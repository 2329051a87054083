"""Block-sparse tree-masked attention, forward and backward: CUDA kernels +
plain versions.

Counterpart of ``dynamictreeattn_tpu/ops/tree_attention.py``. Queries/keys
live in a packed DFS trie layout (tries/flatten.py) where token q attends to
token k iff ``k <= q <= last_desc[k]``. The kernels visit only the (q block,
kv block) pairs that hold an ancestor relation, from the metadata of
``tries.build_block_meta``: for q block i, kv blocks ``kv_ids[i, s]`` for
s < ``kv_counts[i]`` (and its key-major transpose ``q_ids/q_counts/q_types``);
type-2 (full) tiles skip the mask, type-1 (partial) tiles apply it
elementwise, type-0 slots are skipped.

Forward kernels, one CUDA source (``csrc/tree_attn_fwd.cu``):

* bound (K1, replaces ``_fwd_bound_kernel``): each row is shifted by the fixed
  Cauchy-Schwarz bound ``C = scale*||q_row||*max||k||`` (``_score_bound``,
  plain torch outside the kernel) instead of a running max;
* online (K2, replaces ``_fwd_kernel``): classic flash online softmax.

Backward kernels ("split", ``csrc/tree_attn_bwd.cu``), from the saved lse and
``di = sum(do * o)``:

* dq (K11, replaces ``_dq_kernel``): query-major over ``kv_ids``;
* dk, dv (K12, replaces ``_dkv_kernel``): key-major over ``q_ids``.

Each has a plain blocked version beside it (the loops of the TPU kernels in
torch). A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises — it never falls back.
``tree_attention`` ties forward and backward together as a
``torch.autograd.Function``.

Layout: q heads grouped per kv head, ``q4 [hkv, group, n, dh]``; k, v
``[hkv, n, dh]``; lse and di fp32 ``[hkv, group, n]``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from dynamictreeattn_tpu_torch.ops import _build

__all__ = [
    "BOUND_SAFE_MAX", "BlockSizes", "MASK_VALUE", "tree_attention",
    "tree_attn_bwd_dkv", "tree_attn_bwd_dkv_plain", "tree_attn_bwd_dq",
    "tree_attn_bwd_dq_plain", "tree_attn_fwd_bound", "tree_attn_fwd_online",
    "tree_attn_fwd_plain",
]

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
# Guard for the bound path: scores satisfy |s| <= C, so the shift's slack
# over the true row max is at most 2*max(C); max(C) < 40 keeps exp(s - C)
# inside fp32's normal range (floor ~e^-87).
BOUND_SAFE_MAX = 40.0
# the kernel's tile sizes: metadata block sizes must be multiples of these
KERNEL_TILE = 64
# (head_dim, GQA group) pairs the CUDA source instantiates: Qwen3-0.6B/1.7B
KERNEL_SHAPES = ((128, 2),)


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    # The card's own choice, not the TPU's 512: the kernel's tiles are 64
    # rows and 64 columns, and smaller metadata blocks skip more masked work.
    block_q: int = 128
    block_kv: int = 128


def _score_bound(q4: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """Per-row score upper bound C[h, g, row] = scale*||q_row||*max_r||k_r||
    (fp32 norms, each one fused pass over the bf16 input)."""
    qn = torch.linalg.vector_norm(q4, dim=-1, dtype=torch.float32)  # [hkv, g, n]
    kn = torch.linalg.vector_norm(k, dim=-1, dtype=torch.float32)  # [hkv, n]
    kmax = torch.amax(kn, dim=-1)  # [hkv]
    return scale * qn * kmax[:, None, None]


# ---------------------------------------------------------------- plain version


def tree_attn_fwd_plain(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, scale,
                        block_q, block_kv, c=None):
    """Blocked loop over the metadata, the kernels' arithmetic in torch.

    ``c`` given: the bound variant (shift by ``c``, no running max); else the
    online variant. Scores and statistics in fp32, P rounded to v's dtype
    before the PV product. Returns (o like q4, lse fp32 [hkv, g, n])."""
    hkv, group, n, dh = q4.shape
    ids, counts, types = kv_ids.tolist(), kv_counts.tolist(), kv_types.tolist()
    ld = last_desc.long()
    o = torch.empty_like(q4)
    lse = torch.empty((hkv, group, n), dtype=torch.float32, device=q4.device)
    for i in range(n // block_q):
        rows = slice(i * block_q, (i + 1) * block_q)
        qf = q4[:, :, rows].float()
        row_pos = torch.arange(i * block_q, (i + 1) * block_q, device=q4.device)[:, None]
        m = torch.full((hkv, group, block_q, 1), float("-inf"), device=q4.device)
        l = torch.zeros((hkv, group, block_q, 1), device=q4.device)
        acc = torch.zeros((hkv, group, block_q, dh), device=q4.device)
        for s in range(counts[i]):
            j, typ = ids[i][s], types[i][s]
            if typ == 0:
                continue
            cols = slice(j * block_kv, (j + 1) * block_kv)
            st = torch.einsum("hgqd,hkd->hgqk", qf, k[:, cols].float()) * scale
            if typ == 1:
                col_pos = torch.arange(j * block_kv, (j + 1) * block_kv, device=q4.device)[None, :]
                keep = (col_pos <= row_pos) & (row_pos <= ld[cols][None, :])
                st = st + torch.where(keep, 0.0, MASK_VALUE)
            if c is not None:
                p = torch.exp(st - c[:, :, rows, None])
                l = l + p.sum(-1, keepdim=True)
                alpha = 1.0
            else:
                m_next = torch.maximum(m, st.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_next)
                p = torch.exp(st - m_next)
                l = alpha * l + p.sum(-1, keepdim=True)
                m = m_next
            pv = torch.einsum("hgqk,hkd->hgqd", p.to(v.dtype).float(), v[:, cols].float())
            acc = acc * alpha + pv
        inv = torch.where(l == 0.0, 1.0, 1.0 / l)
        o[:, :, rows] = (acc * inv).to(q4.dtype)
        base = c[:, :, rows] if c is not None else m[..., 0]
        lse[:, :, rows] = base + torch.log(torch.clamp(l[..., 0], min=1e-30))
    return o, lse


def _bwd_tile(q4, k, v, do, lse, di, ld, i, j, typ, scale, block_q, block_kv):
    """(p, ds) fp32 [hkv, g, block_q, block_kv] of q block i against kv block
    j, the arithmetic of the TPU backward kernels: p = exp(s*scale + bias -
    lse), ds = (dp - di)*p*scale, with the mask bias on partial tiles only."""
    rows = slice(i * block_q, (i + 1) * block_q)
    cols = slice(j * block_kv, (j + 1) * block_kv)
    st = torch.einsum("hgqd,hkd->hgqk", q4[:, :, rows].float(), k[:, cols].float()) * scale
    if typ == 1:
        row_pos = torch.arange(i * block_q, (i + 1) * block_q, device=q4.device)[:, None]
        col_pos = torch.arange(j * block_kv, (j + 1) * block_kv, device=q4.device)[None, :]
        keep = (col_pos <= row_pos) & (row_pos <= ld[cols][None, :])
        st = st + torch.where(keep, 0.0, MASK_VALUE)
    p = torch.exp(st - lse[:, :, rows, None])
    dp = torch.einsum("hgqd,hkd->hgqk", do[:, :, rows].float(), v[:, cols].float())
    ds = (dp - di[:, :, rows, None]) * p * scale
    return p, ds


def tree_attn_bwd_dq_plain(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, do, lse, di,
                           scale, block_q, block_kv):
    """dq like q4: query-major loop over ``kv_ids`` (``_dq_kernel``); ds is
    rounded to k's dtype before the product, the fp32 sum to q4's dtype."""
    hkv, group, n, dh = q4.shape
    ids, counts, types = kv_ids.tolist(), kv_counts.tolist(), kv_types.tolist()
    ld = last_desc.long()
    dq = torch.empty_like(q4)
    for i in range(n // block_q):
        acc = torch.zeros((hkv, group, block_q, dh), device=q4.device)
        for s in range(counts[i]):
            j, typ = ids[i][s], types[i][s]
            if typ == 0:
                continue
            _, ds = _bwd_tile(q4, k, v, do, lse, di, ld, i, j, typ, scale, block_q, block_kv)
            kj = k[:, j * block_kv:(j + 1) * block_kv].float()
            acc += torch.einsum("hgqk,hkd->hgqd", ds.to(k.dtype).float(), kj)
        dq[:, :, i * block_q:(i + 1) * block_q] = acc.to(q4.dtype)
    return dq


def tree_attn_bwd_dkv_plain(q4, k, v, last_desc, q_ids, q_counts, q_types, do, lse, di,
                            scale, block_q, block_kv):
    """(dk, dv) like k, v: key-major loop over the transposed metadata
    ``q_ids`` (``_dkv_kernel``), summed over the GQA group; p and ds are
    rounded to the input dtype before the products."""
    hkv, group, n, dh = q4.shape
    ids, counts, types = q_ids.tolist(), q_counts.tolist(), q_types.tolist()
    ld = last_desc.long()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for j in range(n // block_kv):
        dk_acc = torch.zeros((hkv, block_kv, dh), device=q4.device)
        dv_acc = torch.zeros_like(dk_acc)
        for s in range(counts[j]):
            i, typ = ids[j][s], types[j][s]
            if typ == 0:
                continue
            p, ds = _bwd_tile(q4, k, v, do, lse, di, ld, i, j, typ, scale, block_q, block_kv)
            rows = slice(i * block_q, (i + 1) * block_q)
            dv_acc += torch.einsum("hgqk,hgqd->hkd", p.to(do.dtype).float(), do[:, :, rows].float())
            dk_acc += torch.einsum("hgqk,hgqd->hkd", ds.to(q4.dtype).float(), q4[:, :, rows].float())
        dk[:, j * block_kv:(j + 1) * block_kv] = dk_acc.to(k.dtype)
        dv[:, j * block_kv:(j + 1) * block_kv] = dv_acc.to(v.dtype)
    return dk, dv


# -------------------------------------------------------------------- kernels


def _kernel_fn():
    lib = _build.load("tree_attn_fwd")
    fn = lib.tree_attn_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = i
    return fn


def _check_inputs(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, block_q, block_kv,
                  key_major=False):
    """What the CUDA launchers refuse. The metadata is query-major
    (``kv_ids/kv_counts/kv_types``, one row per q block) or, with
    `key_major`, its transpose (``q_ids/...``, one row per kv block)."""
    hkv, group, n, dh = q4.shape
    if q4.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError("tree attention kernel takes bf16 q, k, v")
    if k.shape != (hkv, n, dh) or v.shape != (hkv, n, dh):
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} != {(hkv, n, dh)}")
    if (dh, group) not in KERNEL_SHAPES:
        raise ValueError(f"kernel is compiled for (head_dim, group) in {KERNEL_SHAPES}, "
                         f"got {(dh, group)}")
    if block_q % KERNEL_TILE or block_kv % KERNEL_TILE or n % block_q or n % block_kv:
        raise ValueError(f"{n=} and blocks ({block_q}, {block_kv}) must be multiples of {KERNEL_TILE}")
    nrows = n // (block_kv if key_major else block_q)
    if kv_ids.shape[0] != nrows or kv_types.shape != kv_ids.shape or kv_counts.shape != (nrows,):
        raise ValueError(f"block metadata does not match the {'kv' if key_major else 'q'} blocks")
    for name, t in (("last_desc", last_desc), ("kv_ids", kv_ids),
                    ("kv_counts", kv_counts), ("kv_types", kv_types)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32")
    for t in (q4, k, v, last_desc, kv_ids, kv_counts, kv_types):
        if t.device != q4.device:
            raise ValueError("all inputs must be on one device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel inputs must be contiguous and 16-byte aligned")
    if last_desc.shape != (n,):
        raise ValueError(f"last_desc shape {tuple(last_desc.shape)} != {(n,)}")


def _launch(kind, q4, k, v, last_desc, kv_ids, kv_counts, kv_types, scale,
            block_q, block_kv, c):
    _check_inputs(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, block_q, block_kv)
    hkv, group, n, dh = q4.shape
    if c is not None and (c.dtype != torch.float32 or c.shape != (hkv, group, n)
                          or not c.is_contiguous() or c.device != q4.device):
        raise ValueError("bound C must be contiguous fp32 [hkv, group, n] on q's device")
    o = torch.empty_like(q4)
    lse = torch.empty((hkv, group, n), dtype=torch.float32, device=q4.device)
    stream = torch.cuda.current_stream(q4.device).cuda_stream
    code = _kernel_fn()(
        int(c is not None), q4.data_ptr(), k.data_ptr(), v.data_ptr(),
        last_desc.data_ptr(), kv_ids.data_ptr(), kv_counts.data_ptr(),
        kv_types.data_ptr(), c.data_ptr() if c is not None else None,
        o.data_ptr(), lse.data_ptr(), hkv, group, n, dh, block_q, block_kv,
        kv_ids.shape[1], float(scale), stream,
    )
    _build.check(code, f"tree_attn_fwd_{kind}")
    _build.count_launch(f"tree_attn_fwd_{kind}")
    return o, lse


def tree_attn_fwd_bound(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, scale,
                        block_q, block_kv, c):
    """K1: bound-shift forward. Returns (o, lse = C + log sum exp(s - C))."""
    if q4.device.type == "cpu":
        return tree_attn_fwd_plain(q4, k, v, last_desc, kv_ids, kv_counts, kv_types,
                                   scale, block_q, block_kv, c=c)
    return _launch("bound", q4, k, v, last_desc, kv_ids, kv_counts, kv_types,
                   scale, block_q, block_kv, c)


def tree_attn_fwd_online(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, scale,
                         block_q, block_kv):
    """K2: online-softmax forward. Returns (o, lse)."""
    if q4.device.type == "cpu":
        return tree_attn_fwd_plain(q4, k, v, last_desc, kv_ids, kv_counts, kv_types,
                                   scale, block_q, block_kv)
    return _launch("online", q4, k, v, last_desc, kv_ids, kv_counts, kv_types,
                   scale, block_q, block_kv, None)


def _bwd_kernel_fn(name):
    fn = getattr(_build.load("tree_attn_bwd"), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        n_out = 1 if name == "tree_attn_bwd_dq" else 2
        fn.argtypes = [p] * (10 + n_out) + [i] * 7 + [ctypes.c_float, p]
        fn.restype = i
    return fn


def _check_grad_inputs(q4, do, lse, di):
    if do.dtype != q4.dtype or do.shape != q4.shape:
        raise ValueError(f"do {do.dtype} {tuple(do.shape)} must match q4 {q4.dtype} {tuple(q4.shape)}")
    for name, t in (("lse", lse), ("di", di)):
        if t.dtype != torch.float32 or t.shape != q4.shape[:3]:
            raise ValueError(f"{name} must be fp32 {tuple(q4.shape[:3])}")
    for t in (do, lse, di):
        if t.device != q4.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("do, lse, di must be contiguous, 16-byte aligned, on q's device")


def _launch_bwd(name, outs, q4, k, v, last_desc, ids, counts, types, do, lse, di, scale,
                block_q, block_kv):
    _check_inputs(q4, k, v, last_desc, ids, counts, types, block_q, block_kv,
                  key_major=name == "tree_attn_bwd_dkv")
    _check_grad_inputs(q4, do, lse, di)
    hkv, group, n, dh = q4.shape
    stream = torch.cuda.current_stream(q4.device).cuda_stream
    code = _bwd_kernel_fn(name)(
        q4.data_ptr(), k.data_ptr(), v.data_ptr(), last_desc.data_ptr(), ids.data_ptr(),
        counts.data_ptr(), types.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
        *(t.data_ptr() for t in outs), hkv, group, n, dh, block_q, block_kv, ids.shape[1],
        float(scale), stream,
    )
    _build.check(code, name)
    _build.count_launch(name)


def tree_attn_bwd_dq(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, do, lse, di, scale,
                     block_q, block_kv):
    """K11: dq like q4, query-major over ``kv_ids``."""
    if q4.device.type == "cpu":
        return tree_attn_bwd_dq_plain(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, do,
                                      lse, di, scale, block_q, block_kv)
    dq = torch.empty_like(q4)
    _launch_bwd("tree_attn_bwd_dq", (dq,), q4, k, v, last_desc, kv_ids, kv_counts, kv_types,
                do, lse, di, scale, block_q, block_kv)
    return dq


def tree_attn_bwd_dkv(q4, k, v, last_desc, q_ids, q_counts, q_types, do, lse, di, scale,
                      block_q, block_kv):
    """K12: (dk, dv) like k, v, key-major over the transposed metadata."""
    if q4.device.type == "cpu":
        return tree_attn_bwd_dkv_plain(q4, k, v, last_desc, q_ids, q_counts, q_types, do,
                                       lse, di, scale, block_q, block_kv)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("tree_attn_bwd_dkv", (dk, dv), q4, k, v, last_desc, q_ids, q_counts, q_types,
                do, lse, di, scale, block_q, block_kv)
    return dk, dv


def _fwd_dispatch(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, scale,
                  block_sizes, softmax_mode):
    """(o, lse). In "bound" mode the choice between K1 and K2 is ONE host read
    of ``max(C) < BOUND_SAFE_MAX`` per call (so per layer): the bound kernel
    when it holds, the online kernel otherwise — the JAX package makes the
    same choice with a device-side ``lax.cond``."""
    bq, bkv = block_sizes.block_q, block_sizes.block_kv
    if softmax_mode == "bound":
        c = _score_bound(q4, k, scale)
        if float(c.max()) < BOUND_SAFE_MAX:
            return tree_attn_fwd_bound(q4, k, v, last_desc, kv_ids, kv_counts,
                                       kv_types, scale, bq, bkv, c)
    elif softmax_mode != "online":
        raise ValueError(f"unknown softmax_mode {softmax_mode!r}")
    return tree_attn_fwd_online(q4, k, v, last_desc, kv_ids, kv_counts, kv_types,
                                scale, bq, bkv)


class _TreeAttention(torch.autograd.Function):
    """Counterpart of the JAX package's ``jax.custom_vjp`` ``_tree_attention``:
    forward K1/K2 (``_fwd_dispatch``), backward "split" (K11 then K12) from
    the saved (q4, k, v, o, lse) and ``di = sum(do * o)`` in fp32."""

    @staticmethod
    def forward(ctx, q4, k, v, last_desc, kv_ids, kv_counts, kv_types, q_ids, q_counts,
                q_types, scale, block_sizes, softmax_mode):
        o, lse = _fwd_dispatch(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, scale,
                               block_sizes, softmax_mode)
        ctx.save_for_backward(q4, k, v, o, lse, last_desc, kv_ids, kv_counts, kv_types,
                              q_ids, q_counts, q_types)
        ctx.scale, ctx.block_sizes = scale, block_sizes
        return o

    @staticmethod
    def backward(ctx, do):
        (q4, k, v, o, lse, last_desc, kv_ids, kv_counts, kv_types, q_ids, q_counts,
         q_types) = ctx.saved_tensors
        do = do.contiguous()
        di = torch.sum(do.float() * o.float(), dim=-1)  # [hkv, g, n]
        bq, bkv = ctx.block_sizes.block_q, ctx.block_sizes.block_kv
        dq = tree_attn_bwd_dq(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, do, lse, di,
                              ctx.scale, bq, bkv)
        dk, dv = tree_attn_bwd_dkv(q4, k, v, last_desc, q_ids, q_counts, q_types, do, lse, di,
                                   ctx.scale, bq, bkv)
        return (dq, dk, dv) + (None,) * 10


def tree_attention(
    q: torch.Tensor,  # [Hq, n, dh]
    k: torch.Tensor,  # [Hkv, n, dh]
    v: torch.Tensor,  # [Hkv, n, dh]
    last_desc: torch.Tensor,  # [n] int32
    kv_ids: torch.Tensor,  # [nq, S] int32
    kv_counts: torch.Tensor,  # [nq] int32
    kv_types: torch.Tensor,  # [nq, S] int32
    q_ids: torch.Tensor,  # [nk, St] int32
    q_counts: torch.Tensor,  # [nk] int32
    q_types: torch.Tensor,  # [nk, St] int32
    *,
    scale: float | None = None,
    block_sizes: BlockSizes = BlockSizes(),
    softmax_mode: str = "online",
    bwd_mode: str = "split",
) -> torch.Tensor:
    """Tree-masked attention over a packed DFS trie layout, differentiable in
    q, k, v.

    softmax_mode "online" is safe for any inputs; "bound" shifts by the
    Cauchy-Schwarz row bound and takes the online kernel when max(C) >= 40
    (see ``_fwd_dispatch``). bwd_mode "split" is the only backward ported:
    dq (K11) and dk/dv (K12) as separate kernels. Returns o [Hq, n, dh]."""
    if bwd_mode in ("fused", "cached"):
        raise ValueError(f"bwd_mode={bwd_mode!r} is not ported yet (its kernel, "
                         f"{'K10' if bwd_mode == 'fused' else 'K3'}, is still to port); use 'split'")
    if bwd_mode != "split":
        raise ValueError(f"unknown bwd_mode {bwd_mode!r}")
    hq, n, dh = q.shape
    hkv = k.shape[0]
    if hq % hkv:
        raise ValueError(f"{hq=} not a multiple of {hkv=}")
    if n % block_sizes.block_q or n % block_sizes.block_kv:
        raise ValueError(f"{n=} must be a multiple of the block sizes {block_sizes}")
    if scale is None:
        scale = dh**-0.5
    q4 = q.reshape(hkv, hq // hkv, n, dh).contiguous()
    o = _TreeAttention.apply(q4, k.contiguous(), v.contiguous(), last_desc, kv_ids, kv_counts,
                             kv_types, q_ids, q_counts, q_types, float(scale), block_sizes,
                             softmax_mode)
    return o.reshape(hq, n, dh)
