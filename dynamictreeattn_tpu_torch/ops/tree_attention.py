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

Forward kernels, one CUDA kernel with two branches (``csrc/tree_attn_fwd.cu``,
wgmma and TMA):

* bound (K1, replaces ``_fwd_bound_kernel``): each row is shifted by the fixed
  Cauchy-Schwarz bound ``C = scale*||q_row||*max||k||`` (``_score_bound``,
  plain torch outside the kernel) instead of a running max;
* online (K2, replaces ``_fwd_kernel``): classic flash online softmax.

On the card the forward walks a host work list (``tries.build_qmajor_work``,
built once per batch by ``TreeEngine.prepare``): each 64-row q tile's live
64-key sub-tiles, flagged full or partial, the tiles heaviest first.
``_fwd_dispatch`` in "bound" mode hands the kernel the device-side flag
``max(C) < BOUND_SAFE_MAX`` and the kernel takes the branch it names, as the
JAX package's ``lax.cond`` does: no host read. Each launch records its branch
on the card (``_build.branch_record``).

Backward kernels, from the saved lse and ``di = sum(do * o)``:

* "split": dq (K11, replaces ``_dq_kernel``; ``csrc/tree_attn_bwd.cu``),
  query-major; dk, dv (K12, replaces ``_dkv_kernel``), key-major;
* "fused" (K10, replaces ``_dqdkv_kernel``): dq, dk, dv in one pass, the
  score/exp/dP chain once per pair;
* "cached" (K3, replaces ``_dqdkv_cached_kernel``): the same pass with the
  dk/dv accumulators kept on chip. The plain version replays the host Belady
  slot schedule (``tries.build_bwd_cache_sched``) as the TPU kernel does;
  the CUDA kernel walks key-major, so every kv block's accumulator stays on
  chip and it takes no schedule (``cached_bwd_geometry``).

K3, K10 and K12 on the card are one key-major kernel
(``csrc/tree_attn_bwd_kmajor.cu``, wgmma and TMA; K3 and K10 one
instantiation, the only difference being that K3's wrapper checks a schedule
on the CPU) that walks a host work list (``tries.build_kmajor_work``, built
once per batch by ``TreeEngine.prepare``): each 64-key tile's live q
sub-tiles, a heavy tile split into chunks so that the work spreads evenly
over the card, the split tiles' fp32 partials summed in a fixed order, so
their dk/dv repeat bit-equal; the dq of K3 and K10 is added by the TMA
unit's bulk reduce-add, across CTAs in no fixed order. K11 walks the
forward's query-major list: one CTA owns each (q tile, q head), so its dq
repeats bit-equal, and "split" is the bit-reproducible backward.

Shapes the CUDA kernels take (``kernel_takes``): head_dim 64 or 128 and any
GQA group 1-8, which covers every dense configuration of ``MODEL_CONFIGS``;
and, for latent attention (MLA, ``models/deepseek_v3.py``), q/k of width
192 against v of width 128 at group 1, in the forward (K1/K2) and the
key-major K3/K10 (``KERNEL_SPLIT_DIMS``; K11 and K12 refuse it). Where the
widths differ, o, do and dv are v's width and dq, dk q's (the plain versions
take any pair). The group is a run-time argument. The query-major kernels (K1, K2, K11)
hold a 64-row q tile of a slice of two group heads per CTA and put the
ceil(group/2) slices on the grid, each slice reading the kv head's K/V tiles
again; at odd group the last slice's second head is idle: its warpgroup
exits at once, nothing is loaded for it and it stores nothing. The key-major
kernels (K3, K10, K12) walk each q sub-tile of their chunk over every group
head, so their tiles do not depend on the group.

Each has a plain blocked version beside it (the loops of the TPU kernels in
torch). A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises — it never falls back.
``tree_attention`` ties forward and backward together as a
``torch.autograd.Function``. Given a `handoff`, its forward keeps (o, lse)
there for a layer's recompute to take instead of launching again (the remat
policy "attn", ``models/qwen3.py``).

Layout: q heads grouped per kv head, ``q4 [hkv, group, n, dh]``; k
``[hkv, n, dh]``, v ``[hkv, n, dv]`` (dv = dh but at ``KERNEL_SPLIT_DIMS``);
lse and di fp32 ``[hkv, group, n]``.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from dynamictreeattn_tpu_torch.ops import _build
from dynamictreeattn_tpu_torch.tries import (
    KMajorWork, QMajorWork, build_bwd_cache_sched, build_kmajor_work, build_qmajor_work,
)

__all__ = [
    "BOUND_SAFE_MAX", "BlockSizes", "MASK_VALUE", "cached_bwd_geometry", "kernel_takes",
    "kmajor_key", "kmajor_slots", "kmajor_work", "qmajor_work",
    "tree_attention", "tree_attention_with_meta", "tree_attn_bwd_cached", "tree_attn_bwd_cached_plain",
    "tree_attn_bwd_dkv", "tree_attn_bwd_dkv_plain", "tree_attn_bwd_dq", "tree_attn_bwd_dq_plain",
    "tree_attn_bwd_fused", "tree_attn_bwd_fused_plain", "tree_attn_fwd_bound",
    "tree_attn_fwd_online", "tree_attn_fwd_plain",
]

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
# Guard for the bound path: scores satisfy |s| <= C, so the shift's slack
# over the true row max is at most 2*max(C); max(C) < 40 keeps exp(s - C)
# inside fp32's normal range (floor ~e^-87).
BOUND_SAFE_MAX = 40.0
# the kernel's tile sizes: metadata block sizes must be multiples of these
KERNEL_TILE = 64
# head dims the CUDA sources instantiate, and the GQA groups the wrappers
# take (the group is a run-time argument of every kernel)
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_MAX_GROUP = 8
# (q/k width, v width) pairs of their own widths, at group 1: MLA's, whose
# q and k carry a RoPE part beside the part v matches (forward and K3/K10)
KERNEL_SPLIT_DIMS = ((192, 128),)
# CTAs the key-major backward kernels (K3, K12) keep on each SM, by head_dim
# or (q/k width, v width) pair (their launch bounds, csrc/tree_attn_bwd_kmajor.cu)
KMAJOR_CTAS_PER_SM = {64: 3, 128: 2, (192, 128): 2}
# the work list cuts each CTA slot's share of the units into chunks of at
# most half of it, heaviest first, so that the tail after the last chunk
# starts is short
KMAJOR_CHUNKS_PER_SLOT = 2


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    # The card's own choice, not the TPU's 512: the kernel's tiles are 64
    # rows and 64 columns, and smaller metadata blocks skip more masked work.
    block_q: int = 128
    block_kv: int = 128


def kernel_takes(head_dim: int, group: int, v_dim: int | None = None) -> bool:
    """Whether the CUDA kernels take this (head_dim, GQA group) pair, with v
    of width `v_dim` (default: head_dim)."""
    if v_dim is None or v_dim == head_dim:
        return head_dim in KERNEL_HEAD_DIMS and 1 <= group <= KERNEL_MAX_GROUP
    return (head_dim, v_dim) in KERNEL_SPLIT_DIMS and group == 1


def kmajor_key(head_dim: int, v_dim: int | None = None):
    """The key of ``KMAJOR_CTAS_PER_SM`` for q/k of `head_dim` and v of
    `v_dim` (default: head_dim)."""
    return head_dim if v_dim is None or v_dim == head_dim else (head_dim, v_dim)


def _score_bound(q4: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """Per-row score upper bound C[h, g, row] = scale*||q_row||*max_r||k_r||
    (fp32 norms, each one fused pass over the bf16 input)."""
    qn = torch.linalg.vector_norm(q4, dim=-1, dtype=torch.float32)  # [hkv, g, n]
    kn = torch.linalg.vector_norm(k, dim=-1, dtype=torch.float32)  # [hkv, n]
    kmax = torch.amax(kn, dim=-1)  # [hkv]
    return scale * qn * kmax[:, None, None]


# ---------------------------------------------------------------- plain version


def tree_attn_fwd_plain(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, scale,
                        block_q, block_kv, c=None, q_off=0, kv_off=0):
    """Blocked loop over the metadata, the kernels' arithmetic in torch.

    ``c`` given: the bound variant (shift by ``c``, no running max); else the
    online variant. Scores and statistics in fp32, P rounded to v's dtype
    before the PV product. Returns (o like q4 at v's width, lse fp32
    [hkv, g, n]).

    ``q_off``, ``kv_off``: the global positions of the first query and the
    first key (a ring pair's; the TPU kernels' ``offs``): the mask is
    ``kv_off + k <= q_off + q <= last_desc[kv_off + k]`` over the whole
    ``last_desc``. A row that sees no key of the pair gets what the TPU
    kernel writes: in a live block p = exp(0) for every key (o their mean,
    lse ~ MASK_VALUE); with no live block o = 0, lse = -inf. Either merges
    with weight 0 once a row has seen a key (the ring's ``_combine``)."""
    hkv, group, n, _ = q4.shape
    dv = v.shape[-1]
    ids, counts, types = kv_ids.tolist(), kv_counts.tolist(), kv_types.tolist()
    ld = last_desc.long()[kv_off:]  # the keys' last_desc
    o = q4.new_empty((hkv, group, n, dv))
    lse = torch.empty((hkv, group, n), dtype=torch.float32, device=q4.device)
    for i in range(n // block_q):
        rows = slice(i * block_q, (i + 1) * block_q)
        qf = q4[:, :, rows].float()
        row_pos = q_off + torch.arange(i * block_q, (i + 1) * block_q, device=q4.device)[:, None]
        m = torch.full((hkv, group, block_q, 1), float("-inf"), device=q4.device)
        l = torch.zeros((hkv, group, block_q, 1), device=q4.device)
        acc = torch.zeros((hkv, group, block_q, dv), device=q4.device)
        for s in range(counts[i]):
            j, typ = ids[i][s], types[i][s]
            if typ == 0:
                continue
            cols = slice(j * block_kv, (j + 1) * block_kv)
            st = torch.einsum("hgqd,hkd->hgqk", qf, k[:, cols].float()) * scale
            if typ == 1:
                col_pos = kv_off + torch.arange(j * block_kv, (j + 1) * block_kv, device=q4.device)[None, :]
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


def _bwd_tile(q4, k, v, do, lse, di, ld, i, j, typ, scale, block_q, block_kv, q_off=0, kv_off=0):
    """(p, ds) fp32 [hkv, g, block_q, block_kv] of q block i against kv block
    j, the arithmetic of the TPU backward kernels: p = exp(s*scale + bias -
    lse), ds = (dp - di)*p*scale, with the mask bias on partial tiles only
    (at global positions: ``q_off``, ``kv_off`` as in the forward; `ld` the
    keys' last_desc, from kv_off on)."""
    rows = slice(i * block_q, (i + 1) * block_q)
    cols = slice(j * block_kv, (j + 1) * block_kv)
    st = torch.einsum("hgqd,hkd->hgqk", q4[:, :, rows].float(), k[:, cols].float()) * scale
    if typ == 1:
        row_pos = q_off + torch.arange(i * block_q, (i + 1) * block_q, device=q4.device)[:, None]
        col_pos = kv_off + torch.arange(j * block_kv, (j + 1) * block_kv, device=q4.device)[None, :]
        keep = (col_pos <= row_pos) & (row_pos <= ld[cols][None, :])
        st = st + torch.where(keep, 0.0, MASK_VALUE)
    p = torch.exp(st - lse[:, :, rows, None])
    dp = torch.einsum("hgqd,hkd->hgqk", do[:, :, rows].float(), v[:, cols].float())
    ds = (dp - di[:, :, rows, None]) * p * scale
    return p, ds


def tree_attn_bwd_dq_plain(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, do, lse, di,
                           scale, block_q, block_kv, q_off=0, kv_off=0):
    """dq like q4: query-major loop over ``kv_ids`` (``_dq_kernel``); ds is
    rounded to k's dtype before the product, the fp32 sum to q4's dtype.
    ``q_off``, ``kv_off`` as in the forward."""
    hkv, group, n, dh = q4.shape
    ids, counts, types = kv_ids.tolist(), kv_counts.tolist(), kv_types.tolist()
    ld = last_desc.long()[kv_off:]
    dq = torch.empty_like(q4)
    for i in range(n // block_q):
        acc = torch.zeros((hkv, group, block_q, dh), device=q4.device)
        for s in range(counts[i]):
            j, typ = ids[i][s], types[i][s]
            if typ == 0:
                continue
            _, ds = _bwd_tile(q4, k, v, do, lse, di, ld, i, j, typ, scale, block_q, block_kv, q_off, kv_off)
            kj = k[:, j * block_kv:(j + 1) * block_kv].float()
            acc += torch.einsum("hgqk,hkd->hgqd", ds.to(k.dtype).float(), kj)
        dq[:, :, i * block_q:(i + 1) * block_q] = acc.to(q4.dtype)
    return dq


def tree_attn_bwd_dkv_plain(q4, k, v, last_desc, q_ids, q_counts, q_types, do, lse, di,
                            scale, block_q, block_kv, q_off=0, kv_off=0):
    """(dk, dv) like k, v: key-major loop over the transposed metadata
    ``q_ids`` (``_dkv_kernel``), summed over the GQA group; p and ds are
    rounded to the input dtype before the products. ``q_off``, ``kv_off``
    as in the forward."""
    hkv, group, n, dh = q4.shape
    ids, counts, types = q_ids.tolist(), q_counts.tolist(), q_types.tolist()
    ld = last_desc.long()[kv_off:]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for j in range(n // block_kv):
        dk_acc = torch.zeros((hkv, block_kv, dh), device=q4.device)
        dv_acc = torch.zeros((hkv, block_kv, v.shape[-1]), device=q4.device)
        for s in range(counts[j]):
            i, typ = ids[j][s], types[j][s]
            if typ == 0:
                continue
            p, ds = _bwd_tile(q4, k, v, do, lse, di, ld, i, j, typ, scale, block_q, block_kv, q_off, kv_off)
            rows = slice(i * block_q, (i + 1) * block_q)
            dv_acc += torch.einsum("hgqk,hgqd->hkd", p.to(do.dtype).float(), do[:, :, rows].float())
            dk_acc += torch.einsum("hgqk,hgqd->hkd", ds.to(q4.dtype).float(), q4[:, :, rows].float())
        dk[:, j * block_kv:(j + 1) * block_kv] = dk_acc.to(k.dtype)
        dv[:, j * block_kv:(j + 1) * block_kv] = dv_acc.to(v.dtype)
    return dk, dv


def _fused_pass(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, do, lse, di, scale,
                block_q, block_kv, visit):
    """The one query-major pass of the fused backwards (``_dqdkv_kernel``,
    ``_dqdkv_cached_kernel``): calls ``visit(i, s, j, dk_p, dv_p)`` per active
    pair in (i asc, s asc) order with the pair's fp32 dk/dv partials
    [hkv, block_kv, dh], summed over the GQA group, and returns dq like q4
    from its fp32 per-block accumulator. p and ds are computed once per pair
    and rounded to the input dtype before each product."""
    hkv, group, n, dh = q4.shape
    ids, counts, types = kv_ids.tolist(), kv_counts.tolist(), kv_types.tolist()
    ld = last_desc.long()
    dq = torch.empty_like(q4)
    for i in range(n // block_q):
        rows = slice(i * block_q, (i + 1) * block_q)
        acc = torch.zeros((hkv, group, block_q, dh), device=q4.device)
        for s in range(counts[i]):
            j, typ = ids[i][s], types[i][s]
            if typ == 0:
                continue
            p, ds = _bwd_tile(q4, k, v, do, lse, di, ld, i, j, typ, scale, block_q, block_kv)
            kj = k[:, j * block_kv:(j + 1) * block_kv].float()
            acc += torch.einsum("hgqk,hkd->hgqd", ds.to(k.dtype).float(), kj)
            visit(i, s, j,
                  torch.einsum("hgqk,hgqd->hkd", ds.to(q4.dtype).float(), q4[:, :, rows].float()),
                  torch.einsum("hgqk,hgqd->hkd", p.to(do.dtype).float(), do[:, :, rows].float()))
        dq[:, :, rows] = acc.to(q4.dtype)
    return dq


def tree_attn_bwd_fused_plain(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, do, lse, di,
                              scale, block_q, block_kv):
    """(dq, dk, dv) like q4, k, v: K10's loop (``_dqdkv_kernel``) — one
    query-major pass, each visit's dk/dv partial added into an fp32
    [hkv, n, dh] buffer (the TPU's per-visit read-modify-write), cast to k's
    and v's dtype at the end as the JAX launcher does."""
    dk32 = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv32 = torch.zeros(v.shape, dtype=torch.float32, device=v.device)

    def visit(i, s, j, dk_p, dv_p):
        dk32[:, j * block_kv:(j + 1) * block_kv] += dk_p
        dv32[:, j * block_kv:(j + 1) * block_kv] += dv_p

    dq = _fused_pass(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, do, lse, di, scale,
                     block_q, block_kv, visit)
    return dq, dk32.to(k.dtype), dv32.to(v.dtype)


def tree_attn_bwd_cached_plain(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, actions, flush,
                               do, lse, di, scale, block_q, block_kv):
    """(dq, dk, dv) like q4, k, v: K3's loop (``_dqdkv_cached_kernel``) — the
    pass of K10 with dk/dv accumulated in an R-slot fp32 cache driven by the
    Belady schedule (``tries.build_bwd_cache_sched``): per visit ``actions[i,
    s] = (slot, fresh, load, evict_id)`` writes the slot's occupant out,
    reloads an evicted block, or starts fresh; ``flush`` writes each slot's
    last occupant. The fp32 output starts as NaN, like uninitialised device
    memory, so a schedule that reads a block never written shows."""
    hkv, _, _, dh = q4.shape
    acts = actions.tolist()
    # dk, dv fp32 side by side on the last axis (dh + dv wide)
    out = torch.full(k.shape[:-1] + (dh + v.shape[-1],), float("nan"), device=k.device)
    cache = torch.zeros((flush.shape[0], hkv, block_kv, out.shape[-1]), device=k.device)

    def cols(b):
        return slice(b * block_kv, (b + 1) * block_kv)

    def visit(i, s, j, dk_p, dv_p):
        slot, fresh, load, evict_id = acts[i][s]
        if evict_id >= 0:
            out[:, cols(evict_id)] = cache[slot]
        if load:
            cache[slot] = out[:, cols(j)]
        if fresh:
            cache[slot].zero_()
        cache[slot, ..., :dh] += dk_p
        cache[slot, ..., dh:] += dv_p

    dq = _fused_pass(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, do, lse, di, scale,
                     block_q, block_kv, visit)
    for r, (b, valid) in enumerate(flush.tolist()):
        if valid:
            out[:, cols(b)] = cache[r]
    return dq, out[..., :dh].to(k.dtype), out[..., dh:].to(v.dtype)


def cached_bwd_geometry(n_kv_blocks: int) -> int:
    """Slot count R of the Belady schedule that ``TreeEngine.prepare`` builds
    for ``bwd_mode="cached"`` on the CPU: the number of kv blocks whose dk/dv
    accumulators K3 keeps on chip at once.

    The JAX launcher derives R from a 96 MB TPU VMEM budget. The CUDA K3 is
    key-major: each CTA holds its chunk of a 64-key tile's dk/dv in
    registers from its first unit to its last (a split tile's partials are
    summed once, in a fixed order), so no accumulator is ever evicted or
    reloaded — the cache of every kv block, R = the number of kv blocks.
    The schedule at that R has no evictions and no reloads; the plain K3
    replays it, and the kernel (which walks its q units key-major) takes
    none, so ``prepare`` builds none on the card."""
    return max(1, int(n_kv_blocks))


def kmajor_slots(device, head_dim) -> int:
    """Chunk slots the key-major work list is balanced over on the CUDA
    ``device``: its SMs x ``KMAJOR_CTAS_PER_SM[head_dim]`` x
    ``KMAJOR_CHUNKS_PER_SLOT`` (`head_dim` a key of ``KMAJOR_CTAS_PER_SM``:
    ``kmajor_key``)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the key-major work list is balanced over a CUDA card's SMs, not {device}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * KMAJOR_CTAS_PER_SM[head_dim] * KMAJOR_CHUNKS_PER_SLOT


def kmajor_work(last_desc, q_ids, q_counts, q_types, block_q, block_kv, hkv, head_dim,
                device, q_off: int = 0, kv_off: int = 0, n_loc: int | None = None) -> KMajorWork:
    """K3's and K12's work list (``tries.build_kmajor_work``) for ``hkv`` kv
    heads of ``head_dim`` (a key of ``KMAJOR_CTAS_PER_SM``) on the CUDA ``device``, built on the host from the
    key-major metadata (numpy arrays or tensors) and uploaded there. Once per
    batch: ``TreeEngine.prepare`` builds it, and the kernels' wrappers take
    it. A ring pair's (K12) passes its offsets and shard length, and the
    whole ``last_desc`` (``tries.build_kmajor_work``'s position-offset form)."""
    host = [t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
            for t in (last_desc, q_ids, q_counts, q_types)]
    work = build_kmajor_work(*host, block_q, block_kv, hkv, kmajor_slots(device, head_dim),
                             tile=KERNEL_TILE, q_off=q_off, kv_off=kv_off, n_loc=n_loc)
    return dataclasses.replace(work, **{name: torch.from_numpy(getattr(work, name)).to(device)
                                        for name in ("units", "chunks")})


def qmajor_work(last_desc, kv_ids, kv_counts, kv_types, block_q, block_kv, device, q_off: int = 0,
                kv_off: int = 0, n_loc: int | None = None) -> QMajorWork:
    """K1's and K2's work list (``tries.build_qmajor_work``), built on the
    host from the query-major metadata (numpy arrays or tensors) and
    uploaded to ``device``. Once per batch: ``TreeEngine.prepare`` builds it,
    and the forward wrappers take it. A ring pair's (K2, K11) as
    ``kmajor_work``'s."""
    host = [t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
            for t in (last_desc, kv_ids, kv_counts, kv_types)]
    work = build_qmajor_work(*host, block_q, block_kv, tile=KERNEL_TILE, q_off=q_off, kv_off=kv_off, n_loc=n_loc)
    return dataclasses.replace(work, **{name: torch.from_numpy(getattr(work, name)).to(device)
                                        for name in ("entries", "tiles")})


# -------------------------------------------------------------------- kernels

# the forward kernel's branch argument: online (K2), bound (K1), or the one a
# device-side flag names (the dispatch's choice, made on the card)
FWD_ONLINE, FWD_BOUND, FWD_BY_FLAG = 0, 1, 2


def _kernel_fn():
    lib = _build.load("tree_attn_fwd")
    fn = lib.tree_attn_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 11 + [i] * 9 + [ctypes.c_float, p]
        fn.restype = i
    return fn


def _check_inputs(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, block_q, block_kv,
                  key_major=False, q_off=0, kv_off=0):
    """What the CUDA launchers refuse. The metadata is query-major
    (``kv_ids/kv_counts/kv_types``, one row per q block) or, with
    `key_major`, its transpose (``q_ids/...``, one row per kv block).
    ``last_desc`` is 1-D and covers the queries' and the keys' global
    positions: from ``q_off`` and ``kv_off``, n of each."""
    hkv, group, n, dh = q4.shape
    dv = v.shape[-1]
    if q4.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError("tree attention kernel takes bf16 q, k, v")
    if k.shape != (hkv, n, dh) or v.shape != (hkv, n, dv):
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} != {(hkv, n, dh)}/{(hkv, n, dv)}")
    if not kernel_takes(dh, group, dv):
        raise ValueError(f"kernel takes head_dim in {KERNEL_HEAD_DIMS} and group in "
                         f"1..{KERNEL_MAX_GROUP}, or (head_dim, v width) in {KERNEL_SPLIT_DIMS} at "
                         f"group 1, got {(dh, group) if dv == dh else (dh, dv, group)}")
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
    if q_off < 0 or kv_off < 0 or q_off % KERNEL_TILE or kv_off % KERNEL_TILE:
        raise ValueError(f"offsets ({q_off}, {kv_off}) must be non-negative multiples of {KERNEL_TILE}")
    if last_desc.dim() != 1 or last_desc.shape[0] < max(q_off, kv_off) + n:
        raise ValueError(f"last_desc shape {tuple(last_desc.shape)} does not cover positions "
                         f"{max(q_off, kv_off)} + {n}")


def _check_offsets(work, q_off, kv_off):
    if (work.q_off, work.kv_off) != (q_off, kv_off):
        raise ValueError(f"work list built for the pair at offsets ({work.q_off}, {work.kv_off}), launched at "
                         f"({q_off}, {kv_off})")


def _check_qwork(work, device, n, q_off=0, kv_off=0):
    """What the forward kernel refuses of a work list: one built for another
    sequence length (its q tiles would lie outside o, or leave some of it
    unwritten) or another ring pair (offsets), or one that is not int32
    contiguous ``tiles [n / 64, 3]`` and ``entries [m]`` on q's device."""
    if not isinstance(work, QMajorWork):
        raise TypeError(f"work must be a QMajorWork, got {type(work).__name__}")
    if work.n_tiles != n // KERNEL_TILE:
        raise ValueError(f"work list of {work.n_tiles} q tiles, but n = {n} has {n // KERNEL_TILE}")
    _check_offsets(work, q_off, kv_off)
    for name, t, dim in (("tiles", work.tiles, 2), ("entries", work.entries, 1)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != dim:
            raise TypeError(f"work.{name} must be an int32 tensor of {dim} dims")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"work.{name} must be contiguous on q's device")
    if work.tiles.shape != (work.n_tiles, 3):
        raise ValueError(f"work.tiles shape {tuple(work.tiles.shape)} is not [{work.n_tiles}, 3]")


def _launch(branch, q4, k, v, last_desc, kv_ids, kv_counts, kv_types, scale,
            block_q, block_kv, c, work, flag=None, q_off=0, kv_off=0):
    """(o, lse) of the forward kernel on the work list `work`, in `branch`
    FWD_ONLINE, FWD_BOUND or FWD_BY_FLAG (the 0-d bool tensor `flag` on the
    card: bound where it holds), the mask at global positions from `q_off`
    and `kv_off`. The kernel records the branch it took."""
    _check_inputs(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, block_q, block_kv, q_off=q_off,
                  kv_off=kv_off)
    hkv, group, n, dh = q4.shape
    if work is None:
        raise ValueError("the tree-attention forward on CUDA needs its work list (qmajor_work, "
                         "built once per batch)")
    _check_qwork(work, q4.device, n, q_off, kv_off)
    if c is not None and (c.dtype != torch.float32 or c.shape != (hkv, group, n)
                          or not c.is_contiguous() or c.device != q4.device):
        raise ValueError("bound C must be contiguous fp32 [hkv, group, n] on q's device")
    if branch == FWD_BY_FLAG and (flag is None or flag.dtype != torch.bool or flag.dim() != 0
                                  or flag.device != q4.device):
        raise ValueError("the branch flag must be a 0-d bool tensor on q's device")
    o = q4.new_empty((hkv, group, n, v.shape[-1]))
    lse = torch.empty((hkv, group, n), dtype=torch.float32, device=q4.device)
    stream = torch.cuda.current_stream(q4.device).cuda_stream
    code = _kernel_fn()(
        branch, flag.data_ptr() if flag is not None else None, q4.data_ptr(), k.data_ptr(),
        v.data_ptr(), last_desc.data_ptr(), work.tiles.data_ptr(), work.entries.data_ptr(),
        c.data_ptr() if c is not None else None, o.data_ptr(), lse.data_ptr(),
        _build.branch_record(q4.device).data_ptr(), _build.RECORD_CAP, work.n_tiles, hkv, group, n,
        dh, v.shape[-1], q_off, kv_off, float(scale), stream,
    )
    _build.check(code, "tree_attn_fwd")
    return o, lse


def tree_attn_fwd_bound(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, scale,
                        block_q, block_kv, c, work=None):
    """K1: bound-shift forward. Returns (o, lse = C + log sum exp(s - C)).
    The kernel takes head_dim 64/128 and group 1-8, or MLA's (192, 128) at
    group 1 (``KERNEL_SPLIT_DIMS``; o then v's width); a CTA holds a 64-row q
    tile of a two-head group slice, the slices on the grid. On CUDA it walks
    ``work`` (``qmajor_work``, required there)."""
    if q4.device.type == "cpu":
        return tree_attn_fwd_plain(q4, k, v, last_desc, kv_ids, kv_counts, kv_types,
                                   scale, block_q, block_kv, c=c)
    return _launch(FWD_BOUND, q4, k, v, last_desc, kv_ids, kv_counts, kv_types,
                   scale, block_q, block_kv, c, work)


def tree_attn_fwd_online(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, scale,
                         block_q, block_kv, work=None, q_off=0, kv_off=0):
    """K2: online-softmax forward. Returns (o, lse). Shapes, group slicing
    and the work list as K1. A ring pair passes the global positions of its
    first query and first key, `q_off` and `kv_off` (multiples of 64), the
    whole ``last_desc`` and its own metadata and work list
    (``build_ring_block_meta``, ``qmajor_work`` at the offsets)."""
    if q4.device.type == "cpu":
        return tree_attn_fwd_plain(q4, k, v, last_desc, kv_ids, kv_counts, kv_types,
                                   scale, block_q, block_kv, q_off=q_off, kv_off=kv_off)
    return _launch(FWD_ONLINE, q4, k, v, last_desc, kv_ids, kv_counts, kv_types,
                   scale, block_q, block_kv, None, work, q_off=q_off, kv_off=kv_off)


# the key-major backward kernels, all in csrc/tree_attn_bwd_kmajor.cu; K3 and
# K10 add dq into an fp32 scratch
_KMAJOR_SOURCE = "tree_attn_bwd_kmajor"
_KMAJOR_WITH_DQ = ("tree_attn_bwd_cached", "tree_attn_bwd_fused")


def _dq_kernel_fn():
    fn = _build.load("tree_attn_bwd").tree_attn_bwd_dq
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 10 + [i] * 7 + [ctypes.c_float, p]
        fn.restype = i
    return fn


def _kmajor_kernel_fn(name):
    fn = getattr(_build.load(_KMAJOR_SOURCE), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        with_dq = name in _KMAJOR_WITH_DQ  # K3 / K10: a dq scratch; K12: offsets
        fn.argtypes = [p] * 9 + ([p] if with_dq else []) + [p] * 4 + [i] * (6 if with_dq else 8) \
            + [ctypes.c_float, p]
        fn.restype = i
    return fn


def _check_grad_inputs(q4, do, lse, di, dv=None):
    """do like o: q4's shape at v's width `dv` (default: q4's)."""
    o_shape = q4.shape[:3] + (q4.shape[3] if dv is None else dv,)
    if do.dtype != q4.dtype or do.shape != o_shape:
        raise ValueError(f"do {do.dtype} {tuple(do.shape)} must match o {q4.dtype} {tuple(o_shape)}")
    for name, t in (("lse", lse), ("di", di)):
        if t.dtype != torch.float32 or t.shape != q4.shape[:3]:
            raise ValueError(f"{name} must be fp32 {tuple(q4.shape[:3])}")
    for t in (do, lse, di):
        if t.device != q4.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("do, lse, di must be contiguous, 16-byte aligned, on q's device")


def tree_attn_bwd_dq(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, do, lse, di, scale,
                     block_q, block_kv, work=None, q_off=0, kv_off=0):
    """K11: dq like q4, query-major. head_dim 64/128, group 1-8, two-head
    group slices on the grid as K1. On CUDA the kernel walks the forward's
    work list ``work`` (``qmajor_work``, required there); one CTA owns each
    (q tile, q head), so dq repeats bit-equal. `q_off`, `kv_off`: a ring
    pair's, as in K2."""
    if q4.device.type == "cpu":
        return tree_attn_bwd_dq_plain(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, do,
                                      lse, di, scale, block_q, block_kv, q_off=q_off, kv_off=kv_off)
    return _launch_dq(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, do, lse, di, scale,
                      block_q, block_kv, work, q_off, kv_off)


def _launch_dq(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, do, lse, di, scale,
               block_q, block_kv, work, q_off=0, kv_off=0):
    """dq of K11 on the query-major work list `work`."""
    _check_inputs(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, block_q, block_kv, q_off=q_off,
                  kv_off=kv_off)
    _check_grad_inputs(q4, do, lse, di, v.shape[-1])
    hkv, group, n, dh = q4.shape
    if v.shape[-1] != dh:
        raise ValueError(f"tree_attn_bwd_dq (K11) takes v of q's width {dh}, got {v.shape[-1]}: "
                         'MLA\'s widths run bwd_mode "cached" or "fused"')
    if work is None:
        raise ValueError("tree_attn_bwd_dq on CUDA needs its work list (qmajor_work, built once per batch)")
    _check_qwork(work, q4.device, n, q_off, kv_off)
    dq = torch.empty_like(q4)
    stream = torch.cuda.current_stream(q4.device).cuda_stream
    code = _dq_kernel_fn()(
        q4.data_ptr(), k.data_ptr(), v.data_ptr(), last_desc.data_ptr(), work.tiles.data_ptr(),
        work.entries.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        work.n_tiles, hkv, group, n, dh, q_off, kv_off, float(scale), stream,
    )
    _build.check(code, "tree_attn_bwd_dq")
    _build.count_launch("tree_attn_bwd_dq")
    return dq


def _check_work(work, device, n, q_off=0, kv_off=0):
    """What the key-major kernels refuse of a work list: one built for
    another sequence length (its key tiles would lie outside dk/dv, or leave
    some of them unwritten) or another ring pair (offsets), or one that is
    not int32 contiguous ``chunks [m, 8]`` and ``units [u]`` on q's device."""
    if not isinstance(work, KMajorWork):
        raise TypeError(f"work must be a KMajorWork, got {type(work).__name__}")
    if work.n_tiles != n // KERNEL_TILE:
        raise ValueError(f"work list of {work.n_tiles} key tiles, but n = {n} has {n // KERNEL_TILE}")
    _check_offsets(work, q_off, kv_off)
    for name, t, dim in (("chunks", work.chunks, 2), ("units", work.units, 1)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.dim() != dim:
            raise TypeError(f"work.{name} must be an int32 tensor of {dim} dims")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"work.{name} must be contiguous on q's device")
    if work.chunks.shape[1] != 8:
        raise ValueError(f"work.chunks shape {tuple(work.chunks.shape)} is not [n, 8]")


def _launch_kmajor(name, q4, k, v, last_desc, ids, counts, types, do, lse, di, scale,
                   block_q, block_kv, work, key_major=True, q_off=0, kv_off=0):
    """(dq or None, dk, dv) of K3 (``tree_attn_bwd_cached``) or K10
    (``tree_attn_bwd_fused``), dq through an fp32 scratch zeroed here and
    cast after, or K12 (``tree_attn_bwd_dkv``). The block metadata (checked,
    not read: the kernel walks ``work``) is key-major, or query-major
    without `key_major`. The split tiles' partials and arrival counters are
    scratch of ``work.n_parts`` / ``work.n_split`` entries per kv head. K12
    takes a ring pair's offsets; K3 and K10 run at offset 0."""
    with_dq = name in _KMAJOR_WITH_DQ
    if with_dq and (q_off or kv_off):
        raise ValueError(f"{name} takes no position offsets")
    _check_inputs(q4, k, v, last_desc, ids, counts, types, block_q, block_kv, key_major=key_major, q_off=q_off,
                  kv_off=kv_off)
    _check_grad_inputs(q4, do, lse, di, v.shape[-1])
    hkv, group, n, dh = q4.shape
    v_dim = v.shape[-1]
    if not with_dq and v_dim != dh:
        raise ValueError(f"{name} (K12) takes v of q's width {dh}, got {v_dim}: "
                         'MLA\'s widths run bwd_mode "cached" or "fused"')
    if work is None:
        raise ValueError(f"{name} on CUDA needs its work list (kmajor_work, built once per batch)")
    _check_work(work, q4.device, n, q_off, kv_off)
    dq32 = torch.zeros(q4.shape, dtype=torch.float32, device=q4.device) if with_dq else None
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    part = torch.empty(work.n_parts * hkv * KERNEL_TILE * (dh + v_dim), dtype=torch.float32, device=q4.device)
    counters = torch.zeros(work.n_split * hkv, dtype=torch.int32, device=q4.device)
    stream = torch.cuda.current_stream(q4.device).cuda_stream
    code = _kmajor_kernel_fn(name)(
        q4.data_ptr(), k.data_ptr(), v.data_ptr(), last_desc.data_ptr(), work.chunks.data_ptr(),
        work.units.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
        *((dq32.data_ptr(),) if with_dq else ()), dk.data_ptr(), dv.data_ptr(), part.data_ptr(),
        counters.data_ptr(), work.chunks.shape[0], hkv, group, n, dh, v_dim,
        *(() if with_dq else (q_off, kv_off)), float(scale), stream,
    )
    _build.check(code, name)
    _build.count_launch(name)
    return (dq32.to(q4.dtype) if with_dq else None), dk, dv


def tree_attn_bwd_dkv(q4, k, v, last_desc, q_ids, q_counts, q_types, do, lse, di, scale,
                      block_q, block_kv, work=None, q_off=0, kv_off=0):
    """K12: (dk, dv) like k, v, key-major over the transposed metadata.
    head_dim 64/128, group 1-8: each CTA walks a chunk of its key tile's q
    sub-tiles over every group head, so no slicing. On CUDA the kernel walks
    ``work`` (``kmajor_work``, required there); its split tiles are summed in
    a fixed order, so dk and dv repeat bit-equal. `q_off`, `kv_off`: a ring
    pair's, as in K2."""
    if q4.device.type == "cpu":
        return tree_attn_bwd_dkv_plain(q4, k, v, last_desc, q_ids, q_counts, q_types, do,
                                       lse, di, scale, block_q, block_kv, q_off=q_off, kv_off=kv_off)
    return _launch_kmajor("tree_attn_bwd_dkv", q4, k, v, last_desc, q_ids, q_counts, q_types, do,
                          lse, di, scale, block_q, block_kv, work, q_off=q_off, kv_off=kv_off)[1:]


def tree_attn_bwd_fused(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, do, lse, di, scale,
                        block_q, block_kv, work=None):
    """K10: (dq, dk, dv) like q4, k, v in one pass. On the CPU the plain
    version runs the TPU kernel's query-major pass over ``kv_ids``. On CUDA
    the kernel is K3's key-major walk over ``work`` (``kmajor_work``,
    required there), entered with no schedule: dk and dv stay on chip and
    repeat bit-equal; dq is added into a zeroed fp32 scratch by bulk
    reduce-adds in no fixed order and cast to q's dtype after. head_dim
    64/128, group 1-8, or MLA's (192, 128) at group 1."""
    if q4.device.type == "cpu":
        return tree_attn_bwd_fused_plain(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, do,
                                         lse, di, scale, block_q, block_kv)
    return _launch_kmajor("tree_attn_bwd_fused", q4, k, v, last_desc, kv_ids, kv_counts, kv_types, do,
                          lse, di, scale, block_q, block_kv, work, key_major=False)


def _check_sched(actions, flush, kv_ids, device):
    """What the plain K3 refuses of a slot schedule: ``actions`` int32
    [nq, slots, 4] matching ``kv_ids``, ``flush`` int32 [R, 2] with R >= 1,
    on q's device."""
    if actions.dtype != torch.int32 or flush.dtype != torch.int32:
        raise TypeError("cache schedule (actions, flush) must be int32")
    if actions.shape != (*kv_ids.shape, 4):
        raise ValueError(f"actions shape {tuple(actions.shape)} != {(*kv_ids.shape, 4)}")
    if flush.dim() != 2 or flush.shape[0] < 1 or flush.shape[1] != 2:
        raise ValueError(f"flush shape {tuple(flush.shape)} is not [R >= 1, 2]")
    if actions.device != device or flush.device != device:
        raise ValueError("cache schedule must be on q's device")


def tree_attn_bwd_cached(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, q_ids, q_counts,
                         q_types, actions, flush, do, lse, di, scale, block_q, block_kv,
                         work=None):
    """K3: (dq, dk, dv) like q4, k, v. On the CPU the plain version replays
    the slot schedule (``actions``, ``flush``, checked) over ``kv_ids``. On
    CUDA the kernel walks the key-major work list ``work`` as K12 does
    (required there), each key tile's dk/dv on chip (see
    ``cached_bwd_geometry``): it takes no schedule (``actions`` and
    ``flush`` may be None) and is K10's kernel. dk and dv repeat bit-equal;
    dq is added into a zeroed fp32 scratch by bulk reduce-adds in no fixed
    order (not bit-reproducible) and cast to q's dtype after. head_dim
    64/128, group 1-8, key-major as K12: no slicing; or MLA's (192, 128) at
    group 1 (its own instantiation, ``tree_attn_bwd_kmajor_mla_kernel``)."""
    if q4.device.type == "cpu":
        _check_sched(actions, flush, kv_ids, q4.device)
        return tree_attn_bwd_cached_plain(q4, k, v, last_desc, kv_ids, kv_counts, kv_types,
                                          actions, flush, do, lse, di, scale, block_q, block_kv)
    return _launch_kmajor("tree_attn_bwd_cached", q4, k, v, last_desc, q_ids, q_counts, q_types,
                          do, lse, di, scale, block_q, block_kv, work)


def _fwd_dispatch(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, scale,
                  block_sizes, softmax_mode, work=None):
    """(o, lse). In "bound" mode the bound kernel (K1) runs where ``max(C) <
    BOUND_SAFE_MAX``, the online kernel (K2) otherwise, the choice the JAX
    package makes with ``lax.cond``. On the card the choice is made there:
    one launch with the flag as a 0-d tensor, no host read. On the CPU the
    host reads the flag and runs the plain version of its branch."""
    bq, bkv = block_sizes.block_q, block_sizes.block_kv
    if softmax_mode == "bound":
        c = _score_bound(q4, k, scale)
        if q4.device.type != "cpu":
            return _launch(FWD_BY_FLAG, q4, k, v, last_desc, kv_ids, kv_counts, kv_types, scale,
                           bq, bkv, c, work, flag=torch.amax(c) < BOUND_SAFE_MAX)
        if float(c.max()) < BOUND_SAFE_MAX:
            return tree_attn_fwd_bound(q4, k, v, last_desc, kv_ids, kv_counts,
                                       kv_types, scale, bq, bkv, c, work=work)
    elif softmax_mode != "online":
        raise ValueError(f"unknown softmax_mode {softmax_mode!r}")
    return tree_attn_fwd_online(q4, k, v, last_desc, kv_ids, kv_counts, kv_types,
                                scale, bq, bkv, work=work)


class _TreeAttention(torch.autograd.Function):
    """Counterpart of the JAX package's ``jax.custom_vjp`` ``_tree_attention``:
    forward K1/K2 (``_fwd_dispatch``); backward from the saved (q4, k, v, o,
    lse) and ``di = sum(do * o)`` in fp32, by ``bwd_mode``: "cached" (K3,
    with the slot schedule ``actions``/``flush`` on the CPU), "fused" (K10)
    or "split" (K11 then K12); K3, K10 and K12 walk the key-major work list
    ``work``, the forward and K11 the query-major one ``qwork``. With a
    `handoff` (see ``tree_attention``) the forward keeps (o, lse) there or,
    when it is taking, takes them and launches nothing."""

    @staticmethod
    def forward(ctx, q4, k, v, last_desc, kv_ids, kv_counts, kv_types, q_ids, q_counts,
                q_types, actions, flush, scale, block_sizes, softmax_mode, bwd_mode, work, qwork,
                handoff):
        if handoff is not None and handoff.taking:  # the recompute: the first forward's (o, lse)
            o, lse = handoff.take()
        else:
            o, lse = _fwd_dispatch(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, scale,
                                   block_sizes, softmax_mode, qwork)
            if handoff is not None:
                handoff.keep((o.detach(), lse))
        ctx.save_for_backward(q4, k, v, o, lse, last_desc, kv_ids, kv_counts, kv_types,
                              q_ids, q_counts, q_types, actions, flush)
        ctx.scale, ctx.block_sizes, ctx.bwd_mode = scale, block_sizes, bwd_mode
        ctx.work, ctx.qwork = work, qwork
        return o

    @staticmethod
    def backward(ctx, do):
        (q4, k, v, o, lse, last_desc, kv_ids, kv_counts, kv_types, q_ids, q_counts,
         q_types, actions, flush) = ctx.saved_tensors
        do = do.contiguous()
        di = torch.sum(do.float() * o.float(), dim=-1)  # [hkv, g, n]
        tail = (do, lse, di, ctx.scale, ctx.block_sizes.block_q, ctx.block_sizes.block_kv)
        if ctx.bwd_mode == "cached":
            dq, dk, dv = tree_attn_bwd_cached(q4, k, v, last_desc, kv_ids, kv_counts, kv_types,
                                              q_ids, q_counts, q_types, actions, flush, *tail, ctx.work)
        elif ctx.bwd_mode == "fused":
            dq, dk, dv = tree_attn_bwd_fused(q4, k, v, last_desc, kv_ids, kv_counts, kv_types,
                                             *tail, ctx.work)
        else:
            dq = tree_attn_bwd_dq(q4, k, v, last_desc, kv_ids, kv_counts, kv_types, *tail, ctx.qwork)
            dk, dv = tree_attn_bwd_dkv(q4, k, v, last_desc, q_ids, q_counts, q_types, *tail, ctx.work)
        return (dq, dk, dv) + (None,) * 16


def tree_attention(
    q: torch.Tensor,  # [Hq, n, dh]
    k: torch.Tensor,  # [Hkv, n, dh]
    v: torch.Tensor,  # [Hkv, n, dv]
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
    cache_sched=None,
    kmajor_work: KMajorWork | None = None,
    qmajor_work: QMajorWork | None = None,
    handoff=None,
) -> torch.Tensor:
    """Tree-masked attention over a packed DFS trie layout, differentiable in
    q, k, v.

    softmax_mode "online" is safe for any inputs; "bound" shifts by the
    Cauchy-Schwarz row bound and takes the online branch when max(C) >= 40,
    a choice made on the card (see ``_fwd_dispatch``).

    bwd_mode:

    * ``"split"`` (default, as in JAX) — dq (K11, query-major) and dk/dv (K12,
      key-major) as separate kernels, each recomputing the scores;
      bit-reproducible on the card;
    * ``"fused"`` — one kernel (K10) emits dq, dk and dv, computing the
      score/exp/dP chain once per active pair; dq summed across CTAs;
    * ``"cached"`` — the JAX engine's default (K3): the fused pass with dk/dv
      accumulators on chip; on the CPU it needs ``cache_sched``, a
      ``tries.BwdCacheSched`` or an ``(actions, flush)`` pair from
      ``tries.build_bwd_cache_sched``, which the plain K3 replays; on the
      card it is K10's kernel and takes none ("split" and "fused" ignore it).

    ``kmajor_work``: the work list of K3, K10 and K12 (``kmajor_work``, once
    per batch), which every backward mode needs on the card;
    ``qmajor_work``: the forward's (``qmajor_work``), which the forward and
    K11 need there.

    ``handoff``: an object with ``taking``, ``keep(value)`` and ``take()``
    (``models.qwen3.RematHandoff``) through which a checkpointed layer's
    first forward keeps (o, lse) and its recompute, while ``taking``, takes
    them back instead of launching the forward again.

    Returns o [Hq, n, dv] (dv = dh but for MLA's widths, module docstring;
    the scale defaults to dh**-0.5, dh q's width)."""
    if bwd_mode not in ("split", "fused", "cached"):
        raise ValueError(f"unknown bwd_mode {bwd_mode!r}")
    hq, n, dh = q.shape
    hkv = k.shape[0]
    if hq % hkv:
        raise ValueError(f"{hq=} not a multiple of {hkv=}")
    if n % block_sizes.block_q or n % block_sizes.block_kv:
        raise ValueError(f"{n=} must be a multiple of the block sizes {block_sizes}")
    if scale is None:
        scale = dh**-0.5
    actions = flush = None
    if bwd_mode == "cached" and q.device.type == "cpu":
        if cache_sched is None:
            raise ValueError('bwd_mode="cached" needs cache_sched '
                             "(tries.build_bwd_cache_sched)")
        acts, fl = ((cache_sched.actions, cache_sched.flush) if hasattr(cache_sched, "actions")
                    else cache_sched)
        actions, flush = (torch.as_tensor(a, dtype=torch.int32, device=q.device) for a in (acts, fl))
    q4 = q.reshape(hkv, hq // hkv, n, dh).contiguous()
    o = _TreeAttention.apply(q4, k.contiguous(), v.contiguous(), last_desc, kv_ids, kv_counts,
                             kv_types, q_ids, q_counts, q_types, actions, flush, float(scale),
                             block_sizes, softmax_mode, bwd_mode, kmajor_work, qmajor_work, handoff)
    return o.reshape(hq, n, v.shape[-1])


def tree_attention_with_meta(q, k, v, last_desc, meta, **kw):
    """``tree_attention`` from a host ``tries.BlockMeta`` (JAX's
    convenience): its arrays uploaded to q's device and, on the card, the
    q-major and k-major work lists built from it (the kernels need both);
    on the CPU a "cached" backward gets its slot schedule. `kw` as
    ``tree_attention``'s."""
    dev = q.device
    ld = torch.as_tensor(last_desc, dtype=torch.int32, device=dev)
    arrays = [torch.from_numpy(np.ascontiguousarray(getattr(meta, f), np.int32)).to(dev)
              for f in ("kv_ids", "kv_counts", "kv_types", "q_ids", "q_counts", "q_types")]
    bq, bkv = meta.block_q, meta.block_kv
    if dev.type == "cuda":
        hkv, key = k.shape[0], kmajor_key(k.shape[-1], v.shape[-1])
        kw.setdefault("qmajor_work", qmajor_work(ld, meta.kv_ids, meta.kv_counts, meta.kv_types, bq, bkv, dev))
        kw.setdefault("kmajor_work", kmajor_work(ld, meta.q_ids, meta.q_counts, meta.q_types, bq, bkv, hkv, key, dev))
    elif kw.get("bwd_mode") == "cached" and kw.get("cache_sched") is None:
        kw["cache_sched"] = build_bwd_cache_sched(meta, cached_bwd_geometry(len(meta.q_counts)))
    return tree_attention(q, k, v, ld, *arrays, block_sizes=BlockSizes(bq, bkv), **kw)
