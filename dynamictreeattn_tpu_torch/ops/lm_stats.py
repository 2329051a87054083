"""Fused LM-head softmax statistics, forward and backward: CUDA kernels +
plain versions.

Counterpart of ``dynamictreeattn_tpu/ops/lm_stats.py``:

* forward (K8, ``csrc/lm_stats_fwd.cu``): per row, the fp32 (lse, mean_x) of
  softmax(hidden @ w_lm * inv_temp), without materializing the [n, V]
  logits; entropy = lse − mean_x. A persistent kernel walks units of one
  128-row tile × a split of consecutive 256-column vocab tiles
  (:func:`lm_fwd_plan`, :func:`lm_fwd_units`), folding each row online in
  the log2 domain, and a second small pass merges each row's split partials
  (m, Σ2ˣ, Σ2ˣ·x) in split order;
* backward (K9, ``csrc/lm_stats_bwd.cu``): (dhidden, dWᵀ) for the cotangents
  (g_lse, g_ent) from the saved (lse, mean_x), recomputing the logits. One
  persistent pass writes the bf16 dlogits; a second contracts them into
  dhidden and dWᵀ over one list of output tiles (:func:`lm_bwd_units`).

Both run wgmma m64n256k16 on TMA rings (``csrc/lm_head.cuh``). The TPU's row
splits (``default_max_rows`` / ``_row_splits``) exist only for its VMEM
budget and are not carried over.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dynamictreeattn_tpu_torch.ops import _build

__all__ = ["lm_bwd_units", "lm_fwd_plan", "lm_fwd_units", "lm_kernel_takes", "lm_stats", "lm_stats_bwd",
           "lm_stats_bwd_plain", "lm_stats_plain"]

BLOCK_ROWS = 128  # rows of a kernel tile
BLOCK_V = 256  # vocab columns of a logits tile (and hidden columns of an output tile of K9)
BLOCK_K = 64  # depth of a k-chunk: the hidden size must be a multiple of this
_PAD = 128  # K9's dlogits scratch: rows and columns rounded up to this


def lm_kernel_takes(d: int, V: int) -> bool:
    """Whether the K8 / K9 kernels take hidden size d and vocabulary V (at
    any row count n >= 1): d a multiple of the 64-deep k-chunk (every hidden size of
    ``MODEL_CONFIGS`` is a multiple of 128) and a non-empty vocabulary."""
    return d >= BLOCK_K and d % BLOCK_K == 0 and V >= 1


@functools.lru_cache(maxsize=64)
def lm_fwd_plan(n: int, V: int, sms: int) -> tuple[int, int, int]:
    """(splits, vocab tiles per split, grid) of the K8 walk for n rows, a
    vocabulary V and `sms` SMs. The busiest CTA runs ceil(R · splits / grid)
    · T tiles (R = ceil(n / 128) row tiles, T tiles per split, splits =
    ceil(ceil(V / 256) / T)); of the T within 2% of the least, the largest
    is taken: fewer splits write fewer partials."""
    R, NT = -(-n // BLOCK_ROWS), -(-V // BLOCK_V)
    cost = {T: -(-R * -(-NT // T) // sms) * T for T in range(1, NT + 1)}
    least = min(cost.values())
    T = max(t for t, c in cost.items() if c <= least * 1.02)
    S = -(-NT // T)
    return S, T, min(sms, R * S)


def lm_fwd_units(n: int, V: int, sms: int) -> list[list[tuple[int, int, int, int]]]:
    """The K8 walk: for each CTA, in order, its units (row tile, split, first
    vocab tile, end vocab tile). CTA c takes units c, c + grid, ...; unit u
    is row tile u % R of split u // R. A row's partials merge in split order."""
    S, T, grid = lm_fwd_plan(n, V, sms)
    R, NT = -(-n // BLOCK_ROWS), -(-V // BLOCK_V)
    return [[(u % R, u // R, (u // R) * T, min(NT, (u // R + 1) * T)) for u in range(c, R * S, grid)]
            for c in range(grid)]


def lm_bwd_units(n: int, d: int, V: int) -> list[tuple[str, int, int, int]]:
    """K9's output tiles in the order its product pass hands them out:
    ("dh", first row, first column, depth in 64-chunks) for every 128 x 256
    tile of dhidden (contraction over the padded vocabulary), then ("dwT",
    ...) for every tile of dWT (over the padded rows): the long tiles first."""
    R, ND = -(-n // _PAD), -(-d // BLOCK_V)
    V_pad = -(-V // _PAD) * _PAD
    dh = [("dh", (u // ND) * BLOCK_ROWS, (u % ND) * BLOCK_V, V_pad // BLOCK_K) for u in range(R * ND)]
    dwt = [("dwT", (u // ND) * BLOCK_ROWS, (u % ND) * BLOCK_V, R * _PAD // BLOCK_K)
           for u in range((V_pad // BLOCK_ROWS) * ND)]
    return dh + dwt


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _head_rows(hidden: torch.Tensor, w_lm: torch.Tensor, what: str) -> torch.Tensor:
    """wT = w_lm.T [V, d], checked for the kernels (copied if w_lm is a
    contiguous [d, V] tensor)."""
    d, V = w_lm.shape
    if hidden.dim() != 2 or hidden.shape[1] != d:
        raise ValueError(f"w_lm shape {tuple(w_lm.shape)} does not match hidden {tuple(hidden.shape)}")
    if hidden.dtype != torch.bfloat16 or w_lm.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bf16 hidden and w_lm")
    if not lm_kernel_takes(d, V):
        raise ValueError(f"{what} kernel does not take hidden size {d}, vocabulary {V} "
                         f"(hidden size a multiple of {BLOCK_K})")
    if w_lm.device != hidden.device:
        raise ValueError("hidden and w_lm must be on one device")
    wT = w_lm.t()
    if not wT.is_contiguous():
        wT = wT.contiguous()
    if not hidden.is_contiguous() or hidden.data_ptr() % 16 or wT.data_ptr() % 16:
        raise ValueError(f"{what} kernel inputs must be contiguous and 16-byte aligned")
    return wT


def lm_stats_plain(hidden: torch.Tensor, w_lm: torch.Tensor, inv_temp: float = 1.0,
                   vocab_chunk: int = 16384, row_chunk: int = 2048):
    """(lse [n], mean_x [n]) fp32, looping over row chunks and, inside each,
    folding online (m, Σeˣ, Σeˣ·x) over vocab chunks — never more than a
    [row_chunk, vocab_chunk] fp32 logits block at once. Products are fp32
    over the inputs' values (bf16 inputs are widened, not rounded)."""
    n = hidden.shape[0]
    V = w_lm.shape[1]
    lse = torch.empty(n, dtype=torch.float32, device=hidden.device)
    mean_x = torch.empty_like(lse)
    for r0 in range(0, n, row_chunk):
        h = hidden[r0:r0 + row_chunk].float()
        m = torch.full((h.shape[0],), float("-inf"), device=hidden.device)
        se = torch.zeros_like(m)
        sx = torch.zeros_like(m)
        for c0 in range(0, V, vocab_chunk):
            x = (h @ w_lm[:, c0:c0 + vocab_chunk].float()) * inv_temp
            new_m = torch.maximum(m, x.amax(-1))
            r = torch.exp(m - new_m)  # 0 on the first chunk (m = -inf)
            ex = torch.exp(x - new_m[:, None])
            se = se * r + ex.sum(-1)
            sx = sx * r + (ex * x).sum(-1)
            m = new_m
        lse[r0:r0 + row_chunk] = m + torch.log(se)
        mean_x[r0:r0 + row_chunk] = sx / se
    return lse, mean_x


def _kernel_fn():
    lib = _build.load("lm_stats_fwd")
    fn = lib.lm_stats_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 6 + [ctypes.c_float, p]
        fn.restype = i
    return fn


def lm_stats(hidden: torch.Tensor, w_lm: torch.Tensor, inv_temp: float = 1.0, *, _plan=None):
    """(lse [n], mean_x [n]) fp32 of softmax(hidden @ w_lm · inv_temp).

    hidden [n, d]; w_lm [d, V]. The kernel reads the head as wT = w_lm.T
    [V, d] row-major, which is free for a tied head (w_lm = embed.T) and for
    an untied head as the port's params hold it (a view of [V, d] storage);
    a head passed as a contiguous [d, V] tensor is copied to [V, d] on each
    call. `_plan` replaces :func:`lm_fwd_plan`'s (splits, tiles per split,
    grid), for checks that plant a bug in the walk."""
    if hidden.device.type == "cpu":
        return lm_stats_plain(hidden, w_lm, inv_temp)
    wT = _head_rows(hidden, w_lm, "lm_stats")
    n, d = hidden.shape
    V = w_lm.shape[1]
    lse = torch.empty(n, dtype=torch.float32, device=hidden.device)
    mean_x = torch.empty_like(lse)
    splits, per_split, grid = _plan or lm_fwd_plan(n, V, _sms(hidden.device))
    partials = torch.empty((3, splits, n), dtype=torch.float32, device=hidden.device)
    stream = torch.cuda.current_stream(hidden.device).cuda_stream
    code = _kernel_fn()(
        hidden.data_ptr(), wT.data_ptr(), partials[0].data_ptr(), partials[1].data_ptr(),
        partials[2].data_ptr(), lse.data_ptr(), mean_x.data_ptr(), n, d, V, splits, per_split, grid,
        float(inv_temp), stream,
    )
    _build.check(code, "lm_stats_fwd")
    _build.count_launch("lm_stats_fwd")
    return lse, mean_x


# ------------------------------------------------------------------ backward


def lm_stats_bwd_plain(hidden, w_lm, lse, mean_x, g_lse, g_ent, inv_temp: float = 1.0,
                       vocab_chunk: int = 16384):
    """(dhidden [n, d] like hidden, dWT [V, d] like w_lm) for the cotangents
    (g_lse, g_ent) of (lse, entropy): the vocab-chunked fp32 loop of the JAX
    package's ``_vc_bwd_rule``. Per chunk the logits x are recomputed and
    dl = exp(x − lse)·(a − b·x)·inv_temp, a = g_lse + g_ent·mean_x, b = g_ent,
    rounded to hidden's dtype; each dWT chunk is written once, dhidden sums
    over the chunks in fp32."""
    n, d = hidden.shape
    V = w_lm.shape[1]
    h = hidden.float()
    a = (g_lse + g_ent * mean_x).float()[:, None]
    b = g_ent.float()[:, None]
    dh = torch.zeros((n, d), dtype=torch.float32, device=hidden.device)
    dwT = torch.empty((V, d), dtype=w_lm.dtype, device=hidden.device)
    for c0 in range(0, V, vocab_chunk):
        wc = w_lm[:, c0:c0 + vocab_chunk].float()
        x = (h @ wc) * inv_temp
        p = torch.exp(x - lse[:, None])
        dl = (p * (a - b * x) * inv_temp).to(hidden.dtype).float()
        dwT[c0:c0 + vocab_chunk] = (dl.t() @ h).to(w_lm.dtype)
        dh += dl @ wc.t()
    return dh.to(hidden.dtype), dwT


def _bwd_kernel_fn():
    lib = _build.load("lm_stats_bwd")
    fn = lib.lm_stats_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 6 + [ctypes.c_float, p]
        fn.restype = i
    return fn


def lm_stats_bwd(hidden, w_lm, lse, mean_x, g_lse, g_ent, inv_temp: float = 1.0):
    """K9: (dhidden [n, d] like hidden, dWT [V, d] like w_lm), the analytic
    backward of ``lm_stats`` for the cotangents (g_lse, g_ent) of (lse,
    entropy). Reads the head as ``lm_stats`` does (wT = w_lm.T, free for a
    tied head). Allocates the bf16 dlogits scratch [n, V] (both rounded up
    to 128) for the duration of the call."""
    if hidden.device.type == "cpu":
        return lm_stats_bwd_plain(hidden, w_lm, lse, mean_x, g_lse, g_ent, inv_temp)
    wT = _head_rows(hidden, w_lm, "lm_stats_bwd")
    n, d = hidden.shape
    V = w_lm.shape[1]
    for name, t in (("lse", lse), ("mean_x", mean_x), ("g_lse", g_lse), ("g_ent", g_ent)):
        if t.shape != (n,) or t.device != hidden.device:
            raise ValueError(f"{name} must be [n] on hidden's device")
    dh = torch.empty_like(hidden)
    dwT = torch.empty((V, d), dtype=w_lm.dtype, device=hidden.device)
    lse = lse.float().contiguous()
    a = (g_lse.float() + g_ent.float() * mean_x.float()).contiguous()
    b = g_ent.float().contiguous()
    n_pad = -(-n // _PAD) * _PAD
    V_pad = -(-V // _PAD) * _PAD
    dl = torch.empty((n_pad, V_pad), dtype=torch.bfloat16, device=hidden.device)
    counter = torch.empty(1, dtype=torch.int32, device=hidden.device)
    stream = torch.cuda.current_stream(hidden.device).cuda_stream
    code = _bwd_kernel_fn()(
        hidden.data_ptr(), wT.data_ptr(), lse.data_ptr(), a.data_ptr(), b.data_ptr(),
        dl.data_ptr(), dh.data_ptr(), dwT.data_ptr(), counter.data_ptr(), n, d, V, n_pad, V_pad,
        _sms(hidden.device), float(inv_temp), stream,
    )
    _build.check(code, "lm_stats_bwd")
    _build.count_launch("lm_stats_bwd")
    return dh, dwT
