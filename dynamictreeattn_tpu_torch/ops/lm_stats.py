"""Fused LM-head softmax statistics, forward and backward: CUDA kernels +
plain versions.

Counterpart of ``dynamictreeattn_tpu/ops/lm_stats.py``:

* forward (K8, ``csrc/lm_stats_fwd.cu``): per row, the fp32 (lse, mean_x) of
  softmax(hidden @ w_lm * inv_temp), without materializing the [n, V]
  logits; entropy = lse − mean_x. The kernel splits rows × vocab over the
  card's SMs and merges the per-split partial (m, Σeˣ, Σeˣ·x) in a second
  small kernel pass;
* backward (K9, ``csrc/lm_stats_bwd.cu``): (dhidden, dWᵀ) for the cotangents
  (g_lse, g_ent) from the saved (lse, mean_x), recomputing the logits. The
  kernel writes the bf16 dlogits once and contracts them in two more passes
  (see the source for the design).

The TPU's row splits (``default_max_rows`` / ``_row_splits``) exist only for
its VMEM budget and are not carried over.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from dynamictreeattn_tpu_torch.ops import _build

__all__ = ["lm_stats", "lm_stats_bwd", "lm_stats_bwd_plain", "lm_stats_plain"]

_BLOCK_ROWS = 128  # rows per CTA of the kernel
_BLOCK_V = 128  # vocab columns per tile of the kernel
_DEPTH_CHUNK = 32  # hidden size must be a multiple of this
_BWD_TILE = 128  # the backward's output tiles: hidden size a multiple of this


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
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    return fn


def _n_splits(n: int, V: int, device: torch.device) -> int:
    """Vocab splits so that row tiles × splits give ~4 CTAs per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    row_tiles = -(-n // _BLOCK_ROWS)
    return max(1, min(-(-V // _BLOCK_V), -(-4 * sms // row_tiles)))


def lm_stats(hidden: torch.Tensor, w_lm: torch.Tensor, inv_temp: float = 1.0):
    """(lse [n], mean_x [n]) fp32 of softmax(hidden @ w_lm · inv_temp).

    hidden [n, d]; w_lm [d, V]. The kernel reads the head as wT = w_lm.T
    [V, d] row-major, which is free for a tied head (w_lm = embed.T) and for
    an untied head as the port's params hold it (a view of [V, d] storage);
    a head passed as a contiguous [d, V] tensor is copied to [V, d] on each
    call."""
    if hidden.device.type == "cpu":
        return lm_stats_plain(hidden, w_lm, inv_temp)
    n, d = hidden.shape
    V = w_lm.shape[1]
    if w_lm.shape[0] != d:
        raise ValueError(f"w_lm shape {tuple(w_lm.shape)} does not match hidden size {d}")
    if hidden.dtype != torch.bfloat16 or w_lm.dtype != torch.bfloat16:
        raise TypeError("lm_stats kernel takes bf16 hidden and w_lm")
    if d % _DEPTH_CHUNK:
        raise ValueError(f"hidden size {d} must be a multiple of {_DEPTH_CHUNK}")
    if w_lm.device != hidden.device:
        raise ValueError("hidden and w_lm must be on one device")
    wT = w_lm.t()
    if not wT.is_contiguous():
        wT = wT.contiguous()
    if not hidden.is_contiguous() or hidden.data_ptr() % 16 or wT.data_ptr() % 16:
        raise ValueError("lm_stats kernel inputs must be contiguous and 16-byte aligned")
    nsplit = _n_splits(n, V, hidden.device)
    partials = torch.empty((3, nsplit, n), dtype=torch.float32, device=hidden.device)
    lse = torch.empty(n, dtype=torch.float32, device=hidden.device)
    mean_x = torch.empty_like(lse)
    stream = torch.cuda.current_stream(hidden.device).cuda_stream
    code = _kernel_fn()(
        hidden.data_ptr(), wT.data_ptr(), partials[0].data_ptr(),
        partials[1].data_ptr(), partials[2].data_ptr(), lse.data_ptr(),
        mean_x.data_ptr(), n, d, V, nsplit, float(inv_temp), stream,
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
        fn.argtypes = [p] * 8 + [i] * 5 + [ctypes.c_float, p]
        fn.restype = i
    return fn


def lm_stats_bwd(hidden, w_lm, lse, mean_x, g_lse, g_ent, inv_temp: float = 1.0):
    """K9: (dhidden [n, d] like hidden, dWT [V, d] like w_lm), the analytic
    backward of ``lm_stats`` for the cotangents (g_lse, g_ent) of (lse,
    entropy). Reads the head as ``lm_stats`` does (wT = w_lm.T, free for a
    tied head). Allocates the bf16 dlogits scratch [n, V] (rounded up to
    128) for the duration of the call."""
    if hidden.device.type == "cpu":
        return lm_stats_bwd_plain(hidden, w_lm, lse, mean_x, g_lse, g_ent, inv_temp)
    n, d = hidden.shape
    V = w_lm.shape[1]
    if w_lm.shape[0] != d:
        raise ValueError(f"w_lm shape {tuple(w_lm.shape)} does not match hidden size {d}")
    if hidden.dtype != torch.bfloat16 or w_lm.dtype != torch.bfloat16:
        raise TypeError("lm_stats_bwd kernel takes bf16 hidden and w_lm")
    if d % _BWD_TILE:
        raise ValueError(f"hidden size {d} must be a multiple of {_BWD_TILE}")
    for name, t in (("lse", lse), ("mean_x", mean_x), ("g_lse", g_lse), ("g_ent", g_ent)):
        if t.shape != (n,) or t.device != hidden.device:
            raise ValueError(f"{name} must be [n] on hidden's device")
    wT = w_lm.t()
    if not wT.is_contiguous():
        wT = wT.contiguous()
    if not hidden.is_contiguous() or hidden.data_ptr() % 16 or wT.data_ptr() % 16:
        raise ValueError("lm_stats_bwd kernel inputs must be contiguous and 16-byte aligned")
    lse = lse.float().contiguous()
    a = (g_lse.float() + g_ent.float() * mean_x.float()).contiguous()
    b = g_ent.float().contiguous()
    n_pad = -(-n // _BWD_TILE) * _BWD_TILE
    V_pad = -(-V // _BWD_TILE) * _BWD_TILE
    dl = torch.empty((n_pad, V_pad), dtype=torch.bfloat16, device=hidden.device)
    dh = torch.empty_like(hidden)
    dwT = torch.empty((V, d), dtype=w_lm.dtype, device=hidden.device)
    stream = torch.cuda.current_stream(hidden.device).cuda_stream
    code = _bwd_kernel_fn()(
        hidden.data_ptr(), wT.data_ptr(), lse.data_ptr(), a.data_ptr(), b.data_ptr(),
        dl.data_ptr(), dh.data_ptr(), dwT.data_ptr(), n, d, V, n_pad, V_pad,
        float(inv_temp), stream,
    )
    _build.check(code, "lm_stats_bwd")
    _build.count_launch("lm_stats_bwd")
    return dh, dwT
