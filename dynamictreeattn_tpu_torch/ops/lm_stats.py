"""Fused LM-head softmax statistics forward: CUDA kernel + plain version.

Counterpart of the forward of ``dynamictreeattn_tpu/ops/lm_stats.py`` (K8):
per row, the fp32 (lse, mean_x) of softmax(hidden @ w_lm * inv_temp), without
materializing the [n, V] logits. Entropy = lse − mean_x.

The kernel (``csrc/lm_stats_fwd.cu``) splits rows × vocab over the card's
SMs and merges the per-split partial (m, Σeˣ, Σeˣ·x) in a second small kernel
pass. The TPU's row splits (``default_max_rows`` / ``_row_splits``) exist only
for its VMEM budget and are not carried over.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from dynamictreeattn_tpu_torch.ops import _build

__all__ = ["lm_stats", "lm_stats_plain"]

_BLOCK_ROWS = 128  # rows per CTA of the kernel
_BLOCK_V = 128  # vocab columns per tile of the kernel
_DEPTH_CHUNK = 32  # hidden size must be a multiple of this


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
