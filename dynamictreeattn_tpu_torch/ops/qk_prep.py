"""Fused q/k/v attention-input prep: per-head RMSNorm · w, RoPE and the
head-major transpose, forward and backward: CUDA kernels + plain versions.

Counterpart of ``dynamictreeattn_tpu/ops/qk_prep.py`` (kernels in
``csrc/qk_prep.cu``):

* K4 ``qk_prep_fwd_q``: q [n, H·dh] → fp32 RMSNorm over each head's dh
  values · w → RoPE (HF rotate-half) → [H, n, dh] in q's dtype;
* K5 ``qk_prep_fwd_kv``: the same for k, and v transposed to [H, n, dh];
* K6 ``qk_prep_bwd_q``: g [H, n, dh] → RoPEᵀ → RMSNorm vjp
  dx = r·(du − u·mean(du·u)), du = g'·w → [n, H·dh], and the fp32 norm-weight
  grad dw [dh] summed over rows and heads (a deterministic two-pass sum);
* K7 ``qk_prep_bwd_kv``: the same for k, and dv transposed back.

Numerics are the fused JAX path's: fp32 from the load to one rounding at the
store, so the normed q/k are not rounded before RoPE (the unfused chain in
``models/qwen3.py`` rounds them; the two differ by up to one ulp).
``qkv_prep`` ties the four together as an autograd function.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from dynamictreeattn_tpu_torch.ops import _build

__all__ = [
    "qk_prep_bwd_kv", "qk_prep_bwd_kv_plain", "qk_prep_bwd_q", "qk_prep_bwd_q_plain",
    "qk_prep_fwd_kv", "qk_prep_fwd_kv_plain", "qk_prep_fwd_q", "qk_prep_fwd_q_plain",
    "qkv_prep", "qkv_prep_plain",
]

_KERNEL_HEAD_DIMS = (64, 128)


def _rot(x: torch.Tensor) -> torch.Tensor:
    """rotate_half, HF layout: [x1, x2] -> [-x2, x1]."""
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _heads(x: torch.Tensor, dh: int) -> torch.Tensor:
    """[n, H·dh] -> fp32 [n, H, dh]."""
    return x.float().reshape(x.shape[0], -1, dh)


def _norm_rope_fwd(x, w, cos, sin, eps, use_norm):
    """fp32 [n, H, dh] -> fp32 [n, H, dh]: the JAX ``_norm_rope_fwd``."""
    if use_norm:
        r = torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
        x = x * r * w.float()
    return x * cos.float()[:, None] + _rot(x) * sin.float()[:, None]


def _norm_rope_bwd(g, x, w, cos, sin, eps, use_norm):
    """(dx fp32 [n, H, dh], dw fp32 [dh] | None): the JAX ``_norm_rope_bwd``
    for cotangent g [n, H, dh], the weight grad summed over rows and heads."""
    gp = g * cos.float()[:, None] - _rot(g) * sin.float()[:, None]  # RoPEᵀ
    if not use_norm:
        return gp, None
    r = torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    u = x * r
    dw = torch.sum(gp * u, dim=(0, 1))
    du = gp * w.float()
    dx = r * (du - u * (torch.sum(du * u, dim=-1, keepdim=True) / x.shape[-1]))
    return dx, dw


def qk_prep_fwd_q_plain(q, w, cos, sin, eps: float, use_norm: bool):
    """[H, n, dh] like q: RMSNorm · w (if use_norm) and RoPE of q [n, H·dh]."""
    out = _norm_rope_fwd(_heads(q, cos.shape[-1]), w, cos, sin, eps, use_norm)
    return out.to(q.dtype).transpose(0, 1).contiguous()


def qk_prep_fwd_kv_plain(k, v, w, cos, sin, eps: float, use_norm: bool):
    """(k [H, n, dh], v [H, n, dh]): K4's function on k, v transposed."""
    dh = cos.shape[-1]
    vo = v.reshape(v.shape[0], -1, dh).transpose(0, 1).contiguous()
    return qk_prep_fwd_q_plain(k, w, cos, sin, eps, use_norm), vo


def qk_prep_bwd_q_plain(g, q, w, cos, sin, eps: float, use_norm: bool):
    """(dq [n, H·dh] like q, dw fp32 [dh] | None) for cotangent g [H, n, dh]."""
    dh = cos.shape[-1]
    x = _heads(q, dh) if use_norm else None
    dx, dw = _norm_rope_bwd(g.float().transpose(0, 1), x, w, cos, sin, eps, use_norm)
    return dx.reshape(q.shape).to(q.dtype), dw


def qk_prep_bwd_kv_plain(gk, gv, k, w, cos, sin, eps: float, use_norm: bool):
    """(dk, dv [n, H·dh] like k, dw fp32 [dh] | None): K6's function on k,
    dv = gv transposed back."""
    dk, dw = qk_prep_bwd_q_plain(gk, k, w, cos, sin, eps, use_norm)
    return dk, gv.transpose(0, 1).reshape(k.shape).to(k.dtype), dw


def qkv_prep_plain(q, k, v, qw, kw, cos, sin, eps: float, use_norm: bool):
    """The plain forward of ``qkv_prep``: (q [hq, n, dh], k, v [hkv, n, dh])."""
    return (qk_prep_fwd_q_plain(q, qw, cos, sin, eps, use_norm),
            *qk_prep_fwd_kv_plain(k, v, kw, cos, sin, eps, use_norm))


# ------------------------------------------------------------------- kernels


def _lib():
    lib = _build.load("qk_prep")
    if lib.qk_prep_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qk_prep_fwd.argtypes = [p] * 7 + [i] * 4 + [ctypes.c_float, p]
        lib.qk_prep_fwd.restype = i
        lib.qk_prep_bwd.argtypes = [p] * 10 + [i] * 4 + [ctypes.c_float, p]
        lib.qk_prep_bwd.restype = i
        lib.qk_prep_bwd_parts.argtypes = [i, i, i]
        lib.qk_prep_bwd_parts.restype = i
    return lib


def _check(x, w, cos, sin, *others):
    """(n, H, dh) of x [n, H·dh]; raises on what the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"qk-prep kernels run on CUDA tensors, not {x.device}")
    n, hdh = x.shape
    dh = cos.shape[-1]
    if dh not in _KERNEL_HEAD_DIMS or hdh % dh:
        raise ValueError(f"qk-prep kernels take head_dim in {_KERNEL_HEAD_DIMS} and "
                         f"[n, H*head_dim] inputs, got {tuple(x.shape)} with head_dim {dh}")
    if cos.shape != (n, dh) or sin.shape != (n, dh) or w.shape != (dh,):
        raise ValueError("cos, sin must be [n, head_dim] and w [head_dim]")
    if cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise TypeError("qk-prep kernels take fp32 cos/sin")
    for t in (x, w, *others):
        if t.dtype != torch.bfloat16:
            raise TypeError("qk-prep kernels take bf16 activations and norm weights")
    for t in (x, w, cos, sin, *others):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("qk-prep kernel inputs must be contiguous, 16-byte aligned, "
                             "on one device")
    return n, hdh // dh, dh


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def qk_prep_fwd_q(q, w, cos, sin, eps: float, use_norm: bool):
    """K4: [H, n, dh] like q (see ``qk_prep_fwd_q_plain``)."""
    if q.device.type == "cpu":
        return qk_prep_fwd_q_plain(q, w, cos, sin, eps, use_norm)
    n, H, dh = _check(q, w, cos, sin)
    out = torch.empty((H, n, dh), dtype=q.dtype, device=q.device)
    code = _lib().qk_prep_fwd(q.data_ptr(), None, w.data_ptr(), cos.data_ptr(),
                              sin.data_ptr(), out.data_ptr(), None, n, H, dh, int(use_norm),
                              float(eps), _stream(q))
    _build.check(code, "qk_prep_fwd_q")
    _build.count_launch("qk_prep_fwd_q")
    return out


def qk_prep_fwd_kv(k, v, w, cos, sin, eps: float, use_norm: bool):
    """K5: (k [H, n, dh], v [H, n, dh]) (see ``qk_prep_fwd_kv_plain``)."""
    if k.device.type == "cpu":
        return qk_prep_fwd_kv_plain(k, v, w, cos, sin, eps, use_norm)
    n, H, dh = _check(k, w, cos, sin, v)
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} must have k's shape {tuple(k.shape)}")
    ko = torch.empty((H, n, dh), dtype=k.dtype, device=k.device)
    vo = torch.empty_like(ko)
    code = _lib().qk_prep_fwd(k.data_ptr(), v.data_ptr(), w.data_ptr(), cos.data_ptr(),
                              sin.data_ptr(), ko.data_ptr(), vo.data_ptr(), n, H, dh,
                              int(use_norm), float(eps), _stream(k))
    _build.check(code, "qk_prep_fwd_kv")
    _build.count_launch("qk_prep_fwd_kv")
    return ko, vo


def _launch_bwd(name, g, gv, x, w, cos, sin, eps, use_norm):
    n, H, dh = _check(x, w, cos, sin, g, *(() if gv is None else (gv,)))
    for t in (g, gv):
        if t is not None and t.shape != (H, n, dh):
            raise ValueError(f"{name}: cotangents must be [{H}, {n}, {dh}], got {tuple(t.shape)}")
    lib = _lib()
    dx = torch.empty_like(x)
    dv = None if gv is None else torch.empty_like(x)
    dw = part = None
    if use_norm:
        part = torch.empty((lib.qk_prep_bwd_parts(n, H, dh), dh), dtype=torch.float32,
                           device=x.device)
        dw = torch.empty(dh, dtype=torch.float32, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    code = lib.qk_prep_bwd(g.data_ptr(), ptr(gv), x.data_ptr(), w.data_ptr(), cos.data_ptr(),
                           sin.data_ptr(), dx.data_ptr(), ptr(dv), ptr(part), ptr(dw), n, H, dh,
                           int(use_norm), float(eps), _stream(x))
    _build.check(code, name)
    _build.count_launch(name)
    return dx, dv, dw


def qk_prep_bwd_q(g, q, w, cos, sin, eps: float, use_norm: bool):
    """K6: (dq [n, H·dh] like q, dw fp32 [dh] | None) (see
    ``qk_prep_bwd_q_plain``)."""
    if q.device.type == "cpu":
        return qk_prep_bwd_q_plain(g, q, w, cos, sin, eps, use_norm)
    dq, _, dw = _launch_bwd("qk_prep_bwd_q", g, None, q, w, cos, sin, eps, use_norm)
    return dq, dw


def qk_prep_bwd_kv(gk, gv, k, w, cos, sin, eps: float, use_norm: bool):
    """K7: (dk, dv [n, H·dh] like k, dw fp32 [dh] | None) (see
    ``qk_prep_bwd_kv_plain``)."""
    if k.device.type == "cpu":
        return qk_prep_bwd_kv_plain(gk, gv, k, w, cos, sin, eps, use_norm)
    return _launch_bwd("qk_prep_bwd_kv", gk, gv, k, w, cos, sin, eps, use_norm)


class _QKVPrep(torch.autograd.Function):
    """Counterpart of the JAX package's ``jax.custom_vjp`` ``qkv_prep``:
    forward K4 + K5, backward K6 + K7 from the saved (q, k, qw, kw, cos,
    sin)."""

    @staticmethod
    def forward(ctx, q, k, v, qw, kw, cos, sin, eps, use_norm):
        qo = qk_prep_fwd_q(q, qw, cos, sin, eps, use_norm)
        ko, vo = qk_prep_fwd_kv(k, v, kw, cos, sin, eps, use_norm)
        ctx.save_for_backward(q, k, qw, kw, cos, sin)
        ctx.eps, ctx.use_norm = eps, use_norm
        return qo, ko, vo

    @staticmethod
    def backward(ctx, gq, gk, gv):
        q, k, qw, kw, cos, sin = ctx.saved_tensors
        eps, use_norm = ctx.eps, ctx.use_norm
        dq, dqw = qk_prep_bwd_q(gq.contiguous(), q, qw, cos, sin, eps, use_norm)
        dk, dv, dkw = qk_prep_bwd_kv(gk.contiguous(), gv.contiguous(), k, kw, cos, sin, eps,
                                     use_norm)
        if use_norm:
            dqw, dkw = dqw.to(qw.dtype), dkw.to(kw.dtype)
        # cos/sin derive from integer positions: no grad
        return dq, dk, dv, dqw, dkw, None, None, None, None


def qkv_prep(q, k, v, qw, kw, cos, sin, eps: float, use_norm: bool):
    """(q [n, hq·dh], k [n, hkv·dh], v [n, hkv·dh]) → (q [hq, n, dh], k, v
    [hkv, n, dh]), differentiable in q, k, v, qw, kw.

    Fused per-head RMSNorm (weights qw/kw [dh]) + RoPE (cos/sin fp32
    [n, dh]) + head-major transpose; v is transposed only. With
    use_norm=False (Qwen2.5 / Llama) qw/kw are not read and get no grad."""
    return _QKVPrep.apply(q, k, v, qw, kw, cos, sin, float(eps), bool(use_norm))
