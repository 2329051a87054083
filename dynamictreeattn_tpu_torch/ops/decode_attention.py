"""Grouped-decode attention: one decode token for G branches of each of P
prompts: CUDA kernel + plain version.

Counterpart of ``dynamictreeattn_tpu/ops/decode_attention.py`` (K13, the TPU
kernel ``_decode_kernel``). Each branch's current query attends to the
visible columns of its row:

* its prompt's columns < plen[p] of the frozen prompt cache kp/vp
  [P, hkv, Lp, dh], shared by the prompt's G branches;
* its own completion columns < t of the branch cache kc/vc
  [P, G, hkv, Nc, dh] (never a neighbour branch's);
* the current token itself (the self column, k_self/v_self), whose (k, v)
  the sampler writes into slot t after the step.

Scores and softmax statistics are fp32; P is rounded to the value dtype
before the PV product, as on the TPU. Columns >= plen and >= t are neither
used nor read, so Lp and Nc need not be chunk multiples (the TPU kernel needs
them padded).

t is a host int or a one-element int32 tensor on q's device: the TPU kernel
reads t by scalar prefetch, and so the kernel here reads it from device
memory, so that a decode step that holds it can be captured once as a CUDA
graph and replayed at every t (``models/generate.py``).

* ``decode_attention_grouped_plain``: the blocked PyTorch version — fp32
  (acc, m, l) carried over prompt column chunks, then branch column chunks,
  then merged with the self column (the JAX launcher's merge). It reads a
  tensor t with ``int()``.
* CUDA (``csrc/decode_attn.cu``): one launch. Its grid and fp32 workspace
  are sized for the branch cache's width Nc, not for t; units past plen or t
  return at once. Each unit (a 128-column chunk of a prompt's cache for all
  G·grp rows of a kv head, or of one branch's cache for its grp rows) brings
  its whole chunk in by TMA bulk copies, runs tensor-core products over live
  16-row bands only and writes an fp32 (acc, m, l) partial per row; the last
  unit to arrive at a (prompt, branch, kv head) — an arrival counter that it
  leaves at zero — merges that group's partials with its self column in a
  fixed order (no atomics in any sum: two launches, and a graph replay and an
  eager launch, are bit-equal). The counters live in one zeroed int32 buffer
  per (device, P·G·hkv), kept for the process: calls that share it run on
  one stream.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from dynamictreeattn_tpu_torch.ops import _build

__all__ = ["decode_attention_grouped", "decode_attention_grouped_plain"]

# prompt / branch columns of one partial; the CUDA source's CHUNK
PROMPT_CHUNK = 128
BRANCH_CHUNK = 128
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_MAX_GROUP = 8


def decode_attention_grouped_plain(q, k_self, v_self, kp, vp, kc, vc, plens, t, *,
                                   scale: float | None = None):
    """o [P, G, hq, dh] in q's dtype: softmax(q·Kᵀ·scale)·V over each
    branch's visible columns (see the module docstring). One host read of
    `plens` (and of `t`, when it is a tensor); only the live columns are
    sliced, so the padding and the columns >= t are never read."""
    t = int(t)
    P, G, hq, dh = q.shape
    hkv = kp.shape[1]
    grp = hq // hkv
    scale = dh**-0.5 if scale is None else float(scale)
    qf = q.float().reshape(P, G, hkv, grp, dh).transpose(1, 2)  # [P, hkv, G, grp, dh]
    out = torch.empty(qf.shape, dtype=torch.float32, device=q.device)
    for p, plen in enumerate(plens.tolist()):
        qp = qf[p]
        m = torch.full(qp.shape[:-1], float("-inf"), device=q.device)
        l = torch.zeros(qp.shape[:-1], device=q.device)
        acc = torch.zeros(qp.shape, device=q.device)

        def update(k, v):
            # k, v [hkv, 1 or G, C, dh]: one chunk of columns, online softmax
            nonlocal m, l, acc
            st = qp @ k.float().transpose(-1, -2) * scale  # [hkv, G, grp, C]
            m_next = torch.maximum(m, st.amax(-1))
            alpha = torch.exp(m - m_next)
            pe = torch.exp(st - m_next[..., None])
            l = alpha * l + pe.sum(-1)
            acc = acc * alpha[..., None] + pe.to(v.dtype).float() @ v.float()
            m = m_next

        plen = min(plen, kp.shape[2])
        for c0 in range(0, plen, PROMPT_CHUNK):
            cols = slice(c0, min(c0 + PROMPT_CHUNK, plen))
            update(kp[p, :, None, cols], vp[p, :, None, cols])
        for c0 in range(0, t, BRANCH_CHUNK):
            cols = slice(c0, min(c0 + BRANCH_CHUNK, t))
            update(kc[p, :, :, cols].transpose(0, 1), vc[p, :, :, cols].transpose(0, 1))
        ks = k_self[p].float().transpose(0, 1)  # [hkv, G, dh]
        vs = v_self[p].float().transpose(0, 1)
        s_self = (qp * ks[:, :, None, :]).sum(-1) * scale  # [hkv, G, grp]
        m_tot = torch.maximum(m, s_self)
        sc, ss = torch.exp(m - m_tot), torch.exp(s_self - m_tot)
        out[p] = (sc[..., None] * acc + ss[..., None] * vs[:, :, None, :]) / (sc * l + ss)[..., None]
    return out.transpose(1, 2).reshape(P, G, hq, dh).to(q.dtype)


# -------------------------------------------------------------------- kernel


def _kernel_fn():
    fn = _build.load("decode_attn").decode_attn
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 12 + [i] * 8 + [ctypes.c_float, p]
        fn.restype = i
    return fn


def _check(q, k_self, v_self, kp, vp, kc, vc, plens, t):
    """What the CUDA kernel refuses."""
    if q.device.type != "cuda":
        raise ValueError(f"the decode-attention kernel runs on CUDA tensors, not {q.device}")
    P, G, hq, dh = q.shape
    hkv, Lp = kp.shape[1], kp.shape[2]
    Nc = kc.shape[3]
    if dh not in _KERNEL_HEAD_DIMS or hq % hkv or not 1 <= hq // hkv <= _KERNEL_MAX_GROUP:
        raise ValueError(f"decode-attention kernel takes head_dim in {_KERNEL_HEAD_DIMS} and GQA "
                         f"groups 1..{_KERNEL_MAX_GROUP}, got head_dim {dh}, heads {hq}/{hkv}")
    shapes = {"k_self": (k_self, (P, G, hkv, dh)), "v_self": (v_self, (P, G, hkv, dh)),
              "kp": (kp, (P, hkv, Lp, dh)), "vp": (vp, (P, hkv, Lp, dh)),
              "kc": (kc, (P, G, hkv, Nc, dh)), "vc": (vc, (P, G, hkv, Nc, dh))}
    for name, (x, want) in shapes.items():
        if tuple(x.shape) != want:
            raise ValueError(f"{name} shape {tuple(x.shape)} != {want}")
    for x in (q, k_self, v_self, kp, vp, kc, vc):
        if x.dtype != torch.bfloat16:
            raise TypeError("decode-attention kernel takes bf16 q, k, v and caches")
    if plens.dtype != torch.int32 or tuple(plens.shape) != (P,):
        raise ValueError(f"plens must be int32 [{P}]")
    if isinstance(t, torch.Tensor):
        if t.dtype != torch.int32 or t.numel() != 1 or t.device != q.device:
            raise ValueError(f"a tensor t must be one int32 on {q.device} (the kernel clamps it to "
                             f"[0, {Nc}]), got {t.dtype} {tuple(t.shape)} on {t.device}")
    elif not 0 <= t <= Nc:
        raise ValueError(f"t={t} outside the branch cache's [0, {Nc}]")
    for x in (q, k_self, v_self, kp, vp, kc, vc, plens):
        if x.device != q.device:
            raise ValueError("all inputs must be on one device")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("kernel inputs must be contiguous and 16-byte aligned")


_COUNTERS: dict[tuple[int | None, int], torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The kernel's zeroed arrival counters for `n` (prompt, branch, kv
    head) groups on `device`. Each call leaves them zero; kept for the
    process, never replaced, so a captured launch's address stays valid."""
    key = (device.index, n)
    buf = _COUNTERS.get(key)
    if buf is None:
        buf = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return buf


def decode_attention_grouped(q, k_self, v_self, kp, vp, kc, vc, plens, t, *,
                             scale: float | None = None):
    """K13. o [P, G, hq, dh] in q's dtype.

    q [P, G, hq, dh] post-RoPE queries of the current token; k_self, v_self
    [P, G, hkv, dh] its keys and values; kp, vp [P, hkv, Lp, dh] the frozen
    prompt cache; kc, vc [P, G, hkv, Nc, dh] the branch caches, columns < t
    live; plens int32 [P] in [1, Lp] (the kernel clamps to [0, Lp]); t a
    host int in [0, Nc] or one int32 on q's device (the kernel clamps it to
    [0, Nc])."""
    if q.device.type == "cpu":
        return decode_attention_grouped_plain(q, k_self, v_self, kp, vp, kc, vc, plens, t,
                                              scale=scale)
    if not isinstance(t, torch.Tensor):
        t = int(t)
    _check(q, k_self, v_self, kp, vp, kc, vc, plens, t)
    P, G, hq, dh = q.shape
    hkv, Lp, Nc = kp.shape[1], kp.shape[2], kc.shape[3]
    grp = hq // hkv
    scale = dh**-0.5 if scale is None else float(scale)
    # fp32 partials: [acc of every prompt row | acc of every branch row | m, l of each]
    prompt_rows = P * hkv * -(-Lp // PROMPT_CHUNK) * G * grp
    branch_rows = P * G * hkv * -(-Nc // BRANCH_CHUNK) * grp
    ws = torch.empty((prompt_rows + branch_rows) * (dh + 2), dtype=torch.float32, device=q.device)
    o = torch.empty_like(q)
    t_dev, t_host = (t.data_ptr(), 0) if isinstance(t, torch.Tensor) else (None, t)
    code = _kernel_fn()(
        q.data_ptr(), k_self.data_ptr(), v_self.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        kc.data_ptr(), vc.data_ptr(), plens.data_ptr(), t_dev, ws.data_ptr(),
        _counters(q.device, P * G * hkv).data_ptr(), o.data_ptr(),
        P, G, hq, hkv, dh, Lp, Nc, t_host, scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(code, "decode_attn")
    _build.count_launch("decode_attn")
    return o
