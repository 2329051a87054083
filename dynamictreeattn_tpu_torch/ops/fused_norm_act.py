"""The model step's elementwise chain, RMSNorm and SwiGLU, forward and
backward: CUDA kernels + plain versions.

No counterpart among the JAX package's kernels: the JAX model writes
``rms_norm`` and ``silu(gate) * up`` as plain jnp, which XLA fuses on the
TPU. Eager PyTorch runs each as a chain of passes over memory
(:func:`rms_norm_plain`, :func:`swiglu_plain`: the port's model ran these
before the kernels) and autograd takes each apart again in the backward.
The kernels (``csrc/fused_norm_act.cu``) read each input once and write
each output once:

* N1 ``rms_norm_fwd``: y = R(R32(x·rstd)·w), rstd = rsqrt(mean(x²) + eps)
  in fp32, one a row, kept for N2 (R rounds to x's dtype);
* N2 ``rms_norm_bwd``: dx = R(rstd·(w·dy − x̂·mean(w·dy·x̂))), x̂ = x·rstd,
  and dw = Σ over rows of dy·x̂: fp32 partials, one a CTA, summed in a fixed
  order by a second, small launch, so dw repeats bit-equal;
* S1 ``swiglu_fwd``: y = R(R(silu(a))·b), the plain chain's rounding points;
* S2 ``swiglu_bwd``: db = R(dy·act), da = R(silu'(a)·R(dy·b)), act
  recomputed from a.

:func:`rms_norm` and :func:`swiglu` are what the models call: on a CPU
tensor the plain chain (autograd through it), on a CUDA tensor the autograd
functions over the kernels. Those functions (:func:`rms_norm_fused`,
:func:`swiglu_fused`) also run on the CPU, where their forward and
backward are the plain versions of the kernels' formulas
(:func:`rms_norm_fwd_plain`, :func:`rms_norm_bwd_plain`,
:func:`swiglu_plain`, :func:`swiglu_bwd_plain`; dw summed in the
kernel's block order), so that the CPU tests hold the backward formulas and
the wrappers' shape handling against autograd. Given a CUDA tensor a
wrapper launches its kernel or raises: bf16 and fp32 only, one dtype for x
and w (a and b).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dynamictreeattn_tpu_torch.ops import _build

__all__ = [
    "BWD_CTAS_PER_SM", "BWD_VECS", "DW_SLICES", "FWD_VECS", "NT", "bwd_grid", "norm_plan",
    "rms_norm", "rms_norm_bwd", "rms_norm_bwd_plain", "rms_norm_fused", "rms_norm_fwd", "rms_norm_fwd_plain",
    "rms_norm_plain", "swiglu", "swiglu_bwd", "swiglu_bwd_plain", "swiglu_fused", "swiglu_fwd",
    "swiglu_plain",
]

NT = 256  # threads a CTA (csrc/fused_norm_act.cu)
VEC_BYTES = 16  # a vector load or store
FWD_VECS, BWD_VECS = 4, 2  # N1 / N2 hold a row at this many vectors a thread, up to NT threads
MAX_NV = 8  # and at most this many past NT threads
MAX_NORM_WIDTH = 12288  # N2 keeps the CTA's dw row (fp32) in 48 KB of shared memory
BWD_CTAS_PER_SM = 2  # N2's persistent grid: at most SMs x this at <= BWD_VECS vectors a thread, else SMs
DW_SLICES = 8  # the dw sum: slices of the CTAs' partials, each summed in order
ACT_CTAS_PER_SM = 8  # S1 / S2: a grid-stride loop over at most SMs x this CTAs
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_SMS: dict = {}


# --------------------------------------------------------------------- plan


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def norm_plan(d: int, elem_bytes: int, per_thread: int = FWD_VECS) -> tuple[int, int]:
    """(tpr, nv): the threads that hold one row of `d` elements of
    `elem_bytes` each, and the 16-byte vectors each thread holds: the fewest
    threads, a power of two, at `per_thread` vectors a thread (FWD_VECS for
    N1, BWD_VECS for N2), at most NT; nv a power of two, at most MAX_NV.
    Raises on a width the kernels do not take."""
    vec = VEC_BYTES // elem_bytes
    if d < 1 or d % vec or d > MAX_NORM_WIDTH:
        raise ValueError(f"the RMSNorm kernels take widths that are multiples of {vec} up to {MAX_NORM_WIDTH}, "
                         f"got {d}")
    vecs = d // vec
    tpr = min(NT, _pow2(-(-vecs // per_thread)))
    nv = _pow2(-(-vecs // tpr))
    if nv > MAX_NV:
        raise ValueError(f"a row of {d} elements of {elem_bytes} bytes needs {nv} vectors a thread "
                         f"(the kernels hold at most {MAX_NV})")
    return tpr, nv


def bwd_grid(rows: int, tpr: int, nv: int, sms: int) -> int:
    """N2's CTAs: one a slot of NT // tpr rows, at most as many as fit on
    the `sms` SMs at once (BWD_CTAS_PER_SM an SM up to BWD_VECS vectors a
    thread, one past that)."""
    slots = -(-rows // (NT // tpr))
    return max(1, min(slots, sms * (BWD_CTAS_PER_SM if nv <= BWD_VECS else 1)))


# -------------------------------------------------------------------- plain


def rms_norm_fwd_plain(x: torch.Tensor, w: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """N1's function: (y like x, rstd fp32 [rows]); y is the eager chain,
    an fp32 mean of squares, rsqrt, two multiplies, one cast to x's dtype."""
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * r * w.float()).to(x.dtype), r.reshape(-1)


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """The eager chain (:func:`rms_norm_fwd_plain`'s y)."""
    return rms_norm_fwd_plain(x, weight, eps)[0]


def _block_order_sum(contrib: torch.Tensor, tpr: int, nv: int, sms: int) -> torch.Tensor:
    """Σ over rows of contrib [rows, d] (fp32) in N2's order: CTA c sums
    its row group's rows of slots c, c + grid, ... in order, then its groups
    in order; the dw launch sums the CTAs' partials in DW_SLICES slices (CTAs
    s, s + DW_SLICES, ...), each in order, then the slices in order."""
    rows, d = contrib.shape
    if not rows:
        return contrib.new_zeros(d)
    per_cta = NT // tpr
    grid = bwd_grid(rows, tpr, nv, sms)
    slots = -(-rows // per_cta)
    rounds = -(-slots // grid)
    padded = contrib.new_zeros(rounds * grid * per_cta, d)
    padded[:rows] = contrib
    padded = padded.view(rounds, grid, per_cta, d)
    acc = padded[0].clone()
    for t in range(1, rounds):
        acc += padded[t]
    part = acc[:, 0].clone()  # [grid, d]
    for g in range(1, per_cta):
        part += acc[:, g]
    sliced = part.new_zeros(-(-grid // DW_SLICES) * DW_SLICES, d)
    sliced[:grid] = part
    sliced = sliced.view(-1, DW_SLICES, d)
    s = sliced[0].clone()
    for k in range(1, sliced.shape[0]):
        s += sliced[k]
    total = s[0].clone()
    for k in range(1, DW_SLICES):
        total += s[k]
    return total


def rms_norm_bwd_plain(x: torch.Tensor, w: torch.Tensor, rstd: torch.Tensor, dy: torch.Tensor,
                       sms: int = 132) -> tuple[torch.Tensor, torch.Tensor]:
    """N2's function: (dx like x, dw like w) from the forward's rstd, in
    fp32 with one rounding each; dw summed in the kernel's block order at
    `sms` SMs (:func:`_block_order_sum`)."""
    d = x.shape[-1]
    xf, gf = x.reshape(-1, d).float(), dy.reshape(-1, d).float()
    r = rstd.reshape(-1, 1)
    xh = xf * r
    gw = gf * w.float()
    m = torch.sum(gw * xh, dim=-1, keepdim=True) * (1.0 / d)
    dx = (r * (gw - xh * m)).to(x.dtype).view(x.shape)
    tpr, nv = norm_plan(d, x.element_size(), BWD_VECS)
    return dx, _block_order_sum(gf * xh, tpr, nv, sms).to(w.dtype)


def swiglu_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The eager chain: silu in fp32, a cast to b's dtype, a multiply."""
    return F.silu(a.to(torch.promote_types(a.dtype, torch.float32))).to(b.dtype) * b


def swiglu_bwd_plain(a: torch.Tensor, b: torch.Tensor, dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """S2's function: (da like a, db like b), ATen's silu_backward at the
    eager chain's rounding points."""
    af = a.to(torch.promote_types(a.dtype, torch.float32))
    s = 1 / (1 + torch.exp(-af))
    act = F.silu(af).to(b.dtype)
    dact = (dy * b).to(af.dtype)
    return (dact * s * (1 + af * (1 - s))).to(a.dtype), dy * act


# ------------------------------------------------------------------- kernel


def _lib():
    lib = _build.load("fused_norm_act")
    if lib.rmsnorm_fwd.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.rmsnorm_fwd.argtypes = [p, ll, p, p, p, ll, i, i, i, f, f, i, p]
        lib.rmsnorm_bwd.argtypes = [p, ll, p, p, p, ll, p, p, ll, i, i, i, i, f, i, p]
        lib.rmsnorm_dw.argtypes = [p, i, i, p, i, p]
        lib.swiglu_fwd.argtypes = [p, p, p, ll, i, i, i, p]
        lib.swiglu_bwd.argtypes = [p, p, p, p, p, ll, i, i, i, p]
        for fn in (lib.rmsnorm_fwd, lib.rmsnorm_bwd, lib.rmsnorm_dw, lib.swiglu_fwd, lib.swiglu_bwd):
            fn.restype = i
    return lib


def _sms(device: torch.device) -> int:
    n = _SMS.get(device)
    if n is None:
        n = _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _dtype(t: torch.Tensor, what: str) -> int:
    if t.device.type != "cuda":
        raise ValueError(f"the {what} kernels run on CUDA tensors, not {t.device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"the {what} kernels take bf16 and fp32, not {t.dtype}")
    return _DTYPES[t.dtype]


def _rows(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(t as [rows, d] with unit column stride, 16-byte aligned rows, its row
    stride): a view where one exists, else a dense copy."""
    d = t.shape[-1]
    t2 = t.reshape(-1, d)
    vec = VEC_BYTES // t.element_size()
    rows = t2.shape[0]
    if ((d > 1 and t2.stride(-1) != 1) or (rows > 1 and (t2.stride(0) % vec or t2.stride(0) < d))
            or t2.data_ptr() % VEC_BYTES):
        t2 = t2.clone(memory_format=torch.contiguous_format)
    return t2, (t2.stride(0) if rows > 1 else d)


def _norm_args(x: torch.Tensor, w: torch.Tensor, per_thread: int):
    """(dtype code, x as rows, its row stride, w dense, tpr, nv) after the
    kernels' checks, the row plan at `per_thread` vectors a thread."""
    code = _dtype(x, "RMSNorm")
    d = x.shape[-1]
    if w.dtype != x.dtype or w.shape != (d,) or w.device != x.device:
        raise ValueError(f"the RMSNorm kernels take a [{d}] weight of x's dtype on x's device, got "
                         f"{w.dtype} {tuple(w.shape)} on {w.device} for x {x.dtype}")
    tpr, nv = norm_plan(d, x.element_size(), per_thread)
    if w.stride(0) != 1 or w.data_ptr() % VEC_BYTES:
        w = w.clone(memory_format=torch.contiguous_format)
    x2, xs = _rows(x)
    return code, x2, xs, w, tpr, nv


def rms_norm_fwd(x: torch.Tensor, w: torch.Tensor, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """N1: (y [x's shape], dense, rstd fp32 [rows]); the plain version on a
    CPU tensor."""
    if x.device.type == "cpu":
        return rms_norm_fwd_plain(x, w, eps)
    code, x2, xs, w, tpr, nv = _norm_args(x, w, FWD_VECS)
    rows, d = x2.shape
    y = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows:
        _build.check(_lib().rmsnorm_fwd(x2.data_ptr(), xs, w.data_ptr(), y.data_ptr(), rstd.data_ptr(), rows, d,
                                        tpr, nv, 1.0 / d, float(eps), code, _stream(x)), "rmsnorm_fwd")
        _build.count_launch("rms_norm_fwd")
    return y.view(x.shape), rstd


def rms_norm_bwd(x: torch.Tensor, w: torch.Tensor, rstd: torch.Tensor,
                 dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """N2: (dx [x's shape], dense, dw like w) from the forward's rstd; two
    launches, the rows and the dw sum. The plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, w, rstd, dy)
    code, x2, xs, w, tpr, nv = _norm_args(x, w, BWD_VECS)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} must have x's dtype and shape {tuple(x.shape)}")
    rows, d = x2.shape
    if rstd.shape != (rows,) or rstd.dtype != torch.float32 or not rstd.is_contiguous():
        raise ValueError(f"rstd must be fp32 [{rows}], dense, got {rstd.dtype} {tuple(rstd.shape)}")
    g2, gs = _rows(dy)
    dx = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    dw = torch.empty(d, dtype=w.dtype, device=x.device)
    if not rows:
        return dx.view(x.shape), dw.zero_()
    grid = bwd_grid(rows, tpr, nv, _sms(x.device))
    partials = torch.empty((grid, d), dtype=torch.float32, device=x.device)
    lib, stream = _lib(), _stream(x)
    _build.check(lib.rmsnorm_bwd(x2.data_ptr(), xs, w.data_ptr(), rstd.data_ptr(), g2.data_ptr(), gs, dx.data_ptr(),
                                 partials.data_ptr(), rows, d, tpr, nv, grid, 1.0 / d, code, stream), "rmsnorm_bwd")
    _build.count_launch("rms_norm_bwd")
    _build.check(lib.rmsnorm_dw(partials.data_ptr(), grid, d, dw.data_ptr(), code, stream), "rmsnorm_dw")
    _build.count_launch("rms_norm_bwd")
    return dx.view(x.shape), dw


def _act_args(*ts: torch.Tensor) -> tuple[int, list, bool, int]:
    """(dtype code, the tensors dense, whether all are 16-byte aligned, the
    grid) after the kernels' checks."""
    code = _dtype(ts[0], "SwiGLU")
    for t in ts[1:]:
        if t.shape != ts[0].shape or t.dtype != ts[0].dtype or t.device != ts[0].device:
            raise ValueError(f"the SwiGLU kernels take tensors of one shape, dtype and device, got "
                             f"{[(t.dtype, tuple(t.shape), str(t.device)) for t in ts]}")
    ts = [t.contiguous() for t in ts]
    vectors = all(t.data_ptr() % VEC_BYTES == 0 for t in ts)
    n, vec = ts[0].numel(), VEC_BYTES // ts[0].element_size()
    units = n // vec + n % vec if vectors else n  # each thread's loads: vectors, then the scalar tail
    grid = max(1, min(-(-units // NT), _sms(ts[0].device) * ACT_CTAS_PER_SM))
    return code, ts, vectors, grid


def swiglu_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """S1: y like a, dense; the plain version on a CPU tensor."""
    if a.device.type == "cpu":
        return swiglu_plain(a, b)
    code, (a, b), vectors, grid = _act_args(a, b)
    y = torch.empty_like(a)
    if a.numel():
        _build.check(_lib().swiglu_fwd(a.data_ptr(), b.data_ptr(), y.data_ptr(), a.numel(), int(vectors), grid, code,
                                       _stream(a)), "swiglu_fwd")
        _build.count_launch("swiglu_fwd")
    return y


def swiglu_bwd(a: torch.Tensor, b: torch.Tensor, dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """S2: (da, db) like a, dense; the plain version on a CPU tensor."""
    if a.device.type == "cpu":
        return swiglu_bwd_plain(a, b, dy)
    code, (a, b, dy), vectors, grid = _act_args(a, b, dy)
    da, db = torch.empty_like(a), torch.empty_like(b)
    if a.numel():
        _build.check(_lib().swiglu_bwd(a.data_ptr(), b.data_ptr(), dy.data_ptr(), da.data_ptr(), db.data_ptr(),
                                       a.numel(), int(vectors), grid, code, _stream(a)), "swiglu_bwd")
        _build.count_launch("swiglu_bwd")
    return da, db


# ----------------------------------------------------------------- autograd


class _RMSNorm(torch.autograd.Function):
    """N1 forward, N2 backward; saves x, w and rstd (4 bytes a row)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        y, rstd = rms_norm_fwd(x, w, eps)
        ctx.save_for_backward(x, w, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, rstd = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, w, rstd, dy)
        return dx, (dw if ctx.needs_input_grad[1] else None), None


class _SwiGLU(torch.autograd.Function):
    """S1 forward, S2 backward; saves a and b in their own dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return swiglu_fwd(a, b)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        return swiglu_bwd(a, b, dy)


def rms_norm_fused(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over x's last dim through the autograd function of N1 / N2
    (their plain versions on the CPU)."""
    return _RMSNorm.apply(x, weight, float(eps))


def swiglu_fused(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """silu(a) · b through the autograd function of S1 / S2 (their plain
    versions on the CPU)."""
    return _SwiGLU.apply(a, b)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over x's last dim (any leading shape; rows may be strided, as
    a column slice is), weight [d]: the plain chain on a CPU tensor, N1 / N2
    on a CUDA tensor."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    return rms_norm_fused(x, weight, eps)


def swiglu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """silu(a) · b, a = h·W_gate and b = h·W_up of one dtype: the plain
    chain on a CPU tensor, S1 / S2 on a CUDA tensor."""
    if a.device.type == "cpu":
        return swiglu_plain(a, b)
    return swiglu_fused(a, b)
