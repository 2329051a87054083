"""The model step's fused RMSNorm and SwiGLU (``ops/fused_norm_act.py``: N1 /
N2, S1 / S2).

CPU: the kernels' formulas in plain PyTorch (``rms_norm_fwd_plain``,
``rms_norm_bwd_plain`` with dw summed in N2's block order,
``swiglu_plain``, ``swiglu_bwd_plain``) under the wrappers' autograd
functions, held against autograd through the unfused chains the model ran
before (``rms_norm_plain``, ``swiglu_plain``) and against the JAX package's
``rms_norm`` and ``silu(a) * b`` under ``jax.vjp``, at widths 128 (rows of
heads, as the sampler's q/k norm), 512 (a column slice of a 576-wide row, as
MLA's latent norm), 1024 and 2048, at 1, 37 and 300 rows, in bf16 and
fp32; the block-order sum
against a literal loop over N2's CTAs; the kernels' row plan; the wrappers'
CPU dispatch and their refusals.

Tolerances: the forwards repeat the plain chains' ops, so they are
bit-equal on the CPU. The backward formulas round once where autograd
rounds its passes and sum in other orders: fp32 within 2e-5 of the largest
element, bf16 within one bf16 ulp (2^-7 relative) plus 2^-9 of the largest
element, which covers a rounding of fp32 values a few ulps apart and the
cancellation of w·dy against x̂·mean(w·dy·x̂). Against JAX (its silu is
x·sigmoid(x), its mean another order) the same bars.

On the card only (``card``; skipped without a compute capability 9.0
device; JAX is imported inside the CPU tests that use it, so that the
card's run of this file needs none): N1 within one bf16 ulp of the plain chain, S1 / S2 bit-equal to it,
N2 within the bars above and dw bit-equal from run to run, and N1 / S1
captured in a CUDA graph and replayed.
"""

import numpy as np
import pytest
import torch

from dynamictreeattn_tpu_torch.ops import _build
from dynamictreeattn_tpu_torch.ops import fused_norm_act as fna

EPS = 1e-6
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# (width, heads a row or None, row stride, rows by default): the norms the models run
NORMS = {
    "q_heads_128": (128, 4, None, 9),
    "latent_512_strided": (512, None, 576, 23),
    "hidden_1024": (1024, None, None, 37),
    "hidden_2048": (2048, None, None, 11),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(shape, seed, scale=1.0, offset=0.0):
    return (offset + scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _norm_inputs(name, dtype, seed=0, device="cpu", rows=None):
    """(x [rows, (heads,) d] (a column slice where the width has a row
    stride), w, dy) in `dtype` on `device`, and their fp32 numpy values."""
    d, heads, stride, default_rows = NORMS[name]
    lead = (rows or default_rows,) + ((heads,) if heads else ())
    full = _np((*lead, stride or d), seed)
    w, dy = _np(d, seed + 1, 0.1, 1.0), _np((*lead, d), seed + 2)
    x = torch.from_numpy(full).to(device, dtype)[..., :d]
    return ((x, *(torch.from_numpy(t).to(device, dtype) for t in (w, dy))), (full[..., :d], w, dy))


def _jax():
    """(jax, jax.numpy, the JAX package's qwen3 module), imported here: the
    card's tests run where JAX is not installed."""
    import jax
    import jax.numpy as jnp

    from dynamictreeattn_tpu.models import qwen3

    return jax, jnp, qwen3


def _close(got, want, dtype):
    """The module docstring's bars, in fp32."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    if dtype == torch.float32:
        tol = 2e-5 * scale
    else:
        tol = 2**-7 * want.abs() + 2**-9 * scale
    err = (got - want).abs()
    assert bool((err <= tol).all()), f"max err {float(err.max()):.3e} at scale {scale:.3e}"


def _autograd_norm(x, w, dy):
    x, w = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    y = fna.rms_norm_plain(x, w, EPS)
    y.backward(dy)
    return y.detach(), x.grad, w.grad


# ------------------------------------------------------------------- RMSNorm


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(NORMS))
def test_norm_forward_formula_is_the_plain_chain(name, dtype):
    """N1's plain function: the eager chain's y bit for bit, and its rstd
    1 / sqrt(mean(x²) + eps) of each row."""
    (x, w, _), (xn, _, _) = _norm_inputs(name, DTYPES[dtype])
    y, rstd = fna.rms_norm_fwd_plain(x, w, EPS)
    assert torch.equal(y, fna.rms_norm_plain(x, w, EPS))
    xf = x.double().reshape(-1, x.shape[-1])
    want = 1 / torch.sqrt(torch.mean(xf * xf, dim=-1) + EPS)
    assert rstd.dtype == torch.float32 and rstd.shape == (xf.shape[0],)
    torch.testing.assert_close(rstd.double(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("rows", [1, 37, 300])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(NORMS))
def test_norm_fused_function_against_autograd(name, dtype, rows):
    """The autograd function on the CPU (N1 / N2's formulas): y bit-equal
    to the chain's, dx and dw within the bars of autograd through the
    chain; dx has x's shape, dw w's dtype."""
    dt = DTYPES[dtype]
    (x, w, dy), _ = _norm_inputs(name, dt, rows=rows)
    y_ref, dx_ref, dw_ref = _autograd_norm(x, w, dy)
    xg, wg = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    y = fna.rms_norm_fused(xg, wg, EPS)
    y.backward(dy)
    assert torch.equal(y.detach(), y_ref)
    assert xg.grad.shape == x.shape and xg.grad.dtype == dt and wg.grad.dtype == dt
    _close(xg.grad, dx_ref, dt)
    _close(wg.grad, dw_ref, dt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["hidden_1024", "latent_512_strided"])
def test_norm_against_jax(name, dtype):
    """y and the vjp (dx, dw) of the fused function against the JAX
    package's rms_norm under jax.vjp on the same values."""
    jax, jnp, jq = _jax()
    dt, jd = DTYPES[dtype], getattr(jnp, {"bf16": "bfloat16", "fp32": "float32"}[dtype])
    (x, w, dy), (xn, wn, dyn) = _norm_inputs(name, dt)
    jy, vjp = jax.vjp(lambda a, b: jq.rms_norm(a, b, EPS), jnp.asarray(xn, jd), jnp.asarray(wn, jd))
    jdx, jdw = vjp(jnp.asarray(dyn, jd))
    xg, wg = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    y = fna.rms_norm_fused(xg, wg, EPS)
    y.backward(dy)
    for got, want in ((y.detach(), jy), (xg.grad, jdx), (wg.grad, jdw)):
        _close(got, torch.from_numpy(np.array(want.astype(jnp.float32))), dt)


def _dw_loop(contrib: torch.Tensor, tpr: int, nv: int, sms: int) -> torch.Tensor:
    """N2's dw order written out CTA by CTA, row by row."""
    rows, d = contrib.shape
    per_cta = fna.NT // tpr
    grid = fna.bwd_grid(rows, tpr, nv, sms)
    slots = -(-rows // per_cta)
    parts = []
    for c in range(grid):
        groups = []
        for g in range(per_cta):
            acc = torch.zeros(d)
            for s in range(c, slots, grid):
                if s * per_cta + g < rows:
                    acc = acc + contrib[s * per_cta + g]
            groups.append(acc)
        part = groups[0]
        for acc in groups[1:]:
            part = part + acc
        parts.append(part)
    slices = []
    for k in range(fna.DW_SLICES):
        acc = torch.zeros(d)
        for p in range(k, grid, fna.DW_SLICES):
            acc = acc + parts[p]
        slices.append(acc)
    total = slices[0]
    for s in slices[1:]:
        total = total + s
    return total


@pytest.mark.parametrize("rows,d,tpr,nv,sms", [(1, 16, 4, 2, 132), (300, 64, 8, 2, 2), (2000, 32, 16, 1, 3),
                                               (777, 128, 256, 1, 1), (900, 64, 32, 4, 5)])
def test_dw_block_order(rows, d, tpr, nv, sms):
    """The plain backward's dw sum: bit-equal to the literal loop over N2's
    CTAs, groups and slices, and within 1e-5 of the fp64 sum."""
    contrib = torch.from_numpy(_np((rows, d), rows))
    got = fna._block_order_sum(contrib, tpr, nv, sms)
    assert torch.equal(got, _dw_loop(contrib, tpr, nv, sms))
    want = contrib.double().sum(0)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5 * float(want.abs().max()) + 1e-5)


@pytest.mark.parametrize("d,elem,want", [
    (128, 2, (4, 4)), (512, 2, (16, 4)), (576, 2, (32, 4)), (1024, 2, (32, 4)), (2048, 2, (64, 4)),
    (1024, 4, (64, 4)), (5120, 2, (256, 4)), (8, 2, (1, 1)), (12288, 2, (256, 8)), (8192, 4, (256, 8)),
])
def test_norm_plan(d, elem, want):
    """Threads a row and vectors a thread: a power of two each, the row held
    whole, at most four vectors a thread (N1; two for N2) up to a CTA a row."""
    vecs = d * elem // 16
    for per_thread in (fna.FWD_VECS, fna.BWD_VECS):
        tpr, nv = fna.norm_plan(d, elem, per_thread)
        if per_thread == fna.FWD_VECS:
            assert (tpr, nv) == want
        assert tpr * nv >= vecs and fna.NT % tpr == 0 and nv in (1, 2, 4, 8)
        assert nv <= per_thread or tpr == fna.NT


@pytest.mark.parametrize("d,elem", [(12, 2), (6, 4), (12296, 2), (16384, 4)])
def test_norm_plan_refuses(d, elem):
    with pytest.raises(ValueError):
        fna.norm_plan(d, elem)


def test_rows_view_or_copy():
    """The kernels' row layout: a column slice and a head-split tensor stay
    views; a transposed one is copied dense."""
    full = torch.zeros(5, 576, dtype=torch.bfloat16)
    x2, xs = fna._rows(full[:, :512])
    assert x2.data_ptr() == full.data_ptr() and xs == 576 and x2.shape == (5, 512)
    heads = torch.zeros(3, 4, 128)
    x2, xs = fna._rows(heads)
    assert x2.data_ptr() == heads.data_ptr() and x2.shape == (12, 128) and xs == 128
    t = torch.zeros(64, 5).t()
    x2, xs = fna._rows(t)
    assert x2.data_ptr() != t.data_ptr() and x2.is_contiguous() and xs == 64
    torch.testing.assert_close(x2, t)


# -------------------------------------------------------------------- SwiGLU


SWIGLU_SHAPES = {"dense_3072": (29, 3072), "experts_1408": (3, 7, 1408), "ragged_13": (5, 13)}


def _act_inputs(shape, dtype, seed=0):
    vals = tuple(_np(shape, seed + i, 2.0) for i in range(3))
    return tuple(torch.from_numpy(v).to(dtype) for v in vals), vals


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(SWIGLU_SHAPES))
def test_swiglu_fused_function_against_autograd(name, dtype):
    """The autograd function on the CPU (S1 / S2's formulas): y bit-equal
    to the chain's, (da, db) within the bars of autograd through the
    chain."""
    dt = DTYPES[dtype]
    (a, b, dy), _ = _act_inputs(SWIGLU_SHAPES[name], dt)
    ar, br = a.clone().requires_grad_(), b.clone().requires_grad_()
    y_ref = fna.swiglu_plain(ar, br)
    y_ref.backward(dy)
    ag, bg = a.clone().requires_grad_(), b.clone().requires_grad_()
    y = fna.swiglu_fused(ag, bg)
    y.backward(dy)
    assert torch.equal(y.detach(), y_ref.detach()) and y.dtype == dt
    _close(ag.grad, ar.grad, dt)
    _close(bg.grad, br.grad, dt)
    # db = R(dy · R(silu(a))) is one rounding of the same product: equal
    assert torch.equal(bg.grad, br.grad)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_swiglu_against_jax(dtype):
    """y, da, db against the JAX model's silu(a.astype(f32)).astype(b.dtype)
    · b under jax.vjp."""
    jax, jnp, _ = _jax()
    dt, jd = DTYPES[dtype], getattr(jnp, {"bf16": "bfloat16", "fp32": "float32"}[dtype])
    (a, b, dy), (an, bn, dyn) = _act_inputs((17, 768), dt, seed=5)

    def jax_swiglu(x, y):
        return jax.nn.silu(x.astype(jnp.float32)).astype(y.dtype) * y

    jy, vjp = jax.vjp(jax_swiglu, jnp.asarray(an, jd), jnp.asarray(bn, jd))
    jda, jdb = vjp(jnp.asarray(dyn, jd))
    ag, bg = a.clone().requires_grad_(), b.clone().requires_grad_()
    y = fna.swiglu_fused(ag, bg)
    y.backward(dy)
    for got, want in ((y.detach(), jy), (ag.grad, jda), (bg.grad, jdb)):
        _close(got, torch.from_numpy(np.array(want.astype(jnp.float32))), dt)


# ------------------------------------------------------------- dispatch


def test_cpu_dispatch_is_the_plain_chain():
    """On CPU tensors the models' rms_norm and swiglu are the plain chains
    (autograd through their ops, no autograd function of the kernels) and
    launch nothing."""
    from dynamictreeattn_tpu_torch.models import qwen3

    before = dict(_build.LAUNCHES)
    (x, w, _), _ = _norm_inputs("hidden_1024", torch.bfloat16)
    xg = x.clone().requires_grad_()
    y = qwen3.rms_norm(xg, w, EPS)
    assert torch.equal(y, fna.rms_norm_plain(x, w, EPS))
    assert "RMSNorm" not in type(y.grad_fn).__name__
    (a, b, _), _ = _act_inputs((4, 16), torch.bfloat16)
    ag = a.clone().requires_grad_()
    s = fna.swiglu(ag, b)
    assert torch.equal(s, fna.swiglu_plain(a, b)) and "SwiGLU" not in type(s.grad_fn).__name__
    assert type(fna.rms_norm_fused(xg, w, EPS).grad_fn).__name__ == "_RMSNormBackward"
    assert type(fna.swiglu_fused(ag, b).grad_fn).__name__ == "_SwiGLUBackward"
    assert _build.LAUNCHES == before
    for name in ("rms_norm_fwd", "rms_norm_bwd", "swiglu_fwd", "swiglu_bwd"):
        assert name in _build.LAUNCHES


def test_kernel_paths_refuse_what_they_do_not_take():
    """The launch paths refuse a tensor off the card and, before any
    launch, a width the kernels do not take."""
    x = torch.zeros(4, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fna.rms_norm_fwd(x, torch.zeros(64, device="meta", dtype=torch.bfloat16), EPS)
    with pytest.raises(ValueError, match="CUDA"):
        fna.swiglu_fwd(x, x)
    with pytest.raises(ValueError):
        fna.rms_norm_bwd_plain(torch.zeros(2, 12, dtype=torch.bfloat16), torch.ones(12, dtype=torch.bfloat16),
                               torch.ones(2), torch.zeros(2, 12, dtype=torch.bfloat16))


# ------------------------------------------------------------------ the card


def _card() -> torch.device:
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("no CUDA device of compute capability 9.0")
    return torch.device("cuda")


def _ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """The most bf16 ulps between same-signed elements (their bit patterns)."""
    return int((got.view(torch.int16).int() - want.view(torch.int16).int()).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("name", list(NORMS))
def test_card_norm_kernels(name):
    """N1 within one bf16 ulp of the chain, rstd within 2 fp32 ulps; N2
    within the bars of autograd through the chain; dw the same bits twice."""
    dev = _card()
    (x, w, dy), _ = _norm_inputs(name, torch.bfloat16, device=dev)
    y, rstd = fna.rms_norm_fwd(x, w, EPS)
    y_ref, r_ref = fna.rms_norm_fwd_plain(x, w, EPS)
    assert _ulps(y, y_ref) <= 1
    torch.testing.assert_close(rstd, r_ref, rtol=2.5e-7, atol=0)
    _, dx_ref, dw_ref = _autograd_norm(x, w, dy)
    dx, dw = fna.rms_norm_bwd(x, w, rstd, dy)
    _close(dx, dx_ref, torch.bfloat16)
    _close(dw, dw_ref, torch.bfloat16)
    assert torch.equal(dw, fna.rms_norm_bwd(x, w, rstd, dy)[1])


@pytest.mark.card
@pytest.mark.parametrize("name", list(SWIGLU_SHAPES))
def test_card_swiglu_kernels(name):
    """S1 and S2 bit-equal to the chain and autograd through it."""
    dev = _card()
    (a, b, dy), _ = _act_inputs(SWIGLU_SHAPES[name], torch.bfloat16)
    a, b, dy = a.to(dev), b.to(dev), dy.to(dev)
    ar, br = a.clone().requires_grad_(), b.clone().requires_grad_()
    y_ref = fna.swiglu_plain(ar, br)
    y_ref.backward(dy)
    assert torch.equal(fna.swiglu_fwd(a, b), y_ref.detach())
    da, db = fna.swiglu_bwd(a, b, dy)
    assert torch.equal(db, br.grad) and torch.equal(da, ar.grad)


@pytest.mark.card
def test_card_kernels_in_a_graph():
    """N1 and S1 captured in a CUDA graph: counted once into the capture's
    tally, and each replay equal to an eager launch."""
    dev = _card()
    (x, w, _), _ = _norm_inputs("hidden_1024", torch.bfloat16)
    (a, b, _), _ = _act_inputs((37, 3072), torch.bfloat16)
    x, w, a, b = (t.to(dev) for t in (x, w, a, b))
    fna.rms_norm(x, w, EPS), fna.swiglu(a, b)  # loads the library outside the capture
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), _build.captured_launches() as counts, torch.cuda.graph(graph, stream=stream):
        y = fna.rms_norm(x, w, EPS)
        s = fna.swiglu(a, b)
    assert counts == {"rms_norm_fwd": 1, "swiglu_fwd": 1}
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, fna.rms_norm(x, w, EPS)) and torch.equal(s, fna.swiglu(a, b))
