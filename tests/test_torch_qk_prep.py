"""The qk-prep port (``dynamictreeattn_tpu_torch/ops/qk_prep.py``) against the
JAX package's fused qk-prep kernels (K4-K7) run in interpret mode.

The same inputs, made with numpy from a seed, go through JAX ``qkv_prep``
(the Pallas kernels in the TPU-semantics interpreter, with their custom_vjp)
and the port's ``qkv_prep`` on CPU tensors (its kernels' plain versions
under its autograd function): the three outputs and the five grads (dq, dk,
dv, dqw, dkw), with and without the norm, in fp32 and in bf16, at head
dims 16, 64 and 128 and lengths that are not multiples of 8.

Tolerances: fp32 to the JAX suite's own bars (tests/test_qk_prep.py: 2e-5
on values, 3e-5 on grads; the same fp32 arithmetic summed in other orders);
bf16 to one bf16 ulp of each element (both sides compute in fp32 and round
once, so only a rounding of fp32 values a few fp32 ulps apart can differ).
The model-level tests hold ``forward_hidden(..., fused_qk=True)`` against
the JAX model's fused path (rtol/atol 1e-4, fp32 through two layers).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamictreeattn_tpu.ops.qk_prep  # noqa: F401  (patched below, reached through sys.modules)
from dynamictreeattn_tpu.models import qwen3 as jq
from dynamictreeattn_tpu.ops.tree_attention_ref import tree_attention_reference as jax_attn_ref
from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, forward_hidden, params_from_numpy
from dynamictreeattn_tpu_torch.ops import qkv_prep, qkv_prep_plain, tree_attention_reference

qp = sys.modules["dynamictreeattn_tpu_torch.ops.qk_prep"]
jqp = sys.modules["dynamictreeattn_tpu.ops.qk_prep"]

EPS = 1e-6
FP32_VAL_TOL, FP32_GRAD_TOL = 2e-5, 3e-5
SHAPES = [(37, 4, 2, 16), (64, 4, 2, 64), (29, 2, 1, 128)]  # (n, hq, hkv, dh)
NAMES = ("q", "k", "v", "dq", "dk", "dv", "dqw", "dkw")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loops run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, n, hq, hkv, dh):
    """fp32 numpy (q, k, v, qw, kw, cos, sin, gq, gk, gv); cos/sin from the
    JAX package's rope_tables so both sides see the same tables."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((n, h * dh), dtype=np.float32) for h in (hq, hkv, hkv))
    qw, kw = (1.0 + 0.1 * rng.standard_normal(dh, dtype=np.float32) for _ in range(2))
    cos, sin = (np.array(t) for t in jq.rope_tables(jnp.arange(n, dtype=jnp.int32) % 7, dh, 10000.0))
    cts = tuple(rng.standard_normal((h, n, dh), dtype=np.float32) for h in (hq, hkv, hkv))
    return (q, k, v, qw, kw, cos, sin) + cts


def _jax_side(inputs, use_norm, dtype):
    q, k, v, qw, kw, cos, sin, gq, gk, gv = inputs
    args = [jnp.asarray(a, dtype) for a in (q, k, v, qw, kw)]
    cos, sin = jnp.asarray(cos), jnp.asarray(sin)
    out, vjp = jax.vjp(lambda *a: jqp.qkv_prep(*a, cos, sin, EPS, use_norm, True), *args)
    grads = vjp(tuple(jnp.asarray(c, dtype) for c in (gq, gk, gv)))
    return dict(zip(NAMES, [np.asarray(t.astype(jnp.float32)) for t in (*out, *grads)]))


def _port_side(inputs, use_norm, dtype):
    q, k, v, qw, kw, cos, sin, gq, gk, gv = inputs
    args = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (q, k, v, qw, kw)]
    out = qkv_prep(*args, torch.from_numpy(cos), torch.from_numpy(sin), EPS, use_norm)
    grads = torch.autograd.grad(out, args, [torch.from_numpy(c).to(dtype) for c in (gq, gk, gv)],
                                allow_unused=True)
    assert all(o.dtype == dtype and o.is_contiguous() for o in out)
    assert all(g is None or g.dtype == dtype for g in grads)
    return dict(zip(NAMES, [None if t is None else t.detach().float().numpy()
                            for t in (*out, *grads)]))


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits): 2^(floor(log2|x|) - 7)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny))) - 7)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("use_norm", [True, False], ids=["norm", "no_norm"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s[0]}_h{s[1]}-{s[2]}_dh{s[3]}")
def test_plain_qk_prep_against_jax_interpret_kernels(shape, use_norm, dtype):
    inputs = _inputs(sum(shape), *shape)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    want = _jax_side(inputs, use_norm, jdt)
    got = _port_side(inputs, use_norm, tdt)
    n, hq, hkv, dh = shape
    assert got["q"].shape == (hq, n, dh) and got["k"].shape == got["v"].shape == (hkv, n, dh)
    assert got["dq"].shape == (n, hq * dh) and got["dk"].shape == got["dv"].shape == (n, hkv * dh)
    for name in NAMES:
        if name in ("dqw", "dkw") and not use_norm:
            # JAX returns zeros for the unread weights; the port no grad
            assert got[name] is None and not want[name].any(), name
            continue
        if dtype == "fp32":
            tol = FP32_VAL_TOL if name in ("q", "k", "v") else FP32_GRAD_TOL
            np.testing.assert_allclose(got[name], want[name], rtol=tol, atol=tol, err_msg=name)
        else:
            err = np.abs(got[name] - want[name])
            ulp = _bf16_ulp(np.maximum(np.abs(got[name]), np.abs(want[name])))
            assert (err <= ulp).all(), (name, float((err / ulp).max()))


@pytest.mark.parametrize("use_norm", [True, False], ids=["norm", "no_norm"])
def test_qk_prep_analytic_backward_equals_autograd_of_plain_forward(use_norm):
    """The hand-derived backward (the kernels' plain K6/K7) equals torch
    autograd through the plain forward (K4/K5), fp32, to 1e-5."""
    q, k, v, qw, kw, cos, sin, gq, gk, gv = (torch.from_numpy(a) for a in _inputs(5, 45, 4, 2, 64))
    grads = []
    for fn in (qkv_prep, qkv_prep_plain):
        args = [t.clone().requires_grad_(True) for t in (q, k, v, qw, kw)]
        out = fn(*args, cos, sin, EPS, use_norm)
        grads.append(torch.autograd.grad(out, args, (gq, gk, gv), allow_unused=True))
    for name, a, b in zip(("dq", "dk", "dv", "dqw", "dkw"), *grads):
        if b is None or not use_norm and name in ("dqw", "dkw"):
            assert a is None, name
            continue
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)


def test_qk_prep_wrappers_launch_or_raise_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device goes to
    the kernel path, which refuses what is not a CUDA tensor (no fallback)."""
    n, H, dh = 8, 2, 64
    x = torch.zeros((n, H * dh), dtype=torch.bfloat16, device="meta")
    w = torch.ones(dh, dtype=torch.bfloat16, device="meta")
    cos = torch.zeros((n, dh), device="meta")
    g = torch.zeros((H, n, dh), dtype=torch.bfloat16, device="meta")
    calls = [lambda: qp.qk_prep_fwd_q(x, w, cos, cos, EPS, True),
             lambda: qp.qk_prep_fwd_kv(x, x, w, cos, cos, EPS, True),
             lambda: qp.qk_prep_bwd_q(g, x, w, cos, cos, EPS, True),
             lambda: qp.qk_prep_bwd_kv(g, g, x, w, cos, cos, EPS, False)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()


def _with_bias(config):
    """qwen3-tiny as Qwen2.5 lays it out: q/k/v biases, no qk-norm."""
    return dataclasses.replace(config, use_qk_norm=False, attention_bias=True)


@pytest.mark.parametrize("name", ["qwen3-tiny", "llama-tiny", "qwen2.5-style-tiny"])
def test_fused_model_matches_jax_fused_model(monkeypatch, name):
    """forward_hidden(fused_qk=True) equals the JAX model's fused path (its
    qk-prep kernels in interpret mode) and the port's unfused path, fp32;
    the bias case gets nonzero random biases."""
    base = "qwen3-tiny" if name == "qwen2.5-style-tiny" else name
    jcfg, cfg = jq.MODEL_CONFIGS[base], MODEL_CONFIGS[base]
    if name == "qwen2.5-style-tiny":
        jcfg, cfg = _with_bias(jcfg), _with_bias(cfg)
    jp = jq.init_params(jcfg, jax.random.key(7), dtype=jnp.float32)
    rng = np.random.default_rng(7)
    for key in ("bq", "bk", "bv"):
        if key in jp["layers"]:
            jp["layers"][key] = jnp.asarray(0.5 * rng.standard_normal(jp["layers"][key].shape), jnp.float32)
    n = 45
    tokens = rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
    depth = (np.arange(n) % 23).astype(np.int32)
    last_desc = np.minimum((np.arange(n) // 23 + 1) * 23 - 1, n - 1).astype(np.int32)  # two chains
    orig = jqp.qkv_prep
    monkeypatch.setattr(jqp, "qkv_prep", lambda *a: orig(*a[:9], True))
    want = np.asarray(jq.forward_hidden(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(depth),
        lambda q, k, v: jax_attn_ref(q, k, v, jnp.asarray(last_desc)), fused_qk=True))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ld = torch.from_numpy(last_desc)

    def attn(q, k, v):
        return tree_attention_reference(q, k, v, ld)

    got = {fused: forward_hidden(tp, cfg, torch.from_numpy(tokens), torch.from_numpy(depth), attn,
                                 fused_qk=fused).numpy() for fused in (True, False)}
    np.testing.assert_allclose(got[True], want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[True], got[False], rtol=1e-4, atol=1e-4)
