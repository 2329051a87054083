"""The training step against the JAX package: the port's
``TreeEngine.loss_and_grad`` equals the JAX engine's on the same trie and
weights, and its fused qk-prep path the JAX engine's fused path (the JAX
qk-prep kernels K4-K7 in interpret mode); tree == dense gradients inside
the port; remat changes nothing.

fp32 on the CPU, qwen3-tiny weights from the JAX package's init converted
through numpy. The JAX engine runs its reference backend (dense-mask
attention, vocab-chunked loss, no remat); the port runs its kernel backend
(the plain versions of K1/K2, K11/K12, K8/K9 on CPU tensors) and its
reference backend; its backward runs in each mode, "cached" (K3, the
default), "fused" (K10) and "split" (K11/K12). Bars: loss rtol 1e-5 and per-parameter relative grad error
< 1e-4 (the same fp32 math summed in other orders through two layers and the
LM head); tree vs dense < 1e-3 (the JAX suite's bar,
tests/test_engine_parity.py); remat on vs off within 1e-6 (the recompute
repeats the same CPU arithmetic). qwen3-moe-tiny's steps (with the
load-balance term and without it in the custom step) against the JAX
engine at its "exact" bucket, the port's padded length, where the default
capacity drops pairs: the same bars.
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamictreeattn_tpu.ops.qk_prep  # noqa: F401  (patched below, reached through sys.modules)
from dynamictreeattn_tpu.engine import EngineConfig as JaxEngineConfig
from dynamictreeattn_tpu.engine import TreeEngine as JaxTreeEngine
from dynamictreeattn_tpu.models import qwen3 as jq
from dynamictreeattn_tpu.tries import TokenTrie as JaxTokenTrie
from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine, pack_sequences_dense
from dynamictreeattn_tpu_torch.models import (
    MODEL_CONFIGS, forward_hidden, forward_hidden_aux, params_from_numpy,
)
from dynamictreeattn_tpu_torch.ops import tree_attention_reference
import dynamictreeattn_tpu_torch.ops.tree_attention  # noqa: F401  (patched below, reached through sys.modules)
from dynamictreeattn_tpu_torch.tries import TokenTrie
from dynamictreeattn_tpu_torch.utils import compare_grads

from helpers import random_trie_batch

ta = sys.modules["dynamictreeattn_tpu_torch.ops.tree_attention"]
LOSS_RTOL, GRAD_REL, TREE_DENSE_REL, REMAT_REL = 1e-5, 1e-4, 1e-3, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loops run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(seed=0, n_seqs=10):
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=n_seqs, vocab=128, max_len=40)
    jp = jq.init_params(jq.MODEL_CONFIGS["qwen3-tiny"], jax.random.key(seed), dtype=jnp.float32)
    return seqs, attachs, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def jax_step():
    """(loss, aux, grads as torch tensors) of the JAX engine's training step."""
    seqs, attachs, jp, _ = _setup()
    eng = JaxTreeEngine(jq.MODEL_CONFIGS["qwen3-tiny"], JaxEngineConfig(
        block_q=16, block_kv=16, remat=False, attn_backend="reference",
        loss_mode="vocab", fused_qk="off"))
    loss, grads, aux = eng.loss_and_grad(jp, eng.prepare(JaxTokenTrie(seqs, attachs)))
    return (float(loss), {k: float(v) for k, v in aux.items()},
            params_from_numpy(jax.tree.map(np.asarray, grads), device="cpu"))


@pytest.fixture(scope="module")
def jax_fused_step():
    """(loss, aux, grads) of the JAX engine's fused qk-prep step: its
    qkv_prep (custom_vjp over K4-K7) in interpret mode, patched where
    ``_layer`` and the custom_vjp's fwd rule look it up."""
    seqs, attachs, jp, _ = _setup()
    jqp = sys.modules["dynamictreeattn_tpu.ops.qk_prep"]
    orig, calls = jqp.qkv_prep, []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jqp, "qkv_prep", lambda *a: calls.append(a) or orig(*a[:9], True))
        eng = JaxTreeEngine(jq.MODEL_CONFIGS["qwen3-tiny"], JaxEngineConfig(
            block_q=16, block_kv=16, remat=False, attn_backend="reference",
            loss_mode="vocab", fused_qk="on"))
        loss, grads, aux = eng.loss_and_grad(jp, eng.prepare(JaxTokenTrie(seqs, attachs)))
    assert calls, "the JAX engine did not take its fused qk-prep path"
    return (float(loss), {k: float(v) for k, v in aux.items()},
            params_from_numpy(jax.tree.map(np.asarray, grads), device="cpu"))


def _port_step(cfg, seed=0, dense=False):
    seqs, attachs, _, tp = _setup(seed)
    eng = TreeEngine(MODEL_CONFIGS["qwen3-tiny"], EngineConfig(**{"block_q": 16, "block_kv": 16, **cfg}),
                     device="cpu")
    packed = (pack_sequences_dense(seqs, attachs, pad_multiple=eng.cfg.pad_multiple) if dense
              else TokenTrie(seqs, attachs))
    return eng.loss_and_grad(tp, eng.prepare(packed))


@pytest.mark.parametrize("cfg", [
    dict(),  # kernel backend: bound softmax, "auto" -> cached backward, K8/K9 (plain on CPU), remat
    dict(remat=False),
    dict(fwd_softmax="online"),
    dict(attn_backend="reference", loss_mode="vocab"),
    dict(block_q=32, block_kv=16, loss_mode="vocab", remat=False),
    dict(bwd_mode="split"),
    dict(bwd_mode="fused"),
    dict(bwd_mode="cached", fwd_softmax="online"),
    dict(bwd_mode="cached", block_q=16, block_kv=32, remat=False),
])
def test_loss_and_grad_match_jax_engine(jax_step, cfg):
    want_loss, want_aux, want_grads = jax_step
    loss, grads, aux = _port_step(cfg)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    for key in ("sum_logprob", "sum_entropy"):
        np.testing.assert_allclose(float(aux[key]), want_aux[key], rtol=LOSS_RTOL)
    rows = compare_grads(want_grads, grads)
    assert len(rows) == 2 * 11 + 2  # 11 stacked leaves x 2 layers, embed, final_norm
    assert rows[0][1] < GRAD_REL, rows[:3]


@pytest.mark.parametrize("cfg", [
    dict(),  # "auto" -> fused qk-prep on the kernel backend, remat: K4/K5 rerun in the recompute
    dict(remat=False, loss_mode="vocab"),
    dict(attn_backend="reference", loss_mode="vocab", fused_qk="on"),
])
def test_fused_step_matches_jax_fused_engine(jax_fused_step, cfg):
    want_loss, want_aux, want_grads = jax_fused_step
    loss, grads, aux = _port_step(cfg)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    for key in ("sum_logprob", "sum_entropy"):
        np.testing.assert_allclose(float(aux[key]), want_aux[key], rtol=LOSS_RTOL)
    rows = compare_grads(want_grads, grads)
    assert len(rows) == 2 * 11 + 2
    assert rows[0][1] < GRAD_REL, rows[:3]


def test_batch_without_schedule_takes_fused(jax_step, monkeypatch):
    """A batch prepared without the slot schedule (its meta holds only the
    six block arrays) downgrades "cached" to "fused", as the JAX engine's
    ``_attn_fn`` does; the step still equals the JAX engine's."""
    seqs, attachs, _, tp = _setup()
    eng = TreeEngine(MODEL_CONFIGS["qwen3-tiny"], EngineConfig(block_q=16, block_kv=16), device="cpu")
    batch = eng.prepare(TokenTrie(seqs, attachs))
    assert len(batch.meta) == 8  # the schedule, for the default "auto" -> "cached"
    batch.meta = batch.meta[:6]
    taken = []
    for name in ("tree_attn_bwd_cached", "tree_attn_bwd_fused", "tree_attn_bwd_dq"):
        real = getattr(ta, name)
        monkeypatch.setattr(ta, name, lambda *a, _r=real, _n=name: taken.append(_n) or _r(*a))
    loss, grads, _ = eng.loss_and_grad(tp, batch)
    assert taken == ["tree_attn_bwd_fused"] * 2  # one per layer
    want_loss, _, want_grads = jax_step
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    assert compare_grads(want_grads, grads)[0][1] < GRAD_REL


@pytest.mark.parametrize("bwd", ["cached", "fused"])
def test_backward_modes_take_their_kernels(monkeypatch, bwd):
    """The step's backward goes through the mode's own wrapper: "auto" and
    "cached" K3 only, "fused" K10 only; no split wrapper runs."""
    seqs, attachs, _, tp = _setup(4, n_seqs=6)
    taken = []
    for name in ("tree_attn_bwd_cached", "tree_attn_bwd_fused", "tree_attn_bwd_dq", "tree_attn_bwd_dkv"):
        real = getattr(ta, name)
        monkeypatch.setattr(ta, name, lambda *a, _r=real, _n=name: taken.append(_n) or _r(*a))
    for mode in ("auto", bwd):
        taken.clear()
        eng = TreeEngine(MODEL_CONFIGS["qwen3-tiny"], EngineConfig(block_q=16, block_kv=16, bwd_mode=mode),
                         device="cpu")
        eng.loss_and_grad(tp, eng.prepare(TokenTrie(seqs, attachs)))
        want = "cached" if mode == "auto" else bwd
        assert taken == [f"tree_attn_bwd_{want}"] * 2, (mode, taken)


@pytest.mark.parametrize("softmax", ["auto", "online"])
def test_tree_grads_equal_dense(softmax):
    loss_t, grads_t, aux_t = _port_step(dict(fwd_softmax=softmax), seed=1)
    loss_d, grads_d, aux_d = _port_step(dict(fwd_softmax=softmax), seed=1, dense=True)
    np.testing.assert_allclose(float(loss_t), float(loss_d), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux_t["sum_entropy"]), float(aux_d["sum_entropy"]), rtol=LOSS_RTOL)
    worst = compare_grads(grads_d, grads_t)[0]
    assert worst[1] < TREE_DENSE_REL, worst


@pytest.mark.parametrize("backend", ["kernel", "reference"])
def test_remat_changes_nothing(backend):
    loss_r, grads_r, _ = _port_step(dict(attn_backend=backend, remat=True), seed=2)
    loss_n, grads_n, _ = _port_step(dict(attn_backend=backend, remat=False), seed=2)
    np.testing.assert_allclose(float(loss_r), float(loss_n), rtol=REMAT_REL)
    assert compare_grads(grads_n, grads_r)[0][1] < REMAT_REL


def test_loss_without_grad_and_params_untouched():
    """``loss`` equals the step's loss; the step leaves the caller's tensors
    as they were (no grad flags, no .grad, same values)."""
    seqs, attachs, _, tp = _setup(3)
    before = {k: v.clone() for k, v in tp["layers"].items()}
    eng = TreeEngine(MODEL_CONFIGS["qwen3-tiny"], EngineConfig(block_q=16, block_kv=16), device="cpu")
    batch = eng.prepare(TokenTrie(seqs, attachs))
    loss, aux = eng.loss(tp, batch)
    loss_g, grads, aux_g = eng.loss_and_grad(tp, batch)
    assert not loss.requires_grad and not loss_g.requires_grad
    np.testing.assert_allclose(float(loss), float(loss_g), rtol=1e-6)
    np.testing.assert_allclose(float(aux["sum_logprob"]), float(aux_g["sum_logprob"]), rtol=1e-6)
    for name, t in tp["layers"].items():
        assert not t.requires_grad and t.grad is None
        torch.testing.assert_close(t, before[name], rtol=0, atol=0)
        assert grads["layers"][name].shape == t.shape and grads["layers"][name].dtype == t.dtype


def test_untied_head_grads_match_jax_in_the_params_layout():
    """An untied head ([d, V] view of [V, d] storage) gets its grad in the
    same layout, equal to the JAX engine's."""
    seqs, attachs = random_trie_batch(np.random.default_rng(4), n_seqs=8, vocab=128, max_len=30)
    jcfg = dataclasses.replace(jq.MODEL_CONFIGS["qwen3-tiny"], tie_word_embeddings=False)
    jp = jq.init_params(jcfg, jax.random.key(4), dtype=jnp.float32)
    jeng = JaxTreeEngine(jcfg, JaxEngineConfig(block_q=16, block_kv=16, remat=False,
                                               attn_backend="reference", loss_mode="vocab",
                                               fused_qk="off"))
    want_loss, want, _ = jeng.loss_and_grad(jp, jeng.prepare(JaxTokenTrie(seqs, attachs)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    cfg = dataclasses.replace(MODEL_CONFIGS["qwen3-tiny"], tie_word_embeddings=False)
    eng = TreeEngine(cfg, EngineConfig(block_q=16, block_kv=16), device="cpu")
    loss, grads, _ = eng.loss_and_grad(tp, eng.prepare(TokenTrie(seqs, attachs)))
    assert grads["lm_head"].shape == tp["lm_head"].shape
    assert grads["lm_head"].stride() == tp["lm_head"].stride() == (1, tp["lm_head"].shape[0])
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    worst = compare_grads(params_from_numpy(jax.tree.map(np.asarray, want), device="cpu"), grads)[0]
    assert worst[1] < GRAD_REL, worst


def test_forward_hidden_aux_and_unported_remat_options():
    """``forward_hidden_aux`` returns the hidden states of ``forward_hidden``
    (with and without remat, under every remat policy and nested segments)
    and a zero load-balance loss for dense models; an unknown policy and a
    segment count that does not divide the layers raise."""
    _, _, _, tp = _setup()
    cfg = MODEL_CONFIGS["qwen3-tiny"]
    n = 24
    tokens = torch.arange(n, dtype=torch.int32)
    chain = torch.full((n,), n - 1, dtype=torch.int32)  # one sequence: every key sees all later rows

    def attn(q, k, v, handoff=None):  # the dense oracle hands no (o, lse) over
        return tree_attention_reference(q, k, v, chain)

    want = forward_hidden(tp, cfg, tokens, tokens, attn)
    for kw in (dict(remat=False), dict(remat=True), dict(remat=True, remat_policy="attn"),
               dict(remat=True, remat_policy="dots"), dict(remat=True, remat_segments=2)):
        hidden, aux = forward_hidden_aux(tp, cfg, tokens, tokens, attn, **kw)
        torch.testing.assert_close(hidden, want, rtol=0, atol=0)
        assert float(aux["lb_loss"]) == 0.0
    for kw, match in ((dict(remat_policy="all"), "unknown remat policy"), (dict(remat_segments=3), "divisible")):
        with pytest.raises(ValueError, match=match):
            forward_hidden_aux(tp, cfg, tokens, tokens, attn, remat=True, **kw)


# --- qwen3-moe-tiny: the steps at the JAX engine's padded length ("exact"
# buckets), where the default capacity drops (row, choice) pairs

MOE = "qwen3-moe-tiny"
JAX_MOE_ECFG = JaxEngineConfig(block_q=16, block_kv=16, remat=False, attn_backend="reference",
                               loss_mode="vocab", fused_qk="off", bucketing="exact")
MOE_CFGS = {"kernel": dict(), "kernel_split_attn": dict(bwd_mode="split", remat_policy="attn"),
            "reference": dict(attn_backend="reference", loss_mode="vocab", remat=False)}


@functools.lru_cache(maxsize=None)
def _moe_setup(seed=7):
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=10, vocab=128, max_len=36)
    jp = jq.init_params(jq.MODEL_CONFIGS[MOE], jax.random.key(seed), dtype=jnp.float32)
    return seqs, attachs, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _moe_linear(lp, ent, extras, length):
    m_lp = (torch.arange(lp.shape[0]) < length - 1).float()
    return -(lp * m_lp).sum() / torch.clamp(length - 1, min=1) + 0.1 * ent[0]


def _jax_moe_linear(lp, ent, extras, length):
    m_lp = (jnp.arange(lp.shape[0]) < length - 1).astype(jnp.float32)
    return -jnp.sum(lp * m_lp) / jnp.maximum(length - 1, 1) + 0.1 * ent[0]


@functools.lru_cache(maxsize=None)
def _jax_moe_step(kind):
    seqs, attachs, jp, _ = _moe_setup()
    eng = JaxTreeEngine(jq.MODEL_CONFIGS[MOE], JAX_MOE_ECFG)
    batch = eng.prepare(JaxTokenTrie(seqs, attachs))
    if kind == "step":
        loss, grads, aux = eng.loss_and_grad(jp, batch)
        aux = {k: float(v) for k, v in aux.items()}
    else:
        (loss, grads), aux = eng.loss_and_grad_custom(jp, batch, _jax_moe_linear), {}
    return batch.n_padded, float(loss), aux, params_from_numpy(jax.tree.map(np.asarray, grads), device="cpu")


@pytest.mark.parametrize("cfg", list(MOE_CFGS))
@pytest.mark.parametrize("kind", ["step", "custom"])
def test_moe_steps_match_jax_engine(kind, cfg, monkeypatch):
    """qwen3-moe-tiny: loss_and_grad (the lb term in the loss, aux
    "lb_loss") and loss_and_grad_custom (no lb term) against the JAX engine
    at the same padded length, with the kernel backend (plain versions) and
    the reference backend; the default capacity drops pairs here, the same
    ones on both sides."""
    from dynamictreeattn_tpu_torch.models import qwen3 as tq

    dropped, real_apply = [], tq.moe_apply

    def counting_apply(h, e_gate, e_up, e_down, idx, w, capacity):  # pairs past capacity, from idx
        counts = (idx.reshape(-1, 1) == torch.arange(e_gate.shape[0])).sum(0)
        dropped.append(int((counts - capacity).clamp(min=0).sum()))
        return real_apply(h, e_gate, e_up, e_down, idx, w, capacity)

    monkeypatch.setattr(tq, "moe_apply", counting_apply)
    seqs, attachs, _, tp = _moe_setup()
    n_jax, want_loss, want_aux, want_g = _jax_moe_step(kind)
    eng = TreeEngine(MODEL_CONFIGS[MOE], EngineConfig(block_q=16, block_kv=16, **MOE_CFGS[cfg]), device="cpu")
    batch = eng.prepare(TokenTrie(seqs, attachs))
    assert batch.n_padded == n_jax
    if kind == "step":
        loss, grads, aux = eng.loss_and_grad(tp, batch)
    else:
        (loss, grads), aux = eng.loss_and_grad_custom(tp, batch, _moe_linear), {}
    assert sum(dropped) > 0
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    assert set(aux) == set(want_aux)
    for key in aux:
        np.testing.assert_allclose(float(aux[key]), want_aux[key], rtol=LOSS_RTOL)
    worst = compare_grads(want_g, grads)[0]
    assert worst[1] < GRAD_REL, worst
