"""The pluggable per-sequence loss against the JAX package: the port's
``TreeEngine.loss_and_grad_custom`` equals the JAX engine's on the same trie,
weights and extras, a linear loss reproduces ``loss_and_grad``, and a PPO
loss gives tree == dense.

fp32 on the CPU, qwen3-tiny weights from the JAX package's init converted
through numpy. The JAX engine runs its reference backend (dense-mask
attention, vocab-chunked loss, no remat), unfused and on its fused qk-prep
path (its ``qkv_prep`` patched to interpret mode, as
``tests/test_torch_train.py`` reaches it); the port runs its kernel backend
(the plain versions of the kernels on CPU tensors) and its reference
backend. Every custom step runs with warnings raised as errors, so a
``torch.func.vmap`` fallback (an op without a batching rule, which vmap
only warns about) fails the test.

Bars: loss rtol 1e-5 and per-parameter relative grad error < 1e-4 against
JAX (the same fp32 math summed in other orders, as in test_torch_train);
linear == ``loss_and_grad`` at rtol 1e-5, grads 1e-4 / atol 1e-6 and tree
== dense < 1e-3 (the JAX suite's bars, tests/test_custom_loss.py).

JAX's ``test_custom_loss_cache_no_stale_reuse_on_recycled_id`` has no
counterpart: the JAX engine caches one compiled step per loss function,
and the eager port has no such cache.
"""

import sys
import warnings

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
from dynamictreeattn_tpu_torch.examples.grpo import make_grpo_loss
from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, params_from_numpy
from dynamictreeattn_tpu_torch.tries import TokenTrie
from dynamictreeattn_tpu_torch.utils import compare_grads
from dynamictreeattn_tpu_torch.utils.compare_grads import named_leaves

from helpers import random_trie_batch

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent.parent))
from examples.grpo import make_grpo_loss as jax_make_grpo_loss  # noqa: E402

LOSS_RTOL, GRAD_REL, TREE_DENSE_REL = 1e-5, 1e-4, 1e-3
MC = MODEL_CONFIGS["qwen3-tiny"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loops run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def linear_loss(lp, ent, extras, length):
    """The flatten weights of random_trie_batch (w_logprobs -1, w_entropy
    0.1) written per sequence: loss_and_grad's loss."""
    m_lp = (torch.arange(lp.shape[0]) < length - 1).float()
    m_en = (torch.arange(ent.shape[0]) < length).float()
    return -1.0 * (lp * m_lp).sum() / torch.clamp(length - 1, min=1) + 0.1 * (ent * m_en).sum() / length


def jax_linear_loss(lp, ent, extras, length):
    m_lp = (jnp.arange(lp.shape[0]) < length - 1).astype(jnp.float32)
    m_en = (jnp.arange(ent.shape[0]) < length).astype(jnp.float32)
    return (-1.0 * jnp.sum(lp * m_lp) / jnp.maximum(length - 1, 1)
            + 0.1 * jnp.sum(ent * m_en) / length)


LOSSES = {"linear": (linear_loss, jax_linear_loss),
          "grpo": (make_grpo_loss(0.2, 0.01), jax_make_grpo_loss(0.2, 0.01))}


def _setup(seed=0, n_seqs=10):
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=n_seqs, vocab=128, max_len=40)
    jp = jq.init_params(jq.MODEL_CONFIGS["qwen3-tiny"], jax.random.key(seed), dtype=jnp.float32)
    return seqs, attachs, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _extras_table(seqs, seed=7):
    """Per batch id: behavior log-probs [Lmax-1], advantage, prompt length."""
    rng = np.random.default_rng(seed)
    lmax = max(len(s) for s in seqs)
    return {b: (rng.normal(-4.0, 1.0, size=lmax - 1).astype(np.float32),
                np.float32(rng.normal()), np.int32(rng.integers(1, len(s) + 1)))
            for b, s in enumerate(seqs)}


def _extras(table, ids, as_array):
    return {"behavior_lp": as_array(np.stack([table[b][0] for b in ids])),
            "adv": as_array(np.array([table[b][1] for b in ids], np.float32)),
            "prompt_len": as_array(np.array([table[b][2] for b in ids], np.int32))}


def _port_custom(engine, params, batch, loss_fn, table=None):
    ids = [int(b) for b in batch.packed.seq_batch_ids]
    extras = None if table is None else _extras(table, ids, torch.from_numpy)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a vmap fallback warns: fail on it
        return engine.loss_and_grad_custom(params, batch, loss_fn, extras)


def _jax_custom(fused: bool, loss: str):
    seqs, attachs, jp, _ = _setup()
    eng = JaxTreeEngine(jq.MODEL_CONFIGS["qwen3-tiny"], JaxEngineConfig(
        block_q=16, block_kv=16, remat=False, attn_backend="reference", loss_mode="vocab",
        fused_qk="on" if fused else "off"))
    batch = eng.prepare(JaxTokenTrie(seqs, attachs))
    ids = [int(b) for b in batch.packed.seq_batch_ids]
    extras = _extras(_extras_table(seqs), ids, jnp.asarray)
    jqp = sys.modules["dynamictreeattn_tpu.ops.qk_prep"]
    orig, calls = jqp.qkv_prep, []
    with pytest.MonkeyPatch.context() as mp:
        if fused:  # its qkv_prep (custom_vjp over K4-K7) in interpret mode
            mp.setattr(jqp, "qkv_prep", lambda *a: calls.append(a) or orig(*a[:9], True))
        loss_val, grads = eng.loss_and_grad_custom(jp, batch, LOSSES[loss][1], extras)
    assert calls or not fused, "the JAX engine did not take its fused qk-prep path"
    return float(loss_val), params_from_numpy(jax.tree.map(np.asarray, grads), device="cpu")


@pytest.fixture(scope="module")
def jax_custom():
    """(loss, grads) of the JAX engine's custom step, by (fused, loss)."""
    cache = {}

    def get(fused, loss):
        if (fused, loss) not in cache:
            cache[fused, loss] = _jax_custom(fused, loss)
        return cache[fused, loss]

    return get


def _port_engine(cfg):
    return TreeEngine(MC, EngineConfig(**{"block_q": 16, "block_kv": 16, **cfg}), device="cpu")


# (port config, whether the JAX reference takes its fused qk-prep path)
PORT_CFGS = {
    "kernel": (dict(), True),  # fused qk-prep, "cached" (K3) backward, K8/K9, remat
    "kernel-split-unfused": (dict(bwd_mode="split", fused_qk="off", remat=False), False),
    "reference": (dict(attn_backend="reference", loss_mode="vocab", remat=False), False),
}


@pytest.mark.parametrize("loss", sorted(LOSSES))
@pytest.mark.parametrize("cfg", sorted(PORT_CFGS))
def test_custom_step_matches_jax_engine(jax_custom, cfg, loss):
    port_cfg, fused = PORT_CFGS[cfg]
    want_loss, want_grads = jax_custom(fused, loss)
    seqs, attachs, _, tp = _setup()
    eng = _port_engine(port_cfg)
    got_loss, grads = _port_custom(eng, tp, eng.prepare(TokenTrie(seqs, attachs)), LOSSES[loss][0],
                                   _extras_table(seqs))
    np.testing.assert_allclose(float(got_loss), want_loss, rtol=LOSS_RTOL)
    rows = compare_grads(want_grads, grads)
    assert len(rows) == 2 * 11 + 2  # 11 stacked leaves x 2 layers, embed, final_norm
    assert rows[0][1] < GRAD_REL, rows[:3]


@pytest.mark.parametrize("cfg", sorted(PORT_CFGS))
def test_custom_linear_matches_fast_path(cfg):
    seqs, attachs, _, tp = _setup(seed=1)
    eng = _port_engine(PORT_CFGS[cfg][0])
    batch = eng.prepare(TokenTrie(seqs, attachs))
    loss_fast, grads_fast, _ = eng.loss_and_grad(tp, batch)
    loss_c, grads_c = _port_custom(eng, tp, batch, linear_loss)
    np.testing.assert_allclose(float(loss_c), float(loss_fast), rtol=1e-5)
    for (name, a), (_, b) in zip(named_leaves(grads_fast), named_leaves(grads_c)):
        assert a.stride() == b.stride(), name
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("cfg", sorted(PORT_CFGS))
def test_ppo_style_loss_tree_vs_dense(cfg):
    """A nonlinear per-sequence loss (the GRPO clipped ratio): tree == dense."""
    seqs, attachs, _, tp = _setup(seed=2, n_seqs=8)
    eng = _port_engine(PORT_CFGS[cfg][0])
    t_batch = eng.prepare(TokenTrie(seqs, attachs))
    d_batch = eng.prepare(pack_sequences_dense(seqs, attachs, pad_multiple=eng.cfg.pad_multiple))
    assert int(t_batch.packed.seq_lens.max()) == int(d_batch.packed.seq_lens.max())
    table = _extras_table(seqs, seed=3)
    lt, gt = _port_custom(eng, tp, t_batch, LOSSES["grpo"][0], table)
    ld, gd = _port_custom(eng, tp, d_batch, LOSSES["grpo"][0], table)
    np.testing.assert_allclose(float(lt), float(ld), rtol=1e-5)
    rows = compare_grads(gd, gt)
    assert rows[0][1] < TREE_DENSE_REL, rows[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seq_gather_arrays_match_jax(seed):
    seqs, attachs, _, _ = _setup(seed=seed, n_seqs=12)
    jeng = JaxTreeEngine(jq.MODEL_CONFIGS["qwen3-tiny"], JaxEngineConfig(
        block_q=16, block_kv=16, attn_backend="reference"))
    want_paths, want_lens = jeng.seq_gather_arrays(jeng.prepare(JaxTokenTrie(seqs, attachs)))
    eng = _port_engine({})
    batch = eng.prepare(TokenTrie(seqs, attachs))
    paths, lens = eng.seq_gather_arrays(batch)
    assert paths.dtype == torch.int32 and lens.dtype == torch.int32
    np.testing.assert_array_equal(paths.numpy(), np.asarray(want_paths))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))
    assert eng.seq_gather_arrays(batch)[0] is paths  # cached on the batch


def test_vmap_fallback_is_caught():
    """The warnings filter of these tests does catch a vmap fallback: a loss
    whose op has no batching rule fails under it (and runs without it)."""
    seqs, attachs, _, tp = _setup(seed=4, n_seqs=4)
    eng = _port_engine(dict(attn_backend="reference", loss_mode="vocab", remat=False))
    batch = eng.prepare(TokenTrie(seqs, attachs))

    def no_rule(lp, ent, extras, length):  # aten::histc has no batching rule
        return lp.sum() + torch.histc(ent.detach(), bins=4).sum() * 0

    with pytest.raises(UserWarning, match="batching rule"):
        _port_custom(eng, tp, batch, no_rule)
    with pytest.warns(UserWarning, match="batching rule"):
        assert torch.isfinite(eng.loss_and_grad_custom(tp, batch, no_rule)[0])
