"""The tree engine of the port against the JAX engine at the layouts of the
model families beyond Qwen3: a Qwen2.5-style tiny config (q/k/v bias, no
qk-norm, GQA group 3) and a Llama-style one (no qk-norm, llama3 RoPE, group
4, head_dim 64), each built by ``dataclasses.replace`` of the same tiny
config on both sides.

fp32 on the CPU, weights from the JAX package's init converted through
numpy. The JAX engine runs its reference backend (dense-mask attention,
vocab-chunked loss, no remat); the port runs its kernel backend, whose
"auto" choices for a model without qk-norm are the slice's path: the online
forward (K2), fused qk-prep without the norm (K4-K7), K8/K9 and the "cached"
backward (K3) under remat — all in their plain versions on CPU tensors —
then the other backward modes and the reference backend. Bars: per-token
log-probs 1e-4 absolute (as test_torch_engine.py); loss rtol 1e-5 and
per-parameter relative grad error <= 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.engine import EngineConfig as JaxEngineConfig
from dynamictreeattn_tpu.engine import TreeEngine as JaxTreeEngine
from dynamictreeattn_tpu.models import qwen3 as jq
from dynamictreeattn_tpu.tries import TokenTrie as JaxTokenTrie
from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine
from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, params_from_numpy
from dynamictreeattn_tpu_torch.tries import TokenTrie
from dynamictreeattn_tpu_torch.utils import compare_grads

from helpers import random_trie_batch

LOGPROB_ATOL, LOSS_RTOL, GRAD_REL = 1e-4, 1e-5, 1e-5
# family -> (tiny base config, the fields replaced on both sides)
FAMILIES = {
    "qwen2.5-style": ("qwen3-tiny", dict(use_qk_norm=False, attention_bias=True,
                                         num_attention_heads=6, num_key_value_heads=2)),
    "llama-style": ("llama-tiny", dict(num_attention_heads=8, num_key_value_heads=2, head_dim=64)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loops run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(family):
    base, fields = FAMILIES[family]
    return (dataclasses.replace(jq.MODEL_CONFIGS[base], **fields),
            dataclasses.replace(MODEL_CONFIGS[base], **fields))


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, port config, seqs, attachs, port params, JAX forward log-probs,
    JAX (loss, grads as torch tensors)) of one family, the JAX results
    computed once per module."""
    jcfg, cfg = _configs(request.param)
    rng = np.random.default_rng(7)
    seqs, attachs = random_trie_batch(rng, n_seqs=10, vocab=128, max_len=40)
    jp = jq.init_params(jcfg, jax.random.key(7), dtype=jnp.float32)
    eng = JaxTreeEngine(jcfg, JaxEngineConfig(block_q=16, block_kv=16, remat=False,
                                              attn_backend="reference", loss_mode="vocab",
                                              fused_qk="off"))
    batch = eng.prepare(JaxTokenTrie(seqs, attachs))
    lp = eng.forward(jp, batch)
    loss, grads, _ = eng.loss_and_grad(jp, batch)
    to_torch = lambda tree: params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")  # noqa: E731
    return request.param, cfg, seqs, attachs, to_torch(jp), lp, (float(loss), to_torch(grads))


def _engine(cfg, **kw):
    return TreeEngine(cfg, EngineConfig(**{"block_q": 16, "block_kv": 16, **kw}), device="cpu")


def test_families_are_the_layouts_asked_for(family):
    name, cfg, *_ = family
    group = cfg.num_attention_heads // cfg.num_key_value_heads
    assert not cfg.use_qk_norm
    assert (cfg.head_dim, group, cfg.attention_bias) == {"qwen2.5-style": (16, 3, True),
                                                         "llama-style": (64, 4, False)}[name]


@pytest.mark.parametrize("kw", [
    dict(),  # kernel backend: "auto" -> online forward (no qk-norm), fused qk-prep, K8
    dict(fused_qk="off", loss_mode="vocab"),
    dict(attn_backend="reference"),
])
def test_forward_matches_jax_engine_family(family, kw):
    _, cfg, seqs, attachs, tp, want, _ = family
    eng = _engine(cfg, **kw)
    got = eng.forward(tp, eng.prepare(TokenTrie(seqs, attachs)))
    assert set(got) == set(want) == set(range(len(seqs)))
    for bid, w in want.items():
        np.testing.assert_allclose(got[bid], np.asarray(w), atol=LOGPROB_ATOL, rtol=0, err_msg=f"seq {bid}")


@pytest.mark.parametrize("kw", [
    dict(),  # "auto": online forward, fused qk-prep, "cached" backward (K3), remat
    dict(bwd_mode="fused"),
    dict(bwd_mode="split", fused_qk="off", remat=False),
])
def test_loss_and_grad_match_jax_engine_family(family, kw):
    _, cfg, seqs, attachs, tp, _, (want_loss, want_grads) = family
    eng = _engine(cfg, **kw)
    loss, grads, _ = eng.loss_and_grad(tp, eng.prepare(TokenTrie(seqs, attachs)))
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    rows = compare_grads(want_grads, grads)
    # every parameter compared: each stacked layer leaf once per layer
    assert len(rows) == len(want_grads["layers"]) * cfg.num_hidden_layers + len(want_grads) - 1
    assert rows[0][1] <= GRAD_REL, rows[:3]
