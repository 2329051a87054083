"""The remat policies, nested segments, loss mode "rows" and
logits_from_hidden of the port against the JAX package.

CPU, fp32, qwen3-tiny, llama-tiny and qwen3-moe-tiny weights from the JAX package's
``init_params`` converted through numpy. The port's layers run its kernel
backend (the plain K1/K2, K11/K12 on CPU tensors, the plain qk-prep K4-K7)
on a random trie; the JAX model runs its dense-mask reference attention on
the same trie. Bars: per-parameter relative grad error < 1e-4 against JAX
under the same remat setting (the same fp32 math summed in other orders),
< 1e-6 against the port's own remat-off grads (the recompute repeats the
CPU arithmetic); "rows" against JAX's ``position_stats_rowchunked`` and the
port's "vocab" at 1e-5, grads included; logits against JAX's and HF's at
rtol/atol 2e-4 (the JAX suite's own bar, tests/test_model.py).
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.models import qwen3 as jq
from dynamictreeattn_tpu.models.hf_compat import hf_config, to_hf_state_dict
from dynamictreeattn_tpu.ops import losses as jax_losses
from dynamictreeattn_tpu.ops import tree_attention_reference as jax_tree_attention_reference
from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine
from dynamictreeattn_tpu_torch.models import (
    MODEL_CONFIGS, forward_hidden, logits_from_hidden, params_from_numpy,
)
from dynamictreeattn_tpu_torch.ops import losses, tree_attention_reference
from dynamictreeattn_tpu_torch.tries import TokenTrie
from dynamictreeattn_tpu_torch.utils import compare_grads

from helpers import random_trie_batch

import dynamictreeattn_tpu_torch.ops.tree_attention  # noqa: F401  (wrapped below, reached through sys.modules)

ta = sys.modules["dynamictreeattn_tpu_torch.ops.tree_attention"]
GRAD_REL, SELF_REL, ROWS_TOL, LOGIT_TOL = 1e-4, 1e-6, 1e-5, 2e-4
# the tiny models have 2 layers: 2 segments of one layer, or 1 of both (a
# segment whose first layer the policy's hand-off reaches)
SETTINGS = {"none": dict(remat_policy=None), "dots": dict(remat_policy="dots"),
            "attn": dict(remat_policy="attn"), "attn_dots": dict(remat_policy="attn_dots"),
            "segments2": dict(remat_policy=None, remat_segments=2),
            "attn_segments1": dict(remat_policy="attn", remat_segments=1),
            "dots_segments1": dict(remat_policy="dots", remat_segments=1)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loops run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(model: str, seed: int = 0):
    """(seqs, attachs, JAX params, the port's copy, cotangent [n, d] numpy,
    the port's engine and batch) on a random trie."""
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=8, vocab=128, max_len=30)
    jp = jq.init_params(jq.MODEL_CONFIGS[model], jax.random.key(seed), dtype=jnp.float32)
    eng = TreeEngine(MODEL_CONFIGS[model], EngineConfig(block_q=16, block_kv=16, bwd_mode="split"),
                     device="cpu")
    batch = eng.prepare(TokenTrie(seqs, attachs))
    cot = rng.standard_normal((batch.n_padded, MODEL_CONFIGS[model].hidden_size)).astype(np.float32)
    return seqs, attachs, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"), cot, eng, batch


@functools.lru_cache(maxsize=None)
def _jax_grads(model: str, setting: str):
    """JAX grads of sum(hidden * cot) under `setting`, as the port's tensors."""
    _, _, jp, _, cot, _, batch = _setup(model)
    ld = jnp.asarray(batch.last_desc.numpy())
    cfg = jq.MODEL_CONFIGS[model]

    def f(p):
        h = jq.forward_hidden(p, cfg, jnp.asarray(batch.tokens.numpy()), jnp.asarray(batch.depth.numpy()),
                              lambda q, k, v: jax_tree_attention_reference(q, k, v, ld), remat=True,
                              **SETTINGS[setting])
        return jnp.sum(h * cot)

    return params_from_numpy(jax.tree.map(np.asarray, jax.grad(f)(jp)), device="cpu")


def _port_grads(model: str, remat: bool, fused_qk: bool = True, **kw):
    _, _, _, tp, cot, eng, batch = _setup(model)
    names = [("embed",), ("final_norm",)] + [("layers", k) for k in tp["layers"]]
    flat = [tp["embed"], tp["final_norm"]] + list(tp["layers"].values())
    aliases = [t.detach().clone().requires_grad_(True) for t in flat]
    leaves = {"embed": aliases[0], "final_norm": aliases[1],
              "layers": dict(zip(tp["layers"], aliases[2:]))}
    h = forward_hidden(leaves, eng.mc, batch.tokens, batch.depth, eng._attn_fn(batch), remat=remat,
                       fused_qk=fused_qk, **kw)
    grads = dict(zip(names, torch.autograd.grad(torch.sum(h * torch.from_numpy(cot)), aliases)))
    return {k: {n: grads["layers", n] for n in v} if k == "layers" else grads[k,] for k, v in tp.items()}


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("model", ["qwen3-tiny", "llama-tiny", "qwen3-moe-tiny"])
def test_policy_grads_match_jax(model, setting):
    """forward_hidden's grads under each remat policy, nested segments and
    the two together: equal to JAX's under the same setting (its inner
    jax.checkpoint takes the policy), and to the port's remat-off."""
    got = _port_grads(model, True, **SETTINGS[setting])
    rows = compare_grads(_jax_grads(model, setting), got)
    assert len(rows) == MODEL_CONFIGS[model].num_hidden_layers * len(got["layers"]) + 2
    assert rows[0][1] < GRAD_REL, rows[:3]
    own = compare_grads(_port_grads(model, False), got)
    assert own[0][1] < SELF_REL, own[:3]


@pytest.mark.parametrize("setting,runs,kept", [("off", 1, 0), ("none", 2, 0), ("dots", 2, 7), ("attn", 1, 1),
                                               ("attn_dots", 1, 8), ("segments2", 2, 0),
                                               ("attn_segments1", 2, 1), ("dots_segments1", 2.5, 7)])
def test_attention_forward_runs_per_policy(monkeypatch, setting, runs, kept):
    """A counter on the plain K1/K2: a training step of L layers runs the
    attention forward L times under "attn" / "attn_dots" (the recompute
    takes the first forward's o and lse) and 2L under None / "dots". G
    nested segments add the outer recompute of every layer but each
    segment's last, where PyTorch's early-stopping checkpoint stops (its
    inner recompute computes everything again): 3L - G forwards (2.5 per
    layer at L = 2, G = 1), and the outer recompute keeps the policy's
    values for the other layers' inner recomputes (2L under "attn"). The
    recompute takes back what the policy keeps: per layer the seven products
    under "dots", (o, lse) under "attn", all eight under "attn_dots"; the
    outer forward keeps nothing."""
    import dynamictreeattn_tpu_torch.models.qwen3 as mq

    calls, taken = [], []
    for name in ("tree_attn_fwd_bound", "tree_attn_fwd_online"):
        orig = getattr(ta, name)
        monkeypatch.setattr(ta, name, lambda *a, _o=orig, **k: calls.append(1) or _o(*a, **k))
    take = mq.RematHandoff.take
    monkeypatch.setattr(mq.RematHandoff, "take", lambda self: taken.append(1) or take(self))
    handoffs = []
    init = mq.RematHandoff.__init__
    monkeypatch.setattr(mq.RematHandoff, "__init__",
                        lambda self, *a: handoffs.append(self) or init(self, *a))
    seqs, attachs, _, tp, _, _, _ = _setup("qwen3-tiny")
    mc = MODEL_CONFIGS["qwen3-tiny"]
    kw = dict(remat=False) if setting == "off" else SETTINGS[setting]
    eng = TreeEngine(mc, EngineConfig(block_q=16, block_kv=16, **kw), device="cpu")
    loss, _, _ = eng.loss_and_grad(tp, eng.prepare(TokenTrie(seqs, attachs)))
    L, G = mc.num_hidden_layers, kw.get("remat_segments", 0)
    assert len(calls) == runs * L
    # under segments only the layers the outer recompute reaches keep
    assert len(taken) == kept * (L - G if G else L)
    assert all(not h.saved for h in handoffs)  # everything kept was taken
    assert np.isfinite(float(loss))


@functools.lru_cache(maxsize=None)
def _rows_inputs(n: int = 200, d: int = 64, V: int = 301, seed: int = 3):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) * d**-0.5).astype(np.float32)
    g_lse, g_ent = rng.standard_normal((2, n)).astype(np.float32)
    return h, w, g_lse, g_ent


@pytest.mark.parametrize("chunk", [64, 1024, 37])
def test_rows_mode_matches_jax_and_vocab(chunk):
    """Loss mode "rows" at a ragged n (200: chunk 64 becomes 50, 37 becomes
    25, 1024 one chunk) equals JAX's position_stats_rowchunked and the port's
    "vocab" mode, values and grads, at temperature 0.7."""
    h, w, g_lse, g_ent = _rows_inputs()
    assert losses._best_chunk(200, chunk) == {64: 50, 1024: 200, 37: 25}[chunk]

    def jax_f(hh, ww):
        return jax_losses.position_stats_rowchunked(hh, ww, 0.7, chunk)

    (want_lse, want_ent), vjp = jax.vjp(jax_f, jnp.asarray(h), jnp.asarray(w))
    want_dh, want_dw = vjp((jnp.asarray(g_lse), jnp.asarray(g_ent)))
    outs = {}
    for mode in ("rows", "vocab"):
        ht, wt = (torch.from_numpy(a).requires_grad_(True) for a in (h, w))
        lse, ent = losses.position_stats_from_hidden(ht, wt, 0.7, mode=mode, chunk_size=chunk)
        dh, dw = torch.autograd.grad((lse, ent), (ht, wt), (torch.from_numpy(g_lse), torch.from_numpy(g_ent)))
        outs[mode] = [t.detach().numpy() for t in (lse, ent, dh, dw)]
    for got in outs.values():
        for a, b in zip(got, (want_lse, want_ent, want_dh, want_dw)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=ROWS_TOL, atol=ROWS_TOL)
    for a, b in zip(outs["rows"], outs["vocab"]):
        np.testing.assert_allclose(a, b, rtol=ROWS_TOL, atol=ROWS_TOL)


def test_rows_mode_engine_step_matches_vocab():
    """The engine's training step in loss mode "rows" (loss_chunk 7, which
    _best_chunk shrinks to a divisor of the padded length) equals "vocab"."""
    seqs, attachs, _, tp, _, _, _ = _setup("qwen3-tiny")
    steps = {}
    for mode in ("rows", "vocab"):
        eng = TreeEngine(MODEL_CONFIGS["qwen3-tiny"], EngineConfig(block_q=16, block_kv=16, loss_mode=mode,
                                                                     loss_chunk=7), device="cpu")
        steps[mode] = eng.loss_and_grad(tp, eng.prepare(TokenTrie(seqs, attachs)))
    np.testing.assert_allclose(float(steps["rows"][0]), float(steps["vocab"][0]), rtol=ROWS_TOL)
    assert compare_grads(steps["vocab"][1], steps["rows"][1])[0][1] < ROWS_TOL


@pytest.mark.parametrize("model,tie", [("qwen3-tiny", True), ("qwen3-tiny", False), ("llama-tiny", True)])
def test_logits_from_hidden_matches_jax_and_hf(model, tie):
    """logits_from_hidden on the port's causal forward equals the JAX
    package's and HF's Qwen3ForCausalLM / LlamaForCausalLM (random init, the
    HF state dict from the JAX package's to_hf_state_dict)."""
    import dataclasses

    from transformers.models.llama import LlamaForCausalLM
    from transformers.models.qwen3 import Qwen3ForCausalLM

    jcfg = dataclasses.replace(jq.MODEL_CONFIGS[model], tie_word_embeddings=tie)
    cfg = dataclasses.replace(MODEL_CONFIGS[model], tie_word_embeddings=tie)
    jp = jq.init_params(jcfg, jax.random.key(6), dtype=jnp.float32)
    n = 20
    tokens = np.arange(n, dtype=np.int32) * 7 % cfg.vocab_size
    chain = np.full((n,), n - 1, dtype=np.int32)  # one sequence: causal
    jh = jq.forward_hidden(jp, jcfg, jnp.asarray(tokens), jnp.arange(n, dtype=jnp.int32),
                           lambda q, k, v: jax_tree_attention_reference(q, k, v, jnp.asarray(chain)))
    want = np.asarray(jq.logits_from_hidden(jp, jcfg, jh))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    pos = torch.arange(n, dtype=torch.int32)
    hidden = forward_hidden(tp, cfg, torch.from_numpy(tokens), pos,
                            lambda q, k, v: tree_attention_reference(q, k, v, torch.from_numpy(chain)))
    got = logits_from_hidden(tp, cfg, hidden)
    assert got.dtype == torch.float32 and got.shape == (n, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    hf_model = (LlamaForCausalLM if model.startswith("llama") else Qwen3ForCausalLM)(hf_config(jcfg)).eval()
    sd = {k: torch.from_numpy(np.array(v)) for k, v in to_hf_state_dict(jp, jcfg).items()}
    missing, unexpected = hf_model.load_state_dict(sd, strict=False)
    assert not [m for m in missing if "rotary" not in m] and not unexpected, (missing, unexpected)
    with torch.no_grad():
        theirs = hf_model(torch.from_numpy(tokens[None].astype(np.int64))).logits[0].float().numpy()
    np.testing.assert_allclose(got.numpy(), theirs, rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("kw", [dict(remat_policy="all"), dict(remat_segments=-1), dict(loss_mode="cols")])
def test_engine_config_rejects_unknown_values(kw):
    with pytest.raises(ValueError, match="unknown|< 0"):
        EngineConfig(**kw)
