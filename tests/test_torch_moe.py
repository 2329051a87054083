"""The Qwen3-MoE family against the JAX package: routing, capacity
dispatch, the load-balance loss, the layer stack under every remat setting,
the training steps, the sampler and the trainer, and HF Qwen3MoeForCausalLM.

fp32 on the CPU; qwen3-moe-tiny (8 experts, top-2, expert width 32) with
the JAX package's init converted through numpy. The JAX side runs its
reference attention and vocab-chunked loss with ``bucketing="exact"``, so
that both engines pad a trie to the same length n: the capacity
ceil(1.5 · n · k / E) is then the same on both sides, and where pairs drop
the port must drop the same ones. Bars: routing indices exact, weights
1e-6, lb rel 1e-6; ``moe_apply`` 1e-5 against JAX and the dense per-expert
oracle, the kept (row, choice) pairs equal as sets; hidden states 1e-4 and
lb rel 1e-5 under remat; steps: loss rtol 1e-5, per-parameter grad rel
1e-4; tree vs dense (no drops, no lb term) 1e-3; logits vs HF 2e-4; greedy
tokens exactly; the trainer rtol 1e-5; two steps bit-equal.
"""

import contextlib
import dataclasses
import functools
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.engine import EngineConfig as JaxEngineConfig
from dynamictreeattn_tpu.engine import TreeEngine as JaxTreeEngine
import dynamictreeattn_tpu.models.generate  # noqa: F401  (the module, not the function)
from dynamictreeattn_tpu.models import qwen3 as jq
from dynamictreeattn_tpu.ops.tree_attention_ref import tree_attention_reference as jax_attention_reference
from dynamictreeattn_tpu.tries import TokenTrie as JaxTokenTrie
from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine, pack_sequences_dense
from dynamictreeattn_tpu_torch.models import generate, generate_grouped, params_from_numpy
from dynamictreeattn_tpu_torch.models import qwen3 as tq
from dynamictreeattn_tpu_torch.models.generate import forward_hidden_cached, init_cache
from dynamictreeattn_tpu_torch.ops import tree_attention_reference
from dynamictreeattn_tpu_torch.tries import TokenTrie
from dynamictreeattn_tpu_torch.utils import compare_grads
from dynamictreeattn_tpu_torch.utils.compare_grads import named_leaves

from helpers import random_trie_batch

jgen = sys.modules["dynamictreeattn_tpu.models.generate"]

NAME = "qwen3-moe-tiny"
MC, JMC = tq.MODEL_CONFIGS[NAME], jq.MODEL_CONFIGS[NAME]
W_TOL, LB_REL, APPLY_TOL, HIDDEN_TOL, HIDDEN_LB_REL = 1e-6, 1e-6, 1e-5, 1e-4, 1e-5
LOSS_RTOL, GRAD_REL, TREE_DENSE_REL, HF_TOL = 1e-5, 1e-4, 1e-3, 2e-4
JAX_ECFG = JaxEngineConfig(block_q=16, block_kv=16, remat=False, attn_backend="reference",
                           loss_mode="vocab", fused_qk="off", bucketing="exact")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loops run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(config_kw=None, seed=0):
    """(JAX config, port config, JAX params, the port's copy)."""
    jc = dataclasses.replace(JMC, **(config_kw or {}))
    c = dataclasses.replace(MC, **(config_kw or {}))
    jp = jq.init_params(jc, jax.random.key(seed), dtype=jnp.float32)
    return jc, c, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _t(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


@contextlib.contextmanager
def _drops():
    """``moe_apply`` wrapped: each call appends (routed, dropped, most, capacity)
    worked out from its expert ids and capacity: the (row, choice) pairs
    routed to an expert, Σ_e max(0, count_e − capacity), the most pairs one
    expert received."""
    real, rec = tq.moe_apply, []

    def wrapped(h, e_gate, e_up, e_down, idx, w, capacity):
        E, ids = e_gate.shape[0], idx.reshape(-1).numpy()
        counts = np.bincount(ids[(ids >= 0) & (ids < E)], minlength=E)
        rec.append((int(counts.sum()), int(np.maximum(counts - capacity, 0).sum()), int(counts.max()), capacity))
        return real(h, e_gate, e_up, e_down, idx, w, capacity)

    tq.moe_apply = wrapped
    try:
        yield rec
    finally:
        tq.moe_apply = real


# ---------------------------------------------------------------- routing


@pytest.mark.parametrize("masked", [False, True])
def test_moe_route_matches_jax(masked):
    rng = np.random.default_rng(0)
    n, d, E = 40, MC.hidden_size, MC.num_experts
    h = rng.standard_normal((n, d)).astype(np.float32)
    router = (rng.standard_normal((d, E)) * d**-0.5).astype(np.float32)
    valid = (np.arange(n) < 29).astype(np.float32) if masked else None
    jw, ji, jl = jq.moe_route(jnp.asarray(h), jnp.asarray(router), JMC,
                              None if valid is None else jnp.asarray(valid))
    w, idx, lb = tq.moe_route(torch.from_numpy(h), torch.from_numpy(router), MC,
                              None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=W_TOL, rtol=0)
    np.testing.assert_allclose(float(lb), float(jl), rtol=LB_REL)
    if masked:
        assert (idx.numpy()[29:] == E).all() and (idx.numpy()[:29] < E).all()


# --------------------------------------------------------------- dispatch


def _dense_moe_oracle(h, e_gate, e_up, e_down, idx, w, kept=None):
    """Loop-over-experts compute of the kept (row, choice) pairs (all when
    `kept` is None): the exact math."""
    n, d = h.shape
    y = np.zeros((n, d), np.float64)
    for t in range(n):
        for j in range(idx.shape[1]):
            if kept is not None and (t, j) not in kept:
                continue
            e = int(idx[t, j])
            a, b = h[t] @ e_gate[e], h[t] @ e_up[e]
            y[t] += float(w[t, j]) * ((a / (1.0 + np.exp(-a)) * b) @ e_down[e])
    return y


def _kept(apply, n, k):
    """The (row, choice) pairs that reach y: weight 1 on one pair at a time."""
    kept = set()
    for p in range(n * k):
        w = np.zeros((n, k), np.float32)
        w.flat[p] = 1.0
        if np.abs(apply(w)).sum() > 0:
            kept.add(divmod(p, k))
    return kept


@pytest.mark.parametrize("case", ["no_drops", "one_expert", "random_drops"])
def test_moe_apply_matches_jax_and_the_oracle(case):
    """Without drops, with everyone on expert 0 at capacity 4 (the first 4
    pairs survive), and random routing at capacity 3: y equal to JAX's and
    to the dense oracle over the kept pairs, the kept pairs the same set on
    both sides, and the record counting the drops."""
    rng = np.random.default_rng({"no_drops": 0, "one_expert": 1, "random_drops": 2}[case])
    n, d, E, k, Ie = 16, 8, 4, 2, 6
    h = rng.standard_normal((n, d)).astype(np.float32)
    e_gate, e_up = (rng.standard_normal((2, E, d, Ie)) * 0.3).astype(np.float32)
    e_down = (rng.standard_normal((E, Ie, d)) * 0.3).astype(np.float32)
    idx = rng.integers(0, E, size=(n, k)).astype(np.int32)
    idx[:, 1] = (idx[:, 0] + 1 + idx[:, 1] % (E - 1)) % E  # top-k never repeats an expert
    w = rng.uniform(0.1, 1.0, size=(n, k)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    cap = {"no_drops": n * k, "one_expert": 4, "random_drops": 3}[case]
    if case == "one_expert":
        k = 1
        idx, w = np.zeros((n, 1), np.int32), np.ones((n, 1), np.float32)

    def jax_apply(w):
        return np.asarray(jq.moe_apply(*map(jnp.asarray, (h, e_gate, e_up, e_down, idx, w)), cap))

    def port_apply(w):
        return tq.moe_apply(*map(torch.from_numpy, (h, e_gate, e_up, e_down)), torch.from_numpy(idx).long(),
                            torch.from_numpy(w), cap).numpy()

    with _drops() as rec:
        got = port_apply(w)
    np.testing.assert_allclose(got, jax_apply(w), atol=APPLY_TOL, rtol=0)
    kept = _kept(port_apply, n, k)
    assert kept == _kept(jax_apply, n, k)
    np.testing.assert_allclose(got, _dense_moe_oracle(h, e_gate, e_up, e_down, idx, w, kept),
                               atol=APPLY_TOL, rtol=0)
    routed, dropped, most, capacity = rec[0]
    assert (routed, dropped, capacity) == (n * k, n * k - len(kept), cap)
    assert most == np.bincount(idx.ravel(), minlength=E).max()
    if case == "no_drops":
        assert len(kept) == n * k
    elif case == "one_expert":
        assert kept == {(t, 0) for t in range(cap)}
    else:
        assert 0 < len(kept) < n * k


def test_moe_apply_skips_out_of_range_experts():
    """idx outside [0, E) (the padding rows' E) reaches no expert."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))
    e = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((4, 8, 5), (4, 8, 5), (4, 5, 8))]
    idx = torch.tensor([[0, 1], [4, 4], [2, -1], [3, 0], [4, 1], [1, 2]])
    w = torch.full((6, 2), 0.5)
    y = tq.moe_apply(h, *e, idx, w, 12)
    assert torch.all(y[1] == 0)
    torch.testing.assert_close(y[2], tq.moe_apply(h[2:3], *e, idx[2:3, :1], w[2:3, :1], 1)[0])


@pytest.mark.parametrize("capacity", [32, 3], ids=["no_drops", "drops"])
def test_moe_apply_backward_is_the_gradient(capacity):
    """The gather-only backward of the dispatch and the combine against
    finite differences (gradcheck, fp64) in h, the experts and the weights,
    with an out-of-range expert id among the choices."""
    rng = np.random.default_rng(4)
    n, d, E, k, Ie = 8, 5, 4, 2, 3
    t = [torch.from_numpy(rng.standard_normal(s)).requires_grad_()
         for s in ((n, d), (E, d, Ie), (E, d, Ie), (E, Ie, d))]
    idx = torch.from_numpy(rng.integers(0, E, size=(n, k)))
    idx[:, 1] = (idx[:, 0] + 1) % E
    idx[3, 1] = E  # a padding choice
    w = torch.from_numpy(rng.uniform(0.1, 1.0, size=(n, k))).requires_grad_()
    assert torch.autograd.gradcheck(lambda h, g, u, dn, w: tq.moe_apply(h, g, u, dn, idx, w, capacity),
                                    (*t, w), eps=1e-6, atol=1e-6)


def test_moe_capacity_is_jax_rule():
    for rows in (1, 7, 96, 6656, 37888):
        assert tq.moe_capacity(MC, rows) == int(math.ceil(JMC.moe_capacity_factor * rows
                                                          * JMC.num_experts_per_tok / JMC.num_experts))
    assert tq.moe_capacity(tq.MODEL_CONFIGS["qwen3-30b-a3b"], 6656) == 624


# ------------------------------------------------------------ layer stack

REMAT = {"off": dict(), "none": dict(remat=True), "dots": dict(remat=True, remat_policy="dots"),
         "attn": dict(remat=True, remat_policy="attn"), "segments2": dict(remat=True, remat_segments=2)}


@functools.lru_cache(maxsize=None)
def _stack_setup():
    """(port batch, JAX params, port params, cotangent) on a trie whose
    padding rows `valid` masks."""
    rng = np.random.default_rng(5)
    seqs, attachs = random_trie_batch(rng, n_seqs=8, vocab=MC.vocab_size, max_len=30)
    _, _, jp, tp = _both(seed=5)
    batch = TreeEngine(MC, EngineConfig(block_q=16, block_kv=16), device="cpu").prepare(TokenTrie(seqs, attachs))
    assert float(batch.valid.sum()) < batch.n_padded  # padding rows to mask
    cot = rng.standard_normal((batch.n_padded, MC.hidden_size)).astype(np.float32)
    return batch, jp, tp, cot


@functools.lru_cache(maxsize=None)
def _jax_stack(setting):
    batch, jp, _, cot = _stack_setup()
    ld, valid = jnp.asarray(batch.last_desc.numpy()), jnp.asarray(batch.valid.numpy())

    def f(p):
        h, aux = jq.forward_hidden_aux(p, JMC, jnp.asarray(batch.tokens.numpy()), jnp.asarray(batch.depth.numpy()),
                                       lambda q, k, v: jax_attention_reference(q, k, v, ld),
                                       valid=valid, **REMAT[setting])
        return jnp.sum(h * cot) + aux["lb_loss"], (h, aux["lb_loss"])

    grads, (h, lb) = jax.grad(f, has_aux=True)(jp)
    return np.asarray(h), float(lb), _t(grads)


@pytest.mark.parametrize("setting", list(REMAT))
def test_forward_hidden_aux_matches_jax(setting):
    """Hidden states, the summed lb loss and the grads of sum(h · cot) + lb
    under remat off, None, "dots", "attn" and 2 nested segments, with the
    batch's padding masked by `valid`."""
    batch, _, tp, cot = _stack_setup()
    want_h, want_lb, want_g = _jax_stack(setting)
    leaves = {k: ({n: t.clone().requires_grad_(True) for n, t in v.items()} if k == "layers"
                  else v.clone().requires_grad_(True)) for k, v in tp.items()}
    h, aux = tq.forward_hidden_aux(leaves, MC, batch.tokens, batch.depth,
                                   lambda q, k, v, handoff=None: tree_attention_reference(q, k, v, batch.last_desc),
                                   valid=batch.valid, **REMAT[setting])
    np.testing.assert_allclose(h.detach().numpy(), want_h, atol=HIDDEN_TOL, rtol=0)
    np.testing.assert_allclose(aux["lb_loss"].item(), want_lb, rtol=HIDDEN_LB_REL)
    (torch.sum(h * torch.from_numpy(cot)) + aux["lb_loss"]).backward()
    got = {k: ({n: t.grad for n, t in v.items()} if k == "layers" else v.grad) for k, v in leaves.items()}
    rows = compare_grads(want_g, got)
    assert rows[0][1] < GRAD_REL, rows[:3]


def test_moe_params_and_init():
    """init_params draws the four MoE leaves (and no dense MLP) with JAX's
    shapes and fan-in scales, the expert leaves one layer at a time."""
    c = dataclasses.replace(MC, num_hidden_layers=3)
    p = tq.init_params(c, torch.Generator().manual_seed(0), torch.float32)
    jp = jq.init_params(dataclasses.replace(JMC, num_hidden_layers=3), jax.random.key(0), jnp.float32)
    assert {k: tuple(v.shape) for k, v in p["layers"].items()} == \
        {k: tuple(v.shape) for k, v in jp["layers"].items()}
    assert "gate" not in p["layers"] and "router" in p["layers"]
    for name, fan_in in (("router", 64), ("e_gate", 64), ("e_up", 64), ("e_down", 32)):
        std = float(p["layers"][name].std())
        assert abs(std * fan_in**0.5 - 1) < 0.1, (name, std)
    assert not torch.equal(p["layers"]["e_gate"][0], p["layers"]["e_gate"][1])


# ------------------------------------------------------------------ engine


@functools.lru_cache(maxsize=None)
def _engine_setup(seed=7):
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=10, vocab=MC.vocab_size, max_len=36)
    _, _, jp, tp = _both(seed=seed)
    return seqs, attachs, jp, tp


def test_lb_term_and_custom_router_aux():
    """The step's loss is the linear loss + router_aux_coef · lb_loss; the
    custom step adds the same term only with `router_aux`, and then equals
    the linear step's loss."""
    seqs, attachs, _, tp = _engine_setup()
    eng = TreeEngine(MC, EngineConfig(block_q=16, block_kv=16, remat=False), device="cpu")
    off = TreeEngine(dataclasses.replace(MC, router_aux_coef=0.0), eng.cfg, device="cpu")
    batch = eng.prepare(TokenTrie(seqs, attachs))
    loss, aux = eng.loss(tp, batch)
    loss0, aux0 = off.loss(tp, batch)
    np.testing.assert_allclose(float(loss), float(loss0) + MC.router_aux_coef * float(aux["lb_loss"]), rtol=1e-6)
    assert float(aux["lb_loss"]) == float(aux0["lb_loss"]) > 0

    def weighted(lp, ent, extras, length):
        m_lp = (torch.arange(lp.shape[0]) < length - 1).float()
        m_en = (torch.arange(ent.shape[0]) < length).float()
        return -(lp * m_lp).sum() / torch.clamp(length - 1, min=1) + 0.1 * (ent * m_en).sum() / length

    plain, _ = eng.loss_and_grad_custom(tp, batch, weighted)
    with_lb, _, aux_c = eng.loss_and_grad_custom(tp, batch, weighted, with_aux=True, router_aux=True)
    np.testing.assert_allclose(float(plain), float(loss0), rtol=1e-5)
    np.testing.assert_allclose(float(with_lb), float(loss), rtol=1e-5)
    assert float(aux_c["lb_loss"]) == float(aux["lb_loss"])


def test_tree_matches_dense_replay():
    """The grad-parity oracle for MoE (JAX test_moe_tree_matches_dense_replay):
    no drops (capacity factor E) and no lb term (it legitimately differs
    between packings)."""
    rng = np.random.default_rng(3)
    seqs, attachs = random_trie_batch(rng, n_seqs=5, vocab=MC.vocab_size, max_len=18)
    c = dataclasses.replace(MC, moe_capacity_factor=float(MC.num_experts), router_aux_coef=0.0)
    _, _, _, tp = _both(seed=1)
    eng = TreeEngine(c, EngineConfig(block_q=16, block_kv=16), device="cpu")
    lt, gt, at = eng.loss_and_grad(tp, eng.prepare(TokenTrie(seqs, attachs)))
    ld, gd, ad = eng.loss_and_grad(tp, eng.prepare(pack_sequences_dense(seqs, attachs, pad_multiple=16)))
    np.testing.assert_allclose(float(lt), float(ld), rtol=LOSS_RTOL)
    rows = compare_grads(gd, gt)
    assert rows[0][1] < TREE_DENSE_REL, rows[:3]
    assert float(at["lb_loss"]) != float(ad["lb_loss"])  # the routed multisets differ


def test_split_steps_bit_equal():
    """Two "split" steps of the MoE tree step (kernel backend, remat) give
    bit-equal loss and grads."""
    seqs, attachs, _, tp = _engine_setup()
    eng = TreeEngine(MC, EngineConfig(block_q=16, block_kv=16, bwd_mode="split"), device="cpu")
    batch = eng.prepare(TokenTrie(seqs, attachs))
    (l1, g1, a1), (l2, g2, a2) = eng.loss_and_grad(tp, batch), eng.loss_and_grad(tp, batch)
    assert torch.equal(l1, l2) and torch.equal(a1["lb_loss"], a2["lb_loss"])
    for (_, x), (_, y) in zip(named_leaves(g1), named_leaves(g2)):
        assert torch.equal(x, y)


def test_forward_routes_with_valid():
    """TreeEngine.forward masks the padding out of routing: its log-probs
    equal the JAX engine's forward at the same padded length."""
    seqs, attachs, jp, tp = _engine_setup()
    jeng = JaxTreeEngine(JMC, JAX_ECFG)
    want = jeng.forward(jp, jeng.prepare(JaxTokenTrie(seqs, attachs)))
    eng = TreeEngine(MC, EngineConfig(block_q=16, block_kv=16), device="cpu")
    got = eng.forward(tp, eng.prepare(TokenTrie(seqs, attachs)))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4, rtol=0)


# ----------------------------------------------------------------- sampler

DROPPING = dict(moe_capacity_factor=0.5)


@functools.lru_cache(maxsize=None)
def _sampler_setup():
    jc, c, jp, tp = _both(DROPPING, seed=9)
    rng = np.random.default_rng(9)
    lens = np.array([13, 5, 9], np.int32)
    prompts = np.zeros((3, 13), np.int32)
    for b, n in enumerate(lens):
        prompts[b, :n] = rng.integers(1, MC.vocab_size, size=n)
    return jc, c, jp, tp, prompts, lens


def test_ragged_prefill_routes_with_the_padded_width():
    """A short row's prefill: the JAX row over the padded width Lp (padding
    masked by valid) equals the port's real tokens at the capacity of Lp
    rows, and differs from the capacity of the row's own length (which
    drops other pairs here): the Lp trap."""
    jc, c, jp, tp, prompts, lens = _sampler_setup()
    Lp, n = prompts.shape[1], int(lens[1])
    jcache = jgen.init_cache(jc, 1, Lp, jnp.float32)
    valid = (np.arange(Lp) < n).astype(np.int32)
    want, _, _ = jgen.forward_hidden_cached(jp, jc, jnp.asarray(prompts[1]), jnp.arange(Lp), jcache["k"][:, 0],
                                            jcache["v"][:, 0], 0, jnp.asarray(valid))
    want = np.asarray(want)[:n]

    def port(moe_rows):
        cache = init_cache(c, 1, Lp, torch.float32, "cpu")
        with _drops() as rec:
            h, _, _ = forward_hidden_cached(tp, c, torch.from_numpy(prompts[1, :n]), torch.arange(n),
                                            cache["k"][:, 0], cache["v"][:, 0], 0, moe_rows=moe_rows)
        return h.numpy(), rec

    got, rec = port(Lp)
    np.testing.assert_allclose(got, want, atol=HIDDEN_TOL, rtol=0)
    assert all(r[3] == tq.moe_capacity(c, Lp) for r in rec)
    wrong, rec_wrong = port(None)
    assert sum(r[1] for r in rec_wrong) > sum(r[1] for r in rec)
    assert np.abs(wrong - want).max() > 100 * HIDDEN_TOL


def test_greedy_tokens_equal_jax_at_a_dropping_capacity():
    """Greedy generate and generate_grouped (both backends) on ragged
    prompts at capacity factor 0.5, where the prefill drops pairs: the
    tokens equal JAX's (its einsum backend for the grouped rollout, which
    routes over the prompt width as given)."""
    jc, c, jp, tp, prompts, lens = _sampler_setup()
    with _drops() as rec:
        got = generate(tp, c, prompts, lens, 6, greedy=True)
    assert sum(r[1] for r in rec) > 0
    np.testing.assert_array_equal(got, np.asarray(jgen.generate(jp, jc, prompts, lens, 6, greedy=True)))
    want = np.asarray(jgen.generate_grouped(jp, jc, prompts, lens, 3, 6, greedy=True, backend="xla"))
    for backend in ("kernel", "reference"):
        np.testing.assert_array_equal(generate_grouped(tp, c, prompts, lens, 3, 6, greedy=True, backend=backend),
                                      want)


def test_decode_capacity_is_exact():
    """A decode step routes its B (or P·G) rows at capacity B: nothing drops,
    even with every row on the same experts."""
    jc, c, jp, tp, prompts, lens = _sampler_setup()
    with _drops() as rec:
        generate_grouped(tp, c, prompts, lens, 4, 5, greedy=True)
    decode = [r for r in rec if r[3] == 3 * 4]
    assert decode and all(r[1] == 0 for r in decode)
