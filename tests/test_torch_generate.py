"""The port's KV-cache sampler (models/generate.py) against the JAX
package's, in one process on the CPU.

Weights come from the JAX ``init_params`` through ``params_from_numpy``
(fp32); prompts and caches from seeded numpy. One prefill and one decode
step (flat, and grouped with both port backends against JAX's "xla" one)
agree within 1e-4 (fp32 through two layers in another summation order);
greedy tokens are equal token for token. qwen3-tiny, llama-tiny and
qwen3-moe-tiny (whose MoE blocks route with the capacities of the JAX
module's paths: each chunk's rows, a decode step's rows). Sampled tokens come from a torch
generator, so they are held by their own properties (eos tail, branches
diverge, seed reproducibility), not against JAX's.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamictreeattn_tpu.models.generate as jax_gen_module  # noqa: F401  (the module)
from dynamictreeattn_tpu.models import MODEL_CONFIGS as JAX_CONFIGS, init_params as jax_init_params
from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, generate, generate_grouped, params_from_numpy
import dynamictreeattn_tpu_torch.models.generate  # noqa: F401  (the module, not the function)

jgen = sys.modules["dynamictreeattn_tpu.models.generate"]
tgen = sys.modules["dynamictreeattn_tpu_torch.models.generate"]
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loops run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["qwen3-tiny", "llama-tiny", "qwen3-moe-tiny"])
def model(request):
    """(name, JAX params, port params) from one seeded JAX init (fp32)."""
    name = request.param
    jp = jax_init_params(JAX_CONFIGS[name], jax.random.key(3), dtype=jnp.float32)
    return name, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _ragged_prompts(seed, lens, vocab=128):
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int32)
    prompts = np.zeros((len(lens), int(lens.max())), np.int32)
    for b, n in enumerate(lens):
        prompts[b, :n] = rng.integers(1, vocab, size=n)
    return prompts, lens


def _f32(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_prefill_matches_jax(model):
    """Two chunks of one sequence (start 0, then start 9): hidden states and
    every written cache slot equal JAX's forward_hidden_cached."""
    name, jp, tp = model
    c = MODEL_CONFIGS[name]
    L, hkv, dh = c.num_hidden_layers, c.num_key_value_heads, c.head_dim
    toks = np.random.default_rng(0).integers(1, c.vocab_size, size=14).astype(np.int32)
    jk = jv = jnp.zeros((L, hkv, 20, dh), jnp.float32)
    tk, tv = torch.zeros((L, hkv, 20, dh)), torch.zeros((L, hkv, 20, dh))
    for lo, hi in ((0, 9), (9, 14)):
        pos = np.arange(lo, hi, dtype=np.int32)
        jh, jk, jv = jgen.forward_hidden_cached(jp, JAX_CONFIGS[name], jnp.asarray(toks[lo:hi]),
                                                jnp.asarray(pos), jk, jv, lo)
        th, tk, tv = tgen.forward_hidden_cached(tp, c, torch.from_numpy(toks[lo:hi]), torch.from_numpy(pos),
                                                tk, tv, lo)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    logits, _, _ = tgen.forward_step(tp, c, torch.from_numpy(toks[:3]), torch.arange(3),
                                     torch.zeros((L, hkv, 20, dh)), torch.zeros((L, hkv, 20, dh)), 0)
    want, _, _ = jgen.forward_step(jp, JAX_CONFIGS[name], jnp.asarray(toks[:3]), jnp.arange(3),
                                   jnp.zeros((L, hkv, 20, dh)), jnp.zeros((L, hkv, 20, dh)), 0)
    assert logits.dtype == torch.float32 and logits.shape == (3, c.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("t", [0, 5])
def test_flat_decode_step_matches_jax(model, t):
    """One _decode_step_flat on random caches (rows of ragged prompt
    lengths): logits and the cache slot it writes."""
    name, jp, tp = model
    c = MODEL_CONFIGS[name]
    L, hkv, dh, B, lp0 = c.num_hidden_layers, c.num_key_value_heads, c.head_dim, 3, 7
    ck, cv = _f32(L, B, hkv, lp0 + 8, dh, seed=1), _f32(L, B, hkv, lp0 + 8, dh, seed=2)
    tok = np.array([5, 17, 99], np.int32)
    plens = np.array([7, 3, 5], np.int32)
    want, wk, wv = jgen._decode_step_flat(jp, JAX_CONFIGS[name], jnp.asarray(tok), jnp.asarray(plens), lp0,
                                          t, jnp.asarray(ck), jnp.asarray(cv))
    got, gk, gv = tgen._decode_step_flat(tp, c, torch.from_numpy(tok), torch.from_numpy(plens), lp0, t,
                                         torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL, rtol=0)


@pytest.mark.parametrize("backend", ["kernel", "reference"])
@pytest.mark.parametrize("t", [0, 6])
def test_grouped_decode_step_matches_jax(model, t, backend):
    """One _decode_step_grouped on random caches, both port backends (kernel
    = K13's plain version on the CPU) against JAX's "xla" backend: logits
    [P, G, V] and the branch-cache slot t it writes."""
    name, jp, tp = model
    c = MODEL_CONFIGS[name]
    L, hkv, dh, P, G, Lp, Nc = c.num_hidden_layers, c.num_key_value_heads, c.head_dim, 2, 3, 9, 8
    ckp, cvp = _f32(L, P, hkv, Lp, dh, seed=3), _f32(L, P, hkv, Lp, dh, seed=4)
    ckc, cvc = _f32(L, P, G, hkv, Nc, dh, seed=5), _f32(L, P, G, hkv, Nc, dh, seed=6)
    tok = np.random.default_rng(7).integers(1, c.vocab_size, size=(P, G)).astype(np.int32)
    plens = np.array([9, 4], np.int32)
    want, wk, wv = jgen._decode_step_grouped(jp, JAX_CONFIGS[name], jnp.asarray(tok), jnp.asarray(plens), t,
                                             *map(jnp.asarray, (ckp, cvp, ckc, cvc)), backend="xla")
    got, gk, gv = tgen._decode_step_grouped(tp, c, torch.from_numpy(tok), torch.from_numpy(plens), t,
                                            torch.from_numpy(ckp), torch.from_numpy(cvp),
                                            torch.from_numpy(ckc.copy()), torch.from_numpy(cvc.copy()),
                                            backend)
    assert got.shape == (P, G, c.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL, rtol=0)


@pytest.mark.parametrize("t", [0, 6])
def test_grouped_decode_step_takes_a_tensor_t(model, t):
    """The step with t as an int32 tensor (as the replayed step holds it)
    gives the int-t step's logits and cache writes exactly, and stays within
    ATOL of JAX's _decode_step_grouped, with both backends."""
    name, jp, tp = model
    c = MODEL_CONFIGS[name]
    L, hkv, dh, P, G, Lp, Nc = c.num_hidden_layers, c.num_key_value_heads, c.head_dim, 2, 3, 9, 8
    ckp, cvp = _f32(L, P, hkv, Lp, dh, seed=13), _f32(L, P, hkv, Lp, dh, seed=14)
    ckc, cvc = _f32(L, P, G, hkv, Nc, dh, seed=15), _f32(L, P, G, hkv, Nc, dh, seed=16)
    tok = np.random.default_rng(17).integers(1, c.vocab_size, size=(P, G)).astype(np.int32)
    plens = np.array([4, 9], np.int32)
    want, wk, wv = jgen._decode_step_grouped(jp, JAX_CONFIGS[name], jnp.asarray(tok), jnp.asarray(plens), t,
                                             *map(jnp.asarray, (ckp, cvp, ckc, cvc)), backend="xla")
    for backend in ("kernel", "reference"):
        outs = [tgen._decode_step_grouped(tp, c, torch.from_numpy(tok), torch.from_numpy(plens), step_t,
                                          torch.from_numpy(ckp), torch.from_numpy(cvp),
                                          torch.from_numpy(ckc.copy()), torch.from_numpy(cvc.copy()), backend)
                for step_t in (t, torch.tensor(t, dtype=torch.int32))]
        for got_int, got_dev in zip(*outs):
            torch.testing.assert_close(got_dev, got_int, rtol=0, atol=0)
        got, gk, gv = outs[1]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0, err_msg=backend)
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=ATOL, rtol=0, err_msg=backend)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL, rtol=0, err_msg=backend)


def _grouped_loops(tp, c, prompts, lens, G, max_new, eos_id=None, seed=5, **sampling):
    """(the replay loop's tokens, the host-t eager loop's tokens), each
    [max_new, P, G], from the same prefill and a generator of one seed: the
    captured-step function run eagerly as the replayed loop runs it, and
    ``_decode_loop`` stepping with a host int t."""
    P, Lp = prompts.shape
    L, hkv, dh = c.num_hidden_layers, c.num_key_value_heads, c.head_dim
    cache = tgen.init_cache(c, P, Lp, torch.float32, "cpu")
    last = tgen._prefill(tp, c, prompts, lens, cache["k"], cache["v"])
    plens = torch.as_tensor(lens)
    layers = tgen._layer_list(tp)
    outs = []
    for replayed in (True, False):
        ckc, cvc = torch.zeros((L, P, G, hkv, max_new, dh)), torch.zeros((L, P, G, hkv, max_new, dh))
        gen = torch.Generator().manual_seed(seed)
        sample = tgen._sampler(gen, 1.0, sampling.get("greedy", False), sampling.get("top_k", 0),
                               sampling.get("top_p"), sampling.get("min_p"))

        def step(tok, t):
            return tgen._decode_step_grouped(tp, c, tok, plens, t, cache["k"], cache["v"], ckc, cvc,
                                             layers=layers)[0]

        tok0 = sample(last[:, None, :].expand(P, G, last.shape[-1]))
        if replayed:
            state = tgen._grouped_state(tok0, max_new, eos_id)
            outs.append(tgen._decode_loop_grouped(lambda: tgen._grouped_step(step, sample, state, eos_id),
                                                  state, max_new, eos_id, gen, graph=False))
        else:
            outs.append(tgen._decode_loop(step, sample, tok0, max_new, eos_id))
    return outs


def test_replay_loop_greedy_equals_jax_and_the_eager_loop(model):
    """The captured-step function, run eagerly on the CPU as the replayed
    loop runs it: greedy tokens equal JAX's generate_grouped and the host-t
    eager loop's."""
    name, jp, tp = model
    prompts, lens = _ragged_prompts(30, [9, 6])
    G, max_new = 3, 9
    replayed, eager = _grouped_loops(tp, MODEL_CONFIGS[name], prompts, lens, G, max_new, greedy=True)
    want = jgen.generate_grouped(jp, JAX_CONFIGS[name], prompts, lens, G, max_new, greedy=True)
    np.testing.assert_array_equal(replayed.permute(1, 2, 0).numpy(), want)
    torch.testing.assert_close(replayed, eager, rtol=0, atol=0)


def test_replay_loop_sampled_equals_the_eager_loop(qwen_tiny):
    """With top-k / top-p (and min-p) the replayed loop's tokens from one
    torch.Generator seed equal the eager loop's, draw for draw."""
    c, tp = qwen_tiny
    prompts, lens = _ragged_prompts(31, [8, 5])
    for filters in ({"top_k": 20, "top_p": 0.9}, {"top_p": 0.8, "min_p": 0.05}):
        replayed, eager = _grouped_loops(tp, c, prompts, lens, 4, 10, **filters)
        torch.testing.assert_close(replayed, eager, rtol=0, atol=0)
        assert len({tuple(r) for r in replayed.permute(1, 2, 0).reshape(-1, 10).tolist()}) > 1


def test_replay_loop_eos_tail_and_early_stop(qwen_tiny, monkeypatch):
    """Under eos_id the replayed loop equals the eager loop (the forced-eos
    tail), and once every row is done it stops at its first check."""
    c, tp = qwen_tiny
    prompts = np.random.default_rng(32).integers(1, c.vocab_size, size=(2, 8)).astype(np.int32)
    lens = np.full(2, 8, np.int32)
    free, _ = _grouped_loops(tp, c, prompts, lens, 3, 12)
    eos = int(free[2, 0, 0])
    replayed, eager = _grouped_loops(tp, c, prompts, lens, 3, 12, eos_id=eos)
    torch.testing.assert_close(replayed, eager, rtol=0, atol=0)
    _check_eos(free.permute(1, 2, 0).numpy(), replayed.permute(1, 2, 0).numpy(), eos)
    # every branch's first token is eos: one check, then the loop stops
    same = np.tile(prompts[:1], (2, 1))
    first = int(generate_grouped(tp, c, same, lens, 2, 1, greedy=True)[0, 0, 0])
    steps = []
    real = tgen._decode_step_grouped
    monkeypatch.setattr(tgen, "_decode_step_grouped",
                        lambda *a, **k: steps.append(int(a[4])) or real(*a, **k))
    out = generate_grouped(tp, c, same, lens, 2, 40, greedy=True, eos_id=first)
    assert (out == first).all()
    assert steps == list(range(tgen.EOS_CHECK_EVERY))


def test_greedy_flat_tokens_equal_jax(model):
    name, jp, tp = model
    prompts, lens = _ragged_prompts(0, [9, 13, 6])
    want = jgen.generate(jp, JAX_CONFIGS[name], prompts, lens, 8, greedy=True)
    got = generate(tp, MODEL_CONFIGS[name], prompts, lens, 8, greedy=True)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)


def test_greedy_grouped_tokens_equal_jax_and_flat(model):
    """generate_grouped (both backends) equals JAX's generate_grouped and the
    port's flat generate on the duplicated prompts; all branches equal."""
    name, jp, tp = model
    c = MODEL_CONFIGS[name]
    prompts, lens = _ragged_prompts(8, [9, 6])
    G, max_new = 3, 7
    want = jgen.generate_grouped(jp, JAX_CONFIGS[name], prompts, lens, G, max_new, greedy=True)
    flat = generate(tp, c, prompts, lens, max_new, greedy=True)
    for backend in ("auto", "kernel", "reference"):
        got = generate_grouped(tp, c, prompts, lens, G, max_new, greedy=True, backend=backend)
        assert got.dtype == np.int32 and got.shape == (2, G, max_new)
        np.testing.assert_array_equal(got, want, err_msg=backend)
        np.testing.assert_array_equal(got, np.broadcast_to(flat[:, None], got.shape), err_msg=backend)


@pytest.fixture(scope="module")
def qwen_tiny():
    c = MODEL_CONFIGS["qwen3-tiny"]
    jp = jax_init_params(JAX_CONFIGS["qwen3-tiny"], jax.random.key(4), dtype=jnp.float32)
    return c, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def test_batched_rows_equal_solo_runs(qwen_tiny):
    c, tp = qwen_tiny
    prompts, lens = _ragged_prompts(1, [7, 12])
    both = generate(tp, c, prompts, lens, 6, greedy=True)
    for b, n in enumerate(lens):
        solo = generate(tp, c, prompts[b:b + 1, :n], lens[b:b + 1], 6, greedy=True)
        np.testing.assert_array_equal(both[b], solo[0])
    grouped = generate_grouped(tp, c, prompts, lens, 2, 6, greedy=True)
    for p, n in enumerate(lens):
        solo = generate_grouped(tp, c, prompts[p:p + 1, :n], lens[p:p + 1], 2, 6, greedy=True)
        np.testing.assert_array_equal(grouped[p], solo[0])


def _check_eos(free, out, eos):
    """`out` equals `free` up to each row's first eos and is eos after it."""
    for row_free, row_out in zip(free.reshape(-1, free.shape[-1]), out.reshape(-1, out.shape[-1])):
        hits = np.nonzero(row_free == eos)[0]
        cut = hits[0] + 1 if len(hits) else len(row_free)
        np.testing.assert_array_equal(row_out[:cut], row_free[:cut])
        assert (row_out[cut:] == eos).all()


def test_eos_tail_and_prefix_flat(qwen_tiny):
    c, tp = qwen_tiny
    prompts = np.random.default_rng(20).integers(1, c.vocab_size, size=(4, 8)).astype(np.int32)
    lens = np.full(4, 8, np.int32)
    free = generate(tp, c, prompts, lens, 12, greedy=True)
    eos = int(free[0, 3])  # a token that appears: rows finish early
    _check_eos(free, generate(tp, c, prompts, lens, 12, greedy=True, eos_id=eos), eos)


@pytest.mark.parametrize("backend", ["kernel", "reference"])
def test_eos_tail_and_prefix_grouped(qwen_tiny, backend):
    c, tp = qwen_tiny
    prompts = np.random.default_rng(21).integers(1, c.vocab_size, size=(2, 8)).astype(np.int32)
    lens = np.full(2, 8, np.int32)

    def run(eos_id=None):
        return generate_grouped(tp, c, prompts, lens, 4, 12, generator=torch.Generator().manual_seed(3),
                                temperature=1.0, eos_id=eos_id, backend=backend)

    free = run()
    eos = int(free[0, 0, 2])
    _check_eos(free, run(eos), eos)


def test_eos_stops_the_loop_once_every_row_is_done(qwen_tiny, monkeypatch):
    """Every row's first token is eos: the loop stops at its first check
    (EOS_CHECK_EVERY steps), not after max_new - 1 steps, and the output is
    all eos."""
    c, tp = qwen_tiny
    prompts = np.tile(np.random.default_rng(22).integers(1, c.vocab_size, size=(1, 8)), (3, 1)).astype(np.int32)
    lens = np.full(3, 8, np.int32)
    eos = int(generate(tp, c, prompts, lens, 1, greedy=True)[0, 0])
    calls = []
    real = tgen._decode_step_flat
    monkeypatch.setattr(tgen, "_decode_step_flat", lambda *a, **k: calls.append(a[5]) or real(*a, **k))
    out = generate(tp, c, prompts, lens, 40, greedy=True, eos_id=eos)
    assert (out == eos).all()
    assert calls == list(range(tgen.EOS_CHECK_EVERY))


def test_top_k_1_equals_greedy(qwen_tiny):
    c, tp = qwen_tiny
    prompts, lens = _ragged_prompts(2, [8, 5])
    np.testing.assert_array_equal(generate(tp, c, prompts, lens, 5, top_k=1),
                                  generate(tp, c, prompts, lens, 5, greedy=True))
    np.testing.assert_array_equal(generate_grouped(tp, c, prompts, lens, 2, 5, top_k=1),
                                  generate_grouped(tp, c, prompts, lens, 2, 5, greedy=True))
    out = generate_grouped(tp, c, prompts, lens, 3, 4, top_k=5, top_p=0.9, min_p=0.05)
    assert out.shape == (2, 3, 4) and out.min() >= 0 and out.max() < c.vocab_size


def test_temperature_branches_diverge_and_seed_reproduces(qwen_tiny):
    c, tp = qwen_tiny
    prompts = np.random.default_rng(10).integers(1, c.vocab_size, size=(1, 8)).astype(np.int32)
    lens = np.full(1, 8, np.int32)

    def run(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return generate_grouped(tp, c, prompts, lens, 8, 12, generator=gen, temperature=1.0)

    out = run(1)
    assert len({tuple(out[0, g]) for g in range(8)}) > 1
    np.testing.assert_array_equal(run(1), out)
    np.testing.assert_array_equal(run(None), run(0))  # None = a generator seeded 0
    assert not np.array_equal(run(2), out)


def test_rejections(qwen_tiny):
    c, tp = qwen_tiny
    prompts, lens = _ragged_prompts(3, [5, 4])
    with pytest.raises(ValueError, match="backend"):
        generate_grouped(tp, c, prompts, lens, 2, 2, backend="pallas")
    with pytest.raises(ValueError, match="prompt_lens"):
        generate(tp, c, prompts, np.array([5, 0], np.int32), 2)
