"""The RL examples of the port against the JAX package's (examples/grpo.py,
examples/rl_loop.py).

CPU, fp32 qwen3-tiny, the reference backend, the JAX tests' arguments
(tests/test_examples.py) plus ``--device cpu``:

* the GRPO example descends and the RL loop's sampled reward rises (the
  port draws its samples from a ``torch.Generator``, so the trajectory is
  its own, not JAX's);
* ``make_grpo_loss`` vmapped over random sequences equals JAX's in value
  and in the grads of lp and ent (rtol 1e-5, atol 1e-6: fp32 exp and sums
  in other orders), finite where the padding would overflow the exp;
* ``grpo_advantages`` equals JAX's exactly (the same numpy);
* the first GRPO step (behavior log-probs, extras, loss and grads) equals
  the JAX example's on the same params and batch (loss rtol 1e-5, grads
  rel < 1e-4, as tests/test_torch_custom_loss.py);
* ``adamw`` + ``apply_grads`` equal ``optax.adamw`` (its weight decay 1e-4,
  not torch's 1e-2) at fp32 within 1e-6, an untied [d, V] head view
  included.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dynamictreeattn_tpu.data import synthetic_rollout_batch as jax_synthetic_rollout_batch
from dynamictreeattn_tpu.engine import EngineConfig as JaxEngineConfig
from dynamictreeattn_tpu.engine import TreeEngine as JaxTreeEngine
from dynamictreeattn_tpu.models import qwen3 as jq
from dynamictreeattn_tpu.tries import TokenTrie as JaxTokenTrie
from dynamictreeattn_tpu_torch.data import synthetic_rollout_batch
from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine
from dynamictreeattn_tpu_torch.examples import grpo, rl_loop
from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, params_from_numpy
from dynamictreeattn_tpu_torch.tries import TokenTrie
from dynamictreeattn_tpu_torch.utils import compare_grads
from dynamictreeattn_tpu_torch.utils.compare_grads import named_leaves

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from examples import grpo as jax_grpo  # noqa: E402

TINY_ARGS = ["--model", "qwen3-tiny", "--attn-backend", "reference", "--dtype", "fp32",
             "--block-q", "32", "--block-kv", "32", "--loss-chunk", "32", "--no-remat",
             "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loops run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_grpo_example_descends():
    hist = grpo.main(TINY_ARGS + ["--steps", "5", "--prompt-len", "24", "--completion-len", "12",
                                  "--samples", "6", "--lr", "1e-3"])
    assert all(np.isfinite(h["loss"]) for h in hist), hist
    assert hist[-1]["loss"] < hist[0]["loss"], hist


def test_rl_loop_reward_improves():
    """The JAX test's arguments: the sampled reward's trend rises."""
    hist = rl_loop.main(TINY_ARGS + ["--iters", "10", "--prompt-len", "16", "--max-new", "12",
                                     "--samples", "8", "--lr", "1e-3"])
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert all(h["t_rollout"] > 0 and h["t_train"] > 0 and "peak_mem_gb" not in h for h in hist)
    first = np.mean([h["mean_reward"] for h in hist[:3]])
    last = np.mean([h["mean_reward"] for h in hist[-3:]])
    assert last > first, (first, last)


@pytest.mark.parametrize("clip_eps,ent_bonus", [(0.2, 0.0), (0.2, 0.01), (0.05, 0.1), (0.5, 0.01)])
def test_make_grpo_loss_matches_jax(clip_eps, ent_bonus):
    rng = np.random.default_rng(int(clip_eps * 100 + ent_bonus * 1000))
    S, L = 7, 29
    lengths = rng.integers(2, L + 1, size=S).astype(np.int32)
    lp = rng.normal(-3.0, 1.0, size=(S, L - 1)).astype(np.float32)
    lp[np.arange(L - 1)[None, :] >= lengths[:, None] - 1] = 200.0  # padding: exp would overflow
    ent = rng.uniform(0.0, 5.0, size=(S, L)).astype(np.float32)
    extras = {"behavior_lp": (lp + rng.normal(0.0, 0.3, size=lp.shape)).astype(np.float32),
              "adv": rng.normal(size=S).astype(np.float32),
              "prompt_len": rng.integers(1, lengths + 1).astype(np.int32)}
    extras["behavior_lp"][lp == 200.0] = -200.0

    jfn = jax_grpo.make_grpo_loss(clip_eps, ent_bonus)
    want, (want_glp, want_gent) = jax.value_and_grad(
        lambda a, b: jnp.sum(jax.vmap(jfn)(a, b, {k: jnp.asarray(v) for k, v in extras.items()},
                                           jnp.asarray(lengths))), argnums=(0, 1))(lp, ent)
    t_lp, t_ent = torch.tensor(lp, requires_grad=True), torch.tensor(ent, requires_grad=True)
    got = torch.func.vmap(grpo.make_grpo_loss(clip_eps, ent_bonus))(
        t_lp, t_ent, {k: torch.from_numpy(v) for k, v in extras.items()}, torch.from_numpy(lengths)).sum()
    got.backward()
    assert torch.isfinite(got) and torch.isfinite(t_lp.grad).all()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_lp.grad.numpy(), np.asarray(want_glp), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_ent.grad.numpy(), np.asarray(want_gent), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grpo_advantages_match_jax(seed):
    rng = np.random.default_rng(seed)
    rewards = rng.uniform(size=24)
    groups = rng.integers(0, 4, size=24)
    np.testing.assert_array_equal(grpo.grpo_advantages(rewards, groups),
                                  jax_grpo.grpo_advantages(rewards, groups))


def test_first_grpo_step_matches_jax():
    """The first step of the GRPO example, on the JAX example's batch and
    weights: behavior log-probs, then the custom step."""
    mc = MODEL_CONFIGS["qwen3-tiny"]
    kw = dict(seed=0, n_prompts=2, samples_per_prompt=6, prompt_len=(24, 40), completion_len=(12, 20),
              vocab_size=mc.vocab_size)
    seqs, attachs = synthetic_rollout_batch(**kw)
    jseqs, jattachs = jax_synthetic_rollout_batch(**kw)
    assert all(np.array_equal(a, b) for a, b in zip(seqs, jseqs)) and attachs == jattachs
    prompt_lens = np.array([a["prompt_len"] for a in attachs])
    rewards = np.array([float((s[pl:] % 2 == 0).mean()) for s, pl in zip(seqs, prompt_lens)])
    adv = jax_grpo.grpo_advantages(rewards, np.array([a["prompt_id"] for a in attachs]))

    jp = jq.init_params(jq.MODEL_CONFIGS["qwen3-tiny"], jax.random.key(0), dtype=jnp.float32)
    jeng = JaxTreeEngine(jq.MODEL_CONFIGS["qwen3-tiny"], JaxEngineConfig(
        block_q=32, block_kv=32, remat=False, attn_backend="reference", loss_chunk=32))
    jbatch = jeng.prepare(JaxTokenTrie(jseqs, jattachs))
    ids = [int(b) for b in jbatch.packed.seq_batch_ids]
    old = jeng.forward(jp, jbatch)
    beh = np.zeros((len(ids), int(jbatch.packed.seq_lens.max()) - 1), np.float32)
    for row, b in enumerate(ids):
        beh[row, : len(old[b])] = old[b]
    jextras = {"behavior_lp": jnp.asarray(beh), "adv": jnp.asarray(adv[ids].astype(np.float32)),
               "prompt_len": jnp.asarray(prompt_lens[ids].astype(np.int32))}
    want_loss, want_grads = jeng.loss_and_grad_custom(jp, jbatch, jax_grpo.make_grpo_loss(0.2, 0.01),
                                                      jextras)

    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    eng = TreeEngine(mc, EngineConfig(block_q=32, block_kv=32, remat=False, attn_backend="reference"),
                     device="cpu")
    batch = eng.prepare(TokenTrie(seqs, attachs))
    extras = grpo.grpo_extras(batch, eng.forward(tp, batch), adv, prompt_lens, "cpu")
    np.testing.assert_allclose(extras["behavior_lp"].numpy(), beh, rtol=1e-5, atol=1e-5)
    loss, grads = eng.loss_and_grad_custom(tp, batch, grpo.make_grpo_loss(0.2, 0.01), extras)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    rows = compare_grads(params_from_numpy(jax.tree.map(np.asarray, want_grads), device="cpu"), grads)
    assert rows[0][1] < 1e-4, rows[:3]


@pytest.mark.parametrize("lr,steps", [(1e-3, 1), (3e-2, 1), (1e-3, 3)])
def test_adamw_matches_optax(lr, steps):
    rng = np.random.default_rng(steps)
    tree = {"embed": rng.normal(size=(11, 6)), "layers": {"wq": rng.normal(size=(2, 6, 5))},
            "lm_head": rng.normal(size=(6, 11))}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
             for _ in range(steps)]
    opt = optax.adamw(lr)
    jparams, state = tree, opt.init(tree)
    for g in grads:
        updates, state = opt.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    params = params_from_numpy(tree, device="cpu")
    head = params["lm_head"]
    assert head.stride() == (1, 6)  # a [d, V] view of [V, d] storage
    topt = grpo.adamw(params, lr)
    for g in grads:
        grpo.apply_grads(topt, params, params_from_numpy(g, device="cpu"))
    assert params["lm_head"] is head and head.stride() == (1, 6)  # updated in place
    for (name, got), (_, want) in zip(named_leaves(params),
                                      named_leaves(params_from_numpy(jparams, device="cpu"))):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6, err_msg=name)
