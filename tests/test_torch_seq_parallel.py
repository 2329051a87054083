"""The port's sequence parallelism, Ulysses and ring, against the JAX package.

Eight ranks, one process each, over gloo on the CPU (``torch_dist_worker``,
spawned once for the file), fp32 tiny configs with the JAX package's
initial weights:

* Ulysses at (dp, sp, tp) (1, 2, 1), (1, 2, 2), (2, 2, 2) and the ring at
  (1, 2, 1), (1, 4, 2) (past Ulysses' kv-head limit) and (2, 2, 2), through
  the reference attention: loss and grads equal the JAX one-device engine
  summed over the data ranks' tries (JAX ``test_seq_parallel_step_*`` and
  ``test_ring_seq_parallel_step_*``); through the kernel backend (the plain
  K1/K2, K10, K11/K12 with offsets, K4-K7, K8/K9) under remat, the same;
* sequence parallelism with ZeRO-3 at (2, 2, 2) in both modes equals the
  same mode without it (JAX ``test_seq_parallel_with_fsdp`` and
  ``test_ring_seq_parallel_with_fsdp``);
* a custom per-sequence loss under Ulysses (2, 2, 1) and the ring (1, 2, 2)
  (parent-owned edge log-probs summed over "seq"): the JAX engine's custom
  step summed over the data ranks;
* a MoE tiny under Ulysses at (1, 2, 1) and (2, 2, 1), the load-balance
  statistics pooled over "seq": loss, lb_loss and grads equal JAX's
  sharded step on the fake mesh and the JAX one-device engine summed (JAX
  ``test_moe_ulysses_sp_matches_single_device``);
* ``cli.train --dp 2 --sp 2 --fsdp`` in the ranks' group: step 1 equals
  ``--dp 1``'s.

Bars: JAX's loss rtol 1e-4 and grads < 1e-3, tightened to what fp32 shows
here: loss rtol 1e-5 and grads < 1e-5 (the sums in another order; measured
at most 1.1e-7 and 1.5e-6); the MoE cases against JAX's sharded step at the
same bars; SP with ZeRO-3 against SP alone at 1e-5 (JAX's; measured 0 and
9.7e-8).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.engine import TreeEngine as JaxTreeEngine
from dynamictreeattn_tpu.parallel import make_mesh as jax_make_mesh
from dynamictreeattn_tpu.parallel import make_train_step as jax_make_train_step
from dynamictreeattn_tpu.parallel import shard_params as jax_shard_params
from dynamictreeattn_tpu.parallel import stack_batches as jax_stack_batches
from dynamictreeattn_tpu.tries import TokenTrie as JaxTokenTrie
from dynamictreeattn_tpu_torch.cli import train as cli_train

from torch_dist_refs import (
    ECFG, JAX_ECFG, cfg_dict, flat, grad_errs, init, jax_config, jax_engine_sum, numpy_tree, rank_tries, worst,
)
from torch_dist_worker import run_ranks

LOSS_RTOL, GRAD_REL = 1e-5, 1e-5
TINY = cfg_dict("qwen3-tiny")
TINY4 = cfg_dict("qwen3-tiny", num_attention_heads=8, num_key_value_heads=4)
MOE = cfg_dict("qwen3-moe-tiny")
MOE = dict(MOE, moe_capacity_factor=float(MOE["num_experts"]), router_aux_coef=0.01)
KERNEL = dict(ECFG, block_q=64, block_kv=64, attn_backend="kernel", loss_mode="kernel", remat=True)
ULYSSES = [(1, 2, 1), (1, 2, 2), (2, 2, 2)]
RING = [(1, 2, 1), (1, 4, 2), (2, 2, 2)]
KERNEL_CASES = {"ulysses": ((1, 2, 2), dict(remat_segments=2)), "ring": ((1, 4, 2), dict(remat_policy="attn"))}
CUSTOM = {"ulysses": (2, 2, 1), "ring": (1, 2, 2)}
MOE_MESHES = [(1, 2, 1), (2, 2, 1)]
SCALES = np.random.default_rng(5).uniform(0.5, 1.5, size=(2, 6)).astype(np.float32)
CLI = ["--device", "cpu", "--model", "qwen3-tiny", "--dtype", "fp32", "--attn-backend", "reference",
       "--block-q", "32", "--block-kv", "32", "--lr", "1e-3", "--steps", "1",
       "--data", "synthetic:n_prompts=2,samples=4,prompt_lo=8,prompt_hi=12,completion_lo=4,completion_hi=8"]

P4 = init(TINY4)
PT = init(TINY, seed=5)
PM = init(MOE)
SP_TRIES = {("ulysses", m): rank_tries(m[0], seed=13, max_len=24) for m in ULYSSES}
SP_TRIES.update({("ring", m): rank_tries(m[0], seed=19, max_len=24) for m in RING})
FSDP_TRIES = rank_tries(2, seed=17, max_len=24)
CUSTOM_TRIES = rank_tries(2, seed=41)
MOE_TRIES = {m: rank_tries(m[0], seed=23) for m in MOE_MESHES}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _step(dp, sp, tp, mode, cfg, params, tries, ecfg=ECFG, **kw):
    return "step", dict(dp=dp, sp=sp, tp=tp, sp_mode=mode, cfg=cfg, ecfg=ecfg, params=params, tries=tries, **kw)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp")
    cases = [(f"{mode}{''.join(map(str, m))}", *_step(*m, mode, TINY4, P4, tries))
             for (mode, m), tries in SP_TRIES.items()]
    for mode, (m, kw) in KERNEL_CASES.items():
        cases.append((f"kernel_{mode}", *_step(*m, mode, TINY4, P4, SP_TRIES[mode, m], ecfg=dict(KERNEL, **kw))))
    for mode in ("ulysses", "ring"):
        for name, lay in (("rep", {}), ("zero3", dict(fsdp=True, fsdp_min_size=1))):
            cases.append((f"{mode}_{name}", *_step(2, 2, 2, mode, TINY4, P4, FSDP_TRIES, **lay)))
    for mode, (dp, sp, tp) in CUSTOM.items():
        cases.append((f"custom_{mode}", "custom", dict(dp=dp, sp=sp, tp=tp, sp_mode=mode, cfg=TINY, ecfg=ECFG,
                                                        params=PT, tries=CUSTOM_TRIES[:dp], scales=SCALES)))
    cases += [(f"moe{''.join(map(str, m))}", *_step(*m, "ulysses", MOE, PM, MOE_TRIES[m])) for m in MOE_MESHES]
    cases.append(("cli", "cli", dict(argv=CLI + ["--dp", "2", "--sp", "2", "--fsdp", "--fsdp-min-size", "1",
                                                 "--dist-backend", "gloo", "--stats-out", str(root / "cli.jsonl")])))
    return run_ranks(8, cases, str(root / "work")), root


def _check(res, ref_loss, ref_grads, loss_rtol=LOSS_RTOL, grad_rel=GRAD_REL):
    losses = [float(r["loss"]) for r in res if r is not None]
    assert len(set(losses)) == 1, losses  # every rank holds the summed loss
    np.testing.assert_allclose(losses[0], ref_loss, rtol=loss_rtol)
    err, path = worst(grad_errs(ref_grads, res[0]))
    assert err < grad_rel, (path, err)


@pytest.mark.parametrize("mode,mesh", [("ulysses", m) for m in ULYSSES] + [("ring", m) for m in RING])
def test_sp_step_matches_summed_jax_engine(ranks, mode, mesh):
    """Loss and every grad at (dp, sp, tp) == the JAX engine summed over
    the data ranks' tries."""
    res = ranks[0][f"{mode}{''.join(map(str, mesh))}"]
    assert sum(r is not None for r in res) == int(np.prod(mesh))
    _check(res, *jax_engine_sum(TINY4, P4, SP_TRIES[mode, mesh]))


@pytest.mark.parametrize("mode", list(KERNEL_CASES))
def test_sp_kernel_backend_under_remat(ranks, mode):
    """The kernel backend's plain versions (the ring: K2, K11, K12 with
    offsets per pair; Ulysses: the full sequence on its kv-head shard)
    under remat (2 segments; the "attn" hand-off through the ring)."""
    m, _ = KERNEL_CASES[mode]
    _check(ranks[0][f"kernel_{mode}"], *jax_engine_sum(TINY4, P4, SP_TRIES[mode, m]))


@pytest.mark.parametrize("mode", ["ulysses", "ring"])
def test_sp_with_zero3_equals_sp_alone(ranks, mode):
    """(2, 2, 2) with ZeRO-3 == without (JAX's bars, 1e-5)."""
    got, rep = ranks[0][f"{mode}_zero3"], ranks[0][f"{mode}_rep"]
    _check(got, float(rep[0]["loss"]), {k[2:]: v for k, v in rep[0].items() if k.startswith("g/")})
    _check(got, *jax_engine_sum(TINY4, P4, FSDP_TRIES))


def _jax_scaled_loss(lp, ent, extras, length):
    m_lp = (jnp.arange(lp.shape[0]) < length - 1).astype(jnp.float32)
    m_en = (jnp.arange(ent.shape[0]) < length).astype(jnp.float32)
    return -extras["scale"] * jnp.sum(lp * m_lp) + 0.1 * jnp.sum(ent * m_en) / length


@pytest.mark.parametrize("mode", list(CUSTOM))
def test_sp_custom_loss_matches_jax(ranks, mode):
    """``torch_dist_worker.scaled_loss`` under sequence parallelism == the
    JAX engine's custom step summed over the data ranks."""
    dp = CUSTOM[mode][0]
    engine = JaxTreeEngine(jax_config(TINY), JAX_ECFG)
    jp = jax.tree.map(jnp.asarray, PT)
    total, grads = 0.0, None
    for r, (seqs, attachs) in enumerate(CUSTOM_TRIES[:dp]):
        batch = engine.prepare(JaxTokenTrie(seqs, attachs))
        extras = {"scale": jnp.asarray(SCALES[r][: len(batch.packed.seq_batch_ids)])}
        loss, g = engine.loss_and_grad_custom(jp, batch, _jax_scaled_loss, extras)
        total += float(loss)
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    _check(ranks[0][f"custom_{mode}"], total, flat(numpy_tree(grads)))


@pytest.mark.parametrize("mesh", MOE_MESHES)
def test_moe_ulysses_pools_load_balance(ranks, mesh):
    """MoE under Ulysses: loss, lb_loss and grads == JAX's sharded step on
    the fake (dp, sp, tp) mesh and the JAX engine summed (the pooled
    statistics make each trie's lb the one-device term)."""
    dp, sp, tp = mesh
    res = ranks[0][f"moe{''.join(map(str, mesh))}"]
    mc = dataclasses.replace(jax_config(MOE))
    jm = jax_make_mesh(dp=dp, tp=tp, sp=sp)
    jp = jax.tree.map(jnp.asarray, PM)
    batch = jax_stack_batches([JaxTokenTrie(s, a) for s, a in MOE_TRIES[mesh]], JAX_ECFG, sp=sp)
    loss, grads, aux = jax_make_train_step(mc, jm, JAX_ECFG)(jax_shard_params(jp, jm, mc), batch.arrays)
    _check(res, float(loss), flat(numpy_tree(grads)))
    np.testing.assert_allclose(float(res[0]["lb_loss"]), float(aux["lb_loss"]), rtol=LOSS_RTOL)
    engine = JaxTreeEngine(mc, JAX_ECFG)
    total, ref_grads, lb = 0.0, None, 0.0
    for seqs, attachs in MOE_TRIES[mesh]:
        l, g, a = engine.loss_and_grad(jp, engine.prepare(JaxTokenTrie(seqs, attachs)))
        total, lb = total + float(l), lb + float(a["lb_loss"])
        ref_grads = g if ref_grads is None else jax.tree.map(jnp.add, ref_grads, g)
    _check(res, total, flat(numpy_tree(ref_grads)))
    np.testing.assert_allclose(float(res[0]["lb_loss"]), lb, rtol=LOSS_RTOL)


def test_cli_train_sp_fsdp_matches_dp1(ranks, tmp_path):
    """cli.train --dp 2 --sp 2 --fsdp (four of the eight ranks; the rest
    return): rank 0 alone writes the record, and step 1's loss equals
    --dp 1's on the same synthetic batch."""
    res, root = ranks
    assert [bool(r["trained"]) for r in res["cli"]] == [True] * 4 + [False] * 4
    with open(root / "cli.jsonl") as f:
        mesh_recs = [json.loads(line) for line in f]
    assert len(mesh_recs) == 1
    cli_train.main(CLI + ["--stats-out", str(tmp_path / "one.jsonl")])
    with open(tmp_path / "one.jsonl") as f:
        one = json.loads(f.readline())
    np.testing.assert_allclose(mesh_recs[0]["loss"], one["loss"], rtol=LOSS_RTOL)
    assert mesh_recs[0]["n_tokens"] == one["n_tokens"]
