"""The port's expert parallelism against the JAX package.

Four ranks (one process each, over gloo on the CPU; ``torch_dist_worker``,
spawned once for the file) train qwen3-moe-tiny (8 experts, top-2) with the
JAX package's fp32 weights:

* ``ep=True`` at (dp, tp) = (2, 1) and (2, 2), capacity factor E (no pair
  drops on either side), against the JAX one-device engine summed over the
  ranks' tries (JAX ``tests/test_moe.py::test_moe_ep_a2a_matches_single_device``);
* ``ep=True`` at (2, 1) at the default factor 1.5, where pairs drop at the
  all-to-all's capacity, against the JAX sharded EP step: each layer's
  routing equal on every rank, pairs dropped, loss and grads equal — the
  kept (row, choice) pairs of the two sides are then the same, as one pair
  kept on one side only moves the loss by far more than the bar;
* experts sharded over "model" alone (tp = 2, no ep) at the default
  factor against the JAX one-device engine (the drops are the same: one
  stable order per expert);
* the Trainer with ``ep=True`` at dp = 2 (factor E) against the port's
  one-device Trainer on the same batches, without the load-balance term
  (a per-rank statistic: the sum over the ranks' bins is not the union's).

Bars: loss rtol 1e-6, per-parameter relative grad error < 1e-5 (at most
1.7e-7 and 1.6e-6 seen); Trainer losses rtol 1e-6, params after two AdamW
steps < 1e-4 (2.4e-5 seen, in e_gate: Adam's first updates are g/(|g| +
1e-8), so an expert grad element near 1e-8 turns fp32 noise into an update
difference of the order of the learning rate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamictreeattn_tpu.models.qwen3 as jq
from dynamictreeattn_tpu.parallel import make_mesh as jax_make_mesh
from dynamictreeattn_tpu.parallel import make_train_step as jax_make_train_step
from dynamictreeattn_tpu.parallel import shard_params as jax_shard_params
from dynamictreeattn_tpu.parallel import stack_batches as jax_stack_batches
from dynamictreeattn_tpu.tries import TokenTrie as JaxTokenTrie
from dynamictreeattn_tpu_torch.engine import EngineConfig
from dynamictreeattn_tpu_torch.models import Qwen3Config
from dynamictreeattn_tpu_torch.models import params_from_numpy
from dynamictreeattn_tpu_torch.training import TrainConfig, Trainer

from torch_dist_refs import ECFG, JAX_ECFG, cfg_dict, flat, grad_errs, init, jax_config, jax_engine_sum, rank_tries, worst
from torch_dist_worker import run_ranks

LOSS_RTOL, GRAD_REL = 1e-6, 1e-5
TRAINER_PARAM_REL = 1e-4
MOE = cfg_dict("qwen3-moe-tiny")
MOE_E = cfg_dict("qwen3-moe-tiny", moe_capacity_factor=float(MOE["num_experts"]))
MOE_E_NO_LB = dict(MOE_E, router_aux_coef=0.0)
PARAMS = init(MOE)
TRIES = {2: rank_tries(2, seed=11), 1: rank_tries(1, seed=7)}
TC = dict(learning_rate=1e-3, param_dtype="fp32", lb_method="LB_by_n_tokens")
TRAIN_BATCHES = rank_tries(2, seed=5, n_seqs=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [(f"ep{dp}{tp}", "step", dict(dp=dp, tp=tp, cfg=MOE_E, ecfg=ECFG, params=PARAMS, tries=TRIES[2],
                                          ep=True)) for dp, tp in ((2, 1), (2, 2))]
    cases.append(("ep_drops", "step", dict(dp=2, tp=1, cfg=MOE, ecfg=ECFG, params=PARAMS, tries=TRIES[2], ep=True,
                                           record_routes=True)))
    cases.append(("model_experts", "step", dict(dp=1, tp=2, cfg=MOE, ecfg=ECFG, params=PARAMS, tries=TRIES[1])))
    cases.append(("trainer", "trainer", dict(dp=2, tp=1, cfg=MOE_E_NO_LB, ecfg=ECFG, params=PARAMS, ep=True, tc=TC,
                                             batches=TRAIN_BATCHES)))
    return run_ranks(4, cases, str(tmp_path_factory.mktemp("ranks")))


def _check(res, ref_loss, ref_grads):
    losses = [float(r["loss"]) for r in res if r is not None]
    assert len(set(losses)) == 1, losses
    np.testing.assert_allclose(losses[0], ref_loss, rtol=LOSS_RTOL)
    err, path = worst(grad_errs(ref_grads, res[0]))
    assert err < GRAD_REL, (path, err)


@pytest.mark.parametrize("dp,tp", [(2, 1), (2, 2)])
def test_ep_step_at_factor_e_matches_jax_engine_sum(ranks, dp, tp):
    res = ranks[f"ep{dp}{tp}"]
    # each rank holds E / (dp * tp) experts
    assert all(int(r["expert_rows"]) == MOE["num_experts"] // (dp * tp) for r in res if r is not None)
    _check(res, *jax_engine_sum(MOE_E, PARAMS, TRIES[2]))


def test_ep_step_with_drops_matches_jax_ep_step(ranks, monkeypatch):
    """Default factor: the JAX sharded EP step's routing, recorded per rank
    and layer, equals the port's; pairs drop; loss and grads agree."""
    routes = {0: [], 1: []}
    route = jq.moe_route

    def recording(h, router, c, valid=None, stat_axes=()):
        w, idx, lb = route(h, router, c, valid, stat_axes)
        jax.debug.callback(lambda r, i: routes[int(r)].append(np.asarray(i)), jax.lax.axis_index("data"), idx)
        return w, idx, lb

    monkeypatch.setattr(jq, "moe_route", recording)
    mc = jax_config(MOE)
    mesh = jax_make_mesh(dp=2, tp=1)
    batch = jax_stack_batches([JaxTokenTrie(s, a) for s, a in TRIES[2]], JAX_ECFG)
    jp = jax_shard_params(jax.tree.map(jnp.asarray, PARAMS), mesh, mc, ep=2)
    loss, grads, _ = jax_make_train_step(mc, mesh, JAX_ECFG, ep=True)(jp, batch.arrays)
    jax.effects_barrier()
    res = ranks["ep_drops"]
    assert int(res[0]["n_pad"]) == batch.arrays["tokens"].shape[1]
    for r in (0, 1):
        np.testing.assert_array_equal(res[r]["routes"], np.stack(routes[r]))
    # per layer: the dispatch's drops past C, then the received experts' past their capacity
    assert sum(int(r["drops"].sum()) for r in res[:2]) > 0, [r["drops"] for r in res[:2]]
    _check(res, float(loss), flat(jax.tree.map(np.asarray, jax.device_get(grads))))


def test_experts_over_model_match_jax_engine(ranks):
    """tp = 2 without ep: each rank dispatches its experts' pairs at the
    one-device capacity, drops included."""
    res = ranks["model_experts"]
    assert int(res[0]["expert_rows"]) == MOE["num_experts"] // 2
    _check(res, *jax_engine_sum(MOE, PARAMS, TRIES[1]))


def test_trainer_with_ep_matches_one_device_trainer(ranks):
    """Trainer(ep=True) at dp = 2: the records and params after 2 steps
    equal the port's one-device Trainer on the same batches (the global
    clip norm sums the expert shards over the ranks)."""
    one = Trainer(Qwen3Config(**MOE_E_NO_LB), EngineConfig(**ECFG), TrainConfig(**TC), device="cpu")
    one.set_params(params_from_numpy(PARAMS, device="cpu"))
    recs = [one.train_step(s, a) for s, a in TRAIN_BATCHES]
    res = ranks["trainer"]
    for r in res[:2]:
        np.testing.assert_allclose(r["loss"], [x["loss"] for x in recs], rtol=LOSS_RTOL)
    err, path = worst(grad_errs(flat(one.params), res[0], prefix="p/"))
    assert err < TRAINER_PARAM_REL, (path, err)
