"""The port's ZeRO-3 (FSDP) layout and steps against the replicated layout and the JAX package.

* ``fsdp_dims`` equals JAX's for qwen3-tiny, a tiny with 8 q / 4 kv heads,
  a MoE tiny under expert parallelism and Qwen3-0.6B at dp 2 and 4, at the
  default floor and at one element.
* Eight ranks, one process each, over gloo on the CPU (``torch_dist_worker``,
  spawned once for the file), fp32 qwen3-tiny with the JAX package's
  initial weights, every leaf of at least one element a layer sharded: the
  ZeRO-3 step at (dp, tp) (2, 2), (4, 2), (4, 1) with remat on (the
  per-layer gather inside the checkpointed layer) equals the replicated step
  on the same mesh and the JAX engine summed over the ranks' tries (JAX
  ``test_fsdp_step_matches_replicated``: loss rtol 1e-5, grads < 1e-5); so
  does the kernel backend's step (the plain versions) under the "attn_dots"
  hand-off; ``make_forward_step(fsdp=True)`` equals the replicated forward
  (1e-5, JAX's ``test_sharded_forward_with_fsdp_params``) and the JAX
  engine's forward (2e-5); two optimizer steps with the clip binding equal
  the replicated steps (the clip's norm summed over the shards: < 1e-5);
  the Trainer at (4, 2) keeps each rank a slice of the params and moments
  the shape of its params (JAX ``test_fsdp_optimizer_state_is_sharded``),
  its loss descends and its params equal the replicated Trainer's; a
  checkpoint written on one device restores under ZeRO-3 bit-equal, and one
  written under ZeRO-3 (gathered to one file) restores on one device
  bit-equal.

Measured (fp32): the ZeRO-3 loss equal to the replicated one, grads within
8.6e-8; against JAX loss 8.5e-8 and grads 1.3e-6; the forward equal; the
optimizer steps' params within 1.1e-8.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.models import MODEL_CONFIGS as JAX_CONFIGS
from dynamictreeattn_tpu.parallel.train import fsdp_dims as jax_fsdp_dims
from dynamictreeattn_tpu_torch.engine import EngineConfig
from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, Qwen3Config, params_from_numpy
from dynamictreeattn_tpu_torch.parallel import fsdp_dims
from dynamictreeattn_tpu_torch.training import TrainConfig, Trainer

from torch_dist_refs import ECFG, cfg_dict, flat, grad_errs, init, jax_config, jax_engine_sum, rank_tries, worst
from torch_dist_worker import run_ranks

LOSS_RTOL, GRAD_REL = 1e-5, 1e-5
TINY = cfg_dict("qwen3-tiny")
REMAT = dict(ECFG, remat=True)
KERNEL = dict(ECFG, attn_backend="kernel", loss_mode="kernel", remat=True, remat_policy="attn_dots")
MESHES = [(2, 2), (4, 2), (4, 1)]
ZERO3 = dict(fsdp=True, fsdp_min_size=1)
TC = dict(learning_rate=1e-3, param_dtype="fp32")
PARAMS = init(TINY)
TRIES = {m: rank_tries(m[0], seed=7) for m in MESHES}
FWD_TRIES = rank_tries(2, seed=37)
BATCHES = rank_tries(2, seed=8, n_seqs=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(name: str, **changes):
    return dataclasses.replace(JAX_CONFIGS[name], **changes)


TINY4 = dict(num_attention_heads=8, num_key_value_heads=4)
DIMS_CASES = [("qwen3-tiny", {}, 2, 1), ("qwen3-tiny", TINY4, 4, 1), ("qwen3-moe-tiny", {}, 2, 2),
              ("qwen3-0.6b", {}, 2, 1), ("qwen3-0.6b", {}, 4, 1)]


@pytest.mark.parametrize("name,changes,dp,ep", DIMS_CASES)
def test_fsdp_dims_equal_jax(name, changes, dp, ep):
    """The port's ZeRO-3 dims == JAX's, leaf for leaf, at the default floor
    and at one element a layer."""
    jc = _jax_cfg(name, **changes)
    pc = dataclasses.replace(MODEL_CONFIGS[name], **changes)
    for floor in (1 << 16, 1):
        want = jax_fsdp_dims(jc, dp, floor, ep)
        assert fsdp_dims(pc, dp, floor, ep) == want, (name, floor)
    assert any(d >= 0 for d in fsdp_dims(pc, dp, 1, ep)["layers"].values())
    assert all(d < 0 for d in fsdp_dims(pc, 1, 1, ep)["layers"].values())  # dp = 1: nothing to shard


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("zero3")
    one = Trainer(Qwen3Config(**TINY), EngineConfig(**ECFG), TrainConfig(ckpt_dir=str(root / "one"), **TC),
                  device="cpu")
    one.set_params(params_from_numpy(PARAMS, device="cpu"))
    one.train_step(*BATCHES[0])
    one.save()
    cases = []
    for dp, tp in MESHES:
        for name, lay in (("rep", {}), ("zero3", ZERO3)):
            cases.append((f"{name}{dp}{tp}", "step", dict(dp=dp, tp=tp, cfg=TINY, ecfg=REMAT, params=PARAMS,
                                                          tries=TRIES[dp, tp], **lay)))
    cases.append(("kernel", "step", dict(dp=2, tp=2, cfg=TINY, ecfg=KERNEL, params=PARAMS, tries=TRIES[2, 2],
                                         **ZERO3)))
    cases += [(f"forward_{name}", "forward", dict(dp=2, tp=2, cfg=TINY, ecfg=ECFG, params=PARAMS, tries=FWD_TRIES,
                                                  **lay)) for name, lay in (("rep", {}), ("zero3", ZERO3))]
    cases += [(f"opt_{name}", "opt", dict(dp=2, tp=2, cfg=TINY, ecfg=ECFG, params=PARAMS, tries=TRIES[2, 2],
                                          clip=0.05, steps=2, lr=1e-2, fsdp=fsdp))
              for name, fsdp in (("rep", False), ("zero3", True))]
    cases += [(f"trainer_{name}", "trainer", dict(dp=4, tp=2, cfg=TINY, ecfg=ECFG, params=PARAMS,
                                                  batches=rank_tries(2, seed=9, n_seqs=12),
                                                  tc=dict(TC, lb_method="LB_by_n_tokens", **lay)))
              for name, lay in (("rep", {}), ("zero3", ZERO3))]
    cases.append(("ckpt", "ckpt", dict(dp=2, tp=2, cfg=TINY, ecfg=ECFG, tc=dict(TC, **ZERO3),
                                       restore_dir=str(root / "one"), save_dir=str(root / "mesh"),
                                       batch=BATCHES[1])))
    return run_ranks(8, cases, str(root / "work")), one, root


def _same_step(got, want, loss_rtol=LOSS_RTOL, grad_rel=GRAD_REL):
    np.testing.assert_allclose(float(got[0]["loss"]), float(want[0]["loss"]), rtol=loss_rtol)
    err, path = worst(grad_errs({k[2:]: v for k, v in want[0].items() if k.startswith("g/")}, got[0]))
    assert err < grad_rel, (path, err)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_zero3_step_equals_replicated_and_jax(ranks, dp, tp):
    """Loss and every grad (gathered) of the ZeRO-3 step == the replicated
    step on the mesh and the JAX engine summed over the ranks' tries."""
    res = ranks[0]
    got = res[f"zero3{dp}{tp}"]
    assert sum(r is not None for r in got) == dp * tp
    assert len({float(r["loss"]) for r in got if r is not None}) == 1
    _same_step(got, res[f"rep{dp}{tp}"])
    ref_loss, ref_grads = jax_engine_sum(TINY, PARAMS, TRIES[dp, tp])
    np.testing.assert_allclose(float(got[0]["loss"]), ref_loss, rtol=LOSS_RTOL)
    err, path = worst(grad_errs(ref_grads, got[0]))
    assert err < GRAD_REL, (path, err)


def test_zero3_kernel_backend_under_attn_dots(ranks):
    """The kernel backend (the plain K1/K2, K3 replaying its slot
    schedule, K4-K7, K8/K9 on CPU tensors) under the "attn_dots" hand-off at (2, 2), ZeRO-3: the JAX
    reference engine's sum."""
    ref_loss, ref_grads = jax_engine_sum(TINY, PARAMS, TRIES[2, 2])
    got = ranks[0]["kernel"]
    np.testing.assert_allclose(float(got[0]["loss"]), ref_loss, rtol=LOSS_RTOL)
    err, path = worst(grad_errs(ref_grads, got[0]))
    assert err < GRAD_REL, (path, err)


def test_zero3_forward_equals_replicated_and_jax(ranks):
    """make_forward_step(fsdp=True) on ZeRO-3 params == the replicated
    forward (1e-5) and the JAX engine's per-sequence log-probs (2e-5)."""
    import jax
    import jax.numpy as jnp

    from dynamictreeattn_tpu.engine import TreeEngine as JaxTreeEngine
    from dynamictreeattn_tpu.tries import TokenTrie as JaxTokenTrie
    from torch_dist_refs import JAX_ECFG

    got, rep = ranks[0]["forward_zero3"][0], ranks[0]["forward_rep"][0]
    keys = [k for k in rep if k.startswith("lp/")]
    assert keys and all(bool(r["finite"]) for r in ranks[0]["forward_zero3"] if r is not None)
    for k in keys:
        np.testing.assert_allclose(got[k], rep[k], rtol=1e-5, atol=1e-6)
    engine = JaxTreeEngine(jax_config(TINY), JAX_ECFG)
    jp = jax.tree.map(jnp.asarray, PARAMS)
    for r, (seqs, attachs) in enumerate(FWD_TRIES):
        for k, v in engine.forward(jp, engine.prepare(JaxTokenTrie(seqs, attachs))).items():
            np.testing.assert_allclose(got[f"lp/{r}/{k}"], v, rtol=2e-5, atol=2e-5)


def test_zero3_optimizer_steps_equal_replicated(ranks):
    """Two steps with the clip binding: the losses and the params gathered
    after == the replicated layout's (the clip norm's squares of a ZeRO-3
    leaf summed over "data" once)."""
    got, rep = ranks[0]["opt_zero3"][0], ranks[0]["opt_rep"][0]
    np.testing.assert_allclose(got["losses"], rep["losses"], rtol=LOSS_RTOL)
    assert got["losses"][1] < got["losses"][0]
    err, path = worst(grad_errs({k[2:]: v for k, v in rep.items() if k.startswith("p/")}, got, prefix="p/"))
    assert err < GRAD_REL, (path, err)


def test_zero3_trainer_shards_params_and_moments(ranks):
    """The Trainer at (4, 2) under ZeRO-3: each rank holds about 1/(dp·tp)
    of the params (the replicated layout 1/tp of the sharded leaves), the
    AdamW moments the shapes of its shards; the records and the params
    after equal the replicated Trainer's."""
    got, rep = ranks[0]["trainer_zero3"], ranks[0]["trainer_rep"]
    full = sum(v.size for v in flat(PARAMS).values())
    for r in got:
        assert bool(r["moment_shapes_match"]) and int(r["local_numel"]) < full / 6
    assert all(int(r["local_numel"]) > full / 3 for r in rep)
    np.testing.assert_allclose(got[0]["loss"], rep[0]["loss"], rtol=LOSS_RTOL)
    assert got[0]["loss"][1] < got[0]["loss"][0] * 1.5  # finite, the step ran
    err, path = worst(grad_errs({k[2:]: v for k, v in rep[0].items() if k.startswith("p/")}, got[0], prefix="p/"))
    assert err < GRAD_REL, (path, err)


def test_zero3_checkpoint_moves_between_layouts(ranks):
    """One device -> ZeRO-3 at (2, 2): the restored params and moments,
    gathered, equal the saved ones bitwise; ZeRO-3 -> one device: the file
    (gathered by rank 0) restores bitwise, and the step after equals the
    one-device step."""
    res, one, root = ranks
    r0 = res["ckpt"][0]
    assert int(r0["step_idx"]) == 1
    for path, v in flat(one.params).items():
        np.testing.assert_array_equal(r0["restored/" + path], v, err_msg=path)
    for path, v in zip(flat(one.params), one.opt_state["mu"]):
        np.testing.assert_array_equal(r0["mu/" + path], v.numpy(), err_msg=path)
    rec = one.train_step(*BATCHES[1])
    np.testing.assert_allclose(float(r0["next_loss"]), rec["loss"], rtol=LOSS_RTOL)
    back = Trainer(Qwen3Config(**TINY), EngineConfig(**ECFG), TrainConfig(ckpt_dir=str(root / "mesh"), **TC),
                   device="cpu")
    back.restore()
    assert back.step_idx == 2
    for path, v in flat(back.params).items():
        np.testing.assert_array_equal(v, r0["after/" + path], err_msg=path)
