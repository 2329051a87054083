"""The port's pipeline parallelism, GPipe and 1F1B, against the JAX package.

Eight ranks, one process each, over gloo on the CPU (``torch_dist_worker``,
spawned once for the file), fp32 qwen3-tiny (L = max(2, pp) layers) with the
JAX package's initial weights, the reference attention and the
vocab-chunked loss:

* GPipe at (dp, pp, tp, M) (1, 2, 1, 3), (1, 2, 2, 2), (2, 2, 2, 2) and 1F1B
  at (1, 2, 1, 3), (1, 2, 2, 2), (1, 4, 1, 6) (JAX's own cases,
  ``tests/test_parallel.py``): loss, aux and grads (the stages and shards
  gathered whole) equal JAX's ``make_pp_train_step`` on the fake CPU mesh
  with the same numpy inputs, and the port's one-device engine summed over
  the microbatches;
* 1F1B at (1, 2, 2, 2) on the kernel backend (the plain K1/K2, K10, K8/K9
  under remat with the "attn" policy): the one-device kernel-backend engine
  summed;
* ``pp_param_specs`` leaf for leaf against JAX's PartitionSpecs, and
  ``shard_params_pp``'s slice at every (pipe, model) coordinate against the
  JAX array's shard on that device; ``distributed.put_global`` with those
  specs against ``shard_params`` and ``shard_params_pp``;
  ``stack_microbatches``' arrays against JAX's;
* every refusal JAX makes: sp with pp, fsdp / ep / a custom loss with pp, a
  layer count pp does not divide, an unknown schedule, ``forward_logprobs``
  at pp > 1.

Bars: loss rtol 1e-5, grads max rel 1e-4 (tighter than JAX's own, 1e-4
and 1e-3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.parallel import make_mesh as jax_make_mesh
from dynamictreeattn_tpu.parallel import make_pp_train_step as jax_make_pp_train_step
from dynamictreeattn_tpu.parallel import pp_param_specs as jax_pp_param_specs
from dynamictreeattn_tpu.parallel import shard_params_pp as jax_shard_params_pp
from dynamictreeattn_tpu.parallel import stack_microbatches as jax_stack_microbatches
from dynamictreeattn_tpu.tries import TokenTrie as JaxTokenTrie
from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine
from dynamictreeattn_tpu_torch.models import Qwen3Config, params_from_numpy
from dynamictreeattn_tpu_torch.parallel import (
    Mesh, make_mesh, make_pp_train_step, pp_param_specs, shard_params, shard_params_pp, stack_microbatches,
)
from dynamictreeattn_tpu_torch.parallel.distributed import global_placer, put_global
from dynamictreeattn_tpu_torch.tries import TokenTrie, build_block_meta
from dynamictreeattn_tpu_torch.training import TrainConfig, Trainer

from torch_dist_refs import ECFG, JAX_ECFG, cfg_dict, flat, grad_errs, init, jax_config, numpy_tree, rank_tries, worst
from torch_dist_worker import run_ranks

LOSS_RTOL, GRAD_REL = 1e-5, 1e-4
CASES = [("gpipe", (1, 2, 1, 3)), ("gpipe", (1, 2, 2, 2)), ("gpipe", (2, 2, 2, 2)),
         ("1f1b", (1, 2, 1, 3)), ("1f1b", (1, 2, 2, 2)), ("1f1b", (1, 4, 1, 6))]
KERNEL = dict(ECFG, block_q=64, block_kv=64, attn_backend="kernel", loss_mode="kernel", remat=True,
              remat_policy="attn")
KERNEL_CASE = ("1f1b", (1, 2, 2, 2))


def _cfg(pp: int) -> dict:
    return cfg_dict("qwen3-tiny", num_hidden_layers=max(2, pp))


def _rows(dp: int, M: int, seed: int) -> list:
    """[dp][M] (seqs, attachs) of 5 sequences up to 20 tokens."""
    tries = rank_tries(dp * M, seed=seed, n_seqs=5, max_len=20)
    return [tries[r * M:(r + 1) * M] for r in range(dp)]


PARAMS = {L: init(_cfg(L)) for L in (2, 4)}
ROWS = {case: _rows(case[1][0], case[1][3], seed=23 + i) for i, case in enumerate(CASES)}


def _name(schedule, mesh) -> str:
    return f"{schedule}_{'_'.join(map(str, mesh))}"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp")
    cases = []
    for schedule, (dp, pp, tp, M) in CASES:
        cases.append((_name(schedule, (dp, pp, tp, M)), "pp",
                      dict(dp=dp, pp=pp, tp=tp, cfg=_cfg(pp), ecfg=ECFG, params=PARAMS[max(2, pp)],
                           rows=ROWS[schedule, (dp, pp, tp, M)], schedule=schedule)))
    schedule, (dp, pp, tp, M) = KERNEL_CASE
    cases.append(("kernel", "pp", dict(dp=dp, pp=pp, tp=tp, cfg=_cfg(pp), ecfg=KERNEL, params=PARAMS[2],
                                       rows=ROWS[KERNEL_CASE], schedule=schedule)))
    return run_ranks(8, cases, str(root / "work"))


@functools.lru_cache(maxsize=None)
def jax_pp(schedule: str, mesh: tuple):
    """(loss, aux, grads as {path: numpy}) of JAX's pipelined step."""
    dp, pp, tp, M = mesh
    cfg = jax_config(_cfg(pp))
    rows = [[JaxTokenTrie(s, a) for s, a in row] for row in ROWS[schedule, mesh]]
    jmesh = jax_make_mesh(dp=dp, tp=tp, pp=pp)
    step = jax_make_pp_train_step(cfg, jmesh, JAX_ECFG, schedule=schedule)
    params = jax.tree.map(jnp.asarray, PARAMS[max(2, pp)])
    loss, grads, aux = step(jax_shard_params_pp(params, jmesh, cfg), jax_stack_microbatches(rows, JAX_ECFG).arrays)
    return float(loss), {k: float(v) for k, v in aux.items()}, flat(numpy_tree(grads))


def one_device_sum(cfg: dict, params: dict, rows: list, ecfg: dict):
    """(loss, grads as {path: numpy}) of the port's one-device engine summed
    over every microbatch."""
    engine = TreeEngine(Qwen3Config(**cfg), EngineConfig(**ecfg), device="cpu")
    p = params_from_numpy(params, device="cpu")
    total, grads = 0.0, None
    for row in rows:
        for seqs, attachs in row:
            loss, g, _ = engine.loss_and_grad(p, engine.prepare(TokenTrie(seqs, attachs)))
            total += float(loss)
            g = {k: np.asarray(v, np.float64) for k, v in flat(g).items()}
            grads = g if grads is None else {k: grads[k] + g[k] for k in g}
    return total, grads


def _check(res, ref_loss, ref_grads):
    losses = [float(r["loss"]) for r in res if r is not None]
    assert len(set(losses)) == 1, losses  # every rank holds the summed loss
    np.testing.assert_allclose(losses[0], ref_loss, rtol=LOSS_RTOL)
    err, path = worst(grad_errs(ref_grads, res[0]))
    assert err < GRAD_REL, (path, err)


@pytest.mark.parametrize("schedule,mesh", CASES, ids=[_name(*c) for c in CASES])
def test_schedule_step_equals_jax_and_one_device(ranks, schedule, mesh):
    """Loss, aux and every grad equal JAX's make_pp_train_step on the fake
    mesh and the port's one-device engine summed over the microbatches;
    each stage holds its L/pp layers."""
    dp, pp, tp, M = mesh
    res = ranks[_name(schedule, mesh)]
    loss, aux, grads = jax_pp(schedule, mesh)
    _check(res, loss, grads)
    for key in ("sum_logprob", "sum_entropy"):
        np.testing.assert_allclose(float(res[0][key]), aux[key], rtol=LOSS_RTOL, err_msg=key)
    live = [r for r in res if r is not None]
    assert len(live) == dp * pp * tp
    assert sorted({int(r["stage"]) for r in live}) == list(range(pp))
    assert {int(r["n_layers"]) for r in live} == {max(2, pp) // pp}
    _check(res, *one_device_sum(_cfg(pp), PARAMS[max(2, pp)], ROWS[schedule, mesh], ECFG))


def test_kernel_backend_step_equals_one_device(ranks):
    """1F1B at pp = 2 x tp = 2 through the kernels' plain versions under
    remat ("attn" policy), the backward "fused": the one-device
    kernel-backend engine (its "cached" backward) summed."""
    _check(ranks["kernel"], *one_device_sum(_cfg(2), PARAMS[2], ROWS[KERNEL_CASE], KERNEL))


def _jax_spec(spec) -> tuple:
    """A JAX PartitionSpec as the port's ((dim, axes), ...)."""
    out = []
    for dim, part in enumerate(tuple(spec)):
        if part is not None:
            out.append((dim, part if isinstance(part, tuple) else (part,)))
    return tuple(out)


def _leaves(tree, prefix: str = "") -> dict:
    """{path: leaf} of a nested dict, the leaves as they are (JAX's sharded arrays)."""
    out = {}
    for key, val in tree.items():
        out.update(_leaves(val, prefix + key + "/") if isinstance(val, dict) else {prefix + key: val})
    return out


def _fake_mesh(shape: dict, coords: dict) -> Mesh:
    """A mesh without process groups: enough to cut params into one rank's slices."""
    full = {"data": 1, "seq": 1, "pipe": 1, "model": 1}
    return Mesh({**full, **shape}, {**{a: 0 for a in full}, **coords}, {}, "gloo", torch.device("cpu"), None)


@pytest.mark.parametrize("pp,tp", [(2, 1), (2, 2), (4, 1)])
def test_layouts_equal_jax(pp, tp):
    """pp_param_specs equals JAX's leaf for leaf; shard_params_pp at every
    (pipe, model) coordinate equals the JAX array's shard on that device."""
    cfg = _cfg(pp)
    specs = pp_param_specs(Qwen3Config(**cfg), pp)
    jspecs = flat(jax_pp_param_specs(jax_config(cfg), pp))
    for path, spec in jspecs.items():
        assert specs.get(path.split("/")[-1], ()) == _jax_spec(spec), path
    jmesh = jax_make_mesh(dp=1, tp=tp, pp=pp)
    sharded = _leaves(jax_shard_params_pp(jax.tree.map(jnp.asarray, PARAMS[max(2, pp)]), jmesh, jax_config(cfg)))
    full = params_from_numpy(PARAMS[max(2, pp)], device="cpu")
    def where(shard):  # the (pipe, model) coordinates of a shard's device
        at = dict(zip(jmesh.axis_names, np.argwhere(jmesh.devices == shard.device)[0]))
        return at.get("pipe", 0), at.get("model", 0)

    for p in range(pp):
        for m in range(tp):
            mine = flat(shard_params_pp(full, _fake_mesh({"pipe": pp, "model": tp}, {"pipe": p, "model": m}),
                                        Qwen3Config(**cfg)))
            for path, arr in sharded.items():
                shards = [sh for sh in arr.addressable_shards if where(sh) == (p, m)]
                assert shards, path
                np.testing.assert_array_equal(np.asarray(mine[path]), np.asarray(shards[0].data), err_msg=path)


@pytest.mark.parametrize("pp,tp", [(2, 1), (2, 2), (4, 1)])
def test_put_global_cuts_as_shard_params(pp, tp):
    """put_global (JAX's multi-host placer, also named global_placer) with
    pp_param_specs gives every (pipe, model) coordinate the slices that
    shard_params and shard_params_pp give it on the same mesh."""
    cfg = Qwen3Config(**_cfg(pp))
    full = params_from_numpy(PARAMS[max(2, pp)], device="cpu")
    assert global_placer is put_global
    for p in range(pp):
        for m in range(tp):
            mesh = _fake_mesh({"pipe": pp, "model": tp}, {"pipe": p, "model": m})
            placed = flat(put_global(full, mesh, pp_param_specs(cfg, pp)))
            for other in (shard_params(full, mesh, cfg), shard_params_pp(full, mesh, cfg)):
                other = flat(other)
                assert placed.keys() == other.keys()
                for path, t in placed.items():
                    np.testing.assert_array_equal(t, other[path], err_msg=path)


def test_stack_microbatches_equals_jax():
    """Every microbatch padded to one common bucket: the packed arrays equal
    JAX's [dp, M, ...] arrays, the block metadata within each row's counts."""
    rows = _rows(2, 3, seed=61)
    ec = EngineConfig(**ECFG)
    got = stack_microbatches([[TokenTrie(s, a) for s, a in row] for row in rows], ec)
    want = jax_stack_microbatches([[JaxTokenTrie(s, a) for s, a in row] for row in rows], JAX_ECFG).arrays
    assert (got.dp, got.M) == (2, 3)
    assert len({p.n_padded for p in got.packeds}) == 1
    for r in range(2):
        for j, p in enumerate(got.row(r)):
            for f in ("tokens", "depth", "parent", "last_desc", "w_logprob", "w_entropy", "valid"):
                np.testing.assert_array_equal(getattr(p, f), np.asarray(want[f][r, j]), err_msg=f)
            meta = build_block_meta(p.last_desc, ec.block_q, ec.block_kv)
            for ids, counts, types in (("kv_ids", "kv_counts", "kv_types"), ("q_ids", "q_counts", "q_types")):
                c = getattr(meta, counts)
                np.testing.assert_array_equal(c, np.asarray(want[counts][r, j]))
                for i, k in enumerate(c):
                    for f in (ids, types):
                        np.testing.assert_array_equal(getattr(meta, f)[i, :k], np.asarray(want[f][r, j])[i, :k])


def _pp_trainer(**tc):
    cfg = Qwen3Config(**_cfg(2))
    mesh = _fake_mesh({"pipe": 2}, {"pipe": 0})
    return Trainer(cfg, EngineConfig(**ECFG), TrainConfig(pp=2, param_dtype="fp32", **tc), mesh=mesh, device="cpu")


def _custom_loss(lp, ent, extras, length):
    return -lp.sum()


@pytest.mark.parametrize("what", ["sp", "fsdp", "ep", "custom_loss", "layers", "schedule", "forward_logprobs"])
def test_refusals(what):
    """What JAX refuses with pipeline stages raises here too."""
    cfg = Qwen3Config(**_cfg(2))
    with pytest.raises(ValueError):
        if what == "sp":
            make_mesh(dp=1, tp=1, sp=2, pp=2, backend="gloo", device="cpu")
        elif what == "fsdp":
            _pp_trainer(fsdp=True)
        elif what == "ep":
            _pp_trainer(ep=True)
        elif what == "custom_loss":
            Trainer(cfg, EngineConfig(**ECFG), TrainConfig(pp=2), mesh=None, custom_loss=_custom_loss, device="cpu")
        elif what == "layers":
            pp_param_specs(Qwen3Config(**cfg_dict("qwen3-tiny", num_hidden_layers=3)), 2)
        elif what == "schedule":
            make_pp_train_step(cfg, _fake_mesh({"pipe": 2}, {}), EngineConfig(**ECFG), schedule="interleaved")
        else:
            tr = _pp_trainer()
            tr.set_params(params_from_numpy(PARAMS[2], device="cpu"))
            tr.forward_logprobs(*rank_tries(1, seed=3)[0])
