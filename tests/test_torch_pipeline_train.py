"""The port's pipeline with MoE layers, the optimizer, the Trainer and
``cli.train --pp``, against the JAX package.

Four ranks, one process each, over gloo on the CPU (``torch_dist_worker``,
spawned once for the file), fp32 tiny configs with the JAX package's initial
weights, the reference attention and the vocab-chunked loss:

* ``qwen3-moe-tiny`` (capacity factor E: no drops, router_aux_coef 0.01) at
  pp = 2 x tp = 2, GPipe and 1F1B: loss, the per-stage ``lb_loss`` summed
  over "pipe", and every grad equal JAX's ``make_pp_train_step`` (JAX
  ``test_moe_pipeline_matches_single_device``);
* two AdamW steps (clip 1.0 over the global norm, which counts each stage's
  layers once) at pp = 2 x tp = 2: the losses and the params after equal
  JAX's pipelined step with optax's clip and adamw;
* the Trainer at pp = 2, 1F1B, M = 2, three steps (bins by token count on
  both sides) equal the JAX Trainer's records and params;
* ``cli.train --pp 2 --pp-schedule 1f1b --microbatches 4`` in the ranks'
  group: step 1 equals ``--dp 1``'s.

Bars: losses rtol 1e-5, grads and params max rel 1e-4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dynamictreeattn_tpu.parallel import init_opt_state as jax_init_opt_state
from dynamictreeattn_tpu.parallel import make_mesh as jax_make_mesh
from dynamictreeattn_tpu.parallel import make_pp_train_step as jax_make_pp_train_step
from dynamictreeattn_tpu.parallel import shard_params_pp as jax_shard_params_pp
from dynamictreeattn_tpu.parallel import stack_microbatches as jax_stack_microbatches
from dynamictreeattn_tpu.training import TrainConfig as JaxTrainConfig
from dynamictreeattn_tpu.training import Trainer as JaxTrainer
from dynamictreeattn_tpu.tries import TokenTrie as JaxTokenTrie
from dynamictreeattn_tpu_torch.cli import train as cli_train

from torch_dist_refs import JAX_ECFG, ECFG, cfg_dict, flat, grad_errs, init, jax_config, numpy_tree, rank_tries, worst
from torch_dist_worker import run_ranks

LOSS_RTOL, GRAD_REL = 1e-5, 1e-4
MOE = cfg_dict("qwen3-moe-tiny")
MOE = dict(MOE, moe_capacity_factor=float(MOE["num_experts"]), router_aux_coef=0.01)
TINY = cfg_dict("qwen3-tiny")
PM, PT = init(MOE), init(TINY, seed=1)
MOE_ROWS = [rank_tries(3, seed=41, n_seqs=5, max_len=20)]
OPT_ROWS = [rank_tries(2, seed=29, n_seqs=5, max_len=20)]
OPT = dict(lr=1e-3, clip=1.0, steps=2)
TC = dict(pp=2, pp_schedule="1f1b", microbatches=2, learning_rate=1e-3, param_dtype="fp32",
          lb_method="LB_by_n_tokens")
BATCHES = rank_tries(3, seed=4, n_seqs=8)
CLI = ["--device", "cpu", "--model", "qwen3-tiny", "--dtype", "fp32", "--attn-backend", "reference",
       "--block-q", "32", "--block-kv", "32", "--lr", "1e-3", "--steps", "1",
       "--data", "synthetic:n_prompts=2,samples=4,prompt_lo=8,prompt_hi=12,completion_lo=4,completion_hi=8"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_trainer():
    jt = JaxTrainer(jax_config(TINY), JAX_ECFG, JaxTrainConfig(**TC))
    jt.init(seed=0)
    return jt, numpy_tree(jt.params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_trainer):
    root = tmp_path_factory.mktemp("pp_train")
    _, params = jax_trainer
    cases = [(f"moe_{s}", "pp", dict(dp=1, pp=2, tp=2, cfg=MOE, ecfg=ECFG, params=PM, rows=MOE_ROWS, schedule=s))
             for s in ("gpipe", "1f1b")]
    cases.append(("opt", "pp", dict(dp=1, pp=2, tp=2, cfg=TINY, ecfg=ECFG, params=PT, rows=OPT_ROWS,
                                    schedule="gpipe", steps=OPT["steps"], lr=OPT["lr"], clip=OPT["clip"])))
    cases.append(("trainer", "trainer", dict(dp=1, tp=1, cfg=TINY, ecfg=ECFG, params=params, batches=BATCHES,
                                             tc=TC)))
    cases.append(("cli", "cli", dict(argv=CLI + ["--pp", "2", "--pp-schedule", "1f1b", "--microbatches", "4",
                                                 "--dist-backend", "gloo", "--stats-out", str(root / "pp.jsonl")])))
    return run_ranks(4, cases, str(root / "work")), root


def _jax_step(cfg: dict, params: dict, rows: list, schedule: str, optimizer=None):
    jcfg = jax_config(cfg)
    mesh = jax_make_mesh(dp=1, tp=2, pp=2)
    step = jax_make_pp_train_step(jcfg, mesh, JAX_ECFG, optimizer=optimizer, schedule=schedule)
    arrays = jax_stack_microbatches([[JaxTokenTrie(s, a) for s, a in row] for row in rows], JAX_ECFG).arrays
    return step, jax_shard_params_pp(jax.tree.map(jnp.asarray, params), mesh, jcfg), arrays


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_moe_stages_equal_jax(ranks, schedule):
    """Each stage seeds its own MoE layers' load-balance term; the step's
    loss, lb_loss and grads equal JAX's."""
    step, p, arrays = _jax_step(MOE, PM, MOE_ROWS, schedule)
    loss, grads, aux = step(p, arrays)
    res = ranks[0][f"moe_{schedule}"]
    losses = {float(r["loss"]) for r in res}
    assert len(losses) == 1, losses
    np.testing.assert_allclose(losses.pop(), float(loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(res[0]["lb_loss"]), float(aux["lb_loss"]), rtol=LOSS_RTOL)
    err, path = worst(grad_errs(flat(numpy_tree(grads)), res[0]))
    assert err < GRAD_REL, (path, err)


def test_optimizer_steps_equal_jax(ranks):
    """Two AdamW steps with the clip over the whole model's norm (each
    stage's layers counted once, the replicated leaves once) equal JAX's
    pipelined step with optax; the loss descends."""
    opt = optax.chain(optax.clip_by_global_norm(OPT["clip"]), optax.adamw(OPT["lr"], weight_decay=0.0))
    step, p, arrays = _jax_step(TINY, PT, OPT_ROWS, "gpipe", optimizer=opt)
    state = jax_init_opt_state(opt, p)
    losses = []
    for _ in range(OPT["steps"]):
        p, state, loss, _ = step(p, state, arrays)
        losses.append(float(loss))
    res = ranks[0]["opt"]
    np.testing.assert_allclose(res[0]["losses"], losses, rtol=LOSS_RTOL)
    assert losses[1] < losses[0]
    err, path = worst(grad_errs(flat(numpy_tree(p)), res[0], prefix="p/"))
    assert err < GRAD_REL, (path, err)


def test_trainer_equals_jax_trainer(ranks, jax_trainer):
    """The Trainer at pp = 2 (1F1B, two microbatches binned by token count)
    over three steps: records and params equal the JAX Trainer's."""
    jt, _ = jax_trainer
    want = [jt.train_step(s, a) for s, a in BATCHES]
    res = ranks[0]["trainer"]
    for r in res[:2]:
        for key in ("loss", "sum_logprob", "sum_entropy"):
            np.testing.assert_allclose(r[key], [w[key] for w in want], rtol=LOSS_RTOL, err_msg=key)
        assert r["n_tree_tokens"].tolist() == [w["n_tree_tokens"] for w in want]
    err, path = worst(grad_errs(flat(numpy_tree(jt.params)), res[0], prefix="p/"))
    assert err < GRAD_REL, (path, err)


def test_cli_pp_step_one_equals_dp1(ranks, tmp_path):
    """cli.train --pp 2 --pp-schedule 1f1b in the ranks' group: two ranks
    train (the others return), rank 0 writes step 1, equal to --dp 1's."""
    res, root = ranks
    assert [bool(r["trained"]) for r in res["cli"]] == [True, True, False, False]
    with open(root / "pp.jsonl") as f:
        pp = [json.loads(line) for line in f]
    cli_train.main(CLI + ["--stats-out", str(tmp_path / "dp1.jsonl")])
    with open(tmp_path / "dp1.jsonl") as f:
        one = [json.loads(line) for line in f]
    assert len(pp) == len(one) == 1
    np.testing.assert_allclose(pp[0]["loss"], one[0]["loss"], rtol=LOSS_RTOL)
    assert pp[0]["n_tokens"] == one[0]["n_tokens"]
