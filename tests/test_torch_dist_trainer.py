"""The port's Trainer, checkpoints and cli.train on a mesh against the JAX
package and against one device.

Four ranks (one process each, over gloo on the CPU; ``torch_dist_worker``,
spawned once for the file), fp32 qwen3-tiny with the JAX Trainer's initial
weights, the reference attention and the vocab-chunked loss:

* the Trainer at dp = 2: three steps equal to the JAX Trainer at dp = 2 on
  the fake CPU mesh (bins by token count on both sides), records and params;
  then its forward_logprobs equal JAX's (2e-5 plus the params' 1e-5), and
  its greedy rollout, from the gathered params on every rank, the port's
  one-device sampler on those params;
* at the default balancer (the live cost model), every rank fits the same
  times: rank 0's, broadcast;
* a checkpoint written on one device restores at (dp, tp) = (2, 2) bit-equal
  (params and moments), and one written at (2, 2) restores on one device
  bit-equal; the step after equals the one-device step;
* ``cli.train --dp 2 --tp 2`` (the ranks joining their group, as under
  torchrun): its step-1 loss equals ``--dp 1``'s.

Bars: losses rtol 1e-6 (fp32 sums in another order; JAX's CLI cross-check
asks for "the same step-1 loss"), params after the steps < 1e-5.
"""

import json

import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.models import MODEL_CONFIGS as JAX_CONFIGS
from dynamictreeattn_tpu.training import TrainConfig as JaxTrainConfig
from dynamictreeattn_tpu.training import Trainer as JaxTrainer
from dynamictreeattn_tpu_torch.cli import train as cli_train
from dynamictreeattn_tpu_torch.engine import EngineConfig
from dynamictreeattn_tpu_torch.models import Qwen3Config, generate_grouped
from dynamictreeattn_tpu_torch.training import TrainConfig, Trainer

from torch_dist_refs import ECFG, JAX_ECFG, cfg_dict, flat, grad_errs, numpy_tree, rank_tries, worst
from torch_dist_worker import run_ranks

LOSS_RTOL, PARAM_REL = 1e-6, 1e-5
TINY = cfg_dict("qwen3-tiny")
TC = dict(learning_rate=1e-3, param_dtype="fp32")
BATCHES = rank_tries(3, seed=4, n_seqs=8)
PROMPTS = np.random.default_rng(3).integers(1, 128, size=(2, 6)).astype(np.int32)
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
    jt = JaxTrainer(JAX_CONFIGS["qwen3-tiny"], JAX_ECFG,
                    JaxTrainConfig(dp=2, tp=1, lb_method="LB_by_n_tokens", **TC))
    jt.init(seed=0)
    return jt, numpy_tree(jt.params)


def _one_device(params, ckpt_dir=None, **tc):
    t = Trainer(Qwen3Config(**TINY), EngineConfig(**ECFG), TrainConfig(ckpt_dir=ckpt_dir, **TC, **tc),
                device="cpu")
    if params is not None:
        from dynamictreeattn_tpu_torch.models import params_from_numpy

        t.set_params(params_from_numpy(params, device="cpu"))
    return t


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_trainer):
    _, params = jax_trainer
    root = tmp_path_factory.mktemp("ranks")
    one = _one_device(params, ckpt_dir=str(root / "one"), warmup_steps=2)
    one.train_step(*BATCHES[0])
    one.save()
    cases = [
        ("trainer", "trainer", dict(dp=2, tp=1, cfg=TINY, ecfg=ECFG, params=params, batches=BATCHES,
                                    tc=dict(TC, lb_method="LB_by_n_tokens"), prompts=PROMPTS)),
        ("cost_model", "trainer", dict(dp=2, tp=2, cfg=TINY, ecfg=ECFG, params=params, batches=BATCHES, tc=TC)),
        ("ckpt", "ckpt", dict(dp=2, tp=2, cfg=TINY, ecfg=ECFG, tc=dict(TC, warmup_steps=2),
                              restore_dir=str(root / "one"), save_dir=str(root / "mesh"), batch=BATCHES[1])),
        ("cli", "cli", dict(argv=CLI + ["--dp", "2", "--tp", "2", "--dist-backend", "gloo",
                                        "--stats-out", str(root / "cli.jsonl")])),
        ("cli_dp2", "cli", dict(argv=CLI + ["--dp", "2", "--dist-backend", "gloo",
                                            "--stats-out", str(root / "cli_dp2.jsonl")])),
    ]
    return run_ranks(4, cases, str(root / "work")), one, root


def test_trainer_dp2_matches_jax_trainer(ranks, jax_trainer):
    jt, _ = jax_trainer
    want = [jt.train_step(s, a) for s, a in BATCHES]
    res = ranks[0]["trainer"]
    for r in res[:2]:
        for key in ("loss", "sum_logprob", "sum_entropy"):
            np.testing.assert_allclose(r[key], [w[key] for w in want], rtol=LOSS_RTOL, err_msg=key)
        assert r["n_tree_tokens"].tolist() == [w["n_tree_tokens"] for w in want]
    err, path = worst(grad_errs(flat(numpy_tree(jt.params)), res[0], prefix="p/"))
    assert err < PARAM_REL, (path, err)
    # forward_logprobs over the mesh (aligned with the input order) == JAX's
    # on the same trainer state; a greedy rollout from the gathered params ==
    # the port's one-device sampler on them, on every rank
    want_lp = np.concatenate(jt.forward_logprobs(*BATCHES[0]))
    tree = {}
    for key, v in res[0].items():
        if key.startswith("p/"):
            *path, leaf = key[2:].split("/")
            node = tree
            for name in path:
                node = node.setdefault(name, {})
            node[leaf] = torch.from_numpy(v)
    want_tokens = generate_grouped(tree, Qwen3Config(**TINY), PROMPTS, np.array([6, 5], np.int32), 2, 4,
                                   greedy=True)
    for r in res[:2]:
        np.testing.assert_allclose(r["forward"], want_lp, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(r["rollout"], want_tokens)


def test_ranks_fit_one_cost_model(ranks):
    """Under the cost-model balancer every rank feeds TreeTimeModel rank 0's
    step time, so the fits (and the next step's bins) agree; the records
    agree too."""
    res = ranks[0]["cost_model"]
    assert len(res[0]["fit_times"]) == len(BATCHES)
    for r in res[1:]:
        np.testing.assert_array_equal(r["fit_times"], res[0]["fit_times"])
        np.testing.assert_array_equal(r["loss"], res[0]["loss"])


def test_checkpoint_moves_between_meshes(ranks):
    """One device -> (2, 2): the restored params and moments, gathered, equal
    the saved ones bitwise; (2, 2) -> one device: the restored params equal
    the mesh's, bitwise; the mesh's next step equals the one device's."""
    res, one, root = ranks
    r0 = res["ckpt"][0]
    assert int(r0["step_idx"]) == 1 and int(r0["count"]) == 1
    for path, v in flat(one.params).items():
        np.testing.assert_array_equal(r0["restored/" + path], v, err_msg=path)
    names = list(flat(one.params))
    for path, v in zip(names, one.opt_state["mu"]):
        np.testing.assert_array_equal(r0["mu/" + path], v.numpy(), err_msg=path)
    rec = one.train_step(*BATCHES[1])
    np.testing.assert_allclose(float(r0["next_loss"]), rec["loss"], rtol=LOSS_RTOL)
    back = _one_device(None, ckpt_dir=str(root / "mesh"), warmup_steps=2)
    back.restore()
    assert back.step_idx == 2
    for path, v in flat(back.params).items():
        np.testing.assert_array_equal(v, r0["after/" + path], err_msg=path)
    err, path = worst(grad_errs(flat(one.params), r0, prefix="after/"))
    assert err < PARAM_REL, (path, err)


def test_cli_train_on_mesh_matches_dp1(ranks, tmp_path, capsys):
    """cli.train --dp 2 --tp 2: rank 0 alone writes the records; step 1's loss
    equals --dp 1's on the same synthetic batch and seed."""
    _, _, root = ranks
    with open(root / "cli.jsonl") as f:
        mesh_recs = [json.loads(line) for line in f]
    assert len(mesh_recs) == 1
    cli_train.main(CLI + ["--stats-out", str(tmp_path / "one.jsonl")])
    with open(tmp_path / "one.jsonl") as f:
        one = json.loads(f.readline())
    np.testing.assert_allclose(mesh_recs[0]["loss"], one["loss"], rtol=LOSS_RTOL)
    assert mesh_recs[0]["n_sequences"] == one["n_sequences"] and mesh_recs[0]["n_tokens"] == one["n_tokens"]
    assert [bool(r["trained"]) for r in ranks[0]["cli"]] == [True] * 4


def test_cli_train_ranks_beyond_the_mesh_return(ranks, tmp_path):
    """cli.train --dp 2 in a group of 4 (a launcher that started more ranks
    than dp·tp): ranks 2 and 3 return without training or writing; ranks 0
    and 1 train, and step 1's loss equals --dp 1's."""
    _, _, root = ranks
    assert [bool(r["trained"]) for r in ranks[0]["cli_dp2"]] == [True, True, False, False]
    with open(root / "cli_dp2.jsonl") as f:
        mesh_recs = [json.loads(line) for line in f]
    assert len(mesh_recs) == 1
    cli_train.main(CLI + ["--stats-out", str(tmp_path / "one.jsonl")])
    with open(tmp_path / "one.jsonl") as f:
        one = json.loads(f.readline())
    np.testing.assert_allclose(mesh_recs[0]["loss"], one["loss"], rtol=LOSS_RTOL)
