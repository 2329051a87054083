"""The port's multi-host bring-up against the JAX package's two-process test.

Eight ranks, one process each, over gloo on the CPU, laid out as two
"hosts" of four with the environment a two-node ``torchrun`` gives
(``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``GROUP_RANK``); the first case starts
the process group with ``initialize_multihost`` from a ``file://`` URL (no
port). The mesh is dp 2 × tp 2 × sp 2, that of JAX's
``tests/multihost_worker.py``, on its tiny config:

* ``initialize_multihost`` returns the rank, the world, four local and eight
  global devices (ranks, on the CPU), the same when called again;
  ``local_data_ranks`` gives host 0 data rank 0 and host 1 data rank 1;
* the step's loss and global grad norm equal JAX's single-process step on
  the fake 8-device mesh (rtol 1e-6, JAX ``tests/test_multihost.py``), the
  same on every rank bit for bit, and the grads equal JAX's (max rel 1e-5);
* the multihost Trainer over two steps is bit-equal to the same Trainer
  without the flag (one process per rank: the same math);
* the custom-loss (clipped-ratio) multihost Trainer at dp 4 × tp 2 is
  finite and equal on every rank;
* ``cli.train --multihost`` in ranks with no process group starts one from
  the launcher's environment (``MASTER_ADDR`` / ``MASTER_PORT``, a free
  localhost port) and trains bit-equal to the same argv run inside the
  first group; the last case, as it replaces the group.
"""

import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.models import Qwen3Config as JaxQwen3Config
from dynamictreeattn_tpu.parallel import make_mesh as jax_make_mesh
from dynamictreeattn_tpu.parallel import make_train_step as jax_make_train_step
from dynamictreeattn_tpu.parallel import shard_params as jax_shard_params
from dynamictreeattn_tpu.parallel import stack_batches as jax_stack_batches
from dynamictreeattn_tpu.tries import TokenTrie as JaxTokenTrie

from torch_dist_refs import ECFG, JAX_ECFG, flat, grad_errs, init, numpy_tree, rank_tries, worst
from torch_dist_worker import run_ranks

# JAX tests/multihost_worker.py's config
JAX_TINY = JaxQwen3Config(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                          num_attention_heads=8, num_key_value_heads=4, head_dim=16, tie_word_embeddings=True)
TINY = {f.name: getattr(JAX_TINY, f.name) for f in dataclasses.fields(JAX_TINY)}
PARAMS = init(TINY)
TRIES = rank_tries(2, seed=0)
SEQS = [s for seqs, _ in TRIES for s in seqs]
_rng = np.random.default_rng(3)
EXTRAS = {"behavior_lp": [_rng.normal(size=len(s) - 1).astype(np.float32) for s in SEQS],
          "adv": _rng.normal(size=len(SEQS)).astype(np.float32)}
TC = dict(learning_rate=1e-3, param_dtype="fp32", lb_block_size=32, lb_method="LB_by_n_tokens")
MESH = dict(dp=2, tp=2, sp=2)
CLI = ["--device", "cpu", "--model", "qwen3-tiny", "--dtype", "fp32", "--attn-backend", "reference",
       "--block-q", "32", "--block-kv", "32", "--lr", "1e-3", "--steps", "2", "--dp", "2", "--tp", "2",
       "--sp", "2", "--sp-mode", "ring", "--dist-backend", "gloo",
       "--data", "synthetic:n_prompts=2,samples=4,prompt_lo=8,prompt_hi=12,completion_lo=4,completion_hi=8"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    batches = [(SEQS, [{} for _ in SEQS])] * 2
    cases = [("init", "host_init", dict(url=f"file://{root / 'rendezvous'}", mesh=MESH)),
             ("step", "host_step", dict(**MESH, cfg=TINY, ecfg=ECFG, params=PARAMS, tries=TRIES))]
    for name, multihost in (("multihost", True), ("plain", False)):
        cases.append((f"trainer_{name}", "trainer", dict(dp=2, tp=2, cfg=TINY, ecfg=ECFG, params=PARAMS,
                                                         batches=batches, tc=dict(TC, sp=2, multihost=multihost))))
    cases.append(("custom", "host_custom", dict(dp=4, tp=2, cfg=TINY, ecfg=ECFG, seqs=SEQS, extras=EXTRAS, tc=TC)))
    cases.append(("cli", "host_cli", dict(argv=CLI, port=_free_port())))
    return run_ranks(8, cases, str(root / "work"), hosts=2)


@pytest.fixture(scope="module")
def jax_step():
    """(loss, grad norm, grads) of JAX's single-process step on the fake mesh."""
    mesh = jax_make_mesh(**MESH)
    step = jax_make_train_step(JAX_TINY, mesh, JAX_ECFG)
    batch = jax_stack_batches([JaxTokenTrie(s, a) for s, a in TRIES], JAX_ECFG, sp=2)
    loss, grads, _ = step(jax_shard_params(jax.tree.map(jnp.asarray, PARAMS), mesh, JAX_TINY), batch.arrays)
    gnorm = float(jax.jit(lambda g: sum(jnp.sum(x.astype(jnp.float32) ** 2) for x in jax.tree.leaves(g)))(grads)
                  ** 0.5)
    return float(loss), gnorm, flat(numpy_tree(grads))


def test_initialize_multihost_and_local_data_ranks(ranks):
    """HostInfo (rank, world 8, 4 local and 8 global devices), the same on a
    second call; each host feeds the data rank of its four ranks."""
    for r, res in enumerate(ranks["init"]):
        np.testing.assert_array_equal(res["first"], [r, 8, 4, 8])
        np.testing.assert_array_equal(res["again"], res["first"])
        assert res["data_ranks"].tolist() == [r // 4]
        assert int(res["data"]) == r // 4


def test_step_equals_jax_and_agrees_across_hosts(ranks, jax_step):
    loss, gnorm, grads = jax_step
    res = ranks["step"]
    assert len({float(r["loss"]) for r in res}) == 1
    assert len({float(r["gnorm"]) for r in res}) == 1
    np.testing.assert_allclose(float(res[0]["loss"]), loss, rtol=1e-6)
    np.testing.assert_allclose(float(res[0]["gnorm"]), gnorm, rtol=1e-6)
    err, path = worst(grad_errs(grads, res[0]))
    assert err < 1e-5, (path, err)


def test_multihost_trainer_bit_equals_plain(ranks):
    """One process per rank: the flag changes no number."""
    for a, b in zip(ranks["trainer_multihost"], ranks["trainer_plain"]):
        for key in ("loss", "sum_logprob", "sum_entropy"):
            np.testing.assert_array_equal(a[key], b[key])
        if "p/embed" in a:
            for key in a:
                if key.startswith("p/"):
                    np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    losses = ranks["trainer_multihost"][0]["loss"]
    assert losses[1] < losses[0]


def test_custom_loss_trainer_agrees_across_hosts(ranks):
    losses = [float(r["loss"]) for r in ranks["custom"]]
    assert np.isfinite(losses[0]) and len(set(losses)) == 1, losses


def test_cli_multihost_starts_a_fresh_group(ranks):
    """The flag's initialize_multihost starts the 8-rank group from the
    launcher's environment; two steps bit-equal to the run inside the
    spawned group, on every rank."""
    res = ranks["cli"]
    for r, out in enumerate(res):
        assert out["group"].tolist() == [8, r]
        np.testing.assert_array_equal(out["multihost"], out["plain"])
        np.testing.assert_array_equal(out["multihost"], res[0]["multihost"])
    assert len(res[0]["plain"]) == 2 and np.all(np.isfinite(res[0]["plain"]))
