"""The port's vocab-parallel LM-head statistics against the JAX package.

tp ranks (one process each, over gloo on the CPU; ``torch_dist_worker``,
spawned once for the file) hold column shards [d, V/tp] of one fp32 head,
as the kernels take them ([V/tp, d] rows); ``vp_position_stats`` in each
loss mode ("vocab", "kernel" — K8/K9's plain versions on CPU tensors —,
"rows") is held against the JAX ``vp_position_stats`` under ``shard_map``
on the fake CPU mesh (the pattern of JAX ``tests/test_vocab_parallel.py``),
and the vp loss's grads (hidden through ``mpar_in``, as the
tensor-parallel model leaves it; the head shards gathered) against the JAX
one-device loss. tp = 2 and 4, temperature 1.0 and 0.7, and a ragged
shard: V = 150 at tp = 2 (75 columns), as Qwen3-0.6B's 75,968 at tp = 2 is
no multiple of K8's 256-column tile. Bars: lse rtol 2e-6, entropy rtol
2e-5 / atol 2e-6 (JAX's 2e-5 and 2e-4 / 2e-5, tightened to what fp32
shows), loss rtol 1e-6, grads rtol 1e-5 / atol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dynamictreeattn_tpu.ops.losses import logprob_entropy_from_hidden, position_stats_from_hidden
from dynamictreeattn_tpu.parallel import make_mesh as jax_make_mesh
from dynamictreeattn_tpu.parallel.vocab_parallel import vp_position_stats as jax_vp_position_stats

from torch_dist_worker import run_ranks

MODES = ("vocab", "kernel", "rows")
CASES = {"tp2_t1": (2, 1.0, 128), "tp2_t07": (2, 0.7, 128), "tp4_t1": (4, 1.0, 128), "tp4_t07": (4, 0.7, 128),
         "tp2_ragged": (2, 0.7, 150)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _inputs(v: int, seed: int = 0, n: int = 64, d: int = 32):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(n, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.3).astype(np.float32)
    tokens = rng.integers(0, v, size=n).astype(np.int32)
    parent = np.concatenate([[-1], np.arange(n - 1)]).astype(np.int32)
    w_lp = rng.normal(size=n).astype(np.float32)
    return dict(hidden=hidden, w=w, tokens=tokens, parent=parent, w_lp=w_lp, w_ent=np.abs(w_lp) * 0.1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [(name, "vp", dict(tp=tp, temperature=t, modes=MODES, **_inputs(v))) for name, (tp, t, v) in CASES.items()]
    return run_ranks(4, cases, str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("case", list(CASES))
def test_vp_stats_match_jax(ranks, case):
    """(lse, entropy) of every rank and every mode == the JAX vp stats under
    shard_map (and its one-device stats)."""
    tp, temperature, v = CASES[case]
    x = _inputs(v)
    mesh = jax_make_mesh(dp=1, tp=tp)
    sharded = jax.shard_map(lambda h, w: jax_vp_position_stats(h, w, temperature, 16), mesh=mesh,
                            in_specs=(P(), P(None, "model")), out_specs=(P(), P()), check_vma=False)
    lse_j, ent_j = (np.asarray(a) for a in sharded(jnp.asarray(x["hidden"]), jnp.asarray(x["w"])))
    lse_l, ent_l = (np.asarray(a) for a in position_stats_from_hidden(jnp.asarray(x["hidden"]),
                                                                      jnp.asarray(x["w"]), temperature, 16))
    np.testing.assert_allclose(lse_j, lse_l, rtol=2e-6)
    res = ranks[case]
    assert sum(r is not None for r in res) == tp
    for r in res[:tp]:
        for mode in MODES:
            np.testing.assert_allclose(r[f"lse_{mode}"], lse_j, rtol=2e-6, err_msg=mode)
            np.testing.assert_allclose(r[f"ent_{mode}"], ent_j, rtol=2e-5, atol=2e-6, err_msg=mode)


@pytest.mark.parametrize("case", list(CASES))
def test_vp_loss_grads_match_jax_one_device(ranks, case):
    """The vp loss and its grads in hidden (summed over the ranks by
    mpar_in) and in the head (each rank its shard, gathered) == the JAX
    one-device loss's."""
    tp, temperature, v = CASES[case]
    x = _inputs(v)
    tokens, parent = jnp.asarray(x["tokens"]), jnp.asarray(x["parent"])

    def local(h, w):
        lp, ent = logprob_entropy_from_hidden(h, w, tokens, parent, temperature, 16)
        return jnp.sum(jnp.asarray(x["w_lp"]) * lp) + jnp.sum(jnp.asarray(x["w_ent"]) * ent)

    loss, (gh, gw) = jax.value_and_grad(local, argnums=(0, 1))(jnp.asarray(x["hidden"]), jnp.asarray(x["w"]))
    for r in ranks[case][:tp]:
        for mode in MODES:
            np.testing.assert_allclose(r[f"loss_{mode}"], float(loss), rtol=1e-6, err_msg=mode)
            np.testing.assert_allclose(r[f"gh_{mode}"], np.asarray(gh), rtol=1e-5, atol=1e-6, err_msg=mode)
            np.testing.assert_allclose(r[f"gw_{mode}"], np.asarray(gw), rtol=1e-5, atol=1e-6, err_msg=mode)
