"""The port's steps over data and tensor parallelism against the JAX package.

Eight ranks, one process each, over gloo on the CPU (``torch_dist_worker``,
spawned once for the file), run ``make_train_step`` / ``make_forward_step``
on meshes of (dp, tp) with the JAX package's fp32 qwen3-tiny weights; each
is held against the JAX package's one-device engine summed over the ranks'
tries (JAX ``tests/test_parallel.py``), at (2, 1) also against the JAX
sharded step on the fake 8-device CPU mesh. Bars (fp32, the same math
summed in another order): loss rtol 1e-6 and per-parameter relative grad
error < 1e-5, through the reference attention and through the kernel
backend's plain versions under remat (the JAX suite's 1e-4 and 1e-3,
tightened to what fp32 shows: at most 6.1e-8 and 1.8e-6 here); forward
log-probs at 2e-5 (JAX's bar). The optimizer steps at (2, 2) equal the
port's one-device steps on the union of the ranks' sequences (the trie loss
is a sum over sequences): losses rtol 1e-6, params < 1e-5 (1.1e-7 and
4.0e-6 seen), the clip binding in one case.
"""

import functools

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
from dynamictreeattn_tpu_torch.engine import EngineConfig
from dynamictreeattn_tpu_torch.models import Qwen3Config, params_from_numpy
from dynamictreeattn_tpu_torch.parallel import Mesh, make_forward_step, make_mesh, make_train_step, stack_batches
from dynamictreeattn_tpu_torch.parallel.mesh import pick_backend
from dynamictreeattn_tpu_torch.tries import TokenTrie
from dynamictreeattn_tpu_torch.training import OptaxAdamW

from torch_dist_refs import ECFG, JAX_ECFG, cfg_dict, flat, grad_errs, init, jax_config, jax_engine_sum, rank_tries, worst
from torch_dist_worker import run_ranks

LOSS_RTOL, GRAD_REL = 1e-6, 1e-5
TINY = cfg_dict("qwen3-tiny")
QWEN25 = cfg_dict("qwen3-tiny", use_qk_norm=False, attention_bias=True, tie_word_embeddings=False)
MESHES = [(2, 1), (1, 2), (2, 2), (4, 2)]
KERNEL_ECFG = dict(ECFG, attn_backend="kernel", loss_mode="kernel", remat=True)
REMATS = {"segments2": dict(remat_segments=2), "attn_dots": dict(remat_policy="attn_dots")}
OPT = dict(lr=1e-2, steps=2)
CLIPS = {"clip_binds": 0.05, "no_clip": 0.0}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qwen25_params():
    params = init(QWEN25, seed=2)
    rng = np.random.default_rng(21)
    for b in ("bq", "bk", "bv"):  # non-trivial biases, so that their grads matter
        params["layers"][b] = (rng.normal(size=params["layers"][b].shape) * 0.1).astype(np.float32)
    return params


INPUTS = {
    "step": (TINY, init(TINY), {m: rank_tries(m[0], seed=0) for m in MESHES}),
    "qwen25": (QWEN25, _qwen25_params(), rank_tries(1, seed=21, max_len=16)),
    "forward": (TINY, init(TINY, seed=2), {(2, 2): rank_tries(2, seed=31), (4, 1): rank_tries(4, seed=31)}),
    "opt": (TINY, init(TINY, seed=1), rank_tries(2, seed=3)),
    "custom": (TINY, init(TINY, seed=4), rank_tries(2, seed=41)),
}
SCALES = np.random.default_rng(5).uniform(0.5, 1.5, size=(2, 6)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cfg, params, tries = INPUTS["step"]
    cases = [(f"step{dp}{tp}", "step", dict(dp=dp, tp=tp, cfg=cfg, ecfg=ECFG, params=params, tries=tries[dp, tp]))
             for dp, tp in MESHES]
    cases += [(f"kernel_{name}", "step", dict(dp=2, tp=2, cfg=cfg, ecfg=dict(KERNEL_ECFG, **kw), params=params,
                                              tries=tries[2, 2])) for name, kw in REMATS.items()]
    cfg25, p25, t25 = INPUTS["qwen25"]
    cases.append(("qwen25", "step", dict(dp=1, tp=2, cfg=cfg25, ecfg=ECFG, params=p25, tries=t25)))
    cfg, params, tries = INPUTS["forward"]
    cases += [(f"forward{dp}{tp}", "forward", dict(dp=dp, tp=tp, cfg=cfg, ecfg=ECFG, params=params,
                                                   tries=tries[dp, tp])) for dp, tp in tries]
    cfg, params, tries = INPUTS["opt"]
    cases += [(f"opt_{name}", "opt", dict(dp=2, tp=2, cfg=cfg, ecfg=ECFG, params=params, tries=tries, clip=clip,
                                          **OPT)) for name, clip in CLIPS.items()]
    cfg, params, tries = INPUTS["custom"]
    cases.append(("custom", "custom", dict(dp=2, tp=2, cfg=cfg, ecfg=ECFG, params=params, tries=tries,
                                           scales=SCALES)))
    return run_ranks(8, cases, str(tmp_path_factory.mktemp("ranks")))


@functools.lru_cache(maxsize=None)
def _jax_sum(which: str, mesh=None):
    cfg, params, tries = INPUTS[which]
    return jax_engine_sum(cfg, params, tries if mesh is None else tries[mesh])


def _check_step(res, ref_loss, ref_grads, loss_rtol, grad_rel):
    losses = [float(r["loss"]) for r in res if r is not None]
    assert len(set(losses)) == 1, losses  # every rank holds the summed loss
    np.testing.assert_allclose(losses[0], ref_loss, rtol=loss_rtol)
    err, path = worst(grad_errs(ref_grads, res[0]))
    assert err < grad_rel, (path, err)


@pytest.mark.parametrize("dp,tp", MESHES)
def test_train_step_on_mesh_matches_jax(ranks, dp, tp):
    """Loss, aux and every grad at (dp, tp) == the JAX engine summed over
    the ranks' tries."""
    ref_loss, ref_grads = _jax_sum("step", (dp, tp))
    res = ranks[f"step{dp}{tp}"]
    assert sum(r is not None for r in res) == dp * tp
    _check_step(res, ref_loss, ref_grads, LOSS_RTOL, GRAD_REL)


def test_train_step_2x1_matches_jax_sharded_step(ranks):
    """At (2, 1) the JAX package's own sharded step (shard_map over a
    2-device mesh) gives the same loss and grads."""
    cfg, params, tries = INPUTS["step"]
    mc = jax_config(cfg)
    mesh = jax_make_mesh(dp=2, tp=1)
    jp = jax.tree.map(jnp.asarray, params)
    batch = jax_stack_batches([JaxTokenTrie(s, a) for s, a in tries[2, 1]], JAX_ECFG)
    loss, grads, _ = jax_make_train_step(mc, mesh, JAX_ECFG)(jax_shard_params(jp, mesh, mc), batch.arrays)
    _check_step(ranks["step21"], float(loss), flat(jax.tree.map(np.asarray, jax.device_get(grads))),
                LOSS_RTOL, GRAD_REL)


@pytest.mark.parametrize("remat", list(REMATS))
def test_kernel_backend_under_remat_on_mesh(ranks, remat):
    """At (2, 2) through the kernel backend (the plain K1/K2, K3, K4-K7 and
    K8/K9 on CPU tensors, on each rank's local heads and vocabulary shard)
    with the TP layer under remat (nested segments; the attn_dots
    hand-off): the JAX reference engine's sum."""
    ref_loss, ref_grads = _jax_sum("step", (2, 2))
    _check_step(ranks[f"kernel_{remat}"], ref_loss, ref_grads, LOSS_RTOL, GRAD_REL)


def test_qwen25_variant_at_tp2(ranks):
    """Biases, no qk-norm and an untied head (JAX
    ``test_sharded_step_qwen25_variant``) at tp = 2."""
    ref_loss, ref_grads = _jax_sum("qwen25")
    _check_step(ranks["qwen25"], ref_loss, ref_grads, LOSS_RTOL, GRAD_REL)


@pytest.mark.parametrize("dp,tp", [(2, 2), (4, 1)])
def test_forward_step_on_mesh_matches_jax_forward(ranks, dp, tp):
    """make_forward_step + extract_forward == the JAX engine's forward, per
    sequence of every data rank (JAX ``test_sharded_forward_matches_engine_forward``)."""
    cfg, params, tries = INPUTS["forward"]
    res = ranks[f"forward{dp}{tp}"]
    assert all(bool(r["finite"]) and tuple(r["shape"])[0] == dp for r in res if r is not None)
    engine = JaxTreeEngine(jax_config(cfg), JAX_ECFG)
    jp = jax.tree.map(jnp.asarray, params)
    for r, (seqs, attachs) in enumerate(tries[dp, tp]):
        ref = engine.forward(jp, engine.prepare(JaxTokenTrie(seqs, attachs)))
        for k, v in ref.items():
            np.testing.assert_allclose(res[0][f"lp/{r}/{k}"], v, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("clip", list(CLIPS))
def test_optimizer_step_on_mesh_matches_one_device(ranks, clip):
    """Two optimizer steps at (2, 2): the loss descends, and the params equal
    the port's one-device steps on one trie of all the ranks' sequences; with
    clip 0.05 the clip binds (the tiny model's grad norm is far above it), so
    the clip's norm must be the whole model's."""
    cfg, params, tries = INPUTS["opt"]
    res = ranks[f"opt_{clip}"]
    losses = res[0]["losses"]
    assert losses[1] < losses[0]
    mc, ec = Qwen3Config(**cfg), EngineConfig(**ECFG)
    opt = OptaxAdamW(OPT["lr"], grad_clip=CLIPS[clip])
    step = make_train_step(mc, ec, optimizer=opt, device="cpu")
    seqs = [s for ts, _ in tries for s in ts]
    attachs = [a for _, ats in tries for a in ats]
    batch = stack_batches([TokenTrie(seqs, attachs)], ec, engine=step.engine)
    p = params_from_numpy(params, device="cpu")
    state = opt.init(p)
    if CLIPS[clip]:
        g = make_train_step(mc, ec, device="cpu")(p, batch)[1]
        norm = float(np.sqrt(sum(np.sum(t.astype(np.float64) ** 2) for t in flat(g).values())))
        assert norm > 10 * CLIPS[clip], norm
    one = []
    for _ in range(OPT["steps"]):
        p, state, loss, _ = step(p, state, batch)
        one.append(float(loss))
    np.testing.assert_allclose(losses, one, rtol=LOSS_RTOL)
    err, path = worst(grad_errs(flat(p), res[0], prefix="p/"))
    assert err < 1e-5, (path, err)


def _jax_scaled_loss(lp, ent, extras, length):
    m_lp = (jnp.arange(lp.shape[0]) < length - 1).astype(jnp.float32)
    m_en = (jnp.arange(ent.shape[0]) < length).astype(jnp.float32)
    return -extras["scale"] * jnp.sum(lp * m_lp) + 0.1 * jnp.sum(ent * m_en) / length


def test_custom_loss_step_on_mesh_matches_jax(ranks):
    """A per-sequence loss with an extra (``torch_dist_worker.scaled_loss``)
    at (2, 2): each rank uploads its row of the extras; the loss and grads
    equal the JAX engine's custom step summed over the ranks' tries."""
    cfg, params, tries = INPUTS["custom"]
    engine = JaxTreeEngine(jax_config(cfg), JAX_ECFG)
    jp = jax.tree.map(jnp.asarray, params)
    total, grads = 0.0, None
    for r, (seqs, attachs) in enumerate(tries):
        batch = engine.prepare(JaxTokenTrie(seqs, attachs))
        order = np.asarray(batch.packed.seq_batch_ids)
        extras = {"scale": jnp.asarray(SCALES[r][: len(order)])}
        loss, g = engine.loss_and_grad_custom(jp, batch, _jax_scaled_loss, extras)
        total += float(loss)
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    _check_step(ranks["custom"], total, flat(jax.tree.map(np.asarray, jax.device_get(grads))), LOSS_RTOL, GRAD_REL)


def test_mesh_rules_without_a_group():
    """The backend rule and the refusals, checked before any group is
    joined; sequence and pipeline parallelism need the group as dp and tp
    do, and exclude each other (JAX's pipeline refuses sp)."""
    with pytest.raises(ValueError, match="not initialised"):
        make_mesh(dp=1, tp=1, sp=2)
    with pytest.raises(ValueError, match="not initialised"):
        make_mesh(dp=1, tp=1, pp=2)
    with pytest.raises(ValueError, match="exclusive"):
        make_mesh(dp=1, tp=1, sp=2, pp=2)
    assert pick_backend(None, "cpu", 4) == "gloo"
    with pytest.raises(ValueError, match="NCCL does not run on the CPU"):
        pick_backend("nccl", "cpu", 2)
    with pytest.raises(ValueError, match="not initialised"):
        make_mesh(dp=2, tp=1, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        make_train_step(Qwen3Config(**TINY), EngineConfig(**ECFG), device="cpu", dp=2)
    mesh = Mesh({"data": 2, "seq": 1, "pipe": 1, "model": 1}, {"data": 0, "seq": 0, "pipe": 0, "model": 0}, {},
                "gloo", torch.device("cpu"), None)
    for step_fn in (make_train_step, make_forward_step):  # the mesh sets the degrees
        with pytest.raises(ValueError, match="disagree with a mesh"):
            step_fn(Qwen3Config(**TINY), EngineConfig(**ECFG), dp=4, mesh=mesh)
    # the rule's NCCL refusal on a shared card, as the card would see it
    if not torch.cuda.is_available():
        real = torch.cuda.device_count
        torch.cuda.device_count = lambda: 1
        try:
            with pytest.raises(ValueError, match="share 1 card"):
                pick_backend(None, "cuda", 2)
            assert pick_backend("gloo", "cuda", 2) == "gloo" and pick_backend(None, "cuda", 1) == "nccl"
        finally:
            torch.cuda.device_count = real
