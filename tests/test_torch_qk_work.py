"""The qk-prep backward kernels' walk (``ops/qk_prep.py`` ``qk_bwd_plan`` /
``qk_bwd_walk``, run by ``csrc/qk_prep.cu``'s one persistent launch of K6
and K7): tiles of `rows` rows x all heads, CTA c taking tiles c, c + grid,
...; inside a CTA, group gi keeps row gi // (groups / rows) of each tile and
takes the heads j, j + groups / rows, ... (j = gi % (groups / rows)); the
CTAs' dw partials are summed in a fixed order on the card: by groups of
QK_DW_GROUP consecutive CTAs, then the group sums.

The plan must cover every (row, head) item exactly once, at ragged n, for
each count of slabs a tile loads (1: g; 2: g and x, or g and gv; 3: K7
with the norm), and give a tile the kernel takes. A torch replay of the
walk at fp32 (tiles in CTA order, each CTA's dw partial summed in walk
order, the partials summed by groups in CTA order and the group sums in
order) equals the plain K6/K7 within 1e-5 (the same fp32
arithmetic summed in another order, values of magnitude <= ~30) and the JAX
``_bwd_q`` / ``_bwd_kv`` in interpret mode within the JAX suite's fp32 bars
(tests/test_qk_prep.py: 2e-5 values, 3e-5 grads; dx, dv and dw are grads).
Two bugs planted in the walk (a tile dropped, a tile given twice) move the
replay past those bars. The launcher refuses CPU and meta tensors before it
loads the library.
"""

import functools
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamictreeattn_tpu.ops.qk_prep  # noqa: F401  (the module, reached through sys.modules)
from dynamictreeattn_tpu.models import qwen3 as jq
from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS
from dynamictreeattn_tpu_torch.ops.qk_prep import (
    QK_BWD_MAX_WIDTH, QK_DW_GROUP, qk_bwd_plan, qk_bwd_walk, qk_prep_bwd_kv_plain,
    qk_prep_bwd_q_plain,
)

qp = sys.modules["dynamictreeattn_tpu_torch.ops.qk_prep"]
jqp = sys.modules["dynamictreeattn_tpu.ops.qk_prep"]

EPS = 1e-6
PLAIN_TOL = 1e-5
FP32_GRAD_TOL = 3e-5
THREADS, CTAS_PER_SM, RING_BYTES, MAX_STAGES = 256, 2, 100 * 1024, 8  # csrc/qk_prep.cu
# (n, H, dh, sms) of the replays: ragged tiles, several tiles a CTA (8 SMs),
# one-row tiles, and a head count that leaves groups idle
REPLAY_SHAPES = [(50, 8, 64, 8), (50, 12, 128, 8), (7, 2, 128, 132), (37, 16, 128, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The replays run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _group_cover(rows: int, H: int, dh: int) -> np.ndarray:
    """[rows, H] how many of a CTA's groups compute each (row, head) of a
    full tile, as the kernel maps them."""
    groups = THREADS * 8 // dh
    gpr = groups // rows
    cover = np.zeros((rows, H), np.int64)
    for gi in range(groups):
        cover[gi // gpr, gi % gpr::gpr] += 1
    return cover


def _kernel_takes(rows: int, grid: int, H: int, dh: int, sms: int, slabs: int) -> bool:
    """The launcher's checks in csrc/qk_prep.cu for a tile of `slabs` slabs."""
    groups = THREADS * 8 // dh
    stage = rows * (slabs * H * dh * 2 + 8 * dh)
    return (1 <= rows <= groups and groups % rows == 0 and 1 <= grid <= CTAS_PER_SM * sms
            and min(MAX_STAGES, RING_BYTES // stage) >= 2)


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("H", [2, 8, 12, 16])
@pytest.mark.parametrize("n", [1, 7, 50, 6606, 6656])
def test_plan_covers_every_item_once(n, H, dh, sms):
    for slabs in (1, 2, 3):
        rows, grid = qk_bwd_plan(n, H, dh, sms, slabs)
        assert _kernel_takes(rows, grid, H, dh, sms, slabs)
        walk = qk_bwd_walk(n, H, dh, sms, slabs)
        assert len(walk) == grid and all(tiles for tiles in walk)  # no CTA without a tile
        tiles = np.concatenate([np.asarray(t, np.int64) for t in walk])
        assert np.array_equal(np.sort(tiles), np.arange(-(-n // rows)))
        cover = _group_cover(rows, H, dh)
        count = np.zeros((n, H), np.int64)
        for t in tiles:
            r0 = t * rows
            count[r0:r0 + rows] += cover[:min(rows, n - r0)]
        assert (count == 1).all()
        # the busiest CTA walks at most 1.25 times the rows of one-row
        # tiles over min(2 * sms, n) CTAs, the least any walk could give
        busiest = max(len(t) for t in walk) * rows
        assert busiest <= 1.25 * -(-n // min(CTAS_PER_SM * sms, n))


@pytest.mark.parametrize("name", sorted(k for k, c in MODEL_CONFIGS.items() if c.head_dim in (64, 128)))
def test_plan_fits_the_kernel_for_every_config(name):
    """Every config's q and kv head layouts at the bench trie's n and at a
    long one: within QK_BWD_MAX_WIDTH and a tile the kernel takes."""
    c = MODEL_CONFIGS[name]
    for H in (c.num_attention_heads, c.num_key_value_heads):
        assert H * c.head_dim <= QK_BWD_MAX_WIDTH
        for n in (6656, 131072):
            for slabs in (1, 2, 3):
                assert _kernel_takes(*qk_bwd_plan(n, H, c.head_dim, 132, slabs), H, c.head_dim, 132, slabs)


@functools.lru_cache(maxsize=None)
def _inputs(n, H, dh):
    """fp32 numpy (g, gv [H, n, dh], x [n, H·dh], w [dh], cos, sin [n, dh]);
    cos/sin from the JAX package's rope_tables."""
    rng = np.random.default_rng(n * 1000 + H * 10 + dh)
    g, gv = (rng.standard_normal((H, n, dh), dtype=np.float32) for _ in range(2))
    x = rng.standard_normal((n, H * dh), dtype=np.float32)
    w = 1.0 + 0.1 * rng.standard_normal(dh, dtype=np.float32)
    cos, sin = (np.array(t) for t in jq.rope_tables(jnp.arange(n, dtype=jnp.int32) % 11, dh, 10000.0))
    return g, gv, x, w, cos, sin


def _torch(n, H, dh):
    return tuple(torch.from_numpy(a) for a in _inputs(n, H, dh))


def replay(g, gv, x, w, cos, sin, use_norm, sms, walk=None):
    """K6 (gv None) or K7 as the kernel walks it, in torch at fp32: (dx
    [n, H·dh], dv | None, dw | None). `walk` replaces qk_bwd_walk's (planted
    bugs); a tile no CTA takes leaves its rows of dx 0."""
    H, n, dh = g.shape
    slabs = 1 + int(use_norm) + int(gv is not None)
    rows, _ = qk_bwd_plan(n, H, dh, sms, slabs)
    walk = qk_bwd_walk(n, H, dh, sms, slabs) if walk is None else walk
    dx = torch.zeros(n, H, dh)
    dv = None if gv is None else torch.zeros(n, H, dh)
    parts = torch.zeros(len(walk), dh)
    for c, tiles in enumerate(walk):
        for t in tiles:
            sl = slice(t * rows, min(n, (t + 1) * rows))
            xt = x[sl].reshape(-1, H, dh) if use_norm else None
            dxt, dwt = qp._norm_rope_bwd(g[:, sl].transpose(0, 1), xt, w, cos[sl], sin[sl], EPS, use_norm)
            dx[sl] = dxt
            if gv is not None:
                dv[sl] = gv[:, sl].transpose(0, 1)
            if use_norm:
                parts[c] += dwt
    dw = None
    if use_norm:
        dw = torch.zeros(dh)
        for c0 in range(0, len(walk), QK_DW_GROUP):
            group = torch.zeros(dh)
            for c in range(c0, min(len(walk), c0 + QK_DW_GROUP)):
                group += parts[c]
            dw += group
    return dx.reshape(n, H * dh), None if dv is None else dv.reshape(n, H * dh), dw


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["q", "kv"])
@pytest.mark.parametrize("use_norm", [True, False], ids=["norm", "no_norm"])
@pytest.mark.parametrize("shape", REPLAY_SHAPES, ids=lambda s: f"n{s[0]}_h{s[1]}_dh{s[2]}_sms{s[3]}")
def test_replay_equals_plain(shape, use_norm, kind):
    n, H, dh, sms = shape
    g, gv, x, w, cos, sin = _torch(n, H, dh)
    got = replay(g, gv if kind == "kv" else None, x, w, cos, sin, use_norm, sms)
    if kind == "q":
        dx, dw = qk_prep_bwd_q_plain(g, x, w, cos, sin, EPS, use_norm)
        want = (dx, None, dw)
    else:
        want = qk_prep_bwd_kv_plain(g, gv, x, w, cos, sin, EPS, use_norm)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a, b, PLAIN_TOL)


@functools.lru_cache(maxsize=None)
def _jax_bwd(n, H, dh, use_norm, kind):
    """The JAX ``_bwd_q`` / ``_bwd_kv`` in interpret mode: (dx, dv | None,
    dw | None) as numpy, computed once per module."""
    g, gv, x, w, cos, sin = (jnp.asarray(a) for a in _inputs(n, H, dh))
    if kind == "q":
        dx, dw = jqp._bwd_q(g, x, w, cos, sin, EPS, use_norm, True)
        dv = None
    else:
        dx, dv, dw = jqp._bwd_kv(g, gv, x, w, cos, sin, EPS, use_norm, True)
    return tuple(None if t is None else np.asarray(t) for t in (dx, dv, dw))


@pytest.mark.parametrize("kind", ["q", "kv"])
@pytest.mark.parametrize("use_norm", [True, False], ids=["norm", "no_norm"])
@pytest.mark.parametrize("shape", REPLAY_SHAPES[:2], ids=lambda s: f"n{s[0]}_h{s[1]}_dh{s[2]}_sms{s[3]}")
def test_replay_equals_jax_interpret_kernels(shape, use_norm, kind):
    n, H, dh, sms = shape
    g, gv, x, w, cos, sin = _torch(n, H, dh)
    got = replay(g, gv if kind == "kv" else None, x, w, cos, sin, use_norm, sms)
    want = _jax_bwd(n, H, dh, use_norm, kind)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a, b, FP32_GRAD_TOL)


def _bugged(walk, how):
    """A tile dropped (the last CTA's last tile), or a tile given twice (the
    first CTA's first tile, to the last CTA as well)."""
    walk = [list(t) for t in walk]
    if how == "dropped":
        walk[-1].pop()
    else:
        walk[-1].append(walk[0][0])
    return walk


@pytest.mark.parametrize("how", ["dropped", "twice"])
def test_planted_walk_bugs_move_the_replay(how):
    """Either bug breaks the exactly-once cover. A dropped tile leaves its
    rows of dx at 0 and its terms out of dw; a tile given twice adds its
    terms to dw twice (its dx is written twice with the same values, so
    only dw can show it)."""
    n, H, dh, sms = REPLAY_SHAPES[0]
    g, _, x, w, cos, sin = _torch(n, H, dh)
    bad_walk = _bugged(qk_bwd_walk(n, H, dh, sms, 2), how)
    tiles = sorted(t for ts in bad_walk for t in ts)
    assert tiles != list(range(-(-n // qk_bwd_plan(n, H, dh, sms, 2)[0])))
    dx, dw = qk_prep_bwd_q_plain(g, x, w, cos, sin, EPS, True)
    bdx, _, bdw = replay(g, None, x, w, cos, sin, True, sms, walk=bad_walk)

    def tolerances(bad, want):  # max |bad - want| in units of the JAX suite's grad bar
        return float(((bad - want).abs() / (FP32_GRAD_TOL * (1 + want.abs()))).max())

    assert tolerances(bdw, dw) > 3
    if how == "dropped":
        assert tolerances(bdx, dx) > 3
    else:
        assert torch.equal(bdx, replay(g, None, x, w, cos, sin, True, sms)[0])


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("kind", ["q", "kv"])
def test_launcher_refuses_off_card_tensors_before_loading(monkeypatch, device, kind):
    def load(name):
        raise AssertionError(f"the library {name} was loaded")

    monkeypatch.setattr(qp._build, "load", load)
    n, H, dh = 8, 2, 64
    x = torch.zeros((n, H * dh), dtype=torch.bfloat16, device=device)
    w = torch.ones(dh, dtype=torch.bfloat16, device=device)
    cos = torch.zeros((n, dh), device=device)
    g = torch.zeros((H, n, dh), dtype=torch.bfloat16, device=device)
    name = f"qk_prep_bwd_{kind}"
    with pytest.raises(ValueError, match="CUDA"):
        qp._launch_bwd(name, g, g if kind == "kv" else None, x, w, cos, cos, EPS, True)
