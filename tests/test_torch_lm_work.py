"""The LM-head kernels' walks (``ops/lm_stats.py``): K8's unit list
(``lm_fwd_plan`` / ``lm_fwd_units``: 128-row tiles x splits of 256-column
vocab tiles, partials merged in split order) and K9's list of output tiles
(``lm_bwd_units``), replayed in torch at fp32 as the kernels run them
(``csrc/lm_stats_fwd.cu``, ``csrc/lm_stats_bwd.cu``).

The K8 replay folds each unit's tiles in the log2 domain, rescaling only
when a row's maximum moves, and merges the splits in order; the K9 replay
forms dl per 128 x 256 tile (rounded to hidden's dtype) and sums every
output tile over 64-deep chunks in order. Both equal the plain versions
(``lm_stats_plain``, ``lm_stats_bwd_plain``) and the JAX kernels in
interpret mode within 2e-5, the suite's fp32 bar (the same sums in other
orders, values of magnitude <= ~10); two bugs planted in the K8 walk move
lse by hundreds of tolerances.
"""

import functools
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.ops.lm_stats import lm_stats as jax_lm_stats
from dynamictreeattn_tpu.ops.lm_stats import lm_stats_bwd as jax_lm_stats_bwd
from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS
import dynamictreeattn_tpu_torch.ops.lm_stats  # noqa: F401  (the module)
from dynamictreeattn_tpu_torch.ops.lm_stats import (
    lm_bwd_units, lm_fwd_plan, lm_fwd_units, lm_kernel_takes, lm_stats_bwd_plain, lm_stats_plain,
)

lm = sys.modules["dynamictreeattn_tpu_torch.ops.lm_stats"]  # ops/__init__ exports a function of that name
ATOL = 2e-5
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
N, V, TEMP = 200, 691, 0.7  # ragged n (128-row tiles) and V (256-column tiles: 2 full + 179)
DEPTHS = [64, 128, 192]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The replays run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _inputs(d):
    rng = np.random.default_rng(d)
    hidden = rng.standard_normal((N, d)).astype(np.float32)
    w_lm = (rng.standard_normal((d, V)) * d**-0.5 * 3).astype(np.float32)
    g_lse = rng.standard_normal(N).astype(np.float32)
    g_ent = rng.standard_normal(N).astype(np.float32)
    return hidden, w_lm, g_lse, g_ent


@functools.lru_cache(maxsize=None)
def _fwd_refs(d):
    """(plain (lse, mean_x), JAX K8 in interpret mode (lse, mean_x))."""
    hidden, w_lm, _, _ = _inputs(d)
    plain = lm_stats_plain(torch.from_numpy(hidden), torch.from_numpy(w_lm), 1 / TEMP)
    jx = jax_lm_stats(jnp.asarray(hidden), jnp.asarray(w_lm), 1 / TEMP, interpret=True)
    return tuple(t.numpy() for t in plain), tuple(np.asarray(t) for t in jx)


def _merge(m, se, sx, m2, se2, sx2):
    mm = torch.maximum(m, m2)
    empty = mm == float("-inf")
    a = torch.where(empty, 0.0, torch.exp2(m - mm))
    b = torch.where(empty, 0.0, torch.exp2(m2 - mm))
    return mm, se * a + se2 * b, sx * a + sx2 * b


def replay_fwd(hidden, w_lm, inv_temp, sms, drop=None, twice=None):
    """K8 as the kernel walks it, in torch: (lse, mean_x). `drop`: a unit
    never computed; `twice`: a split merged twice (planted bugs)."""
    n, V_ = hidden.shape[0], w_lm.shape[1]
    S, _, _ = lm_fwd_plan(n, V_, sms)
    c2 = inv_temp * LOG2E
    parts = torch.zeros(S, 3, n)
    parts[:, 0] = float("-inf")
    for units in lm_fwd_units(n, V_, sms):
        for unit in units:
            if unit == drop:
                continue
            r, s, t0, t1 = unit
            rows = slice(r * lm.BLOCK_ROWS, min(n, (r + 1) * lm.BLOCK_ROWS))
            h = hidden[rows]
            m = torch.full((h.shape[0],), float("-inf"))
            se, sx = torch.zeros_like(m), torch.zeros_like(m)
            for t in range(t0, t1):
                x2 = (h @ w_lm[:, t * lm.BLOCK_V:(t + 1) * lm.BLOCK_V]) * c2  # columns >= V not there
                mt = x2.amax(1)
                moved = mt > m
                sc = torch.exp2(m - mt)  # 0 while m = -inf
                se, sx, m = torch.where(moved, se * sc, se), torch.where(moved, sx * sc, sx), torch.maximum(m, mt)
                p = torch.exp2(x2 - m[:, None])
                se, sx = se + p.sum(1), sx + (p * x2).sum(1)
            parts[s, 0, rows], parts[s, 1, rows], parts[s, 2, rows] = m, se, sx
    m = torch.full((n,), float("-inf"))
    se, sx = torch.zeros(n), torch.zeros(n)
    for s in list(range(S)) + ([] if twice is None else [twice]):
        m, se, sx = _merge(m, se, sx, *parts[s])
    return m * LN2 + torch.log(se), sx * LN2 / se


def replay_bwd(hidden, w_lm, lse, mean_x, g_lse, g_ent, inv_temp):
    """K9 as the kernel runs it, in torch: dl per 128 x 256 logits tile into
    the padded scratch, then every output tile of ``lm_bwd_units`` summed
    over its 64-deep chunks in order. (dhidden, dWT)."""
    n, d = hidden.shape
    V_ = w_lm.shape[1]
    n_pad, V_pad = -(-n // 128) * 128, -(-V_ // 128) * 128
    a = (g_lse + g_ent * mean_x)[:, None]
    b = g_ent[:, None]
    dl = torch.zeros(n_pad, V_pad)
    R, NT = -(-n // lm.BLOCK_ROWS), -(-V_ // lm.BLOCK_V)
    for u in range(R * NT):
        rows = slice((u % R) * lm.BLOCK_ROWS, min(n, (u % R + 1) * lm.BLOCK_ROWS))
        cols = slice((u // R) * lm.BLOCK_V, min(V_, (u // R + 1) * lm.BLOCK_V))
        acc = hidden[rows] @ w_lm[:, cols]
        p = torch.exp2(acc * (inv_temp * LOG2E) - lse[rows, None] * LOG2E)
        dl[rows, cols] = (p * (a[rows] - b[rows] * acc * inv_temp) * inv_temp).to(hidden.dtype)
    hp, wp = torch.zeros(n_pad, d), torch.zeros(V_pad, d)
    hp[:n], wp[:V_] = hidden, w_lm.t()
    dh, dwT = torch.full((n, d), float("nan")), torch.full((V_, d), float("nan"))
    for kind, m0, n0, nk in lm_bwd_units(n, d, V_):
        acc = torch.zeros(lm.BLOCK_ROWS, min(d, n0 + lm.BLOCK_V) - n0)
        for kc in range(nk):
            k = slice(kc * lm.BLOCK_K, (kc + 1) * lm.BLOCK_K)
            if kind == "dh":
                acc += dl[m0:m0 + lm.BLOCK_ROWS, k] @ wp[k, n0:n0 + lm.BLOCK_V]
            else:
                acc += dl[k, m0:m0 + lm.BLOCK_ROWS].t() @ hp[k, n0:n0 + lm.BLOCK_V]
        out = dh if kind == "dh" else dwT
        rows = min(out.shape[0], m0 + lm.BLOCK_ROWS) - m0
        out[m0:m0 + rows, n0:n0 + acc.shape[1]] = acc[:rows]
    return dh, dwT


@pytest.mark.parametrize("sms", [132, 3])
@pytest.mark.parametrize("d", DEPTHS)
def test_fwd_replay_matches_plain_and_jax(d, sms):
    hidden, w_lm, _, _ = _inputs(d)
    S, T, grid = lm_fwd_plan(N, V, sms)
    assert S > 1 or sms == 132  # 3 SMs: more than one split to merge
    lse, mean_x = replay_fwd(torch.from_numpy(hidden), torch.from_numpy(w_lm), 1 / TEMP, sms)
    plain, jx = _fwd_refs(d)
    for got, want in ((lse, plain[0]), (mean_x, plain[1]), (lse, jx[0]), (mean_x, jx[1])):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("d", DEPTHS)
def test_bwd_replay_matches_plain_and_jax(d):
    hidden, w_lm, g_lse, g_ent = (torch.from_numpy(a) for a in _inputs(d))
    lse, mean_x = (torch.from_numpy(t) for t in _fwd_refs(d)[0])
    dh, dwT = replay_bwd(hidden, w_lm, lse, mean_x, g_lse, g_ent, 1 / TEMP)
    want = lm_stats_bwd_plain(hidden, w_lm, lse, mean_x, g_lse, g_ent, 1 / TEMP)
    jx = jax_lm_stats_bwd(*(jnp.asarray(t.numpy()) for t in (hidden, w_lm, lse, mean_x, g_lse, g_ent)),
                          1 / TEMP, block_v=128, interpret=True)
    for got, p, j in ((dh, want[0], jx[0]), (dwT, want[1], jx[1])):
        assert torch.isfinite(got).all()  # every output tile written
        np.testing.assert_allclose(got.numpy(), p.numpy(), atol=ATOL, rtol=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("bug", ["unit dropped", "split merged twice"])
def test_planted_walk_bugs_move_lse(bug):
    hidden, w_lm, _, _ = (torch.from_numpy(a) for a in _inputs(128))
    units = lm_fwd_units(N, V, 3)
    kw = {"drop": units[-1][-1]} if bug == "unit dropped" else {"twice": 0}
    lse, _ = replay_fwd(hidden, w_lm, 1 / TEMP, 3, **kw)
    moved = float((lse - torch.from_numpy(_fwd_refs(128)[0][0])).abs().max())
    assert moved > 100 * ATOL


def _coverage(n, V_, sms):
    S, T, grid = lm_fwd_plan(n, V_, sms)
    R, NT = -(-n // 128), -(-V_ // 256)
    units = lm_fwd_units(n, V_, sms)
    assert len(units) == grid <= sms and S == -(-NT // T)
    seen = {}
    for cta, walk in enumerate(units):
        for r, s, t0, t1 in walk:
            assert (t0, t1) == (s * T, min(NT, (s + 1) * T))
            for t in range(t0, t1):
                assert (r, t) not in seen
                seen[r, t] = (cta, s)
    assert set(seen) == {(r, t) for r in range(R) for t in range(NT)}
    return S, T, units


@pytest.mark.parametrize("n,V_,sms", [(6656, 151936, 132), (6656, 151936, 114), (37888, 151936, 132),
                                      (6606, 151859, 78), (6606, 179, 132), (N, V, 3), (1, 1, 132)])
def test_fwd_units_cover_every_tile_once(n, V_, sms):
    S, T, units = _coverage(n, V_, sms)
    # each row tile's splits appear once each, and the walk is a fixed function
    per_row = {}
    for walk in units:
        for r, s, _, _ in walk:
            per_row.setdefault(r, []).append(s)
    assert all(sorted(ss) == list(range(S)) for ss in per_row.values())
    assert units == lm_fwd_units(n, V_, sms)
    # the busiest CTA runs within 2% of the fewest tiles any T could give it
    busiest = max(sum(t1 - t0 for _, _, t0, t1 in walk) for walk in units)
    R, NT = -(-n // 128), -(-V_ // 256)
    least = min(-(-R * -(-NT // t) // sms) * t for t in range(1, NT + 1))
    assert busiest <= least * 1.02 + 1


@pytest.mark.parametrize("n,d,V_", [(6656, 1024, 151936), (6606, 896, 151859), (N, 192, V)])
def test_bwd_units_cover_every_output_tile_once(n, d, V_):
    units = lm_bwd_units(n, d, V_)
    kinds = [u[0] for u in units]
    assert kinds == sorted(kinds, key=lambda k: k != "dh")  # the long dhidden tiles first
    n_pad, V_pad = -(-n // 128) * 128, -(-V_ // 128) * 128
    for kind, rows, depth in (("dh", n_pad, V_pad // 64), ("dwT", V_pad, n_pad // 64)):
        tiles = [(m0, n0) for k, m0, n0, nk in units if k == kind]
        assert all(nk == depth for k, _, _, nk in units if k == kind)
        assert sorted(tiles) == [(m0, n0) for m0 in range(0, rows, 128) for n0 in range(0, d, 256)]


@pytest.mark.parametrize("d,V_", sorted({(c.hidden_size, c.vocab_size) for c in MODEL_CONFIGS.values()}))
def test_kernels_take_every_model_config(d, V_):
    assert lm_kernel_takes(d, V_)


@pytest.mark.parametrize("d,V_", [(1000, 151936), (32, 151936), (0, 151936), (1024, 0)])
def test_kernels_refuse(d, V_):
    assert not lm_kernel_takes(d, V_)


def test_wrapper_checks_refuse_before_launch():
    """The kernel wrappers' input checks (run on the card before a launch)
    refuse a hidden size the kernels do not take, and fp32 inputs."""
    with pytest.raises(ValueError, match="does not take hidden size 1000"):
        lm._head_rows(torch.zeros(4, 1000, dtype=torch.bfloat16), torch.zeros(1000, 7, dtype=torch.bfloat16), "K8")
    with pytest.raises(TypeError, match="bf16"):
        lm._head_rows(torch.zeros(4, 128), torch.zeros(128, 7), "K8")
