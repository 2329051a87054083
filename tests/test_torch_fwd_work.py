"""The tree-attention forwards' work list (``tries.build_qmajor_work``): the
host list of live (q tile, key sub-tile) entries, flagged full or partial,
that K1 and K2 walk on the card (``csrc/tree_attn_fwd.cu``), and the
device-side choice between them.

Coverage is held against liveness derived from ``last_desc`` alone and
against the transpose of the key-major backwards' units; the full flag
against the mask, pair by pair. The replay runs the kernel's walk in torch
at fp32 (per q tile, its entries in list order, the mask on partial entries
only, 64-key sub-tiles): o and lse equal the plain K1/K2
(``tree_attn_fwd_plain``, 128-key blocks: the running maxima differ, so
fp32 rounding only) and the JAX blocked simulator (the JAX suite's CPU
stand-in for its Pallas forwards) within 2e-5, the JAX suite's bar.
"""

import dataclasses
import functools
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamictreeattn_tpu.ops.tree_attention  # noqa: F401  (the module)
from dynamictreeattn_tpu.ops.tree_attention_sim import tree_attention_blocked_sim
from dynamictreeattn_tpu.tries import build_block_meta as jax_build_block_meta
from dynamictreeattn_tpu_torch.data import synthetic_rollout_batch
from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine
from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS
from dynamictreeattn_tpu_torch.ops import _build
import dynamictreeattn_tpu_torch.ops.tree_attention  # noqa: F401  (the module)
from dynamictreeattn_tpu_torch.ops.tree_attention_ref import tree_mask
from dynamictreeattn_tpu_torch.tries import (
    QMajorWork, TokenTrie, build_block_meta, build_kmajor_work, build_qmajor_work, flatten_trie,
)

from helpers import random_trie_batch

ta = sys.modules["dynamictreeattn_tpu_torch.ops.tree_attention"]
jta = sys.modules["dynamictreeattn_tpu.ops.tree_attention"]
TILE = 64
ATOL = 2e-5
HKV = 2
# (head_dim, group): Llama-3.2-1B, Qwen2.5-0.5B, Qwen3-0.6B, Llama-3.2-3B, Qwen2.5-1.5B
PAIRS = [(64, 4), (64, 7), (128, 2), (128, 3), (128, 6)]
PAIR_IDS = [f"dh{dh}-g{g}" for dh, g in PAIRS]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The replay runs many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_packed(seed, n_seqs=10, max_len=100, block=128):
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=n_seqs, vocab=5, max_len=max_len)
    trie = TokenTrie(seqs, attachs)
    return flatten_trie(trie, pad_to=block * (trie.n_tree_tokens // block + 1))


@functools.lru_cache(maxsize=None)
def _bench_packed():
    """The bench trie (bench.py's 1-group batch, n = 6656): 104 q tiles."""
    seqs, attachs = synthetic_rollout_batch(seed=0, n_prompts=1, samples_per_prompt=16,
                                            prompt_len=(1024, 2048), completion_len=(128, 512),
                                            branch_prob=0.85)
    trie = TokenTrie(seqs, attachs)
    return flatten_trie(trie, pad_to=EngineConfig().bucket_length(trie.n_tree_tokens))


def _cases():
    return [(f"random{seed}", functools.partial(_random_packed, seed)) for seed in (0, 1, 2)] + [
        ("bench", _bench_packed)]


@functools.lru_cache(maxsize=None)
def _work(case_name, block_q=128, block_kv=128):
    packed = dict(_cases())[case_name]()
    meta = build_block_meta(packed.last_desc, block_q, block_kv)
    work = build_qmajor_work(packed.last_desc, meta.kv_ids, meta.kv_counts, meta.kv_types, block_q, block_kv)
    return packed, meta, work


def _entries(work):
    """[(q tile, key tile, partial)] in the order the kernel walks them."""
    out = []
    for r0, e0, cnt in work.tiles.tolist():
        out += [(r0 // TILE, (e >> 1) // TILE, e & 1) for e in work.entries[e0:e0 + cnt].tolist()]
    return out


def _live_pairs(last_desc):
    """{(q tile, key tile)} holding an unmasked pair, from last_desc alone:
    key k is seen by the queries k..last_desc[k]."""
    live = set()
    for k, last in enumerate(np.asarray(last_desc).tolist()):
        for sub in range(k // TILE, last // TILE + 1):
            live.add((sub, k // TILE))
    return live


CASE_IDS = [name for name, _ in _cases()]


@pytest.mark.parametrize("case", CASE_IDS)
def test_qmajor_list_covers_every_live_pair_once(case):
    """Every live (q tile, key sub-tile) pair is listed exactly once and no
    dead one; every q tile has its row."""
    packed, _, work = _work(case)
    pairs = [(qt, kt) for qt, kt, _ in _entries(work)]
    assert len(pairs) == len(set(pairs)) == len(work.entries)
    assert set(pairs) == _live_pairs(packed.last_desc)
    assert work.n_tiles == packed.n_padded // TILE
    assert sorted(work.tiles[:, 0].tolist()) == list(range(0, packed.n_padded, TILE))
    assert work.entries.dtype == np.int32 and work.tiles.dtype == np.int32


@pytest.mark.parametrize("case", CASE_IDS)
def test_qmajor_list_is_the_kmajor_units_transposed(case):
    """The forward's entries and the key-major backwards' units hold the
    same (q tile, key tile) pairs."""
    packed, meta, work = _work(case)
    km = build_kmajor_work(packed.last_desc, meta.q_ids, meta.q_counts, meta.q_types, 128, 128, 2, 264)
    units = set()
    for t, u0, nu, *_ in km.chunks.tolist():
        units |= {((u >> 1) // TILE, t) for u in km.units[u0:u0 + nu].tolist()}
    assert {(qt, kt) for qt, kt, _ in _entries(work)} == units


@pytest.mark.parametrize("case", CASE_IDS)
def test_full_flag_is_exact(case):
    """An entry is full exactly when every pair of its 64 x 64 sub-tile is
    unmasked (k <= q <= last_desc[k]); else partial."""
    packed, _, work = _work(case)
    ld = np.asarray(packed.last_desc)
    for qt, kt, partial in _entries(work):
        keys = np.arange(kt * TILE, (kt + 1) * TILE)[:, None]
        rows = np.arange(qt * TILE, (qt + 1) * TILE)[None, :]
        assert bool(((keys <= rows) & (rows <= ld[keys])).all()) == (not partial), (qt, kt)


@pytest.mark.parametrize("case", CASE_IDS)
def test_tiles_come_heaviest_first(case):
    """Tiles are ordered by their entry count, most first, ties in row
    order; each tile's entries are contiguous and in slot order."""
    _, _, work = _work(case)
    counts = work.tiles[:, 2]
    assert (np.diff(counts) <= 0).all()
    for a, b in zip(work.tiles[:-1].tolist(), work.tiles[1:].tolist()):
        if a[2] == b[2]:
            assert a[0] < b[0]
    by_row = work.tiles[np.argsort(work.tiles[:, 0])]
    assert (by_row[1:, 1] == by_row[:-1, 1] + by_row[:-1, 2]).all() and by_row[0, 1] == 0
    for r0, e0, cnt in work.tiles.tolist():
        keys = (work.entries[e0:e0 + cnt] >> 1).tolist()
        assert keys == sorted(keys)


def test_bench_trie_list_shape():
    """The bench trie: 104 q tiles, 3363 live pairs (as many as the
    key-major list's units), 2691 of them full; the heaviest tile walks 50
    sub-tiles, the lightest 1."""
    _, _, work = _work("bench")
    assert work.n_tiles == 104 and len(work.entries) == 3363
    assert int((work.entries & 1 == 0).sum()) == 2691
    assert work.tiles[0, 2] == 50 and work.tiles[-1, 2] == 1


def test_qmajor_list_needs_kernel_tiles():
    packed = _random_packed(0, block=32)
    meta = build_block_meta(packed.last_desc, 32, 32)
    with pytest.raises(ValueError, match="tile"):
        build_qmajor_work(packed.last_desc, meta.kv_ids, meta.kv_counts, meta.kv_types, 32, 32)


# ------------------------------------------------------------------ replay


def _replay(q4, k, v, ld, work, scale, c=None):
    """(o, lse) by the kernel's walk: per q tile, its entries in list order,
    64 x 64 score sub-tiles masked on partial entries only; the bound
    variant (`c`) shifts by C, the online one keeps running maxima; P is
    rounded to v's dtype before the PV product."""
    hkv, group, n, dh = q4.shape
    o = torch.empty(q4.shape, dtype=q4.dtype)
    lse = torch.empty((hkv, group, n))
    ldl = ld.long()
    for r0, e0, cnt in work.tiles.tolist():
        rows = slice(r0, r0 + TILE)
        qpos = torch.arange(r0, r0 + TILE)[:, None]
        qf = q4[:, :, rows].float()
        m = torch.full((hkv, group, TILE, 1), float("-inf"))
        l_ = torch.zeros((hkv, group, TILE, 1))
        acc = torch.zeros((hkv, group, TILE, dh))
        for e in work.entries[e0:e0 + cnt].tolist():
            c0, partial = e >> 1, e & 1
            keys = slice(c0, c0 + TILE)
            s = torch.einsum("hgqd,hkd->hgqk", qf, k[:, keys].float()) * scale
            if partial:
                kpos = torch.arange(c0, c0 + TILE)[None, :]
                keep = (kpos <= qpos) & (qpos <= ldl[keys][None, :])
                s = s + torch.where(keep, 0.0, ta.MASK_VALUE)
            if c is not None:
                p = torch.exp(s - c[:, :, rows, None])
                alpha = 1.0
                l_ = l_ + p.sum(-1, keepdim=True)
            else:
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l_ = alpha * l_ + p.sum(-1, keepdim=True)
                m = m_new
            acc = acc * alpha + torch.einsum("hgqk,hkd->hgqd", p.to(v.dtype).float(), v[:, keys].float())
        inv = torch.where(l_ == 0.0, 1.0, 1.0 / l_)
        o[:, :, rows] = (acc * inv).to(q4.dtype)
        base = c[:, :, rows] if c is not None else m[..., 0]
        lse[:, :, rows] = base + torch.log(torch.clamp(l_[..., 0], min=1e-30))
    return o, lse


@functools.lru_cache(maxsize=None)
def _replay_case(dh, group):
    """A random trie (seed 3, padding rows included), fp32 q/k/v from seeded
    numpy, its metadata and work list."""
    rng = np.random.default_rng(200 + 8 * dh + group)
    packed = _random_packed(3, n_seqs=8, max_len=90)
    n = packed.n_padded
    meta = build_block_meta(packed.last_desc, 128, 128)
    work = build_qmajor_work(packed.last_desc, meta.kv_ids, meta.kv_counts, meta.kv_types, 128, 128)
    q = rng.standard_normal((HKV * group, n, dh)).astype(np.float32)
    k, v = (rng.standard_normal((HKV, n, dh)).astype(np.float32) for _ in range(2))
    return packed, meta, work, (q, k, v)


@functools.lru_cache(maxsize=None)
def _jax_sim(dh, group, mode):
    packed, _, _, (q, k, v) = _replay_case(dh, group)
    return np.asarray(tree_attention_blocked_sim(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), packed.last_desc,
        jax_build_block_meta(packed.last_desc, 128, 128), softmax_mode=mode))


def _torch_inputs(dh, group):
    packed, meta, work, (q, k, v) = _replay_case(dh, group)
    n = q.shape[1]
    q4 = torch.from_numpy(q).reshape(HKV, group, n, dh)
    tm = tuple(torch.from_numpy(a) for a in (meta.kv_ids, meta.kv_counts, meta.kv_types))
    return packed, work, q4, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(packed.last_desc), tm


@pytest.mark.parametrize("dh,group", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("mode", ["online", "bound"])
def test_replay_matches_plain_and_jax(mode, dh, group):
    """The kernel's walk over the list computes the plain K1 (bound) / K2
    (online) and the JAX blocked simulator's o, and the plain lse."""
    packed, work, q4, k, v, ld, tm = _torch_inputs(dh, group)
    scale = dh**-0.5
    c = ta._score_bound(q4, k, scale) if mode == "bound" else None
    o, lse = _replay(q4, k, v, ld, work, scale, c)
    o_p, lse_p = ta.tree_attn_fwd_plain(q4, k, v, ld, *tm, scale, 128, 128, c=c)
    torch.testing.assert_close(o, o_p, rtol=0, atol=ATOL)
    torch.testing.assert_close(lse, lse_p, rtol=0, atol=ATOL)
    n = q4.shape[2]
    np.testing.assert_allclose(o.reshape(HKV * group, n, dh).numpy(), _jax_sim(dh, group, mode), atol=ATOL,
                               rtol=0)
    s = torch.einsum("hgqd,hkd->hgqk", q4, k) * scale
    s = s.masked_fill(~tree_mask(ld)[None, None], float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1), rtol=0, atol=ATOL)


def _planted(work, how):
    """The list with one planted bug: "drop" leaves out the heaviest tile's
    last entry, "unmask" marks its first partial entry full."""
    tiles, entries = work.tiles.copy(), work.entries.copy()
    r0, e0, cnt = tiles[0].tolist()
    if how == "drop":
        tiles[0, 2] = cnt - 1
    else:
        i = e0 + int(np.nonzero(entries[e0:e0 + cnt] & 1)[0][0])
        entries[i] &= ~1
    return dataclasses.replace(work, tiles=tiles, entries=entries), r0


@pytest.mark.parametrize("how", ["drop", "unmask"])
def test_replay_sees_planted_list_bugs(how):
    """The replay is an oracle of the list: a planted bug moves o on the
    heaviest tile's rows only."""
    _, work, q4, k, v, ld, _ = _torch_inputs(128, 2)
    good = _replay(q4, k, v, ld, work, 128**-0.5)[0]
    bad_work, r0 = _planted(work, how)
    bad = _replay(q4, k, v, ld, bad_work, 128**-0.5)[0]
    rows = torch.zeros(q4.shape[2], dtype=torch.bool)
    rows[r0:r0 + TILE] = True
    assert (bad[:, :, rows] - good[:, :, rows]).abs().max() > 0.05
    torch.testing.assert_close(bad[:, :, ~rows], good[:, :, ~rows], rtol=0, atol=0)


# ------------------------------------------------------- dispatch, wrappers


@pytest.mark.parametrize("q_scale,bound", [(1.0, True), (64.0, False)], ids=["below40", "above40"])
def test_dispatch_on_cpu_chooses_as_lax_cond(q_scale, bound, monkeypatch):
    """On the CPU ``_fwd_dispatch`` in "bound" mode runs the plain version of
    the branch the JAX package's ``lax.cond`` takes, ``max(C) <
    BOUND_SAFE_MAX`` from the JAX ``_score_bound`` of the same inputs, and
    its o equals the JAX blocked simulator's in that mode."""
    packed, work, q4, k, v, ld, tm = _torch_inputs(64, 4)
    q4 = q4 * q_scale
    scale = 64**-0.5
    jax_bound = bool(jnp.max(jta._score_bound(jnp.asarray(q4.numpy()), jnp.asarray(k.numpy()), scale))
                     < jta.BOUND_SAFE_MAX)
    assert jax_bound == bound and ta.BOUND_SAFE_MAX == jta.BOUND_SAFE_MAX
    taken = []
    for name in ("tree_attn_fwd_bound", "tree_attn_fwd_online"):
        real = getattr(ta, name)
        monkeypatch.setattr(ta, name, lambda *a, _real=real, _name=name, **kw: (taken.append(_name),
                                                                               _real(*a, **kw))[1])
    o, _ = ta._fwd_dispatch(q4, k, v, ld, *tm, scale, ta.BlockSizes(128, 128), "bound", work)
    assert taken == ["tree_attn_fwd_bound" if jax_bound else "tree_attn_fwd_online"]
    n = q4.shape[2]
    want = np.asarray(tree_attention_blocked_sim(
        jnp.asarray(q4.reshape(-1, n, 64).numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        packed.last_desc, jax_build_block_meta(packed.last_desc, 128, 128),
        softmax_mode="bound" if jax_bound else "online"))
    np.testing.assert_allclose(o.reshape(-1, n, 64).numpy(), want, atol=ATOL * q_scale, rtol=0)


def _on_cpu(work):
    return dataclasses.replace(work, tiles=torch.from_numpy(work.tiles),
                               entries=torch.from_numpy(work.entries))


@pytest.mark.parametrize("breakage,err", [
    (lambda w: "not a work list", TypeError),
    (lambda w: _on_cpu(_work("random0")[2]), ValueError),  # built for another trie
    (lambda w: dataclasses.replace(w, tiles=w.tiles.long()), TypeError),
    (lambda w: dataclasses.replace(w, entries=w.entries.reshape(1, -1)), TypeError),
    (lambda w: dataclasses.replace(w, tiles=w.tiles[:, :2].contiguous()), ValueError),
    (lambda w: dataclasses.replace(w, tiles=w.tiles.t().contiguous().t()), ValueError),
    (lambda w: dataclasses.replace(w, entries=w.entries.numpy()), TypeError),
], ids=["type", "length", "dtype", "dims", "width", "strides", "numpy"])
def test_qmajor_work_input_checks(breakage, err):
    """What the forward wrappers refuse of a work list on the card, among
    them one built for a trie of another length, whose q tiles would lie
    outside o or leave some of it unwritten."""
    _, work, q4, *_ = _torch_inputs(64, 4)
    good, n = _on_cpu(work), q4.shape[2]
    assert n != _work("random0")[0].n_padded
    ta._check_qwork(good, torch.device("cpu"), n)
    with pytest.raises(err):
        ta._check_qwork(breakage(good), torch.device("cpu"), n)


@pytest.mark.parametrize("branch", [ta.FWD_ONLINE, ta.FWD_BOUND, ta.FWD_BY_FLAG])
def test_forward_launch_needs_a_work_list(branch):
    """On the card the forward takes the list ``prepare`` built; given none,
    the launcher raises before it builds or loads anything."""
    _, _, q4, k, v, ld, tm = _torch_inputs(64, 4)
    bf = [t.to(torch.bfloat16) for t in (q4, k, v)]
    c = ta._score_bound(bf[0], bf[1], 0.125)
    with pytest.raises(ValueError, match="work list"):
        ta._launch(branch, *bf, ld, *tm, 0.125, 128, 128, c, None, flag=torch.tensor(True))


def test_forward_wrappers_on_cpu_are_the_plain_versions():
    """On CPU tensors K1/K2 run their plain versions and need no list."""
    _, _, q4, k, v, ld, tm = _torch_inputs(64, 4)
    c = ta._score_bound(q4, k, 0.125)
    for got, want in ((ta.tree_attn_fwd_bound(q4, k, v, ld, *tm, 0.125, 128, 128, c),
                       ta.tree_attn_fwd_plain(q4, k, v, ld, *tm, 0.125, 128, 128, c=c)),
                      (ta.tree_attn_fwd_online(q4, k, v, ld, *tm, 0.125, 128, 128),
                       ta.tree_attn_fwd_plain(q4, k, v, ld, *tm, 0.125, 128, 128))):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_branch_record_decoding(monkeypatch):
    """``_build.launches`` and ``fwd_branches`` read the forward's counts
    and its branches in launch order from the device record, the ring's last
    RECORD_CAP of them once it wraps; a reset zeroes the counts."""
    monkeypatch.setattr(_build, "_RECORDS", {})
    rec = _build.branch_record("cpu")
    assert rec.shape == (2 + _build.RECORD_CAP,) and rec.dtype == torch.int32
    assert _build.branch_record("cpu") is rec
    branches = [1, 1, 0, 1, 0]
    rec[0], rec[1] = len(branches), sum(branches)
    rec[2:2 + len(branches)] = torch.tensor(branches, dtype=torch.int32)
    counts = _build.launches()
    assert counts["tree_attn_fwd_bound"] == 3 and counts["tree_attn_fwd_online"] == 2
    assert _build.fwd_branches() == [_build.FWD_BRANCHES[b] for b in branches]
    cap = _build.RECORD_CAP
    rec[0] = cap + 2  # two launches past the ring: launch cap and cap + 1 overwrote slots 0 and 1
    assert len(_build.fwd_branches()) == cap
    assert _build.fwd_branches()[-2:] == [_build.FWD_BRANCHES[b] for b in branches[:2]]
    _build.reset_launches()
    assert _build.launches()["tree_attn_fwd_bound"] == 0 and _build.fwd_branches() == []


@pytest.mark.parametrize("name", ["tree_attn_fwd", "tree_attn_bwd_kmajor", "tree_attn_bwd"])
def test_library_name_follows_the_shared_header(name, tmp_path, monkeypatch):
    """The Hopper sources share ``csrc/hopper.cuh``: a library is named by a
    hash of its source and that header, so an edit to either rebuilds it,
    and an edit to another source does not."""
    for f in _build.CSRC.glob("*.cu*"):
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build._sources(tmp_path / f"{name}.cu", {})] == [f"{name}.cu", "hopper.cuh"]
    before = _build._lib_path(name)
    other = tmp_path / "decode_attn.cu"
    other.write_bytes(other.read_bytes() + b"\n")
    assert _build._lib_path(name) == before
    header = tmp_path / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    assert _build._lib_path(name) != before


@pytest.mark.parametrize("cfg,head_dim,built", [
    (dict(), 128, True),
    (dict(bwd_mode="fused"), 64, True),  # the forward runs K1/K2 whatever the backward
    (dict(block_q=64, block_kv=32), 64, False),  # not a kernel tile multiple
    (dict(), 16, False),  # a head_dim the kernels do not take
    (dict(attn_backend="reference"), 64, False),
])
def test_prepare_builds_the_qmajor_list(cfg, head_dim, built, monkeypatch):
    """``prepare`` builds the forward's list once per batch where the card
    runs K1/K2, equal to ``build_qmajor_work`` on the same metadata; on a CPU
    device the plain versions need none."""
    rng = np.random.default_rng(5)
    seqs, attachs = random_trie_batch(rng, n_seqs=10, vocab=5, max_len=100)
    ec = EngineConfig(**cfg)
    mc = dataclasses.replace(MODEL_CONFIGS["qwen3-tiny"], head_dim=head_dim)
    assert TreeEngine(mc, ec, device="cuda")._wants_qmajor_work() == built
    engine = TreeEngine(mc, ec, device="cpu")
    assert engine.prepare(TokenTrie(seqs, attachs)).qmajor_work is None
    if not built:
        return
    monkeypatch.setattr(engine, "_wants_qmajor_work", lambda: True)
    batch = engine.prepare(TokenTrie(seqs, attachs))
    work = batch.qmajor_work
    assert isinstance(work, QMajorWork)
    meta = build_block_meta(batch.packed.last_desc, ec.block_q, ec.block_kv)
    want = build_qmajor_work(batch.packed.last_desc, meta.kv_ids, meta.kv_counts, meta.kv_types,
                             ec.block_q, ec.block_kv)
    for name in ("tiles", "entries"):
        t = getattr(work, name)
        assert isinstance(t, torch.Tensor) and t.dtype == torch.int32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), getattr(want, name))
    assert work.n_tiles == want.n_tiles == batch.n_padded // TILE
