"""The key-major backwards' work list (``tries.build_kmajor_work``): the host
list of live (key tile, q sub-tile) units and its chunks, which K3 and K12
walk on the card (``csrc/tree_attn_bwd_kmajor.cu``).

Coverage is held against an independent derivation of liveness from
``last_desc`` alone; the chunk replay runs the kernel's per-unit arithmetic
in torch at fp32 and sums each split tile's partials in the kernel's part
order: dk/dv equal the plain K12 (``tree_attn_bwd_dkv_plain``) and dq the
plain K11 within fp32 rounding (1e-5 of the largest value: sums in another
order), and ``jax.vjp`` of the JAX dense reference at 5e-5 (the JAX suite's
bar for its backward kernels).
"""

import dataclasses
import functools
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.ops.tree_attention_ref import tree_attention_reference as jax_ref
from dynamictreeattn_tpu_torch.data import synthetic_rollout_batch
from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine
from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS
import dynamictreeattn_tpu_torch.ops.tree_attention  # noqa: F401  (the module)
from dynamictreeattn_tpu_torch.tries import (
    KMajorWork, TokenTrie, build_block_meta, build_kmajor_work, flatten_trie, kmajor_chunk_table,
)

from helpers import random_trie_batch

ta = sys.modules["dynamictreeattn_tpu_torch.ops.tree_attention"]
TILE = 64
GRAD_ATOL = 5e-5


@pytest.fixture(autouse=True)
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
    """The bench trie (bench.py's 1-group batch, n = 6656): 104 key tiles,
    the first ones shared by every sequence."""
    seqs, attachs = synthetic_rollout_batch(seed=0, n_prompts=1, samples_per_prompt=16,
                                            prompt_len=(1024, 2048), completion_len=(128, 512),
                                            branch_prob=0.85)
    trie = TokenTrie(seqs, attachs)
    return flatten_trie(trie, pad_to=EngineConfig().bucket_length(trie.n_tree_tokens))


def _work(packed, hkv, n_slots, block_q=128, block_kv=128):
    meta = build_block_meta(packed.last_desc, block_q, block_kv)
    return meta, build_kmajor_work(packed.last_desc, meta.q_ids, meta.q_counts, meta.q_types,
                                   block_q, block_kv, hkv, n_slots)


def _live_pairs(last_desc):
    """{(key tile, q sub-tile)} with an unmasked pair, from last_desc alone:
    key k is seen by the queries k..last_desc[k]."""
    ld = np.asarray(last_desc)
    live = set()
    for k, last in enumerate(ld.tolist()):
        for sub in range(k // TILE, last // TILE + 1):
            live.add((k // TILE, sub))
    return live


def _on_cpu(work):
    """The work list with its arrays as CPU tensors, as the wrappers take it."""
    return dataclasses.replace(work, units=torch.from_numpy(work.units), chunks=torch.from_numpy(work.chunks))


def _chunk_units(work):
    """[(chunk index, key tile, q sub-tile, partial)] the chunks walk."""
    out = []
    for c, (t, u0, nu, *_rest) in enumerate(work.chunks.tolist()):
        out += [(c, t, (u >> 1) // TILE, u & 1) for u in work.units[u0:u0 + nu].tolist()]
    return out


def _cases():
    return [(f"random{seed}", functools.partial(_random_packed, seed)) for seed in (0, 1, 2)] + [
        ("bench", _bench_packed)]


@pytest.mark.parametrize("hkv,n_slots", [(2, 264), (8, 264), (1, 7)])
@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_work_list_covers_every_live_unit_once(case, hkv, n_slots):
    """Every live (key tile, q sub-tile) pair is walked by exactly one chunk
    (over every group head, so every live (key tile, q sub-tile, group head)
    unit once), no dead pair is walked, and a unit marked full is fully
    unmasked."""
    packed = case[1]()
    _, work = _work(packed, hkv, n_slots)
    walked = [(t, sub) for _, t, sub, _ in _chunk_units(work)]
    assert len(walked) == len(set(walked)) == len(work.units)
    assert set(walked) == _live_pairs(packed.last_desc)
    ld = np.asarray(packed.last_desc)
    for _, t, sub, partial in _chunk_units(work):
        if not partial:
            keys = np.arange(t * TILE, (t + 1) * TILE)[:, None]
            rows = np.arange(sub * TILE, (sub + 1) * TILE)[None, :]
            assert ((keys <= rows) & (rows <= ld[keys])).all(), (t, sub)
    # every key tile has a chunk, so K3/K12 write all of dk/dv
    assert work.n_tiles == len(ld) // TILE
    assert set(work.chunks[:, 0].tolist()) == set(range(work.n_tiles))


@pytest.mark.parametrize("hkv,n_slots", [(2, 264), (8, 264), (1, 7), (2, 1)])
@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
def test_chunks_respect_the_bound_heaviest_first(case, hkv, n_slots):
    """Chunks hold at most ``bound = ceil(hkv * units / slots)`` units and
    come heaviest first; a split tile's chunks are its parts 0..P-1, in unit
    order, with consecutive partial slots and one counter."""
    packed = case[1]()
    _, work = _work(packed, hkv, n_slots)
    chunks = work.chunks
    assert chunks.dtype == np.int32 and chunks.shape[1] == 8 and work.units.dtype == np.int32
    assert work.bound == max(1, -(-hkv * len(work.units) // n_slots))
    assert (chunks[:, 2] <= work.bound).all()
    assert (np.diff(chunks[:, 2]) <= 0).all()
    bases, counters = [], []
    for t in np.unique(chunks[:, 0]):
        mine = chunks[chunks[:, 0] == t]
        mine = mine[np.argsort(mine[:, 4])]
        parts = len(mine)
        assert (mine[:, 5] == parts).all() and (mine[:, 4] == np.arange(parts)).all()
        # the parts tile the key tile's units in order
        assert (mine[1:, 1] == mine[:-1, 1] + mine[:-1, 2]).all()
        if parts == 1:
            assert mine[0, 3] == -1 and mine[0, 6] == -1
        else:
            assert len(set(mine[:, 3].tolist())) == 1 and len(set(mine[:, 6].tolist())) == 1
            bases.append(int(mine[0, 3]))
            counters.append(int(mine[0, 6]))
            assert mine[:, 2].max() - mine[:, 2].min() <= 1  # near-equal parts
    assert sorted(counters) == list(range(work.n_split))
    sizes = {int(r[3]): int(r[5]) for r in chunks if r[5] > 1}
    assert sum(sizes.values()) == work.n_parts
    run = 0
    for base in sorted(bases):
        assert base == run
        run += sizes[base]


def test_bench_trie_split_balances_the_heaviest_tile():
    """The bench trie at Qwen2.5-1.5B's 2 kv heads on an H100's 264 CTA
    slots: 104 tiles, 3363 live pairs, the heaviest tile 103 of them. Before
    the split one CTA walked 103 pairs against a mean of 25.5 per slot;
    after it, no chunk holds more than the bound (26)."""
    _, work = _work(_bench_packed(), 2, 264)
    per_tile = np.bincount(work.chunks[:, 0], weights=work.chunks[:, 2])
    assert len(per_tile) == 104 and len(work.units) == 3363 and per_tile.max() == 103
    assert work.bound == 26 and work.chunks[:, 2].max() == 26
    assert work.n_split > 0 and work.n_parts > work.n_split


def test_chunk_table_rebuilds_a_planted_change():
    """``kmajor_chunk_table`` numbers parts in list order, so a list with a
    chunk dropped or given twice still forms complete fixed-order sums (the
    card's planted work-list bugs rely on it)."""
    table, n_parts, n_split = kmajor_chunk_table([(0, 0, 3), (1, 3, 2), (1, 5, 2), (1, 7, 1)])
    assert (n_parts, n_split) == (3, 1)
    assert table[:, :3].tolist() == [[0, 0, 3], [1, 3, 2], [1, 5, 2], [1, 7, 1]]
    assert table[1:, 3].tolist() == [0, 0, 0] and table[1:, 4].tolist() == [0, 1, 2]
    assert table[0, 3:7].tolist() == [-1, 0, 1, -1]
    twice, n_parts, _ = kmajor_chunk_table([(1, 3, 2), (1, 5, 2), (1, 3, 2)])
    assert n_parts == 3 and sorted(twice[:, 4].tolist()) == [0, 1, 2] and (twice[:, 5] == 3).all()


# ------------------------------------------------------------------ replay


def _replay(q4, k, v, ld, do, lse, di, scale, work):
    """(dq, dk, dv) fp32 by the kernel's walk: per chunk, per unit, per group
    head, the 64 x 64 sub-tile's P and dS (masked on partial units only),
    dV += P^T dO, dK += dS^T Q, dQ += dS K; an unsplit tile's sums written
    directly, a split tile's partials summed in part order."""
    hkv, group, n, dh = q4.shape
    dq = torch.zeros(q4.shape)
    dk, dv = torch.zeros(k.shape), torch.zeros(v.shape)
    ldl = ld.long()
    partials = {}
    for t, u0, nu, _, part, parts, _, _ in work.chunks.tolist():
        kc = slice(t * TILE, (t + 1) * TILE)
        kpos = torch.arange(t * TILE, (t + 1) * TILE)[None, :]
        acc_k, acc_v = torch.zeros((hkv, TILE, dh)), torch.zeros((hkv, TILE, dh))
        for u in work.units[u0:u0 + nu].tolist():
            r0, partial = u >> 1, u & 1
            rows = slice(r0, r0 + TILE)
            qpos = torch.arange(r0, r0 + TILE)[:, None]
            keep = (kpos <= qpos) & (qpos <= ldl[kc][None, :]) if partial else torch.ones(TILE, TILE, dtype=bool)
            for g in range(group):
                s = torch.einsum("hqd,hkd->hqk", q4[:, g, rows], k[:, kc]) * scale
                p = torch.where(keep, torch.exp(s - lse[:, g, rows, None]), 0.0)
                dp = torch.einsum("hqd,hkd->hqk", do[:, g, rows], v[:, kc])
                ds = (dp - di[:, g, rows, None]) * p * scale
                acc_v += torch.einsum("hqk,hqd->hkd", p, do[:, g, rows])
                acc_k += torch.einsum("hqk,hqd->hkd", ds, q4[:, g, rows])
                dq[:, g, rows] += torch.einsum("hqk,hkd->hqd", ds, k[:, kc])
        if parts == 1:
            dk[:, kc], dv[:, kc] = acc_k, acc_v
        else:
            partials.setdefault(t, {})[part] = (acc_k, acc_v)
    for t, got in partials.items():
        kc = slice(t * TILE, (t + 1) * TILE)
        assert sorted(got) == list(range(len(got)))
        sum_k, sum_v = torch.zeros((hkv, TILE, dh)), torch.zeros((hkv, TILE, dh))
        for part in range(len(got)):
            sum_k, sum_v = sum_k + got[part][0], sum_v + got[part][1]
        dk[:, kc], dv[:, kc] = sum_k, sum_v
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def _replay_case(dh, group, hkv=2, n_slots=16):
    """A random trie (seed 3), fp32 inputs from seeded numpy, K2's plain
    (o, lse) and di, and the work list at a small slot count, so that heavy
    tiles split. Returns (work, (q4, k, v, ld, do, lse, di, scale), the
    plain K11/K12 (dq, dk, dv), the JAX dense reference's (dq, dk, dv))."""
    rng = np.random.default_rng(100 + 8 * dh + group)
    packed = _random_packed(3, n_seqs=8, max_len=90)
    n = packed.n_padded
    meta, work = _work(packed, hkv, n_slots)
    q, do = (rng.standard_normal((hkv * group, n, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((hkv, n, dh)).astype(np.float32) for _ in range(2))
    ld = torch.from_numpy(packed.last_desc)
    tm = tuple(torch.from_numpy(a) for a in (meta.kv_ids, meta.kv_counts, meta.kv_types,
                                            meta.q_ids, meta.q_counts, meta.q_types))
    q4, kt, vt = torch.from_numpy(q).reshape(hkv, group, n, dh), torch.from_numpy(k), torch.from_numpy(v)
    do4 = torch.from_numpy(do).reshape(q4.shape)
    scale = dh**-0.5
    o, lse = ta.tree_attn_fwd_plain(q4, kt, vt, ld, *tm[:3], scale, 128, 128)
    inputs = (q4, kt, vt, ld, do4, lse, (do4 * o).sum(-1), scale)
    tail = inputs[4:] + (128, 128)
    plain = (ta.tree_attn_bwd_dq_plain(q4, kt, vt, ld, *tm[:3], *tail),
             *ta.tree_attn_bwd_dkv_plain(q4, kt, vt, ld, *tm[3:], *tail))
    _, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, jnp.asarray(packed.last_desc)), q, k, v)
    want = tuple(np.asarray(w) for w in vjp(jnp.asarray(do)))
    return work, inputs, tm, plain, want


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 6, 7])
def test_chunk_replay_matches_plain_and_jax(dh, group):
    """The kernel's walk over the chunks, with split tiles summed in part
    order, computes the plain K12's dk/dv and the plain K11's dq (fp32
    rounding), and the JAX dense reference's grads."""
    work, inputs, _, plain, want = _replay_case(dh, group)
    assert work.n_split > 0  # the case exercises the fixed-order sum
    got = _replay(*inputs, work)
    for name, g, p, w in zip(("dq", "dk", "dv"), got, plain, want):
        top = float(p.abs().max())
        torch.testing.assert_close(g, p, rtol=0, atol=1e-5 * top, msg=name)
        np.testing.assert_allclose(g.reshape(w.shape).numpy(), w, atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_replay_sees_a_dropped_chunk():
    """The replay is an oracle of the list, not of a hidden dense sum: a
    list without the last chunk of the heaviest tile loses those units' dk
    and dv and leaves every other tile as it was."""
    work, inputs, _, _, _ = _replay_case(64, 2)
    heavy = int(np.argmax(np.bincount(work.chunks[:, 0], weights=work.chunks[:, 2])))
    rows = work.chunks[np.lexsort((work.chunks[:, 4], work.chunks[:, 0]))]
    spans = [tuple(r[:3]) for r in rows.tolist()]
    last = max(i for i, sp in enumerate(spans) if sp[0] == heavy)
    assert sum(sp[0] == heavy for sp in spans) > 1
    table, n_parts, n_split = kmajor_chunk_table(spans[:last] + spans[last + 1:])
    bad = dataclasses.replace(work, chunks=table, n_parts=n_parts, n_split=n_split)
    good, dropped = _replay(*inputs, work), _replay(*inputs, bad)
    kc = slice(heavy * TILE, (heavy + 1) * TILE)
    other = torch.ones(inputs[0].shape[2], dtype=torch.bool)
    other[kc] = False
    for i in (1, 2):
        assert not torch.allclose(dropped[i][:, kc], good[i][:, kc])
        torch.testing.assert_close(dropped[i][:, other], good[i][:, other], rtol=0, atol=0)


# ------------------------------------------------------------ engine, wrappers


@pytest.mark.parametrize("cfg,head_dim,built", [
    (dict(), 64, True),
    (dict(bwd_mode="split"), 128, True),
    (dict(block_q=64, block_kv=64), 64, True),
    (dict(bwd_mode="fused"), 64, True),  # K10 is K3's kernel: it walks the list too
    (dict(block_q=64, block_kv=32), 64, False),  # not a kernel tile multiple: no kernel runs it
    (dict(), 16, False),  # a head_dim the kernels do not take
    (dict(attn_backend="reference"), 64, False),
])
def test_prepare_builds_the_work_list(cfg, head_dim, built, monkeypatch):
    """``prepare`` builds the work list once per batch where the card runs
    K3, K10 or K12, for the model's kv heads, equal to ``build_kmajor_work``
    on the same metadata; on a CPU device the plain versions need none."""
    rng = np.random.default_rng(5)
    seqs, attachs = random_trie_batch(rng, n_seqs=10, vocab=5, max_len=100)
    ec = EngineConfig(**cfg)
    mc = dataclasses.replace(MODEL_CONFIGS["qwen3-tiny"], head_dim=head_dim)
    assert TreeEngine(mc, ec, device="cuda")._wants_kmajor_work() == built
    engine = TreeEngine(mc, ec, device="cpu")
    assert engine.prepare(TokenTrie(seqs, attachs)).kmajor_work is None
    if not built:
        return
    # what prepare uploads on the card, at 264 chunk slots, built here on the CPU
    monkeypatch.setattr(engine, "_wants_kmajor_work", lambda: True)
    monkeypatch.setattr(ta, "kmajor_slots", lambda device, head_dim: 264)
    batch = engine.prepare(TokenTrie(seqs, attachs))
    work = batch.kmajor_work
    assert isinstance(work, KMajorWork)
    meta = build_block_meta(batch.packed.last_desc, ec.block_q, ec.block_kv)
    want = build_kmajor_work(batch.packed.last_desc, meta.q_ids, meta.q_counts, meta.q_types,
                             ec.block_q, ec.block_kv, mc.num_key_value_heads, 264)
    for name in ("units", "chunks"):
        t = getattr(work, name)
        assert isinstance(t, torch.Tensor) and t.dtype == torch.int32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), getattr(want, name))
    assert (work.bound, work.n_parts, work.n_split, work.n_tiles) == (
        want.bound, want.n_parts, want.n_split, want.n_tiles)


@pytest.mark.parametrize("device,bwd_mode,n_meta", [
    ("cuda", "auto", 6), ("cuda", "cached", 6), ("cuda", "fused", 6), ("cuda", "split", 6),
    ("cpu", "auto", 8), ("cpu", "cached", 8), ("cpu", "fused", 6), ("cpu", "split", 6),
])
def test_prepare_builds_the_schedule_for_the_plain_k3_only(device, bwd_mode, n_meta, monkeypatch):
    """The slot schedule (meta[6:8]) is built only where the plain K3
    replays it: a CPU engine's "cached" batch holds 8 meta arrays, a CUDA
    engine's batch 6 in every mode (its K3 takes no schedule). The CUDA
    engine's answer is taken from ``_wants_schedule`` and its batch built
    here on the CPU with that answer."""
    rng = np.random.default_rng(6)
    seqs, attachs = random_trie_batch(rng, n_seqs=6, vocab=5, max_len=60)
    ec = EngineConfig(bwd_mode=bwd_mode)
    mc = MODEL_CONFIGS["qwen3-tiny"]
    wants = TreeEngine(mc, ec, device=device)._wants_schedule()
    engine = TreeEngine(mc, ec, device="cpu")
    monkeypatch.setattr(engine, "_wants_schedule", lambda: wants)
    assert len(engine.prepare(TokenTrie(seqs, attachs)).meta) == n_meta


def test_kmajor_slots(monkeypatch):
    """The card's SMs x CTAs an SM by head_dim (3 at 64, 2 at 128: the
    kernels' launch bounds) x chunks a slot; no slot count without a card."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(multi_processor_count=132))
    assert ta.kmajor_slots("cuda", 64) == 132 * 3 * ta.KMAJOR_CHUNKS_PER_SLOT
    assert ta.kmajor_slots("cuda:0", 128) == 132 * 2 * ta.KMAJOR_CHUNKS_PER_SLOT
    with pytest.raises(ValueError, match="CUDA"):
        ta.kmajor_slots("cpu", 128)


def test_kmajor_work_from_tensors_equals_numpy(monkeypatch):
    monkeypatch.setattr(ta, "kmajor_slots", lambda device, head_dim: 264)
    packed = _random_packed(1)
    meta, want = _work(packed, 2, 264)
    got = ta.kmajor_work(torch.from_numpy(packed.last_desc), torch.from_numpy(meta.q_ids),
                         torch.from_numpy(meta.q_counts), torch.from_numpy(meta.q_types), 128, 128, 2,
                         128, "cpu")
    np.testing.assert_array_equal(got.chunks.numpy(), want.chunks)
    np.testing.assert_array_equal(got.units.numpy(), want.units)
    assert got.n_tiles == want.n_tiles == packed.n_padded // TILE


def test_work_list_needs_kernel_tiles():
    packed = _random_packed(0, block=32)
    meta = build_block_meta(packed.last_desc, 32, 32)
    with pytest.raises(ValueError, match="tile"):
        build_kmajor_work(packed.last_desc, meta.q_ids, meta.q_counts, meta.q_types, 32, 32, 2, 264)


@pytest.mark.parametrize("breakage,err", [
    (lambda w: "not a work list", TypeError),
    (lambda w: _on_cpu(_work(_bench_packed(), 2, 264)[1]), ValueError),  # built for another trie
    (lambda w: dataclasses.replace(w, chunks=w.chunks.long()), TypeError),
    (lambda w: dataclasses.replace(w, units=w.units.reshape(1, -1)), TypeError),
    (lambda w: dataclasses.replace(w, chunks=w.chunks[:, :7].contiguous()), ValueError),
    (lambda w: dataclasses.replace(w, chunks=w.chunks.t().contiguous().t()), ValueError),
    (lambda w: dataclasses.replace(w, units=w.units.numpy()), TypeError),
])
def test_work_input_checks(breakage, err):
    """What the key-major wrappers refuse of a work list, among them one
    built for a trie of another length, whose key tiles would lie outside
    dk/dv or leave some of them unwritten."""
    packed = _random_packed(2)
    _, work = _work(packed, 2, 264)
    good, n = _on_cpu(work), packed.n_padded
    ta._check_work(good, torch.device("cpu"), n)
    with pytest.raises(err):
        ta._check_work(breakage(good), torch.device("cpu"), n)


def test_kmajor_launch_needs_a_work_list():
    """On the card the wrappers take the work list ``prepare`` built; given
    none, the launcher raises before it builds one per call."""
    work, (q4, k, v, ld, do, lse, di, scale), tm, _, _ = _replay_case(64, 2)
    bf = [t.to(torch.bfloat16) for t in (q4, k, v, do)]
    for name in ("tree_attn_bwd_dkv", "tree_attn_bwd_cached"):
        with pytest.raises(ValueError, match="work list"):
            ta._launch_kmajor(name, *bf[:3], ld, *tm[3:], bf[3], lse, di, scale, 128, 128, None)


def test_key_major_wrappers_on_cpu_are_the_plain_versions():
    """Given a work list, the CPU wrappers still run the plain versions (the
    list is the card's schedule of the same function)."""
    work, (q4, k, v, ld, *tail), tm, _, _ = _replay_case(64, 2)
    tail = (*tail, 128, 128)
    for a, b in zip(ta.tree_attn_bwd_dkv(q4, k, v, ld, *tm[3:], *tail, work=_on_cpu(work)),
                    ta.tree_attn_bwd_dkv_plain(q4, k, v, ld, *tm[3:], *tail)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
