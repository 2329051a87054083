"""The walks of the two tree-attention backwards of "split" and "fused" on
the card.

K11 (``tree_attn_bwd_dq``, ``csrc/tree_attn_bwd.cu``) walks the forward's
query-major list (``tries.build_qmajor_work``); K10 (``tree_attn_bwd_fused``)
is K3's key-major kernel (``csrc/tree_attn_bwd_kmajor.cu``) over
``tries.build_kmajor_work``, entered with no slot schedule. A wrong list
shows only on the card, where the wrappers launch the kernels; here the
replays run each kernel's walk in torch at fp32 -- listed sub-tiles only,
the mask on partial sub-tiles only, P in the kernels' exp2 form
2^(S*scale*log2 e - lse*log2 e) -- and are held against the plain versions,
the JAX package's Pallas kernels in interpret mode (``_bwd_dq``,
``_bwd_fused``) and ``jax.vjp`` of its dense reference, at 5e-5 (the JAX
suite's bar for its backward kernels). The JAX references are computed once
per module.
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.ops.tree_attention import BlockSizes as JaxBlockSizes
from dynamictreeattn_tpu.ops.tree_attention import _bwd_dq as jax_bwd_dq
from dynamictreeattn_tpu.ops.tree_attention import _bwd_fused as jax_bwd_fused
from dynamictreeattn_tpu.ops.tree_attention_ref import tree_attention_reference as jax_ref
from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine
from dynamictreeattn_tpu_torch.engine import tree_engine as te
from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS
import dynamictreeattn_tpu_torch.ops.tree_attention  # noqa: F401  (the module)
from dynamictreeattn_tpu_torch.tries import (
    TokenTrie, build_block_meta, build_kmajor_work, build_qmajor_work, flatten_trie,
)

from helpers import random_trie_batch

ta = sys.modules["dynamictreeattn_tpu_torch.ops.tree_attention"]
TILE = 64
BLOCK = 128
ATOL = 5e-5
LOG2E = 1.4426950408889634
HKV = 2
# (head_dim, group): Llama-3.2-1B, Qwen2.5-0.5B, Qwen3-0.6B, Llama-3.2-3B, Qwen2.5-1.5B
PAIRS = [(64, 4), (64, 7), (128, 2), (128, 3), (128, 6)]
PAIR_IDS = [f"dh{dh}-g{g}" for dh, g in PAIRS]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The replays run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _case(dh, group):
    """A random trie (seed 3, n = 384 with padding rows), fp32 inputs from
    seeded numpy, K2's plain (o, lse) and di; the block metadata, both work
    lists (the key-major one at 16 chunk slots, so that heavy tiles split)
    and the torch tensors of the inputs."""
    rng = np.random.default_rng(300 + 8 * dh + group)
    seqs, attachs = random_trie_batch(np.random.default_rng(3), n_seqs=8, vocab=5, max_len=90)
    trie = TokenTrie(seqs, attachs)
    packed = flatten_trie(trie, pad_to=BLOCK * (trie.n_tree_tokens // BLOCK + 1))
    n = packed.n_padded
    meta = build_block_meta(packed.last_desc, BLOCK, BLOCK)
    qwork = build_qmajor_work(packed.last_desc, meta.kv_ids, meta.kv_counts, meta.kv_types, BLOCK, BLOCK)
    kwork = build_kmajor_work(packed.last_desc, meta.q_ids, meta.q_counts, meta.q_types, BLOCK, BLOCK, HKV, 16)
    q, do = (rng.standard_normal((HKV * group, n, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((HKV, n, dh)).astype(np.float32) for _ in range(2))
    q4 = torch.from_numpy(q).reshape(HKV, group, n, dh)
    kt, vt, do4 = torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(do).reshape(HKV, group, n, dh)
    ld = torch.from_numpy(packed.last_desc)
    tm = tuple(torch.from_numpy(a) for a in (meta.kv_ids, meta.kv_counts, meta.kv_types))
    scale = dh**-0.5
    o, lse = ta.tree_attn_fwd_plain(q4, kt, vt, ld, *tm, scale, BLOCK, BLOCK)
    di = (do4 * o).sum(-1)
    return packed, meta, qwork, kwork, (q4, kt, vt, ld, do4, lse, di, scale), tm


@functools.lru_cache(maxsize=None)
def _jax(dh, group):
    """The JAX references, once per (dh, group): dq of ``_bwd_dq`` and (dq,
    dk, dv) of ``_bwd_fused`` in interpret mode on the same lse and di, and
    (dq, dk, dv) of ``jax.vjp`` of the dense reference."""
    packed, meta, _, _, (q4, k, v, _, do, lse, di, scale), _ = _case(dh, group)
    n = q4.shape[2]
    jargs = (jnp.asarray(q4.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
             jnp.asarray(packed.last_desc).reshape(1, n),
             *(jnp.asarray(a) for a in (meta.kv_ids, meta.kv_counts, meta.kv_types)))
    jtail = (jnp.asarray(do.numpy()), jnp.asarray(lse.numpy()), jnp.asarray(di.numpy()), scale,
             JaxBlockSizes(BLOCK, BLOCK), True)
    dq_kernel = np.asarray(jax_bwd_dq(*jargs, *jtail))
    fused = tuple(np.asarray(t) for t in jax_bwd_fused(*jargs, *jtail))
    q3, do3 = (t.reshape(HKV * group, n, dh).numpy() for t in (q4, do))
    _, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, jnp.asarray(packed.last_desc)), q3, k.numpy(), v.numpy())
    dense = tuple(np.asarray(t) for t in vjp(jnp.asarray(do3)))
    return dq_kernel, fused, dense


def _p_ds(q4, k, v, do, lse, di, scale, rows, keys, ld, partial):
    """(p, ds) fp32 [hkv, g, 64, 64] of one sub-tile as the kernels compute
    them: p = 2^(s*scale*log2 e - lse*log2 e), 0 off the mask on a partial
    sub-tile only; ds = (dp - di) * p * scale."""
    s = torch.einsum("hgqd,hkd->hgqk", q4[:, :, rows], k[:, keys])
    p = torch.exp2(s * (scale * LOG2E) - lse[:, :, rows, None] * LOG2E)
    if partial:
        qpos = torch.arange(rows.start, rows.stop)[:, None]
        kpos = torch.arange(keys.start, keys.stop)[None, :]
        p = torch.where((kpos <= qpos) & (qpos <= ld.long()[keys][None, :]), p, 0.0)
    dp = torch.einsum("hgqd,hkd->hgqk", do[:, :, rows], v[:, keys])
    return p, (dp - di[:, :, rows, None]) * p * scale


def _replay_dq(q4, k, v, ld, do, lse, di, scale, work):
    """dq fp32 by K11's walk: per q tile, its listed sub-tiles in list order;
    a tile with no entry keeps dq = 0."""
    dq = torch.zeros(q4.shape)
    for r0, e0, cnt in work.tiles.tolist():
        rows = slice(r0, r0 + TILE)
        for e in work.entries[e0:e0 + cnt].tolist():
            keys = slice(e >> 1, (e >> 1) + TILE)
            _, ds = _p_ds(q4, k, v, do, lse, di, scale, rows, keys, ld, e & 1)
            dq[:, :, rows] += torch.einsum("hgqk,hkd->hgqd", ds, k[:, keys])
    return dq


def _replay_fused(q4, k, v, ld, do, lse, di, scale, work):
    """(dq, dk, dv) fp32 by K10's walk, the key-major walk of K3 with no
    schedule: per chunk, per unit, all group heads at once, dV += P^T dO,
    dK += dS^T Q, dQ += dS K; an unsplit tile's sums written directly, a
    split tile's partials summed in part order."""
    hkv, group, n, dh = q4.shape
    dq, dk, dv = torch.zeros(q4.shape), torch.zeros(k.shape), torch.zeros(v.shape)
    partials = {}
    for t, u0, nu, _, part, parts, _, _ in work.chunks.tolist():
        keys = slice(t * TILE, (t + 1) * TILE)
        acc_k, acc_v = torch.zeros((hkv, TILE, dh)), torch.zeros((hkv, TILE, dh))
        for u in work.units[u0:u0 + nu].tolist():
            rows = slice(u >> 1, (u >> 1) + TILE)
            p, ds = _p_ds(q4, k, v, do, lse, di, scale, rows, keys, ld, u & 1)
            acc_v += torch.einsum("hgqk,hgqd->hkd", p, do[:, :, rows])
            acc_k += torch.einsum("hgqk,hgqd->hkd", ds, q4[:, :, rows])
            dq[:, :, rows] += torch.einsum("hgqk,hkd->hgqd", ds, k[:, keys])
        if parts == 1:
            dk[:, keys], dv[:, keys] = acc_k, acc_v
        else:
            partials.setdefault(t, {})[part] = (acc_k, acc_v)
    for t, got in partials.items():
        keys = slice(t * TILE, (t + 1) * TILE)
        assert sorted(got) == list(range(len(got)))
        for part in range(len(got)):
            dk[:, keys] += got[part][0]
            dv[:, keys] += got[part][1]
    return dq, dk, dv


@pytest.mark.parametrize("dh,group", PAIRS, ids=PAIR_IDS)
def test_dq_replay_matches_plain_and_jax(dh, group):
    """K11's walk over the forward's list computes the plain K11's dq, the
    JAX ``_bwd_dq`` in interpret mode and the dq of ``jax.vjp`` of the JAX
    dense reference."""
    _, _, qwork, _, inputs, tm = _case(dh, group)
    dq = _replay_dq(*inputs, qwork)
    plain = ta.tree_attn_bwd_dq_plain(*inputs[:4], *tm, *inputs[4:], BLOCK, BLOCK)
    torch.testing.assert_close(dq, plain, rtol=0, atol=ATOL)
    want_kernel, _, want_dense = _jax(dh, group)
    np.testing.assert_allclose(dq.numpy(), want_kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(dq.reshape(want_dense[0].shape).numpy(), want_dense[0], atol=ATOL, rtol=0)


@pytest.mark.parametrize("dh,group", PAIRS, ids=PAIR_IDS)
def test_fused_replay_matches_plain_and_jax(dh, group):
    """K10's key-major walk with dq and no schedule computes the plain K10
    (the TPU kernel's query-major pass), the JAX ``_bwd_fused`` in interpret
    mode and ``jax.vjp`` of the JAX dense reference."""
    _, _, _, kwork, inputs, tm = _case(dh, group)
    assert kwork.n_split > 0  # the case exercises the fixed-order sum
    got = _replay_fused(*inputs, kwork)
    plain = ta.tree_attn_bwd_fused_plain(*inputs[:4], *tm, *inputs[4:], BLOCK, BLOCK)
    _, want_kernel, want_dense = _jax(dh, group)
    for name, g, p, wk, wd in zip(("dq", "dk", "dv"), got, plain, want_kernel, want_dense):
        torch.testing.assert_close(g, p, rtol=0, atol=ATOL, msg=name)
        np.testing.assert_allclose(g.numpy(), wk, atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(g.reshape(wd.shape).numpy(), wd, atol=ATOL, rtol=0, err_msg=name)


def _planted(work, how):
    """(the forward's list with one planted bug, the heaviest tile's first
    row): "drop" leaves out the heaviest tile's last sub-tile (its diagonal
    one), "unmask" marks its diagonal sub-tile full."""
    tiles, entries = work.tiles.copy(), work.entries.copy()
    r0, e0, cnt = tiles[0].tolist()
    diag = e0 + int(np.nonzero((entries[e0:e0 + cnt] >> 1) == r0)[0][0])
    assert diag == e0 + cnt - 1 and entries[diag] & 1
    if how == "drop":
        tiles[0, 2] = cnt - 1
    else:
        entries[diag] &= ~1
    return dataclasses.replace(work, tiles=tiles, entries=entries), r0


@pytest.mark.parametrize("how", ["drop", "unmask"])
def test_planted_qmajor_bugs_move_dq(how):
    """The replay is an oracle of the list: each planted bug moves dq of the
    heaviest tile's rows by at least 3 tolerances, and no other row."""
    _, _, qwork, _, inputs, _ = _case(128, 3)
    good = _replay_dq(*inputs, qwork)
    bad_work, r0 = _planted(qwork, how)
    bad = _replay_dq(*inputs, bad_work)
    rows = torch.zeros(good.shape[2], dtype=torch.bool)
    rows[r0:r0 + TILE] = True
    assert float((bad[:, :, rows] - good[:, :, rows]).abs().max()) >= 3 * ATOL
    torch.testing.assert_close(bad[:, :, ~rows], good[:, :, ~rows], rtol=0, atol=0)


# ---------------------------------------------------------- wrappers, engine


def _bf16_case():
    _, _, qwork, kwork, (q4, k, v, ld, do, lse, di, scale), tm = _case(64, 4)
    q4, k, v, do = (t.to(torch.bfloat16) for t in (q4, k, v, do))
    return qwork, kwork, (q4, k, v, ld), tm, (do, lse, di, scale, BLOCK, BLOCK)


def _torch_qwork(work):
    return dataclasses.replace(work, tiles=torch.from_numpy(work.tiles), entries=torch.from_numpy(work.entries))


def _torch_kwork(work):
    return dataclasses.replace(work, chunks=torch.from_numpy(work.chunks), units=torch.from_numpy(work.units))


def test_k11_launch_refuses_a_missing_or_wrong_list():
    """K11 on the card takes the forward's list that ``prepare`` built:
    given none, or one built for another length, its launcher raises
    before it builds or loads anything."""
    qwork, _, args, tm, tail = _bf16_case()
    with pytest.raises(ValueError, match="work list"):
        ta._launch_dq(*args, *tm, *tail, None)
    chain = np.full(BLOCK, BLOCK - 1, dtype=np.int32)  # one sequence of BLOCK tokens
    meta = build_block_meta(chain, BLOCK, BLOCK)
    short = build_qmajor_work(chain, meta.kv_ids, meta.kv_counts, meta.kv_types, BLOCK, BLOCK)
    with pytest.raises(ValueError, match="q tiles"):
        ta._launch_dq(*args, *tm, *tail, _torch_qwork(short))
    with pytest.raises(TypeError, match="QMajorWork"):
        ta._launch_dq(*args, *tm, *tail, _torch_kwork(_bf16_case()[1]))
    assert _torch_qwork(qwork).n_tiles == args[0].shape[2] // TILE


def test_k10_launch_refuses_a_missing_or_wrong_list():
    """K10 on the card takes the key-major list: given none, or a
    query-major one, its launcher raises before it builds or loads
    anything; the metadata it checks is the query-major one its plain
    version reads."""
    qwork, _, args, tm, tail = _bf16_case()
    with pytest.raises(ValueError, match="work list"):
        ta._launch_kmajor("tree_attn_bwd_fused", *args, *tm, *tail, None, key_major=False)
    with pytest.raises(TypeError, match="KMajorWork"):
        ta._launch_kmajor("tree_attn_bwd_fused", *args, *tm, *tail, _torch_qwork(qwork), key_major=False)


def test_wrappers_on_cpu_are_the_plain_versions():
    """On CPU tensors K11 and K10 run their plain versions and need no list."""
    _, _, args, tm, tail = _bf16_case()
    torch.testing.assert_close(ta.tree_attn_bwd_dq(*args, *tm, *tail),
                               ta.tree_attn_bwd_dq_plain(*args, *tm, *tail), rtol=0, atol=0)
    for g, w in zip(ta.tree_attn_bwd_fused(*args, *tm, *tail), ta.tree_attn_bwd_fused_plain(*args, *tm, *tail)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("bwd_mode,name,kind", [("split", "tree_attn_bwd_dq", "qmajor"),
                                                ("fused", "tree_attn_bwd_fused", "kmajor")])
def test_backward_passes_its_work_list(bwd_mode, name, kind, monkeypatch):
    """``tree_attention``'s backward hands K11 the query-major list and K10
    the key-major one (the lists the engine's batch carries)."""
    _, _, args, tm, _ = _bf16_case()
    packed, meta, *_ = _case(64, 4)
    lists = {"qmajor": object(), "kmajor": object()}
    seen = []
    real = getattr(ta, name)
    monkeypatch.setattr(ta, name, lambda *a: seen.append(a[-1]) or real(*a[:-1]))
    q, k, v = (t.clone().requires_grad_() for t in (args[0].reshape(-1, *args[0].shape[2:]), args[1], args[2]))
    tq = tuple(torch.from_numpy(a) for a in (meta.q_ids, meta.q_counts, meta.q_types))
    o = ta.tree_attention(q, k, v, args[3], *tm, *tq, block_sizes=ta.BlockSizes(BLOCK, BLOCK),
                          bwd_mode=bwd_mode, qmajor_work=lists["qmajor"], kmajor_work=lists["kmajor"])
    o.float().sum().backward()
    assert seen == [lists[kind]]


def test_card_batch_without_schedule_keeps_cached(monkeypatch):
    """A batch on the card holds no slot schedule and keeps "cached" (K3's
    kernel takes none); only a CPU batch without one is sent to "fused" (as
    ``test_batch_without_schedule_takes_fused`` shows)."""
    engine = TreeEngine(MODEL_CONFIGS["qwen3-tiny"], EngineConfig(), device="cpu")
    seen = {}
    monkeypatch.setattr(te, "tree_attention", lambda *a, **kw: seen.update(kw))
    for device, want in (("meta", "cached"), ("cpu", "fused")):
        batch = te.TrieBatch(packed=None, tokens=None, depth=None, parent=None,
                             last_desc=torch.zeros(64, dtype=torch.int32, device=device), w_logprob=None,
                             w_entropy=None, valid=None, meta=(None,) * 6)
        engine._attn_fn(batch)(None, None, None)
        assert seen["bwd_mode"] == want and seen["cache_sched"] is None
