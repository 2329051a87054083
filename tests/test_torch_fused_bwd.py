"""The port's fused tree-attention backwards — K3 ("cached", with the Belady
slot schedule) and K10 ("fused") — in their plain versions, against the
JAX package.

All at fp32 on the CPU, inputs from seeded numpy. Gradients through the
``_TreeAttention`` autograd function: 5e-5 absolute against ``jax.vjp`` of
the JAX dense reference (the JAX suite's own bar for its backward kernels,
tests/test_tree_attention.py). The opt-in interpret test holds the plain
K3/K10 against the JAX kernels themselves at the JAX suite's 2e-5.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.ops.tree_attention_ref import tree_attention_reference as jax_ref
import dynamictreeattn_tpu_torch.ops.tree_attention  # noqa: F401  (the module)
from dynamictreeattn_tpu_torch.tries import (
    BwdCacheSched, TokenTrie, build_block_meta, build_bwd_cache_sched, flatten_trie,
)

from helpers import random_packed, random_trie_batch

ta = sys.modules["dynamictreeattn_tpu_torch.ops.tree_attention"]
GRAD_ATOL = 5e-5
HKV, DH = 2, 16


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain loops run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _grad_case(seed, block, hq):
    """A random trie (padding rows included) with metadata whose slot rows
    are padded to the worst case, so type-0 slots sit beside type-1/2 ones;
    fp32 q/k/v and a cotangent for o from seeded numpy; and the JAX dense
    reference's (o, dq, dk, dv) by ``jax.vjp``."""
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=10, vocab=5, max_len=100)
    trie = TokenTrie(seqs, attachs)
    n_pad = 64 * (trie.n_tree_tokens // 64 + 1)
    packed = flatten_trie(trie, pad_to=n_pad)
    nblk = n_pad // block
    meta = build_block_meta(packed.last_desc, block, block, min_kv_slots=nblk, min_q_slots=nblk)
    q, do = (rng.standard_normal((hq, n_pad, DH)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((HKV, n_pad, DH)).astype(np.float32) for _ in range(2))
    ld = jnp.asarray(packed.last_desc)
    want_o, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, ld), *map(jnp.asarray, (q, k, v)))
    want = tuple(np.asarray(w) for w in (want_o, *vjp(jnp.asarray(do))))
    return packed, meta, (q, k, v, do), want


def _torch_meta(meta):
    return tuple(torch.from_numpy(a) for a in (meta.kv_ids, meta.kv_counts, meta.kv_types,
                                                meta.q_ids, meta.q_counts, meta.q_types))


def _grads(packed, meta, arrays, block, mode, bwd_mode, cache_sched=None):
    q, k, v, do = arrays
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = ta.tree_attention(qt, kt, vt, torch.from_numpy(packed.last_desc), *_torch_meta(meta),
                          block_sizes=ta.BlockSizes(block, block), softmax_mode=mode,
                          bwd_mode=bwd_mode, cache_sched=cache_sched)
    return o, torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))


def _assert_matches(o, got, want):
    np.testing.assert_allclose(o.detach().numpy(), want[0], atol=1e-4, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want[1:]):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("hq", [4, 2])  # GQA group 2 and 1
@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("mode", ["online", "bound"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_backward_matches_jax_reference_grads(seed, mode, block, hq):
    """dq, dk, dv of ``tree_attention(bwd_mode="fused")`` (the plain K10
    behind the autograd function) equal ``jax.vjp`` of the JAX dense
    reference."""
    packed, meta, arrays, want = _grad_case(seed, block, hq)
    assert {0, 1, 2} <= set(np.unique(meta.kv_types).tolist())
    o, got = _grads(packed, meta, arrays, block, mode, "fused")
    _assert_matches(o, got, want)


@pytest.mark.parametrize("n_slots", [1, 2, 3, 8])
@pytest.mark.parametrize("hq", [4, 2])
@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("mode", ["online", "bound"])
@pytest.mark.parametrize("seed", [0, 1])
def test_cached_backward_matches_jax_reference_grads(seed, mode, block, hq, n_slots):
    """The same through ``bwd_mode="cached"``: the plain K3 replays the
    Belady schedule at R slots (evictions and reloads at the small R, see
    the next test); the schedule is passed once as a ``BwdCacheSched`` and
    once as an ``(actions, flush)`` pair."""
    packed, meta, arrays, want = _grad_case(seed, block, hq)
    sched = build_bwd_cache_sched(meta, n_slots)
    given = sched if hq == 4 else (sched.actions, sched.flush)
    o, got = _grads(packed, meta, arrays, block, mode, "cached", given)
    _assert_matches(o, got, want)


@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_small_slot_counts_evict_and_reload(seed, block):
    """The cases above exercise the cache: at R = 1 and 2 the schedule both
    evicts and reloads, at R = 3 and 8 it still evicts; R = n_kv_blocks
    (the CUDA K3's geometry) does neither."""
    _, meta, _, _ = _grad_case(seed, block, 4)
    for r in (1, 2, 3, 8):
        acts = build_bwd_cache_sched(meta, r).actions
        assert (acts[..., 3] >= 0).any(), r
        assert r > 2 or (acts[..., 2] == 1).any(), r
    full = build_bwd_cache_sched(meta, ta.cached_bwd_geometry(meta.q_ids.shape[0]))
    assert not (full.actions[..., 3] >= 0).any() and not (full.actions[..., 2] == 1).any()
    assert full.flush[:, 1].all()


def _plain_inputs(seed=2, block=32, n_slots=2):
    packed, meta, (q, k, v, do), _ = _grad_case(seed, block, 4)
    n = q.shape[1]
    q4 = torch.from_numpy(q).reshape(HKV, 2, n, DH)
    kt, vt, ld = torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(packed.last_desc)
    o, lse = ta.tree_attn_fwd_plain(q4, kt, vt, ld, *_torch_meta(meta)[:3], DH**-0.5, block, block)
    dot = torch.from_numpy(do).reshape(q4.shape)
    sched = build_bwd_cache_sched(meta, n_slots)
    return ((q4, kt, vt, ld), _torch_meta(meta), (dot, lse, (dot * o).sum(-1), DH**-0.5, block, block),
            tuple(torch.from_numpy(a) for a in (sched.actions, sched.flush)))


def test_fused_wrappers_on_cpu_are_the_plain_versions():
    args, meta, tail, sched = _plain_inputs()
    for a, b in zip(ta.tree_attn_bwd_fused(*args, *meta[:3], *tail),
                    ta.tree_attn_bwd_fused_plain(*args, *meta[:3], *tail)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(ta.tree_attn_bwd_cached(*args, *meta, *sched, *tail),
                    ta.tree_attn_bwd_cached_plain(*args, *meta[:3], *sched, *tail)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cached_and_fused_equal_split_in_plain_versions():
    """All three backwards compute the same function: at fp32 the fused
    pass sums each pair's partials in the split kernels' order."""
    args, meta, tail, sched = _plain_inputs(seed=3, block=16, n_slots=3)
    split = (ta.tree_attn_bwd_dq_plain(*args, *meta[:3], *tail),
             *ta.tree_attn_bwd_dkv_plain(*args, *meta[3:], *tail))
    for got in (ta.tree_attn_bwd_fused_plain(*args, *meta[:3], *tail),
                ta.tree_attn_bwd_cached_plain(*args, *meta[:3], *sched, *tail)):
        for a, b in zip(got, split):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_cached_replays_the_schedule():
    """A schedule that drops one eviction leaves the evicted block's sum
    lost: the plain K3 reads the slot actions, not a hidden dense sum."""
    args, meta, tail, (acts, flush) = _plain_inputs(n_slots=1)
    good = ta.tree_attn_bwd_cached_plain(*args, *meta[:3], acts, flush, *tail)
    bad_acts = acts.clone()
    i, s = (int(x) for x in torch.nonzero(acts[..., 3] >= 0)[0])
    bad_acts[i, s, 3] = -1
    bad = ta.tree_attn_bwd_cached_plain(*args, *meta[:3], bad_acts, flush, *tail)
    torch.testing.assert_close(bad[0], good[0], rtol=0, atol=0)  # dq does not use the cache
    assert not torch.isfinite(bad[1]).all() or not torch.allclose(bad[1], good[1])


def test_cached_needs_a_schedule():
    packed, meta, (q, k, v, _), _ = _grad_case(0, 32, 4)
    with pytest.raises(ValueError, match="cache_sched"):
        ta.tree_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(packed.last_desc), *_torch_meta(meta),
                          block_sizes=ta.BlockSizes(32, 32), bwd_mode="cached")


@pytest.mark.parametrize("breakage,err", [
    (lambda a, f: (a.long(), f), TypeError),  # int64 actions
    (lambda a, f: (a, f.long()), TypeError),  # int64 flush
    (lambda a, f: (a[:-1].contiguous(), f), ValueError),  # one q block short
    (lambda a, f: (a[..., :3].contiguous(), f), ValueError),  # 3 fields
    (lambda a, f: (a, f[:0]), ValueError),  # no slot
    (lambda a, f: (a, f[:, :1].contiguous()), ValueError),  # flush without the valid flag
])
def test_cache_schedule_input_checks(breakage, err):
    """What K3's wrapper refuses of a schedule, on the CPU as on the card."""
    args, meta, tail, (acts, flush) = _plain_inputs()
    ta._check_sched(acts, flush, meta[0], args[0].device)  # the well-formed case passes
    bad = breakage(acts, flush)
    with pytest.raises(err):
        ta._check_sched(*bad, meta[0], args[0].device)
    with pytest.raises(err):
        ta.tree_attn_bwd_cached(*args, *meta, *bad, *tail)


def test_schedule_types():
    _, meta, _, _ = _grad_case(1, 16, 4)
    sched = build_bwd_cache_sched(meta, 0)  # clamped to one slot
    assert isinstance(sched, BwdCacheSched) and sched.n_slots == 1
    assert sched.actions.dtype == np.int32 and sched.flush.dtype == np.int32
    assert sched.actions.shape == meta.kv_ids.shape + (4,) and sched.flush.shape == (1, 2)
    assert ta.cached_bwd_geometry(0) == 1 and ta.cached_bwd_geometry(52) == 52


@pytest.mark.skipif(
    not os.environ.get("RUN_INTERPRET"),
    reason="Pallas interpret-mode compile is minutes-slow; opt in with RUN_INTERPRET=1",
)
def test_plain_fused_bwds_match_jax_kernels_interpret():
    """The plain K3 and K10 against the JAX ``_bwd_cached`` / ``_bwd_fused``
    in the TPU-semantics interpreter, at the JAX suite's shapes
    (tests/test_tree_attention.py: block 32, n 128, dh 32, group 2), on a
    trie (seed 1) whose one-slot schedule both evicts and reloads."""
    from dynamictreeattn_tpu.ops.tree_attention import BlockSizes, _bwd_cached, _bwd_fused
    from dynamictreeattn_tpu.tries import build_bwd_cache_sched as jax_sched

    rng = np.random.default_rng(1)
    block, n, dh, hq, hkv = 32, 128, 32, 4, 2
    _, _, packed, jmeta = random_packed(rng, n, block, n_seqs=8, max_len=30)
    q4, k, v, do = (rng.standard_normal(s).astype(np.float32)
                    for s in ((hkv, hq // hkv, n, dh), (hkv, n, dh), (hkv, n, dh), (hkv, hq // hkv, n, dh)))
    meta = build_block_meta(packed.last_desc, block, block, min_kv_slots=n // block,
                            min_q_slots=n // block)
    tm = _torch_meta(meta)
    ld = torch.from_numpy(packed.last_desc)
    o, lse = ta.tree_attn_fwd_plain(torch.from_numpy(q4), torch.from_numpy(k), torch.from_numpy(v),
                                    ld, *tm[:3], dh**-0.5, block, block)
    di = (torch.from_numpy(do) * o).sum(-1)
    sched = build_bwd_cache_sched(meta, 1)
    js = jax_sched(jmeta, 1)
    np.testing.assert_array_equal(sched.actions, js.actions)
    assert (sched.actions[..., 3] >= 0).any() and (sched.actions[..., 2] == 1).any()
    args = tuple(map(torch.from_numpy, (q4, k, v))) + (ld,)
    tail = (torch.from_numpy(do), lse, di, dh**-0.5, block, block)
    acts, flush = torch.from_numpy(sched.actions), torch.from_numpy(sched.flush)
    got = {"fused": ta.tree_attn_bwd_fused_plain(*args, *tm[:3], *tail),
           "cached": ta.tree_attn_bwd_cached_plain(*args, *tm[:3], acts, flush, *tail)}
    jargs = (jnp.asarray(q4), jnp.asarray(k), jnp.asarray(v), jnp.asarray(packed.last_desc).reshape(1, n),
             *(jnp.asarray(a) for a in (meta.kv_ids, meta.kv_counts, meta.kv_types)))
    jtail = (jnp.asarray(do), jnp.asarray(lse.numpy()), jnp.asarray(di.numpy()), dh**-0.5,
             BlockSizes(block, block), True)
    want = {"fused": _bwd_fused(*jargs, *jtail),
            "cached": _bwd_cached(*jargs, jnp.asarray(js.actions), jnp.asarray(js.flush), *jtail)}
    for mode in ("fused", "cached"):
        for name, g, w in zip(("dq", "dk", "dv"), got[mode], want[mode]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5,
                                       err_msg=f"{mode} {name}")
