"""The port's ring tree attention and its position offsets against the JAX package.

* ``build_ring_block_meta`` bit-equal to JAX's (sp 2 and 4, two block sizes).
* The position-offset work lists (``build_qmajor_work`` /
  ``build_kmajor_work`` with ``q_off``, ``kv_off``, ``n_loc``): at offsets 0
  over the whole length they are today's lists, element for element; over
  every (q shard, kv shard) pair of a ring layout they hold exactly the live
  sub-tiles of the one-device lists, translated to global positions (each
  once), with the same full / partial flags.
* The plain K2 / K11 / K12 with offsets equal the JAX ``_fwd`` / ``_bwd_dq``
  / ``_bwd_dkv`` with ``offs`` in interpret mode (a few seconds) on an
  off-diagonal pair where some rows see no key (lse ~ MASK_VALUE, o the mean
  of the keys' v: what the TPU kernel writes) and on an empty pair (o = 0,
  lse = -inf), at fp32, 2e-5 (measured: 1.4e-6 at most, dk).
* ``tree_attention_ring_reference`` and the ring Function on the plain
  kernels, on gloo ranks (``torch_dist_worker``, spawned once), equal the
  JAX ``tree_attention_ring_reference`` under ``shard_map`` on the fake
  mesh, forward and grads, at sp 2 and 4 with (hq, hkv) (4, 2) and (4, 1)
  (JAX ``tests/test_ring_attention.py``): o 2e-5 and grads 1e-4, JAX's own
  bars (measured: 9.5e-7 and 5.7e-6 at most).
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dynamictreeattn_tpu.ops.tree_attention import BlockSizes as JaxBlockSizes
from dynamictreeattn_tpu.ops.tree_attention import _bwd_dkv as jax_bwd_dkv
from dynamictreeattn_tpu.ops.tree_attention import _bwd_dq as jax_bwd_dq
from dynamictreeattn_tpu.ops.tree_attention import _fwd as jax_fwd
from dynamictreeattn_tpu.ops.tree_attention_ring import tree_attention_ring_reference as jax_ring_reference
from dynamictreeattn_tpu.parallel import make_mesh as jax_make_mesh
from dynamictreeattn_tpu.tries import build_ring_block_meta as jax_build_ring_block_meta
from dynamictreeattn_tpu_torch.ops import tree_attention_ring as tar
from dynamictreeattn_tpu_torch.tries import (
    TokenTrie, build_block_meta, build_kmajor_work, build_qmajor_work, build_ring_block_meta, flatten_trie,
)

import dynamictreeattn_tpu_torch.ops.tree_attention  # noqa: F401  (the module, not the function)
from helpers import random_packed, random_trie_batch
from torch_dist_worker import run_ranks

ta = sys.modules["dynamictreeattn_tpu_torch.ops.tree_attention"]
FIELDS = tar.RING_META_FIELDS
RING_CASES = [(sp, hq, hkv) for sp in (2, 4) for hq, hkv in ((4, 2), (4, 1))]
N, DH, BLOCK = 256, 32, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packed(seed: int, n: int, block: int):
    return random_packed(np.random.default_rng(seed), n, block, n_seqs=16, max_len=50)[2]


@pytest.mark.parametrize("sp,block,seed", [(2, 32, 0), (4, 32, 1), (2, 64, 2), (4, 64, 3)])
def test_ring_block_meta_is_jax_bit_for_bit(sp, block, seed):
    """Every table of every (q shard, kv shard) pair, with and without
    minimum slot widths."""
    ld = _packed(seed, 512, block).last_desc
    for extra in ({}, dict(min_kv_slots=9, min_q_slots=7)):
        ours, theirs = build_ring_block_meta(ld, sp, block, block, **extra), jax_build_ring_block_meta(
            ld, sp, block, block, **extra)
        for f in FIELDS:
            a, b = getattr(ours, f), getattr(theirs, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    with pytest.raises(ValueError, match="must divide"):
        build_ring_block_meta(ld, 3, block, block)


def _trie_ld(seed: int, n_pad: int) -> np.ndarray:
    seqs, attachs = random_trie_batch(np.random.default_rng(seed), n_seqs=10, vocab=5, max_len=90)
    return flatten_trie(TokenTrie(seqs, attachs), pad_to=n_pad).last_desc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_offset_work_lists_at_zero_are_todays(seed):
    """q_off = kv_off = 0 with n_loc the whole length: the lists built
    without offsets, every array and count equal."""
    ld = _trie_ld(seed, 512)
    meta = build_block_meta(ld, 128, 128)
    q0 = build_qmajor_work(ld, meta.kv_ids, meta.kv_counts, meta.kv_types, 128, 128)
    q1 = build_qmajor_work(ld, meta.kv_ids, meta.kv_counts, meta.kv_types, 128, 128, q_off=0, kv_off=0, n_loc=512)
    assert np.array_equal(q0.entries, q1.entries) and np.array_equal(q0.tiles, q1.tiles)
    assert (q0.n_tiles, q0.q_off, q0.kv_off) == (q1.n_tiles, 0, 0)
    k0 = build_kmajor_work(ld, meta.q_ids, meta.q_counts, meta.q_types, 128, 128, 2, 16)
    k1 = build_kmajor_work(ld, meta.q_ids, meta.q_counts, meta.q_types, 128, 128, 2, 16, q_off=0, kv_off=0,
                           n_loc=512)
    assert np.array_equal(k0.units, k1.units) and np.array_equal(k0.chunks, k1.chunks)
    assert (k0.bound, k0.n_parts, k0.n_split, k0.n_tiles) == (k1.bound, k1.n_parts, k1.n_split, k1.n_tiles)


def _qmajor_set(work, q_off=0, kv_off=0) -> set:
    """{(q row, key start, partial)} at global positions."""
    out = set()
    for r0, first, count in work.tiles.tolist():
        for e in work.entries[first:first + count].tolist():
            out.add((q_off + r0, kv_off + (e >> 1), e & 1))
    return out


def _kmajor_set(work, q_off=0, kv_off=0, tile=64) -> set:
    """{(key start, q row, partial)} at global positions (chunk by chunk)."""
    out = []
    for t, first, count in work.chunks[:, :3].tolist():
        out += [(kv_off + t * tile, q_off + (u >> 1), u & 1) for u in work.units[first:first + count].tolist()]
    assert len(out) == len(set(out))  # every unit in one chunk
    return set(out)


@pytest.mark.parametrize("sp,seed", [(2, 4), (4, 5), (4, 6)])
def test_ring_pair_work_lists_partition_the_one_device_lists(sp, seed):
    """Over every (me, src) pair the offset lists hold exactly the
    one-device lists' live sub-tiles and flags; src > me pairs are empty."""
    n, block = 1024, 128
    ld = _trie_ld(seed, n)
    n_loc = n // sp
    meta = build_block_meta(ld, block, block)
    whole_q = _qmajor_set(build_qmajor_work(ld, meta.kv_ids, meta.kv_counts, meta.kv_types, block, block))
    whole_k = _kmajor_set(build_kmajor_work(ld, meta.q_ids, meta.q_counts, meta.q_types, block, block, 2, 16))
    rm = build_ring_block_meta(ld, sp, block, block)
    got_q, got_k = set(), set()
    for me in range(sp):
        for src in range(sp):
            offs = dict(q_off=me * n_loc, kv_off=src * n_loc, n_loc=n_loc)
            qw = build_qmajor_work(ld, rm.kv_ids[me, src], rm.kv_counts[me, src], rm.kv_types[me, src], block,
                                   block, **offs)
            kw = build_kmajor_work(ld, rm.q_ids[me, src], rm.q_counts[me, src], rm.q_types[me, src], block, block,
                                   2, 16, **offs)
            assert qw.n_tiles == kw.n_tiles == n_loc // 64 and (qw.q_off, kw.kv_off) == (me * n_loc, src * n_loc)
            pq, pk = _qmajor_set(qw, me * n_loc, src * n_loc), _kmajor_set(kw, me * n_loc, src * n_loc)
            if src > me:
                assert not pq and not pk
            assert not (got_q & pq) and not (got_k & pk)
            got_q |= pq
            got_k |= pk
    assert got_q == whole_q and got_k == whole_k


@functools.lru_cache(maxsize=None)
def _pair_case():
    """A pair of a sp = 2 layout (n = 256, block 64, fp32): q shard 1
    against kv shard 0 (rows whose every ancestor is in shard 1 see no key)
    and against kv shard 1; lse and di from the whole sequence's plain
    K2, as the ring's backward takes them."""
    n, block, sp = 256, 64, 2
    n_loc = n // sp
    packed = _packed(11, n, block)
    ld = packed.last_desc
    rng = np.random.default_rng(12)
    hkv, group, dh = 2, 2, 32
    q4, do = (rng.standard_normal((hkv, group, n, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((hkv, n, dh)).astype(np.float32) for _ in range(2))
    meta = build_block_meta(ld, block, block)
    tm = [torch.from_numpy(getattr(meta, f)) for f in FIELDS[:3]]
    o, lse = ta.tree_attn_fwd_plain(torch.from_numpy(q4), torch.from_numpy(k), torch.from_numpy(v),
                                    torch.from_numpy(ld), *tm, dh**-0.5, block, block)
    di = (torch.from_numpy(do) * o).sum(-1).numpy()
    return packed, build_ring_block_meta(ld, sp, block, block), (q4, k, v, do, lse.numpy(), di), n_loc, block


@pytest.mark.parametrize("me,src", [(1, 0), (1, 1), (0, 1)])
def test_plain_offset_kernels_match_jax_interpret(me, src):
    """Plain K2 (o, lse), K11 dq and K12 (dk, dv) of the pair == the JAX
    kernels with ``offs`` in interpret mode."""
    packed, rm, (q4, k, v, do, lse, di), n_loc, block = _pair_case()
    qs, ks = slice(me * n_loc, (me + 1) * n_loc), slice(src * n_loc, (src + 1) * n_loc)
    args = [np.ascontiguousarray(a) for a in (q4[:, :, qs], k[:, ks], v[:, ks])]
    tail = [np.ascontiguousarray(a) for a in (do[:, :, qs], lse[:, :, qs], di[:, :, qs])]
    m = [getattr(rm, f)[me, src] for f in FIELDS]
    scale = q4.shape[-1] ** -0.5
    offs = dict(q_off=me * n_loc, kv_off=src * n_loc)
    tt = [torch.from_numpy(a) for a in args]
    ld = torch.from_numpy(packed.last_desc)
    tm = [torch.from_numpy(a) for a in m]
    o, lse_p = ta.tree_attn_fwd_plain(*tt, ld, *tm[:3], scale, block, block, **offs)
    ttail = [torch.from_numpy(a) for a in tail]
    dq = ta.tree_attn_bwd_dq_plain(*tt, ld, *tm[:3], *ttail, scale, block, block, **offs)
    dk, dv = ta.tree_attn_bwd_dkv_plain(*tt, ld, *tm[3:], *ttail, scale, block, block, **offs)

    bs = JaxBlockSizes(block, block)
    jargs = [jnp.asarray(a) for a in args] + [jnp.asarray(packed.last_desc).reshape(1, -1)]
    jm = [jnp.asarray(a) for a in m]
    joffs = jnp.asarray([me * n_loc, src * n_loc], jnp.int32)
    jo, jlse = jax_fwd(*jargs, *jm[:3], scale, bs, True, offs=joffs)
    jtail = [jnp.asarray(a) for a in tail]
    jdq = jax_bwd_dq(*jargs, *jm[:3], *jtail, scale, bs, True, offs=joffs)
    jdk, jdv = jax_bwd_dkv(*jargs, *jm[3:], *jtail, scale, bs, True, offs=joffs)

    lse_p, jlse = lse_p.numpy(), np.asarray(jlse)
    no_key = lse_p < -1e30
    if src > me:  # no live block: o = 0, lse = -inf
        assert np.all(np.isneginf(lse_p)) and not o.numpy().any()
    elif src < me:  # some rows see no key of the pair, some do
        assert 0 < no_key.sum() < no_key.size
    np.testing.assert_array_equal(np.isneginf(lse_p), np.isneginf(jlse))
    fin = np.isfinite(lse_p)
    np.testing.assert_allclose(lse_p[fin], jlse[fin], rtol=2e-5, atol=2e-5)
    for got, want in ((o, jo), (dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------------- the ring

def _inputs(sp, hq, hkv):
    packed = _packed(5 + sp, N, BLOCK)
    rng = np.random.default_rng(100 * sp + 10 * hq + hkv)
    q, cot = (rng.standard_normal((hq, N, DH)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((hkv, N, DH)).astype(np.float32) for _ in range(2))
    meta = build_ring_block_meta(packed.last_desc, sp, BLOCK, BLOCK)
    return packed.last_desc, q, k, v, cot, {f: getattr(meta, f) for f in FIELDS}


@pytest.fixture(scope="module")
def ring_ranks(tmp_path_factory):
    cases = []
    for sp, hq, hkv in RING_CASES:
        ld, q, k, v, cot, meta = _inputs(sp, hq, hkv)
        cases.append((f"ring{sp}{hq}{hkv}", "ring", dict(sp=sp, q=q, k=k, v=v, cot=cot, ld=ld, block=BLOCK,
                                                         meta=meta)))
    return run_ranks(4, cases, str(tmp_path_factory.mktemp("ring")))


def _jax_ring(sp, hq, hkv):
    ld, q, k, v, cot, _ = _inputs(sp, hq, hkv)
    mesh = jax_make_mesh(dp=1, tp=1, sp=sp)
    ldj = jnp.asarray(ld)
    fn = jax.shard_map(lambda a, b, c: jax_ring_reference(a, b, c, ldj, sp=sp, axis="seq"), mesh=mesh,
                       in_specs=(P(None, "seq", None),) * 3, out_specs=P(None, "seq", None), check_vma=False)
    def o_and_grads(*qkv):  # one trace and compile for both
        o, vjp = jax.vjp(fn, *qkv)
        return o, vjp(jnp.asarray(cot))

    o, grads = jax.jit(o_and_grads)(*(jnp.asarray(t) for t in (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("sp,hq,hkv", RING_CASES)
def test_ring_matches_jax_ring_reference(ring_ranks, sp, hq, hkv):
    """o and (dq, dk, dv) of the port's reference ring and of its ring
    Function (plain kernels with offsets), each rank's rows concatenated,
    against the JAX reference ring on the fake "seq" mesh."""
    res = ring_ranks[f"ring{sp}{hq}{hkv}"][:sp]
    want_o, want_g = _jax_ring(sp, hq, hkv)
    for r, out in enumerate(res):
        assert out["live"][0] and out["src"][0] == r  # the diagonal first
        assert not out["live"][[s > r for s in out["src"]]].any()  # later shards: nothing to see
    for name in ("ref", "ring"):
        got = np.concatenate([out[f"{name}/o"] for out in res], axis=1)
        np.testing.assert_allclose(got, want_o, rtol=2e-5, atol=2e-5, err_msg=name)
        for x, want in zip("qkv", want_g):
            got = np.concatenate([out[f"{name}/d{x}"] for out in res], axis=1)
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=f"{name} d{x}")
