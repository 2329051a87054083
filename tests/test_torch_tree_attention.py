"""The port's tree attention (plain versions of K1/K2 and K11/K12, the
dispatch, the autograd function, the dense oracle) against the JAX package's
reference and blocked simulator.

All at fp32 on the CPU, inputs from seeded numpy. Tolerance 2e-5 absolute on
o and lse: the same fp32 math summed in different orders (einsum vs XLA dot)
over at most a few hundred terms of magnitude <= ~10. Gradients: 5e-5
absolute against ``jax.vjp`` of the JAX package's dense reference (the JAX
suite's own bar for its backward kernels, tests/test_tree_attention.py).
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.ops.tree_attention import _score_bound as jax_score_bound
from dynamictreeattn_tpu.ops.tree_attention_ref import tree_attention_reference as jax_ref
from dynamictreeattn_tpu.ops.tree_attention_sim import tree_attention_blocked_sim
from dynamictreeattn_tpu.tries import build_block_meta as jax_build_block_meta
import dynamictreeattn_tpu_torch.ops.tree_attention  # noqa: F401  (the module)
from dynamictreeattn_tpu_torch.ops.tree_attention_ref import tree_attention_reference, tree_mask
from dynamictreeattn_tpu_torch.tries import TokenTrie, build_block_meta, flatten_trie

from helpers import random_trie_batch

ta = sys.modules["dynamictreeattn_tpu_torch.ops.tree_attention"]
ATOL = 2e-5
HQ, HKV, DH = 4, 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loops run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, block=32, qk_scale=1.0):
    """A random trie padded past its length to a multiple of 64 (padding rows
    included) with its block metadata, and fp32 q/k/v from seeded numpy."""
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=10, vocab=5, max_len=100)
    trie = TokenTrie(seqs, attachs)
    n_pad = 64 * (trie.n_tree_tokens // 64 + 1)
    packed = flatten_trie(trie, pad_to=n_pad)
    meta = build_block_meta(packed.last_desc, block, block)
    q = (rng.standard_normal((HQ, n_pad, DH)) * qk_scale).astype(np.float32)
    k = (rng.standard_normal((HKV, n_pad, DH)) * qk_scale).astype(np.float32)
    v = rng.standard_normal((HKV, n_pad, DH)).astype(np.float32)
    return packed, meta, q, k, v


def _torch_meta(meta):
    return tuple(torch.from_numpy(a) for a in (meta.kv_ids, meta.kv_counts, meta.kv_types))


def _torch_meta_all(meta):
    """The six metadata arrays ``tree_attention`` takes (query- and key-major)."""
    return _torch_meta(meta) + tuple(torch.from_numpy(a) for a in (meta.q_ids, meta.q_counts,
                                                                    meta.q_types))


def _dense_lse(q, k, last_desc):
    """[hkv, g, n] logsumexp of the masked scores (the lse both kernels emit)."""
    n = q.shape[1]
    s = torch.einsum("hgqd,hkd->hgqk", torch.from_numpy(q).reshape(HKV, HQ // HKV, n, DH),
                     torch.from_numpy(k)) * DH**-0.5
    s = s.masked_fill(~tree_mask(torch.from_numpy(last_desc))[None, None], float("-inf"))
    return torch.logsumexp(s, dim=-1)


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_oracle_matches_jax_reference(seed):
    packed, _, q, k, v = _case(seed)
    got = tree_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), torch.from_numpy(packed.last_desc))
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(packed.last_desc)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cases_hold_full_and_partial_tiles(seed, block):
    """The inputs below exercise both tile kinds and padding rows."""
    packed, meta, *_ = _case(seed, block=block)
    assert {1, 2} <= set(np.unique(meta.kv_types).tolist())
    assert packed.n_tokens < packed.n_padded


@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["online", "bound"])
def test_plain_kernels_match_jax_blocked_sim(mode, seed, block):
    packed, meta, q, k, v = _case(seed, block=block)
    n = q.shape[1]
    q4 = torch.from_numpy(q).reshape(HKV, HQ // HKV, n, DH)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    ld = torch.from_numpy(packed.last_desc)
    c = ta._score_bound(q4, kt, DH**-0.5) if mode == "bound" else None
    o, lse = ta.tree_attn_fwd_plain(q4, kt, vt, ld, *_torch_meta(meta), DH**-0.5,
                                    block, block, c=c)
    want = np.asarray(tree_attention_blocked_sim(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), packed.last_desc,
        jax_build_block_meta(packed.last_desc, block, block), softmax_mode=mode))
    np.testing.assert_allclose(o.reshape(HQ, n, DH).numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), _dense_lse(q, k, packed.last_desc).numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_score_bound_matches_jax(seed):
    _, _, q, k, _ = _case(seed)
    n = q.shape[1]
    got = ta._score_bound(torch.from_numpy(q).reshape(HKV, HQ // HKV, n, DH),
                          torch.from_numpy(k), DH**-0.5)
    want = np.asarray(jax_score_bound(jnp.asarray(q).reshape(HKV, HQ // HKV, n, DH),
                                          jnp.asarray(k), DH**-0.5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("qk_scale,branch", [(1.0, "bound"), (3.0, "online")])
def test_dispatch_branches(monkeypatch, qk_scale, branch):
    """softmax_mode="bound" takes K1 when max(C) < 40 and K2 otherwise; both
    agree with the JAX oracle. qk_scale=3 lifts max(C) past 40."""
    packed, meta, q, k, v = _case(3, qk_scale=qk_scale)
    n = q.shape[1]
    c_max = float(ta._score_bound(torch.from_numpy(q).reshape(HKV, 2, n, DH),
                                  torch.from_numpy(k), DH**-0.5).max())
    assert (c_max < ta.BOUND_SAFE_MAX) == (branch == "bound")
    taken = []
    for name in ("bound", "online"):
        real = getattr(ta, f"tree_attn_fwd_{name}")
        monkeypatch.setattr(ta, f"tree_attn_fwd_{name}",
                            lambda *a, _r=real, _n=name, **kw: taken.append(_n) or _r(*a, **kw))
    o = ta.tree_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(packed.last_desc), *_torch_meta_all(meta),
                          block_sizes=ta.BlockSizes(32, 32), softmax_mode="bound")
    assert taken == [branch]
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(packed.last_desc)))
    np.testing.assert_allclose(o.numpy(), want, atol=1e-4, rtol=0)


def test_online_mode_never_takes_bound(monkeypatch):
    packed, meta, q, k, v = _case(4)
    monkeypatch.setattr(ta, "tree_attn_fwd_bound", lambda *a, **kw: pytest.fail("bound taken"))
    o = ta.tree_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(packed.last_desc), *_torch_meta_all(meta),
                          block_sizes=ta.BlockSizes(32, 32), softmax_mode="online")
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(packed.last_desc)))
    np.testing.assert_allclose(o.numpy(), want, atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="softmax_mode"):
        ta.tree_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(packed.last_desc), *_torch_meta_all(meta),
                          block_sizes=ta.BlockSizes(32, 32), softmax_mode="nope")


def _kernel_inputs(n=256, block=64, dh=128, group=2):
    ld = torch.arange(n, dtype=torch.int32)
    meta = build_block_meta(ld.numpy(), block, block)
    q4 = torch.zeros((2, group, n, dh), dtype=torch.bfloat16)
    kv = torch.zeros((2, n, dh), dtype=torch.bfloat16)
    return [q4, kv, kv.clone(), ld, *_torch_meta(meta), block, block]


@pytest.mark.parametrize("breakage,err", [
    (lambda a: a.__setitem__(0, a[0].float()), TypeError),  # fp32 q
    (lambda a: a.__setitem__(0, a[0][:, :1].repeat(1, 9, 1, 1)), ValueError),  # group 9
    (lambda a: a.__setitem__(0, a[0][:, :0].contiguous()), ValueError),  # group 0
    (lambda a: [a.__setitem__(i, a[i][..., :96].contiguous()) for i in range(3)],
     ValueError),  # head_dim 96
    (lambda a: a.__setitem__(1, a[1][:, :128]), ValueError),  # k length
    (lambda a: a.__setitem__(7, 32), ValueError),  # block below the 64 tile
    (lambda a: a.__setitem__(4, a[4].long()), TypeError),  # int64 metadata
    (lambda a: a.__setitem__(2, a[2].transpose(1, 2).contiguous().transpose(1, 2)), ValueError),
])
def test_kernel_input_checks(breakage, err):
    """What the CUDA launcher refuses, checked before any pointer is passed."""
    args = _kernel_inputs()
    ta._check_inputs(*args)  # the well-formed case passes
    breakage(args)
    with pytest.raises(err):
        ta._check_inputs(*args)


# ------------------------------------------------------------------ backward

GRAD_ATOL = 5e-5


@functools.lru_cache(maxsize=None)
def _grad_case(seed, block, hq):
    """A random trie (padding rows included) with metadata whose slot rows
    are padded to the worst case, so type-0 slots sit beside type-1/2 ones;
    fp32 q/k/v and a cotangent for o from seeded numpy."""
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=10, vocab=5, max_len=100)
    trie = TokenTrie(seqs, attachs)
    n_pad = 64 * (trie.n_tree_tokens // 64 + 1)
    packed = flatten_trie(trie, pad_to=n_pad)
    nblk = n_pad // block
    meta = build_block_meta(packed.last_desc, block, block, min_kv_slots=nblk, min_q_slots=nblk)
    q, do = (rng.standard_normal((hq, n_pad, DH)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((HKV, n_pad, DH)).astype(np.float32) for _ in range(2))
    return packed, meta, q, k, v, do


@functools.lru_cache(maxsize=None)
def _jax_grads(seed, hq):
    """(o, dq, dk, dv) of ``jax.vjp`` of the JAX dense reference on the case's
    inputs (the same for every block size: the trie and arrays do not
    depend on it), computed once per module."""
    packed, _, q, k, v, do = _grad_case(seed, 32, hq)
    ld = jnp.asarray(packed.last_desc)
    want_o, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, ld), *map(jnp.asarray, (q, k, v)))
    return tuple(np.asarray(w) for w in (want_o, *vjp(jnp.asarray(do))))


@pytest.mark.parametrize("hq", [4, 2])  # GQA group 2 and 1
@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("mode", ["online", "bound"])
@pytest.mark.parametrize("seed", [0, 1])
def test_backward_matches_jax_reference_grads(seed, mode, block, hq):
    """dq, dk, dv of ``tree_attention`` (the plain K11/K12 behind the
    autograd function) equal ``jax.vjp`` of the JAX dense reference."""
    packed, meta, q, k, v, do = _grad_case(seed, block, hq)
    assert {0, 1, 2} <= set(np.unique(meta.kv_types).tolist())
    assert {0, 1, 2} <= set(np.unique(meta.q_types).tolist())
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = ta.tree_attention(qt, kt, vt, torch.from_numpy(packed.last_desc), *_torch_meta_all(meta),
                          block_sizes=ta.BlockSizes(block, block), softmax_mode=mode)
    got = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    want_o, *want = _jax_grads(seed, hq)
    np.testing.assert_allclose(o.detach().numpy(), want_o, atol=1e-4, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_backward_wrappers_on_cpu_are_the_plain_versions():
    packed, meta, q, k, v, do = _grad_case(2, 32, 4)
    n = q.shape[1]
    q4 = torch.from_numpy(q).reshape(HKV, 2, n, DH)
    kt, vt, ld = torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(packed.last_desc)
    o, lse = ta.tree_attn_fwd_plain(q4, kt, vt, ld, *_torch_meta(meta), DH**-0.5, 32, 32)
    dot = torch.from_numpy(do).reshape(q4.shape)
    di = (dot * o).sum(-1)
    qm = _torch_meta_all(meta)[3:]
    args = (q4, kt, vt, ld)
    tail = (dot, lse, di, DH**-0.5, 32, 32)
    torch.testing.assert_close(ta.tree_attn_bwd_dq(*args, *_torch_meta(meta), *tail),
                               ta.tree_attn_bwd_dq_plain(*args, *_torch_meta(meta), *tail),
                               rtol=0, atol=0)
    for a, b in zip(ta.tree_attn_bwd_dkv(*args, *qm, *tail), ta.tree_attn_bwd_dkv_plain(*args, *qm, *tail)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("bwd_mode,match", [("nope", "unknown bwd_mode")])
def test_unported_bwd_modes_raise(bwd_mode, match):
    packed, meta, q, k, v = _case(0)
    with pytest.raises(ValueError, match=match):
        ta.tree_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(packed.last_desc), *_torch_meta_all(meta),
                          block_sizes=ta.BlockSizes(32, 32), bwd_mode=bwd_mode)


def test_backward_kernel_input_checks():
    """What the backward launchers refuse: key-major metadata with one row per
    kv block, and do / lse / di of the wrong type or shape."""
    n = 256
    ld = torch.arange(n, dtype=torch.int32)
    meta = build_block_meta(ld.numpy(), 128, 64)  # 2 q blocks, 4 kv blocks
    q4 = torch.zeros((2, 2, n, 128), dtype=torch.bfloat16)
    kv = torch.zeros((2, n, 128), dtype=torch.bfloat16)
    qm = _torch_meta_all(meta)[3:]
    ta._check_inputs(q4, kv, kv, ld, *qm, 128, 64, key_major=True)
    ta._check_inputs(q4, kv, kv, ld, *_torch_meta(meta), 128, 64)
    with pytest.raises(ValueError, match="kv blocks"):
        ta._check_inputs(q4, kv, kv, ld, *_torch_meta(meta), 128, 64, key_major=True)
    lse = torch.zeros((2, 2, n))
    ta._check_grad_inputs(q4, q4.clone(), lse, lse.clone())
    for bad in ((q4.float(), lse, lse), (q4, lse[..., :128].contiguous(), lse),
                (q4, lse, lse.double()), (q4, lse, lse.transpose(0, 1).contiguous().transpose(0, 1))):
        with pytest.raises(ValueError):
            ta._check_grad_inputs(q4, *bad)
