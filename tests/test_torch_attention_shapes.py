"""The port's tree attention at the head layouts of the dense configs that
the CUDA kernels take beyond Qwen3's (head_dim 64 and 128, GQA groups 3-7,
odd groups included), in its plain versions, against the JAX package; and
the kernels' shape gate over every published dense config.

All at fp32 on the CPU, inputs from seeded numpy, with the bars of
test_torch_tree_attention.py: o and lse 2e-5 absolute against the JAX
blocked simulator (the JAX suite's CPU stand-in for its Pallas forward
kernels) and the dense logsumexp; dq, dk, dv 5e-5 absolute against
``jax.vjp`` of the JAX dense reference, for each backward mode ("split"
K11/K12, "fused" K10, "cached" K3 with the Belady schedule). The opt-in
interpret case holds the plain forward against the JAX Pallas kernels
themselves in the TPU-semantics interpreter at a grouped shape.
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
from dynamictreeattn_tpu.ops.tree_attention_sim import tree_attention_blocked_sim
from dynamictreeattn_tpu.tries import build_block_meta as jax_build_block_meta
from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS
import dynamictreeattn_tpu_torch.ops.tree_attention  # noqa: F401  (the module)
from dynamictreeattn_tpu_torch.ops.tree_attention_ref import tree_mask
from dynamictreeattn_tpu_torch.tries import (
    TokenTrie, build_block_meta, build_bwd_cache_sched, flatten_trie,
)

from helpers import random_trie_batch

ta = sys.modules["dynamictreeattn_tpu_torch.ops.tree_attention"]
ATOL, GRAD_ATOL = 2e-5, 5e-5
HKV, BLOCK = 2, 32
# (head_dim, group): Llama-3.2-1B, Qwen2.5-0.5B, Llama-3.2-3B, Qwen2.5-1.5B
PAIRS = [(64, 4), (64, 7), (128, 3), (128, 6)]
PAIR_IDS = [f"dh{dh}-g{g}" for dh, g in PAIRS]
# the published dense configs (the tiny ones are CPU test configs, dh 16)
DENSE = sorted(name for name in MODEL_CONFIGS if "tiny" not in name)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loops run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _case(dh, group, seed=0):
    """A random trie padded past its length (padding rows included), block
    metadata with slot rows padded to the worst case (type-0 slots beside
    type-1/2), fp32 q/k/v and a cotangent for o from seeded numpy, and the
    JAX dense reference's (o, dq, dk, dv) by ``jax.vjp``."""
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=6, vocab=5, max_len=60)
    trie = TokenTrie(seqs, attachs)
    n_pad = 64 * (trie.n_tree_tokens // 64 + 1)
    packed = flatten_trie(trie, pad_to=n_pad)
    nblk = n_pad // BLOCK
    meta = build_block_meta(packed.last_desc, BLOCK, BLOCK, min_kv_slots=nblk, min_q_slots=nblk)
    hq = HKV * group
    q, do = (rng.standard_normal((hq, n_pad, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((HKV, n_pad, dh)).astype(np.float32) for _ in range(2))
    ld = jnp.asarray(packed.last_desc)
    want_o, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, ld), *map(jnp.asarray, (q, k, v)))
    want = tuple(np.asarray(w) for w in (want_o, *vjp(jnp.asarray(do))))
    return packed, meta, (q, k, v, do), want


def _torch_meta(meta):
    return tuple(torch.from_numpy(a) for a in (meta.kv_ids, meta.kv_counts, meta.kv_types,
                                                meta.q_ids, meta.q_counts, meta.q_types))


@pytest.mark.parametrize("dh,group", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("mode", ["online", "bound"])
def test_plain_forward_matches_jax_blocked_sim_at_shape(mode, dh, group):
    """The plain K1 (bound) / K2 (online): o equals the JAX blocked
    simulator's, lse the dense masked logsumexp."""
    packed, meta, (q, k, v, _), _ = _case(dh, group)
    n = q.shape[1]
    q4 = torch.from_numpy(q).reshape(HKV, group, n, dh)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    scale = dh**-0.5
    c = ta._score_bound(q4, kt, scale) if mode == "bound" else None
    o, lse = ta.tree_attn_fwd_plain(q4, kt, vt, torch.from_numpy(packed.last_desc), *_torch_meta(meta)[:3],
                                    scale, BLOCK, BLOCK, c=c)
    want = np.asarray(tree_attention_blocked_sim(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), packed.last_desc,
        jax_build_block_meta(packed.last_desc, BLOCK, BLOCK), softmax_mode=mode))
    np.testing.assert_allclose(o.reshape(HKV * group, n, dh).numpy(), want, atol=ATOL, rtol=0)
    s = torch.einsum("hgqd,hkd->hgqk", q4, kt) * scale
    s = s.masked_fill(~tree_mask(torch.from_numpy(packed.last_desc))[None, None], float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, dim=-1).numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("dh,group", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("bwd_mode", ["split", "fused", "cached"])
def test_backward_matches_jax_reference_grads_at_shape(bwd_mode, dh, group):
    """o and dq, dk, dv of ``tree_attention`` in each backward mode (the
    plain K11/K12, K10 and K3 behind the autograd function; K3 replays a
    2-slot schedule, so it evicts and reloads) equal ``jax.vjp`` of the JAX
    dense reference."""
    packed, meta, (q, k, v, do), want = _case(dh, group)
    sched = build_bwd_cache_sched(meta, 2) if bwd_mode == "cached" else None
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = ta.tree_attention(qt, kt, vt, torch.from_numpy(packed.last_desc), *_torch_meta(meta),
                          block_sizes=ta.BlockSizes(BLOCK, BLOCK), softmax_mode="online",
                          bwd_mode=bwd_mode, cache_sched=sched)
    got = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), want[0], atol=1e-4, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), got, want[1:]):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, rtol=0, err_msg=name)


def _gate_inputs(dh, group, n=128, hkv=1):
    ld = torch.arange(n, dtype=torch.int32)
    meta = _torch_meta(build_block_meta(ld.numpy(), 64, 64))
    q4 = torch.zeros((hkv, group, n, dh), dtype=torch.bfloat16)
    kv = torch.zeros((hkv, n, dh), dtype=torch.bfloat16)
    return q4, kv, kv.clone(), ld, meta


@pytest.mark.parametrize("name", DENSE)
def test_every_dense_config_passes_the_kernel_gate(name):
    """Each published dense config's (head_dim, group) is one the CUDA
    kernels take: ``_check_inputs`` (what every launcher checks first)
    accepts it, query-major and key-major."""
    mc = MODEL_CONFIGS[name]
    dh, group = mc.head_dim, mc.num_attention_heads // mc.num_key_value_heads
    assert ta.kernel_takes(dh, group)
    q4, k, v, ld, meta = _gate_inputs(dh, group)
    ta._check_inputs(q4, k, v, ld, *meta[:3], 64, 64)
    ta._check_inputs(q4, k, v, ld, *meta[3:], 64, 64, key_major=True)
    ta._check_grad_inputs(q4, q4.clone(), *(torch.zeros(q4.shape[:3]) for _ in range(2)))


@pytest.mark.parametrize("dh,group", [(96, 2), (128, 9), (64, 9), (256, 2)])
def test_kernel_gate_refuses_other_shapes(dh, group):
    assert not ta.kernel_takes(dh, group)
    q4, k, v, ld, meta = _gate_inputs(dh, group)
    with pytest.raises(ValueError, match="head_dim"):
        ta._check_inputs(q4, k, v, ld, *meta[:3], 64, 64)


@pytest.mark.skipif(
    not os.environ.get("RUN_INTERPRET"),
    reason="Pallas interpret-mode compile is minutes-slow for grouped kernels; opt in with RUN_INTERPRET=1",
)
@pytest.mark.parametrize("mode", ["online", "bound"])
def test_plain_forward_matches_jax_kernels_interpret_grouped(mode):
    """The plain K1/K2 against the JAX ``_fwd_bound`` / ``_fwd`` in the
    TPU-semantics interpreter at group 3, head_dim 64 (n 128, block 32)."""
    from dynamictreeattn_tpu.ops.tree_attention import BlockSizes, _fwd, _fwd_bound, _score_bound

    rng = np.random.default_rng(5)
    dh, group, n, hkv = 64, 3, 128, 1
    seqs, attachs = random_trie_batch(rng, n_seqs=6, vocab=5, max_len=30)
    packed = flatten_trie(TokenTrie(seqs, attachs), pad_to=n)
    meta = build_block_meta(packed.last_desc, BLOCK, BLOCK, min_kv_slots=n // BLOCK, min_q_slots=n // BLOCK)
    q4, k, v = (rng.standard_normal(s).astype(np.float32)
                for s in ((hkv, group, n, dh), (hkv, n, dh), (hkv, n, dh)))
    scale = dh**-0.5
    tm = _torch_meta(meta)[:3]
    q4t, kt = torch.from_numpy(q4), torch.from_numpy(k)
    c = ta._score_bound(q4t, kt, scale) if mode == "bound" else None
    o, lse = ta.tree_attn_fwd_plain(q4t, kt, torch.from_numpy(v), torch.from_numpy(packed.last_desc), *tm,
                                    scale, BLOCK, BLOCK, c=c)
    jargs = (jnp.asarray(q4), jnp.asarray(k), jnp.asarray(v), jnp.asarray(packed.last_desc).reshape(1, n),
             *(jnp.asarray(a) for a in (meta.kv_ids, meta.kv_counts, meta.kv_types)), scale,
             BlockSizes(BLOCK, BLOCK), True)
    with jax.default_matmul_precision("highest"):
        if mode == "bound":
            jc = _score_bound(jnp.asarray(q4), jnp.asarray(k), scale)
            want_o, want_lse = _fwd_bound(*jargs, c=jc)
        else:
            want_o, want_lse = _fwd(*jargs)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL, rtol=ATOL)
