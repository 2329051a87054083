"""The last small pieces of the JAX package's API in the port.

* ``ops.tree_attention_sim.tree_attention_blocked_sim`` equals JAX's blocked
  simulator on the same host metadata (both softmax modes, GQA groups 1, 2,
  6, head_dim 16 and 64; fp32, 2e-5);
* ``PackedTrie.validate`` accepts what JAX's accepts (random tries, padded)
  and, like JAX's, rejects a corrupted ``parent`` or ``depth``;
* ``BlockMeta.n_q_blocks`` / ``n_kv_blocks`` / ``n_active_pairs`` equal
  JAX's;
* ``ops.tree_attention_with_meta`` (o and its grads in the "split" and
  "cached" backward) equals JAX's, run in interpret mode (2e-5, 5e-5);
* ``cli.warmup`` parses JAX's command line, lists the kernel instantiations
  of qwen3-0.6b and qwen2.5-1.5b (and of a tp = 2 rank), and raises where it
  cannot build or load the kernels (no nvcc here, or ``--device cpu``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.ops.tree_attention import tree_attention_with_meta as jax_with_meta
from dynamictreeattn_tpu.ops.tree_attention_sim import tree_attention_blocked_sim as jax_sim
from dynamictreeattn_tpu.tries import TokenTrie as JaxTokenTrie
from dynamictreeattn_tpu.tries import build_block_meta as jax_build_block_meta
from dynamictreeattn_tpu.tries import flatten_trie as jax_flatten_trie
from dynamictreeattn_tpu_torch.cli import warmup
from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS
from dynamictreeattn_tpu_torch.ops import tree_attention_blocked_sim, tree_attention_with_meta
from dynamictreeattn_tpu_torch.tries import TokenTrie, build_block_meta, flatten_trie

from helpers import random_trie_batch

ATOL, GRAD_ATOL = 2e-5, 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _case(seed: int, block: int):
    """A random trie padded past its length, its metadata (port and JAX),
    and the numpy generator that made them."""
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=6, vocab=5, max_len=50)
    n_pad = block * (TokenTrie(seqs, attachs).n_tree_tokens // block + 1)
    packed = flatten_trie(TokenTrie(seqs, attachs), pad_to=n_pad)
    return (packed, build_block_meta(packed.last_desc, block, block),
            jax_build_block_meta(packed.last_desc, block, block), rng)


@pytest.mark.parametrize("mode", ["online", "bound"])
@pytest.mark.parametrize("dh,group", [(16, 1), (16, 2), (64, 6)])
def test_blocked_sim_equals_jax(mode, dh, group):
    packed, meta, jmeta, rng = _case(0, 32)
    n, hkv = packed.n_padded, 2
    q = rng.standard_normal((hkv * group, n, dh)).astype(np.float32)
    k, v = (rng.standard_normal((hkv, n, dh)).astype(np.float32) for _ in range(2))
    got = tree_attention_blocked_sim(*map(torch.from_numpy, (q, k, v)), packed.last_desc, meta, softmax_mode=mode)
    want = jax_sim(*map(jnp.asarray, (q, k, v)), packed.last_desc, jmeta, softmax_mode=mode)
    assert got.shape == (hkv * group, n, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", range(4))
def test_validate_and_block_meta_properties_equal_jax(seed):
    packed, meta, jmeta, _ = _case(seed, 16)
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=6, vocab=5, max_len=50)
    jpacked = jax_flatten_trie(JaxTokenTrie(seqs, attachs), pad_to=packed.n_padded)
    packed.validate()
    jpacked.validate()
    for name in ("n_q_blocks", "n_kv_blocks", "n_active_pairs"):
        assert getattr(meta, name) == getattr(jmeta, name), name
    for field, j in (("parent", 1), ("depth", 2)):
        if packed.n_tokens <= j:
            continue
        bad_p, bad_j = [flatten_trie(TokenTrie(seqs, attachs), pad_to=packed.n_padded),
                        jax_flatten_trie(JaxTokenTrie(seqs, attachs), pad_to=packed.n_padded)]
        for p in (bad_p, bad_j):
            arr = getattr(p, field).copy()
            arr[j] = j + 3 if field == "parent" else arr[j] + 5  # a parent after its child; a depth off the chain
            setattr(p, field, arr)
            with pytest.raises(AssertionError):
                p.validate()


@pytest.mark.parametrize("bwd_mode", ["split", "cached"])
def test_tree_attention_with_meta_equals_jax(bwd_mode):
    """o and (dq, dk, dv) from a host BlockMeta: the port's (plain kernels on
    the CPU; "cached" with the slot schedule it builds) and JAX's (Pallas in
    interpret mode, its default "split" backward)."""
    packed, meta, jmeta, rng = _case(1, 64)
    n, hkv, group, dh = packed.n_padded, 2, 2, 64
    q, k, v = (rng.standard_normal((h, n, dh)).astype(np.float32) for h in (hkv * group, hkv, hkv))
    do = rng.standard_normal((hkv * group, n, dh)).astype(np.float32)
    qkv = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    o = tree_attention_with_meta(*qkv, packed.last_desc, meta, bwd_mode=bwd_mode)
    grads = torch.autograd.grad(o, qkv, torch.from_numpy(do))
    ld = jnp.asarray(packed.last_desc)
    want, vjp = jax.vjp(lambda a, b, c: jax_with_meta(a, b, c, ld, jmeta, interpret=True), *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)
    for name, g, w in zip("qkv", grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=0, err_msg="d" + name)


JAX_ARGV = ["--model", "qwen3-0.6b", "--max-len", "8192", "--min-len", "512", "--widths", "cross", "--fwd-only",
            "--dp", "2", "--tp", "2", "--fsdp", "--opt", "--block-q", "128", "--block-kv", "128",
            "--attn-backend", "pallas", "--no-remat", "--dtype", "fp32"]


def test_warmup_parses_jax_command_line():
    args = warmup.parser().parse_args(JAX_ARGV)
    assert (args.model, args.max_len, args.min_len, args.widths, args.fwd_only, args.dp, args.tp, args.fsdp,
            args.opt) == ("qwen3-0.6b", 8192, 512, "cross", True, 2, 2, True, True)
    for flag in ("--max-len", "--min-len", "--widths"):
        action = next(a for a in warmup.parser()._actions if flag in a.option_strings)
        assert "changes nothing" in action.help


@pytest.mark.parametrize("name,tp,shapes", [
    ("qwen3-0.6b", 1, {"attn": (128, 2, 8), "qk": (128, 16, 8, True), "lm": (1024, 151936, True)}),
    ("qwen2.5-1.5b", 1, {"attn": (128, 6, 2), "qk": (128, 12, 2, False), "lm": (1536, 151936, True)}),
    ("qwen3-0.6b", 2, {"attn": (128, 2, 4), "qk": (128, 8, 4, True), "lm": (1024, 75968, True)}),
])
def test_warmup_lists_instantiations(name, tp, shapes):
    got = warmup.instantiations(MODEL_CONFIGS[name], tp)
    kernels = [k for inst in got for k in inst["kernels"]]
    assert len(kernels) == len(set(kernels)) == 13  # every kernel launch name once
    for inst in got:
        s = inst["shape"]
        if "group" in s:
            assert (s["head_dim"], s["group"], s["kv_heads"]) == shapes["attn"], inst
        elif "q_heads" in s:
            assert (s["head_dim"], s["q_heads"], s["kv_heads"], s["qk_norm"]) == shapes["qk"], inst
        else:
            assert (s["hidden"], s["vocab"], s["tied"]) == shapes["lm"], inst
    fwd = warmup.instantiations(MODEL_CONFIGS[name], tp, fwd_only=True)
    assert {k for inst in fwd for k in inst["kernels"]} == {
        "tree_attn_fwd_bound", "tree_attn_fwd_online", "qk_prep_fwd_q", "qk_prep_fwd_kv", "lm_stats_fwd",
        "decode_attn"}


@pytest.mark.parametrize("argv", [["--model", "qwen3-0.6b"], ["--model", "qwen3-0.6b", "--device", "cpu"]])
def test_warmup_raises_without_a_card(argv):
    """Here there is no nvcc and no card: warmup raises and prints nothing."""
    with pytest.raises((RuntimeError, ValueError)):
        warmup.main(argv)
