"""The forward path against the JAX package: the port's TreeEngine forward
(inference log-probs) equals the JAX engine's on the same trie and weights,
its fused qk-prep path the JAX engine's fused path (the JAX qk-prep kernels
in interpret mode); tree == dense inside the port; the package imports
without CUDA and never imports JAX or the JAX package.

fp32 on the CPU (the port's kernel wrappers run their plain versions on CPU
tensors). Tolerance 1e-4 absolute on per-token log-probs of magnitude ~5:
two fp32 layers plus the LM-head fold, summed in other orders.
"""

import ast
import importlib
import pkgutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamictreeattn_tpu.ops.qk_prep  # noqa: F401  (patched below, reached through sys.modules)
import dynamictreeattn_tpu_torch
from dynamictreeattn_tpu.engine import EngineConfig as JaxEngineConfig
from dynamictreeattn_tpu.engine import TreeEngine as JaxTreeEngine
from dynamictreeattn_tpu.models import qwen3 as jq
from dynamictreeattn_tpu.tries import TokenTrie as JaxTokenTrie
from dynamictreeattn_tpu_torch.engine import (
    EngineConfig, TreeEngine, pack_sequences_dense, resolve_fused_qk, resolve_kernel_modes,
    resolve_loss_mode,
)
from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, params_from_numpy
from dynamictreeattn_tpu_torch.tries import TokenTrie

from helpers import random_trie_batch

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-4


def _setup(seed=0, n_seqs=10):
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=n_seqs, vocab=128, max_len=40)
    jp = jq.init_params(jq.MODEL_CONFIGS["qwen3-tiny"], jax.random.key(seed), dtype=jnp.float32)
    return seqs, attachs, jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def jax_forward():
    """Per-sequence log-probs of the JAX engine on the reference backend."""
    seqs, attachs, jp, _ = _setup()
    eng = JaxTreeEngine(jq.MODEL_CONFIGS["qwen3-tiny"], JaxEngineConfig(
        block_q=16, block_kv=16, remat=False, attn_backend="reference",
        loss_mode="vocab", fused_qk="off"))
    return eng.forward(jp, eng.prepare(JaxTokenTrie(seqs, attachs)))


@pytest.fixture(scope="module")
def jax_fused_forward():
    """Per-sequence log-probs of the JAX engine's fused qk-prep path (its
    K4/K5 in interpret mode: ``_layer`` looks ``qkv_prep`` up at call time)
    on the reference backend."""
    seqs, attachs, jp, _ = _setup()
    jqp = sys.modules["dynamictreeattn_tpu.ops.qk_prep"]
    orig, calls = jqp.qkv_prep, []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jqp, "qkv_prep", lambda *a: calls.append(a) or orig(*a[:9], True))
        eng = JaxTreeEngine(jq.MODEL_CONFIGS["qwen3-tiny"], JaxEngineConfig(
            block_q=16, block_kv=16, remat=False, attn_backend="reference",
            loss_mode="vocab", fused_qk="on"))
        out = eng.forward(jp, eng.prepare(JaxTokenTrie(seqs, attachs)))
    assert calls, "the JAX engine did not take its fused qk-prep path"
    return out


@pytest.mark.parametrize("cfg", [
    dict(),  # kernel backend, auto -> bound softmax + K8 path + fused qk-prep (plain on CPU)
    dict(fwd_softmax="online"),
    dict(attn_backend="reference"),  # dense oracle + vocab fold
    dict(block_q=32, block_kv=16, loss_mode="vocab"),
])
def test_forward_matches_jax_engine(jax_forward, cfg):
    seqs, attachs, _, tp = _setup()
    eng = TreeEngine(MODEL_CONFIGS["qwen3-tiny"], EngineConfig(**{"block_q": 16, "block_kv": 16, **cfg}),
                     device="cpu")
    got = eng.forward(tp, eng.prepare(TokenTrie(seqs, attachs)))
    assert set(got) == set(jax_forward) == set(range(len(seqs)))
    for bid, want in jax_forward.items():
        assert got[bid].shape == (len(seqs[bid]) - 1,)
        np.testing.assert_allclose(got[bid], want, atol=ATOL, rtol=0, err_msg=f"seq {bid}")


@pytest.mark.parametrize("cfg", [
    dict(),  # "auto" -> fused on the kernel backend
    dict(attn_backend="reference", loss_mode="vocab", fused_qk="on"),
])
def test_fused_forward_matches_jax_fused_engine(jax_fused_forward, cfg):
    seqs, attachs, _, tp = _setup()
    eng = TreeEngine(MODEL_CONFIGS["qwen3-tiny"], EngineConfig(**{"block_q": 16, "block_kv": 16, **cfg}),
                     device="cpu")
    assert resolve_fused_qk(eng.cfg)
    got = eng.forward(tp, eng.prepare(TokenTrie(seqs, attachs)))
    assert set(got) == set(jax_fused_forward)
    for bid, want in jax_fused_forward.items():
        np.testing.assert_allclose(got[bid], want, atol=ATOL, rtol=0, err_msg=f"seq {bid}")


@pytest.mark.parametrize("softmax", ["auto", "online"])
@pytest.mark.parametrize("seed", [1, 2])
def test_tree_equals_dense(seed, softmax):
    seqs, attachs, _, tp = _setup(seed, n_seqs=12)
    cfg = EngineConfig(block_q=16, block_kv=16, fwd_softmax=softmax)
    eng = TreeEngine(MODEL_CONFIGS["qwen3-tiny"], cfg, device="cpu")
    tree_batch = eng.prepare(TokenTrie(seqs, attachs))
    dense_batch = eng.prepare(pack_sequences_dense(seqs, attachs, pad_multiple=cfg.pad_multiple))
    assert tree_batch.packed.n_tokens < dense_batch.packed.n_tokens  # sharing exists
    lp_t, lp_d = eng.forward(tp, tree_batch), eng.forward(tp, dense_batch)
    for bid in lp_t:
        np.testing.assert_allclose(lp_t[bid], lp_d[bid], atol=ATOL, rtol=0, err_msg=f"seq {bid}")


def test_prepare_uploads_int32_metadata():
    seqs, attachs, _, _ = _setup()
    eng = TreeEngine(MODEL_CONFIGS["qwen3-tiny"], EngineConfig(block_q=64, block_kv=64), device="cpu")
    for batch in (eng.prepare(TokenTrie(seqs, attachs)),
                  eng.prepare(pack_sequences_dense(seqs, attachs, pad_multiple=64))):
        for t in (batch.tokens, batch.depth, batch.parent, batch.last_desc, *batch.meta):
            assert t.dtype == torch.int32 and t.device.type == "cpu"
        assert batch.n_padded % 64 == 0 and batch.meta[0].shape[0] == batch.n_padded // 64


@pytest.mark.parametrize("cfg,has_sched", [
    (dict(), True),  # kernel backend, "auto" -> "cached"
    (dict(bwd_mode="cached", block_q=64, block_kv=32), True),
    (dict(bwd_mode="split"), False),
    (dict(bwd_mode="fused"), False),
    (dict(attn_backend="reference"), False),
])
def test_prepare_builds_the_cache_schedule(cfg, has_sched):
    """``prepare`` appends the slot schedule (actions, flush) to the six
    metadata arrays when the kernel backend's backward is "cached", sized by
    ``cached_bwd_geometry`` (every kv block a slot: no eviction), and equal
    to the JAX package's schedule at that slot count."""
    from dynamictreeattn_tpu.tries import build_block_meta as jax_meta
    from dynamictreeattn_tpu.tries import build_bwd_cache_sched as jax_sched

    seqs, attachs, _, _ = _setup()
    cfg = EngineConfig(**{"block_q": 32, "block_kv": 32, **cfg})
    batch = TreeEngine(MODEL_CONFIGS["qwen3-tiny"], cfg, device="cpu").prepare(TokenTrie(seqs, attachs))
    assert len(batch.meta) == (8 if has_sched else 6)
    if has_sched:
        actions, flush = (t.numpy() for t in batch.meta[6:])
        n_kv = batch.n_padded // cfg.block_kv
        want = jax_sched(jax_meta(batch.packed.last_desc, cfg.block_q, cfg.block_kv), n_kv)
        np.testing.assert_array_equal(actions, want.actions)
        np.testing.assert_array_equal(flush, want.flush)
        assert flush.shape == (n_kv, 2) and not (actions[..., 3] >= 0).any()


@pytest.mark.parametrize("blocks", [(64, 128), (128, 128)])
def test_bucket_length_matches_jax(blocks):
    """The port always pads as the JAX engine's "exact" bucketing does."""
    mine = EngineConfig(block_q=blocks[0], block_kv=blocks[1])
    theirs = JaxEngineConfig(block_q=blocks[0], block_kv=blocks[1], bucketing="exact")
    assert mine.pad_multiple == theirs.pad_multiple
    for n in (1, 127, 128, 129, 1000, 6567, 37784):
        assert mine.bucket_length(n) == theirs.bucket_length(n)


def test_config_resolution_and_rejections():
    qwen, llama = MODEL_CONFIGS["qwen3-tiny"], MODEL_CONFIGS["llama-tiny"]
    # (softmax_mode, bwd_mode); "auto" backward is "cached", the JAX engine's rule
    assert resolve_kernel_modes(qwen, EngineConfig()) == ("bound", "cached")
    assert resolve_kernel_modes(llama, EngineConfig()) == ("online", "cached")
    assert resolve_kernel_modes(qwen, EngineConfig(fwd_softmax="online")) == ("online", "cached")
    for bwd in ("split", "fused", "cached"):
        assert resolve_kernel_modes(qwen, EngineConfig(bwd_mode=bwd)) == ("bound", bwd)
    assert resolve_loss_mode(EngineConfig()) == "kernel"
    assert resolve_loss_mode(EngineConfig(attn_backend="reference")) == "vocab"
    assert resolve_loss_mode(EngineConfig(loss_mode="vocab")) == "vocab"
    # fused qk-prep: "auto" (the default) is on iff the kernel backend runs,
    # the JAX engine's rule; "on"/"off" force it on either backend
    assert EngineConfig().fused_qk == "auto"
    assert resolve_fused_qk(EngineConfig()) is True
    assert resolve_fused_qk(EngineConfig(attn_backend="reference")) is False
    assert resolve_fused_qk(EngineConfig(fused_qk="off")) is False
    assert resolve_fused_qk(EngineConfig(attn_backend="reference", fused_qk="on")) is True
    with pytest.raises(ValueError, match="fused_qk"):
        EngineConfig(fused_qk="pallas")
    with pytest.raises(ValueError, match="attn_backend"):
        EngineConfig(attn_backend="pallas")
    with pytest.raises(ValueError, match="bwd_mode"):
        EngineConfig(bwd_mode="pallas")


def test_package_imports_without_cuda():
    names = [m.name for m in pkgutil.walk_packages(dynamictreeattn_tpu_torch.__path__,
                                                   "dynamictreeattn_tpu_torch.")]
    assert len(names) >= 15
    for name in names:
        importlib.import_module(name)
    assert not torch.cuda.is_initialized()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "dynamictreeattn_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 16
    bad = [(f.name, mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "flax", "dynamictreeattn_tpu")]
    assert not bad, bad
