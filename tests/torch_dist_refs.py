"""The JAX references of the port's multi-rank tests (``test_torch_*`` files
that spawn ranks through ``torch_dist_worker.run_ranks``): configs, inputs
made from a seed, the JAX package's one-device engine summed over the
ranks' tries, and per-parameter relative errors."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from dynamictreeattn_tpu.engine import EngineConfig as JaxEngineConfig
from dynamictreeattn_tpu.engine import TreeEngine as JaxTreeEngine
from dynamictreeattn_tpu.models import MODEL_CONFIGS as JAX_CONFIGS
from dynamictreeattn_tpu.models import init_params as jax_init_params
from dynamictreeattn_tpu.tries import TokenTrie as JaxTokenTrie

from helpers import random_trie_batch

# the port's engine config and the JAX engine's: reference attention, the
# vocab-chunked loss, no remat, 32-row blocks, exact buckets (the port's
# padded length, which sets a MoE layer's capacity)
ECFG = dict(block_q=32, block_kv=32, remat=False, attn_backend="reference", loss_mode="vocab")
JAX_ECFG = JaxEngineConfig(block_q=32, block_kv=32, remat=False, attn_backend="reference", loss_chunk=32,
                           bucketing="exact")


def cfg_dict(name: str, **changes) -> dict:
    """A JAX config's fields as a dict (the port's Qwen3Config takes them)."""
    c = dataclasses.replace(JAX_CONFIGS[name], **changes)
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}


def jax_config(cfg: dict):
    return dataclasses.replace(JAX_CONFIGS["qwen3-tiny"], **cfg)


def numpy_tree(tree) -> dict:
    return jax.tree.map(lambda a: np.asarray(a, np.float32), jax.device_get(tree))


def init(cfg: dict, seed: int = 0) -> dict:
    """The JAX package's fp32 init, as numpy."""
    return numpy_tree(jax_init_params(jax_config(cfg), jax.random.key(seed), dtype=jnp.float32))


def rank_tries(n: int, seed: int, vocab: int = 128, n_seqs: int = 6, max_len: int = 20) -> list:
    """n tries' (seqs, attachs), one per data rank."""
    rng = np.random.default_rng(seed)
    return [random_trie_batch(rng, n_seqs=n_seqs, vocab=vocab, max_len=max_len) for _ in range(n)]


def jax_engine_sum(cfg: dict, params: dict, tries: list, ecfg=JAX_ECFG):
    """(loss, grads as {path: numpy}) of the JAX one-device engine, summed
    over the tries."""
    engine = JaxTreeEngine(jax_config(cfg), ecfg)
    jp = jax.tree.map(jnp.asarray, params)
    total, grads = 0.0, None
    for seqs, attachs in tries:
        loss, g, _ = engine.loss_and_grad(jp, engine.prepare(JaxTokenTrie(seqs, attachs)))
        total += float(loss)
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    return total, flat(numpy_tree(grads))


def flat(tree, prefix: str = "") -> dict:
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(flat(val, prefix + key + "/"))
        else:
            out[prefix + key] = np.asarray(val)
    return out


def grad_errs(ref: dict, got: dict, prefix: str = "g/") -> dict:
    """{path: ||got - ref|| / ||ref||} over ref's leaves (got keyed with `prefix`)."""
    out = {}
    for path, r in ref.items():
        g = got[prefix + path]
        assert g.shape == r.shape, (path, g.shape, r.shape)
        nr = float(np.linalg.norm(r.astype(np.float64)))
        diff = float(np.linalg.norm(g.astype(np.float64) - r))
        out[path] = diff / nr if nr > 0 else diff
    return out


def worst(errs: dict) -> tuple:
    key = max(errs, key=errs.get)
    return errs[key], key
