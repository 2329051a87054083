"""The benchmark's weights, drawn from the run's seed on the device.

Every leaf has the port's name and layout (per-layer weights stacked on a
leading [L] axis, projections [in, out], an untied LM head [d, V] as a view
of [V, d] storage) and is drawn by its own generator, so that one leaf can
be drawn again alone: projections N(0, 1/fan_in), norm weights 1. Both the
program and the reference are handed these tensors; nothing here is taken
from the program.
"""

from __future__ import annotations

import hashlib

import torch


def leaf_specs(cfg: dict) -> list[tuple[tuple, tuple, int | None]]:
    """[(path, shape, fan_in or None for a norm weight)] in the port's leaf
    order; an untied head is listed as its [V, d] storage."""
    d, dh = cfg["hidden_size"], cfg["head_dim"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    L, V = cfg["num_hidden_layers"], cfg["vocab_size"]
    layers = [("ln1", (L, d), None), ("ln2", (L, d), None), ("wq", (L, d, hq * dh), d),
              ("wk", (L, d, hkv * dh), d), ("wv", (L, d, hkv * dh), d), ("wo", (L, hq * dh, d), hq * dh)]
    if cfg.get("num_experts", 0):
        E, Ie = cfg["num_experts"], cfg["moe_intermediate_size"]
        layers += [("router", (L, d, E), d), ("e_gate", (L, E, d, Ie), d), ("e_up", (L, E, d, Ie), d),
                   ("e_down", (L, E, Ie, d), Ie)]
    else:
        I = cfg["intermediate_size"]
        layers += [("gate", (L, d, I), d), ("up", (L, d, I), d), ("down", (L, I, d), I)]
    layers += [("q_norm", (L, dh), None), ("k_norm", (L, dh), None)]
    specs = [(("embed",), (V, d), d)] + [(("layers", name), shape, fan) for name, shape, fan in layers]
    specs.append((("final_norm",), (d,), None))
    if not cfg["tie_word_embeddings"]:
        specs.append((("lm_head",), (V, d), d))
    return specs


def _leaf_seed(seed: int, path: tuple) -> int:
    digest = hashlib.sha256(f"{int(seed)}:{'.'.join(path)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_leaf(cfg: dict, seed: int, path: tuple, device, dtype=torch.bfloat16) -> torch.Tensor:
    """One leaf as ``make_weights`` draws it (an untied head as its [d, V]
    view)."""
    for p, shape, fan_in in leaf_specs(cfg):
        if p == path:
            break
    else:
        raise KeyError(path)
    if fan_in is None:
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(_leaf_seed(seed, path))
    out = torch.empty(shape, dtype=dtype, device=device).normal_(0.0, fan_in ** -0.5, generator=gen)
    return out.t() if path == ("lm_head",) else out


def make_weights(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The whole model's weights in the port's nested layout."""
    params: dict = {}
    for path, _, _ in leaf_specs(cfg):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = make_leaf(cfg, seed, path, device, dtype)
    return params


def leaves(params: dict, prefix: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    """[(path, tensor)] in insertion order (the port's ``_leaves`` order)."""
    out = []
    for key, val in params.items():
        out += leaves(val, prefix + (key,)) if isinstance(val, dict) else [(prefix + (key,), val)]
    return out
