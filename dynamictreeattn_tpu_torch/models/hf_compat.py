"""Bridges between the port's parameter dict and the HF transformers layout.

Counterpart of ``dynamictreeattn_tpu/models/hf_compat.py``: HF ``nn.Linear``
stores weights [out, in], the port (as the JAX package) [in, out], layers
stacked [L, ...], experts [L, E, ...], an untied LM head [d, V] as a view of
[V, d] storage.

* ``hf_config``: the transformers config of a port config (Qwen3, Qwen3-MoE,
  Qwen2.5, Llama); imports ``transformers``, which only the tests need;
* ``to_hf_state_dict`` / ``from_hf_state_dict``: the two layouts, name for
  name;
* ``load_hf_checkpoint``: params from a directory of ``*.safetensors``
  shards. The reader is the port's own (``read_safetensors``): an 8-byte
  little-endian header length, a JSON header of (dtype, shape, byte
  offsets), then the raw little-endian buffers, read through
  ``torch.frombuffer`` (BF16, F16, F32). Each tensor is read when the
  stacking reaches it and copied to the device in the target dtype into
  its slice of the stacked leaf, so the host holds one tensor at a time and
  no fp32 copy of the model is ever made.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from collections.abc import Mapping

import numpy as np
import torch

from dynamictreeattn_tpu_torch.models.qwen3 import Qwen3Config

__all__ = ["from_hf_state_dict", "hf_config", "load_hf_checkpoint", "read_safetensors",
           "to_hf_state_dict"]

SAFETENSORS_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32}


def hf_config(config: Qwen3Config):
    """The matching transformers config (Qwen3, Qwen3-MoE, Qwen2 or Llama)."""
    common = dict(
        vocab_size=config.vocab_size,
        hidden_size=config.hidden_size,
        intermediate_size=config.intermediate_size,
        num_hidden_layers=config.num_hidden_layers,
        num_attention_heads=config.num_attention_heads,
        num_key_value_heads=config.num_key_value_heads,
        rms_norm_eps=config.rms_norm_eps,
        rope_theta=config.rope_theta,
        tie_word_embeddings=config.tie_word_embeddings,
    )
    if config.is_moe:
        from transformers.models.qwen3_moe import Qwen3MoeConfig

        if not config.use_qk_norm or config.attention_bias:
            raise ValueError("a Qwen3-MoE config has the q/k norm and no attention bias")
        return Qwen3MoeConfig(
            head_dim=config.head_dim, attention_bias=False, num_experts=config.num_experts,
            num_experts_per_tok=config.num_experts_per_tok,
            moe_intermediate_size=config.moe_intermediate_size,
            norm_topk_prob=config.norm_topk_prob, decoder_sparse_step=1, mlp_only_layers=[],
            **common,
        )
    if config.use_qk_norm:
        from transformers.models.qwen3 import Qwen3Config as HFQwen3Config

        if config.attention_bias:
            raise ValueError("a Qwen3 config has no attention bias")
        rope_scaling = None
        if config.rope_scaling is not None:
            if config.rope_scaling != "yarn":
                raise ValueError(f"Qwen3 ships yarn rope scaling, not {config.rope_scaling!r}")
            rope_scaling = {
                "rope_type": "yarn", "factor": config.rope_factor,
                "beta_fast": config.rope_beta_fast, "beta_slow": config.rope_beta_slow,
                "original_max_position_embeddings": config.rope_original_max_position,
            }
            if config.rope_attention_factor is not None:
                rope_scaling["attention_factor"] = config.rope_attention_factor
        return HFQwen3Config(
            head_dim=config.head_dim, attention_bias=False, rope_scaling=rope_scaling,
            max_position_embeddings=max(40960, int(config.rope_factor * config.rope_original_max_position)),
            **common,
        )
    if not config.attention_bias:
        from transformers.models.llama import LlamaConfig

        rope_scaling = None
        if config.rope_scaling is not None:
            rope_scaling = {
                "rope_type": config.rope_scaling, "factor": config.rope_factor,
                "low_freq_factor": config.rope_low_freq_factor,
                "high_freq_factor": config.rope_high_freq_factor,
                "original_max_position_embeddings": config.rope_original_max_position,
            }
        return LlamaConfig(head_dim=config.head_dim, attention_bias=False, mlp_bias=False,
                           rope_scaling=rope_scaling, **common)
    from transformers.models.qwen2 import Qwen2Config

    if config.head_dim * config.num_attention_heads != config.hidden_size:
        raise ValueError("Qwen2 derives head_dim from the hidden size")
    return Qwen2Config(**common)


def _names(config: Qwen3Config) -> list[tuple[str, str, bool, tuple]]:
    """(leaf, HF name pattern over the layer {0} and expert {1}, whether HF
    stores it transposed, the port's shape of one layer's (or expert's)
    slice) of every stacked leaf."""
    c = config
    d, dh, hq, hkv = c.hidden_size, c.head_dim, c.num_attention_heads, c.num_key_value_heads
    attn = "model.layers.{0}.self_attn."
    out = [("ln1", "model.layers.{0}.input_layernorm.weight", False, (d,)),
           ("ln2", "model.layers.{0}.post_attention_layernorm.weight", False, (d,)),
           ("wq", attn + "q_proj.weight", True, (d, hq * dh)),
           ("wk", attn + "k_proj.weight", True, (d, hkv * dh)),
           ("wv", attn + "v_proj.weight", True, (d, hkv * dh)),
           ("wo", attn + "o_proj.weight", True, (hq * dh, d))]
    if c.use_qk_norm:
        out += [("q_norm", attn + "q_norm.weight", False, (dh,)),
                ("k_norm", attn + "k_norm.weight", False, (dh,))]
    if c.attention_bias:
        out += [("bq", attn + "q_proj.bias", False, (hq * dh,)),
                ("bk", attn + "k_proj.bias", False, (hkv * dh,)),
                ("bv", attn + "v_proj.bias", False, (hkv * dh,))]
    if c.is_moe:
        Ie = c.moe_intermediate_size
        ex = "model.layers.{0}.mlp.experts.{1}."
        out += [("router", "model.layers.{0}.mlp.gate.weight", True, (d, c.num_experts)),
                ("e_gate", ex + "gate_proj.weight", True, (d, Ie)),
                ("e_up", ex + "up_proj.weight", True, (d, Ie)),
                ("e_down", ex + "down_proj.weight", True, (Ie, d))]
    else:
        mlp, I = "model.layers.{0}.mlp.", c.intermediate_size
        out += [("gate", mlp + "gate_proj.weight", True, (d, I)),
                ("up", mlp + "up_proj.weight", True, (d, I)),
                ("down", mlp + "down_proj.weight", True, (I, d))]
    return out


_INIT_ORDER = ("ln1", "ln2", "wq", "wk", "wv", "wo", "router", "e_gate", "e_up", "e_down", "gate", "up", "down",
               "q_norm", "k_norm", "bq", "bk", "bv")


def _is_expert(name: str) -> bool:
    return name in ("e_gate", "e_up", "e_down")


def to_hf_state_dict(params: dict, config: Qwen3Config) -> dict:
    """{HF Qwen3ForCausalLM / Qwen3MoeForCausalLM name: contiguous tensor}
    in each leaf's dtype, on the params' device; a tied head's
    "lm_head.weight" is the embedding tensor itself."""
    c = config
    lp = params["layers"]

    def out(t):
        return t.contiguous()

    names = _names(c)
    experts = [(leaf, pattern) for leaf, pattern, _, _ in names if _is_expert(leaf)]
    sd = {"model.embed_tokens.weight": out(params["embed"])}
    for i in range(c.num_hidden_layers):
        for leaf, pattern, transposed, _ in names:
            if not _is_expert(leaf):
                sd[pattern.format(i)] = out(lp[leaf][i].t() if transposed else lp[leaf][i])
        for e in range(c.num_experts if experts else 0):  # expert by expert: gate, up, down
            for leaf, pattern in experts:
                sd[pattern.format(i, e)] = out(lp[leaf][i, e].t())
    sd["model.norm.weight"] = out(params["final_norm"])
    sd["lm_head.weight"] = (sd["model.embed_tokens.weight"] if c.tie_word_embeddings
                            else out(params["lm_head"].t()))
    return sd


def from_hf_state_dict(sd: Mapping, config: Qwen3Config, dtype: torch.dtype = torch.bfloat16,
                       device="cuda") -> dict:
    """Inverse of ``to_hf_state_dict``: the port's params in `dtype` on
    `device`. `sd` maps HF names to tensors or numpy arrays; each is read
    once, when its slice of the stacked leaf is filled, and copied there on
    the device (a lazy mapping, as ``load_hf_checkpoint`` passes, is read one
    tensor at a time). An untied head comes out as a [d, V] view of [V, d]
    storage, as ``init_params`` stores it."""
    c = config
    dev = torch.device(device)

    def get(name) -> torch.Tensor:
        t = sd[name]
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.array(t))
        return t.to(device=dev, dtype=dtype)

    layers = {}
    for leaf, pattern, transposed, shape in _names(c):
        lead = (c.num_hidden_layers, c.num_experts) if _is_expert(leaf) else (c.num_hidden_layers,)
        w = torch.empty(lead + shape, dtype=dtype, device=dev)
        for i in range(c.num_hidden_layers):
            for e, dst in (enumerate(w[i]) if _is_expert(leaf) else [(0, w[i])]):
                t = get(pattern.format(i, e))
                dst.copy_(t.t() if transposed else t)
        layers[leaf] = w
    layers = {name: layers[name] for name in _INIT_ORDER if name in layers}  # init_params' order
    params = {"embed": get("model.embed_tokens.weight"), "layers": layers,
              "final_norm": get("model.norm.weight")}
    if not c.tie_word_embeddings:
        params["lm_head"] = get("lm_head.weight").t()  # [d, V] view of [V, d] storage
    return params


def read_safetensors(path: str) -> dict:
    """{name: a function that reads the tensor} of one ``.safetensors``
    file: each call reads that tensor's bytes from the file into a new CPU
    tensor of its stored dtype and shape (BF16, F16 or F32; little-endian,
    as the format stores them and this host reads them)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, not one of {list(SAFETENSORS_DTYPES)}")

        def read(info=info, name=name):
            lo, hi = info["data_offsets"]
            buf = bytearray(hi - lo)
            with open(path, "rb") as f:
                f.seek(base + lo)
                if f.readinto(buf) != len(buf):
                    raise ValueError(f"{path}: truncated at {name}")
            dt = SAFETENSORS_DTYPES[info["dtype"]]
            if not buf:
                return torch.empty(info["shape"], dtype=dt)
            return torch.frombuffer(buf, dtype=dt).reshape(info["shape"])

        out[name] = read
    return out


class _Shards(Mapping):
    """HF name -> tensor over the shards of a checkpoint directory, each
    tensor read from its file when it is looked up."""

    def __init__(self, readers: dict):
        self.readers = readers

    def __getitem__(self, name):
        return self.readers[name]()

    def __iter__(self):
        return iter(self.readers)

    def __len__(self):
        return len(self.readers)


def load_hf_checkpoint(path: str, config: Qwen3Config, dtype: torch.dtype = torch.bfloat16,
                       device="cuda") -> dict:
    """Params from a HF checkpoint directory of ``*.safetensors`` shards,
    in `dtype` on `device`, one tensor at a time (module docstring). A tied
    model may leave "lm_head.weight" out."""
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no safetensors under {path}")
    readers = {}
    for f in files:
        readers.update(read_safetensors(f))
    return from_hf_state_dict(_Shards(readers), config, dtype, device)
