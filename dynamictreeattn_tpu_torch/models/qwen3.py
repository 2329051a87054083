"""Functional PyTorch Qwen3 (dense families).

Counterpart of ``dynamictreeattn_tpu/models/qwen3.py``: token embedding →
L × [RMSNorm → GQA attention with per-head q/k RMSNorm and RoPE → residual →
RMSNorm → SwiGLU MLP → residual] → final RMSNorm; the LM head is applied by
the losses (ops/losses.py).

Parameters are a plain dict with the JAX package's layout: per-layer weights
stacked on a leading [L, ...] axis, projections as ``x @ W`` with W
[in, out], the LM head [d, V] (the transposed embedding when tied). The layer
loop is a Python loop. The attention callable is injected, as in the JAX
model: the engine passes the tree kernels, tests pass the dense oracle.
Norms, RoPE and softmax statistics run in fp32; matmuls in the param dtype.
Per-head q/k RMSNorm + RoPE + the head-major transpose run either as plain
tensor code (``fused_qk=False``, the JAX model's unfused path) or through the
fused qk-prep kernels (``fused_qk=True``, ``ops/qk_prep.py``: K4/K5 forward,
K6/K7 backward), as in the JAX model. Gradients come from autograd; with
``remat=True`` each layer runs under ``torch.utils.checkpoint`` (the JAX
model's ``jax.checkpoint`` with no policy): only the layer inputs are kept,
and the backward recomputes each layer's forward.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dynamictreeattn_tpu_torch.ops.qk_prep import qkv_prep

__all__ = [
    "MODEL_CONFIGS",
    "Qwen3Config",
    "apply_rope",
    "attention_inputs",
    "forward_hidden",
    "forward_hidden_aux",
    "init_params",
    "lm_head_weight",
    "rms_norm",
    "rope_tables",
]


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    vocab_size: int = 151936
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    tie_word_embeddings: bool = True
    # Qwen2.5 / Llama variants: no per-head q/k RMSNorm; Qwen2.5 adds biases
    # on the q/k/v projections.
    use_qk_norm: bool = True
    attention_bias: bool = False
    # Rope scaling: "llama3" rescales inv_freq by wavelength band; "yarn" is
    # NTK-by-parts interpolation with an attention-factor cos/sin scale.
    rope_scaling: str | None = None  # None, "llama3", or "yarn"
    rope_factor: float = 8.0
    rope_low_freq_factor: float = 1.0  # llama3 only
    rope_high_freq_factor: float = 4.0  # llama3 only
    rope_original_max_position: int = 8192
    rope_beta_fast: float = 32.0  # yarn only
    rope_beta_slow: float = 1.0  # yarn only
    rope_attention_factor: float | None = None  # yarn; None = 0.1·ln(f)+1

    @property
    def rope_scaling_tuple(self):
        """Tagged rope-scaling spec for rope_tables (None = unscaled)."""
        if self.rope_scaling is None:
            return None
        if self.rope_scaling == "llama3":
            return ("llama3", self.rope_factor, self.rope_low_freq_factor,
                    self.rope_high_freq_factor, self.rope_original_max_position)
        if self.rope_scaling == "yarn":
            att = self.rope_attention_factor
            if att is None:
                att = (0.1 * math.log(self.rope_factor) + 1.0
                       if self.rope_factor > 1 else 1.0)
            return ("yarn", self.rope_factor, self.rope_beta_fast,
                    self.rope_beta_slow, self.rope_original_max_position,
                    float(att))
        raise ValueError(f"unknown rope_scaling {self.rope_scaling!r}")


# The JAX package's dense configurations (its MoE entries wait for the MoE
# port).
MODEL_CONFIGS: dict[str, Qwen3Config] = {
    # tiny configs for CPU tests (not published models)
    "qwen3-tiny": Qwen3Config(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, tie_word_embeddings=True,
    ),
    "qwen3-tiny-yarn": Qwen3Config(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, tie_word_embeddings=True,
        rope_scaling="yarn", rope_factor=4.0, rope_original_max_position=64,
    ),
    "llama-tiny": Qwen3Config(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, tie_word_embeddings=True, use_qk_norm=False,
        rms_norm_eps=1e-5, rope_theta=500_000.0, rope_scaling="llama3",
        rope_factor=8.0, rope_original_max_position=64,
    ),
    # published Qwen3 dense configs
    "qwen3-0.6b": Qwen3Config(
        hidden_size=1024, intermediate_size=3072, num_hidden_layers=28,
        num_attention_heads=16, num_key_value_heads=8, tie_word_embeddings=True,
    ),
    "qwen3-1.7b": Qwen3Config(
        hidden_size=2048, intermediate_size=6144, num_hidden_layers=28,
        num_attention_heads=16, num_key_value_heads=8, tie_word_embeddings=True,
    ),
    "qwen3-4b": Qwen3Config(
        hidden_size=2560, intermediate_size=9728, num_hidden_layers=36,
        num_attention_heads=32, num_key_value_heads=8, tie_word_embeddings=True,
    ),
    "qwen3-8b": Qwen3Config(
        hidden_size=4096, intermediate_size=12288, num_hidden_layers=36,
        num_attention_heads=32, num_key_value_heads=8, tie_word_embeddings=False,
    ),
    "qwen3-14b": Qwen3Config(
        hidden_size=5120, intermediate_size=17408, num_hidden_layers=40,
        num_attention_heads=40, num_key_value_heads=8, tie_word_embeddings=False,
    ),
    # long-context Qwen3 (yarn factor 4 over the 32768 native window)
    "qwen3-0.6b-128k": Qwen3Config(
        hidden_size=1024, intermediate_size=3072, num_hidden_layers=28,
        num_attention_heads=16, num_key_value_heads=8, tie_word_embeddings=True,
        rope_scaling="yarn", rope_factor=4.0, rope_original_max_position=32768,
    ),
    "qwen3-4b-128k": Qwen3Config(
        hidden_size=2560, intermediate_size=9728, num_hidden_layers=36,
        num_attention_heads=32, num_key_value_heads=8, tie_word_embeddings=True,
        rope_scaling="yarn", rope_factor=4.0, rope_original_max_position=32768,
    ),
    # Qwen2.5 dense family
    "qwen2.5-0.5b": Qwen3Config(
        hidden_size=896, intermediate_size=4864, num_hidden_layers=24,
        num_attention_heads=14, num_key_value_heads=2, head_dim=64,
        tie_word_embeddings=True, use_qk_norm=False, attention_bias=True,
    ),
    "qwen2.5-1.5b": Qwen3Config(
        hidden_size=1536, intermediate_size=8960, num_hidden_layers=28,
        num_attention_heads=12, num_key_value_heads=2, head_dim=128,
        tie_word_embeddings=True, use_qk_norm=False, attention_bias=True,
    ),
    "qwen2.5-7b": Qwen3Config(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
        head_dim=128, tie_word_embeddings=False, use_qk_norm=False,
        attention_bias=True,
    ),
    # Llama-3 family
    "llama-3.2-1b": Qwen3Config(
        vocab_size=128256, hidden_size=2048, intermediate_size=8192,
        num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
        head_dim=64, tie_word_embeddings=True, use_qk_norm=False,
        rms_norm_eps=1e-5, rope_theta=500_000.0, rope_scaling="llama3",
        rope_factor=32.0,
    ),
    "llama-3.2-3b": Qwen3Config(
        vocab_size=128256, hidden_size=3072, intermediate_size=8192,
        num_hidden_layers=28, num_attention_heads=24, num_key_value_heads=8,
        head_dim=128, tie_word_embeddings=True, use_qk_norm=False,
        rms_norm_eps=1e-5, rope_theta=500_000.0, rope_scaling="llama3",
        rope_factor=32.0,
    ),
    "llama-3.1-8b": Qwen3Config(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        head_dim=128, tie_word_embeddings=False, use_qk_norm=False,
        rms_norm_eps=1e-5, rope_theta=500_000.0, rope_scaling="llama3",
        rope_factor=8.0,
    ),
}


# ----------------------------------------------------------------------- params


def init_params(config: Qwen3Config, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random weights, N(0, 1/fan_in) projections and unit norms, drawn from
    `generator` on the generator's device. Same shapes and scales as the JAX
    package's init_params; the values differ (another generator)."""
    c = config
    d, dh = c.hidden_size, c.head_dim
    hq, hkv = c.num_attention_heads, c.num_key_value_heads
    L, I, V = c.num_hidden_layers, c.intermediate_size, c.vocab_size
    device = generator.device

    def norm(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def dense(fan_in, *shape):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * fan_in**-0.5).to(dtype)

    layers = {
        "ln1": norm(L, d),
        "ln2": norm(L, d),
        "wq": dense(d, L, d, hq * dh),
        "wk": dense(d, L, d, hkv * dh),
        "wv": dense(d, L, d, hkv * dh),
        "wo": dense(hq * dh, L, hq * dh, d),
        "gate": dense(d, L, d, I),
        "up": dense(d, L, d, I),
        "down": dense(I, L, I, d),
    }
    if c.use_qk_norm:
        layers["q_norm"] = norm(L, dh)
        layers["k_norm"] = norm(L, dh)
    if c.attention_bias:
        layers["bq"] = torch.zeros((L, hq * dh), dtype=dtype, device=device)
        layers["bk"] = torch.zeros((L, hkv * dh), dtype=dtype, device=device)
        layers["bv"] = torch.zeros((L, hkv * dh), dtype=dtype, device=device)
    params = {"embed": dense(d, V, d), "layers": layers, "final_norm": norm(d)}
    if not c.tie_word_embeddings:
        # [d, V] view of [V, d] storage: the LM-stats kernel reads rows of W.T
        params["lm_head"] = dense(d, V, d).t()
    return params


def lm_head_weight(params: dict, config: Qwen3Config) -> torch.Tensor:
    """[d, V] LM head; the transposed embedding (a view) when tied. Both
    `init_params` and `params_from_numpy` store an untied head as a view of
    [V, d] storage, so ``lm_head_weight(...).t()`` is contiguous and the
    LM-stats kernel reads it without a copy."""
    if config.tie_word_embeddings:
        return params["embed"].t()
    return params["lm_head"]


# ---------------------------------------------------------------------- helpers


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                scaling: tuple | None = None):
    """(cos, sin) [n, head_dim] fp32, HF rotate-half layout; `scaling` is
    Qwen3Config.rope_scaling_tuple (llama3 wavelength bands or YaRN)."""
    half = head_dim // 2
    dev = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=dev) / half))
    att = 1.0
    if scaling is not None and scaling[0] == "llama3":
        _, factor, lo, hi, orig = scaling
        wavelen = 2.0 * math.pi / inv_freq
        low_wavelen = orig / lo
        high_wavelen = orig / hi
        smooth = (orig / wavelen - lo) / (hi - lo)
        mid = (1.0 - smooth) * (inv_freq / factor) + smooth * inv_freq
        inv_freq = torch.where(
            wavelen > low_wavelen,
            inv_freq / factor,
            torch.where(wavelen < high_wavelen, inv_freq, mid),
        )
    elif scaling is not None and scaling[0] == "yarn":
        _, factor, beta_fast, beta_slow, orig, att = scaling
        dim = 2 * half

        def corr_dim(rot):
            return (dim * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(theta))

        low = max(math.floor(corr_dim(beta_fast)), 0)
        high = min(math.ceil(corr_dim(beta_slow)), dim - 1)
        ramp = torch.clamp(
            (torch.arange(half, dtype=torch.float32, device=dev) - low) / max(high - low, 1e-3),
            0.0, 1.0,
        )
        extrap_factor = 1.0 - ramp
        inv_freq = (inv_freq / factor) * (1.0 - extrap_factor) + inv_freq * extrap_factor
    angles = positions.float()[:, None] * inv_freq[None, :]  # [n, half]
    angles = torch.cat([angles, angles], dim=-1)  # [n, dh]
    return torch.cos(angles) * att, torch.sin(angles) * att


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [n, H, dh]; cos/sin: [n, dh]."""
    xf = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    out = xf * cos[:, None, :] + rotated * sin[:, None, :]
    return out.to(x.dtype)


# ---------------------------------------------------------------------- forward

AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def attention_inputs(h: torch.Tensor, lp: dict, cos, sin, config: Qwen3Config,
                     fused_qk: bool = False):
    """Head-major (q [hq, n, dh], k, v [hkv, n, dh]) of one layer from its
    normed input h [n, d]: projections (+ biases), per-head q/k RMSNorm, RoPE;
    with `fused_qk`, norm + RoPE + transpose in one qk-prep kernel pass."""
    c = config
    n = h.shape[0]
    dh, hq, hkv = c.head_dim, c.num_attention_heads, c.num_key_value_heads
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if c.attention_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    if fused_qk:
        if c.use_qk_norm:
            qw, kw = lp["q_norm"], lp["k_norm"]
        else:  # not read without the norm, but the kernels take a [dh] weight
            qw = kw = torch.ones(dh, dtype=h.dtype, device=h.device)
        return qkv_prep(q, k, v, qw, kw, cos, sin, c.rms_norm_eps, c.use_qk_norm)
    q = q.reshape(n, hq, dh)
    k = k.reshape(n, hkv, dh)
    v = v.reshape(n, hkv, dh)
    if c.use_qk_norm:
        q = rms_norm(q, lp["q_norm"], c.rms_norm_eps)  # per-head RMS over head_dim
        k = rms_norm(k, lp["k_norm"], c.rms_norm_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1)


def _layer(x, lp, cos, sin, config: Qwen3Config, attn_fn: AttnFn, fused_qk: bool = False):
    c = config
    n = x.shape[0]
    h = rms_norm(x, lp["ln1"], c.rms_norm_eps)
    o = attn_fn(*attention_inputs(h, lp, cos, sin, c, fused_qk))  # [hq, n, dh]
    o = o.transpose(0, 1).reshape(n, c.num_attention_heads * c.head_dim)
    x = x + o @ lp["wo"]
    h = rms_norm(x, lp["ln2"], c.rms_norm_eps)
    act = F.silu((h @ lp["gate"]).float()).to(h.dtype)
    return x + (act * (h @ lp["up"])) @ lp["down"]


def forward_hidden_aux(params: dict, config: Qwen3Config, tokens: torch.Tensor,
                       positions: torch.Tensor, attn_fn: AttnFn, remat: bool = False,
                       remat_policy: str | None = None, remat_segments: int = 0,
                       fused_qk: bool = False):
    """(hidden [n, d], aux): final-norm'd hidden states (the LM head is
    applied by the losses, ops/losses.py) and aux["lb_loss"], the router
    load-balance loss — 0 for the dense models ported so far. `positions`
    are the trie depths. `remat` recomputes every layer in the backward
    (full recompute; the qk-prep forward kernels rerun in the recompute);
    the JAX model's policies and nested segments are not ported yet.
    `fused_qk` takes the qk-prep kernels (see the module docstring)."""
    if remat_policy is not None or remat_segments:
        raise ValueError(f"remat_policy={remat_policy!r}, remat_segments={remat_segments}: "
                         "only full per-layer recompute (None, 0) is ported yet")
    c = config
    # advanced indexing: its backward sums repeated tokens in a fixed order
    # on the card (index_select's adds them with atomics)
    x = params["embed"][tokens.long()]
    cos, sin = rope_tables(positions, c.head_dim, c.rope_theta, c.rope_scaling_tuple)
    # one unbind per stacked weight: its backward stacks the 28 layer grads
    # once, where indexing would add a full-size zero-padded grad per layer
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}
    for i in range(c.num_hidden_layers):
        lp = {name: w[i] for name, w in layers.items()}
        if remat:
            x = checkpoint(_layer, x, lp, cos, sin, c, attn_fn, fused_qk, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _layer(x, lp, cos, sin, c, attn_fn, fused_qk)
    hidden = rms_norm(x, params["final_norm"], c.rms_norm_eps)
    return hidden, {"lb_loss": torch.zeros((), dtype=torch.float32, device=hidden.device)}


def forward_hidden(params: dict, config: Qwen3Config, tokens: torch.Tensor,
                   positions: torch.Tensor, attn_fn: AttnFn,
                   fused_qk: bool = False) -> torch.Tensor:
    """Final-norm'd hidden states [n, d] (see ``forward_hidden_aux``)."""
    return forward_hidden_aux(params, config, tokens, positions, attn_fn, fused_qk=fused_qk)[0]
