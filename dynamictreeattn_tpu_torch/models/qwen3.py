"""Functional PyTorch Qwen3 (dense and MoE families).

Counterpart of ``dynamictreeattn_tpu/models/qwen3.py``: token embedding →
L × [RMSNorm → GQA attention with per-head q/k RMSNorm and RoPE → residual →
RMSNorm → SwiGLU MLP, or (Qwen3-MoE) top-k routed SwiGLU experts →
residual] → final RMSNorm; the LM head is applied by the losses
(ops/losses.py).

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
model's ``jax.checkpoint``) and keeps what its policy names, the backward
recomputing the rest of the layer's forward:

* None: the layer input only (full recompute);
* "dots": also the outputs of the seven projection products (q, k, v, o,
  gate, up, down) (JAX's ``dots_with_no_batch_dims_saveable``); the
  attention and qk-prep forward kernels rerun;
* "attn": also the tree attention's (o, lse), so the attention forward
  kernel runs once a step; q/k/v and qk-prep rerun (JAX's names
  ``tree_attn_o``, ``tree_attn_lse``);
* "attn_dots": both.

The kept values are handed from the first forward to the recompute
explicitly (``RematHandoff``: the products through ``_Product``, (o, lse)
through the attention callable's ``handoff`` argument): the kernels are
ctypes calls that selective checkpointing cannot see, and its Python
dispatch of every op of the layer made "dots" host-bound on the card
(PERF.md).

With ``remat_segments = G``, checkpointing nests: an outer checkpoint over
each of G segments of L/G inner-checkpointed layers keeps G + L/G layer
inputs at the cost of one more forward of each layer. The outer forward
keeps nothing of the policy's; the outer recompute keeps it, and each
layer's inner recompute takes it back (JAX's inner ``jax.checkpoint`` with
the policy). PyTorch's checkpoint stops the outer recompute once it has the
last layer input it needs, so each segment's last layer runs no forward
there and its inner recompute computes everything again.

MoE layers (``num_experts > 0``) route each row to its top-k experts
(``moe_route``: fp32 router logits, softmax, top-k, renormalised, the
load-balance loss E · Σ_e f_e·P̄_e over the rows that `valid` marks) and
dispatch by capacity (``moe_apply``): the (row, choice) pairs sorted stably
by expert, the first ``capacity`` of each expert gathered into a static
[E, capacity, d] buffer, the rest dropped, three batched expert products,
and the weighted combine summed in fp32 over each row's k choices. The
capacity, ceil(moe_capacity_factor · n · k / E), is a host integer from the
row count n alone, never from the data: no host read, and the dispatch is
capturable in a CUDA graph. The dispatch is gathers by a permutation and
the combine a reduction, and their backward passes are gathers through the
same permutation, so no float is summed by atomics, and no index is
accumulated into, in the forward or the backward. ``forward_hidden_aux``
sums each layer's load-balance loss into aux["lb_loss"]. Under "dots" the
router product is kept with the seven (JAX's
``dots_with_no_batch_dims_saveable`` keeps it too, and not the batched
expert products).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import sys
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dynamictreeattn_tpu_torch.ops.qk_prep import qkv_prep
from dynamictreeattn_tpu_torch.utils.profiling import counter, device_region, span

__all__ = [
    "BUFFERS",
    "MODEL_CONFIGS",
    "Qwen3Config",
    "RematHandoff",
    "apply_rope",
    "attention_inputs",
    "forward_hidden",
    "forward_hidden_aux",
    "init_params",
    "run_layers",
    "lm_head_weight",
    "logits_from_hidden",
    "moe_apply",
    "moe_capacity",
    "moe_route",
    "pack_pairs",
    "rms_norm",
    "rope_tables",
]

# the params' top-level key of what a model reads and nothing trains (a
# DeepSeek-V3 model's routing bias): the engine differentiates none of it
# and the optimizer keeps no moments for it (``engine.tree_engine.trainable``)
BUFFERS = "buffers"


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
    # Qwen3-MoE variants: sparse SwiGLU experts with softmax top-k routing
    # (HF Qwen3Moe)
    num_experts: int = 0  # 0 = dense MLP
    num_experts_per_tok: int = 8
    moe_intermediate_size: int = 768
    norm_topk_prob: bool = True
    # per-expert capacity = ceil(cap_factor · n·k/E); the (row, choice) pairs
    # past it are dropped (``moe_apply``); raise it for exactness
    moe_capacity_factor: float = 1.5
    router_aux_coef: float = 0.001  # load-balance aux loss weight (0 = off)
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
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_mla(self) -> bool:
        """Latent attention (``models/deepseek_v3.py``'s ``DeepseekV3Config``)."""
        return False

    @property
    def family(self):
        """The module that draws and runs this config's model (its
        ``init_params`` and ``forward_hidden_aux``): this one."""
        return sys.modules[__name__]

    @property
    def attn_widths(self) -> tuple[int, int]:
        """(q/k width, v width) of an attention head."""
        return self.head_dim, self.head_dim

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


# The JAX package's configurations.
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
    "qwen3-moe-tiny": Qwen3Config(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, tie_word_embeddings=True,
        num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32,
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
    # Qwen3 MoE family: Qwen3-30B-A3B (published), and a single-card MoE
    # config of the JAX package's bench (~0.8B total, ~0.25B active; not a
    # published model)
    "qwen3-30b-a3b": Qwen3Config(
        hidden_size=2048, intermediate_size=6144, num_hidden_layers=48,
        num_attention_heads=32, num_key_value_heads=4, head_dim=128,
        tie_word_embeddings=False,
        num_experts=128, num_experts_per_tok=8, moe_intermediate_size=768,
    ),
    "qwen3-moe-demo": Qwen3Config(
        hidden_size=1024, intermediate_size=3072, num_hidden_layers=12,
        num_attention_heads=16, num_key_value_heads=8, head_dim=128,
        tie_word_embeddings=True,
        num_experts=32, num_experts_per_tok=4, moe_intermediate_size=512,
    ),
}


# ----------------------------------------------------------------------- params


def init_params(config: Qwen3Config, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random weights, N(0, 1/fan_in) projections and unit norms, drawn from
    `generator` on the generator's device. Same shapes and scales as the JAX
    package's init_params; the values differ (another generator). A MoE
    config's expert leaves are drawn one layer at a time into the `dtype`
    leaf (Qwen3-30B-A3B's [48, 128, 2048, 768] drawn whole in fp32 would
    take 38.7 GB)."""
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

    def dense_by_layer(fan_in, *shape):
        out = torch.empty(shape, dtype=dtype, device=device)
        for layer in out:
            layer.copy_(dense(fan_in, *layer.shape))
        return out

    layers = {
        "ln1": norm(L, d),
        "ln2": norm(L, d),
        "wq": dense(d, L, d, hq * dh),
        "wk": dense(d, L, d, hkv * dh),
        "wv": dense(d, L, d, hkv * dh),
        "wo": dense(hq * dh, L, hq * dh, d),
    }
    if c.is_moe:
        E, Ie = c.num_experts, c.moe_intermediate_size
        layers["router"] = dense(d, L, d, E)
        layers["e_gate"] = dense_by_layer(d, L, E, d, Ie)
        layers["e_up"] = dense_by_layer(d, L, E, d, Ie)
        layers["e_down"] = dense_by_layer(Ie, L, E, Ie, d)
    else:
        layers["gate"] = dense(d, L, d, I)
        layers["up"] = dense(d, L, d, I)
        layers["down"] = dense(I, L, I, d)
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

# attn_fn(q, k, v) -> o; under a remat policy that keeps the attention's
# (o, lse), also attn_fn(q, k, v, handoff=...) (``ops.tree_attention``)
AttnFn = Callable[..., torch.Tensor]


REMAT_POLICIES = (None, "dots", "attn", "attn_dots")


class RematHandoff:
    """What a checkpointed layer's first forward hands to its recompute, in
    call order: the tree attention's (o, lse) when `attn`, the seven
    projection products when `dots`. A forward that keeps stores each value;
    the recompute, which makes the same calls in the same order, takes them
    back and computes none of them again; a forward that neither keeps nor
    finds values computes everything. The port's kernels are ctypes calls
    inside autograd functions, out of the reach of ``torch.utils.checkpoint``'s
    selective checkpointing, so they are handed over explicitly: the JAX
    remat policies "attn" (``tree_attn_o``, ``tree_attn_lse``) and "dots"
    (the products without batch dims)."""

    def __init__(self, attn: bool, dots: bool):
        self.attn, self.dots = attn, dots
        self.saved: collections.deque = collections.deque()
        self.taking = self.keeping = False

    def begin(self, keep: bool) -> None:
        """Enter the layer: take the values kept for it, if any; else
        compute them, keeping them when `keep`."""
        self.taking = bool(self.saved)
        self.keeping = keep and not self.taking

    def keep(self, value) -> None:
        if self.keeping:
            self.saved.append(value)

    def take(self):
        return self.saved.popleft()


class _Product(torch.autograd.Function):
    """a @ w under the "dots" policy: computed and kept, or taken back in
    the recompute (``RematHandoff``); the backward is the product's
    (g @ w^T, a^T @ g)."""

    @staticmethod
    def forward(ctx, a, w, handoff):
        if handoff.taking:
            out = handoff.take()
        else:
            out = a @ w
            handoff.keep(out.detach())
        ctx.save_for_backward(a, w)
        return out

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        return (g @ w.t() if ctx.needs_input_grad[0] else None,
                a.t() @ g if ctx.needs_input_grad[1] else None, None)


def _dot(a: torch.Tensor, w: torch.Tensor, handoff: RematHandoff | None = None) -> torch.Tensor:
    """a @ w, kept for the recompute when the layer's policy keeps products."""
    if handoff is None or not handoff.dots:
        return a @ w
    return _Product.apply(a, w, handoff)


def attention_inputs(h: torch.Tensor, lp: dict, cos, sin, config: Qwen3Config,
                     fused_qk: bool = False, handoff: RematHandoff | None = None):
    """Head-major (q [hq, n, dh], k, v [hkv, n, dh]) of one layer from its
    normed input h [n, d]: projections (+ biases), per-head q/k RMSNorm, RoPE;
    with `fused_qk`, norm + RoPE + transpose in one qk-prep kernel pass."""
    c = config
    n = h.shape[0]
    dh, hq, hkv = c.head_dim, c.num_attention_heads, c.num_key_value_heads
    q = _dot(h, lp["wq"], handoff)
    k = _dot(h, lp["wk"], handoff)
    v = _dot(h, lp["wv"], handoff)
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


# -------------------------------------------------------------------------- MoE


def moe_capacity(config: Qwen3Config, rows: int) -> int:
    """Per-expert capacity when `rows` rows are routed (padding included):
    ceil(moe_capacity_factor · rows · k / E), as the JAX ``_moe_block``
    computes it."""
    c = config
    return int(math.ceil(c.moe_capacity_factor * rows * c.num_experts_per_tok / c.num_experts))


def moe_route(h: torch.Tensor, router: torch.Tensor, config: Qwen3Config, valid=None,
              handoff: RematHandoff | None = None, groups=()):
    """Router + top-k + load-balance loss: (w [n, k] fp32, idx [n, k] int64,
    lb fp32 scalar). The logits are fp32 products of the param-dtype values
    (JAX ``preferred_element_type=float32``); top-k of the softmax,
    renormalised when ``norm_topk_prob`` (ties, which random fp32
    probabilities do not produce, are not ordered as ``jax.lax.top_k``
    orders them). With `valid` ([n], nonzero = a real row) padding rows get
    idx = E, which no expert receives, and are left out of the statistics.
    lb = E · Σ_e f_e·P̄_e: f_e the share of the routed (row, choice) pairs
    that chose e, P̄_e the mean router probability of e over the real rows
    (HF Qwen3Moe's load_balancing_loss_func, masked like its
    attention_mask path). `groups`: process groups over which the
    statistics (counts, n_eff, prob_sum) are summed before lb, JAX's
    `stat_axes` (the "seq" group under sequence parallelism, where every
    rank routes a slice of one trie); prob_sum's sum carries its gradient
    back (``parallel.collectives.psum``)."""
    with span("moe.route"):
        c = config
        n = h.shape[0]
        E, k = c.num_experts, c.num_experts_per_tok
        probs = torch.softmax(_dot(h.float(), router.float(), handoff), dim=-1)  # [n, E] fp32
        w, idx = torch.topk(probs, k, dim=-1)
        if c.norm_topk_prob:
            w = w / torch.sum(w, dim=-1, keepdim=True)
        if valid is None:
            n_eff = float(n)
            prob_sum = torch.sum(probs, dim=0)
        else:
            m = valid.float()
            idx = torch.where(valid[:, None] > 0, idx, E)
            n_eff = torch.sum(m)
            prob_sum = torch.sum(probs * m[:, None], dim=0)
        # integer counts by comparison, summed without atomics
        counts = (idx.reshape(-1, 1) == torch.arange(E, device=h.device)).sum(0).float()
        if groups:  # (the parallel package imports this module: imported here)
            from dynamictreeattn_tpu_torch.parallel.collectives import all_reduce_, psum

            stats = torch.cat([counts, torch.as_tensor(n_eff, dtype=torch.float32, device=h.device).reshape(1)])
            for group in groups:
                stats = all_reduce_(stats, group)
                prob_sum = psum(prob_sum, group)
            counts, n_eff = stats[:E], stats[E]
        n_eff = torch.clamp(n_eff, min=1.0) if isinstance(n_eff, torch.Tensor) else max(n_eff, 1.0)
        lb = E * torch.sum((counts / (n_eff * k)) * (prob_sum / n_eff))
        return w, idx, lb


class _Dispatch(torch.autograd.Function):
    """The expert buffer [E*capacity, d]: slot s holds row tok_of_slot[s] of
    h where filled[s], zeros elsewhere. Its backward gathers each row's
    kept slots (slot, keep: [n, k]) and sums them over the k choices in
    order, in fp32: gathers only, where the backward of advanced indexing
    would accumulate into one repeated row per unfilled slot."""

    @staticmethod
    def forward(ctx, h, tok_of_slot, filled, slot, keep):
        ctx.save_for_backward(slot, keep)
        return h[tok_of_slot].masked_fill_(~filled[:, None], 0)

    @staticmethod
    def backward(ctx, g):
        slot, keep = ctx.saved_tensors
        acc, gh = torch.promote_types(g.dtype, torch.float32), None
        for j in range(slot.shape[1]):
            part = g[slot[:, j]].to(acc).masked_fill_(~keep[:, j:j + 1], 0)
            gh = part if gh is None else gh + part
        return gh.to(g.dtype), None, None, None, None


class _Combine(torch.autograd.Function):
    """y [n, d] in wk's dtype (fp32) = sum over the k choices, in order, of wk[:, j] times
    the expert output in slot[:, j] (wk is 0 on dropped pairs). Its
    backward: the grad of slot s is the weight of the pair it holds times dy
    of that pair's row (0 where unfilled), the grad of wk[t, j] is
    dy[t] · out[slot[t, j]]: gathers only."""

    @staticmethod
    def forward(ctx, out, wk, slot, tok_of_slot, pair_of_slot, filled):
        ctx.save_for_backward(out, wk, slot, tok_of_slot, pair_of_slot, filled)
        y = None
        for j in range(slot.shape[1]):
            part = out[slot[:, j]].to(wk.dtype) * wk[:, j:j + 1]
            y = part if y is None else y + part
        return y

    @staticmethod
    def backward(ctx, gy):
        out, wk, slot, tok_of_slot, pair_of_slot, filled = ctx.saved_tensors
        g_out = g_wk = None
        if ctx.needs_input_grad[0]:
            w_slot = torch.where(filled, wk.reshape(-1)[pair_of_slot], 0)
            g_out = (gy[tok_of_slot] * w_slot[:, None]).to(out.dtype)
        if ctx.needs_input_grad[1]:
            g_wk = torch.stack([torch.sum(gy * out[slot[:, j]].to(gy.dtype), dim=-1)
                                for j in range(slot.shape[1])], dim=1)
        return g_out, g_wk, None, None, None, None


def pack_pairs(idx: torch.Tensor, buckets: int, capacity: int):
    """The capacity dispatch's bijection between kept (row, choice) pairs
    and filled buffer slots, for idx [n, k] bucket ids (out of [0,
    buckets): never kept). The pairs, in row-major order, are sorted stably
    by bucket; a pair's rank is its place among its bucket's pairs, and the
    first `capacity` of each bucket are kept. Returns (slot [n, k], keep
    [n, k], tok_of_slot, pair_of_slot, filled [buckets * capacity]): slot
    (b, c) = b * capacity + c holds pair pair_of_slot (row tok_of_slot)
    where filled."""
    n, k = idx.shape
    nk = n * k
    dev = idx.device
    flat = idx.reshape(-1)
    key = torch.where((flat >= 0) & (flat < buckets), flat, buckets)  # out of range: a tail bucket
    sorted_b, order = torch.sort(key, stable=True)
    bounds = torch.searchsorted(sorted_b, torch.arange(buckets + 1, device=dev))  # starts, tail start
    starts, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    # slot (b, c) holds the pair at sorted place starts[b] + c
    cols = torch.arange(capacity, device=dev)
    pair_of_slot = order[(starts[:, None] + cols).clamp(max=nk - 1).reshape(-1)]
    filled = (cols < counts[:, None]).reshape(-1)
    # each pair's rank from its place in the sorted order
    place = torch.empty_like(order)
    place[order] = torch.arange(nk, device=dev)
    b = key.clamp(max=buckets - 1)
    rank = place - starts[b]
    keep = (key < buckets) & (rank < capacity)
    slot = torch.where(keep, b * capacity + rank, 0).reshape(n, k)
    return slot, keep.reshape(n, k), pair_of_slot // k, pair_of_slot, filled


def moe_apply(h: torch.Tensor, e_gate: torch.Tensor, e_up: torch.Tensor, e_down: torch.Tensor,
              idx: torch.Tensor, w: torch.Tensor, capacity: int) -> torch.Tensor:
    """Capacity dispatch → batched expert products → weighted combine:
    y [n, d] in h's dtype. h [n, d]; e_gate/e_up [E, d, Ie], e_down
    [E, Ie, d]; idx [n, k] expert ids (out of [0, E): skipped); w [n, k]
    fp32 weights; `capacity` a host integer.

    The (row, choice) pairs, in row-major order, are sorted stably by
    expert; a pair's rank is its place among its expert's pairs, and the
    first `capacity` of each expert are kept, the rest dropped (the JAX
    ``moe_apply``'s set, pair for pair). Buffer slot (e, c) gathers the row
    of expert e's c-th pair, or zeros; y sums each row's k kept expert
    outputs times their weights in fp32, over the k choices in order. Kept
    pairs and filled slots are one bijection, and both backward passes
    gather through it (``_Dispatch``, ``_Combine``).

    While a step's parts are collected (``utils.profiling``), the pairs
    with an expert in [0, E) count into "moe.pairs" and those past their
    expert's capacity into "moe.dropped"."""
    n, d = h.shape
    E = e_gate.shape[0]
    with span("moe.dispatch"):
        slot, keep, tok_of_slot, pair_of_slot, filled = pack_pairs(idx, E, capacity)
        parts = counter()
        if parts is not None:
            pairs = ((idx >= 0) & (idx < E)).sum()
            parts.count("moe.pairs", pairs)
            parts.count("moe.dropped", pairs - keep.sum())
        buf = _Dispatch.apply(h, tok_of_slot, filled, slot, keep).reshape(E, capacity, d)
    with span("moe.experts"):
        a = torch.bmm(buf, e_gate)
        b = torch.bmm(buf, e_up)
        del buf  # without autograd, each [E, capacity, ...] transient goes as soon as it is used
        act = F.silu(a.to(torch.promote_types(a.dtype, torch.float32))).to(b.dtype) * b
        del a, b
        out = torch.bmm(act, e_down).reshape(E * capacity, d)
        del act
    with span("moe.combine"):
        wk = w.to(torch.promote_types(w.dtype, torch.float32)) * keep  # fp32 (fp64 weights stay fp64)
        y = _Combine.apply(out, wk, slot, tok_of_slot, pair_of_slot, filled)
        return y.to(h.dtype)


def _moe_block(h: torch.Tensor, lp: dict, config: Qwen3Config, valid=None, capacity: int | None = None,
               handoff: RematHandoff | None = None):
    """Router + top-k + dispatch: (y [n, d], lb fp32 scalar). `capacity`
    defaults to ``moe_capacity`` of the n rows."""
    w, idx, lb = moe_route(h, lp["router"], config, valid, handoff)
    if capacity is None:
        capacity = moe_capacity(config, h.shape[0])
    return moe_apply(h, lp["e_gate"], lp["e_up"], lp["e_down"], idx, w, capacity), lb


def _layer(x, lp, cos, sin, config: Qwen3Config, attn_fn: AttnFn, fused_qk: bool = False,
           handoff: RematHandoff | None = None, valid=None, capacity: int | None = None):
    """One layer: (x, lb), lb the MoE load-balance loss (None for a dense
    MLP). `valid` and `capacity` reach the MoE block (``_moe_block``)."""
    c = config
    n = x.shape[0]
    h = rms_norm(x, lp["ln1"], c.rms_norm_eps)
    qkv = attention_inputs(h, lp, cos, sin, c, fused_qk, handoff)
    o = attn_fn(*qkv, handoff=handoff) if handoff is not None and handoff.attn else attn_fn(*qkv)
    o = o.transpose(0, 1).reshape(n, c.num_attention_heads * c.head_dim)  # o: [hq, n, dh]
    x = x + _dot(o, lp["wo"], handoff)
    h = rms_norm(x, lp["ln2"], c.rms_norm_eps)
    if c.is_moe:  # its device time is part "moe" while a step's parts are collected
        y, lb = device_region("moe", lambda h: _moe_block(h, lp, c, valid, capacity, handoff), h)
        return x + y, lb
    act = F.silu(_dot(h, lp["gate"], handoff).float()).to(h.dtype)
    return x + _dot(act * _dot(h, lp["up"], handoff), lp["down"], handoff), None


def _remat_layer(x, lp, cos, sin, config, attn_fn, fused_qk, handoff: RematHandoff | None, keep: bool,
                 valid=None, layer_fn=None):
    """`layer_fn` (default ``_layer``) under ``torch.utils.checkpoint``:
    (x, lb). With a `handoff` the first run keeps the policy's values there
    when `keep`, and a later run (the recompute) takes what was kept."""
    runs = 0
    layer_fn = layer_fn or _layer

    def layer(x, *args, **kwargs):
        nonlocal runs
        runs += 1
        if handoff is not None:
            handoff.begin(keep and runs == 1)
        return layer_fn(x, *args, handoff=handoff, **kwargs)

    return checkpoint(layer, x, lp, cos, sin, config, attn_fn, fused_qk, use_reentrant=False,
                      preserve_rng_state=False, valid=valid)


def run_layers(x: torch.Tensor, layers: dict, config: Qwen3Config, cos, sin, attn_fn: AttnFn,
               remat: bool = False, remat_policy: str | None = None, remat_segments: int = 0,
               fused_qk: bool = False, valid=None, layer_fn=None):
    """(x, lb): `x` [n, d] through the stacked `layers` ({name: [L', ...]},
    L' = their leading dim: the whole model's or one pipeline stage's) with
    ``forward_hidden_aux``'s remat machinery; lb the MoE load-balance loss
    summed over them (0 for a dense model)."""
    c = config
    L = next(iter(layers.values())).shape[0]
    layer_fn = layer_fn or _layer
    # one unbind per stacked weight: its backward stacks the layer grads
    # once, where indexing would add a full-size zero-padded grad per layer
    stacks = {name: w.unbind(0) for name, w in layers.items()}
    lps = [{name: w[i] for name, w in stacks.items()} for i in range(L)]
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat_policy!r}")
    attn, dots = remat_policy in ("attn", "attn_dots"), remat_policy in ("dots", "attn_dots")
    lb = torch.zeros((), dtype=torch.float32, device=x.device) if c.is_moe else None

    def add(lb, lb_i):
        return lb if lb_i is None else lb + lb_i

    def handoff():
        return RematHandoff(attn, dots) if (attn or dots) and torch.is_grad_enabled() else None

    if not remat:
        for lp in lps:
            x, lb_i = layer_fn(x, lp, cos, sin, c, attn_fn, fused_qk, valid=valid)
            lb = add(lb, lb_i)
    elif remat_segments:
        G = remat_segments
        if L % G:
            raise ValueError(f"{L=} not divisible by {remat_segments=}")
        S = L // G
        # one hand-off a layer, shared by the outer forward (keeps nothing),
        # the outer recompute (keeps) and the inner recompute (takes)
        handoffs = [handoff() for _ in range(L)]
        runs = [0] * G

        def segment(x, lb, g):
            runs[g] += 1
            for i in range(g * S, (g + 1) * S):
                x, lb_i = _remat_layer(x, lps[i], cos, sin, c, attn_fn, fused_qk, handoffs[i], runs[g] > 1,
                                       valid, layer_fn)
                lb = add(lb, lb_i)
            return x, lb

        for g in range(G):
            x, lb = checkpoint(segment, x, lb, g, use_reentrant=False, preserve_rng_state=False)
    else:
        for lp in lps:
            x, lb_i = _remat_layer(x, lp, cos, sin, c, attn_fn, fused_qk, handoff(), True, valid, layer_fn)
            lb = add(lb, lb_i)
    if lb is None:
        lb = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, lb


def forward_hidden_aux(params: dict, config: Qwen3Config, tokens: torch.Tensor,
                       positions: torch.Tensor, attn_fn: AttnFn, remat: bool = False,
                       remat_policy: str | None = None, remat_segments: int = 0,
                       fused_qk: bool = False, valid=None, layer_fn=None, embed_fn=None):
    """(hidden [n, d], aux): final-norm'd hidden states (the LM head is
    applied by the losses, ops/losses.py) and aux["lb_loss"], the router
    load-balance loss summed over the layers (0 for a dense model).
    `positions` are the trie depths. `remat` recomputes every layer in the
    backward, keeping what `remat_policy` names; `remat_segments` > 0 nests
    the checkpoints (module docstring; L must divide by it). `fused_qk`
    takes the qk-prep kernels. `valid` ([n], nonzero = a real row) keeps
    padding rows out of MoE routing: out of the load-balance statistics and
    out of every expert's capacity; the capacity comes from all n rows, as
    in the JAX model. `layer_fn` (``_layer``'s signature) and
    `embed_fn(embed, tokens)` replace the layer and the embedding gather:
    the tensor-parallel model's (``parallel/tp_model.py``) under the same
    remat machinery."""
    c = config
    # advanced indexing: its backward sums repeated tokens in a fixed order
    # on the card (index_select's adds them with atomics)
    x = params["embed"][tokens.long()] if embed_fn is None else embed_fn(params["embed"], tokens)
    cos, sin = rope_tables(positions, c.head_dim, c.rope_theta, c.rope_scaling_tuple)
    x, lb = run_layers(x, params["layers"], c, cos, sin, attn_fn, remat=remat, remat_policy=remat_policy,
                       remat_segments=remat_segments, fused_qk=fused_qk, valid=valid, layer_fn=layer_fn)
    hidden = rms_norm(x, params["final_norm"], c.rms_norm_eps)
    return hidden, {"lb_loss": lb}


def forward_hidden(params: dict, config: Qwen3Config, tokens: torch.Tensor,
                   positions: torch.Tensor, attn_fn: AttnFn, remat: bool = False,
                   remat_policy: str | None = None, remat_segments: int = 0,
                   fused_qk: bool = False, valid=None) -> torch.Tensor:
    """Final-norm'd hidden states [n, d] (see ``forward_hidden_aux``)."""
    return forward_hidden_aux(params, config, tokens, positions, attn_fn, remat=remat,
                              remat_policy=remat_policy, remat_segments=remat_segments,
                              fused_qk=fused_qk, valid=valid)[0]


def logits_from_hidden(params: dict, config: Qwen3Config, hidden: torch.Tensor) -> torch.Tensor:
    """[n, V] fp32 logits (a test and debug path; training takes the LM-head
    statistics kernels): the product of fp32 copies of hidden and the head."""
    return torch.matmul(hidden.float(), lm_head_weight(params, config).float())
