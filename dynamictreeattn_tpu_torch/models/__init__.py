"""Model family: functional PyTorch Qwen3 (dense and MoE) and DeepSeek-V3 (MLA, training only), the KV-cache
sampler and the HF bridge."""

from dynamictreeattn_tpu_torch.models.convert import params_from_numpy
from dynamictreeattn_tpu_torch.models.deepseek_v3 import DeepseekV3Config
from dynamictreeattn_tpu_torch.models.generate import generate, generate_grouped, init_cache
from dynamictreeattn_tpu_torch.models.qwen3 import (
    MODEL_CONFIGS,
    Qwen3Config,
    forward_hidden,
    forward_hidden_aux,
    init_params,
    lm_head_weight,
    logits_from_hidden,
)

__all__ = [
    "DeepseekV3Config",
    "Qwen3Config",
    "MODEL_CONFIGS",
    "init_params",
    "forward_hidden",
    "forward_hidden_aux",
    "lm_head_weight",
    "logits_from_hidden",
    "params_from_numpy",
    "generate",
    "generate_grouped",
    "init_cache",
]
