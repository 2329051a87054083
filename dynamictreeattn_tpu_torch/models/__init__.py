"""Model family: functional PyTorch Qwen3 (dense), forward only."""

from dynamictreeattn_tpu_torch.models.convert import params_from_numpy
from dynamictreeattn_tpu_torch.models.qwen3 import (
    MODEL_CONFIGS,
    Qwen3Config,
    forward_hidden,
    init_params,
    lm_head_weight,
)

__all__ = [
    "Qwen3Config",
    "MODEL_CONFIGS",
    "init_params",
    "forward_hidden",
    "lm_head_weight",
    "params_from_numpy",
]
