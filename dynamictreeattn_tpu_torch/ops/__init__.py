"""Compute ops: tree-attention, LM-head statistics, qk-prep and grouped-decode
attention kernels, the trie loss, logit filters for sampling, the
optimizer's clip and AdamW kernels (``ops.adamw``), and the model step's
fused RMSNorm and SwiGLU kernels (``ops.fused_norm_act``).

Every kernel has a plain PyTorch version in the same module; a wrapper given
CPU tensors runs the plain version, given CUDA tensors it launches the
hand-written CUDA kernel (``csrc/``, built by ``ops/_build.py``) or raises.
"""

from dynamictreeattn_tpu_torch.ops.decode_attention import (
    decode_attention_grouped,
    decode_attention_grouped_plain,
)
from dynamictreeattn_tpu_torch.ops.losses import (
    logprob_entropy_from_hidden,
    position_stats_from_hidden,
    tree_loss_from_hidden,
)
from dynamictreeattn_tpu_torch.ops.lm_stats import (
    lm_stats, lm_stats_bwd, lm_stats_bwd_plain, lm_stats_plain,
)
from dynamictreeattn_tpu_torch.ops.qk_prep import qkv_prep, qkv_prep_plain
from dynamictreeattn_tpu_torch.ops.sampling import categorical, filter_logits
from dynamictreeattn_tpu_torch.ops.tree_attention import BlockSizes, tree_attention, tree_attention_with_meta
from dynamictreeattn_tpu_torch.ops.tree_attention_ref import tree_attention_reference
from dynamictreeattn_tpu_torch.ops.tree_attention_sim import tree_attention_blocked_sim

__all__ = [
    "BlockSizes",
    "tree_attention",
    "tree_attention_blocked_sim",
    "tree_attention_reference",
    "tree_attention_with_meta",
    "lm_stats",
    "lm_stats_plain",
    "lm_stats_bwd",
    "lm_stats_bwd_plain",
    "qkv_prep",
    "qkv_prep_plain",
    "position_stats_from_hidden",
    "logprob_entropy_from_hidden",
    "tree_loss_from_hidden",
    "decode_attention_grouped",
    "decode_attention_grouped_plain",
    "filter_logits",
    "categorical",
]
