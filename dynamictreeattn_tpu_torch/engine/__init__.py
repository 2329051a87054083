"""Tree engine (training step, inference log-probs) + dense replay packing."""

from dynamictreeattn_tpu_torch.engine.tree_engine import (
    EngineConfig,
    TreeEngine,
    TrieBatch,
    pack_sequences_dense,
    resolve_fused_qk,
    resolve_kernel_modes,
    resolve_loss_mode,
)

__all__ = [
    "EngineConfig",
    "TreeEngine",
    "TrieBatch",
    "pack_sequences_dense",
    "resolve_fused_qk",
    "resolve_kernel_modes",
    "resolve_loss_mode",
]
