"""Training loop, optimizer, checkpoint and resume, rollout batching.

Counterpart of ``dynamictreeattn_tpu/training`` on one device: ``Trainer``
and ``TrainConfig`` (with ``OptaxAdamW``, the JAX Trainer's optax chain),
``CheckpointManager`` (torch.save in place of orbax) and
``TokenBudgetBatcher``."""

from dynamictreeattn_tpu_torch.training.batching import TokenBudgetBatcher
from dynamictreeattn_tpu_torch.training.checkpoint import CheckpointManager
from dynamictreeattn_tpu_torch.training.trainer import OptaxAdamW, TrainConfig, Trainer

__all__ = ["CheckpointManager", "OptaxAdamW", "TokenBudgetBatcher", "TrainConfig", "Trainer"]
