"""Data: synthetic rollout tries (host numpy)."""

from dynamictreeattn_tpu_torch.data.synthetic import sharing_ratio, synthetic_rollout_batch

__all__ = ["synthetic_rollout_batch", "sharing_ratio"]
