"""Data: synthetic rollout tries and sequence batch IO (host numpy)."""

from dynamictreeattn_tpu_torch.data.io import load_sequences, parse_data_spec, save_sequences
from dynamictreeattn_tpu_torch.data.synthetic import sharing_ratio, synthetic_rollout_batch

__all__ = ["synthetic_rollout_batch", "sharing_ratio", "load_sequences", "save_sequences",
           "parse_data_spec"]
