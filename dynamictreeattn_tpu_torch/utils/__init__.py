"""Utilities: gradient-parity comparison."""

from dynamictreeattn_tpu_torch.utils.compare_grads import compare_grads

__all__ = ["compare_grads"]
