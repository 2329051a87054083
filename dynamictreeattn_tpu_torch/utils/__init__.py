"""Utilities: gradient-parity comparison, profiling and timing."""

from dynamictreeattn_tpu_torch.utils.compare_grads import compare_grads, format_grad_table
from dynamictreeattn_tpu_torch.utils.profiling import StepTimer, device_memory_stats, trace

__all__ = ["compare_grads", "format_grad_table", "StepTimer", "device_memory_stats", "trace"]
