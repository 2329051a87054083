"""Utilities: gradient-parity comparison, spans and counters, device memory."""

from dynamictreeattn_tpu_torch.utils.compare_grads import compare_grads, format_grad_table
from dynamictreeattn_tpu_torch.utils.profiling import device_memory_stats, span

__all__ = ["compare_grads", "format_grad_table", "device_memory_stats", "span"]
