"""Execution over devices: the cost model, the load balancers and the
training steps over stacked batches.

Counterpart of ``dynamictreeattn_tpu/parallel``. Ported so far: the
execution-time model (``TreeTimeModel``), the three data-parallel load
balancers, and the one-device subset of the sharded steps
(``stack_batches``, ``make_train_step``, ``make_forward_step``,
``extract_forward``). The mesh itself — data, tensor, sequence and pipeline
parallelism, FSDP, expert parallelism, multi-host — waits for ROADMAP
queue 1 item 10 (``torch.distributed``); asking for it raises.
"""

from dynamictreeattn_tpu_torch.parallel.load_balance import (
    LB_by_DFS_and_TM,
    LB_by_n_tokens,
    LB_by_TM,
    eval_bins,
    pred_time,
)
from dynamictreeattn_tpu_torch.parallel.time_model import FEATURES, TreeTimeModel
from dynamictreeattn_tpu_torch.parallel.train import (
    StackedBatch,
    check_single_device,
    extract_forward,
    make_forward_step,
    make_train_step,
    stack_batches,
)

__all__ = [
    "FEATURES",
    "LB_by_DFS_and_TM",
    "LB_by_TM",
    "LB_by_n_tokens",
    "StackedBatch",
    "TreeTimeModel",
    "check_single_device",
    "eval_bins",
    "extract_forward",
    "make_forward_step",
    "make_train_step",
    "pred_time",
    "stack_batches",
]
