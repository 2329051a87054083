"""Execution over devices: the cost model, the load balancers, the mesh and
the training steps over stacked batches.

Counterpart of ``dynamictreeattn_tpu/parallel``. Ported: the
execution-time model (``TreeTimeModel``), the three data-parallel load
balancers, the mesh over ``torch.distributed`` (``make_mesh``: one process
per rank), the collectives with tensor parallelism's gradients, the
vocab-parallel LM-head statistics, the tensor-parallel model with expert
parallelism, and the steps over data, tensor, vocab and expert parallelism
(``stack_batches``, ``make_train_step``, ``make_forward_step``,
``extract_forward``, ``shard_params``). FSDP, sequence and pipeline
parallelism and multi-host runs wait for ROADMAP queue 1 item 10, legs
(e)-(h); asking for them raises.
"""

from dynamictreeattn_tpu_torch.parallel.load_balance import (
    LB_by_DFS_and_TM,
    LB_by_n_tokens,
    LB_by_TM,
    eval_bins,
    pred_time,
)
from dynamictreeattn_tpu_torch.parallel.mesh import Mesh, make_mesh
from dynamictreeattn_tpu_torch.parallel.time_model import FEATURES, TreeTimeModel
from dynamictreeattn_tpu_torch.parallel.train import (
    ShardedEngine,
    StackedBatch,
    check_single_device,
    extract_forward,
    gather_params,
    global_sum_squares,
    make_forward_step,
    make_train_step,
    param_specs,
    shard_params,
    stack_batches,
)

__all__ = [
    "FEATURES",
    "LB_by_DFS_and_TM",
    "LB_by_TM",
    "LB_by_n_tokens",
    "Mesh",
    "ShardedEngine",
    "StackedBatch",
    "TreeTimeModel",
    "check_single_device",
    "eval_bins",
    "extract_forward",
    "gather_params",
    "global_sum_squares",
    "make_forward_step",
    "make_mesh",
    "make_train_step",
    "param_specs",
    "pred_time",
    "shard_params",
    "stack_batches",
]
