"""Execution over devices: the cost model, the load balancers, the mesh and
the training steps over stacked batches.

Counterpart of ``dynamictreeattn_tpu/parallel``: the execution-time model
(``TreeTimeModel``), the three data-parallel load balancers, the mesh over
``torch.distributed`` (``make_mesh``: one process per rank), the
collectives with tensor parallelism's gradients, the vocab-parallel LM-head
statistics, the tensor-parallel model with expert parallelism and Ulysses
sequence parallelism, the steps over data, tensor, vocab, expert and
sequence parallelism (Ulysses and ring) with ZeRO-3 (``stack_batches``,
``make_train_step``, ``make_forward_step``, ``extract_forward``,
``shard_params``, ``fsdp_dims``), pipeline parallelism, GPipe and 1F1B
(``pipeline.py``: ``make_pp_train_step``, ``stack_microbatches``) and the
multi-host bring-up (``distributed.py``). JAX's ``batch_partition_specs``
has no counterpart: each rank builds and uploads only its own rows
(``parallel/train.py``); JAX's ``init_opt_state`` is the optimizer's own
``init`` here (``training.OptaxAdamW``).
"""

from dynamictreeattn_tpu_torch.parallel.load_balance import (
    LB_by_DFS_and_TM,
    LB_by_n_tokens,
    LB_by_TM,
    eval_bins,
    pred_time,
)
from dynamictreeattn_tpu_torch.parallel.mesh import Mesh, make_mesh
from dynamictreeattn_tpu_torch.parallel.pipeline import (
    StackedMicrobatch,
    make_pp_train_step,
    shard_params_pp,
    stack_microbatches,
)
from dynamictreeattn_tpu_torch.parallel.time_model import FEATURES, TreeTimeModel
from dynamictreeattn_tpu_torch.parallel.train import (
    FSDP_MIN_SIZE,
    SeqShard,
    ShardedEngine,
    StackedBatch,
    extract_forward,
    fsdp_dims,
    fsdp_param_specs,
    gather_params,
    global_sum_squares,
    make_forward_step,
    make_train_step,
    param_specs,
    pp_param_specs,
    shard_params,
    stack_batches,
)

__all__ = [
    "FEATURES",
    "FSDP_MIN_SIZE",
    "SeqShard",
    "LB_by_DFS_and_TM",
    "LB_by_TM",
    "LB_by_n_tokens",
    "Mesh",
    "ShardedEngine",
    "StackedBatch",
    "StackedMicrobatch",
    "TreeTimeModel",
    "eval_bins",
    "extract_forward",
    "fsdp_dims",
    "fsdp_param_specs",
    "gather_params",
    "global_sum_squares",
    "make_forward_step",
    "make_mesh",
    "make_pp_train_step",
    "make_train_step",
    "param_specs",
    "pp_param_specs",
    "pred_time",
    "shard_params",
    "shard_params_pp",
    "stack_batches",
    "stack_microbatches",
]
