"""Command lines.

Counterparts of ``dynamictreeattn_tpu/cli``: ``run``, ``run_all`` and
``compare_grads`` (single runs, folder runs, the gradient-parity table),
``train`` (the training loop with checkpoints, one device), and the host
tools of the cost model, ``time_model``, ``remark``, ``calc_time`` and
``data_parallel`` (``warmup``, a JAX compile-cache filler, has no
counterpart: the eager port compiles nothing per shape). Each command that
runs the model takes ``--device`` (default ``cuda``); ``--device cpu`` runs
the plain versions of the kernels.
"""
