"""Command lines.

Counterparts of ``dynamictreeattn_tpu/cli``: ``run``, ``run_all`` and
``compare_grads`` (single runs, folder runs, the gradient-parity table),
``train`` (the training loop with checkpoints, on one device or a mesh of
processes), the host tools of the cost model, ``time_model``, ``remark``,
``calc_time`` and ``data_parallel``, and ``warmup`` (JAX's compile-cache
filler; here it builds the CUDA sources and loads the instantiations a
model uses, on a card only). Each command that runs the model takes
``--device`` (default ``cuda``); ``--device cpu`` runs the plain versions of
the kernels.
"""
