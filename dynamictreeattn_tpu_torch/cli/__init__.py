"""Command lines: single runs, folder runs and the gradient-parity table.

Counterparts of ``dynamictreeattn_tpu/cli`` ``run``, ``run_all`` and
``compare_grads`` (the remaining CLIs are not ported yet). Each takes
``--device`` (default ``cuda``); ``--device cpu`` runs the plain versions of
the kernels.
"""
