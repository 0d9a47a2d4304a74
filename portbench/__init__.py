"""portbench: the benchmark of ``tpumil_torch`` on NVIDIA H100 cards.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once from the root of a checkout. The cells,
metrics and configurations are data (``BENCHMARK.json`` at the root, and
``portbench/{workloads,configs}/*.json``); a cell's driver is
``portbench/drivers/<driver>.py`` and a per-layer metric's reader is
``portbench/metrics/<name>.py`` or ``portbench/metrics/<family>.py``, all
found by name. Nothing here imports ``jax`` or the JAX package, and
``portbench/reference`` imports nothing of ``tpumil_torch``.
"""
