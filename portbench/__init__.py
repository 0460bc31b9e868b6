"""The benchmark of ``repro_torch`` on the H100.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything is found by name: a cell's configuration under
``configs/``, its traffic under ``traffic/``, its limits under
``workloads/``, its driver under ``drivers/`` and each per-layer metric's
reader under ``metrics/``.  The plain references are under ``reference/``.
"""
