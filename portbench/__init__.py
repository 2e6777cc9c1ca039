"""The benchmark of ``distkeras_tpu_torch`` on one or more NVIDIA cards.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything a cell needs is found by name: its
configuration in ``configs/``, its traffic mix in ``traffic/`` (whose
``driver`` names a module of ``drivers/``), its correctness limits in
``workloads/`` and each per-layer metric's reader in ``metrics/``.  The
plain reference that decides ``correct`` is in ``reference/`` and imports
nothing of the program.
"""
