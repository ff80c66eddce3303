"""esbench: the benchmark of ``estorch_tpu_torch`` on the card.

One run trains one cell (a configuration under a traffic mix) through the
port's ``ES.train`` and prints one JSON line: ``python -m esbench.run
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``.  Configurations,
cells and per-layer metrics are files found by name (``loader.py``); the
yardstick (envs, costs, peaks, the plain reference and the comparison that
decides ``correct``) lives here and imports nothing of the program.
"""
