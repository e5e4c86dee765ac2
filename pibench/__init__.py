"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of PI.

``python3 pibench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints its result as the last line of standard output.  Nothing here
imports JAX or the JAX package ``repro``; only ``system.py`` imports the
program.
"""
