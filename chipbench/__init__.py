"""The end-to-end benchmark of ``repro_torch`` on one NVIDIA card.

``python chipbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line.  Every
configuration, traffic mix and metric is a file of its own, found by the
name ``BENCHMARK.json`` gives it (see ``harness.py``).
"""
