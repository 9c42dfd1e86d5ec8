"""The benchmark of ``sblas_torch`` on NVIDIA H100s: time to solution.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (``README.md``).
"""
