"""The benchmark of ``reflow_tpu_torch`` on one or more CUDA cards.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; README.md
says how the files under this folder are found by name.
"""
