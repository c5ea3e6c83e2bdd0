"""The benchmark of the PyTorch / CUDA port (``tst_torch``) on NVIDIA cards.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; see ``portbench/run.py``.
"""
