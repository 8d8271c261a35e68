"""The benchmark of the PyTorch / CUDA port (``repro_torch``): one cell a
run, driven by ``BENCHMARK.json`` and the data files beside this package
(``configs/``, ``traffic/``, ``metrics/``); ``reference/`` is the plain
NumPy reference that decides ``correct``.  ``python3 perfbench/run.py
--help`` runs it."""
