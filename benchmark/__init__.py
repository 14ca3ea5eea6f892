"""The benchmark of the PyTorch/CUDA port (``cfd_with_cuda_tpu_torch``).

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Every
configuration (``configs/<name>.json``), traffic mix (``traffic/<name>.json``),
per-layer metric reader (``metrics/<name>.py``) and cell's correctness limits
(``limits/<cell>.json``) is a file of its own, found by its name.
"""
