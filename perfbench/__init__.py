"""The benchmark of the PyTorch/CUDA port (``repro_torch``): its harness,
traffic generator, reference, trace reduction and metric readers.  See
``perfbench/run.py`` and ``BENCHMARK.json``."""
