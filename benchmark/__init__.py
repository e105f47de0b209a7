"""The benchmark of ``ctrl_sim_tpu_torch``, the PyTorch and CUDA port, on an
NVIDIA H100: a harness driven by ``BENCHMARK.json`` (``run.py``), its
traffic mixes, configurations, per-layer metric readers, and the plain
reference that decides whether a run's outputs are correct."""
