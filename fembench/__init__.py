"""Benchmark of the PyTorch and CUDA solver ``dealii_asm_tpu_torch`` on one
NVIDIA H100: ``python3 -m fembench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``run.py`` and ``BENCHMARK.json``)."""
