"""Benchmark of `shrimp_tpu_torch`'s `map` CLI on an NVIDIA GPU.

`python -m mapbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line. Nothing here imports JAX or the JAX package.
"""
