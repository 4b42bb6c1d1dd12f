"""shrimp_tpu_torch: the PyTorch/CUDA port of shrimp-tpu's device layer.

The JAX package `shrimp_tpu` stays the reference. This package imports
torch and never jax, and nothing of `shrimp_tpu`: it keeps its own
copies of the host modules it needs (constants, config, index, encoders,
FASTA I/O, run statistics, the native C++ host pipeline under `native/`)
and carries its own twins of the device-bound modules. Each Pallas
kernel on a ported path is a hand-written CUDA kernel under `csrc/`,
built with nvcc at first use (`_build.py`).

Ported so far: the letter-space unpaired fused flows to SAM, the stats
flow for short reads and the traceback flow for long ones
(`fastpath.map_unpaired_sam_stream`), and the colour-space unpaired
fused flow (`fastpath_cs.map_unpaired_cs_sam_stream`).
"""
