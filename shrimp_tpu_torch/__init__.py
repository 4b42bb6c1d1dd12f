"""shrimp_tpu_torch: the PyTorch/CUDA port of shrimp-tpu's device layer.

The JAX package `shrimp_tpu` stays the reference. This package imports
torch and never jax: it reuses the jax-free host modules of `shrimp_tpu`
(config, index, encoders, FASTA I/O, the native C++ host pipeline) as
they are, and carries its own twins of the device-bound modules. Each
Pallas kernel on a ported path is a hand-written CUDA kernel under
`csrc/`, built with nvcc at first use (`_build.py`).

Ported so far: the letter-space unpaired fused stats flow to SAM
(`fastpath.map_unpaired_sam_stream`).
"""
