"""shrimp_tpu_torch: the PyTorch/CUDA port of shrimp-tpu's device layer.

The JAX package `shrimp_tpu` stays the reference. This package imports
torch and never jax, and nothing of `shrimp_tpu`: it keeps its own
copies of the host modules it needs (constants, config, index, encoders,
FASTA I/O, run statistics, the native C++ host pipeline under `native/`)
and carries its own twins of the device-bound modules. Each Pallas
kernel on a ported path is a hand-written CUDA kernel under `csrc/`,
built with nvcc at first use (`_build.py`).

Ported so far, each to SAM and each with its fused and its two-phase
dispatch (the vector SW on every window, the full SW on the survivors,
at 8 or more candidate windows a read):

- letter-space unpaired reads (`fastpath.map_unpaired_sam_stream`): the
  stats flow for short reads and the traceback flow for long ones;
- colour-space unpaired reads (`fastpath_cs.map_unpaired_cs_sam_stream`);
- letter-space pairs (`fastpath.map_paired_sam_stream`, on a
  `paired.PairedMapper`; two-phase batches run select-then-full);
- colour-space pairs (`fastpath_cs.map_paired_cs_sam_stream`, the same);
- in all four, the flows the packed IO cannot take: the byte gather for
  genome planes over ~1 Gbp (no word plane) and the unpacked IO for
  batches of more than 2^16 read rows;
- the generic mapper (`mapper.Mapper.map_unpaired`,
  `paired.PairedMapper.map_paired`) for the configs outside the streams'
  gates (local, gapless, option sets, SHRiMP format, raw-string trims)
  and for the batches the streams' flat encoder rejects (their slow
  tail);
- the command line, `python -m shrimp_tpu_torch {index,map}`
  (`--device cpu` for the plain versions), with the reference's index
  files;
- the single-host mesh tiers (`parallel.meshmap.MeshMapper`,
  `ShardedIndexMapper`): the four streams over a tuple of devices, the
  genome range-sharded or one sub-index a shard, the Z statistics
  recombined by collectives on the first device.

Not yet: the multi-process tier (`DistMapper`), the host tools and the
CLI's other subcommands.
"""
