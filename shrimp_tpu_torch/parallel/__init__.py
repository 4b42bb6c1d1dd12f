"""Mapping over several devices: the single-host mesh tiers in one
process (`meshmap.MeshMapper`, `meshmap.ShardedIndexMapper`) and the
multi-process tier over torch.distributed (`dist.DistMapper`, one rank a
process: `dist_worker`)."""
