"""The single-host mesh tiers: mapping over several torch devices in one
process (`meshmap.MeshMapper`, `meshmap.ShardedIndexMapper`)."""
