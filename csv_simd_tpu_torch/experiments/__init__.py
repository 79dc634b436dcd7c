"""Experiments: the stage-1 machinery applied beyond CSV (the port of
csv_simd_tpu/experiments): JSON structural indexing, the golden bitmask
oracle (json_levels) and its device counterpart (json_device, kernel J1
on a card)."""
