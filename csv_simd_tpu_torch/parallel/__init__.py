"""Sharded index builds and serving over a mesh of devices, with
collective-stitched boundary state (csv_simd_tpu/parallel/)."""
