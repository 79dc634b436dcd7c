"""The benchmark of csv_simd_tpu_torch on an NVIDIA H100; see README.md."""
