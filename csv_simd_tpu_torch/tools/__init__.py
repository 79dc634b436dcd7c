"""The port's measurement tools: the JAX package's probes under tools/,
rebuilt on the card's own kernels, with the JAX tools' names.

    python -m csv_simd_tpu_torch.tools.widestore_probe [mb ...]
        B1n: the fused row prefix A/B (scan, build = B1 + B2, buildf)
    python -m csv_simd_tpu_torch.tools.dma_probe [mb ...]
        the memory stream: read N, write N/8 (narrow, tall2, tall8, wide),
        and the read-only sum
    python -m csv_simd_tpu_torch.tools.vpu_roofline [mb]
        the int32 op rate per mix (alu, shift, mul)
    python -m csv_simd_tpu_torch.tools.ablate [mode:tile ...]
        the stage-1 build cut after each stage (B3's layout), in GB/s
    python -m csv_simd_tpu_torch.tools.ablate2 [mode:tile ...]
        B1's own pass B cut after each stage, beside B1, B3 and B4
    python -m csv_simd_tpu_torch.tools.kbench [variant[:tile] ...]
        B6's v1 layout with its quote masking cut back, beside B6
    python -m csv_simd_tpu_torch.tools.vnext [bench|check [FILE.csv]]
        the atomic-free direct fold pack beside B3
    python -m csv_simd_tpu_torch.tools.widestore_probe2 [mb ...]
        the strided 16-lane gather (s8+st16) and the lane-placed int8
        pack product (mmL) on (rows, 128) words
    python -m csv_simd_tpu_torch.tools.widestore_probe3 [mb ...]
        the lane-window sum (laneload) and the same pack product (mmLb)
        on the (rows/8, 1024) view

The probes' CUDA kernels live here, in `tools/csrc/probe_*.cu`, and build
into their own library through `tools/_lab_kernels` (its wrappers, check
helpers, mode tables and LAUNCHES), apart from the product's kernels in
`csrc/`: the package never imports this directory, so building a tape
never compiles a probe. The card tests import the wrappers as
`from csv_simd_tpu_torch.tools import _lab_kernels`.

Each runs on one NVIDIA card (and exits 2 without one), holds its kernel
against the plain PyTorch version first, exits non-zero on any mismatch,
and prints one JSON line of results, with the card's name and power
limit; the wide-store tools first print the JAX tools' `probe[name]:
BIT-EXACT` lines. Times are CUDA-event means over many launches after a warm-up,
taken in turns when a tool compares several versions.
"""
