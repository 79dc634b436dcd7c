"""The lane-axis concat probe of tools/widestore_probe4.py on the card:
eight 128-lane blocks of x, each offset by its block index and cast to
int8, concatenated to K = 1024 and fed to one int8 product.

- `concat_mm(xw, w)`: (M, 1024) int32 and (1024, 128) int8 -> (M, 128)
  int32, int8(xw + k(col)) @ w with k(col) = col >> 7, the int8 cast
  wrapping, summed over all of K in int32 (exact: each output is at most
  1024 * 128 * 128 = 2^24 in magnitude). Unlike widestore_probe2/3's
  product, which ORs eight block products, this one sums them.

On a CUDA tensor it runs csrc/probe_concatmm.cu on the int8 tensor cores
(mma.sync), on a CPU tensor its plain version. `probe_concat_mm` is the
TPU tool's probe: its W then its x from default_rng(3), and its NumPy
int64 statement, held against the port's result.

    python -m csv_simd_tpu_torch.tools.widestore_probe4 [mb ...]
        the probe, the gate, then the kernel checked and timed on mb MiB
        of random int32 x (default 64 and 1024), beside its plain version
        and torch._int_mm on the int8 x
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ._common import (
    card,
    check_all,
    emit,
    graph_ms,
    interleaved_ms,
    kernel_ms,
    need_card,
    random_words,
    report_probes,
)
from ._lab_kernels import check_pack_weights, check_wide
from .widestore_probe2 import GATE_ROWS, LANES, random_weights

T8 = 64       # the TPU probe's input rows
GATE_M = GATE_ROWS + (4097,)


def _block_k(device) -> torch.Tensor:
    """(1024,) int8: each column's block index, k(col) = col >> 7."""
    return (torch.arange(8 * LANES, device=device) >> 7).to(torch.int8)


def _concat_mm_plain(xw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The int8 cast of x + k, then a float64 product rounded back to
    int32 (exact: the sums are at most 2^24 in magnitude; torch.matmul
    takes no integer types on CUDA)."""
    xs = (xw.to(torch.int8) + _block_k(xw.device)).to(torch.float64)
    return (xs @ w.to(torch.float64)).round().to(torch.int32)


def concat_mm(xw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, 1024) int32 and (1024, 128) int8 -> (M, 128) int32: see the
    module docstring."""
    check_wide(xw, "concat_mm")
    check_pack_weights(w, xw, "concat_mm")
    if xw.device.type == "cuda":
        from . import _lab_kernels

        return _lab_kernels.probe_concat_mm(xw, w)
    if xw.device.type != "cpu":
        raise ValueError(f"unsupported device {xw.device}")
    return _concat_mm_plain(xw, w)


def probe_data() -> tuple:
    """The TPU probe's (W (1024, 128) int8 in [-2, 2], x (64, 1024) int32
    in [0, 14)), drawn from one default_rng(3), W first."""
    rng = np.random.default_rng(3)
    w = rng.integers(-2, 3, (8 * LANES, LANES)).astype(np.int8)
    x = rng.integers(0, 14, (T8, 8 * LANES)).astype(np.int32)
    return w, x


def _concat_mm_probe(device) -> tuple:
    """(the port's result on device, the TPU tool's NumPy int64 product of
    the concatenated blocks) on its inputs."""
    w, x = probe_data()
    big = np.concatenate(
        [x[:, LANES * k:LANES * (k + 1)] + k for k in range(8)],
        axis=1).astype(np.int64)
    want = (big @ w.astype(np.int64)).astype(np.int32)
    got = concat_mm(torch.from_numpy(x).to(device),
                    torch.from_numpy(w).to(device))
    return got, torch.from_numpy(want).to(got.device)


def probe_concat_mm(device="cuda") -> bool:
    """The TPU tool's probe: True when the port's result is bit-exact."""
    got, want = _concat_mm_probe(device)
    return torch.equal(got, want)


PROBES = (("concat1024+mm", probe_concat_mm),)


def weight_sets(device) -> dict:
    """{name: (1024, 128) int8 on device}: the probe's W, full-range random
    int8 and all -128 (the largest sums)."""
    return {"probe": torch.from_numpy(probe_data()[0]).to(device),
            "random": random_weights(device, 13),
            "min": torch.full((8 * LANES, LANES), -128, dtype=torch.int8,
                              device=device)}


def library_call(xw: torch.Tensor, w: torch.Tensor):
    """The same function as one int8 product: each int32's low byte (its
    int8 cast) read as a strided int8 view, k added in int8 in the same
    pass (which wraps as the cast of x + k does), then torch._int_mm with W
    laid out once in the column-major order cuBLASLt takes."""
    k = _block_k(xw.device)
    w_cm = w.t().contiguous().t()
    low = xw.view(torch.int8).view(xw.shape[0], 8 * LANES, 4)[..., 0]
    return lambda: torch._int_mm(low + k, w_cm)


def gate(device) -> dict:
    """{"concat_mm": {checks, max_abs_err}}: the kernel against its plain
    version on full-range random int32 at M = 1, 7, 64, 65, 1000 and 4097
    and on the probe's x, with each weight set, and the TPU probe's NumPy
    statement."""
    pairs = [(*_concat_mm_probe(device), "TPU probe")]
    inputs = [(random_words(8 * m, device, 5 * m).view(-1, 8 * LANES),
               f"M={m}") for m in GATE_M]
    inputs.append((torch.from_numpy(probe_data()[1]).to(device), "probe x"))
    for x, at in inputs:
        for name, w in weight_sets(device).items():
            pairs.append((concat_mm(x, w), _concat_mm_plain(x, w),
                          f"{at} {name} weights"))
    return {"concat_mm": check_all(pairs)}


def check(x: torch.Tensor) -> dict:
    """{"concat_mm": {checks, max_abs_err}}: the kernel with the probe's W
    and the library call against the plain version on the (M, 1024) x
    `run` times."""
    w = weight_sets(x.device)["probe"]
    plain = _concat_mm_plain(x, w)
    return {"concat_mm": check_all([
        (concat_mm(x, w), plain, f"M={x.shape[0]}"),
        (library_call(x, w)(), plain, f"M={x.shape[0]} library call")])}


def run(x: torch.Tensor, reps: int = 20, plain_reps: int = 2) -> dict:
    """{"concat_mm": {ms, eager_ms, gbps (GB/s of x, from ms), plain_ms,
    library_ms}} on (M, 1024) x with the probe's W; the library call from
    CUDA graphs. `check` holds the same calls against the plain version."""
    w = weight_sets(x.device)["probe"]
    ms = kernel_ms({"concat_mm": lambda: concat_mm(x, w)}, reps)["concat_mm"]
    return {"concat_mm": {
        **ms, "gbps": x.numel() * 4 / ms["ms"] / 1e6,
        "plain_ms": interleaved_ms({0: lambda: _concat_mm_plain(x, w)},
                                   plain_reps, rounds=1)[0],
        "library_ms": graph_ms(library_call(x, w), reps)}}


def main(argv) -> int:
    device = need_card("widestore_probe4")
    ok = report_probes(PROBES, device)
    result = {**card(), "gate": gate(device), "sizes": {}}
    for mb in [int(a) for a in argv] or (64, 1024):
        x = random_words(mb * 1024 * 1024 // 512, device, mb).view(
            -1, 8 * LANES)
        result["sizes"][f"{mb}MiB"] = {"check": check(x), "run": run(x)}
        del x
    emit(result)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
