"""The wide-store probes of tools/widestore_probe2.py on the card: the
strided-sublane gather (s8+st16) and the lane-placed int8 pack product
(mmL).

- `s8_st16(x)`: (rows, 128) int32, rows % 8 == 0 -> (rows/8, 128) int32,
  out[r, 16s + j] = x[8r + s, j] for s < 8 and j < 16; only lanes 0-15 of
  each input row reach the output.
- `mm_lanes(x, w)`: the same x and (1024, 128) int8 w -> (rows/8, 128)
  int32, the OR over s < 8 of int8(x[s::8]) @ w[128s:128s+128] with int32
  accumulation (the int8 cast wraps). Rows 8r..8r+7 of x are row r of its
  (rows/8, 1024) view and x[s::8] is lane window s of that view, so this
  is `packmm(x.view(-1, 1024), w)`, the product tools/widestore_probe3's
  mmLb runs too.

The product ORs the eight block products, as the TPU kernel did. With the
probe's weights (`weights_mmL`: lane 8g of block s to column 16s + g with
weight 1, lane 8g + 1 with weight 16) they lie in disjoint columns and the
OR is their sum; with other weights it is not. On a CUDA tensor the
gather runs csrc/probe_widestore.cu and the pack product
csrc/probe_concatmm.cu (the tensor cores), on a CPU tensor each its plain
version. `probe_s8_st16` and `probe_mmL` are the TPU tool's
probes: its input and NumPy statement, held against the port's result.

    python -m csv_simd_tpu_torch.tools.widestore_probe2 [mb ...]
        the probes, the gate, then each kernel checked and timed on mb MiB
        of random int32 (default 64 and 1024)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .._kernels import check_pack_weights, check_rows128, check_wide
from ._common import (
    card,
    check_all,
    emit,
    interleaved_ms,
    kernel_ms,
    need_card,
    random_words,
    report_probes,
)

T = 512       # the TPU probe's input rows
LANES = 128
GATE_ROWS = (1, 7, 64, 65, 1000)   # rows of the (rows/8, 1024) view


def _gather_plain(x: torch.Tensor) -> torch.Tensor:
    return x.view(-1, 8, LANES)[:, :, :16].reshape(-1, LANES)


def _packmm_plain(xw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per 128-lane block: the int8 cast, a float64 product rounded back
    to int32 (exact: a block's sums are at most 128 * 128 * 128 = 2**21 in
    magnitude; torch.matmul takes no integer types on CUDA), then the
    eight ORed."""
    acc = None
    for k in range(8):
        xs = xw[:, LANES * k:LANES * (k + 1)].to(torch.int8).to(torch.float64)
        ws = w[LANES * k:LANES * (k + 1)].to(torch.float64)
        p = (xs @ ws).round().to(torch.int32)
        acc = p if acc is None else acc | p
    return acc


def s8_st16(x: torch.Tensor) -> torch.Tensor:
    """(rows, 128) int32, rows % 8 == 0 -> (rows/8, 128) int32: see the
    module docstring."""
    check_rows128(x, "s8_st16", 8)
    if x.device.type == "cuda":
        from .. import _kernels

        return _kernels.probe_ws_gather(x)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return _gather_plain(x)


def packmm(xw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, 1024) int32 and (1024, 128) int8 -> (M, 128) int32, the OR over
    k < 8 of int8(xw[:, 128k:128k+128]) @ w[128k:128k+128] in int32."""
    check_wide(xw, "packmm")
    check_pack_weights(w, xw, "packmm")
    if xw.device.type == "cuda":
        from .. import _kernels

        return _kernels.probe_ws_packmm(xw, w)
    if xw.device.type != "cpu":
        raise ValueError(f"unsupported device {xw.device}")
    return _packmm_plain(xw, w)


def mm_lanes(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(rows, 128) int32, rows % 8 == 0, and (1024, 128) int8 -> (rows/8,
    128) int32: the OR over s < 8 of int8(x[s::8]) @ w[128s:128s+128]."""
    check_rows128(x, "mm_lanes", 8)
    return packmm(x.view(-1, 8 * LANES), w)


def weights_mmL() -> torch.Tensor:
    """The TPU probe's (1024, 128) int8 weights, on the CPU."""
    w = np.zeros((8, LANES, LANES), np.int8)
    for s in range(8):
        for lane in range(LANES):
            g, l = divmod(lane, 8)
            if l == 0:
                w[s, lane, 16 * s + g] = 1
            elif l == 1:
                w[s, lane, 16 * s + g] = 16
    return torch.from_numpy(w.reshape(8 * LANES, LANES))


def random_weights(device, seed: int) -> torch.Tensor:
    """(1024, 128) int8 uniform over [-128, 127], made on `device`: the
    block products overlap, so their OR is not their sum."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(-128, 128, (8 * LANES, LANES), dtype=torch.int8,
                         device=device, generator=gen)


def overlap_weights(device) -> torch.Tensor:
    """(1024, 128) int8: lane j of every block to column j with weight 1,
    so out[:, j] is the OR of the eight int8(x[:, 128k + j]) where the
    sum would add them."""
    eye = torch.eye(LANES, dtype=torch.int8, device=device)
    return eye.repeat(8, 1)


def _s8_st16_input() -> np.ndarray:
    return np.arange(T * 128, dtype=np.int32).reshape(T, 128)


def _mmL_input() -> np.ndarray:
    rng = np.random.default_rng(7)
    return rng.integers(0, 16, (T, 128)).astype(np.int32)


def _s8_st16_probe(device) -> tuple:
    """(the port's result on device, the TPU tool's NumPy gather) on its
    arange input."""
    x = _s8_st16_input()
    want = np.zeros((T // 8, 128), np.int32)
    for s in range(8):
        want[:, 16 * s:16 * (s + 1)] = x[s::8, :16]
    got = s8_st16(torch.from_numpy(x).to(device))
    return got, torch.from_numpy(want).to(got.device)


def _mmL_probe(device) -> tuple:
    """(the port's result on device, the TPU tool's NumPy OR of the int64
    block products) on its nibble input from seed 7 and its weights."""
    w = weights_mmL().numpy().reshape(8, LANES, LANES)
    x = _mmL_input()
    want = np.zeros((T // 8, 128), np.int64)
    for s in range(8):
        want |= x[s::8].astype(np.int64) @ w[s].astype(np.int64)
    got = mm_lanes(torch.from_numpy(x).to(device),
                   torch.from_numpy(w.reshape(8 * LANES, LANES)).to(device))
    return got, torch.from_numpy(want.astype(np.int32)).to(got.device)


def probe_s8_st16(device="cuda") -> bool:
    """The TPU tool's probe: True when the port's result is bit-exact."""
    got, want = _s8_st16_probe(device)
    return torch.equal(got, want)


def probe_mmL(device="cuda") -> bool:
    """The TPU tool's probe: True when the port's result is bit-exact."""
    got, want = _mmL_probe(device)
    return torch.equal(got, want)


PROBES = (("s8+st16", probe_s8_st16), ("mmL", probe_mmL))


def weight_sets(device) -> dict:
    """{name: (1024, 128) int8 on device}: both probes' weights and random
    ones."""
    from .widestore_probe3 import weights_mmLb

    return {"mmL": weights_mmL().to(device),
            "mmLb": weights_mmLb().to(device),
            "random": random_weights(device, 11)}


def _pairs(x: torch.Tensor, weights: dict) -> dict:
    """{"s8_st16": [...], "mmL": [...]}: (got, want, what) of each kernel
    against its plain version on x, the product with each weight set."""
    at = f"rows={x.shape[0]}"
    return {"s8_st16": [(s8_st16(x), _gather_plain(x), at)],
            "mmL": [(mm_lanes(x, w), _packmm_plain(x.view(-1, 8 * LANES), w),
                     f"{at} {name} weights") for name, w in weights.items()]}


def gate(device) -> dict:
    """{"s8_st16", "mmL": {checks, max_abs_err}}: each kernel against its
    plain version on full-range random int32 at 8, 56, 512, 520 and 8000
    rows and on the TPU probe's inputs (the product with both probes'
    weights and random weights), and against the TPU probe's NumPy
    statement."""
    weights = weight_sets(device)
    pairs = {"s8_st16": [(*_s8_st16_probe(device), "TPU probe")],
             "mmL": [(*_mmL_probe(device), "TPU probe")]}
    inputs = [random_words(8 * m, device, m) for m in GATE_ROWS] + [
        torch.from_numpy(make()).to(device)
        for make in (_s8_st16_input, _mmL_input)]
    for x in inputs:
        for name, p in _pairs(x, weights).items():
            pairs[name] += p
    return {name: check_all(p) for name, p in pairs.items()}


def check(words: torch.Tensor) -> dict:
    """{"s8_st16", "mmL": {checks, max_abs_err}}: the gather and the
    product with the probe's weights against their plain versions on the
    (rows, 128) words `run` times."""
    pairs = _pairs(words, {"mmL": weights_mmL().to(words.device)})
    return {name: check_all(p) for name, p in pairs.items()}


def run(words: torch.Tensor, reps: int = 20, plain_reps: int = 2) -> dict:
    """{"s8_st16", "mmL": {ms, eager_ms, gbps (GB/s of input, from ms),
    plain_ms}} on (rows, 128) words, the product with the probe's weights;
    the kernels timed in turns. `check` holds the same calls against the
    plain versions."""
    w = weights_mmL().to(words.device)
    wide = words.view(-1, 8 * LANES)
    ms = kernel_ms({"s8_st16": lambda: s8_st16(words),
                    "mmL": lambda: mm_lanes(words, w)}, reps)
    plain = {"s8_st16": lambda: _gather_plain(words),
             "mmL": lambda: _packmm_plain(wide, w)}
    return {name: {**ms[name], "gbps": words.numel() * 4 / ms[name]["ms"] / 1e6,
                   "plain_ms": interleaved_ms({0: plain[name]}, plain_reps,
                                              rounds=1)[0]}
            for name in ms}


def main(argv) -> int:
    device = need_card("widestore_probe2")
    ok = report_probes(PROBES, device)
    result = {**card(), "gate": gate(device), "sizes": {}}
    for mb in [int(a) for a in argv] or (64, 1024):
        words = random_words(mb * 1024 * 1024 // 512, device, mb)
        result["sizes"][f"{mb}MiB"] = {"check": check(words),
                                       "run": run(words)}
        del words
    emit(result)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
