"""The wide-store probes of tools/widestore_probe3.py on the card: the
lane-window loads (laneload) and the per-block lane-placed int8 pack
product (mmLb), on the (rows/8, 1024) view of the words.

- `laneload(x)`: (M, 1024) int32 -> (M, 128) int32, the sum of the eight
  128-lane windows, out[r, j] = sum over k of x[r, 128k + j], int32 adds
  that wrap.
- `mm_lanes_b(x, w)`: (M, 1024) int32 and (1024, 128) int8 -> (M, 128)
  int32, the OR over k < 8 of int8(x[:, 128k:128k+128]) @
  w[128k:128k+128]: tools/widestore_probe2's `packmm`, the one product of
  mmL and mmLb.

The probe's weights (`weights_mmLb`) send lane 8g + l of block k to column
16k + g with weight 1 for even l and 16 for odd l. On a CUDA tensor the
lane sum runs csrc/probe_widestore.cu and the pack product
csrc/probe_concatmm.cu (the tensor cores), on a CPU tensor each its plain
version. `probe_laneload` and `probe_mmLb` are the TPU
tool's probes: its input and NumPy statement, held against the port's
result.

    python -m csv_simd_tpu_torch.tools.widestore_probe3 [mb ...]
        the probes, the gate, then each kernel checked and timed on mb MiB
        of random int32 (default 64 and 1024)
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ._common import (
    card,
    check_all,
    emit,
    interleaved_ms,
    kernel_ms,
    need_card,
    random_words,
    report_probes,
    wrap_sum,
)
from ._lab_kernels import check_wide
from .widestore_probe2 import (
    GATE_ROWS,
    LANES,
    _packmm_plain,
    packmm,
    weight_sets,
)

T8 = 64       # the TPU probe's input rows


def _lanesum_plain(x: torch.Tensor) -> torch.Tensor:
    return wrap_sum(x.view(-1, 8, LANES), 1)


def laneload(x: torch.Tensor) -> torch.Tensor:
    """(M, 1024) int32 -> (M, 128) int32: see the module docstring."""
    check_wide(x, "laneload")
    if x.device.type == "cuda":
        from . import _lab_kernels

        return _lab_kernels.probe_ws_lanesum(x)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return _lanesum_plain(x)


def mm_lanes_b(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, 1024) int32 and (1024, 128) int8 -> (M, 128) int32: the OR over
    k < 8 of int8(x[:, 128k:128k+128]) @ w[128k:128k+128]."""
    return packmm(x, w)


def weights_mmLb() -> torch.Tensor:
    """The TPU probe's (1024, 128) int8 weights, on the CPU."""
    w = np.zeros((8, LANES, LANES), np.int8)
    for k in range(8):
        for lane in range(LANES):
            g, l = divmod(lane, 8)
            w[k, lane, 16 * k + g] = 1 if l % 2 == 0 else 16
    return torch.from_numpy(w.reshape(8 * LANES, LANES))


def _laneload_input() -> np.ndarray:
    return np.arange(T8 * 8 * LANES, dtype=np.int32).reshape(T8, 8 * LANES)


def _mmLb_input() -> np.ndarray:
    rng = np.random.default_rng(7)
    return rng.integers(0, 16, (T8, 8 * LANES)).astype(np.int32)


def _laneload_probe(device) -> tuple:
    """(the port's result on device, the TPU tool's NumPy int32 sum) on
    its arange input."""
    x = _laneload_input()
    want = x.reshape(T8, 8, LANES).sum(axis=1, dtype=np.int32)
    got = laneload(torch.from_numpy(x).to(device))
    return got, torch.from_numpy(want).to(got.device)


def _mmLb_probe(device) -> tuple:
    """(the port's result on device, the TPU tool's NumPy OR of the int64
    block products) on its nibble input from seed 7 and its weights."""
    w = weights_mmLb().numpy().reshape(8, LANES, LANES)
    x = _mmLb_input()
    want = np.zeros((T8, LANES), np.int64)
    for k in range(8):
        want |= x[:, LANES * k:LANES * (k + 1)].astype(np.int64) \
            @ w[k].astype(np.int64)
    got = mm_lanes_b(torch.from_numpy(x).to(device),
                     torch.from_numpy(w.reshape(8 * LANES, LANES)).to(device))
    return got, torch.from_numpy(want.astype(np.int32)).to(got.device)


def probe_laneload(device="cuda") -> bool:
    """The TPU tool's probe: True when the port's result is bit-exact."""
    got, want = _laneload_probe(device)
    return torch.equal(got, want)


def probe_mmLb(device="cuda") -> bool:
    """The TPU tool's probe: True when the port's result is bit-exact."""
    got, want = _mmLb_probe(device)
    return torch.equal(got, want)


PROBES = (("laneload", probe_laneload), ("mmLb", probe_mmLb))


def _pairs(x: torch.Tensor, weights: dict) -> dict:
    """{"laneload": [...], "mmLb": [...]}: (got, want, what) of each
    kernel against its plain version on x, the product with each weight
    set."""
    at = f"M={x.shape[0]}"
    return {"laneload": [(laneload(x), _lanesum_plain(x), at)],
            "mmLb": [(mm_lanes_b(x, w), _packmm_plain(x, w),
                      f"{at} {name} weights") for name, w in weights.items()]}


def gate(device) -> dict:
    """{"laneload", "mmLb": {checks, max_abs_err}}: each kernel against
    its plain version on full-range random int32 at M = 1, 7, 64, 65 and
    1000 and on the TPU probe's inputs (the product with both probes'
    weights and random weights), and against the TPU probe's NumPy
    statement."""
    weights = weight_sets(device)
    pairs = {"laneload": [(*_laneload_probe(device), "TPU probe")],
             "mmLb": [(*_mmLb_probe(device), "TPU probe")]}
    inputs = [random_words(8 * m, device, 3 * m).view(-1, 8 * LANES)
              for m in GATE_ROWS] + [
        torch.from_numpy(make()).to(device)
        for make in (_laneload_input, _mmLb_input)]
    for x in inputs:
        for name, p in _pairs(x, weights).items():
            pairs[name] += p
    return {name: check_all(p) for name, p in pairs.items()}


def check(x: torch.Tensor) -> dict:
    """{"laneload", "mmLb": {checks, max_abs_err}}: the lane sum and the
    product with the probe's weights against their plain versions on the
    (M, 1024) input `run` times."""
    pairs = _pairs(x, {"mmLb": weights_mmLb().to(x.device)})
    return {name: check_all(p) for name, p in pairs.items()}


def run(x: torch.Tensor, reps: int = 20, plain_reps: int = 2) -> dict:
    """{"laneload", "mmLb": {ms, eager_ms, gbps (GB/s of input, from ms),
    plain_ms}} on (M, 1024) x, the product with the probe's weights; the
    kernels timed in turns. `check` holds the same calls against the
    plain versions."""
    w = weights_mmLb().to(x.device)
    ms = kernel_ms({"laneload": lambda: laneload(x),
                    "mmLb": lambda: mm_lanes_b(x, w)}, reps)
    plain = {"laneload": lambda: _lanesum_plain(x),
             "mmLb": lambda: _packmm_plain(x, w)}
    return {name: {**ms[name], "gbps": x.numel() * 4 / ms[name]["ms"] / 1e6,
                   "plain_ms": interleaved_ms({0: plain[name]}, plain_reps,
                                              rounds=1)[0]}
            for name in ms}


def main(argv) -> int:
    device = need_card("widestore_probe3")
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
