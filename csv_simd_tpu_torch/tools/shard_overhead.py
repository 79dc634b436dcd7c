"""Sharded-path overhead attribution on the port's mesh (the counterpart
of tools/shard_overhead.py): the sharded build's time a pass decomposed
by ablation, at mesh widths n = 1, 2, 4 and 8.

Rows per mesh width n, all on the sequential layout, so that each delta
isolates one mechanism:
  full     - the production `sharded_stage1(layout="seq")`: S1's local
             parity a shard, the parity scan across shards, B1 a shard
             with its carried parity, the count scan
  nocoll   - the collectives ablated: each shard's carry is its own
             parity and its count stays local; full - nocoll is the
             cost of the gathers and scans at width n
  nophaseA - S1's local parity also ablated (carry 0): nocoll -
             nophaseA is the second read of the buffer that the sharded
             build pays
  plain    - B1 on the whole buffer on one device, no mesh: full(1) -
             plain is the mesh's own overhead
On --device cpu the shards run the kernels' plain versions.

Caveat, stamped into the output: every shard of these meshes is on ONE
device (`make_mesh(n, device)` repeats the card), so the shards' builds
run one after another on it: the table attributes OVERHEAD, it does not
measure scaling across cards.

    python -m csv_simd_tpu_torch.tools.shard_overhead [MB] [--device cuda|cpu]
        [--out FILE]

Prints one JSON object (also written to FILE with --out); the sharded
build's words are checked bit for bit against golden first. Exit 2
without a card for --device cuda.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ._common import best_s

MESH_SIZES = (1, 2, 4, 8)
CAVEAT = ("every shard of these meshes is on one device, so the rows "
          "attribute overhead and do not measure scaling across cards")


def _buffer(n_bytes: int, seed: int = 11) -> np.ndarray:
    """n_bytes of seeded CSV-ish bytes (the JAX tool's cell alphabet)."""
    rng = np.random.default_rng(seed)
    cell = np.frombuffer(b"abcdefgh,123,456.75,x\n", np.uint8)
    return np.asarray(rng.choice(cell, n_bytes), np.uint8)


def _variant(which: str, shards: list, dialect, use_pallas: bool):
    """One ablated pass over the shards (the rows' definitions above)."""
    from ..parallel.sharded import _local_parity, _shard_fn

    def run():
        if which == "nophaseA":
            carries = [0] * len(shards)
        else:
            carries = [_local_parity(w, dialect) for w in shards]
        return [_shard_fn(w, c, dialect, use_pallas, 512, "seq", False)
                for w, c in zip(shards, carries)]

    return run


def measure(mb: float, device="cuda") -> dict:
    """The table for an `mb` MiB buffer on `device`."""
    from .. import golden
    from ..config import DEFAULT_DIALECT
    from ..device import resolve_device
    from ..parallel.sharded import (
        _shard_fn,
        make_mesh,
        pad_words_for_mesh,
        sharded_stage1,
    )

    dev = resolve_device(device)
    use_pallas = dev.type == "cuda"
    arr = _buffer(int(mb * (1 << 20)))
    w2d = torch.from_numpy(pad_words_for_mesh(arr, max(MESH_SIZES))).to(dev)
    padded = w2d.shape[0] * 512
    want = golden.structural_mask(arr)

    plain = lambda: _shard_fn(w2d, 0, DEFAULT_DIALECT, use_pallas, 512,  # noqa: E731
                              "seq", False)
    t_plain = best_s(plain, dev)
    out = {"mb": mb, "padded_bytes": padded, "device": str(dev),
           "caveat": CAVEAT, "plain_s": t_plain,
           "plain_gbps": padded / t_plain / 1e9, "rows": []}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
    for n in MESH_SIZES:
        mesh = make_mesh(n, device=dev)
        step = w2d.shape[0] // n
        shards = [w2d[k * step:(k + 1) * step] for k in range(n)]
        # the anchor: the production build's words against golden
        packed, _counts, _excl, total, parity = sharded_stage1(
            shards, 0, mesh, layout="seq")
        host = torch.cat([p.reshape(-1) for p in packed]).cpu().numpy()
        bits = np.unpackbits(host.view("<u4").view(np.uint8),
                             bitorder="little")
        if not (np.array_equal(bits[:arr.size], want)
                and not bits[arr.size:].any()
                and int(total) == int(want.sum())
                and int(parity) == golden.quote_parity_out(arr)):
            raise AssertionError(f"sharded_stage1 at {n} shards differs "
                                 "from golden")
        row = {"shards": n, "full_s": best_s(
            lambda: sharded_stage1(shards, 0, mesh, layout="seq"), dev)}
        for which in ("nocoll", "nophaseA"):
            row[f"{which}_s"] = best_s(
                _variant(which, shards, DEFAULT_DIALECT, use_pallas),
                dev)
        row["collectives_s"] = row["full_s"] - row["nocoll_s"]
        row["phaseA_s"] = row["nocoll_s"] - row["nophaseA_s"]
        row["gbps"] = padded / row["full_s"] / 1e9
        out["rows"].append(row)
    out["mesh_overhead_s"] = out["rows"][0]["full_s"] - t_plain
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="shard_overhead")
    p.add_argument("mb", nargs="?", type=float, default=256.0,
                   help="buffer size in MiB (default 256)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("# shard_overhead: no NVIDIA card (torch.cuda.is_available() "
              "is False); pass --device cpu for the plain versions",
              file=sys.stderr)
        return 2
    table = measure(args.mb, args.device)
    text = json.dumps(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
