"""The controls of each cell's check: the plain reference put in the
program's place with one thing broken, which the check has to call not
correct. The benchmark's own runs never run them.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \
        [--device cuda] [--rows N] [--batches 64]

The traffic file's "controls" list what is broken, one control each:
    {"kind": "precision", "dtype": "bfloat16"}  the statements computed
        with every value, product and sum in bfloat16 (the columns are
        float32)
    {"kind": "precision", "dtype": "bfloat16_values"}  the column values
        rounded to bfloat16 (a column stored in bfloat16), the
        arithmetic exact
    {"kind": "truncate", "max_len": 16}  fields served through a window
        of 16 bytes where the cell serves 32 (the widest taxi field has
        19): the lengths stay true, the bytes are cut
    {"kind": "quote_unaware"}  the index built without quote parity, so
        a quoted comma counts as a delimiter
    {"kind": "chunk_local"}  each index position taken modulo the
        traffic's "chunk_bytes": a streamed build that left out the
        rebasing of each chunk's positions
    {"kind": "utf8_unchecked"}  (serving traffic with "validate_utf8")
        the reference builds from the file with its planted byte
        (loops.plant_offset) instead of refusing it

Where the traffic sets "validate_utf8", every other control refuses the
planted file as the reference does (Python's UTF-8 decoder).

For each seed it generates the cell's table as a run does, and prints one
JSON line for each control with the readings beside their limits and
whether the check passed them.
"""

from __future__ import annotations

import argparse
import codecs
import json
import os
import sys

import numpy as np


def _is_utf8(data: np.ndarray) -> bool:
    dec = codecs.getincrementaldecoder("utf-8")()
    try:
        for i in range(0, data.size, 1 << 26):
            dec.decode(data[i:i + (1 << 26)].tobytes())
        dec.decode(b"", final=True)
    except UnicodeDecodeError:
        return False
    return True


def control_outputs(ref, workload: dict, ctl: dict, data: np.ndarray,
                    keys, seed: int) -> dict:
    """What the control `ctl` hands the check in the program's place."""
    from .loops import plant_offset

    out = _control_results(ref, workload, ctl, data, keys)
    if workload["validate_utf8"]:
        planted = data.copy()
        planted[plant_offset(data, seed)] = 0xFF
        out["utf8_refused"] = (ctl["kind"] != "utf8_unchecked"
                               and not _is_utf8(planted))
    return out


def _control_results(ref, workload: dict, ctl: dict, data: np.ndarray,
                     keys) -> dict:
    from .loops import _sample_records
    from .reference import structural

    if ctl["kind"] == "precision":
        return {"results": [(st["name"], ref.statement(st, ctl["dtype"]))
                            for st in workload["statements"]]}
    max_len = int(workload["max_len"])
    index = ref.index
    if ctl["kind"] == "quote_unaware":
        index = structural.structural_index(data, quote_aware=False)
    elif ctl["kind"] == "chunk_local":
        index = index % int(workload["chunk_bytes"])
    elif ctl["kind"] not in ("truncate", "utf8_unchecked"):
        raise ValueError(f"unknown control {ctl['kind']!r}")
    window = int(ctl.get("max_len", max_len))
    served = []
    for recs in keys:
        r = np.repeat(recs.astype(np.int64), ref.n_fields)
        f = np.tile(np.arange(ref.n_fields), recs.size)
        out, ln, valid = structural.serve(data, index, r, f, ref.jump,
                                          ref.n_fields, window)
        full = np.zeros((out.shape[0], max_len), np.uint8)
        full[:, : min(window, max_len)] = out[:, :max_len]
        served.append((recs, full, ln.astype(np.int32), valid))
    sample = _sample_records(np.random.default_rng(0), ref.n_records)
    slots = ((sample[:, None] + 1) * ref.jump
             + np.arange(ref.jump + 1)[None, :]).reshape(-1)
    n = (index.size - 1) // ref.jump - 1
    view = {"n_records": n, "n_fields": ref.n_fields, "jump": ref.jump,
            "slots": slots,
            "positions": index[np.minimum(slots, index.size - 1)],
            "full_index": index, "full_n_records": n}
    return {"served": served, "index": view}


def run_control(spec: dict, cell: str, seed: int, device, rows=None,
                batches: int = 64) -> list:
    import torch

    from . import gen, traffic
    from .check import Reference, judge, readings
    from .run import load_json

    wspec = next(w for w in spec["workloads"] if w["name"] == cell)
    workload = load_json("traffic", wspec["traffic"])
    config = load_json("configs", wspec["config"])
    dev = torch.device(device)
    table = gen.Table(config, seed, dev, rows)
    path = gen.tmp_csv_path(config["name"])
    try:
        table.write(path)
        n = table.n
        del table
        keys = []
        if workload["loop"] != "sql":
            k = traffic.keys(workload["keys"], n,
                             batches * int(workload["batch_records"]),
                             traffic.generator(seed, dev), dev)
            keys = list(k.view(batches, -1).cpu().numpy())
        data = np.fromfile(path, dtype=np.uint8)
        ref = Reference(data)
        out = []
        for ctl in workload["controls"]:
            got = control_outputs(ref, workload, ctl, data, keys, seed)
            values, wrong = readings(ref, workload, got)
            correct, checks = judge(values, workload["limits"])
            out.append({"cell": cell, "seed": seed, "control": ctl,
                        "correct": correct, "wrong_operations": wrong,
                        "checks": checks})
        return out
    finally:
        os.unlink(path)


def main(argv=None) -> int:
    from .run import ROOT, load_spec

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--batches", type=int, default=64)
    args = ap.parse_args(argv)
    spec = load_spec(ROOT)
    for s in args.seeds.split(","):
        for out in run_control(spec, args.workload, int(s), args.device,
                               args.rows, args.batches):
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
