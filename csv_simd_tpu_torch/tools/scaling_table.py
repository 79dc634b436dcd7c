"""The scaling table on the port (the counterpart of tools/scaling_table.py):
bytes/s of the index build at 1 device, at several shards of it, on the
host's C++ engine by threads, and across processes.

Sections:
- `chip`: B1's build (B1 and the row prefix B2, the offsets-free
  tape's) and B3's fold build, GB/s of padded input, each checked bit
  for bit against golden first; on --device cpu their plain versions;
- `mesh`: the sharded build (`sharded_stage1`, sequential layout: S1 and
  B1 a shard, the parity and count scans) at 1, 2, 4 and 8 shards of the
  one device. Every shard is on the same device, so these rows show the
  mesh's overhead and its correctness at each width, not scaling across
  cards;
- `native`: the port's C++ host engine by thread count, best of rounds
  taken in turns;
- `multihost`: 2 and 4 processes of `python -m
  csv_simd_tpu_torch.tools.multihost_demo`, joined by torch.distributed
  (gloo, CPU shards), timed a pass by process 0.

    python -m csv_simd_tpu_torch.tools.scaling_table [--mb MB]
        [--device cuda|cpu] [--out FILE]

Writes one JSON object to FILE (stdout by default) and nothing else:
the JAX package's SCALING.json and SCALING.md are the TPU's record and
this tool never writes them. Exit 2 without a card for --device cuda.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from ._common import best_s

MESH_SIZES = (1, 2, 4, 8)
MESH_CAVEAT = ("every shard is on the same device: the rows show the "
               "mesh's overhead, not scaling across cards")


def _buffer(n_bytes: int) -> np.ndarray:
    """n_bytes of the synthetic wide table (tests/corpus.py's generator,
    the 1 GiB configuration's rows)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, os.path.join(root, "tests"))
    try:
        from corpus import synthetic_wide_table
    finally:
        sys.path.pop(0)
    return np.frombuffer(synthetic_wide_table(n_bytes), dtype=np.uint8)


def section_chip(arr: np.ndarray, device) -> dict:
    """B1 + B2 (the offsets-free build) and B3 (the fold build) on one
    device, after a check against golden."""
    from .. import golden
    from ..config import DEFAULT_DIALECT as d
    from ..offsetfree import _prefix_for_packed_xla, _to_device
    from ..offsetfree import prefix_for_packed
    from ..ops.stage1_v2 import ROW_BYTES, padded_rows
    from ..ops.stage1_v3 import stage1_fused, stage1_swar_xla
    from ..ops.stage1_v3 import unpack_packed_host
    from ..ops.stage1_v4 import _stage1_v4_plain, stage1_fused_v4

    on_card = device.type == "cuda"
    padded = padded_rows(arr.size) * ROW_BYTES
    words = _to_device(arr, padded, device).view(torch.int32)
    w2d = words.view(-1, 128)
    want = golden.structural_mask(arr)

    def b1():
        if on_card:
            packed = stage1_fused_v4(words.view(-1, 1024), 0, d,
                                     count_nonascii=False,
                                     out_mode="wide_native")[0]
            return packed, prefix_for_packed(packed)
        packed = _stage1_v4_plain(words, 0, d, False)[0].view(-1, 128)
        return packed, _prefix_for_packed_xla(packed)

    def b3():
        return (stage1_fused if on_card else stage1_swar_xla)(w2d, 0, d)[0]

    packed, _prefix = b1()
    host = packed.reshape(-1).cpu().numpy()
    bits = np.unpackbits(host.view("<u4").view(np.uint8), bitorder="little")
    fold = unpack_packed_host(b3().cpu().numpy(), arr.size,
                              tile=min(512, w2d.shape[0]))
    if not (np.array_equal(bits[:arr.size], want)
            and np.array_equal(fold, want)):
        raise AssertionError("the one-device builds differ from golden")
    t_b1, t_b3 = best_s(b1, device), best_s(b3, device)
    return {"padded_bytes": padded, "b1_build_s": t_b1,
            "b1_build_gbps": padded / t_b1 / 1e9, "b3_fold_s": t_b3,
            "b3_fold_gbps": padded / t_b3 / 1e9,
            "source": "measured", "checked": "golden"}


def section_mesh(arr: np.ndarray, device) -> dict:
    """The sharded build at 1, 2, 4 and 8 shards of `device`."""
    from .. import golden
    from ..parallel.sharded import make_mesh, pad_words_for_mesh
    from ..parallel.sharded import sharded_stage1

    w2d = torch.from_numpy(pad_words_for_mesh(arr, max(MESH_SIZES))).to(
        device)
    padded = w2d.shape[0] * 512
    want = int(golden.structural_mask(arr).sum())
    rows = []
    for n in MESH_SIZES:
        mesh = make_mesh(n, device=device)

        def build():
            return sharded_stage1(w2d, 0, mesh, layout="seq")

        if int(build()[3]) != want:
            raise AssertionError(f"the sharded build at {n} shards counts "
                                 "other than golden")
        s = best_s(build, device)
        rows.append({"shards": n, "s_per_pass": s, "gbps": padded / s / 1e9})
    base = rows[0]["gbps"]
    for r in rows:
        r["speedup_vs_1"] = r["gbps"] / base
        r["efficiency_vs_1"] = r["gbps"] / (base * r["shards"])
    return {"padded_bytes": padded, "total_structural": want,
            "caveat": MESH_CAVEAT, "rows": rows}


def section_native(arr: np.ndarray) -> dict:
    """The port's C++ engine by thread count: rounds taken in turns, so
    that a change in the host's load does not pass for scaling."""
    from .. import golden, native

    if not native.available():
        return {"error": f"native engine unavailable: {native.build_error()}"}
    want = int(golden.structural_mask(arr).sum())
    ncpu = os.cpu_count() or 1
    threads = sorted(x for x in {1, 2, 4, 8, min(16, ncpu), ncpu}
                     if x <= ncpu)
    for t in threads:
        offs, _par = native.host_stage1(arr, n_threads=t)
        if offs.shape[0] != want:
            raise AssertionError(f"native at {t} threads counts other than "
                                 "golden")
    best = {t: float("inf") for t in threads}
    for _round in range(4):
        for t in threads:
            t0 = time.perf_counter()
            native.host_stage1(arr, n_threads=t)
            best[t] = min(best[t], time.perf_counter() - t0)
    rows = [{"threads": t, "s_per_pass": best[t],
             "gbps": arr.size / best[t] / 1e9} for t in threads]
    base = rows[0]["gbps"]
    for r in rows:
        r["speedup_vs_1"] = r["gbps"] / base
        r["efficiency_vs_1"] = r["gbps"] / (base * r["threads"])
    return {"bytes": int(arr.size), "cpus": ncpu, "rows": rows}


def run_multihost(n_procs: int, n_bytes: int) -> dict:
    """One pass of the demo over n_procs gloo processes on this host."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["MULTIHOST_BYTES"] = str(n_bytes)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "csv_simd_tpu_torch.tools.multihost_demo",
         f"127.0.0.1:{port}", str(n_procs), str(i)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(n_procs)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_out, err) in zip(procs, outs):
        if p.returncode != 0:
            return {"processes": n_procs, "error": err[-500:]}
    entry = {"processes": n_procs}
    for line in outs[0][0].splitlines():
        if line.startswith("MULTIHOST_TIME"):
            _, sec, nbytes, shards = line.split()
            entry.update(s_per_pass=float(sec), padded_bytes=int(nbytes),
                         shards=int(shards),
                         gbps=int(nbytes) / float(sec) / 1e9)
        if line.startswith("MULTIHOST_OK"):
            entry["total_structural"] = int(line.split()[1])
    return entry


def measure(mb: float, device="cuda") -> dict:
    from ..device import resolve_device

    dev = resolve_device(device)
    arr = _buffer(int(mb * (1 << 20)))
    table = {"buffer_mb": mb, "device": str(dev)}
    if dev.type == "cuda":
        table["card"] = torch.cuda.get_device_name(dev)
    table["chip"] = section_chip(arr, dev)
    table["mesh"] = section_mesh(arr, dev)
    table["native"] = section_native(arr)
    n_bytes = min(arr.size, 8 << 20)
    table["multihost"] = [run_multihost(n, n_bytes) for n in (2, 4)]
    return table


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="scaling_table")
    p.add_argument("--mb", type=float, default=1024.0,
                   help="buffer size in MiB (default 1024)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=None,
                   help="write the JSON here (default: stdout)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("# scaling_table: no NVIDIA card (torch.cuda.is_available() is "
              "False); pass --device cpu for the plain versions",
              file=sys.stderr)
        return 2
    text = json.dumps(measure(args.mb, args.device))
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    else:
        print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
