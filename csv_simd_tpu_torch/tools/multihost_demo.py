"""Multi-process sharded index build check (tools/multihost_demo.py).

Each process plays one host with 4 local CPU shards; torch.distributed
(gloo) joins them into one global mesh, and parallel.sharded's
sharded_stage1 runs over it as over one process's mesh: local parities
and builds, with the parity and count scans all-gathered across every
process's shards. Run one process a rank:

    python -m csv_simd_tpu_torch.tools.multihost_demo HOST:PORT N RANK

Process 0 prints "MULTIHOST_OK <total structural>" once the fold and the
seq layouts' totals, parities and per-shard counts equal golden's, then
"MULTIHOST_TIME <best s> <padded bytes> <shards>". MULTIHOST_BYTES sets
the input size (default 300,000 seeded CSV-ish bytes, quotes included).
"""

from __future__ import annotations

import os
import sys
import time

LOCAL_SHARDS = 4


def main(argv=None) -> int:
    coordinator, num, pid = (argv or sys.argv[1:])[:3]
    num, pid = int(num), int(pid)

    import numpy as np
    import torch
    import torch.distributed as dist

    from .. import golden
    from ..parallel.sharded import Mesh, pad_words_for_mesh, sharded_stage1

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num, rank=pid)
    try:
        mesh = Mesh(["cpu"] * LOCAL_SHARDS, group=dist.group.WORLD)
        n_bytes = int(os.environ.get("MULTIHOST_BYTES", "300000"))
        rng = np.random.default_rng(7)
        arr = rng.choice(np.frombuffer(b'ab"",\n\rx,z: 09', dtype=np.uint8),
                         size=n_bytes)
        w2d = torch.from_numpy(pad_words_for_mesh(arr, mesh.size))
        shard_rows = w2d.shape[0] // mesh.size
        # each process hands over its own shards only
        local = [w2d[(mesh.first_shard + k) * shard_rows:
                     (mesh.first_shard + k + 1) * shard_rows]
                 for k in range(LOCAL_SHARDS)]
        mask = golden.structural_mask(arr)
        want = int(mask.sum())
        want_par = golden.quote_parity_out(arr)
        bounds = np.arange(mesh.size + 1) * shard_rows * 512
        want_counts = np.add.reduceat(
            np.concatenate([mask, np.zeros(bounds[-1] - arr.size, mask.dtype)]),
            bounds[:-1]).astype(np.int64)
        for layout in ("fold", "seq"):
            _packed, counts, _excl, total, parity = sharded_stage1(
                local, 0, mesh, use_pallas=False, layout=layout)
            got = (int(total), int(parity), counts.numpy().tolist())
            if got != (want, want_par, want_counts.tolist()):
                raise AssertionError(f"{layout}: {got} != "
                                     f"{(want, want_par, want_counts)}")
        reps = int(os.environ.get("MULTIHOST_TIME_REPS", "3"))
        best = float("inf")
        for _ in range(reps):
            dist.barrier()
            t0 = time.perf_counter()
            sharded_stage1(local, 0, mesh, use_pallas=False)
            best = min(best, time.perf_counter() - t0)
        if pid == 0:
            print(f"MULTIHOST_OK {want}", flush=True)
            print(f"MULTIHOST_TIME {best:.6f} {w2d.shape[0] * 512} "
                  f"{mesh.size}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
