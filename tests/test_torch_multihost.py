"""The port's multi-process sharded build on the CPU: N processes, each
with 4 local CPU shards, joined by torch.distributed (gloo) into one
mesh of 4N shards; csv_simd_tpu_torch/tools/multihost_demo.py checks the
fold and seq layouts' totals, parities and per-shard counts against
golden, which the parity and count scans across processes must stitch
as one process's mesh does. The counterpart of tests/test_multihost.py
(jax.distributed)."""

import os
import pathlib
import socket
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n_procs", [2, 4])
def test_multi_process_sharded_build(n_procs):
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "csv_simd_tpu_torch.tools.multihost_demo",
             coord, str(n_procs), str(i)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        for i in range(n_procs)
    ]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("the multi-process demo timed out")
    for p, (_out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    lines = outs[0][0].splitlines()
    assert lines[0].startswith("MULTIHOST_OK "), outs[0][0]
    assert lines[1].split()[-1] == str(4 * n_procs)
    assert all("MULTIHOST_OK" not in out for out, _ in outs[1:])
