"""The port's sharding tools on the CPU at 1 MiB: `python -m
csv_simd_tpu_torch.tools.shard_overhead` and `...tools.scaling_table`
with `--device cpu`. Their rows are present, the sharded build they time
is bit-identical to golden (each tool checks it before it times, and the
test checks the same build here), each writes only its `--out` file, and
scaling_table leaves the TPU's record (SCALING.json, SCALING.md) as it
was. Without a card the default `--device cuda` exits 2."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from csv_simd_tpu_torch import golden
from csv_simd_tpu_torch.parallel.sharded import (
    make_mesh,
    pad_words_for_mesh,
    sharded_stage1,
)
from csv_simd_tpu_torch.tools import scaling_table, shard_overhead

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _run_tool(module: str, args: list, cwd) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run(
        [sys.executable, "-m", f"csv_simd_tpu_torch.tools.{module}", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_shard_overhead_rows_and_out(tmp_path):
    out = tmp_path / "overhead.json"
    work = tmp_path / "work"
    work.mkdir()
    r = _run_tool("shard_overhead", ["1", "--device", "cpu", "--out",
                                     str(out)], work)
    assert r.returncode == 0, r.stderr
    table = json.loads(out.read_text())
    assert json.loads(r.stdout.strip().splitlines()[-1]) == table
    assert [row["shards"] for row in table["rows"]] == [1, 2, 4, 8]
    for row in table["rows"]:
        for key in ("full_s", "nocoll_s", "nophaseA_s", "collectives_s",
                    "phaseA_s", "gbps"):
            assert key in row
    assert table["plain_s"] > 0 and "one device" in table["caveat"]
    assert table["device"] == "cpu"
    assert list(work.iterdir()) == []
    assert sorted(p.name for p in tmp_path.iterdir()) == ["overhead.json",
                                                          "work"]


@pytest.mark.parametrize("n", [1, 8])
def test_shard_overhead_full_build_is_golden(n):
    """The build the tool times (its buffer, the sequential layout) is
    golden's mask bit for bit at 1 and 8 shards."""
    arr = shard_overhead._buffer(1 << 20)
    w2d = torch.from_numpy(pad_words_for_mesh(arr, 8))
    packed, _c, _e, total, parity = sharded_stage1(
        w2d, 0, make_mesh(n, device="cpu"), layout="seq")
    host = torch.cat([p.reshape(-1) for p in packed]).numpy()
    bits = np.unpackbits(host.view("<u4").view(np.uint8), bitorder="little")
    want = golden.structural_mask(arr)
    assert np.array_equal(bits[:arr.size], want)
    assert not bits[arr.size:].any()
    assert int(total) == int(want.sum())
    assert int(parity) == golden.quote_parity_out(arr)


def test_scaling_table_sections_and_out(tmp_path):
    record = {name: (REPO / name).read_bytes()
              for name in ("SCALING.json", "SCALING.md")}
    out = tmp_path / "scaling.json"
    work = tmp_path / "work"
    work.mkdir()
    r = _run_tool("scaling_table", ["--mb", "1", "--device", "cpu", "--out",
                                    str(out)], work)
    assert r.returncode == 0, r.stderr
    assert r.stdout == ""
    table = json.loads(out.read_text())
    assert table["chip"]["checked"] == "golden"
    assert table["chip"]["b1_build_gbps"] > 0
    assert table["chip"]["b3_fold_gbps"] > 0
    assert [row["shards"] for row in table["mesh"]["rows"]] == [1, 2, 4, 8]
    assert table["native"]["rows"][0]["threads"] == 1
    assert [e["processes"] for e in table["multihost"]] == [2, 4]
    for e in table["multihost"]:
        assert "error" not in e and e["shards"] == 4 * e["processes"]
    assert list(work.iterdir()) == []
    assert sorted(p.name for p in tmp_path.iterdir()) == ["scaling.json",
                                                          "work"]
    for name, data in record.items():
        assert (REPO / name).read_bytes() == data


def test_scaling_table_to_stdout_and_refusals(capsys):
    assert scaling_table.main(["--mb", "0.25", "--device", "cpu"]) == 0
    table = json.loads(capsys.readouterr().out)
    assert set(table) >= {"chip", "mesh", "native", "multihost"}
    for main in (scaling_table.main, shard_overhead.main):
        with pytest.raises(SystemExit):
            main(["--device", "tpu"])
    if not torch.cuda.is_available():
        assert scaling_table.main(["--mb", "1"]) == 2
        assert shard_overhead.main(["1"]) == 2
