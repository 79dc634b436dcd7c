"""The harness end to end on the CPU at small sizes: every cell, a cell
added as data files only (and one under "validate_utf8"), the planted
byte, the module check, and the refusal without a card."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import control, loops, run

from .conftest import SEED, small_run


@pytest.mark.parametrize("cell", ["taxi-ingest-packed", "lineitem-sql",
                                  "taxi-lookup", "lineitem-ingest-offsets",
                                  "taxi-ingest-streaming"])
def test_every_cell_runs_correct_on_the_cpu(spec, cell, monkeypatch):
    out = small_run(spec, cell, monkeypatch)
    res = out["result"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    want = {m["name"] for m in run.reported(spec["end_to_end"], cell)}
    assert set(res["metrics"]) == want
    assert list(res)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    assert {"generate_s", "first_build_s", "warmup_s"} <= set(
        out["setup_parts"])


@pytest.mark.parametrize("cell, key", [("taxi-lookup", "check_share"),
                                       ("taxi-lookup", "keys"),
                                       ("lineitem-sql", "warmup_steps"),
                                       ("taxi-ingest-streaming",
                                        "chunk_bytes"),
                                       ("taxi-ingest-packed",
                                        "validate_utf8"),
                                       ("lineitem-sql", "validate_utf8")])
def test_a_traffic_file_sets_every_parameter_its_loop_reads(spec, monkeypatch,
                                                            cell, key):
    """Each value lives in the traffic file alone: the code has no
    default for it."""
    load = run.load_json

    def without(kind, name):
        d = load(kind, name)
        if kind == "traffic":
            d.pop(key)
        return d

    monkeypatch.setattr(run, "load_json", without)
    with pytest.raises(KeyError, match=key):
        run.run_cell(spec, cell, 5, 0.1, False, device="cpu", rows=500)


def test_a_cell_added_as_data_files_only(spec, tmp_path, monkeypatch):
    """A new traffic file and a new BENCHMARK.json entry make a new cell,
    with no edit to any file the benchmark has."""
    here = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics", "end_to_end"):
        shutil.copytree(os.path.join(run.HERE, sub), here / sub)
    with open(here / "traffic" / "ycsb-c-packed.json") as f:
        uniform = json.load(f)
    uniform["keys"] = {"dist": "uniform"}
    with open(here / "traffic" / "ycsb-c-uniform.json", "w") as f:
        json.dump(uniform, f)
    new = dict(spec)
    new["workloads"] = spec["workloads"] + [{
        "name": "taxi-lookup-uniform", "config": "nyc-taxi-yellow-2015-01",
        "traffic": "ycsb-c-uniform", "chips": 1, "why": "control"}]
    new["end_to_end"] = [
        dict(m, workloads=m["workloads"] + ["taxi-lookup-uniform"])
        if "taxi-lookup" in m.get("workloads", []) else m
        for m in spec["end_to_end"]]
    monkeypatch.setattr(run, "HERE", str(here))
    out = small_run(new, "taxi-lookup-uniform", monkeypatch)
    assert out["result"]["correct"] is True
    assert {"lookups_per_s", "lookup_p99_ms", "setup_s"} == set(
        out["result"]["metrics"])


def _utf8_cells(spec, here):
    """A taxi month with a non-ASCII store_and_fwd_flag, and two cells
    that ingest it with "validate_utf8": true on the packed and the
    offsets tape: data files under `here` and entries in a copy of
    `spec` alone."""
    for sub in ("configs", "traffic", "metrics", "end_to_end"):
        shutil.copytree(os.path.join(run.HERE, sub), here / sub)
    with open(here / "configs" / "nyc-taxi-yellow-2015-01.json") as f:
        config = json.load(f)
    config["name"] = "taxi-utf8"
    flag = next(c for c in config["columns"]
                if c["name"] == "store_and_fwd_flag")
    flag["value"] = "pick([0, 1, 2], [0.5, 0.3, 0.2])"
    flag["format"] = {"choice": ["N", "S\u00ed", "\u00e9\u65e5"]}
    with open(here / "configs" / "taxi-utf8.json", "w") as f:
        json.dump(config, f)
    new = dict(spec, configs=spec["configs"] + [dict(
        spec["configs"][0], name="taxi-utf8",
        file="benchmark/configs/taxi-utf8.json")])
    cells = []
    for tape in ("packed", "offsets"):
        with open(here / "traffic" / f"ingest-{tape}.json") as f:
            traffic = json.load(f)
        traffic["validate_utf8"] = True
        traffic["limits"]["utf8_unrefused"] = 0
        traffic["controls"] = [{"kind": "utf8_unchecked"}]
        with open(here / "traffic" / f"ingest-{tape}-utf8.json", "w") as f:
            json.dump(traffic, f)
        cells.append({"name": f"taxi-utf8-{tape}", "config": "taxi-utf8",
                      "traffic": f"ingest-{tape}-utf8", "chips": 1,
                      "why": "U1 on the build"})
    new["workloads"] = spec["workloads"] + cells
    new["end_to_end"] = [
        dict(m, workloads=m["workloads"] + [c["name"] for c in cells])
        if m["name"] == "ingest_GBps" else m for m in spec["end_to_end"]]
    return new


@pytest.mark.parametrize("tape", ["packed", "offsets"])
def test_a_validated_cell_added_as_data_files_only(spec, tmp_path,
                                                   monkeypatch, tape):
    """A non-ASCII configuration under "validate_utf8": true is new files
    and entries alone. Its valid file builds and is correct; the file with
    its planted byte is refused, and a build that skips the check is not
    correct."""
    new = _utf8_cells(spec, tmp_path / "benchmark")
    monkeypatch.setattr(run, "HERE", str(tmp_path / "benchmark"))
    cell = f"taxi-utf8-{tape}"
    res = small_run(new, cell, monkeypatch)["result"]
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["utf8_unrefused"] == {"value": 0, "limit": 0}
    assert {"ingest_GBps", "setup_s"} == set(res["metrics"])
    for ctl in control.run_control(new, cell, SEED, "cpu", rows=2000,
                                   batches=2):
        assert ctl["correct"] is False, ctl["control"]
    from csv_simd_tpu_torch.ops import utf8

    monkeypatch.setattr(utf8, "validate_utf8", lambda *a, **k: True)
    monkeypatch.setattr(utf8, "validate_utf8_device", lambda *a, **k: True)
    res = small_run(new, cell, monkeypatch)["result"]
    assert res["correct"] is False
    assert res["checks"]["utf8_unrefused"] == {"value": 1, "limit": 0}


def test_a_streamed_tape_cannot_be_validated(spec, monkeypatch):
    """create_streaming has no validate_utf8: the pair raises, naming it,
    before any build."""
    with pytest.raises(ValueError, match='"streaming" with "validate_utf8"'):
        small_run(spec, "taxi-ingest-streaming", monkeypatch,
                  traffic={"validate_utf8": True})


@pytest.mark.parametrize("seed", [1, 7, SEED])
def test_the_planted_byte_starts_a_record_in_the_last_quarter(seed):
    """The first byte of a whole record's first field, inside its quotes,
    past three quarters of the file: a quoted line end is no record's
    end, and the file's structure stays as it was."""
    from benchmark.reference.structural import structural_index

    rec = b'"x\ny,z",12,w\n'
    data = np.frombuffer(b"h1,h2,h3\n" + rec * 5000, np.uint8)
    at = loops.plant_offset(data, seed)
    assert at >= data.size * 3 // 4
    assert bytes(data[at - 2:at + 1]) == b'\n"x'
    assert (at - 10) % len(rec) == 0
    assert loops.plant_offset(data, seed) == at
    planted = data.copy()
    planted[at] = 0xFF
    assert np.array_equal(structural_index(planted), structural_index(data))
    with pytest.raises(ValueError, match="non-empty first field"):
        loops.plant_offset(np.frombuffer(b"a,b\n" + b",1\n" * 1000,
                                         np.uint8), seed)


@pytest.mark.parametrize("name, bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax", True), ("csv_simd_tpu", True), ("csv_simd_tpu.api", True),
    ("tests.corpus", True), ("tools.bench", True),
    ("csv_simd_tpu_torch", False), ("csv_simd_tpu_torch.api", False),
    ("jaxtyping", False), ("benchmark.run", False), ("torch", False)])
def test_forbidden_modules_compare_whole_top_level_names(name, bad):
    assert run.forbidden_modules([name]) == ([name] if bad else [])


def test_a_run_loads_no_forbidden_module(spec, monkeypatch):
    small_run(spec, "lineitem-sql", monkeypatch)
    assert run.forbidden_modules(list(sys.modules)) == []


def test_without_a_card_the_run_exits_2_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "taxi-ingest-packed", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=run.ROOT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode == 2
    assert p.stdout.strip() == ""


def test_without_the_program_the_run_fails(tmp_path):
    """A checkout that holds only BENCHMARK.json and benchmark/ cannot
    import the program: the run exits non-zero and prints no result."""
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(run.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = ("import sys, torch; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; "
            "from benchmark import run; sys.exit(run.main(["
            "'--workload', 'taxi-ingest-packed', '--seed', '3', "
            "'--seconds', '1', '--trace', '0']))")
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "taxi-ingest-packed", "--seed", str(2**31 + 17), "--seconds", "3",
         "--trace", "1"], cwd=run.ROOT, capture_output=True, text=True,
        timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["busy_s"] > 0
    assert "ingest_GBps.traced" in res["metrics"]
