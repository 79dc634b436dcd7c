"""The harness end to end on the CPU at small sizes: every cell, a cell
added as data files only, the module check, and the refusal without a
card."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import run

from .conftest import small_run


@pytest.mark.parametrize("cell", ["taxi-ingest-packed", "lineitem-sql",
                                  "taxi-lookup", "lineitem-ingest-offsets"])
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
                                       ("lineitem-sql", "warmup_steps")])
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
    assert "b1_roofline_pct" in res["metrics"]
