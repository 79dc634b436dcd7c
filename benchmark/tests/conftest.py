"""Shared pieces of the benchmark's CPU tests: small runs of a cell on
the CPU (the port's plain PyTorch versions) through the harness itself."""

import copy

import pytest

from benchmark import run

SEED = 2**31 + 4242  # past 32 signed bits: seeds may be that large


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skipped without one")


@pytest.fixture(scope="session")
def spec():
    return run.load_spec(run.ROOT)


def small_run(spec, cell, monkeypatch=None, seed=SEED, rows=2000,
              seconds=0.3, trace=False, traffic=None):
    """One run of `cell` on the CPU at `rows` rows, its traffic file
    shrunk to a small key pool (and changed by `traffic`, a dict)."""
    load = run.load_json

    def patched(kind, name):
        d = copy.deepcopy(load(kind, name))
        if kind == "traffic":
            d["pool_batches"] = 16
            d.update(traffic or {})
        return d

    mp = monkeypatch or pytest.MonkeyPatch()
    mp.setattr(run, "load_json", patched)
    try:
        return run.run_cell(spec, cell, seed, seconds, trace, device="cpu",
                            rows=rows)
    finally:
        if monkeypatch is None:
            mp.undo()
