"""Shared pieces of the benchmark's CPU tests: small runs of a cell on
the CPU (the port's plain PyTorch versions) through the harness itself."""

import copy

import pytest

from benchmark import run

SEED = 2**31 + 4242  # past 32 signed bits: seeds may be that large
# the streaming tape's chunks (and so the chunk_local control's N) at the
# CPU tests' sizes: a table of a few hundred KB is cut into several chunks, so
# the rebasing of each chunk's positions is checked across the cuts
SMALL_CHUNK = 32 * 1024


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card; skipped without one")


@pytest.fixture(scope="session")
def spec():
    return run.load_spec(run.ROOT)


def small_traffic(mp, traffic=None):
    """Patch the harness's loader so that every traffic file has a small
    key pool and SMALL_CHUNK for its streaming chunks (and is changed by
    `traffic`, a dict)."""
    load = run.load_json

    def patched(kind, name):
        d = copy.deepcopy(load(kind, name))
        if kind == "traffic":
            d["pool_batches"] = 16
            if d.get("tape") == "streaming":
                d["chunk_bytes"] = SMALL_CHUNK
            d.update(traffic or {})
        return d

    mp.setattr(run, "load_json", patched)


def small_run(spec, cell, monkeypatch=None, seed=SEED, rows=2000,
              seconds=0.3, trace=False, traffic=None):
    """One run of `cell` on the CPU at `rows` rows, its traffic file
    shrunk by small_traffic (and changed by `traffic`, a dict)."""
    mp = monkeypatch or pytest.MonkeyPatch()
    small_traffic(mp, traffic)
    try:
        return run.run_cell(spec, cell, seed, seconds, trace, device="cpu",
                            rows=rows)
    finally:
        if monkeypatch is None:
            mp.undo()
