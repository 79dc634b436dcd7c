"""The port's own host modules: config, errors, utils, serve, tape,
artifact, golden and the native engine are files of csv_simd_tpu_torch,
the port runs with no csv_simd_tpu beside it and jax blocked, and its
native library builds under csv_simd_tpu_torch/_build/. The copies
compute what the JAX package's modules compute, on the same inputs
(tolerance 0: offsets, bytes and names)."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import csv_simd_tpu
import csv_simd_tpu_torch as ct
from csv_simd_tpu import config as jconfig
from csv_simd_tpu import golden as jgolden
from csv_simd_tpu.tape import Header as JHeader
from csv_simd_tpu_torch import config, golden, native
from csv_simd_tpu_torch.tape import Header

from corpus import all_cases, synthetic_wide_table

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "csv_simd_tpu_torch"
HOST_MODULES = ("errors", "utils", "utils.metrics", "utils.debug",
                "utils.profiling", "config", "serve", "tape", "artifact",
                "golden", "native")

ALONE = r"""
import os, pathlib, sys
sys.modules['jax'] = None
sys.modules['csv_simd_tpu'] = None
import numpy as np
import csv_simd_tpu_torch as ct
from csv_simd_tpu_torch import golden, native
here = pathlib.Path(os.getcwd()).resolve()
port = pathlib.Path(ct.__file__).resolve().parent
assert port == here / 'csv_simd_tpu_torch', port
data = b'id,name\n1,"x,y"\n2,"a\nb"\n3,z\n'
t = ct.create_from_bytes(data, device='cpu')
assert t.seek_field(0, 1) == b'"x,y"' and t.num_data_records == 3
want = golden.structural_index(np.frombuffer(data, np.uint8))
assert np.array_equal(t.index, want)
(here / 'd.csv').write_bytes(data)
if native.available():
    path = pathlib.Path(native.library_path()).resolve()
    assert path.parent == port / '_build', path
    assert path.exists()
    t2 = ct.create(str(here / 'd.csv'), backend='torch', device='cpu')
    assert np.array_equal(t2.index, want)
    t3 = ct.create(str(here / 'd.csv'), backend='native')
    assert np.array_equal(t3.index, want)
    print('native')
else:
    assert 'g++' in str(native.build_error()), native.build_error()
import importlib
for m in ('sql', 'window', 'setops'):
    importlib.import_module('csv_simd_tpu_torch.' + m)
sys.modules['csv_simd_tpu_torch.window'].DEVICE_WINDOW_MIN_ROWS = 1
r = ct.sql('SELECT id, ROW_NUMBER() OVER (ORDER BY id DESC) AS r FROM t',
           data, device='cpu')
assert r['r'].tolist() == [3, 2, 1], r['r']
from csv_simd_tpu_torch.parallel.serving import ShardedPackedTape
from csv_simd_tpu_torch.parallel.sharded import build_index_sharded, make_mesh
mesh = make_mesh(2, device='cpu')
assert np.array_equal(build_index_sharded(data, mesh), want)
st = ShardedPackedTape(data, mesh)
o, ln, v = st.gather_fields(np.array([2, 1]), np.array([1, 1]))
assert st.to_host_lists(o, ln, v) == [b'z', b'"a\nb"'], st.to_host_lists(o, ln, v)
ct.save_tape(t, str(here / 'idx.npz'))
back = ct.load_tape(str(here / 'idx.npz'), data)
assert np.array_equal(back.index, want)
assert back.seek_field(1, 1) == b'"a\nb"'
bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')
       or m == 'csv_simd_tpu' or m.startswith('csv_simd_tpu.')]
assert all(sys.modules[m] is None for m in bad), bad
print('ok')
"""


def test_port_copied_alone_runs_without_jax(tmp_path):
    """The package copied alone (no csv_simd_tpu beside it, jax and
    csv_simd_tpu blocked) imports and, on the CPU, runs create_from_bytes,
    create with native extraction, golden, an artifact round trip, a
    SQL window statement on the device path, and a 2-shard sharded
    build and lookup (parallel.sharded, parallel.serving);
    the native library builds under its own _build/."""
    shutil.copytree(PORT, tmp_path / "csv_simd_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", ALONE], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
    if shutil.which("g++"):
        assert "native" in r.stdout
        built = list((tmp_path / "csv_simd_tpu_torch" / "_build").glob(
            "csvidx-*.so"))
        assert len(built) == 1
    assert not (tmp_path / "csv_simd_tpu").exists()


@pytest.mark.parametrize("name", HOST_MODULES)
def test_host_module_is_the_ports_own_file(name):
    mod = __import__(f"csv_simd_tpu_torch.{name}", fromlist=["_"])
    path = pathlib.Path(mod.__file__).resolve()
    assert PORT in path.parents, path
    assert "csv_simd_tpu_torch" in mod.__name__


def test_no_port_module_reads_the_jax_package():
    """No source of the port imports jax or csv_simd_tpu, or names a path
    inside the JAX package's directory."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|csv_simd_tpu)\b"
                     r"|/\s*\"csv_simd_tpu\"", re.M)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    for f in files:
        assert not bad.search(f.read_text()), f


def test_native_library_builds_under_the_port():
    path = pathlib.Path(native.library_path())
    assert path.parent == PORT / "_build"
    assert re.fullmatch(r"csvidx-[0-9a-f]{16}\.so", path.name)
    jax_native = pathlib.Path(csv_simd_tpu.__file__).parent / "native"
    if native.available():
        assert path.exists()
        assert not path.is_relative_to(jax_native)


def test_native_engine_matches_golden():
    if not native.available():
        pytest.skip(f"no native build: {native.build_error()}")
    data = synthetic_wide_table(200_000)
    arr = np.frombuffer(data, np.uint8)
    got, par = native.host_stage1(arr, with_sentinel=True)
    np.testing.assert_array_equal(got, golden.structural_index(arr))
    assert par == golden.quote_parity_out(arr)
    assert native.host_quote_parity(arr) == par


@pytest.mark.parametrize("case", all_cases()[:24], ids=lambda c: c.name)
def test_golden_copy_matches_the_jax_golden(case):
    arr = np.frombuffer(case.data, np.uint8)
    for kw in ({}, dict(delimiter=0x3B, quote=0x27)):
        np.testing.assert_array_equal(
            golden.structural_index(arr, config.Dialect(**kw)),
            jgolden.structural_index(arr, jconfig.Dialect(**kw)))
        for carry in (0, 1):
            assert golden.quote_parity_out(
                arr, config.Dialect(**kw), carry) == \
                jgolden.quote_parity_out(arr, jconfig.Dialect(**kw), carry)


def test_config_and_header_copies_match():
    for kw in ({}, dict(delimiter=0x3B, quote=0x27), dict(delimiter=0x09)):
        for a, b in zip(config.build_nibble_luts(config.Dialect(**kw)),
                        jconfig.build_nibble_luts(jconfig.Dialect(**kw))):
            np.testing.assert_array_equal(a, b)
    for data in (b'a,b\r\nc,d\r\n', b'\xef\xbb\xbfx, y ,z\n1,2,3\n',
                 b'"q,1",b\n1,2\n'):
        for qa in (False, True):
            got = Header.parse(data, quote_aware=qa)
            want = JHeader.parse(data, quote_aware=qa)
            assert (got.names, got.new_line.value, got.field_cnt,
                    got.record_offset) == (want.names, want.new_line.value,
                                           want.field_cnt,
                                           want.record_offset)
    with pytest.raises(ValueError):
        config.Dialect(delimiter=0x22)
    assert issubclass(ct.InvalidCsvFormat, ct.errors.StructureError)
