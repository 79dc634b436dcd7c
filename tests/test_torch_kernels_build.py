"""The port's build-and-bind layer (csv_simd_tpu_torch/_compiled.py) and
its three libraries, on the CPU with no nvcc: the product's kernels
(`_kernels`, csrc/), the measurement probes' kernels
(`tools._lab_kernels`, tools/csrc/) and the g++ host engine (`native`).
Each library's name is a hash of its own sources, the headers they
include and its flags, so an edit rebuilds only the libraries that
compile the edited file; importing the package, or building a tape,
never imports the tools or compiles a probe. The g++ cases build small
libraries of their own under a temporary `_build/`."""

import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from csv_simd_tpu_torch import _compiled, _kernels, native
from csv_simd_tpu_torch.tools import _lab_kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def copies(tmp_path, monkeypatch):
    """Both CUDA libraries and the native engine pointed at copies of
    their sources in tmp_path (csrc/, lab/, native/), which it returns."""
    product = tmp_path / "csrc"
    lab = tmp_path / "lab"
    nat = tmp_path / "native"
    shutil.copytree(_kernels.CSRC, product)
    shutil.copytree(_lab_kernels.LAB_CSRC, lab)
    nat.mkdir()
    shutil.copy(native.LIB.source_dir / "csvidx.cpp", nat)
    monkeypatch.setattr(_kernels.LIB, "source_dir", product)
    monkeypatch.setattr(_lab_kernels.LIB, "source_dir", lab)
    monkeypatch.setattr(_lab_kernels.LIB, "include_dirs", (product,))
    monkeypatch.setattr(native.LIB, "source_dir", nat)
    return tmp_path


def _paths() -> tuple:
    return (_kernels.library_path(), _lab_kernels.library_path(),
            native.library_path())


def _edit(path) -> None:
    path.write_bytes(path.read_bytes() + b"\n// edited\n")


def test_product_library_holds_no_probe():
    """The product library compiles csrc/*.cu and their headers only: no
    probe source and nothing under the lab directory; the lab library
    compiles the probes and includes B1's core header from csrc/."""
    lab_dir = _lab_kernels.LAB_CSRC.resolve()
    files = [p.resolve() for p in _kernels.LIB.sources()]
    files += _compiled._headers(_kernels.LIB.sources(), ())
    assert files and all(not p.name.startswith("probe_") for p in files)
    assert all(lab_dir not in p.parents for p in files)
    probes = _lab_kernels.LIB.sources()
    assert len(probes) == 9
    assert all(p.name.startswith("probe_") for p in probes)
    assert not list(_kernels.CSRC.glob("probe_*"))
    assert {p.name for p in _compiled._headers(
        probes, _lab_kernels.LIB.include_dirs)} == {"stage1_core.cuh"}
    assert len(_kernels.LAUNCHES) == 14
    assert not any(k.startswith("probe_") for k in _kernels.LAUNCHES)
    assert not any(name.startswith("probe_") for name in dir(_kernels))
    wrappers = {k for k in dir(_lab_kernels) if k.startswith("probe_")}
    assert set(_lab_kernels.LAUNCHES) == wrappers - {"probe_alu_op_counts"}


@pytest.mark.parametrize("edited,changes", [
    ("lab/probe_alu.cu", (False, True, False)),
    ("lab/probe_mosaic.cu", (False, True, False)),
    ("csrc/stage1_core.cuh", (True, True, False)),
    ("csrc/scan.cuh", (True, False, False)),
    ("csrc/rank_select.cu", (True, False, False)),
    ("native/csvidx.cpp", (False, False, True)),
])
def test_an_edit_renames_only_the_libraries_that_compile_it(copies,
                                                            edited,
                                                            changes):
    before = _paths()
    _edit(copies / edited)
    after = _paths()
    assert tuple(a != b for a, b in zip(after, before)) == changes
    for path, stem in zip(after, ("libcsv_simd_kernels-", "libcsv_simd_lab-",
                                  "csvidx-")):
        assert os.path.basename(path).startswith(stem)
        assert os.path.dirname(path) == str(_compiled.BUILD_DIR)


def test_importing_the_package_and_building_a_tape_imports_no_tool():
    code = textwrap.dedent("""
        import importlib, sys
        import os, tempfile
        ct = importlib.import_module("csv_simd_tpu_torch")
        d = tempfile.mkdtemp()
        path = os.path.join(d, "t.csv")
        open(path, "wb").write(b'a,b\\n1,"x,y"\\n2,z\\n')
        t = ct.create_packed(path, device="cpu")
        assert t.to_host_lists(*t.gather_fields([0, 1], [1, 0])) == \\
            [b'"x,y"', b"2"]
        t2 = ct.create(path, backend="torch", device="cpu")
        assert t2.seek_field(1, 1) == b"z"
        tools = [m for m in sys.modules
                 if m.startswith("csv_simd_tpu_torch.tools")]
        assert not tools, tools
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def _library(tmp_path, source: str, compiler: str = "g++"):
    src = tmp_path / "src"
    src.mkdir(exist_ok=True)
    (src / "one.cpp").write_text(source)
    return _compiled.Library("one", src, "*.cpp", compiler,
                             ("-O1", "-fPIC"))


def test_a_library_builds_once_and_binds_its_entry_points(tmp_path,
                                                          monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    monkeypatch.setattr(_compiled, "BUILD_DIR", tmp_path / "_build")
    lib = _library(tmp_path, 'extern "C" long long twice(long long x) '
                             '{ return 2 * x; }\n')
    twice = lib.fn("twice", [_compiled.ctypes.c_longlong],
                   _compiled.ctypes.c_longlong)
    assert not lib.path().exists()
    assert twice(21) == 42
    assert lib.path().exists()
    assert lib.build() == {"path": str(lib.path()), "seconds": 0.0,
                           "log": ""}
    # nothing but the library is left in _build/
    assert [p.name for p in (tmp_path / "_build").iterdir()] == \
        [lib.path().name]


def test_a_refused_source_raises_with_the_compilers_log(tmp_path,
                                                       monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    monkeypatch.setattr(_compiled, "BUILD_DIR", tmp_path / "_build")
    lib = _library(tmp_path, "this is not C++;\n")
    with pytest.raises(_compiled.BuildError, match=r"g\+\+ failed"):
        lib.build()
    assert not lib.path().exists()
    missing = _library(tmp_path, "int x;\n", compiler="no-such-compiler")
    with pytest.raises(_compiled.BuildError, match="no-such-compiler"):
        missing.handle()
