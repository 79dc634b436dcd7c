"""The port's sharded build (csv_simd_tpu_torch/parallel/sharded.py)
against csv_simd_tpu.parallel.sharded on the CPU, bit for bit: every
output of sharded_stage1 (packed words, per-shard counts, exclusive
offsets, total, parity, non-ASCII counts) at 1-8 shards in every layout
with both use_pallas values (the JAX side on the 8-device virtual CPU
mesh of conftest.py, its kernels in interpret mode), the quote parity's
plain version (S1's) against `_local_parity`, the mesh pad rule, and
build_index_sharded against golden over the corpus, quotes spanning
shards and the big-pad branch. Tolerance 0: words, counts and offsets.
The CUDA kernel S1 is held against its plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csv_simd_tpu import golden
from csv_simd_tpu.config import Dialect as JDialect
from csv_simd_tpu.ops.stage1_v3 import unpack_packed_host
from csv_simd_tpu.parallel import sharded as jsharded
from csv_simd_tpu_torch.config import Dialect
from csv_simd_tpu_torch.parallel.sharded import (
    AXIS,
    Mesh,
    _exclusive_scan_axis,
    _local_parity_plain,
    _mesh_rows,
    _scan_total_psum,
    build_index_sharded,
    make_mesh,
    pad_words_for_mesh,
    sharded_stage1,
)

from corpus import basic_cases, synthetic_wide_table

SHARDS = (1, 2, 3, 4, 5, 6, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _spanning(n_bytes: int = 90_000, seed: int = 3) -> np.ndarray:
    """Seeded CSV-ish bytes with non-ASCII runs and one quoted span of
    about 40 KB, which crosses several shard cuts at every shard count
    tested, and a dangling quote at the end."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer('ab"",\n\rx,z: 09é'.encode(), dtype=np.uint8)
    arr = rng.choice(alphabet, size=n_bytes)
    span = np.frombuffer(b"x,y\n" * 10_000, dtype=np.uint8)
    body = np.concatenate([arr[:20_000], [0x22], span, [0x22], arr[20_000:],
                           [0x22]])
    return body.astype(np.uint8)


DATA = _spanning()


def _jax_run(w2d: np.ndarray, carry, n: int, layout: str, use_pallas: bool,
             count_nonascii: bool):
    x = w2d.reshape(-1, 1024) if layout == "seq_wide" else w2d
    out = jsharded.sharded_stage1(
        x, carry, jsharded.make_mesh(n), use_pallas=use_pallas,
        interpret=use_pallas, layout=layout, count_nonascii=count_nonascii)
    return [np.asarray(o) for o in out]


def _port_run(w2d: np.ndarray, carry, n: int, layout: str,
              use_pallas: bool, count_nonascii: bool):
    t = torch.from_numpy(w2d.copy())
    x = t.view(-1, 1024) if layout == "seq_wide" else t
    out = sharded_stage1(x, carry, make_mesh(n, device="cpu"),
                         use_pallas=use_pallas, layout=layout,
                         count_nonascii=count_nonascii)
    return [torch.cat(out[0]).numpy()] + [o.numpy() for o in out[1:]]


def _mask(words: np.ndarray, layout: str, n_bytes: int,
          shard_rows: int) -> np.ndarray:
    """The structural mask of a build's words, by its layout's inverse."""
    if layout == "fold":
        return unpack_packed_host(words, n_bytes, tile=min(512, shard_rows))
    return np.unpackbits(words.reshape(-1).view("<u4").view(np.uint8),
                         bitorder="little")[:n_bytes]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("layout", ["fold", "seq", "seq_wide"])
@pytest.mark.parametrize("n", SHARDS)
def test_sharded_stage1_matches_jax(n, layout, use_pallas):
    """Every output at carries 0, 1 and a device 1, each equal to the JAX
    package's and the words to golden's mask."""
    w2d = pad_words_for_mesh(DATA, n)
    count_nonascii = layout != "fold"
    if layout == "seq_wide" and not use_pallas:
        with pytest.raises(ValueError, match="seq_wide"):
            _port_run(w2d, 0, n, layout, use_pallas, count_nonascii)
        with pytest.raises(ValueError, match="seq_wide"):
            _jax_run(w2d, 0, n, layout, use_pallas, count_nonascii)
        return
    for carry in (0, 1, torch.ones((), dtype=torch.int32)):
        got = _port_run(w2d, carry, n, layout, use_pallas, count_nonascii)
        want = _jax_run(w2d, int(carry), n, layout, use_pallas,
                        count_nonascii)
        assert len(got) == len(want) == (6 if count_nonascii else 5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        shard_rows = w2d.shape[0] // n
        mask = _mask(got[0], layout, DATA.size, shard_rows)
        np.testing.assert_array_equal(
            mask, golden.structural_mask(DATA, carry_in=int(carry)))
        assert int(got[4]) == golden.quote_parity_out(DATA,
                                                      carry_in=int(carry))
        assert int(got[3]) == int(mask.sum())
    if count_nonascii:
        assert got[5].sum() == int((DATA >= 0x80).sum())


@pytest.mark.parametrize("n", [2, 3, 8])
def test_sharded_stage1_from_a_list_of_shards(n):
    """A list of the shards' tensors gives what the whole tensor gives."""
    w2d = torch.from_numpy(pad_words_for_mesh(DATA, n))
    mesh = make_mesh(n, device="cpu")
    whole = sharded_stage1(w2d, 1, mesh, layout="seq")
    parts = sharded_stage1(list(w2d.chunk(n)), 1, mesh, layout="seq")
    for a, b in zip(whole[1:], parts[1:]):
        assert torch.equal(a, b)
    for a, b in zip(whole[0], parts[0]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shards"):
        sharded_stage1(list(w2d.chunk(n))[:-1] or [w2d[:8]], 0,
                       make_mesh(n + 1, device="cpu"))
    with pytest.raises(ValueError, match="layout"):
        sharded_stage1(w2d, 0, mesh, layout="v2")


DIALECTS = ({}, dict(delimiter=0x3B, quote=0x27), dict(quote=0xA2))


@pytest.mark.parametrize("d", range(len(DIALECTS)))
@pytest.mark.parametrize("density", [0.0, 1 / 64, 0.5])
@pytest.mark.parametrize("rows", [8, 24, 520, 4104])
def test_local_parity_plain_matches_jax(rows, density, d):
    """S1's plain version against the JAX `_local_parity` on shards of 8
    to 4,104 rows at quote densities 0, 1/64 and 1/2."""
    rng = np.random.default_rng(rows)
    dialect = DIALECTS[d]
    quote = dialect.get("quote", 0x22)
    b = rng.integers(0, 256, rows * 512, dtype=np.uint8)
    b = np.where(b == quote, quote ^ 1, b)
    b = np.where(rng.random(b.size) < density, quote, b).astype(np.uint8)
    w = b.view("<i4").reshape(rows, 128)
    got = _local_parity_plain(torch.from_numpy(w.copy()), Dialect(**dialect))
    want = jsharded._local_parity(jnp.asarray(w), JDialect(**dialect))
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(want) == int((b == quote).sum() & 1)


@pytest.mark.parametrize("case", basic_cases(), ids=lambda c: c.name)
def test_local_parity_plain_over_the_corpus(case):
    arr = np.frombuffer(case.data, dtype=np.uint8)
    w = pad_words_for_mesh(arr, 1)
    got = _local_parity_plain(torch.from_numpy(w.copy()), Dialect())
    assert int(got) == int(jsharded._local_parity(jnp.asarray(w),
                                                  JDialect()))
    assert int(got) == golden.quote_parity_out(arr)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("n_bytes", [0, 1, 4_000, 262_145, 3_000_000])
def test_pad_words_for_mesh_matches_jax(n_bytes, n):
    """The pad rule, the big-pad branch (rows > 512 n) included; the
    shape decides which word belongs to which shard."""
    arr = np.random.default_rng(n_bytes).integers(0, 256, n_bytes,
                                                  dtype=np.uint8)
    got = pad_words_for_mesh(arr, n)
    want = jsharded.pad_words_for_mesh(arr, n)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert _mesh_rows(n_bytes, n) == want.shape[0]


@pytest.mark.parametrize("n", SHARDS)
def test_collectives_match_jax_scans(n):
    """`_scan_total_psum` and `_exclusive_scan_axis`: the exclusive prefix
    on each shard's device, the total on the first, int32 as JAX's psum
    (wrapping past 2^31)."""
    mesh = make_mesh(n, device="cpu")
    vals = [2**30 + 7 * k for k in range(n)]
    xs = [torch.tensor(v, dtype=torch.int32) for v in vals]
    excl, total = _scan_total_psum(xs, mesh)
    want = np.cumsum(np.array(vals, np.int64))
    wrap = (want + 2**31) % 2**32 - 2**31
    assert [int(e) for e in excl] == [0] + list(wrap[:-1])
    assert int(total) == wrap[-1]
    assert [int(e) for e in _exclusive_scan_axis(xs, mesh)] == \
        [int(e) for e in excl]
    assert all(e.device == torch.device("cpu") and e.dim() == 0
               for e in excl)


def test_mesh_and_make_mesh():
    mesh = make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.first_shard == 0 and mesh.group is None
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert make_mesh(device="cpu").size == 1
    assert Mesh(["cpu", "cpu"]).size == 2
    assert AXIS == jsharded.AXIS
    with pytest.raises(ValueError):
        Mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(4)
        with pytest.raises(RuntimeError, match="cuda"):
            build_index_sharded(b"a,b\n1,2\n")


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("use_pallas", [None, False])
def test_build_index_sharded_matches_jax(n, use_pallas):
    data = synthetic_wide_table(200_000)
    got = build_index_sharded(data, make_mesh(n, device="cpu"),
                              use_pallas=use_pallas)
    want = jsharded.build_index_sharded(data, mesh=jsharded.make_mesh(n),
                                        use_pallas=False)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, golden.structural_index(data))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_build_index_sharded_quote_spanning_shards(n):
    """The JAX test's input: a 60 KB quoted span across every shard cut."""
    inner = "x," * 30000
    data = f'a,b\n"{inner}end",2\nq,w\n'.encode()
    got = build_index_sharded(data, make_mesh(n, device="cpu"))
    np.testing.assert_array_equal(got, golden.structural_index(data))


@pytest.mark.parametrize("case", basic_cases(), ids=lambda c: c.name)
@pytest.mark.parametrize("n", [3, 8])
def test_build_index_sharded_corpus(case, n):
    got = build_index_sharded(case.data, make_mesh(n, device="cpu"))
    np.testing.assert_array_equal(got, golden.structural_index(case.data))


@pytest.mark.parametrize("n", [3, 5, 6])
def test_build_index_sharded_big_pad(n):
    """Shards larger than the 512-row tile: the big-pad branch."""
    rng = np.random.default_rng(n)
    data = rng.choice(np.frombuffer(b'ab"",\n\rx,z: 09', dtype=np.uint8),
                      size=3_000_000)
    assert pad_words_for_mesh(data, n).shape[0] > 512 * n
    got = build_index_sharded(data, make_mesh(n, device="cpu"))
    assert got[0] == 0
    np.testing.assert_array_equal(
        got[1:], np.flatnonzero(golden.structural_mask(data)))


def test_jax_mesh_has_the_shards():
    """The JAX side of these tests runs on 8 virtual CPU devices."""
    assert len(jax.devices()) >= 8


def test_kernel_build_hash_covers_the_shard_parity_source(tmp_path,
                                                         monkeypatch):
    """S1's source is one of the library's sources, and an edit to it
    names another library, so the kernels are built again."""
    import shutil

    from csv_simd_tpu_torch import _kernels

    assert "shard_parity.cu" in [p.name for p in _kernels._sources()]
    shutil.copytree(_kernels.CSRC, tmp_path / "csrc")
    monkeypatch.setattr(_kernels, "CSRC", tmp_path / "csrc")
    before = _kernels.library_path()
    src = tmp_path / "csrc" / "shard_parity.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _kernels.library_path() != before
