"""The stage-1 labs of the port on the CPU: B1's stage cuts
(tools/ablate2.py), the v1-layout variants (tools/kbench.py) and the
direct fold pack (tools/vnext.py). Each plain version is held against
the JAX tool's own kernel run in interpret mode through an
interpret-mode `pl` shim (no tool file is edited), at tiles 64 and 512
and carries 0 and 1; and v4full against B1's narrow words, roll against
B6, and the direct pack against B3 and golden. Tolerance 0: these are
integer words, counts and parities. The CUDA kernels are held against
the plain versions on the card by tests/test_torch_gpu.py and
chip_smoke.py.

The inputs are 128 KB or less, except where a (rows, 128) int32 input
at tile 512 needs one whole tile (256 KB)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csv_simd_tpu import golden as jgolden
from csv_simd_tpu.ops.stage1_pallas import stage1_pallas as jstage1_pallas
from csv_simd_tpu.ops.stage1_v3 import stage1_fused as jstage1_fused
from csv_simd_tpu.ops.stage1_v4 import stage1_fused_v4 as jstage1_fused_v4
from csv_simd_tpu_torch.ops.stage1_v2 import pad_to_words
from csv_simd_tpu_torch.ops.stage1_v3 import unpack_packed_host
from csv_simd_tpu_torch.ops.stage1_v4 import stage1_fused_v4
from csv_simd_tpu_torch.tools import ablate2, kbench, vnext
from corpus import synthetic_wide_table
from jax_tools import interpret_tool

TILES = (64, 512)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


_ALPHABET = np.frombuffer(b'ab"",\n\rx,z":; \t\xa2', np.uint8)


def _csv_words(rows: int, seed: int) -> np.ndarray:
    """(rows, 128) int32 of CSV-ish bytes: quotes and delimiters dense."""
    rng = np.random.default_rng(seed)
    return rng.choice(_ALPHABET, size=rows * 512).view("<i4").reshape(rows,
                                                                      128)


def _csv_bytes(rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(_ALPHABET, size=(rows, 128))


def _rows_for(tile: int, row_bytes: int) -> int:
    """Rows of at most 128 KB that hold whole tiles (one tile at least)."""
    return max(tile, (128 * 1024 // row_bytes) // tile * tile)


# --- T6: B1's stage cuts (tools/ablate2.py mk_microkernel) -------------


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("mode", ablate2.MICRO)
def test_ablate2_cut_matches_jax_tool_kernel(monkeypatch, mode, tile):
    tool = interpret_tool(monkeypatch, "ablate2")
    rows = _rows_for(tile, 512)
    a = _csv_words(rows, tile + len(mode))
    with jax.disable_jit():
        tool.mk_microkernel(mode, tile, rows)(jnp.asarray(a), 1)
    call, args, _ = tool.pl.calls[0]
    for carry in (0, 1):
        want = np.asarray(call(jnp.asarray([carry], jnp.int32), *args[1:]))
        got, side = ablate2.mk(torch.from_numpy(a.copy()), mode, tile, carry)
        assert got.shape == (rows, 16)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{mode} carry={carry}")
        assert side.numel() == (-(-rows // 128) if mode in ablate2.SIDE
                                else 0)


def _np_eq(x: np.ndarray, byte: int) -> np.ndarray:
    y = x ^ np.uint32(byte * 0x01010101)
    t = ((y & np.uint32(0x7F7F7F7F)) + np.uint32(0x7F7F7F7F)) | y
    return ~t & np.uint32(0x80808080)


def _np_side_values(a: np.ndarray) -> dict:
    """The value each side-word cut XORs over a chunk, in NumPy uint32:
    byte flags straight from byte compares, nibbles and packed words by
    bit placement."""
    x = a.view(np.uint32)
    sf = _np_eq(x, 0x2C) | _np_eq(x, 0x0A) | _np_eq(x, 0x0D)
    qf = _np_eq(x, 0x22)
    us, uq = sf >> np.uint32(7), qf >> np.uint32(7)
    b = np.arange(4, dtype=np.uint32)
    vs = ((us[..., None] >> (8 * b)) & 1) << b
    vq = ((uq[..., None] >> (8 * b)) & 1) << b
    vs, vq = vs.sum(-1, dtype=np.uint32), vq.sum(-1, dtype=np.uint32)
    l = np.arange(8, dtype=np.uint32)
    sw = (vs.reshape(-1, 16, 8) << (4 * l)).sum(-1, dtype=np.uint32)
    return {"cls22": sf | qf, "cls18": us | uq, "prep": vs + vq, "mm1": sw}


@pytest.mark.parametrize("rows", [8, 128, 296])
def test_ablate2_side_words_match_numpy(rows):
    """cls22, cls18, prep and mm1's side words: the XOR of the cut's value
    over each 128-row chunk, the last one partial."""
    a = _csv_words(rows, rows)
    values = _np_side_values(a)
    for mode, val in values.items():
        want = [np.bitwise_xor.reduce(val[i:i + 128].reshape(-1))
                for i in range(0, rows, 128)]
        _, side = ablate2.mk(torch.from_numpy(a.copy()), mode, 8, 1)
        np.testing.assert_array_equal(side.numpy().view(np.uint32),
                                      np.array(want, np.uint32), err_msg=mode)


@pytest.mark.parametrize("tile", TILES)
def test_ablate2_v4full_is_b1_narrow(tile):
    """v4full equals B1's narrow words: the port's plain B1 and the JAX
    package's narrow kernel in interpret mode."""
    rows = _rows_for(tile, 512)
    a = _csv_words(rows, 3 * tile)
    for carry in (0, 1):
        got, _ = ablate2.mk(torch.from_numpy(a.copy()), "v4full", tile, carry)
        port = stage1_fused_v4(torch.from_numpy(a.copy()), carry,
                               row_tile=tile)[0]
        jax_b1 = jstage1_fused_v4(jnp.asarray(a), carry, row_tile=tile,
                                  interpret=True, out_mode="narrow")[0]
        np.testing.assert_array_equal(got.numpy(), port.numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_b1))


def test_ablate2_package_modes_and_sol_on_cpu():
    """v3 is B3, seq B4 and the v4 modes B1 (pack_mode ignored; nc modes
    report -1 non-ASCII bytes); sol is the int32 sum of max(words,
    carry & 127); mk and plain agree on each."""
    a = torch.from_numpy(_csv_words(128, 9))
    assert ablate2.check(a, [(m, 64) for m in ablate2.PACKAGE + ("sol",)]) \
        == {"checks": 3 * 6 + 2 * 2 + 1, "max_abs_err": 0}
    assert int(ablate2.mk(a, "v4nc", 64, 1)[2]) == -1
    v4 = ablate2.mk(a, "v4", 64, 1)
    assert torch.equal(v4[0], ablate2.mk(a, "v4full", 64, 1)[0])
    assert torch.equal(ablate2.mk(a, "seq", 64, 1)[0], v4[0])
    want = np.maximum(a.numpy().astype(np.int64), 1).sum()
    want = (want + 2**31) % 2**32 - 2**31
    assert int(ablate2.mk(a, "sol", 64, 1)) == want
    assert ablate2.mk(a, "pack1slice", 64, 1)[0].equal(
        ablate2.mk(a, "pack1", 64, 1)[0])


# --- T7: the v1-layout variants (tools/kbench.py make_variant) ---------


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", kbench.VARIANTS)
def test_kbench_variant_matches_jax_tool_kernel(monkeypatch, name, tile):
    """Words and count (the last tile's, plus the carry-in for nopar and
    lanescan; current's is B6's total)."""
    tool = interpret_tool(monkeypatch, "kbench")
    rows = _rows_for(tile, 128)
    b = _csv_bytes(rows, tile + len(name))
    for carry in (0, 1):
        with jax.disable_jit():
            if name == "current":
                want = jstage1_pallas(jnp.asarray(b), jnp.int32(carry),
                                      row_tile=tile, interpret=True)[:2]
            else:
                want = tool.make_variant(name, tile, rows)(
                    jnp.asarray(b), jnp.asarray(carry, jnp.int32))
        got = kbench.make_variant(torch.from_numpy(b.copy()), name, tile,
                                  carry)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]),
                                      err_msg=f"{name} carry={carry}")
        assert int(got[1]) == int(want[1]), (name, carry)


def test_kbench_count_is_the_last_tiles():
    """Against an independent statement: nopar's count is the structural
    bytes of the last tile plus the carry; full's words are B6's."""
    b = _csv_bytes(1024, 5)
    t = torch.from_numpy(b.copy())
    struct = np.isin(b, (0x2C, 0x0A, 0x0D))
    for tile in (32, 256, 1024):
        got = kbench.make_variant(t, "nopar", tile, 1)
        assert int(got[1]) == int(struct[-tile:].sum()) + 1
        roll = kbench.make_variant(t, "roll", tile, 0)
        cur = kbench.make_variant(t, "current", tile, 0)
        assert torch.equal(roll[0], cur[0])
        mask = jgolden.structural_mask(b.reshape(-1))
        assert int(roll[1]) == int(mask.reshape(-1, 128)[-tile:].sum())
        assert int(cur[1]) == int(mask.sum())


def test_kbench_checks_and_bad_input():
    b = torch.from_numpy(_csv_bytes(256, 6))
    assert torch.equal(kbench.make_variant(b, "lanescan", 64, 1)[1],
                       kbench._variant_plain(b, "lanescan", 64, 1)[1])
    assert kbench.check(b, [(v, 64) for v in kbench.VARIANTS]) == {
        "checks": 10, "max_abs_err": 0}
    with pytest.raises(ValueError):
        kbench.make_variant(b, "roll", 48)
    with pytest.raises(ValueError):
        kbench.make_variant(b.to(torch.int32), "roll", 64)
    with pytest.raises(ValueError):
        kbench.make_variant(b, "pack", 64)


# --- T8: the direct fold pack (tools/vnext.py make) --------------------


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("variant", list(vnext.VARIANTS))
def test_vnext_variant_matches_jax_tool_kernel(monkeypatch, variant, tile):
    """Words and parity out of each candidate."""
    tool = interpret_tool(monkeypatch, "vnext")
    i8acc, directpack = vnext.VARIANTS[variant]
    rows = _rows_for(tile, 512)
    a = _csv_words(rows, 7 * tile + len(variant))
    for carry in (0, 1):
        with jax.disable_jit():
            want = tool.make(tile, rows, i8acc, directpack)(jnp.asarray(a),
                                                            carry)
        got = vnext.make(torch.from_numpy(a.copy()), tile, carry, i8acc,
                         directpack)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]),
                                      err_msg=f"{variant} carry={carry}")
        assert int(got[1]) == int(want[1])


@pytest.mark.parametrize("tile", TILES)
def test_vnext_direct_pack_is_b3_and_golden(tile):
    """On a small synthetic wide table: the direct pack equals B3 (the
    JAX package's kernel in interpret mode) and, unpacked, golden."""
    data = np.frombuffer(synthetic_wide_table(100_000), np.uint8)
    w = pad_to_words(data, row_align=tile)
    got = vnext.make(torch.from_numpy(w.copy()), tile, 0, directpack=True)
    b3 = jstage1_fused(jnp.asarray(w), 0, row_tile=tile, interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(b3[0]))
    assert int(got[1]) == int(b3[1]) == jgolden.quote_parity_out(data)
    np.testing.assert_array_equal(
        unpack_packed_host(got[0].numpy(), data.size, tile=tile),
        jgolden.structural_mask(data))


def test_vnext_check_on_cpu(tmp_path):
    """The tool's check: every variant, the direct pack against B3 and
    golden, on its default wide table, a CSV file and given words."""
    assert vnext._wide_table(50_000) == synthetic_wide_table(50_000)
    assert vnext.check() == {"checks": 12, "max_abs_err": 0}
    path = tmp_path / "t.csv"
    path.write_bytes(synthetic_wide_table(30_000))
    assert vnext.check(path=str(path), tile=64)["max_abs_err"] == 0
    w = torch.from_numpy(_csv_words(128, 2))
    assert vnext.check(w, tile=64) == {"checks": 12, "max_abs_err": 0}
    assert vnext.check_timed(w, tile=64) == {"checks": 10, "max_abs_err": 0}


def test_lab_tools_exit_2_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (ablate2, kbench, vnext):
        with pytest.raises(SystemExit) as e:
            tool.main([])
        assert e.value.code == 2


def test_lab_tools_reject_bad_input():
    w = torch.zeros((512, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        ablate2.mk(w, "pack3")
    with pytest.raises(ValueError):
        ablate2.mk(w, "lane", tile=12)
    with pytest.raises(ValueError):
        vnext.make(w, tile=1024)
    with pytest.raises(ValueError):
        vnext.make(w[:100])


@pytest.mark.parametrize("dialect", ["default", "quote_a2"])
def test_stage1_time_checks_each_classify_dialect(dialect):
    """The B1 timing tool's check on its own kind of input (CSV-ish words,
    seed 7, 64 rows) passes on the CPU, and the port's words there equal
    the JAX B1 kernel's in interpret mode for the dialect (the SWAR and
    the __vcmpeq4 classify on the card)."""
    from csv_simd_tpu_torch.tools import stage1_time
    from csv_simd_tpu_torch.tools._common import csv_words

    d = stage1_time.DIALECTS[dialect]
    words = csv_words(64, "cpu", 7)
    assert stage1_time.check(words, d) == {"checks": 2, "max_abs_err": 0}
    port = stage1_fused_v4(words, 1, d)[0]
    jax_b1 = jstage1_fused_v4(jnp.asarray(words.numpy()), 1, d, row_tile=64,
                              interpret=True, out_mode="narrow")[0]
    np.testing.assert_array_equal(port.numpy(), np.asarray(jax_b1))


@pytest.mark.parametrize("dialect", ["default", "quote_a2"])
def test_stage1_time_checks_b5_each_classify_dialect(dialect):
    """The tool's B5 check on its own kind of input passes on the CPU, and
    the port's v2 words, count and parity there equal the JAX B5 kernel's
    in interpret mode for the dialect."""
    from csv_simd_tpu.ops.stage1_v2 import stage1_pallas_v2 as jstage1_v2
    from csv_simd_tpu_torch.ops.stage1_v2 import stage1_pallas_v2
    from csv_simd_tpu_torch.tools import stage1_time
    from csv_simd_tpu_torch.tools._common import csv_words

    d = stage1_time.DIALECTS[dialect]
    words = csv_words(64, "cpu", 7)
    assert stage1_time.check_v2(words, d) == {"checks": 3, "max_abs_err": 0}
    port = stage1_pallas_v2(words, 1, d)
    jax_b5 = jstage1_v2(jnp.asarray(words.numpy()), 1, d, row_tile=64,
                        interpret=True)
    for got, want in zip(port, jax_b5):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stage1_time_exits_2_without_a_card(monkeypatch):
    from csv_simd_tpu_torch.tools import stage1_time

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        stage1_time.main([])
    assert e.value.code == 2
