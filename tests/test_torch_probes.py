"""The port's measurement path on the CPU: the probes' plain versions
against NumPy statements of the JAX tools' kernels, the ablation and ALU
probes against the JAX tool kernels in interpret mode, the fused-prefix
A/B chains, and the port's own `utils.profiling`. Tolerance 0 throughout:
these are integer words and sums. The CUDA kernels are held against the
plain versions on the card by tests/test_torch_gpu.py and chip_smoke.py.

tools/dma_probe.py and tools/dma_probe2.py are not imported here: the
first runs its benchmark at import and the second configures JAX's
compilation cache at import. Their kernels are stated in NumPy below."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csv_simd_tpu_torch.ops.stage1_v2 import pad_to_words
from csv_simd_tpu_torch.ops.stage1_v3 import stage1_swar_xla
from csv_simd_tpu_torch.tools import _common, ablate, dma_probe, vpu_roofline
from csv_simd_tpu_torch.tools import widestore_probe
from corpus import synthetic_wide_table
from jax_tools import InterpretPl, load_tool

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


def _rand_words(rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, (rows, 128), dtype=np.int64).astype(
        np.int32)


def _csv_words(rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b'ab"",\n\rx,z":; \t\xa2', np.uint8)
    return rng.choice(alphabet, size=rows * 512).view("<i4").reshape(rows, 128)


def _wrap(s) -> np.ndarray:
    """int64 sums -> int32, wrapping."""
    return ((np.asarray(s, np.int64) + 2**31) % 2**32 - 2**31).astype(np.int32)


def _xor_all(a: np.ndarray) -> np.int32:
    return np.bitwise_xor.reduce(a.reshape(-1).astype(np.int32))


# --- the memory-stream probe (tools/dma_probe.py :24-58, dma_probe2.py
# :28-110) --------------------------------------------------------------


def _np_write(a: np.ndarray, mode: str, c: int):
    """dma_probe `mk` / dma_probe2 `mk_write`: per 512-row block i the
    SMEM carry is c then flips, so block i adds (c + i) & 1; narrow and
    tall stores w[:, :16], wide stores w[:64, :]."""
    outs, side = [], []
    sm = c
    for i in range(a.shape[0] // 512):
        blk = a[512 * i:512 * (i + 1)]
        part = blk[:64, :] if mode == "wide" else blk[:, :16]
        outs.append(_wrap(part.astype(np.int64) + sm))
        sm = (sm + 1) & 1
        side.append(_xor_all(blk))
    return np.concatenate(outs), np.array(side, np.int32)


def _np_read(a: np.ndarray, c: int):
    """dma_probe2 `mk_read`: every (64, 128) block overwrites the output
    with its sum plus the carry; the last one stays."""
    side = [_wrap(a[i:i + 64].astype(np.int64).sum())
            for i in range(0, a.shape[0], 64)]
    return _wrap(int(side[-1]) + c), np.array(side, np.int32)


@pytest.mark.parametrize("rows", [512, 1536, 4096])
def test_stream_write_plain_matches_numpy(rows):
    a = _rand_words(rows, rows)
    for mode in dma_probe.WRITE_MODES:
        for carry in (0, 1):
            out, side = dma_probe.mk_write(torch.from_numpy(a.copy()), mode,
                                           carry)
            want_out, want_side = _np_write(a, mode, carry)
            shape = (rows // 8, 128) if mode == "wide" else (rows, 16)
            assert out.shape == shape
            np.testing.assert_array_equal(out.numpy().reshape(-1, 16)
                                          if mode != "wide" else out.numpy(),
                                          want_out)
            np.testing.assert_array_equal(side.numpy(), want_side)


@pytest.mark.parametrize("rows", [64, 192, 4096])
def test_stream_read_plain_matches_numpy(rows):
    a = _rand_words(rows, 3 * rows)
    for carry in (0, 1, torch.tensor(1)):
        out, side = dma_probe.mk_read(torch.from_numpy(a.copy()), carry)
        want_out, want_side = _np_read(a, int(carry))
        assert out.shape == ()
        assert int(out) == int(want_out)
        np.testing.assert_array_equal(side.numpy(), want_side)


def test_stream_probe_rejects_bad_input():
    w = torch.zeros((1024, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        dma_probe.mk_write(w[:1000], "narrow")
    with pytest.raises(ValueError):
        dma_probe.mk_write(w, "tall4")
    with pytest.raises(ValueError):
        dma_probe.mk_read(w[:100])
    with pytest.raises(ValueError):
        dma_probe.mk_read(w.to(torch.int64))


# --- the ALU probe (tools/vpu_roofline.py :49-86) ----------------------


def _np_alu(a: np.ndarray, n_ops: int, mix: str, s: int) -> np.ndarray:
    """`_probe_kernel` in uint32 arithmetic: four chains, one primitive a
    step with constant _CONSTS[(4k + j) % 256], out (c0^c1) + (c2^c3)."""
    consts = np.random.default_rng(11).integers(1, 2**31 - 1, size=256)
    kinds = {"alu": ("add", "xor"), "shift": ("lsr", "add", "xor"),
             "mul": ("mul", "xor")}[mix]
    x = a.view(np.uint32) + np.uint32(s & 0xFFFFFFFF)
    chains = [x, x ^ np.uint32(17), x + np.uint32(5),
              x ^ np.uint32(0xFFFFFFF9)]
    for j in range(4):
        v = chains[j]
        for k in range(n_ops // 4):
            c = np.uint32(consts[(4 * k + j) % 256])
            kind = kinds[k % len(kinds)]
            if kind == "add":
                v = v + c
            elif kind == "xor":
                v = v ^ c
            elif kind == "mul":
                v = v * (c | np.uint32(1))
            else:
                v = v >> np.uint32(1)
        chains[j] = v
    return ((chains[0] ^ chains[1]) + (chains[2] ^ chains[3])).view(np.int32)


@pytest.mark.parametrize("n_ops", [16, 48, 128])
def test_alu_plain_matches_numpy(n_ops):
    a = _rand_words(64, n_ops)
    for mix in vpu_roofline.MIXES:
        for s in (0, -123_456_789):
            got = vpu_roofline.probe(torch.from_numpy(a.copy()), n_ops, mix, s)
            np.testing.assert_array_equal(got.numpy(),
                                          _np_alu(a, n_ops, mix, s))


@pytest.mark.parametrize("n_ops", [16, 48])
def test_alu_plain_matches_jax_tool_kernel(monkeypatch, n_ops):
    """One (512, 128) tile through the TPU tool's own kernel in interpret
    mode (its fori-loop chain run eagerly), two values of s."""
    tool = load_tool("vpu_roofline")
    pl = InterpretPl(tool.pl)
    monkeypatch.setattr(tool, "pl", pl)
    a = _rand_words(512, 60 + n_ops)
    for mix in tool.MIXES:
        pl.calls.clear()
        with jax.disable_jit():
            tool._chain(jnp.asarray(a), n_ops, mix, 1)
        call, args, out = pl.calls[0]
        for s in (0, 987_654_321):
            want = call(jnp.asarray([s], jnp.int32), *args[1:])
            got = vpu_roofline.probe(torch.from_numpy(a.copy()), n_ops, mix, s)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the stage ablation (tools/ablate.py :32-146) ----------------------


def _np_eq(x: np.ndarray, byte: int) -> np.ndarray:
    y = x ^ np.uint32(byte * 0x01010101)
    t = ((y & np.uint32(0x7F7F7F7F)) + np.uint32(0x7F7F7F7F)) | y
    return ~t & np.uint32(0x80808080)


def _np_fold(t: np.ndarray, tile: int) -> np.ndarray:
    t = (t >> np.uint32(7)) & np.uint32(0x01010101)
    h = tile // 2
    t = t[:h] | (t[h:] << np.uint32(1))
    h //= 2
    t = t[:h] | (t[h:] << np.uint32(2))
    h //= 2
    return t[:h] | (t[h:] << np.uint32(4))


def _np_ablate(a: np.ndarray, mode: str, tile: int, c: int):
    """tools/ablate.py `mk`'s kernel, grid step by grid step with its SMEM
    carry, the matmul scans written as cumulative sums; the side word of
    a tile is the XOR of the value its mode stores."""
    x_all = a.view(np.uint32)
    q = tile // 8
    sh = (7 - np.arange(tile) % 8)[:, None]
    sm = c
    outs, side = [], []
    for i in range(a.shape[0] // tile):
        x = x_all[i * tile:(i + 1) * tile]
        qf = _np_eq(x, 0x22)
        sf = _np_eq(x, 0x2C) | _np_eq(x, 0x0A) | _np_eq(x, 0x0D)
        p = qf ^ (qf << np.uint32(8))
        p_in = p ^ (p << np.uint32(16))
        wp = (p_in >> np.uint32(31)).astype(np.int64)
        lane_excl = np.cumsum(wp, axis=1) - wp
        row_tot = lane_excl[:, -1] + wp[:, -1]
        xx = np.cumsum(row_tot)
        base = ((lane_excl + (xx - row_tot)[:, None] + sm) & 1).astype(
            np.uint32)
        masked = sf & ~(p_in ^ (base * np.uint32(0x80808080)))
        inword = sf & ~p_in
        val = {"dma_only": x, "classify_only": sf | qf,
               "inword": inword + wp.astype(np.uint32), "noscan": inword,
               "full": masked, "v3": masked, "v3i8": masked,
               "v3_foldonly": inword, "v3_mmonly": base}[mode]
        if mode in ("noscan", "full"):
            t = val.view(np.int32).astype(np.int64) >> sh
            o = _wrap(t.reshape(q, 8, 128).sum(axis=1)).view(np.uint32)
        elif mode in ("v3", "v3i8", "v3_foldonly"):
            o = _np_fold(val, tile)
        else:
            o = val[:q]
        if mode in ("full", "v3", "v3i8", "v3_mmonly"):
            sm = int((sm + xx[-1]) & 1)
        else:
            o = o + np.uint32(sm)
        outs.append(o.view(np.int32))
        side.append(_xor_all(val.view(np.int32)))
    return np.concatenate(outs), np.array(side, np.int32)


@pytest.mark.parametrize("rows,tile", [(64, 8), (512, 64), (1024, 512),
                                       (96, 24)])
def test_ablate_plain_matches_numpy(rows, tile):
    for a in (_rand_words(rows, rows + tile), _csv_words(rows, rows * tile)):
        for mode in ablate.MODES:
            for carry in (0, 1):
                out, side = ablate.mk(torch.from_numpy(a.copy()), mode, tile,
                                      carry)
                want_out, want_side = _np_ablate(a, mode, tile, carry)
                assert out.shape == (rows // 8, 128)
                np.testing.assert_array_equal(out.numpy(), want_out,
                                              err_msg=f"{mode} carry={carry}")
                np.testing.assert_array_equal(side.numpy(), want_side)


@pytest.mark.parametrize("mode", ablate.MODES)
def test_ablate_plain_matches_jax_tool_kernel(monkeypatch, mode):
    """One 64-row tile through the TPU tool's own kernel in interpret
    mode (its fori-loop chain run eagerly), carries 0 and 1, on CSV-ish
    bytes so that every stage has work."""
    tool = load_tool("ablate")
    pl = InterpretPl(tool.pl)
    monkeypatch.setattr(tool, "pl", pl)
    a = _csv_words(64, 77)
    with jax.disable_jit():
        tool.mk(mode, 64, 64)(jnp.asarray(a), 1)
    call, args, _ = pl.calls[0]
    for carry in (0, 1):
        want = call(jnp.asarray([carry], jnp.int32), *args[1:])
        got, _side = ablate.mk(torch.from_numpy(a.copy()), mode, 64, carry)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ablate_v3_is_b3_with_bytes_bit_reversed():
    """The v3 cut's fold words are not B3's: B3 puts row j of a tile at
    bit 8b + 7 - bitrev3(j), v3 at 8b + bitrev3(j), so each byte of one is
    the bit reversal of the other's (which is why the probe is not served
    from B3)."""
    a = _csv_words(1024, 5)
    for tile in (64, 512):
        v3, _ = ablate.mk(torch.from_numpy(a.copy()), "v3", tile, 1)
        b3, _ = stage1_swar_xla(torch.from_numpy(a.copy()), 1, row_tile=tile)
        rev = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)],
                       np.uint8)
        v3b = v3.numpy().view(np.uint8)
        assert not np.array_equal(v3b, b3.numpy().view(np.uint8))
        np.testing.assert_array_equal(rev[v3b], b3.numpy().view(np.uint8))


def test_ablate_rejects_bad_input():
    w = torch.zeros((512, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        ablate.mk(w, "pack_only")
    with pytest.raises(ValueError):
        ablate.mk(w, "full", tile=12)
    with pytest.raises(ValueError):
        ablate.mk(w, "full", tile=1024)


# --- the fused-prefix A/B (tools/widestore_probe.py :65-96) ------------


def test_widestore_chains_agree_on_cpu():
    """scan, build (B1 + B2) and buildf (B1n) on a small wide table: the
    fused prefix equals the separate pass and the words equal scan's."""
    data = np.frombuffer(synthetic_wide_table(300_000), np.uint8)
    words = torch.from_numpy(pad_to_words(data))
    assert words.shape[0] % 8 == 0
    fns = widestore_probe.chains(words)
    scan, build, buildf = fns["scan"](), fns["build"](), fns["buildf"]()
    assert torch.equal(buildf[0], scan[0]) and torch.equal(build[0], scan[0])
    assert torch.equal(buildf[3], build[1])
    assert int(build[1][-1]) == int(
        np.unpackbits(scan[0].numpy().view(np.uint8)).sum())
    assert widestore_probe.check(words) == {"checks": 3, "max_abs_err": 0}


def test_tool_checks_run_on_cpu():
    """Each tool's check of the timed input runs through its entry point
    (the plain version on a CPU tensor) and counts its comparisons."""
    w = torch.from_numpy(_rand_words(1024, 8))
    assert dma_probe.check_write(w) == {"checks": 8, "max_abs_err": 0}
    assert dma_probe.check_write(w, dma_probe.DMA_PROBE_MODES) == {
        "checks": 4, "max_abs_err": 0}
    assert dma_probe.check_read(w) == {"checks": 2, "max_abs_err": 0}
    got = ablate.check(w, [("full", 512), ("v3", 64)])
    assert got == {"checks": 4, "max_abs_err": 0}


def test_common_check_all_raises_on_a_difference():
    a = torch.arange(8, dtype=torch.int32)
    b = a.clone()
    b[3] = 0
    assert _common.check_all([(a, a, "x"), (b, b, "y")]) == {
        "checks": 2, "max_abs_err": 0}
    with pytest.raises(AssertionError, match="1 of 8 values differ"):
        _common.check_all([(a, b, "z")])
    assert _common.merge({"checks": 2, "max_abs_err": 0},
                         {"checks": 3, "max_abs_err": 0}) == {
        "checks": 5, "max_abs_err": 0}


def test_tools_exit_2_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (dma_probe, vpu_roofline, ablate, widestore_probe):
        with pytest.raises(SystemExit) as e:
            tool.main([])
        assert e.value.code == 2


def test_common_reductions():
    x = torch.from_numpy(_rand_words(7, 1))
    np.testing.assert_array_equal(_common.xor_reduce(x).numpy(),
                                  np.bitwise_xor.reduce(x.numpy(), axis=1))
    np.testing.assert_array_equal(
        _common.wrap_sum(x, 1).numpy(),
        _wrap(x.numpy().astype(np.int64).sum(axis=1)))
    w = _common.random_words(8, "cpu", 3)
    assert w.shape == (8, 128) and w.dtype == torch.int32
    assert torch.equal(w, _common.random_words(8, "cpu", 3))


# --- utils: profiling, metrics and debug are the port's own -------------


def test_profiling_is_the_ports_and_runs_without_jax(tmp_path):
    """With jax blocked from import: `csv_simd_tpu_torch.utils.profiling`
    is the port's torch module, device_trace yields its directory and
    writes a Chrome trace in which a `named` span shows; debug and
    metrics are the port's own copies under utils/."""
    code = (
        "import os, sys\n"
        "sys.modules['jax'] = None\n"
        "import torch\n"
        "import csv_simd_tpu_torch as ct\n"
        "from csv_simd_tpu_torch.utils import debug, metrics, profiling\n"
        "name = 'csv_simd_tpu_torch.utils.profiling'\n"
        "assert profiling is sys.modules[name]\n"
        "assert profiling.__file__.endswith(os.path.join("
        "'csv_simd_tpu_torch', 'utils', 'profiling.py')), "
        "profiling.__file__\n"
        "assert metrics.__file__.endswith(os.path.join("
        "'csv_simd_tpu_torch', 'utils', 'metrics.py')), metrics.__file__\n"
        "assert not hasattr(ct, 'utils.profiling')\n"
        f"d = {str(tmp_path / 'trace')!r}\n"
        "with profiling.device_trace(d) as got:\n"
        "    with profiling.named('csv_probe_span'):\n"
        "        torch.arange(1000).sum()\n"
        "assert got == d\n"
        "text = open(os.path.join(d, 'trace.json')).read()\n"
        "assert 'csv_probe_span' in text\n"
        "assert debug.__name__ == 'csv_simd_tpu_torch.utils.debug'\n"
        "assert 'ByteReport: 4 bytes' in debug.byte_report(b'a,b\\n')\n"
        "assert '^' in debug.mask_report(b'a,b\\n', [0, 1, 0, 1])\n"
        "assert metrics.GLOBAL is not None\n"
        "assert 'csv_simd_tpu' not in sys.modules\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")
