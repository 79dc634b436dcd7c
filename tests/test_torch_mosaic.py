"""The Mosaic probes of the port on the CPU (tools/mosaic_probes.py's seven
`_run_both` bodies). The JAX tool is loaded by tests/jax_tools.py and its
`pl` replaced by the shim there, which runs every pallas_call in
interpret mode, overriding the tool's own `interpret=` argument (its
`_run_both` passes one), and records each call. Running the tool's
probes in its PROBES order draws their inputs from its one
default_rng(7) as a full run does; each
body must report "fixed", the port's `probe_inputs` must equal the
arguments recorded, and each recorded kernel is run again on the probe's
input and on three seeded random (8, 128) inputs inside the domain where
the port's function is the TPU body's, against the port's plain version.
Tolerance 0: these are integer words. The CUDA kernels are held against
the plain versions on the card by tests/test_torch_gpu.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csv_simd_tpu_torch.tools import mosaic_probes as mp
from jax_tools import InterpretPl, load_tool

RUN_BOTH = [name for name, _note, _fn in mp.PROBES
            if name != "mm1_in_context"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax_probes():
    """{probe: (status, (call, args))}: the JAX tool loaded from tools/,
    each `_run_both` probe run once in its PROBES order with the first
    pallas_call it made recorded."""
    tool = load_tool("mosaic_probes")
    shim = InterpretPl(tool.pl)
    out = {}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tool, "pl", shim)
        for name, _note, fn in tool.PROBES:
            if name == "mm1_in_context":
                continue
            before = len(shim.calls)
            status, _detail = fn()
            call, args, _ = shim.calls[before]
            out[name] = (status, (call, args))
    return out


def _random_inputs(name: str, seed: int) -> list:
    """Seeded (8, 128) numpy inputs of the recorded call, in the domain
    where the port equals the TPU body: the product's v with |v| <= 256,
    the gather's idx in [0, 128), the rest over their whole range."""
    rng = np.random.default_rng(seed)
    shape = (mp.T, mp.L)
    if name in ("matmul32_slice", "matmul32_roll"):
        return [rng.integers(-256, 257, shape).astype(np.int32)]
    if name == "int8_lane_gather":
        return [rng.integers(-128, 128, shape).astype(np.int8),
                rng.integers(0, 128, shape).astype(np.int32)]
    if name in ("cmp8", "select8"):
        a = rng.integers(0, 256, shape).astype(np.uint8)
        a[rng.random(shape) < 0.1] = 0x2C
        return [a]
    if name == "sublane_concat":
        return [rng.integers(-2**31, 2**31, shape,
                             dtype=np.int64).astype(np.int32)]
    return [rng.integers(0, 2**32, shape, dtype=np.int64).astype(np.uint32)]


def _port(name: str, inputs: list) -> np.ndarray:
    """The port's plain version on numpy inputs, as the JAX kernel's
    output type (unsigned_reduce's uint32 bits)."""
    kernel = mp.PROBE_KERNEL[name]
    args = [torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32
                              else a).copy()) for a in inputs]
    got = mp.FUNCTIONS[kernel](*args).numpy()
    return got.view(np.uint32) if name == "unsigned_reduce" else got


@pytest.mark.parametrize("name", RUN_BOTH)
def test_jax_tool_probe_reports_fixed_in_interpret_mode(jax_probes, name):
    assert jax_probes[name][0] == "fixed"


@pytest.mark.parametrize("name", RUN_BOTH)
def test_port_probe_inputs_equal_the_tools(jax_probes, name):
    """The port draws every probe's input as the TPU tool does."""
    _, args = jax_probes[name][1]
    host = mp.probe_inputs()
    for key, arg in zip(mp.TPU_BODIES[name][1], args):
        want = np.asarray(arg)
        got = host[key]
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    if name.startswith("matmul32"):
        np.testing.assert_array_equal(
            np.asarray(args[1], np.float32), mp.pack_weights32())


@pytest.mark.parametrize("inp", ["probe", 0, 1, 2])
@pytest.mark.parametrize("name", RUN_BOTH)
def test_port_matches_jax_tool_kernel(jax_probes, name, inp):
    call, args = jax_probes[name][1]
    n = len(mp.TPU_BODIES[name][1])
    inputs = [np.asarray(a) for a in args[:n]] if inp == "probe" \
        else _random_inputs(name, 100 * inp + len(name))
    want = np.asarray(call(*[jnp.asarray(a) for a in inputs], *args[n:]))
    got = _port(name, inputs)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_mm32_pack_domain_ends_where_bf16_stops_being_exact(jax_probes):
    """Past |v| = 256 the bf16 cast of the TPU body rounds, and the port's
    integer function (kernel and plain alike) is the one that differs."""
    call, args = jax_probes["matmul32_slice"][1]
    rng = np.random.default_rng(9)
    v = rng.integers(-300, 300, (mp.T, mp.L)).astype(np.int32)
    want = np.asarray(call(jnp.asarray(v), args[1]))
    assert not np.array_equal(_port("matmul32_slice", [v]), want)


@pytest.mark.parametrize("name", [n for n, _note, _fn in mp.PROBES])
def test_port_probes_fixed_on_cpu(name):
    fn = dict((n, f) for n, _note, f in mp.PROBES)[name]
    assert fn("cpu")[0] == "fixed"


@pytest.mark.parametrize("rows", [1, 7, 9, 520])
def test_plain_versions_match_numpy(rows):
    rng = np.random.default_rng(rows)
    x = rng.integers(-2**31, 2**31, (rows, 128), dtype=np.int64).astype(
        np.int32)
    a = rng.integers(0, 256, (rows, 128)).astype(np.uint8)
    lut = rng.integers(-128, 128, (rows, 128)).astype(np.int8)
    idx = rng.integers(-2**31, 2**31, (rows, 128), dtype=np.int64).astype(
        np.int32)
    t = torch.from_numpy
    x64 = x.astype(np.int64)
    lo = sum(x64.reshape(rows, 16, 2, 4)[..., 0, l] << (4 * l)
             for l in range(4))
    hi = sum(x64.reshape(rows, 16, 2, 4)[..., 1, l] << (4 * l)
             for l in range(4))
    np.testing.assert_array_equal(
        mp.mm32_pack(t(x)).numpy(),
        ((lo | (hi << 16)) & 0xFFFFFFFF).astype(np.uint32).view(np.int32))
    np.testing.assert_array_equal(
        mp.lane_gather(t(lut), t(idx)).numpy(),
        np.take_along_axis(lut, idx & 127, 1))
    np.testing.assert_array_equal(mp.cmp8(t(a)).numpy(),
                                  (a == 0x2C).astype(np.int32))
    np.testing.assert_array_equal(mp.select8(t(a)).numpy(),
                                  np.where(a > 127, a, np.uint8(7)))
    prev = np.concatenate([np.zeros((1, 128), np.int64), x64[:-1]])
    np.testing.assert_array_equal(
        mp.shift_add(t(x)).numpy(),
        ((x64 + prev) & 0xFFFFFFFF).astype(np.uint32).view(np.int32))
    np.testing.assert_array_equal(
        mp.unsigned_sum(t(x)).numpy().view(np.uint32),
        x.view(np.uint32).sum(dtype=np.uint32).reshape(1, 1))


def test_gate_check_and_library_calls_on_cpu():
    """The gate's comparisons, counted: the TPU probe's input plus five row
    counts, two inputs for the product and the gather; check holds each
    kernel and its library call against the plain version."""
    two, one = 1 + 2 * len(mp.GATE_ROWS), 1 + len(mp.GATE_ROWS)
    assert mp.gate("cpu") == {
        k: {"checks": two if k in ("mm32_pack", "lane_gather") else one,
            "max_abs_err": 0} for k in mp.KERNELS}
    small = {k: tuple(a[:520] for a in v)
             for k, v in mp.timed_inputs("cpu").items()}
    assert mp.check(small) == {k: {"checks": 2, "max_abs_err": 0}
                               for k in mp.KERNELS}


def test_probe_kernel_map_covers_every_body():
    assert set(mp.PROBE_KERNEL) == set(RUN_BOTH)
    assert set(mp.PROBE_KERNEL.values()) == set(mp.KERNELS)


def test_mosaic_tool_exits_2_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        mp.main([])
    assert e.value.code == 2


def test_mosaic_reject_bad_input():
    x = torch.zeros((8, 128), dtype=torch.int32)
    a = torch.zeros((8, 128), dtype=torch.uint8)
    with pytest.raises(ValueError):
        mp.mm32_pack(x[:, :64])
    with pytest.raises(ValueError):
        mp.mm32_pack(x[:0])
    with pytest.raises(ValueError):
        mp.cmp8(x)
    with pytest.raises(ValueError):
        mp.select8(a.view(-1))
    with pytest.raises(ValueError):
        mp.lane_gather(a.to(torch.int8), x[:4])
    with pytest.raises(ValueError):
        mp.lane_gather(a, x)
    with pytest.raises(ValueError):
        mp.shift_add(a)
    with pytest.raises(ValueError):
        mp.unsigned_sum(x.to(torch.int64))
