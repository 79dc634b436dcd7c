"""The wide-store probes of the port on the CPU: the strided gather and
the mmL pack product (tools/widestore_probe2.py), the lane-window sum and
the mmLb pack product (tools/widestore_probe3.py). Each plain version is
held against the JAX tool's own kernel run in interpret mode through an
interpret-mode `pl` shim (no tool file is edited), on the probe's own
input and on full-range random int32, the products also with both
probes' weights and random int8 weights, where the OR of the eight block
products is not their sum. Tolerance 0: these are int32 words. The CUDA
kernels are held against the plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py. Both JAX tools set JAX's
persistent compilation cache when imported; tests/jax_tools.py stubs
that while it loads them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csv_simd_tpu_torch.tools import widestore_probe2 as ws2
from csv_simd_tpu_torch.tools import widestore_probe3 as ws3
from jax_tools import interpret_tool

PORT_PROBES = dict(ws2.PROBES + ws3.PROBES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rand_words(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


WEIGHTS = ["mmL", "mmLb", "random", "min", "overlap"]


def _weights(name: str) -> np.ndarray:
    """Both probes' weights, full-range random int8, all -128, and every
    block on the same columns (`overlap_weights`)."""
    if name == "mmL":
        return ws2.weights_mmL().numpy()
    if name == "mmLb":
        return ws3.weights_mmLb().numpy()
    if name == "min":
        return np.full((1024, 128), -128, np.int8)
    if name == "overlap":
        return ws2.overlap_weights("cpu").numpy()
    rng = np.random.default_rng(5)
    return rng.integers(-128, 128, (1024, 128)).astype(np.int8)


def _np_product(xw: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The OR over k < 8 of the int64 product of block k, the int8 cast
    wrapping, as int32."""
    want = np.zeros((xw.shape[0], 128), np.int64)
    for k in range(8):
        xs = xw[:, 128 * k:128 * (k + 1)].astype(np.int8).astype(np.int64)
        want |= xs @ w[128 * k:128 * (k + 1)].astype(np.int64)
    return want.astype(np.int32)


# --- T10: tools/widestore_probe2.py ------------------------------------


@pytest.mark.parametrize("inp", ["probe", "random"])
def test_s8_st16_matches_jax_tool_kernel(monkeypatch, inp):
    tool = interpret_tool(monkeypatch, "widestore_probe2")
    assert tool.probe_s8_st16()
    call, args, _ = tool.pl.calls[0]
    x = np.asarray(args[0]) if inp == "probe" else _rand_words((512, 128), 1)
    want = np.asarray(call(jnp.asarray(x)))
    got = ws2.s8_st16(torch.from_numpy(x.copy()))
    assert got.shape == (64, 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("inp", ["probe", "random"])
def test_mmL_matches_jax_tool_kernel(monkeypatch, inp, weights):
    """The probe's weights are the port's `weights_mmL`; on its nibble
    input and on full-range int32 the port's product equals the TPU
    kernel's with each weight set."""
    tool = interpret_tool(monkeypatch, "widestore_probe2")
    assert tool.probe_mmL()
    call, args, _ = tool.pl.calls[0]
    np.testing.assert_array_equal(np.asarray(args[1]),
                                  ws2.weights_mmL().numpy())
    x = np.asarray(args[0]) if inp == "probe" else _rand_words((512, 128), 2)
    w = _weights(weights)
    want = np.asarray(call(jnp.asarray(x), jnp.asarray(w)))
    got = ws2.mm_lanes(torch.from_numpy(x.copy()), torch.from_numpy(w.copy()))
    np.testing.assert_array_equal(got.numpy(), want)


# --- T11: tools/widestore_probe3.py ------------------------------------


@pytest.mark.parametrize("inp", ["probe", "random"])
def test_laneload_matches_jax_tool_kernel(monkeypatch, inp):
    """Full-range input makes the int32 adds wrap."""
    tool = interpret_tool(monkeypatch, "widestore_probe3")
    assert tool.probe_laneload()
    call, args, _ = tool.pl.calls[0]
    x = np.asarray(args[0]) if inp == "probe" else _rand_words((64, 1024), 3)
    want = np.asarray(call(jnp.asarray(x)))
    got = ws3.laneload(torch.from_numpy(x.copy()))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("inp", ["probe", "random"])
def test_mmLb_matches_jax_tool_kernel(monkeypatch, inp, weights):
    tool = interpret_tool(monkeypatch, "widestore_probe3")
    assert tool.probe_mmLb()
    call, args, _ = tool.pl.calls[0]
    np.testing.assert_array_equal(np.asarray(args[1]),
                                  ws3.weights_mmLb().numpy())
    x = np.asarray(args[0]) if inp == "probe" else _rand_words((64, 1024), 4)
    w = _weights(weights)
    want = np.asarray(call(jnp.asarray(x), jnp.asarray(w)))
    got = ws3.mm_lanes_b(torch.from_numpy(x.copy()),
                         torch.from_numpy(w.copy()))
    np.testing.assert_array_equal(got.numpy(), want)


# --- the one product, and the plain versions at other row counts -------


def test_or_of_block_products_is_their_sum_only_for_the_probe_weights():
    """One summed (M, 1024) @ (1024, 128) product (the library call
    `torch._int_mm`) equals the OR of the block products for both probes'
    weights, whose blocks fill disjoint columns, and not for random, all
    -128 or same-column int8 weights."""
    x = torch.from_numpy(_rand_words((64, 1024), 6))
    for name in WEIGHTS:
        w = torch.from_numpy(_weights(name))
        summed = torch._int_mm(x.to(torch.int8), w)
        assert torch.equal(summed, ws2.packmm(x, w)) == \
            (name in ("mmL", "mmLb"))


@pytest.mark.parametrize("m", [1, 7, 64, 65])
def test_mm_lanes_on_both_views_is_one_product(m):
    """mmL on the (rows, 128) words equals mmLb's product on their
    (rows/8, 1024) view, and both the NumPy statement."""
    x = torch.from_numpy(_rand_words((8 * m, 128), m))
    for name in ("mmL", "mmLb", "random"):
        w = torch.from_numpy(_weights(name))
        got = ws2.mm_lanes(x, w)
        assert got.shape == (m, 128)
        assert torch.equal(got, ws3.mm_lanes_b(x.view(-1, 1024), w))
        np.testing.assert_array_equal(
            got.numpy(), _np_product(x.view(-1, 1024).numpy(), w.numpy()))


@pytest.mark.parametrize("m", [1, 7, 65])
def test_gather_and_lane_sum_match_numpy(m):
    x = _rand_words((8 * m, 128), 10 + m)
    want = np.zeros((m, 128), np.int32)
    for s in range(8):
        want[:, 16 * s:16 * (s + 1)] = x[s::8, :16]
    np.testing.assert_array_equal(
        ws2.s8_st16(torch.from_numpy(x.copy())).numpy(), want)
    xw = x.reshape(m, 1024)
    total = xw.reshape(m, 8, 128).astype(np.int64).sum(axis=1)
    np.testing.assert_array_equal(
        ws3.laneload(torch.from_numpy(xw.copy())).numpy(),
        ((total + 2**31) % 2**32 - 2**31).astype(np.int32))


@pytest.mark.parametrize("name", list(PORT_PROBES))
def test_port_probes_bit_exact_on_cpu(name):
    assert PORT_PROBES[name]("cpu") is True


def test_tools_gate_and_check_on_cpu():
    """Each gate's and check's comparisons, counted: 7 inputs, the
    product with 3 weight sets, plus the TPU probe; check, one each on
    the timed words."""
    assert ws2.gate("cpu") == {"s8_st16": {"checks": 8, "max_abs_err": 0},
                               "mmL": {"checks": 22, "max_abs_err": 0}}
    assert ws3.gate("cpu") == {"laneload": {"checks": 8, "max_abs_err": 0},
                               "mmLb": {"checks": 22, "max_abs_err": 0}}
    w = torch.from_numpy(_rand_words((1024, 128), 12))
    one = {"checks": 1, "max_abs_err": 0}
    assert ws2.check(w) == {"s8_st16": one, "mmL": one}
    assert ws3.check(w.view(-1, 1024)) == {"laneload": one, "mmLb": one}


def test_widestore_tools_exit_2_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (ws2, ws3):
        with pytest.raises(SystemExit) as e:
            tool.main([])
        assert e.value.code == 2


def test_widestore_reject_bad_input():
    x = torch.zeros((64, 1024), dtype=torch.int32)
    w = torch.zeros((1024, 128), dtype=torch.int8)
    with pytest.raises(ValueError):
        ws2.s8_st16(x.view(-1, 128)[:100])
    with pytest.raises(ValueError):
        ws2.s8_st16(x.view(-1, 128).to(torch.int64))
    with pytest.raises(ValueError):
        ws3.laneload(x[:, :512])
    with pytest.raises(ValueError):
        ws3.mm_lanes_b(x, w.to(torch.int32))
    with pytest.raises(ValueError):
        ws2.mm_lanes(x.view(-1, 128), w[:512])
    with pytest.raises(ValueError):
        ws2.packmm(x[:0], w)
