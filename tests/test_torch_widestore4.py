"""The lane-axis concat product of the port on the CPU
(tools/widestore_probe4.py `probe_concat_mm`). The JAX tool is loaded by
tests/jax_tools.py, which stubs `jax.config.update` while it loads (it
sets JAX's persistent compilation cache at import), and its `pl`
replaced by the shim there, which runs the pallas_call in interpret mode
and records the call.
The recorded kernel is run again on the probe's input and on full-range
int32 x with the probe's W, full-range random int8 W and all -128,
against the port's plain version, at tolerance 0. The CUDA kernel is held
against the plain version on the card by tests/test_torch_gpu.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csv_simd_tpu_torch.tools import widestore_probe4 as ws4
from jax_tools import InterpretPl, load_tool


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
def jax_probe():
    """(the JAX probe's verdict, its recorded call and args)."""
    tool = load_tool("widestore_probe4")
    shim = InterpretPl(tool.pl)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tool, "pl", shim)
        ok = tool.probe_concat_mm()
    call, args, _ = shim.calls[0]
    return ok, call, args


def _rand_words(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def _weights(name: str) -> np.ndarray:
    if name == "probe":
        return ws4.probe_data()[0]
    if name == "min":
        return np.full((1024, 128), -128, np.int8)
    rng = np.random.default_rng(21)
    return rng.integers(-128, 128, (1024, 128)).astype(np.int8)


def test_jax_probe_is_bit_exact_in_interpret_mode(jax_probe):
    assert jax_probe[0] is True


def test_port_probe_data_equals_the_tools(jax_probe):
    """The port draws the probe's W then x from default_rng(3), as the
    TPU tool does."""
    _, _, args = jax_probe
    w, x = ws4.probe_data()
    np.testing.assert_array_equal(np.asarray(args[0]), x)
    np.testing.assert_array_equal(np.asarray(args[1]), w)
    assert np.asarray(args[0]).dtype == x.dtype
    assert np.asarray(args[1]).dtype == w.dtype


@pytest.mark.parametrize("weights", ["probe", "random", "min"])
@pytest.mark.parametrize("inp", ["probe", "random"])
def test_concat_mm_matches_jax_tool_kernel(jax_probe, inp, weights):
    """Full-range x makes the int32 add and the int8 cast wrap; with
    random W every lane of W reaches the sums."""
    _, call, args = jax_probe
    x = np.asarray(args[0]) if inp == "probe" else _rand_words((64, 1024), 8)
    w = _weights(weights)
    want = np.asarray(call(jnp.asarray(x), jnp.asarray(w)))
    got = ws4.concat_mm(torch.from_numpy(x.copy()), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [1, 7, 65])
def test_concat_mm_matches_numpy_at_ragged_rows(m):
    """The int64 product of the wrapped int8 cast, at row counts the TPU
    block never had."""
    x = _rand_words((m, 1024), m)
    k = np.arange(1024) >> 7
    for name in ("probe", "random", "min"):
        w = _weights(name)
        want = ((x.astype(np.int64) + k).astype(np.int8).astype(np.int64)
                @ w.astype(np.int64)).astype(np.int32)
        got = ws4.concat_mm(torch.from_numpy(x), torch.from_numpy(w))
        assert got.shape == (m, 128)
        np.testing.assert_array_equal(got.numpy(), want)


def test_sum_of_blocks_is_not_their_or():
    """With the probe's data the one product is not the OR of the eight
    block products (tools/widestore_probe2/3's pack): a different
    function."""
    w, x = ws4.probe_data()
    xs = (x.astype(np.int64) + (np.arange(1024) >> 7)).astype(np.int8)
    ored = np.zeros((64, 128), np.int64)
    for k in range(8):
        ored |= xs[:, 128 * k:128 * (k + 1)].astype(np.int64) @ \
            w[128 * k:128 * (k + 1)].astype(np.int64)
    got = ws4.concat_mm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert not np.array_equal(got, ored.astype(np.int32))


def test_library_call_computes_the_same_function():
    x = torch.from_numpy(_rand_words((64, 1024), 3))
    for name in ("probe", "random", "min"):
        w = torch.from_numpy(_weights(name))
        assert torch.equal(ws4.library_call(x, w)(), ws4.concat_mm(x, w))


def test_port_probe_bit_exact_on_cpu():
    assert ws4.probe_concat_mm("cpu") is True


def test_tool_gate_and_check_on_cpu():
    """The gate: the TPU probe, then 7 inputs with 3 weight sets; check,
    the kernel and the library call on the timed input."""
    assert ws4.gate("cpu") == {"concat_mm": {"checks": 22, "max_abs_err": 0}}
    x = torch.from_numpy(_rand_words((128, 1024), 12))
    assert ws4.check(x) == {"concat_mm": {"checks": 2, "max_abs_err": 0}}


def test_widestore4_tool_exits_2_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        ws4.main([])
    assert e.value.code == 2


def test_concat_mm_rejects_bad_input():
    x = torch.zeros((64, 1024), dtype=torch.int32)
    w = torch.zeros((1024, 128), dtype=torch.int8)
    with pytest.raises(ValueError):
        ws4.concat_mm(x[:, :512], w)
    with pytest.raises(ValueError):
        ws4.concat_mm(x[:0], w)
    with pytest.raises(ValueError):
        ws4.concat_mm(x.to(torch.int64), w)
    with pytest.raises(ValueError):
        ws4.concat_mm(x, w.to(torch.int32))
    with pytest.raises(ValueError):
        ws4.concat_mm(x, w[:512])
