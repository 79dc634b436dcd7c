"""The port's JSON experiment (csv_simd_tpu_torch/experiments) against the
JAX package's, on the CPU, where `json_depths_device` and
`json_structural_mask_device` run their plain PyTorch version.

The plain mask, depths and offsets equal the JAX functions' bit for bit
at sizes 0 to 100,003 (2,049 and more take JAX's hierarchical
`fast_cummax_i32`/`fast_cumsum_i32` path), on backslash runs of 0-70
before a quote, the inputs that straddle a device kernel's cuts, and
seeded newline-delimited records; `fast_cummax_i32` equals JAX's; the
port's golden `json_levels` equals JAX's on the JSON tests' cases and
fuzzed `json.dumps` documents; and the entry points raise without a card
when asked for "cuda". Tolerance: exact (int32 and int64 arrays)."""

import json
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csv_simd_tpu.experiments import json_device as jdev
from csv_simd_tpu.experiments import json_levels as jlev
from csv_simd_tpu_torch.experiments import json_device as pdev
from csv_simd_tpu_torch.experiments import json_levels as plev

from json_cases import (
    CASES,
    escape_runs,
    json_lines,
    random_alphabet,
    straddling,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _same_as_jax(data) -> None:
    arr = np.frombuffer(bytes(data), np.uint8) if not isinstance(
        data, np.ndarray) else data
    pm, pd = pdev.json_depths_device(arr, device="cpu")
    if arr.size:
        jm, jd = jdev.json_depths_device(jnp.asarray(arr))
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(
            pdev.json_structural_mask_device(arr, device="cpu").numpy(),
            np.asarray(jdev.json_structural_mask_device(jnp.asarray(arr))))
    assert pm.dtype == pd.dtype == torch.int32
    assert pm.shape == pd.shape == (arr.size,)
    got = pdev.json_structural_index_device(arr, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jdev.json_structural_index_device(arr))


@pytest.mark.parametrize("n", [0, 1, 2, 2047, 2048, 2049, 4096, 100_003])
def test_random_alphabet_matches_jax(n):
    _same_as_jax(random_alphabet(n, n))


@pytest.mark.parametrize("k", range(9))
def test_escape_runs_match_jax(k):
    _same_as_jax(b'{"x": "' + b"\\" * k + b'", "y": [1]}')


def test_escape_runs_to_70_match_golden():
    for doc in escape_runs(70):
        np.testing.assert_array_equal(
            pdev.json_structural_index_device(doc, device="cpu"),
            plev.json_structural_index(doc))


@pytest.mark.parametrize("data", [c for c in CASES if c],
                         ids=lambda d: repr(d)[:30])
def test_cases_match_jax(data):
    _same_as_jax(data)


def test_straddling_inputs_match_jax():
    # the cuts up to 4 KiB: the larger ones only repeat these patterns,
    # at a cost in the JAX side's compiles
    for _name, data in straddling((128, 512, 4096)):
        _same_as_jax(data)


def test_json_lines_match_jax_and_end_at_depth_zero():
    block = json_lines(200_000, 3, distinct=256)
    assert len(block) <= 200_000 and block.endswith(b"\n")
    _same_as_jax(block)
    _, depth = pdev.json_depths_device(block, device="cpu")
    assert int(depth[-1]) == 0
    tiled = np.tile(np.frombuffer(block, np.uint8), 3)
    m3, d3 = pdev.json_depths_device(tiled, device="cpu")
    m1, d1 = pdev.json_depths_device(block, device="cpu")
    assert torch.equal(m3, m1.repeat(3)) and torch.equal(d3, d1.repeat(3))


@pytest.mark.parametrize("n", [1, 5, 2048, 2049, 70_001])
def test_fast_cummax_matches_jax(n):
    rng = np.random.default_rng(n)
    x = np.where(rng.random(n) < 0.1, rng.integers(0, 10**6, n),
                 -1).astype(np.int32)
    got = pdev.fast_cummax_i32(torch.from_numpy(x))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jdev.fast_cummax_i32(jnp.asarray(x))))


def test_tensor_inputs_and_refusals():
    arr = random_alphabet(5000, 9)
    t = torch.from_numpy(arr.copy())
    m, d = pdev.json_depths_device(t, device="cpu")
    m2, d2 = pdev.json_depths_device(arr.tobytes(), device="cpu")
    assert torch.equal(m, m2) and torch.equal(d, d2)
    with pytest.raises(ValueError, match="uint8"):
        pdev.json_depths_device(t.to(torch.int32), device="cpu")
    with pytest.raises(ValueError):
        pdev.json_depths_device(arr, device="meta")


def test_inputs_of_2_gib_are_refused_before_any_copy():
    """2**31 bytes raise ValueError (the outputs are int32 positions, as
    the JAX functions' are) before the bytes are copied anywhere (the
    buffers here are never written)."""
    for big in (torch.empty(2**31, dtype=torch.uint8),
                np.empty(2**31, np.uint8)):
        for fn in (pdev.json_depths_device, pdev.json_structural_mask_device,
                   pdev.json_structural_index_device):
            with pytest.raises(ValueError, match="2 GiB"):
                fn(big, device="cpu")
        del big


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    doc = b'{"a": [1]}'
    for fn in (pdev.json_depths_device, pdev.json_structural_mask_device,
               pdev.json_structural_index_device):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(doc)
        with pytest.raises(RuntimeError, match="cuda"):
            fn(doc, device="cuda")


@pytest.mark.parametrize("data", CASES, ids=lambda d: repr(d)[:30])
def test_json_levels_matches_jax(data):
    np.testing.assert_array_equal(plev.json_structural_index(data),
                                  jlev.json_structural_index(data))
    assert plev.level_sets(data) == jlev.level_sets(data)
    assert plev.json_string_mask(data) == jlev.json_string_mask(data)


def test_json_levels_fuzz_matches_jax():
    rng = random.Random(11)

    def rand_value(depth=0):
        k = rng.random()
        if depth > 3 or k < 0.3:
            return rng.choice([rng.randint(-99, 99),
                               'str with \\ and " and {, : ]', "plain",
                               True, None, 'tricky\\"', "\\"])
        if k < 0.65:
            return [rand_value(depth + 1) for _ in range(rng.randint(0, 4))]
        return {f"k{i}\\\"x": rand_value(depth + 1)
                for i in range(rng.randint(0, 4))}

    for _ in range(200):
        doc = json.dumps(rand_value()).encode()
        assert plev.level_sets(doc) == jlev.level_sets(doc), doc
        np.testing.assert_array_equal(
            pdev.json_structural_index_device(doc, device="cpu"),
            plev.json_structural_index(doc))
