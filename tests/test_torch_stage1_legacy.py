"""The port's v1 and v2 stage-1 pipelines, the sequential B4 wrapper, the
device compaction and `DeviceTape` against the JAX package, on the CPU.

Kernels B6 (`stage1_pallas`), B5 (`stage1_pallas_v2`) and B4
(`stage1_fused_seq`) run their plain versions here, because the tensors
lie on the CPU; the JAX kernels run in interpret mode. Tolerance 0:
integer words, counts, parities and offsets, and served bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csv_simd_tpu
import csv_simd_tpu_torch as ct
from csv_simd_tpu import golden
from csv_simd_tpu.config import Dialect as JDialect
from csv_simd_tpu.index import build_index_device as jbuild_index_device
from csv_simd_tpu.index import pad_to_grid as jpad_to_grid
from csv_simd_tpu.index import stage1_jnp as jstage1_jnp
from csv_simd_tpu.index import stage1_mask_jnp as jstage1_mask_jnp
from csv_simd_tpu.index import stage1_words as jstage1_words
from csv_simd_tpu.ops.pack import unpack_words_host as junpack_words_host
from csv_simd_tpu.ops.stage1_pallas import stage1_pallas as jstage1_pallas
from csv_simd_tpu.ops.stage1_v2 import stage1_pallas_v2 as jstage1_pallas_v2
from csv_simd_tpu.ops.stage1_v2 import stage1_swar_jnp as jstage1_swar_jnp
from csv_simd_tpu.ops.stage1_v3 import stage1_fused_seq as jstage1_fused_seq
from csv_simd_tpu_torch.config import Dialect
from csv_simd_tpu_torch.index import (
    pad_to_grid,
    stage1_jnp,
    stage1_mask_jnp,
    stage1_words,
)
from csv_simd_tpu_torch.ops.pack import unpack_words_device, unpack_words_host
from csv_simd_tpu_torch.ops.stage1_pallas import stage1_pallas
from csv_simd_tpu_torch.ops.stage1_v2 import (
    pad_to_words,
    stage1_pallas_v2,
    stage1_swar_jnp,
    unpack_words_v2_host,
)
from csv_simd_tpu_torch.ops.stage1_v3 import stage1_fused_seq

from corpus import all_cases, synthetic_wide_table

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


DIALECTS = ({}, dict(delimiter=0x3B, quote=0x27), dict(quote=0xA2))
ALPHABET = np.frombuffer(b'ab"",\n\rx,z":; \t\'\xc3\xa9\xa2', np.uint8)


def _inputs():
    cases = [np.frombuffer(c.data, np.uint8) for c in all_cases()[::4]]
    rng = np.random.default_rng(5)
    return cases + [rng.choice(ALPHABET, size=n) for n in (1, 5000, 70_000)]


@pytest.mark.parametrize("i", range(len(_inputs())))
def test_v1_matches_jax(i):
    arr = _inputs()[i]
    b2d = pad_to_grid(arr)
    np.testing.assert_array_equal(b2d, jpad_to_grid(arr))
    t, j = torch.from_numpy(b2d.copy()), jnp.asarray(b2d)
    for kw in DIALECTS:
        td, jd = Dialect(**kw), JDialect(**kw)
        for carry in (0, 1):
            words, count, par = stage1_pallas(t, carry, td)
            jw, jc, jp = jstage1_pallas(j, carry, jd, interpret=True)
            np.testing.assert_array_equal(words.numpy(), np.asarray(jw))
            assert int(count) == int(jc) and int(par) == int(jp)
            pw, pp = stage1_jnp(t, carry, td)
            jw2, jp2 = jstage1_jnp(j, jnp.int32(carry), jd)
            np.testing.assert_array_equal(pw.numpy(), np.asarray(jw2))
            assert int(pp) == int(jp2) == int(par)
            pm, pmp = stage1_mask_jnp(t, carry, td)
            jm, jmp = jstage1_mask_jnp(j, jnp.int32(carry), jd)
            np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
            assert int(pmp) == int(jmp) == int(par)
            mask = unpack_words_host(words.numpy(), arr.size)
            np.testing.assert_array_equal(
                mask, junpack_words_host(np.asarray(jw), arr.size))
            np.testing.assert_array_equal(
                mask, golden.structural_mask(arr, jd, carry_in=carry))
            assert int(count) == int(mask.sum())
            np.testing.assert_array_equal(
                unpack_words_device(words).reshape(-1)[:arr.size].numpy(),
                mask)


@pytest.mark.parametrize("i", range(len(_inputs())))
def test_v2_matches_jax(i):
    arr = _inputs()[i]
    w = pad_to_words(arr, row_align=8)
    t, j = torch.from_numpy(w.copy()), jnp.asarray(w)
    for kw in DIALECTS:
        td, jd = Dialect(**kw), JDialect(**kw)
        for carry in (0, 1):
            got = stage1_pallas_v2(t, carry, td)
            plain = stage1_swar_jnp(t, carry, td)
            twin = jstage1_swar_jnp(j, carry, jd)
            kern = jstage1_pallas_v2(j, carry, jd, interpret=True,
                                     row_tile=min(64, w.shape[0]))
            for g, p, tw, k in zip(got, plain, twin, kern):
                np.testing.assert_array_equal(g.numpy(), p.numpy())
                np.testing.assert_array_equal(g.numpy(), np.asarray(tw))
                np.testing.assert_array_equal(g.numpy(), np.asarray(k))
            mask = unpack_words_v2_host(got[0].numpy(), arr.size)
            np.testing.assert_array_equal(
                mask, golden.structural_mask(arr, jd, carry_in=carry))


@pytest.mark.parametrize("i", range(len(_inputs())))
def test_seq_wrapper_matches_jax(i):
    arr = _inputs()[i]
    w = pad_to_words(arr, row_align=8)
    t, j = torch.from_numpy(w.copy()), jnp.asarray(w)
    for kw in DIALECTS:
        for carry in (0, 1):
            got, par = stage1_fused_seq(t, carry, Dialect(**kw))
            want, wpar = jstage1_fused_seq(j, carry, JDialect(**kw),
                                           interpret=True)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert int(par) == int(wpar)


@pytest.mark.parametrize("cut", [1, 777, 4096, 30_001])
def test_stage1_words_chained_across_a_cut(cut):
    rng = np.random.default_rng(cut)
    arr = rng.choice(ALPHABET, size=40_000)
    head, tail = arr[:cut], arr[cut:]
    w1, n1, p1 = stage1_words(head, backend="torch", device="cpu")
    w2, n2, p2 = stage1_words(tail, backend="torch", carry_in=p1,
                              device="cpu")
    j1, m1, q1 = jstage1_words(head, backend="jnp")
    j2, m2, q2 = jstage1_words(tail, backend="jnp", carry_in=q1)
    np.testing.assert_array_equal(w1, j1)
    np.testing.assert_array_equal(w2, j2)
    assert (n1, p1, n2, p2) == (m1, q1, m2, q2)
    mask = np.concatenate([unpack_words_host(w1, n1),
                           unpack_words_host(w2, n2)])
    np.testing.assert_array_equal(mask, golden.structural_mask(arr))
    assert p2 == golden.quote_parity_out(arr)


def test_stage1_words_backends():
    with pytest.raises(ValueError):
        stage1_words(b"a,b\n", backend="native", device="cpu")
    with pytest.raises(ValueError):
        stage1_words(b"a,b\n", backend="cuda", device="cpu")
    with pytest.raises(ValueError):
        stage1_words(b"a,b\n", backend="pallas", device="cpu")


@pytest.mark.parametrize("density", [0.25, 0.01])
@pytest.mark.parametrize("kw", DIALECTS[:2])
def test_build_index_device_matches_jax(density, kw):
    data = synthetic_wide_table(120_000)
    got, count = ct.build_index_device(data, Dialect(**kw), density=density,
                                       device="cpu")
    want, wcount = jbuild_index_device(data, JDialect(**kw), density=density)
    assert count == wcount
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    arr = np.frombuffer(data, np.uint8)
    np.testing.assert_array_equal(
        got.numpy(), golden.structural_index(arr, JDialect(**kw)))


def test_build_index_device_capacity_fill():
    """With room to spare the offsets are exactly the index; the JAX
    capacity and fill semantics hold at the compaction step."""
    from csv_simd_tpu.ops.compact import count_set as jcount_set
    from csv_simd_tpu.ops.compact import extract_offsets_device as jextract
    from csv_simd_tpu_torch.ops.compact import count_set, extract_offsets_device

    rng = np.random.default_rng(0)
    mask = (rng.random((64, 512)) < 0.05).astype(np.int32)
    assert int(count_set(torch.from_numpy(mask))) == int(
        jcount_set(jnp.asarray(mask)))
    for cap in (10, int(mask.sum()), 5000):
        got, n = extract_offsets_device(torch.from_numpy(mask), cap)
        want, wn = jextract(jnp.asarray(mask), cap)
        assert int(n) == int(wn)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("max_len", [8, 64])
def test_device_tape_matches_jax(max_len):
    data = synthetic_wide_table(100_000)
    jt = csv_simd_tpu.create_from_bytes(data, backend="jnp")
    pt = ct.create_from_bytes(data, backend="torch", device="cpu")
    jdt = csv_simd_tpu.DeviceTape.from_tape(jt)
    pdt = ct.DeviceTape.from_tape(pt, device="cpu")
    rng = np.random.default_rng(max_len)
    recs = rng.integers(-3, jt.record_cnt + 3, 4000).astype(np.int32)
    flds = rng.integers(-2, 18, 4000).astype(np.int32)
    for g, w in zip(pdt.gather_fields(recs, flds, max_len),
                    jdt.gather_fields(recs, flds, max_len)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(pdt.column_int32(0), jdt.column_int32(0)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_device_tape_refuses_two_gib_offsets():
    with pytest.raises(ValueError, match="2 GiB"):
        ct.DeviceTape(b"a\n", np.array([0, 2**31], np.int64), 1, 1, 2,
                      device="cpu")
