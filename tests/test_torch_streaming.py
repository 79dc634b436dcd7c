"""The port's streaming build against the one-shot index and the JAX
package, on the CPU: chunk cuts inside quoted regions, the prefetching
pipeline, `create_streaming`, and checkpoints written by one package and
resumed by the other. Tolerance 0: these are integer offsets."""

import io

import numpy as np
import pytest
import torch

import csv_simd_tpu
import csv_simd_tpu_torch as ct
from csv_simd_tpu import golden
from csv_simd_tpu.streaming import StreamingIndexBuilder as JBuilder

from corpus import synthetic_wide_table


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _quoted_data(n_rows: int = 300) -> bytes:
    """Quoted fields with commas and newlines, long enough to be cut by
    every chunk size below, and a dangling quote at the end."""
    rows = [b"id,text,n"]
    for i in range(n_rows):
        text = b'"a,b\nc ""q"" ' + b"x" * (i % 37) + b'"'
        rows.append(b"%d,%s,%d" % (i, text, i * 7))
    return b"\n".join(rows) + b'\n"tail'


@pytest.mark.parametrize("chunk", [37, 501, 4096])
@pytest.mark.parametrize("backend", ["torch", "native", "golden"])
def test_streaming_cuts_match_one_shot(chunk, backend):
    data = _quoted_data(60 if chunk < 100 else 300)
    arr = np.frombuffer(data, np.uint8)
    want = golden.structural_index(arr)
    b = ct.StreamingIndexBuilder(backend=backend, device="cpu")
    for lo in range(0, len(data), chunk):
        b.feed(data[lo: lo + chunk])
    assert b.bytes_consumed == len(data)
    assert b.quote_parity == golden.quote_parity_out(arr)
    np.testing.assert_array_equal(b.finish(), want)
    jb = JBuilder(backend="jnp")
    for lo in range(0, len(data), chunk):
        jb.feed(data[lo: lo + chunk])
    np.testing.assert_array_equal(jb.finish(), want)


@pytest.mark.parametrize("prefetch", [True, False])
def test_build_index_streaming(prefetch):
    data = synthetic_wide_table(120_000)
    want = ct.build_index(data, backend="torch", device="cpu")
    for source in (io.BytesIO(data),
                   [data[i: i + 30_000] for i in range(0, len(data), 30_000)]):
        got = ct.build_index_streaming(source, backend="torch",
                                       chunk_bytes=17_777, prefetch=prefetch,
                                       device="cpu")
        np.testing.assert_array_equal(got, want)


def test_create_streaming_matches_create(tmp_path):
    data = _quoted_data()[:-len(b'"tail')]
    path = tmp_path / "q.csv"
    path.write_bytes(data)
    one = ct.create(str(path), backend="torch", device="cpu")
    streamed = ct.create_streaming(str(path), backend="torch",
                                   chunk_bytes=501, device="cpu")
    jax = csv_simd_tpu.create_streaming(str(path), backend="jnp",
                                        chunk_bytes=501)
    np.testing.assert_array_equal(streamed.index, one.index)
    np.testing.assert_array_equal(streamed.index, jax.index)
    assert streamed.record_cnt == one.record_cnt == jax.record_cnt
    assert streamed.seek_field(5, 1) == jax.seek_field(5, 1)
    with pytest.raises(ct.IoError):
        ct.create_streaming(str(tmp_path / "missing.csv"), device="cpu")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_resume_across_packages(tmp_path, direction):
    data = _quoted_data()
    cut = 2345  # inside a quoted field
    arr = np.frombuffer(data, np.uint8)
    assert golden.quote_parity_out(arr[:cut]) == 1
    path = str(tmp_path / "ckpt.npz")
    if direction == "jax_to_port":
        first = JBuilder(backend="jnp")
        first.feed(data[:cut])
        first.save(path)
        second = ct.StreamingIndexBuilder.load(path, backend="torch",
                                               device="cpu")
    else:
        first = ct.StreamingIndexBuilder(backend="torch", device="cpu")
        first.feed(data[:cut])
        first.save(path)
        second = JBuilder.load(path, backend="jnp")
    assert second.quote_parity == 1
    assert second.bytes_consumed == cut
    for lo in range(cut, len(data), 1000):
        second.feed(data[lo: lo + 1000])
    np.testing.assert_array_equal(second.finish(),
                                  golden.structural_index(arr))


def test_streaming_device_parity_is_chained_as_a_tensor():
    """On a device backend the carry stays a 0-d tensor between chunks
    (no host sync per chunk) and still gives the one-shot index."""
    data = _quoted_data()
    b = ct.StreamingIndexBuilder(backend="torch", device="cpu",
                                 pipeline_depth=3)
    b.feed(data[:1000])
    b.feed(data[1000:2000])
    assert type(b._parity).__name__ == "Tensor"
    assert len(b._pending) == 2
    b.feed(data[2000:])
    np.testing.assert_array_equal(
        b.finish(), golden.structural_index(np.frombuffer(data, np.uint8)))
