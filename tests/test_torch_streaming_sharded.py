"""The port's sharded streaming build (csv_simd_tpu_torch/streaming.py
ShardedStreamingIndexBuilder, build_index_sharded_streaming) against the
JAX package's and golden on the CPU: chunks whose cuts fall inside quoted
spans that also cross shard cuts (tests/test_streaming_sharded.py's
input), the parity carried across chunks, and checkpoints written by one
package and resumed by the other at 4 and 8 shards. Tolerance 0: these
are integer offsets."""

import numpy as np
import pytest
import torch

from csv_simd_tpu.parallel.sharded import make_mesh as jmake_mesh
from csv_simd_tpu.streaming import ShardedStreamingIndexBuilder as JBuilder
from csv_simd_tpu_torch.parallel.sharded import make_mesh
from csv_simd_tpu_torch.streaming import (
    ShardedStreamingIndexBuilder,
    StreamingIndexBuilder,
    build_index_sharded_streaming,
)

from test_streaming_sharded import CHUNK, DATA, _golden_index


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite runs several test processes side by side on the same
    cores, where torch's thread pool only contends."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


GOLDEN = _golden_index(DATA)


def _feed(b, data: bytes, lo: int = 0, chunk: int = CHUNK):
    for start in range(lo, len(data), chunk):
        b.feed(data[start:start + chunk])
    return b


@pytest.mark.parametrize("use_pallas", [None, False, True])
@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_sharded_streaming_bit_identical(n, use_pallas):
    b = _feed(ShardedStreamingIndexBuilder(make_mesh(n, device="cpu"),
                                           use_pallas=use_pallas), DATA)
    np.testing.assert_array_equal(b.finish(), GOLDEN)


@pytest.mark.parametrize("chunk", [CHUNK, 20_011])
def test_matches_jax_and_single_device_streaming(chunk):
    got = build_index_sharded_streaming(
        iter([DATA[i:i + chunk] for i in range(0, len(DATA), chunk)]),
        make_mesh(8, device="cpu"), chunk_bytes=chunk)
    jb = _feed(JBuilder(jmake_mesh(8)), DATA, chunk=chunk)
    np.testing.assert_array_equal(got, jb.finish())
    single = StreamingIndexBuilder(backend="torch", device="cpu")
    single.feed(DATA)
    np.testing.assert_array_equal(got, single.finish())


def test_tail_chunk_and_parity_property():
    data = b'a,b\n1,"unclosed , \n span'
    b = ShardedStreamingIndexBuilder(make_mesh(4, device="cpu"))
    b.feed(data[:7])
    b.feed(data[7:])
    b.feed(b"")
    assert b.quote_parity == 1
    np.testing.assert_array_equal(b.finish(), _golden_index(data))


@pytest.mark.parametrize("n_save,n_load", [(4, 8), (8, 4)])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, n_save, n_load):
    """The JAX builder's state after two chunks, saved, resumed in the
    port on another mesh size, and the reverse: both finish at golden."""
    jb = _feed(JBuilder(jmake_mesh(n_save)), DATA[:2 * CHUNK])
    p = tmp_path / "jax.npz"
    jb.save(p)
    b = ShardedStreamingIndexBuilder.load(p, make_mesh(n_load, device="cpu"))
    np.testing.assert_array_equal(_feed(b, DATA, 2 * CHUNK).finish(), GOLDEN)
    b2 = ShardedStreamingIndexBuilder.from_state(
        jb.state_dict(), make_mesh(n_load, device="cpu"))
    np.testing.assert_array_equal(_feed(b2, DATA, 2 * CHUNK).finish(),
                                  GOLDEN)


@pytest.mark.parametrize("n_save,n_load", [(4, 8), (8, 4)])
def test_port_checkpoint_resumes_in_jax(tmp_path, n_save, n_load):
    b = _feed(ShardedStreamingIndexBuilder(make_mesh(n_save, device="cpu")),
              DATA[:CHUNK + 5000], chunk=5000)
    state = b.state_dict()
    jstate = _feed(JBuilder(jmake_mesh(n_save)), DATA[:CHUNK + 5000],
                   chunk=5000).state_dict()
    assert state.keys() == jstate.keys()
    assert state["parity"] == jstate["parity"] == 1
    assert state["offset"] == jstate["offset"]
    np.testing.assert_array_equal(state["index_parts"],
                                  jstate["index_parts"])
    p = tmp_path / "port.npz"
    b.save(p)
    jb = JBuilder.load(p, jmake_mesh(n_load))
    np.testing.assert_array_equal(_feed(jb, DATA, CHUNK + 5000).finish(),
                                  GOLDEN)


def test_builder_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default mesh is on it")
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedStreamingIndexBuilder()
    with pytest.raises(RuntimeError, match="cuda"):
        build_index_sharded_streaming([b"a,b\n"])
