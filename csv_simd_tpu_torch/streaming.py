"""Streaming index build (csv_simd_tpu/streaming.py): chunked input with
carried boundary state.

The byte stream is consumed in chunks; the only state carried between
chunks is the quote parity plus the running byte offset for rebasing
local structural positions to absolute offsets. The result is
bit-identical to a one-shot build wherever the chunks are cut, quoted
regions included.

On the device backends ("cuda", "torch") each chunk is padded and
copied to the device (`prepare`, safe to run on a worker thread so the
copy is in flight before the scan), the stage-1 build runs with the
parity carry chained as a device scalar (no host sync per chunk), and
the host extraction lags `pipeline_depth` chunks behind.
`ShardedStreamingIndexBuilder` does the same over a mesh of shards
(parallel/sharded.py), each chunk cut into the mesh's shards.
"""

from __future__ import annotations

import os
from typing import BinaryIO, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from .config import DEFAULT_DIALECT, Dialect
from .device import resolve_device
from .errors import IoError
from .index import FOLD_TILE, _resolve_backend
from .utils import as_u8

DEFAULT_CHUNK_BYTES = 64 * 1024 * 1024


def _iter_chunks(
    source: Union[str, os.PathLike, BinaryIO, Iterable[bytes]],
    chunk_bytes: int,
) -> Iterator[bytes]:
    if isinstance(source, (str, os.PathLike)):
        try:
            with open(source, "rb") as f:
                while True:
                    chunk = f.read(chunk_bytes)
                    if not chunk:
                        return
                    yield chunk
        except OSError as e:
            raise IoError(str(e)) from e
    elif hasattr(source, "read"):
        while True:
            chunk = source.read(chunk_bytes)
            if not chunk:
                return
            yield chunk
    else:
        yield from source


class StreamingIndexBuilder:
    """Incremental structural-index builder.

    feed(chunk) any number of times, then finish() -> int64 index with
    the 0 sentinel. Device work per chunk uses the selected backend on
    `device`; the carry is one parity bit and a byte offset.
    """

    def __init__(self, dialect: Dialect = DEFAULT_DIALECT,
                 backend: str = "auto", pipeline_depth: int = 2,
                 device="cuda"):
        self._dialect = dialect
        self._backend = _resolve_backend(backend, device)
        self._device = (resolve_device(device)
                        if self._backend in ("cuda", "torch") else None)
        self._parity = 0  # int, or a device scalar while pipelining
        self._offset = 0
        self._parts = [np.zeros(1, dtype=np.int64)]  # sentinel
        self._depth = max(pipeline_depth, 1)
        self._pending = []  # [(packed_device, n_bytes, base_offset, tile)]

    def feed(self, chunk: bytes | np.ndarray) -> None:
        self.feed_prepared(self.prepare(chunk))

    def prepare(self, chunk: bytes | np.ndarray):
        """Backend-specific chunk staging, safe to call from a worker
        thread: for the device backends this pads to the (rows, 128)
        byte-quad layout and enqueues the copy to the device, so the copy
        is in flight when feed_prepared launches the scan. Host backends
        pass the bytes through."""
        from .index import _upload_words

        arr = as_u8(chunk)
        if arr.size and self._device is not None:
            return ("dev", _upload_words(arr, self._device), arr.size)
        return ("host", arr, arr.size)

    def feed_prepared(self, prepared) -> None:
        from .utils.metrics import GLOBAL as _metrics

        kind, payload, n_bytes = prepared
        if n_bytes == 0:
            return
        with _metrics.span("streaming_chunk", n_bytes):
            if kind == "dev":
                self._feed_device(payload, n_bytes)
            else:
                self._feed_inner(payload)

    def _feed_inner(self, arr: np.ndarray) -> None:
        """One chunk on a host backend ("golden" or "native")."""
        if self._backend == "golden":
            from . import golden

            mask = golden.structural_mask(arr, self._dialect, self._parity)
            self._parity = golden.quote_parity_out(
                arr, self._dialect, self._parity)
            local = np.flatnonzero(mask).astype(np.int64)
        else:
            from . import native

            local, par = native.host_stage1(
                arr, self._dialect, carry_in=self._parity,
                with_sentinel=False)
            self._parity = int(par)
        if local.size:
            self._parts.append(local + self._offset)
        self._offset += arr.size

    def _feed_device(self, w2d: torch.Tensor, n_bytes: int) -> None:
        from .ops.stage1_v3 import stage1_fused, stage1_swar_xla

        tile = min(FOLD_TILE, w2d.shape[0])
        if self._backend == "cuda":
            packed, par = stage1_fused(w2d, self._parity, self._dialect,
                                       row_tile=FOLD_TILE)
        else:
            packed, par = stage1_swar_xla(w2d, self._parity, self._dialect,
                                          row_tile=FOLD_TILE)
        # chain the parity carry as a device scalar (the next chunk's
        # scan is enqueued without waiting), queue the packed words and
        # extract a lagging chunk on the host
        self._parity = par
        self._pending.append((packed, n_bytes, self._offset, tile))
        self._offset += n_bytes
        while len(self._pending) > self._depth:
            self._drain_one()

    def _drain_one(self) -> None:
        from .index import _to_host, extract_offsets_from_packed

        packed, n, base, tile = self._pending.pop(0)
        local = extract_offsets_from_packed(_to_host(packed), tile, n,
                                            base=base)
        if local.size:
            self._parts.append(local)

    def _drain_all(self) -> None:
        while self._pending:
            self._drain_one()

    @property
    def bytes_consumed(self) -> int:
        return self._offset

    @property
    def quote_parity(self) -> int:
        return int(self._parity)

    def finish(self) -> np.ndarray:
        self._drain_all()
        return np.concatenate(self._parts)

    # -- checkpoint/resume: an interrupted ingest restarts from the last
    #    consumed byte with only the parity bit, the offset and the
    #    partial index; the file format is the JAX package's --

    def state_dict(self) -> dict:
        self._drain_all()
        return {
            "parity": int(self._parity),
            "offset": self._offset,
            "index_parts": np.concatenate(self._parts),
        }

    @classmethod
    def from_state(cls, state: dict, dialect=None, backend: str = "auto",
                   device="cuda"):
        b = cls(dialect or DEFAULT_DIALECT, backend, device=device)
        b._parity = int(state["parity"])
        b._offset = int(state["offset"])
        b._parts = [np.asarray(state["index_parts"], dtype=np.int64)]
        return b

    def save(self, path) -> None:
        np.savez_compressed(path, **self.state_dict())

    @classmethod
    def load(cls, path, dialect=None, backend: str = "auto", device="cuda"):
        with np.load(path, allow_pickle=False) as z:
            state = {k: z[k] for k in ("parity", "offset", "index_parts")}
        return cls.from_state(state, dialect, backend, device)


class ShardedStreamingIndexBuilder:
    """Chunked ingestion across a mesh: streaming and sharding composed.

    Each fed chunk is cut byte-wise into the mesh's shards and scanned by
    parallel.sharded.sharded_stage1 ("fold" layout), whose exclusive
    parity scan resolves the quote parity across the shard cuts inside
    the chunk; the builder threads the one quote-parity carry across the
    chunk cuts as a device scalar (no host sync a chunk), and extracts a
    lagging chunk's words on the host with the native extractor, shard by
    shard. The result is bit-identical to a one-shot build even where a
    quoted region spans a chunk and a shard cut. `device` makes the
    default mesh (one shard a visible device)."""

    def __init__(self, mesh=None, dialect: Dialect = DEFAULT_DIALECT,
                 use_pallas: Optional[bool] = None,
                 interpret: Optional[bool] = None,
                 pipeline_depth: int = 2, device="cuda"):
        from .parallel.sharded import _single_process, make_mesh

        self._mesh = mesh or make_mesh(device=device)
        _single_process(self._mesh)
        self._dialect = dialect
        self._use_pallas = use_pallas
        self._parity = 0  # int or device scalar
        self._offset = 0
        self._parts = [np.zeros(1, dtype=np.int64)]
        self._depth = max(pipeline_depth, 1)
        self._pending = []  # [(packed words a shard, n_bytes, base offset)]

    def feed(self, chunk: bytes | np.ndarray) -> None:
        from .parallel.sharded import (
            _mesh_rows,
            _upload_shards,
            _words,
            sharded_stage1,
        )

        arr = as_u8(chunk)
        if arr.size == 0:
            return
        rows = _mesh_rows(arr.size, self._mesh.size)
        shards = _upload_shards(arr, rows, self._mesh)
        packed, _c, _ce, _t, parity = sharded_stage1(
            [_words(s) for s in shards], self._parity, self._mesh,
            self._dialect, use_pallas=self._use_pallas)
        self._parity = parity  # device scalar: the next chunk chains on it
        self._pending.append((packed, arr.size, self._offset))
        self._offset += arr.size
        while len(self._pending) > self._depth:
            self._drain_one()

    def _drain_one(self) -> None:
        from .parallel.sharded import _fold_offsets

        packed, n, base = self._pending.pop(0)
        self._parts.extend(_fold_offsets(packed, n, base))

    @property
    def quote_parity(self) -> int:
        return int(self._parity)

    def finish(self) -> np.ndarray:
        while self._pending:
            self._drain_one()
        return np.concatenate(self._parts)

    # -- checkpoint/resume: the parity bit, the byte offset and the
    #    partial index restart an interrupted ingest exactly; the file
    #    format is the JAX package's --

    def state_dict(self) -> dict:
        while self._pending:
            self._drain_one()
        return {
            "parity": int(self._parity),
            "offset": self._offset,
            "index_parts": np.concatenate(self._parts),
        }

    @classmethod
    def from_state(cls, state: dict, mesh=None, dialect=None,
                   use_pallas=None, interpret=None, device="cuda"):
        b = cls(mesh, dialect or DEFAULT_DIALECT, use_pallas, interpret,
                device=device)
        b._parity = int(state["parity"])
        b._offset = int(state["offset"])
        b._parts = [np.asarray(state["index_parts"], dtype=np.int64)]
        return b

    def save(self, path) -> None:
        np.savez_compressed(path, **self.state_dict())

    @classmethod
    def load(cls, path, mesh=None, dialect=None, use_pallas=None,
             interpret=None, device="cuda"):
        with np.load(path, allow_pickle=False) as z:
            state = {k: z[k] for k in ("parity", "offset", "index_parts")}
        return cls.from_state(state, mesh, dialect, use_pallas, interpret,
                              device)


def build_index_sharded_streaming(
    source: Union[str, os.PathLike, BinaryIO, Iterable[bytes]],
    mesh=None,
    dialect: Dialect = DEFAULT_DIALECT,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    use_pallas: Optional[bool] = None,
    interpret: Optional[bool] = None,
    device="cuda",
) -> np.ndarray:
    """Streamed and sharded build -> host int64 index with the 0
    sentinel, bit-identical to golden and the one-shot builds."""
    b = ShardedStreamingIndexBuilder(mesh, dialect, use_pallas, interpret,
                                     device=device)
    for chunk in _iter_chunks(source, chunk_bytes):
        b.feed(chunk)
    return b.finish()


def build_index_streaming(
    source: Union[str, os.PathLike, BinaryIO, Iterable[bytes]],
    dialect: Dialect = DEFAULT_DIALECT,
    backend: str = "auto",
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    prefetch: bool = True,
    device="cuda",
) -> np.ndarray:
    """Build the full structural index from a path, file object or chunk
    iterable without materialising the input.

    With prefetch=True (default) the ingest is a three-stage pipeline:
    an IO thread reads chunk k+2, a transfer thread stages chunk k+1
    (padding and the copy to the device for the device backends), while
    the calling thread launches chunk k's scan and extracts lagging
    results."""
    builder = StreamingIndexBuilder(dialect, backend, device=device)
    chunks = _iter_chunks(source, chunk_bytes)
    if prefetch:
        import concurrent.futures

        with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
            nxt = pool.submit(next, chunks, None)
            staged = None  # future of the next prepared chunk
            while True:
                chunk = nxt.result()
                if chunk is None:
                    break
                nxt = pool.submit(next, chunks, None)
                prep = pool.submit(builder.prepare, chunk)
                if staged is not None:
                    builder.feed_prepared(staged.result())
                staged = prep
            if staged is not None:
                builder.feed_prepared(staged.result())
    else:
        for chunk in chunks:
            builder.feed(chunk)
    return builder.finish()


def create_streaming(
    path: Union[str, os.PathLike],
    dialect: Optional[Dialect] = None,
    backend: str = "auto",
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    device="cuda",
):
    """Streamed counterpart of api.create: the index is built chunk by
    chunk, then a Tape serves the mmapped bytes (not duplicated in
    memory)."""
    import mmap as _mmap

    from .tape import Header, Tape

    dialect = dialect or DEFAULT_DIALECT
    index = build_index_streaming(path, dialect, backend, chunk_bytes,
                                  device=device)
    try:
        with open(path, "rb") as f:
            mapped = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
    except (OSError, ValueError) as e:
        raise IoError(str(e)) from e
    data = np.frombuffer(mapped, dtype=np.uint8)
    header = Header.parse(data, delimiter=dialect.delimiter,
                          quote_aware=dialect.header_quotes,
                          quote=dialect.quote)
    return Tape(data, index, header)
