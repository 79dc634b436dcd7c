"""Cross-shard serving: batched field gathers over sharded bytes
(csv_simd_tpu/parallel/serving.py).

Two tapes, one contract:

- ShardedTape: bytes sharded, the int32 offsets index replicated on the
  mesh's first device. Capped at 2 GiB by that index.
- ShardedPackedTape: the offsets-free path. The packed sequential bitmask
  and the bytes are sharded; only the row popcount prefix is replicated.
  Serving addresses bytes as (global row, offset in row) pairs with
  shard-local int32 positions, so it serves inputs far past the 2 GiB
  flat-int32 line: each shard must stay under 2 GiB, and the structural
  count under 2^31.

Both set `device` to the mesh's first device, where every served tensor
lies, so the typed columns (TypedColumnsMixin) and the relational layer
run over them unchanged. A cross-shard read is a masked gather on each
shard, combined on the first device, where exactly one shard gives each
value: the JAX package's psum of zeros elsewhere, without widening the
bytes, and with each shard's temporaries freed before the next shard's
gather.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..device_tape import (
    TypedColumnsMixin,
    _byte_window,
    _field_bounds,
    _host,
    _slots,
    as_int32,
)
from ..offsetfree import _upload_bytes
from ..utils import as_u8
from .sharded import (
    Mesh,
    _mesh_rows,
    _single_process,
    _upload_shards,
    _words,
    sharded_stage1,
)


def _sharded_take(shards: list, owner: torch.Tensor, local: torch.Tensor,
                  keep=None) -> torch.Tensor:
    """shards[owner][local] where keep (and owner names a shard), 0
    elsewhere, on owner's device. owner and local are int32 of one shape;
    a shard may add trailing dimensions (a row of words)."""
    first = owner.device
    trail = tuple(shards[0].shape[1:])
    out = torch.zeros(tuple(owner.shape) + trail, dtype=shards[0].dtype,
                      device=first)
    pad = (1,) * len(trail)
    for k, shard in enumerate(shards):
        mine = owner == k
        if keep is not None:
            mine &= keep
        got = shard[torch.where(mine, local, 0).to(shard.device)].to(first)
        out = torch.where(mine.view(tuple(mine.shape) + pad), got, out)
        del mine, got
    return out


class ShardedTape(TypedColumnsMixin):
    """Serving over mesh-sharded bytes and a replicated int32 index.
    Typed columns, decode and filters come from TypedColumnsMixin, so the
    relational layer runs over the mesh unchanged."""

    def __init__(self, data: np.ndarray, index: np.ndarray, jump: int,
                 field_cnt: int, record_cnt: int, mesh: Mesh,
                 header=None):
        _single_process(mesh)
        self.header = header  # optional Header (column names, frame.py)
        idx_host = _host(index)
        if idx_host.size and int(idx_host[-1]) >= 2**31:
            raise ValueError(
                "ShardedTape replicates an int32 index: >= 2 GiB inputs "
                "need the offsets-free ShardedPackedTape"
            )
        arr = as_u8(data)
        n = mesh.size
        self.shard_len = -(-arr.size // n)  # bytes padded to n equal parts
        self.data = [_upload_bytes(arr, k * self.shard_len, self.shard_len, d)
                     for k, d in enumerate(mesh.devices)]
        self.mesh = mesh
        self.device = mesh.devices[0]
        self.index = torch.from_numpy(np.ascontiguousarray(
            idx_host, dtype=np.int32)).to(self.device)
        self.jump = int(jump)
        self.field_cnt = int(field_cnt)
        self.record_cnt = int(record_cnt)

    @classmethod
    def from_tape(cls, tape, mesh: Mesh) -> "ShardedTape":
        return cls(
            as_u8(tape.data_bytes),
            np.asarray(tape.index),
            tape.record_jump_size,
            tape.field_cnt,
            tape.record_cnt,
            mesh,
            header=getattr(tape, "header", None),
        )

    def gather_fields(self, records, fields, max_len: int = 64):
        """Batched (record, field) -> (bytes (N, max_len) uint8, TRUE
        lengths (N,) int32, valid (N,) bool), on the first device."""
        starts, ends, valid = _field_bounds(
            self.index, as_int32(records, self.device),
            as_int32(fields, self.device), self.jump, self.field_cnt,
            self.record_cnt)
        return _byte_window(self.data, starts, ends, valid, max_len,
                            take=self._take)

    def _take(self, shards: list, pos: torch.Tensor,
              keep: torch.Tensor) -> torch.Tensor:
        """The byte window's read: flat positions, clamped into the padded
        bytes, read from the shard that holds each; `pos` becomes the
        shard-local positions in place."""
        pos.clamp_(0, self.shard_len * self.mesh.size - 1)
        owner = pos // self.shard_len
        local = pos.sub_(owner * self.shard_len)
        return _sharded_take(shards, owner, local, keep)


def _serve_packed_sharded(data: list, words: list, cum: torch.Tensor,
                          records: torch.Tensor, fields: torch.Tensor,
                          jump: int, field_cnt: int, record_cnt: int,
                          shard_rows: int, max_len: int):
    """The offsets-free sharded serve (the JAX `_sharded_serve_fn`). All
    byte addressing is (global row int32, in-row offset 0..511) pairs, and
    a byte is read at its shard-local int32 position (local row * 512 +
    offset), which stays under 2^31 whatever the total size: no flat
    global position exists. The replicated math (the searchsorted on the
    row prefix, the rank in the row) runs on cum's device; each hit row's
    16 words and each byte come from the owning shard."""
    from ..offsetfree import _bit_in_row, _row_and_rank

    slots, valid = _slots(records, fields, jump, field_cnt, record_cnt)
    ks = torch.cat([slots - 1, slots])  # start bit, end bit
    row, j = _row_and_rank(cum, ks)
    owner = row // shard_rows
    # narrow row r of a wide shard is its flat words 16r .. 16r + 15
    wrow = _sharded_take([w.view(-1, 16) for w in words], owner,
                         row - owner * shard_rows)
    inrow = _bit_in_row(wrow, j)  # 0..511 within the row
    del wrow, owner, j

    n = slots.shape[0]
    # field byte range: start = pos(slot - 1) + 1, end = pos(slot), as
    # (row, offset) pairs
    srow, soff = row[:n], inrow[:n] + 1
    srow, soff = srow + (soff >> 9), soff & 511
    erow, eoff = row[n:, None], inrow[n:, None]
    lengths = torch.where(valid, (erow[:, 0] - srow) * 512
                          + (eoff[:, 0] - soff), 0)
    off = soff[:, None] + torch.arange(max_len, dtype=torch.int32,
                                       device=cum.device)[None, :]
    brow = srow[:, None] + (off >> 9)
    boff = off & 511
    del off
    keep = ((brow < erow) | ((brow == erow) & (boff < eoff))) \
        & valid[:, None]
    owner = brow // shard_rows
    local = (brow - owner * shard_rows) * 512 + boff
    del brow, boff
    return _sharded_take(data, owner, local, keep), lengths, valid


class ShardedPackedTape(TypedColumnsMixin):
    """Offsets-free serving over a mesh: the packed sequential bitmask and
    the bytes stay on the shards' devices row-wise; only the row popcount
    prefix (4 bytes per 512 input bytes) is replicated, on the first
    device. The >= 2 GiB serving path: no offsets array exists, and a
    lookup routes by global row.

    On CUDA shards the build is kernel S1 (the shard parities), B1 (the
    wide sequential words, with the carried parity) and B2 (each shard's
    row prefix), once a shard; on CPU shards their plain versions. The
    bytes go to each shard from the caller's array through pinned
    staging; no padded host copy of the whole input is made.
    validate_utf8 counts the non-ASCII bytes in B1 and checks input with
    any on the host, as the JAX package does."""

    def __init__(self, data: bytes | np.ndarray, mesh: Mesh,
                 dialect=None, use_pallas=None, interpret=None,
                 validate_utf8: bool = False):
        from ..config import DEFAULT_DIALECT
        from ..errors import InvalidCsvFormat
        from ..tape import Header

        _single_process(mesh)
        dialect = dialect or DEFAULT_DIALECT
        arr = as_u8(data)
        header = Header.parse(arr, delimiter=dialect.delimiter,
                              quote_aware=dialect.header_quotes,
                              quote=dialect.quote)
        n_shards = mesh.size
        if use_pallas is None:
            use_pallas = mesh.devices[0].type == "cuda"
        rows = _mesh_rows(arr.size, n_shards)
        if (rows // n_shards) * 512 >= 2**31:
            raise ValueError(
                "each SHARD must stay under 2 GiB for int32-local byte "
                f"addressing: {rows * 512 / 2**30:.1f} GiB over {n_shards} "
                "shard(s) — use a larger mesh"
            )
        shards = _upload_shards(arr, rows, mesh)
        # the kernels run the wide pipeline per shard: the (shard_rows/8,
        # 1024) view of the bytes in, the (shard_rows/8, 128) words out,
        # which the prefix and the serve take as they are
        wide = bool(use_pallas)
        out = sharded_stage1(
            [_words(s, 1024 if wide else 128) for s in shards], 0, mesh,
            dialect, use_pallas=use_pallas,
            layout="seq_wide" if wide else "seq",
            count_nonascii=validate_utf8)
        self._index(out[0], shards, header, arr.size, mesh)
        if validate_utf8:
            # B1's per-shard high-bit counts: pure-ASCII input skips the
            # check; other input is checked on the host, since a shard
            # cut may split a sequence
            na_total = int(_host(out[5]).astype(np.int64).sum())
            self.nonascii_count = na_total
            if na_total > 0:
                from ..ops.utf8 import validate_utf8 as _utf8_host

                if not _utf8_host(arr):
                    raise InvalidCsvFormat("input is not valid UTF-8")
        else:
            self.nonascii_count = None

    def _index(self, packed: list, shards: list, header, n_bytes: int,
               mesh: Mesh) -> None:
        """Keep the words and bytes; the replicated row prefix (kernel B2
        on each shard, plus the shard's exclusive count); the stride
        checks."""
        from ..errors import InvalidCsvFormat
        from ..offsetfree import prefix_for_packed
        from ..tape import NewLine
        from .sharded import _all_shards, _prefix

        self.mesh = mesh
        self.device = mesh.devices[0]
        self.header = header
        self.n_bytes = n_bytes
        self.shard_rows = shards[0].numel() // 512
        self.words = packed
        self.data = shards
        prefixes = [prefix_for_packed(p) for p in packed]
        counts = _all_shards([p[-1] for p in prefixes], mesh)
        excl = _prefix(counts)[0]
        self.cum_incl = torch.cat([
            (p + excl[k].to(p.device)).to(self.device)
            for k, p in enumerate(prefixes)])
        # each shard's count fits int32 (shards < 2 GiB); the total sums in
        # int64 on the host
        count = int(_host(counts).astype(np.int64).sum())
        if count >= 2**31:
            raise ValueError(
                "structural count >= 2^31: the replicated row prefix "
                "and slot math are int32 — split the corpus across "
                "files (corpus_api.CsvCorpus)"
            )
        jump = header.field_cnt + (
            1 if header.new_line is NewLine.CRLF else 0)
        record_cnt, rem = divmod(count, jump)
        if rem != 0:
            raise InvalidCsvFormat(
                f"non-uniform record stride: {count} structural entries "
                f"not divisible by jump {jump}"
            )
        self.jump = jump
        self.field_cnt = header.field_cnt
        self.record_cnt = record_cnt
        self.num_data_records = max(record_cnt - 1, 0)

    @classmethod
    def from_numpy_state(cls, words: np.ndarray, header, data,
                         mesh: Mesh) -> "ShardedPackedTape":
        """A tape from another tape's state as numpy, with no re-scan:
        packed sequential words of the whole input in either layout (for
        example the JAX ShardedPackedTape's `np.asarray(words)`), a
        Header-like object and the original bytes. The words are cut into
        this mesh's shards (the rows past the bytes hold no set bit)."""
        from ..errors import InvalidCsvFormat
        from ..offsetfree import _own_header

        _single_process(mesh)
        arr = as_u8(data)
        w = np.asarray(words, dtype=np.int32).reshape(-1, 16)
        if w.shape[0] * 512 < arr.size:
            raise InvalidCsvFormat(
                f"{w.shape[0]} packed rows cover fewer than {arr.size} bytes")
        rows = _mesh_rows(arr.size, mesh.size)
        full = np.zeros((rows, 16), np.int32)
        take = min(rows, w.shape[0])
        full[:take] = w[:take]
        shard_rows = rows // mesh.size
        packed = [torch.from_numpy(full[(mesh.first_shard + k) * shard_rows:
                                        (mesh.first_shard + k + 1)
                                        * shard_rows]).to(d).view(-1, 128)
                  for k, d in enumerate(mesh.devices)]
        self = cls.__new__(cls)
        self._index(packed, _upload_shards(arr, rows, mesh),
                    _own_header(header), arr.size, mesh)
        self.nonascii_count = None  # not recorded in the state
        return self

    def gather_fields(self, records, fields, max_len: int = 64):
        """Batched (record, field) -> (bytes (N, max_len) uint8, TRUE
        lengths (N,) int32, valid (N,) bool), on the first device."""
        return _serve_packed_sharded(
            self.data, self.words, self.cum_incl,
            as_int32(records, self.device), as_int32(fields, self.device),
            self.jump, self.field_cnt, self.record_cnt, self.shard_rows,
            max_len)

    def save(self, path) -> None:
        """Write the same packed_seq artifact as PackedDeviceTape.save:
        the narrow (rows, 16) words (the pad rows past the bytes are zero,
        harmless to either loader) and the JAX package's meta."""
        from ..artifact import _fingerprint
        from ..offsetfree import packed_seq_meta

        data_host = np.concatenate([_host(s) for s in self.data])
        meta = packed_seq_meta(self.header, self.n_bytes,
                               _fingerprint(data_host[: self.n_bytes]))
        np.savez_compressed(
            path,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            packed=np.concatenate([_host(w).reshape(-1, 16)
                                   for w in self.words]),
        )
