"""Tape serialization: build once, serve elsewhere.

The reference's design notes study xsv's `index create` writing u64
offsets to disk as the intended direction (notes.md:205-250); nothing was
built. Here the tape is a durable artifact with two interchangeable
encodings:

- "offsets": the structural index as int64, exactly the in-memory tape;
- "packed":  the stage-1 packed bitmask words (1 bit per input byte,
             ~8-50x smaller than offsets depending on density) plus the
             fold layout tile — offsets are re-extracted on load (native
             C++ decoder when available).

Both carry the header metadata needed to reconstruct a serving Tape
without re-scanning the CSV, and a content fingerprint so a stale index
is refused rather than silently mis-serving.

The port's own copy of csv_simd_tpu/artifact.py;
it imports nothing of that package.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from .errors import InvalidState, IoError
from .tape import Header, NewLine, Tape

_MAGIC = "csv-simd-tpu-index"
_VERSION = 1


def _fingerprint(data) -> str:
    """Full-content sha256 (plus length) of the data bytes. sha256 runs
    at ~GB/s — negligible next to the scan — and unlike a head/tail hash
    it catches mid-file edits, so a stale index is always refused."""
    h = hashlib.sha256()
    h.update(len(data).to_bytes(8, "little"))
    h.update(memoryview(data))
    return h.hexdigest()[:32]


def save_tape(tape: Tape, path: str | os.PathLike) -> None:
    """Write the offsets-encoded index artifact (.npz)."""
    h = tape.header
    meta = dict(
        magic=_MAGIC,
        version=_VERSION,
        encoding="offsets",
        names=h.names,
        new_line=h.new_line.value,
        field_cnt=h.field_cnt,
        delimiter=h.delimiter,
        record_offset=h.record_offset,
        fingerprint=_fingerprint(tape.data_bytes),
        n_bytes=len(tape.data_bytes),
    )
    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        index=np.asarray(tape.index, dtype=np.int64),
    )


def save_packed(
    packed: np.ndarray,
    tile: int,
    header: Header,
    data: bytes,
    path: str | os.PathLike,
) -> None:
    """Write the packed-bitmask-encoded artifact (.npz, 1 bit/byte)."""
    meta = dict(
        magic=_MAGIC,
        version=_VERSION,
        encoding="packed",
        names=header.names,
        new_line=header.new_line.value,
        field_cnt=header.field_cnt,
        delimiter=header.delimiter,
        record_offset=header.record_offset,
        fingerprint=_fingerprint(data),
        n_bytes=len(data),
        tile=tile,
    )
    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        packed=np.asarray(packed, dtype=np.int32),
    )


def _load_meta(z) -> dict:
    meta = json.loads(bytes(z["meta"]).decode())
    if meta.get("magic") != _MAGIC:
        raise InvalidState("not a csv-simd-tpu index artifact")
    if meta.get("version") != _VERSION:
        raise InvalidState(f"unsupported artifact version {meta.get('version')}")
    return meta


def load_tape(path: str | os.PathLike, data: bytes) -> Tape:
    """Reconstruct a serving Tape from an artifact + the original bytes.

    Raises InvalidState if the bytes don't match the artifact fingerprint
    (full-content sha256 since round 2 — artifacts written by older
    head/tail-hash builds are refused and must be re-indexed) — a stale
    index must not silently mis-serve.
    """
    try:
        z = np.load(path, allow_pickle=False)
    except OSError as e:
        # np.savez_compressed appends '.npz' to suffix-less paths, so a
        # round-trip with the same path string must look there too
        p = os.fspath(path)
        if not p.endswith(".npz") and os.path.exists(p + ".npz"):
            z = np.load(p + ".npz", allow_pickle=False)
        else:
            raise IoError(str(e)) from e
    meta = _load_meta(z)
    if meta["n_bytes"] != len(data) or meta["fingerprint"] != _fingerprint(data):
        raise InvalidState(
            "index artifact does not match these bytes (stale data, or an "
            "artifact from a pre-full-hash build — re-index to refresh)"
        )
    header = Header(
        names=list(meta["names"]),
        new_line=NewLine(meta["new_line"]),
        field_cnt=meta["field_cnt"],
        delimiter=meta["delimiter"],
        record_offset=meta["record_offset"],
    )
    if meta["encoding"] == "offsets":
        index = z["index"]
    elif meta["encoding"] == "packed_seq":
        # the offsets-free serving artifact (PackedDeviceTape.save) also
        # reconstructs a host Tape: sequential bit order decodes with a
        # single unpackbits + flatnonzero
        bits = np.unpackbits(
            np.ascontiguousarray(z["packed"]).view("<u4").view(np.uint8),
            bitorder="little",
        )[: len(data)]
        offs = np.flatnonzero(bits).astype(np.int64)
        index = np.concatenate([np.zeros(1, dtype=np.int64), offs])
    elif meta["encoding"] == "packed":
        packed = z["packed"]
        tile = meta["tile"]
        try:
            from . import native

            if native.available():
                offs = native.extract_offsets_v3(packed, tile, len(data))
            else:
                raise RuntimeError
        except Exception:
            from .ops.stage1_v3 import unpack_packed_host

            mask = unpack_packed_host(packed, len(data), tile=tile)
            offs = np.flatnonzero(mask).astype(np.int64)
        index = np.concatenate([np.zeros(1, dtype=np.int64), offs])
    else:
        raise InvalidState(f"unknown encoding {meta['encoding']!r}")
    return Tape(data, index, header)
