#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

    python3 chip_smoke.py        (from the repository root, no arguments)

Phases, each of which fails the run on any error:

0. the card (nvidia-smi name and power limit), torch and CUDA versions;
   exit 1 without a card;
1. build the CUDA kernels from csv_simd_tpu_torch/csrc with nvcc (one
   process per source, in parallel) and the native host extractor with
   g++;
2. hold each kernel against its plain PyTorch version on the card, bit
   for bit: the stage-1 build (B1) over the corpus and fuzz inputs, both
   carries, count_nonascii both ways and three dialects; the row prefix
   (B2) at many row counts in both layouts; B1 at 64 MiB against
   golden.structural_mask and golden.quote_parity_out; the other stage-1
   layouts (B3 fold at tiles 8, 64 and 512, B4 sequential, B5 v2, B6 v1)
   over the same inputs, carries and dialects, each unpacked with its
   own inverse and held against golden.structural_mask, B3 with a
   device-scalar carry too; at 64 MiB B3 against golden and against B1's
   words, with the carry chained on the card over four chunks;
3. the offsets-free path at 1 GiB (the wide-table configuration):
   create_packed on a 1 GiB CSV made of the data rows of one 64 MiB
   synthetic_wide_table block repeated after its header, a warm-up batch
   and three timed batches of 65,536 random (record, field) lookups, and
   the row-id column, all checked against the 64 MiB block's golden index
   shifted by whole blocks;
4. the offsets route on the same file: create(backend="cuda") (B3, the
   words back to the host, native extraction, Tape) with its index held
   entry for entry against the shifted golden index, 65,536 seek_field
   calls and column(0); DeviceTape.from_tape with a warm-up batch and
   three timed batches of lookups; create_streaming in 64 MiB chunks (B3
   once a chunk, the carry chained on the card); build_index_device on
   the block; and the entry points of B4, B5 and B6 on the block;
5. kernel and plain times on the card at the paths' shapes, and the
   parts of create at 1 GiB.

Each path runs with the launch counts set to 0 just before it and read
just after; a kernel of the path that was not launched fails the run.
It prints one JSON line with the kernels' launch counts (each from its
path's run), errors and times, and last the device line. It imports
nothing of JAX: the port's shared host modules (golden among them) are
loaded from their sources by csv_simd_tpu_torch._host.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BLOCK_BYTES = 64 << 20   # one synthetic_wide_table block
REPEATS = 16             # 16 blocks: the 1 GiB configuration
N_FIELDS = 16
BATCH = 65_536
BATCHES = 3
MAX_LEN = 64
DEVICE = torch.device("cuda", 0)

DIALECTS = ({}, dict(delimiter=0x3B, quote=0x27), dict(quote=0xA2))


def _card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card, by CUDA events over
    `reps` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


GATED = ("stage1_v4", "row_prefix", "stage1_fold", "stage1_seq",
         "stage1_v2", "stage1_v1")


class Gate:
    """Counts comparisons and keeps the largest absolute difference."""

    def __init__(self):
        self.max_abs_err = dict.fromkeys(GATED, 0)
        self.checks = dict.fromkeys(GATED, 0)

    def same(self, name: str, got: torch.Tensor, want: torch.Tensor,
             what: str) -> None:
        got, want = got.reshape(-1), want.reshape(-1)
        if got.shape != want.shape:
            raise AssertionError(f"{name} {what}: shape {tuple(got.shape)} "
                                 f"!= {tuple(want.shape)}")
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        self.max_abs_err[name] = max(self.max_abs_err[name], err)
        self.checks[name] += 1
        if err:
            bad = int((got != want).sum())
            raise AssertionError(f"{name} {what}: {bad} of {got.numel()} "
                                 f"words differ from the plain version")


def _unpack(packed: torch.Tensor, n: int) -> np.ndarray:
    host = packed.cpu().numpy().reshape(-1)
    return np.unpackbits(host.view("<u4").view(np.uint8),
                         bitorder="little")[:n]


def gate_stage1(gate: Gate, device, corpus_cases, golden) -> None:
    from csv_simd_tpu_torch import Dialect
    from csv_simd_tpu_torch.ops.stage1_v2 import pad_to_words
    from csv_simd_tpu_torch.ops.stage1_v4 import (
        _stage1_v4_plain,
        stage1_fused_v4,
    )

    def check(words: torch.Tensor, what: str, arr=None) -> None:
        flat = words.reshape(-1)
        for kw in DIALECTS:
            d = Dialect(**kw)
            for carry in (0, 1):
                for cn in (True, False):
                    tag = f"{what} {kw} carry={carry} count_nonascii={cn}"
                    got = stage1_fused_v4(words, carry, d, count_nonascii=cn,
                                          out_mode="wide_native"
                                          if words.shape[0] % 8 == 0
                                          else "narrow")
                    want = _stage1_v4_plain(flat, carry, d, cn)
                    torch.cuda.synchronize()
                    for g, w, part in zip(got, want,
                                          ("words", "parity", "nonascii")):
                        gate.same("stage1_v4", g, w, f"{tag} {part}")
                    if arr is not None:
                        mask = _unpack(got[0], arr.size)
                        want_mask = golden.structural_mask(arr, d, carry)
                        if not np.array_equal(mask, want_mask):
                            raise AssertionError(f"stage1_v4 {tag}: differs "
                                                 "from golden.structural_mask")

    for case in corpus_cases:
        arr = np.frombuffer(case.data, dtype=np.uint8)
        w = torch.from_numpy(pad_to_words(arr)).to(device)
        check(w, f"corpus {case.name}", arr)
    for what, arr in fuzz_arrays():
        w = torch.from_numpy(arr.view("<i4").reshape(-1, 128).copy())
        check(w.to(device), what, arr)


def fuzz_arrays() -> list:
    """(name, bytes) from under one 64 KiB chunk to many chunks, with a
    ragged last chunk: whole 512-byte rows of a CSV-ish alphabet."""
    alphabet = np.frombuffer(b'ab"",\n\rx,z":; \t\'\xc3\xa9\xa2\x8a', np.uint8)
    out = []
    for seed, rows in enumerate((1, 3, 100, 127, 128, 129, 1000, 4097,
                                 20_001)):
        rng = np.random.default_rng(seed)
        out.append((f"fuzz seed={seed} rows={rows}",
                    rng.choice(alphabet, size=rows * 512)))
    return out


def gate_prefix(gate: Gate, device) -> None:
    from csv_simd_tpu_torch.offsetfree import (
        _prefix_for_packed_xla,
        prefix_for_packed,
    )

    for rows in (1, 7, 8, 64, 100, 2047, 2048, 2049, 4096, 10_000,
                 65_544, 1 << 21):
        rng = np.random.default_rng(rows)
        words = torch.from_numpy(rng.integers(
            -2**31, 2**31, (rows, 16), dtype=np.int64).astype(np.int32))
        words = words.to(device)
        want = _prefix_for_packed_xla(words)
        gate.same("row_prefix", prefix_for_packed(words), want,
                  f"narrow rows={rows}")
        if rows % 8 == 0:
            gate.same("row_prefix", prefix_for_packed(words.view(-1, 128)),
                      want, f"wide rows={rows}")
    torch.cuda.synchronize()


def gate_stage1_block(gate: Gate, device, block: bytes, golden) -> None:
    """B1 at 64 MiB against golden (mask and parity out) and the plain
    version, with the non-ASCII count checked against numpy."""
    from csv_simd_tpu_torch.config import DEFAULT_DIALECT
    from csv_simd_tpu_torch.ops.stage1_v2 import pad_to_words
    from csv_simd_tpu_torch.ops.stage1_v4 import (
        _stage1_v4_plain,
        stage1_fused_v4,
    )

    arr = np.frombuffer(block, dtype=np.uint8)
    w = torch.from_numpy(pad_to_words(arr)).to(device)
    for carry in (0, 1):
        got = stage1_fused_v4(w.view(-1, 1024), carry, out_mode="wide_native")
        want = _stage1_v4_plain(w.view(-1), carry, DEFAULT_DIALECT, True)
        for g, x, part in zip(got, want, ("words", "parity", "nonascii")):
            gate.same("stage1_v4", g, x, f"64 MiB carry={carry} {part}")
        if not np.array_equal(_unpack(got[0], arr.size),
                              golden.structural_mask(arr, carry_in=carry)):
            raise AssertionError("stage1_v4 at 64 MiB differs from golden")
        if int(got[1]) != golden.quote_parity_out(arr, carry_in=carry):
            raise AssertionError("stage1_v4 parity out differs from golden")
        if int(got[2]) != int((arr >= 0x80).sum()):
            raise AssertionError("stage1_v4 non-ASCII count is wrong")


def _mask_of(name: str, words: torch.Tensor, n: int, tile: int = 0):
    """The structural mask of n bytes from a kernel's words, by the
    layout's own inverse."""
    from csv_simd_tpu_torch.ops.pack import unpack_words_host
    from csv_simd_tpu_torch.ops.stage1_v2 import unpack_words_v2_host
    from csv_simd_tpu_torch.ops.stage1_v3 import unpack_packed_host

    host = words.cpu().numpy()
    if name == "stage1_fold":
        return unpack_packed_host(host, n, tile=tile)
    if name == "stage1_v2":
        return unpack_words_v2_host(host, n)
    if name == "stage1_v1":
        return unpack_words_host(host, n)
    return _unpack(words, n)


def gate_pack(gate: Gate, device, arrays, golden) -> None:
    """B3 (fold, tiles 8/64/512), B4, B5 and B6 against their plain
    versions on the card and, unpacked, against golden.structural_mask:
    every input, three dialects, carries 0 and 1; B3 also with the carry
    as a 0-d tensor on the card."""
    from csv_simd_tpu_torch import Dialect
    from csv_simd_tpu_torch.index import pad_to_grid
    from csv_simd_tpu_torch.ops.stage1_pallas import (
        _stage1_pallas_plain,
        stage1_pallas,
    )
    from csv_simd_tpu_torch.ops.stage1_v2 import (
        pad_to_words,
        stage1_pallas_v2,
        stage1_swar_jnp,
    )
    from csv_simd_tpu_torch.ops.stage1_v3 import (
        stage1_fused,
        stage1_fused_seq,
        stage1_seq_xla,
        stage1_swar_xla,
    )

    for what, arr in arrays:
        w = torch.from_numpy(pad_to_words(arr, row_align=8)).to(device)
        b = torch.from_numpy(pad_to_grid(arr)).to(device)
        rows = w.shape[0]
        for kw in DIALECTS:
            d = Dialect(**kw)
            for carry in (0, 1):
                tag = f"{what} {kw} carry={carry}"
                want_mask = golden.structural_mask(arr, d, carry)
                want_par = golden.quote_parity_out(arr, d, carry)
                runs = []
                for tile in (8, 64, 512):
                    t = min(tile, rows)
                    runs.append(("stage1_fold", f"tile={t}", t,
                                 stage1_fused(w, carry, d, row_tile=t),
                                 stage1_swar_xla(w, carry, d, row_tile=t)))
                dev_carry = torch.tensor(carry, dtype=torch.int32,
                                         device=device)
                runs.append(("stage1_fold", "tile=512 device carry",
                             min(512, rows),
                             stage1_fused(w, dev_carry, d),
                             stage1_swar_xla(w, carry, d)))
                runs.append(("stage1_seq", "", 0,
                             stage1_fused_seq(w, carry, d, row_tile=8),
                             stage1_seq_xla(w, carry, d)))
                runs.append(("stage1_v2", "", 0,
                             stage1_pallas_v2(w, carry, d, row_tile=8),
                             stage1_swar_jnp(w, carry, d)))
                runs.append(("stage1_v1", "", 0,
                             stage1_pallas(b, carry, d, row_tile=32),
                             _stage1_pallas_plain(b, carry, d)))
                torch.cuda.synchronize()
                for name, note, tile, got, want in runs:
                    for i, (g, x) in enumerate(zip(got, want)):
                        gate.same(name, g, x, f"{tag} {note} output {i}")
                    mask = _mask_of(name, got[0], arr.size, tile)
                    if not np.array_equal(mask, want_mask):
                        raise AssertionError(f"{name} {tag} {note}: differs "
                                             "from golden.structural_mask")
                    if int(got[-1]) != want_par:
                        raise AssertionError(f"{name} {tag} {note}: parity "
                                             "differs from golden")
                    if name in ("stage1_v2", "stage1_v1") and \
                            int(got[1]) != int(want_mask.sum()):
                        raise AssertionError(f"{name} {tag}: count differs "
                                             "from golden")


def gate_pack_block(gate: Gate, device, block: bytes, golden) -> dict:
    """At 64 MiB: B3 against golden and against B1's words (two layouts
    of one mask), with the parity chained on the card over four chunks;
    returns the block's device inputs for the times."""
    from csv_simd_tpu_torch.config import DEFAULT_DIALECT
    from csv_simd_tpu_torch.index import pad_to_grid
    from csv_simd_tpu_torch.ops.stage1_v2 import pad_to_words
    from csv_simd_tpu_torch.ops.stage1_v3 import (
        stage1_fused,
        stage1_swar_xla,
        unpack_packed_host,
    )
    from csv_simd_tpu_torch.ops.stage1_v4 import stage1_fused_v4

    arr = np.frombuffer(block, dtype=np.uint8)
    w = torch.from_numpy(pad_to_words(arr)).to(device)
    want = golden.structural_mask(arr)
    fold, par = stage1_fused(w, 0)
    gate.same("stage1_fold", fold, stage1_swar_xla(w, 0)[0], "64 MiB words")
    if not np.array_equal(unpack_packed_host(fold.cpu().numpy(), arr.size),
                          want):
        raise AssertionError("stage1_fold at 64 MiB differs from golden")
    seq = stage1_fused_v4(w, 0, DEFAULT_DIALECT, count_nonascii=False)[0]
    if not np.array_equal(_unpack(seq, arr.size), want):
        raise AssertionError("stage1_v4 at 64 MiB differs from golden")
    if int(par) != golden.quote_parity_out(arr):
        raise AssertionError("stage1_fold parity out differs from golden")
    quarter = w.shape[0] // 4
    assert quarter % 512 == 0, quarter
    parity = torch.ones((), dtype=torch.int32, device=device)
    parts = []
    for i in range(4):
        packed, parity = stage1_fused(w[i * quarter:(i + 1) * quarter],
                                      parity)
        parts.append(packed)
    chained = stage1_swar_xla(w, 1)
    gate.same("stage1_fold", torch.cat(parts), chained[0],
              "64 MiB, carry 1 chained on the card over 4 chunks")
    gate.same("stage1_fold", parity, chained[1], "64 MiB chained parity")
    return {"words": w, "bytes": torch.from_numpy(pad_to_grid(arr)).to(
        device), "arr": arr, "mask": want}


def write_big_csv(block: bytes) -> tuple:
    """The 1 GiB file: the block's header, then its data rows REPEATS
    times. Cached in the temporary directory by size."""
    header_len = block.index(b"\n") + 1
    rows = block[header_len:]
    size = header_len + REPEATS * len(rows)
    path = os.path.join(tempfile.gettempdir(),
                        f"csv_simd_torch_smoke_{size}.csv")
    if not (os.path.exists(path) and os.path.getsize(path) == size):
        tmp = path + f".{os.getpid()}.part"
        with open(tmp, "wb") as f:
            f.write(block[:header_len])
            for _ in range(REPEATS):
                f.write(rows)
        os.replace(tmp, path)
    return path, len(rows)


def truth(index: np.ndarray, rows_len: int, per_block: int,
          recs: np.ndarray, flds: np.ndarray) -> tuple:
    """(start, end) byte ranges of (record, field) in the big file from
    the 64 MiB block's golden index: record r is record r % per_block
    of the block, shifted by r // per_block copies of the data rows."""
    local = recs % per_block
    shift = (recs // per_block).astype(np.int64) * rows_len
    slot = (local + 1) * N_FIELDS + flds
    return index[slot] + 1 + shift, index[slot + 1] + shift


def check_lookups(tape, data, index: np.ndarray, rows_len: int,
                  per_block: int, seed: int, device) -> float:
    """A warm-up batch and BATCHES timed batches of BATCH random (record,
    field) lookups through tape.gather_fields, every byte checked against
    the shifted golden index; returns lookups/s over the timed batches."""
    n_records = REPEATS * per_block
    rng = np.random.default_rng(seed)
    serve_s = 0.0
    quoted = 0
    # batch 0 warms up (the first launch of each torch kernel loads it);
    # every batch is checked, batches 1..BATCHES are timed
    for batch in range(BATCHES + 1):
        recs = rng.integers(0, n_records, BATCH).astype(np.int32)
        flds = rng.integers(0, N_FIELDS, BATCH).astype(np.int32)
        r_dev = torch.from_numpy(recs).to(device)
        f_dev = torch.from_numpy(flds).to(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, lengths, valid = tape.gather_fields(r_dev, f_dev, MAX_LEN)
        torch.cuda.synchronize()
        if batch:
            serve_s += time.perf_counter() - t0
        start, end = truth(index, rows_len, per_block, recs, flds)
        want_len = (end - start).astype(np.int32)
        if not bool(valid.all()):
            raise AssertionError(f"batch {batch}: valid queries refused")
        if not np.array_equal(lengths.cpu().numpy(), want_len):
            raise AssertionError(f"batch {batch}: field lengths differ")
        if want_len.max() > MAX_LEN:
            raise AssertionError("a field is longer than the gather window")
        grid = start[:, None] + np.arange(MAX_LEN)
        inside = grid < end[:, None]
        want = np.where(inside, data[np.minimum(grid, data.size - 1)], 0)
        if not np.array_equal(out.cpu().numpy(), want.astype(np.uint8)):
            raise AssertionError(f"batch {batch}: served bytes differ")
        sample = tape.to_host_lists(out[:64], lengths[:64], valid[:64])
        for i, got in enumerate(sample):
            if got != bytes(data[start[i]:end[i]]):
                raise AssertionError(f"batch {batch}: to_host_lists differs")
        quoted += int((out[:, 0] == 0x22).sum())
    if quoted == 0:
        raise AssertionError("no quoted field was served")
    return BATCHES * BATCH / serve_s


def run_main_path(path: str, device, index: np.ndarray, rows_len: int,
                  per_block: int) -> dict:
    """create_packed on the big file, lookups and the row-id column,
    each checked; returns the tape and the host-clock timings."""
    from csv_simd_tpu_torch import create_packed

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tape = create_packed(path, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_records = REPEATS * per_block
    if tape.num_data_records != n_records:
        raise AssertionError(f"num_data_records {tape.num_data_records} "
                             f"!= {n_records}")
    data = np.memmap(path, dtype=np.uint8, mode="r")
    lookups = check_lookups(tape, data, index, rows_len, per_block, 2024,
                            device)
    ids, ok = tape.column_int32(0)
    want_ids = np.tile(np.arange(per_block, dtype=np.int32), REPEATS)
    if not (bool(ok.all()) and np.array_equal(ids.cpu().numpy(), want_ids)):
        raise AssertionError("column_int32(0) differs from the row ids")
    return {"tape": tape, "build_s": build_s, "lookups_per_s": lookups}


def check_index(got: np.ndarray, index: np.ndarray, rows_len: int) -> None:
    """The big file's index, entry for entry: the block's sentinel and
    header entries, then its data entries shifted by each copy."""
    head = N_FIELDS + 1
    body = index[head:]
    if got.dtype != np.int64 or got.size != head + REPEATS * body.size:
        raise AssertionError(f"index has {got.size} {got.dtype} entries, "
                             f"want {head + REPEATS * body.size} int64")
    if not np.array_equal(got[:head], index[:head]):
        raise AssertionError("index header entries differ")
    for c in range(REPEATS):
        lo = head + c * body.size
        if not np.array_equal(got[lo:lo + body.size],
                              body + c * rows_len):
            raise AssertionError(f"index entries of copy {c} differ")


def run_offsets_route(path: str, device, index: np.ndarray, rows_len: int,
                      per_block: int) -> dict:
    """create(backend="cuda") on the big file with its index, record
    count, seek_field and column(0) checked."""
    from csv_simd_tpu_torch import create

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tape = create(path, backend="cuda", device=device)
    create_s = time.perf_counter() - t0
    check_index(tape.index, index, rows_len)
    n_records = REPEATS * per_block
    if tape.record_cnt != n_records + 1:
        raise AssertionError(f"record_cnt {tape.record_cnt} != "
                             f"{n_records + 1}")
    data = np.memmap(path, dtype=np.uint8, mode="r")
    rng = np.random.default_rng(77)
    recs = rng.integers(0, n_records, BATCH)
    flds = rng.integers(0, N_FIELDS, BATCH)
    start, end = truth(index, rows_len, per_block, recs, flds)
    for i in range(BATCH):
        if tape.seek_field(int(recs[i]), int(flds[i])) != \
                bytes(data[start[i]:end[i]]):
            raise AssertionError(f"seek_field({recs[i]}, {flds[i]}) differs")
    ids = np.array(tape.column(0)).astype(np.int64)
    if not np.array_equal(ids, np.tile(np.arange(per_block), REPEATS)):
        raise AssertionError("column(0) differs from the row ids")
    return {"tape": tape, "create_s": create_s}


def driven(fn, *args, **kw) -> tuple:
    """fn's result and the launch counts of its run alone."""
    from csv_simd_tpu_torch import _kernels

    _kernels.reset_launch_counts()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, _kernels.launch_counts()


def need(launches: dict, name: str, at_least: int, what: str) -> None:
    if launches[name] < at_least:
        raise AssertionError(f"{what}: kernel {name} launched "
                             f"{launches[name]} times, want >= {at_least}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "an NVIDIA card and torch built for CUDA", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import csv_simd_tpu_torch
    from csv_simd_tpu_torch import _kernels, golden, native
    from csv_simd_tpu_torch.config import DEFAULT_DIALECT
    from csv_simd_tpu_torch.index import (
        _to_host,
        _upload_words,
        extract_offsets_from_packed,
        stage1_words,
    )
    from csv_simd_tpu_torch.offsetfree import (
        _prefix_for_packed_xla,
        _to_device,
        prefix_for_packed,
    )
    from csv_simd_tpu_torch.ops.pack import unpack_words_host
    from csv_simd_tpu_torch.ops.stage1_pallas import (
        _stage1_pallas_plain,
        stage1_pallas,
    )
    from csv_simd_tpu_torch.ops.stage1_v2 import (
        ROW_BYTES,
        padded_rows,
        stage1_pallas_v2,
        stage1_swar_jnp,
    )
    from csv_simd_tpu_torch.ops.stage1_v3 import (
        stage1_fused,
        stage1_fused_seq,
        stage1_seq_xla,
        stage1_swar_xla,
    )
    from csv_simd_tpu_torch.ops.stage1_v4 import (
        _stage1_v4_plain,
        stage1_fused_v4,
    )
    from corpus import all_cases, synthetic_wide_table

    device = DEVICE
    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    info = _kernels.build(verbose=True)
    print(f"build: {info['seconds']:.3f} s -> "
          f"{os.path.relpath(info['path'], REPO)}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    t0 = time.perf_counter()
    extractor = "native" if native.available() else "numpy"
    print(f"host extractor: {extractor} ({time.perf_counter() - t0:.3f} s"
          f"{'' if extractor == 'native' else ': ' + str(native.build_error())})")

    gate = Gate()
    t0 = time.perf_counter()
    cases = all_cases()
    gate_stage1(gate, device, cases, golden)
    gate_prefix(gate, device)
    block = synthetic_wide_table(BLOCK_BYTES)
    gate_stage1_block(gate, device, block, golden)
    arrays = [(f"corpus {c.name}", np.frombuffer(c.data, dtype=np.uint8))
              for c in cases] + fuzz_arrays()
    gate_pack(gate, device, arrays, golden)
    blk = gate_pack_block(gate, device, block, golden)
    print("gate: " + ", ".join(f"{k} {v}" for k, v in gate.checks.items())
          + f" comparisons, all bit-identical "
          f"({time.perf_counter() - t0:.1f} s)")

    path, rows_len = write_big_csv(block)
    index = golden.structural_index(np.frombuffer(block, dtype=np.uint8))
    per_block = (index.size - 1) // N_FIELDS - 1
    size = os.path.getsize(path)
    print(f"paths: {size} bytes, {REPEATS * per_block} records")
    data = np.memmap(path, dtype=np.uint8, mode="r")

    # path 1: the offsets-free tape (B1 + B2)
    res, l_packed = driven(run_main_path, path, device, index, rows_len,
                           per_block)
    need(l_packed, "stage1_v4", 1, "create_packed")
    need(l_packed, "row_prefix", 1, "create_packed")
    print(f"create_packed: {res['build_s']:.4f} s "
          f"({size / res['build_s'] / 1e9:.3f} GB/s end to end, first call), "
          f"{BATCHES + 1}x{BATCH} lookups checked "
          f"({res['lookups_per_s']:.0f} lookups/s over {BATCHES} batches "
          f"after a warm-up batch), row ids checked; launches {l_packed}")
    packed = res.pop("tape").words

    # path 2: the offsets route (B3 + host extraction -> Tape)
    route, l_create = driven(run_offsets_route, path, device, index,
                             rows_len, per_block)
    need(l_create, "stage1_fold", 1, "create")
    tape = route["tape"]
    print(f"create: {route['create_s']:.4f} s first call "
          f"({size / route['create_s'] / 1e9:.3f} GB/s), index of "
          f"{tape.index.size} entries held entry for entry, "
          f"{BATCH} seek_field and column(0) checked; launches {l_create}")
    t0 = time.perf_counter()
    dtape = csv_simd_tpu_torch.DeviceTape.from_tape(tape, device=device)
    torch.cuda.synchronize()
    upload_dt_s = time.perf_counter() - t0
    dt_lookups = check_lookups(dtape, data, index, rows_len, per_block,
                               4048, device)
    del dtape
    print(f"DeviceTape: from_tape {upload_dt_s:.4f} s, {BATCHES + 1}x{BATCH} "
          f"lookups checked ({dt_lookups:.0f} lookups/s over {BATCHES} "
          f"batches after a warm-up batch)")

    def streaming():
        t0 = time.perf_counter()
        got = csv_simd_tpu_torch.create_streaming(
            path, backend="cuda", chunk_bytes=BLOCK_BYTES, device=device)
        return got, time.perf_counter() - t0

    (streamed, stream_s), l_stream = driven(streaming)
    n_chunks = -(-size // BLOCK_BYTES)
    need(l_stream, "stage1_fold", n_chunks, "create_streaming")
    if not np.array_equal(streamed.index, tape.index):
        raise AssertionError("create_streaming index differs from create's")
    del streamed
    print(f"create_streaming: {stream_s:.4f} s in {n_chunks} chunks of "
          f"{BLOCK_BYTES} bytes, index equal to create's; "
          f"launches {l_stream}")

    offs, count = csv_simd_tpu_torch.build_index_device(block, device=device)
    if count != index.size - 1 or not np.array_equal(offs.cpu().numpy(),
                                                     index):
        raise AssertionError("build_index_device differs from golden")
    del offs
    print(f"build_index_device: 64 MiB block, {count} offsets equal to "
          "golden")

    # paths 3-5: the entry points of B4, B5 and B6 on the 64 MiB block
    arr, want_mask = blk["arr"], blk["mask"]
    (seq, _), l_seq = driven(stage1_fused_seq, blk["words"], 0)
    need(l_seq, "stage1_v4", 1, "stage1_fused_seq")
    gate.same("stage1_seq", seq, stage1_seq_xla(blk["words"], 0)[0],
              "64 MiB words")
    if not np.array_equal(_unpack(seq, arr.size), want_mask):
        raise AssertionError("stage1_fused_seq at 64 MiB differs from golden")
    (v2, v2_count, _), l_v2 = driven(stage1_pallas_v2, blk["words"], 0)
    need(l_v2, "stage1_v2", 1, "stage1_pallas_v2")
    gate.same("stage1_v2", v2, stage1_swar_jnp(blk["words"], 0)[0],
              "64 MiB words")
    if not np.array_equal(_mask_of("stage1_v2", v2, arr.size), want_mask) \
            or int(v2_count) != int(want_mask.sum()):
        raise AssertionError("stage1_pallas_v2 at 64 MiB differs from golden")
    (v1_words, v1_n, _), l_v1 = driven(stage1_words, block, backend="cuda",
                                       device=device)
    need(l_v1, "stage1_v1", 1, "stage1_words")
    if not np.array_equal(unpack_words_host(v1_words, v1_n), want_mask):
        raise AssertionError("stage1_words at 64 MiB differs from golden")
    gate.same("stage1_v1", torch.from_numpy(v1_words).to(device),
              _stage1_pallas_plain(blk["bytes"], 0, DEFAULT_DIALECT)[0],
              "64 MiB words")
    print(f"entry points at 64 MiB: stage1_fused_seq {l_seq}, "
          f"stage1_pallas_v2 {l_v2}, stage1_words {l_v1}; all equal to "
          "golden and to the plain versions")

    # times at the paths' shapes: the 1 GiB padded input and its words
    # for B1, B2 and B3; the 64 MiB block for B4, B5 and B6. Kernel and
    # plain are compared on the same inputs.
    del tape
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    words = _to_device(data, padded_rows(size) * ROW_BYTES,
                       device).view(torch.int32)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    d = DEFAULT_DIALECT
    got = stage1_fused_v4(words.view(-1, 1024), 0, d, count_nonascii=False,
                          out_mode="wide_native")
    want = _stage1_v4_plain(words, 0, d, False)
    gate.same("stage1_v4", got[0], want[0], "1 GiB words")
    gate.same("stage1_v4", got[0], packed, "1 GiB words vs the tape's")
    gate.same("stage1_v4", got[1], want[1], "1 GiB parity")
    del got, want
    gate.same("row_prefix", prefix_for_packed(packed),
              _prefix_for_packed_xla(packed), "1 GiB rows")
    w2d = words.view(-1, 128)
    got = stage1_fused(w2d, 0)
    want = stage1_swar_xla(w2d, 0)
    gate.same("stage1_fold", got[0], want[0], "1 GiB words")
    gate.same("stage1_fold", got[1], want[1], "1 GiB parity")
    del got, want
    ms = {}
    ms["stage1_v4"] = _cuda_ms(lambda: stage1_fused_v4(
        words.view(-1, 1024), 0, d, count_nonascii=False,
        out_mode="wide_native"), 20)
    ms["stage1_v4_plain"] = _cuda_ms(
        lambda: _stage1_v4_plain(words, 0, d, False), 3)
    ms["row_prefix"] = _cuda_ms(lambda: prefix_for_packed(packed), 50)
    ms["row_prefix_plain"] = _cuda_ms(
        lambda: _prefix_for_packed_xla(packed), 10)
    ms["stage1_fold"] = _cuda_ms(lambda: stage1_fused(w2d, 0), 20)
    ms["stage1_fold_plain"] = _cuda_ms(lambda: stage1_swar_xla(w2d, 0), 3)
    bw, bb = blk["words"], blk["bytes"]
    ms["stage1_seq"] = _cuda_ms(lambda: stage1_fused_seq(bw, 0), 20)
    ms["stage1_seq_plain"] = _cuda_ms(lambda: stage1_seq_xla(bw, 0), 5)
    ms["stage1_v2"] = _cuda_ms(lambda: stage1_pallas_v2(bw, 0), 20)
    ms["stage1_v2_plain"] = _cuda_ms(lambda: stage1_swar_jnp(bw, 0), 5)
    ms["stage1_v1"] = _cuda_ms(lambda: stage1_pallas(bb, 0), 20)
    ms["stage1_v1_plain"] = _cuda_ms(
        lambda: _stage1_pallas_plain(bb, 0, d), 5)
    del words, w2d
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    csv_simd_tpu_torch.create_packed(path, device=device)
    torch.cuda.synchronize()
    warm_packed_s = time.perf_counter() - t0

    # create at 1 GiB, warm, whole and in its parts (the steps of
    # index.build_index and api.create, each ended by a sync)
    t0 = time.perf_counter()
    warm = csv_simd_tpu_torch.create(path, backend="cuda", device=device)
    warm_create_s = time.perf_counter() - t0
    del warm
    parts = {}
    t0 = time.perf_counter()
    mapped = np.memmap(path, dtype=np.uint8, mode="r")
    w2d = _upload_words(mapped, device)
    torch.cuda.synchronize()
    parts["upload"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fold, _ = stage1_fused(w2d, 0)
    torch.cuda.synchronize()
    parts["B3"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = _to_host(fold)
    parts["words to host"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    offsets = extract_offsets_from_packed(host, 512, size)
    parts[f"extract ({extractor})"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = np.concatenate([np.zeros(1, dtype=np.int64), offsets])
    header = csv_simd_tpu_torch.Header.parse(mapped)
    split_tape = csv_simd_tpu_torch.Tape(mapped, idx, header)
    parts["index + Header + Tape"] = time.perf_counter() - t0
    check_index(split_tape.index, index, rows_len)
    del w2d, fold, host, offsets, idx, split_tape

    gb = padded_rows(size) * ROW_BYTES / 1e9
    print(f"times on {card}:")
    for name in ("stage1_v4", "row_prefix", "stage1_fold", "stage1_seq",
                 "stage1_v2", "stage1_v1"):
        at = "1 GiB" if name in ("stage1_v4", "row_prefix",
                                 "stage1_fold") else "64 MiB"
        print(f"  {name} at {at}: kernel {ms[name]:.4f} ms, plain "
              f"{ms[name + '_plain']:.4f} ms")
    print(f"  stage1_fold at 1 GiB: {gb / ms['stage1_fold'] * 1e3:.1f} GB/s "
          f"of padded input; stage1_v4: "
          f"{gb / ms['stage1_v4'] * 1e3:.1f} GB/s")
    print(f"  create_packed warm {warm_packed_s:.4f} s "
          f"({size / warm_packed_s / 1e9:.3f} GB/s), host pad and upload "
          f"{upload_s:.4f} s")
    print(f"  create first {route['create_s']:.4f} s, warm "
          f"{warm_create_s:.4f} s ({size / warm_create_s / 1e9:.3f} GB/s); "
          "warm parts: " + ", ".join(f"{k} {v:.4f} s"
                                     for k, v in parts.items()))
    print(f"  create_streaming {stream_s:.4f} s "
          f"({size / stream_s / 1e9:.3f} GB/s); DeviceTape "
          f"{dt_lookups:.0f} lookups/s; PackedDeviceTape "
          f"{res['lookups_per_s']:.0f} lookups/s")

    if any(sys.modules.get(m) is not None for m in ("jax", "csv_simd_tpu")):
        raise AssertionError("the port imported JAX or the JAX package")
    src = "csv_simd_tpu_torch/csrc/"
    table = (
        ("stage1_fused_v4", "cuda", "stage1_v4.cu",
         "csv_simd_tpu/ops/stage1_v4.py:147", "stage1_v4", l_packed,
         "stage1_v4"),
        ("prefix_for_packed", "cuda", "prefix.cu",
         "csv_simd_tpu/offsetfree.py:107", "row_prefix", l_packed,
         "row_prefix"),
        ("stage1_fused", "cuda", "stage1_pack.cu",
         "csv_simd_tpu/ops/stage1_v3.py:106", "stage1_fold", l_create,
         "stage1_fold"),
        ("stage1_fused_seq", "cuda via stage1_v4", "stage1_v4.cu",
         "csv_simd_tpu/ops/stage1_v3.py:238", "stage1_v4", l_seq,
         "stage1_seq"),
        ("stage1_pallas_v2", "cuda", "stage1_pack.cu",
         "csv_simd_tpu/ops/stage1_v2.py:66", "stage1_v2", l_v2,
         "stage1_v2"),
        ("stage1_pallas", "cuda", "stage1_pack.cu",
         "csv_simd_tpu/ops/stage1_pallas.py:73", "stage1_v1", l_v1,
         "stage1_v1"),
    )
    kernels = [
        {"name": name, "route": route_, "source": src + source,
         "replaces": replaces, "launches": launches[counter],
         "max_abs_err": gate.max_abs_err[gated], "ms": ms[gated],
         "plain_ms": ms[gated + "_plain"]}
        for name, route_, source, replaces, counter, launches, gated
        in table
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
