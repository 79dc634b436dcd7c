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
   golden.structural_mask and golden.quote_parity_out, and (one quote
   open from its first chunk to its last) launched three times in a row
   and replayed three times from one captured CUDA graph; the other stage-1
   layouts (B3 fold at tiles 8, 64 and 512, B4 sequential, B5 v2, B6 v1)
   over the same inputs, carries and dialects, each unpacked with its
   own inverse and held against golden.structural_mask, B3 with a
   device-scalar carry too; the relayouts that make B3 and B6 of B1's
   words (fold_words at tiles 8 to 16,384, v1_words with its count from
   several words on) on full-range words, and B3 at tiles 2,048, 3,200
   and 16,384 with one quote open across a 64 KiB chunk of B1's one pass
   and a fold tile, against golden too; at 64 MiB B3 against golden and
   against B1's words, with the carry chained on the card over four
   chunks; B1n's
   row counts and prefix (narrow, and the prefix wide) over the corpus
   and fuzz inputs; each probe kernel (stream, ALU, ablation) with its
   side words against its plain version at several sizes; and the
   stage-1 labs: B1's stage cuts (ablate2: every cut, carries 0, 1 and
   a device 1, tiles 8, 64 and 512, v4full against B1's narrow words),
   the v1-layout variants (kbench: words and last-tile count, full
   against B6), the stage ablation (ablate: every mode, words and side
   words, at tiles 8 to 8,192, carries 0, 1 and a device 1) and the
   direct fold pack (vnext: against its plain version and B3 at tiles 8
   to 8,192, and at 64 MiB against golden); the wide-store probes
   (widestore_probe2: the strided gather and the mmL pack product;
   widestore_probe3: the lane-window sum and the mmLb product, one
   product kernel for both) at 8 to 8,000 rows, on full-range int32 with
   both probes' weights and random int8 weights, and the four TPU probes
   on their own inputs, each printed as `probe[name]: BIT-EXACT`; the
   Mosaic probes' six kernels (mosaic_probes: the (T,32) pack product for
   both matmul probes, the int8 lane gather, cmp8, select8, the row
   shift-add and the uint32 sum) at 8 to 8,000 rows on full-range inputs
   (the product also on |v| <= 256, the gather also on indices outside
   [0, 128)) and the TPU tool's eight probe lines, each `fixed`; the
   tensor-core concat product (widestore_probe4) at M = 1 to 4,097 with
   the probe's, random and all -128 int8 weights, and its
   `probe[concat1024+mm]: BIT-EXACT`; both int8 products (one kernel
   template: the OR of block products and the concat sum) at M = 1, 15,
   16, 17, 1,000 and 4,097 with five weight sets, among them all -128 and
   blocks that reach the same columns (their OR is not their sum);
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
5. kernel and plain times on the card at the paths' shapes (B3 and B6 at
   64 MiB also from CUDA graphs, beside their eager times; B5 from CUDA
   graphs at 64 MiB and 1 GiB, beside its eager times), and the parts of
   create at 1 GiB;
6. the measurement path (csv_simd_tpu_torch.tools, each tool's run as
   `python -m csv_simd_tpu_torch.tools.<name>` runs it, after its gate in
   phase 2, and after its check, which holds every kernel it then times
   against the plain version on the timed input): the fused-prefix A/B
   of B1n (scan, build = B1 + B2, buildf) at 64 MiB and 1 GiB, with
   buildf's prefix held against B2's at 1 GiB; the memory-stream probe
   in every mode and the stage ablation at 64 MiB and 1 GiB; the int32
   ALU rate per mix at 64 MiB; B1's and B3's GB/s against the stream
   probe's wide ceiling; and the labs at 64 MiB and 1 GiB: B1's stage
   cuts beside B1, B3 and B4 (ablate2), the v1-layout variants beside B6
   (kbench, on the same random words as bytes) and the direct fold pack
   beside B3 (vnext, at tiles 128 and 512: at 128 it is written from B1's
   one pass, at 512 it is B3's pair); the wide-store probes at 64 MiB and
   1 GiB: the
   gather and mmL on the (rows, 128) words, the lane sum and mmLb on
   their (rows/8, 1024) view, and the concat product on that view; the
   Mosaic probes' kernels on 64 MiB of their first input. Probe kernels
   are timed from CUDA graphs
   (the kernels alone) and from eager launches; one PyTorch call that
   computes a probe's function is timed beside it where there is one;
7. a torch.profiler trace (utils.profiling.device_trace) of a warm
   create_packed and a warm create at 1 GiB: the five device ops that
   took the most time and the device-busy share of the traced window.
   The trace must name B1's one pass (`mask_pack`, at least twice: B3
   runs it too) and B3's relayout (`fold_words`). A second
   trace gives each probe and lab kernel's device time a launch at 64 MiB
   (the wide-store kernels and B5 among them), with B1's one pass
   (`mask_pack`) beside the v4full cut's (`ablate2_v4full`) and B5's
   (`v2_pack`); it must name the Mosaic
   probes' kernels, `ablate2_v4full`, `v1_words`, `v2_pack`, both int8
   products, `concat_mm<true, false>` (the concat sum) and
   `concat_mm<false, true>` (the OR of block products), and the one-pass
   kernels of the stage ablation and the direct fold pack at tiles 128
   and 512 (`ablate_pass`, `vnext_pack`, and at 512 `mask_pack` and
   `fold_words`). Neither trace may name a kernel of the two-pass carry
   (`chunk_parity`, `chunk_carry_scan`, `pack_v2`, `row_parity`): no
   kernel of the port reads its input twice.
8. the UTF-8 and typed-column path, after the traces, so that the other
   paths run in the state they would have without it: the validator kernel
   (csrc/utf8.cu) against its plain version on edge cases, every length
   1-600, bad bytes around its chunk, warp, block and grid-step edges,
   64 MiB of CJK text and 64 MiB of the non-ASCII table (the 1 GiB table
   with every `text` made `éxt`, the same bytes long);
   create_packed(validate_utf8=True) on that table (one validator
   launch, lookups checked) and on the ASCII one (none); an injected
   0xFF and a cut sequence before a newline each refused, their counts
   equal to the plain version's on 64 MiB windows; on the 1 GiB tape
   column_decimal64 and column_float32_exp of field 1 against the host's
   parse, filter_equals of a row id (one hit a copy) and gather_decoded
   of field 3 against decode_field; column_decoded on the 64 MiB block
   against DecodedView; dates and datetimes on a seeded 64 MiB table;
   then the validator's times (64 MiB and 1 GiB of the non-ASCII table,
   1 GiB of the ASCII table and of CJK text, its plain version at 64
   MiB), the warm builds with and without it, and each column's warm
   time.
9. the relational layer, after phase 8: column_stats (int exact,
   a float spec within rtol 1e-5 of the host's float64 sum),
   column_quantiles, describe, select_records (an int compare and a
   LIKE), order_records both ways, groupby_typed and group_aggregate on
   the row id, join_records and join_typed of the 1 GiB table with its
   64 MiB block, each on the create_packed tape (B1 + B2) and on the
   create + DeviceTape tape (B3), and held against the truth from the
   block's golden fields, tiled; each run once under a dispatch watch
   that fails if a step left a large tensor on the CPU; value_counts,
   distinct and groupby_typed on the text field f3 and the
   read_typed -> write_csv -> read_typed round trip on the block; a
   CsvCorpus of 16 files of the block (column_stats, column_quantiles by
   the rank bisection, order_records through the corpus tape); each
   operation's warm median of 3; a torch.profiler trace of a warm
   groupby_typed and order_records (busy share, top device ops).
10. SQL (sql, window, setops), last, after phase 9: the same statement
   on each table built from the files by sql itself (engine="packed":
   B1 + B2; engine="offsets": B3), then twelve statements over the 1 GiB
   table on the create_packed tape and on the create + DeviceTape tape,
   with the 64 MiB block as the second table: windows over 16-row
   partitions (ROW_NUMBER, SUM, AVG, COUNT, and SUM of f5 read as
   float32, the double-f32 scan) and over the whole table's sort (RANK
   and LAG by f2 DESC, f0; MIN over ROWS 3 PRECEDING AND 3 FOLLOWING,
   the sparse table), UNION, INTERSECT and EXCEPT with the block, a
   GROUP BY with HAVING, ORDER BY and LIMIT, a JOIN whose WHERE and
   GROUP BY push down to each side, an IN subquery and two EXPLAIN
   ANALYZE (their text names the sql.window and sql.setop spans); each
   once under the dispatch watch with the window and set-operation
   executors spied (every call must return a device result, never fall
   to the host executor), held against the truth from the block's golden
   fields, tiled, then its warm median of 3 (an EXPLAIN ANALYZE prints
   the time of its checked run instead); a window over the text
   field f3 on the block; a torch.profiler trace of the four window
   statements.
11. sharding (parallel.sharded, parallel.serving and the sharded
   streaming build), last, after phase 10, every mesh on the one card
   (make_mesh(n, device="cuda")): the shard-parity kernel S1
   (csrc/shard_parity.cu) against its plain version on the corpus,
   random bytes at quote densities 0, 1/64 and 1/2 on shards of 8 to
   4,104 rows, one quote around its block and grid-step edges, the 64
   MiB block, the 1 GiB table and each shard of the 2.5 GiB table;
   sharded_stage1 on the 64 MiB block at 1, 2, 3, 4, 5 and 8 shards in
   the fold, seq and seq_wide layouts (S1 once a shard), equal to one
   device's B3 and B1 words and to golden, on the JAX test's 60 KB
   quoted span across every shard cut, and on the 1 GiB table with a
   quote open across each cut of 4 shards; build_index_sharded and the
   sharded streaming build (64 MiB chunks) of the 1 GiB table at 4
   shards, entry for entry; ShardedTape.from_tape of the create tape and
   ShardedPackedTape of the 1 GiB table with the lookups checked, the
   latter's words equal to create_packed's, its row prefix to B2's, its
   saved artifact loaded by PackedDeviceTape.load; then the headline, a
   ShardedPackedTape of a 2.5 GiB table (the block's header and its data
   rows 40 times, in host memory) on 4 shards: S1, B1 and B2 once a
   shard, lookups (a batch of records past byte 2^31 among them),
   column_int32 of f0 over all 14.7 M rows, column_stats, groupby_typed
   and a SQL GROUP BY, each once under the dispatch watch and held
   against the block's truth tiled 40 times; S1's times (64 MiB from a
   CUDA graph and eager, 1 GiB by events, beside its plain version and
   one library call), the sharded builds' warm times beside
   create_packed's and create's index, lookups/s of both sharded tapes,
   and a torch.profiler trace of a warm 2.5 GiB build.

Each path runs with the launch counts set to 0 just before it and read
just after; a kernel of the path that was not launched fails the run.
It prints one JSON line with the kernels' launch counts (each from its
path's run), errors, times and bounds, and last the device line. It
imports nothing of JAX and nothing of csv_simd_tpu: the port keeps its
own copies of the host modules (golden among them), and g++ builds its
native extractor under csv_simd_tpu_torch/_build/.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
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

# the card's peaks for the bound (NVIDIA's H100 SXM data sheet): HBM
# bytes/s, and 32-bit operations/s outside the tensor cores (67 TFLOP/s
# of float32 counts an FMA as two: 33.5 T instructions/s; int32 adds,
# logic and shifts issue on the same lanes)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
# dense int8 on the tensor cores (the same data sheet), for the pack
# products' multiply-adds, two operations each
INT8_TC_OPS_PER_S = 1.979e15
# aten ops that move or make data without computing on it
_FREE_OPS = {"view", "_unsafe_view", "slice", "select", "expand", "reshape",
             "clone", "copy_", "cat", "empty", "zeros", "ones", "full",
             "arange", "_to_copy", "lift_fresh", "detach", "alias",
             "unsqueeze", "squeeze", "t", "transpose", "permute",
             "new_zeros", "zeros_like", "empty_like", "scalar_tensor",
             "_local_scalar_dense", "as_strided", "index", "stack",
             "constant_pad_nd", "fill_", "zero_", "new_empty", "split",
             "unbind", "contiguous"}


GATED = ("stage1_v4", "row_prefix", "stage1_fold", "stage1_seq",
         "stage1_v2", "stage1_v1", "stage1_v4_emit", "dma_probe",
         "dma_probe2.write", "dma_probe2.read", "vpu_roofline", "ablate",
         "ablate2", "kbench", "vnext", "widestore_probe2.s8_st16",
         "widestore_probe2.mmL", "widestore_probe3.laneload",
         "widestore_probe3.mmLb", "mosaic_probes.matmul32_slice",
         "mosaic_probes.matmul32_roll", "mosaic_probes.int8_lane_gather",
         "mosaic_probes.cmp8", "mosaic_probes.select8",
         "mosaic_probes.sublane_concat", "mosaic_probes.unsigned_reduce",
         "widestore_probe4.concat_mm", "utf8_errs", "quote_parity")
# the gather reads 64 of each input row's 512 bytes; a pack product's
# work is its multiply-adds, which its plain version's op count misses
READS_AN_EIGHTH = ("widestore_probe2.s8_st16",)
PRODUCTS = ("widestore_probe2.mmL", "widestore_probe3.mmLb",
            "widestore_probe4.concat_mm")
# the Mosaic probes' line in tools/mosaic_probes.py and its port function
MOSAIC_LINES = {"matmul32_slice": 100, "matmul32_roll": 113,
                "int8_lane_gather": 127, "cmp8": 139, "select8": 149,
                "sublane_concat": 160, "unsigned_reduce": 172}


class Gate:
    """Counts comparisons and keeps the largest absolute difference."""

    def __init__(self):
        self.max_abs_err = dict.fromkeys(GATED, 0)
        self.checks = dict.fromkeys(GATED, 0)

    def same(self, name: str, got: torch.Tensor, want: torch.Tensor,
             what: str) -> None:
        """Raise unless got equals want exactly (tools._common.same)."""
        from csv_simd_tpu_torch.tools._common import same

        self.record(name, {"checks": 1,
                           "max_abs_err": same(got, want, f"{name} {what}")})

    def record(self, name: str, result: dict) -> None:
        """A tool's own gate result ({checks, max_abs_err}; it raised on
        any difference)."""
        self.max_abs_err[name] = max(self.max_abs_err[name],
                                     result["max_abs_err"])
        self.checks[name] += result["checks"]


def plain_work(fn) -> tuple:
    """(operations, output bytes) of one call of fn, a plain version on
    CPU tensors: every aten op it runs that computes counts the largest
    element count among its tensor inputs and outputs."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ not in _FREE_OPS:
                Count.ops += max((x.numel() for x in tree_leaves((args, out))
                                  if isinstance(x, torch.Tensor)), default=0)
            return out

    with Count():
        out = fn()
    out_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(out)
                    if isinstance(x, torch.Tensor))
    return Count.ops, out_bytes


def bounds(timed: dict, hi_ops: int) -> dict:
    """{kernel: (bound ms, "bytes" or "operations", bytes moved,
    operations, their peak rate)} for the inputs each
    kernel was timed on ({kernel: input bytes}): the operations and the
    output bytes of its plain version, counted on a 256 KiB CPU input
    (the Mosaic probes' on a 1/256 sample of their timed inputs: 256 KiB
    of their first input) and scaled by input size (each grows with it),
    the inputs read once
    and the output written once, against the card's peaks. B6's and the
    v1 variants' plain versions compute on one byte an int32, and B5's
    SWAR plain version overstates the work with its cumsums; their
    operations are counted on B1's plain version (four bytes an int32)
    over the same bytes, the same mask in fewer operations
    ("stage1_v2_swar" keeps B5's count on its own plain version).
    Two cases count what the function needs instead: the wide-store
    gather reads 1/8 of its input (lanes 0-15 of each row), and a pack
    product does a multiply-add (two operations, on the int8 tensor
    cores) for each int32 of x and each of W's 128 columns, and reads W,
    where `plain_work` would charge one operation an output element (the
    concat product's as much: it sums where the others OR)."""
    from csv_simd_tpu_torch.config import DEFAULT_DIALECT as d
    from csv_simd_tpu_torch.offsetfree import _prefix_for_packed_xla
    from csv_simd_tpu_torch.ops.stage1_pallas import _stage1_pallas_plain
    from csv_simd_tpu_torch.ops.stage1_v2 import stage1_swar_jnp
    from csv_simd_tpu_torch.ops.stage1_v3 import (
        stage1_seq_xla,
        stage1_swar_xla,
    )
    from csv_simd_tpu_torch.ops.stage1_v4 import (
        _row_emits_plain,
        _stage1_v4_plain,
    )
    from csv_simd_tpu_torch.tools import (
        ablate,
        ablate2,
        dma_probe,
        kbench,
        mosaic_probes,
        vnext,
        vpu_roofline,
        widestore_probe2,
        widestore_probe3,
        widestore_probe4,
    )
    from csv_simd_tpu_torch.tools._common import csv_words

    w = csv_words(512, "cpu", 5)
    wide = w.view(-1, 1024)
    w_l, w_lb = widestore_probe2.weights_mmL(), widestore_probe3.weights_mmLb()
    b = w.view(torch.uint8).view(-1, 128)
    packed = _stage1_v4_plain(w.view(-1), 0, d, False)[0]

    def b1n():
        words = _stage1_v4_plain(w.view(-1), 0, d, False)[0]
        return (words,) + _row_emits_plain(words)

    plain = {
        "stage1_v4": (w, lambda: _stage1_v4_plain(w.view(-1), 0, d, False)),
        "row_prefix": (packed, lambda: _prefix_for_packed_xla(packed)),
        "stage1_fold": (w, lambda: stage1_swar_xla(w, 0)),
        "stage1_seq": (w, lambda: stage1_seq_xla(w, 0)),
        "stage1_v2": (w, lambda: stage1_swar_jnp(w, 0)),
        "stage1_v2_swar": (w, lambda: stage1_swar_jnp(w, 0)),
        "stage1_v1": (b, lambda: _stage1_pallas_plain(b, 0, d)),
        "stage1_v4_emit": (w, b1n),
        "dma_probe": (w, lambda: dma_probe._write_plain(w, "narrow", 1)),
        "dma_probe2.write": (w, lambda: dma_probe._write_plain(w, "tall8",
                                                               1)),
        "dma_probe2.read": (w, lambda: dma_probe._read_plain(w, 1)),
        "vpu_roofline": (w, lambda: vpu_roofline._probe_plain(w, hi_ops,
                                                              "alu", 1)),
        "ablate": (w, lambda: ablate._ablate_plain(w, "full", 512, 1)),
        "ablate2": (w, lambda: ablate2.plain(w, "v4full", 512, 1)),
        "kbench": (b, lambda: kbench._variant_plain(b, "roll", 1024, 1)),
        "vnext": (w, lambda: vnext._vnext_plain(w, 128, 1, True)),
        "widestore_probe2.s8_st16": (w, lambda: widestore_probe2._gather_plain(
            w)),
        "widestore_probe2.mmL": (w, lambda: widestore_probe2._packmm_plain(
            wide, w_l)),
        "widestore_probe3.laneload": (
            w, lambda: widestore_probe3._lanesum_plain(wide)),
        "widestore_probe3.mmLb": (w, lambda: widestore_probe2._packmm_plain(
            wide, w_lb)),
        "widestore_probe4.concat_mm": (
            w, lambda: widestore_probe4._concat_mm_plain(wide, w_lb)),
    }
    sample = mosaic_probes.timed_inputs("cpu", scale=256)
    for probe, kernel in mosaic_probes.PROBE_KERNEL.items():
        plain[f"mosaic_probes.{probe}"] = (
            sample[kernel], lambda k=kernel: mosaic_probes.PLAIN[k](
                *sample[k]))
    swar_ops = plain_work(plain["stage1_v4"][1])[0]
    out = {}
    for name, n_in in timed.items():
        x, fn = plain[name]
        ops, out_bytes = plain_work(fn)
        if name in ("stage1_v1", "kbench", "stage1_v2"):
            ops = swar_ops
        scale = n_in / sum(t.numel() * t.element_size() for t in
                           (x if isinstance(x, tuple) else (x,)))
        read = n_in / 8 if name in READS_AN_EIGHTH else n_in
        moved = read + out_bytes * scale
        ops, rate = ops * scale, INT32_OPS_PER_S
        if name in PRODUCTS:
            ops, rate = 2 * 128 * (n_in // 4), INT8_TC_OPS_PER_S
            moved += w_l.numel()
        by_bytes = moved / HBM_BYTES_PER_S
        by_ops = ops / rate
        out[name] = ((max(by_bytes, by_ops) * 1e3),
                     "bytes" if by_bytes >= by_ops else "operations",
                     moved, ops, rate)
    return out


def _unpack(packed: torch.Tensor, n: int) -> np.ndarray:
    host = packed.cpu().numpy().reshape(-1)
    return np.unpackbits(host.view("<u4").view(np.uint8),
                         bitorder="little")[:n]


def gate_stage1(gate: Gate, device, corpus_cases, golden) -> None:
    from csv_simd_tpu_torch import Dialect
    from csv_simd_tpu_torch.ops.stage1_v2 import pad_to_words
    from csv_simd_tpu_torch.ops.stage1_v4 import (
        _row_emits_plain,
        _stage1_v4_plain,
        stage1_fused_v4,
    )

    def check(words: torch.Tensor, what: str, arr=None) -> None:
        flat = words.reshape(-1)
        for kw in DIALECTS:
            d = Dialect(**kw)
            for carry in (0, 1):
                # B1n: counts and prefix narrow, the prefix wide
                tag = f"{what} {kw} carry={carry}"
                got = stage1_fused_v4(words, carry, d, emit_counts=True,
                                      emit_prefix=True)
                counts, prefix = _row_emits_plain(got[0])
                gate.same("stage1_v4_emit", got[3], counts, f"{tag} counts")
                gate.same("stage1_v4_emit", got[4], prefix, f"{tag} prefix")
                gate.same("stage1_v4_emit", got[0], _stage1_v4_plain(
                    flat, carry, d, True)[0], f"{tag} words")
                if words.shape[0] % 8 == 0:
                    wide = stage1_fused_v4(words.view(-1, 1024), carry, d,
                                           out_mode="wide_native",
                                           emit_prefix=True)
                    gate.same("stage1_v4_emit", wide[3], prefix,
                              f"{tag} wide prefix")
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


def gate_stage1_repeats(gate: Gate, device) -> None:
    """B1 at 64 MiB (1,024 chunks, more than the card holds at once), one
    quote opened in chunk 0 and closed in the last chunk, the carry a
    device 1: three launches in a row, then three replays of one captured
    CUDA graph with the outputs cleared before each, every result equal
    to the plain version. A chunk status word left from an earlier launch
    would show here."""
    from csv_simd_tpu_torch.config import DEFAULT_DIALECT as d
    from csv_simd_tpu_torch.ops.stage1_v4 import (
        _stage1_v4_plain,
        stage1_fused_v4,
    )

    rng = np.random.default_rng(1024)
    arr = rng.choice(np.frombuffer(b"ab,\n\r x9;\xc3\xa9", np.uint8),
                     size=BLOCK_BYTES)
    arr[100] = arr[arr.size - 100] = 0x22
    w = torch.from_numpy(arr.view("<i4").reshape(-1, 128)).to(device)
    one = torch.ones((), dtype=torch.int32, device=device)
    want = _stage1_v4_plain(w.view(-1), 1, d, True)
    for i in range(3):
        got = stage1_fused_v4(w, one, d)
        for g, x, part in zip(got, want, ("words", "parity", "nonascii")):
            gate.same("stage1_v4", g, x, f"64 MiB launch {i} {part}")
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = stage1_fused_v4(w, one, d)
    for i in range(3):
        for g in got:
            g.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for g, x, part in zip(got, want, ("words", "parity", "nonascii")):
            gate.same("stage1_v4", g, x, f"64 MiB graph replay {i} {part}")
    del graph, got


def gate_products(gate: Gate, device) -> None:
    """Both int8 products (T10b/T11b's OR of the eight block products,
    T12's sum) against their plain versions at M = 1, 15, 16, 17, 1000
    and 4097 (the mma's 16-row tiles short, whole and one row over) with
    both probes' weights, full-range random, all -128, and blocks that
    all reach the same columns (their OR is not their sum)."""
    from csv_simd_tpu_torch.tools import (
        widestore_probe2,
        widestore_probe3,
        widestore_probe4,
    )
    from csv_simd_tpu_torch.tools._common import random_words

    weights = {**widestore_probe2.weight_sets(device),
               "min": torch.full((1024, 128), -128, dtype=torch.int8,
                                 device=device),
               "overlap": widestore_probe2.overlap_weights(device)}
    for m in (1, 15, 16, 17, 1000, 4097):
        x = random_words(8 * m, device, 31 * m)
        wide = x.view(-1, 1024)
        for name, w in weights.items():
            at = f"M={m} {name} weights"
            want = widestore_probe2._packmm_plain(wide, w)
            gate.same("widestore_probe2.mmL", widestore_probe2.mm_lanes(x, w),
                      want, at)
            gate.same("widestore_probe3.mmLb",
                      widestore_probe3.mm_lanes_b(wide, w), want, at)
            gate.same("widestore_probe4.concat_mm",
                      widestore_probe4.concat_mm(wide, w),
                      widestore_probe4._concat_mm_plain(wide, w), at)
    torch.cuda.synchronize()


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


def gate_relayouts(gate: Gate, device, golden) -> None:
    """The relayout kernels alone against their plain versions on
    full-range sequential words: fold_words at tiles 8 to 16,384 and
    v1_words with its count from the first, a middle and the last tile's
    first word (under B3's and B6's names); then B3 at tiles 2,048,
    3,200 (the two-pass kernel's largest) and 16,384 on CSV-ish bytes
    with one quote opened 100 bytes before the end of B1's first 64 KiB
    chunk and closed past the first fold tile, carries 0, 1 and a device
    1, against its plain version and golden."""
    from csv_simd_tpu_torch import _kernels
    from csv_simd_tpu_torch.ops.stage1_pallas import _v1_from_seq_plain
    from csv_simd_tpu_torch.ops.stage1_v3 import (
        _fold_from_seq_plain,
        stage1_fused,
        stage1_swar_xla,
        unpack_packed_host,
    )

    rng = np.random.default_rng(8)

    def seq_words(n: int) -> torch.Tensor:
        return torch.from_numpy(rng.integers(
            -2**31, 2**31, n, dtype=np.int64).astype(np.int32)).to(device)

    for rows, tile in ((8, 8), (48, 24), (4096, 512), (8192, 2048),
                       (12_800, 3200), (32_768, 16_384), (131_072, 512)):
        seq = seq_words(rows * 16)
        gate.same("stage1_fold", _kernels.fold_words(seq, tile),
                  _fold_from_seq_plain(seq, tile),
                  f"fold_words rows={rows} tile={tile}")
    for rows, count_from in ((32, 0), (1024, 77), (524_288, 0),
                             (524_288, 524_288 * 4 - 1024 * 4)):
        seq = seq_words(rows * 4)
        for g, w, part in zip(_kernels.v1_words(seq, count_from),
                              _v1_from_seq_plain(seq, count_from),
                              ("words", "count")):
            gate.same("stage1_v1", g, w,
                      f"v1_words rows={rows} count_from={count_from} {part}")
    one = torch.ones((), dtype=torch.int32, device=device)
    alphabet = np.frombuffer(b"ab,\n\r x9;", np.uint8)
    for tile in (2048, 3200, 16_384):
        rows = 4 * tile
        arr = rng.choice(alphabet, size=rows * 512)
        arr[(1 << 16) - 100] = arr[tile * 512 + 100] = 0x22
        w = torch.from_numpy(arr.view("<i4").reshape(rows, 128)).to(device)
        for carry in (0, 1, one):
            got = stage1_fused(w, carry, row_tile=tile)
            for g, x, part in zip(got, stage1_swar_xla(w, int(carry),
                                                       row_tile=tile),
                                  ("words", "parity")):
                gate.same("stage1_fold", g, x,
                          f"tile={tile} carry={int(carry)} {part}")
        mask = unpack_packed_host(got[0].cpu().numpy(), arr.size, tile)
        if not np.array_equal(mask, golden.structural_mask(arr, carry_in=1)):
            raise AssertionError(f"stage1_fold at tile {tile} differs from "
                                 "golden")
    torch.cuda.synchronize()


def gate_probes(gate: Gate, device) -> None:
    """Each probe and lab kernel, outputs and side words, against its
    plain version at several sizes and carries (the tools' own gates);
    each wide-store probe under its own name, each Mosaic probe under its
    own name with its kernel's gate (the two matmul probes share one)."""
    from csv_simd_tpu_torch.tools import (
        ablate,
        ablate2,
        dma_probe,
        kbench,
        mosaic_probes,
        vnext,
        vpu_roofline,
        widestore_probe2,
        widestore_probe3,
        widestore_probe4,
    )

    stream = dma_probe.gate(device)
    for name in ("dma_probe", "dma_probe2.write", "dma_probe2.read"):
        gate.record(name, stream)
    gate.record("vpu_roofline", vpu_roofline.gate(device))
    gate.record("ablate", ablate.gate(device))
    for name, tool in (("ablate2", ablate2), ("kbench", kbench),
                       ("vnext", vnext)):
        gate.record(name, tool.gate(device))
    for tool in (widestore_probe2, widestore_probe3, widestore_probe4):
        prefix = tool.__name__.rsplit(".", 1)[1]
        for name, result in tool.gate(device).items():
            gate.record(f"{prefix}.{name}", result)
    record_mosaic(gate, mosaic_probes.gate(device))


def record_mosaic(gate: Gate, by_kernel: dict) -> None:
    """A Mosaic tool result ({kernel: {checks, max_abs_err}}) under each
    probe that runs the kernel."""
    from csv_simd_tpu_torch.tools.mosaic_probes import PROBE_KERNEL

    for probe, kernel in PROBE_KERNEL.items():
        gate.record(f"mosaic_probes.{probe}", by_kernel[kernel])


def _device_ops(trace_path: str) -> tuple:
    """({device op name: (ms, launches)}, the device-busy share of the
    traced window) from a torch.profiler Chrome trace."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        raise AssertionError("the trace holds no device activity")
    per = {}
    for e in device:
        ms, n = per.get(e["name"], (0.0, 0))
        per[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in device)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    return per, busy / (t1 - t0)


def _short(name: str) -> str:
    """A kernel's demangled name without namespace, return type and
    parameters: `ablate_pass<4>`."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0]


def probe_trace(words: torch.Tensor) -> dict:
    """{kernel: (mean device ms a launch, launches)} from a torch.profiler
    trace of five calls of every stream and ablation mode (tiles 128 and
    512), of
    B1's narrow build, B5, every B1 stage cut, every v1-layout variant (the
    words as bytes), the direct fold pack (tiles 128 and 512) and the
    wide-store gather, lane
    sum and both pack products (on the words and their (rows/8, 1024)
    view), the Mosaic probes' kernels (on the words, the words as bytes,
    and for the gather a quarter of those bytes as the table and the words
    & 127 as indices) and the concat product, and two of every ALU op
    count and mix on words."""
    from csv_simd_tpu_torch import _kernels
    from csv_simd_tpu_torch.ops.stage1_v2 import stage1_pallas_v2
    from csv_simd_tpu_torch.ops.stage1_v4 import stage1_fused_v4
    from csv_simd_tpu_torch.tools import (
        ablate,
        ablate2,
        dma_probe,
        kbench,
        mosaic_probes,
        vnext,
        vpu_roofline,
        widestore_probe2,
        widestore_probe3,
        widestore_probe4,
    )
    from csv_simd_tpu_torch.utils import profiling

    as_bytes = kbench.as_bytes(words)
    wide = words.view(-1, 1024)
    w_l = widestore_probe2.weights_mmL().to(words.device)
    w_lb = widestore_probe3.weights_mmLb().to(words.device)
    w4 = widestore_probe4.weight_sets(words.device)["probe"]
    lut = as_bytes[:words.shape[0]].view(torch.int8)
    idx = words & 127
    with tempfile.TemporaryDirectory() as trace_dir:
        with profiling.device_trace(trace_dir):
            for _ in range(5):
                for mode in dma_probe.WRITE_MODES:
                    dma_probe.mk_write(words, mode, 1)
                dma_probe.mk_read(words, 1)
                for tile in (128, 512):
                    for mode in ablate.MODES:
                        ablate.mk(words, mode, tile, 1)
                stage1_fused_v4(words, 1, count_nonascii=False)
                stage1_pallas_v2(words, 1)
                for cut in _kernels.ABLATE2_CUTS:
                    ablate2.mk(words, cut, 512, 1)
                for name in ("nopar", "lanescan", "roll"):
                    kbench.make_variant(as_bytes, name, 1024, 1)
                for tile in vnext.TILES:
                    vnext.make(words, tile, 1, directpack=True)
                widestore_probe2.s8_st16(words)
                widestore_probe2.mm_lanes(words, w_l)
                widestore_probe3.laneload(wide)
                widestore_probe3.mm_lanes_b(wide, w_lb)
                widestore_probe4.concat_mm(wide, w4)
                mosaic_probes.mm32_pack(words)
                mosaic_probes.lane_gather(lut, idx)
                mosaic_probes.cmp8(as_bytes)
                mosaic_probes.select8(as_bytes)
                mosaic_probes.shift_add(words)
                mosaic_probes.unsigned_sum(words)
            for _ in range(2):
                for n_ops in _kernels.probe_alu_op_counts():
                    for mix in vpu_roofline.MIXES:
                        vpu_roofline.probe(words, n_ops, mix, 1)
        per, _busy = _device_ops(os.path.join(trace_dir,
                                              profiling.TRACE_FILE))
    return {_short(name): (ms / n, n) for name, (ms, n) in per.items()}


# the kernels of the two-pass carry, which the port no longer has: pass A
# and the carry scan of stage1_core.cuh, B5's pass B, and the probes'
# former row parity pass
TWO_PASS = ("chunk_parity", "chunk_carry_scan", "pack_v2", "row_parity")


def no_two_pass(names, what: str) -> None:
    """Fail if a traced kernel name holds a two-pass kernel's name."""
    for kernel in TWO_PASS:
        hit = [name for name in names if kernel in name]
        if hit:
            raise AssertionError(f"{what} names {kernel}: {hit}")


def write_big_csv(block: bytes, tag: str = "") -> tuple:
    """The 1 GiB file: the block's header, then its data rows REPEATS
    times. Cached in the temporary directory by size and tag."""
    header_len = block.index(b"\n") + 1
    rows = block[header_len:]
    size = header_len + REPEATS * len(rows)
    path = os.path.join(tempfile.gettempdir(),
                        f"csv_simd_torch_smoke{tag}_{size}.csv")
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
                  per_block: int, seed: int, device, repeats: int = REPEATS,
                  rec_lo: int = 0, batches: int = BATCHES) -> float:
    """A warm-up batch and `batches` timed batches of BATCH random
    (record, field) lookups, records from rec_lo on, through
    tape.gather_fields on a table of `repeats` copies of the block's rows,
    every byte checked against the shifted golden index; returns lookups/s
    over the timed batches."""
    n_records = repeats * per_block
    rng = np.random.default_rng(seed)
    serve_s = 0.0
    quoted = 0
    # batch 0 warms up (the first launch of each torch kernel loads it);
    # every batch is checked, batches 1..batches are timed
    for batch in range(batches + 1):
        recs = rng.integers(rec_lo, n_records, BATCH).astype(np.int32)
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
    return batches * BATCH / serve_s


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


# the non-ASCII 1 GiB table: every b"text" of the block made "éxt", the
# same four bytes with a two-byte character, so no structural byte moves
NONASCII_FROM, NONASCII_TO = b"text", "éxt".encode()
DATE_ROW = 43  # bytes of a row of the date table
FILTER_ID = 12345  # the row id filter_equals looks for in each copy


def block_fields(arr: np.ndarray, index: np.ndarray, per_block: int,
                 field: int) -> list:
    """Field `field` of every data row of the 64 MiB block, as bytes."""
    recs = np.arange(per_block)
    start, end = truth(index, 0, per_block, recs,
                       np.full(per_block, field))
    return [bytes(arr[s:e]) for s, e in zip(start, end)]


def fma_float32(fields: list) -> np.ndarray:
    """The float parses' value of unsigned integer fields: float32
    v = v * 10 + d a digit, rounded once (v * 10 + d is exact in float64
    for these fields, so one rounding to float32 is the fused
    multiply-add's)."""
    width = max(len(f) for f in fields)
    digits = (np.array([f.rjust(width, b"0") for f in fields],
                       dtype=f"S{width}").view(np.uint8)
              .reshape(-1, width).astype(np.float64) - 48)
    v = np.zeros(len(fields), np.float32)
    for j in range(width):
        v = (v.astype(np.float64) * 10 + digits[:, j]).astype(np.float32)
    return v


def date_table(n_bytes: int, seed: int) -> tuple:
    """(csv bytes, days, epoch ms, bad rows): rows `id,YYYY-MM-DD,
    YYYY-MM-DD[ T]HH:MM:SS.fff` of fixed width over the years 1-9999, made
    from a seed; the bad rows carry month 13 in both columns."""
    rng = np.random.default_rng(seed)
    n = (n_bytes - 8) // DATE_ROW
    days = rng.integers(-719162, 2932897, n)
    ms = days * 86_400_000 + rng.integers(0, 86_400_000, n)
    rows = np.empty((n, DATE_ROW), np.uint8)
    ids = np.arange(n)
    for k in range(7):
        rows[:, 6 - k] = 48 + (ids // 10**k) % 10
    rows[:, 7] = rows[:, 18] = ord(",")
    rows[:, 8:18] = np.datetime_as_string(days.astype("datetime64[D]")) \
        .astype("S10").view(np.uint8).reshape(n, 10)
    rows[:, 19:42] = np.datetime_as_string(ms.astype("datetime64[ms]")) \
        .astype("S23").view(np.uint8).reshape(n, 23)
    rows[::2, 29] = ord(" ")  # both date-time separators
    rows[:, 42] = ord("\n")
    bad = rng.choice(n, 64, replace=False)
    rows[bad, 13:15] = rows[bad, 24:26] = np.frombuffer(b"13", np.uint8)
    return b"id,d,ts\n" + rows.tobytes(), days, ms, np.sort(bad)


def cjk_text(n_bytes: int, seed: int) -> np.ndarray:
    """n_bytes of UTF-8 text in another script: random code points of the
    CJK block U+4E00-U+9FFF, three bytes each, every word not ASCII; the
    last n_bytes % 3 bytes are `a`."""
    rng = np.random.default_rng(seed)
    cp = rng.integers(0x4E00, 0xA000, n_bytes // 3)
    out = np.full(n_bytes, ord("a"), np.uint8)
    chars = out[: 3 * cp.size].reshape(-1, 3)
    chars[:, 0] = 0xE0 | (cp >> 12)
    chars[:, 1] = 0x80 | ((cp >> 6) & 0x3F)
    chars[:, 2] = 0x80 | (cp & 0x3F)
    return out


def warm_s(fn, reps: int = 3) -> list:
    """Host seconds of `reps` warm calls of fn, each ended by a sync,
    after one untimed call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def gate_utf8(gate: Gate, device, window: torch.Tensor) -> None:
    """The validator kernel against its plain version on the card: the
    corpus of edge cases, every length 1-600 of mixed text, a bad byte at
    offsets around chunk, warp, block and grid-step edges, 64 MiB of CJK
    text (every word checked in place) with and without cut sequences,
    and a 64 MiB window of the non-ASCII table (the words listed), valid
    and with bad bytes spread over it."""
    from csv_simd_tpu_torch import _kernels
    from csv_simd_tpu_torch.ops.utf8 import _utf8_errs_plain

    def check(t: torch.Tensor, what: str) -> int:
        got = _kernels.utf8_errs(t)
        want = torch.tensor(_utf8_errs_plain(t), device=t.device)
        gate.same("utf8_errs", got, want, what)
        return int(want)

    cases = [b"\x80", b"\xc0\x80", b"\xc1\xbf", b"\xe0\x80\x80",
             b"\xe0\x9f\xbf", b"\xed\xa0\x80", b"\xed\x9f\xbf",
             b"\xee\x80\x80", b"\xf0\x80\x80\x80", b"\xf0\x8f\xbf\xbf",
             b"\xf4\x8f\xbf\xbf", b"\xf4\x90\x80\x80", b"\xf5\x80\x80\x80",
             b"\xe2\x82", b"\xf0\x9f\x98", b"a\xc3", b"ok\xff", b"\xfe",
             "héllo 日本語 \U0001f389".encode()]
    for c in cases:
        check(torch.tensor(list(c), dtype=torch.uint8, device=device),
              f"case {c!r}")
    rng = np.random.default_rng(8)
    pool = [c.encode() for c in "aé日😀\n,"] + [b"\xff", b"\x80", b"\xe6\x97"]
    mixed = np.frombuffer(b"".join(pool[i] for i in rng.integers(
        0, len(pool), 400)), np.uint8)[:600].copy()
    t = torch.from_numpy(mixed).to(device)
    for n in range(1, mixed.size + 1):
        check(t[:n], f"mixed text, length {n}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for edge in (16, 512, 1024, 8192, 4 * sms * 8192):
        base = np.full(edge + 64, ord("x"), np.uint8)
        for off in range(20):
            for piece in (b"\xff", b"\xe6\x97\xa5", b"\xe6\x97"):
                arr = base.copy()
                p = edge - 10 + off
                arr[p:p + len(piece)] = np.frombuffer(piece, np.uint8)
                check(torch.from_numpy(arr).to(device),
                      f"{piece!r} at {p} near edge {edge}")
    cjk = torch.from_numpy(cjk_text(BLOCK_BYTES, 5)).to(device)
    if check(cjk, "64 MiB of CJK text") != 0:
        raise AssertionError("the CJK text is not valid UTF-8")
    cjk[torch.arange(7, cjk.numel(), 1_000_003, device=device)] = 0x41
    if check(cjk, "64 MiB of CJK text with cut sequences") == 0:
        raise AssertionError("cut sequences went uncounted")
    del cjk
    if check(window, "64 MiB of the non-ASCII table") != 0:
        raise AssertionError("the non-ASCII table is not valid UTF-8")
    bad = window.clone()
    bad[torch.arange(1000, bad.numel(), 997_331, device=device)] = 0xFF
    if check(bad, "64 MiB of the non-ASCII table with bad bytes") == 0:
        raise AssertionError("bad bytes went uncounted")


def utf8_bound(t: torch.Tensor) -> tuple:
    """The validator's bound on t (bound() entry: ms, by, bytes moved,
    operations, rate): it reads t once and writes 8 bytes; its operations
    are the plain version's per byte (counted on 256 KiB of t on the CPU)
    four bytes an operation, on the 16-byte chunks it checks in full (a
    byte >= 0x80 in the chunk or in the three bytes before it), and one
    a 4-byte word on the others."""
    from csv_simd_tpu_torch.ops.utf8 import _utf8_errs_plain

    sample = t[: 256 << 10].cpu()
    ops_per_byte = plain_work(lambda: _utf8_errs_plain(sample))[0] \
        / sample.numel()
    n = t.numel() - t.numel() % 16
    hi = (t[:n] >= 0x80).view(-1, 16)
    full = hi.any(dim=1)
    full[1:] |= hi[:-1, 13:].any(dim=1)
    n_full = int(full.sum()) * 16
    ops = ops_per_byte / 4 * n_full + (t.numel() - n_full) / 4
    moved = t.numel() + 8
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations", moved, ops,
            INT32_OPS_PER_S)


def s1_bound(n_bytes: int) -> tuple:
    """S1's bound on n_bytes (bound() entry: ms, by, bytes moved,
    operations, rate): it reads the bytes once and writes 4; its
    operations are its plain version's a byte (counted on 256 KiB on the
    CPU) times n_bytes."""
    from csv_simd_tpu_torch.config import DEFAULT_DIALECT as d
    from csv_simd_tpu_torch.parallel.sharded import _local_parity_plain

    sample = torch.zeros(64 << 10, dtype=torch.int32)
    ops = plain_work(lambda: _local_parity_plain(sample, d))[0] \
        / (4 * sample.numel()) * n_bytes
    moved = n_bytes + 4
    by_bytes, by_ops = moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations", moved, ops,
            INT32_OPS_PER_S)


def run_utf8_typed_path(gate: Gate, device, block: bytes, index: np.ndarray,
                        per_block: int, ascii_path: str) -> dict:
    """The validator and the typed and decoded columns: gates first, then
    times. create_packed(validate_utf8=True) on the non-ASCII 1 GiB table
    (one validator launch) and on the ASCII one (none); one injected 0xFF
    and one cut sequence before a newline each refused; the seven new
    columns gated on the 1 GiB tape, the 64 MiB block and a seeded 64 MiB
    date table; then the validator's and the columns' times."""
    import csv_simd_tpu_torch as ct
    from csv_simd_tpu_torch import _kernels
    from csv_simd_tpu_torch.ops.utf8 import _utf8_errs_plain
    from csv_simd_tpu_torch.tools._common import cuda_ms, graph_ms

    nblock = block.replace(NONASCII_FROM, NONASCII_TO)
    if len(nblock) != len(block) or nblock == block:
        raise AssertionError("the substitution moved bytes or found none")
    path, rows_len = write_big_csv(nblock, "_nonascii")
    n_records = REPEATS * per_block
    out = {"path": path}

    # gates: the kernel against its plain version on the card
    head = torch.from_numpy(np.fromfile(path, np.uint8, BLOCK_BYTES)).to(
        device)
    gate_utf8(gate, device, head)
    del head

    # the path: create_packed with the validator, once on each table
    tape, l_utf8 = driven(ct.create_packed, path, validate_utf8=True,
                          device=device)
    for name in ("stage1_v4", "row_prefix", "utf8_errs"):
        need(l_utf8, name, 1, "create_packed(validate_utf8=True), non-ASCII")
    if tape.num_data_records != n_records or int(tape.nonascii_count) == 0:
        raise AssertionError("the non-ASCII tape's records or count differ")
    data = np.memmap(path, dtype=np.uint8, mode="r")
    out["lookups_per_s"] = check_lookups(tape, data, index, rows_len,
                                         per_block, 4242, device)
    atape, l_ascii = driven(ct.create_packed, ascii_path, validate_utf8=True,
                            device=device)
    if l_ascii["utf8_errs"] != 0 or int(atape.nonascii_count) != 0:
        raise AssertionError(f"the ASCII table launched the validator: "
                             f"{l_ascii}")
    if int(_kernels.utf8_errs(atape.data)) != 0:
        raise AssertionError("the ASCII table counted errors")
    out["launches"], out["launches_ascii"] = l_utf8, l_ascii

    # one injected 0xFF, one cut sequence before a newline: refused, and
    # counted as the plain version counts them on a 64 MiB window
    host = np.fromfile(path, np.uint8)
    recs = np.array([REPEATS // 2 * per_block + 1234,
                     (REPEATS - 1) * per_block + 77])
    start, end = truth(index, rows_len, per_block, recs, np.array([5, 15]))
    faults = ((int(start[0]) + 1, b"\xff"), (int(end[1]) - 2, b"\xe6\x97"))
    if host[int(end[1])] != ord("\n"):
        raise AssertionError("the cut sequence is not before a newline")
    for pos, piece in faults:
        keep = host[pos:pos + len(piece)].copy()
        host[pos:pos + len(piece)] = np.frombuffer(piece, np.uint8)
        try:
            ct.PackedDeviceTape(host, validate_utf8=True, device=device)
        except ct.InvalidCsvFormat:
            pass
        else:
            raise AssertionError(f"{piece!r} at {pos} was not refused")
        lo = max(pos - BLOCK_BYTES // 2, 0) & ~15
        win = torch.from_numpy(host[lo:lo + BLOCK_BYTES]).to(device)
        got = int(_kernels.utf8_errs(win))
        want = _utf8_errs_plain(win)
        if got != want or got == 0:
            raise AssertionError(f"{piece!r}: kernel {got}, plain {want}")
        gate.record("utf8_errs", {"checks": 1, "max_abs_err": 0})
        host[pos:pos + len(piece)] = keep
        out.setdefault("fault_counts", []).append(got)
    del host, win

    # the columns on the 1 GiB tape against the host parse of the block
    arr = np.frombuffer(nblock, np.uint8)
    f1 = block_fields(arr, index, per_block, 1)
    vals, ok = tape.column_decimal64(1)
    want = np.tile(np.array([int(v) for v in f1], np.int64) * 100, REPEATS)
    if not (ok.all() and np.array_equal(vals, want)):
        raise AssertionError("column_decimal64(1) differs from the host")
    vals, ok = tape.column_float32_exp(1)
    want = np.tile(fma_float32(f1), REPEATS)
    if not (bool(ok.all()) and np.array_equal(
            vals.cpu().numpy().view(np.int32), want.view(np.int32))):
        raise AssertionError("column_float32_exp(1) differs from the host")
    fid = FILTER_ID % per_block
    hits = tape.filter_equals(0, str(fid).encode())
    if not np.array_equal(hits, np.arange(REPEATS) * per_block + fid):
        raise AssertionError(f"filter_equals(0, {fid}): {hits[:20]}")
    raw3 = block_fields(arr, index, per_block, 3)
    dec = [ct.decode_field(v) for v in raw3]
    if not any(NONASCII_TO in v for v in dec):
        raise AssertionError("field 3 holds no non-ASCII text")
    want_b = np.zeros((per_block, MAX_LEN), np.uint8)
    for i, v in enumerate(dec):
        want_b[i, :len(v)] = np.frombuffer(v, np.uint8)
    want_b = torch.from_numpy(want_b).to(device)
    want_n = torch.tensor([len(v) for v in dec], dtype=torch.int32,
                          device=device)
    all_recs = torch.arange(n_records, dtype=torch.int32, device=device)
    three = torch.full_like(all_recs, 3)
    got_b, got_n, got_v = tape.gather_decoded(all_recs, three, MAX_LEN)
    for r in range(REPEATS):
        sl = slice(r * per_block, (r + 1) * per_block)
        if not (torch.equal(got_b[sl], want_b) and torch.equal(got_n[sl],
                                                                want_n)
                and bool(got_v[sl].all())):
            raise AssertionError(f"gather_decoded(3) differs in copy {r}")
    del got_b, got_n, got_v, want_b

    # column_decoded on the 64 MiB block, dates on a seeded 64 MiB table
    btape = ct.PackedDeviceTape(nblock, device=device)
    view = ct.DecodedView(ct.Tape(arr, index, ct.Header.parse(arr)))
    if btape.column_decoded(3) != view.column(3):
        raise AssertionError("column_decoded(3) differs from DecodedView")
    dbytes, days, ms, bad = date_table(BLOCK_BYTES, 2026)
    dtape = ct.PackedDeviceTape(dbytes, device=device)
    good = np.ones(days.size, bool)
    good[bad] = False
    got, ok = dtape.column_date_days(1)
    if not (np.array_equal(ok.cpu().numpy(), good) and np.array_equal(
            got.cpu().numpy(), np.where(good, days, 0))):
        raise AssertionError("column_date_days differs from the seed")
    got, ok = dtape.column_datetime64(2, unit="ms")
    if not (np.array_equal(ok, good) and np.array_equal(
            got, np.where(good, ms, 0))):
        raise AssertionError("column_datetime64 differs from the seed")
    out["date_rows"] = int(days.size)

    # times: the validator (kernel from CUDA graphs and events, the plain
    # version at 64 MiB), the builds with and without it, the columns
    win = tape.data[:BLOCK_BYTES]
    out["ms"] = graph_ms(lambda: _kernels.utf8_errs(win), 20)
    out["eager_ms"] = cuda_ms(lambda: _kernels.utf8_errs(win), 20)
    out["plain_ms"] = cuda_ms(lambda: _utf8_errs_plain(win), 3)
    out["ms_1GiB"] = cuda_ms(lambda: _kernels.utf8_errs(tape.data), 20)
    out["graph_ms_1GiB"] = graph_ms(lambda: _kernels.utf8_errs(tape.data), 20)
    out["ms_1GiB_ascii"] = cuda_ms(lambda: _kernels.utf8_errs(atape.data), 20)
    cjk = torch.from_numpy(cjk_text(tape.data.numel(), 5)).to(device)
    if int(_kernels.utf8_errs(cjk)) != 0:
        raise AssertionError("1 GiB of CJK text counted errors")
    out["ms_1GiB_cjk"] = cuda_ms(lambda: _kernels.utf8_errs(cjk), 20)
    del cjk
    if int(_kernels.utf8_errs(tape.data)) != 0:
        raise AssertionError("the 1 GiB non-ASCII table counted errors")
    out["bound"] = utf8_bound(win)
    out["bound_1GiB"] = utf8_bound(tape.data)
    builds = {
        "create_packed validate non-ASCII": lambda: ct.create_packed(
            path, validate_utf8=True, device=device),
        "create_packed non-ASCII": lambda: ct.create_packed(
            path, device=device),
        "create_packed validate ASCII": lambda: ct.create_packed(
            ascii_path, validate_utf8=True, device=device),
        "create_packed ASCII": lambda: ct.create_packed(ascii_path,
                                                        device=device),
    }
    out["builds_s"] = {k: warm_s(f) for k, f in builds.items()}
    out["create_s"] = {
        "create validate non-ASCII": warm_s(lambda: ct.create(
            path, backend="cuda", validate_utf8=True, device=device), 2),
        "create non-ASCII": warm_s(lambda: ct.create(
            path, backend="cuda", device=device), 2)}
    columns = {
        "column_int32(0)": lambda: tape.column_int32(0),
        "column_float32(1)": lambda: tape.column_float32(1),
        "column_float32_exp(1)": lambda: tape.column_float32_exp(1),
        "column_decimal64(1)": lambda: tape.column_decimal64(1),
        "column_date_days(1)": lambda: tape.column_date_days(1),
        "column_datetime64(1)": lambda: tape.column_datetime64(1),
        "filter_equals(0)": lambda: tape.filter_equals(0, str(fid).encode()),
        "gather_decoded(3)": lambda: tape.gather_decoded(all_recs, three,
                                                         MAX_LEN),
    }
    out["columns_s"] = {k: warm_s(f) for k, f in columns.items()}
    out["small_s"] = {
        f"column_decoded(3), {per_block} rows": warm_s(
            lambda: btape.column_decoded(3)),
        f"column_date_days(1), {days.size} rows": warm_s(
            lambda: dtape.column_date_days(1)),
        f"column_datetime64(2, ms), {days.size} rows": warm_s(
            lambda: dtape.column_datetime64(2, unit="ms"))}
    out["rows"] = n_records
    del tape, atape, btape, dtape, win, all_recs, three
    torch.cuda.empty_cache()
    return out


REL_QS = (0.01, 0.5, 0.99)
REL_LIKE = "%comma 12%"
WATCH_ELEMS = 4096  # a CPU tensor larger than this in a device op fails


def device_watch():
    """A TorchDispatchMode that counts the aten ops whose outputs lie on
    the card and records every op that leaves a tensor of more than
    WATCH_ELEMS elements on the CPU, other than a copy between devices,
    host data entering torch or an alias of a host copy (`.numpy()`
    detaches it): a step of the relational layer that ran on the host."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    crossing = {"_to_copy", "copy_", "lift_fresh", "detach", "alias"}

    class Watch(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.cuda_ops = 0
            self.cpu_ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            for t in tree_flatten(out)[0]:
                if not isinstance(t, torch.Tensor):
                    continue
                if t.device.type == "cuda":
                    self.cuda_ops += 1
                elif t.numel() > WATCH_ELEMS and name not in crossing:
                    self.cpu_ops.append((name, tuple(t.shape)))
            return out

    return Watch()


def on_card(what: str, fn):
    """fn() once under device_watch: fails if it ran no op on the card or
    left a large tensor on the CPU; returns fn's result."""
    with device_watch() as w:
        out = fn()
    if w.cuda_ops == 0 or w.cpu_ops:
        raise AssertionError(f"{what}: {w.cuda_ops} ops on the card, on the "
                             f"CPU {w.cpu_ops[:5]}")
    return out


def median_s(fn, reps: int = 3) -> float:
    """The median host seconds of `reps` warm calls, each ended by a
    sync (fn ran once before, under on_card)."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return float(np.median(out))


def relational_truth(block: bytes, index: np.ndarray, per_block: int) -> dict:
    """The host's truth for phase 9 from the 64 MiB block's golden
    fields: the int fields f1, f2 and f4 (int64), f2 as the float parse
    gives it (float32), f3 decoded, as str; the quantiles of the tiled
    int fields and the stable orders of the tiled f2, computed once for
    both tapes and the corpus."""
    from csv_simd_tpu_torch import decode_field

    arr = np.frombuffer(block, np.uint8)
    out = {f"f{k}": np.array(block_fields(arr, index, per_block, k))
           .astype(np.int64) for k in (1, 2, 4)}
    out["f2_float"] = fma_float32(block_fields(arr, index, per_block, 2))
    out["f3"] = np.array([decode_field(v).decode() for v in
                          block_fields(arr, index, per_block, 3)], object)
    for k in ("f1", "f2", "f4"):
        tiled = np.tile(out[k], REPEATS)
        out[f"{k}_q"] = np.quantile(tiled, (0.25, 0.5, 0.75))
        if k == "f2":
            out["f2_qs"] = np.quantile(tiled, REL_QS)
            out["f2_order"] = np.argsort(tiled, kind="stable")
            out["f2_order_desc"] = np.argsort(-tiled, kind="stable")
    return out


def same_array(what: str, got, want) -> None:
    if not np.array_equal(got, want):
        raise AssertionError(f"{what}: {np.asarray(got)[:8]} != "
                             f"{np.asarray(want)[:8]}")


def check_stats(st, vals: np.ndarray, what: str,
                repeats: int = REPEATS) -> None:
    """Stats of an int column against the tiled block: all exact."""
    n = repeats * vals.size
    want = (n, n, repeats * int(vals.sum()), int(vals.min()), int(vals.max()))
    got = (st.count, st.ok_count, st.sum, st.min, st.max)
    if got != want:
        raise AssertionError(f"{what}: {got} != {want}")


def check_relational(ct, t, bt, truth: dict, per_block: int,
                     what: str, times: dict) -> None:
    """Every phase-9 operation on the 1 GiB tape `t` (and the join with
    the 64 MiB block's tape `bt`) once under on_card, held against the
    truth, then its warm median added to `times`."""
    n = REPEATS * per_block
    ids = np.arange(n)
    tile = lambda a: np.tile(a, REPEATS)  # noqa: E731
    f1, f2, f4 = truth["f1"], truth["f2"], truth["f4"]

    def run(name, fn, check):
        check(on_card(f"{what} {name}", fn))
        times[name] = median_s(fn)

    def stats_float(st):
        v = truth["f2_float"].astype(np.float64)
        ok = (st.count == st.ok_count == n
              and st.min == float(v.min()) and st.max == float(v.max())
              and abs(st.sum / (REPEATS * v.sum()) - 1) < 1e-5
              and abs(st.sum_sq / (REPEATS * (v * v).sum()) - 1) < 1e-5)
        if not ok:
            raise AssertionError(f"{what} float stats of f2: {st}")

    def equal(name, want):
        return lambda got: same_array(f"{what} {name}", got, want)

    def described(got):
        for name, vals in (("f1", f1), ("f2", f2), ("f4", f4)):
            check_stats(got[name]["stats"], vals, f"{what} describe {name}")
            equal(f"describe {name} quantiles",
                  truth[f"{name}_q"])(got[name]["quantiles"])

    def grouped(g):
        equal("group keys", np.arange(per_block, dtype=np.int32))(g["keys"])
        equal("group counts", np.full(per_block, REPEATS))(g["count"])
        equal("group sums", REPEATS * f1)(g["sum"])
        equal("group min", f1.astype(np.int32))(g["min"])
        equal("group max", f1.astype(np.int32))(g["max"])

    def aggregate():
        k, kok = t.column_int32(0)
        v, vok = t.column_int32(1)
        return ct.group_aggregate(k, v, kok, vok)

    def joined(frame):
        equal("join_typed records", ids)(frame.records)
        equal("join_typed f0", tile(np.arange(per_block)))(frame["f0"])
        equal("join_typed f1", tile(f1))(frame["f1"])
        equal("join_typed f2", tile(f2))(frame["f2"])

    like = np.array(["comma 12" in s for s in truth["f3"]])
    run("column_stats(f1)", lambda: ct.column_stats(t, "f1"),
        lambda st: check_stats(st, f1, f"{what} column_stats(f1)"))
    run("column_stats(f2, float)", lambda: ct.column_stats(t, "f2", "float"),
        stats_float)
    run("column_quantiles(f2)", lambda: ct.column_quantiles(t, "f2", REL_QS),
        equal("column_quantiles", truth["f2_qs"]))
    run("describe(f1, f2, f4)", lambda: ct.describe(t, ["f1", "f2", "f4"]),
        described)
    run("select_records", lambda: ct.select_records(
        t, [("f1", "<", 500_000_000), ("f3", "like", REL_LIKE)]),
        equal("select_records", np.flatnonzero(tile((f1 < 500_000_000)
                                                    & like))))
    run("order_records(f2)", lambda: ct.order_records(t, "f2"),
        equal("order_records", truth["f2_order"]))
    run("order_records(f2, desc)",
        lambda: ct.order_records(t, "f2", descending=True),
        equal("order_records desc", truth["f2_order_desc"]))
    run("groupby_typed(f0, f1)", lambda: ct.groupby_typed(t, "f0", "f1"),
        grouped)
    run("group_aggregate(f0, f1)", aggregate, grouped)
    run("join_records(f0)", lambda: ct.join_records(t, bt, "f0"),
        lambda p: (equal("join left ids", ids)(p[0]),
                   equal("join right ids", ids % per_block)(p[1])))
    run("join_typed(f0)", lambda: ct.join_typed(
        t, bt, "f0", columns=["f0", "f1"], right_columns=["f2"]), joined)


def run_relational_path(device, block: bytes, index: np.ndarray,
                        per_block: int, path: str) -> dict:
    """Phase 9: the relational layer on the 1 GiB table through both
    engines, the text keys and the CSV round trip on the 64 MiB block, and
    a CsvCorpus of 16 files of the block, each result held against the
    host's truth from the block's golden fields; the warm times; a trace
    of a warm groupby_typed and order_records on the packed tape."""
    import csv_simd_tpu_torch as ct
    from csv_simd_tpu_torch import _kernels
    from csv_simd_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    truth = relational_truth(block, index, per_block)
    n = REPEATS * per_block
    out = {"times": {}, "offsets_times": {}, "text_times": {}}
    block_path = os.path.join(tempfile.gettempdir(),
                              "csv_simd_torch_smoke_block.csv")
    with open(block_path, "wb") as f:
        f.write(block)

    # the path: the entry points build their tapes from the file, with
    # the launch counts set to 0 just before
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    check_stats(ct.column_stats(path, "f1", engine="packed", device=device),
                truth["f1"], "column_stats(path, packed)")
    check_stats(ct.column_stats(path, "f1", engine="offsets", device=device),
                truth["f1"], "column_stats(path, offsets)")
    packed = ct.create_packed(path, device=device)
    offsets = ct.DeviceTape.from_tape(
        ct.create(path, backend="cuda", device=device), device=device)
    bpacked = ct.create_packed(block_path, device=device)
    boffsets = ct.DeviceTape.from_tape(
        ct.create(block_path, backend="cuda", device=device), device=device)
    torch.cuda.synchronize()
    out["launches"] = _kernels.launch_counts()
    out["build_s"] = time.perf_counter() - t0
    for name in ("stage1_v4", "row_prefix", "stage1_fold"):
        need(out["launches"], name, 1, "phase 9's tapes")

    check_relational(ct, packed, bpacked, truth, per_block, "packed",
                     out["times"])
    check_relational(ct, offsets, boffsets, truth, per_block, "offsets",
                     out["offsets_times"])
    del offsets, boffsets

    # text keys on the 64 MiB block: the reference factorizes them on
    # the host, one Python bytes a row
    keys, counts = np.unique(truth["f3"], return_counts=True)
    sums = np.zeros(keys.size, np.int64)
    np.add.at(sums, np.searchsorted(keys, truth["f3"]), truth["f1"])

    def counted(name, g):
        same_array(f"{name} keys", g["keys"], keys)
        same_array(f"{name} counts", g["count"], counts)

    text_ops = {
        "value_counts(f3)": (lambda: ct.value_counts(bpacked, "f3"),
                             lambda g: counted("value_counts(f3)", g)),
        "distinct(f3)": (lambda: ct.distinct(bpacked, "f3"),
                         lambda g: same_array("distinct(f3)", g, keys)),
        "groupby_typed(f3, f1)": (
            lambda: ct.groupby_typed(bpacked, "f3", "f1"),
            lambda g: (counted("groupby_typed(f3, f1)", g),
                       same_array("groupby_typed(f3, f1) sums", g["sum"],
                                  sums))),
    }
    for name, (fn, check) in text_ops.items():
        check(on_card(f"text {name}", fn))
        out["text_times"][name] = median_s(fn)
    out["text_keys"] = int(keys.size)

    # read_typed, write_csv, read_typed again: an equal Frame. No float
    # column: the fields hold up to 10 digits, and the float parse rounds
    # once a digit (as the reference's does), so the shortest text of a
    # float32 need not parse back to it
    schema = {"f0": "int32", "f1": "int32", "f3": "str", "f4": "decimal:2"}
    frame = on_card("read_typed", lambda: ct.read_typed(bpacked, schema))
    blob = ct.write_csv(frame)
    again = ct.read_typed(blob, schema, engine="packed", device=device)
    for name in schema:
        same_array(f"the CSV round trip of {name}", again[name], frame[name])
        if frame.ok(name) is not None and not (
                frame.ok(name).all() and again.ok(name).all()):
            raise AssertionError(f"{name} does not parse in the round trip")
    if not (np.array_equal(frame["f0"], np.arange(per_block))
            and np.array_equal(frame["f4"], truth["f4"] * 100)
            and again.names == frame.names and len(again) == per_block):
        raise AssertionError("read_typed of the block differs from the host")
    out["text_times"]["read_typed(4 columns)"] = median_s(
        lambda: ct.read_typed(bpacked, schema))
    out["text_times"]["write_csv(4 columns)"] = median_s(
        lambda: ct.write_csv(frame), 1)
    del frame, again, blob

    # a corpus of 16 files of the block: per-file statistics and the
    # rank bisection over the files' device buffers, ORDER BY through the
    # corpus tape
    parts = []
    for i in range(REPEATS):
        p = os.path.join(tempfile.gettempdir(),
                         f"csv_simd_torch_smoke_part{i:02d}.csv")
        with open(p, "wb") as f:
            f.write(block)
        parts.append(p)
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    corpus = ct.CsvCorpus(parts, device=device)
    corpus.serving_tape()  # the files' DeviceTapes, uploaded once
    torch.cuda.synchronize()
    out["corpus_build_s"] = time.perf_counter() - t0
    out["corpus_launches"] = _kernels.launch_counts()
    need(out["corpus_launches"], "stage1_fold", 1, "CsvCorpus")
    corpus_ops = {
        "corpus column_stats(f1)": (
            lambda: ct.column_stats(corpus, "f1"),
            lambda st: check_stats(st, truth["f1"], "corpus column_stats")),
        "corpus column_quantiles(f2)": (
            lambda: ct.column_quantiles(corpus, "f2", REL_QS),
            lambda q: same_array("corpus column_quantiles", q,
                                 truth["f2_qs"])),
        "corpus order_records(f2)": (
            lambda: ct.order_records(corpus.serving_tape(), "f2"),
            lambda perm: same_array("corpus order_records", perm,
                                    truth["f2_order"])),
    }
    for name, (fn, check) in corpus_ops.items():
        check(on_card(name, fn))
        out["times"][name] = median_s(fn)
    if corpus.num_records != n:
        raise AssertionError(f"corpus records {corpus.num_records}")
    del corpus
    for p in parts:
        os.remove(p)

    # where a column's time goes: a trace of a warm groupby_typed and a
    # warm order_records on the packed tape
    with tempfile.TemporaryDirectory() as trace_dir:
        with profiling.device_trace(trace_dir):
            with profiling.named("groupby_typed"):
                ct.groupby_typed(packed, "f0", "f1")
            with profiling.named("order_records"):
                ct.order_records(packed, "f2")
        per, busy = _device_ops(os.path.join(trace_dir,
                                             profiling.TRACE_FILE))
    out["trace_busy"] = busy
    out["trace_top"] = sorted(per.items(), key=lambda kv: -kv[1][0])[:5]
    out["trace_device_ms"] = sum(ms for ms, _ in per.values())
    out["rows"] = n
    out["phase_s"] = time.perf_counter() - t_phase
    del packed, bpacked
    os.remove(block_path)
    torch.cuda.empty_cache()
    return out


SQL_HALF = 500_000_000  # the set operations' and the join's f2 filter
SQL_TENTH = 100_000_000  # the IN subquery's and EXCEPT's f1 filter


def sql_truth(block: bytes, index: np.ndarray, per_block: int) -> dict:
    """The host's truth for phase 10 from the 64 MiB block's golden
    fields, tiled 16 times: f1, f2 (int64), f5 as the float32 parse
    gives it, f3 decoded, and the orders the windows without a
    partition sort by (stable, as np.lexsort is)."""
    from csv_simd_tpu_torch import decode_field

    arr = np.frombuffer(block, np.uint8)
    out = {f"f{k}": np.array(block_fields(arr, index, per_block, k))
           .astype(np.int64) for k in (1, 2)}
    out["f5_float"] = fma_float32(block_fields(arr, index, per_block, 5))
    out["f3"] = np.array([decode_field(v).decode() for v in
                          block_fields(arr, index, per_block, 3)], object)
    f0 = np.tile(np.arange(per_block), REPEATS)
    f2 = np.tile(out["f2"], REPEATS)
    out["desc_order"] = np.lexsort((f0, -f2))
    out["asc_order"] = np.argsort(f2, kind="stable")
    return out


def _ints(what: str, got, want) -> None:
    """An int column of a result (int64, or exact Python ints in an
    object array) against the truth, with no NULL among them."""
    got = np.asarray(got)
    if got.dtype == object and any(v is None for v in got):
        raise AssertionError(f"{what}: NULL where the truth has none")
    same_array(what, got.astype(np.int64), np.asarray(want, np.int64))


def sql_statements(truth: dict, per_block: int) -> list:
    """(name, statement, schema, check, spied executors) for phase 10;
    `big` is the 1 GiB table and `block` its 64 MiB block. Every
    window item and set operation must take its device executor: the
    spied executors' calls, each of which must return a result."""
    n = REPEATS * per_block
    ids = np.arange(n)
    f0 = ids % per_block
    f1, f2 = truth["f1"], truth["f2"]
    tile = lambda a: np.tile(a, REPEATS)  # noqa: E731
    half = f2 < SQL_HALF

    def partitioned(r):
        _ints("row_number", r["rn"], ids // per_block + 1)
        _ints("SUM(f1)", r["s"], tile(REPEATS * f1))
        same_array("AVG(f1)", r["a"], tile(f1).astype(np.float64))
        _ints("COUNT(*)", r["c"], np.full(n, REPEATS))

    def float_sum(r):
        same_array("SUM(f5) float32",
                   r["s5"], tile(REPEATS * truth["f5_float"]
                                 .astype(np.float64)))

    def ranked(r):
        order = truth["desc_order"]
        key = tile(f2)[order] * per_block + f0[order]
        change = np.r_[True, key[1:] != key[:-1]]
        start = np.maximum.accumulate(np.where(change, np.arange(n), 0))
        rank = np.empty(n, np.int64)
        rank[order] = start + 1
        _ints("RANK()", r["r"], rank)
        lag = r["p"]
        if lag[order[0]] is not None:
            raise AssertionError("LAG of the first row is not NULL")
        prev = np.empty(n, np.int64)
        prev[order[1:]] = tile(f1)[order[:-1]]
        rest = np.delete(np.arange(n), order[0])
        _ints("LAG(f1)", lag[rest], prev[rest])

    def slid(r):
        order = truth["asc_order"]
        srt = np.pad(tile(f1)[order], 3, constant_values=2**62)
        lo = np.lib.stride_tricks.sliding_window_view(srt, 7).min(axis=1)
        want = np.empty(n, np.int64)
        want[order] = lo
        _ints("MIN(f1) ROWS 3 PRECEDING AND 3 FOLLOWING", r["m"], want)

    def union(r):
        _ints("UNION f0", r["f0"], np.arange(per_block))

    def setop(keep):
        def check(r):
            rows = np.flatnonzero(keep)
            _ints("set operation f0", r["f0"], rows)
            _ints("set operation f1", r["f1"], f1[rows])
        return check

    def grouped(r):
        _ints("GROUP BY keys", r["f0"], np.arange(10))
        _ints("COUNT(*)", r["count"], np.full(10, REPEATS))
        _ints("SUM(f1)", r["sum_f1"], REPEATS * f1[:10])

    def joined(r):
        keys = np.flatnonzero(half)
        _ints("JOIN keys", r["k"], keys)
        _ints("JOIN COUNT(*)", r["c"], np.full(keys.size, REPEATS))
        _ints("JOIN SUM(block.f1)", r["s"], REPEATS * f1[keys])

    def in_sub(r):
        _ints("IN (SELECT ...)", r["f0"],
              np.flatnonzero(tile(f1 < SQL_TENTH)) % per_block)

    def analyzed(span):
        def check(text):
            if span not in text:
                raise AssertionError(f"EXPLAIN ANALYZE names no {span}: "
                                     f"{text}")
        return check

    win, dedupe, setop_ = "window_column", "dedupe_keep", "setop_keep_concat"
    over = "OVER (PARTITION BY f0)"
    f5 = {"f5": "float32"}
    return [
        ("window PARTITION BY f0",
         "SELECT f0, ROW_NUMBER() OVER (PARTITION BY f0 ORDER BY f1) AS rn,"
         f" SUM(f1) {over} AS s, AVG(f1) {over} AS a,"
         f" COUNT(*) {over} AS c FROM big", None, partitioned, {win: 4}),
        ("window SUM(f5 float32)",
         f"SELECT SUM(f5) {over} AS s5 FROM big", f5, float_sum, {win: 1}),
        ("window RANK, LAG ORDER BY f2 DESC, f0",
         "SELECT f0, RANK() OVER (ORDER BY f2 DESC, f0) AS r,"
         " LAG(f1) OVER (ORDER BY f2 DESC, f0) AS p FROM big", None, ranked,
         {win: 2}),
        ("window MIN ROWS 3 PRECEDING AND 3 FOLLOWING",
         "SELECT MIN(f1) OVER (ORDER BY f2 ROWS BETWEEN 3 PRECEDING AND"
         " 3 FOLLOWING) AS m FROM big", None, slid, {win: 1}),
        ("UNION", "SELECT f0 FROM big UNION SELECT f0 FROM block", None,
         union, {dedupe: 1}),
        ("INTERSECT",
         "SELECT f0, f1 FROM big INTERSECT SELECT f0, f1 FROM block"
         f" WHERE f2 < {SQL_HALF}", None, setop(half), {setop_: 1}),
        ("EXCEPT",
         "SELECT f0, f1 FROM big EXCEPT SELECT f0, f1 FROM block"
         f" WHERE f2 < {SQL_HALF}", None, setop(~half), {setop_: 1}),
        ("GROUP BY HAVING ORDER BY LIMIT",
         "SELECT f0, COUNT(*), SUM(f1) FROM big GROUP BY f0"
         " HAVING COUNT(*) = 16 ORDER BY f0 LIMIT 10", None, grouped, {}),
        # the WHERE and the group-by push down to each side (the group
        # key is the join key); a plain JOIN would materialize every
        # column of both sides on the host, as the reference's does
        ("JOIN WHERE GROUP BY (pushdown)",
         "SELECT big.f0 AS k, COUNT(*) AS c, SUM(block.f1) AS s FROM big"
         " JOIN block ON big.f0 = block.f0"
         f" WHERE big.f2 < {SQL_HALF} GROUP BY big.f0 ORDER BY k", None,
         joined, {}),
        ("IN (SELECT ...)",
         "SELECT f0 FROM big WHERE f0 IN (SELECT f0 FROM block WHERE"
         f" f1 < {SQL_TENTH})", None, in_sub, {}),
        ("EXPLAIN ANALYZE window",
         f"EXPLAIN ANALYZE SELECT f0, SUM(f1) {over} AS s FROM big", None,
         analyzed("sql.window"), {win: 1}),
        ("EXPLAIN ANALYZE EXCEPT",
         "EXPLAIN ANALYZE SELECT f0 FROM big EXCEPT SELECT f0 FROM block"
         f" WHERE f1 < {SQL_TENTH}", None, analyzed("sql.setop"),
         {setop_: 1}),
    ]


class Spied:
    """Counts a device executor's calls and those that returned None (a
    fall to the host executor)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.calls = self.none = 0

    def __call__(self, *a, **k):
        r = self.real(*a, **k)
        self.calls += 1
        self.none += r is None
        return r

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def run_sql_path(device, block: bytes, index: np.ndarray, per_block: int,
                 path: str) -> dict:
    """Phase 10: SQL (sql, window, setops) on the 1 GiB table through
    both engines' tapes, with the 64 MiB block as the second table; each
    statement once under on_card with its window and set-operation
    executors spied (each must return a device result), its result held
    against the host's truth, then its warm median of 3 (EXPLAIN ANALYZE:
    the time its text reports); the statement that builds its own tapes
    from the files (with the launch counts);
    text keys on the block; a trace of the window statements."""
    import csv_simd_tpu_torch as ct
    from csv_simd_tpu_torch import _kernels, setops, window
    from csv_simd_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    truth = sql_truth(block, index, per_block)
    statements = sql_statements(truth, per_block)
    out = {"times": {}, "launches": {}}
    block_path = os.path.join(tempfile.gettempdir(),
                              "csv_simd_torch_smoke_sql_block.csv")
    with open(block_path, "wb") as f:
        f.write(block)
    modules = {"window_column": window, "dedupe_keep": setops,
               "setop_keep_concat": setops}

    def checked(what, q, tables, schema, check, executors, watch=True,
                **kw):
        def run():
            return ct.sql(q, tables=tables, schema=schema, device=device,
                          **kw)

        with contextlib.ExitStack() as stack:
            spies = [stack.enter_context(Spied(modules[name], name))
                     for name in modules]
            res = on_card(what, run) if watch else run()
        for s in spies:
            want = executors.get(s.name, 0)
            if s.calls < want or s.none:
                raise AssertionError(
                    f"{what}: {s.name} returned a device result "
                    f"{s.calls - s.none} times of {s.calls}, want {want}")
        check(res)
        return res

    # the entry point builds its tapes from the files, with the launch
    # counts set to 0 just before (not under the watch: a build stages
    # the file in pinned host memory)
    need_kernels = {"packed": ("stage1_v4", "row_prefix"),
                    "offsets": ("stage1_fold",)}
    grouped = next(st for st in statements if st[0].startswith("GROUP"))
    for engine, kernels in need_kernels.items():
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        checked(f"{engine} from the files", grouped[1],
                {"big": path, "block": block_path}, None, grouped[3], {},
                watch=False, engine=engine)
        out[f"from_files_s_{engine}"] = time.perf_counter() - t0
        out["launches"][engine] = _kernels.launch_counts()
        for name in kernels:
            need(out["launches"][engine], name, 1, f"sql engine={engine}")

    tapes = {
        "packed": (ct.create_packed(path, device=device),
                   ct.create_packed(block_path, device=device)),
        "offsets": tuple(ct.DeviceTape.from_tape(
            ct.create(p, backend="cuda", device=device), device=device)
            for p in (path, block_path)),
    }
    out["analyze"] = {}
    for engine, (big, blk) in tapes.items():
        tables = {"big": big, "block": blk}
        times = out["times"][engine] = {}
        for name, q, schema, check, executors in statements:
            res = checked(f"{engine} {name}", q, tables, schema, check,
                          executors)
            if name.startswith("EXPLAIN"):
                # its statement is timed above; the text times its run
                # under the watch
                out["analyze"][f"{engine} {name}"] = next(
                    ln for ln in res.splitlines() if "executed in" in ln)
                continue
            times[name] = median_s(lambda: ct.sql(
                q, tables=tables, schema=schema, device=device))

    # text keys on the 64 MiB block: the reference factorizes them on
    # the host, one Python str a row
    keys, inv, counts = np.unique(truth["f3"], return_inverse=True,
                                  return_counts=True)
    rank = np.empty(per_block, np.int64)
    seen = np.zeros(keys.size, np.int64)
    for i, k in enumerate(inv):
        seen[k] += 1
        rank[i] = seen[k]

    def text_window(r):
        _ints("ROW_NUMBER over f3", r["rn"], rank)
        _ints("COUNT(*) over f3", r["c"], counts[inv])

    q = ("SELECT f3, ROW_NUMBER() OVER (PARTITION BY f3 ORDER BY f0) AS rn,"
         " COUNT(*) OVER (PARTITION BY f3) AS c FROM block")
    blk = tapes["packed"][1]
    checked("text keys", q, {"block": blk}, None, text_window,
            {"window_column": 2})
    out["times"]["text"] = {"window PARTITION BY f3 (block)": median_s(
        lambda: ct.sql(q, tables={"block": blk}, device=device))}
    out["text_keys"] = int(keys.size)

    # where the window statements' time goes, on the packed tape
    big, blk = tapes["packed"]
    with tempfile.TemporaryDirectory() as trace_dir:
        with profiling.device_trace(trace_dir):
            for name, q, schema, _check, _ex in statements[:4]:
                with profiling.named(name):
                    ct.sql(q, tables={"big": big, "block": blk},
                           schema=schema, device=device)
        per, busy = _device_ops(os.path.join(trace_dir,
                                             profiling.TRACE_FILE))
    out["trace_busy"] = busy
    out["trace_top"] = sorted(per.items(), key=lambda kv: -kv[1][0])[:6]
    out["trace_device_ms"] = sum(ms for ms, _ in per.values())
    out["rows"] = REPEATS * per_block
    out["statements"] = len(statements)
    del tapes, big, blk
    os.remove(block_path)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


SHARDS = 4          # the sharded tapes' mesh: 4 shards on the one card
BIG_REPEATS = 40    # copies of the block's rows in the 2.5 GiB table
MESH_SIZES = (1, 2, 3, 4, 5, 8)


def gate_quote_parity(gate: Gate, device, cases) -> None:
    """S1 (csrc/shard_parity.cu) against its plain version on the card:
    the corpus, random bytes at quote densities 0, 1/64 and 1/2 on shards
    of 8 to 4,104 rows for three quote bytes, and one quote at the first,
    middle and last byte of sizes at the kernel's block and grid-step
    edges (1,024 chunks of 16 bytes a block step, 8 blocks an SM)."""
    from csv_simd_tpu_torch import _kernels
    from csv_simd_tpu_torch.config import Dialect
    from csv_simd_tpu_torch.parallel.sharded import (
        _local_parity_plain,
        pad_words_for_mesh,
    )

    def check(w: torch.Tensor, what: str, quote: int = 0x22) -> None:
        gate.same("quote_parity", _kernels.quote_parity(w, quote),
                  _local_parity_plain(w, Dialect(quote=quote)), what)

    for c in cases:
        w = pad_words_for_mesh(np.frombuffer(c.data, np.uint8), 1)
        check(torch.from_numpy(w).to(device), f"corpus {c.name}")
    rng = np.random.default_rng(14)
    for rows in (8, 16, 24, 72, 520, 1000, 1024, 1032, 4096, 4104):
        for density in (0.0, 1 / 64, 0.5):
            for quote in (0x22, 0x27, 0xA2):
                b = rng.integers(0, 256, rows * 512, dtype=np.uint8)
                b = np.where(b == quote, quote ^ 1, b)
                b = np.where(rng.random(b.size) < density, quote, b)
                w = torch.from_numpy(b.astype(np.uint8).view(np.int32))
                check(w.to(device), f"{rows} rows at density {density:.4f} "
                      f"of {quote:#x}", quote)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    step = 8 * sms * 1024
    for chunks in (1, 2, 1023, 1024, 1025, 4097, step - 1, step, step + 1,
                   3 * step + 5):
        n = 16 * chunks
        for at in (0, n // 2, n - 1):
            t = torch.zeros(n, dtype=torch.uint8, device=device)
            t[at] = 0x22
            check(t.view(torch.int32), f"one quote at {at} of {n} bytes")


def check_sharded_stage1(device, block: bytes, index: np.ndarray,
                         want_mask: np.ndarray) -> dict:
    """sharded_stage1 on the 64 MiB block at 1, 2, 3, 4, 5 and 8 shards
    in the three layouts, each equal to the one-device kernel's words on
    the same padded input (B3 at tile 512, B1 narrow, B1 wide), its counts
    to golden's and its parity to golden's, and at 3 and 8 shards the
    words to golden's mask; the JAX test's 60 KB quoted span across every
    shard cut at 2, 4 and 8 shards against golden. Returns the launches
    of the checked runs."""
    from csv_simd_tpu_torch import golden
    from csv_simd_tpu_torch.ops.stage1_v3 import stage1_fused
    from csv_simd_tpu_torch.parallel.sharded import (
        _fold_offsets,
        make_mesh,
        pad_words_for_mesh,
        sharded_stage1,
    )
    from csv_simd_tpu_torch.ops.stage1_v4 import stage1_fused_v4

    arr = np.frombuffer(block, np.uint8)
    n_struct = index.size - 1
    parity = golden.quote_parity_out(arr)
    nonascii = int((arr >= 0x80).sum())
    launches = {}

    def one_device(w2d, layout):
        if layout == "fold":
            return stage1_fused(w2d, 0)[0]
        if layout == "seq":
            return stage1_fused_v4(w2d, 0, count_nonascii=False)[0]
        return stage1_fused_v4(w2d.view(-1, 1024), 0, count_nonascii=False,
                               out_mode="wide_native")[0]

    for n in MESH_SIZES:
        w2d = torch.from_numpy(pad_words_for_mesh(arr, n)).to(device)
        mesh = make_mesh(n, device="cuda")
        for layout in ("fold", "seq", "seq_wide"):
            x = w2d.view(-1, 1024) if layout == "seq_wide" else w2d
            out, launched = driven(sharded_stage1, x, 0, mesh, layout=layout,
                                   count_nonascii=True)
            need(launched, "quote_parity", n, f"sharded_stage1 {layout} {n}")
            launches = _sum({0: launches, 1: launched})
            packed, counts, excl, total, par, na = out
            what = f"sharded_stage1({layout}) at {n} shards, 64 MiB"
            if not torch.equal(torch.cat(packed), one_device(w2d, layout)):
                raise AssertionError(f"{what}: words differ from one device's")
            sums = counts.cpu().numpy().astype(np.int64)
            if (int(total), int(sums.sum()), int(par)) != (n_struct, n_struct,
                                                           parity):
                raise AssertionError(f"{what}: total {int(total)}, parity "
                                     f"{int(par)}")
            if not np.array_equal(excl.cpu().numpy(),
                                  np.cumsum(sums) - sums):
                raise AssertionError(f"{what}: exclusive offsets differ")
            if layout != "fold" and int(na.cpu().sum()) != nonascii:
                raise AssertionError(f"{what}: non-ASCII count differs")
            if n in (3, 8):
                if layout == "fold":
                    same_array(what, np.concatenate(
                        _fold_offsets(packed, arr.size)), index[1:])
                else:
                    same_array(what, _unpack(torch.cat(packed), arr.size),
                               want_mask)
        del w2d
    inner = "x," * 30000
    span = np.frombuffer(f'a,b\n"{inner}end",2\nq,w\n'.encode(), np.uint8)
    want = golden.structural_mask(span)
    for n in (2, 4, 8):
        w2d = torch.from_numpy(pad_words_for_mesh(span, n)).to(device)
        for layout in ("fold", "seq", "seq_wide"):
            x = w2d.view(-1, 1024) if layout == "seq_wide" else w2d
            packed = sharded_stage1(x, 0, make_mesh(n, device="cuda"),
                                    layout=layout)[0]
            what = f"the 60 KB quoted span, {layout} at {n} shards"
            if layout == "fold":
                same_array(what, np.concatenate(
                    _fold_offsets(packed, span.size)), np.flatnonzero(want))
            else:
                same_array(what, _unpack(torch.cat(packed), span.size), want)
    return launches


def check_quote_across_cuts(device, data: np.ndarray, size: int) -> None:
    """The 1 GiB table with a quote open across each cut of a 4-shard
    build (a byte before each cut set so that the quotes before the cut
    are odd): the fold and wide layouts at 4 shards equal B3's and B1's
    words over the whole input on one device, parities too."""
    from csv_simd_tpu_torch.offsetfree import _to_device
    from csv_simd_tpu_torch.ops.stage1_v3 import stage1_fused
    from csv_simd_tpu_torch.ops.stage1_v4 import stage1_fused_v4
    from csv_simd_tpu_torch.parallel.sharded import (
        _mesh_rows,
        make_mesh,
        sharded_stage1,
    )

    b = _to_device(data, _mesh_rows(size, SHARDS) * 512, device)
    cut = b.numel() // SHARDS
    for k in range(1, SHARDS):
        c = k * cut
        odd = int((b[:c - 1] == 0x22).sum()) & 1
        b[c - 1] = 0x78 if odd else 0x22
        if int((b[:c] == 0x22).sum()) & 1 != 1:
            raise AssertionError(f"no quote open across cut {k}")
    w2d = b.view(torch.int32).view(-1, 128)
    mesh = make_mesh(SHARDS, device="cuda")
    fold = sharded_stage1(w2d, 0, mesh, layout="fold")
    ref, ref_par = stage1_fused(w2d, 0)
    if not torch.equal(torch.cat(fold[0]), ref) or int(fold[4]) != \
            int(ref_par):
        raise AssertionError("fold words with quotes open across the cuts "
                             "differ from B3's")
    del fold, ref
    wide = sharded_stage1(w2d.view(-1, 1024), 0, mesh, layout="seq_wide")
    ref, ref_par, _ = stage1_fused_v4(w2d.view(-1, 1024), 0,
                                      count_nonascii=False,
                                      out_mode="wide_native")
    if not torch.equal(torch.cat(wide[0]), ref) or int(wide[4]) != \
            int(ref_par):
        raise AssertionError("wide words with quotes open across the cuts "
                             "differ from B1's")


def big_table(block: bytes) -> tuple:
    """The 2.5 GiB table in host memory: the block's header, then its data
    rows BIG_REPEATS times. Returns (bytes as uint8, header length)."""
    header_len = block.index(b"\n") + 1
    rows = np.frombuffer(block, np.uint8)[header_len:]
    out = np.empty(header_len + BIG_REPEATS * rows.size, np.uint8)
    out[:header_len] = np.frombuffer(block[:header_len], np.uint8)
    out[header_len:].reshape(BIG_REPEATS, rows.size)[:] = rows
    return out, header_len


def run_sharded_path(gate: Gate, device, block: bytes, index: np.ndarray,
                     per_block: int, path: str, want_mask: np.ndarray,
                     block_words: torch.Tensor) -> dict:
    """Phase 11: sharding. S1 gated against its plain version;
    sharded_stage1 on the 64 MiB block and the quoted spans;
    build_index_sharded and the sharded streaming build of the 1 GiB
    table; ShardedTape and ShardedPackedTape of it (words, prefix,
    artifact, lookups); then the headline, a ShardedPackedTape of the
    2.5 GiB table on 4 shards: lookups past byte 2^31, the whole f0
    column, its stats, a groupby and a SQL GROUP BY, each once under
    device_watch and held against the block's truth; then the times and
    a trace of a warm 2.5 GiB build."""
    import csv_simd_tpu_torch as ct
    from csv_simd_tpu_torch import _kernels
    from csv_simd_tpu_torch.config import DEFAULT_DIALECT as d
    from csv_simd_tpu_torch.offsetfree import (
        PackedDeviceTape,
        _to_device,
        prefix_for_packed,
    )
    from csv_simd_tpu_torch.ops.stage1_v2 import ROW_BYTES, padded_rows
    from csv_simd_tpu_torch.parallel.serving import (
        ShardedPackedTape,
        ShardedTape,
    )
    from csv_simd_tpu_torch.parallel.sharded import (
        _STAGE_BYTES,
        _local_parity_plain,
        build_index_sharded,
        make_mesh,
    )
    from csv_simd_tpu_torch.streaming import build_index_sharded_streaming
    from csv_simd_tpu_torch.tools._common import cuda_ms, graph_ms
    from csv_simd_tpu_torch.utils import profiling
    from corpus import all_cases

    t_phase = time.perf_counter()
    out = {"times": {}}
    times = out["times"]
    gate_quote_parity(gate, device, all_cases())
    gate.same("quote_parity", _kernels.quote_parity(block_words, d.quote),
              _local_parity_plain(block_words, d), "the 64 MiB block")
    out["stage1_launches"] = check_sharded_stage1(device, block, index,
                                                  want_mask)
    size = os.path.getsize(path)
    data = np.memmap(path, dtype=np.uint8, mode="r")
    check_quote_across_cuts(device, data, size)
    mesh = make_mesh(SHARDS, device="cuda")
    rows_len = len(block) - (block.index(b"\n") + 1)

    # the index builds of the 1 GiB table at 4 shards
    got, launched = driven(build_index_sharded, data, mesh)
    need(launched, "quote_parity", SHARDS, "build_index_sharded")
    need(launched, "stage1_fold", SHARDS, "build_index_sharded")
    check_index(got, index, rows_len)
    del got
    got, launched = driven(build_index_sharded_streaming, path, mesh,
                           chunk_bytes=BLOCK_BYTES)
    n_chunks = -(-size // BLOCK_BYTES)
    need(launched, "quote_parity", SHARDS * n_chunks, "sharded streaming")
    need(launched, "stage1_fold", SHARDS * n_chunks, "sharded streaming")
    check_index(got, index, rows_len)
    del got
    out["index_launches"] = launched

    # ShardedTape of the 1 GiB create tape
    host_tape = ct.create(path, backend="cuda", device=device)
    st = ShardedTape.from_tape(host_tape, mesh)
    del host_tape
    out["sharded_tape_lookups"] = check_lookups(st, data, index, rows_len,
                                                per_block, 5150, device)
    del st

    # ShardedPackedTape of the 1 GiB table against create_packed
    spt, launched = driven(ShardedPackedTape, data, mesh)
    for name in ("quote_parity", "stage1_v4", "row_prefix"):
        if launched[name] != SHARDS:
            raise AssertionError(f"ShardedPackedTape at 1 GiB: {name} "
                                 f"launched {launched[name]} times")
    ref = ct.create_packed(path, device=device)
    flat = torch.cat([w.reshape(-1) for w in spt.words])
    n_ref = ref.words.numel()
    if not (torch.equal(flat[:n_ref], ref.words.reshape(-1))
            and not bool(flat[n_ref:].any())):
        raise AssertionError("sharded words differ from create_packed's")
    prefix = prefix_for_packed(ref.words)
    if not (torch.equal(spt.cum_incl[:prefix.numel()], prefix)
            and bool((spt.cum_incl[prefix.numel():] == prefix[-1]).all())):
        raise AssertionError("sharded row prefix differs from B2's")
    del flat, prefix, ref
    out["packed_lookups_1GiB"] = check_lookups(spt, data, index, rows_len,
                                               per_block, 6160, device)
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "sharded_seq.npz")
        spt.save(art)
        loaded = PackedDeviceTape.load(art, data, device=device)
        recs = torch.randint(0, REPEATS * per_block, (BATCH,),
                             dtype=torch.int32, device=device)
        flds = torch.randint(0, N_FIELDS, (BATCH,), dtype=torch.int32,
                             device=device)
        for a, b in zip(loaded.gather_fields(recs, flds, MAX_LEN),
                        spt.gather_fields(recs, flds, MAX_LEN)):
            if not torch.equal(a, b):
                raise AssertionError("the loaded artifact serves other bytes")
        del loaded
    del spt

    # the times at 1 GiB: S1 (64 MiB from graphs and eager, 1 GiB by
    # events, beside its plain version and one library call); the builds
    words = _to_device(data, padded_rows(size) * ROW_BYTES,
                       device).view(torch.int32)
    gate.same("quote_parity", _kernels.quote_parity(words, d.quote),
              _local_parity_plain(words, d), "the 1 GiB table")
    s1 = lambda w: _kernels.quote_parity(w, d.quote)  # noqa: E731
    out["s1_ms_64MiB"] = graph_ms(lambda: s1(block_words), 20)
    out["s1_eager_ms_64MiB"] = cuda_ms(lambda: s1(block_words), 20)
    out["ms"] = cuda_ms(lambda: s1(words), 20)
    out["plain_ms"] = cuda_ms(lambda: _local_parity_plain(words, d), 3)
    out["library_ms"] = cuda_ms(lambda: (words.view(torch.uint8) == d.quote)
                                .sum(dtype=torch.int32) & 1, 5)
    out["timed_bytes"] = words.numel() * 4
    del words
    times["ShardedPackedTape 1 GiB"] = warm_s(
        lambda: ShardedPackedTape(data, mesh))
    times["create_packed 1 GiB"] = warm_s(
        lambda: ct.create_packed(path, device=device))
    times["build_index_sharded 1 GiB"] = warm_s(
        lambda: build_index_sharded(data, mesh))
    times["build_index (create's index) 1 GiB"] = warm_s(
        lambda: ct.build_index(data, backend="cuda", device=device))
    times["sharded streaming 1 GiB"] = warm_s(
        lambda: build_index_sharded_streaming(path, mesh,
                                              chunk_bytes=BLOCK_BYTES), 2)
    del data
    gc.collect()
    torch.cuda.empty_cache()

    # the headline: the 2.5 GiB table on 4 shards
    big, header_len = big_table(block)
    out["big_bytes"] = big.size
    n_records = BIG_REPEATS * per_block
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tape, launched = driven(ShardedPackedTape, big, mesh)
    out["big_first_s"] = time.perf_counter() - t0
    for name in ("quote_parity", "stage1_v4", "row_prefix"):
        if launched[name] != SHARDS:
            raise AssertionError(f"ShardedPackedTape at 2.5 GiB: {name} "
                                 f"launched {launched[name]} times")
    out["launches"] = launched
    for k, shard in enumerate(tape.data):
        w = shard.view(torch.int32)
        gate.same("quote_parity", _kernels.quote_parity(w, d.quote),
                  _local_parity_plain(w, d), f"shard {k} of the 2.5 GiB table")
    shard_bytes = tape.shard_rows * 512
    if tape.record_cnt != n_records + 1 or shard_bytes >= 2**31:
        raise AssertionError(f"2.5 GiB tape: {tape.record_cnt} records, "
                             f"{tape.shard_rows} rows a shard")
    # records from copy `far` on start past byte 2^31
    far = -(-(2**31 - header_len) // rows_len)
    start, _ = truth(index, rows_len, per_block,
                     np.array([far * per_block]), np.array([0]))
    if start[0] < 2**31:
        raise AssertionError("the far records start below byte 2^31")
    out["far_record"] = far * per_block
    on_card("2.5 GiB lookups", lambda: check_lookups(
        tape, big, index, rows_len, per_block, 7170, device, BIG_REPEATS))
    on_card("2.5 GiB lookups past byte 2^31", lambda: check_lookups(
        tape, big, index, rows_len, per_block, 7171, device, BIG_REPEATS,
        rec_lo=far * per_block, batches=1))
    out["big_lookups"] = check_lookups(tape, big, index, rows_len, per_block,
                                       7172, device, BIG_REPEATS)
    arr = np.frombuffer(block, np.uint8)
    f1 = np.array(block_fields(arr, index, per_block, 1)).astype(np.int64)
    ids = np.arange(per_block)

    def column(r):
        vals, ok = r
        if not bool(ok.all()):
            raise AssertionError("2.5 GiB column_int32(f0): a field refused")
        same_array("2.5 GiB column_int32(f0)", vals.cpu().numpy(),
                   np.tile(ids.astype(np.int32), BIG_REPEATS))

    def grouped(g):
        same_array("2.5 GiB group keys", g["keys"], ids.astype(np.int32))
        same_array("2.5 GiB group counts", g["count"],
                   np.full(per_block, BIG_REPEATS))
        same_array("2.5 GiB group sums", g["sum"], BIG_REPEATS * f1)
        same_array("2.5 GiB group min", g["min"], f1.astype(np.int32))
        same_array("2.5 GiB group max", g["max"], f1.astype(np.int32))

    def sql_grouped(r):
        same_array("2.5 GiB SQL keys", np.asarray(r["f0"]).astype(np.int64),
                   np.arange(10))
        same_array("2.5 GiB SQL COUNT(*)", np.asarray(r["count"])
                   .astype(np.int64), np.full(10, BIG_REPEATS))
        same_array("2.5 GiB SQL SUM(f1)", np.asarray(r["sum_f1"])
                   .astype(np.int64), BIG_REPEATS * f1[:10])

    q = ("SELECT f0, COUNT(*), SUM(f1) FROM big GROUP BY f0"
         f" HAVING COUNT(*) = {BIG_REPEATS} ORDER BY f0 LIMIT 10")
    for name, fn, check in (
            ("column_int32(f0)", lambda: tape.column_int32(0), column),
            ("column_stats(f0)", lambda: ct.column_stats(tape, "f0"),
             lambda st: check_stats(st, ids, "2.5 GiB column_stats(f0)",
                                    BIG_REPEATS)),
            ("groupby_typed(f0, f1)",
             lambda: ct.groupby_typed(tape, "f0", "f1"), grouped),
            ("SQL GROUP BY f0", lambda: ct.sql(q, tables={"big": tape},
                                               device=device), sql_grouped)):
        check(on_card(f"2.5 GiB {name}", fn))
        times[f"2.5 GiB {name}"] = [median_s(fn)]
    del tape
    torch.cuda.empty_cache()
    times["ShardedPackedTape 2.5 GiB"] = warm_s(
        lambda: ShardedPackedTape(big, mesh))
    with tempfile.TemporaryDirectory() as trace_dir:
        with profiling.device_trace(trace_dir):
            traced = ShardedPackedTape(big, mesh)
        per, busy = _device_ops(os.path.join(trace_dir, profiling.TRACE_FILE))
    del traced, big
    gc.collect()
    torch.cuda.empty_cache()
    names = {"quote_parity": 0, "mask_pack": 0, "row_prefix_local": 0}
    for name, (_, k) in per.items():
        for key in names:
            names[key] += k if key in name else 0
    if set(names.values()) != {SHARDS}:
        raise AssertionError(f"the 2.5 GiB build's trace: {names}")
    # the copies the build makes: one a pinned buffer of a shard's bytes
    # (a trace late in a long run has come back with some of them only)
    out["trace_copies"] = (
        sum(k for name, (_, k) in per.items() if "HtoD" in name),
        sum(-(-min(max(out["big_bytes"] - k * shard_bytes, 0), shard_bytes)
              // _STAGE_BYTES) for k in range(SHARDS)))
    out["trace_busy"] = busy
    out["trace_device_ms"] = sum(t for t, _ in per.values())
    out["trace_top"] = sorted(per.items(), key=lambda kv: -kv[1][0])[:6]
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def driven(fn, *args, **kw) -> tuple:
    """fn's result and the launch counts of its run alone."""
    from csv_simd_tpu_torch import _kernels

    _kernels.reset_launch_counts()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, _kernels.launch_counts()


def _sum(per_size: dict) -> dict:
    """Launch counts of several driven runs, added."""
    out = {}
    for launches in per_size.values():
        for k, v in launches.items():
            out[k] = out.get(k, 0) + v
    return out


def nonzero(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if v}


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
        _row_emits_plain,
        _stage1_v4_plain,
        stage1_fused_v4,
    )
    from csv_simd_tpu_torch.tools import (
        ablate,
        ablate2,
        dma_probe,
        kbench,
        mosaic_probes,
        vnext,
        vpu_roofline,
        widestore_probe,
        widestore_probe2,
        widestore_probe3,
        widestore_probe4,
    )
    from csv_simd_tpu_torch.tools._common import card as card_info
    from csv_simd_tpu_torch.tools._common import (
        cuda_ms,
        graph_ms,
        random_words,
        report_probes,
    )
    from csv_simd_tpu_torch.utils import profiling
    from corpus import all_cases, synthetic_wide_table

    t_run = time.perf_counter()
    device = DEVICE
    card = card_info()["card"]
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
    gate_stage1_repeats(gate, device)
    arrays = [(f"corpus {c.name}", np.frombuffer(c.data, dtype=np.uint8))
              for c in cases] + fuzz_arrays()
    gate_pack(gate, device, arrays, golden)
    blk = gate_pack_block(gate, device, block, golden)
    gate_relayouts(gate, device, golden)
    # the direct fold pack at 64 MiB against B3 and golden, at the tiles
    # of both its routes
    for tile in vnext.TILES:
        gate.record("vnext", vnext.check(blk["words"], tile=tile))
    gate_probes(gate, device)
    gate_products(gate, device)
    if not report_probes(widestore_probe2.PROBES + widestore_probe3.PROBES
                         + widestore_probe4.PROBES, device):
        raise AssertionError("a wide-store probe is not bit-exact")
    mosaic = mosaic_probes.report(device)
    if set(mosaic.values()) != {"fixed"}:
        raise AssertionError(f"a Mosaic probe is not fixed: {mosaic}")
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
    ms["stage1_v4"] = cuda_ms(lambda: stage1_fused_v4(
        words.view(-1, 1024), 0, d, count_nonascii=False,
        out_mode="wide_native"), 20)
    ms["stage1_v4_plain"] = cuda_ms(
        lambda: _stage1_v4_plain(words, 0, d, False), 3)
    ms["row_prefix"] = cuda_ms(lambda: prefix_for_packed(packed), 50)
    ms["row_prefix_plain"] = cuda_ms(
        lambda: _prefix_for_packed_xla(packed), 10)
    ms["stage1_fold"] = cuda_ms(lambda: stage1_fused(w2d, 0), 20)
    ms["stage1_fold_plain"] = cuda_ms(lambda: stage1_swar_xla(w2d, 0), 3)
    bw, bb = blk["words"], blk["bytes"]
    bw_bytes, bb_bytes = bw.numel() * 4, bb.numel()
    ms["stage1_seq"] = cuda_ms(lambda: stage1_fused_seq(bw, 0), 20)
    ms["stage1_seq_plain"] = cuda_ms(lambda: stage1_seq_xla(bw, 0), 5)
    # B5 from CUDA graphs (the kernel alone; its `ms` is the 64 MiB one)
    # beside its eager times, at 64 MiB and 1 GiB
    ms["stage1_v2"] = graph_ms(lambda: stage1_pallas_v2(bw, 0), 20)
    ms["stage1_v2_eager"] = cuda_ms(lambda: stage1_pallas_v2(bw, 0), 20)
    ms["stage1_v2_1GiB"] = graph_ms(lambda: stage1_pallas_v2(w2d, 0), 20)
    ms["stage1_v2_1GiB_eager"] = cuda_ms(lambda: stage1_pallas_v2(w2d, 0),
                                         20)
    ms["stage1_v2_plain"] = cuda_ms(lambda: stage1_swar_jnp(bw, 0), 5)
    # B3 and B6 at 64 MiB from CUDA graphs (the kernels alone; B6's is its
    # `ms`) beside their eager times, which the wrappers' host work sets
    # at this size
    ms["stage1_fold_64MiB"] = graph_ms(lambda: stage1_fused(bw, 0), 20)
    ms["stage1_fold_64MiB_eager"] = cuda_ms(lambda: stage1_fused(bw, 0), 20)
    ms["stage1_v1"] = graph_ms(lambda: stage1_pallas(bb, 0), 20)
    ms["stage1_v1_eager"] = cuda_ms(lambda: stage1_pallas(bb, 0), 20)
    ms["stage1_v1_plain"] = cuda_ms(
        lambda: _stage1_pallas_plain(bb, 0, d), 5)

    # phase 6: the measurement path. Each tool's check holds its kernels
    # against their plain versions on the input it then times (recorded
    # in the gate); each run has the launch counts set to 0 just before
    # it and read just after.
    got = stage1_fused_v4(words.view(-1, 1024), 0, d, count_nonascii=False,
                          out_mode="wide_native", emit_prefix=True)
    gate.same("stage1_v4_emit", got[0], packed, "1 GiB words vs B1's")
    gate.same("stage1_v4_emit", got[3], prefix_for_packed(packed),
              "1 GiB fused prefix vs B2's")
    del got
    ab, l_ab = {}, {}
    for at, w in (("64 MiB", bw), ("1 GiB", w2d)):
        gate.record("stage1_v4_emit", widestore_probe.check(w))
        ab[at], l_ab[at] = driven(widestore_probe.run, w)
        need(l_ab[at], "stage1_v4_emit", 1,
             f"widestore_probe.run at {at}")
    ms["stage1_v4_emit"] = ab["1 GiB"]["buildf"]["ms"]
    ms["stage1_v4_emit_plain"] = cuda_ms(lambda: _row_emits_plain(
        _stage1_v4_plain(words, 0, d, False)[0]), 2)
    stream, l_dma1, l_dma2w, l_dma2r = {}, {}, {}, {}
    abl, l_abl = {}, {}
    ab2, l_ab2, kb, l_kb, vn, l_vn = {}, {}, {}, {}, {}, {}
    ws2, l_ws2, ws3, l_ws3, ws4, l_ws4 = {}, {}, {}, {}, {}, {}
    rnd = {"64 MiB": random_words(BLOCK_BYTES // 512, device, 64),
           "1 GiB": random_words(16 * BLOCK_BYTES // 512, device, 1024)}
    for at, w in rnd.items():
        gate.record("dma_probe", dma_probe.check_write(
            w, dma_probe.DMA_PROBE_MODES))
        t1, l_dma1[at] = driven(dma_probe.run_write, w,
                                dma_probe.DMA_PROBE_MODES)
        need(l_dma1[at], "probe_stream_write", 2, f"dma_probe at {at}")
        gate.record("dma_probe2.write", dma_probe.check_write(w))
        t2, l_dma2w[at] = driven(dma_probe.run_write, w)
        need(l_dma2w[at], "probe_stream_write", 4,
             f"dma_probe2 write at {at}")
        gate.record("dma_probe2.read", dma_probe.check_read(w))
        rd, l_dma2r[at] = driven(dma_probe.run_read, w)
        need(l_dma2r[at], "probe_stream_read", 1,
             f"dma_probe2 read at {at}")
        stream[at] = {"dma_probe": t1, "dma_probe2": {**t2, "read": rd}}
        gate.record("ablate", ablate.check(w))
        abl[at], l_abl[at] = driven(ablate.run, w)
        need(l_abl[at], "probe_ablate", len(ablate.MODES),
             f"ablate.run at {at}")
        # the labs: B1's stage cuts, the v1 variants on the same random
        # words as bytes, the direct fold pack
        gate.record("ablate2", ablate2.check(w))
        ab2[at], l_ab2[at] = driven(ablate2.run, w)
        need(l_ab2[at], "probe_ablate2", len(_kernels.ABLATE2_CUTS),
             f"ablate2.run at {at}")
        gate.record("kbench", kbench.check(kbench.as_bytes(w)))
        kb[at], l_kb[at] = driven(kbench.run, kbench.as_bytes(w))
        need(l_kb[at], "probe_kbench", 4, f"kbench.run at {at}")
        for tile in vnext.TILES:
            gate.record("vnext", vnext.check_timed(w, tile))
        vn[at], l_vn[at] = driven(vnext.run, w)
        need(l_vn[at], "probe_vnext", 2 * len(vnext.TILES),
             f"vnext.run at {at}")
        # the wide-store probes: the gather and mmL on the (rows, 128)
        # words, the lane sum and mmLb on their (rows/8, 1024) view
        for tool, x, times, launched, kernels in (
                (widestore_probe2, w, ws2, l_ws2,
                 ("probe_ws_gather", "probe_ws_packmm")),
                (widestore_probe3, w.view(-1, 1024), ws3, l_ws3,
                 ("probe_ws_lanesum", "probe_ws_packmm"))):
            prefix = tool.__name__.rsplit(".", 1)[1]
            for name, result in tool.check(x).items():
                gate.record(f"{prefix}.{name}", result)
            times[at], launched[at] = driven(tool.run, x)
            for kernel in kernels:
                need(launched[at], kernel, 1, f"{prefix}.run at {at}")
        # the concat product on the (rows/8, 1024) view, as T10b/T11b
        gate.record("widestore_probe4.concat_mm",
                    widestore_probe4.check(w.view(-1, 1024))["concat_mm"])
        ws4[at], l_ws4[at] = driven(widestore_probe4.run, w.view(-1, 1024))
        need(l_ws4[at], "probe_concat_mm", 1, f"widestore_probe4.run at {at}")
    ms["ablate2"] = ab2["1 GiB"]["v4full:512"]["ms"]
    ms["ablate2_plain"] = ab2["1 GiB"]["v4full:512"]["plain_ms"]
    ms["kbench"] = kb["1 GiB"]["roll:1024"]["ms"]
    ms["kbench_plain"] = kb["1 GiB"]["roll:1024"]["plain_ms"]
    # T8's own kernel: the direct pack at tile 128 (at 512 it is B3's pair)
    ms["vnext"] = vn["1 GiB"]["directpack:128"]["ms"]
    ms["vnext_plain"] = vn["1 GiB"]["directpack:128"]["plain_ms"]
    for prefix, times in (("widestore_probe2", ws2),
                          ("widestore_probe3", ws3)):
        for name, v in times["1 GiB"].items():
            ms[f"{prefix}.{name}"] = v["ms"]
            ms[f"{prefix}.{name}_plain"] = v["plain_ms"]
    # the library calls that compute a probe's function: the read
    # probe's (64, 128)-block sums are one int32 sum; the gather is a
    # strided copy, the lane sum one int32 sum; with the probes' weights,
    # whose block products lie in disjoint columns, each pack product is
    # the int8 cast and one int8 product, the weights laid out once in
    # the column-major order cuBLASLt takes (timed from CUDA graphs, as
    # the wide-store kernels are)
    big_w = rnd["1 GiB"]
    library_ms = {"dma_probe2.read": cuda_ms(lambda: big_w.view(
        -1, 64 * 128).sum(1, dtype=torch.int32), 20)}
    w_l = widestore_probe2.weights_mmL().to(device).t().contiguous().t()
    w_lb = widestore_probe3.weights_mmLb().to(device).t().contiguous().t()
    library_ms.update({
        "widestore_probe2.s8_st16": graph_ms(lambda: big_w.view(
            -1, 8, 128)[:, :, :16].reshape(-1, 128), 20),
        "widestore_probe3.laneload": graph_ms(lambda: big_w.view(
            -1, 8, 128).sum(1, dtype=torch.int32), 20),
        "widestore_probe2.mmL": graph_ms(lambda: torch._int_mm(
            big_w.to(torch.int8).view(-1, 1024), w_l), 20),
        "widestore_probe3.mmLb": graph_ms(lambda: torch._int_mm(
            big_w.view(-1, 1024).to(torch.int8), w_lb), 20)})
    del big_w
    t12 = ws4["1 GiB"]["concat_mm"]
    ms["widestore_probe4.concat_mm"] = t12["ms"]
    ms["widestore_probe4.concat_mm_plain"] = t12["plain_ms"]
    library_ms["widestore_probe4.concat_mm"] = t12["library_ms"]
    big = stream["1 GiB"]
    ms["dma_probe"] = big["dma_probe"]["narrow"]["ms"]
    ms["dma_probe_plain"] = big["dma_probe"]["narrow"]["plain_ms"]
    ms["dma_probe2.write"] = big["dma_probe2"]["tall8"]["ms"]
    ms["dma_probe2.write_plain"] = big["dma_probe2"]["tall8"]["plain_ms"]
    ms["dma_probe2.read"] = big["dma_probe2"]["read"]["ms"]
    ms["dma_probe2.read_plain"] = big["dma_probe2"]["read"]["plain_ms"]
    ms["ablate"] = abl["64 MiB"]["full:512"]["ms"]
    ms["ablate_plain"] = abl["64 MiB"]["full:512"]["plain_ms"]
    del rnd["1 GiB"]
    gate.record("vpu_roofline", vpu_roofline.check(rnd["64 MiB"]))
    alu, l_vpu = driven(vpu_roofline.run, rnd["64 MiB"])
    need(l_vpu, "probe_alu", 3, "vpu_roofline.run")
    hi = alu["alu"]["ops"][1]
    ms["vpu_roofline"] = alu["alu"]["ms"][hi]
    ms["vpu_roofline_plain"] = vpu_roofline.plain_ms(rnd["64 MiB"], hi, "alu",
                                                     1)
    # the Mosaic probes' kernels on 64 MiB of their first input, each with
    # its library call (checked against the plain version, then timed)
    mosaic_in = mosaic_probes.timed_inputs(device)
    record_mosaic(gate, mosaic_probes.check(mosaic_in))
    mos, l_mos = driven(mosaic_probes.run, mosaic_in)
    for counter in mosaic_probes.LAUNCH_COUNTER.values():
        need(l_mos, counter, 1, "mosaic_probes.run")
    mosaic_bytes = {k: mosaic_probes.input_bytes(v)
                    for k, v in mosaic_in.items()}
    for probe, kernel in mosaic_probes.PROBE_KERNEL.items():
        name = f"mosaic_probes.{probe}"
        ms[name] = mos[kernel]["ms"]
        ms[name + "_plain"] = mos[kernel]["plain_ms"]
        library_ms[name] = mos[kernel]["library_ms"]
    del rnd, w, words, w2d, mosaic_in
    torch.cuda.empty_cache()

    # the first create_packed after CUDA graphs were captured in the
    # process takes about 0.45 s more (measured on an H100, cause not
    # found); one untimed call keeps that out of the warm time
    csv_simd_tpu_torch.create_packed(path, device=device)
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

    # phase 7: a trace of a warm create_packed and a warm create
    with tempfile.TemporaryDirectory() as trace_dir:
        with profiling.device_trace(trace_dir):
            with profiling.named("create_packed"):
                csv_simd_tpu_torch.create_packed(path, device=device)
            with profiling.named("create"):
                csv_simd_tpu_torch.create(path, backend="cuda",
                                          device=device)
        per, busy = _device_ops(os.path.join(trace_dir,
                                             profiling.TRACE_FILE))
    top_ops = sorted(per.items(), key=lambda kv: -kv[1][0])[:5]
    traced = {k: sum(n for name, (_, n) in per.items() if k in name)
              for k in ("mask_pack", "fold_words")}
    # B1's one pass runs in both builds: B3 is it and then fold_words
    if traced["mask_pack"] < 2 or not traced["fold_words"]:
        raise AssertionError(f"the trace lacks B1's one pass twice or B3's "
                             f"relayout (fold_words): {traced}")
    # both builds read their input once
    no_two_pass(per, "the trace of the warm builds")
    # the probes' kernels in a second trace, at 64 MiB: device time a
    # launch by name, beside phase 6's graph and eager times
    trace_words = random_words(BLOCK_BYTES // 512, device, 64)
    probe_ops = probe_trace(trace_words)
    del trace_words
    # the two int8 products, one kernel template: T12's sum and the mmL
    # and mmLb OR of block products; the stage ablation's one pass and
    # the direct fold pack's, and at tile 512 B3's pair
    for kernel in ("mm32_pack", "lane_gather", "cmp8", "select8", "shift_add",
                   "usum", "concat_mm<true, false>", "concat_mm<false, true>",
                   "ablate2_v4full", "v1_words", "vnext_pack", "v2_pack",
                   "ablate_pass", "mask_pack", "fold_words"):
        if not any(name == kernel or name.startswith(kernel + "<")
                   for name in probe_ops):
            raise AssertionError(f"the probe trace names no {kernel}: "
                                 f"{sorted(probe_ops)}")
    no_two_pass(probe_ops, "the probe trace")

    # phase 8: UTF-8 validation (the validator kernel) and the typed and
    # decoded columns, gated, then timed; after the traces, so that the
    # other paths' times are taken in the state the process had before it
    u8 = run_utf8_typed_path(gate, device, block, index, per_block, path)
    print(f"create_packed(validate_utf8=True): non-ASCII 1 GiB table "
          f"launches {u8['launches']}, ASCII table {u8['launches_ascii']}; "
          f"{BATCHES + 1}x{BATCH} lookups checked; an injected 0xFF and a "
          f"cut sequence refused (counts {u8['fault_counts']}, equal to the "
          "plain version's on 64 MiB windows); decimal64, float32_exp, "
          f"filter_equals and gather_decoded at {u8['rows']} rows, "
          f"column_decoded at {per_block} rows and dates and datetimes at "
          f"{u8['date_rows']} rows equal to the host")

    # phase 9: the relational layer (query, frame, corpus_api, join) on
    # the 1 GiB table through both engines, gated against the block's
    # truth, then timed; last, after phase 8
    rel = run_relational_path(device, block, index, per_block, path)
    print(f"relational layer: {rel['rows']} rows through create_packed "
          f"(B1 + B2) and create + DeviceTape (B3), every result equal to the "
          f"host's truth and computed on the card; tapes {rel['build_s']:.3f}"
          f" s, launches {rel['launches']}; text keys ({rel['text_keys']} "
          f"distinct) and the CSV round trip on the {per_block}-row block; "
          f"CsvCorpus of {REPEATS} files in {rel['corpus_build_s']:.3f} s, "
          f"launches {rel['corpus_launches']}; phase {rel['phase_s']:.1f} s")

    # phase 10: SQL (sql, window, setops) on the 1 GiB table through both
    # engines, each statement's executors spied and its result gated
    # against the block's truth, then timed; last, after phase 9
    sq = run_sql_path(device, block, index, per_block, path)
    print(f"SQL: {sq['statements']} statements at {sq['rows']} rows on the "
          f"create_packed tape (B1 + B2) and the create + DeviceTape tape "
          f"(B3), every window item and set operation on its device "
          f"executor, every result equal to the host's truth and computed on "
          f"the card; GROUP BY from the files: packed "
          f"{sq['from_files_s_packed']:.3f} s, launches "
          f"{sq['launches']['packed']}; offsets "
          f"{sq['from_files_s_offsets']:.3f} s, launches "
          f"{sq['launches']['offsets']}; text keys ({sq['text_keys']} "
          f"distinct) on the {per_block}-row block; phase "
          f"{sq['phase_s']:.1f} s")

    # phase 11: sharding (S1, parallel.sharded, parallel.serving and the
    # sharded streaming build), gated, then timed; last, after phase 10.
    # The earlier phases' 1 GiB tables go first, so that the host holds
    # the 2.5 GiB table, its pinned staging and little else
    route.pop("tape", None)
    del packed
    gc.collect()
    torch.cuda.empty_cache()
    sh = run_sharded_path(gate, device, block, index, per_block, path,
                          want_mask, blk["words"])
    print(f"sharding: S1 against its plain version "
          f"({gate.checks['quote_parity']} comparisons); sharded_stage1 at "
          f"{', '.join(map(str, MESH_SIZES))} shards in the three layouts on "
          f"the 64 MiB block, the 60 KB quoted span and quotes open across "
          f"each 1 GiB cut equal to one device's words and to golden "
          f"(launches {nonzero(sh['stage1_launches'])}); build_index_sharded "
          f"and the sharded streaming build of the 1 GiB table equal to "
          f"golden (streaming launches {nonzero(sh['index_launches'])}); "
          f"ShardedTape and ShardedPackedTape at 1 GiB: lookups, words, row "
          f"prefix and artifact checked; ShardedPackedTape of the "
          f"{sh['big_bytes']}-byte table on {SHARDS} shards: launches "
          f"{nonzero(sh['launches'])}, {BIG_REPEATS * per_block} records, "
          f"lookups (from record {sh['far_record']} on past byte 2^31), "
          f"column_int32, column_stats, groupby_typed and a SQL GROUP BY "
          f"equal to the truth and run on the card; phase "
          f"{sh['phase_s']:.1f} s")

    gb = padded_rows(size) * ROW_BYTES / 1e9
    print(f"times on {card}:")
    for name in ("stage1_v4", "row_prefix", "stage1_fold", "stage1_seq",
                 "stage1_v2", "stage1_v1"):
        at = "1 GiB" if name in ("stage1_v4", "row_prefix",
                                 "stage1_fold") else "64 MiB"
        print(f"  {name} at {at}: kernel {ms[name]:.4f} ms, plain "
              f"{ms[name + '_plain']:.4f} ms")
    print(f"  B3 and B6 at 64 MiB (CUDA graph ms / eager ms): stage1_fold "
          f"{ms['stage1_fold_64MiB']:.4f} / {ms['stage1_fold_64MiB_eager']:.4f}"
          f", stage1_v1 {ms['stage1_v1']:.4f} / {ms['stage1_v1_eager']:.4f}")
    print(f"  B5 (v2_pack) (CUDA graph ms / eager ms): 64 MiB "
          f"{ms['stage1_v2']:.4f} / {ms['stage1_v2_eager']:.4f}, 1 GiB "
          f"{ms['stage1_v2_1GiB']:.4f} / {ms['stage1_v2_1GiB_eager']:.4f} "
          f"({gb / ms['stage1_v2_1GiB'] * 1e3:.1f} GB/s)")
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

    b1g = u8["bound_1GiB"]
    print(f"UTF-8 validator on {card}: 64 MiB {u8['ms']:.4f} ms (CUDA graph; "
          f"eager {u8['eager_ms']:.4f}; plain {u8['plain_ms']:.3f}; bound "
          f"{u8['bound'][0]:.4f} {u8['bound'][1]}), 1 GiB "
          f"{u8['ms_1GiB']:.4f} ms (events; graph "
          f"{u8['graph_ms_1GiB']:.4f}; bound {b1g[0]:.4f} {b1g[1]}, "
          f"{b1g[3]:.4g} ops; {size / u8['ms_1GiB'] / 1e6:.1f} GB/s), "
          f"1 GiB of the ASCII table {u8['ms_1GiB_ascii']:.4f} ms, 1 GiB of "
          f"CJK text {u8['ms_1GiB_cjk']:.4f} ms (events)")
    print(f"builds with and without the validator on {card} (warm s, 3 "
          "calls): " + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in v)
                                 for k, v in u8["builds_s"].items())
          + "; " + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in v)
                             for k, v in u8["create_s"].items()))
    print(f"typed and decoded columns on {card} (warm s, 3 calls; "
          f"{u8['rows']} rows of the 1 GiB table unless named): "
          + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in v)
                      for times in (u8["columns_s"], u8["small_s"])
                      for k, v in times.items()))

    for label, times in (("packed tape", rel["times"]),
                         ("offsets tape (DeviceTape)", rel["offsets_times"])):
        print(f"relational ops on the {label} on {card} (warm s, median of "
              f"3; {rel['rows']} rows): " + "; ".join(
                  f"{k} {v:.4f}" for k, v in times.items()))
    print(f"relational ops on the {per_block}-row block on {card} (warm s, "
          "median of 3; write_csv one call): " + "; ".join(
              f"{k} {v:.4f}" for k, v in rel["text_times"].items()))
    print(f"trace of a warm groupby_typed + order_records at {rel['rows']} "
          f"rows on {card}: device busy {rel['trace_busy']:.2%} of the traced "
          f"window, {rel['trace_device_ms']:.3f} ms of device ops; top device "
          "ops: " + "; ".join(f"{name[:100]} {t:.3f} ms x{k}"
                              for name, (t, k) in rel["trace_top"]))

    for label, times in sq["times"].items():
        print(f"SQL statements, {label} on {card} (warm s, median of 3; "
              f"{sq['rows']} rows unless named): " + "; ".join(
                  f"{k} {v:.4f}" for k, v in times.items()))
    print("EXPLAIN ANALYZE, once under the dispatch watch: " + "; ".join(
        f"{k}: {v}" for k, v in sq["analyze"].items()))
    print(f"trace of the four window statements at {sq['rows']} rows on "
          f"{card}: device busy {sq['trace_busy']:.2%} of the traced window, "
          f"{sq['trace_device_ms']:.3f} ms of device ops; top device ops: "
          + "; ".join(f"{name[:100]} {t:.3f} ms x{k}"
                      for name, (t, k) in sq["trace_top"]))

    read_gbps = big["dma_probe2"]["read"]["gbps"]
    s1_gb = sh["timed_bytes"] / 1e9
    print(f"S1 (quote_parity) on {card}: 64 MiB {sh['s1_ms_64MiB']:.4f} ms "
          f"(CUDA graph; eager {sh['s1_eager_ms_64MiB']:.4f}), 1 GiB "
          f"{sh['ms']:.4f} ms (events; {s1_gb / sh['ms'] * 1e3:.1f} GB/s; "
          f"its bytes at this run's read rate, {read_gbps:.1f} GB/s: "
          f"{s1_gb / read_gbps * 1e3:.4f} ms), plain {sh['plain_ms']:.3f} ms, "
          f"library {sh['library_ms']:.4f} ms")
    print(f"sharded builds and serving on {card} (warm s, 3 calls after one "
          f"untimed; streaming 2; the 2.5 GiB operations the median of 3): "
          + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in v)
                      for k, v in sh["times"].items())
          + f"; 2.5 GiB first build {sh['big_first_s']:.4f} s; lookups/s: "
          f"ShardedTape 1 GiB {sh['sharded_tape_lookups']:.0f}, "
          f"ShardedPackedTape 1 GiB {sh['packed_lookups_1GiB']:.0f}, 2.5 GiB "
          f"{sh['big_lookups']:.0f}")
    print(f"trace of a warm 2.5 GiB ShardedPackedTape build on {card}: "
          f"device busy {sh['trace_busy']:.2%} of the traced window, "
          f"{sh['trace_device_ms']:.3f} ms of device ops, "
          f"{sh['trace_copies'][0]} of the build's {sh['trace_copies'][1]} "
          "host-to-device copies traced; top device ops: "
          + "; ".join(f"{name[:80]} {t:.3f} ms x{k}"
                      for name, (t, k) in sh["trace_top"]))

    # phase 6 and 7 results, one line each, with the card
    for at in ("64 MiB", "1 GiB"):
        print(f"fused prefix A/B at {at} on {card}: " + ", ".join(
            f"{k} {v['ms']:.4f} ms ({v['gbps']:.1f} GB/s)"
            for k, v in ab[at].items()))
    for at, res in stream.items():
        print(f"stream at {at} on {card} (GB/s of input read, CUDA graph; "
              "eager ms / graph ms): " + ", ".join(
                  f"{m} {v['gbps']:.1f} ({v['eager_ms'] / v['ms']:.3f})"
                  for m, v in res["dma_probe2"].items())
              + "; dma_probe " + ", ".join(
                  f"{m} {v['gbps']:.1f}" for m, v in res["dma_probe"].items()))
    for mix, v in alu.items():
        print(f"int32 ops on {card}, {mix}: {v['t_ops_per_s']:.3f} T ops/s "
              f"between {v['ops'][0]} and {v['ops'][1]} ops (graph ms by "
              "ops at 64 MiB: " + ", ".join(
                  f"{n} {t:.4f}" for n, t in v["ms"].items())
              + "; eager: " + ", ".join(
                  f"{n} {t:.4f}" for n, t in v["eager_ms"].items()) + ")")
    for at, res in abl.items():
        print(f"ablation at {at} on {card} (GB/s of input, CUDA graph; "
              "graph ms / eager ms): " + ", ".join(
                  f"{k} {v['gbps']:.1f} ({v['ms']:.4f} / "
                  f"{v['eager_ms']:.4f})" for k, v in res.items()))
    ceiling = big["dma_probe2"]["wide"]["gbps"]
    b1_gbps = gb / ms["stage1_v4"] * 1e3
    b3_gbps = gb / ms["stage1_fold"] * 1e3
    print(f"against the stream's wide ceiling at 1 GiB on {card} "
          f"({ceiling:.1f} GB/s): B1 {b1_gbps:.1f} GB/s "
          f"({b1_gbps / ceiling:.1%}), B3 {b3_gbps:.1f} GB/s "
          f"({b3_gbps / ceiling:.1%})")
    print(f"trace of a warm create_packed + create at 1 GiB on {card}: "
          f"device busy {busy:.2%} of the traced window; top device ops: "
          + "; ".join(f"{name[:60]} {t:.3f} ms x{n}"
                      for name, (t, n) in top_ops))
    print(f"probe kernels in a trace at 64 MiB on {card} (device ms a "
          "launch): " + "; ".join(f"{name} {t:.4f} x{n}" for name, (t, n)
                                  in sorted(probe_ops.items())))
    for at in ("64 MiB", "1 GiB"):
        for what, res in (("B1 stage cuts (ablate2)", ab2[at]),
                          ("v1-layout variants (kbench)", kb[at]),
                          ("direct fold pack (vnext)", vn[at])):
            print(f"{what} at {at} on {card} (GB/s of input, CUDA graph; "
                  "graph ms / eager ms / plain ms): " + ", ".join(
                      f"{k} {v['gbps']:.1f} ({v['ms']:.4f} / "
                      f"{v['eager_ms']:.4f} / {v['plain_ms']:.2f})"
                      for k, v in res.items()))
    for at in ("64 MiB", "1 GiB"):
        print(f"wide-store probes at {at} on {card} (GB/s of input, CUDA "
              "graph; graph ms / eager ms / plain ms): " + ", ".join(
                  f"{k} {v['gbps']:.1f} ({v['ms']:.4f} / "
                  f"{v['eager_ms']:.4f} / {v['plain_ms']:.2f})"
                  for times in (ws2[at], ws3[at])
                  for k, v in times.items()))
    for at in ("64 MiB", "1 GiB"):
        v = ws4[at]["concat_mm"]
        print(f"concat product at {at} on {card} (GB/s of x, CUDA graph; "
              f"graph ms / eager ms / plain ms / library ms): "
              f"{v['gbps']:.1f} ({v['ms']:.4f} / {v['eager_ms']:.4f} / "
              f"{v['plain_ms']:.2f} / {v['library_ms']:.4f})")
    print(f"Mosaic probe kernels at 64 MiB of their first input on {card} "
          "(GB/s of input, CUDA graph; graph ms / eager ms / plain ms / "
          "library ms): " + ", ".join(
              f"{k} {v['gbps']:.1f} ({v['ms']:.4f} / {v['eager_ms']:.4f} / "
              f"{v['plain_ms']:.2f} / {v['library_ms']:.4f})"
              for k, v in mos.items()))
    print(f"library calls on {card} (ms; the Mosaic probes' at 64 MiB, the "
          "rest at 1 GiB): " + ", ".join(
              f"{k} {v:.4f}" for k, v in library_ms.items()))
    one_pass = {k: v for k, v in probe_ops.items()
                if k.startswith(("mask_pack", "ablate2_v4full", "v2_pack",
                                 "concat_mm"))}
    print(f"B1's one pass beside the v4full cut's and B5's, and the two int8 "
          f"products, 64 MiB trace on {card} (device ms a launch): "
          + "; ".join(f"{k} {t:.4f} x{n}"
                      for k, (t, n) in sorted(one_pass.items())))

    print("gate with the timed inputs: " + ", ".join(
        f"{k} {v}" for k, v in gate.checks.items())
        + f" comparisons, all bit-identical; whole run "
        f"{time.perf_counter() - t_run:.1f} s")
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
        ("stage1_fused", "cuda", "relayout.cu",
         "csv_simd_tpu/ops/stage1_v3.py:106", "stage1_fold", l_create,
         "stage1_fold"),
        ("stage1_fused_seq", "cuda", "stage1_v4.cu",
         "csv_simd_tpu/ops/stage1_v3.py:238", "stage1_v4", l_seq,
         "stage1_seq"),
        ("stage1_pallas_v2", "cuda", "stage1_pack.cu",
         "csv_simd_tpu/ops/stage1_v2.py:66", "stage1_v2", l_v2,
         "stage1_v2"),
        ("stage1_pallas", "cuda", "relayout.cu",
         "csv_simd_tpu/ops/stage1_pallas.py:73", "stage1_v1", l_v1,
         "stage1_v1"),
        ("stage1_fused_v4[emit]", "cuda", "stage1_v4.cu",
         "csv_simd_tpu/ops/stage1_v4.py:707", "stage1_v4_emit", _sum(l_ab),
         "stage1_v4_emit"),
        ("dma_probe", "cuda", "probe_stream.cu", "tools/dma_probe.py:47",
         "probe_stream_write", _sum(l_dma1), "dma_probe"),
        ("dma_probe2.write", "cuda", "probe_stream.cu",
         "tools/dma_probe2.py:62", "probe_stream_write", _sum(l_dma2w),
         "dma_probe2.write"),
        ("dma_probe2.read", "cuda", "probe_stream.cu",
         "tools/dma_probe2.py:90", "probe_stream_read", _sum(l_dma2r),
         "dma_probe2.read"),
        ("vpu_roofline", "cuda", "probe_alu.cu", "tools/vpu_roofline.py:95",
         "probe_alu", l_vpu, "vpu_roofline"),
        ("ablate", "cuda", "probe_ablate.cu", "tools/ablate.py:149",
         "probe_ablate", _sum(l_abl), "ablate"),
        ("ablate2", "cuda", "probe_ablate2.cu", "tools/ablate2.py:136",
         "probe_ablate2", _sum(l_ab2), "ablate2"),
        ("kbench", "cuda", "relayout.cu", "tools/kbench.py:142",
         "probe_kbench", _sum(l_kb), "kbench"),
        ("vnext", "cuda", "probe_vnext.cu", "tools/vnext.py:85",
         "probe_vnext", _sum(l_vn), "vnext"),
        ("widestore_probe2.s8_st16", "cuda", "probe_widestore.cu",
         "tools/widestore_probe2.py:44", "probe_ws_gather", _sum(l_ws2),
         "widestore_probe2.s8_st16"),
        ("widestore_probe2.mmL", "cuda", "probe_concatmm.cu",
         "tools/widestore_probe2.py:87", "probe_ws_packmm", _sum(l_ws2),
         "widestore_probe2.mmL"),
        ("widestore_probe3.laneload", "cuda", "probe_widestore.cu",
         "tools/widestore_probe3.py:41", "probe_ws_lanesum", _sum(l_ws3),
         "widestore_probe3.laneload"),
        ("widestore_probe3.mmLb", "cuda", "probe_concatmm.cu",
         "tools/widestore_probe3.py:75", "probe_ws_packmm", _sum(l_ws3),
         "widestore_probe3.mmLb"),
        *((f"mosaic_probes.{probe}", "cuda", "probe_mosaic.cu",
           f"tools/mosaic_probes.py:{MOSAIC_LINES[probe]}",
           mosaic_probes.LAUNCH_COUNTER[kernel], l_mos,
           f"mosaic_probes.{probe}")
          for probe, kernel in mosaic_probes.PROBE_KERNEL.items()),
        ("widestore_probe4.concat_mm", "cuda", "probe_concatmm.cu",
         "tools/widestore_probe4.py:40", "probe_concat_mm", _sum(l_ws4),
         "widestore_probe4.concat_mm"),
        ("validate_utf8_device", "cuda", "utf8.cu",
         "csv_simd_tpu/ops/utf8.py:97", "utf8_errs", u8["launches"],
         "utf8_errs"),
        ("_local_parity", "cuda", "shard_parity.cu",
         "csv_simd_tpu/parallel/sharded.py:51", "quote_parity",
         sh["launches"], "quote_parity"),
    )
    # the input bytes each kernel's `ms` was timed on
    gib, blk_words = padded_rows(size) * ROW_BYTES, BLOCK_BYTES
    timed = {"stage1_v4": gib, "row_prefix": gib // 8, "stage1_fold": gib,
             "stage1_seq": bw_bytes, "stage1_v2": bw_bytes,
             "stage1_v2_swar": bw_bytes,
             "stage1_v1": bb_bytes, "stage1_v4_emit": gib,
             "dma_probe": 16 * blk_words, "dma_probe2.write": 16 * blk_words,
             "dma_probe2.read": 16 * blk_words, "vpu_roofline": blk_words,
             "ablate": blk_words, "ablate2": 16 * blk_words,
             "kbench": 16 * blk_words, "vnext": 16 * blk_words,
             **{name: 16 * blk_words for name in GATED
                if name.startswith("widestore_probe")},
             **{f"mosaic_probes.{probe}": mosaic_bytes[kernel]
                for probe, kernel in mosaic_probes.PROBE_KERNEL.items()}}
    bound = bounds(timed, hi)
    # the validator's work depends on its data: its own count, at 64 MiB
    bound["utf8_errs"] = u8["bound"]
    ms["utf8_errs"], ms["utf8_errs_plain"] = u8["ms"], u8["plain_ms"]
    # S1's: its bytes, timed on the 1 GiB table
    bound["quote_parity"] = s1_bound(sh["timed_bytes"])
    ms["quote_parity"], ms["quote_parity_plain"] = sh["ms"], sh["plain_ms"]
    library_ms["quote_parity"] = sh["library_ms"]
    kernels = [
        {"name": name, "route": route_, "source": src + source,
         "replaces": replaces, "launches": launches[counter],
         "max_abs_err": gate.max_abs_err[gated], "ms": ms[gated],
         "plain_ms": ms[gated + "_plain"], "bound_ms": bound[gated][0],
         "bound_by": bound[gated][1],
         "library_ms": library_ms.get(gated)}
        for name, route_, source, replaces, counter, launches, gated
        in table
    ]
    old = bound.pop("stage1_v2_swar")
    print(f"B5's bound at 64 MiB on {card}: {bound['stage1_v2'][0]:.4f} ms "
          f"{bound['stage1_v2'][1]} ({bound['stage1_v2'][3]:.4g} ops, B1's "
          f"plain version's count), was {old[0]:.4f} ms {old[1]} "
          f"({old[3]:.4g} ops, its own SWAR plain version's)")
    print(f"bounds on {card} (the least time for the timed inputs at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s and "
          f"{INT32_OPS_PER_S / 1e12:.1f} T int32 ops/s, the pack products "
          f"at {INT8_TC_OPS_PER_S / 1e12:.0f} T int8 ops/s; ms / bound): "
          + ", ".join(
              f"{k['name']} {k['ms']:.4f} / {k['bound_ms']:.4f} "
              f"{k['bound_by']}" for k in kernels))
    # the same work at the rates this run measured: the stream probe's
    # wide mode (it reads N and writes N/8) and the ALU probe's alu mix
    # (the pack products' int8 operations at the data-sheet rate: no
    # probe measures it)
    traffic = ceiling * 1e9 * 1.125
    alu_rate = alu["alu"]["t_ops_per_s"] * 1e12

    def at_measured(b) -> float:
        rate = alu_rate if b[4] == INT32_OPS_PER_S else b[4]
        return max(b[2] / traffic, b[3] / rate) * 1e3

    print(f"bounds at this card's measured rates ({traffic / 1e12:.3f} TB/s "
          f"of traffic, {alu_rate / 1e12:.3f} T int32 ops/s; ms, bytes "
          "moved, operations): " + ", ".join(
              f"{name} {at_measured(b):.4f} ({b[2]:.4g} B, {b[3]:.4g} ops)"
              for name, b in bound.items()))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
