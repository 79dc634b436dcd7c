"""csv_simd_tpu_torch: the PyTorch + CUDA port of csv_simd_tpu.

Two paths are ported. The offsets-free path: `create_packed(path)`
builds the index on an NVIDIA card with two hand-written Hopper kernels
(the stage-1 build, csrc/stage1_v4.cu, and the row popcount prefix,
csrc/prefix.cu), with `validate_utf8=True` checks non-ASCII input with
a third (the UTF-8 validator, csrc/utf8.cu), and `PackedDeviceTape`
serves batched field lookups, typed columns (int32, float32 with and
without exponents, exact decimals, dates, datetimes), decoded fields and
equality filters from it, for a file of any size the card holds (int64
byte positions from 2 GiB on). The offsets route: `create(path)` builds the
fold-layout words with kernel B3 (the stage-1 build's one pass, then
csrc/relayout.cu `fold_words`), compacts them into the int32 offsets
on the card with kernel E1 (csrc/fold_offsets.cu) and copies the index
to the host once into a `Tape`; `DeviceTape.from_tape` serves from the
card's index itself. `create_streaming` builds chunk by chunk and
extracts each chunk's words on the host. Every function takes an explicit device; the
default is "cuda", and device="cpu" runs the plain PyTorch versions of
the kernels. The package imports torch and never jax or csv_simd_tpu:
it keeps its own copies of the JAX package's pure-host modules (config,
errors, utils, serve, tape, artifact, golden, decode and the native C++
engine, which g++ builds into `_build/` at first use).

The relational layer runs over any of those tapes with torch ops on the
tape's device: `read_typed` -> `Frame` (frame.py), `CsvCorpus` over many
files (corpus_api.py), filters, statistics, quantiles, ORDER BY and
GROUP BY (query.py) and equi-joins (join.py). `sql` compiles a SELECT
statement onto it (sql.py), with device window functions (window.py) and
set operations (setops.py). Its entry points that build a tape take
`device="cuda"` as `create` does.

Sharding (`csv_simd_tpu_torch.parallel`) builds and serves over a mesh
of shards (several may share one card): `sharded_stage1`,
`build_index_sharded`, `ShardedTape` and `ShardedPackedTape`, which
serves a file over several cards, each shard under 2 GiB;
`streaming.ShardedStreamingIndexBuilder` streams over a mesh.
"""

from .api import create, create_from_bytes, create_packed
from .artifact import load_tape, save_tape
from .config import (
    CODE_DELIM,
    CODE_ESCAPE,
    CODE_NEWLINE,
    CODE_QUOTE,
    CODE_SPACE,
    CODE_STRUCTURAL,
    Dialect,
    build_nibble_luts,
)
from .decode import DecodedView, decode_field, decode_str
from .corpus_api import CorpusTape, CsvCorpus
from .device_tape import DeviceTape
from .errors import (
    InvalidCsvFormat,
    InvalidState,
    IoError,
    MissingValue,
    StructureError,
)
from .frame import Col, Frame, infer_schema, read_typed, write_csv
from .index import build_index, build_index_device
from .join import join_records, join_typed
from .offsetfree import PackedDeviceTape
from .sql import SqlError, SqlResult, sql
from .sql import explain as explain_sql
from .query import (
    Stats,
    column_quantiles,
    column_stats,
    describe,
    distinct,
    group_aggregate,
    groupby_typed,
    order_records,
    select_records,
    value_counts,
)
from .streaming import (
    StreamingIndexBuilder,
    build_index_streaming,
    create_streaming,
)
from .tape import Boundary, Chunk, Header, NewLine, Tape, boundaries

__all__ = [
    "create",
    "create_from_bytes",
    "create_packed",
    "Tape",
    "build_index",
    "build_index_device",
    "StreamingIndexBuilder",
    "build_index_streaming",
    "create_streaming",
    "DeviceTape",
    "PackedDeviceTape",
    "DecodedView",
    "decode_field",
    "decode_str",
    "save_tape",
    "load_tape",
    "Dialect",
    "build_nibble_luts",
    "CODE_NEWLINE",
    "CODE_DELIM",
    "CODE_SPACE",
    "CODE_ESCAPE",
    "CODE_QUOTE",
    "CODE_STRUCTURAL",
    "Header",
    "NewLine",
    "Boundary",
    "Chunk",
    "boundaries",
    "StructureError",
    "IoError",
    "MissingValue",
    "InvalidState",
    "InvalidCsvFormat",
    "CsvCorpus",
    "CorpusTape",
    "Col",
    "Frame",
    "infer_schema",
    "read_typed",
    "write_csv",
    "Stats",
    "column_quantiles",
    "column_stats",
    "describe",
    "distinct",
    "group_aggregate",
    "groupby_typed",
    "join_records",
    "join_typed",
    "order_records",
    "select_records",
    "value_counts",
    "sql",
    "explain_sql",
    "SqlResult",
    "SqlError",
]
