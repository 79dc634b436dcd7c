"""Sharded index build: data-parallel byte shards over a mesh of devices
(csv_simd_tpu/parallel/sharded.py).

- the byte stream is cut by offset into equal shards over a 1-D mesh
  (axis "data"); no record break need be known up front;
- each shard computes the quote parity of its bytes (kernel S1 on a
  card), an exclusive scan of the parities across shards gives each
  shard its carried-in parity, and the full stage-1 build runs on each
  shard with it;
- the per-shard structural counts are scanned the same way, so local
  bit positions rebase into the global offset space;
- the outputs stay per shard: packed words live on the device that owns
  the bytes.

A mesh is single-controller, as JAX's is: one process holds a `Mesh` of
devices (one `torch.device` a shard; a device may repeat, so one card
can hold several shards) and runs each shard's work on its device. A
shard's arrays (the counterpart of a `P(AXIS)` array) are a Python list
of tensors, one on each shard's device; a replicated value is a tensor on
the mesh's first device. The collectives are plain functions under the
JAX names: the per-shard 0-d values are stacked on the first device and
scanned there with `cumsum`, with no host sync, so the parity can chain
as a device scalar. A mesh may also name a `torch.distributed` process
group; its shards are then this rank's local ones, global shard `rank *
local + k`, and the collectives all-gather every rank's values before
the scan (the counterpart of `jax.distributed`, tools/multihost_demo.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_DIALECT, Dialect
from ..device import resolve_device
from ..ops.stage1_v2 import LANES, ROW_BYTES, padded_rows
from ..ops.stage1_v3 import (
    _as_carry,
    count_packed,
    stage1_fused,
    stage1_seq_xla,
    stage1_swar_xla,
)
from ..ops.stage1_v4 import stage1_fused_v4
from ..ops.swar import (
    _HI1,
    popcount32,
    swar_eq,
    swar_prefix_xor_bytes,
    swar_word_parity,
)
from ..utils import as_u8

AXIS = "data"
_LAYOUTS = ("fold", "seq", "seq_wide")
_STAGE_BYTES = 64 << 20  # one pinned staging buffer of a shard upload


class Mesh:
    """A 1-D mesh over AXIS: one torch.device a shard, in shard order (a
    device may repeat). With a torch.distributed `group` the devices are
    this rank's local shards, global shards rank * len(devices) + k, and
    `size` counts every rank's."""

    def __init__(self, devices, group=None):
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        rank, world = 0, 1
        if group is not None:
            import torch.distributed as dist

            rank, world = dist.get_rank(group), dist.get_world_size(group)
        self.size = world * len(self.devices)
        self.first_shard = rank * len(self.devices)


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A mesh of n_devices shards (default: one per visible device of
    `device`'s type). "cuda" with no index spreads the shards over every
    card in contiguous runs, so make_mesh(4) on one card puts 4 shards on
    it; "cpu" is one device. Raises for "cuda" without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(dev)]
    n = n_devices or len(devs)
    return Mesh([devs[k * len(devs) // n] for k in range(n)])


def _single_process(mesh: Mesh) -> None:
    if mesh.group is not None:
        raise ValueError("this entry point takes the whole input and needs "
                         "a mesh without a process group; across processes "
                         "pass each rank's shards to sharded_stage1")


def _local_parity(w: torch.Tensor, dialect: Dialect) -> torch.Tensor:
    """Quote parity of a local shard's int32 byte quads, 0-d int32 on its
    device: kernel S1 on a CUDA tensor, the plain version on a CPU one."""
    if w.device.type == "cuda":
        from .. import _kernels

        return _kernels.quote_parity(w.contiguous(), dialect.quote)
    if w.device.type != "cpu":
        raise ValueError(f"unsupported device {w.device}")
    return _local_parity_plain(w, dialect)


def _local_parity_plain(w: torch.Tensor, dialect: Dialect) -> torch.Tensor:
    """The JAX `_local_parity` as PyTorch ops on any device: the byte
    compare, the in-word prefix XOR and the word parities, summed, & 1."""
    qf = swar_eq(w, dialect.quote)
    wp = swar_word_parity(swar_prefix_xor_bytes(qf))
    return wp.sum(dtype=torch.int32) & 1


def _all_shards(xs, mesh: Mesh) -> torch.Tensor:
    """The local shards' 0-d values as one (mesh.size,) tensor on the
    first device, every rank's in rank order (all_gather)."""
    first = mesh.devices[0]
    local = torch.stack([x.reshape(()).to(first) for x in xs])
    if mesh.group is None:
        return local
    import torch.distributed as dist

    parts = [torch.empty_like(local)
             for _ in range(mesh.size // len(mesh.devices))]
    dist.all_gather(parts, local, group=mesh.group)
    return torch.cat(parts)


def _prefix(allv: torch.Tensor) -> tuple:
    """(exclusive prefix (n,), total 0-d) of a gathered (n,) vector,
    summed in int32 as JAX's psum is."""
    incl = torch.cumsum(allv, 0, dtype=torch.int32)
    return incl - allv, incl[-1]


def _local(excl: torch.Tensor, mesh: Mesh) -> list:
    """Each local shard's entry of a replicated (n,) vector, on its
    device."""
    return [excl[mesh.first_shard + k].to(d)
            for k, d in enumerate(mesh.devices)]


def _exclusive_scan_axis(xs, mesh: Mesh) -> list:
    """Exclusive prefix sum of a per-shard scalar across the mesh: one
    0-d int32 on each local shard's device."""
    return _local(_prefix(_all_shards(xs, mesh))[0], mesh)


def _scan_total_psum(xs, mesh: Mesh) -> tuple:
    """One gather serving both the exclusive prefix and the total of a
    per-shard scalar: (per-shard exclusive prefixes, one 0-d int32 on
    each local shard's device; the total, 0-d int32 on the first
    device)."""
    excl, total = _prefix(_all_shards(xs, mesh))
    return _local(excl, mesh), total


def _shard_fn(w: torch.Tensor, carry, dialect: Dialect, use_pallas: bool,
              row_tile: int, layout: str, count_nonascii: bool) -> tuple:
    """Phase B of one shard: the stage-1 build with its carried-in parity
    -> (packed words, structural count 0-d int32, non-ASCII count 0-d
    int32 or -1 when not counted), all on the shard's device."""
    # the tile is in narrow (512-byte) rows; a seq_wide shard's dim 0 is
    # wide rows of 8 narrow rows
    tile = min(row_tile, w.shape[0] * (8 if layout == "seq_wide" else 1))
    na = None
    if layout in ("seq", "seq_wide"):
        if use_pallas:
            packed, _par, na = stage1_fused_v4(
                w, carry, dialect, row_tile=tile,
                count_nonascii=count_nonascii,
                out_mode="wide_native" if layout == "seq_wide" else "narrow")
        else:
            packed, _ = stage1_seq_xla(w, carry, dialect)
            if count_nonascii:
                na = popcount32(w & _HI1).sum(dtype=torch.int32)
    elif use_pallas:
        packed, _ = stage1_fused(w, carry, dialect, row_tile=tile)
    else:
        packed, _ = stage1_swar_xla(w, carry, dialect, row_tile=tile)
    if na is None:
        na = torch.full((), -1, dtype=torch.int32, device=w.device)
    return packed, count_packed(packed), na


def _as_shards(w2d, mesh: Mesh) -> list:
    """The local shards' words: a list as given (each moved to its
    shard's device), or one whole tensor cut along dim 0."""
    if isinstance(w2d, (list, tuple)):
        if len(w2d) != len(mesh.devices):
            raise ValueError(f"{len(w2d)} shards for a mesh of "
                             f"{len(mesh.devices)} local devices")
        return [w.to(d) for w, d in zip(w2d, mesh.devices)]
    _single_process(mesh)
    n = mesh.size
    if w2d.shape[0] % n:
        raise ValueError(f"{w2d.shape[0]} rows do not divide into {n} "
                         "shards")
    step = w2d.shape[0] // n
    return [w2d[k * step:(k + 1) * step].to(d)
            for k, d in enumerate(mesh.devices)]


def sharded_stage1(
    w2d,
    carry_in,
    mesh: Mesh,
    dialect: Dialect = DEFAULT_DIALECT,
    use_pallas: Optional[bool] = None,
    row_tile: int = 512,
    interpret: bool = False,
    layout: str = "fold",
    count_nonascii: bool = False,
):
    """Sharded stage-1 over a 1-D mesh. w2d is the (rows, 128) int32 byte
    quads, rows divisible by mesh.size * 8 ((rows/8, 1024) for
    "seq_wide"): one tensor, cut along dim 0 into the shards, or a list
    of the local shards' tensors.

    Returns (packed words, a list of one tensor a local shard; per-shard
    counts (n,) int32; per-shard exclusive count offsets (n,) int32;
    total count and parity_out, 0-d int32), the replicated values on the
    mesh's first device. With count_nonascii=True (the "seq" layouts) a
    6th element holds the per-shard high-bit byte counts (n,) (-1 for
    "fold"). Sum counts in int64 on the host: the int32 total wraps past
    2^31 structural entries, as JAX's psum does.

    use_pallas=None runs the kernels on CUDA shards and the plain
    versions on CPU shards (the JAX default is the plain versions);
    "seq_wide" needs the kernels. `interpret` is accepted and changes
    nothing. The quote parity is kernel S1 on a CUDA shard whatever
    use_pallas says, as the JAX package's is one XLA function."""
    if layout not in _LAYOUTS:
        raise ValueError(f"layout must be one of {_LAYOUTS}: {layout!r}")
    shards = _as_shards(w2d, mesh)
    if use_pallas is None:
        use_pallas = mesh.devices[0].type == "cuda"
    if layout == "seq_wide" and not use_pallas:
        raise ValueError(
            "layout='seq_wide' needs the kernels (use_pallas=True); the "
            "plain version emits narrow")
    first = mesh.devices[0]
    carry0 = _as_carry(carry_in, first)

    def on(dev):
        return carry0.to(dev) if isinstance(carry0, torch.Tensor) else carry0

    # phase A: local parity + exclusive scan across shards (the same
    # gather also yields the global parity)
    par_excl, par_total = _scan_total_psum(
        [_local_parity(w, dialect) for w in shards], mesh)
    # phase B: the full stage-1 build with the carried parity
    outs = [_shard_fn(w, (pe + on(pe.device)) & 1, dialect, use_pallas,
                      row_tile, layout, count_nonascii)
            for w, pe in zip(shards, par_excl)]
    packed = [o[0] for o in outs]
    counts = _all_shards([o[1] for o in outs], mesh)
    count_excl, total = _prefix(counts)
    parity_out = (par_total + carry0) & 1
    if count_nonascii:
        return (packed, counts, count_excl, total, parity_out,
                _all_shards([o[2] for o in outs], mesh))
    return packed, counts, count_excl, total, parity_out


def _mesh_rows(n_bytes: int, n_shards: int) -> int:
    """The row count pad_words_for_mesh gives n_bytes, without the
    array."""
    rows = padded_rows(n_bytes, row_align=8 * n_shards)
    unit = 8 * n_shards if rows <= 512 * n_shards else 512 * n_shards
    return -(-rows // unit) * unit


def pad_words_for_mesh(arr: np.ndarray, n_shards: int) -> np.ndarray:
    """(n,) uint8 -> (rows, 128) byte-quad words with rows divisible by
    the mesh AND each shard's rows compatible with the fold tile:
    shard_rows <= 512 only needs % 8; larger shards are multiples of 512.
    The padded shape decides which word belongs to which shard."""
    rows = _mesh_rows(arr.size, n_shards)
    padded = np.zeros(rows * ROW_BYTES, dtype=np.uint8)
    padded[: arr.size] = arr
    return padded.view("<i4").reshape(rows, LANES)


def _upload_bytes(arr: np.ndarray, lo: int, n_bytes: int,
                  device: torch.device) -> torch.Tensor:
    """Bytes lo .. lo + n_bytes of arr, zero past its end, as one uint8
    tensor on `device`. For a card they pass through two pinned buffers
    of _STAGE_BYTES in turn, one filled while the other is copied, so no
    host copy of the whole range is made; the zeros are set on the
    card."""
    got = max(0, min(arr.size - lo, n_bytes))
    if device.type != "cuda":
        out = torch.zeros(n_bytes, dtype=torch.uint8, device=device)
        out.numpy()[:got] = arr[lo:lo + got]
        return out
    out = torch.empty(n_bytes, dtype=torch.uint8, device=device)
    out[got:].zero_()
    if got == 0:
        return out
    stream = torch.cuda.current_stream(device)
    size = min(_STAGE_BYTES, got)
    bufs = [torch.empty(size, dtype=torch.uint8, pin_memory=True)
            for _ in range(2 if got > size else 1)]
    done = [None] * len(bufs)
    for k, off in enumerate(range(0, got, _STAGE_BYTES)):
        m = min(_STAGE_BYTES, got - off)
        b = k % len(bufs)
        if done[b] is not None:
            done[b].synchronize()
        bufs[b].numpy()[:m] = arr[lo + off:lo + off + m]
        out[off:off + m].copy_(bufs[b][:m], non_blocking=True)
        done[b] = torch.cuda.Event()
        done[b].record(stream)
    return out


def _upload_shards(arr: np.ndarray, rows: int, mesh: Mesh) -> list:
    """arr zero-padded to `rows` 512-byte rows, cut into the mesh's
    shards: one uint8 tensor of rows / mesh.size * 512 bytes on each
    local shard's device."""
    shard_bytes = rows // mesh.size * ROW_BYTES
    return [_upload_bytes(arr, (mesh.first_shard + k) * shard_bytes,
                          shard_bytes, d)
            for k, d in enumerate(mesh.devices)]


def _words(shard: torch.Tensor, lanes: int = LANES) -> torch.Tensor:
    """A shard's bytes as int32 byte quads of `lanes` words a row."""
    return shard.view(torch.int32).view(-1, lanes)


def build_index_sharded(
    data: bytes | np.ndarray,
    mesh: Optional[Mesh] = None,
    dialect: Dialect = DEFAULT_DIALECT,
    use_pallas: Optional[bool] = None,
    interpret: Optional[bool] = None,
    device="cuda",
) -> np.ndarray:
    """End-to-end sharded build -> host int64 structural index with the 0
    sentinel, bit-identical to the single-device and golden result. Each
    shard's fold-layout words go through the native extractor with the
    shard's byte base: the fold tile min(512, shard_rows) divides the
    shard's rows, so no fold group crosses a shard. `device` makes the
    default mesh (one shard a visible device)."""
    arr = as_u8(data)
    mesh = mesh or make_mesh(device=device)
    _single_process(mesh)
    rows = _mesh_rows(arr.size, mesh.size)
    shards = _upload_shards(arr, rows, mesh)
    packed = sharded_stage1([_words(s) for s in shards], 0, mesh, dialect,
                            use_pallas=use_pallas)[0]
    del shards
    return np.concatenate([np.zeros(1, dtype=np.int64)]
                          + _fold_offsets(packed, arr.size))


def _fold_offsets(packed: list, n_bytes: int, base: int = 0) -> list:
    """The int64 structural offsets in fold-layout shard words of a
    stream of n_bytes that starts at byte `base`: the native extractor a
    shard (tile min(512, shard_rows)), each shard's offsets rebased by its
    first byte. One array a shard that holds bytes."""
    from ..index import _to_host, extract_offsets_from_packed

    shard_rows = packed[0].shape[0] * 8
    shard_bytes = shard_rows * ROW_BYTES
    return [extract_offsets_from_packed(
                _to_host(p), min(512, shard_rows),
                min(n_bytes - k * shard_bytes, shard_bytes),
                base=base + k * shard_bytes)
            for k, p in enumerate(packed) if k * shard_bytes < n_bytes]
