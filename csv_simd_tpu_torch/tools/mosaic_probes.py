"""The Mosaic regression probes of tools/mosaic_probes.py on the card.

The TPU tool compiled each probe body on an (8, 128) tile and compared it
bit for bit with interpret mode. Here each body is a function on (rows,
128) tensors (at rows = 8 the TPU probe); on a CUDA tensor it runs its
kernel in csrc/probe_mosaic.cu, on a CPU tensor its plain version, on any
other device it raises:

- `mm32_pack(v)` (matmul32_slice, matmul32_roll: one function, one
  kernel): (rows, 128) int32 -> (rows, 16) int32, word g = lo | (hi <<
  16) with lo = sum over l < 4 of v[:, 8g + l] << 4l and hi the same over
  v[:, 8g + 4 + l], in int32 that wraps. The TPU formed lo and hi with a
  bf16 product, so the two agree where the bf16 cast of v is exact, |v| <=
  256; kernel and plain version agree on every int32.
- `lane_gather(lut, idx)` (int8_lane_gather): (rows, 128) int8 and int32
  -> (rows, 128) int8, out[r, j] = lut[r, idx[r, j]] for idx in [0, 128).
  Outside that range kernel and plain version both read idx & 127, inside
  the row.
- `cmp8(a)`: uint8 -> int32, a == 0x2C.
- `select8(a)`: uint8 -> uint8, where(a > 127, a, 7).
- `shift_add(x)` (sublane_concat): int32 -> int32, x[r] + x[r - 1] with
  row -1 = 0, wrapping.
- `unsigned_sum(a)` (unsigned_reduce): (rows, 128) int32 holding uint32
  bit patterns -> (1, 1) int32 with the bits of their uint32 sum mod 2^32.

`probe_<name>(device)` is the TPU tool's probe on its own inputs (drawn as
it drew them, `probe_inputs`): ("fixed", detail) when the result on device
is bit-identical to the plain version and to a NumPy statement of the
TPU body, else ("broken-miscompile", detail). `probe_mm1_in_context` runs
B1 (`stage1_fused_v4`, whose `pack_mode` the port ignores) on the TPU
probe's 700,000 bytes against golden.structural_mask.

    python -m csv_simd_tpu_torch.tools.mosaic_probes
        the probe table and its JSON line, the gate, then each kernel
        checked and timed on 64 MiB of its first input, with the plain
        version and one PyTorch call that computes the same function
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from .._kernels import check_rows
from ._common import (
    card,
    check_all,
    emit,
    graph_ms,
    interleaved_ms,
    kernel_ms,
    need_card,
    wrap_sum,
)

T, L = 8, 128
GATE_ROWS = (8, 56, 512, 520, 8000)
# the first input's rows in the timed set: 64 MiB of int32 or of bytes
TIMED_ROWS = {"int32": 131_072, "bytes": 524_288}


def _wrap32(z: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits."""
    return (((z + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _mm32_plain(v: torch.Tensor) -> torch.Tensor:
    scale = torch.tensor([1, 16, 256, 4096], dtype=torch.int64,
                         device=v.device)
    parts = (v.to(torch.int64).view(-1, 16, 2, 4) * scale).sum(-1)
    return _wrap32(parts[..., 0] | (parts[..., 1] * 65536))


def _gather_plain(lut: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(lut, 1, (idx & 127).long())


def _cmp8_plain(a: torch.Tensor) -> torch.Tensor:
    return (a == 0x2C).to(torch.int32)


def _select8_plain(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a > 127, a, 7)


def _shift_add_plain(x: torch.Tensor) -> torch.Tensor:
    x64 = x.to(torch.int64)
    return _wrap32(x64 + F.pad(x64[:-1], (0, 0, 1, 0)))


def _unsigned_sum_plain(a: torch.Tensor) -> torch.Tensor:
    return wrap_sum(a.reshape(1, -1), 1).view(1, 1)


PLAIN = {"mm32_pack": _mm32_plain, "lane_gather": _gather_plain,
         "cmp8": _cmp8_plain, "select8": _select8_plain,
         "shift_add": _shift_add_plain, "unsigned_sum": _unsigned_sum_plain}
KERNELS = tuple(PLAIN)
LAUNCH_COUNTER = {"mm32_pack": "probe_mosaic_mm32",
           "lane_gather": "probe_mosaic_gather",
           "cmp8": "probe_mosaic_cmp8", "select8": "probe_mosaic_select8",
           "shift_add": "probe_mosaic_shift_add",
           "unsigned_sum": "probe_mosaic_usum"}


def _run(name: str, *args: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    dev = args[0].device
    if any(a.device != dev for a in args):
        raise ValueError(f"{name}: inputs on {[str(a.device) for a in args]}")
    if dev.type == "cuda":
        from .. import _kernels

        return getattr(_kernels, LAUNCH_COUNTER[name])(*args)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return PLAIN[name](*args)


def mm32_pack(v: torch.Tensor) -> torch.Tensor:
    """(rows, 128) int32 -> (rows, 16) int32: see the module docstring.
    Equal to the TPU probes' bf16 product where |v| <= 256."""
    check_rows(v, torch.int32, "mm32_pack")
    return _run("mm32_pack", v)


def lane_gather(lut: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(rows, 128) int8 lut and int32 idx -> (rows, 128) int8, out[r, j] =
    lut[r, idx[r, j] & 127]: the TPU probe's take_along_axis for idx in
    [0, 128)."""
    rows = check_rows(lut, torch.int8, "lane_gather lut")
    if check_rows(idx, torch.int32, "lane_gather idx") != rows:
        raise ValueError(f"lane_gather: lut has {rows} rows, idx "
                         f"{idx.shape[0]}")
    return _run("lane_gather", lut, idx)


def cmp8(a: torch.Tensor) -> torch.Tensor:
    """(rows, 128) uint8 -> (rows, 128) int32, a == 0x2C."""
    check_rows(a, torch.uint8, "cmp8")
    return _run("cmp8", a)


def select8(a: torch.Tensor) -> torch.Tensor:
    """(rows, 128) uint8 -> (rows, 128) uint8, where(a > 127, a, 7)."""
    check_rows(a, torch.uint8, "select8")
    return _run("select8", a)


def shift_add(x: torch.Tensor) -> torch.Tensor:
    """(rows, 128) int32 -> (rows, 128) int32, x[r] + x[r - 1] with row -1
    = 0, wrapping."""
    check_rows(x, torch.int32, "shift_add")
    return _run("shift_add", x)


def unsigned_sum(a: torch.Tensor) -> torch.Tensor:
    """(rows, 128) int32 of uint32 bit patterns -> (1, 1) int32, the bits
    of their uint32 sum mod 2^32."""
    check_rows(a, torch.int32, "unsigned_sum")
    return _run("unsigned_sum", a)


FUNCTIONS = {"mm32_pack": mm32_pack, "lane_gather": lane_gather,
             "cmp8": cmp8, "select8": select8, "shift_add": shift_add,
             "unsigned_sum": unsigned_sum}


# --- the TPU probes ------------------------------------------------------


def pack_weights32() -> np.ndarray:
    """The TPU probes' (128, 32) weights (bf16-exact, here float32): word
    g's low half from lanes 8g..8g+3 (columns 0-15), its high half from
    lanes 8g+4..8g+7 (columns 16-31)."""
    w = np.zeros((L, 32), np.float32)
    for lane in range(L):
        g, l = divmod(lane, 8)
        w[lane, g + (0 if l < 4 else 16)] = float(1 << (4 * (l % 4)))
    return w


def probe_inputs() -> dict:
    """The TPU probes' (8, 128) inputs, drawn as the TPU tool draws them
    from its one default_rng(7): `_V` at import, then, in the order of its
    PROBES, int8_lane_gather's lut and idx, cmp8's a, select8's a and
    unsigned_reduce's a (int32 holding the uint32 values)."""
    rng = np.random.default_rng(7)
    out = {"v": rng.integers(0, 16, size=(T, L)).astype(np.int32)}
    out["lut"] = rng.integers(-128, 127, size=(T, L)).astype(np.int8)
    out["idx"] = rng.integers(0, L, size=(T, L)).astype(np.int32)
    out["cmp8"] = rng.integers(0, 255, size=(T, L)).astype(np.uint8)
    out["select8"] = rng.integers(0, 255, size=(T, L)).astype(np.uint8)
    out["unsigned"] = rng.integers(0, 2**31, size=(T, L)).astype(
        np.uint32).view(np.int32)
    return out


def _np_mm32(v: np.ndarray) -> np.ndarray:
    o = (v.astype(np.float32) @ pack_weights32()).astype(np.int64)
    return ((o[:, :16] | (o[:, 16:] << 16)) & 0xFFFFFFFF).astype(
        np.uint32).view(np.int32)


def _np_shift_add(x: np.ndarray) -> np.ndarray:
    s = x.astype(np.int64) + np.concatenate(
        [np.zeros((1, L), np.int64), x[:-1].astype(np.int64)])
    return (s & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _np_unsigned_sum(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32).sum(dtype=np.uint32).reshape(1, 1).view(
        np.int32)


# probe name -> (the port function (and kernel) that runs its body, the
# probe_inputs keys it takes, NumPy statement of the TPU body)
TPU_BODIES = {
    "matmul32_slice": ("mm32_pack", ("v",), _np_mm32),
    "matmul32_roll": ("mm32_pack", ("v",), _np_mm32),
    "int8_lane_gather": ("lane_gather", ("lut", "idx"),
                         lambda lut, idx: np.take_along_axis(lut, idx, 1)),
    "cmp8": ("cmp8", ("cmp8",), lambda a: (a == 0x2C).astype(np.int32)),
    "select8": ("select8", ("select8",),
                lambda a: np.where(a > 127, a, np.uint8(7))),
    "sublane_concat": ("shift_add", ("v",), _np_shift_add),
    "unsigned_reduce": ("unsigned_sum", ("unsigned",), _np_unsigned_sum),
}
PROBE_KERNEL = {probe: body[0] for probe, body in TPU_BODIES.items()}


def _tpu_probe(name: str, device) -> tuple:
    kernel, keys, statement = TPU_BODIES[name]
    host = probe_inputs()
    args = [torch.from_numpy(host[k]).to(device) for k in keys]
    got = FUNCTIONS[kernel](*args).cpu()
    plain = PLAIN[kernel](*[a.cpu() for a in args])
    want = torch.from_numpy(np.ascontiguousarray(
        statement(*[host[k] for k in keys])))
    if got.shape != want.shape:
        return ("broken-miscompile",
                f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    bad = max(int((got != plain).sum()), int((got != want).sum()))
    if bad:
        return "broken-miscompile", f"{bad} mismatched elements"
    return "fixed", ("output bit-identical to the plain version and the "
                     "NumPy statement")


def mm1_data() -> np.ndarray:
    """The TPU probe's 700,000 bytes, from default_rng(2026)."""
    rng = np.random.default_rng(2026)
    return rng.choice(
        np.frombuffer(b'ab"",\n\rx,z":; \t09\xa2\x8a\x8d\xac\xff',
                      dtype=np.uint8),
        size=700_000)


def probe_mm1_in_context(device="cuda") -> tuple:
    """B1 with pack_mode="mm1" (ignored by the port) on the probe's bytes
    against golden.structural_mask."""
    from .. import golden
    from ..ops.stage1_v2 import pad_to_words
    from ..ops.stage1_v4 import stage1_fused_v4

    data = mm1_data()
    ref = golden.structural_mask(data)
    w2d = torch.from_numpy(pad_to_words(data)).to(device)
    p4 = stage1_fused_v4(w2d, 0, row_tile=512, count_nonascii=False,
                         pack_mode="mm1")[0]
    m4 = np.unpackbits(
        np.ascontiguousarray(p4.cpu().numpy()).view("<u4").view(np.uint8),
        bitorder="little")[:data.size]
    bad = int((m4 != ref).sum())
    if bad:
        return "broken-wrong", f"{bad} mismatched bits vs golden"
    return "fixed", "B1's words bit-identical to golden"


def _probe_fn(name: str):
    def probe(device="cuda") -> tuple:
        return _tpu_probe(name, device)

    probe.__name__ = f"probe_{name}"
    probe.__doc__ = (f"The TPU tool's {name} probe: (status, detail), "
                     "'fixed' when bit-exact.")
    return probe


probe_matmul32_slice = _probe_fn("matmul32_slice")
probe_matmul32_roll = _probe_fn("matmul32_roll")
probe_int8_lane_gather = _probe_fn("int8_lane_gather")
probe_cmp8 = _probe_fn("cmp8")
probe_select8 = _probe_fn("select8")
probe_sublane_concat = _probe_fn("sublane_concat")
probe_unsigned_reduce = _probe_fn("unsigned_reduce")

PROBES = (
    ("matmul32_slice", "(T,32) matmul output consumed via offset lane slice",
     probe_matmul32_slice),
    ("matmul32_roll", "(T,32) matmul output consumed via pltpu.roll combine",
     probe_matmul32_roll),
    ("int8_lane_gather",
     "take_along_axis lane gather on int8 (int32 gathers DO lower)",
     probe_int8_lane_gather),
    ("cmp8", "8-bit vector compare (eq) inside a kernel", probe_cmp8),
    ("select8", "8-bit vector select (jnp.where on uint8 lanes)",
     probe_select8),
    ("sublane_concat", "sublane-axis shift via pad/concat",
     probe_sublane_concat),
    ("unsigned_reduce", "jnp.sum over uint32 lanes", probe_unsigned_reduce),
    ("mm1_in_context", "the FULL v4 kernel with pack_mode='mm1' vs golden",
     probe_mm1_in_context),
)


def report(device) -> dict:
    """Run every TPU probe on device, print the TPU tool's table line for
    each, and return {probe: status}."""
    results = {}
    for name, note, fn in PROBES:
        status, detail = fn(device)
        results[name] = status
        print(f"{name:18s} {status:18s} {detail}   [{note}]", flush=True)
    return results


# --- gate, check, run ----------------------------------------------------


def _random(shape, dtype: torch.dtype, device, seed: int, lo=None,
            hi=None) -> torch.Tensor:
    """Uniform over dtype's whole range, or over [lo, hi), made on device."""
    if lo is None:
        info = torch.iinfo(dtype)
        lo, hi = info.min, info.max + 1
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(lo, hi, shape, dtype=dtype, device=device,
                         generator=gen)


def _cases(rows: int, device, seed: int) -> dict:
    """{kernel: [(inputs, what)]} at `rows` rows, full-range inputs; the
    product also on |v| <= 256 and the gather also on idx outside [0,
    128)."""
    shape = (rows, L)
    a8 = _random(shape, torch.uint8, device, seed + 1)
    x = _random(shape, torch.int32, device, seed + 2)
    lut = _random(shape, torch.int8, device, seed + 3)
    at = f"rows={rows}"
    return {
        "mm32_pack": [((x,), f"{at} full range"),
                      ((_random(shape, torch.int32, device, seed + 4, -256,
                                257),), f"{at} |v| <= 256")],
        "lane_gather": [
            ((lut, _random(shape, torch.int32, device, seed + 5, 0, L)),
             f"{at} idx in [0, 128)"),
            ((lut, _random(shape, torch.int32, device, seed + 6)),
             f"{at} idx full range")],
        "cmp8": [((a8,), at)],
        "select8": [((a8,), at)],
        "shift_add": [((x,), at)],
        "unsigned_sum": [((x,), at)],
    }


def _probe_cases(device) -> dict:
    """{kernel: [(the TPU probe's inputs on device, "TPU probe")]}."""
    host = probe_inputs()
    out = {}
    for kernel, keys, _statement in TPU_BODIES.values():
        out.setdefault(kernel, [(tuple(torch.from_numpy(host[k]).to(device)
                                       for k in keys), "TPU probe")])
    return out


def _pairs(cases: dict) -> dict:
    return {k: [(FUNCTIONS[k](*args), PLAIN[k](*args), f"{k} {what}")
                for args, what in v] for k, v in cases.items()}


def gate(device) -> dict:
    """{kernel: {checks, max_abs_err}}: each kernel against its plain
    version at 8, 56, 512, 520 and 8000 rows (full-range inputs; the
    product also on |v| <= 256, the gather also on idx outside [0, 128))
    and on the TPU probes' inputs."""
    pairs = _pairs(_probe_cases(device))
    for i, rows in enumerate(GATE_ROWS):
        for k, p in _pairs(_cases(rows, device, 10 * i)).items():
            pairs[k] += p
    return {k: check_all(p) for k, p in pairs.items()}


def timed_inputs(device, seed: int = 64, scale: int = 1) -> dict:
    """{kernel: inputs} at 64 MiB / scale of each kernel's first input: the
    product on nibbles (the domain its library call shares), the gather's
    idx in [0, 128), the rest full range."""
    rows32 = TIMED_ROWS["int32"] // scale
    rows8 = TIMED_ROWS["bytes"] // scale
    x = _random((rows32, L), torch.int32, device, seed)
    a8 = _random((rows8, L), torch.uint8, device, seed + 1)
    return {
        "mm32_pack": (_random((rows32, L), torch.int32, device, seed + 2, 0,
                              16),),
        "lane_gather": (_random((rows8, L), torch.int8, device, seed + 3),
                        _random((rows8, L), torch.int32, device, seed + 4, 0,
                                L)),
        "cmp8": (a8,), "select8": (a8,), "shift_add": (x,),
        "unsigned_sum": (x,)}


def library_calls(inputs: dict) -> dict:
    """{kernel: fn}: one PyTorch call (or a short chain) that computes each
    kernel's function on its timed inputs; the product's is the TPU body,
    a bf16 product with float32 output and the combine, which equals it on
    the nibble input."""
    (v,), (lut, idx) = inputs["mm32_pack"], inputs["lane_gather"]
    (a,), (x,) = inputs["cmp8"], inputs["shift_add"]
    w32 = torch.from_numpy(pack_weights32()).to(v.device)

    def mm32():
        if v.device.type == "cuda":
            o = torch.mm(v.to(torch.bfloat16), w32.to(torch.bfloat16),
                         out_dtype=torch.float32)
        else:
            o = v.float() @ w32
        o = o.to(torch.int32)
        return o[:, :16] | (o[:, 16:] << 16)

    return {"mm32_pack": mm32,
            "lane_gather": lambda: torch.gather(lut, 1, idx.long()),
            "cmp8": lambda: (a == 0x2C).to(torch.int32),
            "select8": lambda: torch.where(a > 127, a, 7),
            "shift_add": lambda: x + F.pad(x[:-1], (0, 0, 1, 0)),
            "unsigned_sum": lambda: x.sum(dtype=torch.int32)}


def check(inputs: dict) -> dict:
    """{kernel: {checks, max_abs_err}}: each kernel and its library call
    against the plain version on the inputs `run` times."""
    lib = library_calls(inputs)
    out = {}
    for k, args in inputs.items():
        plain = PLAIN[k](*args)
        out[k] = check_all([(FUNCTIONS[k](*args), plain, f"{k} timed"),
                            (lib[k](), plain, f"{k} library call")])
    return out


def input_bytes(args) -> int:
    return sum(t.numel() * t.element_size() for t in args)


def run(inputs: dict, reps: int = 20, plain_reps: int = 2) -> dict:
    """{kernel: {ms, eager_ms, gbps (GB/s of input, from ms), plain_ms,
    library_ms}} on the timed inputs, the kernels timed in turns (CUDA
    graphs and eager), the library calls from CUDA graphs. `check` holds
    the same calls against the plain versions."""
    ms = kernel_ms({k: (lambda k=k, a=a: FUNCTIONS[k](*a))
                    for k, a in inputs.items()}, reps)
    lib = library_calls(inputs)
    return {k: {**ms[k],
                "gbps": input_bytes(inputs[k]) / ms[k]["ms"] / 1e6,
                "plain_ms": interleaved_ms(
                    {0: lambda k=k: PLAIN[k](*inputs[k])}, plain_reps,
                    rounds=1)[0],
                "library_ms": graph_ms(lib[k], reps)}
            for k in ms}


def main(argv) -> int:
    device = need_card("mosaic_probes")
    results = report(device)
    info = card()
    print(json.dumps({"platform": "gpu", **info, "probes": results}),
          flush=True)
    inputs = timed_inputs(device)
    emit({**info, "gate": gate(device), "check": check(inputs),
          "run": run(inputs)})
    return 0 if all(s == "fixed" for s in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
