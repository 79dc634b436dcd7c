"""JSON inputs for the port's JSON stage-1 (experiments/json_device.py and
kernel J1): edge cases of escapes, strings and depth, inputs whose
backslash runs and strings straddle the cuts a device kernel makes, and
a seeded block of newline-delimited JSON records. Shared by the CPU
tests, the on-card tests and chip_smoke.py; imports neither JAX nor
torch."""

from __future__ import annotations

import json

import numpy as np

# tests/test_json_experiment.py's cases
CASES = [
    b"{}",
    b'{"a": 1, "b": [2, 3]}',
    b'{"s": "br{ace}s, and [colons]: inside"}',
    b'{"esc": "quote \\" inside"}',
    b'{"bs": "ends with backslash \\\\"}',
    b'{"bs2": "\\\\\\" still in string, here: yes"}',
    b'["\\\\", "\\"", "\\\\\\\\", {"k": "v"}]',
    b'{"deep": {"a": [{"b": [[]]}]}}',
    b"[1,2,3]",
    b"",
    b'"just a string with , and { inside"',
]

ALPHABET = b'{}[]:,"\\ab1 \n\t'

# cuts a device kernel may make: its warp steps, its segments, its blocks
CUTS = (128, 512, 4096, 16384, 65536)


def escape_runs(max_run: int = 70) -> list:
    """Backslash runs of every length 0..max_run before a quote inside a
    string: even runs leave the quote closing it, odd ones escape it."""
    return [b'{"x": "' + b"\\" * k + b'", "y": [1]}'
            for k in range(max_run + 1)]


def straddling(cuts=CUTS) -> list:
    """(name, bytes): backslash runs of lengths 1-5 and 127-129 ending
    just before, at and just after each cut, followed by a quote and
    brackets; a whole cut-long run of backslashes; and a string that
    spans many cuts with brackets inside it."""
    out = []
    for cut in cuts:
        for run in (1, 2, 3, 4, 5, 127, 128, 129):
            for end in (cut - 1, cut, cut + 1):
                lo = end - run
                if lo < 8:
                    continue
                data = bytearray(b"[" + b" " * (lo - 1))
                data += b"\\" * run + b'"{[]}:,"' + b"]" * 3 + b"x" * 40
                out.append((f"run {run} ends at {end}", bytes(data)))
        for pre in (0, 1):
            data = b"[" * pre + b"\\" * cut + b'"{[' + b"\\" * (cut + pre) \
                + b'"],' * 5
            out.append((f"{cut} backslashes after {pre}", data))
    span = b'{"s": "' + b"{[:,]}\\\\" * 40_000 + b'", "t": [1, {"u": 2}]}'
    out.append(("a string across many cuts", span))
    return out


def random_alphabet(n: int, seed: int) -> np.ndarray:
    """n seeded bytes of ALPHABET."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(ALPHABET, np.uint8), size=n)


def _record(rng: np.random.Generator) -> dict:
    def value(depth):
        k = rng.random()
        if depth > 3 or k < 0.35:
            return [int(rng.integers(-10**6, 10**6)), 'say "hi"',
                    "a\\b", "\\" * int(rng.integers(1, 6)) + '"',
                    "{[:,]}", None, True, float(rng.integers(0, 999)) / 8,
                    "plain text"][int(rng.integers(0, 9))]
        if k < 0.65:
            return [value(depth + 1) for _ in range(int(rng.integers(0, 4)))]
        return {f"k{i}\\\"{'x' * int(rng.integers(0, 3))}": value(depth + 1)
                for i in range(int(rng.integers(0, 4)))}

    return {"id": int(rng.integers(0, 10**9)), "v": value(0)}


def json_lines(n_bytes: int, seed: int, distinct: int = 4096) -> bytes:
    """About n_bytes (never more) of newline-delimited `json.dumps`
    records, seeded: `distinct` records with escaped quotes and backslash
    runs in their strings, drawn at random to fill the size. Each line
    is a whole document, so the block ends outside strings at depth 0
    with no trailing backslash, and can be tiled."""
    rng = np.random.default_rng(seed)
    lines = [json.dumps(_record(rng)).encode() + b"\n"
             for _ in range(distinct)]
    lens = np.array([len(x) for x in lines])
    picks = rng.integers(0, distinct, size=n_bytes // int(lens.min()) + 1)
    keep = np.searchsorted(np.cumsum(lens[picks]), n_bytes, side="right")
    return b"".join(lines[i] for i in picks[:keep])
