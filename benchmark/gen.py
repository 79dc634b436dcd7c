"""The benchmark's data generator: one seeded, vectorised CSV writer that
every configuration file drives.

A configuration file (benchmark/configs/<name>.json) lists its columns in
order. Each column has a `value`, a Python expression over torch tensors
that draws or derives one int64 value a row, and a `format` that prints
the value. Hidden columns (`derive`) are evaluated first and are not
printed. The expressions see:

    n, parent, line, n_parents         rows, each row's parent group and
                                       its place in it (see `groups`)
    randint(lo, hi, per=None)          uniform integers in [lo, hi]
    pick(values, weights, per=None)    values drawn by weight
    uniform(lo, hi), exponential(mean), normal(mu, sd)    float64 draws
    text(lo, hi)                       a substring of the text pool
    day("YYYY-MM-DD"), sec("YYYY-MM-DD hh:mm:ss")          epoch numbers
    where, clamp, floor, rnd, i64, torch, and every column so far

`per="parent"` draws once a parent and repeats the draw on its rows. The
draws come from one torch.Generator seeded by --seed, in the order of the
file, so the same seed gives the same bytes on one device and torch.

Formats: "int"; {"fixed": s} and {"short": s} for a value in units of
10**-s, with all s digits or with trailing zeros (and a bare ".")
dropped; "date" (days since 1970-01-01) and "datetime" (seconds); {"g17":
b} for the binary fraction value * 2**-b printed as C's "%.17g" prints a
double, trailing zeros dropped; {"choice": [strings]} by index; "text".
A field that holds the delimiter, a quote or a line break is quoted as
RFC 4180 says, with its quotes doubled.

Rows are formatted and written in chunks, so the device holds the value
columns and one chunk of text at a time.
"""

from __future__ import annotations

import datetime as _dt
import os

import numpy as np
import torch

DELIM, QUOTE, LF, CR = 0x2C, 0x22, 0x0A, 0x0D
CHUNK_ROWS = 1 << 20
_EPOCH = _dt.date(1970, 1, 1)
_POW10 = [10**k for k in range(19)]


def day(s: str) -> int:
    return (_dt.date.fromisoformat(s) - _EPOCH).days


def sec(s: str) -> int:
    t = _dt.datetime.fromisoformat(s)
    return day(t.date().isoformat()) * 86400 + t.hour * 3600 + \
        t.minute * 60 + t.second


def seed_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


class _Draws:
    """The expression namespace's random and calendar helpers, all drawing
    from one generator in call order."""

    def __init__(self, n: int, parent: torch.Tensor, n_parents: int,
                 g: torch.Generator, device):
        self.n, self.parent, self.n_parents = n, parent, n_parents
        self.g, self.device = g, device
        self.text_len_bits = 8

    def _spread(self, x: torch.Tensor, per):
        if per is None:
            return x
        if per != "parent":
            raise ValueError(f"per={per!r}: only 'parent' is known")
        return x[self.parent]

    def _m(self, per) -> int:
        return self.n if per is None else self.n_parents

    def randint(self, lo: int, hi: int, per=None) -> torch.Tensor:
        x = torch.randint(int(lo), int(hi) + 1, (self._m(per),),
                          generator=self.g, device=self.device,
                          dtype=torch.int64)
        return self._spread(x, per)

    def pick(self, values, weights, per=None) -> torch.Tensor:
        w = np.asarray(weights, np.float64)
        cdf = torch.tensor(np.cumsum(w) / w.sum(), dtype=torch.float64,
                           device=self.device)
        u = torch.rand(self._m(per), generator=self.g, device=self.device,
                       dtype=torch.float64)
        idx = torch.searchsorted(cdf, u, right=True).clamp(max=len(w) - 1)
        table = torch.tensor(list(values), dtype=torch.int64,
                             device=self.device)
        return self._spread(table[idx], per)

    def uniform(self, lo: float, hi: float, per=None) -> torch.Tensor:
        u = torch.rand(self._m(per), generator=self.g, device=self.device,
                       dtype=torch.float64)
        return self._spread(lo + (hi - lo) * u, per)

    def exponential(self, mean: float, per=None) -> torch.Tensor:
        u = torch.rand(self._m(per), generator=self.g, device=self.device,
                       dtype=torch.float64)
        return self._spread(-mean * torch.log1p(-u), per)

    def normal(self, mu: float, sd: float, per=None) -> torch.Tensor:
        z = torch.randn(self._m(per), generator=self.g, device=self.device,
                        dtype=torch.float64)
        return self._spread(mu + sd * z, per)

    def text(self, lo: int, hi: int) -> torch.Tensor:
        """(offset << 8) | length of a substring of the text pool, whose
        length is uniform in [lo, hi]; `format: "text"` prints it."""
        if not 0 < lo <= hi < (1 << self.text_len_bits):
            raise ValueError(f"text length [{lo}, {hi}] out of range")
        length = self.randint(lo, hi)
        off = torch.randint(0, self.pool_size - hi + 1, (self.n,),
                            generator=self.g, device=self.device,
                            dtype=torch.int64)
        return (off << self.text_len_bits) | length

    def namespace(self) -> dict:
        return dict(
            randint=self.randint, pick=self.pick, uniform=self.uniform,
            exponential=self.exponential, normal=self.normal,
            text=self.text, day=day, sec=sec, torch=torch,
            where=torch.where, clamp=torch.clamp, floor=torch.floor,
            rnd=torch.round, i64=lambda x: x.to(torch.int64),
        )


def _group_sizes(spec: dict, g: torch.Generator, device) -> torch.Tensor:
    """Sizes of `parents` groups drawn from `sizes`, adding up to exactly
    `rows` for every seed: the sizes cycle through the values, the first
    groups that can grow (or shrink) by one take up the difference, and
    the seed permutes them."""
    parents, rows = int(spec["parents"]), int(spec["rows"])
    values = torch.tensor(spec["sizes"], dtype=torch.int64)
    sizes = values[torch.arange(parents) % len(values)]
    lo, hi = int(values.min()), int(values.max())
    diff = rows - int(sizes.sum())
    can = torch.nonzero(sizes < hi if diff > 0 else sizes > lo)[:, 0]
    if can.numel() < abs(diff):
        raise ValueError(f"{parents} groups of {spec['sizes']} cannot hold "
                         f"{rows} rows")
    sizes[can[: abs(diff)]] += 1 if diff > 0 else -1
    perm = torch.randperm(parents, generator=g, device=device)
    return sizes.to(device)[perm]


def _text_pool(spec: dict, g: torch.Generator, device) -> torch.Tensor:
    """`spec["bytes"]` bytes of sentences from the vocabulary: a noun
    phrase (noun; adjective noun; adjective, adjective noun; adverb
    adjective noun), a verb phrase (verb; verb adverb; auxiliary verb
    adverb) and a terminator, as uint8 on `device`."""
    words = {k: spec[k] for k in ("nouns", "verbs", "adjectives",
                                  "adverbs", "auxiliaries", "terminators")}
    n_sent = spec["bytes"] // 16 + 16
    draws = {k: torch.randint(0, len(v), (n_sent,), generator=g,
                              device=device).tolist()
             for k, v in words.items()}
    form = torch.randint(0, 12, (n_sent,), generator=g,
                         device=device).tolist()
    out, size = [], 0
    for i in range(n_sent):
        noun = words["nouns"][draws["nouns"][i]]
        adj = words["adjectives"][draws["adjectives"][i]]
        adj2 = words["adjectives"][draws["adjectives"][-1 - i]]
        adv = words["adverbs"][draws["adverbs"][i]]
        verb = words["verbs"][draws["verbs"][i]]
        aux = words["auxiliaries"][draws["auxiliaries"][i]]
        np_form = (noun, f"{adj} {noun}", f"{adj}, {adj2} {noun}",
                   f"{adv} {adj} {noun}")[form[i] % 4]
        vp_form = (verb, f"{verb} {adv}", f"{aux} {verb} {adv}")[form[i] // 4]
        s = f"{np_form} {vp_form}{words['terminators'][draws['terminators'][i]]} "
        out.append(s)
        size += len(s)
        if size >= spec["bytes"]:
            break
    raw = "".join(out).encode("ascii")[: spec["bytes"]]
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(device)


# ---------------------------------------------------------------- formats

def _ndigits(v: torch.Tensor) -> torch.Tensor:
    nd = torch.ones_like(v)
    for k in range(1, 19):
        nd += (v >= _POW10[k]).to(torch.int64)
    return nd


def _digits(v: torch.Tensor, width: int) -> tuple:
    """Non-negative int64 v -> ((n, width) uint8 ASCII digits, left
    aligned, int64 digit counts)."""
    nd = _ndigits(v)
    p10 = torch.tensor(_POW10, dtype=torch.int64, device=v.device)
    j = torch.arange(width, device=v.device)[None, :]
    k = (nd[:, None] - 1 - j).clamp(min=0)
    d = (v[:, None] // p10[k]) % 10
    return (d + 48).to(torch.uint8), nd


def _concat(parts) -> tuple:
    """Fields made of parts ((n, w) uint8, lengths) laid end to end ->
    ((n, sum w) uint8, lengths)."""
    n = parts[0][0].shape[0]
    width = sum(p[0].shape[1] for p in parts)
    dev = parts[0][0].device
    out = torch.zeros((n, width), dtype=torch.uint8, device=dev)
    at = torch.zeros(n, dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)[:, None]
    for mat, ln in parts:
        j = torch.arange(mat.shape[1], device=dev)[None, :]
        keep = j < ln[:, None]
        cols = (at[:, None] + j).clamp(max=width - 1)
        out[rows.expand_as(cols)[keep], cols[keep]] = mat[keep]
        at = at + ln
    return out, at


def _const(n: int, s: bytes, device) -> tuple:
    mat = torch.tensor(list(s), dtype=torch.uint8,
                       device=device)[None, :].expand(n, len(s))
    return mat, torch.full((n,), len(s), dtype=torch.int64, device=device)


def _when(part: tuple, cond: torch.Tensor) -> tuple:
    return part[0], torch.where(cond, part[1], 0)


def _fmt_int(v: torch.Tensor) -> tuple:
    neg = v < 0
    a = v.abs()
    width = len(str(int(a.max()))) if a.numel() else 1
    return _concat([_when(_const(v.shape[0], b"-", v.device), neg),
                    _digits(a, width)])


def _fmt_decimal(v: torch.Tensor, scale: int, short: bool) -> tuple:
    n, dev = v.shape[0], v.device
    neg = v < 0
    a = v.abs()
    ip, fp = a // _POW10[scale], a % _POW10[scale]
    width = len(str(int(ip.max()))) if n else 1
    frac, _ = _digits(fp + _POW10[scale], scale + 1)  # "1" + padded digits
    frac_len = torch.full((n,), scale, dtype=torch.int64, device=dev)
    if short:
        for k in range(scale):
            frac_len -= ((fp % _POW10[k + 1]) == 0).to(torch.int64)
    return _concat([_when(_const(n, b"-", dev), neg), _digits(ip, width),
                    _when(_const(n, b".", dev), frac_len > 0),
                    (frac[:, 1:], frac_len)])


def _civil(days: torch.Tensor) -> tuple:
    """Days since 1970-01-01 -> (year, month, day), proleptic Gregorian
    (H. Hinnant's days_from_civil inverse)."""
    z = days + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return y + (m <= 2).to(torch.int64), m, d


def _fixed_digits(v: torch.Tensor, width: int) -> tuple:
    mat, _ = _digits(v + _POW10[width], width + 1)
    return mat[:, 1:], torch.full_like(v, width)


def _fmt_date(days: torch.Tensor) -> tuple:
    y, m, d = _civil(days)
    n, dev = days.shape[0], days.device
    dash = _const(n, b"-", dev)
    return _concat([_fixed_digits(y, 4), dash, _fixed_digits(m, 2), dash,
                    _fixed_digits(d, 2)])


def _fmt_datetime(secs: torch.Tensor) -> tuple:
    days = torch.div(secs, 86400, rounding_mode="floor")
    s = secs - days * 86400
    n, dev = secs.shape[0], secs.device
    colon = _const(n, b":", dev)
    return _concat([_fmt_date(days), _const(n, b" ", dev),
                    _fixed_digits(s // 3600, 2), colon,
                    _fixed_digits(s // 60 % 60, 2), colon,
                    _fixed_digits(s % 60, 2)])


def _fmt_g17(m: torch.Tensor, bits: int) -> tuple:
    """m * 2**-bits as "%.17g" prints it: 17 significant digits of the
    exact binary value, rounded half to even, trailing zeros dropped; 0
    prints as "0". Needs |value| >= 1 or 0, and 5**bits * 2**bits < 2**63."""
    if 5**bits * (1 << bits) >= 1 << 63:
        raise ValueError(f"g17: {bits} fraction bits overflow int64")
    n, dev = m.shape[0], m.device
    neg = m < 0
    a = m.abs()
    ip = a >> bits
    if bool(((ip == 0) & (a != 0)).any()):
        raise ValueError("g17 needs |value| >= 1 or exactly 0")
    exact = (a & ((1 << bits) - 1)) * 5**bits  # `bits` decimal digits
    int_digits = _ndigits(ip)
    keep = (17 - int_digits).clamp(min=0, max=bits)  # fraction digits kept
    p10 = torch.tensor(_POW10, dtype=torch.int64, device=dev)
    unit = p10[bits - keep]
    q, r = exact // unit, exact % unit
    up = (2 * r > unit) | ((2 * r == unit) & (q % 2 == 1))
    q = q + up.to(torch.int64)
    carry = q >= p10[keep]
    ip = ip + carry.to(torch.int64)
    q = torch.where(carry, q - p10[keep], q)
    # drop trailing zeros of the kept fraction
    frac_len = keep.clone()
    for k in range(bits):
        frac_len -= ((k < keep) & ((q % _POW10[k + 1]) == 0)).to(torch.int64)
    width = len(str(int(ip.max()))) if n else 1
    frac, _ = _digits(q + p10[keep], bits + 1)  # "1" + keep digits
    zero = a == 0
    return _concat([_when(_const(n, b"-", dev), neg & ~zero),
                    _digits(ip, width),
                    _when(_const(n, b".", dev), frac_len > 0),
                    (frac[:, 1:], frac_len)])


def _fmt_choice(idx: torch.Tensor, strings) -> tuple:
    raw = [s.encode() for s in strings]
    width = max(len(s) for s in raw)
    table = torch.zeros((len(raw), width), dtype=torch.uint8)
    for i, s in enumerate(raw):
        table[i, : len(s)] = torch.tensor(list(s), dtype=torch.uint8)
    lens = torch.tensor([len(s) for s in raw], dtype=torch.int64)
    dev = idx.device
    return table.to(dev)[idx], lens.to(dev)[idx]


def _fmt_text(v: torch.Tensor, pool: torch.Tensor) -> tuple:
    length = v & 0xFF
    off = v >> 8
    hi = int(length.max()) if v.numel() else 1
    j = torch.arange(hi, device=v.device)[None, :]
    mat = pool[(off[:, None] + j).clamp(max=pool.shape[0] - 1)]
    return torch.where(j < length[:, None], mat, 0), length


def _quote(mat: torch.Tensor, ln: torch.Tensor) -> tuple:
    """RFC 4180: a field holding the delimiter, a quote or a line break
    is wrapped in quotes, each quote inside doubled."""
    j = torch.arange(mat.shape[1], device=mat.device)[None, :]
    inside = j < ln[:, None]
    special = ((mat == DELIM) | (mat == QUOTE) | (mat == LF)
               | (mat == CR)) & inside
    need = special.any(dim=1)
    if not bool(need.any()):
        return mat, ln
    isq = ((mat == QUOTE) & inside).to(torch.int64)
    before = torch.cumsum(isq, dim=1) - isq
    n_q = isq.sum(dim=1)
    width = mat.shape[1] * 2 + 2
    out = torch.zeros((mat.shape[0], width), dtype=torch.uint8,
                      device=mat.device)
    rows = torch.arange(mat.shape[0], device=mat.device)[:, None].expand_as(
        mat)
    shift = torch.where(need[:, None], before + 1, 0)
    cols = j + shift
    out[rows[inside], cols[inside]] = mat[inside]
    dq = inside & (isq > 0) & need[:, None]
    out[rows[dq], (cols + 1)[dq]] = QUOTE
    new_len = torch.where(need, ln + n_q + 2, ln)
    r = torch.nonzero(need)[:, 0]
    out[r, 0] = QUOTE
    out[r, new_len[r] - 1] = QUOTE
    return out, new_len


# ---------------------------------------------------------------- writer

class Table:
    """One configuration's columns, drawn for `rows` rows from `seed`
    (the configuration's own row count when rows is None)."""

    def __init__(self, config: dict, seed: int, device, rows=None):
        self.config = config
        self.device = torch.device(device)
        g = seed_generator(seed, self.device)
        groups = config.get("groups")
        if groups is not None:
            spec = dict(groups)
            if rows is not None:  # a smaller table keeps the group shape
                spec["rows"] = int(rows)
                mean = sum(spec["sizes"]) / len(spec["sizes"])
                spec["parents"] = max(1, round(int(rows) / mean))
            sizes = _group_sizes(spec, g, self.device)
            n = int(spec["rows"])
            parent = torch.repeat_interleave(
                torch.arange(sizes.numel(), device=self.device), sizes)
            starts = torch.cumsum(sizes, 0) - sizes
            line = torch.arange(n, device=self.device) - starts[parent]
            n_parents = sizes.numel()
        else:
            n = int(config["rows"] if rows is None else rows)
            parent = torch.arange(n, device=self.device)
            line = torch.zeros(n, dtype=torch.int64, device=self.device)
            n_parents = n
        self.n = n
        draws = _Draws(n, parent, n_parents, g, self.device)
        self.pool = None
        if "text_pool" in config:
            self.pool = _text_pool(config["text_pool"], g, self.device)
            draws.pool_size = self.pool.numel()
        # torch's C code imports through the caller's builtins
        env = {"__builtins__": {"__import__": __import__, "range": range,
                                "min": min, "max": max, "abs": abs},
               "n": n, "parent": parent, "line": line,
               "n_parents": n_parents, **draws.namespace()}
        self.values = {}
        for col in config.get("derive", []) + config["columns"]:
            v = eval(col["value"], env)  # the repo's own config files
            if not isinstance(v, torch.Tensor):
                v = torch.full((n,), v, device=self.device)
            v = v.to(torch.int64).expand(n).contiguous()
            env[col["name"]] = v
            self.values[col["name"]] = v
        self.header = ",".join(c["name"] for c in config["columns"]) \
            .encode() + b"\n"

    def _format(self, col: dict, lo: int, hi: int) -> tuple:
        v = self.values[col["name"]][lo:hi]
        fmt = col["format"]
        if fmt == "int":
            out = _fmt_int(v)
        elif fmt == "date":
            out = _fmt_date(v)
        elif fmt == "datetime":
            out = _fmt_datetime(v)
        elif fmt == "text":
            out = _fmt_text(v, self.pool)
        elif "fixed" in fmt:
            out = _fmt_decimal(v, int(fmt["fixed"]), short=False)
        elif "short" in fmt:
            out = _fmt_decimal(v, int(fmt["short"]), short=True)
        elif "g17" in fmt:
            out = _fmt_g17(v, int(fmt["g17"]))
        elif "choice" in fmt:
            out = _fmt_choice(v, fmt["choice"])
        else:
            raise ValueError(f"column {col['name']}: unknown format {fmt!r}")
        return _quote(*out)

    def chunk(self, lo: int, hi: int) -> torch.Tensor:
        """Rows lo..hi-1 as CSV bytes (uint8 on the device), each row
        ended by LF."""
        cols = self.config["columns"]
        fields = [self._format(c, lo, hi) for c in cols]
        row_len = sum(f[1] for f in fields) + len(cols)
        row_off = torch.cumsum(row_len, 0) - row_len
        out = torch.empty(int(row_len.sum()), dtype=torch.uint8,
                          device=self.device)
        at = row_off
        for i, (mat, ln) in enumerate(fields):
            j = torch.arange(mat.shape[1], device=self.device)[None, :]
            keep = j < ln[:, None]
            out[(at[:, None] + j)[keep]] = mat[keep]
            at = at + ln
            out[at] = LF if i == len(cols) - 1 else DELIM
            at = at + 1
        return out

    def write(self, path: str) -> int:
        """Write the table as CSV with its header to `path` and flush it
        to the disk; returns the byte count."""
        total = 0
        with open(path, "wb") as f:
            f.write(self.header)
            total += len(self.header)
            for lo in range(0, self.n, CHUNK_ROWS):
                b = self.chunk(lo, min(lo + CHUNK_ROWS, self.n)).cpu()
                f.write(b.numpy().tobytes())
                total += b.numel()
            # written back in set-up, so that no writeback of the file's
            # dirty pages competes with the window (it made the ingest
            # rate swing by 10-15% between runs)
            f.flush()
            os.fsync(f.fileno())
        return total

    def to_bytes(self) -> bytes:
        parts = [self.header]
        for lo in range(0, self.n, CHUNK_ROWS):
            parts.append(self.chunk(lo, min(lo + CHUNK_ROWS, self.n))
                         .cpu().numpy().tobytes())
        return b"".join(parts)


def tmp_csv_path(name: str) -> str:
    """A file for the generated table under TMPDIR, named by the process
    so two runs never share one."""
    import tempfile

    fd, path = tempfile.mkstemp(prefix=f"{name}-", suffix=".csv")
    os.close(fd)
    return path
