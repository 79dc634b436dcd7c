"""Observability: the program's spans and counters.

The reference's only instrumentation is a wall-clock print around the
whole pipeline (lib.rs:62,71) and debug-build printlns inside kernels
(SURVEY.md §5.1/§5.5). Here every pipeline stage records into one
registry: a span keeps its calls, host seconds and bytes, a counter its
count, and `report()` prints both as a table.

While a torch profiler runs, a span also opens a
`torch.profiler.record_function` of its name, so it lands in the
profiler's trace on the device events' clock, nested in whatever span
is open around it. With no profiler running it never enters one (that
costs about 11 us a span; the check costs 0.1 us). A span over enqueued
device work measures the host's enqueue time: no span or counter
synchronises with the device or reads anything back from it.

The port's own copy of csv_simd_tpu/utils/metrics.py;
it imports nothing of that package.
"""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

_profiling = torch._C._autograd._profiler_enabled


@dataclass
class StageStats:
    name: str
    calls: int = 0  # a counter's count
    seconds: float = 0.0
    bytes: int = 0
    counter: bool = False

    @property
    def gbps(self) -> Optional[float]:
        if self.seconds > 0 and self.bytes > 0:
            return self.bytes / self.seconds / 1e9
        return None


@dataclass
class Metrics:
    stages: Dict[str, StageStats] = field(default_factory=dict)
    # builds in worker threads (corpora, the streaming index) record too
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def _stage(self, name: str, counter: bool) -> StageStats:
        st = self.stages.get(name)
        if st is None:
            with self._lock:
                st = self.stages.setdefault(
                    name, StageStats(name, counter=counter))
        if st.counter != counter:
            kind = "counter" if st.counter else "span"
            raise ValueError(f"{name!r} is a {kind}; a name is a span or "
                             "a counter, never both")
        return st

    def span(self, name: str, n_bytes: int = 0) -> "_Span":
        """A span of `name`: a context manager, or a decorator that opens
        a fresh span around every call of the function."""
        return _Span(self, name, n_bytes)

    def count(self, name: str, n: int) -> None:
        """Add the host integer `n` to the counter `name` (its `calls`;
        its seconds stay 0). Counting 0 still makes the counter."""
        st = self._stage(name, counter=True)
        with self._lock:
            st.calls += n

    def report(self) -> str:
        lines = [f"{'stage':24s} {'calls':>6s} {'ms':>10s} {'GB/s':>8s}"]
        for st in self.stages.values():
            if st.counter:
                continue
            gbps = f"{st.gbps:.2f}" if st.gbps else "-"
            lines.append(
                f"{st.name:24s} {st.calls:6d} {st.seconds*1e3:10.2f} {gbps:>8s}"
            )
        counters = [st for st in self.stages.values() if st.counter]
        if counters:
            lines.append(f"{'counter':24s} {'count':>6s}")
            lines.extend(f"{st.name:24s} {st.calls:6d}" for st in counters)
        return "\n".join(lines)

    def reset(self) -> None:
        self.stages.clear()


class _Span:
    """One span: adds a call, its host seconds and `n_bytes` to its stage
    on exit, inside a record_function of its name while a torch profiler
    runs. A class and not a generator: about 1 us a span on the host."""

    __slots__ = ("_metrics", "_name", "_bytes", "_stage", "_mark", "_t0")

    def __init__(self, metrics: Metrics, name: str, n_bytes: int):
        self._metrics, self._name, self._bytes = metrics, name, n_bytes

    def __enter__(self) -> None:
        self._stage = self._metrics._stage(self._name, counter=False)
        self._mark = None
        if _profiling():
            self._mark = torch.profiler.record_function(self._name)
            self._mark.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self._t0
        if self._mark is not None:
            self._mark.__exit__(*exc)
        st = self._stage
        with self._metrics._lock:
            st.calls += 1
            st.seconds += dt
            st.bytes += self._bytes
        return False

    def __call__(self, f):
        @functools.wraps(f)
        def spanned(*args, **kwargs):
            with _Span(self._metrics, self._name, self._bytes):
                return f(*args, **kwargs)

        return spanned


# the process-global registry the program records into: always on; a
# span enters record_function only while a torch profiler runs
GLOBAL = Metrics()
