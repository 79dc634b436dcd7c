"""Observability: structured per-stage timing and throughput.

The reference's only instrumentation is a wall-clock print around the
whole pipeline (lib.rs:62,71) and debug-build printlns inside kernels
(SURVEY.md §5.1/§5.5). Here every pipeline stage can record spans into a
registry that reports counts, wall time and bytes/s, either as a table or
as one JSON line per stage (machine-readable, like bench.py's output).

The port's own copy of csv_simd_tpu/utils/metrics.py;
it imports nothing of that package.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional


@dataclass
class StageStats:
    name: str
    calls: int = 0
    seconds: float = 0.0
    bytes: int = 0

    @property
    def gbps(self) -> Optional[float]:
        if self.seconds > 0 and self.bytes > 0:
            return self.bytes / self.seconds / 1e9
        return None


@dataclass
class Metrics:
    stages: Dict[str, StageStats] = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str, n_bytes: int = 0) -> Iterator[None]:
        st = self.stages.setdefault(name, StageStats(name))
        t0 = time.perf_counter()
        try:
            yield
        finally:
            st.calls += 1
            st.seconds += time.perf_counter() - t0
            st.bytes += n_bytes

    def record(self, name: str, seconds: float, n_bytes: int = 0) -> None:
        st = self.stages.setdefault(name, StageStats(name))
        st.calls += 1
        st.seconds += seconds
        st.bytes += n_bytes

    def report(self) -> str:
        lines = [f"{'stage':24s} {'calls':>6s} {'ms':>10s} {'GB/s':>8s}"]
        for st in self.stages.values():
            gbps = f"{st.gbps:.2f}" if st.gbps else "-"
            lines.append(
                f"{st.name:24s} {st.calls:6d} {st.seconds*1e3:10.2f} {gbps:>8s}"
            )
        return "\n".join(lines)

    def json_lines(self) -> str:
        out = []
        for st in self.stages.values():
            out.append(
                json.dumps(
                    {
                        "stage": st.name,
                        "calls": st.calls,
                        "seconds": round(st.seconds, 6),
                        "bytes": st.bytes,
                        "gbps": round(st.gbps, 3) if st.gbps else None,
                    }
                )
            )
        return "\n".join(out)

    def reset(self) -> None:
        self.stages.clear()


# process-global default registry (opt-in; the hot paths take a
# metrics=None parameter and skip instrumentation when unset)
GLOBAL = Metrics()
