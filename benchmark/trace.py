"""The traced part of a `--trace 1` run: torch.profiler (CUPTI) over a
few steady iterations of the window, read back as plain events.

`Trace` holds the device events (kernels, copies, sets) and the host
spans that the benchmark wraps around its calls into the program, all on
the profiler's one clock in microseconds, with what the traced
iterations did (`counts`) and the program's own spans over them
(`spans`). The per-layer readers under benchmark/metrics/ take it.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ITER_SPAN = "bench.iteration"


class EmptyTrace(RuntimeError):
    """The trace holds no device activity: no per-layer metric may be
    read from it."""


@dataclass
class Trace:
    events: list  # device events: {"name", "cat", "ts", "dur"} in us
    host: list  # host spans and ops: {"name", "cat", "ts", "dur"}
    counts: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)  # name -> (seconds, calls)

    def window(self) -> tuple:
        """(start, end) in us: from the first traced iteration's start to
        the last one's end."""
        its = [e for e in self.host if e["name"] == ITER_SPAN]
        if not its:
            raise EmptyTrace("no traced iteration in the trace")
        return (min(e["ts"] for e in its),
                max(e["ts"] + e["dur"] for e in its))

    def device(self) -> list:
        if not self.events:
            raise EmptyTrace("the trace holds no device activity")
        return self.events

    def busy_intervals(self) -> list:
        """The union of the device events inside the window, as sorted
        disjoint (start, end) us."""
        t0, t1 = self.window()
        iv = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                    for e in self.device())
        out = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_us(self) -> float:
        busy = sum(b - a for a, b in self.busy_intervals())
        if busy <= 0:
            raise EmptyTrace("no device activity inside the traced window")
        return busy

    def window_us(self) -> float:
        t0, t1 = self.window()
        return t1 - t0

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_us() / self.window_us())

    def host_spans(self, name: str) -> list:
        """(start, end) us of the benchmark's host spans named `name` that
        start inside the window."""
        t0, t1 = self.window()
        return [(e["ts"], e["ts"] + e["dur"]) for e in self.host
                if e["name"] == name and e["cat"] != "gpu_user_annotation"
                and t0 <= e["ts"] < t1]

    def busy_in_us(self, spans: list) -> float:
        """Device-busy us inside the host intervals `spans`."""
        iv = np.array(self.busy_intervals(), np.float64).reshape(-1, 2)
        return float(sum(np.clip(np.minimum(iv[:, 1], b)
                                 - np.maximum(iv[:, 0], a), 0, None).sum()
                         for a, b in spans))

    def kernel_us(self, *names: str) -> float:
        """Summed device time of the kernels with these base names."""
        return sum(e["dur"] for e in self.device()
                   if e["cat"] == "kernel"
                   and base_name(e["name"]).split("::")[-1] in names)

    def breakdown(self) -> dict:
        """The 10 device operations that took most time, and the idle time
        inside the window by what the host was doing (the innermost host
        span or op over each gap's middle), in seconds."""
        ops = {}
        for e in self.device():
            k = base_name(e["name"])
            ops[k] = ops.get(k, 0.0) + e["dur"] * 1e-6
        t0, t1 = self.window()
        gaps, last = [], t0
        for a, b in self.busy_intervals() + [[t1, t1]]:
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        host = [e for e in self.host if e["name"] != ITER_SPAN
                and not e["name"].startswith("PyTorch Profiler")]
        ts = np.array([e["ts"] for e in host], np.float64)
        end = ts + np.array([e["dur"] for e in host], np.float64)
        idle = {}
        for a, b in gaps:
            mid = (a + b) / 2
            inner = np.flatnonzero((ts <= mid) & (mid < end))
            label = (host[inner[np.argmin(end[inner] - ts[inner])]]["name"]
                     if inner.size else "host (no span)")
            idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        gap = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gap]}


def base_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces,
    template arguments and parameters: "void (anonymous
    namespace)::mask_pack<4>(uint4 const*, ...)" -> "mask_pack";
    "void at::native::reduce_kernel<...>(...)" ->
    "at::native::reduce_kernel". Copies keep their names ("Memcpy HtoD
    (Pinned -> Device)" -> "Memcpy HtoD")."""
    n = name.replace("(anonymous namespace)::", "")
    n = n.split("(")[0].split("<")[0].strip()
    if n.startswith("void "):
        n = n[5:]
    return n or name


def parse_chrome(doc: dict) -> tuple:
    """(device events, host events) of a torch.profiler Chrome trace."""
    dev, host = [], []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        rec = {"name": e.get("name", ""), "cat": e.get("cat", ""),
               "ts": float(e["ts"]), "dur": float(e["dur"])}
        (dev if rec["cat"] in DEVICE_CATS else host).append(rec)
    return dev, host


class Profiler:
    """torch.profiler over a block, CPU and CUDA activity, read back
    through a Chrome trace in TMPDIR that is deleted once read."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.device, self.host = parse_chrome(json.load(f))
        finally:
            os.unlink(path)
        return False
