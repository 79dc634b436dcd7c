"""Device profiling hooks (csv_simd_tpu/utils/profiling.py), over
torch.profiler: `device_trace` captures a trace of a block, with the
card's kernels and copies when CUDA is present, and writes it into a
directory as a Chrome trace; `named` marks a span in it.

    from csv_simd_tpu_torch.utils import profiling
    with profiling.device_trace("trace_dir") as d:
        with profiling.named("build"):
            ...
    # trace_dir/trace.json, viewable in chrome://tracing or Perfetto
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[str]:
    """Trace the block with torch.profiler (CPU activity, and CUDA when a
    card is present) and write `log_dir`/trace.json; yields log_dir."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def named(name: str):
    """A named span in the trace: `with named("stage1"): ...`."""
    import torch

    return torch.profiler.record_function(name)
