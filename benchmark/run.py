"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. The cell's entry
there names its configuration (benchmark/configs/<config>.json, which
drives the generator) and its traffic mix (benchmark/traffic/<traffic>.json:
the loop, its parameters and the limits of its check). Set-up generates
the table from the seed into a file under TMPDIR, imports the program
(csv_simd_tpu_torch), builds the kernels at their first use, builds the
tape and warms the cell's own shapes; the window then runs the loop for
`--seconds`; after it the program's outputs are held against the plain
reference. With --trace 1 a few steady steps in the middle of the window
run under torch.profiler and the per-layer metrics are read from them.

The last stdout line is the result JSON; an earlier line splits set-up
into its parts. The last stderr lines give each compared number beside
its limit. Exit 2 without a card, 3 if a forbidden module was loaded,
1 on any other failure; none of those prints a result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "csv_simd_tpu", "tests", "tools")
TRACE_TRIES = 3


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name (before the first dot, whole)
    is one the run may not load."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def set_cache_dirs(root: str) -> None:
    """Every kernel and build cache inside the checkout, at fixed paths."""
    cache = os.path.join(root, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py, found by the metric's name."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(kind: str, name: str):
    """The metric's `read`."""
    return load_module(kind, name).read


def reported(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


class MissingMetric(RuntimeError):
    """A per-layer metric listed for the cell read nothing from the
    trace: the kernel or span it reads is gone or renamed."""


def per_layer_metrics(spec: dict, cell: str, traced) -> dict:
    """Every per-layer metric listed for `cell`, read from the trace; one
    that reads nothing fails the run, naming what it looked for."""
    out = {}
    for m in spec["per_layer"]:
        if cell not in m.get("workloads", []):
            continue
        mod = load_module("metrics", m["name"])
        v = mod.read(traced)
        if v is None:
            raise MissingMetric(
                f"{m['name']}: the traced steps hold none of "
                f"{list(getattr(mod, 'READS', ()))}")
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


@dataclass
class Window:
    """The measured window: its start and end on the host clock, each
    step's (start, end, units: file bytes, lookups or statements), and the
    card's peak memory over set-up's builds and the window."""
    start: float
    end: float
    ops: list
    memory_peak_bytes: int = 0


class Context:
    def __init__(self, workload: dict, config: dict, seed: int, device,
                 path: str, n_bytes: int, n_records: int):
        import torch

        from .traffic import generator

        self.workload, self.config, self.seed = workload, config, seed
        self.device = torch.device(device)
        self.path, self.n_bytes, self.n_records = path, n_bytes, n_records
        self.n_fields = len(config["columns"])
        self.traffic_gen = generator(seed, self.device)


def _card(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i",
                            str(device.index or 0)],
                           capture_output=True, text=True, timeout=20)
        out["power_limit_w"] = float(q.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return out


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(spec: dict, cell: str, seed: int, seconds: float, trace: bool,
             device="cuda", rows=None, log=sys.stderr, parts=None) -> dict:
    """One run of `cell`: {"result", "setup_parts", "setup_s", "window"}.
    `rows` cuts the table (the CPU tests run small tables); the cell's
    runs use the configuration's own size. `parts` holds the set-up parts
    timed before the call."""
    parts = dict(parts or {})
    import torch

    from . import gen

    wspec = next(w for w in spec["workloads"] if w["name"] == cell)
    workload = load_json("traffic", wspec["traffic"])
    config = load_json("configs", wspec["config"])
    dev = torch.device(device)

    t = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
    parts["device_init_s"] = time.perf_counter() - t

    t = time.perf_counter()
    table = gen.Table(config, seed, dev, rows)
    path = gen.tmp_csv_path(config["name"])
    try:
        n_bytes = table.write(path)
        n_records = table.n
        del table
        _sync(dev)
        parts["generate_s"] = time.perf_counter() - t
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        return _run_program(spec, cell, workload, config, seed, seconds,
                            trace, dev, path, n_bytes, n_records, parts, log)
    finally:
        os.unlink(path)


def _run_program(spec, cell, workload, config, seed, seconds, trace, dev,
                 path, n_bytes, n_records, parts, log) -> dict:
    import numpy as np
    import torch

    from . import loops
    from .check import Reference, judge, readings
    from .trace import ITER_SPAN, EmptyTrace, Profiler, Trace

    t = time.perf_counter()
    import csv_simd_tpu_torch  # noqa: F401  the system under test
    from csv_simd_tpu_torch.utils.metrics import GLOBAL

    parts["import_program_s"] = time.perf_counter() - t

    ctx = Context(workload, config, seed, dev, path, n_bytes, n_records)
    t = time.perf_counter()
    loop = loops.LOOPS[workload["loop"]](ctx)
    loop.step(0, keep=False)
    _sync(dev)
    parts["first_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for i in range(1, int(workload["warmup_steps"])):
        loop.step(i, keep=False)
    _sync(dev)
    parts["warmup_s"] = time.perf_counter() - t

    ops, failed, traced, tries = [], 0, None, 0
    trace_ops = int(workload["trace_steps"])
    # the trace starts half way through the window, or earlier at the
    # traffic's `trace_from_step` (where a few long steps fill the window)
    trace_from = int(workload.get("trace_from_step", 1 << 62))
    i = 0
    start = time.perf_counter()
    setup_s = start - T0
    while True:
        try:
            if trace and traced is None and tries < TRACE_TRIES and (
                    i >= trace_from
                    or time.perf_counter() - start >= seconds / 2):
                tries += 1
                before = {k: (s.seconds, s.calls)
                          for k, s in GLOBAL.stages.items()}
                with Profiler() as prof:
                    for _ in range(trace_ops):
                        t0 = time.perf_counter()
                        with torch.profiler.record_function(ITER_SPAN):
                            units = loop.step(i)
                        ops.append((t0, time.perf_counter(), units))
                        i += 1
                spans = {k: (s.seconds - before.get(k, (0, 0))[0],
                             s.calls - before.get(k, (0, 0))[1])
                         for k, s in GLOBAL.stages.items()}
                cand = Trace(prof.device, prof.host,
                             {"steps": trace_ops,
                              "units": sum(o[2] for o in ops[-trace_ops:]),
                              "file_bytes": n_bytes}, spans)
                if cand.events:
                    traced = cand
                else:
                    print(f"trace {tries} held no device activity",
                          file=log)
            else:
                t0 = time.perf_counter()
                units = loop.step(i)
                ops.append((t0, time.perf_counter(), units))
                i += 1
        except Exception:  # a step that raises is a failed operation
            traceback.print_exc(file=log)
            failed += 1
            break
        if ops and ops[-1][1] - start >= seconds and (
                not trace or traced is not None or tries >= TRACE_TRIES):
            break
    end = ops[-1][1] if ops else time.perf_counter()
    card = _card(dev)
    if dev.type == "cuda":
        card["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    else:
        card["memory_peak_bytes"] = 0
    window = Window(start, end, ops, card["memory_peak_bytes"])

    rng = np.random.default_rng(seed % (1 << 64))
    outputs = loop.outputs(rng) if not failed else None
    del loop
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    values, wrong = {}, 0
    if outputs is not None:
        ref = Reference(np.fromfile(path, dtype=np.uint8))
        values, wrong = readings(ref, workload, outputs)
        del ref
    correct, checks = judge(values, workload["limits"])
    correct = correct and not failed and outputs is not None
    check_s = time.perf_counter() - t

    metrics = {}
    result = {"correct": bool(correct), "attempted": len(ops) + failed,
              "failed": failed + wrong}
    if not trace:
        for m in reported(spec["end_to_end"], cell):
            if m["name"] == "setup_s":
                v = setup_s
            else:
                v = load_reader("end_to_end", m["name"])(window)
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        if traced is None:
            raise EmptyTrace(f"{tries} traces held no device activity")
        metrics = per_layer_metrics(spec, cell, traced)
        card["busy_s"] = traced.busy_us() * 1e-6
        card["window_s"] = traced.window_us() * 1e-6
        result["breakdown"] = traced.breakdown()
    result["metrics"] = metrics
    result["device"] = card
    result["checks"] = checks
    parts["check_s_after_window"] = check_s
    steps = sorted(t1 - t0 for t0, t1, _ in ops)
    summary = {"seconds": end - start, "steps": len(ops),
               "step_s": [steps[int(q * (len(steps) - 1))]
                          for q in (0, 0.25, 0.5, 0.75, 1)] if steps else []}
    return {"result": result, "setup_parts": parts, "setup_s": setup_s,
            "window": summary}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_cache_dirs(ROOT)
    spec = load_spec(ROOT)
    wspec = next((w for w in spec["workloads"]
                  if w["name"] == args.workload), None)
    if wspec is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 1
    t = time.perf_counter()
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wspec["chips"]):
        print(f"{args.workload} needs {wspec['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    startup = {"interpreter_s": t - T0,
               "import_torch_s": time.perf_counter() - t}
    try:
        out = run_cell(spec, args.workload, args.seed, args.seconds,
                       bool(args.trace), parts=startup)
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    res = out["result"]
    print(json.dumps({"setup_parts": out["setup_parts"],
                      "setup_s": out["setup_s"], "window": out["window"]}))
    sys.stdout.flush()
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
