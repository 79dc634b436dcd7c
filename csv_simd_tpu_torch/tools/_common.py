"""What the measurement tools share: the CUDA-event timers, exact
comparison, XOR and wrapping sums as the kernels compute them, inputs,
and the card's description."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card, by CUDA events over
    `reps` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def best_s(fn, device: torch.device, trials: int = 5) -> float:
    """The least seconds a call of fn over `trials` calls, after a warm-up
    call: by CUDA events on a card, by the host clock on the CPU."""
    if device.type == "cuda":
        return min(cuda_ms(fn, 1) for _ in range(trials)) / 1e3
    fn()
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card with the host out of
    the window: `reps` calls captured once into a CUDA graph after one
    warm-up call, a warm-up replay, then one replay timed by CUDA events.
    fn must not sync with the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def interleaved_ms(fns: dict, reps: int, rounds: int = 3,
                   timer=cuda_ms) -> dict:
    """{name: ms}: each fn timed by `timer` in turns, `rounds` times, and
    the least mean kept, so that drift on the card hits all alike."""
    best = dict.fromkeys(fns, float("inf"))
    for _ in range(rounds):
        for name, fn in fns.items():
            best[name] = min(best[name], timer(fn, reps))
    return best


def kernel_ms(fns: dict, reps: int) -> dict:
    """{name: {"ms", "eager_ms"}} of kernel launches, timed in turns:
    "ms" from CUDA graphs (the kernels alone), "eager_ms" from CUDA
    events around the launches as Python makes them (host work between
    launches shows when a kernel is shorter than it)."""
    graph = interleaved_ms(fns, reps, timer=graph_ms)
    eager = interleaved_ms(fns, reps)
    return {k: {"ms": graph[k], "eager_ms": eager[k]} for k in fns}


def same(got: torch.Tensor, want: torch.Tensor, what: str) -> int:
    """Raise unless got equals want exactly; returns the largest absolute
    difference (0) for the record."""
    got, want = got.reshape(-1), want.reshape(-1)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err:
        bad = int((got != want).sum())
        raise AssertionError(f"{what}: {bad} of {got.numel()} values differ "
                             "from the plain version")
    return err


def xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR of int32 x over its last dimension (torch has no XOR
    reduction): pairwise halving."""
    while x.shape[-1] > 1:
        n = x.shape[-1]
        h = n // 2
        y = x[..., :h] ^ x[..., h:2 * h]
        if n % 2:
            y = y.clone()
            y[..., 0] ^= x[..., n - 1]
        x = y
    return x[..., 0]


def wrap_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of int32 x over `dim`, wrapping at 32 bits as int32 adds do."""
    s = x.to(torch.int64).sum(dim=dim)
    return (((s + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def random_words(rows: int, device, seed: int) -> torch.Tensor:
    """(rows, 128) uniformly random int32, made on `device` from `seed`,
    as the JAX probes fed np.random.randint over the full int32 range."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(-2**31, 2**31, (rows, 128), dtype=torch.int32,
                         device=device, generator=gen)


def csv_words(rows: int, device, seed: int) -> torch.Tensor:
    """(rows, 128) int32 of CSV-ish bytes (quotes, delimiters, newlines
    dense enough that every stage has work), made on `device`."""
    alphabet = torch.tensor(list(b'ab"",\n\rx,z":; \t\xa2'),
                            dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    idx = torch.randint(0, alphabet.numel(), (rows * 512,), device=device,
                        generator=gen)
    return alphabet[idx].view(torch.int32).view(rows, 128)


def check_all(pairs) -> dict:
    """{checks, max_abs_err} over (got, want, what) triples, each held
    by `same` (which raises on any difference)."""
    checks = err = 0
    for got, want, what in pairs:
        err = max(err, same(got, want, what))
        checks += 1
    return {"checks": checks, "max_abs_err": err}


def merge(*results) -> dict:
    """Several {checks, max_abs_err} results as one."""
    return {"checks": sum(r["checks"] for r in results),
            "max_abs_err": max(r["max_abs_err"] for r in results)}


def card() -> dict:
    """The card's name and power limit as nvidia-smi gives them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return {"card": r.stdout.strip().splitlines()[0],
            "device": torch.cuda.get_device_name(0)}


def need_card(tool: str) -> torch.device:
    """The card, or exit 2: the tools measure only on an NVIDIA card."""
    if not torch.cuda.is_available():
        print(f"# {tool}: no NVIDIA card (torch.cuda.is_available() is "
              "False); the probes measure only on the card",
              file=sys.stderr)
        sys.exit(2)
    return torch.device("cuda", 0)


def emit(result: dict) -> None:
    print(json.dumps(result), flush=True)


def report_probes(probes, device) -> bool:
    """Run each (name, fn) of a tool's TPU probes on `device` and print
    `probe[name]: BIT-EXACT` or `WRONG VALUES`, as the JAX tools print
    them; True when every one is bit-exact."""
    ok = True
    for name, fn in probes:
        good = fn(device)
        print(f"probe[{name}]: {'BIT-EXACT' if good else 'WRONG VALUES'}",
              flush=True)
        ok = ok and good
    return ok
