"""ingest_GBps: the file's bytes times the ingests completed in the
window, over the window's seconds, in GB/s (10**9 bytes)."""


def read(window) -> float:
    return sum(u for _, _, u in window.ops) / (window.end - window.start) / 1e9
