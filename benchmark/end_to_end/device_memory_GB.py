"""device_memory_GB: the card's peak memory over set-up's builds and the
window, as torch's allocator gives it after the generator's tensors are
freed, in GB (10**9 bytes): what the tape of a file holds on the card,
which sets the largest file one card takes."""


def read(window) -> float:
    return window.memory_peak_bytes / 1e9
