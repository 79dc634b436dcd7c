"""Cross-cutting utilities: observability (metrics, the torch
profiling hooks), debug helpers. The port's own copy of
csv_simd_tpu/utils; `profiling` is the port's, over torch.profiler."""


def as_u8(data) -> "np.ndarray":
    """bytes/bytearray/memoryview or array-like -> contiguous uint8
    array (zero-copy views where possible). The ONE normalization used
    at every public byte-accepting boundary."""
    import numpy as np

    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data, dtype=np.uint8)
