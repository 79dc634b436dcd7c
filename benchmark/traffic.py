"""Record keys for the serving cells, drawn on the device from a seed.

`keys(spec, n_records, count, g, device)` reads the workload's "keys":
    {"dist": "uniform"}                         every record alike
    {"dist": "zipfian", "theta": 0.99}
        YCSB's ScrambledZipfianGenerator (core workloads A-C): a
        Zipfian draw over YCSB's 10**10 items by Gray et al.'s method
        with YCSB's precomputed zeta, hashed by YCSB's FNV-1a 64-bit
        `fnvhash64` and folded onto the table's records, so the hot
        records are spread over the file.
"""

from __future__ import annotations

import torch

YCSB_ITEMS = 10_000_000_000
YCSB_ZETAN = 26.46902820178302  # zeta(10**10, 0.99), as YCSB hard-codes it
FNV_OFFSET = -3750763034362895579  # 0xCBF29CE484222325 as a signed int64
FNV_PRIME = 1099511628211
_SALT = 0x5EED7AFF1C  # the traffic's stream, apart from the table's


def generator(seed: int, device) -> torch.Generator:
    """The generator of a run's keys: seeded by --seed, but not the
    table's stream."""
    from .gen import seed_generator

    return seed_generator(seed ^ _SALT, device)


def fnvhash64(v: torch.Tensor) -> torch.Tensor:
    """YCSB's Utils.fnvhash64 on int64 values (wrapping int64 products,
    Java's Math.abs)."""
    h = torch.full_like(v, FNV_OFFSET)
    x = v.clone()
    for _ in range(8):
        h = (h ^ (x & 0xFF)) * FNV_PRIME
        x = x >> 8
    return h.abs()


def zipfian(count: int, theta: float, g: torch.Generator, device,
            items: int = YCSB_ITEMS, zetan: float = YCSB_ZETAN):
    """`count` Zipfian draws in [0, items), YCSB's ZipfianGenerator."""
    alpha = 1.0 / (1.0 - theta)
    zeta2 = 1.0 + 0.5 ** theta
    eta = (1.0 - (2.0 / items) ** (1.0 - theta)) / (1.0 - zeta2 / zetan)
    u = torch.rand(count, generator=g, device=device, dtype=torch.float64)
    uz = u * zetan
    v = (items * torch.pow(eta * u - eta + 1.0, alpha)).to(torch.int64)
    v = torch.where(uz < 1.0 + 0.5 ** theta, 1, v)
    return torch.where(uz < 1.0, 0, v)


def keys(spec: dict, n_records: int, count: int, g: torch.Generator,
         device) -> torch.Tensor:
    """`count` record ids in [0, n_records) as int32 on `device`."""
    dist = spec["dist"]
    if dist == "uniform":
        k = torch.randint(0, n_records, (count,), generator=g,
                          device=device, dtype=torch.int64)
    elif dist == "zipfian":
        z = zipfian(count, float(spec["theta"]), g, device)
        k = torch.remainder(fnvhash64(z), n_records)
    else:
        raise ValueError(f"unknown key distribution {dist!r}")
    return k.to(torch.int32)
