"""The key draws: YCSB's FNV hash and scrambled Zipfian."""

import numpy as np
import torch

from benchmark import traffic


def _java_fnvhash64(val: int) -> int:
    """YCSB's Utils.fnvhash64, with Java's wrapping long arithmetic."""
    h = 0xCBF29CE484222325
    for _ in range(8):
        h ^= val & 0xFF
        val >>= 8
        h = (h * 1099511628211) & (2**64 - 1)
    h = h - 2**64 if h >= 2**63 else h
    return abs(h) if h != -(2**63) else h


def test_fnvhash64_is_ycsbs():
    vals = [0, 1, 2, 255, 256, 12345678901, 9_999_999_999, 2**40 + 7]
    got = traffic.fnvhash64(torch.tensor(vals, dtype=torch.int64)).tolist()
    assert got == [_java_fnvhash64(v) for v in vals]


def test_zipfian_keys_are_skewed_scrambled_and_in_range():
    n = 100_000
    g = traffic.generator(2**33 + 5, "cpu")
    k = traffic.keys({"dist": "zipfian", "theta": 0.99}, n, 200_000, g, "cpu")
    assert k.dtype == torch.int32
    assert int(k.min()) >= 0 and int(k.max()) < n
    counts = np.bincount(k.numpy(), minlength=n)
    top = np.sort(counts)[::-1]
    # Zipfian 0.99: the hottest record takes a few % of the draws, and the
    # hot records are spread over the table, not at its start
    assert top[0] > 0.02 * k.numel()
    assert int(np.argmax(counts)) > 1000
    uni = traffic.keys({"dist": "uniform"}, n, 200_000,
                       traffic.generator(2**33 + 5, "cpu"), "cpu")
    assert np.bincount(uni.numpy(), minlength=n).max() < 20


def test_the_same_seed_draws_the_same_keys():
    def draw(seed):
        return traffic.keys({"dist": "zipfian", "theta": 0.99}, 1000, 5000,
                            traffic.generator(seed, "cpu"), "cpu")
    assert torch.equal(draw(7), draw(7))
    assert not torch.equal(draw(7), draw(8))
