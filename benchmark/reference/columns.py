"""Typed columns parsed by the reference from the file's bytes and its
own structural index, each parsed once a run."""

from __future__ import annotations

import numpy as np

from .structural import column_windows


class Columns:
    """Columns by header name: exact decimals as float64, dates as days
    since 1970-01-01, one-byte codes as uint8."""

    def __init__(self, data, index, jump: int, names):
        self.data, self.index, self.jump = data, index, jump
        self.names = list(names)
        self._cache = {}

    def _get(self, kind: str, name: str, parse):
        key = (kind, name)
        if key not in self._cache:
            self._cache[key] = parse(self.names.index(name))
        return self._cache[key]

    def _windows(self, field: int):
        return column_windows(self.data, self.index, field, self.jump)

    def decimal(self, name: str) -> np.ndarray:
        """Plain decimals ("-ddd.dd"), each the float64 nearest its text."""
        def parse(field):
            win, length = self._windows(field)
            digit = (win >= 0x30) & (win <= 0x39)
            dot = win == ord(".")
            inside = np.arange(win.shape[1])[None, :] < length[:, None]
            if (~(digit | dot | (win == ord("-"))) & inside).any() or \
                    (length == 0).any():
                raise ValueError(f"{name}: a value is no decimal")
            acc = np.zeros(win.shape[0], np.int64)
            frac = np.zeros(win.shape[0], np.int64)
            seen_dot = np.zeros(win.shape[0], bool)
            for j in range(win.shape[1]):
                d = digit[:, j]
                acc = np.where(d, acc * 10 + (win[:, j] - 0x30), acc)
                frac += d & seen_dot
                seen_dot |= dot[:, j]
            sign = np.where(win[:, 0] == ord("-"), -1.0, 1.0)
            return sign * acc / np.power(10.0, frac)
        return self._get("decimal", name, parse)

    def date_days(self, name: str) -> np.ndarray:
        """YYYY-MM-DD dates as int64 days since 1970-01-01."""
        def parse(field):
            win, length = self._windows(field)
            if (length != 10).any():
                raise ValueError(f"{name}: a value is no date")
            d = win.astype(np.int64) - 0x30
            y = d[:, 0] * 1000 + d[:, 1] * 100 + d[:, 2] * 10 + d[:, 3]
            m = d[:, 5] * 10 + d[:, 6]
            months = ((y - 1970) * 12 + (m - 1)).astype("datetime64[M]")
            return (months.astype("datetime64[D]").astype(np.int64)
                    + d[:, 8] * 10 + d[:, 9] - 1)
        return self._get("date", name, parse)

    def code(self, name: str) -> np.ndarray:
        """One-byte values as uint8."""
        def parse(field):
            win, length = self._windows(field)
            if (length != 1).any():
                raise ValueError(f"{name}: a value is not one byte")
            return win[:, 0].copy()
        return self._get("code", name, parse)
