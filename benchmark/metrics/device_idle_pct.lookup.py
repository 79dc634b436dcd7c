"""The share of the traced steps' time in which no kernel, copy or set
ran on the card: 1 - (the union of their intervals) / (the traced
window), in %. Raises on a trace with no device activity."""


def read(trace) -> float:
    return trace.idle_pct()
