"""The rank-select serve's device time (offsetfree._serve and
_kth_positions: every kernel and copy of the traced batches) per million
(record, field) lookups, in ms."""


def read(trace):
    lookups = trace.counts["units"]
    if lookups <= 0:
        return None
    return trace.busy_us() * 1e-3 / (lookups / 1e6)
