"""The rank-select serve's device time (offsetfree._serve: on the card one
launch of kernel K2 `serve_packed` a batch, and the answers' copies to the
host; every kernel and copy of the traced batches) per million (record,
field) lookups, in ms."""


def read(trace):
    lookups = trace.counts["units"]
    if lookups <= 0:
        return None
    return trace.busy_us() * 1e-3 / (lookups / 1e6)
