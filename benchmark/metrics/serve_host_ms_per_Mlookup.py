"""The rank-select serve's host time: the program's span
`offsetfree.serve` (offsetfree._serve, the launches of a batch enqueued)
over its counter `offsetfree.lookups` ((record, field) queries served),
per million lookups, in ms. The device half is
serve_device_ms_per_Mlookup."""

READS = ("offsetfree.serve", "offsetfree.lookups")


def read(trace):
    seconds, calls = trace.spans.get(READS[0], (0.0, 0))
    _zero, lookups = trace.spans.get(READS[1], (0.0, 0))
    if calls <= 0 or lookups <= 0:
        return None
    return seconds * 1e3 / (lookups / 1e6)
