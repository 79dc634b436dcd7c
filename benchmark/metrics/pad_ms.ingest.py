"""The program's span `offsetfree.pad` (offsetfree._to_device: the pinned
host buffer, the file copied into it with its zero tail, and the upload
enqueued) summed over an ingest, in ms. The packed route pads once
(create_packed); the offsets route twice (create for B3, then
DeviceTape.from_tape for the tape's bytes)."""

READS = ("offsetfree.pad",)


def read(trace):
    seconds, calls = trace.spans.get(READS[0], (0.0, 0))
    if calls <= 0:
        return None
    return seconds / trace.counts["steps"] * 1e3
