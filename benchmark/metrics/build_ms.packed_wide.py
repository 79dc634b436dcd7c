"""The program's span `offsetfree.build` (PackedDeviceTape.__init__: the
pad and upload, B1, B2 and the readback of the structural count, so it
ends with the build on the card done) summed over an ingest, in ms. A
program without the span reads None."""

READS = ("offsetfree.build",)


def read(trace):
    seconds, calls = trace.spans.get(READS[0], (0.0, 0))
    if calls <= 0:
        return None
    return seconds / trace.counts["steps"] * 1e3
