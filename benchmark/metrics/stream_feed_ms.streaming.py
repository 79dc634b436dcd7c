"""The program's span `streaming_chunk` (streaming.StreamingIndexBuilder
.feed_prepared: B3's launch on one chunk with the quote parity chained
on the card, then the copy to the host and the native extraction of the
chunk that lags two behind) summed over an ingest, in ms. The last two
chunks' extraction runs in finish(), outside the span. A program without
the span reads None."""

READS = ("streaming_chunk",)


def read(trace):
    seconds, calls = trace.spans.get(READS[0], (0.0, 0))
    if calls <= 0:
        return None
    return seconds / trace.counts["steps"] * 1e3
