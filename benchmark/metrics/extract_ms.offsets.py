"""The program's span `index.extract` (index.extract_offsets_from_packed:
the host words to int64 offsets, by the native extractor or NumPy) an
ingest, in ms."""

READS = ("index.extract",)


def read(trace):
    seconds, calls = trace.spans.get(READS[0], (0.0, 0))
    if calls <= 0:
        return None
    return seconds / trace.counts["steps"] * 1e3
