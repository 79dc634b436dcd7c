"""The program's span `index_build[auto]` (api._build_index, which
`create(path)` records under the backend it is passed: B3, the words to
the host, native extraction) an ingest, in ms."""

READS = ("index_build[auto]",)


def read(trace):
    seconds, calls = trace.spans.get(READS[0], (0.0, 0))
    if calls <= 0:
        return None
    return seconds / calls * 1e3
