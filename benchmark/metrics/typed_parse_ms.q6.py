"""Q6's typed parses: the program's spans `query.parse_column`
(query._parse_column, one typed column parsed on the device) that start
inside the benchmark's span `sql.q6`, summed, a Q6, in ms."""

READS = ("sql.q6", "query.parse_column")


def read(trace):
    stmts = trace.host_spans(READS[0])
    inside = [b - a for a, b in trace.host_spans(READS[1])
              if any(s <= a < e for s, e in stmts)]
    if not inside:
        return None
    return sum(inside) / len(stmts) * 1e-3
