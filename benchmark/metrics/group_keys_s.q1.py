"""Q1's GROUP BY key preparation: the program's spans `query.group_keys`
(query._prepare_group_keys) that start inside the benchmark's span
`sql.q1`, summed, a Q1, in s."""

READS = ("sql.q1", "query.group_keys")


def read(trace):
    stmts = trace.host_spans(READS[0])
    inside = [b - a for a, b in trace.host_spans(READS[1])
              if any(s <= a < e for s, e in stmts)]
    if not inside:
        return None
    return sum(inside) / len(stmts) * 1e-6
