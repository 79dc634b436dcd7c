"""GROUP BY key preparation in the hits statements: the program's spans
`query.group_keys` (query._prepare_group_keys) that start inside one of
the benchmark's statement spans `sql.q*`, summed over a step, a round
of the traffic's statements, in s."""

READS = ("sql.q*", "query.group_keys")


def read(trace):
    t0, t1 = trace.window()
    stmts = [(e["ts"], e["ts"] + e["dur"]) for e in trace.host
             if e["name"].startswith(READS[0][:-1])
             and e["cat"] != "gpu_user_annotation" and t0 <= e["ts"] < t1]
    inside = [b - a for a, b in trace.host_spans(READS[1])
              if any(s <= a < e for s, e in stmts)]
    if not inside:
        return None
    return sum(inside) / trace.counts["steps"] * 1e-6
