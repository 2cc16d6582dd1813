"""Milliseconds per decode step over the window (``Generator.stats``:
decode seconds over steps; a step advances every row of a batch)."""


def read(st):
    recs = st["records"]
    n = sum(r["decode_steps"] for r in recs)
    return 1e3 * sum(r["decode_s"] for r in recs) / n if n else None
