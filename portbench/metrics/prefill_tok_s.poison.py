"""Prompt tokens per second of the Generator's prefills over the window
(``Generator.stats``: valid prompt tokens over prefill seconds)."""


def read(st):
    recs = st["records"]
    s = sum(r["prefill_s"] for r in recs)
    return sum(r["prefill_tokens"] for r in recs) / s if s > 0 else None
