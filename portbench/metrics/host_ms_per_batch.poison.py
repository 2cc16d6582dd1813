"""Mean host time per batch of the window, in ms: a batch's wall time less
its retrieval and the Generator's prefill and decode seconds (its
``stats``, device-synchronised at both ends).  What is left is the
orchestrator's host work: selection, injection, the prompt plans and
tokenisation, detokenisation and scoring."""


def read(st):
    recs = st["records"]
    return 1e3 * sum(r["wall_s"] - r["retrieve_s"] - r["prefill_s"]
                     - r["decode_s"] for r in recs) / len(recs)
