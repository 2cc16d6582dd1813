"""Mean seconds of ``SparseRetriever.retrieve_batch`` per batch of the
window, in ms: the benchmark's clock around the call, which ends with the
hits on the host (so the device is done)."""


def read(st):
    recs = st["records"]
    return 1e3 * sum(r["retrieve_s"] for r in recs) / len(recs)
