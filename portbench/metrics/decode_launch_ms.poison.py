"""Milliseconds per decode chunk of the traced segment in which the device
is idle waiting for the chunk's captured graph to start: the device
trace's idle gaps named ``cudaGraphLaunch`` (the host is inside the
launch), over the program's decode chunks (its ``sdag.gen.decode.launch``
spans).  None when the program records no such span."""

from portbench.common import spans


def read(st):
    chunks = spans.count(st, "sdag.gen.decode.launch")
    if not chunks:
        return None
    return 1e3 * st["segment"].gaps.get("cudaGraphLaunch", 0.0) / chunks
