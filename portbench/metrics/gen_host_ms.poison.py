"""The Generator's host milliseconds per batch of the traced segment: its
calls (``sdag.orch.llm_batch``) less their prefill and decode
(``sdag.gen.prefill``, ``sdag.gen.decode``, which end with the device
done).  What is left is packing the prompts and uploads, the decode
buffers and the wait before prefill, and downloading and detokenising the
answers.  None when the program records no such span."""

from portbench.common import spans


def read(st):
    calls = spans.ms_per_batch(st, ("sdag.orch.llm_batch",))
    if calls is None:
        return None
    return calls - (spans.ms_per_batch(
        st, ("sdag.gen.prefill", "sdag.gen.decode")) or 0.0)
