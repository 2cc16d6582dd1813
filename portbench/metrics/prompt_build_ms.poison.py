"""Host milliseconds per batch of the traced segment in which the
orchestrator builds the ISO prompt plans and the NO-ISO chat ids (the
program's spans ``sdag.orch.prompts.iso`` and ``sdag.orch.prompts.noiso``),
with no work queued on the device.  None when the program records no such
span."""

from portbench.common import spans


def read(st):
    return spans.ms_per_batch(st, ("sdag.orch.prompts.iso",
                                   "sdag.orch.prompts.noiso"))
