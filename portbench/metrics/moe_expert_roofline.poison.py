"""K8's share of its roofline over the traced segment, in %: the bound of
the decode steps' expert layers the segment ran (the routed rows'
SwiGLU operations; the distinct experts' weights the program counts it
read, ``Generator.stats["moe_decode_expert_reads"]``, plus the rows in and
out: ``moe_bounds.k8_bound``) over the device time of the kernels named
``sdag_moe`` (K8's four) in the trace.  A live row of a step is one token
emitted (``decode_tokens``).  None when no K8 kernel ran or the program
counts no expert reads."""

from portbench.common import moe_bounds


def read(st):
    dev = st["segment"].device_seconds("sdag_moe")
    moe = st.get("segment_moe")
    if not dev or not moe or not moe["moe_decode_expert_reads"]:
        return None
    cfg = st["cfg"]
    rows = moe["decode_tokens"] * int(cfg["num_hidden_layers"])
    return 100.0 * moe_bounds.k8_bound(
        cfg, rows, moe["moe_decode_expert_reads"])[2] / dev
