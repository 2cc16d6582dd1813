"""K1's share of its roofline over the traced segment, in %, for a decoder
with windowed and full layers: the bound of every prefill attention layer
the segment ran (``bounds.k1_bound`` at the config's head_dim, operations
from the unmasked pairs of the SDAG or causal mask on the full layers and
of that mask within the window on the windowed ones, bytes of q/k/v/output
at the valid positions) over the device time of the kernels named
``sdag_prefill`` (K1's bodies) in the trace.  None when no K1 kernel
ran."""

from portbench.common import bounds, moe_bounds


def read(st):
    dev = st["segment"].device_seconds("sdag_prefill")
    if not dev:
        return None
    cfg = st["cfg"]
    hq = int(cfg["num_attention_heads"])
    hkv = int(cfg["num_key_value_heads"])
    dh = int(cfg["head_dim"])
    n_full, n_win = moe_bounds.kinds(cfg)
    b = int(st["tr"]["llm_batch"])
    total = 0.0
    for r in st["segment_records"]:
        ps = r["prompts"]
        for i in range(0, len(ps), b):
            chunk = ps[i:i + b]
            for full, win in (("iso_pairs", "iso_pairs_w"),
                              (None, "causal_pairs_w")):
                rows_full = [(p["len"], p[full] if full else
                              bounds.causal_pairs(p["len"])) for p in chunk]
                rows_win = [(p["len"], p[win]) for p in chunk]
                total += n_full * bounds.k1_bound(
                    rows_full, hq, hkv, dh, cfg["torch_dtype"])[2]
                total += n_win * bounds.k1_bound(
                    rows_win, hq, hkv, dh, cfg["torch_dtype"])[2]
    return 100.0 * total / dev
