"""K1's share of its roofline over the traced segment, in %: the bound of
every prefill attention layer the segment ran (operations from the SDAG or
causal mask's unmasked pairs, bytes of q/k/v/output at the valid positions
read or written once; ``portbench/common/bounds.py``) over the device
time of the kernels named ``sdag_prefill`` (K1's bodies) in the trace.
None when no K1 kernel ran."""

from portbench.common import bounds


def read(st):
    dev = st["segment"].device_seconds("sdag_prefill")
    if not dev:
        return None
    cfg = st["cfg"]
    hq = int(cfg["num_attention_heads"])
    hkv = int(cfg["num_key_value_heads"])
    dh = int(cfg["hidden_size"]) // hq
    b = int(st["tr"]["llm_batch"])
    total = 0.0
    for r in st["segment_records"]:
        ps = r["prompts"]
        for i in range(0, len(ps), b):
            chunk = ps[i:i + b]
            for rows in ([(p["len"], p["iso_pairs"]) for p in chunk],
                         [(p["len"], bounds.causal_pairs(p["len"]))
                          for p in chunk]):
                total += bounds.k1_bound(rows, hq, hkv, dh,
                                         cfg["torch_dtype"])[2]
    return 100.0 * total * int(cfg["num_hidden_layers"]) / dev
