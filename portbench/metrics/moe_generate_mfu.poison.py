"""Share of the card's bf16 peak, in %, that the window's valid generation
work takes over the whole window, for a sparse-expert decoder with
windowed and full layers: the model's operations for every prompt's valid
tokens (attention projections at the config's head_dim, the router and
the k routed experts a token; attention over the unmasked pairs of each
layer's mask, SDAG for ISO or causal for NO-ISO, within the window on the
windowed layers; the head at the last position) and for every answer
token fed to a decode step, divided by window seconds x 989 TFLOP/s
(``portbench/common/moe_bounds.py``)."""

from portbench.common import bounds, moe_bounds


def read(st):
    cfg = st["cfg"]
    pre, dec = [], []
    for r in st["records"]:
        for p in r["prompts"]:
            pre.append((p["len"], p["iso_pairs"], p["iso_pairs_w"]))
            pre.append((p["len"], bounds.causal_pairs(p["len"]),
                        p["causal_pairs_w"]))
            dec.append((p["len"], p["iso_fed"]))
            dec.append((p["len"], p["noiso_fed"]))
    flops = moe_bounds.moe_flops(cfg, pre, dec)
    return 100.0 * flops / (st["window_s"] * bounds.PEAK_FLOPS["bfloat16"])
