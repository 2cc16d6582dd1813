"""Share of the card's bf16 peak, in %, that the window's valid generation
work takes over the whole window: the model's operations for every
prompt's valid tokens (matrix products, and attention over the unmasked
pairs of its SDAG mask for ISO or causal for NO-ISO; the head at the last
position) and for every answer token fed to a decode step (attention over
the prompt and the answer so far), divided by window seconds x 989
TFLOP/s."""

from portbench.common import bounds


def read(st):
    cfg = st["cfg"]
    pre, dec = [], []
    for r in st["records"]:
        for p in r["prompts"]:
            pre.append((p["len"], p["iso_pairs"]))
            pre.append((p["len"], bounds.causal_pairs(p["len"])))
            dec.append((p["len"], p["iso_fed"]))
            dec.append((p["len"], p["noiso_fed"]))
    flops = bounds.decoder_flops(cfg, pre, dec)
    return 100.0 * flops / (st["window_s"] * bounds.PEAK_FLOPS["bfloat16"])
