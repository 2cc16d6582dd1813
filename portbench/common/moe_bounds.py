"""The yardstick's arithmetic for a sparse-expert decoder with windowed and
full attention layers: pairs under a window, model operations of the
valid work, and the bounds of K8 (the decode step's expert layer) and of
K1 under each layer's mask.

Peaks and K1's bound are ``bounds.py``'s.  Operations count k routed
experts a token and the router (never the experts not picked), the
attention projections at ``head_dim`` (set apart from the hidden size),
and attention over the unmasked pairs of each layer's kind: the SDAG or
causal rule, intersected with the window on the windowed layers.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

from portbench.common import bounds


def window_causal_pairs(length: int, window: int) -> int:
    """Causal pairs of ``length`` tokens where i - j < window."""
    if length <= window:
        return bounds.causal_pairs(length)
    return window * (window + 1) // 2 + (length - window) * window


def window_iso_pairs(length: int, sys_user_len: int,
                     doc_spans: Sequence[Tuple[int, int]],
                     window: int) -> int:
    """``bounds.iso_pairs`` under a window: a passage row i sees the
    prefix keys and its passage's keys up to itself, those with i - j <
    window; every other row sees the keys i - window < j <= i."""
    i = np.arange(length, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0)
    seen = i - lo + 1
    for a, b in doc_spans:
        r = i[a:b]
        seen[a:b] = np.maximum(sys_user_len - lo[a:b], 0) + (
            r - np.maximum(a, lo[a:b]) + 1)
    return int(seen.sum())


def kinds(cfg: Dict) -> Tuple[int, int]:
    """(full layers, windowed layers)."""
    types = cfg["layer_types"]
    n_win = sum(t == "sliding_attention" for t in types)
    return len(types) - n_win, n_win


def layer_params(cfg: Dict) -> Tuple[int, int, int, int]:
    """(attention projections, router, one expert, output head) matrix
    parameters of one layer (the head: the model's)."""
    d = int(cfg["hidden_size"])
    hd = int(cfg["head_dim"])
    q = int(cfg["num_attention_heads"]) * hd
    kv = int(cfg["num_key_value_heads"]) * hd
    f = int(cfg["moe_intermediate_size"])
    return (2 * d * q + 2 * d * kv, d * int(cfg["num_experts"]), 3 * d * f,
            d * int(cfg["vocab_size"]))


def moe_flops(cfg: Dict, prefill: Iterable[Tuple[int, int, int]],
              decode: Iterable[Tuple[int, int]]) -> float:
    """Model operations of the valid work: ``prefill`` (valid length,
    pairs of the full layers' mask, pairs of the windowed layers' mask) of
    each prompt, whose head runs at the last position only; ``decode``
    (prompt length, tokens fed) of each answer, token t at position
    length + t attending length + t + 1 keys on a full layer and at most
    ``sliding_window`` on a windowed one."""
    attn, router, expert, head = layer_params(cfg)
    k = int(cfg["num_experts_per_tok"])
    per_token = 2.0 * (attn + router + k * expert)
    n_full, n_win = kinds(cfg)
    n_l = n_full + n_win
    pair = 4.0 * int(cfg["num_attention_heads"]) * int(cfg["head_dim"])
    w = int(cfg["sliding_window"])
    total = 0.0
    for length, full_pairs, win_pairs in prefill:
        total += per_token * n_l * length + 2.0 * head
        total += pair * (n_full * full_pairs + n_win * win_pairs)
    for plen, fed in decode:
        total += (per_token * n_l + 2.0 * head) * fed
        keys = np.arange(plen + 1, plen + fed + 1, dtype=np.int64)
        total += pair * (n_full * int(keys.sum())
                         + n_win * int(np.minimum(keys, w).sum()))
    return total


def k8_bound(cfg: Dict, row_layers: int, expert_reads: int
             ) -> Tuple[float, float, float]:
    """(operations, bytes, seconds) of K8's work: ``row_layers`` live rows
    times layers (each picks k experts: the SwiGLU's three products a
    pick), ``expert_reads`` distinct experts read (each expert's three
    matrices once), the rows read in and written out once, in bf16."""
    d = int(cfg["hidden_size"])
    _, _, expert, _ = layer_params(cfg)
    es = bounds.DTYPE_BYTES["bfloat16"]
    flops = 2.0 * expert * int(cfg["num_experts_per_tok"]) * row_layers
    nbytes = float(expert_reads * expert * es + row_layers * 2 * d * es)
    return flops, nbytes, max(flops / bounds.PEAK_FLOPS["bfloat16"],
                              nbytes / bounds.H100_BYTES_PER_S)
