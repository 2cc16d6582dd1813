"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes that each measured piece of work needs.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity).  The
K1 bound follows ``chip_smoke.py``'s ``_k1_case`` (operations from the
mask's unmasked pairs, q/k/v read once where the position is valid, the
metadata read once), except that the output counts the valid positions
only, so it counts what the inputs need whatever implements it and
however it pads.  A bound is
max(operations / peak rate, bytes / peak bandwidth) in seconds.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

H100_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "tf32": 495e12, "int8": 1979e12, "fp8": 1979e12}
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


def iso_pairs(length: int, sys_user_len: int,
              doc_spans: Sequence[Tuple[int, int]]) -> int:
    """Unmasked (query, key) pairs of one ISO prompt of ``length`` valid
    tokens under the SDAG rule: a passage row sees the whole system/user
    prefix and its own passage up to itself; every other row is causal."""
    causal = length * (length + 1) // 2
    for a, b in doc_spans:
        n = b - a
        # rows a..b-1 lose the keys between the prefix and the passage
        causal -= n * (a - sys_user_len)
    return causal


def causal_pairs(length: int) -> int:
    return length * (length + 1) // 2


def k1_bound(rows: Iterable[Tuple[int, int]], hq: int, hkv: int, dh: int,
             dtype: str) -> Tuple[float, float, float]:
    """(operations, bytes, seconds) of one prefill layer's attention.
    ``rows``: (valid length, unmasked pairs) of each prompt of the batch.
    q, k, v read once and the output written once at the valid positions,
    the per-token metadata (doc id, neighbour bits, query doc id) once."""
    es = DTYPE_BYTES[dtype]
    rows = list(rows)
    valid = sum(v for v, _ in rows)
    pairs = sum(p for _, p in rows)
    flops = 4.0 * pairs * hq * dh
    nbytes = (2 * hq + 2 * hkv) * valid * dh * es + 4 * 3 * valid
    return flops, nbytes, max(flops / PEAK_FLOPS[dtype],
                              nbytes / H100_BYTES_PER_S)


def decoder_matmul_params(cfg: Dict) -> Tuple[int, int]:
    """(matrix parameters of all layers, of the output head)."""
    d = int(cfg["hidden_size"])
    hd = d // int(cfg["num_attention_heads"])
    kv = int(cfg["num_key_value_heads"]) * hd
    ff = int(cfg["intermediate_size"])
    layer = d * d * 2 + 2 * d * kv + 3 * d * ff
    return layer * int(cfg["num_hidden_layers"]), d * int(cfg["vocab_size"])


def decoder_flops(cfg: Dict, prefill: Iterable[Tuple[int, int]],
                  decode: Iterable[Tuple[int, int]]) -> float:
    """Model operations of the valid work: ``prefill`` (valid length,
    unmasked pairs) of each prompt, whose head runs at the last position
    only; ``decode`` (prompt length, tokens fed) of each answer, token t
    attending prompt + t + 1 keys."""
    layers, head = decoder_matmul_params(cfg)
    hq = int(cfg["num_attention_heads"])
    dh = int(cfg["hidden_size"]) // hq
    n_l = int(cfg["num_hidden_layers"])
    total = 0.0
    for length, pairs in prefill:
        total += 2.0 * layers * length + 2.0 * head
        total += 4.0 * pairs * hq * dh * n_l
    for plen, fed in decode:
        total += (2.0 * layers + 2.0 * head) * fed
        keys = fed * plen + fed * (fed + 1) // 2
        total += 4.0 * keys * hq * dh * n_l
    return total
