"""Ranked-list injection and prompt-order policies.

Behavioral parity with ``src/pipeline/utils/ranked_list.py:8-139``: int
positions (0 no-op, >0 1-indexed contiguous insert, -1 random), per-doc
position lists (short lists padded with -1; fixed positions inserted
high-to-low, then randoms), and top_down/bottom_up/random ordering.
Randomness is taken from an explicit ``random.Random`` for reproducibility.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple, Union


def attack_config_requests_docs(pos_cfg: object) -> bool:
    """True iff the position config asks for at least one injection.

    bool follows int semantics (True == 1 requests an injection) — the
    reference treats positions as plain ints and a special-case here made
    scalar True report no attack while [True] reported one."""
    if isinstance(pos_cfg, int):  # covers bool (True == 1)
        return pos_cfg != 0
    if isinstance(pos_cfg, (list, tuple)):
        return any((p or 0) != 0 for p in pos_cfg)
    return False


def inject_malicious_docs_into_ranked_list(
    base_docs: List[str],
    malicious_docs: List[str],
    attack_pos: Union[int, Sequence[Optional[int]]],
    rng: Optional[random.Random] = None,
) -> List[str]:
    """Insert malicious docs into a ranked list.

    attack_pos: 0 = none, >0 = fixed 1-indexed contiguous block, -1 = random
    per doc; a list gives per-doc positions (padded with -1; fixed inserted
    high-to-low so earlier positions stay valid, then random ones).
    """
    if not malicious_docs:
        return list(base_docs)
    rng = rng or random
    ranked = list(base_docs)

    if isinstance(attack_pos, int):
        if attack_pos == 0:
            return ranked
        if attack_pos > 0:
            pos = max(0, min(attack_pos - 1, len(ranked)))
            for md in malicious_docs:
                ranked.insert(pos, md)
                pos += 1
            return ranked
        if attack_pos == -1:
            for md in malicious_docs:
                ranked.insert(rng.randint(0, len(ranked)), md)
        return ranked

    pos_list = list(attack_pos)
    if len(pos_list) < len(malicious_docs):
        pos_list += [-1] * (len(malicious_docs) - len(pos_list))
    else:
        pos_list = pos_list[:len(malicious_docs)]

    fixed: List[Tuple[int, str]] = []
    randoms: List[str] = []
    for md, p in zip(malicious_docs, pos_list):
        if p is not None and p > 0:
            fixed.append((p, md))
        elif p == -1:
            randoms.append(md)
        # p is None or other non-positive: dropped (reference parity)

    for p, md in sorted(fixed, key=lambda x: x[0], reverse=True):
        ranked.insert(max(0, min(p - 1, len(ranked))), md)
    for md in randoms:
        ranked.insert(rng.randint(0, len(ranked)), md)
    return ranked


def apply_ranked_list_order(
    ranked_docs: List[str],
    order_mode: str,
    rng: Optional[random.Random] = None,
) -> List[str]:
    """top_down = identity, bottom_up = reverse, random = shuffle."""
    if order_mode == "bottom_up":
        return list(reversed(ranked_docs))
    if order_mode == "random":
        out = list(ranked_docs)
        (rng or random).shuffle(out)
        return out
    return list(ranked_docs)
