"""Doc-corruption attack ops.

Behavioral parity with ``src/pipeline/attack/doc_corruption.py:8-74``:
corrupt a *retrieved* GT-bearing doc (case-insensitive substring replace)
instead of injecting a new one, then move it to the attacker position.
"""

from __future__ import annotations

import random
import re
from typing import List, Optional


def doc_contains_any_gt(doc: str, gt_answers: List[str]) -> bool:
    """Case-insensitive substring test of any GT string inside the doc."""
    if not doc:
        return False
    d = doc.lower()
    return any(gt and gt.strip() and gt.strip().lower() in d for gt in gt_answers)


def replace_gt_with_false(doc: str, gt_answers: List[str], false_answer: str) -> str:
    """Replace all case-insensitive occurrences of each GT string with the
    false answer (regex-escaped, conservative)."""
    if not doc:
        return ""
    if not false_answer:
        return doc
    out = doc
    for gt in gt_answers:
        if gt and gt.strip():
            # lambda repl: false_answer is LITERAL text — as a template,
            # a backslash or '\\1' in an LLM-generated answer would raise
            # re.error mid-experiment (or corrupt the doc)
            out = re.sub(re.escape(gt.strip()), lambda m: false_answer,
                         out, flags=re.IGNORECASE)
    return out


def build_docs_for_attack(
    docs: List[str],
    attacked_idx: int,
    attack_pos: int,
    top_k: int,
    rng: Optional[random.Random] = None,
) -> List[str]:
    """Move docs[attacked_idx] to the attack position (0 = keep in place,
    >0 = 1-indexed, -1 = random), then truncate to top_k."""
    if not docs:
        return []
    rng = rng or random
    attacked_idx = max(0, min(attacked_idx, len(docs) - 1))

    out = list(docs)
    attacked_doc = out.pop(attacked_idx)

    if attack_pos == 0:
        out.insert(attacked_idx, attacked_doc)
    elif attack_pos == -1:
        out.insert(rng.randint(0, len(out)), attacked_doc)
    else:
        out.insert(max(0, min(int(attack_pos) - 1, len(out))), attacked_doc)
    return out[:top_k]
