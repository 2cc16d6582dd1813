"""JSONL persistence for classifier labels (resumable across runs).

Behavioral parity with ``src/pipeline/defenses/cache.py:8-85``: keys are
(query_id, doc_id), labels normalized to lowercase, only "clean"/"perturbed"
accepted, malformed lines skipped.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

LabelCache = Dict[Tuple[str, str], str]

_VALID = ("clean", "perturbed")


def load_discern_labels_jsonl(path: str) -> LabelCache:
    cache: LabelCache = {}
    if not path:
        return cache
    if not os.path.exists(path):
        print(f"[discern] labels load path not found: {path}")
        return cache
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except Exception:
                continue
            qid = str(obj.get("query_id", "")).strip()
            did = str(obj.get("doc_id", "")).strip()
            lab = str(obj.get("label", "")).strip().lower()
            if qid and did and lab in _VALID:
                cache[(qid, did)] = lab
    print(f"[discern] loaded {len(cache)} labels from {path}")
    return cache


def save_discern_labels_jsonl(path: str, cache: LabelCache) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for (qid, did), lab in cache.items():
            f.write(json.dumps({"query_id": qid, "doc_id": did, "label": lab},
                               ensure_ascii=False) + "\n")
    print(f"[discern] saved {len(cache)} labels to {path}")
