"""Typed payloads passed between layers.

Mirrors the contracts of the reference's dataclasses
(``src/pipeline/models/datamodels.py:7-73``) so a user of the reference finds
the same shapes, while ``RetrievalBatch`` additionally carries device arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass(frozen=True)
class PairSpec:
    """One experiment condition: (retrieval depth, attacker position)."""
    top_k: int
    attacker_pos: int


@dataclass
class QueryData:
    """Unified dataset input; each query may have several GT strings and
    several preset false answers / malicious docs (CSV mode)."""
    query_ids: List[str]
    questions: List[str]
    short_answers: List[List[str]]
    false_answer_groups: Optional[List[List[str]]] = None
    malicious_doc_groups: Optional[List[List[str]]] = None

    def __len__(self) -> int:
        return len(self.questions)


@dataclass
class RetrievalBatch:
    """Per-query-aligned retrieval output.

    Outer list: per query; inner list: ranked docs of length max_k_needed.
    ``q_embs`` holds one embedding per query (None for the sparse path).
    """
    q_embs: List[Any]
    docs_texts_full: List[List[str]]
    ids_full: List[List[str]]
    scores_full: List[List[float]]


@dataclass
class Resources:
    """Heavy objects initialized once and reused across the run."""
    ranker: Any = None           # encoder wrapper (E5)
    tokenizer: Any = None
    generator: Any = None        # decoder generation engine
    dense_index: Any = None
    sparse_index: Any = None
    mesh: Any = None


@dataclass
class DefenseOutput:
    """Defense result: filtered corpus-side ranking plus surviving malicious
    docs (oracle path) and optional per-doc labels (discern)."""
    ranked_docs: List[str]
    ranked_ids: List[str]
    ranked_scores: Optional[List[float]]
    malicious_docs_survived: List[str] = field(default_factory=list)
    doc_labels: Optional[Dict[str, str]] = None


MAL_ID_PREFIX = "__MAL__"


def make_mal_id(i: int) -> str:
    """Synthetic id for injected malicious docs (reference ``datamodels.py:71``)."""
    return f"{MAL_ID_PREFIX}{i}"


def is_mal_id(doc_id: str) -> bool:
    return str(doc_id).startswith(MAL_ID_PREFIX)
