"""Defense interface.

Same contract as the reference ABC (``src/pipeline/defenses/base.py:9-26``):
take the (k+1)-doc corpus pool plus (oracle) malicious docs, return a
filtered ranking, surviving malicious docs, and optional labels.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Tuple

from sdag_tpu_torch.datamodels import DefenseOutput, is_mal_id, make_mal_id


def build_joint_lists(malicious_docs, corpus_docs, corpus_ids,
                      corpus_scores):
    """Mal-first joint (docs, ids, scores) lists — the reference feeds
    defenses the malicious docs prepended to the corpus pool with
    ``__MAL__i`` ids and 0.0 placeholder scores.  Single source of that
    contract for RAGDefender and Discern (they must not drift)."""
    joint_docs = list(malicious_docs) + list(corpus_docs)
    joint_ids = ([make_mal_id(i) for i in range(len(malicious_docs))]
                 + list(corpus_ids))
    joint_scores = ([0.0] * len(malicious_docs) + list(corpus_scores)
                    if corpus_scores is not None else None)
    return joint_docs, joint_ids, joint_scores


def split_kept_docs(kept, does_oracle: bool):
    """Split surviving (doc, id, score|None) tuples into (survived mals,
    docs, ids, scores): in oracle mode ``__MAL__`` docs divert to the
    survived-malicious list instead of the ranking (reference contract —
    they are re-injected at the attacker position downstream)."""
    kept_mals: List[str] = []
    out_docs: List[str] = []
    out_ids: List[str] = []
    out_scores: List[float] = []
    for d, did, sc in kept:
        if is_mal_id(did) and does_oracle:
            kept_mals.append(d)
        else:
            out_docs.append(d)
            out_ids.append(did)
            if sc is not None:
                out_scores.append(sc)
    return kept_mals, out_docs, out_ids, out_scores


class Defense(ABC):
    @abstractmethod
    def apply(
        self,
        query_id: str,
        query: str,
        corpus_docs: List[str],
        corpus_ids: List[str],
        corpus_scores: Optional[List[float]],
        malicious_docs: List[str],
        does_oracle: bool,
        persistent_cache: Optional[Dict[Tuple[str, str], str]] = None,
    ) -> DefenseOutput:
        raise NotImplementedError
