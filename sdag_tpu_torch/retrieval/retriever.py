"""Retriever interface.

Same contract as the reference ABC (``src/pipeline/retrieval/retriever.py:9-19``):
``retrieve_batch(queries, max_k_needed, embed_batch_size) -> RetrievalBatch``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Sequence

from sdag_tpu_torch.datamodels import RetrievalBatch


class Retriever(ABC):
    @abstractmethod
    def retrieve_batch(self, queries: Sequence[str], max_k_needed: int,
                       embed_batch_size: int) -> RetrievalBatch:
        """Retrieve the top-max_k_needed docs for each query."""
        raise NotImplementedError


def materialize_hits(meta, indices, scores, invalid_score=None):
    """Shared (index, score) -> (texts, ids, scores) materialization for
    the dense and sparse indexes: out-of-range / -1 indices become
    ""/"NA" rows (reference pads short hit lists the same way,
    ``sparse.py:99-102``).

    invalid_score: score recorded for invalid slots — None keeps the raw
    score (dense: the -inf travels through), a float overrides it
    (sparse pins -inf even if the engine reported something else)."""
    texts_b, ids_b, scores_b = [], [], []
    for row_idx, row_sc in zip(indices, scores):
        texts, ids_, scs = [], [], []
        for idx, sc in zip(row_idx, row_sc):
            if 0 <= idx < len(meta):
                texts.append(meta[idx].get("text", ""))
                ids_.append(str(meta[idx].get("id", "NA")))
                scs.append(float(sc))
            else:
                texts.append("")
                ids_.append("NA")
                scs.append(float(sc) if invalid_score is None
                           else float(invalid_score))
        texts_b.append(texts)
        ids_b.append(ids_)
        scores_b.append(scs)
    return texts_b, ids_b, scores_b
