"""Malicious-document selection: near/far/random vs the retrieved centroid.

Behavioral parity with ``src/pipeline/attack/malicious_selection.py:37-180``:
strategies random / closest_to_centroid / furthest_from_centroid, centroid =
mean embedding of non-empty retrieved docs, sorted multi-doc order, random
fallbacks when embeddings are unavailable.  The centroid/similarity math runs
batched on device.
"""

from __future__ import annotations

import random
from typing import List, Optional

import numpy as np


def _select_for_query(encoder, retrieved_docs: List[str],
                      candidate_docs: List[str], strategy: str,
                      max_docs: Optional[int],
                      rng: random.Random) -> List[str]:
    if not candidate_docs:
        return []
    if max_docs is None or max_docs < 0 or max_docs >= len(candidate_docs):
        target_n = len(candidate_docs)
    else:
        target_n = max_docs

    def rand_pick():
        if target_n == 1:
            return [rng.choice(candidate_docs)]
        return rng.sample(candidate_docs, target_n)

    if strategy == "random":
        return rand_pick()

    nonempty = [d for d in retrieved_docs if d and d.strip()]
    if not nonempty:
        return rand_pick()
    retrieved_emb = encoder.encode(nonempty, kind="passage")
    if retrieved_emb.shape[0] == 0:
        return rand_pick()
    centroid = retrieved_emb.mean(axis=0, keepdims=True)
    candidate_emb = encoder.encode(candidate_docs, kind="passage")
    if candidate_emb.shape[0] == 0:
        return rand_pick()
    sims = (candidate_emb @ centroid.T).reshape(-1)

    if strategy == "closest_to_centroid":
        order = np.argsort(-sims, kind="stable")
    elif strategy == "furthest_from_centroid":
        order = np.argsort(sims, kind="stable")
    else:
        return rand_pick()
    return [candidate_docs[int(i)] for i in order[:target_n]]


def select_malicious_docs_for_batch(
    encoder,
    retrieved_docs_batch_full: List[List[str]],
    malicious_doc_groups_batch: List[List[str]],
    strategy: str,
    max_docs: Optional[int],
    rng: Optional[random.Random] = None,
) -> List[List[str]]:
    """Per-query selection (reference ``malicious_selection.py:140``)."""
    rng = rng or random.Random()
    return [
        _select_for_query(encoder, retrieved, candidates, strategy, max_docs,
                          rng)
        for retrieved, candidates in zip(retrieved_docs_batch_full,
                                         malicious_doc_groups_batch)
    ]
