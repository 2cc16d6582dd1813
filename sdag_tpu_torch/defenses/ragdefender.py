"""RAGDefender-equivalent defense: embedding-space outlier filtering.

The reference wraps a third-party ``ragdefender`` package
(``src/pipeline/defenses/ragdefender_defense.py:11-165``) whose contract is:
given the query and a joint doc list (malicious first, ``__MAL__i`` ids), the
model returns which docs to KEEP; the wrapper builds a keep mask *by text
membership* (explicitly not multiset-safe, ``ragdefender_defense.py:54-79``)
and splits survivors into corpus vs malicious.

Counterpart of ``sdag_tpu/defenses/ragdefender.py``: it reproduces that
Defense-interface behavior against the port's ``E5Encoder``, whose
``encode`` returns float32 numpy (kernel K3 on CUDA), so the z-score and
duplicate logic below stays numpy.  Detection heuristic: poisoned docs are
crafted to sit abnormally close to the query in embedding space and to each
other; docs whose query-similarity z-score exceeds a threshold (or the
densest near-duplicate cluster, for multi-doc attacks) are dropped.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from sdag_tpu_torch.datamodels import DefenseOutput
from sdag_tpu_torch.defenses.base import (Defense, build_joint_lists,
                                          split_kept_docs)


def _keep_mask_by_text(joint_docs: List[str], kept_docs: List[str]
                       ) -> List[bool]:
    """Text-membership keep mask (reference
    ``ragdefender_defense.py:54-79``; duplicates all share one fate)."""
    kept = set(kept_docs)
    return [d in kept for d in joint_docs]


class EmbeddingFilterDefense(Defense):
    """Drop embedding-space outliers: docs too close to the query relative to
    the pool (z-score) or near-duplicate groups (PoisonedRAG multi-doc)."""

    def __init__(self, encoder, z_threshold: float = 1.5,
                 duplicate_sim: float = 0.95) -> None:
        self.encoder = encoder
        self.z_threshold = z_threshold
        self.duplicate_sim = duplicate_sim

    def _scores(self, query: str, docs: List[str]
                ) -> Optional[Tuple[List[int], np.ndarray, np.ndarray]]:
        """(indices of the nonempty docs, their query-similarity z-scores,
        their pair similarities), or None when fewer than 3 are nonempty
        and the filter passes the list through."""
        nonempty_idx = [i for i, d in enumerate(docs) if d and d.strip()]
        if len(nonempty_idx) < 3:
            return None
        emb = self.encoder.encode([docs[i] for i in nonempty_idx],
                                  kind="passage")
        q_emb = self.encoder.encode([query], kind="query")[0]
        sims = emb @ q_emb

        mu, sigma = float(np.mean(sims)), float(np.std(sims))
        z = (sims - mu) / (sigma + 1e-9)
        return nonempty_idx, z, emb @ emb.T

    def _defend(self, query: str, docs: List[str]) -> List[str]:
        """Return the docs to keep."""
        scores = self._scores(query, docs)
        if scores is None:
            return list(docs)
        nonempty_idx, z, pair = scores
        drop = set(np.nonzero(z > self.z_threshold)[0].tolist())

        # near-duplicate clusters (independently generated supporting docs
        # for the same false answer are near-identical)
        n = len(nonempty_idx)
        for i in range(n):
            dup = [j for j in range(n)
                   if j != i and pair[i, j] > self.duplicate_sim]
            if dup:
                drop.add(i)
                drop.update(dup)

        keep_local = [i for i in range(n) if i not in drop]
        # never drop everything: keep the least-suspicious doc
        if not keep_local:
            keep_local = [int(np.argmin(z))]
        keep_global = {nonempty_idx[i] for i in keep_local}
        # empty docs pass through untouched (reference keeps them out of the
        # defense model's view)
        keep_global.update(i for i in range(len(docs))
                           if i not in nonempty_idx)
        return [docs[i] for i in sorted(keep_global)]

    def apply(self, query_id, query, corpus_docs, corpus_ids, corpus_scores,
              malicious_docs, does_oracle,
              persistent_cache: Optional[Dict[Tuple[str, str], str]] = None
              ) -> DefenseOutput:
        joint_docs, joint_ids, joint_scores = build_joint_lists(
            malicious_docs, corpus_docs, corpus_ids, corpus_scores)

        kept_docs_list = self._defend(query, joint_docs)
        keep = _keep_mask_by_text(joint_docs, kept_docs_list)

        kept = [(d, did,
                 joint_scores[n] if joint_scores is not None else None)
                for n, (d, did, k) in enumerate(zip(joint_docs, joint_ids,
                                                    keep)) if k]
        kept_mals, out_docs, out_ids, out_scores = split_kept_docs(
            kept, does_oracle)

        return DefenseOutput(
            ranked_docs=out_docs,
            ranked_ids=out_ids,
            ranked_scores=out_scores if joint_scores is not None else None,
            malicious_docs_survived=kept_mals,
            doc_labels=None,
        )
