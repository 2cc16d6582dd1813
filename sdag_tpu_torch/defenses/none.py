"""Passthrough defense (the CARG baseline, reference ``defenses/none.py``)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from sdag_tpu_torch.datamodels import DefenseOutput
from sdag_tpu_torch.defenses.base import Defense


class NoDefense(Defense):
    """No filtering; oracle mode reports all malicious docs as survivors so
    they are injected downstream."""

    def apply(self, query_id, query, corpus_docs, corpus_ids, corpus_scores,
              malicious_docs, does_oracle,
              persistent_cache: Optional[Dict[Tuple[str, str], str]] = None
              ) -> DefenseOutput:
        return DefenseOutput(
            ranked_docs=list(corpus_docs),
            ranked_ids=list(corpus_ids),
            ranked_scores=list(corpus_scores) if corpus_scores is not None
            else None,
            malicious_docs_survived=list(malicious_docs) if does_oracle else [],
            doc_labels=None,
        )
