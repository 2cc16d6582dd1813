"""Document-document KNN for neighbor windows (DOC_NEIGHBORS_K).

Counterpart of ``sdag_tpu/sdag/knn.py`` (itself replacing the reference's
numpy argsort loop, ``SDAG.py:14-65``): embed docs (E5 'passage:' rule),
cosine sims, neighbors per doc sorted most-similar-first with self
excluded.  Empty / whitespace docs are skipped exactly like the reference.
Plain PyTorch ops (XLA in the JAX package, so no hand kernel is owed); the
similarity matrices are per prompt (a handful of docs), so they stay on the
host next to the embeddings ``encoder.encode`` returns.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def knn_from_embeddings(emb: np.ndarray, k_neighbors: int) -> List[List[int]]:
    """Neighbors per row of a normalized embedding matrix [N, D]; equal
    similarities resolve to the smaller index."""
    n = emb.shape[0]
    if n <= 1 or k_neighbors <= 0:
        return [[] for _ in range(n)]
    k = min(k_neighbors, n - 1)
    e = torch.from_numpy(np.ascontiguousarray(emb, dtype=np.float32))
    sims = e @ e.T
    # exclude self on the diagonal, then top-k per row (stable: ties by index)
    sims = sims - 2.0 * torch.eye(n, dtype=sims.dtype)
    idx = torch.sort(sims, dim=1, descending=True, stable=True).indices[:, :k]
    return [list(map(int, row)) for row in idx.numpy()]


def compute_doc_knn_for_docs_batch(encoder, docs_batch: List[List[str]],
                                   k_neighbors: int) -> List[List[List[int]]]:
    """Batched :func:`compute_doc_knn_for_docs`: ONE ``encoder.encode``
    call over every query's docs (the KNN itself stays per query, as
    neighbor indices are within-prompt)."""
    if k_neighbors <= 0:
        return [[[] for _ in docs] for docs in docs_batch]
    flat: List[str] = []
    spans = []
    keep = []
    for docs in docs_batch:
        nonempty = [(i, d) for i, d in enumerate(docs) if d and d.strip()]
        keep.append([i for i, _ in nonempty])
        spans.append((len(flat), len(flat) + len(nonempty)))
        flat.extend(d for _, d in nonempty)
    emb = encoder.encode(flat, kind="passage") if flat else None
    out_batch = []
    for docs, idxs, (s, e) in zip(docs_batch, keep, spans):
        n = len(docs)
        if len(idxs) <= 1:
            out_batch.append([[] for _ in range(n)])
            continue
        local = knn_from_embeddings(emb[s:e], k_neighbors)
        out: List[List[int]] = [[] for _ in range(n)]
        for row, i_full in enumerate(idxs):
            out[i_full] = [idxs[j] for j in local[row]]
        out_batch.append(out)
    return out_batch


def compute_doc_knn_for_docs(encoder, docs: List[str], k_neighbors: int
                             ) -> List[List[int]]:
    """Reference-contract wrapper (``SDAG.py:14``): returns one neighbor list
    per input doc; empty docs get [] and are excluded from others' lists.
    Delegates to the batched path so the nonempty-filter/index-remap rule
    lives in exactly one place."""
    return compute_doc_knn_for_docs_batch(encoder, [docs], k_neighbors)[0]
