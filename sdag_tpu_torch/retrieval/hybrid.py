"""Hybrid retrieval: reciprocal-rank fusion of dense + sparse rankings.

Counterpart of ``sdag_tpu/retrieval/hybrid.py``.  Behavioral parity with
``src/pipeline/retrieval/hybrid.py:10-225``: k split half/half with a
seeded coin flip for odd k, RRF score 1/(k0+rank) with k0=60, dedup by id
(doc text as fallback key for missing/"NA" ids), and the dense retriever's
query embeddings kept on the fused batch.
"""

from __future__ import annotations

import random
from typing import List, Sequence, Tuple

import numpy as np
import torch

from sdag_tpu_torch.datamodels import RetrievalBatch
from sdag_tpu_torch.ops.rrf import rrf_fuse_topk
from sdag_tpu_torch.retrieval.retriever import Retriever

RRF_K0 = 60


def split_k_between_sparse_and_dense(top_k: int, rng: random.Random) -> Tuple[int, int]:
    """k/2 each; for odd k a seeded coin flip decides who gets the extra."""
    k_half = top_k // 2
    if top_k % 2 == 0:
        return k_half, k_half
    if rng.random() < 0.5:
        return k_half + 1, k_half
    return k_half, k_half + 1


def _key_for(doc_id: str, doc_text: str) -> str:
    if doc_id is not None and doc_id not in ("", "NA"):
        return doc_id
    return doc_text


def rrf_fuse_one_query(
    sparse_docs: List[str], sparse_ids: List[str],
    dense_docs: List[str], dense_ids: List[str],
    k0: int = RRF_K0,
) -> Tuple[List[str], List[str], List[float]]:
    """Fuse two rankings by RRF score sum.

    Deterministic order: stable sort by score desc over candidates in
    (sparse rank order, then dense) — identical to the device fuser
    (ops/rrf.py).  Lucene no-match padding slots (empty text, ""/"NA" id)
    are excluded from fusion.
    """
    sparse_rank = {}
    for i, (d, did) in enumerate(zip(sparse_docs, sparse_ids), start=1):
        if not d and (did in (None, "", "NA")):
            continue  # no-hit padding, not a document
        sparse_rank.setdefault(_key_for(did, d), i)
    dense_rank = {}
    for i, (d, did) in enumerate(zip(dense_docs, dense_ids), start=1):
        if not d and (did in (None, "", "NA")):
            continue
        dense_rank.setdefault(_key_for(did, d), i)

    rep = {}
    order: List[str] = []
    for d, did in list(zip(sparse_docs, sparse_ids)) + \
            list(zip(dense_docs, dense_ids)):
        key = _key_for(did, d)
        if key in rep or (not d and (did in (None, "", "NA"))):
            continue
        rep[key] = (d, did)
        order.append(key)

    fused = []
    for key in order:
        score = 0.0
        if key in sparse_rank:
            score += 1.0 / (k0 + sparse_rank[key])
        if key in dense_rank:
            score += 1.0 / (k0 + dense_rank[key])
        doc, did = rep[key]
        fused.append((score, doc, did))

    fused.sort(key=lambda x: -x[0])  # stable: ties keep candidate order
    return ([d for _, d, _ in fused], [i for _, _, i in fused],
            [s for s, _, _ in fused])


def fuse_sparse_and_dense_batch(
    sparse_texts: List[List[str]], sparse_ids: List[List[str]],
    dense_texts: List[List[str]], dense_ids: List[List[str]],
    top_k: int, seed: int, k0: int = RRF_K0,
) -> Tuple[List[List[str]], List[List[str]], List[List[float]]]:
    rng = random.Random(seed)
    out_texts, out_ids, out_scores = [], [], []
    for s_docs, s_ids, d_docs, d_ids in zip(sparse_texts, sparse_ids,
                                            dense_texts, dense_ids):
        k_sparse, k_dense = split_k_between_sparse_and_dense(top_k, rng)
        docs, ids_, scores = rrf_fuse_one_query(
            s_docs[:k_sparse], s_ids[:k_sparse],
            d_docs[:k_dense], d_ids[:k_dense], k0=k0)
        out_texts.append(docs[:top_k])
        out_ids.append(ids_[:top_k])
        out_scores.append(scores[:top_k])
    return out_texts, out_ids, out_scores


class HybridRetriever(Retriever):
    """Runs dense and sparse children, fuses by RRF, keeps dense q_embs."""

    def __init__(self, dense_retriever: Retriever, sparse_retriever: Retriever,
                 seed: int, k0: int = RRF_K0) -> None:
        self.dense = dense_retriever
        self.sparse = sparse_retriever
        self.seed = seed
        self.k0 = k0

    def _same_corpus(self) -> bool:
        """Device fusion requires both indexes over the same corpus order
        (global index == doc identity).  Full id-sequence comparison, done
        once per (dense, sparse) index pair and memoized — endpoint
        sampling would silently fuse mismatched middles by index."""
        dm = getattr(getattr(self.dense, "index", None), "meta", None)
        sm = getattr(getattr(self.sparse, "index", None), "meta", None)
        if dm is None or sm is None:
            return False
        key = (id(dm), id(sm))
        if getattr(self, "_same_corpus_key", None) == key:
            return self._same_corpus_val
        # identity must be POSITIVE: rows without ids compare None == None
        # and would declare two unrelated id-less corpora "identical";
        # duplicate ids make the host fuser merge rows the device fuser
        # keeps separate (it dedups by global index), so either case
        # routes to the safe host path
        ids_d = [a.get("id") for a in dm]
        ids_s = [b.get("id") for b in sm]
        val = (len(ids_d) == len(ids_s) and ids_d == ids_s
               and all(i is not None for i in ids_d)
               and len(set(ids_d)) == len(ids_d))
        self._same_corpus_key = key
        self._same_corpus_val = val
        return val

    def retrieve_batch(self, queries: Sequence[str], max_k_needed: int,
                       embed_batch_size: int) -> RetrievalBatch:
        if self._same_corpus():
            return self._retrieve_batch_device(queries, max_k_needed,
                                               embed_batch_size)
        dense = self.dense.retrieve_batch(queries, max_k_needed, embed_batch_size)
        sparse = self.sparse.retrieve_batch(queries, max_k_needed, embed_batch_size)
        texts, ids_, scores = fuse_sparse_and_dense_batch(
            sparse.docs_texts_full, sparse.ids_full,
            dense.docs_texts_full, dense.ids_full,
            top_k=max_k_needed, seed=self.seed, k0=self.k0)
        return RetrievalBatch(q_embs=dense.q_embs, docs_texts_full=texts,
                              ids_full=ids_, scores_full=scores)

    def _retrieve_batch_device(self, queries: Sequence[str],
                               max_k_needed: int,
                               embed_batch_size: int) -> RetrievalBatch:
        """Device-side RRF: both searches return global corpus indices and
        fusion runs as one tensor op (ops/rrf.py) on the dense index'
        device.  Same seeded odd-k split, same (score desc, sparse-first)
        order as the host fuser."""
        q_embs = self.dense.encoder.encode(list(queries), kind="query",
                                           batch_size=embed_batch_size)
        d_idx, _ = self.dense.index.search(q_embs, max_k_needed)
        s_idx, _ = self.sparse.index.search(list(queries), max_k_needed)

        rng = random.Random(self.seed)
        ks, kd = [], []
        for _ in queries:
            a, b = split_k_between_sparse_and_dense(max_k_needed, rng)
            ks.append(a)
            kd.append(b)
        dev = self.dense.index.device
        as_dev = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.int32), device=dev)
        fused_idx, fused_sc = rrf_fuse_topk(
            as_dev(s_idx), as_dev(d_idx), as_dev(ks), as_dev(kd),
            k0=self.k0, top_k=max_k_needed)
        fused_idx = fused_idx.cpu().numpy()
        fused_sc = fused_sc.cpu().numpy()

        meta = self.dense.index.meta
        texts, ids_, scores = [], [], []
        for row_i, row_s in zip(fused_idx, fused_sc):
            t, d, s = [], [], []
            for i, sc in zip(row_i, row_s):
                if i < 0:
                    break  # -1 padding: fused list is shorter than top_k
                t.append(meta[i].get("text", ""))
                d.append(str(meta[i].get("id", "NA")))
                s.append(float(sc))
            texts.append(t)
            ids_.append(d)
            scores.append(s)
        return RetrievalBatch(q_embs=list(np.asarray(q_embs)),
                              docs_texts_full=texts, ids_full=ids_,
                              scores_full=scores)
