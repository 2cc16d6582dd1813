"""Sparse (BM25) retrieval over a device-packed inverted representation.

Counterpart of ``sdag_tpu/retrieval/sparse.py``: the host C++ analyzer
(retrieval/analyzer.py) reproduces Lucene's analysis chain; documents are packed as padded (term_id, impact) tensors on the device;
search runs the postings engine by default and the dense-scan kernel K2
(ops/bm25.py) for ``engine="scan"`` and whenever a batch's postings
candidates exceed the budget.  Queries with fewer than k matches are
padded with ""/"NA"/-inf like the reference.  The index files are the JAX
package's, so an index saved by either package loads in the other.

Over an index mesh of n ranks (``core/mesh.py``) the packed rows pad to a
multiple of ROW_BLOCK * n and each rank keeps one block: its packed rows,
its own CSR postings and heavy-term columns with LOCAL doc ids; the
engines run per shard and merge (``parallel/collectives.py``).  Every rank
builds every shard's CSR on the host (the windows and the heavy terms need
all shards' dfs) and keeps its own on the device.

While a torch.profiler collects, each query chunk records the spans
``sdag.bm25.encode`` (analysis, slot order, the engine's choice) and
``sdag.bm25.<engine>`` around the device call and its download, named by
the engine the chunk took (``postings``, ``hybrid``, ``scan``, or their
``sharded_`` forms); ``SparseRetriever`` adds ``sdag.bm25.materialize``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sdag_tpu_torch.core.mesh import is_writer, make_index_mesh
from sdag_tpu_torch.datamodels import RetrievalBatch
from sdag_tpu_torch.ops.bm25 import (PAD_TERM, bm25_hybrid_topk,
                                     bm25_postings_topk, bm25_topk_dispatch)
from sdag_tpu_torch.parallel.collectives import (
    gather_rows, sharded_bm25_hybrid_topk, sharded_bm25_postings_topk,
    sharded_bm25_topk)
from sdag_tpu_torch.retrieval.analyzer import analyze_texts
from sdag_tpu_torch.retrieval.retriever import Retriever, materialize_hits
from sdag_tpu_torch.utils.device import resolve_device
from sdag_tpu_torch.utils.mathutil import round_up as _round_up
from sdag_tpu_torch.utils.profiling import span


def _csr_from_packed(term_ids: np.ndarray, impacts: np.ndarray,
                     n_vocab: int):
    """Host build of term-major CSR postings from the packed [N, Lp]
    representation: (docs [P], imps [P], offsets [V+1], max_df).  Stable
    sort by term keeps docs ascending within each term (row-major input)."""
    n, lp = term_ids.shape
    flat_t = term_ids.ravel()
    mask = flat_t != PAD_TERM
    flat_t = flat_t[mask]
    flat_i = impacts.ravel()[mask]
    flat_d = np.repeat(np.arange(n, dtype=np.int32), lp)[mask]
    order = np.argsort(flat_t, kind="stable")
    docs = flat_d[order].astype(np.int32)
    imps = flat_i[order].astype(np.float32)
    terms_sorted = flat_t[order]
    counts = np.bincount(terms_sorted, minlength=n_vocab)
    offsets = np.zeros(n_vocab + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    max_df = int(counts.max()) if counts.size else 1
    return docs, imps, offsets.astype(np.int32), max(max_df, 1)


def _counts_from_tokens(doc_tokens: List[List[str]]) -> Dict[str, Any]:
    """Python counterpart of the native ``bm25_build_counts``: vocab in
    first-appearance order, per-doc (tid, tf) pairs in ascending tid,
    document frequencies, analyzed doc lengths."""
    vocab: Dict[str, int] = {}
    df: List[int] = []
    pair_tid: List[int] = []
    pair_tf: List[int] = []
    doc_offsets: List[int] = [0]
    doc_len: List[int] = []
    for toks in doc_tokens:
        row: Dict[int, int] = {}
        for t in toks:
            tid = vocab.get(t)
            if tid is None:
                tid = len(vocab)
                vocab[t] = tid
                df.append(0)
            row[tid] = row.get(tid, 0) + 1
        for tid in sorted(row):
            pair_tid.append(tid)
            pair_tf.append(row[tid])
            df[tid] += 1
        doc_offsets.append(len(pair_tid))
        doc_len.append(len(toks))
    return {"doc_offsets": np.asarray(doc_offsets, np.int64),
            "doc_len": np.asarray(doc_len, np.int32),
            "df": np.asarray(df, np.int32),
            "pair_tid": np.asarray(pair_tid, np.int32),
            "pair_tf": np.asarray(pair_tf, np.int32),
            "terms": list(vocab.keys())}


class BM25Index:
    """Packed impact-scored BM25 index (Lucene scoring variant, k1=0.9
    b=0.4 Anserini defaults), row-sharded over an index mesh (one shard
    without a process group)."""

    def __init__(self, doc_tokens: Optional[List[List[str]]],
                 meta: List[Dict[str, Any]],
                 k1: float = 0.9, b: float = 0.4,
                 max_terms_per_doc: Optional[int] = None,
                 max_query_terms: int = 32,
                 engine: str = "postings",
                 counts: Optional[Dict[str, Any]] = None,
                 device="cuda", mesh=None) -> None:
        if counts is None:
            if doc_tokens is None:
                raise ValueError("need doc_tokens or counts")
            if len(doc_tokens) != len(meta):
                raise ValueError("meta length must match docs")
            counts = _counts_from_tokens(doc_tokens)
        elif len(counts["doc_len"]) != len(meta):
            raise ValueError("meta length must match docs")
        if engine not in {"postings", "scan"}:
            raise ValueError(f"Unknown BM25 engine: {engine}")
        self.device = resolve_device(device)
        self._set_mesh(mesh)
        self.engine = engine
        self.meta = meta
        self.k1, self.b = float(k1), float(b)
        self.max_query_terms = max_query_terms
        n = len(meta)
        self.valid_n = n

        terms = counts["terms"]
        self.vocab: Dict[str, int] = {t: i for i, t in enumerate(terms)}
        df_arr = np.asarray(counts["df"], np.float64)
        self.idf = np.log(1.0 + (n - df_arr + 0.5) / (df_arr + 0.5))
        dls = np.asarray(counts["doc_len"], np.float64)
        avgdl = dls.mean() if n else 1.0
        doc_offsets = np.asarray(counts["doc_offsets"], np.int64)
        pair_tid = np.asarray(counts["pair_tid"], np.int32)
        pair_tf = np.asarray(counts["pair_tf"], np.float64)
        row_counts = np.diff(doc_offsets)
        pair_doc = np.repeat(np.arange(n, dtype=np.int64), row_counts)

        # packed width = the true max distinct-terms-per-doc (no silent
        # truncation); an explicit max_terms_per_doc cap is opt-in and warns
        max_row = int(row_counts.max()) if n else 1
        lp = _round_up(max(max_row, 1), 128)
        if max_terms_per_doc is None and lp > 2048:
            print(f"[bm25] WARNING: widest doc has {max_row} distinct "
                  f"terms -> packed width {lp}; postings will take "
                  f"~{n * lp * 8 / 1e9:.1f} GB. Set "
                  f"max_terms_per_doc to cap (deviates from Lucene).",
                  flush=True)
        if max_terms_per_doc is not None:
            cap = _round_up(max_terms_per_doc, 128)
            if cap < lp:
                n_trunc = int(np.sum(row_counts > cap))
                print(f"[bm25] WARNING: max_terms_per_doc={max_terms_per_doc}"
                      f" truncates {n_trunc}/{n} docs (max distinct terms "
                      f"{max_row}); ranking will deviate from Lucene",
                      flush=True)
            lp = min(lp, cap)

        # per-doc columns in impact-desc order (a cap keeps the
        # highest-impact terms)
        norm = self.k1 * (1.0 - self.b + self.b * dls / avgdl)
        impacts_flat = (self.idf[pair_tid] * pair_tf
                        / (pair_tf + norm[pair_doc])).astype(np.float32)
        n_pad = _round_up(max(n, 1), self.ROW_BLOCK * self.n_shards)
        term_ids = np.full((n_pad, lp), PAD_TERM, np.int32)
        impacts = np.zeros((n_pad, lp), np.float32)
        if len(pair_tid):
            order = np.lexsort((-impacts_flat, pair_doc))
            sd = pair_doc[order]
            pos = (np.arange(len(sd), dtype=np.int64)
                   - np.repeat(doc_offsets[:-1], row_counts))
            keep = pos < lp
            term_ids[sd[keep], pos[keep]] = pair_tid[order][keep]
            impacts[sd[keep], pos[keep]] = impacts_flat[order][keep]
        self.avgdl = float(avgdl)
        self._place(term_ids, impacts)

    def _set_mesh(self, mesh) -> None:
        self.mesh = mesh if mesh is not None else make_index_mesh(
            self.device)
        self.n_shards = self.mesh.shape["index"]

    def _place(self, term_ids: np.ndarray, impacts: np.ndarray) -> None:
        """This rank's block of the packed rows on the device, then the
        postings."""
        self.rows_per_shard = term_ids.shape[0] // self.n_shards
        r0 = self.mesh.rank("index") * self.rows_per_shard
        own = slice(r0, r0 + self.rows_per_shard)
        self.term_ids = self._dev(term_ids[own])
        self.impacts = self._dev(impacts[own])
        self._build_postings(term_ids, impacts)

    # packed rows pad to a multiple of this times the shards (the JAX
    # package's block_n)
    ROW_BLOCK = 512
    # postings window size: M = sum(per-slot windows) * window candidates
    POSTINGS_WINDOW = 512
    # Candidate budget per query batch: beyond it the postings walk
    # (O(sum df)) costs more than the flat scan's O(N*Lp/Q) share, so the
    # batch falls back to the scan engine (kernel K2 on CUDA).  Effective
    # budget = min(this, rows a shard / 2), the JAX package's rule: every
    # shard walks the whole window profile, the scan only its own rows.
    POSTINGS_CANDIDATE_BUDGET = 1 << 20

    def _candidate_budget(self) -> int:
        return min(self.POSTINGS_CANDIDATE_BUDGET,
                   max(self.valid_n // max(self.n_shards, 1), 2) >> 1)
    # Heavy-term dense sidecar: terms with df >= max(HEAVY_DF_MIN,
    # N * HEAVY_DF_FRAC) get a dense f32 impact column and are scored by a
    # matmul instead of a postings walk, capped at HEAVY_SIDECAR_BUDGET_MB
    # (highest-df terms first); terms left out stay on the exact walk.
    HEAVY_DF_MIN = 4 * POSTINGS_WINDOW
    HEAVY_DF_FRAC = 1 / 64
    HEAVY_SIDECAR_BUDGET_MB = 512

    def _build_postings(self, term_ids: np.ndarray, impacts: np.ndarray
                        ) -> None:
        """Device CSR postings for the O(sum df) engine: one CSR per
        shard over its row block (local doc ids), this rank's on the
        device.  Also keeps ``term_df_bound`` (host, [V]): per-term df, max
        over shards, the per-slot gather window bound at query time."""
        self.post_docs = self.post_imps = self.post_offsets = None
        self.term_df_bound = np.ones(max(len(self.vocab), 1), np.int64)
        self.heavy_cols = None
        self.heavy_rows = None
        self.heavy_row_of = None
        self._w_profile: Optional[List[int]] = None
        if self.engine != "postings":
            return
        n_vocab = max(len(self.vocab), 1)
        sr = self.rows_per_shard
        me = self.mesh.rank("index")
        df_bound = np.zeros(n_vocab, np.int64)
        df_global = np.zeros(n_vocab, np.int64)
        p_max = 1
        for s in range(self.n_shards):
            d_s, i_s, o_s, _m = _csr_from_packed(
                term_ids[s * sr:(s + 1) * sr], impacts[s * sr:(s + 1) * sr],
                n_vocab)
            if s == me:
                d, i, o = d_s, i_s, o_s
            dfs = np.diff(o_s.astype(np.int64))
            np.maximum(df_bound, dfs, out=df_bound)
            df_global += dfs
            p_max = max(p_max, len(d_s))
        # every shard pads its CSR to the longest one's length (the JAX
        # package stacks them)
        p_pad = _round_up(p_max, 128)
        docs = np.full(p_pad, np.iinfo(np.int32).max, np.int32)
        imps = np.zeros(p_pad, np.float32)
        docs[:len(d)] = d
        imps[:len(i)] = i
        self.post_docs = self._dev(docs)
        self.post_imps = self._dev(imps)
        self.post_offsets = self._dev(o)
        self.term_df_bound = df_bound

        # heavy terms by global df, so every shard has one column layout
        thresh = max(self.HEAVY_DF_MIN,
                     int(sr * self.n_shards * self.HEAVY_DF_FRAC))
        # 8 bytes/doc/term: impacts stored doc-major and term-major
        h_cap = int(self.HEAVY_SIDECAR_BUDGET_MB * (1 << 20)
                    // (8 * max(sr, 1)))
        heavy = np.flatnonzero(df_global >= thresh)
        if heavy.size and h_cap > 0:
            if heavy.size > h_cap:
                heavy = heavy[np.argsort(-df_global[heavy],
                                         kind="stable")[:h_cap]]
                print(f"[bm25] Note: heavy-term sidecar capped at "
                      f"{h_cap} of {int((df_global >= thresh).sum())} "
                      f"terms over df>={thresh} "
                      f"(HEAVY_SIDECAR_BUDGET_MB="
                      f"{self.HEAVY_SIDECAR_BUDGET_MB}); the rest stay "
                      "on the postings walk.", flush=True)
            heavy = np.sort(heavy)
            h_pad = _round_up(heavy.size, 128)
            dense = np.zeros((sr, h_pad), np.float32)
            row_of = np.full(n_vocab, -1, np.int32)
            row_of[heavy] = np.arange(heavy.size, dtype=np.int32)
            for h, t in enumerate(heavy):
                lo, hi = o[t], o[t + 1]
                dense[d[lo:hi], h] = i[lo:hi]
            self.heavy_cols = self._dev(dense)
            self.heavy_rows = self._dev(dense.T)
            self.heavy_row_of = row_of

    def _order_slots_by_df(self, q_terms: np.ndarray, q_weights: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray,
                                      Tuple[int, ...], np.ndarray]:
        """Sort each query's term slots by df descending (PAD last) and
        size per-slot gather windows from the batch's actual dfs (slot s
        needs ceil(max s-th-largest df / window) windows, pow2-bucketed).
        Scoring is additive over slots, so the reorder never changes
        results.  Heavy-sidecar terms need no windows and come back in
        q_heavy_idx [Q, T] (sidecar row or -1)."""
        v = len(self.term_df_bound)
        safe = np.clip(q_terms, 0, v - 1)
        df = np.where(q_terms == PAD_TERM, np.int64(-1),
                      self.term_df_bound[safe])
        if self.heavy_row_of is not None:
            hrow = np.where(q_terms == PAD_TERM, np.int32(-1),
                            self.heavy_row_of[safe])
            df = np.where(hrow >= 0, np.int64(-1), df)
        else:
            hrow = np.full_like(q_terms, -1)
        order = np.argsort(-df, axis=1, kind="stable")
        q_terms = np.take_along_axis(q_terms, order, axis=1)
        q_weights = np.take_along_axis(q_weights, order, axis=1)
        hrow = np.take_along_axis(hrow, order, axis=1)
        dfmax = np.take_along_axis(df, order, axis=1).max(axis=0)
        w_slots = []
        for d in dfmax:
            if d <= 0:
                w_slots.append(0)
                continue
            need = -(-int(d) // self.POSTINGS_WINDOW)
            ws = 1
            while ws < need:
                ws *= 2
            w_slots.append(ws)
        return q_terms, q_weights, tuple(w_slots), hrow

    def _merge_window_profile(self, w_slots: Tuple[int, ...]
                              ) -> Tuple[int, ...]:
        """Per-index window profile that only grows (elementwise max of the
        needs seen), reused while it fits the candidate budget.  Larger
        windows are exact (gathers are masked by each term's df).  In the
        JAX package a stable profile saves jit recompiles; here it keeps
        the candidate tensors' shapes, and so the caching allocator's
        blocks, the same batch to batch."""
        prof = self._w_profile
        if prof is not None and len(prof) == len(w_slots):
            merged = tuple(max(a, b) for a, b in zip(prof, w_slots))
        else:
            merged = tuple(w_slots)
        if sum(merged) * self.POSTINGS_WINDOW <= self._candidate_budget():
            self._w_profile = list(merged)
            return merged
        # an oversized merge would trip the budget that each need alone
        # respected: run this batch at its own need, leave the profile
        return tuple(w_slots)

    # ------------------------------------------------------------- search
    def encode_queries(self, queries: Sequence[str]
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Analyzed query terms -> (term ids [Q, T], multiplicity weights)."""
        toks_batch = analyze_texts(list(queries))
        t_cap = self.max_query_terms
        q_terms = np.full((len(queries), t_cap), PAD_TERM, np.int32)
        q_weights = np.zeros((len(queries), t_cap), np.float32)
        for i, toks in enumerate(toks_batch):
            counts: Dict[int, int] = {}
            for t in toks:
                tid = self.vocab.get(t)
                if tid is not None:
                    counts[tid] = counts.get(tid, 0) + 1
            if len(counts) > t_cap:
                print(f"[bm25] WARNING: query {i} has {len(counts)} "
                      f"distinct indexed terms; keeping the first {t_cap} "
                      "(max_query_terms) in appearance order — dropped "
                      "terms contribute no score, which deviates from "
                      "Lucene. Build the index with a larger "
                      "max_query_terms to cover it.", flush=True)
            for jcol, (tid, c) in enumerate(list(counts.items())[:t_cap]):
                q_terms[i, jcol] = tid
                q_weights[i, jcol] = c
        return q_terms, q_weights

    # queries per engine call
    QUERY_CHUNK = 32

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def search(self, queries: Sequence[str], top_k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (indices [Q,k], scores [Q,k]); non-matching slots are
        index -1 / score -inf (Lucene only returns matching docs)."""
        if len(queries) > self.QUERY_CHUNK:
            parts = [self.search(queries[i:i + self.QUERY_CHUNK], top_k)
                     for i in range(0, len(queries), self.QUERY_CHUNK)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        with span("sdag.bm25.encode"):
            q_terms, q_weights = self.encode_queries(queries)
            use_postings = self.engine == "postings"
            use_heavy = False
            if use_postings:
                q_terms, q_weights, w_slots, q_heavy = \
                    self._order_slots_by_df(q_terms, q_weights)
                use_heavy = self.heavy_cols is not None and bool(
                    (q_heavy >= 0).any())
                m_total = sum(w_slots) * self.POSTINGS_WINDOW
                if m_total > self._candidate_budget():
                    print(f"[bm25] Note: batch query terms sum to {m_total} "
                          f"postings candidates (> budget "
                          f"{self._candidate_budget()}); the postings "
                          "walk would be costlier than a flat scan — "
                          "falling back to the scan engine for this batch.",
                          flush=True)
                    use_postings = False
                else:
                    w_slots = self._merge_window_profile(w_slots)
        # the span of the device call names the engine this chunk took
        engine = ("hybrid" if use_heavy else "postings") if use_postings \
            else "scan"
        if self.n_shards > 1:
            engine = "sharded_" + engine
        with span("sdag.bm25." + engine):
            qt, qw = self._dev(q_terms), self._dev(q_weights)
            if engine == "sharded_hybrid":
                vals, idx = sharded_bm25_hybrid_topk(
                    self.post_docs, self.post_imps, self.post_offsets,
                    self.heavy_cols, self.heavy_rows, qt, qw,
                    self._dev(q_heavy), top_k, w_slots=w_slots,
                    window=self.POSTINGS_WINDOW, mesh=self.mesh,
                    rows_per_shard=self.rows_per_shard)
            elif engine == "sharded_postings":
                vals, idx = sharded_bm25_postings_topk(
                    self.post_docs, self.post_imps, self.post_offsets, qt,
                    qw, top_k, w_slots=w_slots, window=self.POSTINGS_WINDOW,
                    mesh=self.mesh, rows_per_shard=self.rows_per_shard)
            elif engine == "sharded_scan":
                vals, idx = sharded_bm25_topk(self.term_ids, self.impacts,
                                              qt, qw, top_k,
                                              valid_n=self.valid_n,
                                              mesh=self.mesh)
            elif engine == "hybrid":
                vals, idx = bm25_hybrid_topk(
                    self.post_docs, self.post_imps, self.post_offsets,
                    self.heavy_cols, self.heavy_rows, qt, qw,
                    self._dev(q_heavy), top_k, w_slots=w_slots,
                    window=self.POSTINGS_WINDOW)
            elif engine == "postings":
                vals, idx = bm25_postings_topk(
                    self.post_docs, self.post_imps, self.post_offsets, qt,
                    qw, top_k, w_slots=w_slots, window=self.POSTINGS_WINDOW)
            else:
                vals, idx = bm25_topk_dispatch(self.term_ids, self.impacts,
                                               qt, qw, top_k,
                                               valid_n=self.valid_n)
            vals = vals.cpu().numpy().copy()
            idx = idx.cpu().numpy().copy()
        no_hit = vals <= 0.0
        idx[no_hit] = -1
        vals[no_hit] = float("-inf")
        return idx, vals

    def materialize(self, indices, scores):
        return materialize_hits(self.meta, indices, scores,
                                invalid_score=float("-inf"))

    # --------------------------------------------------------------- I/O
    def save(self, index_dir: str) -> None:
        """Every rank calls it (the shards are gathered); rank 0
        writes."""
        term_ids = gather_rows(self.term_ids, self.mesh)[: self.valid_n]
        impacts = gather_rows(self.impacts, self.mesh)[: self.valid_n]
        if not is_writer():
            return
        os.makedirs(index_dir, exist_ok=True)
        arrays = {"term_ids": term_ids.cpu().numpy(),
                  "impacts": impacts.cpu().numpy()}
        if self.idf is not None:  # savez would pickle a None into an
            arrays["idf"] = self.idf  # object array load() cannot read
        np.savez(os.path.join(index_dir, "postings.npz"), **arrays)
        with open(os.path.join(index_dir, "vocab.json"), "w") as f:
            json.dump(self.vocab, f)
        with open(os.path.join(index_dir, "meta.jsonl"), "w",
                  encoding="utf-8") as f:
            for m in self.meta:
                f.write(json.dumps(m, ensure_ascii=False) + "\n")
        with open(os.path.join(index_dir, "manifest.json"), "w") as f:
            json.dump({"k1": self.k1, "b": self.b, "avgdl": self.avgdl,
                       "n": self.valid_n,
                       "max_query_terms": self.max_query_terms}, f)

    @classmethod
    def from_packed(cls, term_ids: np.ndarray, impacts: np.ndarray,
                    vocab: Dict[str, int], *, meta=None, idf=None,
                    k1: float = 0.9, b: float = 0.4, avgdl: float = 1.0,
                    valid_n: Optional[int] = None,
                    engine: str = "postings",
                    max_query_terms: int = 32,
                    device="cuda", mesh=None) -> "BM25Index":
        """Construct around precomputed packed [N, Lp] (term_id, impact)
        arrays: the path for load() and for synthetic postings."""
        if engine not in {"postings", "scan"}:
            raise ValueError(f"Unknown BM25 engine: {engine}")
        obj = cls.__new__(cls)
        obj.device = resolve_device(device)
        obj._set_mesh(mesh)
        obj.engine = engine
        obj.vocab = dict(vocab)
        obj.meta = meta if meta is not None else []
        obj.idf = idf
        obj.k1, obj.b = float(k1), float(b)
        obj.avgdl = float(avgdl)
        obj.valid_n = int(valid_n if valid_n is not None
                          else term_ids.shape[0])
        obj.max_query_terms = max_query_terms
        n_pad = _round_up(max(term_ids.shape[0], 1),
                          cls.ROW_BLOCK * obj.n_shards)
        if n_pad != term_ids.shape[0]:
            pad = ((0, n_pad - term_ids.shape[0]), (0, 0))
            term_ids = np.pad(term_ids, pad, constant_values=PAD_TERM)
            impacts = np.pad(impacts, pad)
        obj._place(np.ascontiguousarray(term_ids, np.int32),
                   np.ascontiguousarray(impacts, np.float32))
        return obj

    @classmethod
    def load(cls, index_dir: str, engine: str = "postings", device="cuda",
             mesh=None) -> "BM25Index":
        data = np.load(os.path.join(index_dir, "postings.npz"))
        with open(os.path.join(index_dir, "vocab.json")) as f:
            vocab = json.load(f)
        meta = []
        with open(os.path.join(index_dir, "meta.jsonl"),
                  encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    meta.append(json.loads(line))
        with open(os.path.join(index_dir, "manifest.json")) as f:
            man = json.load(f)
        return cls.from_packed(
            data["term_ids"], data["impacts"], vocab, meta=meta,
            idf=data["idf"] if "idf" in data.files else None,
            k1=man["k1"], b=man["b"], avgdl=man["avgdl"],
            valid_n=man["n"],
            max_query_terms=man.get("max_query_terms", 32),
            engine=engine, device=device, mesh=mesh)

    @classmethod
    def from_texts(cls, texts: List[str], ids: List[str],
                   **kw) -> "BM25Index":
        meta = [{"id": i, "text": t} for i, t in zip(ids, texts)]
        # native fast path: analyze + vocab + tf counting in one C++ pass;
        # identical result to the analyzer + Python counter path (tested)
        from sdag_tpu_torch.retrieval.analyzer import build_counts_native
        counts = build_counts_native(texts)
        if counts is not None:
            return cls(None, meta, counts=counts, **kw)
        return cls(analyze_texts(texts), meta, **kw)


class SparseRetriever(Retriever):
    """BM25 lexical retrieval (reference contract ``sparse.py:111-159``)."""

    def __init__(self, index: BM25Index) -> None:
        self.index = index

    def retrieve_batch(self, queries: Sequence[str], max_k_needed: int,
                       embed_batch_size: int) -> RetrievalBatch:
        idx, scores = self.index.search(queries, top_k=max_k_needed)
        with span("sdag.bm25.materialize"):
            texts, ids_, scs = self.index.materialize(idx, scores)
        return RetrievalBatch(q_embs=[None] * len(queries),
                              docs_texts_full=texts, ids_full=ids_,
                              scores_full=scs)
