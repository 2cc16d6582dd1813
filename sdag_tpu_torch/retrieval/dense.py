"""Dense retrieval: device-resident embedding index + fused top-k search.

Counterpart of ``sdag_tpu/retrieval/dense.py`` (itself replacing the
reference's FAISS flat index, ``src/pipeline/retrieval/dense.py:15-178``):
the corpus embedding matrix lives on the device, queries are scored with
the fused matmul+top-k kernels (``ops/topk.py``), and hits are materialized
from a JSONL metadata manifest with the same ""/"NA" fallbacks for invalid
indices.  One device, one shard: sharded search belongs to the
torch.distributed port of the parallel paths.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sdag_tpu_torch.datamodels import RetrievalBatch
from sdag_tpu_torch.ops.topk import (approx_topk_matmul_int8,
                                     fused_topk_matmul_int8,
                                     quantize_last_axis_int8,
                                     rescored_topk_int8, topk_search)
from sdag_tpu_torch.retrieval.retriever import Retriever, materialize_hits
from sdag_tpu_torch.utils.device import resolve_device
from sdag_tpu_torch.utils.mathutil import round_up as _round_up

INDEX_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


def _one_shard_only(mesh=None, n_shards: int = 1) -> None:
    if mesh is not None or n_shards > 1:
        raise NotImplementedError(
            "sdag_tpu_torch serves one dense-index shard on one device; a "
            "mesh / n_shards > 1 (sharded_topk_search) is ROADMAP.md Queue "
            "A, 'TP/DP on torch.distributed'")


class DenseIndex:
    """Flat exact inner-product index over normalized embeddings.

    Rows are padded to a multiple of block_n (kept from the JAX package so
    index directories stay interchangeable); searches mask the padding
    through ``valid_n``.
    """

    def __init__(self, embeddings: np.ndarray, meta: List[Dict[str, Any]],
                 mesh=None, block_n: int = 1024,
                 dtype: torch.dtype = torch.float32,
                 search_mode: str = "approx", int8_rescore: bool = True,
                 device="cuda", n_shards: int = 1) -> None:
        _one_shard_only(mesh, n_shards)
        if embeddings.ndim != 2:
            raise ValueError("embeddings must be [N, D]")
        if len(meta) != embeddings.shape[0]:
            raise ValueError("meta length must match embedding rows")
        if search_mode not in {"approx", "exact"}:
            raise ValueError(f"Unknown search_mode: {search_mode}")
        if dtype not in INDEX_DTYPES.values():
            raise ValueError(f"Unknown index dtype {dtype}: expected one of "
                             f"{sorted(INDEX_DTYPES)}")
        self.device = resolve_device(device)
        self.meta = meta
        self.valid_n = embeddings.shape[0]
        self.dim = embeddings.shape[1]
        self.block_n = block_n
        self.n_shards = 1
        self.quantized = dtype == torch.int8
        # "approx": matmul + candidate list + exact merge, plain PyTorch
        # (exact on this port).  "exact": kernels K4/K5 on CUDA, exact
        # (score desc, index asc).
        self.search_mode = search_mode

        # max(., 1): an empty corpus still builds a 1-row padded index
        # whose searches return all -1/-inf (same guard as BM25Index)
        n_pad = _round_up(max(self.valid_n, 1), block_n)
        padded = torch.zeros((n_pad, self.dim), dtype=torch.float32,
                             device=self.device)
        padded[: self.valid_n] = torch.from_numpy(
            np.ascontiguousarray(embeddings, dtype=np.float32))
        self.resid = None
        self.resid_scales = None
        self.scales = None
        # rescore exists only on the approx path (the exact kernel scores
        # from the int8 base alone): building residuals in exact mode
        # would double index memory for arrays search() never reads
        self.int8_rescore = (bool(int8_rescore) and self.quantized
                             and search_mode == "approx")
        if bool(int8_rescore) and self.quantized and search_mode == "exact":
            print("[dense] Note: DENSE_INT8_RESCORE has no effect with "
                  "DENSE_SEARCH_MODE=exact (the exact kernel scores the "
                  "int8 base directly); residuals are not built. Use "
                  "search_mode='approx' for rescored recall.", flush=True)
        if self.quantized:
            # int8 base (4x less memory than f32); with int8_rescore an
            # int8 residual beside it: the coarse scan reads only the base
            # and candidates are rescored at ~15-bit precision
            self.embeddings, self.scales = quantize_last_axis_int8(padded)
            if self.int8_rescore:
                resid = padded - self.embeddings.float() \
                    * self.scales[:, None]
                self.resid, self.resid_scales = quantize_last_axis_int8(resid)
        else:
            self.embeddings = padded.to(dtype)

    # ------------------------------------------------------------- search
    def search_device(self, q: torch.Tensor, top_k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k over query embeddings already on the index' device.
        Returns (scores [Q,k] f32, indices [Q,k] int32)."""
        if self.quantized:
            if self.search_mode == "approx" and self.int8_rescore:
                return rescored_topk_int8(
                    q, self.embeddings, self.scales, self.resid,
                    self.resid_scales, top_k, valid_n=self.valid_n)
            if self.search_mode == "approx":
                return approx_topk_matmul_int8(
                    q, self.embeddings, self.scales, top_k,
                    valid_n=self.valid_n)
            # exact mode: kernel K5 on CUDA, its plain version on the CPU
            return fused_topk_matmul_int8(q, self.embeddings, self.scales,
                                          top_k, valid_n=self.valid_n)
        return topk_search(q, self.embeddings, top_k, valid_n=self.valid_n,
                           mode=self.search_mode)

    def search(self, query_embeddings: np.ndarray, top_k: int
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k inner-product search.  Returns (indices [Q,k], scores [Q,k]);
        same return convention as the reference's ``search_index``."""
        q = torch.from_numpy(np.ascontiguousarray(
            query_embeddings, dtype=np.float32)).to(self.device)
        vals, idx = self.search_device(q, top_k)
        return idx.cpu().numpy(), vals.cpu().numpy()

    def materialize(self, indices: Sequence[Sequence[int]],
                    scores: Sequence[Sequence[float]]
                    ) -> Tuple[List[List[str]], List[List[str]],
                               List[List[float]]]:
        """Turn raw (index, score) hits into texts/ids/scores with ""/"NA"
        fallbacks for invalid rows."""
        return materialize_hits(self.meta, indices, scores)

    # --------------------------------------------------------------- I/O
    def save(self, index_dir: str) -> None:
        """Persist as embeddings.npy + meta.jsonl + manifest.json, always
        float32 (bf16/int8 are device storage choices)."""
        os.makedirs(index_dir, exist_ok=True)
        emb = self.embeddings[: self.valid_n].float()
        if self.quantized:
            emb = emb * self.scales[: self.valid_n, None]
            if self.resid is not None:
                emb = emb + (self.resid[: self.valid_n].float()
                             * self.resid_scales[: self.valid_n, None])
        np.save(os.path.join(index_dir, "embeddings.npy"),
                emb.cpu().numpy())
        with open(os.path.join(index_dir, "meta.jsonl"), "w",
                  encoding="utf-8") as f:
            for m in self.meta:
                f.write(json.dumps(m, ensure_ascii=False) + "\n")
        with open(os.path.join(index_dir, "manifest.json"), "w") as f:
            json.dump({"n": self.valid_n, "dim": self.dim,
                       "block_n": self.block_n}, f)

    @classmethod
    def load(cls, index_dir: str, mesh=None, meta_path: Optional[str] = None,
             dtype: torch.dtype = torch.float32, search_mode: str = "approx",
             int8_rescore: bool = True, device="cuda") -> "DenseIndex":
        emb = np.load(os.path.join(index_dir, "embeddings.npy"))
        meta = load_meta_jsonl(meta_path
                               or os.path.join(index_dir, "meta.jsonl"))
        manifest_path = os.path.join(index_dir, "manifest.json")
        block_n = 1024
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                block_n = json.load(f).get("block_n", 1024)
        return cls(emb, meta, mesh=mesh, block_n=block_n, dtype=dtype,
                   search_mode=search_mode, int8_rescore=int8_rescore,
                   device=device)

    @classmethod
    def from_texts(cls, texts: List[str], ids: List[str], encoder,
                   mesh=None, batch_size: int = 64, block_n: int = 1024,
                   dtype: torch.dtype = torch.float32,
                   search_mode: str = "approx", int8_rescore: bool = True,
                   device="cuda") -> "DenseIndex":
        """Build the index by encoding passages (E5 'passage: ' rule lives in
        the encoder)."""
        emb = encoder.encode(texts, kind="passage", batch_size=batch_size)
        meta = [{"id": i, "text": t} for i, t in zip(ids, texts)]
        return cls(np.asarray(emb), meta, mesh=mesh, block_n=block_n,
                   dtype=dtype, search_mode=search_mode,
                   int8_rescore=int8_rescore, device=device)


def load_meta_jsonl(path: str) -> List[Dict[str, Any]]:
    if not os.path.exists(path):
        raise FileNotFoundError(f"Metadata jsonl not found at {path}")
    meta: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                meta.append(json.loads(line))
    return meta


class DenseRetriever(Retriever):
    """Encode queries -> fused top-k search -> materialized hits."""

    def __init__(self, encoder, index: DenseIndex) -> None:
        self.encoder = encoder
        self.index = index

    def retrieve_batch(self, queries: Sequence[str], max_k_needed: int,
                       embed_batch_size: int) -> RetrievalBatch:
        q_embs = self.encoder.encode(list(queries), kind="query",
                                     batch_size=embed_batch_size)
        q_embs = np.asarray(q_embs, dtype=np.float32)
        indices, scores = self.index.search(q_embs, top_k=max_k_needed)
        texts, ids_, scs = self.index.materialize(indices, scores)
        return RetrievalBatch(q_embs=list(q_embs), docs_texts_full=texts,
                              ids_full=ids_, scores_full=scs)
