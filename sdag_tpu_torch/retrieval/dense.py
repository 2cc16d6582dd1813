"""Dense retrieval: device-resident embedding index + fused top-k search.

Counterpart of ``sdag_tpu/retrieval/dense.py`` (itself replacing the
reference's FAISS flat index, ``src/pipeline/retrieval/dense.py:15-178``):
the corpus embedding matrix lives on the device, queries are scored with
the fused matmul+top-k kernels (``ops/topk.py``), and hits are materialized
from a JSONL metadata manifest with the same ""/"NA" fallbacks for invalid
indices.  Over an index mesh of n ranks (``core/mesh.py``) each rank holds
one block of the padded rows and search merges the per-shard top-k
(``parallel/collectives.py`` ``sharded_topk_search``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sdag_tpu_torch.core.mesh import is_writer, make_index_mesh
from sdag_tpu_torch.datamodels import RetrievalBatch
from sdag_tpu_torch.ops.topk import quantize_last_axis_int8
from sdag_tpu_torch.parallel.collectives import (gather_rows,
                                                 sharded_topk_search)
from sdag_tpu_torch.retrieval.retriever import Retriever, materialize_hits
from sdag_tpu_torch.utils.device import resolve_device
from sdag_tpu_torch.utils.mathutil import round_up as _round_up

INDEX_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


class DenseIndex:
    """Flat exact inner-product index over normalized embeddings.

    Rows are padded to a multiple of block_n * n_shards (the JAX
    package's rule, so index directories stay interchangeable) and this
    rank keeps its block of them along the mesh's 'index' axis (all rows
    without a process group); searches mask the padding through
    ``valid_n``.
    """

    def __init__(self, embeddings: np.ndarray, meta: List[Dict[str, Any]],
                 mesh=None, block_n: int = 1024,
                 dtype: torch.dtype = torch.float32,
                 search_mode: str = "approx", int8_rescore: bool = True,
                 device="cuda") -> None:
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
        self.mesh = mesh if mesh is not None else make_index_mesh(
            self.device)
        self.n_shards = self.mesh.shape["index"]
        self.quantized = dtype == torch.int8
        # "approx": matmul + candidate list + exact merge, plain PyTorch
        # (exact on this port).  "exact": kernels K4/K5 on CUDA, exact
        # (score desc, index asc).
        self.search_mode = search_mode

        # max(., 1): an empty corpus still builds a 1-row padded index
        # whose searches return all -1/-inf (same guard as BM25Index)
        n_pad = _round_up(max(self.valid_n, 1), block_n * self.n_shards)
        # this rank's block of the padded rows, filled on the device from
        # its slice of the embeddings (quantization is per row, so a shard
        # quantizes as the whole matrix would)
        rows = n_pad // self.n_shards
        row0 = self.mesh.rank("index") * rows
        mine = embeddings[row0: row0 + rows]
        padded = torch.zeros((rows, self.dim), dtype=torch.float32,
                             device=self.device)
        padded[: mine.shape[0]] = torch.from_numpy(
            np.ascontiguousarray(mine, dtype=np.float32))
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
        return sharded_topk_search(
            q, self.embeddings, top_k, valid_n=self.valid_n, mesh=self.mesh,
            scales=self.scales, mode=self.search_mode, resid=self.resid,
            resid_scales=self.resid_scales)

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
        float32 (bf16/int8 are device storage choices).  Every rank calls
        it (the shards are gathered); rank 0 writes."""
        emb = self.embeddings.float()
        if self.quantized:
            emb = emb * self.scales[:, None]
            if self.resid is not None:
                emb = emb + (self.resid.float() * self.resid_scales[:, None])
        emb = gather_rows(emb, self.mesh)[: self.valid_n]
        if not is_writer():
            return
        os.makedirs(index_dir, exist_ok=True)
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
