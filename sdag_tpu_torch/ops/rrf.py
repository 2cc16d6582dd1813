"""Device-side reciprocal-rank fusion for hybrid retrieval (PyTorch).

Counterpart of ``sdag_tpu/ops/rrf.py``: fuses dense and sparse rankings as
one small tensor op over global corpus indices.  Semantics match the host
fuser (``retrieval/hybrid.py``): RRF score sum 1/(k0+rank), dedup by doc
identity (global index here), order (score desc, sparse-candidates-first
stable), invalid slots (index < 0, Lucene no-match padding) excluded.
Reference behavior: ``src/pipeline/retrieval/hybrid.py:30-105``.  Plain
PyTorch ops (XLA in the JAX package, so no hand kernel is owed).
"""

from __future__ import annotations

import torch

BIG = 1 << 30


def _first_rank(cands: torch.Tensor, ranked: torch.Tensor,
                k_take: torch.Tensor) -> torch.Tensor:
    """For each candidate, its 1-based rank in `ranked` (only the first
    k_take slots count), or 0 when absent.  cands: [Q, T]; ranked: [Q, K];
    k_take: [Q]."""
    K = ranked.shape[1]
    pos_iota = torch.arange(K, dtype=torch.int32,
                            device=ranked.device)[None, None, :]     # 1,1,K
    eq = (ranked[:, None, :] == cands[:, :, None]) \
        & (ranked[:, None, :] >= 0) \
        & (pos_iota < k_take[:, None, None])                         # Q,T,K
    pos = torch.where(eq, pos_iota, BIG).amin(-1)                    # Q,T
    return torch.where(eq.any(-1), pos + 1, 0)


def rrf_fuse_topk(sparse_idx: torch.Tensor, dense_idx: torch.Tensor,
                  k_sparse: torch.Tensor, k_dense: torch.Tensor,
                  k0: int = 60, top_k: int = 10):
    """Fuse per-query rankings of global corpus indices.

    sparse_idx/dense_idx: [Q, K] int32, -1 = no hit; k_sparse/k_dense: [Q]
    per-query rank cutoffs (the seeded odd-k split happens on host).
    Returns (fused_idx [Q, top_k] with -1 padding, fused_scores [Q, top_k]
    float32 with -inf padding).
    """
    dev = sparse_idx.device
    sparse_idx = sparse_idx.to(torch.int32)
    dense_idx = dense_idx.to(torch.int32)
    Ks, Kd = sparse_idx.shape[1], dense_idx.shape[1]
    s_cut = k_sparse.to(torch.int32).clamp(max=Ks)
    d_cut = k_dense.to(torch.int32).clamp(max=Kd)

    cand = torch.cat([sparse_idx, dense_idx], dim=1)                 # Q,T
    T = Ks + Kd
    slot = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
    in_window = torch.where(slot < Ks, slot < s_cut[:, None],
                            (slot - Ks) < d_cut[:, None])
    valid = (cand >= 0) & in_window

    r_s = _first_rank(cand, torch.where(
        torch.arange(Ks, device=dev)[None, :] < s_cut[:, None],
        sparse_idx, -1), s_cut)
    r_d = _first_rank(cand, torch.where(
        torch.arange(Kd, device=dev)[None, :] < d_cut[:, None],
        dense_idx, -1), d_cut)
    one = torch.ones((), dtype=torch.float32, device=dev)
    score = (torch.where(r_s > 0, one / (k0 + r_s), 0.0)
             + torch.where(r_d > 0, one / (k0 + r_d), 0.0))

    # dedup: keep only the first slot holding each index
    same = (cand[:, :, None] == cand[:, None, :]) & valid[:, None, :]
    first_pos = torch.where(same, slot[:, None, :], BIG).amin(-1)
    keep = valid & (first_pos == slot)

    score = torch.where(keep, score, float("-inf"))
    order = torch.sort(score, dim=1, descending=True,
                       stable=True).indices[:, :top_k]
    fused_scores = torch.gather(score, 1, order)
    fused_idx = torch.where(torch.isfinite(fused_scores),
                            torch.gather(cand, 1, order), -1)
    if order.shape[1] < top_k:      # fewer candidates than top_k slots
        pad = top_k - order.shape[1]
        fused_scores = torch.nn.functional.pad(fused_scores, (0, pad),
                                               value=float("-inf"))
        fused_idx = torch.nn.functional.pad(fused_idx, (0, pad), value=-1)
    return fused_idx, fused_scores
