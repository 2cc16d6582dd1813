"""Collectives over a mesh axis, and the sharded-index engines.

Counterpart of ``sdag_tpu/parallel/collectives.py``.  Each rank runs the
top-k engine on its block of corpus rows (kernels K4/K5 for exact dense
search and K2 for the BM25 scan on CUDA), candidates are all-gathered over
the index group, and the merge is order-stable (score desc, global index
asc), so sharded results equal a one-device exact scan.

The collective helpers take the axis' process group (None: one rank, no
process group; the helper is the identity).  A backend that cannot carry a
collective on CUDA tensors gets it staged through host memory, by one
explicit rule keyed on the backend (``staged``): gloo carries CPU tensors
only for all-gather and send/recv, and bf16 reductions not at all on some
builds, so every gloo collective of a CUDA tensor is staged.  NCCL carries
them all on the device (and inside a captured CUDA graph).  ``CALLS``
counts collectives by (backend, op, "host" | "device").
"""

from __future__ import annotations

import collections
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from sdag_tpu_torch.core.mesh import Mesh
from sdag_tpu_torch.ops.topk import (NEG_INF, approx_topk_matmul_int8,
                                     fused_topk_matmul_int8, merge_topk,
                                     rescored_topk_int8, topk_search)

INT32_MAX = torch.iinfo(torch.int32).max

CALLS: collections.Counter = collections.Counter()


def staged(group, t: torch.Tensor) -> bool:
    """The staging rule: a CUDA tensor on a gloo group goes through host
    memory; everything else is carried where it lies."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _count(group, op: str, host: bool) -> None:
    CALLS[(dist.get_backend(group), op, "host" if host else "device")] += 1


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """In-place all-reduce of x over ``group``; returns x."""
    if group is None:
        return x
    host = staged(group, x)
    _count(group, "all_reduce", host)
    if host:
        h = x.cpu()
        dist.all_reduce(h, op=op, group=group)
        x.copy_(h)
    else:
        dist.all_reduce(x, op=op, group=group)
    return x


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' x concatenated along ``dim`` in group-rank order (JAX
    ``all_gather(..., tiled=True)``)."""
    if group is None:
        return x
    host = staged(group, x)
    _count(group, "all_gather", host)
    src = x.cpu() if host else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if host else out


def ring_shift(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Send each tensor to the next rank of ``group`` and receive the
    previous rank's (JAX ``ppermute`` with perm d -> d+1)."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    host = staged(group, tensors[0])
    ops, outs = [], []
    for t in tensors:
        _count(group, "send_recv", host)
        src = t.cpu() if host else t.contiguous()
        out = torch.empty_like(src)
        ops.append(dist.P2POp(dist.isend, src, nxt, group))
        ops.append(dist.P2POp(dist.irecv, out, prv, group))
        outs.append(out)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if host:
        return [o.to(t.device) for o, t in zip(outs, tensors)]
    return outs


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str = "index"
                ) -> torch.Tensor:
    """A row-sharded tensor whole again (every rank gets it)."""
    return all_gather_cat(x, mesh.group(axis), dim=0)


def _gather_merge(vals, idx, row0: int, k: int, group, hit=None):
    """The ONE sentinel/all-gather/merge convention every sharded engine
    shares: per-shard (vals, idx) become global candidates (a real slot
    keeps its score and gets idx + row0, an empty one becomes (-inf,
    INT32_MAX)), are all-gathered along the candidate axis and merged
    (score desc, global index asc); slots still empty become -1.

    hit: bool [Q, k] marking real candidates; default idx >= 0 (the dense
    and postings contract); the scan engine passes vals > 0 (docs with no
    query-term match score 0 there)."""
    if hit is None:
        hit = idx >= 0
    gvals = torch.where(hit, vals, NEG_INF)
    gidx = torch.where(hit, idx + row0, INT32_MAX).to(torch.int32)
    vals_all = all_gather_cat(gvals.float().contiguous(), group, dim=1)
    gidx_all = all_gather_cat(gidx.contiguous(), group, dim=1)
    mv, mi = merge_topk(vals_all, gidx_all, k)
    return mv, torch.where(torch.isneginf(mv), -1, mi).to(torch.int32)


def _shard_geometry(n_rows_local: int, valid_n: int, mesh: Mesh, axis: str):
    row0 = mesh.rank(axis) * n_rows_local
    local_valid = min(max(valid_n - row0, 0), n_rows_local)
    return row0, local_valid


def local_topk_search(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                      valid_n: int, scales=None, mode: str = "exact",
                      resid=None, resid_scales=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over one block of corpus rows: the ONE dispatch of the dense
    engines.  With ``scales`` the corpus is int8 (per-row scales); with
    ``resid``/``resid_scales`` beside it candidates are rescored.
    mode="exact" runs K4 (float) or K5 (int8) on CUDA; "approx" and the
    rescore run the port's plain searches.  Returns (scores [Q, k] f32,
    block-local indices [Q, k] int32, -1 for an empty slot)."""
    if resid is not None or resid_scales is not None:
        # guard every incomplete combination, not just mode: resid with
        # scales=None would fall into the float branch below and silently
        # drop the residuals the caller paid memory for
        if mode != "approx":
            raise ValueError(
                "resid/resid_scales require mode='approx': the exact int8 "
                "kernel scores the base alone, so a silent fall-through "
                "would return ~0.98-recall results while the caller paid "
                "HBM for the ~1.0 rescored path")
        if scales is None or resid is None or resid_scales is None:
            raise ValueError(
                "the rescored path needs ALL of scales/resid/resid_scales "
                "(int8 base + int8 residual, per-row scales); a partial "
                "set would silently score the base alone")
    if scales is None:
        return topk_search(queries, corpus, k, valid_n=valid_n, mode=mode)
    if resid is not None:
        return rescored_topk_int8(queries, corpus, scales, resid,
                                  resid_scales, k, valid_n=valid_n)
    if mode == "approx":
        return approx_topk_matmul_int8(queries, corpus, scales, k,
                                       valid_n=valid_n)
    return fused_topk_matmul_int8(queries, corpus, scales, k,
                                  valid_n=valid_n)


def sharded_topk_search(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                        valid_n: int, mesh: Mesh, axis: str = "index",
                        scales=None, mode: str = "exact", resid=None,
                        resid_scales=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a row-sharded corpus.

    queries: [Q, D] on every rank; corpus: this rank's [N_pad / n, D]
    rows (N_pad divisible by the axis size); valid_n: real rows overall.
    Each rank runs ``local_topk_search`` on its block and the candidates
    are merged by ``_gather_merge``; on a one-rank axis the block is the
    whole corpus and its result is returned as it is.  Returns (scores
    [Q, k] f32, global indices [Q, k] int32) on every rank.
    """
    row0, local_valid = _shard_geometry(corpus.shape[0], valid_n, mesh,
                                        axis)
    vals, idx = local_topk_search(queries, corpus, k, local_valid,
                                  scales=scales, mode=mode, resid=resid,
                                  resid_scales=resid_scales)
    if mesh.shape[axis] == 1:
        return vals, idx
    return _gather_merge(vals, idx, row0, k, mesh.group(axis))


def sharded_bm25_topk(term_ids: torch.Tensor, impacts: torch.Tensor,
                      q_terms: torch.Tensor, q_weights: torch.Tensor, k: int,
                      valid_n: int, mesh: Mesh, axis: str = "index"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact BM25 top-k over row-sharded packed postings: this rank's
    [N_pad / n, T] rows scored by the scan engine (K2 on CUDA), candidates
    all-gathered and merged (score desc, global index asc).  Docs with no
    query-term match score 0 and come back as (-inf, -1)."""
    from sdag_tpu_torch.ops.bm25 import bm25_topk_dispatch
    row0, local_valid = _shard_geometry(term_ids.shape[0], valid_n, mesh,
                                        axis)
    vals, idx = bm25_topk_dispatch(term_ids, impacts, q_terms, q_weights, k,
                                   valid_n=local_valid)
    return _gather_merge(vals, idx, row0, k, mesh.group(axis),
                         hit=vals > 0.0)


def sharded_bm25_postings_topk(post_docs, post_imps, offsets, q_terms,
                               q_weights, k: int, w_slots, mesh: Mesh,
                               rows_per_shard: int, window: int = 512,
                               axis: str = "index"):
    """Exact BM25 top-k over per-shard CSR postings (the O(sum df)
    engine): this rank's CSR holds LOCAL doc ids of its row block
    [rank * rows_per_shard, (rank + 1) * rows_per_shard); ids are mapped
    to global ones and candidates merged like the dense path."""
    from sdag_tpu_torch.ops.bm25 import bm25_postings_topk
    vals, idx = bm25_postings_topk(post_docs, post_imps, offsets, q_terms,
                                   q_weights, k, w_slots=w_slots,
                                   window=window)
    return _gather_merge(vals, idx, mesh.rank(axis) * rows_per_shard, k,
                         mesh.group(axis))


def sharded_bm25_hybrid_topk(post_docs, post_imps, offsets, heavy_cols,
                             heavy_rows, q_terms, q_weights, q_heavy_idx,
                             k: int, w_slots, mesh: Mesh,
                             rows_per_shard: int, window: int = 512,
                             axis: str = "index"):
    """Sharded heavy/light hybrid BM25: this rank scores its row block,
    heavy terms against its dense sidecar slice, tail terms against its
    local CSR; candidates merged like the dense path."""
    from sdag_tpu_torch.ops.bm25 import bm25_hybrid_topk
    vals, idx = bm25_hybrid_topk(post_docs, post_imps, offsets, heavy_cols,
                                 heavy_rows, q_terms, q_weights, q_heavy_idx,
                                 k, w_slots=w_slots, window=window)
    return _gather_merge(vals, idx, mesh.rank(axis) * rows_per_shard, k,
                         mesh.group(axis))


def group_backend(group) -> Optional[str]:
    """The backend of a group, None without a process group."""
    return None if group is None else dist.get_backend(group)
