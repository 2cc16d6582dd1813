"""Collectives over a mesh axis, and the sharded-index engines.

Counterpart of ``sdag_tpu/parallel/collectives.py``.  Each rank runs the
top-k engine on its block of corpus rows (kernels K4/K5 for exact dense
search and K2 for the BM25 scan on CUDA), candidates are all-gathered over
the index group, and the merge is order-stable (score desc, global index
asc), so sharded results equal a one-device exact scan.

The layers' collectives (``copy_to_group``, ``reduce_from_group``,
``gather_from_group``) and a pipeline's ``send_to`` / ``recv_from`` are
autograd Functions when autograd records them, so tensor-parallel and
pipelined training differentiate through them.

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


# Megatron's pair of autograd Functions for a tensor-parallel layer, and a
# differentiable all-gather: each collective runs through all_reduce_ /
# all_gather_cat, so the staging rule holds in forward and backward alike.

class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a
    column-parallel product (wq/wk/wv, gate/up, a vocab-sliced head)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial sums of a
    row-parallel product (wo, down)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """All-gather along ``dim`` forward, this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return all_gather_cat(x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size).contiguous(), \
            None, None


def _recorded(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """x for a column-parallel product: under autograd its gradient is
    all-reduced over ``group`` (the other ranks' slices of the product
    contribute to it); otherwise x itself."""
    if group is None or not _recorded(x):
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over ``group`` (a row-parallel product's partial
    sums); in place when autograd does not record it (serving, and inside
    a captured decode step)."""
    if group is None:
        return x
    if not _recorded(x):
        return all_reduce_(x, group)
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int = -1
                      ) -> torch.Tensor:
    """``all_gather_cat`` whose gradient is this rank's slice."""
    if group is None:
        return x
    if not _recorded(x):
        return all_gather_cat(x, group, dim=dim)
    return _GatherFromGroup.apply(x, group, dim % x.dim())


def all_reduce_grads_(tensors: List[torch.Tensor], group) -> None:
    """Sum tensors (gradients) over ``group`` in place, as one flat
    all-reduce per dtype."""
    if group is None or not tensors:
        return
    for dt in sorted({t.dtype for t in tensors}, key=str):
        ts = [t for t in tensors if t.dtype == dt]
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce_(flat, group)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


class _SendTo(torch.autograd.Function):
    """Send x to global rank ``peer``; returns a scalar whose backward
    receives x's gradient from ``peer``.  A pipeline stage's last
    activation goes out through it."""

    @staticmethod
    def forward(ctx, x, group, peer):
        ctx.group, ctx.peer = group, peer
        ctx.like = (x.shape, x.dtype, x.device)
        _send(x, group, peer)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _g):
        shape, dtype, device = ctx.like
        return _recv(shape, dtype, device, ctx.group, ctx.peer), None, None


class _RecvFrom(torch.autograd.Function):
    """Receive a tensor from global rank ``peer``; its gradient is sent
    back to ``peer``.  ``anchor`` (an empty tensor requiring grad) puts
    the receive in the graph: a Function without a differentiable input
    has no backward."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, group, peer):
        ctx.group, ctx.peer = group, peer
        return _recv(shape, dtype, anchor.device, group, peer)

    @staticmethod
    def backward(ctx, g):
        _send(g.contiguous(), ctx.group, ctx.peer)
        return None, None, None, None, None


def _send(x: torch.Tensor, group, peer: int) -> None:
    host = staged(group, x)
    _count(group, "send", host)
    dist.send(x.cpu() if host else x.contiguous(), peer, group=group)


def _recv(shape, dtype, device, group, peer: int) -> torch.Tensor:
    host = device.type == "cuda" and dist.get_backend(group) == "gloo"
    _count(group, "recv", host)
    out = torch.empty(shape, dtype=dtype,
                      device="cpu" if host else device)
    dist.recv(out, peer, group=group)
    return out.to(device) if host else out


def send_to(x: torch.Tensor, group, peer: int) -> torch.Tensor:
    """Send x to global rank ``peer`` of ``group``; the returned scalar's
    backward (``torch.autograd.backward`` on it) receives x's gradient
    from ``peer`` and carries it into x's graph."""
    return _SendTo.apply(x, group, peer)


def recv_from(shape, dtype, device, group, peer: int) -> torch.Tensor:
    """A tensor sent by global rank ``peer`` of ``group`` (``send_to``);
    under autograd its gradient goes back to ``peer`` in the backward."""
    anchor = torch.empty(0, device=device, requires_grad=True)
    return _RecvFrom.apply(anchor, tuple(shape), dtype, group, peer)


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
