"""Impact-scored BM25 over packed postings (PyTorch).

Counterpart of ``sdag_tpu/ops/bm25.py``.  Each document is packed as padded
(term_id, impact) pairs where impact(t, d) is the full per-term BM25
contribution precomputed at index-build time; query scoring is a sparse
dot product.  Three engines, pinned equal:

* dense scan: ``bm25_topk`` -- kernel K2 (``csrc/bm25_scan_topk.cu``) on a
  CUDA tensor, the plain chunked scoring + ordered top-k on a CPU tensor;
* postings walk: ``bm25_postings_topk`` (plain PyTorch ops; XLA in the JAX
  package, so no hand kernel is owed);
* heavy-term hybrid: ``bm25_hybrid_topk`` (plain PyTorch ops).

Every top-k here is ordered (score desc, doc id asc) explicitly:
``torch.topk`` does not order ties, so ranks come from stable sorts.

BM25 variant: Lucene's (as Anserini/Pyserini uses) --
idf = ln(1 + (N - df + 0.5)/(df + 0.5)),
tf_norm = tf / (tf + k1 * (1 - b + b * dl/avgdl)), defaults k1=0.9, b=0.4.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from sdag_tpu_torch import _build

PAD_TERM = -1
NEG_INF = float("-inf")
_INT_MAX = 2 ** 31 - 1
_DOC_SENTINEL = _INT_MAX

# K2 limits (csrc/bm25_scan_topk.cu template instantiations)
K2_MAX_QUERY_TERMS = 32
K2_MAX_K = 64
# match-tensor elements per chunk of the plain scorer
SCORE_CHUNK_ELEMS = 1 << 26


def bm25_scores(term_ids: torch.Tensor, impacts: torch.Tensor,
                q_terms: torch.Tensor, q_weights: torch.Tensor
                ) -> torch.Tensor:
    """Plain scoring: [Q, N] = sum over query slots (in slot order, PAD
    skipped) of weight x the impact of the matching doc term.

    Chunked over docs so the [Q, chunk, Lp] match tensor stays bounded
    (the JAX ``bm25_scores_xla`` builds [Q, N, Lp, T] at once).  The float
    operations per slot -- multiply, then add to the running score -- are
    the ones kernel K2 performs, in the same order."""
    n, lp = term_ids.shape
    qn, t = q_terms.shape
    out = torch.empty(qn, n, dtype=torch.float32, device=term_ids.device)
    step = max(1, SCORE_CHUNK_ELEMS // max(qn * lp, 1))
    for s in range(0, n, step):
        terms = term_ids[s:s + step]
        imps = impacts[s:s + step].float()
        score = torch.zeros(qn, terms.shape[0], dtype=torch.float32,
                            device=term_ids.device)
        for slot in range(t):
            qt = q_terms[:, slot]
            match = terms[None, :, :] == qt[:, None, None]
            contrib = torch.where(match, imps[None], 0.0).sum(-1)
            add = torch.where((qt != PAD_TERM)[:, None],
                              q_weights[:, slot, None] * contrib, 0.0)
            score = score + add
        out[:, s:s + step] = score
    return out


def _ordered_topk(scores: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis ordered (score desc, index asc), padded
    with (-inf, -1) when k exceeds the width; -inf slots report -1."""
    qn, n = scores.shape
    if n < k:
        scores = torch.nn.functional.pad(scores, (0, k - n), value=NEG_INF)
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k].to(torch.int32)
    return vals, torch.where(torch.isneginf(vals), -1, idx)


def bm25_topk_reference(term_ids, impacts, q_terms, q_weights, k: int,
                        valid_n: Optional[int] = None):
    """Plain version of kernel K2: chunked scoring, docs >= valid_n masked,
    ordered top-k.  Returns (scores [Q, k] f32, doc ids [Q, k] int32)."""
    scores = bm25_scores(term_ids, impacts, q_terms, q_weights)
    if valid_n is not None and valid_n < scores.shape[1]:
        scores[:, valid_n:] = NEG_INF
    return _ordered_topk(scores, k)


# launch plan of K2 (csrc/bm25_scan_topk.cu; ScanLayout there mirrors
# _k2_smem_bytes)
K2_WARPS = 8
K2_TILE_MAX = 64           # docs of a tile
K2_CHUNK = 64              # row slots of a staged chunk
K2_RING = 8                # chunks in flight per warp
K2_MERGE_MAX_LISTS = 512   # topk_merge_sorted_pass takes at most this many
K2_SMEM_LIMIT = 232448
K2_SM_SMEM = 233472        # shared memory of an SM
K2_BLOCK_RESERVED = 1024
K2_MAX_BLOCKS_PER_SM = 2   # the kernel's __launch_bounds__


def _k2_smem_bytes(t: int, cap: int, ht: int) -> int:
    return (2 * 32 * (K2_TILE_MAX + 1) * 4 + 2 * 32 * cap * 4
            + K2_WARPS * K2_RING * 2 * K2_CHUNK * 4 + ht * 8 + 32 * t * 32
            + K2_WARPS * t * 32 * 4 + 2 * t * 32 * 4 + 32 * 12
            + K2_WARPS * 32 * 8 + 16)


@functools.lru_cache(maxsize=256)
def bm25_scan_geometry(valid_n: int, qn: int, t: int, k: int,
                       sms: int) -> dict:
    """Launch plan of K2, a pure function of the shapes and the SM count.

    * ``cap``: entries of a query's candidate buffer, 64 for k <= 32 else
      128 (32 survivors of a step are appended between two checks).
    * ``ht``: slots of the block's term table, a power of two at least
      twice the 32 * T query slots (so it is at most half full).
    * ``td`` docs a tile, at most 64, as many as leave every block slot of
      the card a tile; ``n_blocks`` blocks per query group of 32 walk the
      ``n_tiles`` tiles (block x takes tiles x, x + n_blocks, ...), warp w
      of a block docs [w td / 8, (w + 1) td / 8) of a tile.  Each block
      writes one sorted list per query, so the merge sees ``n_blocks``
      lists.
    """
    cap = 64 if k <= 32 else 128
    ht = 64
    while ht < 64 * t:
        ht *= 2
    smem = _k2_smem_bytes(t, cap, ht)
    blocks_per_sm = min(K2_MAX_BLOCKS_PER_SM,
                        K2_SM_SMEM // (smem + K2_BLOCK_RESERVED))
    groups = -(-qn // 32)
    slots = max(1, sms * blocks_per_sm // groups)
    td = max(1, min(K2_TILE_MAX, valid_n // slots))
    n_tiles = -(-max(valid_n, 0) // td)
    n_blocks = max(1, min(n_tiles, slots, K2_MERGE_MAX_LISTS))
    return {"cap": cap, "ht": ht, "ht_log2": ht.bit_length() - 1,
            "smem_bytes": smem, "blocks_per_sm": blocks_per_sm,
            "groups": groups, "td": td, "n_tiles": n_tiles,
            "n_blocks": n_blocks}


def bm25_scan_work(geom: dict, valid_n: int, block: int):
    """(tile, warp, first doc, end doc) a block of the plan scores, in its
    order; warps with no doc in a tile are left out."""
    td = geom["td"]
    for tile in range(block, geom["n_tiles"], geom["n_blocks"]):
        for w in range(K2_WARPS):
            first = min(tile * td + (w * td) // K2_WARPS, valid_n)
            end = min(tile * td + ((w + 1) * td) // K2_WARPS, valid_n)
            if first < end:
                yield tile, w, first, end


def _k2_lib():
    lib = _build.load("bm25_scan_topk")
    if lib.bm25_scan_topk.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bm25_scan_topk.argtypes = [p] * 8 + [i] * 10 + [p]
        lib.bm25_scan_topk.restype = i
    return lib


def bm25_topk_cuda(term_ids, impacts, q_terms, q_weights, k: int,
                   valid_n: Optional[int] = None):
    """Kernel K2 (``csrc/bm25_scan_topk.cu``): fused BM25 scan + exact
    top-k.  term_ids [N, Lp] int32 / impacts [N, Lp] float32 /
    q_terms [Q, T] int32 / q_weights [Q, T] float32, contiguous on CUDA;
    T <= 32, 1 <= k <= 64."""
    n, lp = term_ids.shape
    qn, t = q_terms.shape
    for name, x, dt in (("term_ids", term_ids, torch.int32),
                        ("impacts", impacts, torch.float32),
                        ("q_terms", q_terms, torch.int32),
                        ("q_weights", q_weights, torch.float32)):
        if x.device.type != "cuda":
            raise ValueError(f"bm25_topk_cuda: {name} is not on CUDA")
        if x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"bm25_topk_cuda: {name} must be contiguous "
                             f"{dt}, got {x.dtype}")
    if impacts.shape != term_ids.shape or q_weights.shape != q_terms.shape:
        raise ValueError("bm25_topk_cuda: shape mismatch")
    if t > K2_MAX_QUERY_TERMS or not 1 <= k <= K2_MAX_K:
        raise ValueError(f"bm25_topk_cuda: needs T <= {K2_MAX_QUERY_TERMS} "
                         f"and 1 <= k <= {K2_MAX_K}, got T={t} k={k}")
    valid_n = n if valid_n is None else max(0, min(int(valid_n), n))
    dev = term_ids.device
    geom = bm25_scan_geometry(valid_n, qn, t, k, _build.sm_count(dev))
    vec16 = int(lp % 4 == 0 and term_ids.data_ptr() % 16 == 0
                and impacts.data_ptr() % 16 == 0)
    nb = geom["n_blocks"]
    cand_v = torch.empty(nb, qn, k, dtype=torch.float32, device=dev)
    cand_i = torch.empty(nb, qn, k, dtype=torch.int32, device=dev)
    out_v = torch.empty(qn, k, dtype=torch.float32, device=dev)
    out_i = torch.empty(qn, k, dtype=torch.int32, device=dev)
    _build.launch(
        _k2_lib(), "bm25_scan_topk", term_ids, impacts, q_terms, q_weights,
        cand_v, cand_i, out_v, out_i, lp, qn, t, k, valid_n, geom["td"],
        geom["n_tiles"], nb, geom["ht_log2"], vec16, device=dev,
        count_key="bm25_scan_topk")
    return out_v, out_i


def bm25_topk(term_ids, impacts, q_terms, q_weights, k: int,
              valid_n: Optional[int] = None):
    """Fused BM25 scoring + top-k.  Returns (scores [Q,k], doc ids [Q,k]);
    rows with no match get score 0 ranked by doc id (callers map those to
    ""/"NA"/-inf like the reference).  Kernel K2 on CUDA, the plain
    version on the CPU; any other device raises."""
    if term_ids.device.type == "cpu":
        return bm25_topk_reference(term_ids, impacts, q_terms, q_weights, k,
                                   valid_n=valid_n)
    if term_ids.device.type != "cuda":
        raise ValueError(f"bm25_topk: no path for device {term_ids.device}")
    return bm25_topk_cuda(term_ids, impacts, q_terms, q_weights, k,
                          valid_n=valid_n)


def bm25_topk_dispatch(term_ids, impacts, q_terms, q_weights, k,
                       valid_n=None):
    """Name kept from the JAX package: the scan engine's entry point."""
    return bm25_topk(term_ids, impacts, q_terms, q_weights, k,
                     valid_n=valid_n)


# ------------------------------------------------- postings (CSR) engine
#
# Lucene walks the postings lists of the query's terms, O(sum df(t)).
# Candidates come from windowed contiguous gathers of each query-term slot's
# CSR list, are sorted by doc id (stable), and each doc's run (length <= #
# active slots) collapses onto its first element with shifted adds -- the
# same steps, in the same order, as the JAX engine.


def _postings_runs(post_docs, post_imps, offsets, q_terms, q_weights,
                   w_slots: Tuple[int, ...], window: int, skip_mask=None,
                   heavy_cols=None, w_dense=None):
    """Shared candidate walk -> (docs_s [Q, M], run_scores [Q, M]) with
    the doc's summed contribution at each run start and -inf elsewhere,
    or None when no slot has windows.  With heavy_cols/w_dense each
    candidate also carries its heavy-term total (run_scores then hold the
    full totals)."""
    qn, t = q_terms.shape
    dev = q_terms.device
    p_pad = post_docs.shape[0]
    safe_t = q_terms.clamp(0, offsets.shape[0] - 2).long()
    starts = offsets[safe_t]
    lens = offsets[safe_t + 1] - starts
    lens = torch.where(q_terms == PAD_TERM, 0, lens)
    if skip_mask is not None:
        lens = torch.where(skip_mask, 0, lens)

    groups: dict = {}
    for s, ws in enumerate(w_slots):
        if ws > 0:
            groups.setdefault(ws, []).append(s)
    if not groups:
        return None
    docs_parts, contrib_parts = [], []
    for ws, slots in sorted(groups.items()):
        st = starts[:, slots]
        ln = lens[:, slots]
        qw = q_weights[:, slots]
        span = torch.arange(ws * window, dtype=torch.int32, device=dev)
        pos = st[:, :, None] + span[None, None, :]
        valid = span[None, None, :] < ln[:, :, None]
        pos = pos.clamp(0, p_pad - 1).long()
        g = len(slots) * ws * window
        docs_parts.append(torch.where(valid, post_docs[pos],
                                      _DOC_SENTINEL).reshape(qn, g))
        contrib_parts.append(torch.where(valid, post_imps[pos] * qw[:, :, None],
                                         0.0).reshape(qn, g))
    docs = torch.cat(docs_parts, dim=1).to(torch.int32)
    contrib = torch.cat(contrib_parts, dim=1).float()
    m = docs.shape[1]

    order = torch.sort(docs, dim=1, stable=True).indices
    docs_s = torch.gather(docs, 1, order)
    contrib_s = torch.gather(contrib, 1, order)
    dense_s = None
    if heavy_cols is not None:
        n_pad = heavy_cols.shape[0]
        sd = docs.clamp(0, n_pad - 1).long()
        parts = []
        for s in range(0, m, 1024):
            rows = heavy_cols[sd[:, s:s + 1024]]          # [Q, chunk, H]
            parts.append(torch.einsum("qmh,qh->qm", rows, w_dense))
        dense_c = torch.cat(parts, dim=1)
        dense_s = torch.gather(dense_c, 1, order)
    n_active = sum(1 for ws in w_slots if ws > 0)
    total = contrib_s.clone()
    for j in range(1, min(n_active, m)):
        same = docs_s[:, j:] == docs_s[:, :m - j]
        total[:, :m - j] = total[:, :m - j] + torch.where(
            same, contrib_s[:, j:], 0.0)
    if dense_s is not None:
        total = total + dense_s
    is_start = torch.cat([torch.ones(qn, 1, dtype=torch.bool, device=dev),
                          docs_s[:, 1:] != docs_s[:, :-1]], dim=1)
    run_scores = torch.where(is_start & (docs_s != _DOC_SENTINEL), total,
                             NEG_INF)
    return docs_s, run_scores


def _runs_topk(docs_s, run_scores, k):
    """Ordered top-k over doc-sorted runs (position order == doc order, so
    a stable sort breaks ties toward the smaller doc id)."""
    m = docs_s.shape[1]
    if m < k:
        docs_s = torch.nn.functional.pad(docs_s, (0, k - m),
                                         value=_DOC_SENTINEL)
        run_scores = torch.nn.functional.pad(run_scores, (0, k - m),
                                             value=NEG_INF)
    vals, posk = torch.sort(run_scores, dim=1, descending=True, stable=True)
    vals, posk = vals[:, :k], posk[:, :k]
    idx = torch.gather(docs_s, 1, posk)
    idx = torch.where(torch.isneginf(vals) | (idx == _DOC_SENTINEL), -1, idx)
    return vals, idx.to(torch.int32)


def bm25_postings_topk(post_docs, post_imps, offsets, q_terms, q_weights,
                       k: int, w_slots, window: int = 512):
    """Exact BM25 top-k via CSR postings.

    post_docs/post_imps: [P_pad] int32/f32 (term-major CSR, padded);
    offsets: [V+1] int32; q_terms/q_weights: [Q, T]; w_slots: per-slot
    window counts (w_slots[s]*window >= the max df placed in slot s), or
    an int for every slot.  Returns (scores [Q, k], doc ids [Q, k]);
    empty slots are (-inf, -1)."""
    qn, t = q_terms.shape
    if isinstance(w_slots, int):
        w_slots = (w_slots,) * t
    if len(w_slots) != t:
        raise ValueError(f"w_slots has {len(w_slots)} entries for {t} slots")
    runs = _postings_runs(post_docs, post_imps, offsets, q_terms, q_weights,
                          tuple(w_slots), window)
    if runs is None:
        dev = q_terms.device
        return (torch.full((qn, k), NEG_INF, device=dev),
                torch.full((qn, k), -1, dtype=torch.int32, device=dev))
    return _runs_topk(*runs, k)


def bm25_hybrid_topk(post_docs, post_imps, offsets, heavy_cols, heavy_rows,
                     q_terms, q_weights, q_heavy_idx, k: int,
                     w_slots: Tuple[int, ...], window: int = 512):
    """Exact BM25 top-k with heavy terms scored densely, tail terms on CSR.

    heavy_cols [N_pad, H_pad] (doc-major) / heavy_rows [H_pad, N_pad]
    (term-major) hold each heavy term's impact column; q_heavy_idx [Q, T]
    is the slot's heavy row or -1.  total(d) = dense(d) + light(d): the top
    k lies in (light candidates) U (top-k of dense scores), merged with an
    explicit (score desc, id asc) sort.  w_slots must cover LIGHT dfs only.
    Returns (scores [Q,k], doc ids [Q,k]); empty = (-inf, -1)."""
    qn, t = q_terms.shape
    h_pad = heavy_cols.shape[1]
    if len(w_slots) != t:
        raise ValueError(f"w_slots has {len(w_slots)} entries for {t} slots")
    oh = torch.nn.functional.one_hot(q_heavy_idx.clamp(min=0).long(),
                                     h_pad).float()
    oh = oh * (q_heavy_idx >= 0)[..., None]
    w_dense = torch.einsum("qt,qth->qh", q_weights, oh)
    scores = w_dense @ heavy_rows
    dvals, didx = _ordered_topk(
        torch.where(scores > 0.0, scores, NEG_INF), k)

    runs = _postings_runs(post_docs, post_imps, offsets, q_terms, q_weights,
                          tuple(w_slots), window, skip_mask=q_heavy_idx >= 0,
                          heavy_cols=heavy_cols, w_dense=w_dense)
    if runs is None:
        return dvals, didx
    lvals, lidx = _runs_topk(*runs, k)

    # a dense-top doc that also matched light terms already has its full
    # total in the light list: drop the dense entry
    present = (didx[:, :, None] == lidx[:, None, :]).any(-1)
    dvals = torch.where(present, NEG_INF, dvals)

    cat_v = torch.cat([lvals, dvals], dim=1)
    cat_i = torch.cat([torch.where(lidx < 0, _INT_MAX, lidx),
                       torch.where(torch.isneginf(dvals), _INT_MAX, didx)],
                      dim=1).long()
    # (score desc, id asc): sort by id, then stably by score
    o1 = torch.sort(cat_i, dim=1, stable=True).indices
    v1 = torch.gather(cat_v, 1, o1)
    i1 = torch.gather(cat_i, 1, o1)
    o2 = torch.sort(v1, dim=1, descending=True, stable=True).indices
    vals = torch.gather(v1, 1, o2)[:, :k]
    idx = torch.gather(i1, 1, o2)[:, :k]
    idx = torch.where(torch.isneginf(vals) | (idx == _INT_MAX), -1, idx)
    return vals, idx.to(torch.int32)
