"""Fused matmul + top-k for dense retrieval (PyTorch).

Counterpart of ``sdag_tpu/ops/topk.py`` (itself replacing FAISS flat
inner-product search).  The corpus embedding matrix lives in device memory;
kernels K4/K5 (``csrc/topk_matmul.cu``) score corpus tiles on the tensor
cores and keep a top-k per query on chip, so the full [Q, N] score matrix
is never materialized.

* ``fused_topk_matmul`` (bf16 / f32 corpus) -- K4 on CUDA, its plain
  version ``exact_topk`` on the CPU;
* ``fused_topk_matmul_int8`` (int8 corpus, per-row scales) -- K5 on CUDA,
  its plain version ``exact_topk_int8`` on the CPU; the integer dot is
  exact in both, so they agree bit for bit;
* ``approx_topk_matmul``, ``approx_topk_matmul_int8``,
  ``rescored_topk_int8`` -- plain PyTorch ops (XLA in the JAX package, so
  no hand kernel is owed).  The JAX versions rest on ``lax.approx_max_k``,
  which is exact off the TPU; these are exact everywhere: matmul plus an
  explicitly ordered top-k.

Tie-breaking is exact: equal scores resolve to the smaller corpus index
(``torch.topk`` does not promise that, so ``ordered_topk`` repairs ties).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from sdag_tpu_torch import _build

NEG_INF = float("-inf")
_INT_MAX = 2 ** 31 - 1

K4_MAX_K = 128
_K4_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# launch-count key per kernel body
K4_BODIES = {torch.float32: "topk_matmul_f32",
             torch.bfloat16: "topk_matmul_bf16",
             torch.int8: "topk_matmul_int8"}
# bytes of corpus rows converted to float per step of the plain versions
_PLAIN_CHUNK_BYTES = 1 << 28
# the int8 dot stays exact in float32 while D * 127^2 < 2^24
_INT8_F32_EXACT_D = (1 << 24) // (127 * 127)


def ordered_topk(scores: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis ordered (score desc, index asc); slots
    past the width, and -inf scores, report (-inf, -1).

    ``torch.topk`` finds the k-th value; entries above it are a definite
    set, entries equal to it are taken by ascending index, and the k
    survivors are sorted explicitly."""
    qn, n = scores.shape
    kk = min(k, n)
    dev = scores.device
    if kk == 0:
        return (torch.full((qn, k), NEG_INF, device=dev),
                torch.full((qn, k), -1, dtype=torch.int32, device=dev))
    vals, idx = torch.topk(scores, kk, dim=1)
    kth = vals[:, -1:]
    col = torch.arange(n, dtype=torch.int32, device=dev)
    ties = torch.where(scores == kth, col[None, :], n)
    tie_first = torch.topk(ties, kk, dim=1, largest=False).values
    pos = torch.arange(kk, device=dev)[None, :]
    n_above = (vals > kth).sum(1, keepdim=True)
    from_ties = torch.gather(tie_first, 1, (pos - n_above).clamp(min=0))
    idx = torch.where(pos < n_above, idx.to(torch.int32), from_ties)
    vals = torch.where(pos < n_above, vals, kth)
    vals, idx = merge_topk(vals, idx, kk)
    if kk < k:
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
    return vals, torch.where(torch.isneginf(vals), -1, idx).to(torch.int32)


def merge_topk(scores: torch.Tensor, indices: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge candidate lists [Q, M] -> top-k with exact (score desc, index
    asc) ordering.  Used to combine candidate or per-shard results."""
    o1 = torch.sort(indices, dim=1, stable=True).indices
    s1 = torch.gather(scores, 1, o1)
    o2 = torch.sort(s1, dim=1, descending=True, stable=True).indices[:, :k]
    top = torch.gather(o1, 1, o2)
    return torch.gather(scores, 1, top), torch.gather(indices, 1, top)


def _mask_rows(scores: torch.Tensor, valid_n: Optional[int]) -> torch.Tensor:
    if valid_n is not None and valid_n < scores.shape[1]:
        scores[:, max(int(valid_n), 0):] = NEG_INF
    return scores


def _float_scores(queries: torch.Tensor, corpus: torch.Tensor
                  ) -> torch.Tensor:
    """[Q, N] float32 inner products with float32 accumulation, the corpus
    converted chunk by chunk."""
    qf = queries.float()
    n, d = corpus.shape
    if corpus.dtype == torch.float32:
        return qf @ corpus.T
    out = torch.empty(qf.shape[0], n, dtype=torch.float32,
                      device=corpus.device)
    step = max(1, _PLAIN_CHUNK_BYTES // (4 * max(d, 1)))
    for s in range(0, n, step):
        out[:, s:s + step] = qf @ corpus[s:s + step].float().T
    return out


def _int8_scores(q_i8: torch.Tensor, q_scales: torch.Tensor,
                 corpus_i8: torch.Tensor, scales: torch.Tensor
                 ) -> torch.Tensor:
    """float(exact int dot) * q_scale * row_scale, in that order.  The dot
    runs in float32 while every partial sum stays an exactly representable
    integer (D <= 1040), in float64 beyond."""
    n, d = corpus_i8.shape
    ft = torch.float32 if d <= _INT8_F32_EXACT_D else torch.float64
    qf = q_i8.to(ft)
    out = torch.empty(qf.shape[0], n, dtype=torch.float32,
                      device=corpus_i8.device)
    step = max(1, _PLAIN_CHUNK_BYTES // (qf.element_size() * max(d, 1)))
    for s in range(0, n, step):
        acc = (qf @ corpus_i8[s:s + step].to(ft).T).float()
        out[:, s:s + step] = (acc * q_scales[:, None]) \
            * scales[None, s:s + step].float()
    return out


def exact_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int,
               valid_n: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain exact search: full matmul (float32 accumulate) + ordered
    top-k.  The plain version of kernel K4 when the queries are already in
    the corpus dtype.  Returns (scores [Q,k] f32, indices [Q,k] int32)
    sorted by descending score, ties to the smaller index."""
    scores = _mask_rows(_float_scores(queries, corpus), valid_n)
    return ordered_topk(scores, k)


def _int8_topk(queries, corpus_i8, scales, k, valid_n):
    """Queries quantised per row, exact integer dot, both scales applied
    to the product, ordered top-k."""
    q_i8, q_scales = quantize_last_axis_int8(queries)
    scores = _mask_rows(_int8_scores(q_i8, q_scales, corpus_i8, scales),
                        valid_n)
    return ordered_topk(scores, k)


def exact_topk_int8(queries: torch.Tensor, corpus_i8: torch.Tensor,
                    scales: torch.Tensor, k: int,
                    valid_n: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel K5 (the CPU path of
    ``fused_topk_matmul_int8`` and the reference the kernel is held to)."""
    return _int8_topk(queries, corpus_i8, scales, k, valid_n)


# geometry of the tensor-core bodies (csrc/topk_matmul.cu topk_matmul_mma)
K4_TILE_N = 128            # corpus rows per tile
K4_CHUNK_BYTES = 128       # bytes of a row per ring stage
K4_SMEM_LIMIT = 232448     # dynamic shared memory a block may use
K4_MAX_STAGES = 4
# up to this many corpus tiles one block walks them all and writes the
# result itself (no second pass)
K4_ONE_SPLIT_TILES = 4


def _mma_smem_bytes(q_rows: int, cap: int, stages: int) -> int:
    """csrc/topk_matmul.cu mma_layout().total."""
    stage = (K4_TILE_N + q_rows) * K4_CHUNK_BYTES  # corpus + query chunk
    return (stages * stage
            + stages * K4_TILE_N * 4        # row scales per stage
            + 2 * q_rows * cap * 4          # candidate buffers
            + 2 * stages * 8)               # barriers


def topk_mma_geometry(qn: int, valid_n: int, d: int, k: int,
                      dtype: torch.dtype, sms: int) -> dict:
    """Launch geometry of the bf16 / int8 bodies of K4/K5, a pure function
    of the shapes and the SM count.

    * ``cap``: entries of a row's candidate buffer, 64 / 128 / 256 for
      k <= 16 / 64 / 128 (at least k + 32: 32 columns are appended between
      two checks).
    * ``q_rows``: 128 query rows a block (two warpgroups) once Q > 64 and
      the buffers of 128 rows fit (k <= 64), else 64.
    * ``stages``: as many ring stages (a 128-byte chunk of the corpus
      tile's and of the query tile's rows) as fit, at most K4_MAX_STAGES.
    * one block per SM: ``n_splits`` corpus splits of ``tiles_per_split``
      128-row tiles per query tile; a corpus of at most
      K4_ONE_SPLIT_TILES tiles is one split, written without the merge
      pass (``direct``).
    """
    es = {torch.bfloat16: 2, torch.int8: 1}[dtype]
    n_chunks = -(-d * es // K4_CHUNK_BYTES)
    cap = 64 if k <= 16 else 128 if k <= 64 else 256
    q_rows = 128 if qn > 64 and cap <= 128 else 64

    stages = max(st for st in range(2, K4_MAX_STAGES + 1)
                 if _mma_smem_bytes(q_rows, cap, st) <= K4_SMEM_LIMIT)
    q_tiles = -(-qn // q_rows)
    tiles = max(1, -(-valid_n // K4_TILE_N))
    if tiles <= K4_ONE_SPLIT_TILES:
        n_splits = 1
    else:
        n_splits = max(1, min(tiles, sms // q_tiles))
    tiles_per_split = -(-tiles // n_splits)
    n_splits = -(-tiles // tiles_per_split)
    return {"q_rows": q_rows, "cap": cap, "stages": stages,
            "n_chunks": n_chunks,
            "q_tiles": q_tiles, "tiles": tiles, "n_splits": n_splits,
            "tiles_per_split": tiles_per_split, "direct": n_splits == 1,
            "smem_bytes": _mma_smem_bytes(q_rows, cap, stages)}


# geometry of the float32 body (csrc/topk_matmul.cu topk_matmul_f32)
K4_F32_TILE_N = 128        # corpus rows per tile
K4_F32_CHUNK = 16          # features per staged chunk
K4_F32_PART = 16           # columns of a row appended between two checks
# a block's candidate buffers (q_rows x cap entries) stay within 64 KiB, so
# two blocks fit on an SM
K4_F32_BUFFER_ENTRIES = 8192
K4_F32_BLOCKS_PER_SM = 2


def _f32_smem_bytes(q_rows: int, cap: int) -> int:
    """csrc/topk_matmul.cu f32_smem_words() in bytes: two chunk buffers of
    [chunk][q_rows + 4] and [chunk][128 + 4] floats, the next query chunk as
    copied ([q_rows][chunk]), a threshold value, index and count per row,
    the rows' candidate buffers."""
    stage = K4_F32_CHUNK * (q_rows + 4 + K4_F32_TILE_N + 4)
    return 4 * (2 * stage + q_rows * K4_F32_CHUNK + 3 * q_rows
                + 2 * q_rows * cap)


def topk_f32_geometry(qn: int, valid_n: int, k: int, sms: int) -> dict:
    """Launch geometry of K4's float32 body, a pure function of the shapes
    and the SM count.

    * ``cap``: entries of a row's candidate buffer, 64 / 128 / 256 for
      k <= 48 / 112 / 128 (at least k + 16: 16 columns are appended between
      two checks).
    * ``q_rows``: 32, 64 or 128 query rows a block: the least that covers Q
      (so a small batch pays no idle rows), as long as the buffers stay
      within K4_F32_BUFFER_ENTRIES.
    * two blocks per SM: ``n_splits`` corpus splits of ``tiles_per_split``
      128-row tiles per query tile; one split writes the result itself
      (``direct``), more are merged by the second pass.
    """
    cap = next(c for c in (64, 128, 256) if c >= k + K4_F32_PART)
    q_rows = 32
    while q_rows < 128 and q_rows < qn \
            and 2 * q_rows * cap <= K4_F32_BUFFER_ENTRIES:
        q_rows *= 2
    q_tiles = -(-qn // q_rows)
    tiles = max(1, -(-valid_n // K4_F32_TILE_N))
    n_splits = max(1, min(tiles, K4_F32_BLOCKS_PER_SM * sms // q_tiles))
    tiles_per_split = -(-tiles // n_splits)
    n_splits = -(-tiles // tiles_per_split)
    return {"q_rows": q_rows, "cap": cap, "stages": 0, "q_tiles": q_tiles,
            "tiles": tiles, "n_splits": n_splits,
            "tiles_per_split": tiles_per_split, "direct": n_splits == 1,
            "smem_bytes": _f32_smem_bytes(q_rows, cap)}


def _k4_lib():
    lib = _build.load("topk_matmul")
    if lib.topk_matmul.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_matmul.argtypes = [p] * 8 + [i] * 11 + [p]
        lib.topk_matmul.restype = i
        lib.quantize_rows_int8.argtypes = [p, p, p, i, i, p]
        lib.quantize_rows_int8.restype = i
    return lib


def topk_matmul_cuda(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                     valid_n: Optional[int] = None,
                     q_scales: Optional[torch.Tensor] = None,
                     c_scales: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernels K4/K5 (``csrc/topk_matmul.cu``).  queries [Q, D] and corpus
    [N, D] contiguous on one CUDA device in one dtype: float32, bfloat16
    (D % 8 == 0) or int8 (D % 16 == 0, with q_scales [Q] and c_scales [N]
    float32); 1 <= k <= 128."""
    for name, t in (("queries", queries), ("corpus", corpus)):
        if t.device.type != "cuda" or t.device != corpus.device:
            raise ValueError(f"topk_matmul_cuda: {name} is not on the "
                             "corpus' CUDA device")
        if t.dim() != 2 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"topk_matmul_cuda: {name} must be a "
                             "contiguous, 16-byte aligned matrix")
    dt = corpus.dtype
    if dt not in _K4_DTYPES or queries.dtype != dt:
        raise ValueError(f"topk_matmul_cuda: dtypes {queries.dtype} / {dt} "
                         "unsupported (one of float32, bfloat16, int8)")
    qn, d = queries.shape
    n = corpus.shape[0]
    if corpus.shape[1] != d or (d * corpus.element_size()) % 16 \
            or qn < 1 or n < 1:
        raise ValueError(f"topk_matmul_cuda: shapes {tuple(queries.shape)} "
                         f"/ {tuple(corpus.shape)} unsupported (rows must "
                         "be a multiple of 16 bytes)")
    if not 1 <= k <= K4_MAX_K:
        raise ValueError(f"topk_matmul_cuda: needs 1 <= k <= {K4_MAX_K}, "
                         f"got {k}")
    if dt == torch.int8:
        for name, s, rows in (("q_scales", q_scales, qn),
                              ("c_scales", c_scales, n)):
            if s is None or s.device != corpus.device or s.shape != (rows,) \
                    or s.dtype != torch.float32 or not s.is_contiguous() \
                    or s.data_ptr() % 16:
                raise ValueError(f"topk_matmul_cuda: {name} must be a "
                                 f"contiguous, 16-byte aligned float32 "
                                 f"[{rows}] on the corpus' device")
    valid_n = n if valid_n is None else max(0, min(int(valid_n), n))
    dev = corpus.device
    if dt == torch.float32:
        geo = topk_f32_geometry(qn, valid_n, k, _build.sm_count(dev))
    else:
        geo = topk_mma_geometry(qn, valid_n, d, k, dt, _build.sm_count(dev))
    out_v = torch.empty(qn, k, dtype=torch.float32, device=dev)
    out_i = torch.empty(qn, k, dtype=torch.int32, device=dev)
    # the splits' lists: values, then indices, in one scratch tensor
    cand = (None, None) if geo["direct"] else torch.empty(
        2, geo["n_splits"], qn, k, dtype=torch.float32, device=dev)
    _build.launch(
        _k4_lib(), "topk_matmul", queries, corpus, q_scales, c_scales,
        cand[0], cand[1], out_v, out_i, qn, n, d, k, valid_n,
        geo["n_splits"], geo["tiles_per_split"], geo["q_rows"], geo["cap"],
        geo["stages"], _K4_DTYPES[dt], device=dev, count_key=K4_BODIES[dt])
    return out_v, out_i


def quantize_rows_int8_cuda(x: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The query quantiser of K5 as a kernel (``csrc/topk_matmul.cu``
    quantize_rows_int8_kernel): x [Q, D] float32 contiguous on CUDA ->
    (int8 [Q, D], float32 scales [Q]), bit-equal to
    ``quantize_last_axis_int8``.  It is K5's prologue and is counted with
    K5's launch, not on its own."""
    if x.device.type != "cuda" or x.dim() != 2 or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise ValueError("quantize_rows_int8_cuda: needs a contiguous "
                         "float32 matrix on CUDA")
    qn, d = x.shape
    q = torch.empty(qn, d, dtype=torch.int8, device=x.device)
    scales = torch.empty(qn, dtype=torch.float32, device=x.device)
    _build.launch(_k4_lib(), "quantize_rows_int8", x, q, scales, qn, d,
                  device=x.device)
    return q, scales


def _check_device(t: torch.Tensor, fn: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no path for device {t.device}")


def fused_topk_matmul(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                      valid_n: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused inner-product search.  queries [Q, D] (cast to the corpus
    dtype); corpus [N, D] float32 or bfloat16; rows >= valid_n are masked
    out.  Returns (scores [Q, k] f32, indices [Q, k] int32); missing entries
    are (-inf, -1).  Kernel K4 on CUDA, the plain version on the CPU."""
    _check_device(corpus, "fused_topk_matmul")
    queries = queries.to(corpus.dtype)
    if corpus.device.type == "cpu":
        return exact_topk(queries, corpus, k, valid_n=valid_n)
    return topk_matmul_cuda(queries.contiguous(), corpus, k, valid_n=valid_n)


def quantize_last_axis_int8(x: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the last axis: returns (int8
    values, f32 scales [...]) with x ~= values * scales[..., None]; round
    half to even, clip to +-127.  Single source of the quantization rule
    for the retrieval index and the queries."""
    xf = x.float()
    amax = xf.abs().amax(-1).clamp_min(1e-12)
    # a tensor divisor: dividing by the Python scalar 127.0 becomes a
    # multiply by 1/127 on CUDA, one rounding away from the CPU's scales
    scales = amax / torch.full_like(amax, 127.0)
    q = torch.round(xf / scales[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scales


def quantize_rows_int8(x):
    """Host (numpy) wrapper of quantize_last_axis_int8 for index builds."""
    q, s = quantize_last_axis_int8(
        torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)))
    return q.numpy(), s.numpy()


def quantize_rows_int8_residual(x):
    """Two-level int8 quantization for the rescored dense index:
    x ~= base*sb[:,None] + resid*sr[:,None] with ~15-bit effective
    precision (resid max is sb/2, so the combined step is sb/508).
    Same total memory as bf16, but the coarse scan reads only ``base``.
    Returns (base i8, sb f32, resid i8, sr f32)."""
    xf = np.asarray(x, np.float32)
    base, sb = quantize_rows_int8(xf)
    resid = xf - base.astype(np.float32) * sb[:, None]
    rq, sr = quantize_rows_int8(resid)
    return base, sb, rq, sr


def fused_topk_matmul_int8(queries: torch.Tensor, corpus_i8: torch.Tensor,
                           scales: torch.Tensor, k: int,
                           valid_n: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k over an int8-quantized corpus (per-row scales); the
    queries are quantised per row by K5's prologue kernel.  Kernel K5 on
    CUDA (two launches, counted once), the plain version on the CPU."""
    _check_device(corpus_i8, "fused_topk_matmul_int8")
    if corpus_i8.device.type == "cpu":
        return exact_topk_int8(queries, corpus_i8, scales, k,
                               valid_n=valid_n)
    q_i8, q_scales = quantize_rows_int8_cuda(queries.float().contiguous())
    return topk_matmul_cuda(q_i8, corpus_i8, k, valid_n=valid_n,
                            q_scales=q_scales,
                            c_scales=scales.float().contiguous())


def _approx_candidates(k: int, n: int, m: Optional[int]) -> int:
    """Candidate-list depth of the two-stage searches: M = 4k (floor 40)."""
    return min(m if m is not None else max(4 * k, 40), n)


def approx_topk_matmul(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                       valid_n: Optional[int] = None,
                       m: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage search: matmul -> M >= 4k candidates -> exact (score desc,
    index asc) merge.  The candidate stage is an exact ordered top-k here
    (the JAX ``approx_max_k`` is approximate on the TPU only), so the
    result equals ``exact_topk`` on queries cast to the corpus dtype."""
    mm = _approx_candidates(k, corpus.shape[0], m)
    scores = _mask_rows(_float_scores(queries.to(corpus.dtype), corpus),
                        valid_n)
    vals, idx = ordered_topk(scores, mm)
    mv, mi = merge_topk(vals, idx, k)
    return mv, torch.where(torch.isneginf(mv), -1, mi)


def approx_topk_matmul_int8(queries: torch.Tensor, corpus_i8: torch.Tensor,
                            scales: torch.Tensor, k: int,
                            valid_n: Optional[int] = None,
                            m: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-corpus variant of :func:`approx_topk_matmul`."""
    mm = _approx_candidates(k, corpus_i8.shape[0], m)
    vals, idx = _int8_topk(queries, corpus_i8, scales, mm, valid_n)
    mv, mi = merge_topk(vals, idx, k)
    return mv, torch.where(torch.isneginf(mv), -1, mi)


def rescored_topk_int8(queries: torch.Tensor, base_i8: torch.Tensor,
                       base_scales: torch.Tensor, resid_i8: torch.Tensor,
                       resid_scales: torch.Tensor, k: int,
                       valid_n: Optional[int] = None,
                       m: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 coarse scan + int8-residual candidate rescore.

    Stage 1 is :func:`approx_topk_matmul_int8`'s coarse pass over the int8
    base keeping M candidates.  Stage 2 gathers the M base+residual rows
    per query and rescores them against the float32 query: score =
    sb[i]*(q.base_i) + sr[i]*(q.resid_i), i.e. the reconstruction has
    ~15-bit precision vs int8's 7, which removes the int8 engine's
    candidate-ordering error at the int8 engine's scan cost."""
    n = base_i8.shape[0]
    mm = _approx_candidates(k, n, m)
    cvals, cidx = _int8_topk(queries, base_i8, base_scales, mm, valid_n)
    safe = cidx.clamp(0, n - 1).long()
    qf = queries.float()
    dot_b = torch.einsum("qd,qmd->qm", qf, base_i8[safe].float())
    dot_r = torch.einsum("qd,qmd->qm", qf, resid_i8[safe].float())
    rec = dot_b * base_scales[safe] + dot_r * resid_scales[safe]
    rec = torch.where(torch.isneginf(cvals), NEG_INF, rec)
    # invalid candidates (-1) sort last among equal -inf scores
    mv, mi = merge_topk(rec, torch.where(cidx < 0, _INT_MAX, cidx), k)
    return mv, torch.where(torch.isneginf(mv), -1, mi).to(torch.int32)


def topk_search(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                valid_n: Optional[int] = None, mode: str = "exact"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch.  mode="exact": kernel K4 on CUDA, the plain scan on the
    CPU (decided for the card: the kernel is the exact engine there).
    mode="approx": the two-stage plain search."""
    if mode == "approx":
        return approx_topk_matmul(queries, corpus, k, valid_n=valid_n)
    return fused_topk_matmul(queries, corpus, k, valid_n=valid_n)
