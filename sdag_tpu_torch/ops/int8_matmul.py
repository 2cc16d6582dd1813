"""Weight-only int8 products (kernel K6 on CUDA).

Counterpart of the int8 branch of ``sdag_tpu/models/llama.py`` ``_mm``
(and of the tied unembed in ``_unembed``): ``(x @ w.astype(x.dtype)) *
s.astype(x.dtype)``, where XLA converts the int8 operand at the matrix
unit's read so that device memory streams int8 bytes.  No plain PyTorch
op does that (``x @ w.to(bf16)`` first writes a bf16 copy of the weight),
so the decode-shaped products go to a hand-written kernel,
``csrc/int8_matmul.cu`` (K6): bf16 activations on the tensor cores
(``mma.sync``), f32 activations too, as split TF32 (x = hi + lo, two
exact TF32 products a fragment).  Bound: the weight bytes (at <= 128 rows
the bf16 product does <= 256 operations per weight byte, below the ~295
where the tensor cores would bind; the f32 product's two TF32 products
reach the TF32 rate's ~148 near 37 rows).

Weights are stored ``[out, in]`` (one output channel contiguous) with f32
scales ``[out]``; the port's int8 tree (``models/llama.py``) holds them so.
Products of more than ``K6_MAX_ROWS`` rows (prefill: batch x prompt
length) stay the JAX formula through ``torch.matmul``, a plain large
product.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from sdag_tpu_torch import _build

# K6 takes up to 128 activation rows: a decode step's batch (<= 8 on the
# serving path) or a verification window's batch x (D + 1) <= 8 x 16; a
# product with more rows (prefill) is compute-heavy enough for
# torch.matmul over a dequantized copy
K6_MAX_ROWS = 128
# the bf16 body's splits of one channel tile form one thread block cluster,
# at most the portable cluster size; its ring's chunk (columns) and the
# shared bytes a block may take with two blocks an SM
# (csrc/int8_matmul.cu mirrors these)
K6_MAX_CLUSTER = 8
K6_BF16_CHUNK = 128
K6_BF16_SMEM_2 = 114688
K6_BODIES = {torch.float32: "int8_matmul_f32",
             torch.bfloat16: "int8_matmul_bf16"}
_K6_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def int8_matmul_reference(x: torch.Tensor, w: torch.Tensor,
                          s: torch.Tensor) -> torch.Tensor:
    """Plain version: ``T(T(x @ w.T) * T(s))`` with the sum in f32, T =
    x.dtype.  x [..., K]; w [N, K] int8; s [N] f32 -> [..., N] of x's
    dtype."""
    acc = torch.matmul(x.float(), w.float().T)
    return acc.to(x.dtype) * s.to(x.dtype)


def k6_plan(n_out: int, k_in: int, sm_count: int,
            dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int]:
    """K6's launch plan, from the weight's shape alone (so a row's sums do
    not depend on the number of rows): (warps a block, each on 16
    channels; splits of K across blocks, each at least one 256-wide
    chunk).  Both bodies fill at most one wave of two blocks an SM (their
    occupancy at a window's 40 rows; a second, partial wave cost more
    than the extra split saved).  f32: 8 warps, or 4 below 2048 channels.
    bf16: 4 warps, or 8 where 4-warp blocks would overfill a wave
    unsplit; the splits of a channel tile reduce inside one thread block
    cluster, so at most ``K6_MAX_CLUSTER``; where that many splits leave
    an SM without a block, fewer warps a block."""
    kblocks = -(-k_in // 64)
    if dtype == torch.float32:
        warps = 8 if n_out >= 2048 else 4
        want = 2 * sm_count // -(-n_out // (16 * warps))
    else:
        warps = 8 if -(-n_out // 64) > 2 * sm_count else 4
        most = max(1, min(K6_MAX_CLUSTER, kblocks // 4))
        while warps > 1 and -(-n_out // (16 * warps)) * most < sm_count:
            warps //= 2
        want = min(K6_MAX_CLUSTER, 2 * sm_count // -(-n_out // (16 * warps)))
    splits = max(1, min(want, kblocks // 4))
    per = -(-kblocks // splits)
    return warps, -(-kblocks // per)


def k6_geometry(m_rows: int, n_out: int, k_in: int, dtype: torch.dtype,
                sm_count: int) -> Dict[str, int]:
    """K6's launch at ``m_rows`` rows: the plan (``k6_plan``: warps,
    splits, ``per`` 64-wide k blocks a split, ``blocks`` of channels,
    ``cluster``: blocks a thread block cluster, the bf16 body's splits),
    which fixes every sum's order, and what the row count only sizes: row
    tiles of 8 (``nt``), columns staged a chunk (``kc``) and the shared
    bytes they take.  f32: activation chunks of 256 columns, 128 above 8
    row tiles.  bf16: a ring of ``stages`` chunks of 128 columns, each the
    block's weight rows and the activation rows in 8 ``nt`` rows (TMA
    boxes; rows past M arrive as zeros), as many stages (2 to 4) as leave
    two blocks an SM, and the stages' mbarriers (64 bytes); the f32
    partial tile of a split, ``M x (16 warps + 4)``, reuses the ring; the
    block's ``threads`` include one producer warp.  ``csrc/int8_matmul.cu``
    refuses a ``kc`` or ``stages`` other than its own rule's."""
    warps, splits = k6_plan(n_out, k_in, sm_count, dtype)
    kblocks = -(-k_in // 64)
    nt = -(-m_rows // 8)
    if dtype == torch.float32:
        kc = 256 if nt <= 8 else 128
        stages, smem, threads = 1, nt * 8 * kc * 4, 32 * warps
    else:
        kc = K6_BF16_CHUNK
        stage = 16 * warps * kc + nt * 8 * 2 * kc
        stages = max(2, min(4, (K6_BF16_SMEM_2 - 64) // stage))
        smem, threads = stages * stage + 64, 32 * warps + 32
    return {"warps": warps, "splits": splits,
            "per": -(-kblocks // splits),
            "blocks": -(-n_out // (16 * warps)), "nt": nt, "kc": kc,
            "stages": stages, "smem_bytes": smem, "threads": threads,
            "cluster": 1 if dtype == torch.float32 else splits}


def _k6_lib():
    lib = _build.load("int8_matmul")
    if lib.int8_matmul.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int8_matmul.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                    p]
        lib.int8_matmul.restype = i
        lib.int8_matmul_bf16_clusters.argtypes = [i, i, i]
        lib.int8_matmul_bf16_clusters.restype = i
    return lib


def k6_bf16_clusters(geo: Dict[str, int]) -> int:
    """How many clusters of the bf16 launch ``geo`` (``k6_geometry``) the
    current card holds at once (cudaOccupancyMaxActiveClusters), -1 if it
    cannot tell."""
    return _k6_lib().int8_matmul_bf16_clusters(geo["nt"], geo["warps"],
                                               geo["splits"])


def int8_matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                     s: torch.Tensor) -> torch.Tensor:
    """Kernel K6: x [M, K] (bfloat16 or float32, 1 <= M <= 128), w [N, K]
    int8, s [N] float32, all contiguous CUDA tensors, K % 16 == 0.
    Returns y [M, N] of x's dtype."""
    M, K = x.shape
    N = w.shape[0]
    for name, t in (("x", x), ("w", w), ("s", s)):
        if t.device.type != "cuda":
            raise ValueError(f"int8_matmul_cuda: {name} is not on CUDA")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int8_matmul_cuda: {name} must be contiguous "
                             "and 16-byte aligned")
    if x.dtype not in _K6_DTYPES:
        raise ValueError(f"int8_matmul_cuda: dtype {x.dtype} unsupported "
                         "(float32 or bfloat16)")
    if w.dtype != torch.int8 or s.dtype != torch.float32:
        raise ValueError("int8_matmul_cuda: w must be int8 and s float32")
    if w.shape != (N, K) or s.shape != (N,):
        raise ValueError(f"int8_matmul_cuda: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, s {tuple(s.shape)} differ")
    if not 1 <= M <= K6_MAX_ROWS or K % 16:
        raise ValueError(f"int8_matmul_cuda: {M} rows (1..{K6_MAX_ROWS}) "
                         f"or K={K} (a multiple of 16) unsupported")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    geo = k6_geometry(M, N, K, x.dtype, _build.sm_count(x.device))
    part = None
    if x.dtype == torch.float32 and geo["splits"] > 1:
        part = torch.empty((geo["splits"], M, N), dtype=torch.float32,
                           device=x.device)
    _build.launch(
        _k6_lib(), "int8_matmul", x, w, s, y, part, M, K, N,
        _K6_DTYPES[x.dtype], geo["warps"], geo["splits"], geo["kc"],
        geo["stages"], device=x.device, count_key=K6_BODIES[x.dtype])
    return y


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(w).T`` for an int8 weight ``w`` [N, K] with f32 scales
    ``s`` [N]; x [..., K] -> [..., N] of x's dtype.  On the CPU the plain
    version; on CUDA K6 for at most ``K6_MAX_ROWS`` rows, else the JAX
    formula through torch.matmul; any other device raises."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w, s)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: no path for device {x.device}")
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if x2.shape[0] > K6_MAX_ROWS:
        return torch.matmul(x, w.to(x.dtype).T) * s.to(x.dtype)
    return int8_matmul_cuda(x2.contiguous(), w, s).reshape(*lead, w.shape[0])
