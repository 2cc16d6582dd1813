"""Weight-only int8 products (kernel K6 on CUDA).

Counterpart of the int8 branch of ``sdag_tpu/models/llama.py`` ``_mm``
(and of the tied unembed in ``_unembed``): ``(x @ w.astype(x.dtype)) *
s.astype(x.dtype)``, where XLA converts the int8 operand at the matrix
unit's read so that device memory streams int8 bytes.  No plain PyTorch
op does that (``x @ w.to(bf16)`` first writes a bf16 copy of the weight),
so the decode-shaped products go to a hand-written kernel,
``csrc/int8_matmul.cu`` (K6): bf16 activations on the tensor cores
(``mma.sync``), f32 activations on CUDA-core FMA.  Bound: the weight
bytes (at <= 128 rows the product does <= 256 operations per weight byte,
below the ~295 where the tensor cores would bind).

Weights are stored ``[out, in]`` (one output channel contiguous) with f32
scales ``[out]``; the port's int8 tree (``models/llama.py``) holds them so.
Products of more than ``K6_MAX_ROWS`` rows (prefill: batch x prompt
length) stay the JAX formula through ``torch.matmul``, a plain large
product.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from sdag_tpu_torch import _build

# K6 takes up to 128 activation rows: a decode step's batch (<= 8 on the
# serving path) or a verification window's batch x (D + 1) <= 8 x 16; a
# product with more rows (prefill) is compute-heavy enough for
# torch.matmul over a dequantized copy
K6_MAX_ROWS = 128
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


def k6_plan(n_out: int, k_in: int, sm_count: int) -> Tuple[int, int]:
    """K6's bf16 launch plan, from the weight's shape alone (so a row's
    sums do not depend on the number of rows): (warps a block, each on 16
    channels: 8, or 4 below 2048 channels; splits of K across blocks, each
    at least one 256-wide chunk, enough for two blocks an SM)."""
    warps = 8 if n_out >= 2048 else 4
    blocks = -(-n_out // (16 * warps))
    kblocks = -(-k_in // 64)
    splits = max(1, min(-(-2 * sm_count // blocks), kblocks // 4))
    per = -(-kblocks // splits)
    return warps, -(-kblocks // per)


def _k6_lib():
    lib = _build.load("int8_matmul")
    if lib.int8_matmul.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int8_matmul.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.int8_matmul.restype = i
    return lib


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
    warps, splits = k6_plan(N, K, _build.sm_count(x.device))
    part = None
    if x.dtype == torch.bfloat16 and splits > 1:
        part = torch.empty((splits, M, N), dtype=torch.float32,
                           device=x.device)
    lib = _k6_lib()
    ptr = lambda t: ctypes.c_void_p(  # noqa: E731
        None if t is None else t.data_ptr())
    rc = lib.int8_matmul(
        ptr(x), ptr(w), ptr(s), ptr(y), ptr(part), M, K, N,
        _K6_DTYPES[x.dtype], warps, splits,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(lib, rc, "int8_matmul")
    _build.LAUNCHES[K6_BODIES[x.dtype]] += 1
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
