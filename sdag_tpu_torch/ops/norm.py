"""A decoder layer's residual add and the RMSNorm after it (PyTorch).

``add_rms_norm(x, delta, w, eps)`` returns ``(s, h)``: s = x + delta in
x's dtype (s = x when delta is None) and h = RMSNorm(s) * w, with the
rounding points of the plain composition (``add_rms_norm_reference``):
``x + delta``, then the f32 row mean of squares, ``rsqrt(var + eps)``, the
product cast back to the dtype, times the gain.

On CUDA, with no gradient to record, one hand-written kernel computes both
(``csrc/rms_norm.cu``, kernel K9; bf16 and f32 bodies): each row of x and
delta read once, s and h written once, every row count in one launch.
Only the order of the f32 sum over a row differs from the plain
composition, and that order is fixed by d alone (``k9_plan``), so a row
gives the same bits alone or among any number of rows.  On the CPU and
under autograd (training, GPipe) the plain composition runs; no other
condition turns the card away from the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from sdag_tpu_torch import _build

# K9 (csrc/rms_norm.cu): the most threads a row, the most 16-byte vectors a
# thread holds (d <= 16,384 in bf16, 8,192 in f32), the dtypes it serves
K9_THREADS = 256
K9_MAX_VECTORS = 8
_K9_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm_reference(x: torch.Tensor, w: torch.Tensor,
                       eps: float) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def add_rms_norm_reference(x: torch.Tensor, delta: Optional[torch.Tensor],
                           w: torch.Tensor, eps: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel K9: (x + delta, rms_norm of it)."""
    s = x if delta is None else x + delta
    return s, rms_norm_reference(s, w, eps)


def k9_plan(d: int, dtype) -> Tuple[int, int]:
    """(threads a row, 16-byte vectors a thread) of K9 for rows of ``d``
    elements of ``dtype``: the fewest vectors a thread that keep a row to
    ``K9_THREADS`` threads, then the fewest whole warps that hold the row.
    The row's sum order follows from these alone."""
    vectors = d * torch.empty((), dtype=dtype).element_size() // 16
    vpt = -(-vectors // K9_THREADS)
    return 32 * -(-vectors // (vpt * 32)), vpt


def _k9_lib():
    lib = _build.load("rms_norm")
    if lib.rms_norm.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rms_norm.argtypes = [p] * 5 + [i] * 6 + [ctypes.c_float, p]
        lib.rms_norm.restype = i
    return lib


def _k9_rows(name: str, t: torch.Tensor, x: torch.Tensor) -> None:
    if t.dtype != x.dtype or t.shape != x.shape:
        raise ValueError(f"add_rms_norm_cuda: {name} {tuple(t.shape)} "
                         f"{t.dtype} does not match x {tuple(x.shape)} "
                         f"{x.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"add_rms_norm_cuda: {name}'s rows must be "
                         "contiguous and 16-byte aligned")


def add_rms_norm_cuda(x: torch.Tensor, delta: Optional[torch.Tensor],
                      w: torch.Tensor, eps: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K9 (``csrc/rms_norm.cu``), one launch: x [..., d] (and delta
    of x's shape, or None) contiguous, float32 or bfloat16, d a multiple
    of 8 up to ``k9_plan``'s limit; w [d] contiguous of x's dtype.
    Returns (s, h) as ``add_rms_norm_reference`` (s is x itself when delta
    is None).  Each launch counts in ``_build.LAUNCHES["rms_norm"]`` (at
    capture, in a CUDA graph)."""
    if x.dtype not in _K9_DTYPES:
        raise ValueError(f"add_rms_norm_cuda: dtype {x.dtype} unsupported "
                         "(float32 or bfloat16)")
    d = x.shape[-1] if x.dim() else 0
    if d < 8 or d % 8:
        raise ValueError(f"add_rms_norm_cuda: row width {d} must be a "
                         "positive multiple of 8")
    nt, vpt = k9_plan(d, x.dtype)
    if vpt > K9_MAX_VECTORS:
        raise ValueError(f"add_rms_norm_cuda: row width {d} too wide")
    _k9_rows("x", x, x)
    if delta is not None:
        _k9_rows("delta", delta, x)
    if w.dtype != x.dtype or tuple(w.shape) != (d,) \
            or not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError(f"add_rms_norm_cuda: w {tuple(w.shape)} {w.dtype} "
                         f"must be contiguous [{d}] {x.dtype}")
    tensors = [x, w] + ([] if delta is None else [delta])
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("add_rms_norm_cuda: every tensor must be on x's "
                         "CUDA device")
    rows = x.numel() // d
    if rows == 0:
        return add_rms_norm_reference(x, delta, w, eps)
    h = torch.empty_like(x)
    s = None if delta is None else torch.empty_like(x)
    _build.launch(_k9_lib(), "rms_norm", x, delta, w, s, h, rows, d, nt, vpt,
                  _build.sm_count(x.device), _K9_DTYPES[x.dtype], eps,
                  device=x.device, count_key="rms_norm")
    return (x if s is None else s), h


def add_rms_norm(x: torch.Tensor, delta: Optional[torch.Tensor],
                 w: torch.Tensor, eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x + delta, RMSNorm of it times w); delta None: (x, RMSNorm(x) * w).
    The plain composition on the CPU; on CUDA, kernel K9, unless a gradient
    is to be recorded (training, GPipe), the one condition that takes the
    plain composition on the card.  K9 raises on what it does not serve
    (another dtype, a row width it cannot hold); any other device raises."""
    if x.device.type == "cpu":
        return add_rms_norm_reference(x, delta, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"add_rms_norm: no path for device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, delta, w)):
        return add_rms_norm_reference(x, delta, w, eps)
    return add_rms_norm_cuda(x, delta, w, eps)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm(x) * w: ``add_rms_norm`` with no residual."""
    return add_rms_norm(x, None, w, eps)[1]
