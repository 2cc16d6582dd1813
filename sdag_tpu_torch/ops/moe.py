"""Sparse experts: routing, the prefill's expert products, and the decode
step's expert layer (kernel K8 on CUDA).

No TPU kernel precedes this: the JAX package serves dense decoders only.
An expert layer's weights are ``{"router": [d, E], "gate_up": [E, 2F, d],
"down": [E, d, F]}``: the router as the dense weights ([in, out], ``x @
w``), each expert's matrices [out, in] (one output channel contiguous, as
K8 streams them; gate rows first, then up rows).

Routing (``route``): logits u @ router in f32, softmax over all E experts
in f32, the top k, divided by their sum where ``norm_topk``.  An expert's
output is down(SiLU(gate u) * up u), and the layer's output sum_e w_e *
expert_e(u).

Prefill (``moe_prefill``) routes the valid rows only (no right padding,
no holes), sorts the (token, expert) rows by expert and runs each
expert's two products over its rows: on CUDA one grouped product
(``torch._grouped_mm``) a matrix, which beat one cuBLAS product an
expert (the group sizes read on the host) on the H100, 11.5 against
13.4 ms a layer at 23,200 tokens; on the CPU one product an expert.
Spans ``sdag.moe.route`` and ``sdag.moe.experts`` cover the two
halves.

Decode (``moe_decode``): the routing and experts of a step's rows, with no
host value, so a CUDA graph captures it: K8 (``csrc/moe_experts.cu``) on
CUDA, the plain version ``moe_experts_reference`` on the CPU.  Both add
the number of distinct experts they read to a device counter.

K8 is bound by the bytes of the picked experts (three matrices each, read
once a step whatever the rows that picked them).  Four launches a call:
the route, split over 32 slices of d, whose last block builds a work list
on the device (the distinct picked experts in ascending order, each one's
picks in pick order; the distinct-expert counter reads its length); gate/up
and down, each a persistent block an SM over the list's tiles ((expert, 4
columns of F: their gate and up rows); (expert, 8 rows of down)), every
block an equal run of them; then each row's weighted sum.  A producer
thread streams each tile's rows into a shared-memory ring by bulk copies
on mbarriers, after x's rows (gate/up) or each expert's h (down) where they
fit; a consumer warp a slot multiplies them with its picks' rows on the
tensor cores (``mma.sync``, bf16 in, f32 out, 64-column blocks on a fresh
accumulator added in f32; h stored as three bf16 parts whose sum is h
exactly).  Every sum runs in an order fixed by d and F, so a row's bits
depend on its own picks only.  ``k8_plan`` sizes the grid, the rings and
what is staged, once, from B, the widths and the SM count.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from sdag_tpu_torch import _build
from sdag_tpu_torch.utils.profiling import span

def route(u: torch.Tensor, router: torch.Tensor, k: int,
          norm_topk: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights f32 [T, k], experts int64 [T, k]) of rows u [T, d]."""
    probs = torch.softmax(u.float() @ router.float(), -1)
    w, idx = torch.topk(probs, k, dim=-1)
    if norm_topk:
        w = w / w.sum(-1, keepdim=True)
    return w, idx


def _swiglu(gu: torch.Tensor) -> torch.Tensor:
    f = gu.shape[-1] // 2
    return torch.nn.functional.silu(gu[..., :f]) * gu[..., f:]


def expert_products(u: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                    gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """sum_j w[t, j] * expert_idx[t, j](u[t]) for rows u [T, d], in u's
    dtype: the (token, expert) rows sorted by expert, each expert's
    products over its rows (a row's weight multiplies its SiLU * up before
    the down product, which is linear), then each token's k weighted rows
    summed in f32.  One grouped product a matrix on CUDA, one product an
    expert elsewhere."""
    return _expert_products(u, w, idx, gate_up, down, u.device.type == "cuda")


def _expert_products(u, w, idx, gate_up, down, grouped: bool):
    T, k = idx.shape
    n_exp = gate_up.shape[0]
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    xs = u.index_select(0, order // k)
    ws = w.reshape(-1)[order, None]
    counts = torch.bincount(flat, minlength=n_exp)
    if grouped:
        offs = counts.cumsum(0).to(torch.int32)
        h = _swiglu(torch._grouped_mm(xs, gate_up.transpose(1, 2),
                                      offs=offs))
        ys = torch._grouped_mm((h * ws).to(u.dtype), down.transpose(1, 2),
                               offs=offs)
    else:
        ys = torch.empty_like(xs)
        start = 0
        for e, end in enumerate(counts.cumsum(0).tolist()):
            if end > start:
                h = _swiglu(xs[start:end] @ gate_up[e].T) * ws[start:end]
                ys[start:end] = h.to(u.dtype) @ down[e].T
            start = end
    y = torch.empty_like(ys).index_copy_(0, order, ys).view(T, k, -1)
    return y.sum(1, dtype=torch.float32).to(u.dtype)


def moe_prefill(moe: Dict[str, torch.Tensor], cfg, h: torch.Tensor,
                rows: torch.Tensor, stats: Optional[dict] = None,
                routes: Optional[list] = None) -> torch.Tensor:
    """An expert layer over a prefill's normed states h [B, L, d]: the
    rows ``rows`` names (int64 indices into the B * L rows) are routed and
    summed over their experts, every other row gives 0.
    ``stats["moe_prefill_rows"]`` gains the (token, expert) rows routed;
    the list ``routes`` gains (rows, the experts picked: int64 [rows,
    k])."""
    B, L, d = h.shape
    flat = h.reshape(B * L, d)
    with span("sdag.moe.route"):
        u = flat.index_select(0, rows)
        w, idx = route(u, moe["router"], cfg.experts_per_token,
                       cfg.norm_topk_prob)
    with span("sdag.moe.experts"):
        y = expert_products(u, w, idx, moe["gate_up"], moe["down"])
        out = torch.zeros_like(flat).index_copy_(0, rows, y)
    if stats is not None:
        stats["moe_prefill_rows"] = stats.get("moe_prefill_rows", 0) + \
            int(idx.numel())
    if routes is not None:
        routes.append((rows, idx))
    return out.view(B, L, d)


def _distinct_experts(idx: torch.Tensor, live: torch.Tensor,
                      n_exp: int) -> torch.Tensor:
    """How many experts the live rows' picks name, int64 [1]."""
    picks = torch.where(live[:, None], idx, n_exp).reshape(-1)
    used = torch.zeros(n_exp + 1, dtype=torch.bool, device=idx.device)
    return used.index_fill_(0, picks, True)[:n_exp].sum().reshape(1)


def moe_experts_reference(x: torch.Tensor, router: torch.Tensor,
                          gate_up: torch.Tensor, down: torch.Tensor, k: int,
                          norm_topk: bool = True,
                          row_live: Optional[torch.Tensor] = None,
                          reads: Optional[torch.Tensor] = None,
                          idx_out: Optional[torch.Tensor] = None,
                          routes=None) -> torch.Tensor:
    """The plain version of kernel K8: route rows x [B, d] (or take
    ``routes`` = (weights, experts)), then each live row's sum over its k
    experts in f32 (SwiGLU products in f32 of the stored values), rounded
    once to x's dtype; rows ``row_live`` leaves out give 0.  ``reads``
    (int64 [1]) gains the distinct experts the live rows pick; ``idx_out``
    (int32 [B, k]) receives the picks, -1 for a row not live."""
    B = x.shape[0]
    live = torch.ones(B, dtype=torch.bool, device=x.device) \
        if row_live is None else row_live
    w, idx = route(x, router, k, norm_topk) if routes is None else routes
    if reads is not None:
        reads += _distinct_experts(idx, live, gate_up.shape[0])
    if idx_out is not None:
        idx_out.copy_(torch.where(live[:, None], idx, -1))
    xf = x.float()
    out = torch.zeros(B, down.shape[1], dtype=torch.float32, device=x.device)
    for j in range(k):
        e = idx[:, j]
        gu = torch.einsum("bd,bnd->bn", xf, gate_up[e].float())
        y = torch.einsum("bf,bdf->bd", _swiglu(gu), down[e].float())
        out += torch.where(live[:, None], w[:, j:j + 1] * y, 0.0)
    return out.to(x.dtype)


# what K8 (csrc/moe_experts.cu) is built for: expert counts, the most
# experts a token, the most rows a call; its launches a call
K8_EXPERTS = (64, 128, 256)
K8_MAX_TOPK = 32
K8_MAX_ROWS = 1024
K8_LAUNCHES = 4
# the kernel's constants: slices of d the logits are summed in, weight
# rows a tile (the mma's n: a gate/up tile holds 4 columns' gate and up
# rows, a down tile 8 rows), consumer warps of an expert block (one a
# ring slot), the barriers' bytes before a ring, a block's shared memory
# on sm_90
K8_SLICES = 32
K8_TILE_ROWS = 8
K8_WARPS = 16
K8_BAR_BYTES = 1024
K8_SMEM_LIMIT = 232448
# the bytes of weights a ring holds: tiles in flight cover HBM's latency
# at the SM's share of the bandwidth; at most 164 KB of shared memory
# leaves ~90 KB of L1 for the picks' x and h rows the tiles are read with
K8_RING_BYTES = 160 * 1024


def k8_row_stride(n: int) -> int:
    """Bytes between rows of n bf16 in shared memory (a tile's, or staged
    x or h): the row padded to 8 more 32-bit words than a multiple of 16,
    so that the 8 rows an mma reads by 8-byte loads fall on distinct
    banks."""
    return 2 * n + 4 * ((8 - n // 2 % 16) % 16)


def k8_plan(B: int, d: int, f: int, sms: int) -> Dict[str, int]:
    """K8's launch plan for B rows at widths d and F on a card of ``sms``
    SMs: one persistent block an SM for gate/up and down, and each ring's
    slots with its shared-memory bytes: as many tiles as
    ``K8_RING_BYTES`` holds, at least one and at most ``K8_WARPS`` (each
    slot has its own consumer warp).  A tile is ``K8_TILE_ROWS`` rows of d
    (gate/up) or F (down) bf16.  After its ring, gate/up stages x's B rows
    and down an expert's picks' h (three bf16 parts, at most B picks),
    each where it fits (``x_staged``, ``h_staged``); else their warps read
    them from device memory.  Raises when one tile does not fit a block's
    shared memory."""
    plan = {"grid": int(sms)}
    for name, n in (("gate_up", d), ("down", f)):
        tile = K8_TILE_ROWS * k8_row_stride(n)
        slots = max(1, min(K8_WARPS, K8_RING_BYTES // tile))
        smem = K8_BAR_BYTES + slots * tile
        if smem > K8_SMEM_LIMIT:
            raise ValueError(f"k8_plan: a {name} tile of {tile} bytes (d "
                             f"{d}, F {f}) does not fit shared memory")
        plan[name + "_slots"], plan[name + "_smem"] = slots, smem
    for name, flag, staged in (("gate_up", "x_staged", B * k8_row_stride(d)),
                               ("down", "h_staged",
                                3 * B * k8_row_stride(f))):
        plan[flag] = int(plan[name + "_smem"] + staged <= K8_SMEM_LIMIT)
        plan[name + "_smem"] += staged * plan[flag]
    return plan


def k8_items(d: int, f: int, experts: int) -> int:
    """The tiles a K8 call streams when its rows pick ``experts`` distinct
    experts: 4 columns of F (gate/up) and 8 rows of down (columns of d)
    an expert's tile."""
    return experts * (f // (K8_TILE_ROWS // 2) + d // K8_TILE_ROWS)


def k8_scratch_sizes(B: int, d: int, f: int, n_exp: int,
                     k: int) -> Tuple[int, int]:
    """Elements of K8's f32 scratch (the logits' partials by slice, the
    down products y, then h as three bf16 planes: two to an element) and
    int32 scratch (the work list: its length, the experts, their starts,
    the picks)."""
    P = B * k
    return (K8_SLICES * B * n_exp + P * d + 3 * P * f // 2,
            2 + 2 * n_exp + P)


# the route's tickets a device (one for the row groups, one a group of 8
# rows), zeroed once; the kernel resets them as it goes
_K8_STATE: Dict[torch.device, torch.Tensor] = {}


def _k8_state(dev: torch.device) -> torch.Tensor:
    state = _K8_STATE.get(dev)
    if state is None:
        state = torch.zeros(1 + K8_MAX_ROWS // 8, dtype=torch.int32,
                            device=dev)
        _K8_STATE[dev] = state
    return state


def _k8_lib():
    lib = _build.load("moe_experts")
    if lib.moe_experts.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_experts.argtypes = [p] * 12 + [i] * 12 + [p]
        lib.moe_experts.restype = i
    return lib


def moe_experts_cuda(x: torch.Tensor, router: torch.Tensor,
                     gate_up: torch.Tensor, down: torch.Tensor, k: int,
                     norm_topk: bool = True,
                     row_live: Optional[torch.Tensor] = None,
                     reads: Optional[torch.Tensor] = None,
                     idx_out: Optional[torch.Tensor] = None,
                     w_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K8 (``csrc/moe_experts.cu``), four launches: route each row
    and build the work list of the picked experts, gate/up + SiLU of each
    picked expert over its picks, down of each, each row's weighted sum.
    x [B, d] bf16 with contiguous rows;
    router [d, E] and gate_up [E, 2F, d], down [E, d, F] bf16 contiguous,
    E in ``K8_EXPERTS``, k <= ``K8_MAX_TOPK``, d and F multiples of 8;
    row_live bool [B] (all rows when None); reads int64 [1] on x's device
    (the distinct experts read are added to it); the routes go to
    ``idx_out`` (int32 [B, k], -1 for a row not live) and ``w_out`` (f32
    [B, k]), contiguous on x's device, where given.  Returns [B, d]
    bf16.
    Each launch counts in ``_build.LAUNCHES["moe_experts"]``."""
    B, d = x.shape
    n_exp, f2, d2 = gate_up.shape
    f = f2 // 2
    for name, t in (("x", x), ("router", router), ("gate_up", gate_up),
                    ("down", down)):
        if t.device.type != "cuda" or t.dtype != torch.bfloat16:
            raise ValueError(f"moe_experts_cuda: {name} must be a bf16 CUDA "
                             "tensor")
        if t.stride(-1) != 1 or t.data_ptr() % 16:
            raise ValueError(f"moe_experts_cuda: {name} needs contiguous, "
                             "16-byte aligned rows")
    if not (router.is_contiguous() and gate_up.is_contiguous()
            and down.is_contiguous()) or x.stride(0) % 8:
        raise ValueError("moe_experts_cuda: weights must be contiguous and "
                         "x's rows 16-byte aligned")
    if d2 != d or tuple(router.shape) != (d, n_exp) \
            or tuple(down.shape) != (n_exp, d, f) or f2 != 2 * f:
        raise ValueError(f"moe_experts_cuda: shapes x {tuple(x.shape)}, "
                         f"router {tuple(router.shape)}, gate_up "
                         f"{tuple(gate_up.shape)}, down {tuple(down.shape)}")
    if n_exp not in K8_EXPERTS or not 1 <= k <= min(K8_MAX_TOPK, n_exp) \
            or d % 8 or f % 8 or not 1 <= B <= K8_MAX_ROWS:
        raise ValueError(f"moe_experts_cuda: {n_exp} experts, top {k}, d "
                         f"{d}, F {f} unsupported")
    dev = x.device
    if row_live is not None and (row_live.dtype != torch.bool
                                 or tuple(row_live.shape) != (B,)
                                 or not row_live.is_contiguous()):
        raise ValueError("moe_experts_cuda: row_live must be bool [B]")
    if reads is not None and (reads.dtype != torch.int64
                              or reads.numel() != 1):
        raise ValueError("moe_experts_cuda: reads must be one int64")
    for name, t, dt in (("idx_out", idx_out, torch.int32),
                        ("w_out", w_out, torch.float32)):
        if t is not None and (t.dtype != dt or tuple(t.shape) != (B, k)
                              or not t.is_contiguous()):
            raise ValueError(f"moe_experts_cuda: {name} must be {dt} "
                             f"[{B}, {k}], contiguous")
    if any(t is not None and t.device != dev
           for t in (row_live, reads, idx_out, w_out)) \
            or any(t.device != dev for t in (router, gate_up, down)):
        raise ValueError("moe_experts_cuda: every tensor must be on x's "
                         "device")
    plan = k8_plan(B, d, f, _build.sm_count(dev))
    i32 = dict(dtype=torch.int32, device=dev)
    idx = torch.empty((B, k), **i32) if idx_out is None else idx_out
    w = torch.empty((B, k), dtype=torch.float32, device=dev) \
        if w_out is None else w_out
    n_f32, n_i32 = k8_scratch_sizes(B, d, f, n_exp, k)
    fs = torch.empty(n_f32, dtype=torch.float32, device=dev)
    is_ = torch.empty(n_i32, **i32)
    out = torch.empty((B, d), dtype=torch.bfloat16, device=dev)
    _build.launch(
        _k8_lib(), "moe_experts", x, router, gate_up, down, row_live, idx, w,
        fs, is_, _k8_state(dev), out, reads, B, d, f, n_exp, k,
        int(x.stride(0)), int(norm_topk), plan["grid"], plan["gate_up_slots"],
        plan["down_slots"], plan["x_staged"], plan["h_staged"], device=dev,
        count_key="moe_experts", n=K8_LAUNCHES)
    return out


def moe_decode(moe: Dict[str, torch.Tensor], cfg, h: torch.Tensor,
               reads: Optional[torch.Tensor] = None,
               row_live: Optional[torch.Tensor] = None,
               routes_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A decode step's expert layer over normed rows h [B, d]: kernel K8 on
    CUDA, the plain version on the CPU; any other device raises.
    ``routes_out`` (int32 [B, k]) receives the picks, -1 for a row not
    live."""
    args = (h, moe["router"], moe["gate_up"], moe["down"],
            cfg.experts_per_token, cfg.norm_topk_prob, row_live, reads,
            routes_out)
    if h.device.type == "cpu":
        return moe_experts_reference(*args)
    if h.device.type != "cuda":
        raise ValueError(f"moe_decode: no path for device {h.device}")
    return moe_experts_cuda(*args)
