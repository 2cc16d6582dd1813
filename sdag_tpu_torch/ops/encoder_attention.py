"""Fused bidirectional (encoder) attention for the E5 ranker (PyTorch).

Counterpart of ``sdag_tpu/ops/encoder_attention.py``.  The packed entry
takes the QKV projection output ``[B, L, 3d]`` as it is (column order
``[q heads | k heads | v heads]``, the ``models.e5.fuse_qkv_params``
layout) and returns ``[B, L, d]`` ready for the output projection: no
split copies, no ``[B,L,H,Dh] -> [B,H,L,Dh]`` transposes, and the
``[B, H, L, L]`` scores never reach device memory.

* ``encoder_attention_fused_qkv``: kernel K3 (``csrc/encoder_attention.cu``)
  on a CUDA tensor; on a CPU tensor its plain version
  ``encoder_attention_qkv_reference``, which repeats the kernel's
  arithmetic (scale folded into q in q's dtype, masked columns at -1e30,
  P rounded to v's dtype for P.V, division after P.V);
* ``encoder_attention_reference``: the textbook form over head-major
  tensors with the ``[B, H, L, L]`` probabilities materialised.

Masking contract: attention-mask rows are contiguous prefixes (the
tokenizer right-pads), so the mask is one valid length per batch row.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sdag_tpu_torch import _build

_NEG = -1e30
K3_HEAD_DIMS = (32, 64, 128)
_K3_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# launch-count key per kernel body (wgmma bf16, split-TF32 mma.sync f32)
K3_BODIES = {torch.float32: "encoder_attention_f32",
             torch.bfloat16: "encoder_attention_bf16"}


def encoder_attention_qkv_reference(qkv: torch.Tensor,
                                    valid_len: torch.Tensor,
                                    n_heads: int) -> torch.Tensor:
    """Plain version of kernel K3 on the packed layout: qkv [B, L, 3d],
    valid_len [B] -> [B, L, d] in qkv's dtype.  A row with valid_len 0
    attends all L columns uniformly; query rows past valid_len attend the
    valid prefix (mean pooling drops them later)."""
    B, L, d3 = qkv.shape
    d = d3 // 3
    dh = d // n_heads
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(B, L, n_heads, dh)
               for i in range(3))
    q = q * torch.tensor(dh ** -0.5, dtype=q.dtype, device=q.device)
    s = torch.einsum("bihd,bjhd->bhij", q.float(), k.float())
    col = torch.arange(L, device=qkv.device)
    s = torch.where(col[None, None, None, :]
                    < valid_len.to(qkv.device)[:, None, None, None], s, _NEG)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    denom = p.sum(-1, keepdim=True)                       # [B, H, L, 1]
    o = torch.einsum("bhij,bjhd->bhid", p.to(v.dtype).float(), v.float())
    o = (o / denom).to(qkv.dtype)
    return o.permute(0, 2, 1, 3).reshape(B, L, d)


# launch plan of the bf16 body (csrc/encoder_attention.cu
# encoder_attention_wgmma_kernel; EncLayout there mirrors _k3_smem_bytes)
K3_TILE = 64               # q rows and key rows per tile
K3_Q_BUFS = 2              # each warpgroup's Q tile, double-buffered
K3_ITEM_WORDS = 8          # ints of a round's record
K3_MAX_STAGES = 16
K3_SMEM_LIMIT = 232448     # dynamic shared memory a block may use
K3_SM_SMEM = 233472        # shared memory of an SM
K3_BLOCK_RESERVED = 1024   # shared memory the card reserves per block
# the kernel's __launch_bounds__ minimum blocks per SM, by (warpgroups, Dh)
K3_MIN_BLOCKS = {(1, 32): 2, (1, 64): 2, (1, 128): 2,
                 (2, 32): 1, (2, 64): 1, (2, 128): 1}


def _k3_smem_bytes(dh: int, nwg: int, stages: int) -> int:
    tile = K3_TILE * dh * 2
    return (K3_Q_BUFS * nwg * tile + stages * 2 * tile
            + K3_Q_BUFS * K3_ITEM_WORDS * 4 + (2 * stages + 2 * K3_Q_BUFS) * 8)


# launch plan of the f32 body (csrc/encoder_attention.cu
# encoder_attention_f32_kernel; F32Geom there mirrors these)
K3F_STAGES = 2             # cp.async K/V ring stages
K3F_MIN_BLOCKS = {32: 3, 64: 2, 128: 1}   # the kernel's __launch_bounds__


def _k3f_smem_bytes(dh: int) -> int:
    """Two stages of a K and a V tile, and at Dh = 128 the block's q rows."""
    return (K3F_STAGES * 2 + (dh == 128)) * K3_TILE * dh * 4


def _f32_geometry(B: int, H: int, L: int, dh: int) -> dict:
    """The f32 body's plan in the bf16 plan's terms: one block per unit,
    unit u = p * q_tiles + qt (pair p = b * H + h, q-tile qt), so a pair's
    q-tiles are neighbours in the grid."""
    nqt = -(-L // K3_TILE)
    smem = _k3f_smem_bytes(dh)
    blocks_per_sm = min(K3F_MIN_BLOCKS[dh],
                        K3_SM_SMEM // (smem + K3_BLOCK_RESERVED))
    return {"nwg": 1, "stages": K3F_STAGES, "q_tiles": nqt, "rounds": nqt,
            "pairs": B * H, "splits": nqt, "per_unit": 1,
            "blocks_per_sm": blocks_per_sm, "grid": B * H * nqt,
            "smem_bytes": smem}


@functools.lru_cache(maxsize=256)
def encoder_attention_geometry(B: int, H: int, L: int, dh: int,
                               sms: int, dtype: str = "bfloat16") -> dict:
    """Launch plan of K3, a pure function of the shapes, the SM count and
    the body ("bfloat16" or "float32"; the f32 plan is ``_f32_geometry``).
    The bf16 body's:

    * ``nwg``: consumer warpgroups a block, one 64-row q-tile each per
      round: 2, or 1 when a sequence is a single q-tile (L <= 64), where
      two one-warpgroup blocks share an SM instead.
    * ``stages``: K/V ring stages, as many as fit beside the Q tiles of the
      ``blocks_per_sm`` blocks an SM holds (the kernel's register bound, or
      fewer blocks where 3 stages do not fit), at least 3 (a tile step
      waits for tile t + 1 before it frees tile t - 1), at most 16.  When
      they hold every key tile of a sequence the tiles stay resident (a
      (batch, head) pair's K/V is read once however many rounds its
      q-tiles take); the stages beyond a pair's tiles take the next pair's
      tiles while this one still runs.
    * ``splits``: shares of a pair's ``rounds`` rounds, 1 unless the
      pairs alone would leave block slots idle; unit u = p * splits + i is
      pair p = b * H + h, rounds [i * per_unit, (i + 1) * per_unit),
      warpgroup w taking q-tile round * nwg + w.
    * ``grid``: persistent blocks, at most ``blocks_per_sm`` on every SM;
      block x walks units x, x + grid, ....
    """
    if dtype == "float32":
        return _f32_geometry(B, H, L, dh)
    nqt = -(-L // K3_TILE)
    nwg = 1 if nqt == 1 else 2
    blocks_per_sm = K3_MIN_BLOCKS[(nwg, dh)]
    while True:
        budget = min(K3_SMEM_LIMIT,
                     K3_SM_SMEM // blocks_per_sm - K3_BLOCK_RESERVED)
        fit = [s for s in range(3, K3_MAX_STAGES + 1)
               if _k3_smem_bytes(dh, nwg, s) <= budget]
        if fit or blocks_per_sm == 1:
            break
        blocks_per_sm -= 1
    stages = fit[-1]
    smem = _k3_smem_bytes(dh, nwg, stages)
    pairs = B * H
    rounds = -(-nqt // nwg)
    slots = sms * blocks_per_sm
    splits = min(rounds, max(1, slots // pairs))
    per_unit = -(-rounds // splits)
    splits = -(-rounds // per_unit)
    return {"nwg": nwg, "stages": stages, "q_tiles": nqt, "rounds": rounds,
            "resident": nqt <= stages, "pairs": pairs, "splits": splits,
            "per_unit": per_unit, "blocks_per_sm": blocks_per_sm,
            "grid": max(1, min(pairs * splits, slots)), "smem_bytes": smem}


def encoder_attention_work(geom: dict, H: int, block: int):
    """(b, h, q-tile, warpgroup) a block of the plan computes, in its
    order; idle warpgroups of a last round are left out."""
    for unit in range(block, geom["pairs"] * geom["splits"], geom["grid"]):
        pair, part = divmod(unit, geom["splits"])
        r0 = part * geom["per_unit"]
        for r in range(r0, min(geom["rounds"], r0 + geom["per_unit"])):
            for w in range(geom["nwg"]):
                qt = r * geom["nwg"] + w
                if qt < geom["q_tiles"]:
                    yield pair // H, pair % H, qt, w


def _k3_lib():
    lib = _build.load("encoder_attention")
    if lib.encoder_attention.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.encoder_attention.argtypes = [p, p, p, i, i, i, i,
                                          ctypes.c_float, i, i, i, i, i, p]
        lib.encoder_attention.restype = i
    return lib


def encoder_attention_cuda(qkv: torch.Tensor, valid_len: torch.Tensor,
                           n_heads: int) -> torch.Tensor:
    """Kernel K3: qkv [B, L, 3d] contiguous on CUDA (float32 or bfloat16),
    head dim 32/64/128; valid_len [B] on the same device."""
    if qkv.device.type != "cuda" or valid_len.device != qkv.device:
        raise ValueError("encoder_attention_cuda: qkv and valid_len must "
                         "be on one CUDA device")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * n_heads):
        raise ValueError(f"encoder_attention_cuda: qkv shape "
                         f"{tuple(qkv.shape)} is not [B, L, 3*{n_heads}*Dh]")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("encoder_attention_cuda: qkv must be contiguous "
                         "and 16-byte aligned")
    B, L, d3 = qkv.shape
    d = d3 // 3
    dh = d // n_heads
    if qkv.dtype not in _K3_DTYPES or dh not in K3_HEAD_DIMS:
        raise ValueError(f"encoder_attention_cuda: dtype {qkv.dtype} / head "
                         f"dim {dh} unsupported (float32 or bfloat16, "
                         f"{K3_HEAD_DIMS})")
    if valid_len.shape != (B,):
        raise ValueError("encoder_attention_cuda: valid_len must be [B]")
    vl = valid_len.to(torch.int32).contiguous()
    out = torch.empty(B, L, d, dtype=qkv.dtype, device=qkv.device)
    geom = encoder_attention_geometry(B, n_heads, L, dh,
                                      _build.sm_count(qkv.device),
                                      str(qkv.dtype).split(".")[1])
    lib = _k3_lib()
    rc = lib.encoder_attention(
        ctypes.c_void_p(qkv.data_ptr()), ctypes.c_void_p(vl.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), B, n_heads, L, dh, dh ** -0.5,
        _K3_DTYPES[qkv.dtype], geom["nwg"], geom["stages"], geom["splits"],
        geom["grid"],
        ctypes.c_void_p(torch.cuda.current_stream(qkv.device).cuda_stream))
    _build.check(lib, rc, "encoder_attention")
    _build.LAUNCHES[K3_BODIES[qkv.dtype]] += 1
    return out


def encoder_attention_fused_qkv(qkv: torch.Tensor, valid_len: torch.Tensor,
                                n_heads: int) -> torch.Tensor:
    """Packed-projection entry: qkv [B, L, 3d], the fused QKV matmul
    output untouched; valid_len [B] prefix lengths.  Returns [B, L, d] in
    qkv's dtype.  Kernel K3 on CUDA, the plain version on the CPU; any
    other device raises."""
    if qkv.device.type == "cpu":
        return encoder_attention_qkv_reference(qkv, valid_len, n_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"encoder_attention_fused_qkv: no path for device "
                         f"{qkv.device}")
    return encoder_attention_cuda(qkv, valid_len, n_heads)


def encoder_attention_fused(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, valid_len: torch.Tensor
                            ) -> torch.Tensor:
    """Separate-tensor entry (test/compat surface): q/k/v [B, L, H, Dh].
    Packs to the [B, L, 3d] projection layout (one concat) and runs the
    packed entry.  Returns [B, L, H*Dh]."""
    B, L, H, Dh = q.shape
    packed = torch.cat([t.reshape(B, L, H * Dh) for t in (q, k, v)], dim=-1)
    return encoder_attention_fused_qkv(packed, valid_len, n_heads=H)


def encoder_attention_reference(q, k, v, valid_len):
    """Textbook reference with the [B, H, L, L] probabilities materialised.
    q/k/v: [B, H, L, Dh] (head-major).  Returns [B, H, L, Dh] in q's
    dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * scale
    col = torch.arange(s.shape[-1], device=q.device)
    s = torch.where(col[None, None, None, :]
                    < valid_len.to(q.device)[:, None, None, None], s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhij,bhjd->bhid", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)
