"""SDAG block-sparse prefill attention + causal decode attention (PyTorch).

Counterpart of ``sdag_tpu/ops/attention.py``.  The four Pallas schedules
there (grid, KV-resident, worklist, splash) compute one function; on
Hopper one hand-written CUDA kernel covers them all:
``csrc/sdag_prefill.cu`` (kernel K1).  ``sdag_prefill_attention`` runs K1
on a CUDA tensor and the plain dense-mask version
(``sdag_attention_reference``) on a CPU tensor; any other device raises.

K1 walks, per (batch, q-tile), the packed list of live key tiles
(``compute_block_kinds`` + ``_pack_kv_lists`` at K1's own 64x64 tiles) and
specializes the mask by tile kind: FULL tiles take no mask, CAUSAL tiles
the 3-op causal rule, PARTIAL tiles the full SDAG rule as bit tiles that
the plan evaluates once per prefill for all layers and heads
(``partial_tile_masks``; the TPU path's int8 mask tiles, ``use_mask_tiles``,
are the same trade).  Both bodies take work heaviest q-tile first
(``heavy_first_order``).
bf16 inputs run on the tensor cores (wgmma fed by TMA, f32 accumulation,
two q heads of a GQA group sharing each K/V tile); f32 inputs stay f32 on
CUDA-core FMA (K/V tiles staged by cp.async, two q heads of an even GQA
group sharing each K/V tile).

Decode keeps reference semantics: generated tokens attend the whole cache
with plain causal attention; it is plain PyTorch (XLA in the JAX package),
over a native or an int8 cache (per-slot scales folded into the scores and
the probabilities), one token or a speculative verification window a row.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sdag_tpu_torch import _build
from sdag_tpu_torch.ops.topk import quantize_last_axis_int8

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

HOLE = -2  # inactive padding (block-aligned packing); see sdag/mask.py

BLOCK_SKIP, BLOCK_FULL, BLOCK_PARTIAL, BLOCK_CAUSAL = 0, 1, 2, 3

# K1's tile sizes (csrc/sdag_prefill.cu BQ/BK); block kinds are computed at
# these sizes, not at the TPU kernels' 512
K1_BLOCK_Q = 64
K1_BLOCK_K = 64
K1_HEAD_DIMS = (32, 64, 128)
_ROW_CHUNK = 1024   # q rows per dense-mask step of the plain version


def _tile_mask(i, j, dq, dk, nbr_q, sys_user_len, valid_len):
    """Token-level SDAG attention rule (broadcasting tensors).

    i, j: global row/col indices; dq, dk: doc ids (-1 = non-doc, -2 = hole);
    nbr_q: neighbor bitmask of the q rows; sys_user_len/valid_len scalars.
    Hole keys are never visible; hole rows behave causally (outputs unused).
    """
    causal = j <= i
    is_doc_q = dq >= 0
    same_doc = (dq == dk) & is_doc_q
    prefix = (dk == -1) & (j < sys_user_len)
    # neighbor windows only address docs 0..31; bit dk of the int32 mask
    # ((x >> s) & 1 is the same for arithmetic and logical shifts)
    nbr = (dk >= 0) & (dk < 32) & (
        ((nbr_q >> dk.clamp(0, 31)) & 1) == 1)
    doc_row = (causal & (same_doc | prefix)) | nbr
    nondoc_row = causal & (dk != HOLE)
    mask = (is_doc_q & doc_row) | (~is_doc_q & nondoc_row)
    return mask & (j < valid_len) & (i < valid_len)


def _per_batch(x, B: int, default: int, device) -> torch.Tensor:
    if x is None:
        return torch.full((B,), default, dtype=torch.int32, device=device)
    return torch.as_tensor(x, dtype=torch.int32, device=device).expand(B)


def sdag_attention_reference(q, k, v, doc_id, nbr_bits, sys_user_len,
                             valid_len=None, scale: Optional[float] = None,
                             q_offset=0, doc_id_q=None, nbr_bits_q=None):
    """Dense-mask attention: the plain version of kernel K1.

    q: [B, H, Lq, Dh]; k/v: [B, Hkv, Lk, Dh] (GQA groups repeated here);
    doc_id/nbr_bits describe the KEY sequence [B, Lk]; sys_user_len,
    valid_len, q_offset: [B] or scalar; doc_id_q/nbr_bits_q: the q rows'
    metadata when q covers rows [q_offset, q_offset+Lq).  Scores in f32,
    probabilities cast to v's dtype before the value product (as the JAX
    reference).  Rows are processed _ROW_CHUNK at a time so the dense mask
    stays bounded at long L; rows are independent, so chunking does not
    change the result."""
    B, H, Lq, Dh = q.shape
    Lk = k.shape[2]
    dev = q.device
    if k.shape[1] != H:
        rep = H // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = scale if scale is not None else Dh ** -0.5
    sys_user_len = _per_batch(sys_user_len, B, 0, dev)
    valid_len = _per_batch(valid_len, B, Lk, dev)
    q_offset = _per_batch(q_offset, B, 0, dev)
    doc_id_q = doc_id if doc_id_q is None else doc_id_q
    nbr_bits_q = nbr_bits if nbr_bits_q is None else nbr_bits_q
    j = torch.arange(Lk, dtype=torch.int32, device=dev)[None, :]
    out = torch.empty(B, H, Lq, Dh, dtype=v.dtype, device=dev)
    kf, vf = k.float(), v
    for b in range(B):
        for r0 in range(0, Lq, _ROW_CHUNK):
            r1 = min(r0 + _ROW_CHUNK, Lq)
            i = (q_offset[b] + torch.arange(r0, r1, dtype=torch.int32,
                                            device=dev))[:, None]
            mask = _tile_mask(i, j, doc_id_q[b, r0:r1, None],
                              doc_id[b, None, :], nbr_bits_q[b, r0:r1, None],
                              sys_user_len[b], valid_len[b])
            scores = (q[b, :, r0:r1].float() @ kf[b].transpose(-1, -2)
                      ) * scale
            scores = torch.where(mask[None], scores,
                                 torch.tensor(DEFAULT_MASK_VALUE,
                                              device=dev))
            probs = torch.softmax(scores, dim=-1)
            out[b, :, r0:r1] = probs.to(vf.dtype) @ vf[b]
    return out


def _reduce_blocks(x: torch.Tensor, op) -> torch.Tensor:
    """Bitwise reduce over the last axis by folding halves (torch has no
    bitwise reductions).  x: int64 [..., n]."""
    while x.shape[-1] > 1:
        n = x.shape[-1]
        h = n // 2
        folded = op(x[..., :h], x[..., h:2 * h])
        x = torch.cat([folded, x[..., 2 * h:]], dim=-1) if n % 2 else folded
    return x[..., 0]


_MASK32 = 0xFFFFFFFF


def compute_block_kinds(doc_id, nbr_bits, sys_user_len, valid_len,
                        block_q: int, block_k: int,
                        doc_id_q=None, nbr_bits_q=None, q_offset=0):
    """Classify every (q-block, kv-block) tile from O(L) metadata:

    0 = SKIP (no visible pair), 1 = FULL (every pair visible), 2 = PARTIAL
    (evaluate the full SDAG token rule in-tile), 3 = CAUSAL (the mask is
    exactly causal & valid).  Conservative toward PARTIAL, exactly as the
    JAX function; returns int32 [B, nQ, nK].  Bit masks are carried in
    int64 restricted to 32 bits, so bit 31 needs no sign handling."""
    B, L = doc_id.shape
    dev = doc_id.device
    doc_id_q = doc_id if doc_id_q is None else doc_id_q
    nbr_bits_q = nbr_bits if nbr_bits_q is None else nbr_bits_q
    Lq = doc_id_q.shape[1]
    nq, nk = Lq // block_q, L // block_k
    big = 2 ** 30
    sul = torch.as_tensor(sys_user_len, dtype=torch.int64,
                          device=dev).expand(B)[:, None]
    vl = torch.as_tensor(valid_len, dtype=torch.int64,
                         device=dev).expand(B)
    qoff = torch.as_tensor(q_offset, dtype=torch.int64,
                           device=dev).expand(B)

    dqb = doc_id_q.to(torch.int64).reshape(B, nq, block_q)
    nbrb = nbr_bits_q.to(torch.int64).reshape(B, nq, block_q) & _MASK32
    q_min_d = dqb.amin(-1)
    q_max_d = dqb.amax(-1)
    q_homo_doc = (q_min_d == q_max_d) & (q_min_d >= 0)
    q_all_nondoc = q_max_d < 0           # hole rows behave like non-doc
    q_has_doc = q_max_d >= 0
    q_has_nondoc = q_min_d < 0
    one = torch.ones((), dtype=torch.int64, device=dev)
    q_doc_bits = _reduce_blocks(
        torch.where(dqb >= 0, one << dqb.clamp(0, 31), 0),
        torch.bitwise_or)
    q_nbr_or = _reduce_blocks(nbrb, torch.bitwise_or)
    q_nbr_all = _reduce_blocks(nbrb, torch.bitwise_and)
    qmin_i = qoff[:, None] + torch.arange(nq, device=dev) * block_q
    qmax_i = qmin_i + block_q - 1
    q_any_valid = qmin_i < vl[:, None]
    q_all_valid = qmax_i < vl[:, None]

    dkb = doc_id.to(torch.int64).reshape(B, nk, block_k)
    k_min_d = dkb.amin(-1)
    k_max_d = dkb.amax(-1)
    k_homo_doc = (k_min_d == k_max_d) & (k_min_d >= 0)
    k_all_nondoc = (k_min_d == -1) & (k_max_d == -1)
    k_all_active = k_min_d >= -1
    k_any_active = k_max_d >= -1
    k_doc_bits = _reduce_blocks(
        torch.where(dkb >= 0, one << dkb.clamp(0, 31), 0),
        torch.bitwise_or)
    pos = torch.arange(L, device=dev).reshape(nk, block_k)
    k_nondoc_min_j = torch.where(dkb == -1, pos,
                                 torch.full_like(pos, big)).amin(-1)
    kmin_j = (torch.arange(nk, device=dev) * block_k)[None, :]
    kmax_j = kmin_j + block_k - 1
    k_any_valid = (kmin_j < vl[:, None]) & k_any_active
    k_all_valid = (kmax_j < vl[:, None]) & k_all_active

    Q = (slice(None), slice(None), None)   # [B, nq] -> [B, nq, 1]
    K = (slice(None), None, slice(None))   # [B, nk] -> [B, 1, nk]
    causal_any = kmin_j[:, None, :] <= qmax_i[Q]
    same_any = (k_doc_bits[K] & q_doc_bits[Q]) != 0
    prefix_any = (k_nondoc_min_j < sul)[K]
    nbr_any = (k_doc_bits[K] & q_nbr_or[Q]) != 0
    any_vis = q_any_valid[Q] & k_any_valid[K] & (
        (q_has_nondoc[Q] & causal_any)
        | (q_has_doc[Q] & ((causal_any & (prefix_any | same_any))
                           | nbr_any)))

    below = kmax_j[:, None, :] <= qmin_i[Q]
    k_prefix_all = (k_all_nondoc & (kmax_j < sul))[K]
    same_doc_homo = (q_homo_doc[Q] & k_homo_doc[K]
                     & (q_min_d[Q] == k_min_d[K]))
    nbr_full = (q_homo_doc[Q] & k_homo_doc[K] & (k_min_d < 32)[K]
                & (((q_nbr_all[Q] >> k_min_d.clamp(0, 31)[K]) & 1) == 1))
    full = q_all_valid[Q] & k_all_valid[K] & (
        (q_all_nondoc[Q] & below)
        | (q_homo_doc[Q] & k_prefix_all & below)
        | (same_doc_homo & below)
        | nbr_full)
    causal_exact = q_all_nondoc[Q] & (k_min_d >= -1)[K]
    kinds = torch.where(full, BLOCK_FULL,
                        torch.where(causal_exact, BLOCK_CAUSAL,
                                    BLOCK_PARTIAL))
    return torch.where(any_vis, kinds, BLOCK_SKIP).to(torch.int32)


def tile_masks_from_metadata(doc_id, nbr_bits, sys_user_len, valid_len,
                             block_q: int, block_k: int,
                             doc_id_q=None, nbr_bits_q=None, q_offset=None):
    """The exact SDAG mask as int8 tiles [B, nQ, nK, block_q, block_k]
    (the JAX package streams these on the TPU; K1 tests the bits of
    ``partial_tile_masks`` instead, so this is a test and inspection
    helper)."""
    B, Lk = doc_id.shape
    dev = doc_id.device
    doc_id_q = doc_id if doc_id_q is None else doc_id_q
    nbr_bits_q = nbr_bits if nbr_bits_q is None else nbr_bits_q
    Lq = doc_id_q.shape[1]
    sul = _per_batch(sys_user_len, B, 0, dev)
    vl = _per_batch(valid_len, B, Lk, dev)
    qo = _per_batch(q_offset, B, 0, dev)
    i = qo[:, None, None] + torch.arange(Lq, dtype=torch.int32,
                                         device=dev)[None, :, None]
    j = torch.arange(Lk, dtype=torch.int32, device=dev)[None, None, :]
    m = _tile_mask(i, j, doc_id_q[:, :, None], doc_id[:, None, :],
                   nbr_bits_q[:, :, None], sul[:, None, None],
                   vl[:, None, None]).to(torch.int8)
    nq, nk = Lq // block_q, Lk // block_k
    return m.reshape(B, nq, block_q, nk, block_k).permute(0, 1, 3, 2, 4)


def _pack_kv_lists(kinds: torch.Tensor):
    """From block kinds [B, nQ, nK] build per-(b, q-block) worklists:
    counts [B, nQ], kv indices [B, nQ, nK] (live tiles packed to the front
    in ascending kv order) and their kinds."""
    needed = kinds > BLOCK_SKIP
    order = torch.argsort((~needed).to(torch.int32), dim=-1, stable=True)
    kv_list = order.to(torch.int32)
    kind_list = torch.gather(kinds, -1, order)
    counts = needed.sum(-1).to(torch.int32)
    return counts, kv_list, kind_list


def partial_tile_masks(kinds, kv_list, doc_id, doc_id_q, nbr_bits_q,
                       sys_user_len, valid_len, q_offset):
    """The SDAG token rule on the PARTIAL tiles only, as bits: both of K1's
    bodies test these instead of evaluating the rule per layer and head (a
    tile's mask depends on neither).

    kinds [B, nQ, nK] and the tile-padded metadata of ``k1_plan``.  Returns
    (mask_bits int32 [max(P, 1), K1_BLOCK_Q, K1_BLOCK_K // 32]: bit c % 32
    of word c // 32 of row r is the rule for q row r and key c of the P-th
    PARTIAL tile in (batch, q-tile, kv-tile) order; mask_slot int32
    [B, nQ, nK]: parallel to ``kv_list``, the tile's index into mask_bits,
    -1 where the tile is not PARTIAL)."""
    dev = kinds.device
    B, nq, nk = kinds.shape
    part = kinds == BLOCK_PARTIAL
    b, qi, ki = part.nonzero(as_tuple=True)
    n_part = int(b.numel())
    slot = torch.full((B, nq, nk), -1, dtype=torch.int32, device=dev)
    slot[part] = torch.arange(n_part, dtype=torch.int32, device=dev)
    mask_slot = torch.gather(slot, -1, kv_list.long()).contiguous()
    words = K1_BLOCK_K // 32
    bits = torch.zeros(max(n_part, 1), K1_BLOCK_Q, words, dtype=torch.int32,
                       device=dev)
    if n_part:
        r = torch.arange(K1_BLOCK_Q, dtype=torch.int32, device=dev)
        c = torch.arange(K1_BLOCK_K, dtype=torch.int32, device=dev)
        i = (q_offset[b] + qi.to(torch.int32) * K1_BLOCK_Q)[:, None, None] \
            + r[None, :, None]
        j = (ki.to(torch.int32) * K1_BLOCK_K)[:, None, None] + c[None, None, :]
        dq = doc_id_q.reshape(B, nq, K1_BLOCK_Q)[b, qi]
        nbq = nbr_bits_q.reshape(B, nq, K1_BLOCK_Q)[b, qi]
        dkk = doc_id.reshape(B, nk, K1_BLOCK_K)[b, ki]
        m = _tile_mask(i, j, dq[:, :, None], dkk[:, None, :], nbq[:, :, None],
                       sys_user_len[b][:, None, None],
                       valid_len[b][:, None, None])
        weight = 1 << torch.arange(32, dtype=torch.int64, device=dev)
        packed = (m.reshape(n_part, K1_BLOCK_Q, words, 32).to(torch.int64)
                  * weight).sum(-1)
        # the low 32 bits as a signed word
        bits = torch.where(packed >= 2 ** 31, packed - 2 ** 32,
                           packed).to(torch.int32).contiguous()
    return bits, mask_slot


def heavy_first_order(counts: torch.Tensor) -> torch.Tensor:
    """The (batch, q-tile) pairs b * nQ + qt sorted by live key tiles, most
    first (ties in index order): both of K1's bodies hand out work in this
    order, so the last blocks to finish hold the lightest q-tiles."""
    return torch.argsort(counts.reshape(-1), descending=True,
                         stable=True).to(torch.int32).contiguous()


def live_tile_stats(counts: torch.Tensor) -> dict:
    """Live key tiles per (batch, q-tile) of a plan: the most, the mean and
    their ratio.  K1 hands out one q-tile's tiles to one block, so a ratio
    far above 1 with few q-tiles per SM means the heaviest q-tile sets the
    kernel's time."""
    c = counts.reshape(-1).double()
    most = float(c.max()) if c.numel() else 0.0
    mean = float(c.mean()) if c.numel() else 0.0
    return {"max": int(most), "mean": mean,
            "max_over_mean": most / mean if mean else 0.0}


def k1_group_items(n_q_heads: int, n_kv_heads: int):
    """How K1 cuts a GQA layout into work items per (batch, q-tile): (q
    heads per block, items).  Two q heads of a kv head share
    one block (and each K/V tile) when the group size is even, else every
    q head is an item of its own.  Each item is (kv head, its q heads), in
    the order the kernel numbers them."""
    group = n_q_heads // n_kv_heads
    nwg = 2 if group % 2 == 0 else 1
    items = [(kvh, tuple(kvh * group + c * nwg + w for w in range(nwg)))
             for kvh in range(n_kv_heads) for c in range(group // nwg)]
    return nwg, items


def _pad_cols(x: torch.Tensor, n: int, value: int) -> torch.Tensor:
    if x.shape[1] == n:
        return x.contiguous()
    return torch.nn.functional.pad(x, (0, n - x.shape[1]), value=value)


def prefill_mask_plan(doc_id, nbr_bits, sys_user_len, valid_len=None,
                      doc_id_q=None, nbr_bits_q=None, q_offset=None):
    """Layer-invariant prefill metadata for kernel K1, computed once per
    prefill and passed to every layer's ``sdag_prefill_attention``.

    Pads the metadata to K1's tile multiples (padded keys get doc_id -1 and
    sit at j >= L >= valid_len, so no rule can see them), computes the
    block kinds at K1's tile sizes and packs the live-tile worklists.
    Returns None on the CPU, where the plain version builds its own mask.
    """
    if doc_id.device.type == "cpu":
        return None
    return k1_plan(doc_id, nbr_bits, sys_user_len, valid_len,
                   doc_id_q=doc_id_q, nbr_bits_q=nbr_bits_q,
                   q_offset=q_offset)


def k1_plan(doc_id, nbr_bits, sys_user_len, valid_len=None, doc_id_q=None,
            nbr_bits_q=None, q_offset=None):
    """The metadata K1 reads, on doc_id's device (see prefill_mask_plan)."""
    dev = doc_id.device
    B, L = doc_id.shape
    doc_id_q = doc_id if doc_id_q is None else doc_id_q
    nbr_bits_q = nbr_bits if nbr_bits_q is None else nbr_bits_q
    Lq = doc_id_q.shape[1]
    nq = -(-Lq // K1_BLOCK_Q)
    nk = -(-L // K1_BLOCK_K)
    dk = _pad_cols(doc_id.to(torch.int32), nk * K1_BLOCK_K, -1)
    dq = _pad_cols(doc_id_q.to(torch.int32), nq * K1_BLOCK_Q, -1)
    nbq = _pad_cols(nbr_bits_q.to(torch.int32), nq * K1_BLOCK_Q, 0)
    nbk = _pad_cols(nbr_bits.to(torch.int32), nk * K1_BLOCK_K, 0)
    sul = _per_batch(sys_user_len, B, 0, dev).contiguous()
    vl = _per_batch(valid_len, B, L, dev).contiguous()
    qo = _per_batch(q_offset, B, 0, dev).contiguous()
    kinds = compute_block_kinds(dk, nbk, sul, vl, K1_BLOCK_Q, K1_BLOCK_K,
                                doc_id_q=dq, nbr_bits_q=nbq, q_offset=qo)
    counts, kv_list, kind_list = _pack_kv_lists(kinds)
    mask_bits, mask_slot = partial_tile_masks(kinds, kv_list, dk, dq, nbq,
                                              sul, vl, qo)
    return {"Lq": Lq, "Lk": L, "nq": nq, "nk": nk, "doc_id": dk,
            "order": heavy_first_order(counts),
            "mask_bits": mask_bits, "mask_slot": mask_slot,
            "doc_id_q": dq, "nbr_bits_q": nbq, "sys_user_len": sul,
            "valid_len": vl, "q_offset": qo, "kinds": kinds,
            "counts": counts.contiguous(), "kv_list": kv_list.contiguous(),
            "kind_list": kind_list.contiguous()}


_K1_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# launch-count key per kernel body: bf16 runs the tensor-core kernel
# (sdag_prefill_wgmma_kernel), f32 the CUDA-core one
# (sdag_prefill_f32_kernel)
K1_BODIES = {torch.float32: "sdag_prefill_f32",
             torch.bfloat16: "sdag_prefill_bf16"}


def _k1_lib():
    lib = _build.load("sdag_prefill")
    if lib.sdag_prefill.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sdag_prefill.argtypes = [p] * 12 + [i] * 8 + [ctypes.c_float,
                                                          i, i, i, p]
        lib.sdag_prefill.restype = i
    return lib


def sdag_prefill_cuda(q, k, v, plan, scale: Optional[float] = None):
    """Kernel K1 (``csrc/sdag_prefill.cu``): SDAG block-sparse prefill.

    q: [B, Hq, Lq, Dh]; k/v: [B, Hkv, Lk, Dh]; all contiguous CUDA tensors
    of one dtype (float32 or bfloat16), Dh in 32/64/128; ``plan`` from
    ``prefill_mask_plan`` on the same metadata.  Output has q's dtype; a
    row that sees no key outputs 0."""
    B, Hq, Lq, Dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"sdag_prefill_cuda: {name} is not on CUDA")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"sdag_prefill_cuda: {name} must be contiguous "
                             "and 16-byte aligned")
        if t.dtype != q.dtype:
            raise ValueError("sdag_prefill_cuda: q, k, v dtypes differ")
    if q.dtype not in _K1_DTYPES:
        raise ValueError(f"sdag_prefill_cuda: dtype {q.dtype} unsupported "
                         "(float32 or bfloat16)")
    if Dh not in K1_HEAD_DIMS or k.shape[3] != Dh or v.shape != k.shape:
        raise ValueError(f"sdag_prefill_cuda: head dim {Dh} unsupported or "
                         f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} "
                         "mismatch")
    if Hq % Hkv or k.shape[0] != B:
        raise ValueError(f"sdag_prefill_cuda: {Hq} q heads not a multiple "
                         f"of {Hkv} kv heads")
    if plan is None or plan["Lq"] != Lq or plan["Lk"] != Lk:
        raise ValueError("sdag_prefill_cuda: mask plan does not match "
                         "the q/k lengths")
    scale = scale if scale is not None else Dh ** -0.5
    out = torch.empty_like(q)
    lib = _k1_lib()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    rc = lib.sdag_prefill(
        ptr(q), ptr(k), ptr(v), ptr(out), ptr(plan["valid_len"]),
        ptr(plan["q_offset"]), ptr(plan["counts"]), ptr(plan["kv_list"]),
        ptr(plan["kind_list"]), ptr(plan["order"]), ptr(plan["mask_bits"]),
        ptr(plan["mask_slot"]), B, Hq, Hkv, Lq, Lk, Dh,
        plan["nq"], plan["nk"], float(scale),
        _K1_DTYPES[q.dtype], k1_group_items(Hq, Hkv)[0],
        _build.sm_count(q.device),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _build.check(lib, rc, "sdag_prefill")
    _build.LAUNCHES[K1_BODIES[q.dtype]] += 1
    return out


def sdag_prefill_attention(q, k, v, doc_id, nbr_bits, sys_user_len,
                           valid_len=None, scale: Optional[float] = None,
                           q_offset=None, doc_id_q=None, nbr_bits_q=None,
                           mask_plan=None):
    """Dispatch by device: kernel K1 on CUDA, the plain dense-mask version
    on the CPU; any other device raises.

    mask_plan: a ``prefill_mask_plan`` result for this metadata (multi-
    layer callers compute it once); built here when None on CUDA."""
    if q.device.type == "cpu":
        return sdag_attention_reference(
            q, k, v, doc_id, nbr_bits, sys_user_len, valid_len=valid_len,
            scale=scale, q_offset=0 if q_offset is None else q_offset,
            doc_id_q=doc_id_q, nbr_bits_q=nbr_bits_q)
    if q.device.type != "cuda":
        raise ValueError(f"sdag_prefill_attention: no path for device "
                         f"{q.device}")
    if mask_plan is None:
        mask_plan = prefill_mask_plan(doc_id, nbr_bits, sys_user_len,
                                      valid_len, doc_id_q=doc_id_q,
                                      nbr_bits_q=nbr_bits_q,
                                      q_offset=q_offset)
    return sdag_prefill_cuda(q, k, v, mask_plan, scale=scale)


def masked_decode_attention(q, k_cache, v_cache, cache_mask):
    """Single-step decode attention over a KV cache (plain PyTorch).

    q: [B, H, Dh]; caches: [B, Hkv, S, Dh] with Hkv dividing H (GQA groups
    contract directly, the repeated kv is never materialized);
    cache_mask: [B, S] marks valid slots.  Scores in f32 (a bf16 cache is
    contracted as it is, with f32 products out, as the JAX op's
    preferred_element_type: on CUDA no f32 copy of the cache is made),
    probabilities cast to the cache dtype before the value product (as
    the JAX op).  No host value enters: a CUDA graph can capture it."""
    B, H, Dh = q.shape
    scores = decode_scores(q, k_cache)
    scores = scores.masked_fill(~cache_mask[:, None, None, :],
                                DEFAULT_MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = probs.to(v_cache.dtype) @ v_cache
    return out.reshape(B, H, Dh)


def decode_scores(q, k_cache):
    """Scaled f32 scores [B, Hkv, H / Hkv, S] of ``masked_decode_attention``
    (same shapes): on CUDA a bf16 cache is contracted as it is with f32
    out; elsewhere both operands go to f32 first."""
    B, H, Dh = q.shape
    hkv = k_cache.shape[1]
    return _group_bmm(q.reshape(B, hkv, H // hkv, Dh),
                      k_cache.transpose(-1, -2)) * Dh ** -0.5


def _group_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, G, R, X] @ [B, G, X, Y] -> [B, G, R, Y] f32 products: on CUDA a
    bf16 pair contracts as it is with f32 out (no f32 copy of a cache);
    elsewhere both operands go to f32 first."""
    B, G, R, X = a.shape
    a3, b3 = a.reshape(B * G, R, X), b.reshape(B * G, X, b.shape[-1])
    if a.device.type == "cuda" and a.dtype != torch.float32:
        out = torch.bmm(a3, b3, out_dtype=torch.float32)
    else:
        out = torch.bmm(a3.float(), b3.float())
    return out.reshape(B, G, R, -1)


def _int8_attention(q, k_t, v_t, k_scale, v_scale, cache_mask):
    """``masked_decode_attention_int8`` with the int8 K/V already cast to
    q's dtype (exact): k_t/v_t [B, Hkv, S, Dh], scales [B, Hkv, S], mask
    [B, S]; f32 products, the k scale times the scores, the v scale folded
    into the probabilities.  Returns [B, H, Dh] f32."""
    B, H, Dh = q.shape
    hkv = k_t.shape[1]
    qg = q.reshape(B, hkv, H // hkv, Dh)
    scores = _group_bmm(qg, k_t.transpose(-1, -2))
    scores = scores * k_scale[:, :, None, :] * Dh ** -0.5
    scores = scores.masked_fill(~cache_mask[:, None, None, :],
                                DEFAULT_MASK_VALUE)
    probs = torch.softmax(scores, dim=-1) * v_scale[:, :, None, :]
    return _group_bmm(probs.to(q.dtype), v_t).reshape(B, H, Dh)


def masked_decode_attention_int8(q, k_i8, v_i8, k_scale, v_scale,
                                 cache_mask):
    """``masked_decode_attention`` over an int8 cache (the JAX
    ``masked_decode_attention_int8``): k_i8/v_i8 int8 [B, Hkv, S, Dh],
    k_scale/v_scale f32 [B, Hkv, S] (absmax over Dh per slot).  The int8
    values are cast to q's dtype (a copy in q's dtype, not f32), the k
    scale multiplies the f32 scores, the v scale folds into the
    probabilities before the value product; output in q's dtype."""
    return _int8_attention(q, k_i8.to(q.dtype), v_i8.to(q.dtype), k_scale,
                           v_scale, cache_mask).to(q.dtype)


# A verification window attends row by row through the single-token
# attention, on the same shapes as a decode step: a step and a window row
# that see the same cache give the same bits on the card (one batched
# product over the window's G rows would take other cuBLAS kernels, and
# greedy speculation would then drift from plain greedy decode).  The
# window reads the cache G times; the mask may cover a prefix of the
# cache's slots, and only that prefix is attended.

def masked_decode_window_attention(q, k_cache, v_cache, cache_mask):
    """Multi-token decode attention for speculative verification windows
    (the JAX ``masked_decode_window_attention``).

    q: [B, H, G, Dh]; caches [B, Hkv, S, Dh]; cache_mask [B, G, S'] (S' <=
    S), per window row the valid slots (history plus the window's causal
    prefix); the first S' slots are attended.  Output in the cache
    dtype."""
    G, S = q.shape[2], cache_mask.shape[-1]
    k = k_cache[:, :, :S].contiguous()
    v = v_cache[:, :, :S].contiguous()
    return torch.stack([
        masked_decode_attention(q[:, :, g].contiguous(), k, v,
                                cache_mask[:, g]) for g in range(G)], dim=2)


def masked_decode_window_attention_int8(q, k_i8, v_i8, k_scale, v_scale,
                                        cache_mask):
    """:func:`masked_decode_window_attention` over an int8 cache, with the
    scale folding of :func:`masked_decode_attention_int8` (the int8 K/V
    cast to q's dtype once for the window's rows)."""
    G, S = q.shape[2], cache_mask.shape[-1]
    k_t, v_t = k_i8[:, :, :S].to(q.dtype), v_i8[:, :, :S].to(q.dtype)
    k_s, v_s = k_scale[:, :, :S], v_scale[:, :, :S]
    return torch.stack([
        _int8_attention(q[:, :, g].contiguous(), k_t, v_t, k_s, v_s,
                        cache_mask[:, g]) for g in range(G)],
        dim=2).to(q.dtype)


def quantize_kv_heads_int8(x: torch.Tensor):
    """Per-slot symmetric int8 over the head dim: x [..., S, Dh] -> (int8
    values, f32 scales [..., S]); the retrieval index's rule
    (``ops/topk.py`` ``quantize_last_axis_int8``)."""
    return quantize_last_axis_int8(x)
