"""Context parallelism: the SDAG prefill sequence split over ranks.

Counterpart of ``sdag_tpu/parallel/context.py``.  Each rank of the axis
owns a contiguous slice of the prompt's rows (its q, k, v and metadata);
the keys reach it either all at once (``kv_exchange="all_gather"``: K/V
and key metadata are all-gathered and kernel K1 runs on the rank's q rows
with a global row offset) or chunk by chunk around a ring (``"ring"``:
ring attention, each chunk folded into running flash statistics, live
K/V one chunk; the chunk math is plain PyTorch, as it is XLA einsums in
the JAX package).  Block-kind skipping still applies: K1 skips dead tiles,
the ring skips dead chunks (``chunk_needed``).

Unlike the JAX functions, which take the whole sequence and shard it
inside a ``shard_map``, these take and return this rank's slice: the rank
holds only its rows.
"""

from __future__ import annotations

import torch

from sdag_tpu_torch.core.mesh import Mesh
from sdag_tpu_torch.ops.attention import (DEFAULT_MASK_VALUE, _per_batch,
                                          _tile_mask, sdag_prefill_attention)
from sdag_tpu_torch.parallel.collectives import all_gather_cat, ring_shift


def context_parallel_prefill_attention(
        q, k, v, doc_id, nbr_bits, sys_user_len, valid_len, mesh: Mesh,
        axis: str = "model", impl: str = "auto",
        kv_exchange: str = "all_gather"):
    """SDAG prefill attention with the sequence split over ``axis``.

    q: [B, H, Ls, Dh], k/v: [B, Hkv, Ls, Dh], doc_id/nbr_bits: [B, Ls]:
    this rank's rows [rank * Ls, (rank + 1) * Ls) of an L = n * Ls prompt;
    sys_user_len/valid_len: [B] of the whole prompt.  Returns this rank's
    output rows [B, H, Ls, Dh].  The all-gather variant runs K1 on CUDA
    and its plain version on the CPU.  ``impl`` is kept for the ring's
    guard: the ring rejects a kernel request rather than silently
    ignoring it, as the JAX function does."""
    if kv_exchange == "ring":
        if impl != "auto":
            raise ValueError(
                "kv_exchange='ring' computes chunk attention as plain "
                f"PyTorch einsums (chunk-level skipping); impl={impl!r} "
                "does not apply -- use kv_exchange='all_gather' for the K1 "
                "tile kernel")
        return ring_prefill_attention(q, k, v, doc_id, nbr_bits,
                                      sys_user_len, valid_len, mesh, axis)
    if kv_exchange != "all_gather":
        raise ValueError(f"Unknown kv_exchange {kv_exchange!r}: "
                         "'all_gather' or 'ring'")
    group = mesh.group(axis)
    offset = mesh.rank(axis) * q.shape[2]
    # keys travel once; queries stay where they are
    k_full = all_gather_cat(k, group, dim=2)
    v_full = all_gather_cat(v, group, dim=2)
    did_full = all_gather_cat(doc_id, group, dim=1)
    nbr_full = all_gather_cat(nbr_bits, group, dim=1)
    B = q.shape[0]
    q_offset = torch.full((B,), offset, dtype=torch.int32, device=q.device)
    return sdag_prefill_attention(q, k_full, v_full, did_full, nbr_full,
                                  sys_user_len, valid_len=valid_len,
                                  q_offset=q_offset, doc_id_q=doc_id,
                                  nbr_bits_q=nbr_bits)


def _or_reduce(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over the last axis of an int tensor (int64 result; bit
    31 of an int32 input stays bit 31)."""
    bits = torch.arange(32, device=x.device, dtype=torch.int64)
    set_ = ((x.to(torch.int64)[..., None] >> bits) & 1).amax(-2)
    return (set_ << bits).sum(-1)


def chunk_needed(did_q, nbr_q, did_k, i_max, j0, col_k, sys_user_len,
                 valid_len):
    """Chunk-level SDAG skip predicate for ring attention.

    True iff ANY (q row, k col) pair between this rank's q rows and the
    incoming key chunk can be visible under the ``_tile_mask`` rule -- a
    conservative summary (doc-id bitmask overlap, neighbour-union overlap,
    causal extent, prefix presence), so False implies the chunk's tile mask
    is all False.  Doc ids above 31 alias onto bit 31 (conservative).

    did_q/nbr_q: [..., Ls]; did_k: [..., Lc]; col_k: [Lc] global key
    columns; i_max: last global q row; j0: chunk start column;
    sys_user_len/valid_len: scalars or [...].  Returns bool [...]."""
    sul = torch.as_tensor(sys_user_len, device=did_k.device)[..., None]
    vl = torch.as_tensor(valid_len, device=did_k.device)[..., None]
    valid_k = col_k < vl
    doc_k = (did_k >= 0) & valid_k
    one = torch.ones((), dtype=torch.int64, device=did_k.device)
    docs_k_bits = _or_reduce(torch.where(
        doc_k, one << did_k.clamp(0, 31).to(torch.int64), 0))
    has_nonhole_k = ((did_k != -2) & valid_k).any(-1)
    has_prefix_k = ((did_k == -1) & (col_k < sul) & valid_k).any(-1)

    doc_q = did_q >= 0
    docs_q_bits = _or_reduce(torch.where(
        doc_q, one << did_q.clamp(0, 31).to(torch.int64), 0))
    nbr_union = _or_reduce(torch.where(doc_q, nbr_q.to(torch.int64), 0))
    has_nondoc_q = (~doc_q).any(-1)

    causal_overlap = (j0 <= i_max) & (j0 < vl[..., 0])
    causal_need = causal_overlap & (
        (has_nondoc_q & has_nonhole_k)            # non-doc rows: causal all
        | ((docs_q_bits & docs_k_bits) != 0)      # same-doc diagonal
        | has_prefix_k)                           # doc rows -> sys/user
    nbr_need = (nbr_union & docs_k_bits) != 0     # full-span neighbours
    return causal_need | nbr_need


def ring_prefill_attention(q, k, v, doc_id, nbr_bits, sys_user_len,
                           valid_len, mesh: Mesh, axis: str = "model"):
    """Ring attention with the SDAG mask rule: this rank keeps its q rows
    and the n key chunks pass around the ring (n - 1 shifts; the last
    chunk is folded after the loop, so its shift never runs), each folded
    into running softmax statistics (m, l, acc) in f32.  Same slices in
    and out as ``context_parallel_prefill_attention``."""
    group = mesh.group(axis)
    n, me = mesh.shape[axis], mesh.rank(axis)
    B, H, Ls, Dh = q.shape
    hkv = k.shape[1]
    rep = H // hkv
    dev = q.device
    sul = _per_batch(sys_user_len, B, 0, dev)
    vl = _per_batch(valid_len, B, n * Ls, dev)
    i = (me * Ls + torch.arange(Ls, dtype=torch.int32, device=dev))[:, None]
    j_local = torch.arange(Ls, dtype=torch.int32, device=dev)[None, :]
    i_max = me * Ls + Ls - 1

    qg = q.reshape(B, hkv, rep, Ls, Dh).float() * Dh ** -0.5
    m = torch.full((B, hkv, rep, Ls), DEFAULT_MASK_VALUE, device=dev)
    l_ = torch.zeros((B, hkv, rep, Ls), device=dev)
    acc = torch.zeros((B, hkv, rep, Ls, Dh), device=dev)

    def fold(s, k_c, v_c, did_c, m, l_, acc):
        src = (me - s) % n
        j0 = src * Ls
        col_k = j0 + torch.arange(Ls, dtype=torch.int32, device=dev)
        # chunk-level block-kind skip: no (q row, k col) pair visible ->
        # no score/update work (the ring still moves)
        if not bool(chunk_needed(doc_id, nbr_bits, did_c, i_max, j0, col_k,
                                 sul, vl).any()):
            return m, l_, acc
        mask = _tile_mask(i[None], (j0 + j_local)[None],
                          doc_id[:, :, None], did_c[:, None, :],
                          nbr_bits[:, :, None], sul[:, None, None],
                          vl[:, None, None])               # [B, Ls, Lc]
        s_raw = torch.einsum("bgrld,bgjd->bgrlj", qg, k_c.float())
        s_msk = torch.where(mask[:, None, None], s_raw,
                            torch.tensor(DEFAULT_MASK_VALUE, device=dev))
        m_new = torch.maximum(m, s_msk.amax(-1))
        p = torch.exp(s_msk - m_new[..., None])
        p = torch.where(mask[:, None, None], p, 0.0)
        corr = torch.exp(m - m_new)
        l_new = l_ * corr + p.sum(-1)
        acc_new = acc * corr[..., None] + torch.einsum(
            "bgrlj,bgjd->bgrld", p, v_c.float())
        return m_new, l_new, acc_new

    k_c, v_c, did_c = k, v, doc_id
    for s in range(n - 1):
        m, l_, acc = fold(s, k_c, v_c, did_c, m, l_, acc)
        k_c, v_c, did_c = ring_shift([k_c, v_c, did_c], group)
    m, l_, acc = fold(n - 1, k_c, v_c, did_c, m, l_, acc)
    out = acc / l_.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, Ls, Dh).to(q.dtype)
