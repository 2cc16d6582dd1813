"""SDAG block mask: document-isolation attention structure.

The reference builds a dense L x L boolean mask with Python loops
(``src/pipeline/sparse_attention_RAG/SDAG.py:68-127``).  Here the structure is
encoded as O(L) per-token metadata that the Pallas flash-attention kernel
consumes directly — the L x L mask is never materialized on device:

- ``doc_id[i]``  : which document block token i belongs to (-1 = none)
- ``nbr_bits[i]``: bitmask of *other* documents token i's block may attend
                   in full (the DOC_NEIGHBORS_K neighbor windows)
- ``sys_user_len``: tokens before the first document (always visible to docs)

Attention rule (reference semantics, ``SDAG.py:107-125``):
- non-doc rows (system/user and the QA tail) are causal;
- a doc row attends causally to the sys/user prefix and its own block, plus
  the FULL span of each neighbor block (even future positions —
  ``SDAG.py:117-122`` sets neighbor spans unconditionally);
- isolation applies only at prefill; decode is plain causal over the cache
  (``SDAG.py:191-208``).

Deliberate deviation (documented, not accidental): the reference leaves mask
rows of separator tokens *between* doc spans all-False, which — because the
mask is applied as a constant additive offset — degenerates to full
bidirectional attention for those rows.  Here separator/gap rows are causal
like the QA tail.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

MAX_DOC_BLOCKS = 31  # neighbor sets are int32 bitmasks

# doc_id sentinel for inactive "hole" tokens inserted by block-aligned
# packing (sdag/spans.py): never visible as keys, rows unused.
HOLE_DOC_ID = -2


@dataclass(frozen=True)
class BlockLayout:
    """Token-level layout of an SDAG prompt.

    hole_spans mark inactive padding runs (block-aligned packing); they are
    excluded from attention entirely.
    """
    seq_len: int
    sys_user_len: int
    doc_token_spans: Tuple[Tuple[int, int], ...]  # [(start, end)) per doc
    qa_start: int
    hole_spans: Tuple[Tuple[int, int], ...] = ()

    @property
    def num_docs(self) -> int:
        return len(self.doc_token_spans)


def build_blocked_causal_mask(
    layout: BlockLayout,
    doc_neighbors: Optional[Sequence[Sequence[int]]] = None,
    reference_gap_rows: bool = False,
) -> np.ndarray:
    """Dense boolean mask [L, L]; golden reference for kernel parity tests.

    reference_gap_rows=True reproduces the reference's all-False rows for
    tokens between doc spans (``SDAG.py:107-125`` leaves them unset);
    False (default) makes gap rows causal (production behavior).
    """
    L = layout.seq_len
    mask = np.zeros((L, L), dtype=bool)
    causal = np.tril(np.ones((L, L), dtype=bool))

    covered = np.zeros(L, dtype=bool)

    # sys/user prefix: causal
    mask[:layout.sys_user_len] = causal[:layout.sys_user_len]
    covered[:layout.sys_user_len] = True

    num_docs = layout.num_docs

    for d_idx, (d_start, d_end) in enumerate(layout.doc_token_spans):
        # neighbor semantics mirror neighbors_to_bitmask exactly (truncate
        # to num_docs, apply the entries present, self excluded) so the
        # dense golden and the metadata path cannot diverge on the same
        # inputs — an all-or-nothing length check here silently dropped
        # every neighbor on a 1-entry mismatch while the metadata path
        # applied the ones it had
        nbrs = (doc_neighbors[d_idx]
                if doc_neighbors is not None and d_idx < len(doc_neighbors)
                else ())
        for i in range(d_start, d_end):
            mask[i, :layout.sys_user_len] = True
            mask[i, d_start:i + 1] = True
            for nbr in nbrs:
                if 0 <= nbr < num_docs and nbr != d_idx:
                    n_start, n_end = layout.doc_token_spans[nbr]
                    mask[i, n_start:n_end] = True  # full span, non-causal
        covered[d_start:d_end] = True

    # QA tail: causal over everything
    mask[layout.qa_start:] = causal[layout.qa_start:]
    covered[layout.qa_start:] = True

    if not reference_gap_rows:
        gap_rows = ~covered
        mask[gap_rows] = causal[gap_rows]

    # holes (block-aligned packing): never visible as keys — to any row,
    # including other holes — matching _tile_mask's ``dk != HOLE`` rule
    # (hole rows themselves stay causal like gaps; outputs unused)
    for h_start, h_end in layout.hole_spans:
        mask[:, h_start:h_end] = False

    return mask


def neighbors_to_bitmask(doc_neighbors: Optional[Sequence[Sequence[int]]],
                         num_docs: int) -> np.ndarray:
    """Per-doc int32 bitmask of neighbor docs (self excluded)."""
    bits = np.zeros(num_docs, dtype=np.int32)
    if doc_neighbors is None:
        return bits
    for d, nbrs in enumerate(doc_neighbors[:num_docs]):
        b = 0
        for n in nbrs:
            if 0 <= n < num_docs and n != d:
                b |= 1 << int(n)
        bits[d] = b
    return bits


def layout_to_metadata(
    layout: BlockLayout,
    doc_neighbors: Optional[Sequence[Sequence[int]]] = None,
    pad_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Encode a layout as (doc_id [Lp], nbr_bits [Lp], sys_user_len).

    Padding tokens get doc_id=-1 (causal rows; padded positions are excluded
    by the separate length mask at attention time).
    """
    # The int32 neighbor bitmask addresses docs 0..30 only; plain
    # isolation (exact doc-id equality) has no doc-count limit, so the
    # cap applies only when neighbor windows are actually requested.
    uses_neighbors = doc_neighbors is not None and any(
        len(n) for n in doc_neighbors)
    if uses_neighbors and layout.num_docs > MAX_DOC_BLOCKS:
        raise ValueError(f"at most {MAX_DOC_BLOCKS} doc blocks supported "
                         f"with neighbor windows, got {layout.num_docs}")
    L = pad_to if pad_to is not None else layout.seq_len
    if L < layout.seq_len:
        raise ValueError("pad_to smaller than seq_len")
    doc_id = np.full(L, -1, dtype=np.int32)
    for s, e in layout.hole_spans:
        doc_id[s:e] = HOLE_DOC_ID
    for d, (s, e) in enumerate(layout.doc_token_spans):
        doc_id[s:e] = d
    per_doc_bits = neighbors_to_bitmask(doc_neighbors, layout.num_docs)
    nbr_bits = np.zeros(L, dtype=np.int32)
    for d, (s, e) in enumerate(layout.doc_token_spans):
        nbr_bits[s:e] = per_doc_bits[d]
    return doc_id, nbr_bits, layout.sys_user_len


def mask_from_metadata(doc_id: np.ndarray, nbr_bits: np.ndarray,
                       sys_user_len: int, valid_len: Optional[int] = None
                       ) -> np.ndarray:
    """Dense mask [L, L] from metadata (numpy; mirrors the kernel's in-tile
    rule).  Used for tests and the XLA fallback path."""
    L = doc_id.shape[0]
    i = np.arange(L)[:, None]
    j = np.arange(L)[None, :]
    dq = doc_id[:, None]
    dk = doc_id[None, :]
    causal = j <= i
    is_doc_q = dq >= 0
    same_doc = (dq == dk) & is_doc_q
    prefix = (dk == -1) & (j < sys_user_len)
    nbr = (dk >= 0) & (dk < 32) & \
        (((nbr_bits[:, None] >> np.minimum(np.maximum(dk, 0), 31)) & 1) == 1)
    doc_row = (causal & (same_doc | prefix)) | nbr
    # non-doc rows are causal but never attend hole keys
    mask = np.where(is_doc_q, doc_row, causal & (dk != HOLE_DOC_ID))
    if valid_len is not None:
        mask &= (j < valid_len) & (i < valid_len)
    return mask
