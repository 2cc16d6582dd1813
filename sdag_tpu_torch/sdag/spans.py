"""SDAG prompt construction with token spans known by construction.

The reference recovers document spans *after* rendering the whole chat string
— substring search plus O(num_docs) prefix re-tokenizations
(``SDAG.py:216-304``), which is fragile and tokenizer-dependent.  Here the
prompt is assembled from independently tokenized segments, so every document
block's token span is exact by construction and the rendered text is
identical to the reference's ``USER_RAG_PROMPT`` format (the ``- Question:``
/ ``- Answer:`` markers that evaluation depends on).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sdag_tpu_torch.sdag.mask import BlockLayout, layout_to_metadata
from sdag_tpu_torch.utils import prompts


@dataclass
class PromptPlan:
    """A tokenized SDAG prompt with its block layout."""
    input_ids: np.ndarray            # [L] int32
    layout: BlockLayout
    ranked_docs: List[str]
    text: str

    def metadata(self, doc_neighbors=None, pad_to: Optional[int] = None):
        return layout_to_metadata(self.layout, doc_neighbors, pad_to=pad_to)


def build_rag_prompt_plan(
    tokenizer,
    query: str,
    ranked_docs: Sequence[str],
    system_prompt: str = prompts.SYSTEM_PROMPT_RAG,
    block_align: int = 0,
) -> PromptPlan:
    """Tokenize the RAG chat prompt segment-by-segment.

    Segments: [chat scaffold + user text up to the passages] [doc 0]
    [separator] [doc 1] ... [user text after passages + assistant header].
    Doc spans cover exactly the rendered ``- {doc}`` bullets; separators are
    non-doc (causal) tokens.

    block_align > 0 enables block-aligned packing for the flash kernel: each
    doc segment (with its trailing separator folded into the doc span) starts
    on a multiple of ``block_align``, padded by inactive hole tokens that are
    invisible to attention (sdag/mask.py HOLE_DOC_ID) — cross-doc tiles
    become exactly skippable.  The rendered text is unchanged; only the
    device layout differs.
    """
    docs = [d for d in ranked_docs if d and d.strip()]

    # Render the full chat string once to anchor the scaffold pieces, using
    # a placeholder to split the user content around the docs text.
    sentinel = "\x00DOCS\x00"
    user_content = prompts.USER_RAG_PROMPT.format(query=query,
                                                  docs_text=sentinel)
    chat_str = tokenizer.apply_chat_template(
        [
            {"role": "system", "content": system_prompt},
            {"role": "user", "content": user_content},
        ],
        tokenize=False,
        add_generation_prompt=True,
    )
    before, after = chat_str.split(sentinel, 1)

    rendered_docs = [prompts.render_doc(d) for d in docs]
    sep = prompts.RAG_DOC_SEPARATOR
    pad_id = int(getattr(tokenizer, "pad_token_id", 0) or 0)

    ids: List[int] = []
    spans: List[Tuple[int, int]] = []
    holes: List[Tuple[int, int]] = []

    def align() -> None:
        if block_align > 0 and len(ids) % block_align:
            pad = block_align - len(ids) % block_align
            holes.append((len(ids), len(ids) + pad))
            ids.extend([pad_id] * pad)

    ids.extend(tokenizer.encode(before, add_special_tokens=False))
    sys_user_len = len(ids)
    align()

    for i, rd in enumerate(rendered_docs):
        if block_align > 0:
            # separator folded into the preceding doc span so every doc
            # segment starts exactly on a block boundary
            start = len(ids)
            seg = rd + (sep if i < len(rendered_docs) - 1 else "")
            ids.extend(tokenizer.encode(seg, add_special_tokens=False))
            spans.append((start, len(ids)))
            align()
        else:
            if i > 0:
                ids.extend(tokenizer.encode(sep, add_special_tokens=False))
            start = len(ids)
            ids.extend(tokenizer.encode(rd, add_special_tokens=False))
            spans.append((start, len(ids)))

    qa_start = len(ids)
    ids.extend(tokenizer.encode(after, add_special_tokens=False))

    text = before + sep.join(rendered_docs) + after
    layout = BlockLayout(seq_len=len(ids), sys_user_len=sys_user_len,
                         doc_token_spans=tuple(spans), qa_start=qa_start,
                         hole_spans=tuple(holes))
    return PromptPlan(input_ids=np.asarray(ids, np.int32), layout=layout,
                      ranked_docs=list(docs), text=text)


def build_plain_chat_ids(tokenizer, system_prompt: str, user_content: str
                         ) -> np.ndarray:
    """Tokenize a plain (NO-ISO) chat prompt."""
    chat_str = tokenizer.apply_chat_template(
        [
            {"role": "system", "content": system_prompt},
            {"role": "user", "content": user_content},
        ],
        tokenize=False,
        add_generation_prompt=True,
    )
    return np.asarray(tokenizer.encode(chat_str, add_special_tokens=False),
                      np.int32)
