"""On-the-fly attack content generation with the pipeline's own generator.

Behavioral parity with ``src/pipeline/attack/content_generation.py:97-248``:
chat-templated false-answer and malicious-document prompts, presets take
precedence, one false answer + one doc per query when generating.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from sdag_tpu_torch.sdag.spans import build_plain_chat_ids
from sdag_tpu_torch.utils import prompts
from sdag_tpu_torch.utils.profiling import span


def _generate_in_batches(generator, ids, max_tokens: int,
                         batch_size: int) -> List[str]:
    out: List[str] = []
    for i in range(0, len(ids), batch_size):
        with span("sdag.orch.llm_batch"):
            out.extend(generator.generate_ids(ids[i:i + batch_size],
                                              max_new_tokens=max_tokens))
    return out


def generate_false_answers(generator, queries: Sequence[str],
                           max_tokens: int, batch_size: int = 8) -> List[str]:
    with span("sdag.orch.prompts.false_answer"):
        ids = [build_plain_chat_ids(
            generator.tokenizer, prompts.SYSTEM_PROMPT_FALSE_ANSWER,
            prompts.USER_FALSE_ANSWER_PROMPT.format(query=q))
            for q in queries]
    return _generate_in_batches(generator, ids, max_tokens, batch_size)


def generate_malicious_docs(generator, queries: Sequence[str],
                            false_answers: Sequence[str], max_tokens: int,
                            batch_size: int = 8) -> List[str]:
    with span("sdag.orch.prompts.malicious_doc"):
        ids = [build_plain_chat_ids(
            generator.tokenizer, prompts.SYSTEM_PROMPT_FALSE_DOC,
            prompts.USER_FALSE_DOC_PROMPT.format(query=q, false_answer=fa))
            for q, fa in zip(queries, false_answers)]
    return _generate_in_batches(generator, ids, max_tokens, batch_size)


def build_attack_content_for_batch(
    preset_false_answer_groups: Optional[List[List[str]]],
    preset_malicious_doc_groups: Optional[List[List[str]]],
    need_attack_content: bool,
    generator,
    queries: Sequence[str],
    max_tokens_false_answer: int = 50,
    max_tokens_document: int = 250,
    batch_size: int = 8,
) -> Tuple[List[List[str]], List[List[str]]]:
    """Presets >> skip >> generate (reference ``content_generation.py:196``)."""
    if (preset_false_answer_groups is not None
            and preset_malicious_doc_groups is not None):
        return preset_false_answer_groups, preset_malicious_doc_groups
    if not need_attack_content:
        return [[] for _ in queries], [[] for _ in queries]

    fas = generate_false_answers(generator, queries, max_tokens_false_answer,
                                 batch_size)
    docs = generate_malicious_docs(generator, queries, fas,
                                   max_tokens_document, batch_size)
    return ([[fa] if fa else [] for fa in fas],
            [[d] if d else [] for d in docs])
