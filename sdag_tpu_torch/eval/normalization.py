"""Answer normalization and exact-match (single source of truth).

Behavioral parity with the reference's SQuAD-style normalization
(``src/pipeline/utils/normalization.py:8-64``); the reference duplicates these
in ``utils/metrics.py:10-39`` — here there is exactly one implementation.

Kept quirk (metrics parity): ``exact_match`` is *substring* of normalized
prediction, not equality.
"""

from __future__ import annotations

import re
import string
import unicodedata

_PUNCT = set(string.punctuation)
_ARTICLES_RE = re.compile(r"\b(a|an|the)\b")
_THINK_RE = re.compile(r"<think>.*?</think>", re.DOTALL | re.IGNORECASE)
_ANSWER_PREFIX_RE = re.compile(
    r"^\s*(-\s*)?(final\s*answer\s*:|answer\s*:)\s*", re.IGNORECASE)


def normalize_answer(s: str) -> str:
    """NFD-normalize, lowercase, strip punctuation, drop articles, squeeze
    whitespace."""
    s = unicodedata.normalize("NFD", str(s)).lower()
    s = "".join(ch for ch in s if ch not in _PUNCT)
    s = _ARTICLES_RE.sub(" ", s)
    return " ".join(s.split())


def extract_final_answer(text: str) -> str:
    """Best-effort isolation of a model's final answer: drop <think> blocks
    and 'Answer:' prefixes, return the first non-empty line."""
    if text is None:
        return ""
    s = _THINK_RE.sub("", str(text)).strip()
    s = _ANSWER_PREFIX_RE.sub("", s).strip()
    for line in s.splitlines():
        line = line.strip()
        if line:
            return line
    return ""


def exact_match(prediction: str, ground_truth: str) -> bool:
    """True iff normalized ground_truth is a substring of the normalized
    prediction (with <think> blocks removed first)."""
    prediction = "" if prediction is None else str(prediction)
    ground_truth = "" if ground_truth is None else str(ground_truth)
    prediction = re.sub(r"<think>.*?</think>", "", prediction, flags=re.DOTALL)
    return normalize_answer(ground_truth) in normalize_answer(prediction)

