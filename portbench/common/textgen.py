"""Seeded pseudo-word text: the lexicon, Zipf-distributed word draws, and
bulk rendering of token-id rows into strings.

The syllable alphabet follows ``sdag_tpu_torch/utils/synth_qa.py``
(``_pseudoword``: consonant-vowel syllables), copied here so that the
yardstick does not move when the program does.  Every word ends in ``a`` or
``o`` and starts with a consonant: no Porter-stemmer rule of Lucene's
EnglishAnalyzer applies to such a word and none is a stopword, so the
BM25 analyzer leaves each word as it is and the plain BM25 reference can
count words directly.  ``test_words_pass_the_bm25_analyzer_unchanged`` in
``portbench/tests/test_pb_traffic.py`` holds the program's analyzer to
that.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

CONSONANTS = "bdfgklmnprstvz"
VOWELS = "aeiou"
FINAL_VOWELS = "ao"


def pseudo_words(n: int, seed: int, syllables=(2, 3, 4),
                 weights=(0.25, 0.5, 0.25)) -> List[str]:
    """``n`` distinct lowercase pseudo-words in a seeded order (the order is
    the Zipf rank)."""
    rng = np.random.default_rng(seed)
    out: List[str] = []
    seen = set()
    while len(out) < n:
        m = 2 * (n - len(out)) + 64
        ns = rng.choice(np.asarray(syllables), size=m, p=np.asarray(weights))
        cons = rng.integers(len(CONSONANTS), size=(m, max(syllables)))
        vows = rng.integers(len(VOWELS), size=(m, max(syllables)))
        fin = rng.integers(len(FINAL_VOWELS), size=m)
        for i in range(m):
            k = int(ns[i])
            w = "".join(CONSONANTS[cons[i, j]] + VOWELS[vows[i, j]]
                        for j in range(k - 1))
            w += CONSONANTS[cons[i, k - 1]] + FINAL_VOWELS[fin[i]]
            if w not in seen:
                seen.add(w)
                out.append(w)
                if len(out) == n:
                    break
    return out


class Zipf:
    """Word ranks drawn with P(rank r) proportional to 1 / r**exponent,
    r = 1..n, by inverse CDF (one searchsorted per batch of draws)."""

    def __init__(self, n: int, exponent: float) -> None:
        w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** float(exponent)
        self.cdf = np.cumsum(w / w.sum())
        self.cdf[-1] = 1.0

    def draw(self, rng: np.random.Generator, size) -> np.ndarray:
        return np.minimum(np.searchsorted(self.cdf, rng.random(size),
                                          side="right"),
                          len(self.cdf) - 1).astype(np.int32)


def ragged(rng: np.random.Generator, zipf: Zipf, count: int, lo: int,
           hi: int) -> Tuple[np.ndarray, np.ndarray]:
    """``count`` rows of word ranks with lengths uniform in [lo, hi]:
    (flat ranks, offsets [count + 1])."""
    lens = rng.integers(lo, hi + 1, size=count)
    offsets = np.zeros(count + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    return zipf.draw(rng, int(offsets[-1])), offsets


def render(words: Sequence[str], flat: np.ndarray,
           offsets: np.ndarray) -> List[str]:
    """Rows of word ranks as space-joined strings, built as one byte
    buffer (a Python join per row would dominate set-up at corpus
    scale)."""
    if len(offsets) <= 1:
        return []
    enc = [w.encode("ascii") for w in words]
    wlen = np.fromiter((len(b) + 1 for b in enc), np.int64, len(enc))
    wstart = np.zeros(len(enc), np.int64)
    np.cumsum(wlen[:-1], out=wstart[1:])
    lex = np.frombuffer(b" ".join(enc) + b" ", np.uint8)
    tl = wlen[flat]
    out_start = np.zeros(len(flat), np.int64)
    np.cumsum(tl[:-1], out=out_start[1:])
    total = int(tl.sum())
    src = np.repeat(wstart[flat] - out_start, tl) + np.arange(total)
    buf = lex[src]
    # the space after each row's last word becomes the row separator
    ends = out_start[offsets[1:] - 1] + tl[offsets[1:] - 1] - 1
    buf[ends] = ord("\n")
    return buf.tobytes().decode("ascii").split("\n")[:-1]
