"""Plain BM25 (the Lucene variant the port states: Anserini's k1 = 0.9,
b = 0.4, idf = ln(1 + (N - df + 0.5) / (df + 0.5)), the exact document
length, a query term counted once per occurrence) over the benchmark's
corpus of word ranks, in float64 on the given device.

The benchmark's words pass Lucene's EnglishAnalyzer unchanged (see
``portbench/common/textgen.py``), so a term is a word rank and a
document's length is its word count.  ``tf32=True`` is the precision
control: each term's impact rounded to TF32 (10 mantissa bits) and summed
in float32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class BM25:
    def __init__(self, flat: np.ndarray, offsets: np.ndarray,
                 device, k1: float = 0.9, b: float = 0.4) -> None:
        self.device = device
        n = len(offsets) - 1
        lens = np.diff(offsets)
        self.n = n
        self.flat = torch.as_tensor(flat, device=device).long()
        self.doc = torch.as_tensor(np.repeat(np.arange(n), lens),
                                   device=device)
        dl = torch.as_tensor(lens, device=device, dtype=torch.float64)
        self.norm = k1 * (1.0 - b + b * dl / dl.mean())
        # document frequency of each word: distinct (doc, word) pairs
        vocab = int(flat.max()) + 1 if len(flat) else 1
        pair = torch.unique(self.doc * vocab + self.flat)
        self.df = torch.bincount(pair % vocab, minlength=vocab).double()

    def scores(self, query_words: Sequence[int], tf32: bool = False
               ) -> torch.Tensor:
        """[N] float64 scores of one query (word ranks, repeats counted)."""
        out = torch.zeros(self.n, dtype=torch.float64, device=self.device)
        words, counts = np.unique(np.asarray(query_words), return_counts=True)
        for w, c in zip(words.tolist(), counts.tolist()):
            if w >= len(self.df) or self.df[w] == 0:
                continue
            df = self.df[w]
            idf = torch.log(1.0 + (self.n - df + 0.5) / (df + 0.5))
            tf = torch.bincount(self.doc[self.flat == w],
                                minlength=self.n).double()
            imp = idf * tf / (tf + self.norm)
            if tf32:
                imp = _round_tf32(imp.float()).double()
            out += c * imp
        if tf32:
            out = out.float().double()
        return out


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (round to nearest)."""
    bits = x.view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def rank_gap(ref_all: torch.Tensor, ids: Sequence[int],
             scores: Sequence[float]) -> float:
    """The widest gap of one query's returned top-k, as a share of the
    reference's best score: at each rank r the larger of (the reference's
    r-th best score - the reference's score of the returned id) and
    |returned score - the reference's score of that id|.  A missing hit
    (-1) where the reference has a match, or an id returned twice, reads
    the reference's r-th score (about 1)."""
    k = len(ids)
    top = torch.topk(ref_all, k).values.double().cpu().numpy()
    best = float(top[0]) if top[0] > 0 else 1.0
    worst, seen = 0.0, set()
    for r, (i, s) in enumerate(zip(ids, scores)):
        if i < 0 or i in seen:
            g = max(float(top[r]), 0.0) if i < 0 else best
        else:
            ref = float(ref_all[int(i)])
            g = max(float(top[r]) - ref, abs(float(s) - ref))
        seen.add(i)
        worst = max(worst, g / best)
    return worst
