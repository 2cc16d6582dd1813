"""Text analysis front-end for BM25: C++ library via ctypes, Python fallback.

The C++ analyzer (``sdag_tpu/native/analyzer.cpp``) reproduces Lucene's
EnglishAnalyzer chain — StandardTokenizer (UAX#29 word segmentation,
Unicode-aware: accents kept, CJK per-ideogram/Katakana runs, apostrophe /
dot / comma medials), EnglishPossessiveFilter ('s stripping), Unicode
LowerCaseFilter, the 33-word English stopword set, and Porter stemming —
so device-side BM25 ranking matches a Lucene/Pyserini baseline at equal
analysis.  It is compiled on first use with the baked-in toolchain; the
pure-Python fallback implements the identical algorithm (agreement is
tested), and ``tests/fixtures/lucene_english_golden.json`` pins the
EnglishAnalyzer behavior case by case.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional

_NATIVE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CPP = os.path.join(_NATIVE_DIR, "native", "analyzer.cpp")
_SO = os.path.join(_NATIVE_DIR, "native", "libanalyzer.so")

ENGLISH_STOPWORDS = frozenset({
    "a", "an", "and", "are", "as", "at", "be", "but", "by", "for", "if",
    "in", "into", "is", "it", "no", "not", "of", "on", "or", "such",
    "that", "the", "their", "then", "there", "these", "they", "this",
    "to", "was", "will", "with"})


def _build_native() -> Optional[str]:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_CPP):
        return _SO
    # build to a private file and rename it into place, so a concurrent
    # process (parallel test workers) never loads a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    for cc in ("g++", "c++", "clang++"):
        try:
            subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", "-std=c++17", _CPP, "-o", tmp],
                check=True, capture_output=True)
            os.replace(tmp, _SO)
            return _SO
        except (FileNotFoundError, subprocess.CalledProcessError):
            continue
    return None


class _NativeAnalyzer:
    def __init__(self, so_path: str) -> None:
        self.lib = ctypes.CDLL(so_path)
        self.lib.analyze_batch.restype = ctypes.POINTER(ctypes.c_char)
        self.lib.analyze_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        self.lib.analyzer_free.argtypes = [ctypes.POINTER(ctypes.c_char)]

    def analyze_batch(self, texts: List[str]) -> List[List[str]]:
        payload = "\x02".join(t.replace("\x01", " ").replace("\x02", " ")
                              for t in texts).encode("utf-8")
        out_len = ctypes.c_int64(0)
        buf = self.lib.analyze_batch(payload, len(payload),
                                     ctypes.byref(out_len))
        try:
            raw = ctypes.string_at(buf, out_len.value).decode(
                "utf-8", errors="replace")
        finally:
            self.lib.analyzer_free(buf)
        docs = raw.split("\x02")
        return [[t for t in d.split("\x01") if t] for d in docs]

    def build_counts(self, texts: List[str]):
        """Native BM25 index-build counting: analyze + vocab + (tid, tf)
        pairs + df + doc lengths in ONE C++ pass (the Python token lists
        are never materialized).  Returns the dict described in
        ``sparse.py:_counts_python``."""
        import numpy as np
        if not hasattr(self.lib, "bm25_build_counts"):
            return None
        self.lib.bm25_build_counts.restype = ctypes.POINTER(ctypes.c_char)
        self.lib.bm25_build_counts.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
        payload = "\x02".join(t.replace("\x01", " ").replace("\x02", " ")
                              for t in texts).encode("utf-8")
        out_len = ctypes.c_int64(0)
        buf = self.lib.bm25_build_counts(payload, len(payload),
                                         ctypes.byref(out_len))
        try:
            raw = ctypes.string_at(buf, out_len.value)
        finally:
            self.lib.analyzer_free(buf)
        hdr = np.frombuffer(raw, np.int64, count=4)
        n_docs, n_vocab, n_pairs, blob_len = (int(x) for x in hdr)
        off = 32
        doc_offsets = np.frombuffer(raw, np.int64, count=n_docs + 1,
                                    offset=off)
        off += 8 * (n_docs + 1)
        doc_len = np.frombuffer(raw, np.int32, count=n_docs, offset=off)
        off += 4 * n_docs
        df = np.frombuffer(raw, np.int32, count=n_vocab, offset=off)
        off += 4 * n_vocab
        pair_tid = np.frombuffer(raw, np.int32, count=n_pairs, offset=off)
        off += 4 * n_pairs
        pair_tf = np.frombuffer(raw, np.int32, count=n_pairs, offset=off)
        off += 4 * n_pairs
        blob = raw[off:off + blob_len].decode("utf-8", errors="replace")
        terms = blob.split("\x01") if blob else []
        return {"doc_offsets": doc_offsets.copy(),
                "doc_len": doc_len.copy(), "df": df.copy(),
                "pair_tid": pair_tid.copy(), "pair_tf": pair_tf.copy(),
                "terms": terms}


# --------------------------------------------------------------------------
# Pure-Python fallback: identical algorithm (tested for agreement with C++).
# --------------------------------------------------------------------------
_VOWELS = set("aeiou")


class _PyPorter:
    """Porter (1980) stemmer; mirrors native/analyzer.cpp step by step."""

    def stem(self, w: str) -> str:
        if len(w) <= 2:
            return w
        self.b = list(w)
        self.k = len(w) - 1
        self.j = 0
        self._step1ab(); self._step1c(); self._step2(); self._step3()
        self._step4(); self._step5()
        return "".join(self.b[: self.k + 1])

    def _cons(self, i):
        c = self.b[i]
        if c in _VOWELS:
            return False
        if c == "y":
            return True if i == 0 else not self._cons(i - 1)
        return True

    def _m(self):
        n = i = 0
        while True:
            if i > self.j:
                return n
            if not self._cons(i):
                break
            i += 1
        i += 1
        while True:
            while True:
                if i > self.j:
                    return n
                if self._cons(i):
                    break
                i += 1
            i += 1
            n += 1
            while True:
                if i > self.j:
                    return n
                if not self._cons(i):
                    break
                i += 1
            i += 1

    def _vowelinstem(self):
        return any(not self._cons(i) for i in range(self.j + 1))

    def _doublec(self, j):
        return j >= 1 and self.b[j] == self.b[j - 1] and self._cons(j)

    def _cvc(self, i):
        if i < 2 or not self._cons(i) or self._cons(i - 1) \
                or not self._cons(i - 2):
            return False
        return self.b[i] not in "wxy"

    def _ends(self, s):
        l = len(s)
        if l > self.k + 1:
            return False
        if "".join(self.b[self.k - l + 1: self.k + 1]) != s:
            return False
        self.j = self.k - l
        return True

    def _setto(self, s):
        self.b[self.j + 1:] = list(s)
        self.k = self.j + len(s)

    def _r(self, s):
        if self._m() > 0:
            self._setto(s)

    def _step1ab(self):
        if self.b[self.k] == "s":
            if self._ends("sses"):
                self.k -= 2
            elif self._ends("ies"):
                self._setto("i")
            elif self.b[self.k - 1] != "s":
                self.k -= 1
        if self._ends("eed"):
            if self._m() > 0:
                self.k -= 1
        elif (self._ends("ed") or self._ends("ing")) and self._vowelinstem():
            self.k = self.j
            if self._ends("at"):
                self._setto("ate")
            elif self._ends("bl"):
                self._setto("ble")
            elif self._ends("iz"):
                self._setto("ize")
            elif self._doublec(self.k):
                self.k -= 1
                if self.b[self.k] in "lsz":
                    self.k += 1
            elif self._m() == 1 and self._cvc(self.k):
                self._setto("e")

    def _step1c(self):
        if self._ends("y") and self._vowelinstem():
            self.b[self.k] = "i"

    _S2 = [("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
           ("anci", "ance"), ("izer", "ize"), ("bli", "ble"), ("alli", "al"),
           ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
           ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
           ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
           ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"),
           ("biliti", "ble"), ("logi", "log")]

    def _step2(self):
        for suf, rep in self._S2:
            if self._ends(suf):
                self._r(rep)
                return

    _S3 = [("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
           ("ical", "ic"), ("ful", ""), ("ness", "")]

    def _step3(self):
        for suf, rep in self._S3:
            if self._ends(suf):
                self._r(rep)
                return

    _S4 = ["al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
           "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive",
           "ize"]

    def _step4(self):
        for suf in self._S4:
            if self._ends(suf):
                if suf == "ion" and not (self.j >= 0
                                         and self.b[self.j] in "st"):
                    continue
                if self._m() > 1:
                    self.k = self.j
                return

    def _step5(self):
        self.j = self.k
        if self.b[self.k] == "e":
            a = self._m()
            if a > 1 or (a == 1 and not self._cvc(self.k - 1)):
                self.k -= 1
        if self.b[self.k] == "l" and self._doublec(self.k) and self._m() > 1:
            self.k -= 1


# token classes (mirrors native/analyzer.cpp)
(_OTHER, _LETTER, _DIGIT, _HAN, _HIRA, _KATA, _APOS, _DOT, _COMMA, _UNDER,
 _EXTEND) = range(11)
_MAX_TOKEN_LEN = 255  # StandardTokenizer maxTokenLength
_APOSTROPHES = {0x27, 0x2019, 0xFF07}


def _classify(ch: str) -> int:
    cp = ord(ch)
    if cp < 128:
        if ("a" <= ch <= "z") or ("A" <= ch <= "Z"):
            return _LETTER
        if "0" <= ch <= "9":
            return _DIGIT
        return {"_": _UNDER, "'": _APOS, ".": _DOT, ",": _COMMA
                }.get(ch, _OTHER)
    if cp in (0x2019, 0xFF07):
        return _APOS
    if cp == 0xFF0E:
        return _DOT
    import unicodedata
    cat = unicodedata.category(ch)
    # UAX#29 WB4: Extend (Mn/Mc/Me, incl. combining kana voicing marks)
    # and Format (Cf, incl. ZWJ/ZWNJ) are transparent and attach to the
    # token; U+200B ZERO WIDTH SPACE is excluded from Format by the spec
    # and breaks.  Checked BEFORE the script ranges: U+3099/309A sit
    # inside the Hiragana block but are Mn.
    if cat in ("Mn", "Mc", "Me") or (cat == "Cf" and cp != 0x200B):
        return _EXTEND
    # CJK before the general letter category (Han/Kana are Lo)
    if (0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF) or \
            (0xF900 <= cp <= 0xFAFF) or (0x20000 <= cp <= 0x2FA1F):
        return _HAN
    if 0x3041 <= cp <= 0x309F:
        return _HIRA
    if (0x30A0 <= cp <= 0x30FF) or (0x31F0 <= cp <= 0x31FF) or \
            (0xFF66 <= cp <= 0xFF9D):
        return _KATA
    if cat == "Nd":
        return _DIGIT
    # Nl (Roman numerals etc.) is Alphabetic -> ALetter in UAX#29
    if cat.startswith("L") or cat == "Nl":
        return _LETTER
    return _OTHER


def _lower1(ch: str) -> str:
    """1:1 lowercase (first codepoint of the full mapping), matching the
    native table and Java's Character.toLowerCase(int)."""
    if ch.isascii():
        return ch.lower()
    import unicodedata
    cat = unicodedata.category(ch)
    if not (cat.startswith("L") or cat == "Nl"):
        return ch
    low = ch.lower()
    return low[0] if low else ch


_ALNUM_CLS = {_LETTER, _DIGIT, _HAN, _HIRA, _KATA}


def tokenize_uax29(text: str) -> List[str]:
    """UAX#29-subset word segmentation (see native/analyzer.cpp header for
    the exact subset); returns raw tokens before any filtering.

    Join decisions use ``last_base`` — the class of the token's last
    non-Extend codepoint — so combining marks / format chars riding inside
    a token (WB4) never perturb the WB5-WB13 rules around them."""
    cls = [_classify(ch) for ch in text]
    n = len(text)
    tokens: List[str] = []
    cur: List[str] = []
    cur_has_alnum = False
    last_base = _OTHER

    def flush():
        nonlocal cur, cur_has_alnum, last_base
        if cur and cur_has_alnum:
            tokens.append("".join(cur))
        cur = []
        cur_has_alnum = False
        last_base = _OTHER

    def next_base(i: int) -> int:
        for j in range(i + 1, n):
            if cls[j] != _EXTEND:
                return cls[j]
        return _OTHER

    for i, ch in enumerate(text):
        c = cls[i]
        # force-split at maxTokenLength for ANY continuation — including
        # Extend/Format (WB4) chars, which would otherwise grow the open
        # token without bound (Lucene splits at 255 unconditionally)
        if len(cur) >= _MAX_TOKEN_LEN:
            flush()
        if c == _EXTEND:   # WB4: attach to the open token, never break
            if cur:
                cur.append(ch)
            continue
        if c in (_HAN, _HIRA):
            # one token per ideograph (kept open so trailing Extend
            # marks attach); nothing joins across it
            flush()
            cur.append(ch)
            cur_has_alnum = True
            last_base = c
        elif c == _KATA:
            if last_base not in (_KATA, _UNDER):  # WB13/WB13b
                flush()
            cur.append(ch)
            cur_has_alnum = True
            last_base = _KATA
        elif c in (_LETTER, _DIGIT):
            if last_base in (_HAN, _HIRA, _KATA):
                flush()
            cur.append(ch)
            cur_has_alnum = True
            last_base = c
        elif c == _UNDER:  # ExtendNumLet (WB13a/b): joins words/katakana
            if last_base in (_HAN, _HIRA):
                flush()
            cur.append(ch)
            last_base = _UNDER
        elif c == _APOS:   # MidLetter (WB6/7): letter ' letter
            if last_base == _LETTER and next_base(i) == _LETTER:
                cur.append(ch)
            else:
                flush()
        elif c == _DOT:    # MidNumLet: letter.letter / MidNum: digit.digit
            nb = next_base(i)
            if (last_base == _LETTER and nb == _LETTER) or \
                    (last_base == _DIGIT and nb == _DIGIT):
                cur.append(ch)
            else:
                flush()
        elif c == _COMMA:  # MidNum (WB11/12): digit,digit
            if last_base == _DIGIT and next_base(i) == _DIGIT:
                cur.append(ch)
            else:
                flush()
        else:
            flush()
    flush()
    return tokens


class _PythonAnalyzer:
    """Lucene EnglishAnalyzer chain: UAX#29 tokenize -> possessive filter ->
    lowercase -> stopwords -> Porter.  Bit-identical to the C++ analyzer."""

    def __init__(self) -> None:
        self._stemmer = _PyPorter()

    def analyze_batch(self, texts: List[str]) -> List[List[str]]:
        out = []
        for text in texts:
            toks = []
            for tok in tokenize_uax29(text):
                # EnglishPossessiveFilter: strip trailing 's / 'S
                if len(tok) >= 2 and tok[-1] in "sS" \
                        and ord(tok[-2]) in _APOSTROPHES:
                    tok = tok[:-2]
                tok = "".join(_lower1(ch) for ch in tok)
                if not tok or tok in ENGLISH_STOPWORDS:
                    continue
                stemmed = self._stemmer.stem(tok)
                if stemmed:
                    toks.append(stemmed)
            out.append(toks)
        return out


_analyzer = None


def get_analyzer(prefer_native: bool = True):
    """Singleton analyzer: native C++ when buildable, else Python."""
    global _analyzer
    if _analyzer is None:
        so = _build_native() if prefer_native else None
        _analyzer = _NativeAnalyzer(so) if so else _PythonAnalyzer()
    return _analyzer


def analyze_texts(texts: List[str]) -> List[List[str]]:
    return get_analyzer().analyze_batch(texts)


def build_counts_native(texts: List[str]):
    """One-pass native analyze+count for BM25 index builds, or None when
    the native library is unavailable (callers fall back to Python)."""
    a = get_analyzer()
    if isinstance(a, _NativeAnalyzer):
        return a.build_counts(texts)
    return None
