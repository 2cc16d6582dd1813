"""HF tokenizer dirs read without ``transformers`` / ``tokenizers``.

Counterpart of what ``transformers.AutoTokenizer`` gives the JAX package
(``sdag_tpu/models/tokenizer.py`` ``load_tokenizer``) for the reference's
two model families, from the files of a checkpoint dir
(``tokenizer.json``, ``tokenizer_config.json``, ``chat_template.jinja``,
or a BERT ``vocab.txt``):

- byte-level BPE (Llama 3): a ``Split`` pre-tokenizer regex, GPT-2's
  byte-to-unicode map, merges by rank (``ignore_merges``: a pre-token
  already in the vocab is one token), a ``TemplateProcessing``
  post-processor;
- WordPiece (BERT/E5): ``BertNormalizer``, ``BertPreTokenizer``, greedy
  longest match with ``##`` continuations, ``[CLS] ... [SEP]``.

Added and special tokens are split out of the text first, as the
``tokenizers`` library does.  Any other model, normalizer, pre-tokenizer,
post-processor or decoder type raises NotImplementedError naming it.

Python's ``re`` has no ``\\p{L}`` / ``\\p{N}`` and its ``\\s`` takes four
control characters the Oniguruma engine of ``tokenizers`` does not, so a
pre-tokenizer regex is rewritten with those classes spelled out as
code-point ranges built from ``unicodedata``.  Character classes follow
Python's Unicode tables; the library's are older in places (its BERT
punctuation test), so characters assigned in recent Unicode versions can
split differently (U+11B00, punctuation since Unicode 15.0, is one).
"""

from __future__ import annotations

import functools
import heapq
import json
import os
import re
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

TOKENIZER_FILE = "tokenizer.json"
TOKENIZER_CONFIG = "tokenizer_config.json"
CHAT_TEMPLATE_FILE = "chat_template.jinja"
VOCAB_FILE = "vocab.txt"

_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token",
                 "pad_token", "cls_token", "mask_token")
_BERT_SPECIALS = {"unk_token": "[UNK]", "sep_token": "[SEP]",
                  "pad_token": "[PAD]", "cls_token": "[CLS]",
                  "mask_token": "[MASK]"}


# ------------------------------------------------------ character classes
def _ranges(pred) -> str:
    """A regex character-class body (no brackets) of the code points that
    satisfy ``pred``, as ranges."""
    out, start = [], None
    for cp in range(0x110001):
        hit = cp < 0x110000 and pred(cp)
        if hit and start is None:
            start = cp
        elif not hit and start is not None:
            a, b = start, cp - 1
            out.append(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}")
            start = None
    return "".join(out)


@functools.lru_cache(maxsize=None)
def _category_class(name: str) -> str:
    """``\\p{name}`` for a general category (``L``) or subcategory
    (``Lu``)."""
    return _ranges(lambda cp: unicodedata.category(chr(cp)).startswith(name))


_WS_CHARS = frozenset("\t\n\x0b\x0c\r\x85") | frozenset(
    chr(cp) for cp in range(0x3100)
    if unicodedata.category(chr(cp)) in ("Zs", "Zl", "Zp"))


def _is_ws(c: str) -> bool:
    """Unicode White_Space: Oniguruma's ``\\s`` and Rust's
    ``char::is_whitespace`` (Python's ``str.isspace`` also takes
    U+001C-U+001F)."""
    return c in _WS_CHARS


@functools.lru_cache(maxsize=None)
def _ws_class() -> str:
    return _ranges(lambda cp: chr(cp) in _WS_CHARS)


def translate_regex(pattern: str) -> str:
    """An Oniguruma pattern as a Python ``re`` pattern: ``\\p{..}`` /
    ``\\P{..}`` and ``\\s`` / ``\\S`` spelled out as code-point classes."""
    out: List[str] = []
    i, in_class = 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            body, neg, j = None, False, i + 2
            if nxt in "pP" and pattern[i + 2:i + 3] == "{":
                j = pattern.index("}", i) + 1
                body, neg = _category_class(pattern[i + 3:j - 1]), nxt == "P"
            elif nxt in "sS":
                body, neg = _ws_class(), nxt == "S"
            if body is None:
                out.append(pattern[i:i + 2])
            elif in_class:
                if neg:
                    raise NotImplementedError(
                        f"negated class {pattern[i:j]} inside [...] in "
                        f"{pattern!r}")
                out.append(body)
            else:
                out.append(("[^" if neg else "[") + body + "]")
            i = j if body is not None else i + 2
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            i += 1
            if pattern[i:i + 1] == "^":
                out.append("^")
                i += 1
            if pattern[i:i + 1] == "]":       # a literal ] first
                out.append("\\]")
                i += 1
            continue
        if c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return "".join(out)


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _is_bert_punc(c: str) -> bool:
    o = ord(c)
    return ((33 <= o <= 47) or (58 <= o <= 64) or (91 <= o <= 96)
            or (123 <= o <= 126) or unicodedata.category(c).startswith("P"))


def _is_chinese(c: str) -> bool:
    o = ord(c)
    return (0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF
            or 0x20000 <= o <= 0x2A6DF or 0x2A700 <= o <= 0x2B73F
            or 0x2B740 <= o <= 0x2B81F or 0x2B920 <= o <= 0x2CEAF
            or 0xF900 <= o <= 0xFAFF or 0x2F800 <= o <= 0x2FA1F)


def _unsupported(kind: str, spec) -> NotImplementedError:
    name = spec.get("type") if isinstance(spec, dict) else spec
    return NotImplementedError(f"HF tokenizer {kind} {name!r} is not "
                               "supported (byte-level BPE and BERT "
                               "WordPiece are)")


# ------------------------------------------------------------ normalizers
# what BertNormalizer's clean_text drops (unassigned code points stay)
_CONTROL_CATEGORIES = ("Cc", "Cf", "Co", "Cs")


def _bert_normalizer(spec) -> Callable[[str], str]:
    clean = spec.get("clean_text", True)
    chinese = spec.get("handle_chinese_chars", True)
    lower = spec.get("lowercase", True)
    strip = spec.get("strip_accents")
    strip = lower if strip is None else strip

    def normalize(text: str) -> str:
        if clean:
            text = "".join(
                " " if _is_ws(c) else c for c in text
                if not (c in "\x00\ufffd" or (
                    c not in "\t\n\r"
                    and unicodedata.category(c) in _CONTROL_CATEGORIES)))
        if chinese:
            text = "".join(f" {c} " if _is_chinese(c) else c for c in text)
        if strip:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        if lower:
            text = "".join(c.lower() for c in text)
        return text
    return normalize


def _normalizer(spec) -> Callable[[str], str]:
    if spec is None:
        return lambda text: text
    if spec.get("type") == "BertNormalizer":
        return _bert_normalizer(spec)
    raise _unsupported("normalizer", spec)


# --------------------------------------------------------- pre-tokenizers
def _split_isolated(text: str, regex) -> List[str]:
    """The matches and the gaps between them, in order."""
    out, pos = [], 0
    for m in regex.finditer(text):
        if m.start() > pos:
            out.append(text[pos:m.start()])
        if m.end() > m.start():
            out.append(m.group())
        pos = m.end()
    if pos < len(text):
        out.append(text[pos:])
    return out


def _bert_pre_tokenize(text: str) -> List[str]:
    out: List[str] = []
    cur: List[str] = []
    for c in text:
        if _is_ws(c) or _is_bert_punc(c):
            if cur:
                out.append("".join(cur))
                cur = []
            if not _is_ws(c):
                out.append(c)
        else:
            cur.append(c)
    if cur:
        out.append("".join(cur))
    return out


def _pre_tokenizer(spec) -> Callable[[str], List[str]]:
    if spec is None:
        return lambda text: [text] if text else []
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def seq(text: str) -> List[str]:
            pieces = [text]
            for step in steps:
                pieces = [q for p in pieces for q in step(p)]
            return pieces
        return seq
    if kind == "Split":
        pat = spec["pattern"]
        src = (translate_regex(pat["Regex"]) if "Regex" in pat
               else re.escape(pat["String"]))
        if spec.get("invert") or spec.get("behavior") != "Isolated":
            raise _unsupported("pre_tokenizer",
                               f"Split/{spec.get('behavior')}"
                               f"{'/invert' if spec.get('invert') else ''}")
        regex = re.compile(src)
        return lambda text: _split_isolated(text, regex)
    if kind == "ByteLevel":
        # Llama 3's: after a Split, bytes mapped only (no regex, no prefix)
        if spec.get("use_regex", True) or spec.get("add_prefix_space"):
            raise _unsupported("pre_tokenizer", "ByteLevel with use_regex "
                               "or add_prefix_space")
        b2u = bytes_to_unicode()
        return lambda text: ["".join(b2u[b] for b in text.encode("utf-8"))]
    if kind == "BertPreTokenizer":
        return _bert_pre_tokenize
    raise _unsupported("pre_tokenizer", spec)


# ----------------------------------------------------------------- models
class _BPE:
    def __init__(self, spec) -> None:
        for key in ("dropout", "continuing_subword_prefix",
                    "end_of_word_suffix", "byte_fallback", "unk_token"):
            if spec.get(key):
                raise _unsupported("BPE option", key)
        self.vocab: Dict[str, int] = spec["vocab"]
        self.ranks: Dict[Tuple[str, str], int] = {}
        for r, m in enumerate(spec["merges"]):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self.ranks[(a, b)] = r
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self._cache: Dict[str, List[int]] = {}

    def __call__(self, word: str) -> List[int]:
        ids = self._cache.get(word)
        if ids is None:
            ids = self._tokenize(word)
            if len(self._cache) > 100_000:
                self._cache.clear()
            self._cache[word] = ids
        return ids

    def _tokenize(self, word: str) -> List[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        syms: List[Optional[str]] = list(word)
        n = len(syms)
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        prv = list(range(-1, n - 1))
        heap: List[Tuple[int, int]] = []

        def push(i: int) -> None:
            j = nxt[i]
            if j != -1:
                r = self.ranks.get((syms[i], syms[j]))
                if r is not None:
                    heapq.heappush(heap, (r, i))

        for i in range(n - 1):
            push(i)
        # the lowest rank first, the leftmost among equal ranks; an entry
        # is stale once its pair changed (the tokenizers library's rule)
        while heap:
            r, i = heapq.heappop(heap)
            j = nxt[i] if syms[i] is not None else -1
            if j == -1 or self.ranks.get((syms[i], syms[j])) != r:
                continue
            syms[i] = syms[i] + syms[j]
            syms[j] = None
            nxt[i] = nxt[j]
            if nxt[j] != -1:
                prv[nxt[j]] = i
            if prv[i] != -1:
                push(prv[i])
            push(i)
        # a symbol outside the vocab is dropped (no unk token), as the
        # tokenizers library drops it
        return [self.vocab[s] for s in syms
                if s is not None and s in self.vocab]


class _WordPiece:
    def __init__(self, spec) -> None:
        self.vocab: Dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token", "[UNK]")
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = int(spec.get("max_input_chars_per_word", 100))

    def __call__(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return [self.vocab[self.unk]]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = self.prefix + sub
                tid = self.vocab.get(sub)
                if tid is not None:
                    ids.append(tid)
                    break
                end -= 1
            else:
                return [self.vocab[self.unk]]
            start = end
        return ids


def _model(spec):
    kind = spec.get("type")
    if kind == "BPE" or (kind is None and "merges" in spec):
        return _BPE(spec)
    if kind == "WordPiece":
        return _WordPiece(spec)
    raise _unsupported("model", kind)


# --------------------------------------------------------------- decoders
def _byte_level_decode(tokens: List[str]) -> str:
    u2b = {c: b for b, c in bytes_to_unicode().items()}
    raw = bytearray()
    for t in tokens:
        if all(c in u2b for c in t):
            raw.extend(u2b[c] for c in t)
        else:
            raw.extend(t.encode("utf-8"))
    return raw.decode("utf-8", errors="replace")


def _wordpiece_cleanup(s: str) -> str:
    return (s.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" do not", " don't")
            .replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


def _decoder(spec) -> Callable[[List[str]], str]:
    kind = spec.get("type") if spec else None
    if kind == "ByteLevel":
        return _byte_level_decode
    if kind == "WordPiece":
        prefix = spec.get("prefix", "##")
        cleanup = spec.get("cleanup", True)

        def wordpiece(tokens: List[str]) -> str:
            out = []
            for i, t in enumerate(tokens):
                if i:
                    t = t[len(prefix):] if t.startswith(prefix) else " " + t
                out.append(_wordpiece_cleanup(t) if cleanup else t)
            return "".join(out)
        return wordpiece
    raise _unsupported("decoder", spec)


def clean_up_tokenization(s: str) -> str:
    """transformers' ``clean_up_tokenization`` (applied by ``decode`` when
    ``clean_up_tokenization_spaces`` is set)."""
    return (s.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


# -------------------------------------------------------- post-processors
def _post_processor(spec) -> Callable[[List[int]], List[int]]:
    if spec is None:
        return lambda ids: ids
    kind = spec.get("type")
    if kind == "ByteLevel":
        return lambda ids: ids
    if kind == "Sequence":
        steps = [_post_processor(s) for s in spec["processors"]]

        def seq(ids: List[int]) -> List[int]:
            for step in steps:
                ids = step(ids)
            return ids
        return seq
    if kind == "TemplateProcessing":
        specials = {k: list(v["ids"])
                    for k, v in spec.get("special_tokens", {}).items()}
        pieces = []
        for item in spec["single"]:
            if "SpecialToken" in item:
                pieces.append(specials[item["SpecialToken"]["id"]])
            elif "Sequence" in item:
                pieces.append(None)
            else:
                raise _unsupported("TemplateProcessing item", str(item))

        def template(ids: List[int]) -> List[int]:
            out: List[int] = []
            for p in pieces:
                out.extend(ids if p is None else p)
            return out
        return template
    if kind == "BertProcessing":
        cls_id, sep_id = spec["cls"][1], spec["sep"][1]
        return lambda ids: [cls_id] + ids + [sep_id]
    raise _unsupported("post_processor", spec)


# ------------------------------------------------------------ the class
def _token_content(val) -> Optional[str]:
    if isinstance(val, dict):
        return val.get("content")
    return val


def _bert_json_from_vocab(vocab_path: str, cfg: dict) -> dict:
    """The tokenizer.json that transformers' slow -> fast conversion
    builds for a BERT ``vocab.txt``."""
    vocab: Dict[str, int] = {}
    with open(vocab_path, encoding="utf-8") as fh:
        for i, line in enumerate(fh):
            vocab.setdefault(line.rstrip("\n"), i)
    tok = {k: _token_content(cfg.get(k)) or v
           for k, v in _BERT_SPECIALS.items()}
    lower = cfg.get("do_lower_case", True)
    added = [{"id": vocab[t], "content": t, "single_word": False,
              "lstrip": False, "rstrip": False, "normalized": False,
              "special": True}
             for t in dict.fromkeys(tok.values()) if t in vocab]
    cls_t, sep_t = tok["cls_token"], tok["sep_token"]
    return {
        "added_tokens": sorted(added, key=lambda a: a["id"]),
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": cfg.get(
                           "tokenize_chinese_chars", True),
                       "strip_accents": cfg.get("strip_accents"),
                       "lowercase": lower},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {"type": "BertProcessing",
                           "sep": [sep_t, vocab[sep_t]],
                           "cls": [cls_t, vocab[cls_t]]},
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": tok["unk_token"],
                  "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100, "vocab": vocab},
    }


class _AddedSplitter:
    """Splits added tokens out of a text as the tokenizers library does:
    leftmost-longest matches of their contents, each widened over the
    whitespace beside it where the token's lstrip / rstrip says so.  A
    candidate position is found by one character-class search, then the
    tokens starting with that character are tried longest first (one
    regex alternation over Llama's 256 specials scans several times
    slower)."""

    def __init__(self, added) -> None:
        self.by_first: Dict[str, List[Tuple[str, int, bool, bool]]] = {}
        for a in sorted(added, key=lambda a: -len(a["content"])):
            c = a["content"]
            self.by_first.setdefault(c[0], []).append(
                (c, a["id"], bool(a.get("lstrip")), bool(a.get("rstrip"))))
        self.first = re.compile(
            "[" + "".join(re.escape(ch) for ch in self.by_first) + "]")

    @classmethod
    def of(cls, added) -> Optional["_AddedSplitter"]:
        added = [a for a in added if a["content"]]
        return cls(added) if added else None

    def split(self, text: str):
        pos = i = 0
        n = len(text)
        while True:
            m = self.first.search(text, i)
            if m is None:
                break
            j = m.start()
            for content, tid, lstrip, rstrip in self.by_first[text[j]]:
                if text.startswith(content, j):
                    start, end = j, j + len(content)
                    while lstrip and start > pos and _is_ws(text[start - 1]):
                        start -= 1
                    while rstrip and end < n and _is_ws(text[end]):
                        end += 1
                    if start > pos:
                        yield text[pos:start], None
                    yield text[start:end], tid
                    pos = i = end
                    break
            else:
                i = j + 1
        if pos < n:
            yield text[pos:], None


class HFTokenizer:
    """Encode, decode and chat-template rendering of an HF tokenizer dir,
    with the attributes the port reads (``pad_token_id``,
    ``eos_token_id``, ``cls_token_id``, ``sep_token_id``, ...)."""

    def __init__(self, spec: dict, config: Optional[dict] = None,
                 chat_template: Optional[str] = None) -> None:
        config = config or {}
        model = spec["model"]
        self._model = _model(model)
        self._normalize = _normalizer(spec.get("normalizer"))
        self._pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self._decode_tokens = _decoder(spec.get("decoder"))
        self._vocab: Dict[str, int] = dict(model["vocab"])
        added = self._assign_added_ids(spec.get("added_tokens") or [],
                                       self._vocab)
        self._added: Dict[str, int] = {a["content"]: a["id"] for a in added}
        self._special_ids = {a["id"] for a in added if a.get("special")}
        self._id_to_token: Dict[int, str] = {v: k
                                             for k, v in self._vocab.items()}
        self._id_to_token.update({a["id"]: a["content"] for a in added})
        self._raw_split = _AddedSplitter.of(
            [a for a in added if not a.get("normalized")])
        self._norm_split = _AddedSplitter.of(
            [a for a in added if a.get("normalized")])
        self._post = _post_processor(spec.get("post_processor"))
        self.clean_up_tokenization_spaces = bool(
            config.get("clean_up_tokenization_spaces", False))

        tokens = {k: _token_content(config.get(k)) for k in _SPECIAL_KEYS}
        if model.get("type") == "WordPiece":
            for k, v in _BERT_SPECIALS.items():
                tokens[k] = tokens[k] or v
        if tokens["pad_token"] is None:
            # the JAX loader's rule: no pad token -> pad with eos
            tokens["pad_token"] = tokens["eos_token"]
        self.special_tokens = {k: v for k, v in tokens.items()
                               if v is not None}
        for k in _SPECIAL_KEYS:
            tok = tokens[k]
            setattr(self, k, tok)
            setattr(self, k + "_id",
                    None if tok is None else self.token_to_id(tok))
        self.chat_template = chat_template

    # -------------------------------------------------------- loading
    @classmethod
    def from_dir(cls, path: str) -> "HFTokenizer":
        """Read ``tokenizer.json`` (or a BERT ``vocab.txt``),
        ``tokenizer_config.json`` and the chat template of ``path``."""
        cfg_path = os.path.join(path, TOKENIZER_CONFIG)
        config: dict = {}
        if os.path.isfile(cfg_path):
            with open(cfg_path, encoding="utf-8") as fh:
                config = json.load(fh)
        tok_path = os.path.join(path, TOKENIZER_FILE)
        if os.path.isfile(tok_path):
            with open(tok_path, encoding="utf-8") as fh:
                spec = json.load(fh)
        elif os.path.isfile(os.path.join(path, VOCAB_FILE)):
            spec = _bert_json_from_vocab(os.path.join(path, VOCAB_FILE),
                                         config)
            config.setdefault("clean_up_tokenization_spaces", True)
        else:
            raise FileNotFoundError(f"no {TOKENIZER_FILE} or {VOCAB_FILE} "
                                    f"in {path}")
        template = config.get("chat_template")
        jinja_path = os.path.join(path, CHAT_TEMPLATE_FILE)
        if os.path.isfile(jinja_path):
            with open(jinja_path, encoding="utf-8") as fh:
                template = fh.read()
        if template is not None and not isinstance(template, str):
            raise _unsupported("chat_template", "a list of named templates")
        return cls(spec, config, template)

    @staticmethod
    def _assign_added_ids(added, vocab):
        """The ids the tokenizers library gives the added tokens on load
        (the file's ids only order them): a token in the model vocab keeps
        its vocab id, a new one takes the next id past the vocab and the
        added tokens so far."""
        out, top = [], None
        for a in sorted(added, key=lambda a: a["id"]):
            if a.get("single_word"):
                raise _unsupported("added-token option", "single_word")
            tid = vocab.get(a["content"])
            if tid is None:
                tid = (top + 1 if top is not None and top >= len(vocab)
                       else len(vocab))
            top = tid if top is None else max(top, tid)
            out.append(dict(a, id=tid))
        return out

    def token_to_id(self, token: str) -> Optional[int]:
        tid = self._added.get(token)
        return self._vocab.get(token) if tid is None else tid

    # -------------------------------------------------------- encoding
    @staticmethod
    def _split_added(text: str, splitter):
        """(piece, None) for text, (content, id) for an added token."""
        if splitter is None:
            if text:
                yield text, None
            return
        yield from splitter.split(text)

    def encode(self, text: str, add_special_tokens: bool = True
               ) -> List[int]:
        ids: List[int] = []
        for piece, tid in self._split_added(text, self._raw_split):
            if tid is not None:
                ids.append(tid)
                continue
            for part, tid2 in self._split_added(self._normalize(piece),
                                                self._norm_split):
                if tid2 is not None:
                    ids.append(tid2)
                    continue
                for word in self._pre_tokenize(part):
                    if word:
                        ids.extend(self._model(word))
        return self._post(ids) if add_special_tokens else ids

    # -------------------------------------------------------- decoding
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: Optional[bool] = None) -> str:
        """Ids with no token decode to nothing, as in ``tokenizers``;
        ``clean_up_tokenization_spaces=None`` takes the dir's setting."""
        tokens = []
        for i in ids:
            i = int(i)
            tok = self._id_to_token.get(i)
            if tok is None or (skip_special_tokens
                               and i in self._special_ids):
                continue
            tokens.append(tok)
        text = self._decode_tokens(tokens)
        if clean_up_tokenization_spaces is None:
            clean_up_tokenization_spaces = self.clean_up_tokenization_spaces
        if clean_up_tokenization_spaces:
            text = clean_up_tokenization(text)
        return text

    # --------------------------------------------------- chat template
    def apply_chat_template(self, messages: List[Dict[str, str]],
                            tokenize: bool = False,
                            add_generation_prompt: bool = True):
        """Render the dir's chat template as transformers does: a
        sandboxed jinja2 environment with ``trim_blocks``,
        ``lstrip_blocks`` and ``loopcontrols``, the ``raise_exception``
        and ``strftime_now`` globals, a ``tojson`` filter, and the special
        tokens as variables."""
        if not self.chat_template:
            raise ValueError("this tokenizer has no chat template")
        text = _compile_template(self.chat_template).render(
            messages=messages, tools=None, documents=None,
            add_generation_prompt=add_generation_prompt,
            **self.special_tokens)
        return self.encode(text, add_special_tokens=False) if tokenize \
            else text


@functools.lru_cache(maxsize=8)
def _compile_template(template: str):
    import datetime

    import jinja2
    import jinja2.ext
    from jinja2.sandbox import ImmutableSandboxedEnvironment

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None,
               sort_keys=False):
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                          separators=separators, sort_keys=sort_keys)

    def strftime_now(fmt):
        return datetime.datetime.now().strftime(fmt)

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True,
        extensions=[jinja2.ext.loopcontrols])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = strftime_now
    return env.from_string(template)
