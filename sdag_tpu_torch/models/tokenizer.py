"""Tokenization.

``load_tokenizer`` reads a checkpoint dir's own tokenizer: the word
tokenizer of a native trained checkpoint, or the HF tokenizer files of an
HF checkpoint (``models/hf_tokenizer.py``, read without ``transformers``;
only local dirs: nothing is downloaded).
Without a dir, or for a dir with no tokenizer files, it falls back to a
deterministic byte-level tokenizer with a Llama-3-style chat template,
which is what the tests and the random-weight model scale use.

Unlike the reference — which recovers document token spans by substring
search plus re-tokenizing every prefix (``SDAG.py:277-302``) — prompts here
are built from independently tokenized segments (sdag/spans.py), so any
tokenizer that is prefix-stable per segment works.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Sequence

from sdag_tpu_torch.models.hf_tokenizer import (TOKENIZER_FILE, VOCAB_FILE,
                                                HFTokenizer)

_SPECIALS = [
    "<|pad|>",
    "<|begin_of_text|>",
    "<|end_of_text|>",
    "<|start_header_id|>",
    "<|end_header_id|>",
    "<|eot_id|>",
]


class ByteTokenizer:
    """Byte-level tokenizer: ids 0-255 are raw bytes; specials follow.

    vocab_size is padded to a lane-friendly 512.
    """

    def __init__(self) -> None:
        self._special_to_id: Dict[str, int] = {
            s: 256 + i for i, s in enumerate(_SPECIALS)}
        self._id_to_special = {v: k for k, v in self._special_to_id.items()}
        self.vocab_size = 512
        self.pad_token_id = self._special_to_id["<|pad|>"]
        self.bos_token_id = self._special_to_id["<|begin_of_text|>"]
        self.eos_token_id = self._special_to_id["<|eot_id|>"]
        self._special_re = re.compile(
            "(" + "|".join(re.escape(s) for s in _SPECIALS) + ")")

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids: List[int] = []
        if add_special_tokens:
            ids.append(self.bos_token_id)
        for part in self._special_re.split(text):
            if not part:
                continue
            if part in self._special_to_id:
                ids.append(self._special_to_id[part])
            else:
                ids.extend(part.encode("utf-8"))
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True
               ) -> str:
        out: List[str] = []
        buf = bytearray()
        for i in ids:
            i = int(i)
            if i in self._id_to_special:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                if not skip_special_tokens:
                    out.append(self._id_to_special[i])
            elif 0 <= i < 256:
                buf.append(i)
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)

    def apply_chat_template(self, messages: List[Dict[str, str]],
                            tokenize: bool = False,
                            add_generation_prompt: bool = True) -> str:
        parts = ["<|begin_of_text|>"]
        for m in messages:
            parts.append(
                f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
                f"{m['content']}<|eot_id|>")
        if add_generation_prompt:
            parts.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        text = "".join(parts)
        if tokenize:
            return self.encode(text)
        return text


# Piece pattern shared by WordTokenizer and vocab builders: a word with
# optional leading space (GPT-2-style), a whitespace run, or one
# punctuation char.  Alternation order matters (space+word wins).
_PIECE_RE = re.compile(r" [A-Za-z0-9]+|[A-Za-z0-9]+|\s+|[^\sA-Za-z0-9]")


def iter_pieces(text: str) -> List[str]:
    """Split text into WordTokenizer pieces (exact partition: concatenating
    the pieces reproduces the text)."""
    return _PIECE_RE.findall(text)


WORD_TOKENIZER_FILE = "word_tokenizer.json"


class WordTokenizer(ByteTokenizer):
    """Closed-vocabulary word/piece tokenizer with byte fallback.

    Layout: ids 0-255 raw bytes (fallback), 256-261 the ByteTokenizer
    specials (same ids — checkpoints agree on eos/pad), 262+ the piece
    vocabulary; vocab_size padded to a multiple of 256.

    Encoding: split on specials, then into pieces (``iter_pieces``); each
    piece resolves by direct lookup, else greedy longest-match segmentation
    over the vocab (e.g. a fresh pseudoword entity splits into its CV
    syllables), else the piece's raw UTF-8 bytes.  Decoding concatenates
    piece strings, so round-trip is exact for ANY input.

    The reference serves pretrained subword models; the from-scratch
    SDAG-effect experiment (pipeline/train_qa.py) uses this to train at a
    word-level sequence length ~3-4x shorter than bytes, which is what
    makes the 20-50M-param scale trainable in this offline environment.
    """

    def __init__(self, pieces: Sequence[str]) -> None:
        super().__init__()
        self._pieces: List[str] = list(dict.fromkeys(pieces))
        base = 256 + len(_SPECIALS)
        self._piece_to_id = {p: base + i for i, p in enumerate(self._pieces)}
        self._id_to_piece = {v: k for k, v in self._piece_to_id.items()}
        self._max_piece = max((len(p) for p in self._pieces), default=1)
        n = base + len(self._pieces)
        self.vocab_size = ((n + 255) // 256) * 256

    def _segment(self, piece: str) -> List[int] | None:
        ids: List[int] = []
        i = 0
        while i < len(piece):
            for j in range(min(len(piece), i + self._max_piece), i, -1):
                tid = self._piece_to_id.get(piece[i:j])
                if tid is not None:
                    ids.append(tid)
                    i = j
                    break
            else:
                return None
        return ids

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids: List[int] = []
        if add_special_tokens:
            ids.append(self.bos_token_id)
        for part in self._special_re.split(text):
            if not part:
                continue
            if part in self._special_to_id:
                ids.append(self._special_to_id[part])
                continue
            for piece in iter_pieces(part):
                tid = self._piece_to_id.get(piece)
                if tid is not None:
                    ids.append(tid)
                    continue
                seg = self._segment(piece)
                if seg is not None:
                    ids.extend(seg)
                else:
                    ids.extend(piece.encode("utf-8"))
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True
               ) -> str:
        out: List[str] = []
        buf = bytearray()

        def flush() -> None:
            if buf:
                out.append(buf.decode("utf-8", errors="replace"))
                buf.clear()

        for i in ids:
            i = int(i)
            if i in self._id_to_special:
                flush()
                if not skip_special_tokens:
                    out.append(self._id_to_special[i])
            elif i in self._id_to_piece:
                flush()
                out.append(self._id_to_piece[i])
            elif 0 <= i < 256:
                buf.append(i)
        flush()
        return "".join(out)

    def save(self, ckpt_dir: str) -> None:
        import json
        with open(os.path.join(ckpt_dir, WORD_TOKENIZER_FILE), "w",
                  encoding="utf-8") as fh:
            json.dump({"pieces": self._pieces}, fh)

    @classmethod
    def load(cls, ckpt_dir: str) -> "WordTokenizer":
        import json
        with open(os.path.join(ckpt_dir, WORD_TOKENIZER_FILE),
                  encoding="utf-8") as fh:
            return cls(json.load(fh)["pieces"])


def load_tokenizer(name_or_path: str = ""):
    """Word tokenizer if the dir carries one (native trained checkpoints);
    an HF tokenizer if the dir has ``tokenizer.json`` or ``vocab.txt`` (a
    dir whose files cannot be read raises: the JAX package falls back to
    bytes when ``transformers`` fails, which would run an HF model on the
    wrong ids); byte fallback else."""
    if name_or_path and os.path.isfile(
            os.path.join(name_or_path, WORD_TOKENIZER_FILE)):
        return WordTokenizer.load(name_or_path)
    if name_or_path and os.path.isfile(
            os.path.join(name_or_path, "native_decoder.json")):
        # native trained checkpoint without a word tokenizer: byte
        return ByteTokenizer()
    if name_or_path and any(
            os.path.isfile(os.path.join(name_or_path, f))
            for f in (TOKENIZER_FILE, VOCAB_FILE)):
        return HFTokenizer.from_dir(name_or_path)
    return ByteTokenizer()
