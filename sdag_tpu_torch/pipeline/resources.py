"""Heavy-resource initialization: generator and BM25 index.

Counterpart of ``sdag_tpu/pipeline/resources.py`` for the settings this
port serves: BM25 retrieval (``RETRIEVER_BACKEND="sparse"``), no defense,
a native checkpoint or random weights at a named architecture, one device.
Every other setting raises NotImplementedError naming the ROADMAP item
that will serve it; no E5 encoder is built (BM25 and random selection do
not use one).
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import torch

from sdag_tpu_torch.config import Config
from sdag_tpu_torch.datamodels import Resources
from sdag_tpu_torch.models.llama import DecoderConfig, init_decoder_params
from sdag_tpu_torch.models.tokenizer import load_tokenizer
from sdag_tpu_torch.retrieval.sparse import BM25Index, SparseRetriever
from sdag_tpu_torch.sdag.generate import Generator
from sdag_tpu_torch.utils.device import resolve_device


def _decoder_config(arch: str) -> DecoderConfig:
    if arch == "llama3-8b":
        return DecoderConfig.llama3_8b()
    if arch == "tiny":
        return DecoderConfig.tiny()
    raise ValueError(f"Unknown LLM_ARCH {arch!r}: expected 'llama3-8b' "
                     "or 'tiny'")


def check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for settings outside this port's slice,
    naming the ROADMAP (Queue A) item that will serve each."""
    from sdag_tpu_torch.models.native_ckpt import is_native_checkpoint
    unsupported = [
        (cfg.RETRIEVER_BACKEND != "sparse",
         f"RETRIEVER_BACKEND={cfg.RETRIEVER_BACKEND!r}",
         "dense and hybrid retrieval"),
        (cfg.DEFENSE_BACKEND != "none",
         f"DEFENSE_BACKEND={cfg.DEFENSE_BACKEND!r}", "defenses"),
        (cfg.DOC_NEIGHBORS_K > 0, f"DOC_NEIGHBORS_K={cfg.DOC_NEIGHBORS_K}",
         "the E5 encoder and knn neighbors"),
        (cfg.MALICIOUS_DOC_SELECTION_STRATEGY != "random",
         f"MALICIOUS_DOC_SELECTION_STRATEGY="
         f"{cfg.MALICIOUS_DOC_SELECTION_STRATEGY!r}",
         "the E5 encoder and knn neighbors"),
        (cfg.KV_CACHE_DTYPE != "native",
         f"KV_CACHE_DTYPE={cfg.KV_CACHE_DTYPE!r}",
         "int8 weights and int8 KV cache"),
        (cfg.LLM_WEIGHTS_DTYPE != "native",
         f"LLM_WEIGHTS_DTYPE={cfg.LLM_WEIGHTS_DTYPE!r}",
         "int8 weights and int8 KV cache"),
        (cfg.SPECULATIVE_DRAFT_LEN > 0,
         f"SPECULATIVE_DRAFT_LEN={cfg.SPECULATIVE_DRAFT_LEN}",
         "speculative decoding"),
        (cfg.MESH_MODEL > 1 or cfg.MESH_DATA > 1,
         f"MESH_MODEL={cfg.MESH_MODEL}, MESH_DATA={cfg.MESH_DATA}",
         "TP/DP on torch.distributed"),
        (bool(cfg.LLM_CHECKPOINT)
         and not is_native_checkpoint(cfg.LLM_CHECKPOINT),
         f"an HF LLM_CHECKPOINT ({cfg.LLM_CHECKPOINT!r})", "hf_convert"),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(
                f"sdag_tpu_torch does not serve {what} yet: ROADMAP.md "
                f"Queue A, '{item}'")


def load_corpus_jsonl(path: str) -> Tuple[List[str], List[str]]:
    texts, ids = [], []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            ids.append(str(obj.get("id", len(ids))))
            texts.append(str(obj.get("text", obj.get("contents", ""))))
    return texts, ids


def build_generator(cfg: Config, device="cuda") -> Generator:
    from sdag_tpu_torch.models.native_ckpt import (is_native_checkpoint,
                                                   load_decoder)
    check_supported(cfg)
    dev = resolve_device(device)
    if is_native_checkpoint(cfg.LLM_CHECKPOINT):
        tok = load_tokenizer(cfg.LLM_CHECKPOINT)
        params, dec_cfg = load_decoder(cfg.LLM_CHECKPOINT, device=dev)
    else:
        tok = load_tokenizer("")
        dec_cfg = _decoder_config(cfg.LLM_ARCH)
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.SEED + 1)
        params = init_decoder_params(gen, dec_cfg, device=dev)
    return Generator(params, dec_cfg, tok, temperature=cfg.TEMPERATURE,
                     top_p=cfg.TOP_P, seed=cfg.SEED,
                     batch_bucket=cfg.LLM_BATCH_SIZE, device=dev)


def init_resources(cfg: Config, device="cuda") -> Resources:
    check_supported(cfg)
    dev = resolve_device(device)
    generator = build_generator(cfg, device=dev)
    sp = cfg.SPARSE_INDEX_NAME_OR_PATH
    if sp and os.path.isdir(sp):
        print(f"[resources] loading sparse index: {sp}")
        sparse_index = BM25Index.load(sp, engine=cfg.BM25_ENGINE, device=dev)
    elif cfg.CORPUS_JSONL_PATH:
        print("[resources] building BM25 index from corpus "
              f"{cfg.CORPUS_JSONL_PATH}")
        texts, ids = load_corpus_jsonl(cfg.CORPUS_JSONL_PATH)
        sparse_index = BM25Index.from_texts(texts, ids, k1=cfg.BM25_K1,
                                            b=cfg.BM25_B,
                                            engine=cfg.BM25_ENGINE,
                                            device=dev)
        if sp:
            sparse_index.save(sp)
    else:
        raise FileNotFoundError(
            "No sparse index and no CORPUS_JSONL_PATH to build one")
    return Resources(ranker=None, tokenizer=generator.tokenizer,
                     generator=generator, sparse_index=sparse_index)


def build_retriever(cfg: Config, res: Resources):
    """Factory keyed on RETRIEVER_BACKEND (sparse only in this port)."""
    check_supported(cfg)
    return SparseRetriever(res.sparse_index)


def build_defense(cfg: Config, res: Resources):
    """Factory keyed on DEFENSE_BACKEND (none only in this port)."""
    check_supported(cfg)
    from sdag_tpu_torch.defenses.none import NoDefense
    return NoDefense()
