"""Heavy-resource initialization: generator, encoder, dense and BM25
indexes.

Counterpart of ``sdag_tpu/pipeline/resources.py`` for the settings this
port serves: sparse, dense and hybrid retrieval, knn neighbor windows, the
centroid selection strategies, the three defenses (none, ragdefender,
discern_and_answer), a native checkpoint, a local HF checkpoint
(``LLM_CHECKPOINT`` / ``RANKER_CHECKPOINT``, converted to float32 as in the
JAX package) or random weights at a named architecture, int8 weights
(quantized at load), the int8 KV cache, speculative decoding, and the
meshes of ``core/mesh.py`` over the torchrun world: the decoder
tensor-parallel over ``MESH_MODEL`` ranks with its batches split over
``MESH_DATA`` (int8 weights are served replicated on the data ranks, with
``MESH_MODEL=1``), the encoder's batches split over ``MESH_DATA`` ranks,
the indexes row-sharded over all ranks.

The E5 encoder is built only when a setting calls it (dense or hybrid
retrieval, ``DOC_NEIGHBORS_K > 0``, a centroid selection strategy, the
ragdefender defense); the JAX package always builds one.  A sparse-only
run with random selection and no embedding defense never encodes, so it
does not pay for the weights.
"""

from __future__ import annotations

import functools
import json
import os
from typing import List, Optional, Tuple

import torch

from sdag_tpu_torch.config import Config
from sdag_tpu_torch.core.mesh import (make_index_mesh, make_mesh, mesh_shape,
                                      world_size)
from sdag_tpu_torch.datamodels import Resources
from sdag_tpu_torch.models.e5 import (E5Encoder, EncoderConfig,
                                      init_encoder_params)
from sdag_tpu_torch.models.hf_convert import (load_decoder_checkpoint,
                                              load_encoder_checkpoint)
from sdag_tpu_torch.models.llama import (DecoderConfig, init_decoder_params,
                                         quantize_decoder_params_int8)
from sdag_tpu_torch.models.tokenizer import load_tokenizer
from sdag_tpu_torch.retrieval.dense import (INDEX_DTYPES, DenseIndex,
                                            DenseRetriever)
from sdag_tpu_torch.retrieval.hybrid import HybridRetriever
from sdag_tpu_torch.retrieval.sparse import BM25Index, SparseRetriever
from sdag_tpu_torch.sdag.generate import Generator
from sdag_tpu_torch.utils.device import resolve_device


def _encoder_config(arch: str) -> EncoderConfig:
    if arch == "e5-large-v2":
        return EncoderConfig.e5_large_v2()
    if arch == "tiny":
        return EncoderConfig.tiny()
    # a typo must not silently run the experiment on a random toy model
    # and write plausible-looking garbage metrics
    raise ValueError(f"Unknown RANKER_ARCH {arch!r}: expected "
                     "'e5-large-v2' or 'tiny'")


def _decoder_config(arch: str) -> DecoderConfig:
    if arch == "llama3-8b":
        return DecoderConfig.llama3_8b()
    if arch == "mellum2-12b-a2.5b":
        return DecoderConfig.mellum2_12b_a2p5b()
    if arch == "tiny":
        return DecoderConfig.tiny()
    raise ValueError(f"Unknown LLM_ARCH {arch!r}: expected 'llama3-8b', "
                     "'mellum2-12b-a2.5b' or 'tiny'")


def check_supported(cfg: Config) -> None:
    """Raise ValueError, before anything is loaded, when the configured
    meshes do not fit this process' torch.distributed world (one rank
    without torchrun)."""
    # the decoder's data x model mesh; the encoder's data x 1 fits if it
    # does
    mesh_shape(cfg.MESH_DATA, cfg.MESH_MODEL, world_size())


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
    elif cfg.LLM_CHECKPOINT:
        # an HF dir: float32 tree (as the JAX package), read one tensor at
        # a time; the shard mappings are closed when this returns
        tok = load_tokenizer(cfg.LLM_CHECKPOINT)
        params, dec_cfg = load_decoder_checkpoint(cfg.LLM_CHECKPOINT,
                                                  device=dev)
    else:
        tok = load_tokenizer("")
        dec_cfg = _decoder_config(cfg.LLM_ARCH)
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.SEED + 1)
        params = init_decoder_params(gen, dec_cfg, device=dev)
    if cfg.LLM_WEIGHTS_DTYPE == "int8":
        # weight-only int8 serving, quantized once at load, each float
        # matrix freed as it goes (the forwards dispatch on leaf type);
        # with MESH_DATA > 1 the int8 tree is replicated on the data ranks
        params = quantize_decoder_params_int8(params, consume=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    mesh = None
    if cfg.MESH_MODEL > 1 or cfg.MESH_DATA > 1:
        # 'model' = tensor parallelism, 'data' = batch rows; every rank
        # made the whole tree from the seed and keeps its slices
        mesh = make_mesh(data=cfg.MESH_DATA, model=max(cfg.MESH_MODEL, 1),
                         device=dev)
    gen = Generator(params, dec_cfg, tok, temperature=cfg.TEMPERATURE,
                    top_p=cfg.TOP_P, seed=cfg.SEED,
                    batch_bucket=cfg.LLM_BATCH_SIZE,
                    kv_cache_dtype=cfg.KV_CACHE_DTYPE,
                    speculative_draft=cfg.SPECULATIVE_DRAFT_LEN, device=dev,
                    mesh=mesh)
    del params
    if mesh is not None and dev.type == "cuda":
        torch.cuda.empty_cache()
    return gen


def needs_encoder(cfg: Config) -> bool:
    """Whether any setting of this run calls the E5 encoder."""
    return (cfg.RETRIEVER_BACKEND in {"dense", "sparse_and_dense"}
            or cfg.DOC_NEIGHBORS_K > 0
            or cfg.MALICIOUS_DOC_SELECTION_STRATEGY != "random"
            or cfg.DEFENSE_BACKEND == "ragdefender")


def build_encoder(cfg: Config, device="cuda") -> E5Encoder:
    """The HF ranker checkpoint ``RANKER_CHECKPOINT`` (float32, with its
    own tokenizer), else random weights at ``RANKER_ARCH`` from
    ``cfg.SEED``."""
    check_supported(cfg)
    dev = resolve_device(device)
    if cfg.RANKER_CHECKPOINT:
        params, enc_cfg = load_encoder_checkpoint(cfg.RANKER_CHECKPOINT,
                                                  device=dev)
    else:
        enc_cfg = _encoder_config(cfg.RANKER_ARCH)
        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.SEED)
        params = init_encoder_params(gen, enc_cfg, device=dev)
    # batches split over the data axis (MESH_DATA=0: all ranks); without
    # a process group the mesh has one rank and encoding is unchanged
    dp_mesh = make_mesh(data=cfg.MESH_DATA, model=1, device=dev) \
        if cfg.MESH_DATA != 1 else None
    return E5Encoder(params, enc_cfg, load_tokenizer(cfg.RANKER_CHECKPOINT),
                     model_name=cfg.RANKER_MODEL_NAME, device=dev,
                     dp_mesh=dp_mesh)


def init_resources(cfg: Config, device="cuda",
                   encoder: Optional[E5Encoder] = None) -> Resources:
    """``encoder``: a ready E5Encoder to use instead of building one."""
    check_supported(cfg)
    dev = resolve_device(device)
    # corpus rows sharded over every rank
    mesh = make_index_mesh(dev)
    if encoder is None and needs_encoder(cfg):
        encoder = build_encoder(cfg, device=dev)
    generator = build_generator(cfg, device=dev)

    dense_index = None
    sparse_index = None
    need_dense = cfg.RETRIEVER_BACKEND in {"dense", "sparse_and_dense"}
    need_sparse = cfg.RETRIEVER_BACKEND in {"sparse", "sparse_and_dense"}

    @functools.lru_cache(maxsize=None)
    def corpus():
        """One corpus read shared by both build paths."""
        return load_corpus_jsonl(cfg.CORPUS_JSONL_PATH)

    if need_dense:
        if cfg.DENSE_INDEX_DTYPE not in INDEX_DTYPES:
            # membership-checked like every other config enum: 'bf16'
            # silently loading a float32 index would ignore the user's
            # quantization choice at 2x the memory
            raise ValueError(f"Unknown DENSE_INDEX_DTYPE "
                             f"{cfg.DENSE_INDEX_DTYPE!r}: expected one of "
                             f"{sorted(INDEX_DTYPES)}")
        idx_kw = dict(dtype=INDEX_DTYPES[cfg.DENSE_INDEX_DTYPE],
                      search_mode=cfg.DENSE_SEARCH_MODE,
                      int8_rescore=cfg.DENSE_INT8_RESCORE, device=dev,
                      mesh=mesh)
        if os.path.isdir(cfg.DENSE_INDEX_PATH):
            print(f"[resources] loading dense index: {cfg.DENSE_INDEX_PATH}")
            meta_path = cfg.META_JSONL_PATH \
                if os.path.exists(cfg.META_JSONL_PATH) else None
            dense_index = DenseIndex.load(cfg.DENSE_INDEX_PATH,
                                          meta_path=meta_path, **idx_kw)
        elif cfg.CORPUS_JSONL_PATH:
            print("[resources] building dense index from corpus "
                  f"{cfg.CORPUS_JSONL_PATH}")
            texts, ids = corpus()
            dense_index = DenseIndex.from_texts(
                texts, ids, encoder, batch_size=cfg.BATCH_SIZE_EMBED_Q,
                **idx_kw)
            if cfg.DENSE_INDEX_PATH:
                dense_index.save(cfg.DENSE_INDEX_PATH)
        else:
            raise FileNotFoundError(
                f"No dense index at {cfg.DENSE_INDEX_PATH} and no "
                "CORPUS_JSONL_PATH to build one")

    if need_sparse:
        sp = cfg.SPARSE_INDEX_NAME_OR_PATH
        if sp and os.path.isdir(sp):
            print(f"[resources] loading sparse index: {sp}")
            sparse_index = BM25Index.load(sp, engine=cfg.BM25_ENGINE,
                                          device=dev, mesh=mesh)
        elif cfg.CORPUS_JSONL_PATH:
            print("[resources] building BM25 index from corpus "
                  f"{cfg.CORPUS_JSONL_PATH}")
            texts, ids = corpus()
            sparse_index = BM25Index.from_texts(texts, ids, k1=cfg.BM25_K1,
                                                b=cfg.BM25_B,
                                                engine=cfg.BM25_ENGINE,
                                                device=dev, mesh=mesh)
            if sp:
                sparse_index.save(sp)
        else:
            raise FileNotFoundError(
                "No sparse index and no CORPUS_JSONL_PATH to build one")

    return Resources(ranker=encoder, tokenizer=generator.tokenizer,
                     generator=generator, dense_index=dense_index,
                     sparse_index=sparse_index)


def build_retriever(cfg: Config, res: Resources):
    """Factory keyed on RETRIEVER_BACKEND (reference ``main.py:246-267``)."""
    check_supported(cfg)
    if cfg.RETRIEVER_BACKEND == "dense":
        return DenseRetriever(res.ranker, res.dense_index)
    if cfg.RETRIEVER_BACKEND == "sparse":
        return SparseRetriever(res.sparse_index)
    if cfg.RETRIEVER_BACKEND == "sparse_and_dense":
        return HybridRetriever(DenseRetriever(res.ranker, res.dense_index),
                               SparseRetriever(res.sparse_index),
                               seed=cfg.SEED)
    raise ValueError(f"Unknown RETRIEVER_BACKEND: {cfg.RETRIEVER_BACKEND}")


def build_defense(cfg: Config, res: Resources):
    """Factory keyed on DEFENSE_BACKEND (reference ``main.py:270-286``)."""
    check_supported(cfg)
    if cfg.DEFENSE_BACKEND == "none":
        from sdag_tpu_torch.defenses.none import NoDefense
        return NoDefense()
    if cfg.DEFENSE_BACKEND == "ragdefender":
        from sdag_tpu_torch.defenses.ragdefender import \
            EmbeddingFilterDefense
        return EmbeddingFilterDefense(res.ranker)
    if cfg.DEFENSE_BACKEND == "discern_and_answer":
        from sdag_tpu_torch.defenses.discern import (
            DiscernAndAnswerDefense, make_local_batch_classifier,
            make_local_classifier, make_openai_classifier)
        classify_batch = None
        if cfg.DISCERN_OPENAI_API_KEY:
            classify = make_openai_classifier(
                cfg.DISCERN_OPENAI_API_KEY, cfg.DISCERN_CLASSIFIER_MODEL,
                cfg.DISCERN_CLASSIFY_TEMPERATURE)
        else:
            classify = make_local_classifier(res.generator)
            classify_batch = make_local_batch_classifier(res.generator)
        return DiscernAndAnswerDefense(
            classify, max_docs_to_classify=cfg.DISCERN_MAX_DOCS_TO_CLASSIFY,
            classify_batch=classify_batch)
    raise ValueError(f"Unknown DEFENSE_BACKEND: {cfg.DEFENSE_BACKEND}")
