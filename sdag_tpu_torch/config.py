"""Experiment configuration.

A typed dataclass replaces the reference's flat module of constants
(``src/pipeline/config.py:20-114``).  JSON overrides are applied by key with
type checking (the reference uses blind ``setattr``, ``main.py:97-99``), the
full config snapshot is embedded in every metrics JSON
(``config.py:135-158``), and the reference's misspelled flag
``RNAKED_LIST_ORDER_IN_PROMPT`` (``config.py:70``) is renamed to
``RANKED_LIST_ORDER_IN_PROMPT`` while the old spelling is still accepted in
JSON overrides for compatibility.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

# JSON keys accepted as aliases for renamed fields (reference compat).
_KEY_ALIASES: Dict[str, str] = {
    "RNAKED_LIST_ORDER_IN_PROMPT": "RANKED_LIST_ORDER_IN_PROMPT",
    # reference's FAISS index path maps to the packed dense index dir;
    # lowercase-suffixed gen-token keys map to the normalized names.
    "FAISS_INDEX_PATH": "DENSE_INDEX_PATH",
    "MAX_GEN_TOKENS_false_answer": "MAX_GEN_TOKENS_FALSE_ANSWER",
    "MAX_GEN_TOKENS_document": "MAX_GEN_TOKENS_DOCUMENT",
}
# Reference keys with no TPU equivalent (CUDA device selection, Lucene
# thread pool): accepted silently so reference configs load unchanged.
_IGNORED_REFERENCE_KEYS = {"DEVICE", "RAGDEFENDER_DEVICE", "SPARSE_THREADS"}


# LLM_ARCH presets whose layers hold sparse experts
EXPERT_LLM_ARCHS = frozenset({"mellum2-12b-a2.5b"})


@dataclass
class Config:
    # --- reproducibility ---------------------------------------------------
    SEED: int = 42
    SAMPLE_SIZE: int = 100

    # --- experiment grid ---------------------------------------------------
    # Retrieval depths, zipped with attack positions into (top_k, pos) pairs.
    TOP_K: List[int] = field(default_factory=lambda: [5])
    # Injection position per pair: >0 fixed 1-indexed rank, -1 random, 0 none.
    ADD_ATTACK_IN_RANK: List[int] = field(default_factory=lambda: [1])

    # --- batching ----------------------------------------------------------
    BATCH_SIZE_EMBED_Q: int = 32
    LLM_BATCH_SIZE: int = 4

    # --- dense index -------------------------------------------------------
    # Directory holding the packed device index (embeddings + meta manifest).
    DENSE_INDEX_PATH: str = "dense.index"
    META_JSONL_PATH: str = "docs_meta.jsonl"
    # Device storage dtype of the embedding matrix: float32 | bfloat16 |
    # int8 (per-row scales; a quarter of the float32 scan traffic).  With
    # DENSE_INT8_RESCORE (default) an int8 residual is kept alongside and
    # approx-mode candidates are rescored at ~15-bit precision at the int8
    # scan's cost, total memory = bf16.  Rescore off: pure int8, a quarter
    # of the memory at the int8 quantisation's recall; validate() warns on
    # that combination.
    DENSE_INDEX_DTYPE: str = "float32"
    DENSE_INT8_RESCORE: bool = True
    # Search algorithm: "approx" = matmul + candidate list + exact merge
    # (plain PyTorch ops; exact on this port, where the JAX package's
    # candidate stage is approximate on its accelerator); "exact" = the
    # fused matmul+top-k kernels K4/K5 on CUDA with exact (score desc,
    # index asc) tie-break.
    DENSE_SEARCH_MODE: str = "approx"

    # --- models ------------------------------------------------------------
    RANKER_MODEL_NAME: str = "intfloat/e5-large-v2"
    LLM_MODEL_NAME: str = "meta-llama/Llama-3.1-8B-Instruct"
    # Local checkpoint dirs (offline weight conversion); empty = random init
    # of the architecture named by *_ARCH below.
    RANKER_CHECKPOINT: str = ""
    LLM_CHECKPOINT: str = ""
    # Architecture preset when no checkpoint: tiny | e5-large-v2 (ranker),
    # tiny | llama3-8b | mellum2-12b-a2.5b (LLM; the last has experts).
    RANKER_ARCH: str = "tiny"
    LLM_ARCH: str = "tiny"
    # Corpus JSONL ({"id":..., "text":...} per line) used to build indexes
    # when no prebuilt index dir exists.
    CORPUS_JSONL_PATH: str = ""

    # --- generation --------------------------------------------------------
    MAX_GEN_TOKENS_FALSE_ANSWER: int = 50
    MAX_GEN_TOKENS_DOCUMENT: int = 250
    MAX_GEN_TOKENS_RAG: int = 500
    TEMPERATURE: float = 0.1
    TOP_P: float = 1.0

    # --- dataset / attack --------------------------------------------------
    DATASET_NAME: str = "csv"          # csv | nq | hotpotqa | triviaqa
    DATASET_SPLIT: str = "validation"
    CSV_INPUT_PATH: str = "input.csv"
    SAMPLED_QUERIES_JSON: str = "sampled_nq_queries.json"
    ATTACK_VARIANT: str = "malicious_doc"   # malicious_doc | doc_corruption
    RANKED_LIST_ORDER_IN_PROMPT: str = "top_down"  # top_down|bottom_up|random
    NUM_RANDOM_SHUFFLES: int = 10
    DOC_NEIGHBORS_K: int = 0
    MALICIOUS_DOC_SELECTION_STRATEGY: str = "random"
    MAX_MALICIOUS_DOCS_PER_QUERY: int = 1
    ORACLE: bool = True

    # --- retrieval backend -------------------------------------------------
    RETRIEVER_BACKEND: str = "dense"   # dense | sparse | sparse_and_dense
    SPARSE_INDEX_NAME_OR_PATH: str = ""
    BM25_K1: float = 0.9
    BM25_B: float = 0.4
    # "postings": device CSR postings walk, O(sum df) like Lucene itself
    # (default); "scan": Pallas dense-scan kernel, O(N*Lp) — insensitive
    # to term rarity, useful when one term's df ~ N.
    BM25_ENGINE: str = "postings"

    # --- defense -----------------------------------------------------------
    DEFENSE_BACKEND: str = "none"      # none | ragdefender | discern_and_answer
    RAGDEFENDER_TASK: str = ""
    DISCERN_CLASSIFIER_MODEL: str = ""
    DISCERN_OPENAI_API_KEY: str = ""
    DISCERN_MAX_DOCS_TO_CLASSIFY: int = 32
    DISCERN_CLASSIFY_TEMPERATURE: float = 0.0
    DISCERN_LABELS_LOAD_PATH: str = ""
    DISCERN_LABELS_SAVE_SUFFIX: str = ""

    # --- output ------------------------------------------------------------
    OUTPUT_CSV_BASE: str = "attack_results"
    # Resumable per-batch result logs (pipeline/resume.py): reruns with the
    # same config skip completed query batches.
    RESUME_LOGS: bool = False

    # KV cache storage: "native" (model dtype) or "int8" (halved decode KV
    # traffic, per-slot scales, ~8-bit quantization error; opt-in)
    KV_CACHE_DTYPE: str = "native"
    # Prompt-lookup speculative decoding: number of tokens drafted per
    # round by continuing the last bigram's most recent prompt occurrence,
    # verified in one KV-bound forward.  0 = off.  Composes with
    # KV_CACHE_DTYPE="int8".  TEMPERATURE=0 emits exactly the greedy
    # continuation; TEMPERATURE>0 uses exact speculative sampling (the
    # output distribution equals the non-speculative sampler's).
    SPECULATIVE_DRAFT_LEN: int = 0
    # Generator weights: "native" (checkpoint dtype) or "int8" (weight-only
    # per-channel quantization at load; halves the weight bytes streamed
    # per decode step — the B<=8 decode bottleneck — standard int8 PTQ
    # error; opt-in, single-chip serving: not composable with MESH_MODEL>1)
    LLM_WEIGHTS_DTYPE: str = "native"

    # --- TPU mesh ----------------------------------------------------------
    # Mesh axis sizes; 0 = use all local devices on the data axis.
    MESH_DATA: int = 0
    MESH_MODEL: int = 1

    # ------------------------------------------------------------------ API
    def validate(self) -> None:
        """Config invariants (extends reference's single check,
        ``config.py:129-132``)."""
        if self.RETRIEVER_BACKEND == "sparse_and_dense" and not self.ORACLE:
            raise ValueError(
                "Hybrid (sparse_and_dense) retrieval requires ORACLE=True.")
        if self.RETRIEVER_BACKEND not in {"dense", "sparse", "sparse_and_dense"}:
            raise ValueError(f"Unknown RETRIEVER_BACKEND: {self.RETRIEVER_BACKEND}")
        if self.DEFENSE_BACKEND not in {"none", "ragdefender", "discern_and_answer"}:
            raise ValueError(f"Unknown DEFENSE_BACKEND: {self.DEFENSE_BACKEND}")
        if self.ATTACK_VARIANT not in {"malicious_doc", "doc_corruption"}:
            raise ValueError(f"Unknown ATTACK_VARIANT: {self.ATTACK_VARIANT}")
        if self.KV_CACHE_DTYPE not in {"native", "int8"}:
            raise ValueError(f"Unknown KV_CACHE_DTYPE: {self.KV_CACHE_DTYPE}")
        if self.LLM_WEIGHTS_DTYPE not in {"native", "int8"}:
            raise ValueError(
                f"Unknown LLM_WEIGHTS_DTYPE: {self.LLM_WEIGHTS_DTYPE}")
        if self.LLM_WEIGHTS_DTYPE == "int8" and self.MESH_MODEL > 1:
            raise ValueError(
                "LLM_WEIGHTS_DTYPE='int8' is a single-chip serving format "
                "(decoder_param_specs shard the float tree); use "
                "MESH_MODEL=1 with it.")
        if self.BM25_ENGINE not in {"postings", "scan"}:
            raise ValueError(f"Unknown BM25_ENGINE: {self.BM25_ENGINE}")
        if self.DENSE_SEARCH_MODE not in {"approx", "exact"}:
            raise ValueError(
                f"Unknown DENSE_SEARCH_MODE: {self.DENSE_SEARCH_MODE}")
        if self.RANKED_LIST_ORDER_IN_PROMPT not in {"top_down", "bottom_up",
                                                    "random"}:
            # the consumer silently falls back to top_down, so a typo
            # ('bottom-up') would run the wrong ordering while the config
            # snapshot claims otherwise
            raise ValueError(f"Unknown RANKED_LIST_ORDER_IN_PROMPT: "
                             f"{self.RANKED_LIST_ORDER_IN_PROMPT}")
        if self.DENSE_INDEX_DTYPE == "int8" and not self.DENSE_INT8_RESCORE:
            import warnings
            warnings.warn(
                "DENSE_INDEX_DTYPE='int8' with DENSE_INT8_RESCORE=False: "
                "a bare int8 scan ranks at the int8 quantisation's recall, "
                "below what the rescored default gives.  Enable "
                "DENSE_INT8_RESCORE (same scan cost) unless the recall "
                "loss is deliberate.",
                stacklevel=2)
        if self.LLM_ARCH in EXPERT_LLM_ARCHS:
            for bad, what in (
                    (self.LLM_WEIGHTS_DTYPE == "int8",
                     "LLM_WEIGHTS_DTYPE='int8'"),
                    (self.KV_CACHE_DTYPE == "int8", "KV_CACHE_DTYPE='int8'"),
                    (self.SPECULATIVE_DRAFT_LEN > 0,
                     "SPECULATIVE_DRAFT_LEN > 0"),
                    (self.MESH_MODEL > 1 or self.MESH_DATA > 1,
                     "MESH_MODEL or MESH_DATA > 1")):
                if bad:
                    raise ValueError(f"LLM_ARCH={self.LLM_ARCH!r} has sparse "
                                     f"experts, which are not served with "
                                     f"{what}")
        if self.SPECULATIVE_DRAFT_LEN:
            if not 0 < self.SPECULATIVE_DRAFT_LEN <= 15:
                raise ValueError("SPECULATIVE_DRAFT_LEN must be in [0, 15]")
            # composes with KV_CACHE_DTYPE='int8' (decode_window has an
            # int8 branch; greedy equality w/ plain int8 is test-pinned)
        # SDAG doc-NEIGHBOR sets are int32 bitmasks (sdag/mask.py
        # MAX_DOC_BLOCKS): with neighbor windows on, every prompt doc
        # (top-k survivors + injected malicious docs) needs a bit.  Plain
        # isolation uses exact doc-id equality and has no doc cap.
        # Fail here, not mid-experiment.
        if self.DOC_NEIGHBORS_K > 0:
            from sdag_tpu_torch.sdag.mask import MAX_DOC_BLOCKS
            max_docs = (max(self.TOP_K, default=0)
                        + self.MAX_MALICIOUS_DOCS_PER_QUERY)
            if max_docs > MAX_DOC_BLOCKS:
                raise ValueError(
                    f"TOP_K + MAX_MALICIOUS_DOCS_PER_QUERY can reach "
                    f"{max_docs} prompt docs, above the {MAX_DOC_BLOCKS}-"
                    f"doc neighbor-bitmask limit (sdag/mask.py "
                    f"MAX_DOC_BLOCKS; DOC_NEIGHBORS_K=0 lifts the cap)")

    def init_seeds(self) -> None:
        random.seed(self.SEED)
        np.random.seed(self.SEED)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable snapshot for embedding in result files."""
        return dataclasses.asdict(self)

    def apply_overrides(self, overrides: Dict[str, Any]) -> None:
        """Apply a JSON override dict.  Unknown keys warn and are skipped;
        known keys are coerced to the field's declared type where possible."""
        if not overrides:
            return
        fields = {f.name: f for f in dataclasses.fields(self)}
        for raw_key, value in overrides.items():
            key = _KEY_ALIASES.get(raw_key, raw_key)
            if raw_key in _IGNORED_REFERENCE_KEYS:
                print(f"[config] Note: reference key '{raw_key}' has no "
                      "TPU equivalent; ignored.")
                continue
            if key not in fields:
                print(f"[config] Warning: unknown key '{raw_key}', skipping.")
                continue
            current = getattr(self, key)
            if isinstance(current, bool) and not isinstance(value, bool):
                if isinstance(value, str):
                    # hand-edited JSON often carries string booleans;
                    # bool("false") is True — the opposite of intent
                    low = value.strip().lower()
                    if low in ("true", "1", "yes"):
                        value = True
                    elif low in ("false", "0", "no", ""):
                        value = False
                    else:
                        raise ValueError(
                            f"Config key {key!r} expects a boolean; got "
                            f"the string {value!r}")
                else:
                    value = bool(value)
            elif isinstance(current, int) and not isinstance(current, bool) \
                    and isinstance(value, (int, float)) and not isinstance(value, bool):
                value = int(value)
            elif isinstance(current, float) and isinstance(value, (int, float)):
                value = float(value)
            setattr(self, key, value)
            print(f"[config] {key} = {value}")


def load_json_config(json_path: Optional[str]) -> Dict[str, Any]:
    """Soft-fail JSON loader (returns {} on missing/bad file, matching
    reference ``main.py:44-70``)."""
    if not json_path or not os.path.exists(json_path):
        if json_path:
            print(f"[config] JSON not found: {json_path}")
        return {}
    try:
        with open(json_path, "r", encoding="utf-8") as f:
            return json.load(f)
    except Exception as e:  # noqa: BLE001 - parity with reference soft-fail
        print(f"[config] Error loading {json_path}: {e}")
        return {}


def make_config(json_path: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None) -> Config:
    cfg = Config()
    cfg.apply_overrides(load_json_config(json_path))
    if overrides:
        cfg.apply_overrides(overrides)
    return cfg
