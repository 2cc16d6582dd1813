"""The ranker path of the port end to end on the CPU against the JAX
package: run_experiment with the tiny encoder for dense retrieval, hybrid
retrieval with centroid selection, and knn neighbor windows, writing the
JAX package's answers CSV; the encoder built only on demand; the CLI."""

import csv
import json
import os

import jax
import numpy as np
import pytest
import torch

from sdag_tpu_torch.config import Config
from sdag_tpu_torch.models import e5 as te5
from sdag_tpu_torch.models.tokenizer import ByteTokenizer
from sdag_tpu_torch.pipeline import resources as tres
from sdag_tpu_torch.pipeline.orchestrator import run_experiment
from sdag_tpu_torch.utils.synth_qa import (load_world, write_attack_csv,
                                           write_corpus_jsonl)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "experiments", "data", "qa_ckpt")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tmp_path, world, cls, **over):
    corpus = tmp_path / "corpus.jsonl"
    csv_path = tmp_path / "attack.csv"
    write_corpus_jsonl(world, str(corpus))
    attack = over.pop("attack", False)
    facts = write_attack_csv(world, str(csv_path), world.eval_entities[:2],
                             n_mal=2 if attack else 1,
                             seed=world.seed + (2 if attack else 1))
    cfg = cls()
    cfg.SAMPLE_SIZE = len(facts)
    cfg.TOP_K = [5]
    cfg.ADD_ATTACK_IN_RANK = [1 if attack else 0]
    if attack:
        cfg.MAX_MALICIOUS_DOCS_PER_QUERY = 1
    cfg.CSV_INPUT_PATH = str(csv_path)
    cfg.CORPUS_JSONL_PATH = str(corpus)
    cfg.SPARSE_INDEX_NAME_OR_PATH = str(tmp_path / "bm25.index")
    cfg.DENSE_INDEX_PATH = str(tmp_path / "dense.index")
    cfg.META_JSONL_PATH = str(tmp_path / "docs_meta.jsonl")
    cfg.LLM_CHECKPOINT = CKPT
    cfg.LLM_BATCH_SIZE = 8
    cfg.BATCH_SIZE_EMBED_Q = 32
    cfg.MAX_GEN_TOKENS_RAG = 16
    cfg.TEMPERATURE = 0.0
    cfg.OUTPUT_CSV_BASE = str(tmp_path / "out" / "results")
    for key, val in over.items():
        setattr(cfg, key, val)
    return cfg


def _rows(path):
    with open(path, newline="", encoding="utf-8") as fh:
        return list(csv.DictReader(fh))


@pytest.mark.skipif(
    not os.path.isfile(os.path.join(CKPT, "native_decoder.json")),
    reason="trained qa_ckpt not present")
@pytest.mark.parametrize("name,over", [
    ("dense", dict(RETRIEVER_BACKEND="dense")),
    ("hybrid_int8_exact_centroid", dict(
        RETRIEVER_BACKEND="sparse_and_dense", DENSE_INDEX_DTYPE="int8",
        DENSE_SEARCH_MODE="exact", attack=True,
        MALICIOUS_DOC_SELECTION_STRATEGY="closest_to_centroid")),
    ("sparse_knn2_furthest", dict(
        RETRIEVER_BACKEND="sparse", DOC_NEIGHBORS_K=2, attack=True,
        MALICIOUS_DOC_SELECTION_STRATEGY="furthest_from_centroid")),
])
def test_ranker_path_answers_csv_equals_jax(tmp_path, name, over):
    """run_experiment end to end, tiny encoder, trained decoder: the JAX
    package builds its resources (encoder weights from its PRNG key) and
    the port gets the same encoder weights through
    encoder_params_from_numpy; every CSV row (retrieved ids and docs, ISO
    and NO-ISO answers, match flags) must be equal."""
    from sdag_tpu.config import Config as JaxConfig
    from sdag_tpu.pipeline.orchestrator import run_experiment as jax_run
    from sdag_tpu.pipeline.resources import init_resources as jax_init
    world = load_world(os.path.join(CKPT, "world.json"))
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    tcfg = _cfg(tmp_path / "port", world, Config, **dict(over))
    jcfg = _cfg(tmp_path / "jax", world, JaxConfig, **dict(over))
    jres = jax_init(jcfg)
    assert not jres.ranker.fused
    enc_cfg = te5.EncoderConfig.tiny()
    tenc = te5.E5Encoder(
        te5.encoder_params_from_numpy(
            jax.tree.map(np.asarray, jres.ranker.params), enc_cfg,
            device="cpu"),
        enc_cfg, ByteTokenizer(), model_name=tcfg.RANKER_MODEL_NAME,
        device="cpu")
    res = tres.init_resources(tcfg, device="cpu", encoder=tenc)
    assert res.ranker is tenc
    assert (res.dense_index is not None) == (over["RETRIEVER_BACKEND"]
                                             != "sparse")
    pos = tcfg.ADD_ATTACK_IN_RANK[0]
    run_experiment(tcfg, resources=res, device="cpu")
    jax_run(jcfg, resources=jres)
    fname = f"results_top_k=5_attacker_pos={pos}.csv"
    port_rows = _rows(tmp_path / "port" / "out" / fname)
    jax_rows = _rows(tmp_path / "jax" / "out" / fname)
    assert len(port_rows) == len(jax_rows) == tcfg.SAMPLE_SIZE > 0
    for p, j in zip(port_rows, jax_rows):
        assert p == j
    assert tenc.stats["batches"] > 0
    if over["RETRIEVER_BACKEND"] == "dense":
        # the saved float32 dense index is the JAX package's (1e-4: the
        # encoders' f32 summation order)
        np.testing.assert_allclose(
            np.load(tmp_path / "port/dense.index/embeddings.npy"),
            np.load(tmp_path / "jax/dense.index/embeddings.npy"),
            atol=1e-4)


def test_encoder_is_built_only_when_a_setting_calls_it():
    cfg = Config()
    cfg.RETRIEVER_BACKEND = "sparse"
    assert not tres.needs_encoder(cfg)
    for key, val in (("RETRIEVER_BACKEND", "dense"),
                     ("RETRIEVER_BACKEND", "sparse_and_dense"),
                     ("DOC_NEIGHBORS_K", 1),
                     ("MALICIOUS_DOC_SELECTION_STRATEGY",
                      "closest_to_centroid")):
        c = Config()
        c.RETRIEVER_BACKEND = "sparse"
        setattr(c, key, val)
        assert tres.needs_encoder(c), key
    assert tres.needs_encoder(Config())          # the default is dense
    enc = tres.build_encoder(cfg, device="cpu")
    assert enc.cfg == te5.EncoderConfig.tiny() and enc.is_e5
    assert enc.params["word_emb"].device.type == "cpu"
    cfg.RANKER_ARCH = "e5-small"
    with pytest.raises(ValueError, match="RANKER_ARCH"):
        tres.build_encoder(cfg, device="cpu")


def test_init_resources_membership_checks_dense_dtype(tmp_path):
    world = load_world(os.path.join(CKPT, "world.json"))
    cfg = _cfg(tmp_path, world, Config, RETRIEVER_BACKEND="dense",
               DENSE_INDEX_DTYPE="bf16", LLM_CHECKPOINT="",
               LLM_ARCH="tiny")
    with pytest.raises(ValueError, match="DENSE_INDEX_DTYPE"):
        tres.init_resources(cfg, device="cpu")


def test_cli_runs_dense_and_hybrid_on_the_cpu(tmp_path):
    """python -m sdag_tpu_torch.pipeline.cli cfg.json --device cpu with
    the default tiny encoder and a tiny random decoder."""
    from sdag_tpu_torch.pipeline.cli import main
    world = load_world(os.path.join(CKPT, "world.json"))
    for backend in ("dense", "sparse_and_dense"):
        d = tmp_path / backend
        d.mkdir()
        cfg = _cfg(d, world, Config, RETRIEVER_BACKEND=backend,
                   LLM_CHECKPOINT="", LLM_ARCH="tiny", DOC_NEIGHBORS_K=2,
                   MAX_GEN_TOKENS_RAG=2, SAMPLE_SIZE=3)
        keys = [k for k in cfg.snapshot() if k.isupper()]
        path = d / "cfg.json"
        path.write_text(json.dumps({k: getattr(cfg, k) for k in keys}))
        main([str(path), "--device", "cpu"])
        rows = _rows(d / "out" / "results_top_k=5_attacker_pos=0.csv")
        assert len(rows) == 3
        assert os.path.isfile(d / "dense.index" / "embeddings.npy")
