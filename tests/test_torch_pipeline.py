"""The port's main path end to end on the CPU against the JAX package, with
the committed trained checkpoint (the configs of test_trained_qa_model):
identical per-query answers CSV, clean ACC >= 0.5, ASR > 0 under attack,
and the same with int8 weights, the int8 KV cache and speculative
decoding at once; settings outside the port's slices raise
NotImplementedError, the ranker path's and the decode slice's settings no
longer do."""

import csv
import os

import pytest
import torch

from sdag_tpu_torch.config import Config
from sdag_tpu_torch.pipeline.orchestrator import run_experiment
from sdag_tpu_torch.pipeline.resources import check_supported
from sdag_tpu_torch.utils.synth_qa import (load_world, write_attack_csv,
                                           write_corpus_jsonl)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "experiments", "data", "qa_ckpt")

pytestmark = pytest.mark.skipif(
    not os.path.isfile(os.path.join(CKPT, "native_decoder.json")),
    reason="trained qa_ckpt not present")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Parallel test workers share the CPU; torch's default of one thread
    per core oversubscribes it (measured 4.5x slower under contention)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tmp_path, world, cls, attack: bool):
    corpus = tmp_path / "corpus.jsonl"
    csv_path = tmp_path / "attack.csv"
    write_corpus_jsonl(world, str(corpus))
    facts = write_attack_csv(world, str(csv_path), world.eval_entities[:4],
                             n_mal=2 if attack else 1,
                             seed=world.seed + (2 if attack else 1))
    cfg = cls()
    cfg.SAMPLE_SIZE = len(facts)
    cfg.TOP_K = [5]
    cfg.ADD_ATTACK_IN_RANK = [1 if attack else 0]
    if attack:
        cfg.MAX_MALICIOUS_DOCS_PER_QUERY = 2
    cfg.CSV_INPUT_PATH = str(csv_path)
    cfg.CORPUS_JSONL_PATH = str(corpus)
    cfg.RETRIEVER_BACKEND = "sparse"
    cfg.SPARSE_INDEX_NAME_OR_PATH = str(tmp_path / "bm25.index")
    cfg.LLM_CHECKPOINT = CKPT
    cfg.LLM_BATCH_SIZE = 8
    cfg.BATCH_SIZE_EMBED_Q = 32
    cfg.MAX_GEN_TOKENS_RAG = 24
    cfg.TEMPERATURE = 0.0
    cfg.OUTPUT_CSV_BASE = str(tmp_path / "out" / "results")
    return cfg


def _rows(path):
    with open(path, newline="", encoding="utf-8") as fh:
        return list(csv.DictReader(fh))


@pytest.fixture(scope="module")
def world():
    return load_world(os.path.join(CKPT, "world.json"))


def test_clean_run_answers_csv_equals_jax(tmp_path, world):
    from sdag_tpu.config import Config as JaxConfig
    from sdag_tpu.pipeline.orchestrator import run_experiment as jax_run
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    tcfg = _cfg(tmp_path / "port", world, Config, attack=False)
    jcfg = _cfg(tmp_path / "jax", world, JaxConfig, attack=False)
    m = run_experiment(tcfg, device="cpu")[(5, 0)]["answer_match_stats"]
    jax_run(jcfg)
    name = "results_top_k=5_attacker_pos=0.csv"
    port_rows = _rows(tmp_path / "port" / "out" / name)
    jax_rows = _rows(tmp_path / "jax" / "out" / name)
    assert len(port_rows) == len(jax_rows) == 24
    for p, j in zip(port_rows, jax_rows):
        assert p == j
    assert m["iso"]["ground_truth_match_rate"] >= 0.5
    assert m["no_iso"]["ground_truth_match_rate"] >= 0.5


def test_attack_run_bites(tmp_path, world):
    cfg = _cfg(tmp_path, world, Config, attack=True)
    m = run_experiment(cfg, device="cpu")[(5, 1)]["answer_match_stats"]
    assert (m["iso"]["false_answer_match_rate"]
            + m["no_iso"]["false_answer_match_rate"]) > 0.0


@pytest.mark.parametrize("key,value", [
    ("RETRIEVER_BACKEND", "dense"),
    ("RETRIEVER_BACKEND", "sparse_and_dense"),
    ("DOC_NEIGHBORS_K", 2),
    ("MALICIOUS_DOC_SELECTION_STRATEGY", "closest_to_centroid"),
    ("MALICIOUS_DOC_SELECTION_STRATEGY", "furthest_from_centroid"),
    ("DENSE_INDEX_DTYPE", "int8"),
    ("DENSE_SEARCH_MODE", "exact"),
])
def test_settings_of_the_ranker_path_are_served(key, value):
    cfg = Config()
    setattr(cfg, key, value)
    check_supported(cfg)
    check_supported(Config())         # the default config (dense) too


@pytest.mark.parametrize("settings", [
    {"KV_CACHE_DTYPE": "int8"},
    {"LLM_WEIGHTS_DTYPE": "int8"},
    {"SPECULATIVE_DRAFT_LEN": 1},
    {"SPECULATIVE_DRAFT_LEN": 15},
    {"LLM_WEIGHTS_DTYPE": "int8", "KV_CACHE_DTYPE": "int8",
     "SPECULATIVE_DRAFT_LEN": 4},
])
def test_settings_of_the_decode_slice_are_served(settings):
    cfg = Config()
    cfg.RETRIEVER_BACKEND = "sparse"
    for key, value in settings.items():
        setattr(cfg, key, value)
    check_supported(cfg)


@pytest.mark.parametrize("key,value", [
    ("DEFENSE_BACKEND", "ragdefender"),
    ("DEFENSE_BACKEND", "discern_and_answer"),
    ("RANKER_CHECKPOINT", REPO),      # an HF ranker waits for hf_convert
    ("MESH_MODEL", 2),
    ("MESH_DATA", 2),
    ("LLM_CHECKPOINT", REPO),     # a directory that is not a native ckpt
])
def test_settings_outside_the_slice_raise(key, value):
    cfg = Config()
    cfg.RETRIEVER_BACKEND = "sparse"
    setattr(cfg, key, value)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        check_supported(cfg)


def test_int8_weights_with_a_data_mesh_still_raise():
    """int8 weights with MESH_DATA > 1 raise through the mesh row until
    the mesh item decides how the int8 tree shards."""
    cfg = Config()
    cfg.RETRIEVER_BACKEND = "sparse"
    cfg.LLM_WEIGHTS_DTYPE = "int8"
    cfg.MESH_DATA = 2
    with pytest.raises(NotImplementedError, match="MESH_DATA=2"):
        check_supported(cfg)


def test_run_with_int8_weights_int8_cache_and_speculation_equals_jax(
        tmp_path, world, capsys):
    """run_experiment with LLM_WEIGHTS_DTYPE and KV_CACHE_DTYPE = int8 and
    SPECULATIVE_DRAFT_LEN = 4 writes the JAX package's answers CSV and
    reports its verification rounds; clean ACC stays >= 0.5."""
    from sdag_tpu.config import Config as JaxConfig
    from sdag_tpu.pipeline.orchestrator import run_experiment as jax_run
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    cfgs = []
    for sub, cls in (("port", Config), ("jax", JaxConfig)):
        cfg = _cfg(tmp_path / sub, world, cls, attack=False)
        cfg.LLM_WEIGHTS_DTYPE = "int8"
        cfg.KV_CACHE_DTYPE = "int8"
        cfg.SPECULATIVE_DRAFT_LEN = 4
        cfgs.append(cfg)
    m = run_experiment(cfgs[0], device="cpu")[(5, 0)]["answer_match_stats"]
    assert "[spec] verification rounds" in capsys.readouterr().out
    jax_run(cfgs[1])
    name = "results_top_k=5_attacker_pos=0.csv"
    port_rows = _rows(tmp_path / "port" / "out" / name)
    jax_rows = _rows(tmp_path / "jax" / "out" / name)
    assert len(port_rows) == len(jax_rows) == 24
    for p, j in zip(port_rows, jax_rows):
        assert p == j
    assert m["iso"]["ground_truth_match_rate"] >= 0.5
    assert m["no_iso"]["ground_truth_match_rate"] >= 0.5
