"""The port's main path end to end on the CPU against the JAX package, with
the committed trained checkpoint (the configs of test_trained_qa_model):
identical per-query answers CSV, clean ACC >= 0.5, ASR > 0 under attack,
and the same with int8 weights, the int8 KV cache and speculative
decoding at once; tiny HF Llama and BERT checkpoint dirs (a generator
with a byte-level BPE tokenizer; a ranker with a WordPiece vocab) write
the JAX package's answers CSV too; the ranker path's, the decode slice's,
HF checkpoints' and the defenses' settings are served; a mesh larger than
the torch.distributed world raises ValueError (meshes that fit are run in
test_torch_distributed_pipeline.py)."""

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
])
def test_settings_of_the_defenses_are_served(key, value):
    """Both defenses pass check_supported; the factory builds the JAX
    package's classes' counterparts over the run's resources."""
    from sdag_tpu_torch.datamodels import Resources
    from sdag_tpu_torch.defenses.discern import DiscernAndAnswerDefense
    from sdag_tpu_torch.defenses.ragdefender import EmbeddingFilterDefense
    from sdag_tpu_torch.pipeline.resources import build_defense
    cfg = Config()
    cfg.RETRIEVER_BACKEND = "sparse"
    setattr(cfg, key, value)
    check_supported(cfg)
    ranker, generator = object(), object()
    defense = build_defense(cfg, Resources(
        ranker=ranker, tokenizer=None, generator=generator,
        dense_index=None, sparse_index=None))
    if value == "ragdefender":
        assert isinstance(defense, EmbeddingFilterDefense)
        assert defense.encoder is ranker
    else:
        assert isinstance(defense, DiscernAndAnswerDefense)
        assert defense.classify_batch is not None
        assert defense.max_docs_to_classify == cfg.DISCERN_MAX_DOCS_TO_CLASSIFY


@pytest.mark.parametrize("key,value", [
    ("MESH_MODEL", 2),
    ("MESH_DATA", 2),
])
def test_mesh_larger_than_the_world_raises(key, value):
    """Without torchrun the world is one rank: a 2-rank mesh raises
    ValueError naming the world size, before anything is loaded."""
    cfg = Config()
    cfg.RETRIEVER_BACKEND = "sparse"
    setattr(cfg, key, value)
    with pytest.raises(ValueError, match="world size 1"):
        check_supported(cfg)


@pytest.mark.parametrize("key,build", [
    ("RANKER_CHECKPOINT", "build_encoder"),
    ("LLM_CHECKPOINT", "build_generator"),   # a dir that is no native ckpt
])
def test_hf_checkpoint_settings_are_served(key, build):
    """An HF ranker or generator dir passes check_supported; a dir without
    config.json (the repo root) raises FileNotFoundError naming it at
    load."""
    from sdag_tpu_torch.pipeline import resources
    cfg = Config()
    cfg.RETRIEVER_BACKEND = "sparse"
    setattr(cfg, key, REPO)
    check_supported(cfg)
    with pytest.raises(FileNotFoundError, match="config.json"):
        getattr(resources, build)(cfg, device="cpu")


def test_int8_weights_with_a_model_mesh_raise_in_validate():
    """int8 weights with MESH_MODEL > 1 raise through Config.validate, as
    in the JAX package (the int8 tree is served replicated, MESH_DATA
    only)."""
    cfg = Config()
    cfg.RETRIEVER_BACKEND = "sparse"
    cfg.LLM_WEIGHTS_DTYPE = "int8"
    cfg.MESH_MODEL = 2
    with pytest.raises(ValueError, match="MESH_MODEL=1"):
        cfg.validate()


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


def _hf_llama_dir(path, world):
    """A tiny Llama-class HF checkpoint (GQA, untied, llama3 RoPE scaling,
    f32, sharded) with a byte-level BPE tokenizer trained on the world."""
    from transformers import LlamaConfig, LlamaForCausalLM

    import chip_smoke
    from test_torch_hf_tokenizer import _llama_dir
    _llama_dir(path, corpus=chip_smoke._world_texts(), vocab_size=1200)
    hf_cfg = LlamaConfig(
        vocab_size=1280, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=2048, rope_theta=500000.0,
        tie_word_embeddings=False,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 256})
    torch.manual_seed(7)
    model = LlamaForCausalLM(hf_cfg)
    model.save_pretrained(str(path), safe_serialization=True,
                          max_shard_size="300KB")
    return str(path)


def _hf_bert_dir(path):
    """A tiny BERT HF checkpoint with a WordPiece vocab of the world's
    qa_ckpt corpus words (vocab.txt only: transformers converts it)."""
    from transformers import BertConfig, BertModel

    import chip_smoke
    n = chip_smoke.write_bert_vocab(str(path), chip_smoke._world_texts(),
                                    vocab_size=1500)
    hf_cfg = BertConfig(vocab_size=n, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128,
                        max_position_embeddings=128)
    torch.manual_seed(11)
    BertModel(hf_cfg).save_pretrained(str(path), safe_serialization=True)
    return str(path)


@pytest.mark.parametrize("which", ["llm", "ranker", "llm_int8_kv_spec",
                                   "both_hybrid_knn"])
def test_hf_checkpoint_run_answers_csv_equals_jax(tmp_path, world, which):
    """run_experiment with an HF LLM_CHECKPOINT (sparse, ISO/NO-ISO,
    greedy; also with int8 weights, the int8 KV cache and speculation), an
    HF RANKER_CHECKPOINT beside the trained decoder (hybrid retrieval), or
    both (hybrid, 2-NN windows) writes the JAX package's answers CSV, row
    for row."""
    pytest.importorskip("transformers")
    from sdag_tpu.config import Config as JaxConfig
    from sdag_tpu.pipeline.orchestrator import run_experiment as jax_run
    from sdag_tpu_torch.models.hf_tokenizer import HFTokenizer
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    over = dict(MAX_GEN_TOKENS_RAG=12)
    if which.startswith(("llm", "both")):
        over["LLM_CHECKPOINT"] = _hf_llama_dir(tmp_path / "hf_llm", world)
    if which.startswith(("ranker", "both")):
        over.update(RANKER_CHECKPOINT=_hf_bert_dir(tmp_path / "hf_ranker"),
                    RETRIEVER_BACKEND="sparse_and_dense",
                    DENSE_INDEX_PATH="")
    if which == "llm_int8_kv_spec":
        over.update(LLM_WEIGHTS_DTYPE="int8", KV_CACHE_DTYPE="int8",
                    SPECULATIVE_DRAFT_LEN=4)
    if which == "both_hybrid_knn":
        over["DOC_NEIGHBORS_K"] = 2
    cfgs = []
    for sub, cls in (("port", Config), ("jax", JaxConfig)):
        cfg = _cfg(tmp_path / sub, world, cls, attack=False)
        for key, val in over.items():
            setattr(cfg, key, val)
        cfgs.append(cfg)
    from sdag_tpu_torch.pipeline.resources import init_resources
    res = init_resources(cfgs[0], device="cpu")
    if "LLM_CHECKPOINT" in over:
        assert isinstance(res.generator.tokenizer, HFTokenizer)
    if "RANKER_CHECKPOINT" in over:
        assert isinstance(res.ranker.tokenizer, HFTokenizer)
    run_experiment(cfgs[0], resources=res, device="cpu")
    jax_run(cfgs[1])
    name = "results_top_k=5_attacker_pos=0.csv"
    port_rows = _rows(tmp_path / "port" / "out" / name)
    jax_rows = _rows(tmp_path / "jax" / "out" / name)
    assert len(port_rows) == len(jax_rows) == 24
    for p, j in zip(port_rows, jax_rows):
        assert p == j
    assert any(r["rag_answer_iso"] and r["rag_answer_noiso"]
               for r in port_rows)
