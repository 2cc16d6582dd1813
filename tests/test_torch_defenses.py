"""The port's defenses against the JAX package's on the same inputs: every
discern and embedding-filter case of test_defenses.py run through both
packages (outputs equal), the local batched classifier on the committed
qa_ckpt (raw generations equal to JAX's, sequential labels = batched),
the embedding filter over the tiny encoder with carried weights
(embeddings within 1e-5, the same docs kept), and run_experiment with each
defense writing the JAX package's answers CSV (and discern's labels
JSONL)."""

import csv
import dataclasses
import os
import zlib

import jax
import numpy as np
import pytest
import torch

from sdag_tpu.defenses import cache as jcache
from sdag_tpu.defenses import discern as jdiscern
from sdag_tpu.defenses import ragdefender as jrag
from sdag_tpu_torch.config import Config
from sdag_tpu_torch.datamodels import make_mal_id
from sdag_tpu_torch.defenses import cache as tcache
from sdag_tpu_torch.defenses import discern as tdiscern
from sdag_tpu_torch.defenses import ragdefender as trag
from sdag_tpu_torch.models import e5 as te5
from sdag_tpu_torch.models.tokenizer import ByteTokenizer
from sdag_tpu_torch.pipeline import resources as tres
from sdag_tpu_torch.pipeline.orchestrator import run_experiment
from sdag_tpu_torch.utils.synth_qa import (fact_doc, fact_query, load_world,
                                           malicious_doc, write_attack_csv,
                                           write_corpus_jsonl)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "experiments", "data", "qa_ckpt")
HAVE_CKPT = os.path.isfile(os.path.join(CKPT, "native_decoder.json"))

# (JAX module, port module) pairs every mirrored case runs through
DISCERN = [jdiscern, tdiscern]
RAG = [jrag, trag]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Parallel test workers share the CPU; torch's default of one thread
    per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class HashEncoder:
    """Deterministic encoder; identical texts -> identical embeddings (a
    stable hash, so both packages see the same vectors)."""

    def __init__(self, dim=32):
        self.dim = dim

    def encode(self, texts, kind="passage", batch_size=32):
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            rng = np.random.default_rng(zlib.crc32(t.encode()))
            out[i] = rng.standard_normal(self.dim)
        out /= np.linalg.norm(out, axis=1, keepdims=True) + 1e-9
        return out


def _same(outs):
    """Both packages' DefenseOutputs, field by field."""
    j, t = (dataclasses.asdict(o) for o in outs)
    assert j == t
    return outs[1]


def test_parse_label_fallbacks():
    for txt, lab in [('{"label":"clean"}', "clean"),
                     ('{"label":"perturbed"}', "perturbed"),
                     ('{"label":"banana"}', "perturbed"),
                     ("not json at all", "clean")]:
        assert [m.parse_label(txt) for m in DISCERN] == [lab, lab]
    assert (tdiscern.discern_classifier_prompt("q?", "p.")
            == jdiscern.discern_classifier_prompt("q?", "p."))


def test_discern_defense_filters_and_caches():
    outs, caches, counts = [], [], []
    for mod in DISCERN:
        calls = []

        def classify(query, passage, calls=calls):
            calls.append(passage)
            return "perturbed" if "EVIL" in passage else "clean"

        d = mod.DiscernAndAnswerDefense(classify, max_docs_to_classify=32)
        cache = {}
        kw = dict(does_oracle=True, persistent_cache=cache)
        outs.append(d.apply("q7", "what?", ["good doc", "EVIL doc"],
                            ["c1", "c2"], [0.9, 0.8],
                            ["EVIL mal", "sneaky mal"], **kw))
        n = len(calls)
        d.apply("q7", "what?", ["good doc", "EVIL doc"], ["c1", "c2"],
                [0.9, 0.8], ["EVIL mal", "sneaky mal"], **kw)
        counts.append((n, len(calls)))
        caches.append(cache)
    out = _same(outs)
    assert out.ranked_docs == ["good doc"]
    assert out.ranked_ids == ["c1"]
    assert out.malicious_docs_survived == ["sneaky mal"]
    assert out.doc_labels[make_mal_id(0)] == "perturbed"
    assert out.doc_labels["c2"] == "perturbed"
    assert caches[0] == caches[1] and caches[1][("q7", "c1")] == "clean"
    assert counts[0] == counts[1] == (4, 4)    # cache hit: no second call


def test_discern_cap_limits_classification():
    outs, seen_by = [], []
    for mod in DISCERN:
        seen = []
        d = mod.DiscernAndAnswerDefense(
            lambda q, p, seen=seen: seen.append(p) or "clean",
            max_docs_to_classify=2)
        outs.append(d.apply("q", "x", ["a", "b", "c"], ["1", "2", "3"], None,
                            [], does_oracle=True))
        seen_by.append(seen)
    out = _same(outs)
    assert seen_by[0] == seen_by[1] == ["a", "b"]
    assert out.ranked_docs == ["a", "b"]  # uncapped docs dropped from output


def test_discern_batched_classifier_matches_sequential():
    def classify(query, doc):
        return "perturbed" if "LIE" in doc else "clean"

    def classify_batch(pairs):
        return [classify(q, d) for q, d in pairs]

    kw = dict(query_id="q1", query="q?",
              corpus_docs=["good one", "has LIE inside", "fine"],
              corpus_ids=["a", "b", "c"], corpus_scores=[3.0, 2.0, 1.0],
              malicious_docs=["LIE doc", "benign-looking"], does_oracle=True)
    seqs, bats, bats2, caches = [], [], [], []
    for mod in DISCERN:
        cache_a, cache_b = {}, {}
        seqs.append(mod.DiscernAndAnswerDefense(classify).apply(
            **kw, persistent_cache=cache_a))
        bats.append(mod.DiscernAndAnswerDefense(
            classify, classify_batch=classify_batch).apply(
                **kw, persistent_cache=cache_b))
        assert cache_a == cache_b
        # cached entries short-circuit the classifier on a second apply
        bats2.append(mod.DiscernAndAnswerDefense(
            lambda q, d: "clean",
            classify_batch=lambda p: ["clean"] * len(p)).apply(
                **kw, persistent_cache=cache_b))
        caches.append(cache_b)
    seq, bat, bat2 = _same(seqs), _same(bats), _same(bats2)
    assert caches[0] == caches[1]
    assert seq == bat
    assert bat2.doc_labels == bat.doc_labels


def test_discern_batch_backend_with_a_wrong_label_count_raises():
    for mod in DISCERN:
        d = mod.DiscernAndAnswerDefense(lambda q, p: "clean",
                                        classify_batch=lambda p: ["clean"])
        with pytest.raises(ValueError, match="one label per"):
            d.apply("q", "x", ["a", "b"], ["1", "2"], None, [],
                    does_oracle=True)


def test_label_cache_roundtrip(tmp_path):
    cache = {("q1", "d1"): "clean", ("q1", "d2"): "perturbed"}
    jpath, tpath = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jcache.save_discern_labels_jsonl(jpath, cache)
    tcache.save_discern_labels_jsonl(tpath, cache)
    with open(jpath, "rb") as fj, open(tpath, "rb") as ft:
        assert fj.read() == ft.read()
    assert tcache.load_discern_labels_jsonl(jpath) == cache
    assert tcache.load_discern_labels_jsonl(str(tmp_path / "no.jsonl")) == {}


def test_embedding_filter_drops_duplicates():
    outs = []
    for mod in RAG:
        d = mod.EmbeddingFilterDefense(HashEncoder(), z_threshold=10.0,
                                       duplicate_sim=0.99)
        # two identical malicious docs form a duplicate cluster -> dropped
        outs.append(d.apply("q", "question",
                            ["alpha doc", "beta doc", "gamma doc"],
                            ["1", "2", "3"], [0.3, 0.2, 0.1],
                            ["copy of claim", "copy of claim"],
                            does_oracle=True))
    out = _same(outs)
    assert out.malicious_docs_survived == []
    assert set(out.ranked_docs) == {"alpha doc", "beta doc", "gamma doc"}


def test_embedding_filter_small_pool_passthrough():
    out = _same([mod.EmbeddingFilterDefense(HashEncoder()).apply(
        "q", "question", ["one"], ["1"], [0.1], [], does_oracle=True)
        for mod in RAG])
    assert out.ranked_docs == ["one"]


def test_embedding_filter_z_score_and_empty_docs():
    """A doc that echoes the query is a z-score outlier; empty docs pass
    through untouched; with every doc dropped the least suspicious one
    stays."""
    enc = HashEncoder()
    docs = ["a", "b", "c", "d", "e", "f"]

    class Echo(HashEncoder):
        def encode(self, texts, kind="passage", batch_size=32):
            return enc.encode([t.replace("ECHO ", "") for t in texts])

    outs = [mod.EmbeddingFilterDefense(Echo(), z_threshold=1.5).apply(
        "q", "ask", docs, list("123456"), None, ["ECHO ask", ""],
        does_oracle=True) for mod in RAG]
    out = _same(outs)
    assert out.malicious_docs_survived == [""]
    keep_one = _same([mod.EmbeddingFilterDefense(
        HashEncoder(), duplicate_sim=-2.0).apply(
            "q", "ask", docs, list("123456"), None, [], does_oracle=True)
        for mod in RAG])
    assert len(keep_one.ranked_docs) == 1


# --------------------------------------------------------- real backends
@pytest.fixture(scope="module")
def world():
    return load_world(os.path.join(CKPT, "world.json"))


class Recorder:
    """A generator proxy that keeps every raw generation."""

    def __init__(self, gen):
        self.gen, self.tokenizer, self.raw = gen, gen.tokenizer, []

    def generate_ids(self, ids, max_new_tokens=128):
        out = self.gen.generate_ids(ids, max_new_tokens=max_new_tokens)
        self.raw.append(list(out))
        return out


@pytest.mark.skipif(not HAVE_CKPT, reason="trained qa_ckpt not present")
def test_local_batch_classifier_on_qa_ckpt_equals_jax(world):
    from sdag_tpu.models.native_ckpt import load_decoder as jax_load
    from sdag_tpu.sdag.generate import Generator as JaxGenerator
    from sdag_tpu_torch.models.native_ckpt import load_decoder
    from sdag_tpu_torch.models.tokenizer import load_tokenizer
    from sdag_tpu_torch.sdag.generate import Generator
    tok = load_tokenizer(CKPT)
    facts = world.facts_for(world.eval_entities)[:3]
    pairs = []
    for f in facts:
        pairs += [(fact_query(f), fact_doc(f)),
                  (fact_query(f), malicious_doc(f, "zubo"))]
    jparams, jcfg = jax_load(CKPT)
    tparams, tcfg = load_decoder(CKPT, device="cpu")
    jrec = Recorder(JaxGenerator(jparams, jcfg, tok, temperature=0.0,
                                 batch_bucket=4))
    trec = Recorder(Generator(tparams, tcfg, tok, temperature=0.0,
                              batch_bucket=4, device="cpu"))
    jlabels = jdiscern.make_local_batch_classifier(
        jrec, max_tokens=8, batch_size=4)(pairs)
    tlabels = tdiscern.make_local_batch_classifier(
        trec, max_tokens=8, batch_size=4)(pairs)
    assert [len(r) for r in trec.raw] == [4, 2]       # chunks of 4 and 2
    assert trec.raw == jrec.raw
    assert tlabels == jlabels
    assert tlabels == [tdiscern.parse_label(o) for r in trec.raw for o in r]
    classify = tdiscern.make_local_classifier(trec, max_tokens=8)
    assert [classify(q, p) for q, p in pairs] == tlabels


def _tiny_encoders():
    """The JAX tiny encoder and the port's with the same weights."""
    from sdag_tpu.models import e5 as je5
    from sdag_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer
    cfg = te5.EncoderConfig.tiny()
    jparams = je5.init_encoder_params(jax.random.PRNGKey(3),
                                      je5.EncoderConfig.tiny())
    jenc = je5.E5Encoder(jparams, je5.EncoderConfig.tiny(),
                         JaxByteTokenizer(), model_name="e5", fused=False)
    tenc = te5.E5Encoder(
        te5.encoder_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu"),
        cfg, ByteTokenizer(), model_name="e5", device="cpu")
    return jenc, tenc


@pytest.mark.skipif(not HAVE_CKPT, reason="trained qa_ckpt not present")
def test_embedding_filter_on_the_tiny_encoder_keeps_jax_docs(world):
    jenc, tenc = _tiny_encoders()
    facts = world.facts_for(world.eval_entities)[:6]
    others = world.facts_for(world.train_entities)
    cases = []
    for i, f in enumerate(facts):
        docs = [fact_doc(f)] + [fact_doc(g) for g in others[4 * i:4 * i + 4]]
        mals = [malicious_doc(f, "zubo", variant=v) for v in range(i % 3)]
        cases.append((fact_query(f), docs, mals))
    texts = [t for q, d, m in cases for t in [q] + d + m]
    np.testing.assert_allclose(tenc.encode(texts),
                               np.asarray(jenc.encode(texts)), atol=1e-5)
    for n, (q, docs, mals) in enumerate(cases):
        ids = [f"d{n}_{i}" for i in range(len(docs))]
        _same([mod.EmbeddingFilterDefense(enc).apply(
            f"q{n}", q, docs, ids, None, mals, does_oracle=True)
            for mod, enc in ((jrag, jenc), (trag, tenc))])


def _cfg(tmp_path, world, cls, defense):
    corpus = tmp_path / "corpus.jsonl"
    csv_path = tmp_path / "attack.csv"
    write_corpus_jsonl(world, str(corpus))
    write_attack_csv(world, str(csv_path), world.eval_entities[:1], n_mal=2,
                     seed=world.seed + 2)
    cfg = cls()
    cfg.SAMPLE_SIZE = 3 if defense == "discern_and_answer" else 6
    cfg.TOP_K = [5]
    cfg.ADD_ATTACK_IN_RANK = [1]
    cfg.MAX_MALICIOUS_DOCS_PER_QUERY = 2
    cfg.CSV_INPUT_PATH = str(csv_path)
    cfg.CORPUS_JSONL_PATH = str(corpus)
    cfg.RETRIEVER_BACKEND = "sparse"
    cfg.SPARSE_INDEX_NAME_OR_PATH = str(tmp_path / "bm25.index")
    cfg.DEFENSE_BACKEND = defense
    cfg.LLM_CHECKPOINT = CKPT
    cfg.LLM_BATCH_SIZE = 8
    cfg.BATCH_SIZE_EMBED_Q = 32
    cfg.MAX_GEN_TOKENS_RAG = 16
    cfg.TEMPERATURE = 0.0
    cfg.DISCERN_LABELS_SAVE_SUFFIX = "labels.jsonl"
    cfg.OUTPUT_CSV_BASE = str(tmp_path / "out" / "results")
    return cfg


def _read(path):
    with open(path, newline="", encoding="utf-8") as fh:
        return list(csv.DictReader(fh))


@pytest.mark.skipif(not HAVE_CKPT, reason="trained qa_ckpt not present")
@pytest.mark.parametrize("defense", ["ragdefender", "discern_and_answer"])
def test_run_experiment_with_a_defense_equals_jax(tmp_path, world, defense):
    """The port's encoder carries the JAX package's tiny-encoder weights
    (encoder_params_from_numpy), as in test_torch_ranker_pipeline."""
    from sdag_tpu.config import Config as JaxConfig
    from sdag_tpu.pipeline.orchestrator import run_experiment as jax_run
    from sdag_tpu.pipeline.resources import init_resources as jax_init
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    tcfg = _cfg(tmp_path / "port", world, Config, defense)
    jcfg = _cfg(tmp_path / "jax", world, JaxConfig, defense)
    assert tres.needs_encoder(tcfg) == (defense == "ragdefender")
    jres = jax_init(jcfg)
    enc = None
    if defense == "ragdefender":
        cfg = te5.EncoderConfig.tiny()
        enc = te5.E5Encoder(
            te5.encoder_params_from_numpy(
                jax.tree.map(np.asarray, jres.ranker.params), cfg,
                device="cpu"),
            cfg, ByteTokenizer(), model_name=tcfg.RANKER_MODEL_NAME,
            device="cpu")
    res = tres.init_resources(tcfg, device="cpu", encoder=enc)
    assert (res.ranker is not None) == (defense == "ragdefender")
    run_experiment(tcfg, resources=res, device="cpu")
    jax_run(jcfg, resources=jres)
    name = "results_top_k=5_attacker_pos=1.csv"
    port_rows = _read(tmp_path / "port" / "out" / name)
    jax_rows = _read(tmp_path / "jax" / "out" / name)
    assert len(port_rows) == len(jax_rows) == tcfg.SAMPLE_SIZE
    for p, j in zip(port_rows, jax_rows):
        assert p == j
    if defense == "ragdefender":
        assert enc.stats["batches"] > 0
    else:
        labels = "out/results_labels.jsonl"
        with open(tmp_path / "port" / labels, "rb") as fp, \
                open(tmp_path / "jax" / labels, "rb") as fj:
            port_labels = fp.read()
            assert port_labels == fj.read()
        # one label per classified (query, doc): 2 malicious + 5 retrieved
        assert port_labels.count(b"\n") == tcfg.SAMPLE_SIZE * 7
