"""The port's spans (``utils/profiling.py``) on the CPU: nothing recorded
and no profiler range opened while no profiler collects; while one does,
nesting, batch ids and stamps on the profiler's clock; and the spans
the Generator, the orchestrator and BM25 search open at their layer
boundaries."""

import random

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sdag_tpu_torch.config import Config
from sdag_tpu_torch.datamodels import PairSpec, Resources
from sdag_tpu_torch.defenses.none import NoDefense
from sdag_tpu_torch.models.llama import DecoderConfig, init_decoder_params
from sdag_tpu_torch.models.tokenizer import ByteTokenizer
from sdag_tpu_torch.pipeline.orchestrator import \
    run_pair_malicious_doc_attack_for_batch
from sdag_tpu_torch.retrieval.sparse import BM25Index
from sdag_tpu_torch.sdag.generate import Generator
from sdag_tpu_torch.utils import profiling
from sdag_tpu_torch.utils.profiling import (PhaseTimer, batch_context,
                                            clear_spans, span, spans)

CPU = [ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _fresh_spans():
    clear_spans()
    yield
    clear_spans()


@pytest.fixture(scope="module")
def generator():
    cfg = DecoderConfig.tiny()
    params = init_decoder_params(torch.Generator().manual_seed(3), cfg,
                                 device="cpu")
    return Generator(params, cfg, ByteTokenizer(), temperature=0.0,
                     batch_bucket=4, device="cpu")


def _names():
    return [s.name for s in spans()]


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    timer = PhaseTimer()
    with batch_context("7"):
        with timer.phase("defense"):
            with span("sdag.test.inner") as rec:
                assert rec is None
        with timer.phase("defense"):
            pass
    assert spans() == [] and entered == []
    assert timer.counts["defense"] == 2 and timer.totals["defense"] >= 0.0
    assert set(timer.summary()) == {"defense"}


def test_on_links_parents_and_batches():
    timer = PhaseTimer()
    with profile(activities=CPU):
        with span("sdag.test.outside"):
            pass
        with batch_context("q0"):
            with timer.phase("generate_iso"):
                with span("sdag.test.child"):
                    with batch_context("q9"):
                        with span("sdag.test.grandchild"):
                            pass
                    with span("sdag.test.after_inner_batch"):
                        pass
        with span("sdag.test.after_batch"):
            pass
    got = {s.name: s for s in spans()}
    assert list(got) == ["sdag.test.outside", "sdag.orch.generate_iso",
                         "sdag.test.child", "sdag.test.grandchild",
                         "sdag.test.after_inner_batch",
                         "sdag.test.after_batch"]
    assert got["sdag.test.outside"].batch is None
    assert got["sdag.orch.generate_iso"].batch == "q0"
    assert got["sdag.test.child"].batch == "q0"
    assert got["sdag.test.grandchild"].batch == "q9"
    assert got["sdag.test.after_inner_batch"].batch == "q0"
    assert got["sdag.test.after_batch"].batch is None

    def within(inner, outer):
        return (got[outer].start_ns <= got[inner].start_ns
                and got[inner].end_ns <= got[outer].end_ns)
    assert within("sdag.test.child", "sdag.orch.generate_iso")
    assert within("sdag.test.grandchild", "sdag.test.child")
    assert within("sdag.test.after_inner_batch", "sdag.test.child")
    assert got["sdag.test.outside"].end_ns <= \
        got["sdag.orch.generate_iso"].start_ns
    assert got["sdag.orch.generate_iso"].end_ns <= \
        got["sdag.test.after_batch"].start_ns
    assert timer.counts["generate_iso"] == 1


def test_stamps_agree_with_the_profilers_events():
    """Each span's start and end lie within 200 us of its own profiler
    event's (the first range a process opens loads the profiler's range
    operator, so one span opens before the ones compared)."""
    with profile(activities=CPU) as prof:
        with span("sdag.test.warm"):
            pass
        for i in range(5):
            with span(f"sdag.test.stamp{i}"):
                torch.ones(64).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("sdag.test.stamp")}
    assert len(events) == 5
    for s in spans()[1:]:
        e = events[s.name]
        assert abs(s.start_ns - e.start_ns()) < 200_000, s
        assert abs(s.end_ns - e.end_ns()) < 200_000, s


def test_span_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profile(activities=CPU):
        with pytest.warns(UserWarning):
            for i in range(5):
                with span("sdag.test.many"):
                    with span("sdag.test.many.child"):
                        pass
    assert len(spans()) == 3
    assert all(s.end_ns is not None for s in spans())


@pytest.mark.parametrize("iso", [True, False])
def test_generator_spans_one_prefill_and_a_wait_per_chunk(generator, iso):
    tok = generator.tokenizer
    prompts = [np.asarray(tok.encode(t), np.int32)
               for t in ("the sky is", "a much longer prompt than that",
                         "x")]
    chunks0 = generator.stats["decode_chunks"]
    with profile(activities=CPU):
        if iso:
            from sdag_tpu_torch.sdag.spans import build_rag_prompt_plan
            plans = [build_rag_prompt_plan(tok, "what is x?", ["d one",
                                                               "d two"])
                     for _ in range(3)]
            out = generator.generate_plans(plans, max_new_tokens=19)
        else:
            out = generator.generate_ids(prompts, max_new_tokens=19)
    chunks = generator.stats["decode_chunks"] - chunks0
    names = _names()
    assert len(out) == 3 and chunks >= 1
    assert names.count("sdag.gen.prefill") == 1
    assert names.count("sdag.gen.decode") == 1
    assert names.count("sdag.gen.decode.launch") == chunks
    assert names.count("sdag.gen.decode.wait") == chunks
    assert names[0] == "sdag.gen.pack" and names[-1] == "sdag.gen.unpack"
    # ISO packs the prompts' masks, then both paths pad and upload
    assert names.count("sdag.gen.pack") == (2 if iso else 1)
    by = {s.name: s for s in spans()}
    decode = by["sdag.gen.decode"]
    for s in spans():
        if s.name.startswith("sdag.gen.decode."):
            assert decode.start_ns <= s.start_ns <= s.end_ns <= decode.end_ns
    # the last pack ends before prefill starts, unpack starts after decode
    assert by["sdag.gen.pack"].end_ns <= by["sdag.gen.prefill"].start_ns
    assert by["sdag.gen.prefill"].end_ns <= decode.start_ns
    assert decode.end_ns <= by["sdag.gen.unpack"].start_ns


def _attack_batch(generator, timer, qids):
    cfg = Config()
    cfg.ORACLE = True
    cfg.TEMPERATURE = 0.0
    cfg.LLM_BATCH_SIZE = 2
    cfg.MAX_GEN_TOKENS_RAG = 3
    n = len(qids)
    docs = [[f"passage {j} about topic {i}" for j in range(3)]
            for i in range(n)]
    return run_pair_malicious_doc_attack_for_batch(
        cfg=cfg, res=Resources(tokenizer=generator.tokenizer,
                               generator=generator),
        defense=NoDefense(), discern_cache={}, pair=PairSpec(2, 1),
        batch_qids=qids, batch_qs=[f"question {i}?" for i in range(n)],
        batch_gts=[["topic"] for _ in range(n)], retrieval_docs_full=docs,
        retrieval_ids_full=[[str(j) for j in range(3)] for _ in range(n)],
        retrieval_scores_full=[[3.0, 2.0, 1.0] for _ in range(n)],
        false_groups_batch=[["other"] for _ in range(n)],
        chosen_mals_batch=[[f"malicious text {i}"] for i in range(n)],
        rng=random.Random(5), timer=timer)


def test_attack_batch_spans_carry_the_batch_id(generator):
    timer = PhaseTimer()
    with profile(activities=CPU):
        rows = _attack_batch(generator, timer, ["40", "41", "42"])
    assert len(rows) == 3
    names = _names()
    for name in ("sdag.orch.defense", "sdag.orch.generate_iso",
                 "sdag.orch.generate_noiso", "sdag.orch.prompts.iso",
                 "sdag.orch.prompts.noiso", "sdag.orch.score"):
        assert names.count(name) == 1, name
    # 3 queries in LLM batches of 2, ISO and NO-ISO
    assert names.count("sdag.orch.llm_batch") == 4
    assert names.count("sdag.gen.prefill") == 4
    assert {s.batch for s in spans()} == {"40"}
    by = {s.name: s for s in spans()}
    gen_iso, prompts_iso = by["sdag.orch.generate_iso"], \
        by["sdag.orch.prompts.iso"]
    assert gen_iso.start_ns <= prompts_iso.start_ns
    assert prompts_iso.end_ns <= gen_iso.end_ns
    # each LLM batch holds exactly one prefill
    lb = [s for s in spans() if s.name == "sdag.orch.llm_batch"]
    pre = [s for s in spans() if s.name == "sdag.gen.prefill"]
    for s in lb:
        assert sum(s.start_ns <= p.start_ns and p.end_ns <= s.end_ns
                   for p in pre) == 1
    assert set(timer.counts) == {"defense", "generate_iso", "generate_noiso"}


def test_untraced_attack_batch_records_nothing(generator):
    timer = PhaseTimer()
    rows = _attack_batch(generator, timer, ["1", "2"])
    assert len(rows) == 2 and spans() == []
    assert timer.counts["generate_iso"] == 1


@pytest.fixture(scope="module")
def bm25():
    """Enough rows that two query terms' postings windows fit the
    candidate budget (half the rows)."""
    words = [f"w{i}" for i in range(400)]
    rng = np.random.default_rng(0)
    n = 6000
    texts = [" ".join(rng.choice(words, size=6)) for _ in range(n)]
    return BM25Index.from_texts(texts, [str(i) for i in range(n)],
                                engine="postings", device="cpu")


def test_bm25_search_names_the_engine_it_took(bm25, monkeypatch):
    queries = ["w1 w2", "w4"]
    with profile(activities=CPU):
        idx_p, sc_p = bm25.search(queries, top_k=5)
    assert _names() == ["sdag.bm25.encode", "sdag.bm25.postings"]
    clear_spans()
    monkeypatch.setattr(BM25Index, "POSTINGS_CANDIDATE_BUDGET", 0)
    with profile(activities=CPU):
        idx_s, sc_s = bm25.search(queries, top_k=5)
    assert _names() == ["sdag.bm25.encode", "sdag.bm25.scan"]
    np.testing.assert_allclose(sc_s, sc_p, rtol=1e-5)
