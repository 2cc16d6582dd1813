"""The plain references against the port at small sizes on the CPU, in
float32: they agree to rounding, and a wrong answer reads far off."""

import torch

from conftest import small
from portbench.drivers import poison
from portbench.reference import bm25 as ref_bm25
from portbench.reference import llama_decoder as ref_dec
from portbench.reference import prompts as ref_prompts

CPU = torch.device("cpu")


def _decoder_world(bench):
    cfg, tr = small(bench, "mistral7b.poison_top5")
    head, words = poison.vocabulary(cfg)
    pieces = head + [" " + w for w in words]
    traffic = poison.make_traffic(cfg, tr, words, 77)
    return cfg, tr, pieces, traffic


def test_prompts_match_the_port(bench):
    from sdag_tpu_torch.models.tokenizer import WordTokenizer
    from sdag_tpu_torch.sdag.spans import (build_plain_chat_ids,
                                           build_rag_prompt_plan)
    from sdag_tpu_torch.utils import prompts
    _, _, pieces, tf = _decoder_world(bench)
    tok = WordTokenizer(pieces)
    vocab = ref_prompts.Vocab(pieces)
    docs = tf["texts"][:3] + [""] + tf["mals"][0][:1]
    q = tf["queries"][0]
    plan = build_rag_prompt_plan(tok, q, docs)
    ref = ref_prompts.rag_prompt(vocab, q, docs)
    assert plan.input_ids.tolist() == ref.ids
    assert plan.layout.sys_user_len == ref.sys_user_len
    assert list(plan.layout.doc_token_spans) == ref.doc_spans
    assert plan.layout.qa_start == ref.qa_start
    plain = build_plain_chat_ids(tok, prompts.SYSTEM_PROMPT_RAG,
                                 prompts.USER_RAG_PROMPT.format(
                                     query=q,
                                     docs_text=prompts.render_docs_text(docs)))
    assert plain.tolist() == ref_prompts.plain_prompt_ids(vocab, q, docs)
    assert plain.tolist() == ref.ids


def test_decoder_reference_agrees_with_the_port(bench):
    from sdag_tpu_torch.sdag.generate import Generator
    from sdag_tpu_torch.sdag.spans import build_rag_prompt_plan
    cfg, _, pieces, tf = _decoder_world(bench)
    tok = poison._recording_tokenizer(pieces)
    params = poison.make_weights(cfg, 5, CPU)
    gen = Generator(params, poison.decoder_config(cfg), tok, device=CPU,
                    temperature=0.0)
    vocab = ref_prompts.Vocab(pieces)
    q, docs = tf["queries"][1], tf["texts"][3:6]
    gen.generate_plans([build_rag_prompt_plan(tok, q, docs)],
                       max_new_tokens=6)
    served = tok.served[-1]
    p = ref_prompts.rag_prompt(vocab, q, docs)
    seq = ref_dec.Seq(p.ids + served, len(p.ids), p.sys_user_len,
                            tuple(p.doc_spans))
    gaps = ref_dec.served_gaps(params, cfg, [seq], CPU)[0]
    assert len(gaps) == 6 and max(gaps) < 1e-4
    wrong = ref_dec.Seq(p.ids + served[:2] + [(served[2] + 1) % 1024]
                              + served[3:], len(p.ids), p.sys_user_len,
                              tuple(p.doc_spans))
    assert max(ref_dec.served_gaps(params, cfg, [wrong], CPU)[0]) > 1e-2


def test_bm25_reference_agrees_with_the_port(bench):
    from sdag_tpu_torch.retrieval.sparse import BM25Index
    _, _, _, tf = _decoder_world(bench)
    idx = BM25Index.from_texts(tf["texts"],
                               [str(i) for i in range(len(tf["texts"]))],
                               device=CPU)
    ids, scores = idx.search(tf["queries"][:8], 5)
    bm = ref_bm25.BM25(tf["flat"], tf["offsets"], CPU)
    for j in range(8):
        ref = bm.scores(tf["q_words"][j])
        assert ref_bm25.rank_gap(ref, ids[j].tolist(),
                                 scores[j].tolist()) < 1e-5
        bad = ids[j].tolist()
        bad[0] = int(torch.argsort(ref)[len(ref) // 2])
        assert ref_bm25.rank_gap(ref, bad, scores[j].tolist()) > 1e-2
        t = bm.scores(tf["q_words"][j], tf32=True)
        assert float((t - ref).abs().max()) > 1e-6
