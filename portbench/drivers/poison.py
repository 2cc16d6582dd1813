"""Driver of the poisoning-experiment cells: BM25 retrieval over a seeded
corpus, PoisonedRAG injection at a fixed rank (ORACLE), then ISO and
NO-ISO generation and exact-match scoring, through the port's own
pipeline functions (``pipeline/orchestrator.py``): per batch of
``query_batch`` queries, ``SparseRetriever.retrieve_batch``, then
``select_malicious_docs_for_batch``, then
``run_pair_malicious_doc_attack_for_batch`` (which generates in
``LLM_BATCH_SIZE`` chunks through ``Generator``), as ``run_experiment``
does for each batch.

The traffic is a closed loop with one client: the next batch starts when
the last one is scored.  ``queries_per_s`` counts the queries of the
window's whole batches over the time from the window's start to the end
of its last batch; the window closes at the first batch that ends after
``--seconds``.

``correct`` judges three stages, each from the benchmark's own inputs and
the stage's output: the BM25 top-k of a sample of queries against a
float64 BM25 over the benchmark's corpus; that every answer ran to its
token budget or to EOS; and the served tokens of a sample of requests
(the one with the longest prompt among them) against a float32 forward
over prompt + served tokens (the mean gap of a served token's logit
below the reference's best), with the ISO mask and the prompt re-derived
by ``portbench/reference/prompts.py`` from the query, the retrieved ids
and the selected malicious documents.
"""

from __future__ import annotations

import random
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from portbench.common import bounds, textgen
from portbench.common.trace import traced
from portbench.reference import bm25 as ref_bm25
from portbench.reference import llama_decoder as ref_dec
from portbench.reference import prompts as ref_prompts

def vocabulary(cfg: Dict[str, Any]) -> Tuple[List[str], List[str]]:
    """(template pieces, pseudo-words): the tokenizer's pieces are the
    first followed by each word with a leading space."""
    head = ref_prompts.template_pieces()
    n = int(cfg["vocab_size"]) - 256 - len(ref_prompts.SPECIALS) - len(head)
    words = textgen.pseudo_words(n + 64, int(cfg["assumed"]["lexicon_seed"]))
    taken = set(head)
    return head, [w for w in words if " " + w not in taken][:n]


def decoder_config(cfg: Dict[str, Any]):
    from sdag_tpu_torch.models.llama import DecoderConfig
    return DecoderConfig(
        vocab_size=int(cfg["vocab_size"]), d_model=int(cfg["hidden_size"]),
        n_layers=int(cfg["num_hidden_layers"]),
        n_heads=int(cfg["num_attention_heads"]),
        n_kv_heads=int(cfg["num_key_value_heads"]),
        d_ff=int(cfg["intermediate_size"]),
        rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]),
        dtype=getattr(torch, cfg["torch_dtype"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        rope_scaling=None)


def make_weights(cfg: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The decoder's weights ([in, out] matrices, the port's tree layout)
    as views of three buffers, each filled by one normal_ call on the
    device: N(0, 1/fan_in) with fan_in each matrix's first dimension."""
    dt = getattr(torch, cfg["torch_dtype"])
    d, v = int(cfg["hidden_size"]), int(cfg["vocab_size"])
    ff = int(cfg["intermediate_size"])
    n_l = int(cfg["num_hidden_layers"])
    kv = int(cfg["num_key_value_heads"]) * d // int(
        cfg["num_attention_heads"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def buffer(n, std):
        t = torch.empty(n, dtype=dt, device=device)
        return t.normal_(0.0, std, generator=gen)

    per_layer = [("attn", "wq", d, d), ("attn", "wk", d, kv),
                 ("attn", "wv", d, kv), ("attn", "wo", d, d),
                 ("mlp", "gate", d, ff), ("mlp", "up", d, ff)]
    a = buffer(n_l * sum(i * o for *_, i, o in per_layer) + d * v, d ** -0.5)
    down = buffer(n_l * ff * d, ff ** -0.5)
    embed = buffer(v * d, v ** -0.5)
    gains = buffer((2 * n_l + 1) * d, 0.1).add_(1.0)
    off, layers = 0, []
    for li in range(n_l):
        layer = {"attn": {}, "mlp": {}}
        for grp, name, i, o in per_layer:
            layer[grp][name] = a[off:off + i * o].view(i, o)
            off += i * o
        layer["mlp"]["down"] = down[li * ff * d:(li + 1) * ff * d].view(ff, d)
        layer["ln1"] = gains[2 * li * d:(2 * li + 1) * d]
        layer["ln2"] = gains[(2 * li + 1) * d:(2 * li + 2) * d]
        layers.append(layer)
    return {"embed": embed.view(v, d), "layers": layers,
            "final_norm": gains[2 * n_l * d:],
            "lm_head": a[off:off + d * v].view(d, v)}


def _recording_tokenizer(pieces: List[str]):
    """The port's WordTokenizer, recording the token ids of every answer
    it decodes (the served tokens, in the order the Generator returns
    them)."""
    from sdag_tpu_torch.models.tokenizer import WordTokenizer

    class Recording(WordTokenizer):
        def __init__(self, p):
            super().__init__(p)
            self.served: List[List[int]] = []

        def decode(self, ids, skip_special_tokens=True):
            self.served.append([int(i) for i in ids])
            return super().decode(ids, skip_special_tokens)

    return Recording(pieces)


def make_traffic(cfg: Dict[str, Any], tr: Dict[str, Any], words: List[str],
                 seed: int) -> Dict[str, Any]:
    """The corpus of the configuration's ``corpus_docs`` passages (word
    ranks and strings), the queries with their answer, false answer and
    malicious candidates, all from ``seed``.  A query takes about half its
    words from a target passage, the rest from the Zipf distribution."""
    rng = np.random.default_rng([seed, 7])
    zipf = textgen.Zipf(len(words), float(tr["zipf_exponent"]))
    n_docs = int(cfg["corpus_docs"])
    flat, off = textgen.ragged(rng, zipf, n_docs, *tr["passage_words"])
    texts = textgen.render(words, flat, off)
    n_q = int(tr["queries"])
    lo, hi = tr["query_words"]
    mlo, mhi = tr["malicious_words"]
    n_mal = int(tr["malicious_per_query"])
    queries, answers, false, mals, q_words = [], [], [], [], []
    for _ in range(n_q):
        t = int(rng.integers(n_docs))
        doc = flat[off[t]:off[t + 1]]
        n = int(rng.integers(lo, hi + 1))
        ws = np.concatenate([doc[rng.integers(len(doc), size=n // 2)],
                             zipf.draw(rng, n - n // 2)])
        ws = ws[rng.permutation(n)]
        fa = int(zipf.draw(rng, 1)[0])
        group = []
        for _m in range(n_mal):
            m = int(rng.integers(mlo, mhi + 1))
            body = np.concatenate([ws, [fa], zipf.draw(rng, max(0, m - n - 1))])
            group.append(" ".join(words[i] for i in body[:m]))
        q_words.append(ws.tolist())
        queries.append(" ".join(words[i] for i in ws))
        answers.append([words[int(doc[rng.integers(len(doc))])]])
        false.append([words[fa]])
        mals.append(group)
    return {"flat": flat, "offsets": off, "texts": texts,
            "queries": queries, "q_words": q_words, "answers": answers,
            "false": false, "mals": mals}


def _config(tr: Dict[str, Any], seed: int):
    from sdag_tpu_torch.config import Config
    c = Config()
    c.SEED = seed
    c.TOP_K = [int(tr["top_k"])]
    c.ADD_ATTACK_IN_RANK = [int(tr["attack_rank"])]
    c.ORACLE = True
    c.TEMPERATURE = 0.0
    c.LLM_BATCH_SIZE = int(tr["llm_batch"])
    c.BATCH_SIZE_EMBED_Q = int(tr["query_batch"])
    c.MAX_GEN_TOKENS_RAG = int(tr["max_new_tokens"])
    c.MAX_MALICIOUS_DOCS_PER_QUERY = int(tr["max_malicious_docs"])
    c.MALICIOUS_DOC_SELECTION_STRATEGY = "random"
    c.RETRIEVER_BACKEND = "sparse"
    c.DEFENSE_BACKEND = "none"
    c.BM25_ENGINE = "postings"
    c.RANKED_LIST_ORDER_IN_PROMPT = "top_down"
    c.validate()
    return c


def setup(cfg: Dict[str, Any], tr: Dict[str, Any], seed: int, device,
          control: str = "") -> Dict[str, Any]:
    """Weights, tokenizer, corpus, BM25 index and queries from ``seed``;
    then warm-up batches of queries that the window does not send.
    ``control="int8"`` serves the program's int8 path (int8 weights and KV
    cache), the precision control."""
    from sdag_tpu_torch.datamodels import Resources
    from sdag_tpu_torch.defenses.none import NoDefense
    from sdag_tpu_torch.retrieval.sparse import BM25Index, SparseRetriever
    from sdag_tpu_torch.sdag.generate import Generator
    notes: Dict[str, Any] = {}
    t = time.perf_counter()
    head, words = vocabulary(cfg)
    pieces = head + [" " + w for w in words]
    tok = _recording_tokenizer(pieces)
    params = make_weights(cfg, seed, device)
    served_params, kv = params, "native"
    if control == "int8":
        from sdag_tpu_torch.models.llama import quantize_decoder_params_int8
        served_params, kv = quantize_decoder_params_int8(params), "int8"
    elif control:
        raise ValueError(f"unknown control {control!r}")
    gen = Generator(served_params, decoder_config(cfg), tok, temperature=0.0,
                    seed=seed, batch_bucket=int(tr["llm_batch"]),
                    kv_cache_dtype=kv, device=device)
    t, notes["setup_model_s"] = time.perf_counter(), time.perf_counter() - t
    traffic = make_traffic(cfg, tr, words, seed)
    t, notes["setup_traffic_s"] = time.perf_counter(), time.perf_counter() - t
    index = BM25Index.from_texts(
        traffic["texts"], [str(i) for i in range(len(traffic["texts"]))],
        k1=0.9, b=0.4, engine="postings", device=device)
    t, notes["setup_bm25_s"] = time.perf_counter(), time.perf_counter() - t
    st = {"cfg": cfg, "tr": tr, "seed": seed, "device": device,
          "params": params, "gen": gen, "tok": tok, "words": words,
          "pieces": pieces, "traffic": traffic, "cursor": 0,
          "config": _config(tr, seed), "notes": notes,
          "res": Resources(tokenizer=tok, generator=gen,
                           sparse_index=index),
          "retriever": SparseRetriever(index), "defense": NoDefense(),
          "batch_idx": 0}
    # the decode graphs of each padded prompt length the traffic reaches
    # (a graph is captured per shape at first use), then whole batches
    filler = tok.encode(" " + words[0])[0]
    for lp in tr["warmup_padded_lens"]:
        gen.generate_ids([np.full(int(lp), filler, np.int32)]
                         * int(tr["llm_batch"]),
                         max_new_tokens=int(tr["max_new_tokens"]))
    for _ in range(int(tr["warmup_batches"])):
        run_batch(st)
    notes["setup_warmup_s"] = time.perf_counter() - t
    return st


def run_batch(st: Dict[str, Any]) -> Dict[str, Any]:
    """One batch through retrieve, select, attack + generate + score."""
    from torch.profiler import record_function
    from sdag_tpu_torch.attack.selection import \
        select_malicious_docs_for_batch
    from sdag_tpu_torch.datamodels import PairSpec
    from sdag_tpu_torch.pipeline.orchestrator import \
        run_pair_malicious_doc_attack_for_batch
    from sdag_tpu_torch.utils.profiling import PhaseTimer
    tr, tf, cfg = st["tr"], st["traffic"], st["config"]
    bs = int(tr["query_batch"])
    i0 = st["cursor"]
    if i0 + bs > len(tf["queries"]):
        raise RuntimeError("the traffic's query pool is exhausted: raise "
                           "'queries' in the traffic file")
    st["cursor"] = i0 + bs
    b_idx = st["batch_idx"]
    st["batch_idx"] += 1
    qs = tf["queries"][i0:i0 + bs]
    gen, tok = st["gen"], st["tok"]
    before = dict(gen.stats)
    n_served = len(tok.served)
    k = int(tr["top_k"])
    t0 = time.perf_counter()
    with record_function("pb.retrieve"):
        ret = st["retriever"].retrieve_batch(qs, max_k_needed=k,
                                             embed_batch_size=bs)
    t1 = time.perf_counter()
    rng = random.Random(st["seed"] * 1_000_003 + b_idx)
    with record_function("pb.select_malicious"):
        chosen = select_malicious_docs_for_batch(
            None, ret.docs_texts_full, tf["mals"][i0:i0 + bs],
            strategy="random", max_docs=cfg.MAX_MALICIOUS_DOCS_PER_QUERY,
            rng=rng)
    pair = PairSpec(k, int(tr["attack_rank"]))
    with record_function("pb.attack_generate_score"):
        rows = run_pair_malicious_doc_attack_for_batch(
            cfg=cfg, res=st["res"], defense=st["defense"], discern_cache={},
            pair=pair, batch_qids=[str(i) for i in range(i0, i0 + bs)],
            batch_qs=qs, batch_gts=tf["answers"][i0:i0 + bs],
            retrieval_docs_full=ret.docs_texts_full,
            retrieval_ids_full=ret.ids_full,
            retrieval_scores_full=ret.scores_full,
            false_groups_batch=tf["false"][i0:i0 + bs],
            chosen_mals_batch=chosen,
            rng=random.Random(f"{st['seed']}:{b_idx}:{k}:{pair.attacker_pos}"),
            timer=PhaseTimer())
    t2 = time.perf_counter()
    served = tok.served[n_served:]
    return {
        "q0": i0, "n": bs, "wall_s": t2 - t0, "retrieve_s": t1 - t0,
        "prefill_s": gen.stats["prefill_s"] - before["prefill_s"],
        "decode_s": gen.stats["decode_s"] - before["decode_s"],
        "prefill_tokens": gen.stats["prefill_tokens"]
        - before["prefill_tokens"],
        "decode_tokens": gen.stats["decode_tokens"] - before["decode_tokens"],
        "decode_steps": gen.stats["decode_steps"] - before["decode_steps"],
        "captures": gen.stats["graph_captures"] - before["graph_captures"],
        "ids": [[int(x) if x != "NA" else -1 for x in r]
                for r in ret.ids_full],
        "scores": [list(map(float, r)) for r in ret.scores_full],
        "chosen": chosen,
        "served_iso": served[:bs], "served_noiso": served[bs:2 * bs],
        "answered": sum(1 for r in rows if r["rag_answer_iso"] is not None
                        and r["rag_answer_noiso"] is not None),
    }


def window(st: Dict[str, Any], seconds: float) -> Dict[str, Any]:
    recs = []
    t0 = time.perf_counter()
    while True:
        recs.append(run_batch(st))
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
    st["records"] = recs
    st["window_s"] = now - t0
    st["notes"]["window_batches"] = len(recs)
    st["notes"]["window_graph_captures"] = sum(r["captures"] for r in recs)
    attempted = sum(r["n"] for r in recs)
    done = sum(r["answered"] for r in recs)
    return {"attempted": attempted, "failed": attempted - done,
            "metrics": {"queries_per_s": (done / st["window_s"], "queries/s")}}


def trace_segment(st: Dict[str, Any]) -> None:
    """The traced segment: ``trace_batches`` more batches under the
    profiler."""
    with traced(st["device"]) as seg:
        st["segment_records"] = [run_batch(st)
                                 for _ in range(int(st["tr"]["trace_batches"]))]
    st["segment"] = seg


def prompt_rows(st: Dict[str, Any], rec: Dict[str, Any]) -> List[Dict]:
    """Per query of a record: the re-derived prompt (``Prompt``) and its
    served token counts, from the query, the returned ids and the
    selected malicious documents."""
    vocab = st.get("ref_vocab")
    if vocab is None:
        vocab = st["ref_vocab"] = ref_prompts.Vocab(st["pieces"])
    tf, pos = st["traffic"], int(st["tr"]["attack_rank"])
    out = []
    for j in range(rec["n"]):
        docs = [tf["texts"][i] if i >= 0 else "" for i in rec["ids"][j]]
        mals = list(rec["chosen"][j])
        ranked = docs[:max(0, pos - 1)] + mals + docs[max(0, pos - 1):]
        p = ref_prompts.rag_prompt(vocab, tf["queries"][rec["q0"] + j], ranked)
        # a missing answer reads as empty (``short_answers`` counts it)
        iso, noiso = rec["served_iso"], rec["served_noiso"]
        out.append({"prompt": p, "iso": iso[j] if j < len(iso) else [],
                    "noiso": noiso[j] if j < len(noiso) else []})
    return out


def release(st: Dict[str, Any]) -> None:
    """Free the program's state (the weights are the benchmark's inputs and
    stay for the reference)."""
    for key in ("gen", "res", "retriever", "defense"):
        st.pop(key, None)
    if st["device"].type == "cuda":
        torch.cuda.synchronize(st["device"])
        torch.cuda.empty_cache()


def check(st: Dict[str, Any], control: bool = False
          ) -> List[Tuple[str, float, float]]:
    """The numbers compared, each with its limit.  ``control``: also the
    BM25 reading of the reference in TF32 put in the program's place."""
    tr = st["tr"]
    lim = tr["limits"]
    recs = st["records"] + st.get("segment_records", [])
    rng = np.random.default_rng([st["seed"], 11])
    eos = ref_prompts.N_BYTES + ref_prompts.SPECIALS.index("<|eot_id|>")
    budget = int(tr["max_new_tokens"])
    short = 0
    for r in recs:
        for side in ("served_iso", "served_noiso"):
            answers = r[side]
            short += r["n"] - len(answers)
            short += sum(1 for a in answers
                         if len(a) < budget and (not a or a[-1] != eos))
    out = [("short_answers", float(short), float(lim["short_answers"]))]

    # BM25 top-k of a sample of queries
    tf = st["traffic"]
    bm = ref_bm25.BM25(tf["flat"], tf["offsets"], st["device"])
    flat_q = [(r, j) for r in recs for j in range(r["n"])]
    pick = rng.choice(len(flat_q), size=min(len(flat_q),
                                            int(tr["check_bm25_queries"])),
                      replace=False)
    gap = low = 0.0
    k = int(tr["top_k"])
    for p in pick:
        r, j = flat_q[int(p)]
        words = tf["q_words"][r["q0"] + j]
        ref = bm.scores(words)
        gap = max(gap, ref_bm25.rank_gap(ref, r["ids"][j], r["scores"][j]))
        if control:
            t = bm.scores(words, tf32=True)
            v, i = torch.topk(t, k)
            low = max(low, ref_bm25.rank_gap(ref, i.tolist(), v.tolist()))
    del bm
    out.append(("bm25_gap", gap, float(lim["bm25_gap"])))
    if control:
        out.append(("control_tf32.bm25_gap", low, float(lim["bm25_gap"])))

    # served tokens of a sample of requests, the longest prompt among them
    rows = [(r, row) for r in recs for row in prompt_rows(st, r)]
    n = min(len(rows), int(tr["check_requests"]))
    longest = max(range(len(rows)), key=lambda i: len(rows[i][1]["prompt"].ids))
    pick = [longest] + [int(i) for i in rng.choice(len(rows), size=n,
                                                   replace=False)
                        if int(i) != longest][:n - 1]
    seqs = []
    for i in pick:
        row = rows[i][1]
        p = row["prompt"]
        seqs.append(ref_dec.Seq(p.ids + row["iso"], len(p.ids),
                                p.sys_user_len, tuple(p.doc_spans)))
        seqs.append(ref_dec.Seq(p.ids + row["noiso"], len(p.ids)))
    gaps = ref_dec.served_gaps(st["params"], st["cfg"], seqs, st["device"])
    # the widest gap is set by the nearest tie between the top two logits
    # among a few hundred tokens and swings from seed to seed; the mean
    # over every served token checked is the steady number compared
    flat_g = [x for g in gaps for x in g]
    st["notes"].update(served_tokens_checked=len(flat_g),
                       served_gap_max=max(flat_g, default=0.0),
                       served_tokens_off_argmax=sum(1 for x in flat_g
                                                    if x > 0))
    mean = float(np.mean(flat_g)) if flat_g else float("inf")
    out.append(("served_gap_mean", mean, float(lim["served_gap_mean"])))
    return out


def layer_inputs(st: Dict[str, Any]) -> None:
    """What the per-layer readers need beyond the records: each record's
    re-derived prompts (lengths and unmasked pairs) and served counts."""
    for rec in st["records"] + st.get("segment_records", []):
        rec["prompts"] = [
            {"len": len(r["prompt"].ids),
             "iso_pairs": bounds.iso_pairs(len(r["prompt"].ids),
                                           r["prompt"].sys_user_len,
                                           r["prompt"].doc_spans),
             "iso_fed": len(r["iso"]), "noiso_fed": len(r["noiso"])}
            for r in prompt_rows(st, rec)]
