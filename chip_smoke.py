#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``sdag_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, one CUDA device

Phase 0  print the card (nvidia-smi name, power limit); build kernels K1
         (csrc/sdag_prefill.cu) and K2 (csrc/bm25_scan_topk.cu) with nvcc.
Phase 1  K1 against its plain PyTorch version (sdag_attention_reference) on
         the card: the L=4096 20-doc 2-NN layout, the same tensors fully
         causal, L=16384 with 31 docs, a Dh=32 f32 case with holes, 40 docs
         and a q_offset slice, and the main paths' ISO/NO-ISO shapes over
         real synthetic-world prompts: llama3-8b heads in bf16 (the
         tensor-core body) and qa_ckpt's heads in f32 (the CUDA-core
         body).  Valid rows that see a key are compared: max abs error
         <= 2e-2 for bf16, <= 1e-4 for f32, and each row's max abs error
         over its RMS <= 5e-2 / 1e-3; at each ISO main-path shape a
         planted one-tile fault must fail these checks.  Times K1, the
         plain version, and F.scaled_dot_product_attention with the dense
         boolean mask.
Phase 2  K2 against its plain version: 1,048,576 docs x 64 Zipf term slots
         (2^18 vocab), 32 queries x 16 terms, k=10 (and k=20; and 32 terms,
         k=64: every pass-1 instantiation); and the main path's
         index/query shapes.  Indices must agree wherever scores differ by
         more than 1e-5 relative; scores agree within 1e-5 relative.
Phase 3  run_experiment on experiments/data/qa_ckpt (trained decoder):
         clean ACC iso/noiso >= 0.5, attacked ASR iso+noiso > 0.
Phase 4  the main path at full width: run_experiment with LLM_ARCH=llama3-8b
         (random bf16 weights, 32 layers), BM25_ENGINE=scan, 36 queries;
         launch counts are zeroed before and read after, and both kernels
         must have launched (K1 at least 32 layers x ISO+NO-ISO batches).
         Phase 3 counts its own run the same way.

Any failure raises (exit code 1).  Without CUDA, or without the
sdag_tpu_torch package beside this script, it exits 2 and prints no
result.  The last two stdout lines are the kernels JSON and
{"ok": true, "device": {...}}; details go to smoke_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "smoke_out")

H100_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
BF16_TOL, F32_TOL = 2e-2, 1e-4
# a row's max abs error over the row's RMS (catches a few leaked or dropped
# keys in long rows, whose outputs sit far below the absolute limits)
BF16_ROW_TOL, F32_ROW_TOL = 5e-2, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- phase 1
def _layout_docs(L, sys_len, n_docs, doc_len, neighbors):
    import numpy as np
    doc_id = np.full(L, -1, np.int32)
    nbr = np.zeros(L, np.int32)
    for d in range(n_docs):
        s = sys_len + d * doc_len
        doc_id[s:s + doc_len] = d
        bits = 0
        if neighbors:
            for n in (d - 1, d + 1):
                if 0 <= n < min(n_docs, 32):
                    bits |= 1 << n
        nbr[s:s + doc_len] = bits
    return doc_id, nbr


def _row_errors(out_k, out_p, rows):
    """Over the rows that see a key: the max abs error, and the max over
    rows of the row's max abs error divided by the row's RMS in out_p."""
    ref = out_p.float()
    keep = rows[:, None, :]                              # [B, 1, Lq]
    row_max = (out_k.float() - ref).abs().amax(-1)       # [B, H, Lq]
    rms = ref.pow(2).mean(-1).sqrt().clamp_min(1e-30)
    return (float(row_max.masked_fill(~keep, 0).max()),
            float((row_max / rms).masked_fill(~keep, 0).max()))


def _planted_fault(q, k, v, plan, out_p, rows, tol, row_tol):
    """Drop one live key tile from K1's worklist (the last tile of the
    q-tile with the most live tiles) and require the checks to flag it."""
    from sdag_tpu_torch.ops import attention as A
    counts = plan["counts"].clone()
    b, qi = divmod(int(counts.argmax()), counts.shape[1])
    counts[b, qi] -= 1
    out = A.sdag_prefill_cuda(q, k, v, dict(plan, counts=counts))
    err, row_err = _row_errors(out, out_p, rows)
    if err <= tol and row_err <= row_tol:
        raise AssertionError("K1 checks missed a planted one-tile fault: "
                             f"abs {err}, row-relative {row_err}")
    return {"fault_max_abs_err": err, "fault_max_row_rel_err": row_err}


def _k1_case(name, q, k, v, doc_id, nbr, sul, vl, q_offset=None,
             doc_id_q=None, nbr_q=None, timed=False, plant_fault=False):
    """Run K1 and its plain version on the same inputs; returns a record
    with the errors over valid rows that see a key (and times if asked)."""
    import torch
    from sdag_tpu_torch.ops import attention as A

    B, Hq, Lq, Dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    dev = q.device
    qo = torch.zeros(B, dtype=torch.int32, device=dev) \
        if q_offset is None else q_offset
    dq = doc_id if doc_id_q is None else doc_id_q
    nq = nbr if nbr_q is None else nbr_q
    kw = dict(valid_len=vl, q_offset=qo, doc_id_q=dq, nbr_bits_q=nq)
    plan = A.prefill_mask_plan(doc_id, nbr, sul, vl, doc_id_q=dq,
                               nbr_bits_q=nq, q_offset=qo)
    run_k = lambda: A.sdag_prefill_cuda(q, k, v, plan)  # noqa: E731
    run_p = lambda: A.sdag_attention_reference(  # noqa: E731
        q, k, v, doc_id, nbr, sul, **kw)
    out_k = A.sdag_prefill_attention(q, k, v, doc_id, nbr, sul, **kw)
    torch.cuda.synchronize()
    out_p = run_p()
    i = qo[:, None, None] + torch.arange(Lq, device=dev)[None, :, None]
    j = torch.arange(Lk, device=dev)[None, None, :]
    mask = A._tile_mask(i, j, dq[:, :, None], doc_id[:, None, :],
                        nq[:, :, None], sul[:, None, None], vl[:, None, None])
    rows = mask.any(-1)                                  # [B, Lq]
    err, row_err = _row_errors(out_k, out_p, rows)
    finite = bool(torch.isfinite(out_k.float()).all())
    pairs = int(mask.sum())
    dtype = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    tol, row_tol = (BF16_TOL, BF16_ROW_TOL) if dtype == "bfloat16" \
        else (F32_TOL, F32_ROW_TOL)
    rec = {"name": name, "B": B, "Hq": Hq, "Hkv": Hkv, "Lq": Lq,
           "Lk": Lk, "Dh": Dh, "dtype": dtype, "max_abs_err": err,
           "tol": tol, "max_row_rel_err": row_err, "row_tol": row_tol,
           "live_tiles": int((plan["kinds"] > 0).sum()),
           "all_tiles": int(plan["kinds"].numel()), "visible_pairs": pairs}
    if not finite or not err <= tol or not row_err <= row_tol:
        raise AssertionError(f"K1 {name}: max abs err {err} (limit {tol}), "
                             f"row-relative {row_err} (limit {row_tol}), "
                             f"finite={finite}")
    if plant_fault:
        rec.update(_planted_fault(q, k, v, plan, out_p, rows, tol, row_tol))
    if timed:
        # q/k/v read once where the position is below valid_len, the output
        # written whole, the metadata read once
        q_rows = int((vl - qo).clamp(0, Lq).sum())
        kv_rows = int(vl.clamp(0, Lk).sum())
        flops = 4.0 * pairs * Hq * Dh
        nbytes = (Hq * q_rows + 2 * Hkv * kv_rows) * Dh * q.element_size() \
            + q.numel() * q.element_size() \
            + 4 * (doc_id.numel() + 2 * dq.numel())
        t_ops = flops / PEAK_FLOPS[dtype]
        t_bytes = nbytes / H100_BYTES_PER_S
        rep = Hq // k.shape[1]
        kr = k.repeat_interleave(rep, 1)
        vr = v.repeat_interleave(rep, 1)
        dense = mask[:, None]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa
            q, kr, vr, attn_mask=dense)
        rec.update(ms=cuda_ms(run_k), plain_ms=cuda_ms(run_p, iters=3,
                                                       warmup=1),
                   library_ms=cuda_ms(sdpa, iters=5, warmup=1),
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"[phase1] {json.dumps(rec)}")
    return rec


def _main_path_prompts(n=8):
    """ISO plans as the main path builds them: 5 retrieved fact docs plus
    one injected malicious doc, byte tokenizer (llama3-8b random init)."""
    from sdag_tpu_torch.models.tokenizer import load_tokenizer
    from sdag_tpu_torch.sdag.spans import build_plain_chat_ids, \
        build_rag_prompt_plan
    from sdag_tpu_torch.utils import prompts
    from sdag_tpu_torch.utils.synth_qa import (fact_doc, fact_query,
                                               load_world, malicious_doc)
    world = load_world(os.path.join(REPO, "experiments", "data", "qa_ckpt",
                                    "world.json"))
    tok = load_tokenizer("")
    facts = world.facts_for(world.eval_entities)[:n]
    others = world.facts_for(world.train_entities)
    plans, plain = [], []
    for i, f in enumerate(facts):
        docs = [malicious_doc(f, "bodiku")] + [fact_doc(f)] + [
            fact_doc(g) for g in others[4 * i:4 * i + 4]]
        plans.append(build_rag_prompt_plan(tok, fact_query(f), docs))
        user = prompts.USER_RAG_PROMPT.format(
            query=fact_query(f), docs_text=prompts.render_docs_text(docs))
        plain.append(build_plain_chat_ids(tok, prompts.SYSTEM_PROMPT_RAG,
                                          user))
    return plans, plain


def phase1(dev):
    import numpy as np
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    recs = []
    t32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)  # noqa

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev,
                           dtype=torch.float32).to(dtype)

    # (a)/(b): B=1, Hq=16, Hkv=8, Dh=128, bf16, L=4096, 20 docs x 176, 2-NN
    L = 4096
    q, k, v = (rnd(1, h, L, 128, dtype=torch.bfloat16) for h in (16, 8, 8))
    d, n = _layout_docs(L, 256, 20, 176, True)
    vl = t32([L])
    recs.append(_k1_case("a_L4096_20docs_2nn", q, k, v, t32(d[None]),
                         t32(n[None]), t32([256]), vl, timed=True))
    recs.append(_k1_case("b_L4096_causal", q, k, v,
                         t32(np.full((1, L), -1)), t32(np.zeros((1, L))),
                         t32([0]), vl, timed=True))
    del q, k, v
    # (c): L=16384, 31 docs x 512, no neighbors (the TPU splash regime)
    L = 16384
    q, k, v = (rnd(1, h, L, 128, dtype=torch.bfloat16) for h in (16, 8, 8))
    d, n = _layout_docs(L, 256, 31, 512, False)
    recs.append(_k1_case("c_L16384_31docs", q, k, v, t32(d[None]),
                         t32(n[None]), t32([256]), t32([L]), timed=True))
    del q, k, v
    torch.cuda.empty_cache()
    # (d): Dh=32 f32, B=2, holes, 40 docs, q rows = second half (q_offset)
    L, Lq, B = 2048, 1024, 2
    rng = np.random.default_rng(0)
    did = np.full((B, L), -1, np.int32)
    nbr = np.zeros((B, L), np.int32)
    for b in range(B):
        pos = 96
        for dd in range(40):
            ln = int(rng.integers(20, 40))
            did[b, pos:pos + ln] = dd
            nbr[b, pos:pos + ln] = (1 << ((dd + 1) % 31)) if dd < 31 else 0
            pos += ln
            hole = int(rng.integers(0, 6))
            did[b, pos:pos + hole] = -2
            pos += hole
    vlen = t32([L - 37, L - 300])
    kq = rnd(B, 4, L, 32, dtype=torch.float32)
    k = rnd(B, 2, L, 32, dtype=torch.float32)
    v = rnd(B, 2, L, 32, dtype=torch.float32)
    q = kq[:, :, Lq:].contiguous()
    recs.append(_k1_case("d_Dh32_f32_holes_40docs_qoffset", q, k, v,
                         t32(did), t32(nbr), t32([96, 96]), vlen,
                         q_offset=t32([L - Lq] * B),
                         doc_id_q=t32(did[:, L - Lq:]),
                         nbr_q=t32(nbr[:, L - Lq:])))
    # (e)-(h): the main paths' shapes over real prompt layouts (batch 8,
    # ISO plans padded to 128 / the NO-ISO causal prompts): llama3-8b heads
    # in bf16 (phase 4, the tensor-core body) and qa_ckpt's heads in f32
    # (phase 3, the CUDA-core body)
    plans, plain = _main_path_prompts(8)
    B = len(plans)
    lp = -(-max(len(p.input_ids) for p in plans) // 128) * 128
    metas = [p.metadata(pad_to=lp) for p in plans]
    lpn = -(-max(len(x) for x in plain) // 128) * 128
    for iso, noiso, heads, dh, dtype in (
            ("e_llama3_8b_iso", "f_llama3_8b_noiso", (32, 8, 8), 128,
             torch.bfloat16),
            ("g_qa_ckpt_iso", "h_qa_ckpt_noiso", (6, 6, 6), 32,
             torch.float32)):
        q, k, v = (rnd(B, h, lp, dh, dtype=dtype) for h in heads)
        recs.append(_k1_case(
            iso, q, k, v, t32(np.stack([m[0] for m in metas])),
            t32(np.stack([m[1] for m in metas])), t32([m[2] for m in metas]),
            t32([len(p.input_ids) for p in plans]), timed=True,
            plant_fault=True))
        q, k, v = (rnd(B, h, lpn, dh, dtype=dtype) for h in heads)
        recs.append(_k1_case(
            noiso, q, k, v,
            t32(np.full((B, lpn), -1)), t32(np.zeros((B, lpn))),
            t32([0] * B), t32([len(x) for x in plain]), timed=True))
        del q, k, v
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------- phase 2
def _zipf_ids(g, shape, vocab, s, dev):
    import torch
    w = 1.0 / torch.arange(1, vocab + 1, device=dev, dtype=torch.float64) ** s
    cdf = torch.cumsum(w / w.sum(), 0)
    u = torch.rand(shape, generator=g, device=dev, dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp(max=vocab - 1).to(torch.int32)


def _dedup_rows(ids):
    """Sort each row and turn repeated terms into PAD (packed rows hold
    distinct terms)."""
    import torch
    ids = torch.sort(ids, dim=1).values
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    return torch.where(dup, -1, ids)


def _k2_case(name, term_ids, impacts, q_terms, q_weights, k, valid_n,
             timed=True):
    import torch
    from sdag_tpu_torch.ops import bm25 as M
    N, Lp = term_ids.shape
    Q, T = q_terms.shape
    vk, ik = M.bm25_topk(term_ids, impacts, q_terms, q_weights, k,
                         valid_n=valid_n)
    torch.cuda.synchronize()
    scores = M.bm25_scores(term_ids, impacts, q_terms, q_weights)
    scores[:, valid_n:] = float("-inf")
    vp, ip = M._ordered_topk(scores, k)
    ok_v = torch.isclose(vk, vp, rtol=1e-5, atol=0) | (
        torch.isneginf(vk) & torch.isneginf(vp))
    if not bool(ok_v.all()):
        raise AssertionError(f"K2 {name}: scores differ beyond 1e-5 rel")
    # indices may differ only where scores are within 1e-5 relative (ties)
    mism = ik != ip
    if bool(mism.any()):
        got = torch.gather(scores, 1, ik.clamp(min=0).long())
        tie = torch.isclose(got, vp, rtol=1e-5, atol=0)
        if not bool((tie | ~mism).all()):
            raise AssertionError(f"K2 {name}: indices differ at scores "
                                 "more than 1e-5 relative apart")
    err = float(torch.where(torch.isfinite(vp), (vk - vp).abs(),
                            torch.zeros_like(vp)).max())
    rec = {"name": name, "N": N, "Lp": Lp, "Q": Q, "T": T, "k": k,
           "valid_n": valid_n, "max_abs_err": err,
           "index_mismatches": int(mism.sum())}
    if timed:
        # bytes: the valid_n indexed rows (term id + impact per slot), the
        # queries (term + weight per slot) and the [Q, k] output, once each;
        # operations: one multiply and one add per (query slot, doc slot)
        # match among the valid rows
        docs = term_ids[:valid_n]
        width = max(int(docs.max()), int(q_terms.max())) + 1
        df = torch.bincount(docs[docs >= 0].long(), minlength=width)
        matches = int(torch.where(q_terms >= 0, df[q_terms.clamp(min=0)
                                                   .long()], 0).sum())
        t_bytes = (valid_n * Lp * 8 + Q * T * 8 + Q * k * 8) \
            / H100_BYTES_PER_S
        t_ops = 2.0 * matches / PEAK_FLOPS["float32"]
        rec.update(
            ms=cuda_ms(lambda: M.bm25_topk_cuda(term_ids, impacts, q_terms,
                                                q_weights, k,
                                                valid_n=valid_n)),
            plain_ms=cuda_ms(lambda: M.bm25_topk_reference(
                term_ids, impacts, q_terms, q_weights, k, valid_n=valid_n),
                iters=3, warmup=1),
            library_ms=cuda_ms(lambda: torch.topk(scores, k, dim=1)),
            slot_matches=matches, bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"[phase2] {json.dumps(rec)}")
    return rec


def phase2(dev):
    import numpy as np
    import torch
    from sdag_tpu_torch.retrieval.sparse import BM25Index
    from sdag_tpu_torch.pipeline.resources import load_corpus_jsonl
    from sdag_tpu_torch.utils.synth_qa import (fact_query, load_world,
                                               write_corpus_jsonl)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    recs = []
    # (a) 1,048,576 docs x 64 slots, Zipf over 2^18 terms: 512 MB on device
    N, Lp, V, Q, T = 1 << 20, 64, 1 << 18, 32, 16
    term_ids = _dedup_rows(_zipf_ids(g, (N, Lp), V, 1.07, dev))
    impacts = (0.1 + 2.9 * torch.rand((N, Lp), generator=g, device=dev))
    impacts = torch.where(term_ids >= 0, impacts, 0.0).contiguous()
    q_terms = _dedup_rows(_zipf_ids(g, (Q, T), V, 1.07, dev)).contiguous()
    q_weights = torch.where(
        q_terms >= 0, 1.0 + (torch.rand((Q, T), generator=g, device=dev)
                             > 0.8).float(), 0.0).contiguous()
    recs.append(_k2_case("a_N1M_Lp64_zipf", term_ids, impacts, q_terms,
                         q_weights, 10, N))
    # the wrapper's other pass-1 instantiations: k > 16 at T <= 16, and
    # T > 16 with k > 16
    recs.append(_k2_case("a_N1M_k20", term_ids, impacts, q_terms,
                         q_weights, 20, N, timed=False))
    q_terms = _dedup_rows(_zipf_ids(g, (Q, 32), V, 1.07, dev)).contiguous()
    q_weights = torch.where(q_terms >= 0, 1.0, 0.0).contiguous()
    recs.append(_k2_case("a_N1M_T32_k64", term_ids, impacts, q_terms,
                         q_weights, 64, N, timed=False))
    del term_ids, impacts
    torch.cuda.empty_cache()
    # (b) the main path's shapes: the synthetic world's BM25 index, its
    # first 32 queries (32 padded term slots), k = TOP_K = 5
    world = load_world(os.path.join(REPO, "experiments", "data", "qa_ckpt",
                                    "world.json"))
    os.makedirs(OUT_DIR, exist_ok=True)
    corpus = os.path.join(OUT_DIR, "chip_smoke_corpus.jsonl")
    write_corpus_jsonl(world, corpus)
    texts, ids = load_corpus_jsonl(corpus)
    index = BM25Index.from_texts(texts, ids, engine="scan", device=dev)
    queries = [fact_query(f) for f in world.facts[:32]]
    qt, qw = index.encode_queries(queries)
    recs.append(_k2_case(
        "b_main_path_synth_index", index.term_ids, index.impacts,
        torch.from_numpy(np.ascontiguousarray(qt)).to(dev),
        torch.from_numpy(np.ascontiguousarray(qw)).to(dev), 5,
        index.valid_n))
    return recs


# ------------------------------------------------------------ phases 3-4
def _synth_cfg(tmp, world, entities, n_mal, seed, pos, **over):
    from sdag_tpu_torch.config import Config
    from sdag_tpu_torch.utils.synth_qa import (write_attack_csv,
                                               write_corpus_jsonl)
    os.makedirs(tmp, exist_ok=True)
    corpus, attack = os.path.join(tmp, "corpus.jsonl"), \
        os.path.join(tmp, "attack.csv")
    write_corpus_jsonl(world, corpus)
    facts = write_attack_csv(world, attack, entities, n_mal=n_mal, seed=seed)
    cfg = Config()
    cfg.SAMPLE_SIZE = len(facts)
    cfg.TOP_K = [5]
    cfg.ADD_ATTACK_IN_RANK = [pos]
    cfg.CSV_INPUT_PATH = attack
    cfg.CORPUS_JSONL_PATH = corpus
    cfg.RETRIEVER_BACKEND = "sparse"
    cfg.SPARSE_INDEX_NAME_OR_PATH = ""
    cfg.LLM_BATCH_SIZE = 8
    cfg.BATCH_SIZE_EMBED_Q = 32
    cfg.MAX_GEN_TOKENS_RAG = 24
    cfg.TEMPERATURE = 0.0
    cfg.OUTPUT_CSV_BASE = os.path.join(tmp, "out", "results")
    for key, val in over.items():
        setattr(cfg, key, val)
    return cfg, facts


def phase3(dev):
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    from sdag_tpu_torch.utils.synth_qa import load_world
    ckpt = os.path.join(REPO, "experiments", "data", "qa_ckpt")
    world = load_world(os.path.join(ckpt, "world.json"))
    base = os.path.join(OUT_DIR, "chip_smoke_phase3")
    LAUNCHES.clear()
    cfg, _ = _synth_cfg(os.path.join(base, "clean"), world,
                        world.eval_entities[:4], 1, world.seed + 1, 0,
                        LLM_CHECKPOINT=ckpt)
    m = run_experiment(cfg, device=dev)[(5, 0)]["answer_match_stats"]
    acc_iso = m["iso"]["ground_truth_match_rate"]
    acc_noiso = m["no_iso"]["ground_truth_match_rate"]
    cfg, _ = _synth_cfg(os.path.join(base, "attack"), world,
                        world.eval_entities[:4], 2, world.seed + 2, 1,
                        LLM_CHECKPOINT=ckpt, MAX_MALICIOUS_DOCS_PER_QUERY=2)
    m = run_experiment(cfg, device=dev)[(5, 1)]["answer_match_stats"]
    asr_iso = m["iso"]["false_answer_match_rate"]
    asr_noiso = m["no_iso"]["false_answer_match_rate"]
    rec = {"acc_iso": acc_iso, "acc_noiso": acc_noiso, "asr_iso": asr_iso,
           "asr_noiso": asr_noiso, "launches": dict(LAUNCHES)}
    log(f"[phase3] {json.dumps(rec)}")
    if not (acc_iso >= 0.5 and acc_noiso >= 0.5):
        raise AssertionError(f"phase 3: clean ACC below 0.5: {rec}")
    if not asr_iso + asr_noiso > 0.0:
        raise AssertionError(f"phase 3: attack never bit: {rec}")
    if not (LAUNCHES["sdag_prefill_f32"] and LAUNCHES["bm25_scan_topk"]):
        raise AssertionError(f"phase 3: a kernel never launched: {rec}")
    return rec


def phase4(dev):
    import torch
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.models.llama import prefill
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    from sdag_tpu_torch.pipeline.resources import init_resources
    from sdag_tpu_torch.utils.synth_qa import load_world
    world = load_world(os.path.join(REPO, "experiments", "data", "qa_ckpt",
                                    "world.json"))
    tmp = os.path.join(OUT_DIR, "chip_smoke_phase4")
    cfg, facts = _synth_cfg(tmp, world, world.eval_entities[:6], 1,
                            world.seed + 3, 1, LLM_ARCH="llama3-8b",
                            MAX_GEN_TOKENS_RAG=32, BM25_ENGINE="scan")
    n = len(facts)
    if n < 32:
        raise AssertionError(f"phase 4 needs >= 32 queries, got {n}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    res = init_resources(cfg, device=dev)
    t_init = time.perf_counter() - t0
    metrics = run_experiment(cfg, resources=res, device=dev)
    torch.cuda.synchronize(dev)
    t_run = time.perf_counter() - t0 - t_init
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)

    batches = sum(math.ceil(min(cfg.BATCH_SIZE_EMBED_Q, n - i)
                            / cfg.LLM_BATCH_SIZE)
                  for i in range(0, n, cfg.BATCH_SIZE_EMBED_Q))
    n_layers = res.generator.cfg.n_layers
    need_k1 = n_layers * 2 * batches
    base = cfg.OUTPUT_CSV_BASE + "_top_k=5_attacker_pos=1"
    written = all(os.path.isfile(base + ext) for ext in (".csv", ".json"))
    st = res.generator.stats
    ids = torch.tensor([[1, 2, 3] + [65] * 125], dtype=torch.int32,
                       device=dev)
    logits, _ = prefill(res.generator.params, res.generator.cfg, ids,
                        with_cache=False, logits_last_only=True)
    rec = {"queries": n, "n_layers": n_layers, "d_model":
           res.generator.cfg.d_model, "launches": launches,
           "k1_launches_needed": need_k1, "outputs_written": written,
           "init_s": t_init, "run_s": t_run,
           "prefill_tokens": st["prefill_tokens"],
           "prefill_s": st["prefill_s"],
           "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
           "decode_tokens": st["decode_tokens"], "decode_s": st["decode_s"],
           "decode_tok_s": st["decode_tokens"] / st["decode_s"],
           "peak_mem_gib": peak / 2 ** 30,
           "metrics": {"acc_iso": metrics[(5, 1)]["answer_match_stats"][
               "iso"]["ground_truth_match_rate"]},
           "logits_shape": list(logits.shape),
           "logits_finite": bool(torch.isfinite(logits).all())}
    log(f"[phase4] {json.dumps(rec)}")
    if launches.get("sdag_prefill_bf16", 0) < need_k1:
        raise AssertionError(
            f"phase 4: K1 launched {launches.get('sdag_prefill_bf16', 0)} "
            f"< {need_k1}")
    if launches.get("bm25_scan_topk", 0) < 1:
        raise AssertionError("phase 4: K2 never launched")
    if not written:
        raise AssertionError("phase 4: CSV/JSON outputs missing")
    if not rec["logits_finite"] or rec["logits_shape"] != [
            1, 1, res.generator.cfg.vocab_size]:
        raise AssertionError(f"phase 4: bad logits {rec['logits_shape']}")
    rec["profile"] = _profile_window(res.generator, dev)
    log(f"[phase4] profile {json.dumps(rec['profile'])}")
    del res
    return rec


def _profile_window(gen, dev, new_tokens=16):
    """torch.profiler over one NO-ISO batch (prefill + decode) after the
    counted run: device busy share of the wall time, device time by
    kernel.  Reports device time as null when the profiler sees none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    _plans, plain = _main_path_prompts(gen.batch_bucket or 8)
    gen.generate_ids(plain, max_new_tokens=2)            # warm
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen.generate_ids(plain, max_new_tokens=new_tokens)
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:   # operator rows repeat their
            continue                           # kernels' device time
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((e.key, dev_us, e.count))
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    return {"batch": len(plain), "new_tokens": new_tokens,
            "wall_ms": wall_us / 1e3,
            "device_ms": total / 1e3 if total else None,
            "device_busy_share": total / wall_us if total else None,
            "top": [{"name": k[:80], "ms": us / 1e3, "calls": n,
                     "share": us / total} for k, us, n in rows[:10]]}


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "sdag_tpu_torch")):
        print("chip_smoke: the sdag_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from sdag_tpu_torch import _build

    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    log(f"[phase0] card: {card}")
    log(f"[phase0] torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[phase0] kernels built in {time.perf_counter() - t0:.1f}s")
    for name in _build.KERNELS:
        path = os.path.join(_build.BUILD, f"{name}.log")
        if os.path.isfile(path):
            with open(path) as fh:
                for line in fh:
                    if "registers" in line or "spill" in line:
                        log(f"[phase0] {name}: {line.strip()}")

    details = {"card": card}
    details["phase1"] = k1 = phase1(dev)
    details["phase2"] = k2 = phase2(dev)
    details["phase3"] = p3 = phase3(dev)
    details["phase4"] = p4 = phase4(dev)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(details, fh, indent=1)

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    by_name = {r["name"]: r for r in k1 + k2}
    k2_main = by_name["b_main_path_synth_index"]
    # K1 has two bodies: bf16 (tensor cores) on the llama3-8b path of
    # phase 4, f32 (CUDA cores) on the qa_ckpt path of phase 3; each is
    # timed at its path's ISO shape and counted over its path's run
    kernels = [
        dict(name=f"sdag_prefill_{dt}", route="cuda",
             source="sdag_tpu_torch/csrc/sdag_prefill.cu",
             replaces="sdag_tpu/ops/attention.py:690",
             launches=run["launches"].get(f"sdag_prefill_{dt}", 0),
             max_abs_err=max(r["max_abs_err"] for r in k1
                             if r["dtype"] == dtype),
             **{key: by_name[case][key] for key in keys})
        for dt, dtype, case, run in (
            ("bf16", "bfloat16", "e_llama3_8b_iso", p4),
            ("f32", "float32", "g_qa_ckpt_iso", p3))]
    kernels += [
        dict(name="bm25_scan_topk", route="cuda",
             source="sdag_tpu_torch/csrc/bm25_scan_topk.cu",
             replaces="sdag_tpu/ops/bm25.py:150",
             launches=p4["launches"].get("bm25_scan_topk", 0),
             max_abs_err=max(r["max_abs_err"] for r in k2),
             **{key: k2_main[key] for key in keys}),
    ]
    log(f"[summary] phase 4 prefill {p4['prefill_tok_s']:.1f} tok/s, "
        f"decode {p4['decode_tok_s']:.1f} tok/s, peak "
        f"{p4['peak_mem_gib']:.2f} GiB on {card}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
