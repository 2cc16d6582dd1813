#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``sdag_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, one CUDA device

Phase 0  print the card (nvidia-smi name, power limit); build the kernels
         with nvcc, one process per source, all at once: K1
         (csrc/sdag_prefill.cu), K2 (csrc/bm25_scan_topk.cu), K3
         (csrc/encoder_attention.cu), K4/K5 (csrc/topk_matmul.cu), K6
         (csrc/int8_matmul.cu); print ptxas' registers and spill bytes per
         kernel body.
Phase 1  K1 against its plain PyTorch version (sdag_attention_reference) on
         the card: the L=4096 20-doc 2-NN layout, the same tensors fully
         causal, L=16384 with 31 docs, a Dh=32 f32 case with holes, 40 docs
         and a q_offset slice, the same layout in bf16 off the tile grid
         (Lk 1990, Lq 995, a batch row with valid_len 0), GQA groups of 1
         and 8 (the bf16 body shares K/V tiles between two q heads of a
         group), and the main paths' ISO/NO-ISO shapes over
         real synthetic-world prompts: llama3-8b heads in bf16 (the
         tensor-core body) and qa_ckpt's heads in f32 (the CUDA-core
         body).  Valid rows that see a key are compared: max abs error
         <= 2e-2 for bf16, <= 1e-4 for f32, and each row's max abs error
         over its RMS <= 5e-2 / 1e-3; at each ISO main-path shape a
         planted one-tile fault must fail these checks (also at the group
         of 8).  Times K1, the
         plain version, and F.scaled_dot_product_attention with the dense
         boolean mask.
Phase 2  K2 against its plain version: 1,048,576 docs x 64 Zipf term slots
         (2^18 vocab), 32 queries x 16 terms, k=10 and k=20, and 32 terms,
         k=64 (both buffer sizes), all timed; 5,000 docs with 33 queries
         (two query groups) and valid_n 4,321; one query at k=1; rows of
         50 slots (the 4-byte copy path); and the main path's index/query
         shapes.  Scores and indices must be bit-equal to the plain
         version's (ties in index order, (-inf, -1) tails).  No single
         PyTorch call computes the scan, so library_ms is null; torch.topk
         over precomputed scores (selection alone) is reported as
         topk_only_ms.
Phase 3  run_experiment on experiments/data/qa_ckpt (trained decoder):
         clean ACC iso/noiso >= 0.5, attacked ASR iso+noiso > 0.
Phase 4  the main path at full width: run_experiment with LLM_ARCH=llama3-8b
         (random bf16 weights, 32 layers), BM25_ENGINE=scan, 36 queries;
         launch counts are zeroed before and read after, and both kernels
         must have launched (K1 at least 32 layers x ISO+NO-ISO batches).
         Phase 3 counts its own run the same way.  Decode runs as
         captured CUDA graphs (at least one capture, or it fails):
         reports decode tok/s, ms a step, captures and their seconds,
         peak memory, and the device busy share of a profiled NO-ISO
         batch (prefill + 16 steps); one NO-ISO batch decoded through the
         graphs and through the same steps run eagerly must give equal
         tokens, greedy and sampled (Config TEMPERATURE/TOP_P, one seed);
         the decode attention at the 8B shape (its bf16 scores contracted
         with f32 out) against its f32-copy form: scores within 1e-5 of
         the largest score, outputs within 2e-2.
Phase 5  K3 against its plain version (encoder_attention_qkv_reference):
         e5-large-v2 heads (H=16, Dh=64) in bf16 at (B=64, L=256) and
         (B=32, L=512) with ragged valid_len including L, 1 and 0; tiny
         heads (H=4, Dh=32) in f32 at L=64; the f32 (split-TF32) body at
         e5-large-v2's heads, (B=64, L=256) and (B=32, L=512), timed,
         with the planted faults at L=512; lengths off the tile grid
         (L 72/100/200) and Dh=128; bf16 Dh=128 at (B=4, L=512), whose
         K/V tiles do not fit the ring and stream through it, and one
         sequence of 512; and the ranker path's own batch (32 passages of
         the synthetic world through the byte tokenizer) in bf16 and f32.
         All rows are compared with K1's limits.  Two planted faults (one
         key tile dropped; the mask off by one column) must fail the check.
         Times K3, the plain version, and scaled_dot_product_attention
         with its split + transposes; f32 cases also get their bound at
         the split-TF32 rate (495 / 3 TFLOP/s).
Phase 6  K4 and K5 against their plain versions (exact_topk,
         exact_topk_int8): 1,048,576 x 1024 normalised rows in bf16 and
         int8, Q=256 and Q=32, k=10 and k=64, valid_n = N and N - 1000;
         f32 at N=131,072 (Q=256 k=10, Q=32 k=64); duplicated rows that
         must come back in index
         order (also 150 copies against k=128 at Q=129, and k=1 at Q=1);
         k > valid_n; shapes off the tile grid (D 48/80/128/1040,
         Q 1/130, N 50 and 100, k 128); K5's query quantiser kernel
         against its plain rule, bit for bit; the plain-PyTorch "approx" searches on the
         card against the CPU and the kernels; and the ranker path's shape
         in all three dtypes.  K4: scores
         within 1e-5 relative (+1e-6), indices equal wherever the plain
         scores differ by more than that.  K5: bit-equal, indices included.
         Times each against torch.matmul (torch._int_mm for int8) +
         torch.topk; K5's time and its library time both include the
         query quantiser.
Phase 7  the ranker path at full width through run_experiment, counts
         zeroed before each run and read after: (a) qa_ckpt_v4 with
         DOC_NEIGHBORS_K=2, sparse retrieval, clean, RANKER_ARCH
         e5-large-v2 (24 layers, d 1024, bf16, random weights): ACC iso
         >= 0.8, K3 launched 24 x encode batches, K1 and K2 launched;
         (b) the same world attacked at rank 1 with hybrid retrieval,
         DENSE_SEARCH_MODE=exact, closest_to_centroid selection, once with
         a bfloat16, once with an int8 and once with a float32 (the
         default) dense index: K3, the K4 body of the index' dtype resp.
         K5, K2 and K1 launched, outputs written, the first batch's dense
         hits equal to the plain version's on the same query embeddings;
         (c) e5-large-v2's geometry at float32 (random weights) encoding
         the phase-7 corpus through E5Encoder: K3's f32 body launched
         layers x batches, the first batch's embeddings within 1e-4 of
         the unfused plain attention's.

Phase 8  int8 weights, the int8 KV cache and speculative decoding: (a) K6
         against int8_matmul_reference at every weight product of the 8B
         decode step (M = 8, a step's batch, and M = 40, a verification
         window of 8 x 5) in bf16 and of qa_ckpt's (d 192, tied unembed)
         in f32: each row's max abs error <= 1e-2 (bf16) / 1e-5 (f32) of
         its max |y|; one output column's scale doubled and one 64-wide
         `in` chunk skipped must fail that check; device times of K6, the
         plain version and the bf16 (f32) torch.matmul it replaces
         (torch._weight_int8pack_mm beside it where this torch has it for
         CUDA), summed over a step's products; (b) run_experiment on the
         8B path with LLM_WEIGHTS_DTYPE and KV_CACHE_DTYPE int8 and
         SPECULATIVE_DRAFT_LEN=4, 36 queries, 32 new tokens, counts
         zeroed before: K1, K2 and K6's bf16 body launched; decode tok/s,
         ms a round, rounds, accepted drafts a round, captures, peak
         memory, busy share of a profiled window; (c) on one NO-ISO batch
         and that int8 tree and cache: graph equals eager, greedy and
         sampled, for plain decode and for speculative rounds, and greedy
         speculative tokens equal greedy plain tokens; (d) decode tok/s of
         one 8 x 32 batch in native, int8-weight, + int8 cache and +
         speculation configurations; (e) qa_ckpt with int8 weights and
         speculation (K6's f32 body): clean ACC iso >= 0.5, accepted
         drafts a round.

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
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
TF32_FLOPS = 495e12
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


def _mangled_function_name(mangled: str) -> str:
    """The function's own name out of an Itanium-mangled symbol: the last of
    the length-prefixed names that open it (_ZN 47_GLOBAL__N_... 15topk_...)."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        end = pos
        while mangled[end].isdigit():
            end += 1
        n = int(mangled[pos:end])
        name = mangled[end:end + n]
        pos = end + n
    return name


def ptxas_report(build) -> list:
    """Registers and spill bytes per kernel body from nvcc's -Xptxas=-v
    output in build/<name>.log: the largest over a body's template
    instantiations."""
    import re
    bodies = {}
    for name in build.KERNELS:
        path = os.path.join(build.BUILD, f"{name}.log")
        if not os.path.isfile(path):
            continue
        with open(path) as fh:
            text = fh.read()
        for entry in re.split(r"Compiling entry function '", text)[1:]:
            mangled = entry.split("'", 1)[0]
            body = _mangled_function_name(mangled)
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", entry)
            rec = bodies.setdefault((name, body), {
                "source": f"{name}.cu", "body": body, "instantiations": 0,
                "max_registers": 0, "max_spill_store_bytes": 0,
                "max_spill_load_bytes": 0})
            rec["instantiations"] += 1
            if regs:
                rec["max_registers"] = max(rec["max_registers"],
                                           int(regs.group(1)))
            if spill:
                rec["max_spill_store_bytes"] = max(
                    rec["max_spill_store_bytes"], int(spill.group(1)))
                rec["max_spill_load_bytes"] = max(
                    rec["max_spill_load_bytes"], int(spill.group(2)))
    return list(bodies.values())


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
           "all_tiles": int(plan["kinds"].numel()),
           "tiles_full_partial_causal": [
               int((plan["kinds"] == kind).sum())
               for kind in (A.BLOCK_FULL, A.BLOCK_PARTIAL, A.BLOCK_CAUSAL)],
           "live_tiles_per_q_tile": A.live_tile_stats(plan["counts"]),
           "visible_pairs": pairs}
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
    # (i): the same layout in bf16 (the wgmma body) off the tile grid: Lk
    # and Lq no multiples of 64, q rows = the second half, one batch row
    # with valid_len 0 (every row of it sees no key and outputs 0)
    Lk, Lq = 1990, 995
    kq = rnd(B, 4, Lk, 128, dtype=torch.bfloat16)
    k = rnd(B, 2, Lk, 128, dtype=torch.bfloat16)
    v = rnd(B, 2, Lk, 128, dtype=torch.bfloat16)
    q = kq[:, :, Lk - Lq:].contiguous()
    recs.append(_k1_case("i_bf16_holes_qoffset_ragged_vl0", q, k, v,
                         t32(did[:, :Lk]), t32(nbr[:, :Lk]), t32([96, 96]),
                         t32([Lk - 37, 0]), q_offset=t32([Lk - Lq] * B),
                         doc_id_q=t32(did[:, Lk - Lq:Lk]),
                         nbr_q=t32(nbr[:, Lk - Lq:Lk])))
    # (j), (k): GQA groups of 1 (one warpgroup a block) and 8 (four pairs
    # per kv head) at Dh 64 and 32, lengths off the tile grid
    for name, hq, hkv, dh, L in (("j_bf16_group1_Dh64_L333", 4, 4, 64, 333),
                                 ("k_bf16_group8_Dh32_L520", 8, 1, 32, 520)):
        q = rnd(B, hq, L, dh, dtype=torch.bfloat16)
        k = rnd(B, hkv, L, dh, dtype=torch.bfloat16)
        v = rnd(B, hkv, L, dh, dtype=torch.bfloat16)
        recs.append(_k1_case(name, q, k, v, t32(did[:, :L]), t32(nbr[:, :L]),
                             t32([96, 96]), t32([L - 7, L - 100]),
                             plant_fault=hq // hkv == 8))
    del kq, q, k, v
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
    # the kernel repeats the plain version's float operations in its order
    if not (torch.equal(vk, vp) and torch.equal(ik, ip)):
        raise AssertionError(f"K2 {name}: not bit-equal to the plain "
                             "version")
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
            library_ms=None,   # no single PyTorch call computes the scan
            topk_only_ms=cuda_ms(lambda: torch.topk(scores, k, dim=1)),
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
    # both candidate-buffer sizes (k <= 32 and k > 32), 16 and 32 terms
    recs.append(_k2_case("a_N1M_k20", term_ids, impacts, q_terms,
                         q_weights, 20, N))
    q32 = _dedup_rows(_zipf_ids(g, (Q, 32), V, 1.07, dev)).contiguous()
    w32 = torch.where(q32 >= 0, 1.0, 0.0).contiguous()
    recs.append(_k2_case("a_N1M_T32_k64", term_ids, impacts, q32, w32, 64,
                         N))
    # two query groups with valid_n inside the index; a single query at
    # k = 1; rows of 50 slots, whose chunks are not 16-byte aligned
    q33 = _dedup_rows(_zipf_ids(g, (33, T), V, 1.07, dev)).contiguous()
    w33 = torch.where(q33 >= 0, 1.0 + (torch.rand(
        (33, T), generator=g, device=dev) > 0.8).float(), 0.0).contiguous()
    small_t = term_ids[:5000].contiguous()
    small_i = impacts[:5000].contiguous()
    recs.append(_k2_case("c_Q33_N5000_valid4321", small_t, small_i, q33, w33,
                         10, 4321, timed=False))
    recs.append(_k2_case("c_Q1_k1", small_t, small_i, q33[:1].contiguous(),
                         w33[:1].contiguous(), 1, 5000, timed=False))
    recs.append(_k2_case("c_Lp50_unaligned", small_t[:, :50].contiguous(),
                         small_i[:, :50].contiguous(), q_terms, q_weights, 10,
                         5000, timed=False))
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
           "decode_steps": st["decode_steps"],
           "decode_chunks": st["decode_chunks"],
           "decode_ms_per_step": 1e3 * st["decode_s"] / st["decode_steps"],
           "graph_captures": st["graph_captures"],
           "capture_s": st["capture_s"],
           "live_decode_shapes": len(res.generator._live),
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
    if st["graph_captures"] < 1:
        raise AssertionError("phase 4: decode captured no CUDA graph")
    rec["profile"] = _profile_window(res.generator, dev)
    log(f"[phase4] profile {json.dumps(rec['profile'])}")
    rec["graph_vs_eager"], _ = _decode_graph_vs_eager(res.generator, dev)
    log(f"[phase4] graph vs eager {json.dumps(rec['graph_vs_eager'])}")
    rec["decode_attention"] = _decode_attention_check(res.generator.cfg,
                                                      dev)
    log(f"[phase4] decode attention {json.dumps(rec['decode_attention'])}")
    del res
    return rec


def _decode_attention_check(cfg, dev, batch=8, slots=672):
    """The decode attention at the 8B decode shape (bf16 cache, a quarter
    of its slots masked), against its earlier form that copied the cache
    to f32 before the score product: scores within 1e-5 of the largest
    score's magnitude (f32 sums in another order; the bf16 products are
    exact), outputs within the bf16 limit."""
    import torch
    from sdag_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    hd, hkv = cfg.head_dim, cfg.n_kv_heads

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(cfg.dtype)
    q = rnd(batch, cfg.n_heads, hd)
    k, v = rnd(batch, hkv, slots, hd), rnd(batch, hkv, slots, hd)
    mask = torch.rand(batch, slots, generator=g, device=dev) < 0.75
    mask[:, 0] = True

    def f32_copy_scores():
        qg = q.reshape(batch, hkv, cfg.n_heads // hkv, hd).float()
        return (qg @ k.float().transpose(-1, -2)) * hd ** -0.5

    def f32_copy_attention():
        s = torch.where(mask[:, None, None, :], f32_copy_scores(),
                        A.DEFAULT_MASK_VALUE)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return (p @ v).reshape(batch, cfg.n_heads, hd)
    ref = f32_copy_scores()
    s_err = float((A.decode_scores(q, k) - ref).abs().max())
    o_err = float((A.masked_decode_attention(q, k, v, mask).float()
                   - f32_copy_attention().float()).abs().max())
    rec = {"shape": [batch, cfg.n_heads, hkv, slots, hd],
           "dtype": str(cfg.dtype), "scores_max_abs_err": s_err,
           "scores_max_abs": float(ref.abs().max()),
           "scores_tol": 1e-5 * float(ref.abs().max()),
           "out_max_abs_err": o_err, "out_tol": BF16_TOL,
           "ms": cuda_ms(lambda: A.masked_decode_attention(q, k, v, mask),
                         iters=50),
           "f32_copy_ms": cuda_ms(f32_copy_attention, iters=50)}
    if not (s_err <= rec["scores_tol"] and o_err <= BF16_TOL):
        raise AssertionError(f"phase 4: decode attention differs from its "
                             f"f32-copy form: {rec}")
    return rec


def _no_iso_batch(gen, dev):
    """The main path's 8 NO-ISO prompts as _generate's device arguments."""
    import numpy as np
    import torch
    _plans, plain = _main_path_prompts(gen.batch_bucket or 8)
    lp = gen._pad_len(max(len(x) for x in plain))
    b = len(plain)
    ids = np.full((b, lp), gen.tokenizer.pad_token_id, np.int32)
    for i, x in enumerate(plain):
        ids[i, :len(x)] = x
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return (t(ids), t(np.full((b, lp), -1, np.int32)),
            t(np.zeros((b, lp), np.int32)), t(np.zeros(b, np.int32)),
            t(np.asarray([len(x) for x in plain], np.int32)))


def _decode_graph_vs_eager(gen, dev, new_tokens=32, tag="phase 4", **kw):
    """One NO-ISO batch of the main path decoded through the captured
    graphs and through the same steps run eagerly: greedy tokens and
    lengths equal; then sampled at the Config's TEMPERATURE and TOP_P by
    two generators seeded alike, one on graphs, one eager: equal too.
    ``kw``: the Generator settings of the sampled engines (int8 cache,
    speculation), ``gen``'s own for the greedy one.  Returns the record
    and the greedy tokens and lengths."""
    import torch
    from sdag_tpu_torch.config import Config
    from sdag_tpu_torch.sdag.generate import Generator
    args = _no_iso_batch(gen, dev)
    cfg = Config()
    rec = {"batch": int(args[0].shape[0]), "new_tokens": new_tokens,
           "temperature": cfg.TEMPERATURE, "top_p": cfg.TOP_P}
    greedy = None
    for name, engine in (
            ("greedy", lambda: gen),
            ("sampled", lambda: Generator(
                gen.params, gen.cfg, gen.tokenizer,
                temperature=cfg.TEMPERATURE, top_p=cfg.TOP_P, seed=1234,
                batch_bucket=gen.batch_bucket, device=dev, **kw))):
        runs = {}
        for graphs in (True, False):
            eng = engine()
            out, lengths = eng._generate(*args, new_tokens, graphs=graphs)
            runs[graphs] = (out.cpu(), lengths.cpu())
            if graphs and not eng._live[next(reversed(eng._live))].graphs:
                raise AssertionError(f"{tag} {name}: no graph replayed")
        equal = torch.equal(runs[True][0], runs[False][0]) and \
            torch.equal(runs[True][1], runs[False][1])
        rec[name] = {"equal": equal,
                     "lengths": runs[True][1].tolist(),
                     "tokens_differing": int((runs[True][0]
                                              != runs[False][0]).sum())}
        if not equal:
            raise AssertionError(f"{tag}: {name} tokens of the captured "
                                 f"graphs differ from the eager steps: "
                                 f"{rec[name]}")
        if name == "greedy":
            greedy = runs[True]
    torch.cuda.empty_cache()
    return rec, greedy


def _profile_window(gen, dev, new_tokens=16):
    """torch.profiler over one NO-ISO batch (prefill + decode) after the
    counted run: device busy share of the wall time, device time by
    kernel.  Reports device time as null when the profiler sees none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    _plans, plain = _main_path_prompts(gen.batch_bucket or 8)
    gen.generate_ids(plain, max_new_tokens=new_tokens)   # warm: captures
    torch.cuda.synchronize(dev)
    captures = gen.stats["graph_captures"]
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
            "graph_captures_in_window": gen.stats["graph_captures"]
            - captures,
            "wall_ms": wall_us / 1e3,
            "device_ms": total / 1e3 if total else None,
            "device_busy_share": total / wall_us if total else None,
            "top": [{"name": k[:80], "ms": us / 1e3, "calls": n,
                     "share": us / total} for k, us, n in rows[:10]]}


# ---------------------------------------------------------------- phase 5
def _k3_errors(out_k, out_p, n_heads):
    """Over all (batch, row, head): the max abs error, and the max of a
    head row's max abs error over that row's RMS in the plain output."""
    B, L, d = out_p.shape
    ref = out_p.float().reshape(B, L, n_heads, d // n_heads)
    got = out_k.float().reshape(B, L, n_heads, d // n_heads)
    row_max = (got - ref).abs().amax(-1)
    rms = ref.pow(2).mean(-1).sqrt().clamp_min(1e-30)
    return float(row_max.max()), float((row_max / rms).max())


def _k3_case(name, qkv, vl, n_heads, timed=False, plant_fault=False):
    import torch
    from sdag_tpu_torch.ops import encoder_attention as E
    B, L, d3 = qkv.shape
    d = d3 // 3
    dh = d // n_heads
    out_k = E.encoder_attention_fused_qkv(qkv, vl, n_heads)
    torch.cuda.synchronize()
    out_p = E.encoder_attention_qkv_reference(qkv, vl, n_heads)
    err, row_err = _k3_errors(out_k, out_p, n_heads)
    finite = bool(torch.isfinite(out_k.float()).all())
    dtype = "bfloat16" if qkv.dtype == torch.bfloat16 else "float32"
    tol, row_tol = (BF16_TOL, BF16_ROW_TOL) if dtype == "bfloat16" \
        else (F32_TOL, F32_ROW_TOL)
    rec = {"name": name, "B": B, "L": L, "H": n_heads, "Dh": dh,
           "dtype": dtype, "valid_len_min": int(vl.min()),
           "valid_len_max": int(vl.max()), "max_abs_err": err, "tol": tol,
           "max_row_rel_err": row_err, "row_tol": row_tol}
    if not finite or not err <= tol or not row_err <= row_tol:
        raise AssertionError(f"K3 {name}: max abs err {err} (limit {tol}), "
                             f"row-relative {row_err} (limit {row_tol}), "
                             f"finite={finite}")
    if plant_fault:
        # the kernel run on a wrong valid_len against the plain version on
        # the right one: a dropped key tile, then a mask off by one column
        for fault, bad in (("dropped_tile", torch.where(vl > 64, vl - 64, vl)),
                           ("mask_off_by_one",
                            torch.where((vl > 0) & (vl < L), vl + 1, vl))):
            if bool((bad == vl).all()):
                raise AssertionError(f"K3 {name}: no row to plant {fault}")
            out_f = E.encoder_attention_cuda(qkv, bad, n_heads)
            f_err, f_row = _k3_errors(out_f, out_p, n_heads)
            if f_err <= tol and f_row <= row_tol:
                raise AssertionError(
                    f"K3 checks missed the planted fault {fault}: abs "
                    f"{f_err}, row-relative {f_row}")
            rec[f"fault_{fault}"] = {"max_abs_err": f_err,
                                     "max_row_rel_err": f_row}
    if timed:
        # every q row and output row once, the k/v rows the softmax can
        # see (all L when valid_len == 0), valid_len once
        live = torch.where(vl > 0, vl.clamp(max=L), L)
        kv_rows = int(live.sum())
        es = qkv.element_size()
        nbytes = (2 * B * L + 2 * kv_rows) * d * es + 4 * B
        flops = 4.0 * L * kv_rows * dh * n_heads
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / H100_BYTES_PER_S
        key_ok = (torch.arange(L, device=qkv.device)[None, :]
                  < live[:, None])[:, None, None, :]

        def sdpa():
            q, k, v = (t.reshape(B, L, n_heads, dh).transpose(1, 2)
                       for t in qkv.split(d, dim=-1))
            o = torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=key_ok)
            return o.transpose(1, 2).reshape(B, L, d)
        if dtype == "float32":
            # the f32 body runs split TF32: three TF32 products for one
            rec["bound_tf32x3_ms"] = max(
                flops / (TF32_FLOPS / 3), t_bytes) * 1e3
        rec.update(
            ms=cuda_ms(lambda: E.encoder_attention_cuda(qkv, vl, n_heads)),
            plain_ms=cuda_ms(lambda: E.encoder_attention_qkv_reference(
                qkv, vl, n_heads), iters=3, warmup=1),
            library_ms=cuda_ms(sdpa, iters=5, warmup=1),
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"[phase5] {json.dumps(rec)}")
    return rec


def _ranker_path_passages(n=32):
    """The first encode batch of the ranker path: the synthetic world's
    first n corpus docs under the E5 passage prefix, byte tokenizer."""
    from sdag_tpu_torch.models.e5 import E5Encoder, EncoderConfig
    from sdag_tpu_torch.models.tokenizer import load_tokenizer
    from sdag_tpu_torch.pipeline.resources import load_corpus_jsonl
    from sdag_tpu_torch.utils.synth_qa import load_world, write_corpus_jsonl
    world = load_world(os.path.join(REPO, "experiments", "data", "qa_ckpt_v4",
                                    "world.json"))
    os.makedirs(OUT_DIR, exist_ok=True)
    corpus = os.path.join(OUT_DIR, "chip_smoke_corpus_v4.jsonl")
    write_corpus_jsonl(world, corpus)
    texts, _ids = load_corpus_jsonl(corpus)
    enc = E5Encoder({"layers": []}, EncoderConfig.e5_large_v2(),
                    load_tokenizer(""), model_name="intfloat/e5-large-v2",
                    device="cpu")
    _ids_np, mask = enc._tokenize(enc._prefix(texts[:n], "passage"))
    return mask.shape[1], mask.sum(1)


def phase5(dev):
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    recs = []

    def qkv_of(B, L, H, Dh, dtype):
        return torch.randn(B, L, 3 * H * Dh, generator=g, device=dev,
                           dtype=torch.float32).to(dtype)

    def ragged(B, L):
        vl = torch.randint(2, L, (B,), generator=g, device=dev,
                           dtype=torch.int32)
        vl[0], vl[1], vl[2] = L, 1, 0
        return vl

    for name, B, L in (("a_e5_large_B64_L256", 64, 256),
                       ("b_e5_large_B32_L512", 32, 512)):
        recs.append(_k3_case(name, qkv_of(B, L, 16, 64, torch.bfloat16),
                             ragged(B, L), 16, timed=True, plant_fault=True))
    recs.append(_k3_case("c_tiny_f32_L64",
                         qkv_of(8, 64, 4, 32, torch.float32),
                         ragged(8, 64), 4, timed=True, plant_fault=False))
    # the f32 body at e5-large-v2's heads (a converted checkpoint loads at
    # f32)
    for name, B, L in (("h_e5_large_f32_B64_L256", 64, 256),
                       ("h_e5_large_f32_B32_L512", 32, 512)):
        recs.append(_k3_case(name, qkv_of(B, L, 16, 64, torch.float32),
                             ragged(B, L), 16, timed=True,
                             plant_fault=L == 512))
    recs.append(_k3_case("d_e5_large_f32_L128",
                         qkv_of(4, 128, 16, 64, torch.float32),
                         ragged(4, 128), 16, plant_fault=True))
    recs.append(_k3_case("e_tiny_bf16_Dh32_L100",
                         qkv_of(4, 100, 4, 32, torch.bfloat16),
                         ragged(4, 100), 4))
    recs.append(_k3_case("e_Dh128_bf16_L72_B3",
                         qkv_of(3, 72, 2, 128, torch.bfloat16),
                         ragged(3, 72), 2))
    recs.append(_k3_case("e_Dh128_f32_L200_B3",
                         qkv_of(3, 200, 2, 128, torch.float32),
                         ragged(3, 200), 2, timed=True))
    # Dh = 128 at L = 512: the K/V tiles stream through the ring
    recs.append(_k3_case("g_Dh128_bf16_B4_L512_streaming",
                         qkv_of(4, 512, 8, 128, torch.bfloat16),
                         ragged(4, 512), 8, plant_fault=True))
    recs.append(_k3_case("g_e5_large_bf16_B1_L512",
                         qkv_of(1, 512, 16, 64, torch.bfloat16),
                         torch.tensor([333], dtype=torch.int32, device=dev),
                         16))
    L, lens = _ranker_path_passages(32)
    for name, dtype in (("f_ranker_path_batch", torch.bfloat16),
                        ("f_ranker_path_batch_f32", torch.float32)):
        recs.append(_k3_case(
            name, qkv_of(len(lens), L, 16, 64, dtype),
            torch.as_tensor(lens, dtype=torch.int32, device=dev), 16,
            timed=True))
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------- phase 6
K4_RTOL, K4_ATOL = 1e-5, 1e-6


def _k4_case(name, queries, corpus, k, valid_n, scales=None, timed=True,
             expect_first=None):
    """K4 (scales None) or K5 against the plain version on the same
    inputs.  queries float32 [Q, D]; corpus bf16/f32/int8 [N, D]."""
    import torch
    from sdag_tpu_torch.ops import topk as T
    N, D = corpus.shape
    Q = queries.shape[0]
    int8 = scales is not None
    if int8:
        run_k = lambda: T.fused_topk_matmul_int8(  # noqa: E731
            queries, corpus, scales, k, valid_n=valid_n)
        run_p = lambda: T.exact_topk_int8(  # noqa: E731
            queries, corpus, scales, k, valid_n=valid_n)
        q_i8, q_scales = T.quantize_last_axis_int8(queries)
        scores = T._int8_scores(q_i8, q_scales, corpus, scales)
    else:
        qc = queries.to(corpus.dtype)
        run_k = lambda: T.fused_topk_matmul(  # noqa: E731
            queries, corpus, k, valid_n=valid_n)
        run_p = lambda: T.exact_topk(qc, corpus, k,  # noqa: E731
                                     valid_n=valid_n)
        scores = T._float_scores(qc, corpus)
    scores = T._mask_rows(scores, valid_n)
    vk, ik = run_k()
    torch.cuda.synchronize()
    vp, ip = T.ordered_topk(scores, k)
    both_inf = torch.isneginf(vk) & torch.isneginf(vp)
    mism = ik != ip
    if int8:
        if not (torch.equal(vk, vp) and torch.equal(ik, ip)):
            raise AssertionError(
                f"K5 {name}: not bit-equal to the plain version "
                f"({int(mism.sum())} index, {int((vk != vp).sum())} score "
                "mismatches)")
    else:
        ok_v = torch.isclose(vk, vp, rtol=K4_RTOL, atol=K4_ATOL) | both_inf
        if not bool(ok_v.all()):
            raise AssertionError(f"K4 {name}: scores differ beyond "
                                 f"{K4_RTOL} rel + {K4_ATOL}")
        if bool(mism.any()):
            # a differing index must hold a plain score tied with the rank's
            got = torch.gather(scores, 1, ik.clamp(min=0).long())
            tie = torch.isclose(got, vp, rtol=K4_RTOL, atol=K4_ATOL) \
                & (ik >= 0)
            if not bool((tie | ~mism).all()):
                raise AssertionError(f"K4 {name}: indices differ at scores "
                                     "further apart than the tolerance")
    if expect_first is not None:
        n = len(expect_first)
        if ik[0, :n].tolist() != list(expect_first):
            raise AssertionError(f"{name}: ties not in index order: "
                                 f"{ik[0, :n].tolist()}")
    if valid_n < k:
        if not (bool((ik[:, valid_n:] == -1).all())
                and bool(torch.isneginf(vk[:, valid_n:]).all())):
            raise AssertionError(f"{name}: tail past valid_n is not "
                                 "(-inf, -1)")
    dtype = {torch.bfloat16: "bfloat16", torch.float32: "float32",
             torch.int8: "int8"}[corpus.dtype]
    err = float(torch.where(torch.isfinite(vp), (vk - vp).abs(),
                            torch.zeros_like(vp)).max())
    rec = {"name": name, "N": N, "D": D, "Q": Q, "k": k, "valid_n": valid_n,
           "dtype": dtype, "max_abs_err": err,
           "index_mismatches": int(mism.sum())}
    del scores
    if timed:
        # the valid corpus rows (and their scales), the queries and the
        # [Q, k] result once each; one multiply-add per (query, valid row,
        # feature)
        es = corpus.element_size()
        nbytes = valid_n * D * es + Q * D * es + Q * k * 8 \
            + (4 * (valid_n + Q) if int8 else 0)
        t_bytes = nbytes / H100_BYTES_PER_S
        t_ops = 2.0 * Q * valid_n * D / PEAK_FLOPS[dtype]
        if int8:
            # like for like: run_k quantises the queries (K5's prologue
            # kernel), so the library pair does too (plain PyTorch ops)
            def lib():
                qi, qs = T.quantize_last_axis_int8(queries)
                acc = torch._int_mm(qi, corpus.t())
                s = (acc.float() * qs[:, None]) * scales[None, :]
                return torch.topk(s, k, dim=1)
        else:
            lib = lambda: torch.topk(torch.matmul(qc, corpus.t()),  # noqa
                                     k, dim=1)
        if int8 and Q <= 16:
            library_ms = None            # torch._int_mm needs > 16 rows
        else:
            library_ms = cuda_ms(lib, iters=3, warmup=1)
        rec.update(ms=cuda_ms(run_k, iters=5, warmup=1),
                   plain_ms=cuda_ms(run_p, iters=2, warmup=1),
                   library_ms=library_ms,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
    log(f"[phase6] {json.dumps(rec)}")
    return rec


def _plain_search_modes(g, dev, n=20000, d=256, q=16, k=10):
    import torch
    from sdag_tpu_torch.retrieval.dense import DenseIndex
    emb = _normalised_rows(g, n, d, dev).cpu().numpy()
    qs = _normalised_rows(g, q, d, dev).cpu().numpy()
    meta = [{"id": str(i)} for i in range(n)]
    out = {"name": "h_plain_search_modes", "N": n, "D": d, "Q": q, "k": k,
           "dtype": "mixed", "max_abs_err": 0.0, "index_mismatches": 0}
    for dtype, rescore in ((torch.float32, True), (torch.bfloat16, True),
                           (torch.int8, True), (torch.int8, False)):
        kw = dict(dtype=dtype, int8_rescore=rescore)
        on_card = DenseIndex(emb, meta, search_mode="approx", device=dev,
                             **kw).search(qs, k)
        on_cpu = DenseIndex(emb, meta, search_mode="approx", device="cpu",
                            **kw).search(qs, k)
        kernel = DenseIndex(emb, meta, search_mode="exact", device=dev,
                            **kw).search(qs, k)
        tag = f"{dtype}".split(".")[-1] + ("" if rescore else "_norescore")
        # float scores agree within 1e-5 (indices may swap at near-ties
        # and are only counted); the bare int8 search is integer-exact, so
        # scores and indices are equal.  A rescored int8 search ranks by
        # other scores than the exact int8 kernel: only the devices are
        # compared.
        exact = dtype == torch.int8 and not rescore
        pairs = [("cpu", on_cpu)]
        if not (dtype == torch.int8 and rescore):
            pairs.append(("kernel", kernel))
        for what, (idx, sc) in pairs:
            bad = int((idx != on_card[0]).sum())
            err = float(abs(sc - on_card[1]).max())
            out[f"{tag}_vs_{what}"] = {"index_mismatches": bad,
                                       "max_abs_err": err}
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out["index_mismatches"] += bad
            if err > (0.0 if exact else 1e-5) or (exact and bad):
                raise AssertionError(
                    f"plain search {tag} on the card differs from {what}: "
                    f"{bad} indices, max score difference {err}")
    log(f"[phase6] {json.dumps(out)}")
    return out


def _normalised_rows(g, n, d, dev, chunk=1 << 17):
    import torch
    out = torch.empty(n, d, dtype=torch.float32, device=dev)
    for s in range(0, n, chunk):
        x = torch.randn(min(chunk, n - s), d, generator=g, device=dev)
        out[s:s + chunk] = x / x.norm(dim=1, keepdim=True)
    return out


def phase6(dev):
    import torch
    from sdag_tpu_torch.ops import topk as T
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    recs = []
    N, D = 1 << 20, 1024
    c32 = _normalised_rows(g, N, D, dev)
    q256 = _normalised_rows(g, 256, D, dev)
    q32 = q256[:32].contiguous()
    cb = c32.to(torch.bfloat16)
    ci, cs = T.quantize_last_axis_int8(c32)
    del c32
    torch.cuda.empty_cache()
    grid = (("Q256_k10", q256, 10, N), ("Q256_k64_ragged", q256, 64,
                                        N - 1000),
            ("Q32_k10_ragged", q32, 10, N - 1000), ("Q32_k64", q32, 64, N))
    for tag, q, k, vn in grid:
        recs.append(_k4_case(f"a_bf16_N1M_{tag}", q, cb, k, vn))
    for tag, q, k, vn in grid:
        recs.append(_k4_case(f"b_int8_N1M_{tag}", q, ci, k, vn, scales=cs))
    # f32 on CUDA cores, N = 131,072
    nf = 1 << 17
    cf = cb[:nf].float().contiguous()
    recs.append(_k4_case("c_f32_N128K_Q256_k10", q256, cf, 10, nf))
    recs.append(_k4_case("c_f32_N128K_Q32_k64_ragged", q32, cf, 64,
                         nf - 1000))
    # planted exact ties: 20 copies of query 0's best row, far apart; they
    # must come back first, in index order, from every body
    dup = [7 + 6151 * i for i in range(20)]
    qt = q32.clone()
    for name, corpus, sc in (("bf16", cb[:nf].clone(), None),
                             ("f32", cf, None),
                             ("int8", ci[:nf].clone(), cs[:nf].clone())):
        qt[0] = corpus[dup[0]].float() * (sc[dup[0]] if sc is not None
                                          else 1.0)
        corpus[dup] = corpus[dup[0]].clone()
        if sc is not None:
            sc[dup] = sc[dup[0]].clone()
        recs.append(_k4_case(f"d_ties_{name}", qt, corpus, 32, nf, scales=sc,
                             timed=False, expect_first=dup))
        # k past the valid rows: the tail is (-inf, -1)
        recs.append(_k4_case(f"e_k_gt_valid_{name}", q32, corpus, 10, 5,
                             scales=sc, timed=False))
    del cf
    # the candidate buffers at their limits: 150 copies of query 0's best
    # row against k = 128 (the list fills with ties, in index order) at
    # Q = 129 (one row past a 128-row query tile); k = 1 at Q = 1; a
    # corpus shorter than one 128-row tile
    gd = torch.Generator(device=dev)
    gd.manual_seed(67)
    nd, dd = 5000, 256
    base = _normalised_rows(gd, nd, dd, dev)
    qd = _normalised_rows(gd, 129, dd, dev)
    dup = [3 + 33 * i for i in range(150)]
    for name, corpus, sc in (("bf16", base.to(torch.bfloat16), None),
                             ("f32", base.clone(), None),
                             ("int8",) + T.quantize_last_axis_int8(base)):
        qd[0] = corpus[dup[0]].float() * (sc[dup[0]] if sc is not None
                                          else 1.0)
        corpus[dup] = corpus[dup[0]].clone()
        if sc is not None:
            sc[dup] = sc[dup[0]].clone()
        recs.append(_k4_case(f"i_dups_k128_Q129_{name}", qd, corpus, 128, nd,
                             scales=sc, timed=False, expect_first=dup[:128]))
        recs.append(_k4_case(f"i_k1_Q1_{name}", qd[:1].contiguous(), corpus,
                             1, nd, scales=sc, timed=False,
                             expect_first=dup[:1]))
        recs.append(_k4_case(f"i_N100_lt_tile_Q129_{name}", qd,
                             corpus[:100].contiguous(), 10, 100,
                             scales=None if sc is None
                             else sc[:100].contiguous(), timed=False))
    # K5's prologue kernel against the plain quantisation rule, bit for bit
    for rows, width in ((24, 1024), (1, 48), (130, 1040)):
        x = torch.randn(rows, width, generator=gd, device=dev)
        x[0, 0] = 0.0
        got, want = T.quantize_rows_int8_cuda(x), T.quantize_last_axis_int8(x)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"K5 query quantiser differs from the plain "
                                 f"rule at [{rows}, {width}]")
    log("[phase6] query quantiser kernel bit-equal to the plain rule")
    # shapes off the tile grid (untimed): feature widths that leave a
    # partial 128-byte chunk (or, f32, a partial 32-float step), one query,
    # a query count past one 128-row tile, a corpus shorter than a tile
    go = torch.Generator(device=dev)
    go.manual_seed(66)
    for tag, Q, N, D, k, vn in (("D128_tiny_width", 24, 1024, 128, 6, 384),
                                ("D80_Q1", 1, 5000, 80, 7, 4990),
                                ("D48_Q130_N50", 130, 50, 48, 9, 50),
                                ("D1040_Q130", 130, 3000, 1040, 128, 2999)):
        co = _normalised_rows(go, N, D, dev)
        qo = _normalised_rows(go, Q, D, dev)
        recs.append(_k4_case(f"g_{tag}_bf16", qo, co.to(torch.bfloat16), k,
                             vn, timed=False))
        recs.append(_k4_case(f"g_{tag}_f32", qo, co, k, vn, timed=False))
        oi, os_ = T.quantize_last_axis_int8(co)
        recs.append(_k4_case(f"g_{tag}_int8", qo, oi, k, vn, scales=os_,
                             timed=False))
    # the searches that are plain PyTorch ops (the default
    # DENSE_SEARCH_MODE="approx", with and without the int8 rescore) run on
    # the card through DenseIndex and must return what they return on the
    # CPU, and what the kernels return where both are exact
    recs.append(_plain_search_modes(go, dev))
    # the ranker path's shape: the synthetic world's index (384 docs padded
    # to 1024 rows), one batch of 24 queries, k = TOP_K = 5
    qm = q256[:24].contiguous()
    recs.append(_k4_case("f_ranker_path_bf16", qm, cb[:1024].contiguous(), 5,
                         384))
    recs.append(_k4_case("f_ranker_path_int8", qm, ci[:1024].contiguous(), 5,
                         384, scales=cs[:1024].contiguous()))
    recs.append(_k4_case("f_ranker_path_f32", qm, cb[:1024].float(), 5, 384))
    del cb, ci, cs
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------- phase 7
def _dense_hits_agree(res, cfg, queries):
    """The dense index' kernel search against the plain version on the
    same query embeddings (first batch)."""
    import numpy as np
    import torch
    from sdag_tpu_torch.ops import topk as T
    index = res.dense_index
    q = torch.from_numpy(np.ascontiguousarray(res.ranker.encode(
        list(queries), kind="query",
        batch_size=cfg.BATCH_SIZE_EMBED_Q))).to(index.device)
    k = max(cfg.TOP_K)
    vk, ik = index.search_device(q, k)
    if index.quantized:
        vp, ip = T.exact_topk_int8(q, index.embeddings, index.scales, k,
                                   valid_n=index.valid_n)
        ok = torch.equal(ik, ip) and torch.equal(vk, vp)
    else:
        qc = q.to(index.embeddings.dtype)
        scores = T._mask_rows(T._float_scores(qc, index.embeddings),
                              index.valid_n)
        vp, ip = T.ordered_topk(scores, k)
        got = torch.gather(scores, 1, ik.clamp(min=0).long())
        ok = bool((torch.isclose(got, vp, rtol=K4_RTOL, atol=K4_ATOL)
                   & torch.isclose(vk, vp, rtol=K4_RTOL, atol=K4_ATOL)).all())
    return ok, int((ik != ip).sum())


def phase7(dev):
    import torch
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.ops import topk as T
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    from sdag_tpu_torch.pipeline.resources import init_resources
    from sdag_tpu_torch.utils.synth_qa import load_world
    ckpt = os.path.join(REPO, "experiments", "data", "qa_ckpt_v4")
    world = load_world(os.path.join(ckpt, "world.json"))
    base = os.path.join(OUT_DIR, "chip_smoke_phase7")
    recs = {}
    runs = (
        ("a_knn2_sparse_clean", 0, dict(DOC_NEIGHBORS_K=2)),
        ("b_hybrid_bf16_attack", 1, dict(
            RETRIEVER_BACKEND="sparse_and_dense", DENSE_SEARCH_MODE="exact",
            DENSE_INDEX_DTYPE="bfloat16",
            MALICIOUS_DOC_SELECTION_STRATEGY="closest_to_centroid")),
        ("b_hybrid_int8_attack", 1, dict(
            RETRIEVER_BACKEND="sparse_and_dense", DENSE_SEARCH_MODE="exact",
            DENSE_INDEX_DTYPE="int8",
            MALICIOUS_DOC_SELECTION_STRATEGY="closest_to_centroid")),
        ("b_hybrid_f32_attack", 1, dict(
            RETRIEVER_BACKEND="sparse_and_dense", DENSE_SEARCH_MODE="exact",
            DENSE_INDEX_DTYPE="float32",
            MALICIOUS_DOC_SELECTION_STRATEGY="closest_to_centroid")))
    for name, pos, over in runs:
        cfg, facts = _synth_cfg(
            os.path.join(base, name), world, world.eval_entities[:4], 1,
            world.seed + 1, pos, LLM_CHECKPOINT=ckpt,
            RANKER_ARCH="e5-large-v2", DENSE_INDEX_PATH="", **over)
        torch.cuda.empty_cache()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        res = init_resources(cfg, device=dev)
        torch.cuda.synchronize(dev)
        t_init = time.perf_counter() - t0
        enc = res.ranker
        build = dict(enc.stats)
        metrics = run_experiment(cfg, resources=res, device=dev)
        torch.cuda.synchronize(dev)
        launches = dict(LAUNCHES)
        m = metrics[(5, pos)]["answer_match_stats"]
        out = cfg.OUTPUT_CSV_BASE + f"_top_k=5_attacker_pos={pos}"
        rec = {"queries": len(facts), "launches": launches,
               "encoder": {"layers": enc.cfg.n_layers, "d_model":
                           enc.cfg.d_model, "dtype": str(enc.cfg.dtype),
                           "fused": enc.fused, "gelu": enc.gelu,
                           "batches": enc.stats["batches"],
                           "tokens": enc.stats["tokens"]},
               "init_s": t_init, "run_s": time.perf_counter() - t0 - t_init,
               "acc_iso": m["iso"]["ground_truth_match_rate"],
               "acc_noiso": m["no_iso"]["ground_truth_match_rate"],
               "asr_iso": m["iso"]["false_answer_match_rate"],
               "outputs_written": all(os.path.isfile(out + ext)
                                      for ext in (".csv", ".json"))}
        need_k3 = enc.cfg.n_layers * enc.stats["batches"]
        if launches.get("encoder_attention_bf16", 0) != need_k3 or not need_k3:
            raise AssertionError(
                f"phase 7 {name}: K3 launched "
                f"{launches.get('encoder_attention_bf16', 0)} times, the "
                f"encoder ran {enc.stats['batches']} batches x "
                f"{enc.cfg.n_layers} layers")
        for key in ("sdag_prefill_f32", "bm25_scan_topk"):
            if not launches.get(key, 0):
                raise AssertionError(f"phase 7 {name}: {key} never launched")
        if not rec["outputs_written"]:
            raise AssertionError(f"phase 7 {name}: CSV/JSON outputs missing")
        if res.dense_index is not None:
            body = "topk_matmul_int8" if res.dense_index.quantized else \
                T.K4_BODIES[res.dense_index.embeddings.dtype]
            if not launches.get(body, 0):
                raise AssertionError(f"phase 7 {name}: {body} never launched")
            # index build: passages through the encoder, device synced
            rec["index_build"] = {
                "docs": res.dense_index.valid_n, "tokens": build["tokens"],
                "padded_tokens": build["padded_tokens"],
                "seconds": build["seconds"],
                "tokens_per_s": build["tokens"] / build["seconds"]}
            log(f"[phase7] {name}: index build {build['tokens']} tokens in "
                f"{build['seconds']:.3f} s = "
                f"{build['tokens'] / build['seconds']:.1f} encoder tokens/s")
            ok, mism = _dense_hits_agree(res, cfg,
                                         _first_batch_questions(cfg))
            rec["dense_hits_agree"], rec["dense_index_mismatches"] = ok, mism
            if not ok:
                raise AssertionError(f"phase 7 {name}: dense hits differ "
                                     "from the plain version's")
        log(f"[phase7] {name} {json.dumps(rec)}")
        if name.startswith("a_") and not rec["acc_iso"] >= 0.8:
            raise AssertionError(f"phase 7 {name}: clean ACC iso "
                                 f"{rec['acc_iso']} < 0.8")
        recs[name] = rec
        del res
    recs["c_f32_encode"] = _f32_encode(dev)
    return recs


def _f32_encode(dev, batch=32):
    """(c) e5-large-v2's geometry at float32 (how a converted checkpoint
    loads) through E5Encoder over the phase-7 corpus, random weights from a
    seed: K3's f32 body launched layers x batches and no other K3 body;
    the first batch's unit embeddings within the kernel's own f32 limit
    (1e-4) of the plain attention's (the unfused encoder on the card)."""
    import dataclasses
    import numpy as np
    import torch
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.models.e5 import (E5Encoder, EncoderConfig,
                                          init_encoder_params)
    from sdag_tpu_torch.models.tokenizer import load_tokenizer
    from sdag_tpu_torch.pipeline.resources import load_corpus_jsonl
    from sdag_tpu_torch.utils.synth_qa import load_world, write_corpus_jsonl
    world = load_world(os.path.join(REPO, "experiments", "data",
                                    "qa_ckpt_v4", "world.json"))
    corpus = os.path.join(OUT_DIR, "chip_smoke_corpus_v4.jsonl")
    os.makedirs(OUT_DIR, exist_ok=True)
    write_corpus_jsonl(world, corpus)
    texts, _ids = load_corpus_jsonl(corpus)
    cfg = dataclasses.replace(EncoderConfig.e5_large_v2(),
                              dtype=torch.float32)
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    params = init_encoder_params(g, cfg, device=dev)
    tok = load_tokenizer("")
    enc = E5Encoder(params, cfg, tok, model_name="intfloat/e5-large-v2",
                    device=dev)
    torch.cuda.synchronize(dev)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    emb = enc.encode(texts, kind="passage", batch_size=batch)
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    plain = E5Encoder(params, cfg, tok, model_name="intfloat/e5-large-v2",
                      fused=False, device=dev)
    ref = plain.encode(texts[:batch], kind="passage", batch_size=batch)
    err = float(np.abs(emb[:batch] - ref).max())
    need = cfg.n_layers * enc.stats["batches"]
    rec = {"docs": len(texts), "layers": cfg.n_layers, "d_model":
           cfg.d_model, "dtype": "float32", "fused": enc.fused,
           "batches": enc.stats["batches"], "tokens": enc.stats["tokens"],
           "seconds": seconds, "tokens_per_s": enc.stats["tokens"] / seconds,
           "launches": launches, "k3_f32_launches_needed": need,
           "first_batch_max_abs_err": err, "tol": F32_TOL,
           "finite": bool(np.isfinite(emb).all()),
           "shape": list(emb.shape)}
    log(f"[phase7] c_f32_encode {json.dumps(rec)}")
    if launches.get("encoder_attention_f32", 0) != need or not need or \
            launches.get("encoder_attention_bf16", 0):
        raise AssertionError(f"phase 7 f32 encode: K3 launches {launches}, "
                             f"need {need} of the f32 body")
    if not rec["finite"] or rec["shape"] != [len(texts), cfg.d_model] \
            or not err <= F32_TOL:
        raise AssertionError(f"phase 7 f32 encode: {rec}")
    del params, enc, plain
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------- phase 8
# K6 limits: each row's max abs error over the row's max |y|
K6_F32_TOL, K6_BF16_TOL = 1e-5, 1e-2


def device_ms(fn, calls: int = 10, replays: int = 5) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one
    CUDA graph, replayed after a warm-up (the wrapper's host work left
    out, as on the decode path, which replays captured graphs)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


def k6_products(cfg):
    """One decode step's weight products of a decoder config: (name,
    out N, in K, count a step); the unembed once a step."""
    d, hd, ff = cfg.d_model, cfg.head_dim, cfg.d_ff
    L = cfg.n_layers
    prods = [("wq", cfg.n_heads * hd, d, L), ("wk", cfg.n_kv_heads * hd, d, L),
             ("wv", cfg.n_kv_heads * hd, d, L), ("wo", d, cfg.n_heads * hd, L),
             ("gate", ff, d, L), ("up", ff, d, L), ("down", d, ff, L),
             ("tied_unembed" if cfg.tie_embeddings else "lm_head",
              cfg.vocab_size, d, 1)]
    shapes = {}
    for name, n, k, count in prods:
        key = (n, k)
        if key in shapes:
            shapes[key][0].append(name)
            shapes[key][1] += count
        else:
            shapes[key] = [[name], count]
    return [("+".join(names), n, k, count)
            for (n, k), (names, count) in shapes.items()]


def _k6_row_errors(y, ref):
    """(max abs error, max over rows of the row's max abs error over its
    max |ref|)."""
    d = (y.float() - ref.float()).abs()
    row = d.amax(-1) / ref.float().abs().amax(-1).clamp_min(1e-30)
    return float(d.max()), float(row.max())


def _k6_case(name, M, N, K, dtype, g, dev, timed=True, plant=False):
    """K6 against int8_matmul_reference at one shape (random int8 weights,
    scales ~ the int8 tree's); optionally the two planted faults (one
    output column's scale doubled, one 64-wide `in` chunk skipped) must
    fail the limit.  Times K6, the plain version and the bf16 (f32)
    torch.matmul that K6 replaces as device time a call."""
    import torch
    from sdag_tpu_torch.ops import int8_matmul as Q
    tol = K6_F32_TOL if dtype == torch.float32 else K6_BF16_TOL
    x = torch.randn(M, K, generator=g, device=dev).to(dtype)
    w = torch.randint(-127, 128, (N, K), generator=g, device=dev,
                      dtype=torch.int8)
    s = (torch.rand(N, generator=g, device=dev) * 2e-3 + 1e-4)
    y = Q.int8_matmul_cuda(x, w, s)
    ref = Q.int8_matmul_reference(x, w, s)
    torch.cuda.synchronize(dev)
    err, row_err = _k6_row_errors(y, ref)
    esize = torch.finfo(dtype).bits // 8
    nbytes = N * K + 4 * N + esize * (M * K + M * N)
    ops = 2.0 * M * N * K
    peak = PEAK_FLOPS["bfloat16" if dtype == torch.bfloat16 else "float32"]
    bt, ot = nbytes / H100_BYTES_PER_S * 1e3, ops / peak * 1e3
    rec = {"name": name, "dtype": str(dtype).replace("torch.", ""),
           "M": M, "N": N, "K": K, "max_abs_err": err, "row_rel_err": row_err,
           "tol": tol, "bound_ms": max(bt, ot),
           "bound_by": "bytes" if bt >= ot else "operations",
           "plan": Q.k6_plan(N, K, torch.cuda.get_device_properties(
               dev).multi_processor_count)}
    if plant:
        col, k0 = N // 3, (K // 2) // 64 * 64
        s2 = s.clone()
        s2[col] *= 2
        w2 = w.clone()
        w2[:, k0:k0 + 64] = 0
        faults = {}
        for fault, (ww, ss) in (("scale_doubled", (w, s2)),
                                ("chunk_skipped", (w2, s))):
            faults[fault] = _k6_row_errors(Q.int8_matmul_cuda(x, ww, ss),
                                           ref)[1]
        rec["planted_row_rel_err"] = faults
        if not all(v > tol for v in faults.values()):
            raise AssertionError(f"phase 8 {name}: a planted fault passed "
                                 f"the check: {faults}")
    if timed:
        wl = w.to(dtype)
        rec["ms"] = device_ms(lambda: Q.int8_matmul_cuda(x, w, s))
        rec["event_ms"] = cuda_ms(lambda: Q.int8_matmul_cuda(x, w, s),
                                  iters=20)
        rec["plain_ms"] = device_ms(lambda: Q.int8_matmul_reference(x, w, s),
                                    calls=3, replays=3)
        rec["library_ms"] = device_ms(lambda: x @ wl.T)
        rec["int8pack_ms"] = None
        if dtype == torch.bfloat16 and hasattr(torch, "_weight_int8pack_mm"):
            try:
                sb = s.to(dtype)
                torch._weight_int8pack_mm(x, w, sb)
                rec["int8pack_ms"] = device_ms(
                    lambda: torch._weight_int8pack_mm(x, w, sb))
            except (RuntimeError, NotImplementedError) as exc:
                rec["int8pack_error"] = str(exc).splitlines()[0][:120]
        del wl
    log(f"[phase8] K6 {json.dumps(rec)}")
    if not row_err <= tol:
        raise AssertionError(f"phase 8 {name}: K6 differs from its plain "
                             f"version: {rec}")
    return rec


def _k6_step(recs, cfg, M, dtype):
    """A decode step's (or window round's) K6 work at M rows: the sums of
    the cases' times and bounds, each weighted by its count a step."""
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    tot = {k: 0.0 for k in keys}
    by = {(r["N"], r["K"], r["M"], r["dtype"]): r for r in recs}
    bytes_ms = ops_ms = 0.0
    for _name, n, k, count in k6_products(cfg):
        r = by[(n, k, M, dtype)]
        for key in keys:
            tot[key] += count * r[key]
        if r["bound_by"] == "bytes":
            bytes_ms += count * r["bound_ms"]
        else:
            ops_ms += count * r["bound_ms"]
    tot["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    tot["M"] = M
    return tot


def _k6_cases(dev):
    """(a) K6 at every decode product shape of the 8B step (M = 8, a
    step's batch, and M = 40, a window of batch 8 x (D + 1) = 5) in bf16,
    and of qa_ckpt's (d 192, d_ff 512, tied unembed 512 x 192) in f32; the
    planted faults at one shape of each body."""
    import torch
    from sdag_tpu_torch.models.llama import DecoderConfig
    from sdag_tpu_torch.models.native_ckpt import load_config
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    recs = []
    for cfg, dtype in ((DecoderConfig.llama3_8b(), torch.bfloat16),
                       (load_config(os.path.join(REPO, "experiments", "data",
                                                 "qa_ckpt")), torch.float32)):
        for M in (8, 40):
            for i, (name, n, k, _count) in enumerate(k6_products(cfg)):
                recs.append(_k6_case(f"{name}_M{M}", M, n, k, dtype, g, dev,
                                     plant=(M == 8 and i == 0)))
        torch.cuda.empty_cache()
    return recs


def _spec_stats(gen):
    rr = gen.spec_total_row_rounds
    return {"rounds": gen.spec_total_rounds, "row_rounds": rr,
            "tokens": gen.spec_total_tokens,
            "accepted_drafts_per_round":
                gen.spec_total_tokens / rr - 1.0 if rr else None}


def _p8_main_path(dev):
    """(b) the 8B path through run_experiment with int8 weights, the int8
    cache and SPECULATIVE_DRAFT_LEN=4; launch counts zeroed before, K1, K2
    and K6's bf16 body must have launched."""
    import torch
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    from sdag_tpu_torch.pipeline.resources import init_resources
    from sdag_tpu_torch.utils.synth_qa import load_world
    world = load_world(os.path.join(REPO, "experiments", "data", "qa_ckpt",
                                    "world.json"))
    tmp = os.path.join(OUT_DIR, "chip_smoke_phase8")
    cfg, facts = _synth_cfg(tmp, world, world.eval_entities[:6], 1,
                            world.seed + 3, 1, LLM_ARCH="llama3-8b",
                            MAX_GEN_TOKENS_RAG=32, BM25_ENGINE="scan",
                            LLM_WEIGHTS_DTYPE="int8", KV_CACHE_DTYPE="int8",
                            SPECULATIVE_DRAFT_LEN=4)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    res = init_resources(cfg, device=dev)
    torch.cuda.synchronize(dev)
    t_init = time.perf_counter() - t0
    metrics = run_experiment(cfg, resources=res, device=dev)
    torch.cuda.synchronize(dev)
    t_run = time.perf_counter() - t0 - t_init
    launches = dict(LAUNCHES)
    gen = res.generator
    st = gen.stats
    base = cfg.OUTPUT_CSV_BASE + "_top_k=5_attacker_pos=1"
    rec = {"queries": len(facts), "launches": launches,
           "init_s": t_init, "run_s": t_run,
           "outputs_written": all(os.path.isfile(base + ext)
                                  for ext in (".csv", ".json")),
           "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
           "decode_tokens": st["decode_tokens"], "decode_s": st["decode_s"],
           "decode_tok_s": st["decode_tokens"] / st["decode_s"],
           "rounds_run": st["decode_steps"],
           "ms_per_round": 1e3 * st["decode_s"] / st["decode_steps"],
           "graph_captures": st["graph_captures"],
           "capture_s": st["capture_s"], "spec": _spec_stats(gen),
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "acc_iso": metrics[(5, 1)]["answer_match_stats"]["iso"][
               "ground_truth_match_rate"]}
    need_k1 = gen.cfg.n_layers * 2 * math.ceil(len(facts) / 8)
    if launches.get("sdag_prefill_bf16", 0) < need_k1:
        raise AssertionError(f"phase 8: K1 launched {launches} < {need_k1}")
    for key in ("bm25_scan_topk", "int8_matmul_bf16"):
        if not launches.get(key, 0):
            raise AssertionError(f"phase 8: {key} never launched: {rec}")
    if not rec["outputs_written"] or st["graph_captures"] < 1:
        raise AssertionError(f"phase 8: outputs or graph captures "
                             f"missing: {rec}")
    rec["profile"] = _profile_window(gen, dev)
    log(f"[phase8] main path {json.dumps(rec)}")
    return rec, res


def _p8_equality(gen, dev):
    """(c) one NO-ISO batch on the 8B int8 tree and int8 cache: graph
    equals eager, greedy and sampled, for plain decode and speculative
    rounds; greedy speculative tokens equal greedy plain tokens."""
    import torch
    from sdag_tpu_torch.sdag.generate import Generator
    rec = {}
    greedy = {}
    for name, draft in (("plain", 0), ("spec4", 4)):
        eng = Generator(gen.params, gen.cfg, gen.tokenizer, temperature=0.0,
                        batch_bucket=8, kv_cache_dtype="int8",
                        speculative_draft=draft, device=dev)
        rec[name], greedy[name] = _decode_graph_vs_eager(
            eng, dev, tag=f"phase 8 {name}", kv_cache_dtype="int8",
            speculative_draft=draft)
    same = torch.equal(greedy["plain"][0], greedy["spec4"][0]) and \
        torch.equal(greedy["plain"][1], greedy["spec4"][1])
    rec["spec_equals_plain"] = {
        "equal": same, "tokens_differing": int(
            (greedy["plain"][0] != greedy["spec4"][0]).sum())}
    log(f"[phase8] equality {json.dumps(rec)}")
    if not same:
        raise AssertionError(f"phase 8: greedy speculative tokens differ "
                             f"from plain decode's: {rec}")
    return rec


def decode_configs(dev, new_tokens=32, reps=2):
    """(d) one batch of the 8 main-path NO-ISO prompts at 8B (random bf16
    weights from a seed), 32 new tokens, greedy, in four configurations:
    native, int8 weights, int8 weights + int8 cache, and + speculation
    (D = 4); decode tok/s and ms a step (round) after a warm-up call."""
    import torch
    from sdag_tpu_torch.models.llama import (DecoderConfig,
                                             init_decoder_params,
                                             quantize_decoder_params_int8)
    from sdag_tpu_torch.models.tokenizer import load_tokenizer
    from sdag_tpu_torch.sdag.generate import Generator
    cfg = DecoderConfig.llama3_8b()
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    params = init_decoder_params(g, cfg, device=dev)
    qparams = quantize_decoder_params_int8(params)
    _plans, plain = _main_path_prompts(8)
    recs = {}
    for name, p, kw in (("native", params, {}),
                        ("int8_weights", qparams, {}),
                        ("int8_weights_int8_kv", qparams,
                         {"kv_cache_dtype": "int8"}),
                        ("int8_weights_int8_kv_spec4", qparams,
                         {"kv_cache_dtype": "int8", "speculative_draft": 4})):
        gen = Generator(p, cfg, load_tokenizer(""), temperature=0.0,
                        batch_bucket=8, device=dev, **kw)
        gen.generate_ids(plain, max_new_tokens=new_tokens)      # captures
        torch.cuda.synchronize(dev)
        gen.stats.update(decode_tokens=0, decode_s=0.0, decode_steps=0)
        for _ in range(reps):
            gen.generate_ids(plain, max_new_tokens=new_tokens)
        st = gen.stats
        recs[name] = {"tok_s": st["decode_tokens"] / st["decode_s"],
                      "ms_per_step": 1e3 * st["decode_s"] / st["decode_steps"],
                      "steps": st["decode_steps"],
                      "tokens": st["decode_tokens"]}
        if kw.get("speculative_draft"):
            recs[name]["spec"] = _spec_stats(gen)
        del gen
        torch.cuda.empty_cache()
    del params, qparams
    torch.cuda.empty_cache()
    log(f"[phase8] decode configurations {json.dumps(recs)}")
    return recs


def _p8_qa_ckpt(dev):
    """(e) the trained qa_ckpt through run_experiment with int8 weights and
    SPECULATIVE_DRAFT_LEN=4 (K6's f32 body): clean ACC iso >= 0.5, K6-f32
    and K1 launched; mean accepted drafts a round."""
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    from sdag_tpu_torch.pipeline.resources import init_resources
    from sdag_tpu_torch.utils.synth_qa import load_world
    ckpt = os.path.join(REPO, "experiments", "data", "qa_ckpt")
    world = load_world(os.path.join(ckpt, "world.json"))
    cfg, facts = _synth_cfg(os.path.join(OUT_DIR, "chip_smoke_phase8",
                                         "qa_ckpt"), world,
                            world.eval_entities[:4], 1, world.seed + 1, 0,
                            LLM_CHECKPOINT=ckpt, LLM_WEIGHTS_DTYPE="int8",
                            SPECULATIVE_DRAFT_LEN=4)
    LAUNCHES.clear()
    res = init_resources(cfg, device=dev)
    m = run_experiment(cfg, resources=res, device=dev)[(5, 0)][
        "answer_match_stats"]
    rec = {"queries": len(facts), "launches": dict(LAUNCHES),
           "acc_iso": m["iso"]["ground_truth_match_rate"],
           "acc_noiso": m["no_iso"]["ground_truth_match_rate"],
           "spec": _spec_stats(res.generator)}
    log(f"[phase8] qa_ckpt int8 + speculation {json.dumps(rec)}")
    if not rec["acc_iso"] >= 0.5:
        raise AssertionError(f"phase 8: qa_ckpt int8 ACC iso below 0.5: "
                             f"{rec}")
    if not (LAUNCHES["int8_matmul_f32"] and LAUNCHES["sdag_prefill_f32"]):
        raise AssertionError(f"phase 8: a qa_ckpt kernel never launched: "
                             f"{rec}")
    return rec


def phase8(dev):
    import torch
    from sdag_tpu_torch.models.llama import DecoderConfig
    from sdag_tpu_torch.models.native_ckpt import load_config
    torch.cuda.empty_cache()
    recs = {"k6": _k6_cases(dev)}
    recs["k6_step_8b"] = {
        f"M{M}": _k6_step(recs["k6"], DecoderConfig.llama3_8b(), M,
                          "bfloat16") for M in (8, 40)}
    qa_cfg = load_config(os.path.join(REPO, "experiments", "data",
                                      "qa_ckpt"))
    recs["k6_step_qa_ckpt"] = {
        f"M{M}": _k6_step(recs["k6"], qa_cfg, M, "float32") for M in (8, 40)}
    log(f"[phase8] K6 a step {json.dumps(recs['k6_step_8b'])} "
        f"{json.dumps(recs['k6_step_qa_ckpt'])}")
    recs["main_path"], res = _p8_main_path(dev)
    recs["equality"] = _p8_equality(res.generator, dev)
    del res
    torch.cuda.empty_cache()
    recs["decode_configs"] = decode_configs(dev)
    recs["qa_ckpt"] = _p8_qa_ckpt(dev)
    return recs


def _first_batch_questions(cfg):
    from sdag_tpu_torch.utils.parsing import load_from_csv
    return load_from_csv(cfg.CSV_INPUT_PATH).questions[
        :cfg.BATCH_SIZE_EMBED_Q]


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
    t_start = time.perf_counter()
    card = nvidia_smi()
    log(f"[phase0] card: {card}")
    log(f"[phase0] torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[phase0] kernels built in {time.perf_counter() - t0:.1f}s")
    ptxas = ptxas_report(_build)
    log(f"[phase0] ptxas {json.dumps(ptxas)}")

    details = {"card": card, "ptxas": ptxas}
    details["phase1"] = k1 = phase1(dev)
    details["phase2"] = k2 = phase2(dev)
    details["phase3"] = p3 = phase3(dev)
    details["phase4"] = p4 = phase4(dev)
    details["phase5"] = k3 = phase5(dev)
    details["phase6"] = k4 = phase6(dev)
    details["phase7"] = p7 = phase7(dev)
    details["phase8"] = p8 = phase8(dev)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(details, fh, indent=1)

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    by_name = {r["name"]: r for r in k1 + k2 + k3 + k4}
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
    # K3-K5: timed at the ranker path's shapes (phase 5 case f, phase 6
    # cases f), counted over the phase-7 run that drives each
    kernels += [
        dict(name="encoder_attention_f32", route="cuda",
             source="sdag_tpu_torch/csrc/encoder_attention.cu",
             replaces="sdag_tpu/ops/encoder_attention.py:108",
             launches=p7["c_f32_encode"]["launches"].get(
                 "encoder_attention_f32", 0),
             max_abs_err=max(r["max_abs_err"] for r in k3
                             if r["dtype"] == "float32"),
             **{key: by_name["f_ranker_path_batch_f32"][key]
                for key in keys}),
        dict(name="encoder_attention_bf16", route="cuda",
             source="sdag_tpu_torch/csrc/encoder_attention.cu",
             replaces="sdag_tpu/ops/encoder_attention.py:108",
             launches=p7["a_knn2_sparse_clean"]["launches"].get(
                 "encoder_attention_bf16", 0),
             max_abs_err=max(r["max_abs_err"] for r in k3
                             if r["dtype"] == "bfloat16"),
             **{key: by_name["f_ranker_path_batch"][key] for key in keys}),
        dict(name="topk_matmul_bf16", route="cuda",
             source="sdag_tpu_torch/csrc/topk_matmul.cu",
             replaces="sdag_tpu/ops/topk.py:189",
             launches=p7["b_hybrid_bf16_attack"]["launches"].get(
                 "topk_matmul_bf16", 0),
             max_abs_err=max(r["max_abs_err"] for r in k4
                             if r["dtype"] == "bfloat16"),
             **{key: by_name["f_ranker_path_bf16"][key] for key in keys}),
        dict(name="topk_matmul_f32", route="cuda",
             source="sdag_tpu_torch/csrc/topk_matmul.cu",
             replaces="sdag_tpu/ops/topk.py:189",
             launches=p7["b_hybrid_f32_attack"]["launches"].get(
                 "topk_matmul_f32", 0),
             max_abs_err=max(r["max_abs_err"] for r in k4
                             if r["dtype"] == "float32"),
             **{key: by_name["f_ranker_path_f32"][key] for key in keys}),
        dict(name="topk_matmul_int8", route="cuda",
             source="sdag_tpu_torch/csrc/topk_matmul.cu",
             replaces="sdag_tpu/ops/topk.py:324",
             launches=p7["b_hybrid_int8_attack"]["launches"].get(
                 "topk_matmul_int8", 0),
             max_abs_err=max(r["max_abs_err"] for r in k4
                             if r["dtype"] == "int8"),
             **{key: by_name["f_ranker_path_int8"][key] for key in keys}),
    ]
    # K6: a window round's products (M = batch 8 x (D + 1) = 40 rows, the
    # speculative main paths of 8(b) and 8(e)), counted over those runs
    for dt, dtype, step, run in (
            ("bf16", "bfloat16", p8["k6_step_8b"]["M40"], p8["main_path"]),
            ("f32", "float32", p8["k6_step_qa_ckpt"]["M40"], p8["qa_ckpt"])):
        kernels.append(dict(
            name=f"int8_matmul_{dt}", route="cuda",
            source="sdag_tpu_torch/csrc/int8_matmul.cu",
            replaces="sdag_tpu/models/llama.py:107",
            launches=run["launches"].get(f"int8_matmul_{dt}", 0),
            max_abs_err=max(r["max_abs_err"] for r in p8["k6"]
                            if r["dtype"] == dtype),
            **{key: step[key] for key in keys}))
    main8 = p8["main_path"]
    log(f"[summary] phase 8 int8 + int8 KV + speculation: decode "
        f"{main8['decode_tok_s']:.1f} tok/s ({main8['ms_per_round']:.2f} ms "
        f"a round, {main8['spec']['accepted_drafts_per_round']} accepted "
        f"drafts a round), peak {main8['peak_mem_gib']:.2f} GiB; decode "
        f"configurations {json.dumps(p8['decode_configs'])}; qa_ckpt "
        f"accepted drafts a round "
        f"{p8['qa_ckpt']['spec']['accepted_drafts_per_round']}")
    log(f"[summary] phase 4 prefill {p4['prefill_tok_s']:.1f} tok/s, "
        f"decode {p4['decode_tok_s']:.1f} tok/s "
        f"({p4['decode_ms_per_step']:.2f} ms a step, "
        f"{p4['graph_captures']} graph captures, device busy "
        f"{p4['profile']['device_busy_share']}), peak "
        f"{p4['peak_mem_gib']:.2f} GiB on {card}")
    log(f"[summary] phases 0-8 in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ptxas": ptxas}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
