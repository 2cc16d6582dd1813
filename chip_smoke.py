#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``sdag_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, one CUDA device

Phase 0  print the card (nvidia-smi name, power limit); build the kernels
         with nvcc, one process per source, all at once: K1
         (csrc/sdag_prefill.cu), K2 (csrc/bm25_scan_topk.cu), K3
         (csrc/encoder_attention.cu), K4/K5 (csrc/topk_matmul.cu), K6
         (csrc/int8_matmul.cu), K7 (csrc/decode_attention.cu), K8
         (csrc/moe_experts.cu), K9 (csrc/rms_norm.cu); print
         ptxas' registers and spill bytes per
         kernel body.
Phase 1  K1 against its plain PyTorch version (sdag_attention_reference) on
         the card: the L=4096 20-doc 2-NN layout, the same tensors fully
         causal, L=16384 with 31 docs, a Dh=32 f32 case with holes, 40 docs
         and a q_offset slice, the same layout in bf16 off the tile grid
         (Lk 1990, Lq 995, a batch row with valid_len 0), GQA groups of 1
         and 8 (the bf16 body shares K/V tiles between two q heads of a
         group), and the main paths' ISO/NO-ISO shapes over
         real synthetic-world prompts: llama3-8b heads in bf16 (the
         tensor-core body), qa_ckpt's heads in f32 (the CUDA-core
         body), and the HF 8B checkpoint's heads (Hq 32, Hkv 8, Dh 128)
         in f32 over the prompts of phase 9's byte-level BPE tokenizer.
         Valid rows that see a key are compared: max abs error
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
         must have launched (K1 at least 32 layers x ISO+NO-ISO batches;
         K7 two and K9 65 launches a graph capture).  Phase 3 counts its
         own run the same way (K1, K2 and K9 launched).  Decode runs as
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
         in f32, and of the 8B step again in f32 (an HF checkpoint loads
         float32): each row's max abs error <= 1e-2 (bf16) / 1e-5 (f32)
         of its max |y|; one output column's scale doubled and one
         64-wide `in` chunk skipped (at M = 8), and the last 64-wide
         chunk, in the last split, skipped (at M = 40) must fail that
         check (per configuration); the bf16 body's plan (warps, splits
         = blocks a cluster, ring) and ptxas registers and spills per 8B
         product; device times of K6, the plain version and the bf16
         (f32) torch.matmul it replaces (torch._weight_int8pack_mm beside
         it where this torch has it for CUDA), with the weights cold (the
         calls cycle through 128 MB of weight copies) and warm (one
         weight), summed over a step's products; (b) run_experiment on the
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

Phase 9  HF checkpoints from local files, written here without any HF
         library into a temporary directory outside the repo (removed when
         the phase ends; under 40 GB free fails): (a) Llama-3.1-8B's full width
         and depth (vocab 128256, d 4096, 32 layers, 32/8 heads, d_ff
         14336, llama3 RoPE scaling, untied), random bf16 tensors drawn on
         the card from per-tensor seeds, 4 safetensors shards + index,
         config.json, and a Llama-3-style tokenizer (byte-level BPE of 400
         merges learned here from the world's text, specials at
         128000-128255, a chat template); (b) run_experiment with
         LLM_CHECKPOINT on it, sparse (scan), ISO and NO-ISO, greedy,
         batch 8, 24 queries x 32 new tokens (the cut: queries and new
         tokens, never width or depth), counts zeroed before: the loaded
         tree is float32 and equals every written tensor cast and
         transposed, bit for bit; every eval prompt's chat string comes
         back from decode(encode(.)) and its special tokens map to their
         ids; K1-f32 launched layers x ISO+NO-ISO batches, K2 launched;
         write and load GB/s, prefill and decode tok/s, ms a step, peak
         memory; (c) an e5-large-v2-width BERT (f32, WordPiece vocab.txt)
         as RANKER_CHECKPOINT beside qa_ckpt_v4, hybrid exact search on a
         float32 index: the tree bit-equal, K3-f32 launched layers x
         encode batches (no bf16 body), K4-f32 launched, dense hits equal
         to the plain version's, fused (K3) embeddings within 1e-4 of the
         unfused ones; K3-f32 and K4-f32 timed at this path's shapes.

Phase 10 the paper's defenses, the attack builder, the index builder and
         the SDAG-effect grid: (a) DEFENSE_BACKEND=discern_and_answer at
         llama3-8b width (random bf16 weights), 8 attacked queries (n_mal
         2, rank 1, 16 new tokens), the local batched classifier: a
         clean/perturbed label per classified (query, doc) in the labels
         JSONL; a second run from that file calls no classifier and
         launches exactly 32 x (the first run's classifier generate_ids
         calls) fewer K1-bf16 kernels; (b) DEFENSE_BACKEND=ragdefender with
         an e5-large-v2-width encoder (random bf16) beside qa_ckpt, 24
         queries (n_mal 2, rank 1): K3-bf16 launched layers x batches; each
         query's kept docs equal those of the same filter over the plain
         path on the CPU (the same weights, computed in float32; each
         distinct text encoded once), except queries with a
         z-score or pair similarity within 1e-2 of its threshold (counted,
         printed); (c) pipeline.build_index on the card over phase 7's
         corpus: --bm25 equal to an in-process BM25Index.save (the npz
         member by member), dense e5-large-v2 bf16 loaded with exact search
         giving an in-process DenseIndex.from_texts' hits, both directories
         served by run_experiment (K4-bf16, K2, K1-f32 launched); (d)
         attack.poisoned_rag.main, local backend, llama3-8b width, 4
         cached questions, greedy: 4 rows of the five attack-CSV columns,
         read back by load_from_csv, a second call writes the same file;
         (e) experiments/run_sdag_effect_torch.py run_grid on qa_ckpt,
         n_mal 1, 2, 5 x positions 0, 1, 3 x 96 held-out queries: each
         cell's answers and match flags against the committed JAX CPU
         reference (experiments/results/sdag_effect_jax_cpu), at most 2
         rows a cell differ (each printed).

Phase 11 meshes over torch.distributed (the JAX package's MESH_MODEL /
         MESH_DATA, index sharding and context parallelism): (a) NCCL at
         world size 1: the port's CLI under ``python -m
         torch.distributed.run --nproc-per-node 1`` on phase 3's clean
         config writes phase 3's answers CSV row for row; a llama3-8b bf16
         Generator on an explicit (1, 1) NCCL mesh emits the mesh-less
         Generator's tokens, its decode captured in CUDA graphs with the
         collectives inside (captures and NCCL calls printed); (b) two
         ranks on the one card over gloo (NCCL refuses two ranks on one
         device), every one-rank result computed first, in turn: (i)
         TP=2 at llama3-8b bf16, 8 ISO prompts x 16 new tokens, eager:
         last-position prefill logits within K1-bf16's row-relative
         limit of one rank (bf16 partial sums all-reduced in another
         order move logits by a share of their scale), greedy token
         agreement reported, K1 at Hq 16 / Hkv 4; (ii) run_experiment on
         qa_ckpt with MESH_DATA=2, native (held to phase 3's CSV) and
         with int8 weights + int8 KV + D=4 (K6-f32 on each data rank):
         at most 2 of 24 rows differ, rank 1 writes nothing; (iii) exact
         dense search over 1,048,576 x 1024 rows split over the ranks,
         bf16, f32 (K4) and int8 (K5): K5 bit-equal to one rank, K4
         within 1e-5 and indices equal but at ties; (iv) the K2 scan over
         phase 2's 1M docs split over the ranks, bit-equal; (v) E5 at
         e5-large-v2 (bf16) with MESH_DATA=2: embeddings within K3-bf16's
         absolute limit; (vi) all-gather context parallelism with K1 at
         the 8B ISO shape and at L = 16384 within K1's limits of one-rank
         K1, the ring (f32) within 1e-4 of the plain reference.  Then
         each kernel timed against its plain version at its shard shape
         (K1 at Hq 16 / Hkv 4, K4/K5/K2 on half the index, K3 on half the
         ranker batch, K6-f32 on a data rank's window round).  Prints
         each collective's backend and whether it went through host
         memory, seconds per step, TP tok/s (gloo, two ranks on one card:
         not a multi-GPU number) and peak memory per rank.

Phase 12 training on the card (the JAX package trains through its XLA
         attention; so does the port, through its differentiable dense-mask
         attention, and K1 serves the result): (a) the port's
         pipeline.train_qa.main at the flags of the committed JAX CPU
         reference (experiments/results/train_qa_jax_cpu/reference.json:
         qa_ckpt_v4 warm start, d 192, 6 layers, batch 32, seq 768, 20
         steps, lr 3e-4, warmup 2, one step per dispatch), f32 with TF32
         off: each step's loss within 1e-3 and each tensor's update norm
         within 1e-2 of the reference, relative; in the same run two
         planted faults (ISO rows trained with the causal mask; the lr
         schedule read one step late) must each read over a gate; (b) the
         trained directory served by phase 3's clean pipeline config
         (LLM_CHECKPOINT): ACC iso and noiso >= 0.5, K1-f32 and K2
         launched; (d) 10 steps, save_train_state, restore_train_state
         into a fresh template, 10 more: steps 11-20 within twice the
         spread of two uninterrupted runs (bit-equal when they are); (c)
         the 30M word recipe's width (d 512, 8 layers, 4 heads, d_ff 1792,
         vocab 1280, seq 512, batch 32) from the port's own init, 50
         steps: loss finite and falling; steps/s, valid and padded tok/s,
         host sampling seconds against step seconds, the device busy share
         of a profiled 2-step window, peak memory, the FLOPs of a step and
         their share of the f32 peak; (e) two gloo ranks on the one card
         against one rank, each one-rank result computed first: DP=2 on
         the v4 recipe (losses, gradients, update norms), TP=2 and GPipe
         (2 stages x 4 microbatches) at the 30M width on 8 rows (losses,
         gradients; GPipe's loss within 2e-5, JAX's own gate; the
         replicated leaves' gradients equal on both TP ranks).

Phase 13 K7 (csrc/decode_attention.cu), a decode step's attention block:
         (a) against its plain version (decode_attention_reference) at the
         poison cells' shapes (bf16, B 8, Hq 32, Hkv 8, Dh 128, 928 and
         3,232 slots), HF llama3 RoPE scaling, a TP=2 rank's heads (16 /
         4), the HF 8B f32 tree's heads, qa_ckpt's (f32, Dh 32, group 1),
         Dh 64 at groups 2 and 8, Dh 32 at group 1, slot counts off the
         64-slot chunks; masks with prompt padding, holes, a masked chunk
         and a row with the write slot alone: the caches it writes equal
         the plain version's bit for bit, outputs within 2e-2 (bf16) /
         1e-5 (f32), its attention entry on the plain rope's q equals the
         step, and one row alone or over a longer cache (extra slots
         masked) equals the batch; each timed (device time of a replayed
         graph) beside the plain version, SDPA with enable_gqa and the
         bound over the valid slots' K/V bytes; (b) decode_window at G = 1
         equals decode_step bit for bit at 8B width (4 layers); (c) the
         top-5 decode shape at 8B (B 8, 896 prompt slots, 32 new tokens):
         kernels a step of the captured graph with K7 and with the plain
         block, ms a step of both (K7 twice), K7's launches at capture,
         graph against eager tokens; (d) greedy speculation (D = 4) against
         plain greedy decode at 8B with int8 weights and the native cache:
         equal with the f32 tree (K7's f32 body); with the bf16 tree the
         tokens differing with K7 and with the plain block are reported
         (rms_norm's row means depend on the row count, counted too).

Phase 14 K8 (csrc/moe_experts.cu) and the windows of Mellum2-12B-A2.5B:
         (a) K8 against its plain version (moe_experts_reference, given
         K8's own routes) at the cell's decode shape (B 8, 64 experts, top
         8, 2,304 x 896, bf16), two rows done, every row on the same
         experts, B 1, B 32 on the same experts, B 8 rows around two base
         rows that name 16-24 experts (as the cell's steps do): rows
         within 1e-2 of their RMS, routes and weights equal to the plain
         router's, the distinct-expert counter exact, a captured replay
         equal to the eager call; a dropped expert (its weights zeroed)
         must read over the limit; the two B 8 cases timed beside the
         plain version, route + grouped products, and the bound; each row
         of the B 8 call bit for bit its B 1 call and its row of a B 32
         call; (b) the windowed K1 plan and K7's
         windowed step (YaRN scale) against the plain windowed versions at
         ~3k tokens / 3,232 slots, bf16 and f32, each with a window one
         slot too wide that must read over the f32 limits (q = 0 and v's
         first dim the position: each row's mean over its keys); (c) the
         whole 28-layer model at its widths: 32 greedy tokens of 8 prompts
         past the window, captured graphs against eager steps (K7, K8 and
         K9 launches counted).

Phase 15 K9 (csrc/rms_norm.cu), a layer's residual add and the RMSNorm
         after it: (a) against its plain version (add_rms_norm_reference)
         at the poison cells' decode and prefill rows (Mistral-7B 8 x 1,
         8 x 896 and 8 x 3,200 at d 4,096; Mellum2 at d 2,304), the HF 8B
         f32 tree's and qa_ckpt's (f32, d 192), each at unit RMS and at an
         embedding row's, with and without the residual: s bit for bit, h
         the gain times the plain composition's bf16 cast of s * r or a
         neighbour of it (the count of elements differing from the plain h
         reported) or within 1e-6 relative (f32); a dropped residual and a
         wrong eps must
         fail the same comparison; timed beside the plain version, x +
         delta then F.rms_norm, and the byte bound; (b) rows of a
         25,600-row call equal the same rows alone and among 8, bit for
         bit (the plain composition's f32 row means at 1, 8 and 40 rows
         against 25,600 counted beside); (c) the top-5 decode shape at 8B:
         kernels a step of the captured graph with K9 and with the plain
         composition, ms a step of both, 2 x 32 + 1 K9 launches a step at
         capture and no rsqrt or mean kernel left, graph against eager
         tokens; (d) greedy speculation (D = 4) against plain greedy at 8B
         with int8 weights and bf16 activations: equal with K9, the tokens
         differing with the plain composition reported.

Any failure raises (exit code 1).  Without CUDA, or without the
sdag_tpu_torch package beside this script, it exits 2 and prints no
result.  The last two stdout lines are the kernels JSON and
{"ok": true, "device": {...}}; details go to smoke_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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


def _main_path_prompts(n=8, tok=None):
    """ISO plans as the main path builds them: 5 retrieved fact docs plus
    one injected malicious doc; the byte tokenizer (llama3-8b random init)
    unless ``tok`` is given."""
    from sdag_tpu_torch.models.tokenizer import load_tokenizer
    from sdag_tpu_torch.sdag.spans import build_plain_chat_ids, \
        build_rag_prompt_plan
    from sdag_tpu_torch.utils import prompts
    from sdag_tpu_torch.utils.synth_qa import (fact_doc, fact_query,
                                               load_world, malicious_doc)
    world = load_world(os.path.join(REPO, "experiments", "data", "qa_ckpt",
                                    "world.json"))
    tok = tok or load_tokenizer("")
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
    # (phase 3, the CUDA-core body); (l)-(m): the HF 8B checkpoint's heads
    # in f32 (an HF checkpoint loads float32: phase 9, the CUDA-core body
    # at Dh 128) over its prompts, through the byte-level BPE tokenizer
    # phase 9 writes
    from sdag_tpu_torch.models.hf_tokenizer import HFTokenizer
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tok_") as tmp:
        write_llama_tokenizer(tmp, _world_texts())
        hf_tok = HFTokenizer.from_dir(tmp)
    for tok, cases in (
            (None, (("e_llama3_8b_iso", "f_llama3_8b_noiso", (32, 8, 8),
                     128, torch.bfloat16),
                    ("g_qa_ckpt_iso", "h_qa_ckpt_noiso", (6, 6, 6), 32,
                     torch.float32))),
            (hf_tok, (("l_hf_8b_f32_iso", "m_hf_8b_f32_noiso", (32, 8, 8),
                       128, torch.float32),))):
        plans, plain = _main_path_prompts(8, tok=tok)
        B = len(plans)
        lp = -(-max(len(p.input_ids) for p in plans) // 128) * 128
        metas = [p.metadata(pad_to=lp) for p in plans]
        lpn = -(-max(len(x) for x in plain) // 128) * 128
        for iso, noiso, heads, dh, dtype in cases:
            q, k, v = (rnd(B, h, lp, dh, dtype=dtype) for h in heads)
            recs.append(_k1_case(
                iso, q, k, v, t32(np.stack([m[0] for m in metas])),
                t32(np.stack([m[1] for m in metas])),
                t32([m[2] for m in metas]),
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
    if not (LAUNCHES["sdag_prefill_f32"] and LAUNCHES["bm25_scan_topk"]
            and LAUNCHES["rms_norm"]):
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
    # K7 (bf16 body, native cache): two launches a layer and step, counted
    # at capture; each capture runs at least one step
    need_k7 = 2 * n_layers * st["graph_captures"]
    if launches.get("decode_attention", 0) < need_k7:
        raise AssertionError(
            f"phase 4: K7 launched {launches.get('decode_attention', 0)} "
            f"< {need_k7}")
    # K9: a layer's two norms and the final norm, counted at capture
    need_k9 = (2 * n_layers + 1) * st["graph_captures"]
    if launches.get("rms_norm", 0) < need_k9:
        raise AssertionError(
            f"phase 4: K9 launched {launches.get('rms_norm', 0)} "
            f"< {need_k9}")
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


def _device_rows(prof):
    """(kernel, device us, calls) of a profile's CUDA rows, the most time
    first (operator rows repeat their kernels' device time)."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((e.key, dev_us, e.count))
    rows.sort(key=lambda r: -r[1])
    return rows


def _profile_window(gen, dev, new_tokens=16):
    """torch.profiler over one NO-ISO batch (prefill + decode) after the
    counted run: device busy share of the wall time, device time by
    kernel.  Reports device time as null when the profiler sees none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    _plans, plain = _main_path_prompts(gen.batch_bucket or 8,
                                       tok=gen.tokenizer)
    gen.generate_ids(plain, max_new_tokens=new_tokens)   # warm: captures
    torch.cuda.synchronize(dev)
    captures = gen.stats["graph_captures"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen.generate_ids(plain, max_new_tokens=new_tokens)
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_rows(prof)
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


# a cold K6 timing cycles through copies of the weight, at least this many
# bytes of them (the L2 holds 50 MB), as a decode step streams its weights
K6_CYCLE_BYTES = 128 << 20
# K6's planted faults: one output column's scale doubled; one 64-wide `in`
# block zeroed in the middle of K, or in the last split (its last block)
K6_FAULTS = ("scale_doubled", "chunk_skipped", "last_split_chunk_skipped")


def _k6_fault(fault, w, s):
    N, K = w.shape
    if fault == "scale_doubled":
        s = s.clone()
        s[N // 3] *= 2
        return w, s
    k0 = ((K // 2) // 64 * 64 if fault == "chunk_skipped"
          else (K - 1) // 64 * 64)
    w = w.clone()
    w[:, k0:k0 + 64] = 0
    return w, s


def _k6_copies(nbytes):
    return min(32, -(-K6_CYCLE_BYTES // nbytes))


def _cold_device_ms(fn, copies):
    """device_ms of ``fn`` over weight ``copies`` in turn."""
    turn = [0]

    def call():
        fn(copies[turn[0] % len(copies)])
        turn[0] += 1
    return device_ms(call, calls=max(10, len(copies)))


def _k6_case(name, M, N, K, dtype, g, dev, timed=True, plant=()):
    """K6 against int8_matmul_reference at one shape (random int8 weights,
    scales ~ the int8 tree's); the planted faults named in ``plant`` (of
    K6_FAULTS) must fail the limit.  Times K6, the plain version and the
    bf16 (f32) torch.matmul that K6 replaces as device time a call: cold
    (``ms``, ``library_ms``: the calls cycle through copies of the weight,
    at least K6_CYCLE_BYTES of them) and warm (``warm_ms``,
    ``library_warm_ms``: one weight, L2-resident below 50 MB)."""
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
    bt = nbytes / H100_BYTES_PER_S * 1e3
    if dtype == torch.bfloat16:
        ot = ops / PEAK_FLOPS["bfloat16"] * 1e3
    else:
        # the f32 body's work: two TF32 products (split activations)
        ot = 2 * ops / TF32_FLOPS * 1e3
    rec = {"name": name, "dtype": str(dtype).replace("torch.", ""),
           "M": M, "N": N, "K": K, "max_abs_err": err, "row_rel_err": row_err,
           "tol": tol, "bound_ms": max(bt, ot),
           "bound_by": "bytes" if bt >= ot else "operations",
           "plan": Q.k6_plan(N, K, torch.cuda.get_device_properties(
               dev).multi_processor_count, dtype)}
    if dtype == torch.float32:
        # the same product at the f32 FMA rate (the earlier FMA body's bound)
        rec["bound_f32_fma_ms"] = max(
            bt, ops / PEAK_FLOPS["float32"] * 1e3)
    if plant:
        faults = {f: _k6_row_errors(Q.int8_matmul_cuda(x, *_k6_fault(f, w, s)),
                                    ref)[1] for f in plant}
        rec["planted_row_rel_err"] = faults
        if not all(v > tol for v in faults.values()):
            raise AssertionError(f"phase 8 {name}: a planted fault passed "
                                 f"the check: {faults}")
    if timed:
        copies = [w] + [torch.randint(-127, 128, (N, K), generator=g,
                                      device=dev, dtype=torch.int8)
                        for _ in range(_k6_copies(N * K) - 1)]
        lib_copies = [c.to(dtype) for c in
                      copies[:_k6_copies(esize * N * K)]]
        wl = lib_copies[0]
        rec["ms"] = _cold_device_ms(lambda wi: Q.int8_matmul_cuda(x, wi, s),
                                    copies)
        rec["warm_ms"] = device_ms(lambda: Q.int8_matmul_cuda(x, w, s))
        rec["event_ms"] = cuda_ms(lambda: Q.int8_matmul_cuda(x, w, s),
                                  iters=20)
        rec["plain_ms"] = device_ms(lambda: Q.int8_matmul_reference(x, w, s),
                                    calls=3, replays=3)
        rec["library_ms"] = _cold_device_ms(lambda wi: x @ wi.T, lib_copies)
        rec["library_warm_ms"] = device_ms(lambda: x @ wl.T)
        rec["weight_copies"] = [len(copies), len(lib_copies)]
        rec["int8pack_ms"] = None
        if dtype == torch.bfloat16 and hasattr(torch, "_weight_int8pack_mm"):
            try:
                sb = s.to(dtype)
                torch._weight_int8pack_mm(x, w, sb)
                rec["int8pack_ms"] = device_ms(
                    lambda: torch._weight_int8pack_mm(x, w, sb))
            except (RuntimeError, NotImplementedError) as exc:
                rec["int8pack_error"] = str(exc).splitlines()[0][:120]
        del wl, copies, lib_copies
    log(f"[phase8] K6 {json.dumps(rec)}")
    if not row_err <= tol:
        raise AssertionError(f"phase 8 {name}: K6 differs from its plain "
                             f"version: {rec}")
    return rec


def _k6_step(recs, cfg, M, dtype):
    """A decode step's (or window round's) K6 work at M rows: the sums of
    the cases' times and bounds, each weighted by its count a step."""
    keys = ("ms", "warm_ms", "plain_ms", "bound_ms", "library_ms",
            "library_warm_ms") + (
        ("bound_f32_fma_ms",) if dtype == "float32" else ())
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
    of qa_ckpt's (d 192, d_ff 512, tied unembed 512 x 192) in f32, and of
    the 8B step again in f32 (an HF 8B checkpoint loads float32, so its
    int8 tree runs K6's f32 body); the planted faults at one shape of each
    configuration."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    recs = []
    for tag, cfg, dtype in _k6_configs():
        for M in (8, 40):
            for i, (name, n, k, _count) in enumerate(k6_products(cfg)):
                plant = () if i else K6_FAULTS[:2] if M == 8 else K6_FAULTS[2:]
                recs.append(_k6_case(f"{tag}_{name}_M{M}", M, n, k, dtype, g,
                                     dev, plant=plant))
        torch.cuda.empty_cache()
    return recs


def k6_bf16_ptxas(build) -> dict:
    """ptxas' registers and spill bytes of each instantiation of K6's bf16
    body, by its row tiles, from build/int8_matmul.log."""
    import re
    path = os.path.join(build.BUILD, "int8_matmul.log")
    if not os.path.isfile(path):
        return {}
    with open(path) as fh:
        text = fh.read()
    rec = {}
    for entry in text.split("Compiling entry function '")[1:]:
        m = re.match(r"\S*int8_matmul_bf16_kernelILi(\d+)E", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", entry)
        if m and regs and spill:
            rec[int(m.group(1))] = {
                "registers": int(regs.group(1)),
                "spill_store_bytes": int(spill.group(1)),
                "spill_load_bytes": int(spill.group(2))}
    return rec


def _k6_bf16_plans(dev):
    """K6's bf16 launch at every 8B product, M = 8 and 40 (k6_geometry:
    warps, splits = blocks a cluster, chunk, stages, shared bytes), the
    clusters of it the card holds at once, and ptxas' registers and spill
    bytes of the instantiation it runs."""
    import torch
    from sdag_tpu_torch import _build
    from sdag_tpu_torch.models.llama import DecoderConfig
    from sdag_tpu_torch.ops import int8_matmul as Q
    ptxas = k6_bf16_ptxas(_build)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    recs = []
    for name, n, k, _count in k6_products(DecoderConfig.llama3_8b()):
        for M in (8, 40):
            geo = Q.k6_geometry(M, n, k, torch.bfloat16, sms)
            recs.append(dict(product=name, N=n, K=k, M=M, **geo,
                             max_active_clusters=Q.k6_bf16_clusters(geo),
                             **ptxas.get(geo["nt"], {})))
    log(f"[phase8] K6-bf16 plans {json.dumps(recs)}")
    return recs


def _k6_configs():
    """K6's configurations in phase 8(a): (tag, decoder config, dtype)."""
    import torch
    from sdag_tpu_torch.models.llama import DecoderConfig
    from sdag_tpu_torch.models.native_ckpt import load_config
    return (("8b", DecoderConfig.llama3_8b(), torch.bfloat16),
            ("qa_ckpt", load_config(os.path.join(REPO, "experiments", "data",
                                                 "qa_ckpt")), torch.float32),
            ("8b_f32", DecoderConfig.llama3_8b(), torch.float32))


def _k6_rows_bit_equal(dev):
    """K6's plan ignores the row count, so at every product of each
    configuration the first rows of a 40-row product are the same bits as
    those rows alone (8 rows, 1 row): a window row equals a decode
    step's."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(81)
    recs = [_k6_rows_bit_equal_at(tag, cfg, dtype, g, dev)
            for tag, cfg, dtype in _k6_configs()]
    torch.cuda.empty_cache()
    return recs


def _k6_rows_bit_equal_at(tag, cfg, dtype, g, dev):
    import torch
    from sdag_tpu_torch.ops import int8_matmul as Q
    differing = {}
    for name, n, k, _count in k6_products(cfg):
        x = torch.randn(40, k, generator=g, device=dev).to(dtype)
        w = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                          dtype=torch.int8)
        s = torch.rand(n, generator=g, device=dev) * 2e-3 + 1e-4
        y40 = Q.int8_matmul_cuda(x, w, s)
        differing[name] = sum(
            int((Q.int8_matmul_cuda(x[:m].contiguous(), w, s)
                 != y40[:m]).sum()) for m in (8, 1))
    rec = {"name": tag, "dtype": str(dtype).replace("torch.", ""),
           "differing": differing}
    log(f"[phase8] K6 rows bit-equal across row counts {json.dumps(rec)}")
    if any(differing.values()):
        raise AssertionError(f"phase 8 {tag}: K6 rows differ between row "
                             f"counts: {differing}")
    return rec


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


def _p8_equality(gen, dev, kv_cache_dtype="int8", tag="phase 8"):
    """(c) one NO-ISO batch on an int8 tree (8(c): the 8B tree and the
    int8 cache; 9(d): the HF 8B tree in f32 and its native cache): graph
    equals eager, greedy and sampled, for plain decode and speculative
    rounds; greedy speculative tokens equal greedy plain tokens."""
    import torch
    from sdag_tpu_torch.sdag.generate import Generator
    rec = {}
    greedy = {}
    for name, draft in (("plain", 0), ("spec4", 4)):
        eng = Generator(gen.params, gen.cfg, gen.tokenizer, temperature=0.0,
                        batch_bucket=8, kv_cache_dtype=kv_cache_dtype,
                        speculative_draft=draft, device=dev)
        rec[name], greedy[name] = _decode_graph_vs_eager(
            eng, dev, tag=f"{tag} {name}", kv_cache_dtype=kv_cache_dtype,
            speculative_draft=draft)
    same = torch.equal(greedy["plain"][0], greedy["spec4"][0]) and \
        torch.equal(greedy["plain"][1], greedy["spec4"][1])
    rec["spec_equals_plain"] = {
        "equal": same, "tokens_differing": int(
            (greedy["plain"][0] != greedy["spec4"][0]).sum())}
    log(f"[{tag}] equality {json.dumps(rec)}")
    if not same:
        raise AssertionError(f"{tag}: greedy speculative tokens differ "
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
    recs = {"k6_bf16_plans": _k6_bf16_plans(dev), "k6": _k6_cases(dev),
            "k6_rows_bit_equal": _k6_rows_bit_equal(dev)}
    recs["k6_step_8b"] = {
        f"M{M}": _k6_step(recs["k6"], DecoderConfig.llama3_8b(), M,
                          "bfloat16") for M in (8, 40)}
    qa_cfg = load_config(os.path.join(REPO, "experiments", "data",
                                      "qa_ckpt"))
    recs["k6_step_qa_ckpt"] = {
        f"M{M}": _k6_step(recs["k6"], qa_cfg, M, "float32") for M in (8, 40)}
    recs["k6_step_8b_f32"] = {
        f"M{M}": _k6_step(recs["k6"], DecoderConfig.llama3_8b(), M,
                          "float32") for M in (8, 40)}
    log(f"[phase8] K6 a step {json.dumps(recs['k6_step_8b'])} "
        f"{json.dumps(recs['k6_step_qa_ckpt'])} "
        f"{json.dumps(recs['k6_step_8b_f32'])}")
    recs["main_path"], res = _p8_main_path(dev)
    recs["equality"] = _p8_equality(res.generator, dev)
    del res
    torch.cuda.empty_cache()
    recs["decode_configs"] = decode_configs(dev)
    recs["qa_ckpt"] = _p8_qa_ckpt(dev)
    return recs


# ---------------------------------------------------------------- phase 9
# HF checkpoints are written here without any library: the tokenizer files
# (a byte-level BPE learned in plain Python, a BERT WordPiece vocab), the
# safetensors shards (sdag_tpu_torch.models.safetensors_io) and config.json.

# Llama 3's pre-tokenizer regex (the Split pattern of its tokenizer.json)
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                  r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                  r"|\s+(?!\S)|\s+")
# Llama 3.1's special tokens, ids 128000-128255
LLAMA3_SPECIALS = (["<|begin_of_text|>", "<|end_of_text|>",
                    "<|reserved_special_token_0|>",
                    "<|reserved_special_token_1|>",
                    "<|finetune_right_pad_id|>",
                    "<|reserved_special_token_2|>", "<|start_header_id|>",
                    "<|end_header_id|>", "<|eom_id|>", "<|eot_id|>",
                    "<|python_tag|>"]
                   + [f"<|reserved_special_token_{i}|>"
                      for i in range(3, 248)])
LLAMA3_FIRST_SPECIAL = 128000
# a Llama-3.1-style chat template: the system block with its dates, then
# the turns, each trimmed, then the assistant header
LLAMA3_CHAT_TEMPLATE = (
    "{{- bos_token }}\n"
    "{%- if not date_string is defined %}\n"
    "    {%- set date_string = \"26 Jul 2024\" %}\n"
    "{%- endif %}\n"
    "{%- if messages[0]['role'] == 'system' %}\n"
    "    {%- set system_message = messages[0]['content'] | trim %}\n"
    "    {%- set messages = messages[1:] %}\n"
    "{%- else %}\n"
    "    {%- set system_message = \"\" %}\n"
    "{%- endif %}\n"
    "{{- \"<|start_header_id|>system<|end_header_id|>\\n\\n\" }}\n"
    "{{- \"Cutting Knowledge Date: December 2023\\n\" }}\n"
    "{{- \"Today Date: \" + date_string + \"\\n\\n\" }}\n"
    "{{- system_message }}\n"
    "{{- \"<|eot_id|>\" }}\n"
    "{%- for message in messages %}\n"
    "    {%- if message['role'] not in ['user', 'assistant'] %}\n"
    "        {{- raise_exception('Unknown role: ' + message['role']) }}\n"
    "    {%- endif %}\n"
    "    {{- '<|start_header_id|>' + message['role'] + "
    "'<|end_header_id|>\\n\\n' + message['content'] | trim + "
    "'<|eot_id|>' }}\n"
    "{%- endfor %}\n"
    "{%- if add_generation_prompt %}\n"
    "    {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}\n"
    "{%- endif %}\n")
HF_MIN_FREE_BYTES = 40e9
P9_LLAMA_DIR = "llama3_8b_hf"


def _world_texts(world_name="qa_ckpt"):
    """The phase's prompt text: every corpus doc, question and malicious
    doc of the synthetic world, and the RAG prompts' fixed text."""
    from sdag_tpu_torch.utils import prompts
    from sdag_tpu_torch.utils.synth_qa import (fact_doc, fact_query,
                                               load_world, malicious_doc)
    world = load_world(os.path.join(REPO, "experiments", "data", world_name,
                                    "world.json"))
    facts = world.facts_for(world.eval_entities) + world.facts_for(
        world.train_entities)
    texts = [prompts.SYSTEM_PROMPT_RAG, prompts.USER_RAG_PROMPT]
    for f in facts:
        texts += [fact_doc(f), fact_query(f), malicious_doc(f, "bodiku")]
    return texts


def train_byte_bpe(texts, n_merges):
    """Byte-level BPE learned in plain Python: pieces by Llama 3's
    pre-tokenizer, then the most frequent adjacent pair merged, n_merges
    times (ties broken by the pair).  Returns (vocab {token: id}, merges
    [(a, b)]), the 256 byte tokens first."""
    import re
    from collections import Counter
    from sdag_tpu_torch.models.hf_tokenizer import (bytes_to_unicode,
                                                    translate_regex)
    b2u = bytes_to_unicode()
    split = re.compile(translate_regex(LLAMA3_PATTERN))
    words = Counter()
    for t in texts:
        for piece in split.findall(t):
            words[tuple(b2u[b] for b in piece.encode("utf-8"))] += 1
    vocab = {b2u[b]: b for b in range(256)}
    merges = []
    for _ in range(n_merges):
        pairs = Counter()
        for w, c in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        if not pairs:
            break
        a, b = max(pairs, key=lambda p: (pairs[p], p))
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
        merged = Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    return vocab, merges


def write_llama_tokenizer(path, texts, n_merges=400):
    """tokenizer.json and tokenizer_config.json of a Llama-3-style
    tokenizer: byte-level BPE (merges learned from ``texts``), Llama 3's
    pre-tokenizer, a vocab of 128000 BPE tokens (the learned ones, then
    unreachable fillers), the special tokens at 128000-128255, BOS by the
    post-processor, ``<|eot_id|>`` as EOS, cleanup of tokenization spaces
    on, a Llama-3-style chat template."""
    vocab, merges = train_byte_bpe(texts, n_merges)
    # the tokenizers library numbers added tokens from the BPE vocab's
    # size: fill it to 128000 with tokens no text reaches (a character
    # outside the byte-level alphabet), as Llama 3's 128000 BPE tokens
    for i in range(len(vocab), LLAMA3_FIRST_SPECIAL):
        vocab[f"\u2603{i}"] = i
    added = [{"id": LLAMA3_FIRST_SPECIAL + i, "content": t,
              "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True}
             for i, t in enumerate(LLAMA3_SPECIALS)]
    bos = LLAMA3_SPECIALS[0]
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {"type": "ByteLevel", "add_prefix_space": True,
             "trim_offsets": False, "use_regex": True},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": bos, "type_id": 0}},
                      {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": bos, "type_id": 1}},
                      {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {bos: {"id": bos,
                                      "ids": [LLAMA3_FIRST_SPECIAL],
                                      "tokens": [bos]}}}]},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]},
    }
    config = {"bos_token": bos, "eos_token": "<|eot_id|>",
              "clean_up_tokenization_spaces": True,
              "model_input_names": ["input_ids", "attention_mask"],
              "model_max_length": 131072,
              "tokenizer_class": "PreTrainedTokenizerFast",
              "chat_template": LLAMA3_CHAT_TEMPLATE}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w",
              encoding="utf-8") as fh:
        json.dump(spec, fh, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w",
              encoding="utf-8") as fh:
        json.dump(config, fh, ensure_ascii=False, indent=1)
    return len(vocab), len(merges)


def write_bert_vocab(path, texts, vocab_size=30522):
    """A BERT WordPiece ``vocab.txt`` of exactly ``vocab_size`` lines
    (BERT's layout: [PAD] 0, [unused*], [UNK] 100, [CLS] 101, [SEP] 102,
    [MASK] 103; then every lowercased character alone and as a ``##``
    continuation, then the words of ``texts`` by frequency, then
    [unused*] to fill) and its tokenizer_config.json."""
    import re
    import unicodedata
    from collections import Counter
    lines = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + [
        "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    words, chars = Counter(), set()
    for t in texts:
        t = "".join(c for c in unicodedata.normalize("NFD", t.lower())
                    if unicodedata.category(c) != "Mn")
        for w in re.findall(r"\w+|[^\w\s]", t):
            words[w] += 1
            chars.update(w)
    for c in sorted(chars):
        lines += [c, "##" + c]
    lines += [w for w, _ in words.most_common() if len(w) > 1]
    lines = list(dict.fromkeys(lines))[:vocab_size]
    lines += [f"[unused{i}]" for i in range(99, 99 + vocab_size - len(lines))]
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(os.path.join(path, "tokenizer_config.json"), "w",
              encoding="utf-8") as fh:
        json.dump({"do_lower_case": True, "model_max_length": 512,
                   "tokenizer_class": "BertTokenizer"}, fh)
    return len(lines)


def llama_hf_specs(cfg):
    """(HF tensor name, [out, in] shape, std or None for a norm gain) of a
    LlamaForCausalLM at ``cfg``."""
    d, hd, ff, V = cfg.d_model, cfg.head_dim, cfg.d_ff, cfg.vocab_size
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    specs = [("model.embed_tokens.weight", (V, d), d ** -0.5)]
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        specs += [(p + "self_attn.q_proj.weight", (q, d), d ** -0.5),
                  (p + "self_attn.k_proj.weight", (kv, d), d ** -0.5),
                  (p + "self_attn.v_proj.weight", (kv, d), d ** -0.5),
                  (p + "self_attn.o_proj.weight", (d, q), q ** -0.5),
                  (p + "mlp.gate_proj.weight", (ff, d), d ** -0.5),
                  (p + "mlp.up_proj.weight", (ff, d), d ** -0.5),
                  (p + "mlp.down_proj.weight", (d, ff), ff ** -0.5),
                  (p + "input_layernorm.weight", (d,), None),
                  (p + "post_attention_layernorm.weight", (d,), None)]
    specs += [("model.norm.weight", (d,), None)]
    if not cfg.tie_embeddings:
        specs += [("lm_head.weight", (V, d), d ** -0.5)]
    return specs


def bert_hf_specs(cfg):
    """The same for a BertModel (``std`` 0.02 for biases and LayerNorm
    shifts)."""
    d, ff = cfg.d_model, cfg.d_ff
    e = "embeddings."
    specs = [(e + "word_embeddings.weight", (cfg.vocab_size, d), 0.02),
             (e + "position_embeddings.weight", (cfg.max_position, d), 0.02),
             (e + "token_type_embeddings.weight", (2, d), 0.02),
             (e + "LayerNorm.weight", (d,), None),
             (e + "LayerNorm.bias", (d,), 0.02)]
    for i in range(cfg.n_layers):
        p = f"encoder.layer.{i}."
        for m in ("attention.self.query", "attention.self.key",
                  "attention.self.value", "attention.output.dense"):
            specs += [(p + m + ".weight", (d, d), d ** -0.5),
                      (p + m + ".bias", (d,), 0.02)]
        specs += [(p + "attention.output.LayerNorm.weight", (d,), None),
                  (p + "attention.output.LayerNorm.bias", (d,), 0.02),
                  (p + "intermediate.dense.weight", (ff, d), d ** -0.5),
                  (p + "intermediate.dense.bias", (ff,), 0.02),
                  (p + "output.dense.weight", (d, ff), ff ** -0.5),
                  (p + "output.dense.bias", (d,), 0.02),
                  (p + "output.LayerNorm.weight", (d,), None),
                  (p + "output.LayerNorm.bias", (d,), 0.02)]
    return specs


def _draw(seed, shape, std, dtype, dev):
    """A tensor drawn on the card from its own seed: normal * std, or
    1 + 0.1 normal for a gain."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    t = torch.randn(shape, generator=g, device=dev, dtype=dtype)
    return t.mul_(0.1).add_(1.0) if std is None else t.mul_(std)


def write_hf_checkpoint(path, specs, dtype, dev, shards, seed):
    """Random weights in HF names and [out, in] layout, tensor i drawn
    from seed + i, written by save_safetensors as ``shards`` files with an
    index (one file: model.safetensors).  Returns (bytes, seconds)."""
    import torch
    from sdag_tpu_torch.models.safetensors_io import save_safetensors
    esize = torch.finfo(dtype).bits // 8
    total = sum(math.prod(shape) for _n, shape, _s in specs) * esize
    groups, acc = [[] for _ in range(shards)], 0
    for i, spec in enumerate(specs):
        n = math.prod(spec[1]) * esize
        groups[min(shards - 1, acc * shards // total)].append((i, spec))
        acc += n
    os.makedirs(path, exist_ok=True)
    t0 = time.perf_counter()
    weight_map, written = {}, 0
    for j, group in enumerate(groups):
        fname = ("model.safetensors" if shards == 1 else
                 f"model-{j + 1:05d}-of-{shards:05d}.safetensors")
        tensors = {name: _draw(seed + i, shape, std, dtype, dev)
                   for i, (name, shape, std) in group}
        written += save_safetensors(tensors, os.path.join(path, fname),
                                    metadata={"format": "pt"})
        weight_map.update({name: fname for name in tensors})
        del tensors
        torch.cuda.empty_cache()
    if shards > 1:
        with open(os.path.join(path, "model.safetensors.index.json"),
                  "w") as fh:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": weight_map}, fh, indent=1)
    return written, time.perf_counter() - t0


def _tree_leaf(params, name, llama):
    """The converted tree's leaf of an HF tensor, and whether the
    converter transposes it."""
    parts = name.split(".")
    if llama:
        top = {"model.embed_tokens.weight": ("embed", False),
               "model.norm.weight": ("final_norm", False),
               "lm_head.weight": ("lm_head", True)}
        if name in top:
            key, tr = top[name]
            return params[key], tr
        layer = params["layers"][int(parts[2])]
        sub = {"self_attn.q_proj": ("attn", "wq"),
               "self_attn.k_proj": ("attn", "wk"),
               "self_attn.v_proj": ("attn", "wv"),
               "self_attn.o_proj": ("attn", "wo"),
               "mlp.gate_proj": ("mlp", "gate"), "mlp.up_proj": ("mlp", "up"),
               "mlp.down_proj": ("mlp", "down")}
        mod = ".".join(parts[3:5])
        if mod in sub:
            a, b = sub[mod]
            return layer[a][b], True
        return layer["ln1" if parts[3] == "input_layernorm" else "ln2"], False
    e = {"embeddings.word_embeddings.weight": "word_emb",
         "embeddings.position_embeddings.weight": "pos_emb",
         "embeddings.token_type_embeddings.weight": "type_emb"}
    if name in e:
        return params[e[name]], False
    if parts[0] == "embeddings":
        return params["emb_ln"]["w" if parts[-1] == "weight" else "b"], False
    layer = params["layers"][int(parts[2])]
    wb = "w" if parts[-1] == "weight" else "b"
    rest = ".".join(parts[3:-1])
    if rest.endswith("LayerNorm"):
        ln = "ln1" if rest.startswith("attention") else "ln2"
        return layer[ln][wb], False
    attn = {"attention.self.query": "q", "attention.self.key": "k",
            "attention.self.value": "v", "attention.output.dense": "o"}
    if rest in attn:
        return layer["attn"][wb + attn[rest]], wb == "w"
    mlp = {"intermediate.dense": "1", "output.dense": "2"}
    return layer["mlp"][wb + mlp[rest]], wb == "w"


def _tree_bit_equal(params, specs, dtype, dev, seed, llama):
    """Every leaf equals the written tensor (regenerated from its seed)
    cast to float32 and transposed where the converter transposes, bit
    for bit.  Returns the names that differ."""
    import torch
    bad = []
    for i, (name, shape, std) in enumerate(specs):
        want = _draw(seed + i, shape, std, dtype, dev).float()
        leaf, tr = _tree_leaf(params, name, llama)
        if tr:
            want = want.t()
        if leaf.dtype != torch.float32 or not torch.equal(leaf, want):
            bad.append(name)
        del want
    return bad


def _p9_tokenizer_checks(tok):
    """Every eval fact's NO-ISO chat string (system prompt, the question
    and six docs) comes back from decode(encode(.)) with cleanup off; each
    special token's text maps to its id, BOS first."""
    from sdag_tpu_torch.utils import prompts
    from sdag_tpu_torch.utils.synth_qa import (fact_doc, fact_query,
                                               load_world, malicious_doc)
    world = load_world(os.path.join(REPO, "experiments", "data", "qa_ckpt",
                                    "world.json"))
    facts = world.facts_for(world.eval_entities)
    others = world.facts_for(world.train_entities)
    bad_round, bad_special, n, toks = [], [], 0, 0
    for i, f in enumerate(facts):
        docs = [malicious_doc(f, "bodiku"), fact_doc(f)] + [
            fact_doc(g) for g in others[4 * i:4 * i + 4]]
        user = prompts.USER_RAG_PROMPT.format(
            query=fact_query(f), docs_text=prompts.render_docs_text(docs))
        chat = tok.apply_chat_template(
            [{"role": "system", "content": prompts.SYSTEM_PROMPT_RAG},
             {"role": "user", "content": user}], tokenize=False,
            add_generation_prompt=True)
        ids = tok.encode(chat, add_special_tokens=False)
        n += 1
        toks += len(ids)
        if tok.decode(ids, clean_up_tokenization_spaces=False) != chat:
            bad_round.append(i)
        for j, sp in enumerate(LLAMA3_SPECIALS):
            if chat.count(sp) != ids.count(LLAMA3_FIRST_SPECIAL + j):
                bad_special.append((i, sp))
        if ids[0] != LLAMA3_FIRST_SPECIAL:
            bad_special.append((i, "first id"))
    return {"prompts": n, "mean_tokens": toks / n, "round_trip_failures":
            bad_round, "special_failures": bad_special[:10]}


def _p9_llama(dev, root):
    """(a) write the 8B checkpoint, (b) run the main path on it."""
    import torch
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.models.llama import DecoderConfig, prefill
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    from sdag_tpu_torch.pipeline.resources import init_resources
    from sdag_tpu_torch.utils.synth_qa import load_world
    cfg8 = DecoderConfig.llama3_8b()
    ckpt = os.path.join(root, P9_LLAMA_DIR)
    specs = llama_hf_specs(cfg8)
    seed = 900
    nbytes, write_s = write_hf_checkpoint(ckpt, specs, torch.bfloat16, dev,
                                          shards=4, seed=seed)
    write_llama_tokenizer(ckpt, _world_texts())
    hf_config = {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": cfg8.vocab_size, "hidden_size": cfg8.d_model,
        "intermediate_size": cfg8.d_ff,
        "num_hidden_layers": cfg8.n_layers,
        "num_attention_heads": cfg8.n_heads,
        "num_key_value_heads": cfg8.n_kv_heads, "head_dim": cfg8.head_dim,
        "max_position_embeddings": 131072, "rms_norm_eps": 1e-5,
        "rope_theta": cfg8.rope_theta,
        "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0,
                         "high_freq_factor": 4.0,
                         "original_max_position_embeddings": 8192,
                         "rope_type": "llama3"},
        "tie_word_embeddings": False, "torch_dtype": "bfloat16",
        "bos_token_id": 128000, "eos_token_id": [128001, 128008, 128009],
        "hidden_act": "silu", "attention_bias": False, "mlp_bias": False}
    with open(os.path.join(ckpt, "config.json"), "w") as fh:
        json.dump(hf_config, fh, indent=1)
    log(f"[phase9] wrote the 8B checkpoint: {nbytes / 1e9:.3f} GB in 4 "
        f"shards, {write_s:.2f} s = {nbytes / 1e9 / write_s:.3f} GB/s "
        "(drawn on the card, copied to the host, written)")

    world = load_world(os.path.join(REPO, "experiments", "data", "qa_ckpt",
                                    "world.json"))
    cfg, facts = _synth_cfg(os.path.join(root, "run_8b"), world,
                            world.eval_entities[:4], 1, world.seed + 3, 1,
                            LLM_CHECKPOINT=ckpt, MAX_GEN_TOKENS_RAG=32,
                            BM25_ENGINE="scan")
    n = len(facts)
    if n < 16:
        raise AssertionError(f"phase 9 needs >= 16 queries, got {n}")
    _free_cuda()
    torch.cuda.reset_peak_memory_stats(dev)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    res = init_resources(cfg, device=dev)
    torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    gen = res.generator
    tok_rec = _p9_tokenizer_checks(gen.tokenizer)
    bad = _tree_bit_equal(gen.params, specs, torch.bfloat16, dev, seed,
                          llama=True)
    t1 = time.perf_counter()
    metrics = run_experiment(cfg, resources=res, device=dev)
    torch.cuda.synchronize(dev)
    run_s = time.perf_counter() - t1
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    batches = sum(math.ceil(min(cfg.BATCH_SIZE_EMBED_Q, n - i)
                            / cfg.LLM_BATCH_SIZE)
                  for i in range(0, n, cfg.BATCH_SIZE_EMBED_Q))
    need_k1 = gen.cfg.n_layers * 2 * batches
    st = gen.stats
    ids = torch.tensor([[128000, 2, 3] + [65] * 125], dtype=torch.int32,
                       device=dev)
    logits, _ = prefill(gen.params, gen.cfg, ids, with_cache=False,
                        logits_last_only=True)
    base = cfg.OUTPUT_CSV_BASE + "_top_k=5_attacker_pos=1"
    rec = {"queries": n, "cut": "24 queries, 32 new tokens (width and "
           "depth are Llama-3.1-8B's)",
           "checkpoint_gb": nbytes / 1e9, "write_s": write_s,
           "write_gb_s": nbytes / 1e9 / write_s,
           "load_s": load_s, "load_gb_s": nbytes / 1e9 / load_s,
           "tree_dtype": str(gen.cfg.dtype), "tree_mismatches": bad[:10],
           "tokenizer": tok_rec, "launches": launches,
           "k1_launches_needed": need_k1, "run_s": run_s,
           "prefill_tokens": st["prefill_tokens"],
           "prefill_s": st["prefill_s"],
           "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
           "decode_tokens": st["decode_tokens"], "decode_s": st["decode_s"],
           "decode_tok_s": st["decode_tokens"] / st["decode_s"],
           "decode_steps": st["decode_steps"],
           "decode_ms_per_step": 1e3 * st["decode_s"] / st["decode_steps"],
           "graph_captures": st["graph_captures"],
           "peak_mem_gib": peak / 2 ** 30,
           "acc_iso": metrics[(5, 1)]["answer_match_stats"]["iso"][
               "ground_truth_match_rate"],
           "outputs_written": all(os.path.isfile(base + ext)
                                  for ext in (".csv", ".json")),
           "logits_finite": bool(torch.isfinite(logits).all()),
           "logits_shape": list(logits.shape)}
    rec["profile"] = _profile_window(gen, dev)
    log(f"[phase9] 8B HF {json.dumps(rec)}")
    del res, gen, logits
    _free_cuda()
    if bad:
        raise AssertionError(f"phase 9: {len(bad)} tensors of the loaded "
                             f"8B tree differ from the written ones: "
                             f"{bad[:5]}")
    if rec["tree_dtype"] != "torch.float32":
        raise AssertionError(f"phase 9: the HF tree is {rec['tree_dtype']},"
                             " not float32")
    if tok_rec["round_trip_failures"] or tok_rec["special_failures"]:
        raise AssertionError(f"phase 9: tokenizer checks failed: {tok_rec}")
    if launches.get("sdag_prefill_f32", 0) < need_k1:
        raise AssertionError(
            f"phase 9: K1-f32 launched {launches.get('sdag_prefill_f32', 0)}"
            f" < {need_k1}")
    if launches.get("bm25_scan_topk", 0) < 1:
        raise AssertionError("phase 9: K2 never launched")
    if not rec["outputs_written"] or not rec["logits_finite"] or \
            rec["logits_shape"] != [1, 1, cfg8.vocab_size]:
        raise AssertionError(f"phase 9: bad outputs {rec}")
    return rec


def _p9_llama_int8(dev, root):
    """(d) the 8B checkpoint of (a) served with int8 weights and
    speculation (D = 4, a window of 8 x 5 = 40 rows): the float32 tree is
    quantized on load, the activations stay float32, so every decode
    product runs K6's f32 body; (b)'s 24 queries and 32 new tokens.
    Counts zeroed before the run and read after."""
    import torch
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    from sdag_tpu_torch.pipeline.resources import init_resources
    from sdag_tpu_torch.utils.synth_qa import load_world
    world = load_world(os.path.join(REPO, "experiments", "data", "qa_ckpt",
                                    "world.json"))
    cfg, facts = _synth_cfg(os.path.join(root, "run_8b_int8"), world,
                            world.eval_entities[:4], 1, world.seed + 3, 1,
                            LLM_CHECKPOINT=os.path.join(root, P9_LLAMA_DIR),
                            MAX_GEN_TOKENS_RAG=32, BM25_ENGINE="scan",
                            LLM_WEIGHTS_DTYPE="int8", SPECULATIVE_DRAFT_LEN=4)
    _free_cuda()
    torch.cuda.reset_peak_memory_stats(dev)
    LAUNCHES.clear()
    t0 = time.perf_counter()
    res = init_resources(cfg, device=dev)
    torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    gen = res.generator
    t1 = time.perf_counter()
    run_experiment(cfg, resources=res, device=dev)
    torch.cuda.synchronize(dev)
    run_s = time.perf_counter() - t1
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    p = gen.params
    mats = [p["embed"], p["lm_head"]] + [
        leaf for layer in p["layers"] for part in ("attn", "mlp")
        for leaf in layer[part].values()]
    st = gen.stats
    base = cfg.OUTPUT_CSV_BASE + "_top_k=5_attacker_pos=1"
    rec = {"queries": len(facts), "cut": "24 queries, 32 new tokens (width "
           "and depth are Llama-3.1-8B's)",
           "load_and_quantize_s": load_s, "run_s": run_s,
           "matrices": len(mats),
           "matrices_int8": all(isinstance(m, dict)
                                and m["w"].dtype == torch.int8 for m in mats),
           "activation_dtype": str(gen.cfg.dtype), "launches": launches,
           "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
           "decode_tokens": st["decode_tokens"], "decode_s": st["decode_s"],
           "decode_tok_s": st["decode_tokens"] / st["decode_s"],
           "rounds_run": st["decode_steps"],
           "ms_per_round": 1e3 * st["decode_s"] / st["decode_steps"],
           "graph_captures": st["graph_captures"], "spec": _spec_stats(gen),
           "peak_mem_gib": peak / 2 ** 30,
           "outputs_written": all(os.path.isfile(base + ext)
                                  for ext in (".csv", ".json"))}
    rec["profile"] = _profile_window(gen, dev)
    log(f"[phase9] 8B HF int8 + speculation {json.dumps(rec)}")
    rec["equality"] = _p8_equality(gen, dev, kv_cache_dtype="native",
                                   tag="phase 9(d)")
    del res, gen, p, mats
    _free_cuda()
    if not rec["matrices_int8"] or rec["activation_dtype"] != \
            "torch.float32":
        raise AssertionError(f"phase 9(d): the tree is not int8 matrices "
                             f"with float32 activations: {rec}")
    if launches.get("int8_matmul_f32", 0) < 225:
        raise AssertionError(f"phase 9(d): K6-f32 launched "
                             f"{launches.get('int8_matmul_f32', 0)} < 225 "
                             "(one round's products)")
    # the windows attend row by row through K7's f32 body (two launches a
    # row and layer)
    for key in ("sdag_prefill_f32", "bm25_scan_topk", "decode_attention"):
        if not launches.get(key, 0):
            raise AssertionError(f"phase 9(d): {key} never launched")
    if not rec["outputs_written"]:
        raise AssertionError(f"phase 9(d): outputs missing: {rec}")
    return rec


def _free_cuda():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _unfused_encoder_tree(params):
    """An encoder tree with fused QKV (as E5Encoder holds it on CUDA) split
    back into wq/wk/wv and their biases (views, no copies); a plain tree
    as it is."""
    plain = dict(params, layers=[])
    for layer in params["layers"]:
        a = layer["attn"]
        if "wqkv" not in a:
            plain["layers"].append(layer)
            continue
        wq, wk, wv = a["wqkv"].chunk(3, dim=1)
        bq, bk, bv = a["bqkv"].chunk(3)
        plain["layers"].append(dict(layer, attn={
            "wq": wq, "wk": wk, "wv": wv, "bq": bq, "bk": bk, "bv": bv,
            "wo": a["wo"], "bo": a["bo"]}))
    return plain


def _p9_ranker(dev, root):
    """(c) an e5-large-v2-width BERT checkpoint (f32, as intfloat ships
    it) with a WordPiece vocab, through hybrid exact search on a float32
    index beside qa_ckpt_v4."""
    import dataclasses
    import numpy as np
    import torch
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.models.e5 import E5Encoder, EncoderConfig
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    from sdag_tpu_torch.pipeline.resources import (init_resources,
                                                   load_corpus_jsonl)
    from sdag_tpu_torch.utils.synth_qa import load_world
    ecfg = dataclasses.replace(EncoderConfig.e5_large_v2(),
                               dtype=torch.float32)
    ckpt = os.path.join(root, "e5_large_v2_hf")
    specs = bert_hf_specs(ecfg)
    seed = 5000
    nbytes, write_s = write_hf_checkpoint(ckpt, specs, torch.float32, dev,
                                          shards=1, seed=seed)
    n_vocab = write_bert_vocab(ckpt, _world_texts("qa_ckpt_v4"),
                               ecfg.vocab_size)
    with open(os.path.join(ckpt, "config.json"), "w") as fh:
        json.dump({"architectures": ["BertModel"], "model_type": "bert",
                   "vocab_size": ecfg.vocab_size,
                   "hidden_size": ecfg.d_model,
                   "num_hidden_layers": ecfg.n_layers,
                   "num_attention_heads": ecfg.n_heads,
                   "intermediate_size": ecfg.d_ff, "hidden_act": "gelu",
                   "max_position_embeddings": ecfg.max_position,
                   "type_vocab_size": 2, "layer_norm_eps": 1e-12,
                   "torch_dtype": "float32"}, fh, indent=1)
    ckpt_v4 = os.path.join(REPO, "experiments", "data", "qa_ckpt_v4")
    world = load_world(os.path.join(ckpt_v4, "world.json"))
    cfg, facts = _synth_cfg(
        os.path.join(root, "run_ranker"), world, world.eval_entities[:4], 1,
        world.seed + 1, 1, LLM_CHECKPOINT=ckpt_v4, RANKER_CHECKPOINT=ckpt,
        DENSE_INDEX_PATH="", RETRIEVER_BACKEND="sparse_and_dense",
        DENSE_SEARCH_MODE="exact", DENSE_INDEX_DTYPE="float32",
        MALICIOUS_DOC_SELECTION_STRATEGY="closest_to_centroid")
    _free_cuda()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    res = init_resources(cfg, device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    enc = res.ranker
    metrics = run_experiment(cfg, resources=res, device=dev)
    torch.cuda.synchronize(dev)
    launches = dict(LAUNCHES)
    need_k3 = enc.cfg.n_layers * enc.stats["batches"]
    # the encoder holds the fused-QKV tree: split it back for the check
    plain_tree = _unfused_encoder_tree(enc.params)
    bad = _tree_bit_equal(plain_tree, specs, torch.float32, dev, seed,
                          llama=False)
    ok, mism = _dense_hits_agree(res, cfg, _first_batch_questions(cfg))
    texts, _ = load_corpus_jsonl(cfg.CORPUS_JSONL_PATH)
    batch = texts[:32]
    fused = enc.encode(batch, kind="passage", batch_size=32)
    plain = E5Encoder(enc.params, enc.cfg, enc.tokenizer,
                      model_name=cfg.RANKER_MODEL_NAME, fused=False,
                      device=dev).encode(batch, kind="passage",
                                         batch_size=32)
    err = float(np.abs(fused - plain).max())
    # K3-f32 and K4-f32 timed at this path's shapes: the first passage
    # batch through the WordPiece tokenizer (random q/k/v), the float32
    # index against the first batch's query embeddings
    ids, mask = enc._tokenize(enc._prefix(batch, "passage"))
    g = torch.Generator(device=dev)
    g.manual_seed(19)
    qkv = torch.randn(*ids.shape, 3 * ecfg.d_model, generator=g, device=dev)
    vl = torch.from_numpy(mask.sum(1).astype(np.int32)).to(dev)
    k3 = _k3_case("hf_ranker_batch_f32", qkv, vl, ecfg.n_heads, timed=True)
    index = res.dense_index
    qe = torch.from_numpy(np.ascontiguousarray(enc.encode(
        _first_batch_questions(cfg), kind="query"))).to(dev)
    k4 = _k4_case("hf_ranker_f32", qe, index.embeddings, max(cfg.TOP_K),
                  index.valid_n)
    del qkv
    m = metrics[(5, 1)]["answer_match_stats"]
    out = cfg.OUTPUT_CSV_BASE + "_top_k=5_attacker_pos=1"
    rec = {"queries": len(facts), "checkpoint_gb": nbytes / 1e9,
           "write_s": write_s, "vocab_lines": n_vocab,
           "init_s": init_s, "load_gb_s": nbytes / 1e9 / init_s,
           "tokenizer": type(enc.tokenizer).__name__,
           "cls_sep": [enc.tokenizer.cls_token_id,
                       enc.tokenizer.sep_token_id],
           "encoder": {"layers": enc.cfg.n_layers, "d_model":
                       enc.cfg.d_model, "dtype": str(enc.cfg.dtype),
                       "fused": enc.fused, "batches": enc.stats["batches"],
                       "tokens": enc.stats["tokens"],
                       "seconds": enc.stats["seconds"]},
           "launches": launches, "k3_f32_launches_needed": need_k3,
           "tree_mismatches": bad[:10], "dense_hits_agree": ok,
           "dense_index_mismatches": mism,
           "fused_vs_plain_max_abs_err": err, "tol": F32_TOL,
           "k3_f32": k3, "k4_f32": k4,
           "acc_iso": m["iso"]["ground_truth_match_rate"],
           "outputs_written": all(os.path.isfile(out + ext)
                                  for ext in (".csv", ".json"))}
    log(f"[phase9] e5-large-v2 HF ranker {json.dumps(rec)}")
    del res, enc, plain_tree
    _free_cuda()
    if bad:
        raise AssertionError(f"phase 9: {len(bad)} ranker tensors differ "
                             f"from the written ones: {bad[:5]}")
    if launches.get("encoder_attention_f32", 0) != need_k3 or not need_k3 \
            or launches.get("encoder_attention_bf16", 0):
        raise AssertionError(f"phase 9 ranker: K3 launches {launches}, "
                             f"need {need_k3} of the f32 body")
    if not launches.get("topk_matmul_f32", 0):
        raise AssertionError("phase 9 ranker: K4-f32 never launched")
    if rec["cls_sep"] != [101, 102]:
        raise AssertionError(f"phase 9 ranker: [CLS]/[SEP] ids "
                             f"{rec['cls_sep']}")
    if not ok or not err <= F32_TOL or not rec["outputs_written"]:
        raise AssertionError(f"phase 9 ranker: {rec}")
    return rec


def phase9(dev):
    """The checkpoints go to a temporary directory outside the repo,
    removed when the phase ends, pass or fail."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_hf_") as root:
        free = shutil.disk_usage(root).free / 1e9
        log(f"[phase9] {free:.1f} GB free under {root}")
        if free * 1e9 < HF_MIN_FREE_BYTES:
            raise AssertionError(
                f"phase 9: {free:.1f} GB free under {root}, under the "
                f"{HF_MIN_FREE_BYTES / 1e9:.0f} GB the 8B checkpoint (16.1 "
                "GB) and the ranker (1.3 GB) need; the model is not cut")
        return {"free_gb": free, "llama3_8b": _p9_llama(dev, root),
                "llama3_8b_int8": _p9_llama_int8(dev, root),
                "e5_large_v2": _p9_ranker(dev, root)}


# ------------------------------------------------------------- phase 10
P10_DIR = os.path.join(OUT_DIR, "chip_smoke_phase10")
SDAG_EFFECT_REF = os.path.join(REPO, "experiments", "results",
                               "sdag_effect_jax_cpu")
# 10(b): a doc whose keep decision differs between the card and the CPU
# is exempt when its z-score or one of its pair similarities is this close
# to the defense's threshold
FILTER_MARGIN = 1e-2
# 10(b): the most that the card's bf16 encoder (K3) may move a z-score or
# a pair similarity from the plain f32 path on the CPU, about three times
# the readings on an H100 (0.122-0.135 and 0.0015, PERF.md section 6)
FILTER_Z_MAX_DIFF = 0.35
FILTER_PAIR_MAX_DIFF = 5e-3
# 10(e): rows of a 96-row cell that may differ from the JAX CPU reference
# (greedy tokens flip only at near-ties of f32 logits)
GRID_MAX_DIFF = 2


def _experiment_module(name):
    """A script of experiments/ (not a package) as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "experiments", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _outputs_written(cfg, pos=1):
    base = cfg.OUTPUT_CSV_BASE + f"_top_k=5_attacker_pos={pos}"
    return all(os.path.isfile(base + ext) for ext in (".csv", ".json"))


def _p10_discern(dev):
    """(a) Discern-and-Answer at llama3-8b width: 8 attacked queries, the
    local batched classifier; then the same run from the saved labels."""
    import torch
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.defenses.cache import load_discern_labels_jsonl
    from sdag_tpu_torch.defenses.discern import _CLASSIFIER_SYSTEM
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    from sdag_tpu_torch.pipeline.resources import init_resources
    from sdag_tpu_torch.utils.synth_qa import load_world
    world = load_world(os.path.join(REPO, "experiments", "data", "qa_ckpt",
                                    "world.json"))
    over = dict(LLM_ARCH="llama3-8b", MAX_MALICIOUS_DOCS_PER_QUERY=2,
                MAX_GEN_TOKENS_RAG=16, BM25_ENGINE="scan", SAMPLE_SIZE=8,
                DEFENSE_BACKEND="discern_and_answer",
                DISCERN_LABELS_SAVE_SUFFIX="discern_labels.jsonl")
    cfg, _ = _synth_cfg(os.path.join(P10_DIR, "discern"), world,
                        world.eval_entities[:2], 2, world.seed + 5, 1,
                        **over)
    labels_path = f"{cfg.OUTPUT_CSV_BASE}_{cfg.DISCERN_LABELS_SAVE_SUFFIX}"
    cfg2, _ = _synth_cfg(os.path.join(P10_DIR, "discern_cached"), world,
                         world.eval_entities[:2], 2, world.seed + 5, 1,
                         DISCERN_LABELS_LOAD_PATH=labels_path, **over)
    _free_cuda()
    t0 = time.perf_counter()
    res = init_resources(cfg, device=dev)
    init_s = time.perf_counter() - t0
    gen = res.generator
    tok = gen.tokenizer
    plain_generate_ids = gen.generate_ids
    counts = {}

    def counted(ids, max_new_tokens=128):
        """Classifier calls are the ones whose prompt carries the
        classifier's system message."""
        kind = ("classifier" if _CLASSIFIER_SYSTEM in tok.decode(
            [int(t) for t in ids[0]]) else "other")
        counts[kind + "_calls"] = counts.get(kind + "_calls", 0) + 1
        counts[kind + "_prompts"] = counts.get(kind + "_prompts", 0) + len(ids)
        counts[kind + "_prompt_tokens"] = (counts.get(kind + "_prompt_tokens",
                                                      0)
                                           + sum(len(x) for x in ids))
        return plain_generate_ids(ids, max_new_tokens=max_new_tokens)

    gen.generate_ids = counted
    runs = {}
    try:
        for tag, c in (("classify", cfg), ("from_labels", cfg2)):
            counts.clear()
            LAUNCHES.clear()
            captures = gen.stats["graph_captures"]
            t0 = time.perf_counter()
            m = run_experiment(c, resources=res, device=dev)[(5, 1)]
            torch.cuda.synchronize(dev)
            runs[tag] = {
                "run_s": time.perf_counter() - t0,
                "defense_s": m["phase_timings"]["defense"]["total_s"],
                "calls": dict(counts), "launches": dict(LAUNCHES),
                "graph_captures": gen.stats["graph_captures"] - captures,
                "outputs_written": _outputs_written(c),
                "asr_iso": m["answer_match_stats"]["iso"][
                    "false_answer_match_rate"],
                "asr_noiso": m["answer_match_stats"]["no_iso"][
                    "false_answer_match_rate"]}
    finally:
        gen.generate_ids = plain_generate_ids
    labels = load_discern_labels_jsonl(labels_path)
    with open(labels_path, encoding="utf-8") as fh:
        label_lines = [json.loads(line) for line in fh if line.strip()]
    first, second = runs["classify"], runs["from_labels"]
    n_layers = gen.cfg.n_layers
    k1 = [r["launches"].get("sdag_prefill_bf16", 0) for r in (first, second)]
    calls = first["calls"].get("classifier_calls", 0)
    prompts = first["calls"].get("classifier_prompts", 0)
    rec = {"init_s": init_s, "n_layers": n_layers, "runs": runs,
           "labels": len(labels), "label_lines": len(label_lines),
           "perturbed": sum(v == "perturbed" for v in labels.values()),
           "clean": sum(v == "clean" for v in labels.values()),
           "k1_saved": k1[0] - k1[1], "k1_saved_needed": n_layers * calls,
           "classifier_prompts_s": prompts / first["defense_s"],
           "classifier_prompt_tok_s":
               first["calls"].get("classifier_prompt_tokens", 0)
               / first["defense_s"]}
    log(f"[phase10] (a) discern {json.dumps(rec)}")
    del res, gen
    _free_cuda()
    if not calls or second["calls"].get("classifier_calls", 0):
        raise AssertionError(f"phase 10(a): classifier calls {calls} in the "
                             "first run, "
                             f"{second['calls'].get('classifier_calls', 0)}"
                             " from the labels file")
    if len(label_lines) != prompts or len(labels) != prompts or any(
            line.get("label") not in ("clean", "perturbed")
            for line in label_lines):
        raise AssertionError(f"phase 10(a): {len(label_lines)} label lines "
                             f"({len(labels)} valid) for {prompts} "
                             "classified (query, doc) pairs")
    if rec["k1_saved"] != rec["k1_saved_needed"]:
        raise AssertionError(f"phase 10(a): the label cache saved "
                             f"{rec['k1_saved']} K1 launches, not "
                             f"{n_layers} x {calls} classifier calls")
    if not (first["outputs_written"] and second["outputs_written"]):
        raise AssertionError("phase 10(a): CSV/JSON outputs missing")
    return rec


class _TextCacheEncoder:
    """Embeddings text by text: a call's missing texts are encoded
    together, the rest looked up.  A row's embedding does not depend on
    the batch around it beyond rounding (padded keys are masked, pooling
    is over the valid tokens), so the check encodes each distinct text
    once."""

    def __init__(self, enc):
        self.enc, self.rows = enc, {}

    def encode(self, texts, kind="passage", batch_size=32):
        import numpy as np
        missing = list(dict.fromkeys(t for t in texts
                                     if (kind, t) not in self.rows))
        if missing:
            for t, e in zip(missing, self.enc.encode(
                    missing, kind=kind, batch_size=batch_size)):
                self.rows[(kind, t)] = e
        return np.stack([self.rows[(kind, t)] for t in texts])


def _near_threshold(defense, z, pair, i):
    """Whether nonempty doc i's keep decision lies within FILTER_MARGIN of
    a threshold: its z-score, or its similarity to another doc."""
    import numpy as np
    others = np.delete(pair[i], i)
    return bool(abs(z[i] - defense.z_threshold) < FILTER_MARGIN
                or (np.abs(others - defense.duplicate_sim)
                    < FILTER_MARGIN).any())


def _p10_ragdefender(dev):
    """(b) RAGDefender at e5-large-v2 width (random bf16 weights) beside
    qa_ckpt: the card's kept docs against the plain path on the CPU."""
    import dataclasses
    import torch
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.defenses import ragdefender as R
    from sdag_tpu_torch.models.e5 import E5Encoder
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    from sdag_tpu_torch.pipeline.resources import init_resources
    from sdag_tpu_torch.utils.synth_qa import load_world
    ckpt = os.path.join(REPO, "experiments", "data", "qa_ckpt")
    world = load_world(os.path.join(ckpt, "world.json"))
    cfg, facts = _synth_cfg(os.path.join(P10_DIR, "ragdefender"), world,
                            world.eval_entities[4:8], 2, world.seed + 6, 1,
                            LLM_CHECKPOINT=ckpt, RANKER_ARCH="e5-large-v2",
                            MAX_MALICIOUS_DOCS_PER_QUERY=2, SAMPLE_SIZE=24,
                            DEFENSE_BACKEND="ragdefender")
    _free_cuda()
    res = init_resources(cfg, device=dev)
    enc = res.ranker
    calls = []
    plain_defend = R.EmbeddingFilterDefense._defend

    def recorded(self, query, docs):
        kept = plain_defend(self, query, docs)
        calls.append((query, list(docs), kept))
        return kept

    LAUNCHES.clear()
    R.EmbeddingFilterDefense._defend = recorded
    try:
        t0 = time.perf_counter()
        m = run_experiment(cfg, resources=res, device=dev)[(5, 1)]
        torch.cuda.synchronize(dev)
        run_s = time.perf_counter() - t0
    finally:
        R.EmbeddingFilterDefense._defend = plain_defend
    launches = dict(LAUNCHES)
    need_k3 = enc.cfg.n_layers * enc.stats["batches"]
    enc_stats = dict(enc.stats)
    # the same weights on the CPU, plain attention, in float32 (bf16
    # products on the chip machine's CPU took 136 s for this check)
    cpu_params = _tree_to(_unfused_encoder_tree(enc.params), "cpu",
                          torch.float32)
    cpu_enc = _TextCacheEncoder(E5Encoder(
        cpu_params, dataclasses.replace(enc.cfg, dtype=torch.float32),
        enc.tokenizer, model_name=cfg.RANKER_MODEL_NAME, fused=False,
        device="cpu"))
    card_enc = _TextCacheEncoder(enc)
    card_f = R.EmbeddingFilterDefense(card_enc)
    cpu_f = R.EmbeddingFilterDefense(cpu_enc)
    n_mal = cfg.MAX_MALICIOUS_DOCS_PER_QUERY
    mismatches, exempt = [], []
    mal_dropped = corpus_dropped = n_corpus = near_docs = 0
    z_err = pair_err = 0.0
    t0 = time.perf_counter()
    for e in (card_enc, cpu_enc):
        e.encode(sorted({d for _, docs, _ in calls for d in docs
                         if d and d.strip()}), kind="passage",
                 batch_size=64)
        e.encode(sorted({q for q, _, _ in calls}), kind="query",
                 batch_size=64)
    for query, docs, kept in calls:
        kp = cpu_f._defend(query, docs)
        card_s, cpu_s = card_f._scores(query, docs), cpu_f._scores(query,
                                                                   docs)
        near = set()
        if card_s is not None:
            (idx, zc, pc), (_, zp, pp) = card_s, cpu_s
            z_err = max(z_err, float(abs(zc - zp).max()))
            pair_err = max(pair_err, float(abs(pc - pp).max()))
            near = {docs[idx[i]] for i in range(len(idx))
                    if _near_threshold(card_f, zc, pc, i)
                    or _near_threshold(cpu_f, zp, pp, i)}
            near_docs += sum(d in near for d in docs)
        if kept != kp:
            differ = set(kept) ^ set(kp)
            row = {"query": query, "card": kept, "cpu": kp,
                   "differ": sorted(differ)}
            (exempt if differ <= near else mismatches).append(row)
        mal_dropped += sum(d not in kept for d in docs[:n_mal])
        corpus_dropped += sum(d not in kept for d in docs[n_mal:])
        n_corpus += len(docs) - n_mal
    check_s = time.perf_counter() - t0
    rec = {"queries": len(facts), "filter_calls": len(calls),
           "run_s": run_s, "cpu_check_s": check_s,
           "cpu_texts": len(cpu_enc.rows), "launches": launches,
           "k3_launches_needed": need_k3, "encoder": enc_stats,
           "encoder_tok_s": enc_stats["tokens"] / enc_stats["seconds"],
           "malicious_dropped_share": mal_dropped / (n_mal * len(calls)),
           "corpus_dropped_share": corpus_dropped / n_corpus,
           "z_max_abs_diff": z_err, "pair_sim_max_abs_diff": pair_err,
           "z_max_abs_diff_limit": FILTER_Z_MAX_DIFF,
           "pair_sim_max_abs_diff_limit": FILTER_PAIR_MAX_DIFF,
           "docs": sum(len(docs) for _, docs, _ in calls),
           "near_threshold_docs": near_docs,
           "kept_mismatches": mismatches,
           "near_threshold_exempt_queries": exempt,
           "outputs_written": _outputs_written(cfg),
           "asr_iso": m["answer_match_stats"]["iso"][
               "false_answer_match_rate"],
           "asr_noiso": m["answer_match_stats"]["no_iso"][
               "false_answer_match_rate"]}
    log(f"[phase10] (b) ragdefender {json.dumps(rec)}")
    log(f"[phase10] (b) {near_docs} of {rec['docs']} docs near a "
        f"threshold; {len(exempt)} queries keep other docs on the card "
        "only where the docs are near a threshold")
    for e in exempt:
        log(f"[phase10] (b) near the threshold, exempt: {json.dumps(e)}")
    del res, enc, card_enc, cpu_enc, cpu_params
    _free_cuda()
    if launches.get("encoder_attention_bf16", 0) != need_k3 or not need_k3:
        raise AssertionError(f"phase 10(b): K3 launches {launches}, need "
                             f"{need_k3} of the bf16 body")
    if len(calls) != len(facts) or mismatches:
        raise AssertionError(
            f"phase 10(b): {len(calls)} filter calls for {len(facts)} "
            f"queries, {len(mismatches)} kept-doc mismatches against the "
            f"CPU: {mismatches[:3]}")
    if z_err > FILTER_Z_MAX_DIFF or pair_err > FILTER_PAIR_MAX_DIFF:
        raise AssertionError(
            f"phase 10(b): the card moves z-scores by {z_err} (at most "
            f"{FILTER_Z_MAX_DIFF}) and pair similarities by {pair_err} (at "
            f"most {FILTER_PAIR_MAX_DIFF}) from the CPU's")
    if not rec["outputs_written"]:
        raise AssertionError("phase 10(b): CSV/JSON outputs missing")
    return rec


def _tree_to(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype)


def _npz_members(path):
    import zipfile
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def _same_dir(a, b):
    """Names of the files that differ between two index directories (an
    npz member by member: its zip headers carry the write time)."""
    names = sorted(set(os.listdir(a)) | set(os.listdir(b)))
    bad = []
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if not (os.path.isfile(pa) and os.path.isfile(pb)):
            bad.append(n)
        elif n.endswith(".npz"):
            if _npz_members(pa) != _npz_members(pb):
                bad.append(n)
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                if fa.read() != fb.read():
                    bad.append(n)
    return bad


def _p10_build_index(dev):
    """(c) build_index on the card over phase 7's corpus: --bm25, then
    dense at e5-large-v2 (random bf16 weights); both served."""
    import numpy as np
    import torch
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.config import Config
    from sdag_tpu_torch.pipeline import build_index
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    from sdag_tpu_torch.pipeline.resources import (build_encoder,
                                                   init_resources,
                                                   load_corpus_jsonl)
    from sdag_tpu_torch.retrieval.dense import DenseIndex
    from sdag_tpu_torch.retrieval.sparse import BM25Index
    from sdag_tpu_torch.utils.synth_qa import (fact_query, load_world,
                                               write_corpus_jsonl)
    ckpt = os.path.join(REPO, "experiments", "data", "qa_ckpt_v4")
    world = load_world(os.path.join(ckpt, "world.json"))
    base = os.path.join(P10_DIR, "build_index")
    for sub in ("bm25", "bm25_ref", "dense"):
        shutil.rmtree(os.path.join(base, sub), ignore_errors=True)
    os.makedirs(base, exist_ok=True)
    corpus = os.path.join(base, "corpus.jsonl")
    write_corpus_jsonl(world, corpus)
    texts, ids = load_corpus_jsonl(corpus)
    bm25_dir, dense_dir = (os.path.join(base, "bm25"),
                           os.path.join(base, "dense"))
    _free_cuda()
    t0 = time.perf_counter()
    build_index.main([corpus, bm25_dir, "--bm25", "--device", "cuda"])
    bm25_s = time.perf_counter() - t0
    BM25Index.from_texts(texts, ids, device=dev).save(
        os.path.join(base, "bm25_ref"))
    bm25_differ = _same_dir(bm25_dir, os.path.join(base, "bm25_ref"))
    LAUNCHES.clear()
    t0 = time.perf_counter()
    build_index.main([corpus, dense_dir, "--ranker-arch", "e5-large-v2",
                      "--dtype", "bfloat16", "--device", "cuda"])
    torch.cuda.synchronize(dev)
    dense_s = time.perf_counter() - t0
    cli_launches = dict(LAUNCHES)
    ecfg = Config()
    ecfg.RANKER_ARCH = "e5-large-v2"
    ecfg.RANKER_MODEL_NAME = "intfloat/e5-large-v2"
    enc = build_encoder(ecfg, device=dev)
    ref = DenseIndex.from_texts(texts, ids, enc, batch_size=256,
                                dtype=torch.bfloat16, search_mode="exact",
                                device=dev)
    encode_s = enc.stats["seconds"]
    loaded = DenseIndex.load(dense_dir, dtype=torch.bfloat16,
                             search_mode="exact", device=dev)
    queries = [fact_query(f) for f in world.facts_for(world.eval_entities)]
    q = np.ascontiguousarray(enc.encode(queries, kind="query"))
    li, ls = loaded.search(q, top_k=5)
    ri, rs = ref.search(q, top_k=5)
    hits_equal = bool(np.array_equal(np.asarray(li), np.asarray(ri))
                      and np.array_equal(np.asarray(ls), np.asarray(rs)))
    cfg, facts = _synth_cfg(
        os.path.join(base, "serve"), world, world.eval_entities[:2], 1,
        world.seed + 7, 1, LLM_CHECKPOINT=ckpt, RANKER_ARCH="e5-large-v2",
        RETRIEVER_BACKEND="sparse_and_dense", DENSE_SEARCH_MODE="exact",
        DENSE_INDEX_DTYPE="bfloat16", DENSE_INDEX_PATH=dense_dir,
        SPARSE_INDEX_NAME_OR_PATH=bm25_dir, BM25_ENGINE="scan",
        SAMPLE_SIZE=8)
    cfg.CORPUS_JSONL_PATH = ""      # the directories or nothing
    LAUNCHES.clear()
    res = init_resources(cfg, device=dev, encoder=enc)
    served_from_dirs = (res.dense_index.valid_n == len(texts)
                        and res.sparse_index.valid_n == len(texts))
    run_experiment(cfg, resources=res, device=dev)
    serve_launches = dict(LAUNCHES)
    rec = {"docs": len(texts), "bm25_cli_s": bm25_s,
           "dense_cli_s": dense_s, "bm25_files_differ": bm25_differ,
           "dense_cli_launches": cli_launches,
           "encode_docs_s": len(texts) / encode_s,
           "hits_equal": hits_equal, "served_from_dirs": served_from_dirs,
           "serve_launches": serve_launches,
           "outputs_written": _outputs_written(cfg)}
    log(f"[phase10] (c) build_index {json.dumps(rec)}")
    del res, enc, ref, loaded
    _free_cuda()
    if bm25_differ or not sorted(os.listdir(bm25_dir)):
        raise AssertionError(f"phase 10(c): BM25 files differ {bm25_differ}")
    if not cli_launches.get("encoder_attention_bf16", 0):
        raise AssertionError("phase 10(c): the dense build never ran K3")
    if not (hits_equal and served_from_dirs and rec["outputs_written"]):
        raise AssertionError(f"phase 10(c): {rec}")
    for key in ("topk_matmul_bf16", "bm25_scan_topk", "sdag_prefill_f32"):
        if not serve_launches.get(key, 0):
            raise AssertionError(f"phase 10(c): {key} never launched "
                                 "serving the built directories")
    return rec


def _p10_attack_builder(dev):
    """(d) attack.poisoned_rag.main, local backend, llama3-8b width, on a
    cached samples JSON of 4 synthetic questions; twice."""
    import torch
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.attack import poisoned_rag
    from sdag_tpu_torch.pipeline import resources
    from sdag_tpu_torch.utils.parsing import load_from_csv
    from sdag_tpu_torch.utils.synth_qa import fact_query, load_world
    world = load_world(os.path.join(REPO, "experiments", "data", "qa_ckpt",
                                    "world.json"))
    base = os.path.join(P10_DIR, "attack_builder")
    os.makedirs(base, exist_ok=True)
    samples = os.path.join(base, "samples.json")
    with open(samples, "w", encoding="utf-8") as fh:
        json.dump([{"id": f"{f.entity}-{f.attr}", "question": fact_query(f),
                    "short_answers": [f.value]}
                   for f in world.facts_for(world.eval_entities)[:4]], fh)
    plain_build = resources.build_generator
    built, prompts = [], []

    def recorded(cfg, device="cuda"):
        """The generator main builds, its generate_ids calls counted."""
        gen = plain_build(cfg, device=device)
        plain_generate_ids = gen.generate_ids

        def counted(ids, max_new_tokens=128):
            prompts[-1] += 1
            return plain_generate_ids(ids, max_new_tokens=max_new_tokens)

        gen.generate_ids = counted
        built.append(gen)
        return gen

    runs = []
    resources.build_generator = recorded
    try:
        for i in range(2):
            out = os.path.join(base, f"attack_{i}.csv")
            _free_cuda()
            prompts.append(0)
            LAUNCHES.clear()
            t0 = time.perf_counter()
            poisoned_rag.main([
                "--dataset", "nq", "--samples_json", samples,
                "--out_csv", out, "--backend", "local",
                "--llm_arch", "llama3-8b", "--temperature", "0",
                "--max_tokens_false", "16", "--max_tokens_doc", "64",
                "--device", "cuda"])
            torch.cuda.synchronize(dev)
            gen = built.pop()
            st = gen.stats
            runs.append({"s": time.perf_counter() - t0,
                         "n_layers": gen.cfg.n_layers,
                         "prompts": prompts[-1],
                         "k1_launches": LAUNCHES.get("sdag_prefill_bf16", 0),
                         "new_tokens": st["decode_tokens"],
                         "decode_s": st["decode_s"],
                         "prefill_s": st["prefill_s"],
                         "graph_captures": st["graph_captures"],
                         "capture_s": st["capture_s"]})
    finally:
        resources.build_generator = plain_build
    _free_cuda()
    import csv
    with open(os.path.join(base, "attack_0.csv"), encoding="utf-8",
              newline="") as fh:
        reader = csv.DictReader(fh)
        header, rows = reader.fieldnames, list(reader)
    qd = load_from_csv(os.path.join(base, "attack_0.csv"))
    with open(os.path.join(base, "attack_0.csv"), "rb") as f0, \
            open(os.path.join(base, "attack_1.csv"), "rb") as f1:
        same = f0.read() == f1.read()
    rec = {"runs": runs, "rows": len(rows), "header": header,
           "loaded_rows": len(qd), "second_call_same_file": same,
           "new_tok_s": [r["new_tokens"] / r["s"] for r in runs],
           "empty_false_answers": sum(not r["false_answer"].strip()
                                      for r in rows),
           "empty_documents": sum(not r["malicious_document"].strip()
                                  for r in rows),
           "first_row": rows[0] if rows else None}
    log(f"[phase10] (d) attack builder {json.dumps(rec)}")
    if header != ["query", "query_id", "ground_truth_answers",
                  "false_answer", "malicious_document"] or len(rows) != 4:
        raise AssertionError(f"phase 10(d): {len(rows)} rows, {header}")
    if len(qd) != 4 or not same:
        raise AssertionError(f"phase 10(d): {len(qd)} rows read back, "
                             f"same file on the second call: {same}")
    for r in runs:
        # every prompt is one B=1 causal prefill through K1 at 8B width
        if not r["prompts"] or r["k1_launches"] != r["n_layers"] * r[
                "prompts"]:
            raise AssertionError(
                f"phase 10(d): {r['k1_launches']} sdag_prefill_bf16 "
                f"launches for {r['prompts']} prompts of "
                f"{r['n_layers']} layers")
    return rec


def _p10_sdag_effect(dev):
    """(e) the SDAG-effect grid through the new driver on qa_ckpt, held
    row by row against the committed JAX CPU reference."""
    drv = _experiment_module("run_sdag_effect_torch")
    cmp_mod = _experiment_module("compare_sdag_effect")
    ckpt = os.path.join(REPO, "experiments", "data", "qa_ckpt")
    out = os.path.join(P10_DIR, "sdag_effect")
    shutil.rmtree(out, ignore_errors=True)
    table, walls = {}, {}
    for n_mal in (1, 2, 5):
        t0 = time.perf_counter()
        table[n_mal] = drv.run_grid(ckpt, out, n_mal, [0, 1, 3], 5, 0.0,
                                    "cuda")
        walls[n_mal] = time.perf_counter() - t0
    diff = cmp_mod.compare_dirs(SDAG_EFFECT_REF, out)
    rec = {"table": table, "wall_s": walls,
           "rows": {c: r["rows"] for c, r in diff.items()},
           "differ": {c: r["differ"] for c, r in diff.items()}}
    log(f"[phase10] (e) sdag effect {json.dumps(rec)}")
    for cell, r in diff.items():
        for d in r["differ"]:
            log(f"[phase10] (e) {cell} differs: {json.dumps(d)}")
    if len(diff) != 9 or any(r["rows"] != 96 for r in diff.values()):
        raise AssertionError(f"phase 10(e): cells {rec['rows']}")
    worst = max(len(r["differ"]) for r in diff.values())
    if worst > GRID_MAX_DIFF:
        raise AssertionError(f"phase 10(e): {worst} rows of a cell differ "
                             "from the JAX CPU reference (at most "
                             f"{GRID_MAX_DIFF})")
    return rec


def phase10(dev):
    """Each step's record, and the seconds of each step and of the phase."""
    rec, step_s = {}, {}
    t_phase = time.perf_counter()
    for key, step in (("a_discern", _p10_discern),
                      ("b_ragdefender", _p10_ragdefender),
                      ("c_build_index", _p10_build_index),
                      ("d_attack_builder", _p10_attack_builder),
                      ("e_sdag_effect", _p10_sdag_effect)):
        t0 = time.perf_counter()
        rec[key] = step(dev)
        step_s[key] = time.perf_counter() - t0
    rec["step_s"] = step_s
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


# --------------------------------------------------------------- phase 11
P11_DIR = os.path.join(OUT_DIR, "chip_smoke_phase11")
P11_8B_SEED = 11
P11_NEW_TOKENS = 16
P11_N, P11_D, P11_Q, P11_K = 1 << 20, 1024, 32, 10
P11_CP_TOL = 1e-4          # ring CP (f32) against the plain reference
# TP=2 8B logits: their row-relative error against the same weights' f32
# logits may be at most this multiple of one rank's bf16 error (both are
# bf16 sums of one function in different orders; TP rounds each rank's
# half product to bf16 before the all-reduce adds them).  Sound TP read
# 1.03x on an H100; each planted fault below must read over the limit in
# the same run, or the gate could not tell a broken TP from a sound one.
P11_TP_ERR_RATIO = 1.3
# planted TP faults: the all-reduce of one prefill left out on every rank
# (call 2 * layer after wo, 2 * layer + 1 after down)
P11_TP_FAULTS = (("layer16_down", 2 * 16 + 1), ("layer31_wo", 2 * 31))


def _iso_batch(gen, plans, dev):
    """The padded ISO batch ``Generator.generate_plans`` builds, as
    tensors on ``dev``: (ids, doc_id, nbr_bits, sys_user_len, valid_len)."""
    import numpy as np
    import torch
    ids = [p.input_ids for p in plans]
    lp = gen._pad_len(max(len(x) for x in ids))
    metas = [p.metadata(pad_to=lp) for p in plans]
    batch = np.full((len(ids), lp), gen.tokenizer.pad_token_id, np.int32)
    vl = np.zeros(len(ids), np.int32)
    for i, x in enumerate(ids):
        batch[i, :len(x)] = x
        vl[i] = len(x)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return (t(batch), t(np.stack([m[0] for m in metas])),
            t(np.stack([m[1] for m in metas])),
            t(np.asarray([m[2] for m in metas], np.int32)), t(vl))


def _p11_8b_generator(dev, mesh=None):
    """llama3-8b, random bf16 weights from P11_8B_SEED (every rank draws
    the whole tree alike; a mesh keeps this rank's slices and the tree is
    freed)."""
    import torch
    from sdag_tpu_torch.models.llama import DecoderConfig, init_decoder_params
    from sdag_tpu_torch.models.tokenizer import load_tokenizer
    from sdag_tpu_torch.sdag.generate import Generator
    cfg = DecoderConfig.llama3_8b()
    g = torch.Generator(device=dev)
    g.manual_seed(P11_8B_SEED)
    params = init_decoder_params(g, cfg, device=dev)
    gen = Generator(params, cfg, load_tokenizer(""), temperature=0.0,
                    device=dev, mesh=mesh)
    del params
    _free_cuda()
    return gen


def _p11_8b_prefill(gen, dev):
    """The last-position prefill logits of 8 ISO prompts (on CPU), the
    prefill's seconds and the batch."""
    import torch
    from sdag_tpu_torch.models.llama import prefill
    plans, _ = _main_path_prompts(8)
    batch = _iso_batch(gen, plans, dev)
    ids, did, nbr, sul, vl = batch
    with torch.inference_mode():
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, _ = prefill(gen.params, gen.cfg, ids, doc_id=did,
                            nbr_bits=nbr, sys_user_len=sul, valid_len=vl,
                            logits_last_only=True, with_cache=False,
                            tp_group=gen.tp_group)
        torch.cuda.synchronize(dev)
    return logits[:, 0].float().cpu(), time.perf_counter() - t0, batch


def _p11_8b_run(gen, dev, graphs=False):
    """The last-position prefill logits of 8 ISO prompts, then their greedy
    tokens (P11_NEW_TOKENS), on CPU; prefill / decode tok/s."""
    logits, prefill_s, (ids, did, nbr, sul, vl) = _p11_8b_prefill(gen, dev)
    s0 = dict(gen.stats)
    out, lengths = gen._generate(ids, did, nbr, sul, vl, P11_NEW_TOKENS,
                                 graphs=graphs)
    dec_s = gen.stats["decode_s"] - s0["decode_s"]
    dec_tok = gen.stats["decode_tokens"] - s0["decode_tokens"]
    return {"logits": logits, "tokens": out.cpu(),
            "lengths": lengths.cpu(),
            "prefill_tok_s": float(vl.sum()) / prefill_s,
            "decode_tok_s": dec_tok / dec_s if dec_s else None,
            "stats": {k: gen.stats[k] for k in ("graph_captures",
                                                "decode_mode")}}


def _p11_tp_fault_logits(gen, dev, skip):
    """``_p11_8b_prefill``'s logits with a planted TP fault: the prefill's
    all-reduce number ``skip`` (from 0) is left out on every rank (the
    layers' ``reduce_from_group`` calls ``collectives.all_reduce_``)."""
    from sdag_tpu_torch.parallel import collectives
    real = collectives.all_reduce_
    calls = [0]

    def faulty(x, group, **kw):
        calls[0] += 1
        return x if calls[0] - 1 == skip else real(x, group, **kw)
    collectives.all_reduce_ = faulty
    try:
        return _p11_8b_prefill(gen, dev)[0]
    finally:
        collectives.all_reduce_ = real


def _p11_8b_f32_logits(gen, dev):
    """The last-position prefill logits of ``_p11_8b_run``'s batch with the
    same weights in float32 (K1's f32 body): the reference both bf16 runs
    are held to."""
    import dataclasses
    import torch
    from sdag_tpu_torch.models.llama import prefill
    cfg = dataclasses.replace(gen.cfg, dtype=torch.float32)
    params = _tree_to(gen.params, dev, torch.float32)
    plans, _ = _main_path_prompts(8)
    ids, did, nbr, sul, vl = _iso_batch(gen, plans, dev)
    with torch.inference_mode():
        logits, _ = prefill(params, cfg, ids, doc_id=did, nbr_bits=nbr,
                            sys_user_len=sul, valid_len=vl,
                            logits_last_only=True, with_cache=False)
    del params
    return logits[:, 0].float().cpu()


def _row_rel(got, want):
    """Max over rows of a row's max abs difference over the row's RMS."""
    rms = want.pow(2).mean(-1).sqrt()
    return float(((got - want).abs().amax(-1) / rms).max())


def _p11_nccl_one_rank(rank, world):
    """(a) one rank over NCCL: the 8B Generator without a mesh and with an
    explicit (1, 1) mesh, decode captured in CUDA graphs either way."""
    import torch
    from sdag_tpu_torch.core.mesh import make_mesh
    from sdag_tpu_torch.parallel import collectives as C
    dev = torch.device("cuda", 0)
    gen = _p11_8b_generator(dev)
    plain = _p11_8b_run(gen, dev, graphs=True)
    del gen
    _free_cuda()
    C.CALLS.clear()
    gen = _p11_8b_generator(dev, mesh=make_mesh(1, 1, device=dev))
    meshed = _p11_8b_run(gen, dev, graphs=True)
    return {"plain": plain, "mesh": meshed,
            "calls": {"/".join(k): v for k, v in C.CALLS.items()},
            "backend": torch.distributed.get_backend()}


def _p11_cli_world1():
    """(a) the CLI under torch.distributed.run, one rank (NCCL), on phase
    3's clean qa_ckpt config: its answers CSV equals phase 3's."""
    import csv
    from sdag_tpu_torch.parallel.launch import free_port
    from sdag_tpu_torch.utils.synth_qa import load_world
    ckpt = os.path.join(REPO, "experiments", "data", "qa_ckpt")
    world = load_world(os.path.join(ckpt, "world.json"))
    base = os.path.join(P11_DIR, "cli_world1")
    cfg, _ = _synth_cfg(base, world, world.eval_entities[:4], 1,
                        world.seed + 1, 0, LLM_CHECKPOINT=ckpt)
    keys = ("SAMPLE_SIZE", "TOP_K", "ADD_ATTACK_IN_RANK", "CSV_INPUT_PATH",
            "CORPUS_JSONL_PATH", "RETRIEVER_BACKEND",
            "SPARSE_INDEX_NAME_OR_PATH", "LLM_CHECKPOINT", "LLM_BATCH_SIZE",
            "BATCH_SIZE_EMBED_Q", "MAX_GEN_TOKENS_RAG", "TEMPERATURE",
            "OUTPUT_CSV_BASE")
    cfg_path = os.path.join(base, "cfg.json")
    with open(cfg_path, "w") as fh:
        json.dump({k: getattr(cfg, k) for k in keys}, fh)
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "1", "--master-port", str(free_port()), "-m",
         "sdag_tpu_torch.pipeline.cli", cfg_path],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"phase 11(a): torchrun CLI failed:\n"
                             f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    name = "results_top_k=5_attacker_pos=0.csv"

    def rows(path):
        with open(path, newline="", encoding="utf-8") as fh:
            return list(csv.DictReader(fh))
    got = rows(os.path.join(base, "out", name))
    want = rows(os.path.join(OUT_DIR, "chip_smoke_phase3", "clean", "out",
                             name))
    if got != want:
        raise AssertionError("phase 11(a): the torchrun CLI's answers CSV "
                             "differs from phase 3's")
    return {"rows": len(got), "wall_s": wall}


def _p11_dense_corpus(dev):
    """P11_N x P11_D normalised rows and P11_Q queries, from one seed."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(111)
    c32 = _normalised_rows(g, P11_N, P11_D, dev)
    return c32, _normalised_rows(g, P11_Q, P11_D, dev)


def _p11_bm25_index(dev):
    """Phase 2's 1M-doc shape (its seed and draws): term ids, impacts,
    32 queries x 16 terms."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    N, Lp, V, Q, T = 1 << 20, 64, 1 << 18, 32, 16
    term_ids = _dedup_rows(_zipf_ids(g, (N, Lp), V, 1.07, dev))
    impacts = (0.1 + 2.9 * torch.rand((N, Lp), generator=g, device=dev))
    impacts = torch.where(term_ids >= 0, impacts, 0.0).contiguous()
    q_terms = _dedup_rows(_zipf_ids(g, (Q, T), V, 1.07, dev)).contiguous()
    q_weights = torch.where(
        q_terms >= 0, 1.0 + (torch.rand((Q, T), generator=g, device=dev)
                             > 0.8).float(), 0.0).contiguous()
    return term_ids, impacts, q_terms, q_weights


def _p11_cp_inputs(dev):
    """Context-parallel cases: (name, q, k, v, doc_id, nbr, sul, vl) at the
    8B ISO shape (bf16, heads 32/8/8), at L = 16384 with 31 docs (bf16),
    and the ring's f32 case at qa_ckpt's heads (6/6/6, Dh 32)."""
    import numpy as np
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    t32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)  # noqa

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)
    plans, _ = _main_path_prompts(8)
    lp = -(-max(len(p.input_ids) for p in plans) // 128) * 128
    metas = [p.metadata(pad_to=lp) for p in plans]
    meta = (t32(np.stack([m[0] for m in metas])),
            t32(np.stack([m[1] for m in metas])),
            t32([m[2] for m in metas]),
            t32([len(p.input_ids) for p in plans]))
    cases = [("iso_8b_bf16", *(rnd(8, h, lp, 128, dtype=torch.bfloat16)
                               for h in (32, 8, 8)), *meta)]
    L = 16384
    d, n = _layout_docs(L, 256, 31, 512, False)
    cases.append(("L16384_31docs_bf16",
                  *(rnd(1, h, L, 128, dtype=torch.bfloat16)
                    for h in (16, 8, 8)),
                  t32(d[None]), t32(n[None]), t32([256]), t32([L])))
    cases.append(("ring_iso_qa_ckpt_f32",
                  *(rnd(8, 6, lp, 32, dtype=torch.float32)
                    for _ in range(3)), *meta))
    return cases


def _p11_seen_rows(case, q_offset=0, rows=None):
    """Rows of a CP case that see a key (the rows K1's limits hold on)."""
    import torch
    from sdag_tpu_torch.ops import attention as A
    _, q, _k, _v, did, nbr, sul, vl = case
    B, _, L, _ = q.shape
    dev = q.device
    out = torch.zeros(B, L, dtype=torch.bool, device=dev)
    for r0 in range(0, L, 1024):
        i = torch.arange(r0, min(r0 + 1024, L), device=dev)[None, :, None]
        j = torch.arange(L, device=dev)[None, None, :]
        m = A._tile_mask(i, j, did[:, r0:r0 + 1024, None], did[:, None, :],
                         nbr[:, r0:r0 + 1024, None], sul[:, None, None],
                         vl[:, None, None])
        out[:, r0:r0 + 1024] = m.any(-1)
    return out


def _p11_pipeline_cfg(tag, rank, **over):
    from sdag_tpu_torch.utils.synth_qa import load_world
    ckpt = os.path.join(REPO, "experiments", "data", "qa_ckpt")
    world = load_world(os.path.join(ckpt, "world.json"))
    return _synth_cfg(os.path.join(P11_DIR, f"{tag}_r{rank}"), world,
                      world.eval_entities[:4], 1, world.seed + 1, 0,
                      LLM_CHECKPOINT=ckpt, **over)[0]


P11_INT8 = dict(LLM_WEIGHTS_DTYPE="int8", KV_CACHE_DTYPE="int8",
                SPECULATIVE_DRAFT_LEN=4)


def _p11_step(name, fn, rec, step_s):
    """Run one step of a rank with the launch counts zeroed before and
    read after; its seconds and launches go into the rank's record."""
    from sdag_tpu_torch._build import LAUNCHES
    LAUNCHES.clear()
    t0 = time.perf_counter()
    rec[name] = fn()
    step_s[name] = time.perf_counter() - t0
    rec[name]["launches"] = dict(LAUNCHES)


def _p11_two_ranks(rank, world):
    """(b) two ranks on one card over gloo: (i) TP=2 at llama3-8b, (ii) the
    DP=2 qa_ckpt pipeline (native, then int8 + int8 KV + D=4), (iii)
    sharded exact dense search, (iv) the sharded K2 scan, (v) DP encode at
    e5-large-v2, (vi) context parallelism."""
    import torch
    from sdag_tpu_torch.config import Config
    from sdag_tpu_torch.core.mesh import (make_index_mesh, make_mesh,
                                          shard_rows)
    from sdag_tpu_torch.ops import topk as T
    from sdag_tpu_torch.parallel import collectives as C
    from sdag_tpu_torch.parallel.context import \
        context_parallel_prefill_attention
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    from sdag_tpu_torch.pipeline.resources import build_encoder
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rec, step_s, peak = {}, {}, {}

    def tp_8b():
        gen = _p11_8b_generator(dev, mesh=make_mesh(1, 2, device=dev))
        out = _p11_8b_run(gen, dev)
        out["fault_logits"] = {name: _p11_tp_fault_logits(gen, dev, skip)
                               for name, skip in P11_TP_FAULTS}
        out["local_heads"] = [gen.params["layers"][0]["attn"]["wq"].shape[1]
                              // gen.cfg.head_dim, gen.n_kv_heads]
        return out

    def pipeline(tag, **over):
        def run():
            cfg = _p11_pipeline_cfg(tag, rank, MESH_DATA=2, **over)
            m = run_experiment(cfg, device=dev)[(5, 0)]["answer_match_stats"]
            return {"acc_iso": m["iso"]["ground_truth_match_rate"],
                    "csv": cfg.OUTPUT_CSV_BASE
                    + "_top_k=5_attacker_pos=0.csv"}
        return run

    def dense():
        c32, q = _p11_dense_corpus(dev)
        mesh = make_index_mesh(dev)
        shard = shard_rows(c32, mesh)
        del c32
        out = {}
        for dt in ("bfloat16", "float32", "int8"):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            if dt == "int8":
                ci, cs = T.quantize_last_axis_int8(shard)
                v, i = C.sharded_topk_search(q, ci, P11_K, P11_N - 1000,
                                             mesh, scales=cs)
            else:
                v, i = C.sharded_topk_search(
                    q, shard.to(getattr(torch, dt)), P11_K, P11_N - 1000,
                    mesh)
            torch.cuda.synchronize(dev)
            out[dt] = {"vals": v.cpu(), "idx": i.cpu(),
                       "s": time.perf_counter() - t0}
        return out

    def bm25():
        from sdag_tpu_torch.parallel.collectives import sharded_bm25_topk
        term_ids, impacts, qt, qw = _p11_bm25_index(dev)
        mesh = make_index_mesh(dev)
        v, i = sharded_bm25_topk(shard_rows(term_ids, mesh),
                                 shard_rows(impacts, mesh), qt, qw, 10,
                                 valid_n=term_ids.shape[0], mesh=mesh)
        return {"vals": v.cpu(), "idx": i.cpu()}

    def encode():
        cfg = Config()
        cfg.RANKER_ARCH = "e5-large-v2"
        cfg.MESH_DATA = 2
        enc = build_encoder(cfg, device=dev)
        emb = enc.encode(_p11_passages(), kind="passage", batch_size=32)
        return {"emb": torch.from_numpy(emb), "stats": dict(enc.stats)}

    def context():
        mesh = make_mesh(1, 2, device=dev)
        out = {}
        for case in _p11_cp_inputs(dev):
            name, q, k, v, did, nbr, sul, vl = case
            ls = q.shape[2] // 2
            own = slice(rank * ls, (rank + 1) * ls)
            ex = "ring" if name.startswith("ring") else "all_gather"
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            o = context_parallel_prefill_attention(
                q[:, :, own].contiguous(), k[:, :, own].contiguous(),
                v[:, :, own].contiguous(), did[:, own].contiguous(),
                nbr[:, own].contiguous(), sul, vl, mesh, kv_exchange=ex)
            torch.cuda.synchronize(dev)
            out[name] = {"out": o.cpu(), "s": time.perf_counter() - t0}
        return out

    steps = (("i_tp2_8b", tp_8b), ("ii_dp2_pipeline", pipeline("dp")),
             ("ii_dp2_pipeline_int8", pipeline("dp_int8", **P11_INT8)),
             ("iii_dense", dense), ("iv_bm25", bm25), ("v_encode", encode),
             ("vi_context", context))
    for name, fn in steps:
        torch.cuda.reset_peak_memory_stats(dev)
        _p11_step(name, fn, rec, step_s)
        peak[name] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        _free_cuda()
    rec["step_s"] = step_s
    rec["peak_gib"] = peak
    rec["calls"] = {"/".join(k): v for k, v in C.CALLS.items()}
    return rec


def _p11_passages(n=64):
    """The ranker path's passages: the first n docs of qa_ckpt_v4's
    corpus (two encode batches of 32)."""
    from sdag_tpu_torch.pipeline.resources import load_corpus_jsonl
    from sdag_tpu_torch.utils.synth_qa import load_world, write_corpus_jsonl
    world = load_world(os.path.join(REPO, "experiments", "data", "qa_ckpt_v4",
                                    "world.json"))
    corpus = os.path.join(P11_DIR, "corpus_v4.jsonl")
    if not os.path.exists(corpus):
        os.makedirs(P11_DIR, exist_ok=True)
        write_corpus_jsonl(world, corpus)
    return load_corpus_jsonl(corpus)[0][:n]


def _p11_world1(dev):
    """The one-rank results phase 11(b) is held to, computed before the
    ranks start (one model on the card at a time)."""
    import torch
    from sdag_tpu_torch.config import Config
    from sdag_tpu_torch.ops import attention as A
    from sdag_tpu_torch.ops import bm25 as M
    from sdag_tpu_torch.ops import topk as T
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    from sdag_tpu_torch.pipeline.resources import build_encoder
    ref = {}
    gen = _p11_8b_generator(dev)
    ref["8b"] = _p11_8b_run(gen, dev)
    ref["8b_f32_logits"] = _p11_8b_f32_logits(gen, dev)
    del gen
    _free_cuda()
    cfg = _p11_pipeline_cfg("world1_int8", 0, **P11_INT8)
    run_experiment(cfg, device=dev)
    ref["int8_csv"] = cfg.OUTPUT_CSV_BASE + "_top_k=5_attacker_pos=0.csv"
    c32, q = _p11_dense_corpus(dev)
    ref["dense"] = {}
    for dt in ("bfloat16", "float32", "int8"):
        if dt == "int8":
            ci, cs = T.quantize_last_axis_int8(c32)
            v, i = T.fused_topk_matmul_int8(q, ci, cs, P11_K,
                                            valid_n=P11_N - 1000)
            del ci, cs
        else:
            c = c32.to(getattr(torch, dt))
            v, i = T.fused_topk_matmul(q, c, P11_K, valid_n=P11_N - 1000)
            del c
        ref["dense"][dt] = {"vals": v.cpu(), "idx": i.cpu()}
    del c32
    _free_cuda()
    term_ids, impacts, qt, qw = _p11_bm25_index(dev)
    v, i = M.bm25_topk(term_ids, impacts, qt, qw, 10,
                       valid_n=term_ids.shape[0])
    ref["bm25"] = {"vals": v.cpu(), "idx": i.cpu()}
    del term_ids, impacts
    _free_cuda()
    cfg = Config()
    cfg.RANKER_ARCH = "e5-large-v2"
    cfg.MESH_DATA = 1
    enc = build_encoder(cfg, device=dev)
    ref["emb"] = torch.from_numpy(enc.encode(_p11_passages(),
                                             kind="passage", batch_size=32))
    del enc
    _free_cuda()
    ref["cp"] = {}
    for case in _p11_cp_inputs(dev):
        name, q, k, v, did, nbr, sul, vl = case
        if name.startswith("ring"):
            out = A.sdag_attention_reference(q, k, v, did, nbr, sul,
                                             valid_len=vl)
        else:
            out = A.sdag_prefill_attention(q, k, v, did, nbr, sul,
                                           valid_len=vl)
        ref["cp"][name] = {"out": out.cpu(),
                           "rows": _p11_seen_rows(case).cpu()}
    _free_cuda()
    return ref


def _p11_check_two_ranks(ranks, ref, p3_csv):
    """Phase 11(b)'s gates on the ranks' records against the one-rank
    results; returns the comparison numbers, and raises after computing
    them all when a gate failed."""
    import csv
    import torch
    chk, failed = {}, []

    def gate(ok, msg):
        if not ok:
            failed.append(msg)

    def rows(path):
        with open(path, newline="", encoding="utf-8") as fh:
            return list(csv.DictReader(fh))
    # (i) TP=2 logits: bf16 sums of the same function in another order (two
    # half products rounded to bf16, then all-reduced) land as far from
    # one rank's bf16 logits as bf16 lands from f32 (about 8.6% of a row's
    # RMS at llama3-8b on an H100, over K1-bf16's 5e-2): so each bf16 run
    # is held to the same weights' f32 logits, TP within
    # P11_TP_ERR_RATIO x one rank, and each planted fault over it
    f32 = ref["8b_f32_logits"]
    chk["world1_bf16_vs_f32_row_rel"] = e1 = _row_rel(ref["8b"]["logits"],
                                                      f32)
    chk["tp_vs_f32_row_rel"] = chk["tp_logits_row_rel_err"] = 0.0
    for r in ranks:
        got = r["i_tp2_8b"]["logits"]
        gate(bool(torch.isfinite(got).all()), "(i) TP logits not finite")
        chk["tp_vs_f32_row_rel"] = max(chk["tp_vs_f32_row_rel"],
                                       _row_rel(got, f32))
        chk["tp_logits_row_rel_err"] = max(chk["tp_logits_row_rel_err"],
                                           _row_rel(got, ref["8b"]["logits"]))
        gate(r["i_tp2_8b"]["local_heads"] == [16, 4],
             f"(i) local heads {r['i_tp2_8b']['local_heads']}")
        gate(r["i_tp2_8b"]["launches"].get("sdag_prefill_bf16", 0) >= 64,
             f"(i) K1-bf16 launched {r['i_tp2_8b']['launches']}")
    chk["tp_ratio"] = chk["tp_vs_f32_row_rel"] / e1
    gate(chk["tp_ratio"] <= P11_TP_ERR_RATIO,
         f"(i) TP=2 logits {chk['tp_vs_f32_row_rel']} from f32, over "
         f"{P11_TP_ERR_RATIO} x one rank's {e1}")
    chk["tp_fault_ratio"] = {}
    for name, _ in P11_TP_FAULTS:
        chk["tp_fault_ratio"][name] = ratio = max(
            _row_rel(r["i_tp2_8b"]["fault_logits"][name], f32)
            for r in ranks) / e1
        gate(ratio > P11_TP_ERR_RATIO,
             f"(i) planted TP fault {name} reads {ratio} x one rank's "
             f"error, within the {P11_TP_ERR_RATIO} limit")
    t0, t1 = ranks[0]["i_tp2_8b"]["tokens"], ref["8b"]["tokens"]
    chk["tp_greedy_token_agreement"] = float((t0 == t1).float().mean())
    gate(torch.equal(ranks[0]["i_tp2_8b"]["tokens"],
                     ranks[1]["i_tp2_8b"]["tokens"]),
         "(i) the TP ranks' tokens differ")
    # (ii) the DP=2 pipeline: at most GRID_MAX_DIFF of 24 rows differ
    for step, want_csv in (("ii_dp2_pipeline", p3_csv),
                           ("ii_dp2_pipeline_int8", ref["int8_csv"])):
        got, exp = rows(ranks[0][step]["csv"]), rows(want_csv)
        differ = sum(a != b for a, b in zip(got, exp))
        chk[f"{step}_rows_differ"] = differ
        gate(len(got) == len(exp) == 24, f"(ii) {step}: {len(got)} rows")
        gate(differ <= GRID_MAX_DIFF, f"(ii) {step}: {differ} rows differ")
        gate(not os.path.exists(ranks[1][step]["csv"]),
             f"(ii) {step}: rank 1 wrote")
    for r in ranks:
        gate(r["ii_dp2_pipeline_int8"]["launches"].get("int8_matmul_f32"),
             "(ii) K6-f32 not launched on a data rank")
    # (iii) sharded exact search: K5 bit-equal; K4 indices equal but at
    # ties, scores within 1e-5 relative (+1e-6)
    for dt in ("bfloat16", "float32", "int8"):
        w = ref["dense"][dt]
        for r in ranks:
            g = r["iii_dense"][dt]
            mism = g["idx"] != w["idx"]
            chk[f"dense_{dt}_index_mismatches"] = int(mism.sum())
            chk[f"dense_{dt}_max_abs_err"] = float(
                (g["vals"] - w["vals"]).abs().max())
            if dt == "int8":
                gate(torch.equal(g["vals"], w["vals"])
                     and torch.equal(g["idx"], w["idx"]),
                     "(iii) sharded K5 differs from one rank")
                continue
            gate(bool(torch.isclose(g["vals"], w["vals"], rtol=K4_RTOL,
                                    atol=K4_ATOL).all()),
                 f"(iii) sharded K4 {dt} scores differ")
            # a differing index must sit on a tie of the one-rank list
            v = w["vals"]
            tie = torch.zeros_like(mism)
            near = torch.isclose(v[:, 1:], v[:, :-1], rtol=K4_RTOL,
                                 atol=K4_ATOL)
            tie[:, 1:] |= near
            tie[:, :-1] |= near
            gate(bool((tie | ~mism).all()),
                 f"(iii) sharded K4 {dt} indices differ off a tie")
    # (iv) sharded K2: bit-equal to one rank (no-match slots as -inf, -1)
    w = ref["bm25"]
    hit = w["vals"] > 0
    wv = torch.where(hit, w["vals"], float("-inf"))
    wi = torch.where(hit, w["idx"], -1)
    for r in ranks:
        g = r["iv_bm25"]
        gate(torch.equal(g["vals"], wv) and torch.equal(g["idx"], wi),
             "(iv) sharded K2 differs from one rank")
    # (v) DP encode within K3-bf16's absolute limit of one rank
    chk["dp_encode_max_abs_err"] = max(
        float((r["v_encode"]["emb"] - ref["emb"]).abs().max())
        for r in ranks)
    gate(chk["dp_encode_max_abs_err"] <= BF16_TOL,
         f"(v) DP embeddings off by {chk['dp_encode_max_abs_err']}")
    for r in ranks:
        gate(r["v_encode"]["launches"].get("encoder_attention_bf16", 0)
             >= 48, f"(v) K3-bf16 launched {r['v_encode']['launches']}")
    # (vi) CP: all-gather with K1 within K1's limits of one-rank K1; ring
    # within P11_CP_TOL of the plain reference
    for name, w in ref["cp"].items():
        got = torch.cat([r["vi_context"][name]["out"] for r in ranks], dim=2)
        err, row_err = _row_errors(got, w["out"], w["rows"])
        chk[f"cp_{name}"] = {"max_abs_err": err, "max_row_rel_err": row_err}
        if name.startswith("ring"):
            gate(err <= P11_CP_TOL, f"(vi) {name}: {err}")
        else:
            gate(err <= BF16_TOL and row_err <= BF16_ROW_TOL,
                 f"(vi) {name}: abs {err}, row-relative {row_err}")
    for r in ranks:
        gate(r["vi_context"]["launches"].get("sdag_prefill_bf16"),
             "(vi) K1 not launched in CP")
    log(f"[phase11] (b) checks {json.dumps(chk)}")
    if failed:
        raise AssertionError("phase 11(b): " + "; ".join(failed))
    return chk


def _p11_shard_shapes(dev):
    """Each kernel timed against its plain version at the shard shapes
    phase 11 runs (one process): K1 at a TP rank's heads (16/4), K4/K5 and
    K2 on half an index, K3 on half a ranker batch, K6 on a data rank's
    window round (4 rows x 5)."""
    import torch
    from sdag_tpu_torch.models.native_ckpt import load_config
    from sdag_tpu_torch.ops import topk as T
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    t32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)  # noqa
    out = {}
    import numpy as np
    plans, _ = _main_path_prompts(8)
    lp = -(-max(len(p.input_ids) for p in plans) // 128) * 128
    metas = [p.metadata(pad_to=lp) for p in plans]
    q, k, v = (torch.randn(8, h, lp, 128, generator=g, device=dev)
               .to(torch.bfloat16) for h in (16, 4, 4))
    out["k1"] = _k1_case("p11_tp_rank_iso_Hq16_Hkv4", q, k, v,
                         t32(np.stack([m[0] for m in metas])),
                         t32(np.stack([m[1] for m in metas])),
                         t32([m[2] for m in metas]),
                         t32([len(p.input_ids) for p in plans]), timed=True)
    del q, k, v
    c32, q = _p11_dense_corpus(dev)
    half = c32[:P11_N // 2].contiguous()
    del c32
    out["k4_bf16"] = _k4_case("p11_shard_bf16_N512K", q,
                              half.to(torch.bfloat16), P11_K, P11_N // 2)
    out["k4_f32"] = _k4_case("p11_shard_f32_N512K", q, half, P11_K,
                             P11_N // 2)
    ci, cs = T.quantize_last_axis_int8(half)
    out["k5"] = _k4_case("p11_shard_int8_N512K", q, ci, P11_K, P11_N // 2,
                         scales=cs)
    del half, ci, cs
    _free_cuda()
    term_ids, impacts, qt, qw = _p11_bm25_index(dev)
    rows = term_ids.shape[0] // 2
    out["k2"] = _k2_case("p11_shard_N512K", term_ids[:rows].contiguous(),
                         impacts[:rows].contiguous(), qt, qw, 10, rows)
    del term_ids, impacts
    _free_cuda()
    L, lens = _ranker_path_passages(32)
    qkv = torch.randn(16, L, 3 * 1024, generator=g, device=dev).to(
        torch.bfloat16)
    out["k3"] = _k3_case("p11_dp_rank_ranker_batch_B16", qkv,
                         torch.as_tensor(lens[:16], dtype=torch.int32,
                                         device=dev), 16, timed=True)
    qa_cfg = load_config(os.path.join(REPO, "experiments", "data",
                                      "qa_ckpt"))
    recs = [_k6_case(f"p11_qa_ckpt_{name}_M20", 20, n, kk, torch.float32, g,
                     dev) for name, n, kk, _c in k6_products(qa_cfg)]
    out["k6_f32"] = _k6_step(recs, qa_cfg, 20, "float32")
    out["k6_f32"]["max_abs_err"] = max(r["max_abs_err"] for r in recs)
    _free_cuda()
    return out


def phase11(dev):
    """Meshes over torch.distributed: (a) NCCL at world size 1, (b) two
    ranks on the one card over gloo; then each kernel at its shard shape.
    Returns the phase's record."""
    import torch
    from sdag_tpu_torch.parallel.launch import run_ranks
    t_phase = time.perf_counter()
    os.makedirs(P11_DIR, exist_ok=True)
    rec, step_s = {}, {}
    t0 = time.perf_counter()
    rec["a_cli_world1"] = _p11_cli_world1()
    step_s["a_cli_world1"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = run_ranks(_p11_nccl_one_rank, 1, backend="nccl", threads=None)[0]
    step_s["a_nccl_8b"] = time.perf_counter() - t0
    if not torch.equal(one["plain"]["tokens"], one["mesh"]["tokens"]):
        raise AssertionError("phase 11(a): the (1, 1) NCCL mesh's tokens "
                             "differ from the mesh-less Generator's")
    captured = one["mesh"]["stats"]
    nccl = sum(v for k, v in one["calls"].items() if k.startswith("nccl/"))
    if captured["graph_captures"] < 1 or captured["decode_mode"] != "graphs" \
            or not nccl:
        raise AssertionError(f"phase 11(a): decode not captured with NCCL "
                             f"collectives inside: {captured}, "
                             f"{one['calls']}")
    rec["a_nccl_8b"] = {
        "backend": one["backend"], "calls": one["calls"],
        "graph_captures": captured["graph_captures"],
        "decode_tok_s": {"plain": one["plain"]["decode_tok_s"],
                         "mesh": one["mesh"]["decode_tok_s"]}}
    log(f"[phase11] (a) {json.dumps(rec)}")
    t0 = time.perf_counter()
    ref = _p11_world1(dev)
    step_s["b_world1_refs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = run_ranks(_p11_two_ranks, 2, backend="gloo", threads=None)
    step_s["b_two_ranks"] = time.perf_counter() - t0
    p3_csv = os.path.join(OUT_DIR, "chip_smoke_phase3", "clean", "out",
                          "results_top_k=5_attacker_pos=0.csv")
    rec["b_checks"] = _p11_check_two_ranks(ranks, ref, p3_csv)
    r0 = ranks[0]
    rec["b_ranks"] = [{
        "step_s": r["step_s"], "peak_gib": r["peak_gib"], "calls": r["calls"],
        "launches": {k: r[k]["launches"] for k in r
                     if isinstance(r[k], dict) and "launches" in r[k]}}
        for r in ranks]
    rec["b_tp2_8b"] = {
        "note": "gloo, two ranks on one card: not a multi-GPU number",
        "prefill_tok_s": r0["i_tp2_8b"]["prefill_tok_s"],
        "decode_tok_s": r0["i_tp2_8b"]["decode_tok_s"],
        "decode_mode": r0["i_tp2_8b"]["stats"]["decode_mode"],
        "world1_prefill_tok_s": ref["8b"]["prefill_tok_s"],
        "world1_decode_tok_s_eager": ref["8b"]["decode_tok_s"]}
    rec["b_dense_s"] = {dt: r0["iii_dense"][dt]["s"]
                        for dt in ("bfloat16", "float32", "int8")}
    rec["b_cp_s"] = {n: c["s"] for n, c in r0["vi_context"].items()
                     if isinstance(c, dict) and "s" in c}
    log(f"[phase11] (b) {json.dumps({k: rec[k] for k in rec if k.startswith('b_')})}")
    t0 = time.perf_counter()
    rec["shard_shapes"] = _p11_shard_shapes(dev)
    step_s["shard_shapes"] = time.perf_counter() - t0
    rec["step_s"] = step_s
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[phase11] steps {json.dumps(step_s)}")
    return rec


# ---------------------------------------------------------------- phase 12
P12_REF = os.path.join(REPO, "experiments", "results", "train_qa_jax_cpu",
                       "reference.json")
P12_V4 = os.path.join(REPO, "experiments", "data", "qa_ckpt_v4")
# 12(a): each step's loss and each tensor's update norm (final - initial)
# against the JAX CPU reference, relative
P12_LOSS_GATE, P12_NORM_GATE = 1e-3, 1e-2
# 12(e): two ranks against one (f32, TF32 off, sums in another order):
# losses relative; per-tensor update norms relative; gradients as a
# tensor's max abs error over its largest |value|; GPipe's loss at JAX's
# own pipeline gate (tests/test_sharding.py)
P12_RANK_LOSS_GATE, P12_RANK_NORM_GATE, P12_RANK_GRAD_GATE = 1e-5, 1e-3, 1e-4
# a loss after an update (Adam turns gradients that differ by rounding
# into steps of either sign, on elements whose gradient is that small)
P12_RANK_STEP_GATE = 1e-4
P12_PP_LOSS_GATE = 2e-5
# the 30M word recipe (experiments/tpu_r4_queue2.sh:30-35), cut to 50 steps
# (warmup 10, the scan chunk of 25 kept)
P12_30M_FLAGS = ["--tokenizer", "word", "--d-model", "512", "--layers", "8",
                 "--heads", "4", "--kv-heads", "4", "--d-ff", "1792",
                 "--seq-len", "512", "--batch", "32", "--steps", "50",
                 "--warmup", "10", "--scan-chunk", "25", "--eval-every", "0",
                 "--eval-n", "32", "--seed", "2"]
# 12(e): rows of the 30M-width TP and GPipe batch (the width is the
# recipe's; over gloo every all-reduce of [rows, 512, 512] goes through
# host memory)
P12_RANK_ROWS = 8


def _p12_ref_flags(out, dev):
    """(the JAX CPU reference, its flags for the port's train_qa.main
    writing to ``out`` on ``dev``)."""
    ref = json.load(open(P12_REF))
    flags = [P12_V4 if f == "experiments/data/qa_ckpt_v4" else f
             for f in ref["flags"]]
    return ref, flags + ["--out", out, "--device", str(dev)]


def _p12_update_norms(init_dir, out_dir):
    """L2 norm of (final - initial) per parameter, as the reference
    script computes it."""
    import numpy as np
    a = np.load(os.path.join(init_dir, "params.npz"))
    b = np.load(os.path.join(out_dir, "params.npz"))
    return {k: float(np.linalg.norm(b[k].astype(np.float64)
                                    - a[k].astype(np.float64)))
            for k in sorted(a.files)}


def _p12_against_ref(losses, norms, ref):
    """(the largest per-step loss error, the largest per-tensor update
    norm error), both relative to the reference."""
    le = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    ne = max(abs(norms[k] - v) / v for k, v in ref["update_norms"].items())
    return le, ne


def _p12_faults():
    """The two planted faults of 12(a), as patches of train_qa's names:
    ISO rows trained with the causal mask; the schedule read one step
    late (lr(count + 1), a torch scheduler's off-by-one)."""
    from sdag_tpu_torch.pipeline import train_qa

    def causal_iso():
        real = train_qa.sample_batch

        def sample(*a, **kw):
            b = real(*a, **kw)
            b["doc_id"].fill_(-1)
            b["nbr_bits"].zero_()
            b["sys_user_len"].zero_()
            return b
        return "sample_batch", sample

    def lr_late():
        real = train_qa.warmup_cosine_decay_schedule

        def sched(*a, **kw):
            s = real(*a, **kw)
            return lambda count: s(count + 1)
        return "warmup_cosine_decay_schedule", sched

    return {"iso_trained_causal": causal_iso, "lr_one_step_late": lr_late}


def _p12_run_main(flags, patch=None):
    from sdag_tpu_torch.pipeline import train_qa
    saved = None
    if patch is not None:
        name, fn = patch()
        saved = (name, getattr(train_qa, name))
        setattr(train_qa, name, fn)
    try:
        return train_qa.main(flags)
    finally:
        if saved:
            setattr(train_qa, *saved)


def _p12_recipe(flags):
    """A run's pieces (train_qa's own): args, cfg and its batches, sampled
    as main samples them."""
    import numpy as np
    from sdag_tpu_torch.models.llama import DecoderConfig
    from sdag_tpu_torch.pipeline import train_qa as T
    args = T.parse_args(flags)
    tok = T.make_tokenizer(args.tokenizer)
    cfg = DecoderConfig(vocab_size=tok.vocab_size, d_model=args.d_model,
                        n_layers=args.layers, n_heads=args.heads,
                        n_kv_heads=args.kv_heads, d_ff=args.d_ff)
    rng = np.random.default_rng(args.seed + 7)
    batches = [T.sample_batch(rng, tok, None, args.batch, args.seq_len,
                              **T.sample_kwargs(args))
               for _ in range(args.steps)]
    return args, cfg, batches


def _p12_resume(flags, dev, tmp):
    """(d): the reference steps uninterrupted twice (the spread), and
    10 steps, save_train_state, restore into a fresh template, 10 more."""
    import numpy as np
    from sdag_tpu_torch.parallel.checkpoint import (restore_train_state,
                                                    save_train_state)
    from sdag_tpu_torch.pipeline import train_qa as T
    from sdag_tpu_torch.utils.tree import flatten_with_paths
    args, cfg, batches = _p12_recipe(flags)

    def run(n, state=None):
        init_state, step_fn, _ = T.make_training(args, cfg, dev)
        if state is None:
            state = init_state(T.initial_params(args, cfg, dev))
        losses = []
        for b in batches[state.step:state.step + n]:
            state, loss = step_fn(state, b)
            losses.append(float(loss))
        return state, losses, init_state

    def params_np(state):
        return {k: v.detach().cpu().numpy() for k, v in
                flatten_with_paths(state.params).items()}

    t0 = time.perf_counter()
    sa, la, _ = run(20)
    sb, lb, _ = run(20)
    s10, l10, init_state = run(10)
    path = os.path.join(tmp, "train_state")
    save_train_state(path, s10)
    fresh = init_state(T.initial_params(args, cfg, dev))
    restored = restore_train_state(path, fresh)
    sr, lr_, _ = run(10, restored)
    pa, pb, pr = params_np(sa), params_np(sb), params_np(sr)
    spread_loss = max(abs(x - y) for x, y in zip(la[10:], lb[10:]))
    spread_param = max(float(np.abs(pa[k] - pb[k]).max()) for k in pa)
    dev_loss = max(abs(x - y) for x, y in zip(la[10:], lr_))
    dev_param = max(float(np.abs(pa[k] - pr[k]).max()) for k in pa)
    rec = {"losses_uninterrupted": la, "losses_resumed": l10 + lr_,
           "restored_step": restored.step,
           "spread_loss": spread_loss, "spread_param": spread_param,
           "resume_loss_dev": dev_loss, "resume_param_dev": dev_param,
           "s": time.perf_counter() - t0}
    # within the measured run-to-run spread: bit-equal when the two
    # uninterrupted runs are, else within twice their difference
    if restored.step != 10 or dev_loss > 2 * spread_loss \
            or dev_param > 2 * spread_param:
        raise AssertionError(f"phase 12(d): resumed steps 11-20 leave "
                             f"the run-to-run spread: {rec}")
    return rec, la


def _p12_flops_per_step(cfg, batch, seq):
    """FLOPs of one training step on the dense-mask path: 3 x the
    forward (forward, and a backward of two products each), the forward
    being the weight products 2 x tokens x (layer weights x layers +
    the d x V unembedding) and the attention 4 x B x L^2 x (Hq x Dh) a
    layer (scores and values, every (row, key) pair of the dense mask)."""
    d, hd = cfg.d_model, cfg.head_dim
    layer_w = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd \
        + cfg.n_heads * hd * d + 3 * d * cfg.d_ff
    tokens = batch * seq
    fwd = 2 * tokens * (layer_w * cfg.n_layers + d * cfg.vocab_size) \
        + 4 * batch * seq * seq * cfg.n_heads * hd * cfg.n_layers
    return 3 * fwd


def _p12_busy_share(args, cfg, state, dev):
    """Device busy share of one profiled scan call of 2 steps at the
    run's shapes, after a warm call (sampling excluded: host time of the
    steps alone)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sdag_tpu_torch.pipeline import train_qa as T
    tok = T.make_tokenizer(args.tokenizer)
    init_state, _, scan_fn = T.make_training(args, cfg, dev)
    st = init_state(state.params)
    stacked = T.sample_batch_stack(np.random.default_rng(99), tok, None, 2,
                                   args.batch, args.seq_len,
                                   **T.sample_kwargs(args))
    st, _ = scan_fn(st, stacked)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, ls = scan_fn(st, stacked)
        ls.cpu()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_rows(prof)
    total = sum(r[1] for r in rows)
    return {"steps": 2, "wall_ms": wall_us / 1e3,
            "device_ms": total / 1e3 if total else None,
            "device_busy_share": total / wall_us if total else None,
            "top": [{"name": k[:80], "ms": us / 1e3,
                     "share": us / total} for k, us, _n in rows[:8]]}


def _p12_30m(dev, tmp):
    """(c): the 30M word recipe's full width from the port's own init,
    50 steps."""
    import torch
    from sdag_tpu_torch.models.llama import DecoderConfig
    from sdag_tpu_torch.pipeline import train_qa as T
    flags = P12_30M_FLAGS + ["--out", os.path.join(tmp, "ckpt_30m"),
                             "--device", str(dev)]
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = T.main(flags)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if cuda else None
    losses = res["losses"]
    args = T.parse_args(flags)
    tok = T.make_tokenizer(args.tokenizer)
    cfg = DecoderConfig(vocab_size=tok.vocab_size, d_model=args.d_model,
                        n_layers=args.layers, n_heads=args.heads,
                        n_kv_heads=args.kv_heads, d_ff=args.d_ff)
    flops = _p12_flops_per_step(cfg, args.batch, args.seq_len)
    s_step = res["step_s"] / res["steps"]
    rec = {"vocab": cfg.vocab_size, "steps": res["steps"],
           "first_losses": losses[:5], "last_losses": losses[-5:],
           "wall_s": wall, "sample_s": res["sample_s"],
           "step_s": res["step_s"], "steps_per_s": 1.0 / s_step,
           "tok_s_valid": res["valid_tokens"] / res["step_s"],
           "tok_s_padded": res["padded_tokens"] / res["step_s"],
           "valid_share": res["valid_tokens"] / res["padded_tokens"],
           "host_sample_share": res["sample_s"]
           / (res["sample_s"] + res["step_s"]),
           "flops_per_step": flops,
           "f32_peak_share": flops / s_step / PEAK_FLOPS["float32"],
           "peak_mem_gib": peak,
           "final_eval": res["final_eval"]}
    rec["profile"] = _p12_busy_share(args, cfg, res["state"], dev)
    n = min(10, len(losses) // 2)
    first, last = sum(losses[:n]) / n, sum(losses[-n:]) / n
    if not all(math.isfinite(x) for x in losses) or not last < first:
        raise AssertionError(f"phase 12(c): loss not finite and falling "
                             f"(first {n} {first}, last {n} {last}): "
                             f"{rec}")
    if cfg.vocab_size != 1280:
        raise AssertionError(f"phase 12(c): vocab {cfg.vocab_size} is not "
                             "the 30M recipe's 1280")
    return rec


class _P12Recorder:
    """An optimizer wrapper that keeps the gradients of its last update
    (the ones a step applies, after its collectives)."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update_(self, grads, opt_state, params):
        self.grads = [g.detach().clone() for g in grads]
        return self.opt.update_(grads, opt_state, params)


def _p12_width_case(dev):
    """The 30M width's cfg, seeded params (port init) and a word batch."""
    import numpy as np
    import torch
    from sdag_tpu_torch.models.llama import (DecoderConfig,
                                             init_decoder_params)
    from sdag_tpu_torch.pipeline import train_qa as T
    args = T.parse_args(P12_30M_FLAGS + ["--out", "-"])
    tok = T.make_tokenizer("word")
    cfg = DecoderConfig(vocab_size=tok.vocab_size, d_model=args.d_model,
                        n_layers=args.layers, n_heads=args.heads,
                        n_kv_heads=args.kv_heads, d_ff=args.d_ff)
    params = init_decoder_params(torch.Generator(device=dev).manual_seed(5),
                                 cfg, device=dev)
    batch = T.sample_batch(np.random.default_rng(5), tok, None,
                           P12_RANK_ROWS, args.seq_len,
                           **T.sample_kwargs(args))
    return cfg, params, batch


def _p12_steps(cfg, mesh, params, batches, opt):
    """Losses of len(batches) steps, the first step's gradients (as the
    optimizer applied them) and each tensor's update (final - initial),
    on the host."""
    from sdag_tpu_torch.parallel.train import make_sharded_train_step
    from sdag_tpu_torch.utils.tree import flatten_with_paths
    rec = _P12Recorder(opt)
    init_state, step = make_sharded_train_step(cfg, mesh, optimizer=rec)
    state = init_state(params)
    p0 = {k: v.detach().clone() for k, v in
          flatten_with_paths(state.params).items()}
    losses, grads = [], None
    for b in batches:
        state, loss = step(state, b)
        losses.append(float(loss))
        grads = grads or rec.grads
    flat = flatten_with_paths(state.params)
    return {"losses": losses,
            "grads": {k: g.cpu() for k, g in zip(flat, grads)},
            "deltas": {k: (v.detach() - p0[k]).cpu()
                       for k, v in flat.items()}}


def _p12_pp(cfg, mesh, params, batch, opt):
    """GPipe (4 microbatches): the loss, one step, the loss after it and
    the step's gradients (the replicated leaves' summed over 'pipe')."""
    from sdag_tpu_torch.parallel.pipeline import make_pp_train_step
    from sdag_tpu_torch.utils.tree import flatten_with_paths
    rec = _P12Recorder(opt)
    init_state, step, pp_loss = make_pp_train_step(cfg, mesh, n_micro=4,
                                                   optimizer=rec)
    state = init_state(params)
    loss0 = float(pp_loss(state.params, batch))
    state, l1 = step(state, batch)
    loss1 = float(pp_loss(state.params, batch))
    flat = flatten_with_paths(state.params)
    return {"loss": loss0, "step_loss": float(l1), "next_loss": loss1,
            "grads": {k: g.cpu() for k, g in zip(flat, rec.grads)},
            "step": state.step}


def _p12_opts():
    """(the v4 recipe's optimizer: its schedule over 20 steps; a constant
    lr for the 30M-width cases)."""
    from sdag_tpu_torch.parallel.train import (AdamW,
                                               warmup_cosine_decay_schedule)
    return (lambda: AdamW(warmup_cosine_decay_schedule(0.0, 3e-4, 2, 20,
                                                       9e-6),
                          weight_decay=0.01),
            lambda: AdamW(1e-4, weight_decay=0.01))


def _p12_two_ranks(rank, world, device):
    """(e): DP=2 on the v4 recipe, TP=2 and GPipe (2 stages x 4
    microbatches) at the 30M width; two gloo ranks on one card."""
    import torch
    from sdag_tpu_torch.core.mesh import make_mesh, make_pipe_mesh
    from sdag_tpu_torch.parallel import collectives as C
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    v4_opt, w_opt = _p12_opts()
    out, step_s = {}, {}
    t0 = time.perf_counter()
    cfg, params, batches = _p12_v4_case(dev)
    out["dp"] = _p12_steps(cfg, make_mesh(2, 1, device=dev), params,
                           batches, v4_opt())
    step_s["dp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg, params, batch = _p12_width_case(dev)
    out["tp"] = _p12_steps(cfg, make_mesh(1, 2, device=dev), params,
                           [batch, batch], w_opt())
    step_s["tp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["pp"] = _p12_pp(cfg, make_pipe_mesh(2, device=dev), params, batch,
                        w_opt())
    step_s["pp"] = time.perf_counter() - t0
    out["step_s"] = step_s
    out["calls"] = {"/".join(k): v for k, v in C.CALLS.items()}
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                       if dev.type == "cuda" else None)
    return out


def _p12_v4_case(dev):
    from sdag_tpu_torch.models.native_ckpt import load_decoder
    _ref, flags = _p12_ref_flags("-", dev)
    args, cfg, batches = _p12_recipe(flags)
    params, _ = load_decoder(P12_V4, device=dev)
    return cfg, params, batches[:3]


def _p12_one_rank(dev):
    """The one-rank results (e) holds the ranks to, computed first."""
    from sdag_tpu_torch.core.mesh import make_mesh
    from sdag_tpu_torch.utils.tree import tree_map
    v4_opt, w_opt = _p12_opts()
    one = make_mesh(1, 1, device=dev)
    cfg, params, batches = _p12_v4_case(dev)
    out = {"dp": _p12_steps(cfg, one, params, batches, v4_opt())}
    cfg, params, batch = _p12_width_case(dev)
    out["w"] = _p12_steps(cfg, one, params, [batch, batch], w_opt())
    out["w_cfg"] = cfg
    out["w_template"] = tree_map(lambda _x: 0, params)
    return out


def _p12_grad_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def _p12_check_ranks(ranks, one):
    """Every rank against one rank; returns the largest errors."""
    import torch
    from sdag_tpu_torch.core.mesh import Mesh
    from sdag_tpu_torch.parallel.checkpoint import _slice
    from sdag_tpu_torch.parallel.pipeline import (stack_layer_params,
                                                  stacked_param_specs)
    from sdag_tpu_torch.parallel.sharding import decoder_param_specs
    from sdag_tpu_torch.utils.tree import flatten_with_paths, unflatten_like
    cfg = one["w_cfg"]
    w_tree = unflatten_like(one["w_template"], one["w"]["grads"])
    plain_specs = flatten_with_paths(decoder_param_specs(cfg))
    stacked = flatten_with_paths(stack_layer_params(w_tree))
    pp_specs = flatten_with_paths(stacked_param_specs(
        stack_layer_params(w_tree)))
    err = {"dp_loss": 0.0, "dp_step_loss": 0.0, "dp_grad": 0.0,
           "dp_norm": 0.0, "tp_loss": 0.0, "tp_step_loss": 0.0,
           "tp_grad": 0.0, "tp_norm": 0.0, "tp_replicated_equal": 0.0,
           "pp_loss": 0.0, "pp_step_loss": 0.0, "pp_grad": 0.0}

    def rel(a, b):
        return abs(a - b) / abs(b)

    for r, rk in enumerate(ranks):
        for case in ("dp", "tp"):
            want = one["dp" if case == "dp" else "w"]
            got = rk[case]
            err[f"{case}_loss"] = max(err[f"{case}_loss"],
                                      rel(got["losses"][0],
                                          want["losses"][0]))
            err[f"{case}_step_loss"] = max(
                [err[f"{case}_step_loss"]] + [
                    rel(a, b) for a, b in zip(got["losses"][1:],
                                              want["losses"][1:])])
            mesh = Mesh({"model": 2}, {"model": r}, {}, torch.device("cpu"))

            def mine(x, k):     # this rank's slice of a one-rank tensor
                return _slice(x, plain_specs[k], mesh) if case == "tp" \
                    else x

            for k, g in got["grads"].items():
                err[f"{case}_grad"] = max(err[f"{case}_grad"], _p12_grad_err(
                    g, mine(want["grads"][k], k)))
                norm = float(mine(want["deltas"][k], k).double().norm())
                if norm > 0:
                    err[f"{case}_norm"] = max(err[f"{case}_norm"], rel(
                        float(got["deltas"][k].double().norm()), norm))
        pp = rk["pp"]
        err["pp_loss"] = max(err["pp_loss"], rel(pp["loss"],
                                                 one["w"]["losses"][0]),
                             rel(pp["step_loss"], one["w"]["losses"][0]))
        err["pp_step_loss"] = max(err["pp_step_loss"],
                                  rel(pp["next_loss"],
                                      one["w"]["losses"][1]))
        mesh = Mesh({"pipe": 2}, {"pipe": r}, {}, torch.device("cpu"))
        for k, g in pp["grads"].items():
            w = _slice(stacked[k], pp_specs[k], mesh)
            err["pp_grad"] = max(err["pp_grad"], _p12_grad_err(g, w))
    a, b = (rk["tp"]["grads"] for rk in ranks)
    for k in a:
        if plain_specs[k] in ((None,), (None, None)):
            err["tp_replicated_equal"] = max(err["tp_replicated_equal"],
                                             _p12_grad_err(a[k], b[k]))
    return err


def phase12(dev):
    """Training on the card: (a) train_qa at the JAX CPU reference's
    flags against reference.json, with two planted faults; (b) the
    trained directory served; (d) resume from a train-state checkpoint;
    (c) the 30M word recipe's width, 50 steps; (e) DP, TP and GPipe on
    two gloo ranks against one rank.  Returns the phase's record."""
    import torch
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.parallel.launch import run_ranks
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    from sdag_tpu_torch.utils.synth_qa import load_world
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p12_")
    rec, step_s = {}, {}
    try:
        # (a) the port's train_qa.main against the JAX CPU reference
        t0 = time.perf_counter()
        ckpt = os.path.join(tmp, "ckpt")
        ref, flags = _p12_ref_flags(ckpt, dev)
        res = _p12_run_main(flags)
        loss_err, norm_err = _p12_against_ref(
            res["losses"], _p12_update_norms(P12_V4, ckpt), ref)
        faults = {}
        for name, patch in _p12_faults().items():
            out = os.path.join(tmp, name)
            r = _p12_run_main(_p12_ref_flags(out, dev)[1], patch)
            fl, fn = _p12_against_ref(
                r["losses"], _p12_update_norms(P12_V4, out), ref)
            faults[name] = {"loss_err": fl, "norm_err": fn}
        rec["a"] = {"losses": res["losses"], "ref_losses": ref["losses"],
                    "loss_err": loss_err, "norm_err": norm_err,
                    "loss_gate": P12_LOSS_GATE, "norm_gate": P12_NORM_GATE,
                    "faults": faults, "final_eval": res["final_eval"],
                    "ref_final_eval": ref["final_eval"],
                    "sample_s": res["sample_s"], "step_s": res["step_s"],
                    "s_per_step": res["step_s"] / res["steps"]}
        step_s["a"] = time.perf_counter() - t0
        log(f"[phase12] (a) {json.dumps(rec['a'])}")
        if not (loss_err <= P12_LOSS_GATE and norm_err <= P12_NORM_GATE):
            raise AssertionError(f"phase 12(a): the port's run leaves the "
                                 f"reference's gate: {rec['a']}")
        for name, f in faults.items():
            if not (f["loss_err"] > P12_LOSS_GATE
                    or f["norm_err"] > P12_NORM_GATE):
                raise AssertionError(f"phase 12(a): planted fault {name} "
                                     f"reads within the gate: {f}")
        # (b) the trained directory served by phase 3's pipeline config
        t0 = time.perf_counter()
        world = load_world(os.path.join(ckpt, "world.json"))
        LAUNCHES.clear()
        cfg, _ = _synth_cfg(os.path.join(tmp, "serve"), world,
                            world.eval_entities[:4], 1, world.seed + 1, 0,
                            LLM_CHECKPOINT=ckpt)
        m = run_experiment(cfg, device=dev)[(5, 0)]["answer_match_stats"]
        rec["b"] = {"acc_iso": m["iso"]["ground_truth_match_rate"],
                    "acc_noiso": m["no_iso"]["ground_truth_match_rate"],
                    "launches": dict(LAUNCHES)}
        step_s["b"] = time.perf_counter() - t0
        log(f"[phase12] (b) {json.dumps(rec['b'])}")
        if not (rec["b"]["acc_iso"] >= 0.5 and rec["b"]["acc_noiso"] >= 0.5
                and LAUNCHES["sdag_prefill_f32"]
                and LAUNCHES["bm25_scan_topk"]):
            raise AssertionError(f"phase 12(b): serving the card-trained "
                                 f"checkpoint: {rec['b']}")
        # (d) resume from a train-state checkpoint after step 10
        t0 = time.perf_counter()
        rec["d"], uninterrupted = _p12_resume(flags, dev, tmp)
        rec["d"]["equals_main_run"] = uninterrupted == res["losses"]
        step_s["d"] = time.perf_counter() - t0
        log(f"[phase12] (d) {json.dumps(rec['d'])}")
        # (c) the 30M word recipe's width
        t0 = time.perf_counter()
        rec["c"] = _p12_30m(dev, tmp)
        step_s["c"] = time.perf_counter() - t0
        log(f"[phase12] (c) {json.dumps(rec['c'])}")
        # (e) two gloo ranks on the one card against one rank
        t0 = time.perf_counter()
        one = _p12_one_rank(dev)
        step_s["e_one_rank"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = run_ranks(_p12_two_ranks, 2, str(dev), backend="gloo",
                          threads=None)
        step_s["e_two_ranks"] = time.perf_counter() - t0
        err = _p12_check_ranks(ranks, one)
        gates = {"dp_loss": P12_RANK_LOSS_GATE, "tp_loss":
                 P12_RANK_LOSS_GATE, "dp_step_loss": P12_RANK_STEP_GATE,
                 "tp_step_loss": P12_RANK_STEP_GATE,
                 "pp_step_loss": P12_RANK_STEP_GATE,
                 "dp_norm": P12_RANK_NORM_GATE,
                 "tp_norm": P12_RANK_NORM_GATE,
                 "dp_grad": P12_RANK_GRAD_GATE,
                 "tp_grad": P12_RANK_GRAD_GATE,
                 "pp_grad": P12_RANK_GRAD_GATE,
                 "tp_replicated_equal": P12_RANK_GRAD_GATE,
                 "pp_loss": P12_PP_LOSS_GATE}
        rec["e"] = {"errors": err, "gates": gates,
                    "rank_step_s": [r["step_s"] for r in ranks],
                    "calls": [r["calls"] for r in ranks],
                    "peak_gib": [r["peak_gib"] for r in ranks],
                    "pp_steps": [r["pp"]["step"] for r in ranks],
                    "note": "gloo, two ranks on one card: not a multi-GPU "
                            "number"}
        log(f"[phase12] (e) {json.dumps(rec['e'])}")
        over = {k: v for k, v in err.items() if not v <= gates[k]}
        if over:
            raise AssertionError(f"phase 12(e): two ranks leave their "
                                 f"gates: {over}; {rec['e']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["step_s"] = step_s
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[phase12] steps {json.dumps(step_s)}")
    return rec


def _first_batch_questions(cfg):
    from sdag_tpu_torch.utils.parsing import load_from_csv
    return load_from_csv(cfg.CSV_INPUT_PATH).questions[
        :cfg.BATCH_SIZE_EMBED_Q]


# ---------------------------------------------------------------- phase 13
# K7 against its plain version: the K/V it writes bit for bit; outputs
# within 4x the largest error read on the card over these cases (9.8e-4
# bf16: p and the output round to bf16 at other sums; 4.0e-7 f32: sums in
# another order over <= 4K terms, limit 25x), and each row within the
# row-relative limits of K1 (a dropped chunk or a few leaked slots in a
# long row sit under any absolute limit)
K7_BF16_TOL, K7_F32_TOL = 4e-3, 1e-5
# (name, dtype, B, Hq, Hkv, Dh, slots, rope theta, HF llama3 scaling)
K7_CASES = (
    ("a_top5_bf16", "bfloat16", 8, 32, 8, 128, 928, 1e6, None),
    ("b_top20_bf16", "bfloat16", 8, 32, 8, 128, 3232, 1e6, None),
    ("c_llama3_bf16", "bfloat16", 8, 32, 8, 128, 1056, 5e5,
     (8.0, 1.0, 4.0, 8192)),
    ("d_tp2_rank_bf16", "bfloat16", 8, 16, 4, 128, 928, 1e6, None),
    ("e_hf8b_f32", "float32", 8, 32, 8, 128, 672, 5e5, (8.0, 1.0, 4.0, 8192)),
    ("f_qa_ckpt_f32", "float32", 8, 6, 6, 32, 672, 5e5, None),
    ("g_dh64_g2_bf16", "bfloat16", 3, 8, 4, 64, 200, 1e4, None),
    ("h_dh64_g8_f32", "float32", 2, 16, 2, 64, 130, 1e4, None),
    ("i_dh32_g1_bf16", "bfloat16", 5, 4, 4, 32, 65, 1e4, None),
)


def _k7_mask(g, dev, B, S, w):
    """A decode step's valid slots: a ragged prompt (its tail padding and
    a few holes masked), generated slots up to the write slot ``w``; row
    0 with a whole masked chunk inside its prompt, the last row with the
    write slot alone."""
    import torch
    lp = max(1, w - 16)
    vl = torch.randint(max(1, lp // 2), lp + 1, (B,), generator=g,
                       device=dev)
    j = torch.arange(S, device=dev)[None, :]
    mask = (j < vl[:, None]) & (torch.rand(B, S, generator=g, device=dev)
                                > 0.05)
    mask |= (j >= lp) & (j <= w)
    if lp > 192:
        mask[0, 64:128] = False
    mask[-1] = j[0] == w
    return mask


def _k7_case(name, dtype, B, Hq, Hkv, Dh, S, theta, scaling, g, dev,
             timed=True):
    """One K7 case against its plain version on the card: the step's
    caches bit-equal, outputs within the dtype's absolute and row-relative
    limits, which must flag the attention entry run with one chunk of a
    row's valid slots dropped (a planted fault); the attention entry over
    the written cache, on q rotated by the plain rope, equal to the step
    bit for bit; one row alone, and over a longer cache whose extra slots
    are masked, equal too (row independence).  Timed: device
    time of a replayed graph of K7, the plain version and SDPA (enable_gqa,
    the yardstick), and the bound over the valid slots' K/V bytes."""
    import torch
    import torch.nn.functional as F
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.models.llama import rope_freqs
    from sdag_tpu_torch.ops import attention as A
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dt)
    q, k, v = rnd(B, Hq, Dh), rnd(B, Hkv, Dh), rnd(B, Hkv, Dh)
    kc, vc = rnd(B, Hkv, S, Dh), rnd(B, Hkv, S, Dh)
    w = S - 1 - int(torch.randint(0, min(S, 24), (1,), generator=g,
                                  device=dev))
    mask = _k7_mask(g, dev, B, S, w)
    positions = torch.randint(0, 4096, (B,), generator=g, device=dev)
    positions[0] = 30000
    wi = torch.tensor([w], device=dev)
    freqs = rope_freqs(Dh // 2, theta, scaling, dev)
    kc_p, vc_p, kc_k, vc_k = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    out_p = A.decode_attention_reference(q, k, v, kc_p, vc_p, mask, wi,
                                         positions, freqs)
    before = LAUNCHES["decode_attention"]
    out_k = A.decode_attention_cuda(q, kc_k, vc_k, mask,
                                    new_kv=(k, v, wi, positions, freqs))
    torch.cuda.synchronize()
    launches = LAUNCHES["decode_attention"] - before
    kv_equal = torch.equal(kc_k, kc_p) and torch.equal(vc_k, vc_p)
    every_row = torch.ones(B, 1, dtype=torch.bool, device=dev)
    err, row_err = _row_errors(out_k[:, :, None], out_p[:, :, None],
                               every_row)
    q_rot = A.apply_rope(q[:, :, None], positions[:, None], freqs)[:, :, 0]
    entry = A.decode_attention_cuda(q_rot, kc_k, vc_k, mask)
    # planted fault: the row with the most valid slots loses the chunk
    # that holds most of them
    f = int(mask.sum(1).argmax())
    per_chunk = F.pad(mask[f], (0, -S % A.K7_CHUNK)).view(
        -1, A.K7_CHUNK).sum(1)
    c = int(per_chunk.argmax())
    dropped = mask.clone()
    dropped[f, c * A.K7_CHUNK:(c + 1) * A.K7_CHUNK] = False
    fault_err, fault_row_err = _row_errors(
        A.decode_attention_cuda(q_rot, kc_k, vc_k, dropped)[:, :, None],
        out_p[:, :, None], every_row)
    r = 1
    alone = A.decode_attention_cuda(q_rot[r:r + 1], kc_k[r:r + 1].clone(),
                                    vc_k[r:r + 1].clone(), mask[r:r + 1])
    extra = 70
    kl = torch.zeros(B, Hkv, S + extra, Dh, dtype=dt, device=dev)
    vl = torch.zeros_like(kl)
    kl[:, :, :S], vl[:, :, :S] = kc_k, vc_k
    kl[:, :, S:], vl[:, :, S:] = rnd(B, Hkv, extra, Dh), rnd(B, Hkv, extra, Dh)
    longer = A.decode_attention_cuda(q_rot, kl, vl, torch.cat(
        [mask, torch.zeros(B, extra, dtype=torch.bool, device=dev)], 1))
    torch.cuda.synchronize()
    tol, row_tol = (K7_BF16_TOL, BF16_ROW_TOL) if dt == torch.bfloat16 \
        else (K7_F32_TOL, F32_ROW_TOL)
    rec = {"name": name, "dtype": dtype, "shape": [B, Hq, Hkv, S, Dh],
           "launches": launches, "kv_bit_equal": kv_equal,
           "max_abs_err": err, "tol": tol, "max_row_rel_err": row_err,
           "row_tol": row_tol, "dropped_chunk_slots": int(per_chunk[c]),
           "dropped_chunk_abs_err": fault_err,
           "dropped_chunk_row_rel_err": fault_row_err,
           "entry_equals_step": torch.equal(entry, out_k),
           "row_alone_equal": torch.equal(alone[0], out_k[r]),
           "longer_cache_equal": torch.equal(longer, out_k),
           "valid_slots": int(mask.sum())}
    if timed:
        item = torch.tensor([], dtype=dt).element_size()
        nbytes = 2 * int(mask.sum()) * Hkv * Dh * item
        sdpa_mask = mask[:, None, None, :]
        rec.update(
            ms=device_ms(lambda: A.decode_attention_cuda(
                q, kc_k, vc_k, mask, new_kv=(k, v, wi, positions, freqs)),
                calls=20),
            plain_ms=device_ms(lambda: A.decode_attention_reference(
                q, k, v, kc_p, vc_p, mask, wi, positions, freqs), calls=20),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                q_rot[:, :, None], kc_k, vc_k, attn_mask=sdpa_mask,
                enable_gqa=True), calls=20),
            bound_ms=1e3 * nbytes / H100_BYTES_PER_S, bound_by="bytes",
            bound_all_slots_ms=1e3 * 2 * B * Hkv * S * Dh * item
            / H100_BYTES_PER_S)
        rec["roofline"] = rec["bound_ms"] / rec["ms"]
    flagged = fault_err > tol or fault_row_err > row_tol
    ok = kv_equal and err <= tol and row_err <= row_tol and flagged \
        and launches == 2 and all(
            rec[key] for key in ("entry_equals_step", "row_alone_equal",
                                 "longer_cache_equal"))
    log(f"[phase13] {json.dumps(rec)}")
    if not ok:
        raise AssertionError(f"phase 13: K7 case {name} failed: {rec}")
    return rec


def _k7_window_rows(dev, G, int8_weights):
    """decode_window over G tokens against G decode steps on the same
    cache (teacher-forced: the same tokens), at the 8B width (4 layers,
    random bf16 weights; int8 ones, K6, where G > 1 needs a product's rows
    independent of the row count): each row's logits and the caches bit
    for bit (the window rotates by the plain rope and scatters, the steps
    run K7's whole block)."""
    import dataclasses
    import torch
    from sdag_tpu_torch.models.llama import (DecoderConfig, decode_step,
                                             decode_window,
                                             init_decoder_params,
                                             make_kv_cache,
                                             quantize_decoder_params_int8)
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    cfg = dataclasses.replace(DecoderConfig.llama3_8b(), n_layers=4)
    params = init_decoder_params(g, cfg, device=dev)
    if int8_weights:
        params = quantize_decoder_params_int8(params, consume=True)
    B, S, w = 8, 928, 900
    cache = make_kv_cache(cfg, B, S, device=dev)
    for key in ("k", "v"):
        cache[key].copy_(torch.randn(cache[key].shape, generator=g,
                                     device=dev))
    mask = _k7_mask(g, dev, B, S, w)
    j = torch.arange(S, device=dev)
    masks = [mask | ((j >= w) & (j <= w + i))[None, :] for i in range(G)]
    tokens = torch.randint(0, cfg.vocab_size, (B, G), generator=g,
                           device=dev)
    positions = torch.randint(0, 1000, (B, 1), generator=g, device=dev) \
        + torch.arange(G, device=dev)
    c_step = {k: t.clone() for k, t in cache.items()}
    c_win = {k: t.clone() for k, t in cache.items()}
    ls = torch.stack([decode_step(
        params, cfg, tokens[:, i], positions[:, i], c_step,
        torch.tensor([w + i], device=dev), masks[i])[0]
        for i in range(G)], 1)
    lw, _ = decode_window(params, cfg, tokens, positions, c_win,
                          torch.full((B,), w, device=dev),
                          torch.stack(masks, 1))
    rec = {"G": G, "int8_weights": int8_weights,
           "logits_equal": torch.equal(ls, lw),
           "logits_max_abs_diff": float((ls - lw).abs().max()),
           "caches_equal": all(torch.equal(c_step[k], c_win[k])
                               for k in ("k", "v"))}
    log(f"[phase13] window rows vs steps {json.dumps(rec)}")
    del params, cache, c_step, c_win
    torch.cuda.empty_cache()
    if not (rec["logits_equal"] and rec["caches_equal"]):
        raise AssertionError(f"phase 13: a window row differs from the "
                             f"decode step: {rec}")
    return rec


def _graph_kernel_names(graph):
    """Kernel (and memcpy / memset) names of one replay of ``graph``,
    counted by torch.profiler (a replayed graph's nodes reach CUPTI one
    by one)."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    return collections.Counter(e.name for e in prof.events()
                               if e.device_type == DeviceType.CUDA)


def _graph_kernels(graph) -> int:
    """Kernels (and memcpy / memset nodes) one replay of ``graph`` runs."""
    return sum(_graph_kernel_names(graph).values())


def _decode_graphs(dev, tag, swap, kernel, plain, count_key, names=None,
                   lp=896, max_new=32, prompt=782, replays=10):
    """The top-5 cell's decode shape at the 8B width and depth (random
    bf16 weights, batch 8, 896 prompt slots with 782 valid, 32 new
    tokens): the captured 8-step graph with ``models.llama``'s global
    ``swap`` set to ``kernel`` (record ``tag``, "k7" or "k9") and to its
    ``plain`` version; for each, kernels a step in one replay, ms a step
    over replays (same card, same call), ``LAUNCHES[count_key]`` at
    capture (the eager warm-up step and the captured ones) and a step,
    and for each ``names`` key the kernels a step whose name holds one of
    its substrings; then graph against eager tokens through the
    kernel."""
    import torch
    import sdag_tpu_torch.models.llama as L
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.models.llama import DecoderConfig, init_decoder_params
    from sdag_tpu_torch.models.tokenizer import load_tokenizer
    from sdag_tpu_torch.sdag.generate import Generator
    cfg = DecoderConfig.llama3_8b()
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    params = init_decoder_params(g, cfg, device=dev)
    phase = {"k7": "phase 13", "k9": "phase 15"}[tag]
    rec = {"n_layers": cfg.n_layers}
    for name, fn in ((tag, kernel), ("plain", plain)):
        setattr(L, swap, fn)
        try:
            gen = Generator(params, cfg, load_tokenizer(""), temperature=0.0,
                            batch_bucket=8, device=dev)
            before = LAUNCHES[count_key]
            buf = gen._buffers(8, lp, max_new, graphs=True)
            launches = LAUNCHES[count_key] - before
        finally:
            setattr(L, swap, kernel)
        steps = 1 + sum(buf.step_counts())
        buf.base_mask[:, :prompt] = True
        graph = buf.graphs[gen.decode_chunk]
        buf.t.zero_()
        kernels = _graph_kernel_names(graph)
        times = []
        for _ in range(replays):
            buf.t.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / gen.decode_chunk)
        rec[name] = {"capture_launches": launches, "steps_run": steps,
                     "launches_per_step": launches / steps,
                     "kernels_per_step": sum(kernels.values())
                     / gen.decode_chunk,
                     "ms_per_step": sorted(times)[len(times) // 2],
                     "ms_per_step_all": times}
        for key, subs in (names or {}).items():
            rec[name][key] = sum(n for k, n in kernels.items()
                                 if any(x in k for x in subs)) \
                / gen.decode_chunk
        if name == tag:
            rec["graph_vs_eager"], _ = _decode_graph_vs_eager(gen, dev,
                                                              tag=phase)
        del gen, buf, graph
        torch.cuda.empty_cache()
    rec["kernels_fewer_per_step"] = (rec["plain"]["kernels_per_step"]
                                     - rec[tag]["kernels_per_step"])
    log(f"[{phase.replace(' ', '')}] decode graphs {json.dumps(rec)}")
    del params
    _free_cuda()
    return rec


def _k7_speculation(dev):
    """Greedy speculative decode (D = 4) against plain greedy decode at the
    8B width and depth with int8 weights (K6 keeps a product's rows
    independent), f32 activations and the native cache (K7's f32 body):
    the plain steps run K7's whole block, the windows its attention entry;
    tokens equal, graph against eager (``_p8_equality``)."""
    import dataclasses
    import torch
    import sdag_tpu_torch.models.llama as L
    from sdag_tpu_torch.models.tokenizer import load_tokenizer
    from sdag_tpu_torch.sdag.generate import Generator
    cfg = dataclasses.replace(L.DecoderConfig.llama3_8b(),
                              dtype=torch.float32)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    params = L.quantize_decoder_params_int8(
        L.init_decoder_params(g, cfg, device=dev), consume=True)
    gen = Generator(params, cfg, load_tokenizer(""), temperature=0.0,
                    batch_bucket=8, device=dev)
    rec = {"f32": _p8_equality(gen, dev, kv_cache_dtype="native",
                               tag="phase 13 f32")}
    del gen, params
    torch.cuda.empty_cache()
    log(f"[phase13] speculation {json.dumps(rec)}")
    return rec


def phase13(dev):
    """K7 (csrc/decode_attention.cu): (a) its cases against the plain
    version; (b) window rows against decode steps at 8B width (G = 1 on
    bf16 weights, G = 4 on int8 ones); (c) the top-5 decode graph with K7
    and with the plain block; (d) greedy speculation against plain greedy
    at 8B with f32 activations.  Returns the phase's record."""
    import torch
    from sdag_tpu_torch.ops import attention as A
    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    rec = {"a": [_k7_case(*case, g, dev) for case in K7_CASES]}
    rec["b"] = [_k7_window_rows(dev, 1, False),
                _k7_window_rows(dev, 4, True)]
    rec["c"] = c = _decode_graphs(dev, "k7", "decode_attention",
                                  A.decode_attention,
                                  A.decode_attention_reference,
                                  "decode_attention")
    if c["k7"]["capture_launches"] < 2 * c["n_layers"] \
            or c["plain"]["capture_launches"] != 0:
        raise AssertionError(f"phase 13: K7 launches at capture {c}")
    if c["kernels_fewer_per_step"] < 28 * c["n_layers"]:
        raise AssertionError(f"phase 13: the K7 step graph is not ~31 "
                             f"kernels a layer smaller: {c}")
    rec["d"] = _k7_speculation(dev)
    rec["phase_s"] = time.perf_counter() - t0
    return rec


# --------------------------------------------------------------- phase 14
# K8's output is rounded once to bf16 (0.4% of a value); a row's max error
# over its RMS may read 2.5x that.  Dropping one of 8 routed experts moves
# a row by about a third of its RMS.
K8_ROW_TOL = 1e-2
# the decode shape of mellum2.poison_top20 (B 8, 64 experts, top 8)
K8_DIMS = (64, 8, 2304, 896)
P14_WINDOW = 1024


def _k8_weights(g, dev, E, d, f):
    """A layer's router [d, E] and experts (N(0, 1/fan_in), bf16)."""
    import torch

    def rnd(shape, fan_in):
        return (torch.randn(*shape, generator=g, device=dev)
                * fan_in ** -0.5).to(torch.bfloat16)
    return {"router": rnd((d, E), d), "gate_up": rnd((E, 2 * f, d), d),
            "down": rnd((E, d, f), f)}


def _k8_case(name, x, moe, k, live=None, timed=False, plant=False):
    """K8 against its plain version given K8's own routes (rows the plain
    router routes elsewhere, near ties in f32, are counted apart), the
    routes' weights, the distinct-expert counter, dead rows 0, a captured
    replay equal to the eager call; planted: one routed expert's weights
    zeroed must read over the limit; timed: device time of a replayed
    graph, the bound, the plain version and route + grouped products."""
    import torch
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.ops import moe as M
    dev = x.device
    B, d = x.shape
    E, f = moe["gate_up"].shape[0], moe["down"].shape[2]
    alive = torch.ones(B, dtype=torch.bool, device=dev) if live is None \
        else live
    args = (moe["router"], moe["gate_up"], moe["down"], k, True, live)
    reads = torch.zeros(1, dtype=torch.int64, device=dev)
    idx_k = torch.empty(B, k, dtype=torch.int32, device=dev)
    w_k = torch.empty(B, k, dtype=torch.float32, device=dev)
    before = LAUNCHES["moe_experts"]
    out_k = M.moe_experts_cuda(x, *args, reads=reads, idx_out=idx_k,
                               w_out=w_k)
    launches = LAUNCHES["moe_experts"] - before
    idx_k = idx_k.long()
    w_p, idx_p = M.route(x, moe["router"], k)
    sk, ok = idx_k.sort(-1)
    sp, op = idx_p.sort(-1)
    same = (sk == sp).all(-1) & alive
    w_err = float((w_k.gather(1, ok) - w_p.gather(1, op))[same].abs().max()) \
        if same.any() else 0.0
    out_p = M.moe_experts_reference(x, *args, routes=(w_k, idx_k.clamp(
        min=0)))

    def row_rel(a, b):
        err = (a.float() - b.float()).abs().amax(-1)
        rms = b.float().pow(2).mean(-1).sqrt().clamp_min(1e-30)
        return float((err / rms)[alive].max()), float(err[alive].max())
    rel, err = row_rel(out_k, out_p)
    distinct = int(idx_k[alive].unique().numel())
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        M.moe_experts_cuda(x, *args)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out_g = M.moe_experts_cuda(x, *args)
    graph.replay()
    torch.cuda.synchronize()
    rec = {"name": name, "B": B, "E": E, "k": k, "d": d, "f": f,
           "launches": launches,
           "route_rows_differ": int((~same & alive).sum()),
           "route_weight_max_abs_err": w_err, "max_abs_err": err,
           "max_row_rel_err": rel, "row_tol": K8_ROW_TOL,
           "expert_reads": int(reads), "distinct_experts": distinct,
           "dead_rows_zero": bool((out_k[~alive] == 0).all()),
           "graph_equal": bool(torch.equal(out_g, out_k))}
    if not (rel <= K8_ROW_TOL and rec["expert_reads"] == distinct
            and rec["dead_rows_zero"] and rec["graph_equal"]
            and w_err <= 1e-5 and launches == M.K8_LAUNCHES
            and rec["route_rows_differ"] <= max(1, B // 8)):
        raise AssertionError(f"K8 {name}: {json.dumps(rec)}")
    if plant:
        e0 = int(idx_k[int(alive.nonzero()[0])][0])
        broken = dict(moe, gate_up=moe["gate_up"].clone())
        broken["gate_up"][e0] = 0
        fault = M.moe_experts_cuda(x, broken["router"], broken["gate_up"],
                                   broken["down"], k, True, live)
        rec["fault_max_row_rel_err"] = row_rel(fault, out_p)[0]
        del broken
        if not rec["fault_max_row_rel_err"] > K8_ROW_TOL:
            raise AssertionError(f"K8 {name}: a dropped expert read "
                                 f"{rec['fault_max_row_rel_err']}")
    if timed:
        es = 2
        nbytes = distinct * 3 * d * f * es + 2 * int(alive.sum()) * d * es
        flops = 2.0 * 3 * d * f * k * int(alive.sum())
        t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], \
            nbytes / H100_BYTES_PER_S

        def library():
            w, i = M.route(x, moe["router"], k)
            return M.expert_products(x, w, i, moe["gate_up"], moe["down"])
        rec.update(ms=device_ms(lambda: M.moe_experts_cuda(x, *args),
                                calls=10, replays=5),
                   plain_ms=device_ms(lambda: M.moe_experts_reference(
                       x, *args), calls=3, replays=2),
                   library_ms=cuda_ms(library, iters=5, warmup=2),
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
    log(f"[phase14] {json.dumps(rec)}")
    return rec


def _k8_rows_independent(x, moe, k):
    """Each row of a B 8 call bit for bit its own B 1 call and its row of
    a B 32 call (the 8 rows first, then 24 others): the output, the picks
    and their weights.  Returns the record; raises where a row differs."""
    import torch
    from sdag_tpu_torch.ops import moe as M
    dev = x.device
    B, d = x.shape
    w3 = (moe["router"], moe["gate_up"], moe["down"], k)

    def call(rows):
        n = rows.shape[0]
        idx = torch.empty(n, k, dtype=torch.int32, device=dev)
        w = torch.empty(n, k, dtype=torch.float32, device=dev)
        return M.moe_experts_cuda(rows, *w3, idx_out=idx, w_out=w), idx, w
    g = torch.Generator(device=dev)
    g.manual_seed(141)
    x32 = torch.cat([x, torch.randn(32 - B, d, generator=g, device=dev).to(
        torch.bfloat16)])
    b8, b32 = call(x), call(x32)
    alone = [call(x[b:b + 1].contiguous()) for b in range(B)]
    rec = {"name": "rows_independent", "B": B,
           "rows_equal_b1": sum(all(torch.equal(a, o[b:b + 1])
                                    for a, o in zip(alone[b], b8))
                                for b in range(B)),
           "rows_equal_b32": sum(all(torch.equal(o32[b], o[b])
                                     for o32, o in zip(b32, b8))
                                 for b in range(B))}
    log(f"[phase14] {json.dumps(rec)}")
    if rec["rows_equal_b1"] != B or rec["rows_equal_b32"] != B:
        raise AssertionError(f"K8: rows depend on the batch: {rec}")
    return rec


def _p14_k8(dev):
    """(a) K8 at the cell's decode shape and beside it."""
    import torch
    from kernel_times import k8_few_expert_rows
    E, k, d, f = K8_DIMS
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    moe = _k8_weights(g, dev, E, d, f)

    def rows(B):
        return torch.randn(B, d, generator=g, device=dev).to(torch.bfloat16)
    x = rows(8)
    live = torch.ones(8, dtype=torch.bool, device=dev)
    live[[2, 5]] = False
    same8 = rows(1).expand(8, d).contiguous()
    few = k8_few_expert_rows(g, moe["router"], k)
    recs = [_k8_case("a_decode_b8", x, moe, k, timed=True, plant=True),
            _k8_case("b_two_rows_done", x, moe, k, live=live),
            _k8_case("c_every_row_the_same_experts", same8, moe, k),
            _k8_case("e_b1", rows(1), moe, k),
            _k8_case("f_b32_same_experts", rows(1).expand(32, d).contiguous(),
                     moe, k),
            _k8_case("g_b8_few_experts", few, moe, k, timed=True,
                     plant=True)]
    by = {r["name"]: r for r in recs}
    if not by["a_decode_b8"]["distinct_experts"] < E:
        raise AssertionError("K8: every expert got a row; no empty expert")
    if by["c_every_row_the_same_experts"]["expert_reads"] != k:
        raise AssertionError("K8: identical rows read more than k experts")
    if not 16 <= by["g_b8_few_experts"]["distinct_experts"] <= 24:
        raise AssertionError("K8: the few-experts case names "
                             f"{by['g_b8_few_experts']['distinct_experts']}")
    return recs, _k8_rows_independent(x, moe, k)


def _p14_layout(L, vl, dev):
    """An ISO layout of 25 passages with holes between some, ragged valid
    lengths; (doc_id, nbr, sys_user_len, valid_len, positions)."""
    import torch
    from sdag_tpu_torch.models.llama import positions_from_doc_id
    doc, nbr = _layout_docs(L, 180, 25, 112, False)
    doc = torch.as_tensor(doc, device=dev)
    for d in range(3, 25, 4):               # 4 holes after every 4th doc
        s = 180 + d * 112
        doc[s:s + 4] = -2
    doc = doc[None].repeat(len(vl), 1).contiguous()
    nbr = torch.zeros_like(doc)
    sul = torch.full((len(vl),), 180, dtype=torch.int32, device=dev)
    vlt = torch.tensor(vl, dtype=torch.int32, device=dev)
    return doc, nbr, sul, vlt, positions_from_doc_id(doc)


def _p14_k1_window(dev, dtype, uniform, window_k1=P14_WINDOW):
    """K1 with the windowed plan against the plain windowed version at
    ~3k tokens (Hq 32, Hkv 4, Dh 128).  ``uniform``: q = 0 and v's first
    dim the key's position / 1000, so each row's output is the mean over
    its visible keys and one key more or less shows."""
    import torch
    from sdag_tpu_torch.ops import attention as A
    dt = getattr(torch, dtype)
    L, B, Hq, Hkv, Dh = 3072, 2, 32, 4, 128
    doc, nbr, sul, vl, pos = _p14_layout(L, [3000, 2600], dev)
    g = torch.Generator(device=dev)
    g.manual_seed(141)
    q = torch.randn(B, Hq, L, Dh, generator=g, device=dev).to(dt)
    k = torch.randn(B, Hkv, L, Dh, generator=g, device=dev).to(dt)
    v = torch.randn(B, Hkv, L, Dh, generator=g, device=dev).to(dt)
    if uniform:
        q.zero_()
        v[..., 0] = (pos.float() / 1000)[:, None, :].to(dt)
    plan = A.prefill_mask_plan(doc, nbr, sul, vl, window=window_k1,
                               positions=pos)
    out_k = A.sdag_prefill_cuda(q, k, v, plan)
    out_p = A.sdag_attention_reference(q, k, v, doc, nbr, sul, valid_len=vl,
                                       window=P14_WINDOW, positions=pos)
    torch.cuda.synchronize()
    rows = (torch.arange(L, device=dev)[None] < vl[:, None]) & (doc != -2)
    err, row_err = _row_errors(out_k, out_p, rows)
    full = A.prefill_mask_plan(doc, nbr, sul, vl)
    return {"dtype": dtype, "uniform": uniform, "window_k1": window_k1,
            "max_abs_err": err, "max_row_rel_err": row_err,
            "live_tiles": int((plan["kinds"] > 0).sum()),
            "live_tiles_without_window": int((full["kinds"] > 0).sum()),
            "partial_tiles": int((plan["kinds"] == A.BLOCK_PARTIAL).sum())}


def _p14_k7_window(dev, dtype, uniform, window_k7=P14_WINDOW, timed=False):
    """K7's step at a windowed layer (the mask as the Generator builds it
    from each slot's RoPE position, the YaRN scale) against the plain
    block at the cell's decode shape (B 8, Hq 32, Hkv 4, Dh 128, 3,232
    slots); ``uniform`` as in ``_p14_k1_window``."""
    import torch
    from sdag_tpu_torch.models.llama import DecoderConfig, layer_freqs
    from sdag_tpu_torch.ops import attention as A
    dt = getattr(torch, dtype)
    cfg = DecoderConfig.mellum2_12b_a2p5b()
    B, Hq, Hkv, Dh, lp, t = 8, 32, 4, 128, 3200, 17
    S = lp + 32
    g = torch.Generator(device=dev)
    g.manual_seed(142)
    doc, _, _, vl, _ = _p14_layout(lp, [3100 - 60 * i for i in range(B)],
                                   dev)
    slot = torch.arange(S, device=dev)[None]
    visible = (slot[:, :lp] < vl[:, None]) & (doc != -2)
    real = visible.sum(1)
    spos = torch.cat([visible.cumsum(1) - 1, real[:, None] + slot[:, lp:]
                      - lp], 1)
    mask = torch.cat([visible, (slot[:, lp:] <= lp + t).expand(B, -1)], 1)
    qpos = real + t
    wmask = mask & (spos > (qpos - window_k7)[:, None])
    wmask_p = mask & (spos > (qpos - P14_WINDOW)[:, None])
    q = torch.randn(B, Hq, Dh, generator=g, device=dev).to(dt)
    kn, vn = (torch.randn(B, Hkv, Dh, generator=g, device=dev).to(dt)
              for _ in range(2))
    kc = torch.randn(B, Hkv, S, Dh, generator=g, device=dev).to(dt)
    vc = torch.randn(B, Hkv, S, Dh, generator=g, device=dev).to(dt)
    if uniform:
        q.zero_()
        vc[..., 0] = (spos.float() / 1000)[:, None, :].to(dt)
        vn[..., 0] = (qpos.float() / 1000)[:, None].to(dt)
    wi = torch.tensor([lp + t], device=dev)
    freqs = layer_freqs(cfg, 0, dev)
    scale = cfg.attn_scale(3)
    kc_p, vc_p = kc.clone(), vc.clone()
    out_p = A.decode_attention_reference(q, kn, vn, kc_p, vc_p, wmask_p, wi,
                                         qpos, freqs, scale)
    out_k = A.decode_attention_cuda(q, kc, vc, wmask,
                                    new_kv=(kn, vn, wi, qpos, freqs),
                                    scale=scale)
    torch.cuda.synchronize()
    every = torch.ones(B, 1, dtype=torch.bool, device=dev)
    err, row_err = _row_errors(out_k[:, :, None], out_p[:, :, None], every)
    rec = {"dtype": dtype, "uniform": uniform, "window_k7": window_k7,
           "slots": S, "valid_slots": int(mask.sum()),
           "window_slots": int(wmask.sum()), "max_abs_err": err,
           "max_row_rel_err": row_err}
    if timed:
        rec["ms_window"] = device_ms(lambda: A.decode_attention_cuda(
            q, kc, vc, wmask, new_kv=(kn, vn, wi, qpos, freqs), scale=scale))
        rec["ms_full"] = device_ms(lambda: A.decode_attention_cuda(
            q, kc, vc, mask, new_kv=(kn, vn, wi, qpos, freqs)))
    return rec


def _p14_windows(dev):
    """(b) the windowed K1 plan and K7 against their plain versions; a
    window one slot off must read over the limits."""
    out = {}
    for kern, fn in (("k1", _p14_k1_window), ("k7", _p14_k7_window)):
        tol = {"bfloat16": (BF16_TOL, BF16_ROW_TOL),
               "float32": (F32_TOL, F32_ROW_TOL)}
        for dtype, uniform in (("bfloat16", False), ("float32", True)):
            kw = {"timed": True} if kern == "k7" and dtype == "bfloat16" \
                else {}
            rec = fn(dev, dtype, uniform, **kw)
            lim, row_lim = tol[dtype]
            rec.update(tol=lim, row_tol=row_lim)
            log(f"[phase14] {kern} window {json.dumps(rec)}")
            if not (rec["max_abs_err"] <= lim
                    and rec["max_row_rel_err"] <= row_lim):
                raise AssertionError(f"{kern} window: {json.dumps(rec)}")
            out[f"{kern}_{dtype}"] = rec
        fault = fn(dev, "float32", True, P14_WINDOW + 1)
        log(f"[phase14] {kern} window one slot off {json.dumps(fault)}")
        if fault["max_abs_err"] <= F32_TOL \
                and fault["max_row_rel_err"] <= F32_ROW_TOL:
            raise AssertionError(f"{kern}: a window one slot off passed")
        out[f"{kern}_fault_one_slot_off"] = fault
    return out


def _p14_decode(dev):
    """(c) Mellum2-12B-A2.5B whole, as mellum2.poison_top20 serves it (28
    layers, random bf16 weights, 24.3 GB): a NO-ISO batch of 8 prompts of
    ~3k tokens (past the window), 32 greedy tokens in captured graphs,
    the launches counted from zero over that decode (a captured graph's
    count at capture; each capture holds at least one step): K8 at least
    4 x 28 (``K8_LAUNCHES`` a layer), K7 at least 2 x 28 and K9 at least
    2 x 28 + 1 a capture.
    Then the eager steps and the graphs again: tokens and expert reads
    equal; ms a step."""
    import numpy as np
    import torch
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.models.llama import (DecoderConfig,
                                             init_decoder_params)
    from sdag_tpu_torch.ops import moe as M
    from sdag_tpu_torch.sdag.generate import Generator
    cfg = DecoderConfig.mellum2_12b_a2p5b()
    g = torch.Generator(device=dev)
    g.manual_seed(143)
    params = init_decoder_params(g, cfg, device=dev)

    class Tok:
        pad_token_id, eos_token_id = 0, 1
    gen = Generator(params, cfg, Tok(), temperature=0.0, device=dev)
    rng = np.random.default_rng(143)
    lens = [3100 - 37 * i for i in range(8)]
    lp = 3200
    ids = torch.zeros(8, lp, dtype=torch.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = torch.from_numpy(rng.integers(300, cfg.vocab_size, n))
    ids = ids.to(dev)
    doc = torch.full((8, lp), -1, dtype=torch.int32, device=dev)
    zeros = torch.zeros_like(doc)
    vl = torch.tensor(lens, dtype=torch.int32, device=dev)
    sul = torch.zeros(8, dtype=torch.int32, device=dev)
    runs = []
    for mode in (True, False, True):
        LAUNCHES.clear()
        captures = gen.stats["graph_captures"]
        before = (gen.stats["decode_s"], gen.stats["decode_steps"],
                  gen.stats["moe_decode_expert_reads"])
        out, lengths = gen._generate(ids, doc, zeros, sul, vl, 32,
                                     graphs=mode)
        runs.append({
            "tokens": out.cpu().tolist(), "lengths": lengths.cpu().tolist(),
            "launches": {k: LAUNCHES[k] for k in ("moe_experts",
                                                  "decode_attention",
                                                  "rms_norm")},
            "captures": gen.stats["graph_captures"] - captures,
            "steps": gen.stats["decode_steps"] - before[1],
            "ms_a_step": 1e3 * (gen.stats["decode_s"] - before[0])
            / max(1, gen.stats["decode_steps"] - before[1]),
            "expert_reads": gen.stats["moe_decode_expert_reads"]
            - before[2]})
    graph, eager, again = runs
    n_l = cfg.n_layers
    rec = {"layers": n_l, "prompt_lens": lens,
           "graphs_equal_eager": graph["tokens"] == eager["tokens"]
           == again["tokens"],
           "expert_reads_graph": graph["expert_reads"],
           "expert_reads_eager": eager["expert_reads"],
           "graph_ms_a_step": again["ms_a_step"],
           "eager_ms_a_step": eager["ms_a_step"],
           "graph_captures": graph["captures"],
           "launches": graph["launches"],
           "k8_launches_eager": eager["launches"]["moe_experts"],
           "moe_prefill_rows": gen.stats["moe_prefill_rows"],
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    log(f"[phase14] decode {json.dumps(rec)}")
    need_k8, need_k7, need_k9 = (k * graph["captures"] for k in (
        M.K8_LAUNCHES * n_l, 2 * n_l, 2 * n_l + 1))
    if not (rec["graphs_equal_eager"] and graph["expert_reads"]
            == eager["expert_reads"] == again["expert_reads"] > 0
            and graph["captures"] >= 1
            and graph["launches"]["moe_experts"] >= need_k8
            and graph["launches"]["decode_attention"] >= need_k7
            and graph["launches"]["rms_norm"] >= need_k9
            and rec["k8_launches_eager"]
            == M.K8_LAUNCHES * n_l * eager["steps"] > 0):
        raise AssertionError(f"phase 14 decode (K8 >= {need_k8}, K7 >= "
                             f"{need_k7}, K9 >= {need_k9} launches): "
                             f"{json.dumps(rec)}")
    del gen, params
    _free_cuda()
    return rec


def phase14(dev):
    """K8 (csrc/moe_experts.cu) and the windows: (a) K8 against its plain
    version at the cell's decode shape (B 8, 64 experts, top 8, 2,304 x
    896) and beside it (a step where two rows are done, every row on the
    same experts, B 1, B 32), a dropped expert
    planted; (b) the windowed K1 plan and K7 against their plain versions
    at ~3k slots, a window one slot off planted; (c) the whole model at
    its widths: captured decode (K7 and K8 launches counted) against
    eager.  Returns the phase's record."""
    t0 = time.perf_counter()
    rec = dict(zip(("a", "a_rows"), _p14_k8(dev)))
    _free_cuda()
    rec["b"] = _p14_windows(dev)
    _free_cuda()
    rec["c"] = _p14_decode(dev)
    rec["phase_s"] = time.perf_counter() - t0
    return rec


# --------------------------------------------------------------- phase 15
# K9 against the plain composition: s bit for bit; in bf16 h is the plain
# h, or the gain times a neighbour (one step either way) of the plain
# composition's bf16 cast of s * r (the row's sum, taken in another order,
# moves r by an f32 step or so, and that may move the cast across a
# rounding point; the gain's product rounds again, so h itself may then
# lie two steps off); in f32 h within 1e-6 of each element
K9_F32_TOL = 1e-6
# name, dtype, rows shape, d: the poison cells' decode and prefill rows
# (Mistral-7B, Mellum2), the HF 8B f32 tree's, qa_ckpt's
K9_CASES = (
    ("a_decode_bf16", "bfloat16", (8, 1), 4096),
    ("b_top5_prefill_bf16", "bfloat16", (8, 896), 4096),
    ("c_top20_prefill_bf16", "bfloat16", (8, 3200), 4096),
    ("d_mellum2_decode_bf16", "bfloat16", (8, 1), 2304),
    ("e_mellum2_prefill_bf16", "bfloat16", (8, 3200), 2304),
    ("f_hf8b_decode_f32", "float32", (8, 1), 4096),
    ("g_hf8b_prefill_f32", "float32", (8, 384), 4096),
    ("h_qa_ckpt_decode_f32", "float32", (8, 1), 192),
    ("i_qa_ckpt_prefill_f32", "float32", (8, 640), 192),
)
# the residual stream's RMS deep in a layer stack, and at its first norm
# (an embedding row of N(0, 1 / vocab) entries), where eps weighs
K9_SCALES = (("unit", 1.0), ("embedding", 0.005))


def _bf16_line(t):
    """bf16 values as integers in order, one a representable step."""
    import torch
    i = t.view(torch.int16).int()
    return torch.where(i < 0, -(i & 0x7FFF), i)


def _bf16_from_line(m):
    import torch
    return torch.where(m < 0, (-m) | 0x8000, m).to(torch.int16).view(
        torch.bfloat16)


def _k9_compare(got, want, w, eps, dtype):
    """(s, h) of K9 against the plain composition's (s, h) for gains w and
    eps: s equal, and h's differing elements, its largest distance in bf16
    steps and the elements that are not the gain times the plain cast or
    one of its neighbours (bf16), or its largest relative error (f32);
    ``ok`` by the phase's limits."""
    import torch
    (s, h), (ws, wh) = got, want
    rec = {"s_bit_equal": torch.equal(s, ws),
           "h_differing": int((h != wh).sum()), "h_elements": h.numel(),
           "h_max_abs_err": float((h.float() - wh.float()).abs().max())}
    if dtype == torch.bfloat16:
        rec["h_max_ulps"] = int((_bf16_line(h) - _bf16_line(wh)).abs().max())
        s32 = ws.float()
        cast = _bf16_line((s32 * torch.rsqrt((s32 * s32).mean(
            -1, keepdim=True) + eps)).to(torch.bfloat16))
        near = torch.zeros_like(h, dtype=torch.bool)
        for k in (-1, 0, 1):
            near |= h == _bf16_from_line(cast + k) * w
        rec["h_off_neighbours"] = int((~near).sum())
        rec["ok"] = rec["s_bit_equal"] and rec["h_off_neighbours"] == 0
    else:
        rel = (h - wh).abs() / wh.abs().clamp_min(1e-30)
        rec["h_max_rel_err"] = float(rel.max())
        rec["ok"] = rec["s_bit_equal"] and rec["h_max_rel_err"] <= K9_F32_TOL
    return rec


def _k9_inputs(g, dev, dt, lead, d, scale):
    import torch
    x = (scale * torch.randn(*lead, d, generator=g, device=dev)).to(dt)
    delta = (0.3 * scale * torch.randn(*lead, d, generator=g,
                                       device=dev)).to(dt)
    w = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(dt)
    return x, delta, w


def _k9_case(name, dtype, lead, d, g, dev, eps=1e-5):
    """One K9 shape against its plain version (add_rms_norm_reference) at
    both scales, with and without the residual; each launch counted; at
    the decode shapes two planted faults (the residual dropped, eps 1e-5
    where the model's is 1e-6, at the embedding scale) must fail the same
    comparison.  Timed at unit scale with the residual: device time of a
    replayed graph of K9, of the plain version and of ``x + delta`` then
    ``torch.nn.functional.rms_norm`` (the library yardstick), the byte
    bound (read x, delta and w, write s and h)."""
    import torch
    from sdag_tpu_torch._build import LAUNCHES
    from sdag_tpu_torch.ops import norm as N
    dt = getattr(torch, dtype)
    rec = {"name": name, "dtype": dtype, "shape": [*lead, d],
           "checks": {}}
    for tag, scale in K9_SCALES:
        x, delta, w = _k9_inputs(g, dev, dt, lead, d, scale)
        for with_delta in (True, False):
            dd = delta if with_delta else None
            before = LAUNCHES["rms_norm"]
            got = N.add_rms_norm_cuda(x, dd, w, eps)
            torch.cuda.synchronize()
            chk = _k9_compare(got, N.add_rms_norm_reference(x, dd, w, eps),
                              w, eps, dt)
            chk["launches"] = LAUNCHES["rms_norm"] - before
            chk["s_is_x"] = with_delta or got[0] is x
            rec["checks"][f"{tag}_{'add' if with_delta else 'alone'}"] = chk
        if lead[1] == 1 and tag == "embedding":
            want = N.add_rms_norm_reference(x, delta, w, 1e-6)
            rec["fault_dropped_delta"] = _k9_compare(
                N.add_rms_norm_cuda(x, None, w, 1e-6), want, w, 1e-6, dt)
            rec["fault_wrong_eps"] = _k9_compare(
                N.add_rms_norm_cuda(x, delta, w, 1e-5), want, w, 1e-6, dt)
        if tag == "unit":
            item = x.element_size()
            rows = x.numel() // d
            rec["bound_ms"] = 1e3 * (4 * rows + 1) * d * item \
                / H100_BYTES_PER_S
            rec["bound_by"] = "bytes"
            calls = 20 if rows <= 64 else 5
            rec["ms"] = device_ms(
                lambda: N.add_rms_norm_cuda(x, delta, w, eps), calls=calls)
            rec["plain_ms"] = device_ms(
                lambda: N.add_rms_norm_reference(x, delta, w, eps),
                calls=calls)
            rec["library_ms"] = device_ms(
                lambda: torch.nn.functional.rms_norm(x + delta, (d,), w, eps),
                calls=calls)
            rec["roofline"] = rec["bound_ms"] / rec["ms"]
        del x, delta, w
    rec["max_abs_err"] = max(c["h_max_abs_err"]
                             for c in rec["checks"].values())
    ok = all(c["ok"] and c["launches"] == 1 and c["s_is_x"]
             for c in rec["checks"].values())
    if lead[1] == 1:
        ok = ok and not rec["fault_dropped_delta"]["ok"] \
            and not rec["fault_wrong_eps"]["ok"]
    log(f"[phase15] {json.dumps(rec)}")
    if not ok:
        raise AssertionError(f"phase 15: K9 case {name} failed: {rec}")
    _free_cuda()
    return rec


def _k9_rows(dev, dtype, d, g):
    """A row alone, among 8 and among a prefill's 25,600 ([8, 3,200, d]):
    K9's s and h equal bit for bit.  Beside it the plain composition's f32
    row means of the same rows at 1, 8, 40 (a verification window of 8 x
    5) and 25,600 rows: the rows whose mean differs from the 25,600-row
    one (ROADMAP Queue C's row-count suspect)."""
    import torch
    from sdag_tpu_torch.ops import norm as N
    dt = getattr(torch, dtype)
    x, delta, w = _k9_inputs(g, dev, dt, (8, 3200), d, 1.0)
    flat_x, flat_d = x.reshape(-1, d), delta.reshape(-1, d)
    idx = torch.arange(8, device=dev) * 3203 + 17
    big_s, big_h = N.add_rms_norm_cuda(x, delta, w, 1e-5)
    big_s, big_h = big_s.reshape(-1, d)[idx], big_h.reshape(-1, d)[idx]
    s8, h8 = N.add_rms_norm_cuda(flat_x[idx].contiguous(),
                                 flat_d[idx].contiguous(), w, 1e-5)
    alone = [N.add_rms_norm_cuda(flat_x[i:i + 1].contiguous(),
                                 flat_d[i:i + 1].contiguous(), w, 1e-5)
             for i in idx.tolist()]
    s1, h1 = torch.cat([a[0] for a in alone]), torch.cat([a[1] for a in alone])
    rec = {"dtype": dtype, "d": d, "rows": int(x.numel() // d),
           "among_8_equal": torch.equal(s8, big_s) and torch.equal(h8, big_h),
           "alone_equal": torch.equal(s1, big_s) and torch.equal(h1, big_h)}

    def means(t):
        t32 = t.float()
        return (t32 * t32).mean(-1)
    s_all = (flat_x + flat_d)
    m_big = means(s_all)[idx]
    picked = s_all[idx].contiguous()
    window = s_all[torch.cat([idx + j for j in range(5)])].contiguous()
    rec["plain_mean_rows_differing"] = {
        "alone": int(sum(int(means(picked[i:i + 1])[0] != m_big[i])
                         for i in range(8))),
        "among_8": int((means(picked) != m_big).sum()),
        "among_40": int((means(window)[:8] != m_big).sum())}
    log(f"[phase15] rows {json.dumps(rec)}")
    del x, delta, s_all, window
    _free_cuda()
    if not (rec["among_8_equal"] and rec["alone_equal"]):
        raise AssertionError(f"phase 15: K9 rows depend on the row count: "
                             f"{rec}")
    return rec


def _k9_speculation(dev):
    """Phase 13(d)'s count with K9 in place: greedy speculative decode (D
    = 4) against plain greedy decode at the 8B width and depth with int8
    weights, bf16 activations and the native cache, on the main path's
    NO-ISO batch (8 x 32 tokens), with K9 and with the plain composition:
    the tokens that differ (the plain composition's row sums depend on
    the row count, a window's 40 rows against a step's 8; 4 of 256 tokens
    differed with it on the card).  With K9 they must be equal."""
    import torch
    import sdag_tpu_torch.models.llama as L
    from sdag_tpu_torch.models.tokenizer import load_tokenizer
    from sdag_tpu_torch.ops import norm as N
    from sdag_tpu_torch.sdag.generate import Generator
    cfg = L.DecoderConfig.llama3_8b()
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    params = L.quantize_decoder_params_int8(
        L.init_decoder_params(g, cfg, device=dev), consume=True)
    tok = load_tokenizer("")
    rec = {}
    for name, norm in (("k9", N.add_rms_norm),
                       ("plain", N.add_rms_norm_reference)):
        L.add_rms_norm = norm
        try:
            out = {}
            for draft in (0, 4):
                gen = Generator(params, cfg, tok, temperature=0.0,
                                batch_bucket=8, speculative_draft=draft,
                                device=dev)
                out[draft] = gen._generate(*_no_iso_batch(gen, dev), 32,
                                           graphs=True)[0].cpu()
                del gen
                torch.cuda.empty_cache()
        finally:
            L.add_rms_norm = N.add_rms_norm
        rec[name] = {"tokens": int(out[0].numel()),
                     "tokens_differing": int((out[0] != out[4]).sum())}
    log(f"[phase15] speculation bf16 {json.dumps(rec)}")
    del params
    _free_cuda()
    if rec["k9"]["tokens_differing"]:
        raise AssertionError(f"phase 15: greedy speculative tokens differ "
                             f"from plain greedy decode's with K9: {rec}")
    return rec


def phase15(dev):
    """K9 (csrc/rms_norm.cu): (a) its cases against the plain composition,
    planted faults at the decode shapes; (b) row independence at 25,600
    rows, beside the plain composition's row-count count; (c) the top-5
    decode graph with K9 and with the plain composition; (d) phase 13(d)'s
    bf16 speculation count with K9 in place.  Returns the phase's
    record."""
    import torch
    from sdag_tpu_torch.ops import norm as N
    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    rec = {"a": [_k9_case(*case, g, dev) for case in K9_CASES]}
    rec["b"] = [_k9_rows(dev, dt, d, g) for dt, d in (
        ("bfloat16", 4096), ("bfloat16", 2304), ("float32", 4096),
        ("float32", 192))]
    rec["c"] = c = _decode_graphs(
        dev, "k9", "add_rms_norm", N.add_rms_norm, N.add_rms_norm_reference,
        "rms_norm", names={"norm_kernels_per_step": ("rsqrt", "MeanOps"),
                           "k9_kernels_per_step": ("sdag_rms_norm",)})
    # the counter is exact; torch.profiler may drop a few of a long
    # replay's ~4,300 events (36 seen after the earlier phases), so the
    # kernels it names are held to within one a step
    want = 2 * c["n_layers"] + 1
    if c["k9"]["launches_per_step"] != want \
            or not want - 1 <= c["k9"]["k9_kernels_per_step"] <= want \
            or c["k9"]["norm_kernels_per_step"] != 0 \
            or c["plain"]["capture_launches"] != 0:
        raise AssertionError(f"phase 15: K9 launches at capture (want "
                             f"{want} a step) or norm kernels left: {c}")
    if c["kernels_fewer_per_step"] < 16 * c["n_layers"]:
        raise AssertionError(f"phase 15: the K9 step graph is not ~16 "
                             f"kernels a layer smaller: {c}")
    rec["d"] = _k9_speculation(dev)
    rec["phase_s"] = time.perf_counter() - t0
    return rec


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
    # the earlier phases' trees are gone before 32 GB of f32 loads
    _free_cuda()
    details["phase9"] = p9 = phase9(dev)
    _free_cuda()
    details["phase10"] = p10 = phase10(dev)
    _free_cuda()
    details["phase11"] = p11 = phase11(dev)
    _free_cuda()
    details["phase12"] = p12 = phase12(dev)
    _free_cuda()
    details["phase13"] = p13 = phase13(dev)
    _free_cuda()
    details["phase14"] = p14 = phase14(dev)
    _free_cuda()
    details["phase15"] = p15 = phase15(dev)
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
    # K7: timed at the top-5 decode step's shape (phase 13 case a),
    # counted over phase 4's llama3-8b run (its bf16 native cache; a
    # captured graph's launches count at capture)
    p13_top5 = {r["name"]: r for r in p13["a"]}["a_top5_bf16"]
    kernels.append(dict(
        name="decode_attention", route="cuda",
        source="sdag_tpu_torch/csrc/decode_attention.cu",
        replaces="none (XLA in sdag_tpu/ops/attention.py)",
        launches=p4["launches"].get("decode_attention", 0),
        max_abs_err=max(r["max_abs_err"] for r in p13["a"]
                        if r["dtype"] == "bfloat16"),
        **{key: p13_top5[key] for key in keys}))
    # K8: timed at mellum2.poison_top20's decode shape (phase 14 case a),
    # counted over phase 14(c)'s captured decode of the whole model
    p14_a = p14["a"][0]
    kernels.append(dict(
        name="moe_experts", route="cuda",
        source="sdag_tpu_torch/csrc/moe_experts.cu",
        replaces="none (no expert layer in sdag_tpu)",
        launches=p14["c"]["launches"]["moe_experts"],
        max_abs_err=max(r["max_abs_err"] for r in p14["a"]),
        **{key: p14_a[key] for key in keys}))
    # K9: timed at the top-20 prefill's rows (phase 15 case c), counted
    # over phase 4's llama3-8b run
    p15_c = {r["name"]: r for r in p15["a"]}["c_top20_prefill_bf16"]
    kernels.append(dict(
        name="rms_norm", route="cuda",
        source="sdag_tpu_torch/csrc/rms_norm.cu",
        replaces="none (XLA fuses sdag_tpu/models/llama.py rms_norm)",
        launches=p4["launches"].get("rms_norm", 0),
        max_abs_err=max(r["max_abs_err"] for r in p15["a"]),
        **{key: p15_c[key] for key in keys}))
    # each kernel at the shard shapes of phase 11 (timed in one process)
    # and its launches per rank in phase 11(b)
    shard = p11["shard_shapes"]
    shard_of = {"sdag_prefill_bf16": shard["k1"], "bm25_scan_topk":
                shard["k2"], "encoder_attention_bf16": shard["k3"],
                "topk_matmul_bf16": shard["k4_bf16"],
                "topk_matmul_f32": shard["k4_f32"],
                "topk_matmul_int8": shard["k5"],
                "int8_matmul_f32": shard["k6_f32"]}
    for kern in kernels:
        per_rank = [sum(steps[s].get(kern["name"], 0) for s in steps)
                    for steps in (r["launches"] for r in p11["b_ranks"])]
        r = shard_of.get(kern["name"])
        kern["shard_shape"] = dict(
            {key: r[key] for key in keys + ("max_abs_err",)} if r else {},
            case=r.get("name", "window round M20") if r else None,
            launches_per_rank=per_rank)
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
    h8, hr = p9["llama3_8b"], p9["e5_large_v2"]
    log(f"[summary] phase 9 HF Llama-3.1-8B-width checkpoint (f32 tree): "
        f"wrote {h8['checkpoint_gb']:.2f} GB at {h8['write_gb_s']:.2f} GB/s, "
        f"loaded at {h8['load_gb_s']:.2f} GB/s ({h8['load_s']:.1f} s); "
        f"prefill {h8['prefill_tok_s']:.1f} tok/s, decode "
        f"{h8['decode_tok_s']:.1f} tok/s ({h8['decode_ms_per_step']:.2f} ms "
        f"a step), peak {h8['peak_mem_gib']:.2f} GiB; K1-f32 "
        f"{h8['launches'].get('sdag_prefill_f32', 0)}, K2 "
        f"{h8['launches'].get('bm25_scan_topk', 0)} launches; HF ranker: "
        f"K3-f32 {hr['launches'].get('encoder_attention_f32', 0)}, K4-f32 "
        f"{hr['launches'].get('topk_matmul_f32', 0)} launches, encoder "
        f"{hr['encoder']['tokens'] / hr['encoder']['seconds']:.1f} tok/s; "
        f"on {card}")
    h8q = p9["llama3_8b_int8"]
    log(f"[summary] phase 9(d) the HF 8B tree in int8 (f32 activations) + "
        f"speculation: load and quantize {h8q['load_and_quantize_s']:.1f} s,"
        f" prefill {h8q['prefill_tok_s']:.1f} tok/s, decode "
        f"{h8q['decode_tok_s']:.1f} tok/s ({h8q['ms_per_round']:.2f} ms a "
        f"round, {h8q['spec']['accepted_drafts_per_round']} accepted drafts "
        f"a round), peak {h8q['peak_mem_gib']:.2f} GiB; K6-f32 "
        f"{h8q['launches'].get('int8_matmul_f32', 0)} launches; on {card}")
    pa, pb, pc, pd, pe = (p10[k] for k in (
        "a_discern", "b_ragdefender", "c_build_index", "d_attack_builder",
        "e_sdag_effect"))
    log(f"[summary] phase 10 (a) discern at 8B: defense "
        f"{pa['runs']['classify']['defense_s']:.2f} s for "
        f"{pa['labels']} labels ({pa['classifier_prompts_s']:.1f} prompts/s, "
        f"{pa['classifier_prompt_tok_s']:.0f} prompt tok/s, "
        f"{pa['runs']['classify']['graph_captures']} graph captures), "
        f"{pa['runs']['from_labels']['defense_s']:.3f} s from the labels "
        f"file, K1 launches saved {pa['k1_saved']}; (b) ragdefender at "
        f"e5-large-v2: malicious dropped "
        f"{pb['malicious_dropped_share']:.3f}, corpus dropped "
        f"{pb['corpus_dropped_share']:.3f}, encoder "
        f"{pb['encoder_tok_s']:.0f} tok/s, z / pair-similarity moved by "
        f"{pb['z_max_abs_diff']:.4f} / {pb['pair_sim_max_abs_diff']:.5f}, "
        f"{pb['near_threshold_docs']} of {pb['docs']} docs near a threshold, "
        f"{len(pb['near_threshold_exempt_queries'])} queries exempt; "
        f"(c) build_index "
        f"{pc['encode_docs_s']:.0f} docs/s encoded; (d) attack builder "
        f"{pd['runs'][0]['s']:.1f} s, "
        f"{pd['new_tok_s'][0]:.1f} new tok/s, "
        f"{pd['empty_false_answers']} of {pd['rows']} false answers empty; "
        f"(e) sdag effect "
        f"{json.dumps({k: round(v, 1) for k, v in pe['wall_s'].items()})} "
        f"s per n_mal, rows differing from JAX CPU "
        f"{sum(len(d) for d in pe['differ'].values())}; on {card}")
    log(f"[summary] phase 10 in {p10['phase_s']:.1f} s "
        f"{json.dumps({k: round(v, 1) for k, v in p10['step_s'].items()})}")
    tp, chk = p11["b_tp2_8b"], p11["b_checks"]
    log(f"[summary] phase 11 (a) torchrun CLI (NCCL, 1 rank) "
        f"{p11['a_cli_world1']['rows']} rows = phase 3's; 8B (1, 1) NCCL "
        f"mesh tokens = mesh-less, {p11['a_nccl_8b']['graph_captures']} "
        f"graph captures, collectives {json.dumps(p11['a_nccl_8b']['calls'])}"
        f"; (b) two ranks on one card over gloo: TP=2 8B prefill "
        f"{tp['prefill_tok_s']:.1f} tok/s, decode {tp['decode_tok_s']:.1f} "
        f"tok/s ({tp['note']}), logits row-relative "
        f"{chk['tp_logits_row_rel_err']:.4f}, from f32 "
        f"{chk['tp_ratio']:.4f} x one rank's (limit {P11_TP_ERR_RATIO}; "
        f"planted faults {json.dumps(chk['tp_fault_ratio'])}), greedy "
        f"token agreement "
        f"{chk['tp_greedy_token_agreement']:.3f}; DP=2 rows differing "
        f"{chk['ii_dp2_pipeline_rows_differ']} / "
        f"{chk['ii_dp2_pipeline_int8_rows_differ']} (int8); dense s "
        f"{json.dumps(p11['b_dense_s'])}; CP s {json.dumps(p11['b_cp_s'])};"
        f" peak GiB per rank "
        f"{json.dumps([r['peak_gib'] for r in p11['b_ranks']])}; "
        f"collectives per rank "
        f"{json.dumps([r['calls'] for r in p11['b_ranks']])}; steps "
        f"{json.dumps({k: round(v, 1) for k, v in p11['step_s'].items()})};"
        f" phase {p11['phase_s']:.1f} s on {card}")
    pa, pc, pd, pe = (p12[k] for k in "acde")
    log(f"[summary] phase 12 (a) train_qa at the JAX CPU reference's flags:"
        f" losses within {pa['loss_err']:.2e} (gate {P12_LOSS_GATE}), "
        f"update norms within {pa['norm_err']:.2e} (gate {P12_NORM_GATE}); "
        f"planted faults {json.dumps(pa['faults'])}; "
        f"{pa['s_per_step']:.4f} s a step; (b) served: ACC iso "
        f"{p12['b']['acc_iso']:.3f} noiso {p12['b']['acc_noiso']:.3f}, K1-f32 "
        f"{p12['b']['launches'].get('sdag_prefill_f32', 0)}, K2 "
        f"{p12['b']['launches'].get('bm25_scan_topk', 0)} launches; (d) "
        f"resume loss dev {pd['resume_loss_dev']:.3g} (spread "
        f"{pd['spread_loss']:.3g}), param dev {pd['resume_param_dev']:.3g} "
        f"(spread {pd['spread_param']:.3g}); (c) 30M word width: "
        f"{pc['steps_per_s']:.2f} steps/s, {pc['tok_s_valid']:.0f} valid / "
        f"{pc['tok_s_padded']:.0f} padded tok/s, host sampling "
        f"{pc['sample_s']:.2f} s against {pc['step_s']:.2f} s of steps, "
        f"busy {pc['profile']['device_busy_share']}, peak "
        f"{pc['peak_mem_gib']:.2f} GiB, {pc['flops_per_step']:.4g} FLOP a "
        f"step = {pc['f32_peak_share']:.3f} of the f32 peak, loss "
        f"{pc['first_losses'][0]:.3f} -> {pc['last_losses'][-1]:.3f}; (e) "
        f"two ranks {json.dumps(pe['errors'])}; phase "
        f"{p12['phase_s']:.1f} s on {card}")
    p13c = p13["c"]
    log(f"[summary] phase 13 K7: {len(p13['a'])} cases, K/V bit-equal, "
        f"outputs within {max(r['max_abs_err'] for r in p13['a']):.3g} "
        f"(row-relative "
        f"{max(r['max_row_rel_err'] for r in p13['a']):.3g}), a dropped "
        f"chunk flagged; window rows = steps (G = 1, 4); top-5 step graph "
        f"{p13c['k7']['kernels_per_step']:.0f} kernels a step "
        f"(plain block {p13c['plain']['kernels_per_step']:.0f}), "
        f"{p13c['k7']['ms_per_step']:.3f} ms a step (plain "
        f"{p13c['plain']['ms_per_step']:.3f}); greedy speculation = plain "
        f"greedy at 8B (f32 tree); phase {p13['phase_s']:.1f} s on {card}")
    k8, p14c = p14["a"][0], p14["c"]
    few = {r["name"]: r for r in p14["a"]}["g_b8_few_experts"]
    log(f"[summary] phase 14 K8: {len(p14['a'])} cases within "
        f"{max(r['max_row_rel_err'] for r in p14['a']):.3g} of a row's RMS, "
        f"a dropped expert {k8['fault_max_row_rel_err']:.3g}; "
        f"{k8['ms']:.4f} ms a call at the cell's shape, "
        f"{k8['distinct_experts']} experts (bound {k8['bound_ms']:.4f}), "
        f"{few['ms']:.4f} at {few['distinct_experts']} (bound "
        f"{few['bound_ms']:.4f}); rows bit-equal alone and in B 32; "
        f"windowed K1 / K7 within their limits, a "
        f"window one slot off flagged; the whole Mellum2 graph = eager, "
        f"{p14c['graph_ms_a_step']:.2f} ms a step, K8 "
        f"{p14c['launches']['moe_experts']} / K7 "
        f"{p14c['launches']['decode_attention']} launches over "
        f"{p14c['graph_captures']} captures; phase "
        f"{p14['phase_s']:.1f} s on {card}")
    p15c = p15["c"]
    log(f"[summary] phase 15 K9: {len(p15['a'])} shapes, s bit-equal, h "
        f"the gain times a neighbour of the plain cast (bf16) / within "
        f"{K9_F32_TOL} (f32), both planted faults "
        f"flagged; rows = the row alone at 25,600; top-5 step graph "
        f"{p15c['k9']['kernels_per_step']:.0f} kernels a step (plain "
        f"{p15c['plain']['kernels_per_step']:.0f}), "
        f"{p15c['k9']['ms_per_step']:.3f} ms a step (plain "
        f"{p15c['plain']['ms_per_step']:.3f}), "
        f"{p15c['k9']['launches_per_step']:.0f} K9 launches a step; bf16 "
        f"speculation tokens differing {json.dumps(p15['d'])}; phase "
        f"{p15['phase_s']:.1f} s on {card}")
    log(f"[summary] phases 0-15 in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ptxas": ptxas}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
