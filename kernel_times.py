#!/usr/bin/env python3
"""Time the redesigned kernels of ``sdag_tpu_torch`` against an earlier
checkout of the same package, on one GPU, within one run.

    git archive <earlier commit> | tar -x -C <dir>     # the earlier tree
    python3 kernel_times.py --old <dir> [--only k6,decode_int8]

Both trees are timed at the same seeded shapes through the same public
wrappers, in turns (old, new, new, old), each turn in a process of its own
that builds that tree's kernels with nvcc:

* K4 ``fused_topk_matmul`` (bfloat16) and K5 ``fused_topk_matmul_int8``
  (float32 queries in, so the query quantiser is inside the time of both
  versions): N = 1,048,576 rows of D = 1024, Q in (256, 32), k in (10, 64),
  and the ranker path's shape (N = 1024 with 384 valid rows, Q = 24, k = 5);
* K4 ``fused_topk_matmul`` (float32): N = 131,072 rows of D = 1024 at
  Q = 256, k = 10 and Q = 32, k = 64 (valid_n = N - 1000), and the ranker
  path's shape; ``torch.matmul`` + ``torch.topk`` (full float32) at the
  first, as the library yardstick of the same turn;
* K1 ``sdag_prefill_cuda`` in bfloat16: the llama3-8b main path's ISO and
  NO-ISO shapes (B = 8, Hq = 32, Hkv = 8, L = 640, Dh = 128, real prompt
  layouts), L = 4096 with 20 documents and 2-NN windows, the same fully
  causal, and L = 16384 with 31 documents;
* K1 in float32: the qa_ckpt main path's ISO and NO-ISO shapes (B = 8,
  H = Hkv = 6, L = 640, Dh = 32), the ISO shape with the (batch, q-tile)
  pairs handed out in index order instead of heaviest first, and the
  L = 4096 2-NN layout at Hq = 16, Hkv = 8, Dh = 128 (with its bound,
  plain time and F.scaled_dot_product_attention with the dense mask, from
  chip_smoke's K1 case);
* K3 ``encoder_attention_cuda`` in bfloat16 at e5-large-v2's heads (H = 16,
  Dh = 64): (B = 64, L = 256) and (B = 32, L = 512) with ragged valid
  lengths (L, 1, 0 and random), and the ranker path's first encode batch
  (32 passages of the synthetic world, L = 64);
* K3 in float32: the same two e5-large-v2 shapes, the tiny-head case
  (B = 8, L = 64, H = 4, Dh = 32) and Dh = 128 (B = 3, L = 200, H = 2),
  each with its bound, plain time and SDPA time;
* decode at llama3-8b (random bf16 weights): one NO-ISO batch of 8
  main-path prompts, 32 new tokens, greedy: tok/s, ms a step, peak
  memory and the device busy share of a profiled window;
* K2 ``bm25_topk_cuda``: 1,048,576 docs x 64 Zipf term slots with 32
  queries of 16 terms at k = 10 and k = 20, and 32 terms at k = 64; the
  main path's shape (the synthetic world's 384 docs, Lp = 128, 32 queries,
  k = 5);
* K6 ``int8_matmul_cuda`` (bf16 body) at the 8B decode step's weight
  products (wq/wo, wk/wv, gate/up, down, lm_head) at M = 8 and M = 40,
  beside bf16 ``torch.matmul``, device time a call with the weights cold
  (calls cycling through at least 128 MB of weight copies) and warm (one
  weight), and summed over a step (round); device time by kernel of a
  cold round at M = 40 (torch.profiler); the body's ptxas registers and
  spills by row tiles; then K6's f32 body at the 8B and qa_ckpt products,
  M = 8 and 40, cold, beside f32 ``torch.matmul``, and both summed over a
  step (round) (``--only k6`` needs trees with K6);
* decode at llama3-8b of one 8 x 32 batch in the tree's configurations
  (native, int8 weights, + int8 KV cache, + speculation with D = 4;
  native alone in a tree without them);
* K7 ``decode_attention_cuda`` (a decode step's RoPE, K/V write and
  attention) at the poison cells' decode shapes (B = 8, Hq = 32, Hkv = 8,
  Dh = 128, bf16; 928 / 1,056 and 3,104 / 3,232 slots, prompt lengths
  from each cell's range), beside the plain block and SDPA with
  enable_gqa, with its bound over the valid slots' K/V bytes and each
  pass's device time (``--only k7``; a tree without K7 times the plain
  block alone);
* K8 ``moe_experts_cuda`` (a decode step's expert layer) at
  mellum2.poison_top20's decode shape, random rows (~37 experts) and rows
  naming 16-24 experts as the cell's steps do, beside its plain version
  and the library's grouped products, with its bound, each kernel's
  device time, the experts read and the work items a call, and the
  prefill's expert products grouped and per expert (``--only k8``; a tree
  without K8 times nothing);
* K9 ``add_rms_norm_cuda`` (a layer's residual add and the RMSNorm after
  it) at a decode step's rows (8 x 4,096 bf16), the top-20 prefill's
  (25,600 x 4,096), Mellum2's prefill (25,600 x 2,304) and qa_ckpt's in
  f32 (d 192: 8 and 5,120 rows), beside the plain composition, with its
  byte bound (read x, delta and w; write s and h) and launches a call
  (``--only k9``; a tree without K9 times its plain composition alone).

Prints the card (nvidia-smi name and power limit), one JSON line per turn,
and one JSON line ``{"kernel_times": {shape: {"old_ms": [..], "new_ms":
[..]}}}``.  Times are CUDA-event times over a run of launches after a
warm-up.  At the paths' own shapes a call's host time is of the order of
its kernels', so those shapes are also timed as a CUDA graph of 20 calls
replayed (``*_graph``: device time per call, the wrapper's host work
left out).  Without CUDA it exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed after a warm-up."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
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
    return start.elapsed_time(end) / (replays * calls)


def k3_times(c, dev, out):
    """K3's bf16 body at e5-large-v2's heads and the ranker batch."""
    import torch
    from sdag_tpu_torch.ops import encoder_attention as E
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    for B, L in ((64, 256), (32, 512)):
        qkv = torch.randn(B, L, 3 * 1024, generator=g, device=dev).to(
            torch.bfloat16)
        vl = torch.randint(2, L, (B,), generator=g, device=dev,
                           dtype=torch.int32)
        vl[0], vl[1], vl[2] = L, 1, 0
        out[f"K3_bf16_B{B}_L{L}_ragged"] = c.cuda_ms(
            lambda: E.encoder_attention_cuda(qkv, vl, 16), iters=20)
    L, lens = c._ranker_path_passages(32)
    qkv = torch.randn(len(lens), L, 3 * 1024, generator=g, device=dev).to(
        torch.bfloat16)
    vl = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    fn = lambda: E.encoder_attention_cuda(qkv, vl, 16)  # noqa: E731
    name = f"K3_bf16_ranker_B{len(lens)}_L{L}"
    out[name] = c.cuda_ms(fn, iters=20)
    out[name + "_graph"] = graph_ms(fn)


def k3_f32_times(c, dev, out):
    """K3's f32 body at e5-large-v2's heads, the tiny-head case and Dh=128,
    ragged valid lengths (L, 1, 0 and random); the bound, the plain
    version's time and SDPA's from the tree's chip_smoke K3 case."""
    import torch
    from sdag_tpu_torch.ops import encoder_attention as E
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    for name, B, L, H, dh in (("K3_f32_B64_L256_ragged", 64, 256, 16, 64),
                              ("K3_f32_B32_L512_ragged", 32, 512, 16, 64),
                              ("K3_f32_tiny_B8_L64_H4_Dh32", 8, 64, 4, 32),
                              ("K3_f32_Dh128_B3_L200", 3, 200, 2, 128)):
        qkv = torch.randn(B, L, 3 * H * dh, generator=g, device=dev)
        vl = torch.randint(2, L, (B,), generator=g, device=dev,
                           dtype=torch.int32)
        vl[0], vl[1], vl[2] = L, 1, 0
        out[name] = c.cuda_ms(lambda: E.encoder_attention_cuda(qkv, vl, H),
                              iters=20)
        rec = c._k3_case(name, qkv, vl, H, timed=True)
        for key in ("bound_ms", "bound_tf32x3_ms", "plain_ms",
                    "library_ms"):
            if key in rec:
                out[f"{name}_{key}"] = rec[key]


def decode_times(c, dev, out, reps=3, new_tokens=32):
    """Phase 4's decode at llama3-8b width and depth (random bf16 weights
    from a seed): one NO-ISO batch of the 8 main-path prompts, 32 new
    tokens, greedy, through the tree's Generator after a warm-up call;
    decode tok/s and s a step from its own stats, the device busy share
    of the tree's profiled window (prefill + 32 steps), peak memory."""
    import torch
    from sdag_tpu_torch.models.llama import DecoderConfig, init_decoder_params
    from sdag_tpu_torch.models.tokenizer import load_tokenizer
    from sdag_tpu_torch.sdag.generate import Generator
    cfg = DecoderConfig.llama3_8b()
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    params = init_decoder_params(g, cfg, device=dev)
    gen = Generator(params, cfg, load_tokenizer(""), temperature=0.0,
                    batch_bucket=8, device=dev)
    _plans, plain = c._main_path_prompts(8)
    gen.generate_ids(plain, max_new_tokens=new_tokens)       # warm
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    gen.stats.update(decode_tokens=0, decode_s=0.0)
    for _ in range(reps):
        gen.generate_ids(plain, max_new_tokens=new_tokens)
    st = gen.stats
    name = f"decode_8b_B8_new{new_tokens}"
    out[name + "_tok_s"] = st["decode_tokens"] / st["decode_s"]
    # no EOS under random weights: every call runs all its steps
    out[name + "_rows_full"] = st["decode_tokens"] == reps * 8 * new_tokens
    out[name + "_ms_per_step"] = 1e3 * st["decode_s"] / (reps * new_tokens)
    out[name + "_peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / \
        2 ** 30
    prof = c._profile_window(gen, dev, new_tokens=new_tokens)
    out[name + "_device_busy_share"] = prof["device_busy_share"]
    out[name + "_profile_wall_ms"] = prof["wall_ms"]
    del gen, params
    torch.cuda.empty_cache()


def k2_times(c, dev, out):
    """K2 at 1M docs (three instantiations) and the main path's shape."""
    import numpy as np
    import torch
    from sdag_tpu_torch.ops import bm25 as M
    from sdag_tpu_torch.retrieval.sparse import BM25Index
    from sdag_tpu_torch.pipeline.resources import load_corpus_jsonl
    from sdag_tpu_torch.utils.synth_qa import (fact_query, load_world,
                                               write_corpus_jsonl)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    N, Lp, V = 1 << 20, 64, 1 << 18
    term_ids = c._dedup_rows(c._zipf_ids(g, (N, Lp), V, 1.07, dev))
    impacts = (0.1 + 2.9 * torch.rand((N, Lp), generator=g, device=dev))
    impacts = torch.where(term_ids >= 0, impacts, 0.0).contiguous()
    for t, k in ((16, 10), (16, 20), (32, 64)):
        qt = c._dedup_rows(c._zipf_ids(g, (32, t), V, 1.07, dev)).contiguous()
        qw = torch.where(qt >= 0, 1.0, 0.0).contiguous()
        out[f"K2_N1M_Lp64_T{t}_k{k}"] = c.cuda_ms(
            lambda: M.bm25_topk_cuda(term_ids, impacts, qt, qw, k), iters=10)
    del term_ids, impacts
    world = load_world(os.path.join(HERE, "experiments", "data", "qa_ckpt",
                                    "world.json"))
    corpus = os.path.join(c.OUT_DIR, "kernel_times_corpus.jsonl")
    os.makedirs(c.OUT_DIR, exist_ok=True)
    write_corpus_jsonl(world, corpus)
    texts, ids = load_corpus_jsonl(corpus)
    index = BM25Index.from_texts(texts, ids, engine="scan", device=dev)
    qt, qw = index.encode_queries([fact_query(f) for f in world.facts[:32]])
    qt = torch.from_numpy(np.ascontiguousarray(qt)).to(dev)
    qw = torch.from_numpy(np.ascontiguousarray(qw)).to(dev)

    def fn():
        return M.bm25_topk_cuda(index.term_ids, index.impacts, qt, qw, 5,
                                valid_n=index.valid_n)
    out["K2_path_384docs_Lp128_k5"] = c.cuda_ms(fn, iters=20)
    out["K2_path_384docs_Lp128_k5_graph"] = graph_ms(fn)


# a cold timing cycles through copies of the weight, at least this many
# bytes of them (the L2 holds 50 MB), as a decode step streams its weights
WEIGHT_CYCLE_BYTES = 128 << 20


def _copies(nbytes: int) -> int:
    return min(32, -(-WEIGHT_CYCLE_BYTES // nbytes))


def _cycling(fn, copies):
    """A call that runs ``fn`` on the next of ``copies`` each time."""
    turn = [0]

    def call():
        fn(copies[turn[0] % len(copies)])
        turn[0] += 1
    return call


def _cold_ms(fn, copies) -> float:
    """Device time a call of ``fn`` over ``copies`` in turn, every copy
    captured at least once."""
    return graph_ms(_cycling(fn, copies), calls=max(20, len(copies)))


def _kernel_ms(fn, calls: int) -> dict:
    """Device ms by kernel name of ``calls`` calls of ``fn`` under
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        key = e.key.replace("(anonymous namespace)::", "")
        name = key.replace("void ", "").split("(")[0].split("::")[-1]
        if us > 0:
            ms[name] = ms.get(name, 0.0) + us / 1e3
    return ms


def k6_times(c, dev, out):
    """K6's bf16 body at the 8B decode step's products (c.k6_products),
    M = 8 (a step's batch) and M = 40 (a window of 8 x 5), beside bf16
    ``torch.matmul`` (``x @ w.T`` over a bf16 copy of the weight, the
    library call K6 replaces): device time a call from a replayed graph,
    cold (``*_graph``: the calls cycle through copies of the weight, at
    least 128 MB of them, so each reads its weight from device memory, as
    a decode step does) and warm (``*_warm``: one weight, L2-resident
    below 50 MB), each also summed over a step (round) with the products'
    counts (225 products at 8B); device ms by kernel of one cold round at
    M = 40 under torch.profiler (``K6_8b_round_M40_kernels``); ptxas'
    registers and spills of the bf16 body by row tiles (``K6_bf16_ptxas``,
    where the tree's chip_smoke reads them).  Then the f32 body
    (``k6_f32_times``)."""
    import torch
    from sdag_tpu_torch import _build
    from sdag_tpu_torch.models.llama import DecoderConfig
    from sdag_tpu_torch.ops import int8_matmul as Q
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    for M in (8, 40):
        step = {}
        kernels = {}
        for name, n, k, count in c.k6_products(DecoderConfig.llama3_8b()):
            x = torch.randn(M, k, generator=g, device=dev).to(torch.bfloat16)
            s = torch.rand(n, generator=g, device=dev) * 2e-3 + 1e-4
            w = [torch.randint(-127, 128, (n, k), generator=g, device=dev,
                               dtype=torch.int8)
                 for _ in range(_copies(n * k))]
            wl = [wi.to(torch.bfloat16) for wi in w[:_copies(2 * n * k)]]
            k6 = lambda wi: Q.int8_matmul_cuda(x, wi, s)  # noqa: E731
            lib = lambda wi: x @ wi.T  # noqa: E731
            times = {
                f"K6_8b_{name}_M{M}_graph": _cold_ms(k6, w),
                f"lib_bf16_matmul_8b_{name}_M{M}_graph": _cold_ms(lib, wl),
                f"K6_8b_{name}_M{M}_warm": graph_ms(lambda: k6(w[0])),
                f"lib_bf16_matmul_8b_{name}_M{M}_warm":
                    graph_ms(lambda: lib(wl[0]))}
            out.update(times)
            for key, ms in times.items():
                key = key.replace(f"_{name}_", "_step_")
                step[key] = step.get(key, 0.0) + count * ms
            if M == 40:
                for kname, ms in _kernel_ms(_cycling(k6, w), count).items():
                    kernels[kname] = kernels.get(kname, 0.0) + ms
            del w, wl
            torch.cuda.empty_cache()
        out.update(step)
        if kernels:
            out["K6_8b_round_M40_kernels"] = kernels
    if hasattr(c, "k6_bf16_ptxas"):
        out["K6_bf16_ptxas"] = c.k6_bf16_ptxas(_build)
    k6_f32_times(c, dev, out, Q)


def k6_f32_times(c, dev, out, Q):
    """K6's f32 body at the 8B decode step's products and at qa_ckpt's,
    M = 8 and M = 40, and f32 ``torch.matmul`` (the library call it
    replaces) at the same shapes: device time a call from a replayed
    graph whose calls cycle through copies of the weight (at least 128 MB
    of them), so each call reads its weight from device memory, not L2,
    as a decode step does; and each summed over a step (round) with the
    products' counts (225 products at 8B)."""
    import torch
    from sdag_tpu_torch.models.llama import DecoderConfig
    from sdag_tpu_torch.models.native_ckpt import load_config
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    for tag, cfg in (("8b", DecoderConfig.llama3_8b()),
                     ("qa_ckpt", load_config(os.path.join(
                         HERE, "experiments", "data", "qa_ckpt")))):
        for M in (8, 40):
            step = {"K6": 0.0, "lib": 0.0}
            for name, n, k, count in c.k6_products(cfg):
                x = torch.randn(M, k, generator=g, device=dev)
                s = torch.rand(n, generator=g, device=dev) * 2e-3 + 1e-4
                w = [torch.randint(-127, 128, (n, k), generator=g,
                                   device=dev, dtype=torch.int8)
                     for _ in range(_copies(n * k))]
                ms = graph_ms(_cycling(
                    lambda wi: Q.int8_matmul_cuda(x, wi, s), w))
                wf = [wi.float() for wi in w[:max(1, len(w) // 4)]]
                lib = graph_ms(_cycling(lambda wi: x @ wi.T, wf))
                del w, wf
                out[f"K6_f32_{tag}_{name}_M{M}_graph"] = ms
                out[f"lib_f32_matmul_{tag}_{name}_M{M}_graph"] = lib
                step["K6"] += count * ms
                step["lib"] += count * lib
            out[f"K6_f32_{tag}_step_M{M}_graph"] = step["K6"]
            out[f"lib_f32_matmul_{tag}_step_M{M}_graph"] = step["lib"]
            torch.cuda.empty_cache()


def decode_int8_times(c, dev, out):
    """Decode of one 8 x 32 batch at 8B in the tree's configurations
    (chip_smoke ``decode_configs``: native, int8 weights, + int8 cache, +
    speculation); a tree without them times native decode alone."""
    import torch
    if hasattr(c, "decode_configs"):
        recs = c.decode_configs(dev)
    else:
        from sdag_tpu_torch.models.llama import (DecoderConfig,
                                                 init_decoder_params)
        from sdag_tpu_torch.models.tokenizer import load_tokenizer
        from sdag_tpu_torch.sdag.generate import Generator
        cfg = DecoderConfig.llama3_8b()
        g = torch.Generator(device=dev)
        g.manual_seed(3)
        gen = Generator(init_decoder_params(g, cfg, device=dev), cfg,
                        load_tokenizer(""), temperature=0.0, batch_bucket=8,
                        device=dev)
        _plans, plain = c._main_path_prompts(8)
        gen.generate_ids(plain, max_new_tokens=32)
        torch.cuda.synchronize(dev)
        gen.stats.update(decode_tokens=0, decode_s=0.0, decode_steps=0)
        for _ in range(2):
            gen.generate_ids(plain, max_new_tokens=32)
        st = gen.stats
        recs = {"native": {"tok_s": st["decode_tokens"] / st["decode_s"],
                           "ms_per_step": 1e3 * st["decode_s"]
                           / st["decode_steps"]}}
        del gen
        torch.cuda.empty_cache()
    for name, rec in recs.items():
        out[f"decode_8b_B8_new32_{name}_tok_s"] = rec["tok_s"]
        out[f"decode_8b_B8_new32_{name}_ms_per_step"] = rec["ms_per_step"]


# (cell, prompt slots, prompt lengths drawn from) of the poison cells
K7_SHAPES = (("top5", 896, (656, 882)), ("top5", 1024, (656, 882)),
             ("top20", 3072, (2535, 3072)), ("top20", 3200, (2535, 3161)))


def k7_times(c, dev, out, new_tokens=32, generated=16, calls=20):
    """K7, a decode step's attention block, at the poison cells' decode
    shapes (bf16, B = 8, Hq = 32, Hkv = 8, Dh = 128, prompt slots + 32):
    each row's prompt length drawn from its cell's range, 16 tokens
    generated.  Device time a call of a replayed graph of ``calls``
    calls, launches a call, the bound over the valid slots' K/V bytes
    (and over every slot's), each pass's device time (torch.profiler),
    the plain block and SDPA (enable_gqa, rotated q, the yardstick).  A
    tree without K7 times its decode step's plain block alone."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sdag_tpu_torch import _build
    from sdag_tpu_torch.models import llama as L
    from sdag_tpu_torch.ops import attention as A
    B, Hq, Hkv, Dh, theta = 8, 32, 8, 128, 1e6
    g = torch.Generator(device=dev)
    g.manual_seed(18)
    freqs = L.rope_freqs(Dh // 2, theta, None, dev)
    has_k7 = hasattr(A, "decode_attention_cuda")
    for cell, lp, (lo, hi) in K7_SHAPES:
        S = lp + new_tokens
        name = f"K7_{cell}_S{S}"

        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(
                torch.bfloat16)
        q, k, v = rnd(B, Hq, Dh), rnd(B, Hkv, Dh), rnd(B, Hkv, Dh)
        kc, vc = rnd(B, Hkv, S, Dh), rnd(B, Hkv, S, Dh)
        vl = torch.randint(lo, min(hi, lp) + 1, (B,), generator=g, device=dev)
        j = torch.arange(S, device=dev)[None, :]
        mask = (j < vl[:, None]) | ((j >= lp) & (j <= lp + generated))
        wi = torch.tensor([lp + generated], device=dev)
        pos = vl + generated

        def plain():
            if has_k7:
                return A.decode_attention_reference(q, k, v, kc, vc, mask, wi,
                                                    pos, freqs)
            qr = L.rope(q[:, :, None], pos[:, None], theta)
            kc.index_copy_(2, wi, L.rope(k[:, :, None], pos[:, None], theta))
            vc.index_copy_(2, wi, v[:, :, None])
            return A.masked_decode_attention(qr[:, :, 0], kc, vc, mask)
        valid = int(mask.sum())
        out[name + "_bound_ms"] = 1e3 * 2 * valid * Hkv * Dh * 2 / \
            c.H100_BYTES_PER_S
        out[name + "_bound_all_slots_ms"] = 1e3 * 2 * B * Hkv * S * Dh * 2 / \
            c.H100_BYTES_PER_S
        out[name + "_plain_ms"] = graph_ms(plain, calls=calls)
        qr = L.rope(q[:, :, None], pos[:, None], theta)
        out[name + "_sdpa_ms"] = graph_ms(
            lambda: F.scaled_dot_product_attention(
                qr, kc, vc, attn_mask=mask[:, None, None, :],
                enable_gqa=True), calls=calls)
        if not has_k7:
            continue

        def k7():
            return A.decode_attention_cuda(q, kc, vc, mask,
                                           new_kv=(k, v, wi, pos, freqs))
        before = _build.LAUNCHES["decode_attention"]
        k7()
        out[name + "_launches"] = _build.LAUNCHES["decode_attention"] - before
        out[name + "_ms"] = graph_ms(k7, calls=calls)
        out[name + "_roofline"] = out[name + "_bound_ms"] / out[name + "_ms"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                k7()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            for pas in ("scores", "pv"):
                if f"sdag_decode_attn_{pas}" in e.key:
                    dev_us = getattr(e, "self_device_time_total", None)
                    if dev_us is None:
                        dev_us = e.self_cuda_time_total
                    out[f"{name}_{pas}_ms"] = dev_us / 1e3 / e.count


def k8_few_expert_rows(g, router, k, B=8, want=(16, 24)):
    """B bf16 rows around two base rows (row b near base b % 2, noise of
    0.05-0.2 of a base's scale: the first scale whose rows' picks name
    ``want`` distinct experts by the plain router), drawn from the CUDA
    generator ``g``: as few experts as mellum2.poison_top20's decode steps
    name (~18 a layer), where random rows name ~37."""
    import torch
    from sdag_tpu_torch.ops import moe as M
    d = router.shape[0]
    base = torch.randn(2, d, generator=g, device=router.device)
    noise = torch.randn(B, d, generator=g, device=router.device)
    for eps in (0.1, 0.15, 0.2, 0.05):
        x = (base[torch.arange(B) % 2] + eps * noise).to(torch.bfloat16)
        if want[0] <= M.route(x, router, k)[1].unique().numel() <= want[1]:
            return x
    raise AssertionError(f"K8: no noise scale gives {want} experts")


def k8_times(c, dev, out, calls=10):
    """K8, a decode step's expert layer, at mellum2.poison_top20's decode
    shape (B = 8, 64 experts, top 8, d = 2,304, F = 896, bf16; one layer's
    experts, 792 MB, so every call reads its weights from device memory),
    for random rows (~37 experts) and for rows that name 16-24
    (``k8_few_expert_rows``, as the cell's steps do): device time a call of
    a replayed graph, launches, the experts the counter reads, the work
    items a call (``k8_plan``'s items over those experts; a tree without
    it reports none), the bound (the distinct experts' bytes and the rows
    in and out, or the routed rows' operations at 989 TFLOP/s), each
    kernel's device time (torch.profiler), a digest of the output's bits
    (sum of its int16 view, weighted by position), and at random rows the
    plain version's and the library's (route + ``torch._grouped_mm`` over
    the picks sorted by expert).  Then the prefill's expert products at a
    top-20 LLM batch's routed rows (23,200 tokens x 8) both ways
    (``ops/moe.py`` ``_expert_products``).  A tree without K8 times
    nothing."""
    import importlib.util
    if importlib.util.find_spec("sdag_tpu_torch.ops.moe") is None:
        return
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sdag_tpu_torch import _build
    from sdag_tpu_torch.ops import moe as M
    E, k, d, f = c.K8_DIMS
    g = torch.Generator(device=dev)
    g.manual_seed(19)
    moe = c._k8_weights(g, dev, E, d, f)
    w3 = (moe["router"], moe["gate_up"], moe["down"], k)
    x = torch.randn(8, d, generator=g, device=dev).to(torch.bfloat16)
    cases = (("b8", x), ("b8_few", k8_few_expert_rows(g, moe["router"], k)))
    for case, rows in cases:
        key = f"K8_{case}"
        reads = torch.zeros(1, dtype=torch.int64, device=dev)
        before = _build.LAUNCHES["moe_experts"]
        res = M.moe_experts_cuda(rows, *w3, reads=reads)
        out[key + "_launches"] = _build.LAUNCHES["moe_experts"] - before
        out[key + "_expert_reads"] = int(reads)
        if hasattr(M, "k8_items"):
            out[key + "_items"] = M.k8_items(d, f, int(reads))
        pos = torch.arange(1, res.numel() + 1, device=dev)
        out[key + "_digest"] = int((res.view(torch.int16).reshape(-1).long()
                                    * pos).sum())
        nbytes = int(reads) * 3 * d * f * 2 + 2 * 8 * d * 2
        flops = 2.0 * 3 * d * f * k * 8
        out[key + "_bound_ms"] = 1e3 * max(nbytes / c.H100_BYTES_PER_S,
                                           flops / c.PEAK_FLOPS["bfloat16"])
        out[key + "_ms"] = graph_ms(lambda: M.moe_experts_cuda(rows, *w3),
                                    calls=calls)
        out[key + "_roofline"] = out[key + "_bound_ms"] / out[key + "_ms"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                M.moe_experts_cuda(rows, *w3)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and "sdag_moe" in e.key:
                dev_us = getattr(e, "self_device_time_total", None)
                if dev_us is None:
                    dev_us = e.self_cuda_time_total
                name = e.key.split("sdag_moe_")[1].split("<")[0].split("(")[0]
                out[f"{key}_{name}_ms"] = dev_us / 1e3 / e.count
    out["K8_b8_plain_ms"] = graph_ms(
        lambda: M.moe_experts_reference(x, *w3), calls=3)

    def library():
        w, i = M.route(x, moe["router"], k)
        return M.expert_products(x, w, i, moe["gate_up"], moe["down"])
    out["K8_b8_library_ms"] = c.cuda_ms(library, iters=5, warmup=2)
    T = 23200
    u = torch.randn(T, d, generator=g, device=dev).to(torch.bfloat16)
    w, i = M.route(u, moe["router"], k)
    out["K8_prefill_bound_ms"] = 1e3 * 2.0 * 3 * d * f * k * T / \
        c.PEAK_FLOPS["bfloat16"]
    for way in ("grouped", "per_expert"):
        out[f"K8_prefill_{way}_ms"] = c.cuda_ms(
            lambda: M._expert_products(u, w, i, moe["gate_up"], moe["down"],
                                       way == "grouped"), iters=5, warmup=2)


# K9's shapes: (name, rows, d, dtype)
K9_SHAPES = (("decode", 8, 4096, "bfloat16"),
             ("top20_prefill", 25600, 4096, "bfloat16"),
             ("mellum2_prefill", 25600, 2304, "bfloat16"),
             ("qa_ckpt_decode", 8, 192, "float32"),
             ("qa_ckpt_prefill", 5120, 192, "float32"))


def k9_times(c, dev, out, calls=20):
    """K9, a layer's residual add and RMSNorm, at ``K9_SHAPES``: device
    time a call of a replayed graph (``calls`` calls a graph at a decode
    step's rows, 5 at a prefill's), the plain composition's, launches a
    call, and the bound over the bytes read and written once (x, delta, w
    in; s, h out).  A tree without K9 times ``x + delta`` then its
    ``rms_norm`` alone."""
    import importlib.util
    import torch
    from sdag_tpu_torch import _build
    from sdag_tpu_torch.models import llama as L
    has_k9 = importlib.util.find_spec("sdag_tpu_torch.ops.norm") is not None
    if has_k9:
        from sdag_tpu_torch.ops import norm as N
    g = torch.Generator(device=dev)
    g.manual_seed(20)
    for cell, rows, d, dtype in K9_SHAPES:
        dt = getattr(torch, dtype)
        x = torch.randn(rows, d, generator=g, device=dev).to(dt)
        delta = (0.3 * torch.randn(rows, d, generator=g, device=dev)).to(dt)
        w = (1 + 0.1 * torch.randn(d, generator=g, device=dev)).to(dt)
        name = f"K9_{cell}_{rows}x{d}"
        n = calls if rows <= 64 else 5
        out[name + "_bound_ms"] = 1e3 * (4 * rows + 1) * d * \
            x.element_size() / c.H100_BYTES_PER_S
        if has_k9:
            out[name + "_plain_ms"] = graph_ms(
                lambda: N.add_rms_norm_reference(x, delta, w, 1e-5), calls=n)
        else:
            out[name + "_plain_ms"] = graph_ms(
                lambda: L.rms_norm(x + delta, w, 1e-5), calls=n)
            continue
        before = _build.LAUNCHES["rms_norm"]
        N.add_rms_norm_cuda(x, delta, w, 1e-5)
        out[name + "_launches"] = _build.LAUNCHES["rms_norm"] - before
        out[name + "_ms"] = graph_ms(
            lambda: N.add_rms_norm_cuda(x, delta, w, 1e-5), calls=n)
        out[name + "_roofline"] = out[name + "_bound_ms"] / out[name + "_ms"]
        del x, delta
        torch.cuda.empty_cache()


FAMILIES = ("k3", "k3_f32", "decode", "k2", "k4", "k1", "k6", "decode_int8",
            "k7", "k8", "k9")


def worker(tree: str, families) -> int:
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as c                      # the tree's own helpers
    from sdag_tpu_torch import _build

    _build.build_all()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for fam in families:
        globals()[f"{fam}_times"](c, dev, out)
    print(json.dumps({"tree": tree, "ms": out}), flush=True)
    return 0


def k4_times(c, dev, out):
    """K4 (bf16, f32) and K5 at 1M / 128K rows and the ranker path."""
    import torch
    from sdag_tpu_torch.ops import topk as T
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    n, d = 1 << 20, 1024
    c32 = c._normalised_rows(g, n, d, dev)
    q256 = c._normalised_rows(g, 256, d, dev)
    cb = c32.to(torch.bfloat16)
    ci, cs = T.quantize_last_axis_int8(c32)
    del c32
    torch.cuda.empty_cache()
    for qn in (256, 32):
        q = q256[:qn].contiguous()
        for k in (10, 64):
            out[f"K4_bf16_N1M_Q{qn}_k{k}"] = c.cuda_ms(
                lambda: T.fused_topk_matmul(q, cb, k), iters=5, warmup=1)
            out[f"K5_int8_N1M_Q{qn}_k{k}"] = c.cuda_ms(
                lambda: T.fused_topk_matmul_int8(q, ci, cs, k), iters=5,
                warmup=1)
    qm = q256[:24].contiguous()
    cbp, cip, csp = (t[:1024].contiguous() for t in (cb, ci, cs))
    for name, fn in (
            ("K4_bf16_path_N1024_Q24_k5",
             lambda: T.fused_topk_matmul(qm, cbp, 5, valid_n=384)),
            ("K5_int8_path_N1024_Q24_k5",
             lambda: T.fused_topk_matmul_int8(qm, cip, csp, 5, valid_n=384))):
        out[name] = c.cuda_ms(fn, iters=20)
        out[name + "_graph"] = graph_ms(fn)
    nf = 1 << 17
    cf = cb[:nf].float().contiguous()
    out["K4_f32_N128K_Q256_k10"] = c.cuda_ms(
        lambda: T.fused_topk_matmul(q256, cf, 10), iters=5, warmup=1)
    out["lib_f32_matmul_topk_N128K_Q256_k10"] = c.cuda_ms(
        lambda: torch.topk(torch.matmul(q256, cf.t()), 10, dim=1), iters=5,
        warmup=1)
    q32 = q256[:32].contiguous()
    out["K4_f32_N128K_Q32_k64_ragged"] = c.cuda_ms(
        lambda: T.fused_topk_matmul(q32, cf, 64, valid_n=nf - 1000), iters=5,
        warmup=1)
    cfp = cbp.float()
    path_f32 = lambda: T.fused_topk_matmul(qm, cfp, 5, valid_n=384)  # noqa
    out["K4_f32_path_N1024_Q24_k5"] = c.cuda_ms(path_f32, iters=20)
    out["K4_f32_path_N1024_Q24_k5_graph"] = graph_ms(path_f32)
    del cb, ci, cs, cf
    torch.cuda.empty_cache()


def k1_times(c, dev, out):
    """K1's bf16 and f32 bodies at the main paths' and long shapes."""
    import numpy as np
    import torch
    from sdag_tpu_torch.ops import attention as A
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    t32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)  # noqa

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev,
                           dtype=torch.float32).to(dtype)

    def k1(name, q, k, v, doc_id, nbr, sul, vl, natural_order=False,
           graph=False):
        plan = A.prefill_mask_plan(doc_id, nbr, sul, vl)
        out[name] = c.cuda_ms(lambda: A.sdag_prefill_cuda(q, k, v, plan),
                              iters=20)
        if graph:
            out[name + "_graph"] = graph_ms(
                lambda: A.sdag_prefill_cuda(q, k, v, plan))
        if natural_order:
            n = plan["order"].numel()
            nat = dict(plan, order=torch.arange(n, dtype=torch.int32,
                                                device=dev))
            out[name + "_index_order"] = c.cuda_ms(
                lambda: A.sdag_prefill_cuda(q, k, v, nat), iters=20)

    plans, plain = c._main_path_prompts(8)
    lp = -(-max(len(p.input_ids) for p in plans) // 128) * 128
    metas = [p.metadata(pad_to=lp) for p in plans]
    lpn = -(-max(len(x) for x in plain) // 128) * 128
    iso = (t32(np.stack([m[0] for m in metas])),
           t32(np.stack([m[1] for m in metas])), t32([m[2] for m in metas]),
           t32([len(p.input_ids) for p in plans]))
    noiso = (t32(np.full((8, lpn), -1)), t32(np.zeros((8, lpn))),
             t32([0] * 8), t32([len(x) for x in plain]))
    q, k, v = (rnd(8, h, lp, 32, dtype=torch.float32) for h in (6, 6, 6))
    k1("K1_f32_path_iso", q, k, v, *iso, natural_order=True, graph=True)
    q, k, v = (rnd(8, h, lpn, 32, dtype=torch.float32) for h in (6, 6, 6))
    k1("K1_f32_path_noiso", q, k, v, *noiso, graph=True)
    q, k, v = (rnd(1, h, 4096, 128, dtype=torch.float32)
               for h in (16, 8, 8))
    did, nb = c._layout_docs(4096, 256, 20, 176, True)
    k1("K1_f32_L4096_20docs_2nn_Dh128", q, k, v, t32(did[None]),
       t32(nb[None]), t32([256]), t32([4096]))
    rec = c._k1_case("K1_f32_L4096_20docs_2nn_Dh128", q, k, v,
                     t32(did[None]), t32(nb[None]), t32([256]), t32([4096]),
                     timed=True)
    for key in ("plain_ms", "library_ms", "bound_ms"):
        out[f"K1_f32_L4096_20docs_2nn_Dh128_{key}"] = rec[key]
    q, k, v = (rnd(8, h, lp, 128) for h in (32, 8, 8))
    k1("K1_bf16_path_iso", q, k, v, *iso, graph=True)
    q, k, v = (rnd(8, h, lpn, 128) for h in (32, 8, 8))
    k1("K1_bf16_path_noiso", q, k, v, *noiso, graph=True)
    for name, L, docs, doc_len, nn in (("K1_bf16_L4096_20docs_2nn", 4096, 20,
                                        176, True),
                                       ("K1_bf16_L4096_causal", 4096, 0, 0,
                                        False),
                                       ("K1_bf16_L16384_31docs", 16384, 31,
                                        512, False)):
        q, k, v = (rnd(1, h, L, 128) for h in (16, 8, 8))
        did, nb = c._layout_docs(L, 256 if docs else 0, docs, doc_len, nn)
        k1(name, q, k, v, t32(did[None]), t32(nb[None]),
           t32([256 if docs else 0]), t32([L]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="checkout of the earlier commit")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--only", default=",".join(FAMILIES),
                    help="comma-separated families to time, of "
                    + ", ".join(FAMILIES))
    args = ap.parse_args()
    families = args.only.split(",")
    if not set(families) <= set(FAMILIES):
        ap.error(f"--only takes {', '.join(FAMILIES)}")
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if args.worker:
        return worker(os.path.abspath(args.tree), families)
    if not args.old:
        ap.error("--old is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    times = {}
    for which, tree in (("old", args.old), ("new", HERE), ("new", HERE),
                        ("old", args.old)):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", "--tree",
             os.path.abspath(tree), "--only", args.only],
            capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
            return 1
        line = [x for x in res.stdout.splitlines()
                if x.startswith('{"tree"')][-1]
        print(f"{which}: {line}", flush=True)
        for name, ms in json.loads(line)["ms"].items():
            times.setdefault(name, {"old_ms": [], "new_ms": []})[
                f"{which}_ms"].append(ms)
    print(json.dumps({"kernel_times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
