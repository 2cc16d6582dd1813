"""Driver of the poisoning cell on a sparse-expert decoder with windowed
and full layers (``mellum2-12b-a2.5b``): the traffic, batches, window and
traced segment of ``poison.py`` (BM25 retrieval, PoisonedRAG injection,
ISO and NO-ISO generation through the orchestrator's functions), with its
own weights, ``DecoderConfig`` and check.

``correct`` judges what ``poison.py`` judges: the BM25 top-k of a sample
of queries against float64 BM25, every answer run to its budget or EOS,
and the served tokens of a sample of requests (the longest prompt among
them) against ``portbench/reference/moe_decoder.py``'s float32 forward
over prompt + served tokens (the mean gap of a served token's logit below
the reference's best).  With random weights many routes tie within bf16
rounding, and a flipped route moves every later layer by more than
rounding does; so the forward takes the experts the program routed each
position to, read from the Generator's route log over the timed calls
(the prompt's from prefill, a served token's from the decode step it was
fed to), and the gap reads rounding alone.  ``route_gap_mean`` then holds
the routes themselves to the reference's router: the mean of its k-th
largest logit less the smallest logit among the program's picks, over
the (layer, position) pairs prefill routed and over those decode routed,
whichever is larger.

The traced segment also keeps ``Generator.stats``' expert counters over
the segment (``segment_moe``) for ``moe_expert_roofline.poison``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from portbench.common import bounds, moe_bounds
from portbench.drivers import poison
from portbench.reference import bm25 as ref_bm25
from portbench.reference import llama_decoder as ref_dec
from portbench.reference import moe_decoder as ref_moe
from portbench.reference import prompts as ref_prompts

window, run_batch, prompt_rows, release = (poison.window, poison.run_batch,
                                           poison.prompt_rows, poison.release)
COUNTERS = ("moe_prefill_rows", "moe_decode_expert_reads", "decode_tokens")


def decoder_config(cfg: Dict[str, Any]):
    from sdag_tpu_torch.models.llama import DecoderConfig
    rope = cfg["rope_parameters"]
    full, win = rope["full_attention"], rope["sliding_attention"]
    if full["rope_type"] != "yarn" or win["rope_type"] != "default" \
            or float(win["rope_theta"]) != float(full["rope_theta"]):
        raise ValueError("the port serves YaRN on the full layers and plain "
                         "RoPE at the same theta on the windowed ones")
    if not all(t == "sparse" for t in cfg["mlp_layer_types"]):
        raise ValueError("every MLP must be sparse")
    return DecoderConfig(
        vocab_size=int(cfg["vocab_size"]), d_model=int(cfg["hidden_size"]),
        n_layers=int(cfg["num_hidden_layers"]),
        n_heads=int(cfg["num_attention_heads"]),
        n_kv_heads=int(cfg["num_key_value_heads"]),
        d_ff=int(cfg["intermediate_size"]),
        rope_theta=float(full["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]),
        dtype=getattr(torch, cfg["torch_dtype"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        head_dim=int(cfg["head_dim"]),
        layer_types=tuple(cfg["layer_types"]),
        sliding_window=int(cfg["sliding_window"]),
        rope_yarn=(float(full["factor"]),
                   int(full["original_max_position_embeddings"]),
                   float(full["beta_fast"]), float(full["beta_slow"]),
                   float(full["attention_factor"])),
        n_experts=int(cfg["num_experts"]),
        experts_per_token=int(cfg["num_experts_per_tok"]),
        expert_ff=int(cfg["moe_intermediate_size"]),
        norm_topk_prob=bool(cfg["norm_topk_prob"]))


def make_weights(cfg: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The decoder's weights (the port's tree: [in, out] attention and
    router matrices, experts [E, out, in]) as views of four buffers, each
    filled by one normal_ call on the device: N(0, 1/fan_in), fan_in each
    matrix's input width (the embedding: its rows, as ``poison.py``)."""
    dt = getattr(torch, cfg["torch_dtype"])
    d, v = int(cfg["hidden_size"]), int(cfg["vocab_size"])
    hd = int(cfg["head_dim"])
    q, kv = int(cfg["num_attention_heads"]) * hd, \
        int(cfg["num_key_value_heads"]) * hd
    n_e, f = int(cfg["num_experts"]), int(cfg["moe_intermediate_size"])
    n_l = int(cfg["num_hidden_layers"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def buffer(n, std):
        t = torch.empty(n, dtype=dt, device=device)
        return t.normal_(0.0, std, generator=gen)

    # fan_in d: each layer's wq, wk, wv, router, gate_up, then the head
    per_layer = [("attn", "wq", (d, q)), ("attn", "wk", (d, kv)),
                 ("attn", "wv", (d, kv)), ("moe", "router", (d, n_e)),
                 ("moe", "gate_up", (n_e, 2 * f, d))]
    sizes = [int(np.prod(s)) for *_, s in per_layer]
    a = buffer(n_l * sum(sizes) + d * v, d ** -0.5)
    wo = buffer(n_l * q * d, q ** -0.5)
    down = buffer(n_l * n_e * d * f, f ** -0.5)
    embed = buffer(v * d, v ** -0.5)
    gains = buffer((2 * n_l + 1) * d, 0.1).add_(1.0)
    off, layers = 0, []
    for li in range(n_l):
        layer = {"attn": {}, "moe": {}}
        for (grp, name, shape), n in zip(per_layer, sizes):
            layer[grp][name] = a[off:off + n].view(shape)
            off += n
        layer["attn"]["wo"] = wo[li * q * d:(li + 1) * q * d].view(q, d)
        m = n_e * d * f
        layer["moe"]["down"] = down[li * m:(li + 1) * m].view(n_e, d, f)
        layer["ln1"] = gains[2 * li * d:(2 * li + 1) * d]
        layer["ln2"] = gains[(2 * li + 1) * d:(2 * li + 2) * d]
        layers.append(layer)
    return {"embed": embed.view(v, d), "layers": layers,
            "final_norm": gains[2 * n_l * d:],
            "lm_head": a[off:off + d * v].view(d, v)}


def fp8_weights(params: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of the tree with every matrix rounded to float8 e4m3 by
    output channel (scale: the channel's largest magnitude over 448) and
    back to its dtype; norm gains kept.  The embedding's channels are its
    rows, an [in, out] matrix's its columns, an expert's [out, in] its
    rows."""
    def rnd(w: torch.Tensor, axis: int) -> torch.Tensor:
        out = torch.empty_like(w)
        for i in range(w.shape[0] if w.dim() == 3 else 1):
            m = w[i] if w.dim() == 3 else w
            f = m.float()
            s = f.abs().amax(axis, keepdim=True).clamp_min(1e-12) / 448.0
            (out[i] if w.dim() == 3 else out).copy_(
                (f / s).to(torch.float8_e4m3fn).float() * s)
        return out

    layers = [{"attn": {k: rnd(v, 0) for k, v in layer["attn"].items()},
               "moe": {k: rnd(v, 0 if k == "router" else -1)
                       for k, v in layer["moe"].items()},
               "ln1": layer["ln1"], "ln2": layer["ln2"]}
              for layer in params["layers"]]
    return {"embed": rnd(params["embed"], 1), "layers": layers,
            "final_norm": params["final_norm"],
            "lm_head": rnd(params["lm_head"], 0)}


def setup(cfg: Dict[str, Any], tr: Dict[str, Any], seed: int, device,
          control: str = "") -> Dict[str, Any]:
    """As ``poison.setup``, with this model: the DecoderConfig first (a
    program that cannot state it fails at once), weights, tokenizer,
    corpus, BM25 index and queries from ``seed``, then the warm-up.
    ``control="fp8_weights"`` serves the weights rounded to float8
    (``fp8_weights``; the precision control), the reference keeping the
    bf16 ones."""
    from sdag_tpu_torch.datamodels import Resources
    from sdag_tpu_torch.defenses.none import NoDefense
    from sdag_tpu_torch.retrieval.sparse import BM25Index, SparseRetriever
    from sdag_tpu_torch.sdag.generate import Generator
    if control not in ("", "fp8_weights"):
        raise ValueError(f"unknown control {control!r}")
    dcfg = decoder_config(cfg)
    notes: Dict[str, Any] = {}
    t = time.perf_counter()
    head, words = poison.vocabulary(cfg)
    pieces = head + [" " + w for w in words]
    tok = poison._recording_tokenizer(pieces)
    params = make_weights(cfg, seed, device)
    gen = Generator(fp8_weights(params) if control else params, dcfg, tok,
                    temperature=0.0, seed=seed,
                    batch_bucket=int(tr["llm_batch"]), device=device)
    t, notes["setup_model_s"] = time.perf_counter(), time.perf_counter() - t
    traffic = poison.make_traffic(cfg, tr, words, seed)
    t, notes["setup_traffic_s"] = time.perf_counter(), time.perf_counter() - t
    index = BM25Index.from_texts(
        traffic["texts"], [str(i) for i in range(len(traffic["texts"]))],
        k1=0.9, b=0.4, engine="postings", device=device)
    t, notes["setup_bm25_s"] = time.perf_counter(), time.perf_counter() - t
    st = {"cfg": cfg, "tr": tr, "seed": seed, "device": device,
          "params": params, "dcfg": dcfg, "gen": gen, "tok": tok,
          "words": words, "pieces": pieces, "traffic": traffic, "cursor": 0,
          "config": poison._config(tr, seed), "notes": notes,
          "res": Resources(tokenizer=tok, generator=gen,
                           sparse_index=index),
          "retriever": SparseRetriever(index), "defense": NoDefense(),
          "batch_idx": 0}
    filler = tok.encode(" " + words[0])[0]
    for lp in tr["warmup_padded_lens"]:
        gen.generate_ids([np.full(int(lp), filler, np.int32)]
                         * int(tr["llm_batch"]),
                         max_new_tokens=int(tr["max_new_tokens"]))
    for _ in range(int(tr["warmup_batches"])):
        run_batch(st)
    # every call from here on logs its routes, for the check
    gen.route_log = st["route_log"] = []
    notes["setup_warmup_s"] = time.perf_counter() - t
    return st


def trace_segment(st: Dict[str, Any]) -> None:
    """``poison.trace_segment``, keeping the Generator's expert counters
    over the segment."""
    stats = st["gen"].stats
    before = {k: stats[k] for k in COUNTERS}
    poison.trace_segment(st)
    st["segment_moe"] = {k: stats[k] - before[k] for k in COUNTERS}


def layer_inputs(st: Dict[str, Any]) -> None:
    """Each record's re-derived prompts: lengths, the pairs of the full
    layers' mask and of the windowed layers' (ISO and causal), served
    counts."""
    w = int(st["cfg"]["sliding_window"])
    for rec in st["records"] + st.get("segment_records", []):
        out = []
        for r in prompt_rows(st, rec):
            p = r["prompt"]
            n = len(p.ids)
            out.append({
                "len": n,
                "iso_pairs": bounds.iso_pairs(n, p.sys_user_len,
                                              p.doc_spans),
                "iso_pairs_w": moe_bounds.window_iso_pairs(
                    n, p.sys_user_len, p.doc_spans, w),
                "causal_pairs_w": moe_bounds.window_causal_pairs(n, w),
                "iso_fed": len(r["iso"]), "noiso_fed": len(r["noiso"])})
        rec["prompts"] = out


def _logged_routes(st: Dict[str, Any], recs: List[Dict[str, Any]]):
    """The Generator's route log (``Generator.route_log``, kept from the
    end of the warm-up) by (record, side, query): each record's ISO calls
    of ``llm_batch`` queries, then its NO-ISO ones, in the order it made
    them.  Returns (entry, row) for each."""
    log = st["route_log"]
    llm = int(st["tr"]["llm_batch"])
    out, c = {}, 0
    for ri, r in enumerate(recs):
        for side in ("iso", "noiso"):
            for j in range(r["n"]):
                out[ri, side, j] = (c + j // llm, j % llm)
            c += -(-r["n"] // llm)
    if c != len(log):
        raise RuntimeError(f"the route log holds {len(log)} calls, the "
                           f"records made {c}")
    return {key: (log[i], b) for key, (i, b) in out.items()}


def _program_routes(entry: Dict[str, Any], b: int, prompt: List[int],
                    served: List[int]) -> torch.Tensor:
    """A logged call's routes of row ``b`` at every position of prompt +
    served (int64 [layers, positions, k], -1 where none was logged),
    after checking that the call's row held this prompt."""
    lp = entry["ids"].shape[1]
    rows = entry["rows"]
    sel = ((rows >= b * lp) & (rows < (b + 1) * lp)).nonzero()[:, 0]
    if entry["ids"].reshape(-1)[rows[sel]].tolist() != list(prompt):
        raise RuntimeError("a route log entry does not hold the record's "
                           "prompt")
    n_l, _, k = entry["prefill"].shape
    got = torch.full((n_l, len(prompt) + len(served), k), -1,
                     dtype=torch.int64, device=rows.device)
    got[:, :len(prompt)] = entry["prefill"][:, sel].long()
    t = min(len(served), entry["decode"].shape[0])
    got[:, len(prompt):len(prompt) + t] = \
        entry["decode"][:t, :, b].long().transpose(0, 1)
    return got


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

    rows = [(ri, j, row) for ri, r in enumerate(recs)
            for j, row in enumerate(prompt_rows(st, r))]
    n = min(len(rows), int(tr["check_requests"]))
    longest = max(range(len(rows)),
                  key=lambda i: len(rows[i][2]["prompt"].ids))
    pick = [longest] + [int(i) for i in rng.choice(len(rows), size=n,
                                                   replace=False)
                        if int(i) != longest][:n - 1]
    logged = _logged_routes(st, recs)
    seqs, forced = [], []
    for i in pick:
        ri, j, row = rows[i]
        p = row["prompt"]
        seqs.append(ref_dec.Seq(p.ids + row["iso"], len(p.ids),
                                p.sys_user_len, tuple(p.doc_spans)))
        seqs.append(ref_dec.Seq(p.ids + row["noiso"], len(p.ids)))
        for side in ("iso", "noiso"):
            entry, b = logged[ri, side, j]
            forced.append(_program_routes(entry, b, p.ids, row[side]))
    gaps, short = ref_moe.served_gaps(st["params"], st["cfg"], seqs,
                                      st["device"], routes=forced)
    # the router's shortfall of the program's picks, over the positions
    # prefill routed and over those decode routed (the served tokens but
    # the last), each (layer, position) one reading
    where = {"prefill": [], "decode": []}
    for s, f, sh in zip(seqs, forced, short):
        logged_pos = (f >= 0).all(-1)
        for name, sl in (("prefill", slice(0, s.prompt_len)),
                         ("decode", slice(s.prompt_len, len(s.ids)))):
            where[name].append(sh[:, sl][logged_pos[:, sl]])
    means = {}
    for name, parts in where.items():
        v = torch.cat(parts)
        means[name] = float(v.mean()) if v.numel() else 0.0
        st["notes"].update({
            f"route_{name}_pairs": int(v.numel()),
            f"route_{name}_pairs_differ": int((v > 0).sum()),
            f"route_{name}_gap_mean": means[name],
            f"route_{name}_gap_max": float(v.max()) if v.numel() else 0.0})
    flat_g = [x for g in gaps for x in g]
    st["notes"].update(served_tokens_checked=len(flat_g),
                       served_gap_max=max(flat_g, default=0.0),
                       served_tokens_off_argmax=sum(1 for x in flat_g
                                                    if x > 0))
    mean = float(np.mean(flat_g)) if flat_g else float("inf")
    out.append(("served_gap_mean", mean, float(lim["served_gap_mean"])))
    out.append(("route_gap_mean", max(means.values()),
                float(lim["route_gap_mean"])))
    return out
