"""The expert decoder with windowed and full layers (Mellum2-12B-A2.5B's
block at a tiny size) against the plain float32 reference
(``tests/moe_reference.py``) on seeded weights: prefill logits ISO and
NO-ISO (with holes), decode through the cache against the full forward,
the window dropping a late passage's prefix, the YaRN frequencies at the
published values, routing, and K8's plain version against dense expert
sums; a dense config's prefill and decode unchanged bit for bit; and the
clear errors for what experts are not served with."""

import dataclasses

import numpy as np
import pytest
import torch

import moe_reference as ref
from sdag_tpu_torch.config import Config
from sdag_tpu_torch.models.llama import (DecoderConfig, _mlp, _project_qkv,
                                         decode_step, init_decoder_params,
                                         layer_freqs, make_kv_cache,
                                         positions_from_doc_id, prefill,
                                         quantize_decoder_params_int8,
                                         rms_norm, rope, rope_freqs,
                                         yarn_ramp_bounds)
from sdag_tpu_torch.ops.attention import (decode_attention,
                                          sdag_prefill_attention)
from sdag_tpu_torch.ops import moe as M
from sdag_tpu_torch.ops.moe import (expert_products, moe_experts_reference,
                                    moe_prefill, route)
from sdag_tpu_torch.sdag.generate import Generator
from sdag_tpu_torch.sdag.mask import HOLE_DOC_ID

CPU = torch.device("cpu")
TINY = DecoderConfig(
    vocab_size=96, d_model=48, n_layers=4, n_heads=4, n_kv_heads=2,
    d_ff=96, rope_theta=10000.0, norm_eps=1e-6, tie_embeddings=False,
    head_dim=16, sliding_window=12,
    layer_types=("sliding_attention",) * 3 + ("full_attention",),
    rope_yarn=(4.0, 32, 32.0, 1.0, 1.1386294361119891),
    n_experts=8, experts_per_token=3, expert_ff=24)
# a passage far from the prefix, holes between passages
LAYOUT = [("prefix", 8), ("doc", 9), ("hole", 2), ("doc", 10), ("hole", 3),
          ("doc", 11), ("tail", 3)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_config(cfg: DecoderConfig) -> dict:
    """The published config's keys for ``cfg``."""
    yarn = cfg.rope_yarn
    return {
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
        "rms_norm_eps": cfg.norm_eps, "sliding_window": cfg.sliding_window,
        "layer_types": list(cfg.layer_types),
        "num_experts_per_tok": cfg.experts_per_token,
        "norm_topk_prob": cfg.norm_topk_prob,
        "rope_parameters": {
            "full_attention": {
                "rope_type": "yarn", "rope_theta": cfg.rope_theta,
                "factor": yarn[0], "original_max_position_embeddings":
                yarn[1], "beta_fast": yarn[2], "beta_slow": yarn[3],
                "attention_factor": yarn[4]},
            "sliding_attention": {"rope_type": "default",
                                  "rope_theta": cfg.rope_theta}}}


def params_for(cfg, seed=0):
    gen = torch.Generator()
    gen.manual_seed(seed)
    p = init_decoder_params(gen, cfg, device="cpu")
    # gains away from 1, as the benchmark's
    for layer in p["layers"]:
        for key in ("ln1", "ln2"):
            layer[key] = 1 + 0.1 * torch.randn(cfg.d_model, generator=gen)
    return p


def build(layout, rng, iso=True):
    """Port arrays (ids, doc_id) and the reference's hole-free (ids,
    sys_user_len, doc_spans)."""
    ids, doc_id, ref_ids, spans = [], [], [], []
    sys_user, doc = 0, 0
    for kind, n in layout:
        toks = rng.integers(2, 96, size=n).tolist()
        if kind == "hole":
            ids += [0] * n
            doc_id += [HOLE_DOC_ID] * n
            continue
        if kind == "doc" and iso:
            spans.append((len(ref_ids), len(ref_ids) + n))
            doc_id += [doc] * n
            doc += 1
        else:
            doc_id += [-1] * n
        if kind == "prefix":
            sys_user = n
        ids += toks
        ref_ids += toks
    if not iso:
        keep = [i for i, d in enumerate(doc_id) if d != HOLE_DOC_ID]
        ids = [ids[i] for i in keep]
        doc_id = [-1] * len(ids)
    return ids, doc_id, ref_ids, (sys_user if iso else 0), spans


def port_prefill(params, cfg, rows, stats=None):
    """Right-padded batch of (ids, doc_id, sys_user_len) rows -> logits
    [B, L, V], valid lengths."""
    L = max(len(r[0]) for r in rows) + 5
    B = len(rows)
    ids = torch.zeros(B, L, dtype=torch.int32)
    doc = torch.full((B, L), -1, dtype=torch.int32)
    vl = torch.tensor([len(r[0]) for r in rows], dtype=torch.int32)
    sul = torch.tensor([r[2] for r in rows], dtype=torch.int32)
    for b, (i, d, _) in enumerate(rows):
        ids[b, :len(i)] = torch.tensor(i)
        doc[b, :len(d)] = torch.tensor(d)
    logits, _ = prefill(params, cfg, ids, doc_id=doc,
                        nbr_bits=torch.zeros_like(doc), sys_user_len=sul,
                        valid_len=vl, with_cache=False, stats=stats)
    return logits, doc, vl


def test_prefill_logits_match_reference_iso_and_noiso():
    cfg, params = TINY, params_for(TINY)
    rng = np.random.default_rng(1)
    iso = build(LAYOUT, rng, iso=True)
    noiso = build(LAYOUT, np.random.default_rng(1), iso=False)
    stats = {}
    logits, doc, vl = port_prefill(params, cfg, [(iso[0], iso[1], iso[3]),
                                                 (noiso[0], noiso[1], 0)],
                                   stats)
    hf = hf_config(cfg)
    for b, (ids, d, rids, sul, spans) in enumerate((iso, noiso)):
        want = ref.forward(params, hf, rids, sul, spans)
        rows = [i for i in range(len(ids)) if d[i] != HOLE_DOC_ID]
        got = logits[b, rows]
        assert torch.allclose(got, want, atol=2e-4, rtol=2e-4), \
            (got - want).abs().max()
    # every layer routes the valid rows only: no right padding, no holes
    valid = sum(1 for x in iso[1] if x != HOLE_DOC_ID) + len(noiso[0])
    assert stats["moe_prefill_rows"] == \
        valid * cfg.experts_per_token * cfg.n_layers


class _Tok:
    pad_token_id, eos_token_id = 0, 1


def test_decode_through_cache_matches_full_forward(monkeypatch):
    """Prefill, then greedy decode steps through the cache (the windowed
    layers' mask from each slot's RoPE position): each step's logits equal
    the reference's full forward over prompt + served tokens."""
    from sdag_tpu_torch.sdag import generate
    cfg, params = TINY, params_for(TINY, seed=3)
    ids, doc, rids, sul, spans = build(LAYOUT, np.random.default_rng(5))
    steps = []
    real_step = generate.decode_step

    def recording(*a, **k):
        logits, cache = real_step(*a, **k)
        steps.append(logits.clone())
        return logits, cache
    monkeypatch.setattr(generate, "decode_step", recording)
    gen = Generator(params, cfg, _Tok(), temperature=0.0, device="cpu")
    lp = 64
    inp = torch.zeros(2, lp, dtype=torch.int32)
    inp[0, :len(ids)] = torch.tensor(ids)
    d = torch.full((2, lp), -1, dtype=torch.int32)
    d[0, :len(doc)] = torch.tensor(doc)
    vl = torch.tensor([len(ids), 0], dtype=torch.int32)
    out, lengths = gen._generate(inp, d, torch.zeros_like(d),
                                 torch.tensor([sul, 0], dtype=torch.int32),
                                 vl, 6)
    served = out[0, :lengths[0]].tolist()
    assert len(served) == 6 and 1 not in served
    want = ref.forward(params, hf_config(cfg), rids + served, sul, spans)
    n = len(rids)
    for t, logits in enumerate(steps[:len(served) - 1]):
        assert torch.allclose(logits[0], want[n + t], atol=2e-4,
                              rtol=2e-4), (t, (logits[0] - want[n + t])
                                           .abs().max())
    # the padding row is born done and reads no expert; the live row's
    # distinct experts are counted a layer and step
    reads = gen.stats["moe_decode_expert_reads"]
    steps_run = gen.stats["decode_steps"]
    assert 0 < reads <= cfg.experts_per_token * cfg.n_layers * steps_run
    assert reads == cfg.experts_per_token * cfg.n_layers * steps_run


def test_window_drops_the_prefix_of_a_late_passage():
    """With windowed layers only, a passage row a window or more past the
    prefix does not depend on the prefix's tokens; an early one does."""
    cfg = dataclasses.replace(TINY, layer_types=("sliding_attention",) * 4)
    params = params_for(cfg, seed=4)
    a = build(LAYOUT, np.random.default_rng(7))
    changed = [(t + 5) % 90 + 2 for t in a[0][:8]]
    b = (changed + a[0][8:], a[1], changed + a[2][8:]) + a[3:]
    la, _, _ = port_prefill(params, cfg, [(a[0], a[1], a[3]),
                                          (b[0], b[1], b[3])])
    hf = hf_config(cfg)
    late = range(len(a[0]) - 14, len(a[0]) - 3)     # the last passage
    early = range(8, 17)                            # the first passage
    assert torch.equal(la[0, late], la[1, late])
    assert not torch.allclose(la[0, early], la[1, early])
    want = ref.forward(params, hf, b[2], b[3], b[4])
    rows = [i for i in range(len(b[0])) if b[1][i] != HOLE_DOC_ID]
    assert torch.allclose(la[1, rows], want, atol=2e-4, rtol=2e-4)
    # without the window the late rows would see the prefix
    hf_full = dict(hf, sliding_window=10 ** 6)
    wa = ref.forward(params, hf_full, a[2], a[3], a[4])
    wb = ref.forward(params, hf_full, b[2], b[3], b[4])
    n = len(a[2])
    assert not torch.allclose(wa[n - 11:n - 3], wb[n - 11:n - 3])


def test_yarn_frequencies_at_the_published_values():
    cfg = DecoderConfig.mellum2_12b_a2p5b()
    yarn = cfg.rope_yarn
    assert yarn_ramp_bounds(64, cfg.rope_theta, yarn) == (18, 35)
    got = rope_freqs(64, cfg.rope_theta, None, CPU, yarn).double()
    rope_cfg = hf_config(cfg)["rope_parameters"]
    want, mscale = ref.inv_freqs(rope_cfg["full_attention"], 128)
    assert torch.allclose(got, want, rtol=1e-6, atol=0)
    base = 1.0 / 500000.0 ** (torch.arange(64, dtype=torch.float64) / 64)
    assert torch.allclose(got[:19], base[:19], rtol=1e-6)
    assert torch.allclose(got[35:], base[35:] / 16, rtol=1e-6)
    assert ((got[19:35] < base[19:35]) & (got[19:35] > base[19:35] / 16)
            ).all()
    # full layers: the attention factor squared in the softmax scale;
    # windowed layers: plain RoPE and scale
    assert cfg.attn_scale(3) == pytest.approx(mscale ** 2 / 128 ** 0.5)
    assert cfg.attn_scale(0) is None
    assert torch.allclose(layer_freqs(cfg, 0, CPU).double(), ref.inv_freqs(
        rope_cfg["sliding_attention"], 128)[0], rtol=1e-6, atol=0)
    assert [cfg.windowed(i) for i in range(28)].count(True) == 21


def test_routing_topk_renormalised_and_holes_not_routed():
    gen = torch.Generator()
    gen.manual_seed(9)
    u = torch.randn(20, 16, generator=gen)
    router = torch.randn(16, 8, generator=gen)
    w, idx = route(u, router, 3)
    probs = torch.softmax(u @ router, -1)
    assert torch.allclose(w.sum(-1), torch.ones(20))
    top = probs.sort(-1, descending=True)
    assert torch.equal(idx, top.indices[:, :3])
    assert torch.allclose(w, top.values[:, :3] / top.values[:, :3].sum(
        -1, keepdim=True))
    w_raw, _ = route(u, router, 3, norm_topk=False)
    assert torch.allclose(w_raw, top.values[:, :3])
    # rows not named (holes, padding) give 0 and are not counted
    cfg = TINY
    moe = params_for(cfg)["layers"][0]["moe"]
    h = torch.randn(2, 10, cfg.d_model, generator=gen)
    valid = torch.ones(2, 10, dtype=torch.bool)
    valid[0, 3:5] = False
    valid[1, 7:] = False
    stats, routes = {}, []
    rows = valid.reshape(-1).nonzero()[:, 0]
    out = moe_prefill(moe, cfg, h, rows, stats, routes)
    assert (out[~valid] == 0).all() and (out[valid] != 0).all()
    assert stats["moe_prefill_rows"] == 15 * cfg.experts_per_token
    (got_rows, picks), = routes
    assert torch.equal(got_rows, rows)
    u = h.reshape(-1, cfg.d_model)[rows]
    assert torch.equal(picks, route(u, moe["router"],
                                    cfg.experts_per_token)[1])
    alone = moe_prefill(moe, cfg, h[1:, :7],
                        valid[1:, :7].reshape(-1).nonzero()[:, 0])
    assert torch.allclose(out[1, :7], alone[0], atol=1e-6)


def _dense_expert_sums(x, moe, k):
    probs = torch.softmax(x.float() @ moe["router"].float(), -1)
    tw, ti = torch.topk(probs, k, -1)
    dense_w = torch.zeros_like(probs).scatter_(1, ti, tw / tw.sum(
        -1, keepdim=True))
    f = moe["down"].shape[2]
    g = torch.einsum("bd,end->ben", x.float(), moe["gate_up"][:, :f].float())
    up = torch.einsum("bd,end->ben", x.float(), moe["gate_up"][:, f:].float())
    y = torch.einsum("bef,edf->bed", torch.nn.functional.silu(g) * up,
                     moe["down"].float())
    return (dense_w[:, :, None] * y).sum(1)


def test_k8_plain_version_equals_dense_expert_sums():
    cfg = TINY
    moe = params_for(cfg, seed=6)["layers"][1]["moe"]
    gen = torch.Generator()
    gen.manual_seed(2)
    x = torch.randn(6, cfg.d_model, generator=gen)
    live = torch.tensor([True, True, False, True, True, True])
    reads = torch.zeros(1, dtype=torch.int64)
    got = moe_experts_reference(x, moe["router"], moe["gate_up"],
                                moe["down"], cfg.experts_per_token,
                                row_live=live, reads=reads)
    want = _dense_expert_sums(x, moe, cfg.experts_per_token)
    assert torch.allclose(got[live], want[live], atol=1e-5, rtol=1e-5)
    assert (got[~live] == 0).all()
    _, idx = route(x[live], moe["router"], cfg.experts_per_token)
    assert int(reads) == idx.unique().numel()
    # the prefill's sorted products compute the same sums
    w, idx = route(x, moe["router"], cfg.experts_per_token)
    pre = expert_products(x, w, idx, moe["gate_up"], moe["down"])
    assert torch.allclose(pre, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d,f,sms", [(2304, 896, 132), (2048, 768, 132),
                                     (4096, 14336, 114), (7168, 2048, 132),
                                     (8, 8, 1), (12288, 8, 132)])
def test_k8_plan_fills_each_ring_within_shared_memory(d, f, sms):
    """K8's plan: a persistent block an SM; each ring takes as many tiles
    as its byte budget holds (at least one, at most one a consumer warp)
    and fits a block's shared memory; gate/up stages x's B rows, and down
    an expert's h parts, after their rings where they fit."""
    for B in (1, 8, 32, 1024):
        plan = M.k8_plan(B, d, f, sms)
        assert plan["grid"] == sms
        for name, n, flag, staged in (
                ("gate_up", d, "x_staged", B * M.k8_row_stride(d)),
                ("down", f, "h_staged", 3 * B * M.k8_row_stride(f))):
            tile = M.K8_TILE_ROWS * M.k8_row_stride(n)
            slots = plan[name + "_slots"]
            assert 1 <= slots <= M.K8_WARPS
            assert slots * tile <= max(M.K8_RING_BYTES, tile)
            assert slots == M.K8_WARPS \
                or (slots + 1) * tile > M.K8_RING_BYTES
            ring = M.K8_BAR_BYTES + slots * tile
            assert plan[flag] == int(ring + staged <= M.K8_SMEM_LIMIT)
            assert plan[name + "_smem"] == ring + staged * plan[flag] \
                <= M.K8_SMEM_LIMIT
    if (d, f) == (2304, 896):   # mellum2.poison_top20's widths
        assert (plan["gate_up_slots"], plan["down_slots"]) == (4, 11)
        assert [(M.k8_plan(B, d, f, sms)["x_staged"],
                 M.k8_plan(B, d, f, sms)["h_staged"])
                for B in (8, 12, 13, 17, 18)] == [
            (1, 1), (1, 1), (1, 0), (1, 0), (0, 0)]


@pytest.mark.parametrize("n", [8, 16, 24, 896, 2304, 2312, 4096])
def test_k8_row_stride_spreads_an_mmas_rows_over_the_banks(n):
    """An mma step's 8-byte loads (lane 4g + t: row g, words 2t, 2t + 1;
    a half-warp's 16 lanes at once) fall on 32 distinct banks in each half,
    and each row starts 16-byte aligned for its bulk copy."""
    stride = M.k8_row_stride(n)
    assert stride % 16 == 0 and 2 * n <= stride <= 2 * n + 64
    for half in (range(4), range(4, 8)):
        banks = {(g * stride // 4 + 2 * t + e) % 32
                 for g in half for t in range(4) for e in range(2)}
        assert len(banks) == 32


@pytest.mark.parametrize("d,f", [(2304, 65536), (65536, 896)])
def test_k8_plan_refuses_a_tile_wider_than_shared_memory(d, f):
    with pytest.raises(ValueError, match="does not fit shared memory"):
        M.k8_plan(8, d, f, 132)


def test_k8_scratch_and_items_by_hand():
    """f32: 32 slices x B x E partials, y [B k, d], h [B k, F] as three
    bf16 planes; int32: the list's length, E experts, E + 1 starts, B k
    picks; 18 experts stream 18 x (896 / 4 + 2304 / 8) tiles."""
    B, d, f, E, k = 8, 2304, 896, 64, 8
    assert M.k8_scratch_sizes(B, d, f, E, k) == (
        32 * 8 * 64 + 64 * 2304 + 3 * 64 * 896 // 2, 1 + 64 + 65 + 64)
    assert M.k8_items(d, f, 18) == 18 * (224 + 288)


def test_k8_wrapper_refuses_cpu_tensors():
    moe = params_for(TINY)["layers"][1]["moe"]
    x = torch.zeros(2, TINY.d_model, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 CUDA tensor"):
        M.moe_experts_cuda(x, *(moe[n].bfloat16() for n in
                                ("router", "gate_up", "down")), 3)


def _old_layer(layer, cfg, x, positions, doc_id, valid_len, sul):
    """A dense layer as the port computed it before per-layer kinds."""
    B, L, _ = x.shape
    h = rms_norm(x, layer["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(layer["attn"], h, cfg)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    o = sdag_prefill_attention(q, k, v, doc_id, torch.zeros_like(doc_id),
                               sul, valid_len=valid_len)
    x = x + o.transpose(1, 2).reshape(B, L, -1) @ layer["attn"]["wo"]
    return x + _mlp(layer["mlp"], rms_norm(x, layer["ln2"], cfg.norm_eps)), \
        (k, v)


@pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 8192)])
def test_dense_config_prefill_and_decode_unchanged_bit_for_bit(scaling):
    cfg = dataclasses.replace(DecoderConfig.tiny(), tie_embeddings=False,
                              rope_scaling=scaling)
    params = params_for(cfg, seed=8)
    ids, doc, _, sul, _ = build(LAYOUT, np.random.default_rng(3))
    L = len(ids)
    inp = torch.tensor([ids], dtype=torch.int32) % cfg.vocab_size
    d = torch.tensor([doc], dtype=torch.int32)
    vl = torch.tensor([L], dtype=torch.int32)
    s = torch.tensor([sul], dtype=torch.int32)
    logits, cache = prefill(params, cfg, inp, doc_id=d,
                            nbr_bits=torch.zeros_like(d), sys_user_len=s,
                            valid_len=vl, cache_size=L + 1)
    pos = positions_from_doc_id(d)
    x = params["embed"][inp.long()]
    old_cache = make_kv_cache(cfg, 1, L + 1, device="cpu")
    for li, layer in enumerate(params["layers"]):
        x, (k, v) = _old_layer(layer, cfg, x, pos, d, vl, s)
        old_cache["k"][li, :, :, :L] = k
        old_cache["v"][li, :, :, :L] = v
    old = (rms_norm(x, params["final_norm"], cfg.norm_eps)
           @ params["lm_head"]).float()
    assert torch.equal(logits, old)
    assert torch.equal(cache["k"], old_cache["k"])
    # one decode step against the old step's arithmetic
    tok = torch.tensor([5], dtype=torch.int32)
    p = pos[:, -1] + 1
    mask = torch.ones(1, L + 1, dtype=torch.bool)
    new, _ = decode_step(params, cfg, tok, p, cache, L, mask)
    freqs = rope_freqs(cfg.head_dim // 2, cfg.rope_theta, cfg.rope_scaling,
                       CPU)
    x = params["embed"][tok.long()][:, None, :]
    wi = torch.tensor([L])
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["ln1"], cfg.norm_eps)
        q, k, v = _project_qkv(layer["attn"], h, cfg)
        o = decode_attention(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                             old_cache["k"][li], old_cache["v"][li], mask,
                             wi, p, freqs)
        x = x + o.reshape(1, 1, -1) @ layer["attn"]["wo"]
        x = x + _mlp(layer["mlp"], rms_norm(x, layer["ln2"], cfg.norm_eps))
    old = (rms_norm(x, params["final_norm"], cfg.norm_eps)
           @ params["lm_head"])[:, 0].float()
    assert torch.equal(new, old)


@pytest.mark.parametrize("what", ["int8_weights", "int8_kv", "speculation",
                                  "mesh"])
def test_experts_refuse_what_they_are_not_served_with(what):
    params = params_for(TINY)
    kw = {}
    if what == "int8_weights":
        params = quantize_decoder_params_int8(
            {k: v for k, v in params.items()} | {
                "layers": [{"attn": layer["attn"], "mlp": {},
                            "ln1": layer["ln1"], "ln2": layer["ln2"]}
                           for layer in params["layers"]]})
    elif what == "int8_kv":
        kw["kv_cache_dtype"] = "int8"
    elif what == "speculation":
        kw["speculative_draft"] = 3
    else:
        kw["mesh"] = object()
    with pytest.raises(ValueError, match="expert model is not served"):
        Generator(params, TINY, _Tok(), device="cpu", **kw)
    c = Config()
    c.LLM_ARCH = "mellum2-12b-a2.5b"
    c.validate()
    setting = {"int8_weights": ("LLM_WEIGHTS_DTYPE", "int8"),
               "int8_kv": ("KV_CACHE_DTYPE", "int8"),
               "speculation": ("SPECULATIVE_DRAFT_LEN", 4),
               "mesh": ("MESH_MODEL", 2)}[what]
    setattr(c, *setting)
    with pytest.raises(ValueError, match="sparse experts"):
        c.validate()


def test_experts_refuse_f32_weights_on_cuda():
    """K8 takes bf16: f32 expert weights on CUDA raise at construction's
    check (no device needed to check it); bf16 ones, or f32 on the CPU,
    pass."""
    from sdag_tpu_torch.sdag.generate import _check_experts_served
    params = params_for(TINY)
    with pytest.raises(ValueError, match="float32 weights on CUDA"):
        _check_experts_served(params, "native", 0, None,
                              torch.device("cuda"))
    _check_experts_served(params, "native", 0, None, CPU)
    bf16 = {"layers": [{"attn": layer["attn"], "moe": {
        k: v.bfloat16() for k, v in layer["moe"].items()}}
        for layer in params["layers"]]}
    _check_experts_served(bf16, "native", 0, None, torch.device("cuda"))


def test_route_log_holds_the_prefill_and_decode_routes():
    """``Generator.route_log``: a call's entry names the prompt's routed
    slots, the prefill's picks, and each decode step's picks of the token
    it feeds, the same experts a prefill over prompt + served tokens
    picks there; a row born done logs none."""
    cfg, params = TINY, params_for(TINY, seed=4)
    ids, doc, _, sul, _ = build(LAYOUT, np.random.default_rng(8))
    gen = Generator(params, cfg, _Tok(), temperature=0.0, device="cpu")
    gen.route_log = []
    lp = 64
    inp = torch.zeros(2, lp, dtype=torch.int32)
    inp[0, :len(ids)] = torch.tensor(ids)
    d = torch.full((2, lp), -1, dtype=torch.int32)
    d[0, :len(doc)] = torch.tensor(doc)
    vl = torch.tensor([len(ids), 0], dtype=torch.int32)
    out, lengths = gen._generate(inp, d, torch.zeros_like(d),
                                 torch.tensor([sul, 0], dtype=torch.int32),
                                 vl, 5)
    (entry,) = gen.route_log
    served = out[0, :lengths[0]].tolist()
    assert torch.equal(entry["ids"], inp) and len(served) == 5
    keep = [i for i in range(len(ids)) if doc[i] != HOLE_DOC_ID]
    assert entry["rows"].tolist() == keep
    assert entry["prefill"].shape == (cfg.n_layers, len(keep),
                                      cfg.experts_per_token)
    # a prefill over prompt + served (one row) picks the same experts
    full = torch.tensor([ids + served], dtype=torch.int32)
    fdoc = torch.tensor([doc + [-1] * len(served)], dtype=torch.int32)
    routes = []
    prefill(params, cfg, full, doc_id=fdoc, nbr_bits=torch.zeros_like(fdoc),
            sys_user_len=torch.tensor([sul], dtype=torch.int32),
            valid_len=torch.tensor([full.shape[1]], dtype=torch.int32),
            with_cache=False, routes=routes)
    want = torch.stack([idx for _, idx in routes]).sort(-1).values
    n = len(keep)
    assert torch.equal(entry["prefill"].long().sort(-1).values, want[:, :n])
    dec = entry["decode"][:, :, 0].long().transpose(0, 1).sort(-1).values
    assert torch.equal(dec, want[:, n:])
    assert (entry["decode"][:, :, 1] == -1).all()
