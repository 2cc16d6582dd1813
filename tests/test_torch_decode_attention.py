"""Kernel K7 (``csrc/decode_attention.cu``), a decode step's attention
block, on the CPU: its plain version against the composition the decode
step ran before (rope, ``index_copy_``, ``masked_decode_attention``); an
emulation of the kernel's chunked arithmetic and its fixed sum orders
against ``masked_decode_attention`` and against itself (row independence);
the CUDA wrapper's checks; the CPU path's launch count.  The kernel itself
runs only on the card (``chip_smoke.py`` phase 13)."""

import dataclasses
import math

import pytest
import torch

from sdag_tpu_torch import _build
from sdag_tpu_torch.models import llama as TL
from sdag_tpu_torch.ops import attention as TA

LLAMA3 = (8.0, 1.0, 4.0, 8192)

# csrc/decode_attention.cu's geometry: slots a chunk, pass-2 threads, dims
# a pass-2 block accumulates
CHUNK, NT2, SLICE = 64, 256, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Parallel test workers share the CPU; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, dtype, B, Hq, Hkv, Dh, S, w):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dtype)
    mask = torch.rand(B, S, generator=g) < 0.8
    mask[:, w] = True
    return {"q": rnd(B, Hq, Dh), "k": rnd(B, Hkv, Dh), "v": rnd(B, Hkv, Dh),
            "k_cache": rnd(B, Hkv, S, Dh), "v_cache": rnd(B, Hkv, S, Dh),
            "mask": mask, "write_index": torch.tensor([w]),
            "positions": torch.randint(0, 5000, (B,), generator=g)}


def _old_composition(x, theta, scaling):
    """The decode step's attention block before K7 (models/llama.py)."""
    pos = x["positions"][:, None]
    q = TL.rope(x["q"][:, :, None], pos, theta, scaling)
    k = TL.rope(x["k"][:, :, None], pos, theta, scaling)
    x["k_cache"].index_copy_(2, x["write_index"], k)
    x["v_cache"].index_copy_(2, x["write_index"], x["v"][:, :, None])
    return TA.masked_decode_attention(q[:, :, 0, :], x["k_cache"],
                                      x["v_cache"], x["mask"])


@pytest.mark.parametrize("scaling", [None, LLAMA3], ids=["plain", "llama3"])
@pytest.mark.parametrize("Hq,Hkv", [(8, 8), (32, 8), (16, 4)],
                         ids=["group1", "group4", "tp2_rank"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_block_equals_the_old_composition(dtype, Hq, Hkv, scaling):
    Dh, S, w, theta = 64, 150, 137, 500000.0
    a = _inputs(1, dtype, 3, Hq, Hkv, Dh, S, w)
    b = {k: t.clone() for k, t in a.items()}
    want = _old_composition(a, theta, scaling)
    freqs = TL.rope_freqs(Dh // 2, theta, scaling, torch.device("cpu"))
    got = TA.decode_attention(b["q"], b["k"], b["v"], b["k_cache"],
                              b["v_cache"], b["mask"], b["write_index"],
                              b["positions"], freqs)
    assert torch.equal(got, want)
    assert torch.equal(b["k_cache"], a["k_cache"])
    assert torch.equal(b["v_cache"], a["v_cache"])


# ------------------------------------------------ emulation of K7's sums
def _round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype).float()


def _xor_tree(v: torch.Tensor, offsets, dim: int) -> torch.Tensor:
    """Every lane of ``v`` (along ``dim``) after ``v += shfl_xor(v, off)``
    for each offset in turn."""
    idx = torch.arange(v.shape[dim])
    for off in offsets:
        v = v + v.index_select(dim, idx ^ off)
    return v


def _warps_in_order(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Lane 0 of each warp added in warp order: ``v`` holds warps along
    ``dim`` and their lanes along ``dim + 1``."""
    dim %= v.dim()
    first = v.select(dim + 1, 0)
    out = first.select(dim, 0)
    for wp in range(1, v.shape[dim]):
        out = out + first.select(dim, wp)
    return out


def k7_emulate(q_rot, k_cache, v_cache, mask):
    """K7's attention on the CPU in its own order: f32 scores of the
    valid slots (their dot order not emulated: float64 sums rounded),
    chunks with no valid slot skipped, the maximum over the valid slots;
    each head's sum of exp(s - max) by NT2 threads over slots j = tid mod
    NT2 in order, a warp's xor tree, the warps in order; p = exp(s - max) /
    sum rounded to the cache dtype; the value product per slot group
    (slots j = gi mod groups) in slot order, the groups' xor tree within a
    warp, the warps in order (each 32-dim slice alike)."""
    dtype = v_cache.dtype
    B, Hq, Dh = q_rot.shape
    Hkv, S = k_cache.shape[1], mask.shape[-1]
    G = Hq // Hkv
    n_chunks = -(-S // CHUNK)
    qg = q_rot.double().reshape(B, Hkv, G, Dh)
    s = torch.einsum("bhgd,bhsd->bhgs", qg,
                     k_cache[:, :, :S].double()).float() * Dh ** -0.5
    s = torch.where(mask[:, None, None, :], s, -math.inf)
    live = torch.nn.functional.pad(mask, (0, n_chunks * CHUNK - S)).reshape(
        B, n_chunks, CHUNK).any(-1).repeat_interleave(CHUNK, -1)[:, :S]
    M = s.amax(-1, keepdim=True)
    e = torch.where(mask[:, None, None, :], torch.exp(s - M), 0.0)
    rounds = -(-S // NT2)
    e = torch.nn.functional.pad(e, (0, rounds * NT2 - S))
    t = torch.zeros(B, Hkv, G, NT2)
    for r in range(rounds):
        t = t + e[..., r * NT2:(r + 1) * NT2]
    t = _xor_tree(t.reshape(B, Hkv, G, NT2 // 32, 32), (16, 8, 4, 2, 1), -1)
    L = _warps_in_order(t, -2)[..., None]
    p = torch.where(mask[:, None, None, :],
                    _round_to(torch.exp(s - M) / L, dtype), 0.0)
    lps = SLICE // (16 // v_cache.element_size())
    ng = NT2 // lps
    rounds = -(-S // ng)
    vf = torch.where(live[:, None, :, None], v_cache[:, :, :S].float(), 0.0)
    vf = torch.nn.functional.pad(vf, (0, 0, 0, rounds * ng - S))
    p = torch.nn.functional.pad(p, (0, rounds * ng - S))
    acc = torch.zeros(B, Hkv, G, ng, Dh)
    for r in range(rounds):
        sl = slice(r * ng, (r + 1) * ng)
        acc = acc + p[..., sl, None] * vf[:, :, None, sl, :]
    gpw = 32 // lps
    acc = acc.reshape(B, Hkv, G, NT2 // 32, gpw, Dh)
    acc = _xor_tree(acc, [o for o in (1, 2, 4, 8, 16) if o < gpw], -2)
    return _warps_in_order(acc, -3).reshape(B, Hq, Dh).to(dtype)


def _edge_mask(case, B, S):
    j = torch.arange(S)[None, :].expand(B, S)
    if case == "masked_chunk":
        return (j < S - 3) & ~((j >= 64) & (j < 128))
    if case == "single_slot":
        return j == 97
    if case == "last_chunk_only":
        return j >= (S - 1) // CHUNK * CHUNK
    if case == "prompt_holes":
        lp = S - 20
        holes = (j % 7 == 3) & (j < lp)
        return ((j < lp - 9) & ~holes) | (j >= lp)
    if case == "off_chunk_length":
        return j % 5 != 0
    raise ValueError(case)


EDGE_CASES = ["masked_chunk", "single_slot", "last_chunk_only",
              "prompt_holes", "off_chunk_length"]


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_chunked_arithmetic_matches_plain_attention(dtype, case):
    B, Hq, Hkv, Dh = 2, 8, 2, 64
    S = 201 if case == "off_chunk_length" else 320
    x = _inputs(2, dtype, B, Hq, Hkv, Dh, S, 0)
    mask = _edge_mask(case, B, S)
    got = k7_emulate(x["q"], x["k_cache"], x["v_cache"], mask)
    want = TA.masked_decode_attention(x["q"], x["k_cache"], x["v_cache"],
                                      mask)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_chunked_arithmetic_is_row_independent(dtype):
    """A row alone, and the batch over a longer cache whose extra slots
    are masked, give the batch's bits: the window's rows and the step
    attend alike."""
    B, Hq, Hkv, Dh, S = 3, 8, 2, 64, 300
    x = _inputs(3, dtype, B, Hq, Hkv, Dh, S, 0)
    mask = _edge_mask("prompt_holes", B, S)
    full = k7_emulate(x["q"], x["k_cache"], x["v_cache"], mask)
    alone = k7_emulate(x["q"][1:2], x["k_cache"][1:2], x["v_cache"][1:2],
                       mask[1:2])
    assert torch.equal(alone[0], full[1])
    extra = 90
    grow = lambda c: torch.cat(  # noqa: E731
        [c, torch.randn(B, Hkv, extra, Dh).to(dtype)], 2)
    longer = k7_emulate(x["q"], grow(x["k_cache"]), grow(x["v_cache"]),
                        torch.cat([mask, torch.zeros(B, extra,
                                                     dtype=torch.bool)], 1))
    assert torch.equal(longer, full)


# ------------------------------------------------------ the CUDA wrapper
def _wrapper_args(dtype=torch.bfloat16, B=2, Hq=8, Hkv=2, Dh=64, S=100):
    x = _inputs(4, dtype, B, Hq, Hkv, Dh, S, 50)
    freqs = TL.rope_freqs(Dh // 2, 1e4, None, torch.device("cpu"))
    return x, freqs


def _bad(change):
    x, freqs = _wrapper_args()
    new_kv = [x["k"], x["v"], x["write_index"], x["positions"], freqs]
    args = {"q": x["q"], "k_cache": x["k_cache"], "v_cache": x["v_cache"],
            "cache_mask": x["mask"]}
    change(args, new_kv)
    return args, tuple(new_kv)


WRAPPER_FAULTS = {
    "float16": (lambda a, n: a.update(
        q=a["q"].half(), k_cache=a["k_cache"].half(),
        v_cache=a["v_cache"].half()), "dtype"),
    "q_dtype": (lambda a, n: a.update(q=a["q"].float()),
                "float32, expected"),
    "head_dim_16": (lambda a, n: a.update(
        q=a["q"][..., :16], k_cache=a["k_cache"][..., :16].contiguous(),
        v_cache=a["v_cache"][..., :16].contiguous()), "head dim"),
    "group_3": (lambda a, n: a.update(
        q=torch.zeros(2, 6, 64, dtype=torch.bfloat16)), "group"),
    "cache_strided": (lambda a, n: a.update(
        k_cache=a["k_cache"].transpose(2, 3).contiguous().transpose(2, 3)),
        "contiguous"),
    "cache_shapes": (lambda a, n: a.update(v_cache=a["v_cache"][:, :, :50]),
                     "caches"),
    "mask_dtype": (lambda a, n: a.update(cache_mask=a["cache_mask"].int()),
                   "cache_mask"),
    "mask_longer": (lambda a, n: a.update(cache_mask=torch.ones(
        2, 101, dtype=torch.bool)), "cache_mask"),
    "q_rows_strided": (lambda a, n: a.update(q=torch.zeros(
        2, 8, 128, dtype=torch.bfloat16)[..., ::2]), "rows"),
    "step_mask_short": (lambda a, n: a.update(
        cache_mask=a["cache_mask"][:, :80]), "all the cache's slots"),
    "write_index_int32": (lambda a, n: n.__setitem__(
        2, n[2].int()), "write_index"),
    "positions_float": (lambda a, n: n.__setitem__(
        3, n[3].float()), "positions"),
    "freqs_shape": (lambda a, n: n.__setitem__(4, n[4][:16]), "freqs"),
    "v_new_shape": (lambda a, n: n.__setitem__(1, n[1][:, :1]), "v "),
    "cpu_tensors": (lambda a, n: None, "CUDA"),
}


@pytest.mark.parametrize("fault", sorted(WRAPPER_FAULTS))
def test_wrapper_checks_raise(fault):
    change, message = WRAPPER_FAULTS[fault]
    args, new_kv = _bad(change)
    with pytest.raises(ValueError, match=message):
        TA.decode_attention_cuda(**args, new_kv=new_kv)


def test_attention_entry_checks_out():
    x, _ = _wrapper_args()
    with pytest.raises(ValueError, match="out must be"):
        TA.decode_attention_cuda(x["q"], x["k_cache"], x["v_cache"],
                                 x["mask"], out=torch.empty(2, 8, 64))


def test_cpu_paths_do_not_launch():
    """The step's block, a decode step and a verification window on the
    CPU run the plain version and count no K7 launch."""
    cfg = TL.DecoderConfig(vocab_size=64, d_model=64, n_layers=2, n_heads=2,
                           n_kv_heads=1, d_ff=64)
    params = TL.init_decoder_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    cache = TL.make_kv_cache(cfg, 2, 40, device="cpu")
    before = _build.LAUNCHES["decode_attention"]
    mask = torch.ones(2, 40, dtype=torch.bool)
    TL.decode_step(params, cfg, torch.tensor([3, 4]), torch.tensor([5, 6]),
                   cache, 7, mask)
    TL.decode_window(params, cfg, torch.tensor([[3, 4], [5, 6]]),
                     torch.tensor([[5, 6], [7, 8]]), cache,
                     torch.tensor([8, 9]), mask[:, None].expand(2, 2, 40))
    x, freqs = _wrapper_args(torch.float32)
    TA.decode_attention(x["q"], x["k"], x["v"], x["k_cache"], x["v_cache"],
                        x["mask"], x["write_index"], x["positions"], freqs)
    assert _build.LAUNCHES["decode_attention"] == before


# a model whose layers differ in kind: windowed (plain RoPE) and full
# (YaRN frequencies and scale), the window shorter than the history
WINDOWED = TL.DecoderConfig(
    vocab_size=64, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2,
    d_ff=96, layer_types=("sliding_attention", "full_attention") * 2,
    sliding_window=5, rope_yarn=(4.0, 16, 32.0, 1.0, 1.2))
WINDOWED_MOE = dataclasses.replace(WINDOWED, n_experts=8,
                                   experts_per_token=2, expert_ff=32)


def _window_case(cfg, B=2, L=12, G=3):
    """Prefill of right-padded prompts, then G tokens' masks as the
    Generator builds them: each row's visible prompt slots and the
    slots written since, and the windowed layers' share of them (slots a
    window's width or more behind the token's position left out)."""
    params = TL.init_decoder_params(torch.Generator().manual_seed(2), cfg,
                                    device="cpu")
    g = torch.Generator().manual_seed(4)
    ids = torch.randint(2, cfg.vocab_size, (B, L), generator=g)
    vl = torch.tensor([L, L - 4], dtype=torch.int32)[:B]
    S = L + G + 2
    _, cache = TL.prefill(params, cfg, ids, valid_len=vl, cache_size=S)
    slot = torch.arange(S)[None, :]
    slot_pos = torch.where(slot < L, slot, vl[:, None] + slot - L)
    positions = vl[:, None].long() + torch.arange(G)[None, :]
    masks = [(slot < vl[:, None]) | ((slot >= L) & (slot <= L + i))
             for i in range(G)]
    windows = [m & (slot_pos > positions[:, i:i + 1] - cfg.sliding_window)
               for i, m in enumerate(masks)]
    tokens = torch.randint(2, cfg.vocab_size, (B, G), generator=g)
    return params, cache, tokens, positions, masks, windows, L


@pytest.mark.parametrize("cfg", [WINDOWED, WINDOWED_MOE],
                         ids=["dense", "experts"])
def test_window_rows_equal_steps_on_windowed_yarn_layers(cfg):
    """decode_window over G tokens gives the logits and the cache of G
    successive decode_step calls on a model with windowed and YaRN
    layers: each layer's frequencies, scale and mask are read as a
    step reads them; without window_mask it raises."""
    params, cache, tokens, positions, masks, windows, L = _window_case(cfg)
    assert any(not torch.equal(m, w) for m, w in zip(masks, windows))
    B, G = tokens.shape
    c_step = {k: t.clone() for k, t in cache.items()}
    steps = torch.stack([TL.decode_step(
        params, cfg, tokens[:, i], positions[:, i], c_step, L + i,
        masks[i], window_mask=windows[i])[0] for i in range(G)], 1)
    c_win = {k: t.clone() for k, t in cache.items()}
    got, _ = TL.decode_window(params, cfg, tokens, positions, c_win,
                              torch.full((B,), L), torch.stack(masks, 1),
                              window_mask=torch.stack(windows, 1))
    torch.testing.assert_close(got, steps, atol=1e-5, rtol=1e-5)
    for k in cache:
        torch.testing.assert_close(c_win[k], c_step[k], atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="window_mask"):
        TL.decode_window(params, cfg, tokens, positions, c_win,
                         torch.full((B,), L), torch.stack(masks, 1))


class _Tok:
    pad_token_id, eos_token_id = 0, 1


@pytest.mark.parametrize("draft", [2, 4])
def test_greedy_speculation_on_windowed_layers_equals_plain_greedy(draft):
    """The Generator's verification windows carry the windowed layers'
    mask: on a model with windowed and YaRN layers, greedy speculation
    emits plain greedy decode's tokens, past the window's width."""
    from sdag_tpu_torch.sdag.generate import Generator
    params = TL.init_decoder_params(torch.Generator().manual_seed(2),
                                    WINDOWED, device="cpu")
    g = torch.Generator().manual_seed(8)
    B, lp, max_new = 2, 16, 12
    ids = torch.randint(2, 8, (B, lp), generator=g, dtype=torch.int32)
    doc = torch.full((B, lp), -1, dtype=torch.int32)
    args = (ids, doc, torch.zeros_like(doc), torch.zeros(B, dtype=torch.int32),
            torch.tensor([lp, lp - 5], dtype=torch.int32), max_new)
    out = {}
    for d in (0, draft):
        gen = Generator(params, WINDOWED, _Tok(), temperature=0.0,
                        speculative_draft=d, device="cpu")
        out[d] = gen._generate(*args)
    assert torch.equal(out[0][0], out[draft][0])
    assert torch.equal(out[0][1], out[draft][1])
    assert int(out[0][1].min()) > WINDOWED.sliding_window


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_cache_write_patterns_agree(kv_dtype):
    """``_layer_kv``'s three index patterns write the same values and
    scales: the prompt's slice, a step's slot, a window's per-row bases."""
    cfg = TL.DecoderConfig.tiny()
    g = torch.Generator().manual_seed(6)
    B, n, S = 2, 3, 10
    k, v = (torch.randn(B, cfg.n_kv_heads, n, cfg.head_dim, generator=g)
            for _ in range(2))
    caches = [TL.make_kv_cache(cfg, B, S, device="cpu", kv_dtype=kv_dtype)
              for _ in range(3)]
    TL._layer_kv(caches[0], 1, k, v)
    for i in range(n):
        TL._layer_kv(caches[1], 1, k[:, :, i:i + 1], v[:, :, i:i + 1],
                     slot=torch.tensor([i]))
    TL._layer_kv(caches[2], 1, k, v, rows=torch.zeros(B, dtype=torch.long))
    names = ("k", "v", "k_scale", "v_scale") if kv_dtype == "int8" \
        else ("k", "v")
    layer = TL._layer_kv(caches[0], 1)
    assert (layer[2] is None) == (kv_dtype == "native")
    for name in names:
        assert caches[0][name][1, :, :, :n].abs().sum() > 0
        for c in caches[1:]:
            assert torch.equal(c[name], caches[0][name]), name
