"""Kernel K9 (``csrc/rms_norm.cu``), a layer's residual add and the
RMSNorm after it, on the CPU: ``add_rms_norm``'s plain path against the
composition the model ran before (``x + delta``, then ``rms_norm``) bit
for bit; an emulation of the kernel's fixed per-row sum order against the
plain composition and against itself at other row counts (row
independence); the model's forwards with the residual carried into the
next norm against the forwards as they were; gradients through the
autograd path; the kernel's plan; the CUDA wrapper's checks; the CPU
path's launch count.  The kernel itself runs only on the card
(``chip_smoke.py`` phase 15)."""

import dataclasses

import pytest
import torch

from sdag_tpu_torch import _build
from sdag_tpu_torch.models import llama as TL
from sdag_tpu_torch.ops import norm as TN
from sdag_tpu_torch.ops.attention import decode_attention

DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["f32", "bf16"]
# (rows shape, d): a decode step, a prefill (rows cut), Mellum2's width in
# both, qa_ckpt's
SHAPES = {"decode": ((8, 1), 4096), "prefill": ((2, 96), 4096),
          "mellum2_decode": ((8, 1), 2304), "mellum2_prefill": ((2, 96), 2304),
          "qa_ckpt": ((8, 40), 192)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Parallel test workers share the CPU; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(seed, dtype, lead, d, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(*lead, d, generator=g)).to(dtype)


def _gain(seed, dtype, d):
    g = torch.Generator().manual_seed(seed)
    return (1 + 0.1 * torch.randn(d, generator=g)).to(dtype)


def _old_rms_norm(x, w, eps):
    """``models/llama.py``'s rms_norm before K9."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


@pytest.mark.parametrize("with_delta", [True, False], ids=["add", "alone"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_plain_path_equals_the_old_composition(dtype, shape, with_delta):
    lead, d = SHAPES[shape]
    x = _rows(1, dtype, lead, d)
    delta = _rows(2, dtype, lead, d, 0.3) if with_delta else None
    w = _gain(3, dtype, d)
    s, h = TL.add_rms_norm(x, delta, w, 1e-5)
    want_s = x + delta if with_delta else x
    assert torch.equal(s, want_s) and s.dtype == dtype
    assert torch.equal(h, _old_rms_norm(want_s, w, 1e-5))
    assert torch.equal(TL.rms_norm(x, w, 1e-6), _old_rms_norm(x, w, 1e-6))


# ------------------------------------------------ emulation of K9's sums
def k9_emulate(x, delta, w, eps):
    """K9 on the CPU in its own order: s = x + delta in f32 rounded to the
    dtype; each square rounded to f32; thread t of ``k9_plan``'s nt adds
    the squares of its vectors v = t + i * nt in order (i, then a vector's
    elements), a warp's xor tree (16, 8, 4, 2, 1), the warps' totals in
    warp order; var = sum * f32(1 / d); h = (s * rsqrt(var + eps) rounded
    to the dtype) * w."""
    dtype, d = x.dtype, x.shape[-1]
    nt, vpt = TN.k9_plan(d, dtype)
    E = 16 // x.element_size()
    rows = x.reshape(-1, d)
    s = rows if delta is None else (
        rows.float() + delta.reshape(-1, d).float()).to(dtype)
    f = s.float()
    R = f.shape[0]
    sq = torch.zeros(R, vpt * nt * E)
    sq[:, :d] = f * f
    sq = sq.reshape(R, vpt, nt, E)
    acc = torch.zeros(R, nt)
    for i in range(vpt):
        for e in range(E):
            acc = acc + sq[:, i, :, e]
    acc = acc.reshape(R, nt // 32, 32)
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, :, lanes ^ off]
    total = acc[:, 0, 0]
    for wp in range(1, nt // 32):
        total = total + acc[:, wp, 0]
    inv_d = torch.tensor(1.0) / torch.tensor(float(d))
    r = torch.rsqrt(total * inv_d + eps)
    h = (f * r[:, None]).to(dtype) * w
    return s.reshape(x.shape), h.reshape(x.shape)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_emulated_order_matches_the_plain_composition(dtype, shape):
    """Only the row sum's order differs: s equal; in bf16 h is the gain
    times the plain composition's cast of s * r or a neighbour of it (one
    step either way), in f32 within 1e-6 relative."""
    lead, d = SHAPES[shape]
    x = _rows(4, dtype, lead, d)
    delta = _rows(5, dtype, lead, d, 0.3)
    w = _gain(6, dtype, d)
    s, h = k9_emulate(x, delta, w, 1e-5)
    want_s, want_h = TN.add_rms_norm_reference(x, delta, w, 1e-5)
    assert torch.equal(s, want_s)
    if dtype == torch.float32:
        err = (h - want_h).abs() / want_h.abs().clamp_min(1e-30)
        assert float(err.max()) <= 1e-6
        return
    s32 = s.float()
    bits = (s32 * torch.rsqrt((s32 * s32).mean(-1, keepdim=True) + 1e-5)
            ).to(dtype).view(torch.int16).int()
    line = torch.where(bits < 0, -(bits & 0x7FFF), bits)
    near = torch.zeros_like(h, dtype=torch.bool)
    for k in (-1, 0, 1):
        m = line + k
        cast = torch.where(m < 0, (-m) | 0x8000, m).to(torch.int16)
        near |= h == cast.view(dtype) * w
    assert bool(near.all())


@pytest.mark.parametrize("d", [4096, 2304, 192])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_emulated_order_is_row_independent(dtype, d):
    """A row alone, among a decode step's 8 rows and among a prefill's
    3,200 x 8 gives the same bits (the 25,600 rows at d 192: the order
    depends on d alone)."""
    x = _rows(7, dtype, (8,), d)
    delta = _rows(8, dtype, (8,), d, 0.3)
    w = _gain(9, dtype, d)
    s8, h8 = k9_emulate(x, delta, w, 1e-6)
    for j in (0, 5):
        s1, h1 = k9_emulate(x[j:j + 1], delta[j:j + 1], w, 1e-6)
        assert torch.equal(s1[0], s8[j]) and torch.equal(h1[0], h8[j])
    if d == 192:
        big_x = _rows(10, dtype, (3200 * 8,), d)
        big_d = _rows(11, dtype, (3200 * 8,), d, 0.3)
        big_x[12345], big_d[12345] = x[5], delta[5]
        sb, hb = k9_emulate(big_x.reshape(8, 3200, d),
                            big_d.reshape(8, 3200, d), w, 1e-6)
        assert torch.equal(sb.reshape(-1, d)[12345], s8[5])
        assert torch.equal(hb.reshape(-1, d)[12345], h8[5])


@pytest.mark.parametrize("d,dtype,plan", [
    (4096, torch.bfloat16, (256, 2)), (2304, torch.bfloat16, (160, 2)),
    (192, torch.float32, (64, 1)), (4096, torch.float32, (256, 4)),
    (192, torch.bfloat16, (32, 1)), (8, torch.bfloat16, (32, 1)),
    (16384, torch.bfloat16, (256, 8))])
def test_k9_plan(d, dtype, plan):
    nt, vpt = TN.k9_plan(d, dtype)
    assert (nt, vpt) == plan
    E = 16 // torch.empty((), dtype=dtype).element_size()
    assert nt % 32 == 0 and nt <= TN.K9_THREADS and nt * vpt * E >= d
    # no thread idles for a whole vector round where fewer would do
    assert (nt - 32) * vpt * E < d


# ---------------------------------------------------- the model's forwards
def _cfg(**over):
    return dataclasses.replace(TL.DecoderConfig.tiny(), tie_embeddings=False,
                               **over)


def _params(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = TL.init_decoder_params(gen, cfg, device="cpu")
    for layer in p["layers"]:
        for key in ("ln1", "ln2"):
            layer[key] = 1 + 0.1 * torch.randn(cfg.d_model, generator=gen)
    return p


def _ids(B, L, vocab, seed=1):
    return torch.randint(0, vocab, (B, L),
                         generator=torch.Generator().manual_seed(seed))


def _old_layer(layer, cfg, x, positions, doc_id, valid_len):
    """A dense layer as the port computed it before K9."""
    B, L, _ = x.shape
    h = _old_rms_norm(x, layer["ln1"], cfg.norm_eps)
    q, k, v = TL._project_qkv(layer["attn"], h, cfg)
    q = TL.rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
    k = TL.rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    o = TL.sdag_prefill_attention(q, k, v, doc_id, torch.zeros_like(doc_id),
                                  torch.zeros_like(valid_len),
                                  valid_len=valid_len)
    x = x + o.transpose(1, 2).reshape(B, L, -1) @ layer["attn"]["wo"]
    return x + TL._mlp(layer["mlp"], _old_rms_norm(x, layer["ln2"],
                                                   cfg.norm_eps)), (k, v)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_layer_forward_carried_residual_equals_the_whole_layer(dtype):
    """A layer's x + mlp_out is the old whole layer's output, and two
    layers with the residual carried into the next norm give the bits of
    two old whole layers."""
    cfg = _cfg(dtype=dtype)
    p = TL.params_from_numpy(_np_tree(_params(cfg)), cfg, "cpu")
    B, L = 2, 24
    x = TL._embed_rows(p["embed"], _ids(B, L, cfg.vocab_size), dtype)
    doc = torch.full((B, L), -1, dtype=torch.int32)
    z = torch.zeros((B, L), dtype=torch.int32)
    vl = torch.full((B,), L, dtype=torch.int32)
    pos = TL.positions_from_doc_id(doc)
    args = (pos, doc, z, z[:, 0], vl)
    whole, old = x, x
    for layer in p["layers"]:
        whole, out, _ = TL.layer_forward(layer, cfg, whole, *args)
        whole = whole + out
        old, _ = _old_layer(layer, cfg, old, pos, doc, vl)
        assert torch.equal(whole, old)
    carried, pending = x, None
    for layer in p["layers"]:
        carried, pending, _ = TL.layer_forward(layer, cfg, carried, *args,
                                               residual=pending)
    assert torch.equal(carried + pending, whole)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_prefill_and_decode_equal_the_old_forwards(dtype):
    """prefill, decode_step and decode_window on the CPU against the
    forwards as they were before K9 (the residual added in place, each
    norm apart), bit for bit."""
    cfg = _cfg(dtype=dtype)
    p = TL.params_from_numpy(_np_tree(_params(cfg)), cfg, "cpu")
    B, L, S = 2, 20, 24
    ids = _ids(B, L, cfg.vocab_size)
    logits, cache = TL.prefill(p, cfg, ids, cache_size=S)
    doc = torch.full((B, L), -1, dtype=torch.int32)
    vl = torch.full((B,), L, dtype=torch.int32)
    pos = TL.positions_from_doc_id(doc)
    x = TL._embed_rows(p["embed"], ids, dtype)
    old_cache = TL.make_kv_cache(cfg, B, S, device="cpu")
    for li, layer in enumerate(p["layers"]):
        x, (k, v) = _old_layer(layer, cfg, x, pos, doc, vl)
        old_cache["k"][li, :, :, :L] = k
        old_cache["v"][li, :, :, :L] = v
    want = (_old_rms_norm(x, p["final_norm"], cfg.norm_eps)
            @ p["lm_head"]).float()
    assert torch.equal(logits, want)
    assert torch.equal(cache["k"], old_cache["k"])
    # a decode step
    tok = torch.tensor([5, 9])
    step_pos = torch.tensor([L, L])
    mask = torch.zeros(B, S, dtype=torch.bool)
    mask[:, :L + 1] = True
    got, _ = TL.decode_step(p, cfg, tok, step_pos, cache, L, mask)
    freqs = TL.rope_freqs(cfg.head_dim // 2, cfg.rope_theta, None,
                          torch.device("cpu"))
    wi = torch.tensor([L])
    x = TL._embed_rows(p["embed"], tok, dtype)[:, None, :]
    for li, layer in enumerate(p["layers"]):
        h = _old_rms_norm(x, layer["ln1"], cfg.norm_eps)
        q, k, v = TL._project_qkv(layer["attn"], h, cfg)
        o = decode_attention(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                             old_cache["k"][li], old_cache["v"][li], mask,
                             wi, step_pos, freqs)
        x = x + o.reshape(B, 1, -1) @ layer["attn"]["wo"]
        x = x + TL._mlp(layer["mlp"], _old_rms_norm(x, layer["ln2"],
                                                    cfg.norm_eps))
    want = (_old_rms_norm(x, p["final_norm"], cfg.norm_eps)
            @ p["lm_head"])[:, 0].float()
    assert torch.equal(got, want)
    assert torch.equal(cache["k"], old_cache["k"])
    # a verification window of G = 3 over the step's cache
    G = 3
    win = torch.tensor([[5, 7, 11], [9, 2, 4]])
    win_pos = L + 1 + torch.arange(G)[None, :].expand(B, G)
    slots = torch.tensor([L + 1, L + 1])
    wmask = mask[:, None, :].repeat(1, G, 1)
    for g_ in range(G):
        wmask[:, g_, L + 1:L + 2 + g_] = True
    a_cache = {k: t.clone() for k, t in cache.items()}
    got, _ = TL.decode_window(p, cfg, win, win_pos, a_cache, slots, wmask)
    x = TL._embed_rows(p["embed"], win, dtype)
    for li, layer in enumerate(p["layers"]):
        h = _old_rms_norm(x, layer["ln1"], cfg.norm_eps)
        q, k, v = TL._project_qkv(layer["attn"], h, cfg)
        q = TL.rope(q, win_pos, cfg.rope_theta, cfg.rope_scaling)
        k = TL.rope(k, win_pos, cfg.rope_theta, cfg.rope_scaling)
        k_c, v_c, _, _ = TL._layer_kv(cache, li, k, v, rows=slots)
        o = TL.masked_decode_window_attention(q, k_c, v_c, wmask)
        x = x + o.transpose(1, 2).reshape(B, G, -1) @ layer["attn"]["wo"]
        x = x + TL._mlp(layer["mlp"], _old_rms_norm(x, layer["ln2"],
                                                    cfg.norm_eps))
    want = (_old_rms_norm(x, p["final_norm"], cfg.norm_eps)
            @ p["lm_head"]).float()
    assert torch.equal(got, want)
    assert torch.equal(a_cache["k"], cache["k"])


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return tree.float().numpy()


def test_gradients_equal_the_plain_composition():
    """Under autograd the plain composition runs: gradients of x, delta
    and w equal the old composition's, and a prefill's loss gradient with
    the residual carried equals the whole layers'."""
    x = _rows(12, torch.float32, (3, 5), 64).requires_grad_(True)
    delta = _rows(13, torch.float32, (3, 5), 64, 0.3).requires_grad_(True)
    w = _gain(14, torch.float32, 64).requires_grad_(True)
    up = _rows(15, torch.float32, (3, 5), 64)
    s, h = TL.add_rms_norm(x, delta, w, 1e-5)
    got = torch.autograd.grad(((h * up).sum() + (s * up).sum()),
                              [x, delta, w])
    s2 = x + delta
    want = torch.autograd.grad(((_old_rms_norm(s2, w, 1e-5) * up).sum()
                                + (s2 * up).sum()), [x, delta, w])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    cfg = _cfg()
    p = _params(cfg, seed=3)
    leaves = [p["final_norm"], p["layers"][0]["ln2"],
              p["layers"][1]["mlp"]["down"]]
    for t in leaves:
        t.requires_grad_(True)
    ids = _ids(2, 16, cfg.vocab_size, seed=4)
    logits, _ = TL.prefill(p, cfg, ids, with_cache=False, attn_impl="xla")
    got = torch.autograd.grad(logits.logsumexp(-1).sum(), leaves)
    x = TL._embed_rows(p["embed"], ids, cfg.dtype)
    doc = torch.full(ids.shape, -1, dtype=torch.int32)
    z = torch.zeros(ids.shape, dtype=torch.int32)
    vl = torch.full((2,), 16, dtype=torch.int32)
    for layer in p["layers"]:
        x, out, _ = TL.layer_forward(layer, cfg, x,
                                     TL.positions_from_doc_id(doc), doc, z,
                                     z[:, 0], vl, attn_impl="xla")
        x = x + out
    want_logits = (TL.rms_norm(x, p["final_norm"], cfg.norm_eps)
                   @ p["lm_head"]).float()
    assert torch.equal(logits, want_logits)
    want = torch.autograd.grad(want_logits.logsumexp(-1).sum(), leaves)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------------ the CUDA wrapper
def _good():
    return (_rows(16, torch.bfloat16, (4, 3), 64),
            _rows(17, torch.bfloat16, (4, 3), 64),
            _gain(18, torch.bfloat16, 64))


WRAPPER_FAULTS = {
    "cpu_tensors": (lambda x, d, w: (x, d, w), "CUDA"),
    "float16": (lambda x, d, w: (x.half(), d.half(), w.half()), "dtype"),
    "width_not_multiple_of_8": (lambda x, d, w: (
        x[..., :60].contiguous(), d[..., :60].contiguous(), w[:60]),
        "multiple of 8"),
    "too_wide": (lambda x, d, w: (
        torch.zeros(2, 32768, dtype=torch.bfloat16),
        torch.zeros(2, 32768, dtype=torch.bfloat16),
        torch.ones(32768, dtype=torch.bfloat16)), "too wide"),
    "x_rows_strided": (lambda x, d, w: (
        torch.zeros(4, 3, 128, dtype=torch.bfloat16)[..., ::2], d, w),
        "contiguous"),
    "delta_rows_strided": (lambda x, d, w: (
        x, d.transpose(0, 1).contiguous().transpose(0, 1), w),
        "contiguous"),
    "delta_dtype": (lambda x, d, w: (x, d.float(), w), "does not match"),
    "delta_shape": (lambda x, d, w: (x, d[:2], w), "does not match"),
    "w_dtype": (lambda x, d, w: (x, d, w.float()), "w "),
    "w_shape": (lambda x, d, w: (x, d, w[:32]), "w "),
}


@pytest.mark.parametrize("fault", sorted(WRAPPER_FAULTS))
def test_wrapper_checks_raise(fault):
    change, message = WRAPPER_FAULTS[fault]
    x, d, w = change(*_good())
    with pytest.raises(ValueError, match=message):
        TN.add_rms_norm_cuda(x, d, w, 1e-5)


def test_dispatch_refuses_another_device():
    x = torch.zeros(2, 64, device="meta")
    with pytest.raises(ValueError, match="no path for device"):
        TN.add_rms_norm(x, None, torch.ones(64, device="meta"), 1e-5)


def test_cpu_paths_do_not_launch():
    """The wrappers, a prefill, a decode step and a verification window on
    the CPU run the plain composition and count no K9 launch."""
    cfg = _cfg()
    p = _params(cfg)
    before = _build.LAUNCHES["rms_norm"]
    x, d, w = _good()
    TN.add_rms_norm(x, d, w, 1e-5)
    TN.rms_norm(x, w, 1e-5)
    _, cache = TL.prefill(p, cfg, _ids(2, 10, cfg.vocab_size), cache_size=16)
    mask = torch.ones(2, 16, dtype=torch.bool)
    TL.decode_step(p, cfg, torch.tensor([3, 4]), torch.tensor([10, 10]),
                   cache, 10, mask)
    TL.decode_window(p, cfg, torch.tensor([[3, 4], [5, 6]]),
                     torch.tensor([[11, 12], [11, 12]]), cache,
                     torch.tensor([11, 11]), mask[:, None].expand(2, 2, 16))
    assert _build.LAUNCHES["rms_norm"] == before
