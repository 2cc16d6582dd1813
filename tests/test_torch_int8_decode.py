"""Weight-only int8 decoder and the int8 KV cache: the port against the JAX
package on the CPU.  The quantized tree bit for bit (after the layout
transpose to [out, in]); K6's plain version against JAX's ``_mm`` in f32
and bf16; the embedding gather and both unembeds; prefill, decode_step and
decode_window on an int8 tree carried from JAX's, over native and int8
caches, against JAX called eagerly (the int8 KV scales of a jitted JAX
function are one rounding away: XLA turns ``/ 127`` into ``* (1/127)``);
the int8 and window decode attentions; and greedy Generator tokens on the
committed qa_ckpt with int8 weights and with the int8 cache."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sdag_tpu.models import llama as JL
from sdag_tpu.models.native_ckpt import load_decoder as jax_load_decoder
from sdag_tpu.ops import attention as JA
from sdag_tpu.sdag.generate import Generator as JaxGenerator
from sdag_tpu_torch.models import llama as TL
from sdag_tpu_torch.models.tokenizer import load_tokenizer
from sdag_tpu_torch.ops import attention as TA
from sdag_tpu_torch.ops.int8_matmul import (int8_matmul,
                                            int8_matmul_reference)
from sdag_tpu_torch.sdag.generate import Generator
from sdag_tpu_torch.sdag.spans import (build_plain_chat_ids,
                                       build_rag_prompt_plan)
from sdag_tpu_torch.utils import prompts
from sdag_tpu_torch.utils.synth_qa import (fact_doc, fact_query, load_world,
                                           malicious_doc)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "experiments", "data", "qa_ckpt")
ATOL = 1e-4          # f32 forwards (as tests/test_torch_llama.py)

needs_ckpt = pytest.mark.skipif(
    not os.path.isfile(os.path.join(CKPT, "params.npz")),
    reason="trained qa_ckpt not present")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Parallel test workers share the CPU; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg, dtype=torch.float32):
    return TL.DecoderConfig(
        vocab_size=jcfg.vocab_size, d_model=jcfg.d_model,
        n_layers=jcfg.n_layers, n_heads=jcfg.n_heads,
        n_kv_heads=jcfg.n_kv_heads, d_ff=jcfg.d_ff,
        rope_theta=jcfg.rope_theta, norm_eps=jcfg.norm_eps, dtype=dtype,
        tie_embeddings=jcfg.tie_embeddings, rope_scaling=jcfg.rope_scaling)


def _jax_cfg(tied: bool, dtype=jnp.float32):
    return JL.DecoderConfig(vocab_size=384, d_model=64, n_layers=2,
                            n_heads=4, n_kv_heads=2, d_ff=160, dtype=dtype,
                            tie_embeddings=tied)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=["tied", "untied"])
def model(request):
    """A random GQA decoder (f32), its JAX int8 tree, and the port's tree
    carried across from it."""
    jcfg = _jax_cfg(request.param == "tied")
    jparams = JL.init_decoder_params(jax.random.PRNGKey(5), jcfg)
    jq = JL.quantize_decoder_params_int8(jparams)
    tcfg = _port_cfg(jcfg)
    tq = TL.params_from_numpy(_np_tree(jq), tcfg, device="cpu")
    return jcfg, jq, tcfg, tq, jparams


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tied", [True, False])
def test_quantized_tree_is_jax_bit_for_bit(dtype, tied):
    """The port quantizes its float tree to JAX's values and scales,
    exactly; int8 matrices are JAX's transposed to [out, in] (the
    embedding stays [V, d]), norm gains stay float; carrying JAX's int8
    tree across gives the same tree."""
    jcfg = _jax_cfg(tied, getattr(jnp, dtype))
    jparams = JL.init_decoder_params(jax.random.PRNGKey(2), jcfg)
    jq = _np_tree(JL.quantize_decoder_params_int8(jparams))
    tcfg = _port_cfg(jcfg, getattr(torch, dtype))
    mine = TL.quantize_decoder_params_int8(
        TL.params_from_numpy(_np_tree(jparams), tcfg, device="cpu"))
    carried = TL.params_from_numpy(jq, tcfg, device="cpu")
    ref = dict(_leaves(jq))
    got = dict(_leaves(mine))
    assert set(got) == set(ref) == set(dict(_leaves(carried)))
    for path, leaf in got.items():
        r = ref[path]
        if path[-1] == "w":
            assert leaf.dtype == torch.int8
            expect = r if path[0] == "embed" else r.T
            np.testing.assert_array_equal(leaf.numpy(), expect)
            assert leaf.is_contiguous()
        elif path[-1] == "s":
            assert leaf.dtype == torch.float32
            np.testing.assert_array_equal(leaf.numpy(), r)
        else:                                   # norm gains
            assert leaf.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      dict(_leaves(carried))[path]
                                      .float().numpy())


def test_quantize_consume_frees_the_float_tree():
    cfg = TL.DecoderConfig.tiny()
    params = TL.init_decoder_params(torch.Generator().manual_seed(1), cfg,
                                    device="cpu")
    ref = TL.quantize_decoder_params_int8(params)
    got = TL.quantize_decoder_params_int8(params, consume=True)
    assert params["embed"] is None
    assert all(v is None for layer in params["layers"]
               for part in ("attn", "mlp") for v in layer[part].values())
    for (path, a), (_, b) in zip(_leaves(ref), _leaves(got)):
        assert torch.equal(a, b), path


def _bf16_ulp(y):
    """One bf16 unit in the last place of each |y| (2^(e - 7))."""
    e = np.floor(np.log2(np.maximum(np.abs(y), 1e-30)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("rows", [1, 8, 40])
def test_int8_matmul_reference_matches_jax_mm(rows):
    """f32 within 1e-6 of each row's largest |y| (the sums run in another
    order); bf16 within one bf16 ulp of the output,
    with the scale cast to bf16 before the multiply as JAX does (the f32
    scale gives other bf16 outputs)."""
    rng = np.random.default_rng(rows)
    K, N = 96, 80
    x = rng.standard_normal((rows, K)).astype(np.float32)
    w = rng.integers(-127, 128, size=(N, K)).astype(np.int8)
    s = (rng.random(N) * 0.02 + 1e-3).astype(np.float32)
    jw = {"w": jnp.asarray(w.T), "s": jnp.asarray(s)}
    ref = np.asarray(JL._mm(jnp.asarray(x), jw))
    out = int8_matmul_reference(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(s)).numpy()
    row_max = np.abs(ref).max(1, keepdims=True)
    assert (np.abs(out - ref) <= 1e-6 * row_max).all()
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    refb = np.asarray(JL._mm(xb, jw).astype(jnp.float32))
    tx = torch.from_numpy(x).bfloat16()
    outb = int8_matmul(tx, torch.from_numpy(w), torch.from_numpy(s))
    assert outb.dtype == torch.bfloat16 and outb.shape == (rows, N)
    diff = np.abs(outb.float().numpy() - refb)
    assert (diff <= _bf16_ulp(refb) * 1.0001).all(), diff.max()
    uncast = ((tx.float() @ torch.from_numpy(w).float().T).bfloat16()
              .float() * torch.from_numpy(s)).bfloat16().float().numpy()
    assert (np.abs(outb.float().numpy() - refb) <= np.abs(uncast - refb)
            ).all()
    if rows >= 8:
        assert (uncast != refb).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_rows_and_unembeds_match_jax(model, dtype):
    jcfg, jq, tcfg, tq, _ = model
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ids = np.asarray([[0, 5, 383], [7, 7, 100]], np.int32)
    ref = np.asarray(JL._embed_rows(jq["embed"], jnp.asarray(ids), jd)
                     .astype(jnp.float32))
    out = TL._embed_rows(tq["embed"], torch.from_numpy(ids), td)
    assert out.dtype == td
    np.testing.assert_array_equal(out.float().numpy(), ref)
    x = np.random.default_rng(3).standard_normal((2, 3, 64)).astype(
        np.float32)
    jcfg_d = JL.DecoderConfig(**{**jcfg.__dict__, "dtype": jd})
    refu = np.asarray(JL._unembed(jq, jcfg_d, jnp.asarray(x).astype(jd))
                      .astype(jnp.float32))
    outu = TL._unembed(tq, tcfg, torch.from_numpy(x).to(td)).float().numpy()
    if dtype == "float32":
        row_max = np.abs(refu).max(-1, keepdims=True)
        assert (np.abs(outu - refu) <= 1e-6 * row_max).all()
    else:
        assert (np.abs(outu - refu) <= _bf16_ulp(refu) * 1.0001).all()


def _batch(vocab, L=48):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, size=(2, L)).astype(np.int32)
    vl = np.asarray([L, 31], np.int32)
    return ids, vl


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_prefill_decode_step_and_window_match_jax(model, kv):
    """On the int8 tree carried from JAX's: prefill logits and cache,
    one decode_step, then one 4-token decode_window with per-row bases,
    against JAX eagerly; int8 cache values within one step of JAX's
    (ties at a rounding boundary), scales within 1e-5 relative."""
    jcfg, jq, tcfg, tq, _ = model
    ids, vl = _batch(jcfg.vocab_size)
    L, S = ids.shape[1], ids.shape[1] + 12
    t = torch.from_numpy
    jlog, jc = JL.prefill(jq, jcfg, jnp.asarray(ids),
                          valid_len=jnp.asarray(vl), cache_size=S,
                          kv_dtype=kv)
    tlog, tc = TL.prefill(tq, tcfg, t(ids), valid_len=t(vl), cache_size=S,
                          kv_dtype=kv)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=0)

    def check_cache(jcache, tcache):
        for key in ("k", "v"):
            a, b = tcache[key].numpy(), np.asarray(jcache[key])
            if kv == "int8":
                assert a.dtype == np.int8
                d = np.abs(a.astype(np.int32) - b.astype(np.int32))
                assert d.max() <= 1 and (d == 0).mean() > 0.999
                np.testing.assert_allclose(
                    tcache[f"{key}_scale"].numpy(),
                    np.asarray(jcache[f"{key}_scale"]), rtol=1e-5, atol=0)
            else:
                np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    check_cache(jc, tc)

    tok = np.asarray([5, 9], np.int32)
    pos = np.asarray([L, 31], np.int32)
    mask = np.zeros((2, S), bool)
    mask[0, :L] = True
    mask[1, :31] = True
    mask[:, L] = True
    jd, jc = JL.decode_step(jq, jcfg, jnp.asarray(tok), jnp.asarray(pos),
                            jc, L, jnp.asarray(mask))
    td, tc = TL.decode_step(tq, tcfg, t(tok), t(pos), tc, L, t(mask))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL,
                               rtol=0)
    check_cache(jc, tc)

    G = 4
    w = np.asarray([[9, 1, 2, 3], [4, 4, 8, 1]], np.int32)
    base = np.asarray([L + 1, L + 3], np.int32)   # rows write apart
    wpos = pos[:, None] + 1 + np.arange(G, dtype=np.int32)[None]
    slot = np.arange(S)[None, None, :]
    hist = mask.copy()
    hist[1, L + 1:L + 3] = True
    m3 = hist[:, None, :] | ((slot >= base[:, None, None])
                             & (slot <= base[:, None, None]
                                + np.arange(G)[None, :, None]))
    jw, jc = JL.decode_window(jq, jcfg, jnp.asarray(w), jnp.asarray(wpos),
                              jc, jnp.asarray(base), jnp.asarray(m3))
    tw, tc = TL.decode_window(tq, tcfg, t(w), t(wpos), tc, t(base), t(m3))
    assert tw.shape == (2, G, jcfg.vocab_size)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL,
                               rtol=0)
    check_cache(jc, tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep", [1, 4])
def test_int8_and_window_decode_attention_match_jax(dtype, rep):
    """Single-token int8, window native and window int8 attention, GQA
    groups of 1 and 4, against the JAX ops on the same inputs: f32 within
    1e-5, bf16 within 2e-2 (both round the probabilities and the output
    to bf16, the sums in another order)."""
    rng = np.random.default_rng(11 + rep)
    B, Hkv, S, Dh, G = 2, 2, 40, 32, 3
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    q1 = rng.standard_normal((B, Hkv * rep, Dh)).astype(np.float32)
    qg = rng.standard_normal((B, Hkv * rep, G, Dh)).astype(np.float32)
    kf = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    vf = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    k8 = rng.integers(-127, 128, size=(B, Hkv, S, Dh)).astype(np.int8)
    v8 = rng.integers(-127, 128, size=(B, Hkv, S, Dh)).astype(np.int8)
    ks = (rng.random((B, Hkv, S)) * 0.02).astype(np.float32)
    vs = (rng.random((B, Hkv, S)) * 0.02).astype(np.float32)
    m1 = rng.random((B, S)) < 0.7
    m1[:, 0] = True
    m3 = rng.random((B, G, S)) < 0.7
    m3[:, :, 0] = True
    J = lambda a, cast=True: jnp.asarray(a).astype(jd) if cast \
        else jnp.asarray(a)  # noqa: E731
    T = lambda a, cast=True: torch.from_numpy(a).to(td) if cast \
        else torch.from_numpy(a)  # noqa: E731
    cases = [
        (JA.masked_decode_attention_int8(J(q1), J(k8, 0), J(v8, 0),
                                         J(ks, 0), J(vs, 0), J(m1, 0)),
         TA.masked_decode_attention_int8(T(q1), T(k8, 0), T(v8, 0),
                                         T(ks, 0), T(vs, 0), T(m1, 0))),
        (JA.masked_decode_window_attention(J(qg), J(kf), J(vf), J(m3, 0)),
         TA.masked_decode_window_attention(T(qg), T(kf), T(vf), T(m3, 0))),
        (JA.masked_decode_window_attention_int8(J(qg), J(k8, 0), J(v8, 0),
                                                J(ks, 0), J(vs, 0),
                                                J(m3, 0)),
         TA.masked_decode_window_attention_int8(T(qg), T(k8, 0), T(v8, 0),
                                                T(ks, 0), T(vs, 0),
                                                T(m3, 0))),
    ]
    for ref, out in cases:
        assert out.dtype == td and tuple(out.shape) == tuple(ref.shape)
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   atol=tol, rtol=0)


def test_int8_kv_quantizer_matches_jax_eagerly():
    x = np.random.default_rng(4).standard_normal((2, 3, 7, 32)).astype(
        np.float32)
    jq, js = JA.quantize_kv_heads_int8(jnp.asarray(x))
    tq, ts = TA.quantize_kv_heads_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ------------------------------------------------------------ Generator
@pytest.fixture(scope="module")
def qa():
    """qa_ckpt, five prompts (ISO plans and NO-ISO chats) under a bucket
    of 8, the JAX float tree and its int8 tree, and the port's copies."""
    world = load_world(os.path.join(CKPT, "world.json"))
    tok = load_tokenizer(CKPT)
    facts = world.facts_for(world.eval_entities)[10:15]
    others = world.facts_for(world.train_entities)
    plans, plain = [], []
    for i, f in enumerate(facts):
        docs = [fact_doc(g) for g in others[2 * i:2 * i + 2 + i % 3]]
        docs.insert(i % 2, fact_doc(f))
        if i % 2:
            docs.insert(0, malicious_doc(f, "bodiku", variant=i))
        plans.append(build_rag_prompt_plan(tok, fact_query(f), docs))
        user = prompts.USER_RAG_PROMPT.format(
            query=fact_query(f), docs_text=prompts.render_docs_text(docs))
        plain.append(build_plain_chat_ids(tok, prompts.SYSTEM_PROMPT_RAG,
                                          user))
    jparams, jcfg = jax_load_decoder(CKPT)
    jq = JL.quantize_decoder_params_int8(jparams)
    tcfg = _port_cfg(jcfg)
    trees = {"native": (jparams, TL.params_from_numpy(
        _np_tree(jparams), tcfg, device="cpu")),
        "int8": (jq, TL.params_from_numpy(_np_tree(jq), tcfg,
                                          device="cpu"))}
    return tok, jcfg, tcfg, trees, plans, plain


@needs_ckpt
@pytest.mark.parametrize("mode", ["iso", "noiso"])
@pytest.mark.parametrize("weights,kv", [("int8", "native"),
                                        ("native", "int8")])
def test_generator_greedy_tokens_equal_jax(qa, weights, kv, mode):
    """Greedy answers of the port's Generator equal the JAX Generator's,
    ISO and NO-ISO, with int8 weights and with the int8 cache (both at
    once: the pipeline test of tests/test_torch_speculative.py)."""
    tok, jcfg, tcfg, trees, plans, plain = qa
    jp, tp = trees[weights]
    jgen = JaxGenerator(jp, jcfg, tok, temperature=0.0, batch_bucket=8,
                        kv_cache_dtype=kv)
    tgen = Generator(tp, tcfg, tok, temperature=0.0, batch_bucket=8,
                     kv_cache_dtype=kv, device="cpu")
    if mode == "iso":
        ref = jgen.generate_plans(plans, max_new_tokens=16)
        assert tgen.generate_plans(plans, max_new_tokens=16) == ref
    else:
        ref = jgen.generate_ids(plain, max_new_tokens=16)
        assert tgen.generate_ids(plain, max_new_tokens=16) == ref
    assert sum(bool(a) for a in ref) >= 4


def test_k6_launch_plan_and_cpu_dispatch():
    """K6's bf16 plan at the 8B products: 4 warps a block (8 where 4-warp
    blocks would overfill a wave unsplit, fewer where the most splits
    would leave an SM without a block), K split across blocks up to one
    wave of two blocks an SM and at most 8 splits (one thread block
    cluster), each split at least one 256-wide chunk, no split empty; the
    plan ignores the row count.  On the CPU the wrapper is the plain
    version, the kernel's entry refuses CPU tensors."""
    from sdag_tpu_torch.ops.int8_matmul import (K6_MAX_CLUSTER,
                                                int8_matmul_cuda, k6_geometry,
                                                k6_plan)
    shapes = ((1024, 4096), (4096, 4096), (14336, 4096), (4096, 14336),
              (128256, 4096), (512, 192))
    assert [k6_plan(n, k, 132) for n, k in shapes] == \
        [(2, 8), (4, 4), (4, 1), (4, 4), (8, 1), (1, 1)]
    for n, k in shapes:
        warps, splits = k6_plan(n, k, 132)
        kblocks = -(-k // 64)
        per = -(-kblocks // splits)
        blocks = -(-n // (16 * warps))
        assert per >= min(4, kblocks) and (splits - 1) * per < kblocks
        assert splits <= K6_MAX_CLUSTER == 8
        assert blocks * splits <= 2 * 132 or splits == 1
        for m in (1, 8, 40, 128):
            geo = k6_geometry(m, n, k, torch.bfloat16, 132)
            assert (geo["warps"], geo["splits"], geo["cluster"]) == \
                (warps, splits, splits)
    x = torch.randn(3, 32)
    w = torch.randint(-127, 128, (16, 32), dtype=torch.int8)
    s = torch.rand(16)
    assert torch.equal(int8_matmul(x, w, s), int8_matmul_reference(x, w, s))
    with pytest.raises(ValueError, match="not on CUDA"):
        int8_matmul_cuda(x, w, s)
