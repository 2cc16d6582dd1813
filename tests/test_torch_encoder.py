"""The port's E5 encoder and K3's plain version against the JAX package on
the CPU: same numpy-seeded inputs through both, tolerances stated per test.
The JAX Pallas kernel runs in interpret mode, as tests/test_encoder.py runs
it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdag_tpu.models import e5 as je5
from sdag_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer
from sdag_tpu.ops import encoder_attention as jea
from sdag_tpu.sdag import knn as jknn
from sdag_tpu_torch.models import e5 as te5
from sdag_tpu_torch.models.tokenizer import ByteTokenizer
from sdag_tpu_torch.ops import encoder_attention as tea
from sdag_tpu_torch.sdag import knn as tknn

JCFG = je5.EncoderConfig.tiny()
TCFG = te5.EncoderConfig.tiny()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packed(rng, B, L, H, Dh):
    return rng.standard_normal((B, L, 3 * H * Dh)).astype(np.float32)


def _heads(qkv, H):
    """[B, L, 3d] packed -> q, k, v as [B, H, L, Dh]."""
    B, L, d3 = qkv.shape
    d = d3 // 3
    return [qkv[..., i * d:(i + 1) * d].reshape(B, L, H, d // H)
            .transpose(0, 2, 1, 3) for i in range(3)]


@pytest.mark.parametrize("H,Dh,L,vl", [
    (4, 32, 64, [64, 1, 0, 37]),          # tiny heads: full, 1, 0, ragged
    (2, 64, 128, [128, 53, 0, 1]),        # e5-large head dim
])
def test_k3_plain_version_matches_pallas_interpret(H, Dh, L, vl):
    """f32, |diff| <= 2e-5: same arithmetic, different summation order.
    A row of valid_len 0 is the mean of V (never NaN)."""
    rng = np.random.default_rng(11)
    qkv = _packed(rng, len(vl), L, H, Dh)
    vl = np.asarray(vl, np.int32)
    ref = np.asarray(jea.encoder_attention_fused_qkv(
        jnp.asarray(qkv), jnp.asarray(vl), n_heads=H, interpret=True))
    got = tea.encoder_attention_fused_qkv(
        torch.from_numpy(qkv), torch.from_numpy(vl), n_heads=H).numpy()
    assert got.shape == ref.shape == (len(vl), L, H * Dh)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    b0 = int(np.argmin(vl))
    v = _heads(qkv, H)[2]
    mean_v = v[b0].mean(1).reshape(-1)                    # [H * Dh]
    np.testing.assert_allclose(got[b0, 5], mean_v, rtol=1e-5, atol=1e-5)


def test_k3_plain_version_matches_jax_reference_on_valid_columns():
    """Both packages' references and the port's packed plain version agree
    within 2e-5 (f32) for every query row when valid_len >= 1."""
    rng = np.random.default_rng(7)
    B, H, L, Dh = 3, 4, 128, 32
    qkv = _packed(rng, B, L, H, Dh)
    vl = np.asarray([128, 53, 1], np.int32)
    q, k, v = _heads(qkv, H)
    jref = np.asarray(jea.encoder_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vl)))
    tref = tea.encoder_attention_reference(
        *(torch.from_numpy(np.ascontiguousarray(t)) for t in (q, k, v)),
        torch.from_numpy(vl)).numpy()
    np.testing.assert_allclose(tref, jref, rtol=2e-5, atol=2e-5)
    packed = tea.encoder_attention_fused_qkv(
        torch.from_numpy(qkv), torch.from_numpy(vl), n_heads=H).numpy()
    np.testing.assert_allclose(
        packed.reshape(B, L, H, Dh).transpose(0, 2, 1, 3), jref,
        rtol=2e-5, atol=2e-5)
    sep = tea.encoder_attention_fused(
        *(torch.from_numpy(np.ascontiguousarray(t.transpose(0, 2, 1, 3)))
          for t in (q, k, v)), torch.from_numpy(vl)).numpy()
    np.testing.assert_array_equal(sep, packed)


def test_k3_plain_version_bf16_scale_folds_into_q():
    """bf16, Dh=32 (scale not a power of two): the scale is rounded to
    bf16 and multiplied into q in bf16, as the Pallas body does.  Outputs
    agree within one bf16 step of |x| < 4 (1.6e-2)."""
    rng = np.random.default_rng(3)
    B, H, L, Dh = 2, 4, 64, 32
    qkv = _packed(rng, B, L, H, Dh)
    vl = np.asarray([64, 20], np.int32)
    ref = np.asarray(jea.encoder_attention_fused_qkv(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(vl), n_heads=H,
        interpret=True).astype(jnp.float32))
    got = tea.encoder_attention_fused_qkv(
        torch.from_numpy(qkv).to(torch.bfloat16), torch.from_numpy(vl),
        n_heads=H)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1.6e-2)


def test_k3_wrapper_raises_off_cpu_and_cuda():
    qkv = torch.zeros(1, 64, 3 * 128, device="meta")
    with pytest.raises(ValueError, match="no path for device"):
        tea.encoder_attention_fused_qkv(qkv, torch.zeros(1, device="meta"),
                                        n_heads=4)


# ------------------------------------------------------------- the encoder
@pytest.fixture(scope="module")
def jparams():
    return je5.init_encoder_params(jax.random.PRNGKey(1), JCFG)


def _ids_mask():
    rng = np.random.default_rng(5)
    ids = rng.integers(1, JCFG.vocab_size, size=(5, 64)).astype(np.int32)
    mask = np.zeros((5, 64), np.int32)
    for i, n in enumerate([64, 3, 17, 50, 1]):
        mask[i, :n] = 1
    return ids, mask


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
def test_encoder_forward_plain_matches_jax(jparams, gelu):
    """Plain params, plain attention; f32 embeddings within 3e-5."""
    ids, mask = _ids_mask()
    ref = np.asarray(je5.encoder_forward(jparams, JCFG, ids, mask,
                                         gelu=gelu))
    params = te5.encoder_params_from_numpy(
        jax.tree.map(np.asarray, jparams), TCFG, device="cpu")
    got = te5.encoder_forward(params, TCFG, torch.from_numpy(ids),
                              torch.from_numpy(mask), gelu=gelu).numpy()
    assert got.shape == (5, TCFG.d_model) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("source", ["jax_fused_tree", "port_fuse"])
def test_encoder_forward_fused_qkv_matches_jax(jparams, source):
    """Fused-QKV params + fused attention (JAX: the Pallas kernel in
    interpret mode, patched in inside this test only; port: K3's plain
    version) within 3e-5; the fused tree comes across either through
    encoder_params_from_numpy or through the port's own fuse_qkv_params."""
    ids, mask = _ids_mask()
    orig = jea.encoder_attention_fused_qkv
    try:
        jea.encoder_attention_fused_qkv = \
            lambda qkv, vl, n_heads: orig(qkv, vl, n_heads=n_heads,
                                          interpret=True)
        ref = np.asarray(je5.encoder_forward(
            je5.fuse_qkv_params(jparams), JCFG, ids, mask,
            fused_attention=True))
    finally:
        jea.encoder_attention_fused_qkv = orig
    if source == "jax_fused_tree":
        params = te5.encoder_params_from_numpy(
            jax.tree.map(np.asarray, je5.fuse_qkv_params(jparams)), TCFG,
            device="cpu")
    else:
        params = te5.fuse_qkv_params(te5.encoder_params_from_numpy(
            jax.tree.map(np.asarray, jparams), TCFG, device="cpu"))
    assert "wqkv" in params["layers"][0]["attn"]
    assert "wq" not in params["layers"][0]["attn"]
    got = te5.encoder_forward(params, TCFG, torch.from_numpy(ids),
                              torch.from_numpy(mask),
                              fused_attention=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=3e-5, atol=3e-5)
    # split fused params through the plain attention give the same
    plain = te5.encoder_forward(params, TCFG, torch.from_numpy(ids),
                                torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(plain, got, rtol=3e-5, atol=3e-5)


class _ClsSepTokenizer(ByteTokenizer):
    cls_token_id = 7
    sep_token_id = 9


class _JaxClsSepTokenizer(JaxByteTokenizer):
    cls_token_id = 7
    sep_token_id = 9


@pytest.mark.parametrize("fused", [False, True])
def test_e5_encoder_encode_matches_jax(jparams, fused):
    """encode(): prefixes, bucketed padding, batching; f32 within 1e-4
    (the JAX tests' own padding-invariance tolerance)."""
    texts = ["hello world", "", "x" * 300, "the cat sat on the mat"]
    jenc = je5.E5Encoder(jparams, JCFG, JaxByteTokenizer(),
                         model_name="tiny-e5", fused=False)
    tenc = te5.E5Encoder(
        te5.encoder_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      TCFG, device="cpu"),
        TCFG, ByteTokenizer(), model_name="tiny-e5", fused=fused,
        device="cpu")
    assert tenc.gelu == "erf" and tenc.dim == jenc.dim
    for kind in ("query", "passage", "raw"):
        ref = jenc.encode(texts, kind=kind, batch_size=3)
        got = tenc.encode(texts, kind=kind, batch_size=3)
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert tenc.encode([], kind="query").shape == (0, TCFG.d_model)
    assert tenc._prefix(["a"], "query") == ["query: a"]
    assert tenc._prefix(["a"], "raw") == ["a"]
    plain = te5.E5Encoder(tenc.params if not fused else
                          te5.encoder_params_from_numpy(
                              jax.tree.map(np.asarray, jparams), TCFG,
                              device="cpu"),
                          TCFG, ByteTokenizer(), model_name="bert",
                          fused=False, device="cpu")
    assert plain._prefix(["a"], "query") == ["a"]


def test_e5_encoder_tokenize_cls_sep_rule_matches_jax(jparams):
    """[CLS] body[:max-2] [SEP], padded to a multiple of 64 capped at
    max_length: ids and masks equal the JAX package's."""
    texts = ["short", "y" * 700, ""]
    jenc = je5.E5Encoder(jparams, JCFG, _JaxClsSepTokenizer(),
                         model_name="e5", max_length=100, fused=False)
    tenc = te5.E5Encoder({"layers": []}, TCFG, _ClsSepTokenizer(),
                         model_name="e5", max_length=100, fused=False,
                         device="cpu")
    jids, jmask = jenc._tokenize(texts)
    tids, tmask = tenc._tokenize(texts)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tmask, jmask)
    assert tids.shape == (3, 100) and tids[1, 0] == 7 and tids[1, 99] == 9
    assert tids[2, :2].tolist() == [7, 9] and tmask[2].sum() == 2
    # without cls/sep: plain truncation, multiple-of-64 padding
    ids, mask = te5.E5Encoder({"layers": []}, TCFG, ByteTokenizer(),
                              device="cpu")._tokenize(["abc", "z" * 70])
    assert ids.shape == (2, 128) and mask.sum(1).tolist() == [3, 70]


def test_e5_encoder_defaults_decided_for_the_card():
    """fused=None means the plain attention on the CPU (K3 on CUDA);
    gelu=None means erf; an unknown gelu raises."""
    enc = te5.E5Encoder({"layers": []}, TCFG, ByteTokenizer(), device="cpu")
    assert enc.fused is False and enc.gelu == "erf"
    with pytest.raises(ValueError, match="gelu"):
        te5.E5Encoder({"layers": []}, TCFG, ByteTokenizer(), gelu="relu",
                      device="cpu")


def test_init_encoder_params_shapes_and_geometry():
    gen = torch.Generator().manual_seed(0)
    p = te5.init_encoder_params(gen, TCFG, device="cpu")
    j = je5.init_encoder_params(jax.random.PRNGKey(0), JCFG)
    shapes = jax.tree.map(lambda a: tuple(a.shape), j)
    got = jax.tree.map(lambda a: tuple(a.shape), p)
    assert got == shapes
    big = te5.EncoderConfig.e5_large_v2()
    jbig = je5.EncoderConfig.e5_large_v2()
    assert (big.vocab_size, big.d_model, big.n_layers, big.n_heads,
            big.d_ff, big.max_position, big.head_dim) == (
        jbig.vocab_size, jbig.d_model, jbig.n_layers, jbig.n_heads,
        jbig.d_ff, jbig.max_position, jbig.head_dim)
    assert big.dtype == torch.bfloat16
    w = p["layers"][0]["attn"]["wq"].float()
    assert abs(float(w.std()) - TCFG.d_model ** -0.5) < 0.01


# --------------------------------------------------------------------- knn
def test_knn_from_embeddings_matches_jax():
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((9, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    emb[4] = emb[1]                      # a tie: resolves to the lower index
    for k in (0, 1, 3, 20):
        assert tknn.knn_from_embeddings(emb, k) == \
            jknn.knn_from_embeddings(emb, k)
    assert tknn.knn_from_embeddings(emb[:1], 2) == [[]]


class _StubEncoder:
    def __init__(self):
        self.calls = 0

    def encode(self, texts, kind="passage", batch_size=32):
        self.calls += 1
        out = np.zeros((len(texts), 8), np.float32)
        for i, t in enumerate(texts):
            r = np.random.default_rng(abs(hash(t)) % (2 ** 31))
            out[i] = r.standard_normal(8)
        return out / np.linalg.norm(out, axis=1, keepdims=True)


def test_compute_doc_knn_batch_matches_jax_and_encodes_once():
    docs_batch = [["a b", "", "c d", "e f", "  "], ["only"], [],
                  ["p", "q", "r"]]
    enc = _StubEncoder()
    got = tknn.compute_doc_knn_for_docs_batch(enc, docs_batch, 2)
    assert enc.calls == 1
    assert got == jknn.compute_doc_knn_for_docs_batch(_StubEncoder(),
                                                      docs_batch, 2)
    assert got[0][1] == [] and got[0][4] == [] and got[1] == [[]]
    assert all(1 not in row and 4 not in row for row in got[0])
    assert tknn.compute_doc_knn_for_docs(enc, docs_batch[3], 1) == \
        jknn.compute_doc_knn_for_docs(_StubEncoder(), docs_batch[3], 1)
    assert tknn.compute_doc_knn_for_docs_batch(enc, docs_batch, 0) == \
        [[[] for _ in d] for d in docs_batch]
