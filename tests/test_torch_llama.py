"""Port decoder vs the JAX decoder (f32, atol 1e-4): prefill logits, KV
cache and decode_step logits, on the committed qa_ckpt_v4 checkpoint and a
random 2-layer GQA config with Dh=128 and llama3 RoPE scaling."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sdag_tpu.models import llama as JL
from sdag_tpu.models.native_ckpt import load_decoder as jax_load_decoder
from sdag_tpu.sdag.mask import BlockLayout, layout_to_metadata
from sdag_tpu_torch.models import llama as TL
from sdag_tpu_torch.models.native_ckpt import load_decoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT_V4 = os.path.join(REPO, "experiments", "data", "qa_ckpt_v4")
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Parallel test workers share the CPU; torch's default of one thread
    per core oversubscribes it (measured 4.5x slower under contention)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg):
    return TL.DecoderConfig(
        vocab_size=jcfg.vocab_size, d_model=jcfg.d_model,
        n_layers=jcfg.n_layers, n_heads=jcfg.n_heads,
        n_kv_heads=jcfg.n_kv_heads, d_ff=jcfg.d_ff,
        rope_theta=jcfg.rope_theta, norm_eps=jcfg.norm_eps,
        dtype=torch.float32, tie_embeddings=jcfg.tie_embeddings,
        rope_scaling=jcfg.rope_scaling)


def _v4():
    jparams, jcfg = jax_load_decoder(CKPT_V4)
    tparams = TL.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   _port_cfg(jcfg), device="cpu")
    return jparams, jcfg, tparams, _port_cfg(jcfg)


def _gqa128():
    jcfg = JL.DecoderConfig(vocab_size=512, d_model=256, n_layers=2,
                            n_heads=2, n_kv_heads=1, d_ff=384,
                            rope_scaling=(8.0, 1.0, 4.0, 8192))
    jparams = JL.init_decoder_params(jax.random.PRNGKey(3), jcfg)
    tcfg = _port_cfg(jcfg)
    return jparams, jcfg, TL.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu"), tcfg


MODELS = {"qa_ckpt_v4": _v4, "gqa_dh128_llama3_rope": _gqa128}


def _batch(vocab, L=256):
    """Two rows: a doc layout with neighbor bits and holes, and a shorter
    plain row; right-padded ids."""
    rng = np.random.default_rng(0)
    lay = BlockLayout(220, 30, ((30, 80), (86, 150), (150, 200)), 200,
                      hole_spans=((80, 86),))
    d0, n0, s0 = layout_to_metadata(lay, [[1], [0, 2], []], pad_to=L)
    doc_id = np.stack([d0, np.full(L, -1, np.int32)])
    nbr = np.stack([n0, np.zeros(L, np.int32)])
    sul = np.asarray([s0, 0], np.int32)
    vl = np.asarray([220, 170], np.int32)
    ids = rng.integers(0, min(vocab, 300), size=(2, L)).astype(np.int32)
    return ids, doc_id, nbr, sul, vl


@pytest.mark.parametrize("model", sorted(MODELS))
def test_prefill_logits_and_cache_match_jax(model):
    if model == "qa_ckpt_v4" and not os.path.isfile(
            os.path.join(CKPT_V4, "params.npz")):
        pytest.skip("qa_ckpt_v4 not present")
    jparams, jcfg, tparams, tcfg = MODELS[model]()
    ids, doc_id, nbr, sul, vl = _batch(jcfg.vocab_size)
    L = ids.shape[1]
    jlog, jcache = JL.prefill(jparams, jcfg, jnp.asarray(ids),
                              doc_id=jnp.asarray(doc_id),
                              nbr_bits=jnp.asarray(nbr),
                              sys_user_len=jnp.asarray(sul),
                              valid_len=jnp.asarray(vl), cache_size=L + 8)
    t = torch.from_numpy
    tlog, tcache = TL.prefill(tparams, tcfg, t(ids), doc_id=t(doc_id),
                              nbr_bits=t(nbr), sys_user_len=t(sul),
                              valid_len=t(vl), cache_size=L + 8)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=ATOL,
                                   rtol=0)

    # one decode step on top of the prefilled cache
    tok = np.asarray([5, 9], np.int32)
    pos = np.asarray([213, 170], np.int32)   # active-token positions
    mask = np.zeros((2, L + 8), bool)
    mask[0, :220] = doc_id[0, :220] != -2
    mask[1, :170] = True
    mask[:, L] = True
    jd, jc2 = JL.decode_step(jparams, jcfg, jnp.asarray(tok),
                             jnp.asarray(pos), jcache, L, jnp.asarray(mask))
    td, tc2 = TL.decode_step(tparams, tcfg, t(tok), t(pos), tcache, L,
                             t(mask))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tc2["k"].numpy(), np.asarray(jc2["k"]),
                               atol=ATOL, rtol=0)


def test_prefill_last_only_and_causal_default_match_jax():
    jparams, jcfg, tparams, tcfg = _gqa128()
    ids, _, _, _, vl = _batch(jcfg.vocab_size)
    jlog, _ = JL.prefill(jparams, jcfg, jnp.asarray(ids),
                         valid_len=jnp.asarray(vl),
                         logits_last_only=True, with_cache=False)
    tlog, cache = TL.prefill(tparams, tcfg, torch.from_numpy(ids),
                             valid_len=torch.from_numpy(vl),
                             logits_last_only=True, with_cache=False)
    assert cache is None and tlog.shape == (2, 1, jcfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL,
                               rtol=0)


def test_native_loader_matches_jax_loader():
    if not os.path.isfile(os.path.join(CKPT_V4, "params.npz")):
        pytest.skip("qa_ckpt_v4 not present")
    jparams, jcfg = jax_load_decoder(CKPT_V4)
    tparams, tcfg = load_decoder(CKPT_V4, device="cpu")
    assert tcfg == _port_cfg(jcfg)
    jflat = jax.tree_util.tree_leaves_with_path(jparams)
    for path, leaf in jflat:
        node = tparams
        for p in path:
            node = node[p.key if hasattr(p, "key") else p.idx]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 8192)])
def test_rope_and_rms_norm_match_jax(scaling):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 17, 128)).astype(np.float32)
    pos = rng.integers(0, 9000, size=(2, 17)).astype(np.int32)
    ref = np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0,
                             scaling))
    out = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0,
                  scaling).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-5, rtol=0)
    w = rng.standard_normal(128).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        atol=1e-5, rtol=0)


def test_positions_skip_holes_like_jax():
    d = np.asarray([[-1, -1, 0, 0, -2, -2, 1, -1], [-2, 0, 0, -2, -1, -1,
                                                    -1, -1]], np.int32)
    np.testing.assert_array_equal(
        TL.positions_from_doc_id(torch.from_numpy(d)).numpy(),
        np.asarray(JL.positions_from_doc_id(jnp.asarray(d))))
