"""Port attention vs the JAX package: the plain prefill version against the
JAX reference (f32) and the Pallas kernels in interpret mode (bf16 dots),
block kinds / worklists equal exactly, K1's plan sound, decode attention."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sdag_tpu.ops import attention as JA
from sdag_tpu.sdag.mask import BlockLayout, layout_to_metadata
from sdag_tpu_torch.ops import attention as TA


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Parallel test workers share the CPU; torch's default of one thread
    per core oversubscribes it (measured 4.5x slower under contention)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LAYOUTS = [
    (256, BlockLayout(230, 40, ((40, 80), (85, 130), (132, 180)), 185),
     [[1], [], [0]]),
    (256, BlockLayout(230, 40, ((40, 80), (85, 130), (132, 180)), 185),
     None),
    (256, BlockLayout(256, 16, ((16, 128), (128, 240)), 240), [[], []]),
    (128, BlockLayout(100, 30, (), 30), None),  # no docs: plain causal
]


def _random_meta(rng, B, L, n_docs, holes=False, neighbors=True):
    """Random doc layouts (sys prefix, docs, optional hole runs, QA tail)
    with per-doc neighbor bits for docs < 31 and varied valid lengths."""
    doc_id = np.full((B, L), -1, np.int32)
    nbr = np.zeros((B, L), np.int32)
    sul = np.zeros(B, np.int32)
    vl = np.zeros(B, np.int32)
    for b in range(B):
        pos = int(rng.integers(8, 24))
        sul[b] = pos
        avail = int(L * 0.8) - pos
        lens = rng.integers(2, max(3, 2 * avail // max(n_docs, 1)),
                            size=n_docs)
        for d in range(n_docs):
            ln = int(min(lens[d], max(0, int(L * 0.8) - pos)))
            doc_id[b, pos:pos + ln] = d
            if neighbors and d < 31:
                for nn in rng.choice(min(n_docs, 31), size=2):
                    if nn != d:
                        nbr[b, pos:pos + ln] |= np.int32(1 << int(nn)) \
                            if nn < 31 else 0
            pos += ln
            if holes and rng.random() < 0.5:
                h = int(rng.integers(1, 5))
                doc_id[b, pos:pos + h] = -2
                pos += h
        vl[b] = int(rng.integers(int(L * 0.85), L + 1))
    return doc_id, nbr, sul, vl


CASES = [
    # (name, B, H, Hkv, L, Lq, n_docs, holes, neighbors, Dh)
    ("docs_nbrs", 2, 4, 4, 256, 256, 6, False, True, 32),
    ("gqa_holes", 2, 4, 2, 256, 256, 5, True, True, 64),
    ("over_31_docs", 1, 2, 1, 512, 512, 40, True, False, 32),
    ("qoffset_slice", 2, 4, 2, 256, 128, 6, True, True, 32),
    ("causal_only", 2, 2, 1, 128, 128, 0, False, False, 128),
]


def _inputs(case, seed=0):
    name, B, H, Hkv, L, Lq, n_docs, holes, nbrs, Dh = case
    rng = np.random.default_rng(seed)
    doc_id, nbr, sul, vl = _random_meta(rng, B, L, n_docs, holes, nbrs)
    q = rng.standard_normal((B, H, L, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, L, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, L, Dh)).astype(np.float32)
    qo = np.full(B, L - Lq, np.int32)
    return dict(q=q[:, :, L - Lq:], k=k, v=v, doc_id=doc_id, nbr=nbr,
                sul=sul, vl=vl, qo=qo, dq=doc_id[:, L - Lq:],
                nq=nbr[:, L - Lq:])


def _port_plain(x):
    t = torch.from_numpy
    return TA.sdag_prefill_attention(
        t(x["q"]), t(x["k"]), t(x["v"]), t(x["doc_id"]), t(x["nbr"]),
        t(x["sul"]), valid_len=t(x["vl"]), q_offset=t(x["qo"]),
        doc_id_q=t(x["dq"]), nbr_bits_q=t(x["nq"])).numpy()


def _seen_rows(x):
    """[B, Lq] rows that are valid and see at least one key."""
    t = torch.from_numpy
    B, Lq = x["dq"].shape
    Lk = x["doc_id"].shape[1]
    i = t(x["qo"])[:, None, None] + torch.arange(Lq)[None, :, None]
    j = torch.arange(Lk)[None, None, :]
    m = TA._tile_mask(i, j, t(x["dq"])[:, :, None], t(x["doc_id"])[:, None],
                      t(x["nq"])[:, :, None], t(x["sul"])[:, None, None],
                      t(x["vl"])[:, None, None])
    return m.any(-1).numpy()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_prefill_matches_jax_reference_f32(case):
    """Plain port vs JAX sdag_attention_reference, f32 end to end: only
    summation order differs (atol 1e-5)."""
    x = _inputs(case)
    ref = np.asarray(JA.sdag_attention_reference(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
        jnp.asarray(x["doc_id"]), jnp.asarray(x["nbr"]),
        jnp.asarray(x["sul"]), valid_len=jnp.asarray(x["vl"]),
        q_offset=jnp.asarray(x["qo"]), doc_id_q=jnp.asarray(x["dq"]),
        nbr_bits_q=jnp.asarray(x["nq"])))
    np.testing.assert_allclose(_port_plain(x), ref, atol=1e-5, rtol=0)


_KERNELS = {
    "kvres": lambda **kw: JA.sdag_flash_attention_kvres(
        block_q=128, block_k=128, interpret=True, **kw),
    "splash": lambda **kw: JA.sdag_splash_attention(
        block_q=128, block_k=128, interpret=True, **kw),
    "flash": lambda **kw: JA.sdag_flash_attention(
        block_q=128, block_k=128, interpret=True, **kw),
}


@pytest.mark.parametrize("kernel", sorted(_KERNELS))
@pytest.mark.parametrize("case", CASES[:4], ids=lambda c: c[0])
def test_plain_prefill_matches_pallas_interpret(case, kernel):
    """Plain port (f32) vs the Pallas kernels in interpret mode, which feed
    bf16 to their dots: bf16-dot tolerance (atol 2e-2) on rows that are
    valid and see a key (the kernels output 0 elsewhere, the reference an
    average)."""
    x = _inputs(case, seed=1)
    out = np.asarray(_KERNELS[kernel](
        q=jnp.asarray(x["q"]), k=jnp.asarray(x["k"]), v=jnp.asarray(x["v"]),
        doc_id=jnp.asarray(x["doc_id"]), nbr_bits=jnp.asarray(x["nbr"]),
        sys_user_len=jnp.asarray(x["sul"]),
        valid_len=jnp.asarray(x["vl"]), q_offset=jnp.asarray(x["qo"]),
        doc_id_q=jnp.asarray(x["dq"]), nbr_bits_q=jnp.asarray(x["nq"])))
    rows = _seen_rows(x)[:, None, :, None]
    np.testing.assert_allclose(np.where(rows, _port_plain(x), 0.0),
                               np.where(rows, out, 0.0), atol=2e-2, rtol=0)


def _kinds_pair(doc_id, nbr, sul, vl, bq, bk, dq=None, nq=None, qo=0):
    j = np.asarray(JA.compute_block_kinds(
        jnp.asarray(doc_id), jnp.asarray(nbr), jnp.asarray(sul),
        jnp.asarray(vl), bq, bk,
        doc_id_q=None if dq is None else jnp.asarray(dq),
        nbr_bits_q=None if nq is None else jnp.asarray(nq),
        q_offset=jnp.asarray(qo)))
    t = TA.compute_block_kinds(
        torch.from_numpy(doc_id), torch.from_numpy(nbr),
        torch.from_numpy(np.asarray(sul)), torch.from_numpy(np.asarray(vl)),
        bq, bk, doc_id_q=None if dq is None else torch.from_numpy(dq),
        nbr_bits_q=None if nq is None else torch.from_numpy(nq),
        q_offset=torch.as_tensor(qo)).numpy()
    return j, t


@pytest.mark.parametrize("L,layout,nbrs", LAYOUTS)
@pytest.mark.parametrize("bq,bk", [(32, 32), (64, 32), (32, 64)])
def test_block_kinds_equal_jax(L, layout, nbrs, bq, bk):
    doc_id, bits, sul = layout_to_metadata(layout, doc_neighbors=nbrs,
                                           pad_to=L)
    j, t = _kinds_pair(doc_id[None], bits[None], np.asarray([sul]),
                       np.asarray([layout.seq_len]), bq, bk)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_block_kinds_and_worklists_equal_jax_random(case):
    """Random layouts with holes, >31 docs, neighbor bits, q_offset slices:
    kinds, counts, packed kv lists and kind lists equal exactly."""
    x = _inputs(case, seed=2)
    j, t = _kinds_pair(x["doc_id"], x["nbr"], x["sul"], x["vl"], 64, 32,
                       dq=x["dq"], nq=x["nq"], qo=x["qo"])
    np.testing.assert_array_equal(t, j)
    jl = [np.asarray(a) for a in JA._pack_kv_lists(jnp.asarray(j))]
    tl = [a.numpy() for a in TA._pack_kv_lists(torch.from_numpy(t))]
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a, b)


def test_block_kinds_per_token_nbr_bits_not_full():
    """Mirror of the JAX pin: per-token nbr bits varying inside a doc block
    must not be classified FULL (AND-reduce, not row 0)."""
    L = 128
    doc_id = np.full((1, L), -1, np.int32)
    doc_id[0, 0:64] = 0
    doc_id[0, 64:128] = 1
    nbr = np.zeros((1, L), np.int32)
    nbr[0, 64:96] = 1 << 0          # half of doc 1's rows see doc 0
    j, t = _kinds_pair(doc_id, nbr, np.asarray([0]), np.asarray([L]), 64, 64)
    np.testing.assert_array_equal(t, j)
    assert t[0, 1, 0] != TA.BLOCK_FULL


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_k1_plan_kinds_sound(case):
    """K1's plan (64x64 tiles, metadata padded to tile multiples): SKIP
    tiles see nothing, FULL tiles see everything, CAUSAL tiles are exactly
    causal & valid -- the guarantees the kernel's mask specialization
    relies on."""
    x = _inputs(case, seed=3)
    t = torch.from_numpy
    plan = TA.k1_plan(t(x["doc_id"]), t(x["nbr"]), t(x["sul"]), t(x["vl"]),
                      doc_id_q=t(x["dq"]), nbr_bits_q=t(x["nq"]),
                      q_offset=t(x["qo"]))
    B = x["dq"].shape[0]
    nq, nk = plan["nq"], plan["nk"]
    i = t(x["qo"])[:, None, None] + torch.arange(nq * 64)[None, :, None]
    j = torch.arange(nk * 64)[None, None, :]
    m = TA._tile_mask(i, j, plan["doc_id_q"][:, :, None],
                      plan["doc_id"][:, None], plan["nbr_bits_q"][:, :, None],
                      plan["sys_user_len"][:, None, None],
                      plan["valid_len"][:, None, None])
    vl = plan["valid_len"][:, None, None]
    causal = (j <= i) & (j < vl) & (i < vl)
    tiles = lambda a: a.reshape(B, nq, 64, nk, 64).permute(0, 1, 3, 2, 4)  # noqa
    m, causal = tiles(m), tiles(causal.expand(B, -1, -1))
    kinds = plan["kinds"]
    assert not m[kinds == TA.BLOCK_SKIP].any()
    assert m[kinds == TA.BLOCK_FULL].all()
    assert (m[kinds == TA.BLOCK_CAUSAL] == causal[kinds == TA.BLOCK_CAUSAL]
            ).all()
    counts = plan["counts"]
    assert (counts == (kinds > 0).sum(-1)).all()


def test_tile_masks_equal_jax():
    x = _inputs(CASES[1], seed=4)
    j = np.asarray(JA.tile_masks_from_metadata(
        jnp.asarray(x["doc_id"]), jnp.asarray(x["nbr"]),
        jnp.asarray(x["sul"]), jnp.asarray(x["vl"]), 64, 64))
    t = TA.tile_masks_from_metadata(
        torch.from_numpy(x["doc_id"]), torch.from_numpy(x["nbr"]),
        torch.from_numpy(x["sul"]), torch.from_numpy(x["vl"]), 64,
        64).numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("rep", [1, 4])
def test_masked_decode_attention_matches_jax(rep):
    rng = np.random.default_rng(5)
    B, Hkv, S, Dh = 3, 2, 40, 32
    q = rng.standard_normal((B, Hkv * rep, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, Dh)).astype(np.float32)
    mask = rng.random((B, S)) < 0.7
    mask[:, 0] = True
    ref = np.asarray(JA.masked_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))
    out = TA.masked_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_prefill_dispatch_cpu_takes_plain_and_plan_is_none():
    x = _inputs(CASES[0])
    t = torch.from_numpy
    assert TA.prefill_mask_plan(t(x["doc_id"]), t(x["nbr"]), t(x["sul"]),
                                t(x["vl"])) is None
    with pytest.raises(ValueError, match="no path"):
        TA.sdag_prefill_attention(
            t(x["q"]).to("meta"), t(x["k"]).to("meta"), t(x["v"]).to("meta"),
            t(x["doc_id"]), t(x["nbr"]), t(x["sul"]))
