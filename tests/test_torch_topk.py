"""The port's dense top-k ops against the JAX package on the CPU: the plain
versions of kernels K4/K5 vs the Pallas kernels in interpret mode, the
quantisers, the merge, the two-stage and rescored searches, and RRF."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdag_tpu.ops import rrf as jrrf
from sdag_tpu.ops import topk as jtopk
from sdag_tpu.retrieval import hybrid as jhybrid
from sdag_tpu_torch.ops import rrf as trrf
from sdag_tpu_torch.ops import topk as ttopk
from sdag_tpu_torch.retrieval import hybrid as thybrid


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=0, q=5, n=300, d=128, ties=True):
    rng = np.random.default_rng(seed)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    if ties:                      # duplicated rows: exact score ties
        corpus[17] = corpus[3]
        corpus[250] = corpus[3]
        queries[0] = corpus[3] * 3.0      # the tie is query 0's best hit
    return queries, corpus


def _close_scores(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=rtol, atol=rtol)


@pytest.mark.parametrize("valid_n", [None, 260, 7])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_k4_plain_version_matches_pallas_interpret(k, valid_n):
    """f32 corpus: indices equal (ties to the lower index, rows >= valid_n
    never rank, k > valid rows -> (-inf, -1)); scores within 2e-5 (another
    summation order)."""
    q, c = _data()
    jv, ji = jtopk.fused_topk_matmul(jnp.asarray(q), jnp.asarray(c), k,
                                     block_n=128, valid_n=valid_n,
                                     interpret=True)
    tv, ti = ttopk.fused_topk_matmul(torch.from_numpy(q),
                                     torch.from_numpy(c), k,
                                     valid_n=valid_n)
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close_scores(tv.numpy(), jv, 2e-5)
    if k >= 3 and valid_n != 7:
        assert ti[0, :3].tolist() == [3, 17, 250]
    if valid_n == 7 and k > 7:
        assert (ti[:, 7:] == -1).all() and torch.isneginf(tv[:, 7:]).all()
    ev, ei = ttopk.exact_topk(torch.from_numpy(q), torch.from_numpy(c), k,
                              valid_n=valid_n)
    jev, jei = jtopk.exact_topk_xla(jnp.asarray(q), jnp.asarray(c), k,
                                    valid_n=valid_n)
    np.testing.assert_array_equal(ei.numpy(), np.asarray(jei))
    _close_scores(ev.numpy(), jev, 2e-5)


def test_k4_plain_version_bf16_corpus_casts_queries():
    """bf16 corpus: queries are cast to bf16, products accumulate in f32;
    scores within 1e-5 of the Pallas kernel (same rounded inputs), indices
    equal."""
    q, c = _data(seed=4)
    cb = jnp.asarray(c, jnp.bfloat16)
    jv, ji = jtopk.fused_topk_matmul(jnp.asarray(q), cb, 10, block_n=128,
                                     interpret=True)
    tv, ti = ttopk.fused_topk_matmul(
        torch.from_numpy(q), torch.from_numpy(c).to(torch.bfloat16), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close_scores(tv.numpy(), jv, 1e-5)


@pytest.mark.parametrize("valid_n", [None, 260, 7])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_k5_plain_version_matches_pallas_interpret(k, valid_n):
    """int8 corpus: the integer dot is exact, so indices are equal.  Scores
    are equal up to one rounding of the query scale: under jit XLA turns
    the quantiser's ``/ 127`` into ``* (1/127)``, the eager rule (and the
    port) divides -- hence rtol 3e-7 rather than bit equality here; the
    port's own kernel-vs-plain pair is bit-equal."""
    q, c = _data(seed=1)
    ci, cs = ttopk.quantize_rows_int8(c)
    jv, ji = jtopk.fused_topk_matmul_int8(
        jnp.asarray(q), jnp.asarray(ci), jnp.asarray(cs), k, block_n=128,
        valid_n=valid_n, interpret=True)
    tv, ti = ttopk.fused_topk_matmul_int8(
        torch.from_numpy(q), torch.from_numpy(ci), torch.from_numpy(cs), k,
        valid_n=valid_n)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close_scores(tv.numpy(), jv, 3e-7)
    # exact integer arithmetic: float32 and float64 dots agree bit for bit
    qi, qs = ttopk.quantize_last_axis_int8(torch.from_numpy(q))
    acc = (qi.numpy().astype(np.int64) @ ci.astype(np.int64).T)
    want = (acc.astype(np.float32) * qs.numpy()[:, None]) * cs[None, :]
    got = ttopk._int8_scores(qi, qs, torch.from_numpy(ci),
                             torch.from_numpy(cs)).numpy()
    np.testing.assert_array_equal(got, want)


def test_int8_scores_stay_exact_past_the_float32_range():
    """D > 1040: |acc| can pass 2^24, the dot moves to float64."""
    d = 2048
    q = torch.full((2, d), 127, dtype=torch.int8)
    c = torch.full((3, d), 127, dtype=torch.int8)
    c[1] = -127
    c[2, ::2] = 126
    ones = torch.ones(3)
    got = ttopk._int8_scores(q, torch.ones(2), c, ones).numpy()
    want = (q.numpy().astype(np.int64) @ c.numpy().astype(np.int64).T
            ).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    assert abs(want[0, 0]) > 2 ** 24


def test_quantisers_bit_equal_to_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((40, 96)).astype(np.float32)
    x[3] = 0.0                                   # all-zero row: scale floor
    x[5, :4] = [0.5, 1.5, 2.5, -2.5]             # round half to even
    x[5, 4:] = 0.0
    x[5, 10] = 127.0
    jq, js = jtopk.quantize_rows_int8(x)
    tq, ts = ttopk.quantize_rows_int8(x)
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)
    assert tq.dtype == np.int8 and ts.dtype == np.float32
    assert tq[5, :4].tolist() == [0, 2, 2, -2]
    for a, b in zip(ttopk.quantize_rows_int8_residual(x),
                    jtopk.quantize_rows_int8_residual(x)):
        np.testing.assert_array_equal(a, b)
    tq2, ts2 = ttopk.quantize_last_axis_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq2.numpy(), jq)
    np.testing.assert_array_equal(ts2.numpy(), js)


def test_merge_topk_equals_jax():
    rng = np.random.default_rng(6)
    scores = rng.integers(0, 4, size=(6, 30)).astype(np.float32)  # many ties
    scores[2, :5] = -np.inf
    idx = np.stack([rng.permutation(1000)[:30] for _ in range(6)]
                   ).astype(np.int32)
    for k in (1, 7, 30):
        jv, ji = jtopk.merge_topk(jnp.asarray(scores), jnp.asarray(idx), k)
        tv, ti = ttopk.merge_topk(torch.from_numpy(scores),
                                  torch.from_numpy(idx), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_ordered_topk_breaks_ties_by_index():
    s = torch.tensor([[1.0, 5.0, 5.0, 0.0, 5.0, 5.0, 2.0],
                      [3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0]])
    v, i = ttopk.ordered_topk(s, 3)
    assert i.tolist() == [[1, 2, 4], [0, 1, 2]]
    assert v.tolist() == [[5.0, 5.0, 5.0], [3.0, 3.0, 3.0]]
    v, i = ttopk.ordered_topk(s, 9)                  # k past the width
    assert i[0].tolist() == [1, 2, 4, 5, 6, 0, 3, -1, -1]
    assert torch.isneginf(v[:, 7:]).all()


@pytest.mark.parametrize("valid_n", [None, 33])
def test_two_stage_and_rescored_searches_match_jax(valid_n):
    """approx (exact off the TPU in the JAX package, exact in the port):
    indices equal; rescored scores within 1e-5 (f32 summation order)."""
    q, c = _data(seed=2)
    k = 10
    jv, ji = jtopk.approx_topk_matmul(jnp.asarray(q), jnp.asarray(c), k,
                                      valid_n=valid_n)
    tv, ti = ttopk.approx_topk_matmul(torch.from_numpy(q),
                                      torch.from_numpy(c), k,
                                      valid_n=valid_n)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close_scores(tv.numpy(), jv, 2e-5)
    ev, ei = ttopk.topk_search(torch.from_numpy(q), torch.from_numpy(c), k,
                               valid_n=valid_n, mode="exact")
    np.testing.assert_array_equal(ei.numpy(), ti.numpy())

    base, sb, resid, sr = ttopk.quantize_rows_int8_residual(c)
    jv, ji = jtopk.approx_topk_matmul_int8(
        jnp.asarray(q), jnp.asarray(base), jnp.asarray(sb), k,
        valid_n=valid_n)
    tv, ti = ttopk.approx_topk_matmul_int8(
        torch.from_numpy(q), torch.from_numpy(base), torch.from_numpy(sb),
        k, valid_n=valid_n)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close_scores(tv.numpy(), jv, 3e-7)

    jv, ji = jtopk.rescored_topk_int8(
        jnp.asarray(q), jnp.asarray(base), jnp.asarray(sb),
        jnp.asarray(resid), jnp.asarray(sr), k, valid_n=valid_n)
    tv, ti = ttopk.rescored_topk_int8(
        torch.from_numpy(q), torch.from_numpy(base), torch.from_numpy(sb),
        torch.from_numpy(resid), torch.from_numpy(sr), k, valid_n=valid_n)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close_scores(tv.numpy(), jv, 1e-5)


def test_rescored_search_k_exceeds_valid_rows():
    q, c = _data(seed=3, n=64, ties=False)
    base, sb, resid, sr = ttopk.quantize_rows_int8_residual(c)
    tv, ti = ttopk.rescored_topk_int8(
        torch.from_numpy(q), torch.from_numpy(base), torch.from_numpy(sb),
        torch.from_numpy(resid), torch.from_numpy(sr), 10, valid_n=4)
    assert (ti[:, 4:] == -1).all() and torch.isneginf(tv[:, 4:]).all()
    assert (ti[:, :4] >= 0).all() and (ti[:, :4] < 4).all()


def test_topk_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(2, 128)
    c = torch.zeros(64, 128)
    with pytest.raises(ValueError, match="CUDA"):
        ttopk.topk_matmul_cuda(q, c, 5)
    with pytest.raises(ValueError, match="no path for device"):
        ttopk.fused_topk_matmul(q, c.to("meta"), 5)
    with pytest.raises(ValueError, match="no path for device"):
        ttopk.fused_topk_matmul_int8(q, c.to("meta").to(torch.int8),
                                     torch.ones(64, device="meta"), 5)


# --------------------------------------------------------------------- RRF
def _rankings(seed, q=6, k=7, n=40):
    rng = np.random.default_rng(seed)
    s = np.stack([rng.permutation(n)[:k] for _ in range(q)]).astype(np.int32)
    d = np.stack([rng.permutation(n)[:k] for _ in range(q)]).astype(np.int32)
    s[1, 4:] = -1                 # Lucene no-match padding
    d[2, 0] = s[2, 0]             # shared top hit
    d[3] = s[3]                   # identical rankings
    s[4, :] = -1                  # sparse found nothing
    return s, d


@pytest.mark.parametrize("top_k", [3, 7, 20])
def test_rrf_fuse_topk_equals_jax(top_k):
    s, d = _rankings(0)
    rng = random.Random(5)
    ks, kd = zip(*[jhybrid.split_k_between_sparse_and_dense(7, rng)
                   for _ in range(len(s))])
    ks, kd = np.asarray(ks, np.int32), np.asarray(kd, np.int32)
    ji, js = jrrf.rrf_fuse_topk(jnp.asarray(s), jnp.asarray(d),
                                jnp.asarray(ks), jnp.asarray(kd),
                                k0=60, top_k=top_k)
    ti, ts = trrf.rrf_fuse_topk(torch.from_numpy(s), torch.from_numpy(d),
                                torch.from_numpy(ks), torch.from_numpy(kd),
                                k0=60, top_k=top_k)
    ji, js = np.asarray(ji), np.asarray(js)
    # the JAX op returns min(top_k, candidates) columns; the port pads
    w = ji.shape[1]
    np.testing.assert_array_equal(ti.numpy()[:, :w], ji)
    np.testing.assert_array_equal(ts.numpy()[:, :w], js)
    assert ti.shape == (len(s), top_k)
    assert (ti.numpy()[:, w:] == -1).all()


def test_host_fuser_equals_jax_and_device_fuser():
    s, d = _rankings(1)
    meta = [{"id": f"d{i}", "text": f"text {i}"} for i in range(40)]

    def mat(idx):
        return ([[meta[i]["text"] if i >= 0 else "" for i in row]
                 for row in idx],
                [[meta[i]["id"] if i >= 0 else "NA" for i in row]
                 for row in idx])
    st, si = mat(s)
    dt, di = mat(d)
    got = thybrid.fuse_sparse_and_dense_batch(st, si, dt, di, top_k=7,
                                              seed=11)
    ref = jhybrid.fuse_sparse_and_dense_batch(st, si, dt, di, top_k=7,
                                              seed=11)
    assert got == ref
    rng = random.Random(11)
    ks, kd = zip(*[thybrid.split_k_between_sparse_and_dense(7, rng)
                   for _ in range(len(s))])
    ti, ts = trrf.rrf_fuse_topk(
        torch.from_numpy(s), torch.from_numpy(d),
        torch.tensor(ks, dtype=torch.int32),
        torch.tensor(kd, dtype=torch.int32), k0=60, top_k=7)
    for row, (ids_row, sc_row) in enumerate(zip(got[1], got[2])):
        dev_ids = [f"d{i}" for i in ti[row].tolist() if i >= 0]
        assert dev_ids == ids_row
        np.testing.assert_allclose(
            [x for x in ts[row].tolist() if np.isfinite(x)], sc_row,
            rtol=1e-6)
