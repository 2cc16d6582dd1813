"""Row-sharded dense and BM25 search of the port on gloo ranks against the
JAX package's sharded indexes over the same number of devices, and
against one device: exact f32, bf16 and int8, approx and the int8 +
residual rescore; the BM25 scan, postings and heavy/light hybrid engines.
Indices equal, scores within 1e-5; ties across shards come back in
global index order; the postings engine falls back to the scan on exactly
the batches where JAX's does at the same shard count; the residual guards
raise with JAX's messages.  Each world is spawned once per module."""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from sdag_tpu.core.mesh import make_index_mesh as jax_index_mesh
from sdag_tpu.ops import topk as jtopk
from sdag_tpu.parallel.collectives import \
    sharded_topk_search as jax_sharded_topk_search
from sdag_tpu.retrieval import dense as jdense
from sdag_tpu.retrieval.sparse import BM25Index as JaxBM25Index
from sdag_tpu_torch.core.mesh import make_index_mesh
from sdag_tpu_torch.parallel.collectives import sharded_topk_search
from sdag_tpu_torch.parallel.launch import run_ranks
from sdag_tpu_torch.retrieval import dense as tdense
from sdag_tpu_torch.retrieval.sparse import BM25Index

JNP = {"float32": jax.numpy.float32, "bfloat16": jax.numpy.bfloat16,
       "int8": jax.numpy.int8}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "int8": torch.int8}
DENSE_CASES = [("float32", "exact", False), ("float32", "approx", False),
               ("bfloat16", "exact", False), ("bfloat16", "approx", False),
               ("int8", "exact", False), ("int8", "approx", False),
               ("int8", "approx", True)]
BM25_QUERIES = ["ubiq halfish", "ubiq rare7", "rare7 tail3", "zzzunknown",
                "halfish tail4 mid3", "tail5", "rare3 rare4 mid2", "ubiq"]
# one query a batch: two over the tight candidate budget, two under
FALLBACK_QUERIES = ["halfish tail4 mid3", "tail5", "rare3 rare4 mid2",
                    "ubiq rare7"]


class _JaxSmallBM25(JaxBM25Index):
    HEAVY_DF_MIN = 64
    POSTINGS_WINDOW = 8


class _SmallBM25(BM25Index):
    HEAVY_DF_MIN = 64
    POSTINGS_WINDOW = 8


class _JaxTightBM25(_JaxSmallBM25):
    POSTINGS_CANDIDATE_BUDGET = 40


class _TightBM25(_SmallBM25):
    POSTINGS_CANDIDATE_BUDGET = 40


def _emb(n=300, d=32, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    e[n - 10] = e[2]               # an exact tie across shards
    meta = [{"id": f"d{i}", "text": f"t{i}"} for i in range(n)]
    q = rng.standard_normal((5, d)).astype(np.float32)
    q[0] = e[2]
    return e, meta, q


def _corpus(n_docs=500, seed=13):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n_docs):
        toks = ["ubiq"] * int(rng.integers(1, 3))
        if i % 2 == 0:
            toks.append("halfish")
        toks += [f"mid{i % 12}", f"rare{i % 60}", f"tail{i}"]
        rng.shuffle(toks)
        docs.append(" ".join(toks))
    return docs, [f"d{i}" for i in range(n_docs)]


def _notes(index, queries, k=10):
    """Per query: (indices, scores, whether the scan fallback note
    printed)."""
    out = []
    for q in queries:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            i, s = index.search([q], top_k=k)
        out.append((i, s, "falling back to the scan" in buf.getvalue()))
    return out


def _worker(rank, world):
    e, meta, q = _emb()
    mesh = make_index_mesh("cpu")
    out = {}
    for dtype, mode, rescore in DENSE_CASES:
        idx = tdense.DenseIndex(e, meta, mesh=mesh, block_n=32,
                                dtype=TORCH[dtype], search_mode=mode,
                                int8_rescore=rescore, device="cpu")
        out[(dtype, mode, rescore)] = (idx.n_shards, idx.embeddings.shape[0],
                                       idx.search(q, 7))
    docs, ids = _corpus()
    for engine in ("postings", "scan"):
        idx = _SmallBM25.from_texts(docs, ids, engine=engine, device="cpu",
                                    mesh=mesh)
        out[engine] = (idx.rows_per_shard, idx.heavy_cols is not None,
                       idx.search(BM25_QUERIES, top_k=10))
    out["fallback"] = _notes(_TightBM25.from_texts(docs, ids, device="cpu",
                                                   mesh=mesh),
                             FALLBACK_QUERIES)
    return out


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    n = request.param
    return n, run_ranks(_worker, n)


def _jax_mesh(n):
    return jax_index_mesh(devices=jax.devices()[:n])


@pytest.mark.parametrize("dtype,mode,rescore", DENSE_CASES)
def test_sharded_dense_search_equals_jax_and_one_device(world, dtype, mode,
                                                        rescore):
    n, ranks = world
    e, meta, q = _emb()
    ji = jdense.DenseIndex(e, meta, mesh=_jax_mesh(n), block_n=32,
                           dtype=JNP[dtype], search_mode=mode,
                           int8_rescore=rescore)
    jidx, jsc = ji.search(q, 7)
    if (dtype, mode) == ("bfloat16", "exact"):
        # off the TPU JAX's exact search is an XLA scan that keeps the
        # queries f32; K4 casts them to bf16 as the Pallas kernel does, so
        # the reference is that kernel (interpret mode) over all rows
        jv, ji_ = jtopk.fused_topk_matmul(
            jax.numpy.asarray(q), jax.numpy.asarray(e, jax.numpy.bfloat16),
            7, block_n=32, valid_n=len(e), interpret=True)
        jidx, jsc = np.asarray(ji_), np.asarray(jv)
    one = tdense.DenseIndex(e, meta, block_n=32, dtype=TORCH[dtype],
                            search_mode=mode, int8_rescore=rescore,
                            device="cpu")
    oidx, osc = one.search(q, 7)
    for r in ranks:
        shards, rows, (idx, sc) = r[(dtype, mode, rescore)]
        assert shards == n and rows * n == ji.embeddings.shape[0]
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_allclose(sc, jsc, atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(idx, oidx)
        np.testing.assert_allclose(sc, osc, atol=1e-6, rtol=1e-6)
    # the tie across shards: lower global index first
    assert list(ranks[0][(dtype, mode, rescore)][2][0][0][:2]) == [2, 290]


@pytest.mark.parametrize("engine", ["postings", "scan"])
def test_sharded_bm25_equals_jax_and_one_device(world, engine):
    n, ranks = world
    docs, ids = _corpus()
    jidx = _JaxSmallBM25.from_texts(docs, ids, mesh=_jax_mesh(n),
                                    engine=engine)
    ji, js = jidx.search(BM25_QUERIES, top_k=10)
    oi, os_ = _SmallBM25.from_texts(docs, ids, engine=engine,
                                    device="cpu").search(BM25_QUERIES,
                                                         top_k=10)
    for r in ranks:
        rows, heavy, (ti, ts) = r[engine]
        assert rows == jidx.rows_per_shard
        if engine == "postings":
            assert heavy          # the hybrid engine ran
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts, js, rtol=1e-5)
        np.testing.assert_array_equal(ti, oi)
        np.testing.assert_allclose(ts, os_, rtol=1e-6)


def test_scan_fallback_on_the_batches_jax_takes_it(world):
    n, ranks = world
    docs, ids = _corpus()
    want = _notes(_JaxTightBM25.from_texts(docs, ids, mesh=_jax_mesh(n)),
                  FALLBACK_QUERIES)
    assert any(w[2] for w in want) and not all(w[2] for w in want)
    for r in ranks:
        for (ti, ts, note), (ji, js, jnote) in zip(r["fallback"], want):
            assert note == jnote
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_allclose(ts, js, rtol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(mode="exact", resid=True, resid_scales=True, scales=True),
    dict(mode="approx", resid=True, resid_scales=None, scales=True),
    dict(mode="approx", resid=True, resid_scales=True, scales=None),
])
def test_resid_guards_raise_with_jax_messages(kw):
    e, _, q = _emb(n=64)
    arr = {True: np.ones((64,), np.float32), None: None}

    def args(mk):
        return dict(mode=kw["mode"], scales=mk(arr[kw["scales"]]),
                    resid=mk(e.astype(np.int8)),
                    resid_scales=mk(arr[kw["resid_scales"]]))

    with pytest.raises(ValueError) as jerr:
        jax_sharded_topk_search(
            q, e, 5, 64, _jax_mesh(1),
            **args(lambda a: None if a is None else jax.numpy.asarray(a)))
    with pytest.raises(ValueError) as terr:
        sharded_topk_search(
            torch.from_numpy(q), torch.from_numpy(e), 5, 64,
            make_index_mesh("cpu"),
            **args(lambda a: None if a is None else torch.from_numpy(a)))
    assert str(terr.value) == str(jerr.value)
