"""Dense and hybrid retrieval of the port against the JAX package on the
CPU: index files readable both ways, indexes' and retrievers' hits equal
(the slice end to end is in test_torch_ranker_pipeline.py)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from sdag_tpu.models import e5 as je5
from sdag_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer
from sdag_tpu.retrieval import dense as jdense
from sdag_tpu.retrieval import hybrid as jhybrid
from sdag_tpu.retrieval import sparse as jsparse
from sdag_tpu_torch.models import e5 as te5
from sdag_tpu_torch.models.tokenizer import ByteTokenizer
from sdag_tpu_torch.retrieval import dense as tdense
from sdag_tpu_torch.retrieval import hybrid as thybrid
from sdag_tpu_torch.retrieval import sparse as tsparse

JNP_DTYPES = {"float32": jax.numpy.float32, "bfloat16": jax.numpy.bfloat16,
              "int8": jax.numpy.int8}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def encoders():
    """One set of tiny encoder weights behind both packages' E5Encoder."""
    jcfg = je5.EncoderConfig.tiny()
    jparams = je5.init_encoder_params(jax.random.PRNGKey(0), jcfg)
    jenc = je5.E5Encoder(jparams, jcfg, JaxByteTokenizer(),
                         model_name="intfloat/e5-large-v2", fused=False)
    tcfg = te5.EncoderConfig.tiny()
    tenc = te5.E5Encoder(
        te5.encoder_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu"),
        tcfg, ByteTokenizer(), model_name="intfloat/e5-large-v2",
        device="cpu")
    return jenc, tenc


TEXTS = [f"document {i} speaks about topic {i % 7} and item {i * 3}"
         for i in range(50)]
IDS = [f"doc{i}" for i in range(50)]
QUERIES = ["topic 3 item 9", "document 12", "item 141 topic 5", "nothing"]


def _emb(n=70, d=32, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    e[40] = e[2]                                          # an exact tie
    meta = [{"id": f"d{i}", "text": f"t{i}"} for i in range(n)]
    q = rng.standard_normal((5, d)).astype(np.float32)
    q[0] = e[2]
    return e, meta, q


@pytest.mark.parametrize("dtype,mode,rescore", [
    ("float32", "approx", True), ("float32", "exact", True),
    ("int8", "approx", True), ("int8", "approx", False),
    ("int8", "exact", True), ("bfloat16", "approx", True)])
def test_dense_index_search_equals_jax(dtype, mode, rescore):
    """Same embeddings through both DenseIndex classes: indices equal,
    scores within 1e-5 (f32 summation order; the int8 engines' scores
    differ by one rounding of the query scale, see test_torch_topk)."""
    e, meta, q = _emb()
    ji = jdense.DenseIndex(e, meta, block_n=32, dtype=JNP_DTYPES[dtype],
                           search_mode=mode, int8_rescore=rescore)
    ti = tdense.DenseIndex(e, meta, block_n=32,
                           dtype=tdense.INDEX_DTYPES[dtype],
                           search_mode=mode, int8_rescore=rescore,
                           device="cpu")
    assert ti.valid_n == 70 and ti.embeddings.shape[0] == 96
    assert ti.int8_rescore == ji.int8_rescore
    # k stays within one shard of the JAX index (8 virtual devices x 32)
    for k in (3, 30):
        jidx, jsc = ji.search(q, k)
        tidx, tsc = ti.search(q, k)
        np.testing.assert_array_equal(tidx, jidx)
        fin = np.isfinite(jsc)
        assert np.array_equal(np.isfinite(tsc), fin)
        np.testing.assert_allclose(tsc[fin], jsc[fin], rtol=1e-5, atol=1e-5)
    assert ti.search(q, 3)[0][0, :2].tolist() == [2, 40]
    assert ti.materialize(*ti.search(q, 30))[:2] == \
        ji.materialize(*ji.search(q, 30))[:2]
    # k past the valid rows: (-1, -inf) tail, ""/"NA" hits
    tidx, tsc = ti.search(q, 80)
    assert (tidx[:, 70:] == -1).all() and np.isneginf(tsc[:, 70:]).all()
    assert sorted(tidx[1, :70].tolist()) == list(range(70))
    texts, ids_, _ = ti.materialize(tidx, tsc)
    assert texts[0][70:] == [""] * 10 and ids_[0][70:] == ["NA"] * 10


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_dense_index_files_read_both_ways(tmp_path, dtype):
    """save -> the other package's load -> equal searches; the float32
    embeddings.npy files are bit-equal for a float32 index and for the
    int8 base+residual reconstruction."""
    e, meta, q = _emb(seed=1)
    ti = tdense.DenseIndex(e, meta, block_n=32,
                           dtype=tdense.INDEX_DTYPES[dtype], device="cpu")
    ji = jdense.DenseIndex(e, meta, block_n=32, dtype=JNP_DTYPES[dtype])
    ti.save(str(tmp_path / "port"))
    ji.save(str(tmp_path / "jax"))
    for name in ("embeddings.npy", "meta.jsonl", "manifest.json"):
        assert os.path.isfile(tmp_path / "port" / name)
    np.testing.assert_array_equal(np.load(tmp_path / "port/embeddings.npy"),
                                  np.load(tmp_path / "jax/embeddings.npy"))
    with open(tmp_path / "port/manifest.json") as f:
        assert json.load(f) == {"n": 70, "dim": 32, "block_n": 32}
    assert tdense.load_meta_jsonl(str(tmp_path / "jax/meta.jsonl")) == meta
    from_jax = tdense.DenseIndex.load(str(tmp_path / "jax"), device="cpu")
    from_port = jdense.DenseIndex.load(str(tmp_path / "port"))
    assert from_jax.block_n == 32 and from_jax.valid_n == 70
    a = from_jax.search(q, 5)
    b = from_port.search(q, 5)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], rtol=1e-5, atol=1e-5)
    with pytest.raises(FileNotFoundError):
        tdense.load_meta_jsonl(str(tmp_path / "missing.jsonl"))


def test_dense_index_refuses_shards_and_bad_arguments():
    e, meta, _ = _emb()
    for kw in (dict(mesh=object()), dict(n_shards=2)):
        with pytest.raises(NotImplementedError,
                           match="TP/DP on torch.distributed"):
            tdense.DenseIndex(e, meta, device="cpu", **kw)
    with pytest.raises(ValueError, match="search_mode"):
        tdense.DenseIndex(e, meta, search_mode="fast", device="cpu")
    with pytest.raises(ValueError, match="meta length"):
        tdense.DenseIndex(e, meta[:-1], device="cpu")
    with pytest.raises(ValueError, match="index dtype"):
        tdense.DenseIndex(e, meta, dtype=torch.float16, device="cpu")
    empty = tdense.DenseIndex(np.zeros((0, 32), np.float32), [],
                              device="cpu")
    idx, sc = empty.search(np.ones((2, 32), np.float32), 3)
    assert (idx == -1).all() and np.isneginf(sc).all()


def test_dense_and_hybrid_retrievers_equal_jax(encoders):
    """from_texts + DenseRetriever + HybridRetriever (device fuser, and
    the host fuser when the corpora differ): same texts, ids and scores
    (1e-5)."""
    jenc, tenc = encoders
    jidx = jdense.DenseIndex.from_texts(TEXTS, IDS, jenc, block_n=32)
    tidx = tdense.DenseIndex.from_texts(TEXTS, IDS, tenc, block_n=32,
                                        device="cpu")
    jret = jdense.DenseRetriever(jenc, jidx)
    tret = tdense.DenseRetriever(tenc, tidx)
    jb = jret.retrieve_batch(QUERIES, 6, 32)
    tb = tret.retrieve_batch(QUERIES, 6, 32)
    assert tb.ids_full == jb.ids_full
    assert tb.docs_texts_full == jb.docs_texts_full
    np.testing.assert_allclose(tb.scores_full, jb.scores_full, atol=1e-5)
    np.testing.assert_allclose(np.stack(tb.q_embs), np.stack(jb.q_embs),
                               atol=1e-4)

    jsp = jsparse.SparseRetriever(jsparse.BM25Index.from_texts(TEXTS, IDS))
    tsp = tsparse.SparseRetriever(
        tsparse.BM25Index.from_texts(TEXTS, IDS, device="cpu"))
    jh = jhybrid.HybridRetriever(jret, jsp, seed=3)
    th = thybrid.HybridRetriever(tret, tsp, seed=3)
    assert th._same_corpus() and jh._same_corpus()
    for k in (5, 6):                          # odd k: the seeded coin flip
        jb = jh.retrieve_batch(QUERIES, k, 32)
        tb = th.retrieve_batch(QUERIES, k, 32)
        assert tb.ids_full == jb.ids_full
        assert tb.docs_texts_full == jb.docs_texts_full
        for a, b in zip(tb.scores_full, jb.scores_full):
            np.testing.assert_allclose(a, b, rtol=1e-6)
    # a sparse index over other ids: the host fuser takes over
    tsp2 = tsparse.SparseRetriever(tsparse.BM25Index.from_texts(
        TEXTS, [f"x{i}" for i in IDS], device="cpu"))
    jsp2 = jsparse.SparseRetriever(jsparse.BM25Index.from_texts(
        TEXTS, [f"x{i}" for i in IDS]))
    th2 = thybrid.HybridRetriever(tret, tsp2, seed=3)
    assert not th2._same_corpus()
    tb = th2.retrieve_batch(QUERIES, 5, 32)
    jb = jhybrid.HybridRetriever(jret, jsp2, seed=3).retrieve_batch(
        QUERIES, 5, 32)
    assert tb.ids_full == jb.ids_full
