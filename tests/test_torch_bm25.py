"""Port BM25 vs the JAX package: the plain scan top-k against the Pallas
kernel in interpret mode, the postings and heavy-term hybrid engines
against the JAX engines (the "four BM25 paths pinned equal" invariant,
carried across packages), and index files loading in both directions."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sdag_tpu.core.mesh import make_index_mesh
from sdag_tpu.ops import bm25 as JB
from sdag_tpu.retrieval.sparse import BM25Index as JaxIndex
from sdag_tpu.retrieval.sparse import _csr_from_packed
from sdag_tpu_torch.ops import bm25 as TB
from sdag_tpu_torch.retrieval.sparse import BM25Index, SparseRetriever

t = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Parallel test workers share the CPU; torch's default of one thread
    per core oversubscribes it (measured 4.5x slower under contention)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packed(seed, n=300, lp=64, v=50, q=5, tq=8, distinct=True):
    rng = np.random.default_rng(seed)
    term_ids = np.full((n, lp), JB.PAD_TERM, np.int32)
    impacts = np.zeros((n, lp), np.float32)
    for i in range(n):
        terms = rng.choice(v, size=int(rng.integers(3, 20)),
                           replace=not distinct)
        term_ids[i, :len(terms)] = terms
        impacts[i, :len(terms)] = rng.random(len(terms)) + 0.01
    q_terms = rng.integers(0, v, size=(q, tq)).astype(np.int32)
    q_terms[:, tq - 2:] = JB.PAD_TERM
    q_weights = np.where(q_terms == JB.PAD_TERM, 0.0,
                         rng.integers(1, 3, size=(q, tq))).astype(np.float32)
    return term_ids, impacts, q_terms, q_weights


@pytest.mark.parametrize("k,valid_n", [(5, None), (10, 250), (4, 2)])
def test_plain_scan_topk_matches_pallas_interpret(k, valid_n):
    """Same (score desc, doc asc) order, including 0-score docs and the
    (-inf, -1) slots when k exceeds valid_n."""
    term_ids, impacts, q_terms, q_weights = _packed(0)
    jv, ji = JB.bm25_topk(jnp.asarray(term_ids), jnp.asarray(impacts),
                          jnp.asarray(q_terms), jnp.asarray(q_weights), k,
                          valid_n=valid_n, block_n=128, interpret=True)
    tv, ti = TB.bm25_topk(t(term_ids), t(impacts), t(q_terms),
                          t(q_weights), k, valid_n=valid_n)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


def test_plain_scores_equal_jax_xla_scorer(monkeypatch):
    monkeypatch.setattr(TB, "SCORE_CHUNK_ELEMS", 4096)   # several chunks
    term_ids, impacts, q_terms, q_weights = _packed(1, distinct=False)
    ref = np.asarray(JB.bm25_scores_xla(
        jnp.asarray(term_ids), jnp.asarray(impacts), jnp.asarray(q_terms),
        jnp.asarray(q_weights)))
    got = TB.bm25_scores(t(term_ids), t(impacts), t(q_terms),
                         t(q_weights)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("window,w_slots", [(16, None), (8, (4, 2, 1, 1, 1,
                                                              1, 0, 0))])
def test_postings_engine_matches_jax_engine(window, w_slots):
    term_ids, impacts, q_terms, q_weights = _packed(2)
    docs, imps, offsets, max_df = _csr_from_packed(term_ids, impacts, 50)
    if w_slots is None:
        w_slots = -(-max_df // window)
    else:   # per-slot windows must cover each slot's df: sort like search
        w_slots = tuple(max(w, -(-max_df // window)) if w else 0
                        for w in w_slots)
        q_terms[:, 6:] = JB.PAD_TERM
    jv, ji = JB.bm25_postings_topk(
        jnp.asarray(docs), jnp.asarray(imps), jnp.asarray(offsets),
        jnp.asarray(q_terms), jnp.asarray(q_weights), 7, w_slots=w_slots,
        window=window)
    tv, ti = TB.bm25_postings_topk(t(docs), t(imps), t(offsets),
                                   t(q_terms), t(q_weights), 7,
                                   w_slots=w_slots, window=window)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


def _zipfish_corpus(n_docs=300, seed=11):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n_docs):
        toks = ["ubiq"]
        if i % 2 == 0:
            toks.append("halfish")
        toks += [f"mid{i % 12}", f"rare{i % 60}", f"tail{i}"]
        rng.shuffle(toks)
        docs.append(" ".join(toks))
    return docs, [f"d{i}" for i in range(n_docs)]


HYBRID_QUERIES = ["ubiq halfish", "ubiq rare7", "rare7 tail3", "zzzunknown",
                  "halfish tail4 mid3", "tail5"]


def _mesh1():
    return make_index_mesh(devices=[jax.devices()[0]])


def test_hybrid_engine_matches_jax_engine(monkeypatch):
    """Op level: the same sidecar/CSR arrays and query slots through both
    packages' hybrid engines."""
    for cls in (JaxIndex, BM25Index):
        monkeypatch.setattr(cls, "HEAVY_DF_MIN", 64)
        monkeypatch.setattr(cls, "POSTINGS_WINDOW", 8)
    docs, ids = _zipfish_corpus()
    jidx = JaxIndex.from_texts(docs, ids, mesh=_mesh1())
    tidx = BM25Index.from_texts(docs, ids, device="cpu")
    assert tidx.heavy_cols is not None
    np.testing.assert_array_equal(tidx.heavy_row_of, jidx.heavy_row_of)
    qt, qw = tidx.encode_queries(HYBRID_QUERIES)
    qt, qw, w_slots, qh = tidx._order_slots_by_df(qt, qw)
    jv, ji = JB.bm25_hybrid_topk(
        jidx.post_docs[0], jidx.post_imps[0], jidx.post_offsets[0],
        jidx.heavy_cols[0], jidx.heavy_rows[0], jnp.asarray(qt),
        jnp.asarray(qw), jnp.asarray(qh), 5, w_slots=w_slots, window=8)
    tv, ti = TB.bm25_hybrid_topk(
        tidx.post_docs, tidx.post_imps, tidx.post_offsets, tidx.heavy_cols,
        tidx.heavy_rows, t(qt), t(qw), t(qh), 5, w_slots=w_slots, window=8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    finite = np.isfinite(np.asarray(jv))
    np.testing.assert_array_equal(np.isfinite(tv.numpy()), finite)
    np.testing.assert_allclose(tv.numpy()[finite], np.asarray(jv)[finite],
                               rtol=1e-5)


@pytest.mark.parametrize("engine", ["postings", "scan"])
def test_index_search_matches_jax_index(engine, monkeypatch):
    """Whole search (analysis, slot ordering, engine, -inf/-1 padding): the
    port's index equals the JAX index on one device; within the port the
    postings (with hybrid) and scan engines agree."""
    for cls in (JaxIndex, BM25Index):
        monkeypatch.setattr(cls, "HEAVY_DF_MIN", 64)
        monkeypatch.setattr(cls, "POSTINGS_WINDOW", 8)
    docs, ids = _zipfish_corpus(n_docs=500, seed=13)
    queries = HYBRID_QUERIES + ["rare3 rare4 mid2", "ubiq"]
    ji, js = JaxIndex.from_texts(docs, ids, mesh=_mesh1(),
                                 engine=engine).search(queries, top_k=10)
    tidx = BM25Index.from_texts(docs, ids, engine=engine, device="cpu")
    ti, ts = tidx.search(queries, top_k=10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5)
    si, ss = BM25Index.from_texts(docs, ids, engine="scan",
                                  device="cpu").search(queries, top_k=10)
    np.testing.assert_array_equal(ti, si)
    np.testing.assert_allclose(ts, ss, rtol=1e-5)


def test_index_files_load_across_packages(tmp_path):
    rng = np.random.default_rng(7)
    words = [f"w{i}" for i in range(150)]
    docs = [" ".join(rng.choice(words, size=rng.integers(5, 30)))
            for _ in range(400)]
    ids = [f"d{i}" for i in range(len(docs))]
    queries = [" ".join(rng.choice(words, size=5)) for _ in range(7)]
    jidx = JaxIndex.from_texts(docs, ids, mesh=_mesh1())
    tidx = BM25Index.from_texts(docs, ids, device="cpu")
    jidx.save(str(tmp_path / "from_jax"))
    tidx.save(str(tmp_path / "from_port"))
    ji, js = jidx.search(queries, top_k=10)
    for engine in ("postings", "scan"):
        a = BM25Index.load(str(tmp_path / "from_jax"), engine=engine,
                           device="cpu")
        b = JaxIndex.load(str(tmp_path / "from_port"), mesh=_mesh1(),
                          engine=engine)
        for i_, s_ in (a.search(queries, top_k=10),
                       b.search(queries, top_k=10)):
            np.testing.assert_array_equal(i_, ji)
            np.testing.assert_allclose(s_, js, rtol=1e-6)


def test_window_profile_merges_like_jax():
    """The growing per-index window profile: elementwise max of the needs
    seen while it fits the candidate budget, the batch's own need when a
    merge would not, same decisions as the JAX index."""
    docs, ids = _zipfish_corpus(n_docs=4000, seed=5)
    jidx = JaxIndex.from_texts(docs, ids, mesh=_mesh1())
    tidx = BM25Index.from_texts(docs, ids, device="cpu")
    assert tidx._candidate_budget() == jidx._candidate_budget() == 2000
    needs = [(1, 0, 0), (0, 2, 0), (1, 1, 1), (3, 0, 0), (1, 0, 0),
             (2, 1, 0, 0)]
    got = [tidx._merge_window_profile(n) for n in needs]
    assert got == [jidx._merge_window_profile(n) for n in needs]
    # budget 2000 candidates = 3 windows of 512: (1, 2, 1) and (3, 2, 0)
    # would exceed it, so those batches run at their own need
    assert got == [(1, 0, 0), (1, 2, 0), (1, 1, 1), (3, 0, 0), (1, 2, 0),
                   (2, 1, 0, 0)]


def test_retriever_pads_short_results_like_reference():
    corpus = ["The quick brown fox", "Quantum computing uses qubits",
              "Dogs are loyal companions"]
    r = SparseRetriever(BM25Index.from_texts(
        corpus, [f"d{i}" for i in range(3)], device="cpu"))
    batch = r.retrieve_batch(["quantum"], max_k_needed=3, embed_batch_size=1)
    assert batch.ids_full[0] == ["d1", "NA", "NA"]
    assert batch.docs_texts_full[0][1:] == ["", ""]
    assert batch.scores_full[0][1] == float("-inf")


def test_kernel_wrapper_refuses_cpu_tensors():
    term_ids, impacts, q_terms, q_weights = _packed(3)
    with pytest.raises(ValueError, match="not on CUDA"):
        TB.bm25_topk_cuda(t(term_ids), t(impacts), t(q_terms),
                          t(q_weights), 5)
