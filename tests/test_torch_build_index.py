"""The port's offline index builder against the JAX package's CLI: the
``--bm25`` directory equal file by file (the npz compared member by member:
its zip headers carry the write time), and the dense directory built from a
tiny HF BERT directory (WordPiece vocab) within 1e-5 of JAX's in float32
and bfloat16, each loadable by the other package."""

import json
import os
import zipfile

import numpy as np
import pytest
import torch

import chip_smoke
from sdag_tpu.pipeline import build_index as jbuild
from sdag_tpu_torch.pipeline import build_index as tbuild
from sdag_tpu_torch.utils.synth_qa import load_world, write_corpus_jsonl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = os.path.join(REPO, "experiments", "data", "qa_ckpt", "world.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "corpus.jsonl"
    write_corpus_jsonl(load_world(WORLD), str(path))
    return str(path)


def _npz_members(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


def test_bm25_directory_equals_jax(tmp_path, corpus):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jbuild.main([corpus, jdir, "--bm25"])
    tbuild.main([corpus, tdir, "--bm25", "--device", "cpu"])
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == [
        "manifest.json", "meta.jsonl", "postings.npz", "vocab.json"]
    for name in ("manifest.json", "meta.jsonl", "vocab.json"):
        with open(os.path.join(jdir, name), "rb") as fj, \
                open(os.path.join(tdir, name), "rb") as ft:
            assert fj.read() == ft.read(), name
    members = _npz_members(os.path.join(tdir, "postings.npz"))
    assert members == _npz_members(os.path.join(jdir, "postings.npz"))
    assert set(members) == {"term_ids.npy", "impacts.npy", "idf.npy"}


def _bert_dir(path, corpus):
    from sdag_tpu_torch.pipeline.resources import load_corpus_jsonl
    from test_torch_hf_convert import _bert, _save
    model, _ = _bert("bert_model")
    _save(model, path, sharded=False)
    texts, _ = load_corpus_jsonl(corpus)
    chip_smoke.write_bert_vocab(str(path), texts, vocab_size=200)
    return str(path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_directory_from_an_hf_bert_dir_equals_jax(tmp_path, corpus,
                                                        dtype):
    from sdag_tpu.retrieval.dense import DenseIndex as JaxDenseIndex
    from sdag_tpu_torch.retrieval.dense import DenseIndex
    ckpt = _bert_dir(tmp_path / "bert", corpus)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    flags = ["--ranker-checkpoint", ckpt, "--dtype", dtype,
             "--batch-size", "64"]
    jbuild.main([corpus, jdir] + flags)
    tbuild.main([corpus, tdir] + flags + ["--device", "cpu"])
    for name in ("manifest.json", "meta.jsonl"):
        with open(os.path.join(jdir, name), "rb") as fj, \
                open(os.path.join(tdir, name), "rb") as ft:
            assert fj.read() == ft.read(), name
    jemb = np.load(os.path.join(jdir, "embeddings.npy"))
    temb = np.load(os.path.join(tdir, "embeddings.npy"))
    assert temb.dtype == np.float32 and temb.shape == jemb.shape == (384, 64)
    if dtype == "float32":
        np.testing.assert_allclose(temb, jemb, atol=1e-5)
    else:
        # both are bf16 roundings of f32 embeddings within 1e-5 of each
        # other: equal but where the two f32 values straddle a rounding
        # boundary, then one bf16 step apart
        step = np.abs(jemb) * 2.0 ** -7
        assert np.all(np.abs(temb - jemb) <= step + 1e-6)
        assert np.mean(temb == jemb) > 0.99
    # each package loads the other's directory
    queries = temb[:5] + 0.01
    t_from_j = DenseIndex.load(jdir, search_mode="exact", device="cpu")
    j_from_t = JaxDenseIndex.load(tdir, search_mode="exact")
    ti, ts = t_from_j.search(queries, top_k=5)
    ji, js = j_from_t.search(queries, top_k=5)
    np.testing.assert_array_equal(np.asarray(ti)[:, 0], np.arange(5))
    np.testing.assert_array_equal(np.asarray(ji)[:, 0], np.arange(5))
    assert t_from_j.meta == j_from_t.meta


@pytest.mark.parametrize("flags", [["--bm25"], []], ids=["bm25", "dense"])
def test_build_index_defaults_to_cuda_and_raises_without_it(tmp_path,
                                                            corpus, flags):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        tbuild.main([corpus, str(tmp_path / "out")] + flags)
    assert not (tmp_path / "out").exists()


def test_manifest_records_the_corpus_size(tmp_path, corpus):
    tbuild.main([corpus, str(tmp_path / "d"), "--device", "cpu"])
    with open(tmp_path / "d" / "manifest.json") as fh:
        assert json.load(fh)["n"] == 384
