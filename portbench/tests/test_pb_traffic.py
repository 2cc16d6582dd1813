"""The traffic is a function of the seed alone, and its text has the
properties the references rely on."""

import numpy as np

from conftest import small
from portbench.common import textgen
from portbench.drivers import poison


def test_zipf_head_share():
    z = textgen.Zipf(32000, 1.0)
    d = z.draw(np.random.default_rng(0), 400_000)
    # P(rank 1) = 1 / H(32000) = 0.0930
    assert abs((d == 0).mean() - 0.0930) < 0.003
    assert abs((d == 1).mean() - 0.0465) < 0.002


def test_render_matches_join():
    words = textgen.pseudo_words(50, 1)
    rng = np.random.default_rng(2)
    flat, off = textgen.ragged(rng, textgen.Zipf(50, 1.0), 7, 1, 9)
    want = [" ".join(words[i] for i in flat[off[j]:off[j + 1]])
            for j in range(7)]
    assert textgen.render(words, flat, off) == want


def test_poison_traffic_is_a_function_of_the_seed(bench):
    cfg, tr = small(bench, "mistral7b.poison_top5")
    _, words = poison.vocabulary(cfg)
    a = poison.make_traffic(cfg, tr, words, 2 ** 33 + 5)
    b = poison.make_traffic(cfg, tr, words, 2 ** 33 + 5)
    c = poison.make_traffic(cfg, tr, words, 2 ** 33 + 6)
    for key in ("texts", "queries", "answers", "false", "mals"):
        assert a[key] == b[key]
    assert a["texts"] != c["texts"]
    lens = np.diff(a["offsets"])
    assert lens.min() >= tr["passage_words"][0]
    assert lens.max() <= tr["passage_words"][1]


def test_words_pass_the_bm25_analyzer_unchanged(bench):
    """The plain BM25 counts words as terms: the port's Lucene chain
    (stopwords, possessives, Porter) must leave every word as it is."""
    from sdag_tpu_torch.retrieval.analyzer import analyze_texts
    cfg, _ = small(bench, "mistral7b.poison_top5")
    words = textgen.pseudo_words(20000, cfg["assumed"]["lexicon_seed"])
    assert analyze_texts([" ".join(words)])[0] == words


def test_vocabulary_fills_the_decoder_ids(bench):
    from portbench import run
    _, cfg, _ = run.cell(bench, "mistral7b.poison_top5")
    head, words = poison.vocabulary(cfg)
    pieces = head + [" " + w for w in words]
    assert len(set(pieces)) == len(pieces) == 32506
    from sdag_tpu_torch.models.tokenizer import WordTokenizer
    assert WordTokenizer(pieces).vocab_size == cfg["vocab_size"]
