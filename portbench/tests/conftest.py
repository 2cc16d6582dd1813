"""Small sizes of the benchmark's cells for CPU tests, and the ``chip``
marker of the tests that need an NVIDIA card (they skip elsewhere; the
decision is made in the ``cuda_device`` fixture, never at import).

Run: ``python -m pytest portbench/tests -q`` (CPU); on the card the
``chip`` tests run too."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs an NVIDIA card (skips elsewhere)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def bench():
    from portbench import run
    return run.load_json("BENCHMARK.json")


def small(bench, name):
    """(configuration, traffic) of a cell at a size the CPU holds: every
    width cut, the traffic's shape kept."""
    from portbench import run
    _, cfg, tr = run.cell(bench, name)
    cfg = dict(cfg, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2,
               intermediate_size=128, vocab_size=1024,
               torch_dtype="float32", corpus_docs=300)
    tr = dict(tr, passage_words=[20, 30],
              query_words=[4, 8], malicious_words=[10, 15],
              llm_batch=2, query_batch=4, max_new_tokens=4, queries=64,
              warmup_padded_lens=[128],
              top_k=min(int(tr["top_k"]), 4), check_requests=2,
              check_bm25_queries=8,
              max_malicious_docs=min(int(tr["max_malicious_docs"]), 2))
    return cfg, tr
