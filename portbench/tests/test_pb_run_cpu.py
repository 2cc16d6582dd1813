"""Each cell driven end to end at a small size on the CPU (the look for a
card skipped): sound runs come out correct, and with the timed path
broken underneath, ``correct`` comes out false, once for each fault the
cell can have (an answer altered where it is produced; half of a batch
left out)."""

import pytest
import torch

from conftest import small
from portbench import run

CPU = torch.device("cpu")
SEED = 2 ** 32 + 12345          # wider than 32 signed bits


def _run(bench, name, **kw):
    cfg, tr = small(bench, name)
    return run.run_cell(bench, name, SEED, 0.3, False, CPU, cfg=cfg, tr=tr,
                        **kw)


@pytest.mark.parametrize("name", ["mistral7b.poison_top5",
                                  "mistral7b.poison_top20"])
def test_sound_run_is_correct(bench, name):
    res = _run(bench, name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]}
    assert set(res["metrics"]) == e2e


def _poison_fault(monkeypatch, kind):
    from sdag_tpu_torch.sdag.generate import Generator
    real = Generator._generate

    def broken(self, *a, **k):
        out, lengths = real(self, *a, **k)
        out = out.clone()
        if kind == "token":
            out[0, 1] = (out[0, 1] + 7) % self.cfg.vocab_size
        else:
            lengths = lengths.clone()
            lengths[lengths.shape[0] // 2:] = 0
        return out, lengths
    monkeypatch.setattr(Generator, "_generate", broken)


@pytest.mark.parametrize("kind", ["token", "half_batch", "retrieved_id"])
def test_poison_faults_are_caught(bench, monkeypatch, kind):
    if kind == "retrieved_id":
        from sdag_tpu_torch.retrieval.sparse import BM25Index
        real = BM25Index.search

        def broken(self, queries, top_k):
            idx, sc = real(self, queries, top_k)
            idx = idx.copy()
            idx[0, 0] = (idx[0, 0] + 1) % self.valid_n
            return idx, sc
        monkeypatch.setattr(BM25Index, "search", broken)
        cfg, tr = small(bench, "mistral7b.poison_top5")
        tr = dict(tr, check_bm25_queries=10 ** 6)
        res = run.run_cell(bench, "mistral7b.poison_top5", SEED, 0.3, False,
                           CPU, cfg=cfg, tr=tr)
    else:
        _poison_fault(monkeypatch, kind)
        res = _run(bench, "mistral7b.poison_top5")
    assert not res["correct"], res["checks"]


def test_lower_precision_controls_read_higher(bench):
    """The program's int8 path and the BM25 reference in TF32 read above
    the sound runs on the same seed."""
    cfg, tr = small(bench, "mistral7b.poison_top5")
    tr = dict(tr, check_requests=16, max_new_tokens=8)
    sound, ctl = (run.run_cell(bench, "mistral7b.poison_top5", SEED, 0.3,
                               False, CPU, cfg=cfg, tr=tr, control=c,
                               ref_control=True)["checks"]
                  for c in ("", "int8"))
    assert ctl["served_gap_mean"]["value"] > \
        sound["served_gap_mean"]["value"]
    assert sound["control_tf32.bm25_gap"]["value"] > \
        10 * sound["bm25_gap"]["value"]
