"""The port's offline PoisonedRAG CLI against the JAX package's: every case
of test_poisoned_rag.py through both packages (equal rows and CSV bytes),
generate_false_answers_and_docs with greedy generators built from one
qa_ckpt tree (JAX's rows), and the three dataset samplers and
load_queries_unified on an uncached JSON through a stub ``datasets``
module (in-repo rows, no download)."""

import json
import os
import sys
import types
from dataclasses import asdict

import numpy as np
import pytest
import torch

from sdag_tpu.attack import poisoned_rag as jpr
from sdag_tpu.utils.parsing import load_from_csv as jax_load_from_csv
from sdag_tpu_torch.attack import poisoned_rag as tpr
from sdag_tpu_torch.utils.parsing import load_from_csv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "experiments", "data", "qa_ckpt")

MODS = [jpr, tpr]

SAMPLES = [
    {"id": "q1", "question": "capital of france?", "short_answers": ["Paris"]},
    {"id": "q2", "question": "author of hamlet?",
     "short_answers": ["Shakespeare", "William Shakespeare"]},
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fake_clients(log):
    def fa(system, user, max_tokens):
        log.append(("fa", user))
        return "Lyon\n"

    def doc(system, user, max_tokens):
        log.append(("doc", user))
        return " A supporting doc. "
    return {"false_answer": fa, "false_doc": doc}


def _both(fn):
    """fn(module) for the JAX package and the port: results must be
    equal; returns the port's."""
    j, t = fn(jpr), fn(tpr)
    assert j == t
    return t


def test_generate_and_csv_roundtrip(tmp_path):
    logs = {}

    def run(mod):
        log = logs.setdefault(mod.__name__, [])
        rows = mod.generate_false_answers_and_docs(SAMPLES, fake_clients(log))
        path = str(tmp_path / f"{mod.__name__}.csv")
        mod.save_results_to_csv(rows, path)
        with open(path, "rb") as fh:
            return rows, log, fh.read()

    rows, log, raw = _both(run)
    assert len(rows) == 2
    assert rows[0]["false_answer"] == "Lyon"
    assert rows[0]["malicious_document"] == "A supporting doc."
    # GT answers embedded in the false-answer prompt
    fa_prompts = [u for kind, u in log if kind == "fa"]
    assert "Paris" in fa_prompts[0]
    assert "William Shakespeare" in fa_prompts[1]
    qd = load_from_csv(str(tmp_path / f"{tpr.__name__}.csv"))
    assert qd.questions == ["capital of france?", "author of hamlet?"]
    assert qd.short_answers[1] == ["Shakespeare", "William Shakespeare"]
    assert qd.false_answer_groups[0] == ["Lyon"]
    assert asdict(qd) == asdict(jax_load_from_csv(
        str(tmp_path / f"{jpr.__name__}.csv")))


def test_avoid_list_reaches_prompt(tmp_path):
    prev = tmp_path / "prev.csv"
    prev.write_text("query,false_answer\ncapital of france?,Marseille\n")

    def run(mod):
        avoid = mod.load_avoid_false_answers_from_csvs([str(prev)])
        log = []
        mod.generate_false_answers_and_docs(SAMPLES, fake_clients(log),
                                            avoid_false_by_key=avoid)
        return avoid, log

    _avoid, log = _both(run)
    fa_prompt = [u for kind, u in log if kind == "fa"][0]
    assert "Marseille" in fa_prompt and "Paris" in fa_prompt


def test_preset_false_answers_skip_generation(tmp_path):
    preset = tmp_path / "preset.csv"
    preset.write_text("query,false_answer\ncapital of france?,Nice\n")

    def run(mod):
        presets = mod.load_false_answers_csv(str(preset), key_field="query")
        log = []
        rows = mod.generate_false_answers_and_docs(
            SAMPLES, fake_clients(log), csv_false_answers=presets,
            json_query_id_field="question")
        return rows, log

    rows, log = _both(run)
    # q2 has no preset -> skipped; no false-answer generation calls at all
    assert len(rows) == 1
    assert rows[0]["false_answer"] == "Nice"
    assert not any(kind == "fa" for kind, _ in log)


def test_an_empty_preset_csv_raises(tmp_path):
    empty = tmp_path / "empty.csv"
    empty.write_text("query,false_answer\n")
    for mod in MODS:
        with pytest.raises(ValueError, match="No usable rows"):
            mod.load_false_answers_csv(str(empty))


def test_uniform_take_per_bucket():
    buckets = {"easy": list(range(0, 10)), "medium": list(range(10, 13)),
               "hard": list(range(20, 40))}
    out = _both(lambda mod: mod.uniform_take_per_bucket(
        {k: list(v) for k, v in buckets.items()}, total=12, seed=0))
    assert len(out) == 12 and len(set(out)) == 12
    # medium bucket exhausted (3), shortage refilled from leftovers
    assert sum(1 for i in out if 10 <= i < 13) == 3


@pytest.mark.parametrize("ex,want", [
    ({"annotations": {"short_answers": [{"text": ["a", "b"]}]}}, ["a", "b"]),
    ({"annotations": [{"short_answers": [{"text": "c"}]}]}, ["c"]),
    ({"short_answers": ["d", "d"]}, ["d"]),
    ({}, []),
])
def test_collect_short_answers_nq_variants(ex, want):
    assert _both(lambda mod: mod.collect_short_answers_nq(ex)) == want


def test_false_answer_prompt_format():
    p = _both(lambda mod: mod.build_false_answer_prompt("q?", ["A", "B"]))
    assert "- A" in p and "- B" in p and "q?" in p
    assert _both(lambda mod: mod.build_false_answer_prompt("q?", [])) \
        .endswith("- (none)\n\nYour incorrect answer:")
    assert tpr.SYSTEM_PROMPT_FALSE_DOC == jpr.SYSTEM_PROMPT_FALSE_DOC
    assert tpr.USER_FALSE_DOC_PROMPT == jpr.USER_FALSE_DOC_PROMPT


def test_cli_with_cached_samples_and_local_backend(tmp_path):
    """The port's CLI on the CPU (random tiny weights from its own
    generator, so the text is not JAX's; the qa_ckpt test below holds the
    text)."""
    samples_json = tmp_path / "samples.json"
    samples_json.write_text(json.dumps(SAMPLES))
    out_csv = tmp_path / "out.csv"
    argv = ["--dataset", "nq", "--samples_json", str(samples_json),
            "--out_csv", str(out_csv), "--backend", "local",
            "--max_tokens_false", "3", "--max_tokens_doc", "4",
            "--temperature", "0"]
    tpr.main(argv + ["--device", "cpu"])
    qd = load_from_csv(str(out_csv))
    assert len(qd) == 2
    first = out_csv.read_bytes()
    tpr.main(argv + ["--device", "cpu"])
    assert out_csv.read_bytes() == first      # greedy: the same file


def test_cli_defaults_to_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable here")
    samples_json = tmp_path / "samples.json"
    samples_json.write_text(json.dumps(SAMPLES))
    with pytest.raises(RuntimeError, match="cuda"):
        tpr.main(["--samples_json", str(samples_json),
                  "--out_csv", str(tmp_path / "out.csv")])
    assert not (tmp_path / "out.csv").exists()


@pytest.mark.skipif(
    not os.path.isfile(os.path.join(CKPT, "native_decoder.json")),
    reason="trained qa_ckpt not present")
def test_local_generate_on_qa_ckpt_writes_jax_rows(tmp_path):
    """Greedy generators built from one qa_ckpt tree: the same rows, the
    same CSV bytes."""
    from sdag_tpu.models.native_ckpt import load_decoder as jax_load
    from sdag_tpu.sdag.generate import Generator as JaxGenerator
    from sdag_tpu_torch.models.native_ckpt import load_decoder
    from sdag_tpu_torch.models.tokenizer import load_tokenizer
    from sdag_tpu_torch.sdag.generate import Generator
    tok = load_tokenizer(CKPT)
    jparams, jcfg = jax_load(CKPT)
    tparams, tcfg = load_decoder(CKPT, device="cpu")
    gens = {jpr: JaxGenerator(jparams, jcfg, tok, temperature=0.0,
                              batch_bucket=1),
            tpr: Generator(tparams, tcfg, tok, temperature=0.0,
                           batch_bucket=1, device="cpu")}

    def run(mod):
        rows = mod.generate_false_answers_and_docs(
            SAMPLES, mod.make_local_generate(gens[mod]),
            max_tokens_false=8, max_tokens_doc=16)
        path = str(tmp_path / f"{mod.__name__}.csv")
        mod.save_results_to_csv(rows, path)
        with open(path, "rb") as fh:
            return rows, fh.read()

    rows, _ = _both(run)
    assert len(rows) == 2


# ------------------------------------------------------------- samplers
class FakeDataset:
    """What the samplers use of a ``datasets.Dataset``."""

    def __init__(self, rows):
        self.rows = list(rows)

    def filter(self, fn):
        return FakeDataset(r for r in self.rows if fn(r))

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]

    def __iter__(self):
        return iter(self.rows)


NQ_ROWS = [
    {"id": f"nq{i}", "question": {"text": f"nq question {i}?"},
     "annotations": {"short_answers": [{"text": [f"ans {i}"]}]
                     if i % 3 else [{"text": []}]}}
    for i in range(12)]
HOTPOT_ROWS = [
    {"id": f"hp{i}", "question": f"hotpot question {i}?",
     "answer": f"hp ans {i}", "type": "bridge" if i % 4 else "comparison",
     "level": ("easy", "medium", "hard")[i % 3]}
    for i in range(15)]
TRIVIA_ROWS = [
    {"question_id": f"tq{i}", "question": f"trivia question {i}?",
     "answer": {"value": f"tq ans {i}", "aliases": [f"alias {i}",
                                                    f"tq ans {i}"]}}
    for i in range(10)]
DATASETS = {("natural_questions",): NQ_ROWS,
            ("hotpot_qa", "fullwiki"): HOTPOT_ROWS,
            ("trivia_qa", "rc.wikipedia"): TRIVIA_ROWS}


@pytest.fixture
def stub_datasets(monkeypatch):
    calls = []

    def load_dataset(*name, split):
        calls.append((name, split))
        return FakeDataset(DATASETS[name])

    monkeypatch.setitem(sys.modules, "datasets",
                        types.SimpleNamespace(load_dataset=load_dataset))
    return calls


@pytest.mark.parametrize("dataset,n", [("nq", 5), ("hotpotqa", 7),
                                       ("triviaqa", 4)])
def test_samplers_through_a_stub_datasets_module(tmp_path, stub_datasets,
                                                 dataset, n):
    def run(mod):
        path = str(tmp_path / f"{mod.__name__}_{dataset}.json")
        rows = mod.SAMPLERS[dataset](n, 7, "validation", path)
        with open(path, encoding="utf-8") as fh:
            saved = json.load(fh)
        # a second call reads the cache and loads no dataset
        before = len(stub_datasets)
        assert mod.SAMPLERS[dataset](n, 7, "validation", path) == rows
        assert len(stub_datasets) == before
        return rows, saved

    rows, saved = _both(run)
    assert rows == saved and 0 < len(rows) <= n
    assert all(r["short_answers"] for r in rows)
    assert sorted(set(jpr.SAMPLERS)) == sorted(set(tpr.SAMPLERS))


def test_load_queries_unified_samples_an_uncached_json(tmp_path,
                                                       stub_datasets):
    from sdag_tpu.config import Config as JaxConfig
    from sdag_tpu.pipeline.orchestrator import \
        load_queries_unified as jax_load
    from sdag_tpu_torch.config import Config
    from sdag_tpu_torch.pipeline.orchestrator import load_queries_unified
    out = []
    for cls, load in ((JaxConfig, jax_load), (Config, load_queries_unified)):
        cfg = cls()
        cfg.DATASET_NAME = "hotpotqa"
        cfg.SAMPLE_SIZE = 6
        cfg.SAMPLED_QUERIES_JSON = str(tmp_path / f"{cls.__module__}.json")
        out.append(load(cfg))
        assert os.path.exists(cfg.SAMPLED_QUERIES_JSON)
    assert asdict(out[0]) == asdict(out[1])
    assert len(out[1]) == 6 and out[1].false_answer_groups is None
    assert len(stub_datasets) == 2
    np.testing.assert_array_equal(
        [q.startswith("hotpot question") for q in out[1].questions], True)
