"""The port's SDAG-effect driver against the JAX package's: the same grid
config, corpus and attack CSV on a tiny grid (subprocess.run stubbed),
differing only in the CLI module and its --device; the same summary
files; its default device raising without CUDA; and the row-by-row
comparison script over the committed JAX CPU reference."""

import csv
import gzip
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(REPO, "experiments")
CKPT = os.path.join(EXP, "data", "qa_ckpt")
REF = os.path.join(EXP, "results", "sdag_effect_jax_cpu")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXP, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def drivers():
    return _load("run_sdag_effect"), _load("run_sdag_effect_torch")


def _stub_run(calls):
    """subprocess.run that records the command and the config it points at,
    and writes the per-cell JSON the driver reads back."""

    def run(cmd, cwd=None, env=None, capture_output=False, text=False):
        cfg_path = next(c for c in cmd if c.endswith("config.json"))
        with open(cfg_path) as fh:
            cfg = json.load(fh)
        calls.append((list(cmd), cfg))
        for k, pos in zip(cfg["TOP_K"], cfg["ADD_ATTACK_IN_RANK"]):
            stats = {m: {"ground_truth_match_rate": 0.5 + pos / 10,
                         "false_answer_match_rate": pos / 8}
                     for m in ("iso", "no_iso")}
            path = (f"{cfg['OUTPUT_CSV_BASE']}_top_k={k}"
                    f"_attacker_pos={pos}.json")
            with open(path, "w") as fh:
                json.dump({"answer_match_stats": stats}, fh)
        return types.SimpleNamespace(returncode=0, stdout="[spec] x\n",
                                     stderr="")
    return run


@pytest.mark.skipif(not os.path.isfile(os.path.join(CKPT, "world.json")),
                    reason="qa_ckpt world not present")
@pytest.mark.parametrize("n_mal,nk,spec", [(2, 0, 0), (1, 2, 4)])
def test_grid_config_equals_the_jax_drivers(tmp_path, monkeypatch, drivers,
                                            n_mal, nk, spec):
    jdrv, tdrv = drivers
    out = str(tmp_path / "grid")
    seen = {}
    for tag, mod, dev_arg in (("jax", jdrv, "cpu"), ("torch", tdrv, "cpu")):
        calls = []
        monkeypatch.setattr(mod.subprocess, "run", _stub_run(calls))
        rows = mod.run_grid(CKPT, out, n_mal, [0, 1], 5, 0.0, dev_arg,
                            speculative=spec, neighbors_k=nk)
        with open(os.path.join(out, f"attack_nmal{n_mal}.csv"), "rb") as fh:
            attack = fh.read()
        with open(os.path.join(out, "corpus.jsonl"), "rb") as fh:
            corpus = fh.read()
        run_dir = os.path.join(out, f"nmal{n_mal}" + (f"_k{nk}" if nk
                                                       else ""))
        with open(os.path.join(run_dir, "wall.json")) as fh:
            wall = json.load(fh)
        seen[tag] = (calls, rows, attack, corpus, wall)
    (jcalls, jrows, jattack, jcorpus, jwall), \
        (tcalls, trows, tattack, tcorpus, twall) = seen["jax"], seen["torch"]
    assert len(jcalls) == len(tcalls) == 1
    assert tcalls[0][1] == jcalls[0][1]               # the config dict
    assert tcalls[0][1]["DOC_NEIGHBORS_K"] == nk
    assert tcalls[0][1]["SPECULATIVE_DRAFT_LEN"] == spec
    assert jcalls[0][0][1:] == ["-m", "sdag_tpu.pipeline.cli",
                                jcalls[0][0][3]]
    assert tcalls[0][0][1:] == ["-m", "sdag_tpu_torch.pipeline.cli",
                                jcalls[0][0][3], "--device", "cpu"]
    assert trows == jrows and tattack == jattack and tcorpus == jcorpus
    assert twall.pop("device") == "cpu"
    twall.pop("wall_s"), jwall.pop("wall_s")
    assert twall == jwall


@pytest.mark.skipif(not os.path.isfile(os.path.join(CKPT, "world.json")),
                    reason="qa_ckpt world not present")
def test_main_writes_the_jax_drivers_summary(tmp_path, monkeypatch,
                                             drivers):
    jdrv, tdrv = drivers
    files = {}
    for tag, mod, extra in (("jax", jdrv, ["--platform", "cpu"]),
                            ("torch", tdrv, ["--device", "cpu"])):
        monkeypatch.setattr(mod.subprocess, "run", _stub_run([]))
        out = tmp_path / tag
        argv = ["--ckpt", CKPT, "--out", str(out), "--n-mal", "1", "2",
                "--positions", "0", "3"] + extra
        monkeypatch.setattr(sys, "argv", ["driver"] + argv)
        if tag == "jax":
            mod.main()
        else:
            mod.main(argv)
        files[tag] = [(out / n).read_bytes()
                      for n in ("summary.json", "SUMMARY.md")]
    assert files["torch"] == files["jax"]


@pytest.mark.skipif(not os.path.isfile(os.path.join(CKPT, "world.json")),
                    reason="qa_ckpt world not present")
def test_driver_defaults_to_cuda_and_raises_without_it(tmp_path, drivers):
    """The real CLI subprocess: without CUDA it raises, the driver exits
    non-zero and run.log says why."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable here")
    _, tdrv = drivers
    with pytest.raises(SystemExit):
        tdrv.run_grid(CKPT, str(tmp_path), 1, [0], 5, 0.0)
    with open(tmp_path / "nmal1" / "run.log") as fh:
        log = fh.read()
    assert "torch.cuda.is_available() is False" in log
    with open(tmp_path / "nmal1" / "wall.json") as fh:
        assert json.load(fh)["rc"] != 0


def _copy_reference(dst, edit=None):
    shutil.copytree(REF, dst)
    if edit:
        cell = os.path.join(dst, "nmal2", "results_top_k=5_attacker_pos=1.csv")
        with gzip.open(cell + ".gz", "rt", encoding="utf-8",
                       newline="") as fh:
            rows = list(csv.DictReader(fh))
        for r in rows[:edit]:
            r["rag_answer_noiso"] += " x"
        os.remove(cell + ".gz")
        with open(cell, "w", encoding="utf-8", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)


@pytest.mark.parametrize("edit", [0, 2, 3])
def test_compare_script_counts_differing_rows(tmp_path, capsys, edit):
    cmp_mod = _load("compare_sdag_effect")
    run = str(tmp_path / "run")
    _copy_reference(run, edit)
    result = cmp_mod.compare_dirs(REF, run)
    assert len(result) == 9                    # 3 n_mal x 3 positions
    assert all(r["rows"] == 96 for r in result.values())
    differ = {c: len(r["differ"]) for c, r in result.items()
              if r["differ"]}
    assert differ == ({"nmal2/results_top_k=5_attacker_pos=1.csv": edit}
                      if edit else {})
    assert cmp_mod.main([REF, run]) == 0
    printed = capsys.readouterr().out
    assert (f"nmal2/results_top_k=5_attacker_pos=1.csv: 96 rows, {edit} "
            "differ") in printed
    assert printed.count('"query_id"') == edit


def test_compare_script_refuses_a_missing_cell(tmp_path):
    cmp_mod = _load("compare_sdag_effect")
    ref = str(tmp_path / "ref")
    _copy_reference(ref)
    os.remove(os.path.join(ref, "nmal5", "results_top_k=5_attacker_pos=3"
                                         ".csv.gz"))
    out = subprocess.run([sys.executable,
                          os.path.join(EXP, "compare_sdag_effect.py"),
                          ref, REF], capture_output=True, text=True)
    assert out.returncode == 1 and "missing" in out.stdout
