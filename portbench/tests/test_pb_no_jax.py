"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level module name (``sdag_tpu_torch`` starts with ``sdag_tpu`` and is
the port)."""

import ast
import os
import subprocess
import sys
import types

from conftest import ROOT
from portbench import run


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("sdag_tpu_torch", "sdag_tpu_torch.models", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    base = set(run.forbidden_modules())
    assert "sdag_tpu_torch" not in base and "jaxtyping" not in base
    monkeypatch.setitem(sys.modules, "sdag_tpu.models",
                        types.ModuleType("sdag_tpu.models"))
    assert "sdag_tpu" in run.forbidden_modules()


def test_no_harness_source_imports_jax():
    bad = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                bad += [(f, n) for n in names if n.split(".")[0] in
                        run.FORBIDDEN or n.split(".")[0] in
                        ("bench", "benchmarks")]
    assert not bad


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {ROOT!r}); sys.path.insert(0, "
        f"{os.path.join(ROOT, 'portbench', 'tests')!r})\n"
        "from conftest import small\n"
        "from portbench import run\n"
        "bench = run.load_json('BENCHMARK.json')\n"
        "for name in ('mistral7b.poison_top5', 'mistral7b.poison_top20'):\n"
        "    cfg, tr = small(bench, name)\n"
        "    r = run.run_cell(bench, name, 7, 0.2, False,\n"
        "                     torch.device('cpu'), cfg=cfg, tr=tr)\n"
        "    assert r['correct'], r\n"
        "print('FORBIDDEN', run.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "FORBIDDEN []" in p.stdout
