"""The PyTorch port imports neither jax nor the JAX package, and its entry
points refuse to run without CUDA unless asked for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sdag_tpu_torch")


def _port_modules():
    mods = []
    for root, _dirs, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib") or top == "sdag_tpu"


_BLOCKER = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib") or name == "sdag_tpu" \
                or name.startswith("sdag_tpu."):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import importlib
for mod in sys.argv[1:]:
    importlib.import_module(mod)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
       or m == "sdag_tpu" or m.startswith("sdag_tpu.")]
assert not bad, bad
print("imported", len(sys.argv) - 1)
"""


def test_the_ranker_path_modules_are_covered():
    """The module walk below reaches the second slice's modules."""
    mods = set(_port_modules())
    for mod in ("models.e5", "ops.encoder_attention", "ops.topk", "ops.rrf",
                "retrieval.dense", "retrieval.hybrid", "sdag.knn"):
        assert f"sdag_tpu_torch.{mod}" in mods


def test_every_port_module_imports_with_jax_and_sdag_tpu_blocked():
    mods = _port_modules() + ["chip_smoke"]
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _BLOCKER, *mods], cwd=REPO,
                         env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert f"imported {len(mods)}" in out.stdout


@pytest.mark.parametrize("path", sorted(
    [os.path.join(r, f) for r, _d, fs in os.walk(PKG) for f in fs
     if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]),
    ids=lambda p: os.path.relpath(p, REPO))
def test_no_static_import_of_jax_or_sdag_tpu(path):
    """Imports inside functions (never executed by the import test) are
    checked statically."""
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert not _forbidden(name), (path, node.lineno, name)


def _csv_cfg(tmp_path):
    from sdag_tpu_torch.config import Config
    from sdag_tpu_torch.utils.synth_qa import (load_world, write_attack_csv,
                                               write_corpus_jsonl)
    world = load_world(os.path.join(REPO, "experiments", "data", "qa_ckpt",
                                    "world.json"))
    write_corpus_jsonl(world, str(tmp_path / "corpus.jsonl"))
    write_attack_csv(world, str(tmp_path / "attack.csv"),
                     world.eval_entities[:1], n_mal=1)
    cfg = Config()
    cfg.CSV_INPUT_PATH = str(tmp_path / "attack.csv")
    cfg.CORPUS_JSONL_PATH = str(tmp_path / "corpus.jsonl")
    cfg.RETRIEVER_BACKEND = "sparse"
    cfg.OUTPUT_CSV_BASE = str(tmp_path / "out")
    return cfg


def _entry_run_experiment(tmp_path):
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    run_experiment(_csv_cfg(tmp_path))


def _entry_init_resources(tmp_path):
    from sdag_tpu_torch.pipeline.resources import init_resources
    init_resources(_csv_cfg(tmp_path))


def _entry_build_generator(tmp_path):
    from sdag_tpu_torch.pipeline.resources import build_generator
    build_generator(_csv_cfg(tmp_path))


def _entry_generator(tmp_path):
    from sdag_tpu_torch.models.llama import (DecoderConfig,
                                             init_decoder_params)
    from sdag_tpu_torch.models.tokenizer import ByteTokenizer
    from sdag_tpu_torch.sdag.generate import Generator
    cfg = DecoderConfig.tiny()
    params = init_decoder_params(torch.Generator(), cfg, device="cpu")
    Generator(params, cfg, ByteTokenizer())


def _entry_bm25_index(tmp_path):
    from sdag_tpu_torch.retrieval.sparse import BM25Index
    BM25Index.from_texts(["a b c", "b c d"], ["d0", "d1"])


def _entry_build_encoder(tmp_path):
    from sdag_tpu_torch.pipeline.resources import build_encoder
    build_encoder(_csv_cfg(tmp_path))


def _entry_e5_encoder(tmp_path):
    from sdag_tpu_torch.models.e5 import E5Encoder, EncoderConfig
    from sdag_tpu_torch.models.tokenizer import ByteTokenizer
    E5Encoder({"layers": []}, EncoderConfig.tiny(), ByteTokenizer())


def _entry_init_encoder_params(tmp_path):
    from sdag_tpu_torch.models.e5 import EncoderConfig, init_encoder_params
    init_encoder_params(torch.Generator(), EncoderConfig.tiny())


def _entry_dense_index(tmp_path):
    import numpy as np
    from sdag_tpu_torch.retrieval.dense import DenseIndex
    DenseIndex(np.zeros((2, 8), np.float32), [{"id": "a"}, {"id": "b"}])


def _entry_run_experiment_dense(tmp_path):
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    cfg = _csv_cfg(tmp_path)
    cfg.RETRIEVER_BACKEND = "dense"
    run_experiment(cfg)


def _entry_cli(tmp_path):
    import json
    from sdag_tpu_torch.config import Config
    from sdag_tpu_torch.pipeline.cli import main
    cfg = _csv_cfg(tmp_path)
    keys = ("CSV_INPUT_PATH", "CORPUS_JSONL_PATH", "RETRIEVER_BACKEND",
            "OUTPUT_CSV_BASE")
    assert isinstance(cfg, Config)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({k: getattr(cfg, k) for k in keys}))
    main([str(path)])


@pytest.mark.parametrize("entry", [
    _entry_run_experiment, _entry_init_resources, _entry_build_generator,
    _entry_generator, _entry_bm25_index, _entry_cli, _entry_build_encoder,
    _entry_e5_encoder, _entry_init_encoder_params, _entry_dense_index,
    _entry_run_experiment_dense],
    ids=lambda f: f.__name__[len("_entry_"):])
def test_entry_points_default_to_cuda_and_raise_without_it(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        entry(tmp_path)
