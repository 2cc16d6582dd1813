"""The PyTorch port (and its experiment scripts) imports neither jax nor
the JAX package, nor the HF libraries (transformers, tokenizers,
safetensors, regex), and its entry points refuse to run without CUDA
unless asked for the CPU."""

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


# the JAX side, and the HF libraries the port reads its files without
BLOCKED = ("jax", "jaxlib", "sdag_tpu", "transformers", "tokenizers",
           "safetensors", "regex")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in BLOCKED


_BLOCK = r"""
import importlib.abc, sys
BLOCKED = %r
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
""" % (BLOCKED,)

_BLOCKER = _BLOCK + r"""
import importlib
for mod in sys.argv[1:]:
    importlib.import_module(mod)
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("imported", len(sys.argv) - 1)
"""


def test_the_ranker_path_modules_are_covered():
    """The module walk below reaches the second slice's modules."""
    mods = set(_port_modules())
    for mod in ("models.e5", "ops.encoder_attention", "ops.topk", "ops.rrf",
                "retrieval.dense", "retrieval.hybrid", "sdag.knn"):
        assert f"sdag_tpu_torch.{mod}" in mods


def test_the_mesh_modules_are_covered():
    """The module walk reaches the torch.distributed slice's modules."""
    mods = set(_port_modules())
    for mod in ("core.mesh", "parallel.sharding", "parallel.collectives",
                "parallel.context", "parallel.launch"):
        assert f"sdag_tpu_torch.{mod}" in mods


def test_the_training_modules_are_covered():
    """The module walk reaches the training slice's modules."""
    mods = set(_port_modules())
    for mod in ("parallel.train", "parallel.checkpoint", "parallel.pipeline",
                "pipeline.train_qa", "utils.tree"):
        assert f"sdag_tpu_torch.{mod}" in mods


def test_every_port_module_imports_with_jax_and_sdag_tpu_blocked():
    mods = _port_modules() + ["chip_smoke"]
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _BLOCKER, *mods], cwd=REPO,
                         env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert f"imported {len(mods)}" in out.stdout


def test_hf_dirs_read_and_render_with_the_hf_libraries_blocked(tmp_path):
    """The HF checkpoint path at run time: chip_smoke writes a Llama-3-style
    tokenizer and a tiny sharded checkpoint without any library; the port
    reads both, encodes, decodes and renders the chat template (jinja2 is
    allowed) with jax, the JAX package and the HF libraries blocked."""
    script = _BLOCK + r"""
import json, os, sys, torch
import chip_smoke
from sdag_tpu_torch.models.hf_convert import load_decoder_checkpoint
from sdag_tpu_torch.models.llama import DecoderConfig
from sdag_tpu_torch.models.tokenizer import load_tokenizer
d = sys.argv[1]
chip_smoke.write_llama_tokenizer(d, ["Hello there, world!"], n_merges=20)
cfg = DecoderConfig.tiny()
chip_smoke.write_hf_checkpoint(d, chip_smoke.llama_hf_specs(cfg),
                               torch.bfloat16, "cpu", shards=2, seed=3)
json.dump({"vocab_size": cfg.vocab_size, "hidden_size": cfg.d_model,
           "num_hidden_layers": cfg.n_layers,
           "num_attention_heads": cfg.n_heads,
           "num_key_value_heads": cfg.n_kv_heads,
           "intermediate_size": cfg.d_ff, "tie_word_embeddings": True},
          open(os.path.join(d, "config.json"), "w"))
params, _ = load_decoder_checkpoint(d, device="cpu")
assert not chip_smoke._tree_bit_equal(params, chip_smoke.llama_hf_specs(cfg),
                                      torch.bfloat16, "cpu", 3, llama=True)
tok = load_tokenizer(d)
chat = tok.apply_chat_template([{"role": "user", "content": "Hello!"}])
ids = tok.encode(chat, add_special_tokens=False)
assert ids[0] == 128000 and tok.decode(ids) == chat, (ids, chat)
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("read", len(ids))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert "read" in out.stdout


# the port's experiment scripts, beside the JAX package's
SCRIPTS = [os.path.join(REPO, "experiments", f)
           for f in ("run_sdag_effect_torch.py", "compare_sdag_effect.py")]


def test_the_experiment_scripts_import_with_jax_and_sdag_tpu_blocked():
    script = _BLOCK + r"""
import importlib.util
for path in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location("m", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("imported", len(sys.argv) - 1)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script, *SCRIPTS], cwd=REPO,
                         env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert f"imported {len(SCRIPTS)}" in out.stdout


@pytest.mark.parametrize("path", sorted(
    [os.path.join(r, f) for r, _d, fs in os.walk(PKG) for f in fs
     if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    + SCRIPTS),
    ids=lambda p: os.path.relpath(p, REPO))
def test_no_static_import_of_jax_or_sdag_tpu(path):
    """Imports inside functions (never executed by the import test) are
    checked statically, the HF libraries' too."""
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


def _entry_load_decoder_checkpoint(tmp_path):
    from sdag_tpu_torch.models.hf_convert import load_decoder_checkpoint
    load_decoder_checkpoint(str(tmp_path))


def _entry_load_encoder_checkpoint(tmp_path):
    from sdag_tpu_torch.models.hf_convert import load_encoder_checkpoint
    load_encoder_checkpoint(str(tmp_path))


def _entry_open_checkpoint(tmp_path):
    from sdag_tpu_torch.models.safetensors_io import open_checkpoint
    open_checkpoint(str(tmp_path))


def _entry_run_experiment_defenses(tmp_path):
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    cfg = _csv_cfg(tmp_path)
    cfg.DEFENSE_BACKEND = "ragdefender"
    run_experiment(cfg)


def _entry_build_index(tmp_path):
    from sdag_tpu_torch.pipeline.build_index import main
    cfg = _csv_cfg(tmp_path)
    main([cfg.CORPUS_JSONL_PATH, str(tmp_path / "index")])


def _entry_poisoned_rag(tmp_path):
    import json
    from sdag_tpu_torch.attack.poisoned_rag import main
    path = tmp_path / "samples.json"
    path.write_text(json.dumps([{"id": "q", "question": "q?",
                                 "short_answers": ["a"]}]))
    main(["--samples_json", str(path), "--out_csv", str(tmp_path / "a.csv")])


def _entry_train_qa(tmp_path):
    from sdag_tpu_torch.pipeline.train_qa import main
    main(["--out", str(tmp_path / "ckpt"), "--steps", "1"])


@pytest.mark.parametrize("entry", [
    _entry_train_qa, _entry_run_experiment, _entry_init_resources, _entry_build_generator,
    _entry_generator, _entry_bm25_index, _entry_cli, _entry_build_encoder,
    _entry_e5_encoder, _entry_init_encoder_params, _entry_dense_index,
    _entry_run_experiment_dense, _entry_load_decoder_checkpoint,
    _entry_load_encoder_checkpoint, _entry_open_checkpoint,
    _entry_run_experiment_defenses, _entry_build_index,
    _entry_poisoned_rag],
    ids=lambda f: f.__name__[len("_entry_"):])
def test_entry_points_default_to_cuda_and_raise_without_it(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        entry(tmp_path)
