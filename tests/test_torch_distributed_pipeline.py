"""The port's pipeline on two gloo ranks against the JAX package on two
devices: ``run_experiment`` with MESH_DATA=2 on the committed qa_ckpt
world (decoder batches split over the data ranks, the BM25 index
row-sharded over both) writes, from rank 0 alone, the answers CSV of the
JAX ``run_experiment`` at MESH_DATA=2 (run in a subprocess whose XLA
sees two devices, so its index mesh has two shards too); and
data-parallel E5 encoding (an odd batch) equals one rank's and JAX's
``dp_mesh`` encoder's embeddings within 1e-5."""

import csv
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

from sdag_tpu.models import e5 as je5
from sdag_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer
from sdag_tpu_torch.config import Config
from sdag_tpu_torch.core.mesh import make_mesh
from sdag_tpu_torch.models import e5 as te5
from sdag_tpu_torch.models.tokenizer import ByteTokenizer
from sdag_tpu_torch.parallel.launch import run_ranks
from sdag_tpu_torch.utils.synth_qa import (load_world, write_attack_csv,
                                           write_corpus_jsonl)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "experiments", "data", "qa_ckpt")
NAME = "results_top_k=5_attacker_pos=0.csv"
TEXTS = ["a short passage", "another passage about topic seven",
         "x", "the fourth text, somewhat longer than the others are",
         "five"]

pytestmark = pytest.mark.skipif(
    not os.path.isfile(os.path.join(CKPT, "native_decoder.json")),
    reason="trained qa_ckpt not present")

_JAX_RUN = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
from sdag_tpu.config import Config
from sdag_tpu.pipeline.orchestrator import run_experiment
cfg = Config()
for key, value in json.load(open(sys.argv[1])).items():
    setattr(cfg, key, value)
run_experiment(cfg)
print("JAX_DEVICES", jax.device_count())
"""


def _overrides(root, csv_path, corpus, n_facts):
    return {"SAMPLE_SIZE": n_facts, "TOP_K": [5], "ADD_ATTACK_IN_RANK": [0],
            "CSV_INPUT_PATH": csv_path, "CORPUS_JSONL_PATH": corpus,
            "RETRIEVER_BACKEND": "sparse",
            "SPARSE_INDEX_NAME_OR_PATH": os.path.join(root, "bm25.index"),
            "LLM_CHECKPOINT": CKPT, "LLM_BATCH_SIZE": 8,
            "BATCH_SIZE_EMBED_Q": 32, "MAX_GEN_TOKENS_RAG": 24,
            "TEMPERATURE": 0.0, "MESH_DATA": 2,
            "OUTPUT_CSV_BASE": os.path.join(root, "out", "results")}


def _rows(path):
    with open(path, newline="", encoding="utf-8") as fh:
        return list(csv.DictReader(fh))


def _encoders_tree():
    jcfg = je5.EncoderConfig.tiny()
    return jax.tree.map(np.asarray,
                        je5.init_encoder_params(jax.random.PRNGKey(0), jcfg))


def _worker(rank, world, root, csv_path, corpus, n_facts, enc_tree):
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    cfg = Config()
    mine = os.path.join(root, f"rank{rank}")
    for key, value in _overrides(mine, csv_path, corpus, n_facts).items():
        setattr(cfg, key, value)
    metrics = run_experiment(cfg, device="cpu")
    tcfg = te5.EncoderConfig.tiny()
    enc = te5.E5Encoder(
        te5.encoder_params_from_numpy(enc_tree, tcfg, device="cpu"), tcfg,
        ByteTokenizer(), model_name="intfloat/e5-large-v2", device="cpu",
        dp_mesh=make_mesh(data=2, model=1, device="cpu"))
    return {"acc": metrics[(5, 0)]["answer_match_stats"],
            "emb": enc.encode(TEXTS, kind="passage", batch_size=8),
            "enc_rows": enc.stats["padded_tokens"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist"))
    world = load_world(os.path.join(CKPT, "world.json"))
    corpus = os.path.join(root, "corpus.jsonl")
    csv_path = os.path.join(root, "attack.csv")
    write_corpus_jsonl(world, corpus)
    facts = write_attack_csv(world, csv_path, world.eval_entities[:4],
                             n_mal=1, seed=world.seed + 1)
    jroot = os.path.join(root, "jax")
    cfg_json = os.path.join(root, "jax_cfg.json")
    with open(cfg_json, "w") as fh:
        json.dump(_overrides(jroot, csv_path, corpus, len(facts)), fh)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    jax_proc = subprocess.Popen([sys.executable, "-c", _JAX_RUN, cfg_json],
                                env=env, cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    try:
        ranks = run_ranks(_worker, 2, root, csv_path, corpus, len(facts),
                          _encoders_tree())
    finally:
        jax_out, _ = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, jax_out[-4000:]
    assert "JAX_DEVICES 2" in jax_out
    return root, ranks


def test_data_mesh_run_writes_the_jax_answers_csv_from_rank_0(runs):
    root, ranks = runs
    port_rows = _rows(os.path.join(root, "rank0", "out", NAME))
    jax_rows = _rows(os.path.join(root, "jax", "out", NAME))
    assert len(port_rows) == len(jax_rows) == 24
    for p, j in zip(port_rows, jax_rows):
        assert p == j
    assert ranks[0]["acc"] == ranks[1]["acc"]
    assert ranks[0]["acc"]["iso"]["ground_truth_match_rate"] >= 0.5


def test_only_rank_0_writes(runs):
    """Rank 1 computed the same rows (and built its index) but wrote no
    answers and no index directory; rank 0 wrote both."""
    root, _ = runs
    assert os.path.isdir(os.path.join(root, "rank0", "bm25.index"))
    assert os.path.isfile(os.path.join(root, "rank0", "out",
                                       NAME.replace(".csv", ".json")))
    assert not os.path.exists(os.path.join(root, "rank1"))


def test_data_parallel_encode_equals_one_rank_and_jax(runs):
    _, ranks = runs
    tree = _encoders_tree()
    tcfg = te5.EncoderConfig.tiny()
    one = te5.E5Encoder(te5.encoder_params_from_numpy(tree, tcfg,
                                                      device="cpu"),
                        tcfg, ByteTokenizer(),
                        model_name="intfloat/e5-large-v2", device="cpu")
    want = one.encode(TEXTS, kind="passage", batch_size=8)
    jcfg = je5.EncoderConfig.tiny()
    jenc = je5.E5Encoder(
        je5.init_encoder_params(jax.random.PRNGKey(0), jcfg), jcfg,
        JaxByteTokenizer(), model_name="intfloat/e5-large-v2", fused=False,
        dp_mesh=JaxMesh(np.array(jax.devices()[:2]).reshape(2, 1),
                        axis_names=("data", "model")))
    jwant = jenc.encode(TEXTS, kind="passage", batch_size=8)
    for r in ranks:
        assert r["emb"].shape == (len(TEXTS), tcfg.d_model)
        np.testing.assert_allclose(r["emb"], want, atol=1e-5)
        np.testing.assert_allclose(r["emb"], jwant, atol=1e-5)
    # 5 texts pad to 6 rows: each rank encoded 3 of them
    assert ranks[0]["enc_rows"] == ranks[1]["enc_rows"]
