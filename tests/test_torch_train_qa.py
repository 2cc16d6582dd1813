"""The port's ``train_qa`` against the JAX module on the CPU: examples,
batches and wire stacks bit for bit (byte and word tokenizers, ISO,
causal, neighbor windows, sentence answers); ``teacher_forced_eval``'s
dict equal to JAX's on the committed qa_ckpt_v4; the CLI at a tiny size
writing a checkpoint that JAX's ``load_decoder`` reads and the port's CPU
pipeline serves; ``--mesh-data 2`` on two gloo ranks equal to one
process, rank 0 alone writing; and the first two steps of the committed
JAX CPU reference run (``experiments/results/train_qa_jax_cpu/
reference.json``) within 1e-4 relative."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from sdag_tpu.models.native_ckpt import load_decoder as jax_load_decoder
from sdag_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer
from sdag_tpu.models.tokenizer import WordTokenizer as JaxWordTokenizer
from sdag_tpu.pipeline import train_qa as J
from sdag_tpu.utils.synth_qa import make_world as jax_make_world
from sdag_tpu.utils.synth_qa import synth_word_vocab
from sdag_tpu_torch.models.native_ckpt import load_decoder
from sdag_tpu_torch.pipeline import train_qa as T
from sdag_tpu_torch.utils.synth_qa import make_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V4 = os.path.join(REPO, "experiments", "data", "qa_ckpt_v4")
REFERENCE = os.path.join(REPO, "experiments", "results", "train_qa_jax_cpu",
                         "reference.json")
# f32 on the CPU in both packages, sums in another order
REF_LOSS_RTOL = 1e-4


def _toks(kind):
    if kind == "word":
        return JaxWordTokenizer(synth_word_vocab()), T.make_tokenizer("word")
    return JaxByteTokenizer(), T.make_tokenizer("byte")


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        want = np.asarray(a[k])
        got = b[k].numpy() if isinstance(b[k], torch.Tensor) else b[k]
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("kind,seq", [("byte", 768), ("word", 512)])
@pytest.mark.parametrize("kw", [
    dict(k_min=1, nbr_frac=0.25, dup_frac=0.0),
    dict(k_min=2, k_max=6, iso_frac=1.0, nbr_frac=1.0, dup_frac=0.5,
         answer_form="sentence"),
    dict(k_min=1, k_max=3, iso_frac=0.0, styled_frac=1.0)],
    ids=["v4", "iso_nbr_sentence", "causal_styled"])
def test_sample_batch_is_bit_equal(kind, seq, kw):
    jt, tt = _toks(kind)
    want = J.sample_batch(np.random.default_rng(11), jt, None, 6, seq, **kw)
    got = T.sample_batch(np.random.default_rng(11), tt, None, 6, seq, **kw)
    _equal(want, got)


@pytest.mark.parametrize("kind,seq", [("byte", 768), ("word", 512)])
def test_build_example_from_a_pool_is_bit_equal(kind, seq):
    jt, tt = _toks(kind)
    jw, tw = jax_make_world(16, seed=1), make_world(16, seed=1)
    for i, iso in enumerate((True, False, True)):
        a = J.build_example(np.random.default_rng(i), jt, jw.facts[i],
                            jw.facts, 4, iso=iso, seq_len=seq, nbr_frac=1.0)
        b = T.build_example(np.random.default_rng(i), tt, tw.facts[i],
                            tw.facts, 4, iso=iso, seq_len=seq, nbr_frac=1.0)
        _equal(a, b)
    assert J.build_example(np.random.default_rng(0), jt, jw.facts[0], None,
                           10, True, 64) is None
    assert T.build_example(np.random.default_rng(0), tt, tw.facts[0], None,
                           10, True, 64) is None


@pytest.mark.parametrize("kind,seq", [("byte", 768), ("word", 512)])
def test_sample_batch_stack_and_decompress_are_bit_equal(kind, seq):
    jt, tt = _toks(kind)
    want = J.sample_batch_stack(np.random.default_rng(5), jt, None, 3, 4,
                                seq, k_min=1, nbr_frac=0.25)
    got = T.sample_batch_stack(np.random.default_rng(5), tt, None, 3, 4,
                               seq, k_min=1, nbr_frac=0.25)
    assert set(got) == set(T._WIRE_DTYPES) == set(J._WIRE_DTYPES)
    _equal(want, got)
    jd = J.decompress_batch({k: jax.numpy.asarray(v[0])
                             for k, v in want.items()})
    td = T.decompress_batch({k: torch.from_numpy(v[0])
                             for k, v in got.items()})
    _equal(jd, td)


def test_teacher_forced_eval_equals_jax():
    world = make_world(64, seed=0)
    jp, jcfg = jax_load_decoder(V4)
    params, cfg = load_decoder(V4, device="cpu")
    jt, tt = _toks("byte")
    kw = dict(seq_len=768, n=8, answer_form="value")
    want = J.teacher_forced_eval(jp, jcfg, jt,
                                 world.facts_for(world.eval_entities),
                                 world.facts_for(world.train_entities), **kw)
    got = T.teacher_forced_eval(params, cfg, tt,
                                world.facts_for(world.eval_entities),
                                world.facts_for(world.train_entities), **kw)
    assert got == want
    assert got["full_acc_iso"] >= 0.5


def _tiny_flags(out, tokenizer="byte"):
    return ["--out", str(out), "--steps", "3", "--warmup", "1", "--batch",
            "4", "--entities", "8", "--d-model", "32", "--layers", "1",
            "--heads", "2", "--kv-heads", "2", "--d-ff", "64", "--seq-len",
            "768" if tokenizer == "byte" else "192", "--k-max", "3",
            "--scan-chunk", "2", "--eval-every", "2", "--eval-n", "4",
            "--tokenizer", tokenizer, "--device", "cpu"]


@pytest.mark.parametrize("tokenizer", ["byte", "word"])
def test_cli_checkpoint_is_served_by_the_cpu_pipeline(tmp_path, tokenizer):
    from sdag_tpu_torch.config import Config
    from sdag_tpu_torch.pipeline.orchestrator import run_experiment
    from sdag_tpu_torch.utils.synth_qa import (load_world, write_attack_csv,
                                               write_corpus_jsonl)
    ckpt = tmp_path / "ckpt"
    res = T.main(_tiny_flags(ckpt, tokenizer))
    # --scan-chunk 2 rounds 3 steps up to 4
    assert res["steps"] == 4 and len(res["losses"]) == 4
    assert all(np.isfinite(res["losses"]))
    man = json.loads((ckpt / "native_decoder.json").read_text())
    assert man["extra"]["final_eval"] == res["final_eval"]
    assert man["extra"]["tokenizer"] == tokenizer
    assert (ckpt / "word_tokenizer.json").exists() == (tokenizer == "word")
    jp, jcfg = jax_load_decoder(str(ckpt))
    assert jcfg.d_model == 32 and jcfg.n_layers == 1
    params, _ = load_decoder(str(ckpt), device="cpu")
    np.testing.assert_array_equal(params["embed"].numpy(),
                                  np.asarray(jp["embed"]))

    world = load_world(str(ckpt / "world.json"))
    write_corpus_jsonl(world, str(tmp_path / "corpus.jsonl"))
    write_attack_csv(world, str(tmp_path / "attack.csv"),
                     world.eval_entities[:1], n_mal=1)
    cfg = Config()
    cfg.CSV_INPUT_PATH = str(tmp_path / "attack.csv")
    cfg.CORPUS_JSONL_PATH = str(tmp_path / "corpus.jsonl")
    cfg.RETRIEVER_BACKEND = "sparse"
    cfg.LLM_CHECKPOINT = str(ckpt)
    cfg.MAX_GEN_TOKENS_RAG = 6
    cfg.OUTPUT_CSV_BASE = str(tmp_path / "out" / "results")
    metrics = run_experiment(cfg, device="cpu")
    (key, m), = metrics.items()
    assert m["num_queries"] >= 1
    assert set(m["answer_match_stats"]) == {"iso", "no_iso"}


def _mesh_data_rank(rank, world, root):
    res = T.main(_tiny_flags(os.path.join(root, f"rank{rank}"))
                 + ["--mesh-data", "2"])
    return res["losses"]


def test_mesh_data_ranks_train_one_model_and_rank_0_writes(tmp_path):
    """``--mesh-data 2`` on two gloo ranks: each takes half of every
    batch, both report the same global losses, equal to one process's
    run within f32 summation order, and only rank 0 writes."""
    from sdag_tpu_torch.parallel.launch import run_ranks
    ranks = run_ranks(_mesh_data_rank, 2, str(tmp_path))
    one = T.main(_tiny_flags(tmp_path / "one"))["losses"]
    assert ranks[0] == ranks[1]
    np.testing.assert_allclose(ranks[0], one, rtol=1e-4)
    assert (tmp_path / "rank0" / "params.npz").exists()
    assert not (tmp_path / "rank1").exists()


def test_the_reference_recipe_first_two_steps_match_jax(tmp_path):
    """The port's own pieces of ``main`` (flags, schedule, optimizer,
    warm start, sampler) at the committed reference's flags: its first
    two losses (lr 0, then lr/2) equal JAX's."""
    ref = json.load(open(REFERENCE))
    flags = [os.path.join(REPO, f) if f.startswith("experiments/") else f
             for f in ref["flags"]]
    args = T.parse_args(flags + ["--out", str(tmp_path), "--device", "cpu"])
    tok = T.make_tokenizer(args.tokenizer)
    from sdag_tpu_torch.models.llama import DecoderConfig
    cfg = DecoderConfig(vocab_size=tok.vocab_size, d_model=args.d_model,
                        n_layers=args.layers, n_heads=args.heads,
                        n_kv_heads=args.kv_heads, d_ff=args.d_ff)
    init_state, step_fn, scan_fn = T.make_training(args, cfg, "cpu")
    assert scan_fn is None
    state = init_state(T.initial_params(args, cfg, "cpu"))
    rng = np.random.default_rng(args.seed + 7)
    losses = []
    for _ in range(2):
        batch = T.sample_batch(rng, tok, None, args.batch, args.seq_len,
                               **T.sample_kwargs(args))
        state, loss = step_fn(state, batch)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, ref["losses"][:2],
                               rtol=REF_LOSS_RTOL)
