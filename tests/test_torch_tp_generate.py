"""Tensor- and data-parallel generation of the port on gloo ranks against
the JAX package's meshes (the cases of tests/test_sharding.py): greedy
tokens of TP=2 equal JAX's TP and one-device tokens, tied and untied,
plain and speculative, and with the int8 KV cache under speculation; a
2x2 data x model mesh equals one device, an odd batch included; int8
weights served replicated at MESH_DATA=2 equal JAX's one-device int8
Generator; every rank holds the same texts; a model axis that does not
divide the heads raises.  Each world is spawned once per module."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sdag_tpu.models.llama import DecoderConfig as JaxDecoderConfig
from sdag_tpu.models.llama import init_decoder_params as jax_init
from sdag_tpu.models.llama import \
    quantize_decoder_params_int8 as jax_quantize
from sdag_tpu.models.tokenizer import ByteTokenizer as JaxByteTokenizer
from sdag_tpu.sdag.generate import Generator as JaxGenerator
from sdag_tpu_torch.core.mesh import make_mesh
from sdag_tpu_torch.models.llama import DecoderConfig, params_from_numpy
from sdag_tpu_torch.models.tokenizer import ByteTokenizer
from sdag_tpu_torch.parallel.launch import run_ranks
from sdag_tpu_torch.sdag.generate import Generator

PROMPTS2 = ["abc abc abc abc", "a longer prompt with words"]
PROMPTS4 = ["abc abc abc", "xy", "hello world", "zzz zzz"]


def _cfgs(tie: bool):
    kw = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=2, d_ff=128, tie_embeddings=tie)
    return JaxDecoderConfig(**kw), DecoderConfig(**kw)


def _jax_params(tie: bool):
    jcfg, _ = _cfgs(tie)
    return jax_init(jax.random.PRNGKey(0), jcfg)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _ids(tok, texts):
    return [np.asarray(tok.encode(t), np.int32) for t in texts]


def _port_gen(tree, tie, mesh, **kw):
    _, tcfg = _cfgs(tie)
    return Generator(params_from_numpy(tree, tcfg, device="cpu"), tcfg,
                     ByteTokenizer(), temperature=0.0, device="cpu",
                     mesh=mesh, **kw)


def _world2(rank, world, trees, int8_tree):
    """TP=2 cases, then the int8 tree on a 2 x 1 data mesh."""
    tok = ByteTokenizer()
    ids = _ids(tok, PROMPTS2)
    tp = make_mesh(data=1, model=2, device="cpu")
    out = {"tp_coords": (tp.rank("data"), tp.rank("model"))}
    for tie in (True, False):
        g = _port_gen(trees[tie], tie, tp)
        out[f"tp_{tie}"] = g.generate_ids(ids, max_new_tokens=10)
        out[f"decode_mode_{tie}"] = g.stats["decode_mode"]
        out[f"kv_heads_{tie}"] = tuple(
            g._buffers(len(ids), 128, 10, False).cache["k"].shape)
    g = _port_gen(trees[False], False, tp, speculative_draft=4)
    out["tp_spec"] = g.generate_ids(ids, max_new_tokens=10)
    g = _port_gen(trees[False], False, tp, speculative_draft=4,
                  kv_cache_dtype="int8")
    out["tp_spec_i8kv"] = g.generate_ids(ids, max_new_tokens=10)
    bad = DecoderConfig(vocab_size=512, d_model=64, n_layers=1, n_heads=4,
                        n_kv_heads=1, d_ff=128)
    try:
        Generator(params_from_numpy(trees["bad"], bad, device="cpu"), bad,
                  tok, device="cpu", mesh=tp)
        out["bad"] = None
    except ValueError as e:
        out["bad"] = str(e)
    dp = make_mesh(data=2, model=1, device="cpu")
    g = _port_gen(int8_tree, False, dp, batch_bucket=3)
    out["int8_dp"] = g.generate_ids(_ids(tok, PROMPTS4[:3]),
                                    max_new_tokens=10)
    return out


def _world4(rank, world, tree):
    """A 2 x 2 data x model mesh: a full batch, an odd one, speculation."""
    tok = ByteTokenizer()
    ids4 = _ids(tok, PROMPTS4)
    mesh = make_mesh(data=2, model=2, device="cpu")
    g = _port_gen(tree, False, mesh)
    gs = _port_gen(tree, False, mesh, speculative_draft=3)
    return {"coords": (mesh.rank("data"), mesh.rank("model")),
            "dp4": g.generate_ids(ids4, max_new_tokens=8),
            "dp3": g.generate_ids(ids4[:3], max_new_tokens=8),
            "spec4": gs.generate_ids(ids4, max_new_tokens=8),
            "spec_rounds": gs.spec_total_rounds,
            "spec_row_rounds": gs.spec_total_row_rounds,
            "spec_tokens": gs.spec_total_tokens}


@pytest.fixture(scope="module")
def jax_trees():
    bad = JaxDecoderConfig(vocab_size=512, d_model=64, n_layers=1,
                           n_heads=4, n_kv_heads=1, d_ff=128)
    trees = {True: _jax_params(True), False: _jax_params(False),
             "bad": jax_init(jax.random.PRNGKey(1), bad)}
    return trees


@pytest.fixture(scope="module")
def world2(jax_trees):
    trees = {k: _np_tree(v) for k, v in jax_trees.items()}
    int8_tree = _np_tree(jax_quantize(jax_trees[False]))
    return run_ranks(_world2, 2, trees, int8_tree)


@pytest.fixture(scope="module")
def world4(jax_trees):
    return run_ranks(_world4, 4, _np_tree(jax_trees[False]))


def _jax_gen(params, tie, mesh=None, **kw):
    jcfg, _ = _cfgs(tie)
    return JaxGenerator(params, jcfg, JaxByteTokenizer(), temperature=0.0,
                        tp_mesh=mesh, **kw)


def _tp_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), axis_names=("model",))


@pytest.mark.parametrize("tie", [True, False])
def test_tp2_tokens_equal_jax_tp_and_one_device(world2, jax_trees, tie):
    ids = _ids(JaxByteTokenizer(), PROMPTS2)
    one = _jax_gen(jax_trees[tie], tie).generate_ids(ids, max_new_tokens=10)
    tp = _jax_gen(jax_trees[tie], tie, _tp_mesh(2)).generate_ids(
        ids, max_new_tokens=10)
    for r in world2:
        assert r[f"tp_{tie}"] == tp == one


def test_tp2_speculative_tokens_equal_jax(world2, jax_trees):
    ids = _ids(JaxByteTokenizer(), PROMPTS2)
    params = jax_trees[False]
    one = _jax_gen(params, False).generate_ids(ids, max_new_tokens=10)
    spec = _jax_gen(params, False, _tp_mesh(2),
                    speculative_draft=4).generate_ids(ids, max_new_tokens=10)
    for r in world2:
        assert r["tp_spec"] == spec == one


def test_tp2_speculative_int8_kv_equals_jax_int8_decode(world2, jax_trees):
    ids = _ids(JaxByteTokenizer(), PROMPTS2)
    i8 = _jax_gen(jax_trees[False], False,
                  kv_cache_dtype="int8").generate_ids(ids, max_new_tokens=10)
    for r in world2:
        assert r["tp_spec_i8kv"] == i8


def test_tp2_ranks_hold_their_heads_and_decode_eagerly_on_gloo(world2):
    """Each TP rank caches n_kv_heads / 2 heads; a gloo group is never
    captured (chosen up front, recorded in stats)."""
    assert [r["tp_coords"] for r in world2] == [(0, 0), (0, 1)]
    for r in world2:
        for tie in (True, False):
            assert r[f"kv_heads_{tie}"][2] == 1
            assert r[f"decode_mode_{tie}"].startswith("eager: gloo")


def test_tp_axis_must_divide_the_heads(world2):
    for r in world2:
        assert r["bad"] is not None and "must divide" in r["bad"]


def test_int8_weights_on_a_data_mesh_equal_jax_one_device_int8(
        world2, jax_trees):
    """int8 x MESH_DATA=2: the JAX package's shard_params cannot take the
    int8 leaves; the port serves the tree replicated and its greedy tokens
    equal JAX's one-device int8 Generator (3 prompts, bucket 3 -> 4 rows,
    2 a data rank)."""
    q = jax_quantize(jax_trees[False])
    ids = _ids(JaxByteTokenizer(), PROMPTS4[:3])
    want = _jax_gen(q, False).generate_ids(ids, max_new_tokens=10)
    for r in world2:
        assert r["int8_dp"] == want


@pytest.mark.parametrize("key,n", [("dp4", 4), ("dp3", 3)])
def test_dp_tp_2x2_tokens_equal_jax_and_one_device(world4, jax_trees, key,
                                                   n):
    ids = _ids(JaxByteTokenizer(), PROMPTS4[:n])
    params = jax_trees[False]
    one = _jax_gen(params, False).generate_ids(ids, max_new_tokens=8)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                axis_names=("data", "model"))
    dp = _jax_gen(params, False, mesh).generate_ids(ids, max_new_tokens=8)
    for r in world4:
        assert r[key] == dp == one


def test_dp_tp_2x2_speculative_equals_jax(world4, jax_trees):
    """Speculation composes with data x model; the round counters are
    reduced over the data ranks (rounds max, row rounds summed), so every
    rank reports the same totals."""
    ids = _ids(JaxByteTokenizer(), PROMPTS4)
    params = jax_trees[False]
    one = _jax_gen(params, False, speculative_draft=3).generate_ids(
        ids, max_new_tokens=8)
    for r in world4:
        assert r["spec4"] == one
    for key in ("spec_rounds", "spec_row_rounds", "spec_tokens"):
        assert len({r[key] for r in world4}) == 1
    assert world4[0]["spec_tokens"] >= world4[0]["spec_row_rounds"]


def test_dp_tp_2x2_coordinates(world4):
    assert [r["coords"] for r in world4] == [(0, 0), (0, 1), (1, 0), (1, 1)]
