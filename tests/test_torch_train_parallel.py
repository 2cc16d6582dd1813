"""Data-, tensor- and pipeline-parallel training of the port on gloo ranks
against the JAX package's single-device ``lm_loss`` (the cases of
tests/test_sharding.py): DP=2, TP=2 (tied and untied, GQA) and a 2 x 2
data x model mesh at rtol 2e-4; GPipe with 2 stages, and 2 stages x 2-way
TP, at rtol 2e-5, one step moving the embedding identically on every
stage.  Under TP the replicated leaves (norms, a tied embedding) get
equal gradients on every model rank.  Each world is spawned once per
module."""

import jax
import numpy as np
import pytest
import torch

from sdag_tpu.models.llama import DecoderConfig as JaxDecoderConfig
from sdag_tpu.models.llama import init_decoder_params as jax_init
from sdag_tpu.parallel.train import lm_loss as jax_lm_loss
from sdag_tpu.parallel.train import make_dummy_batch as jax_dummy_batch
from sdag_tpu_torch.core.mesh import make_mesh, make_pipe_mesh
from sdag_tpu_torch.models.llama import DecoderConfig, params_from_numpy
from sdag_tpu_torch.parallel.launch import run_ranks
from sdag_tpu_torch.parallel.pipeline import make_pp_train_step
from sdag_tpu_torch.parallel.train import (lm_loss, make_dummy_batch,
                                           make_optimizer,
                                           make_sharded_train_step)
from sdag_tpu_torch.utils.tree import flatten_with_paths

DP_RTOL = 2e-4      # tests/test_sharding.py:44
PP_RTOL = 2e-5      # tests/test_sharding.py, the pipeline cases


def _cfgs(tie=True, n_layers=2):
    kw = dict(vocab_size=256, d_model=64, n_layers=n_layers, n_heads=4,
              n_kv_heads=2, d_ff=128, tie_embeddings=tie)
    return JaxDecoderConfig(**kw), DecoderConfig(**kw)


def _trees():
    out = {}
    for tie in (True, False):
        jcfg, _ = _cfgs(tie)
        out[tie] = jax.tree.map(np.asarray,
                                jax_init(jax.random.PRNGKey(2), jcfg))
    jcfg, _ = _cfgs(True, n_layers=4)
    out["pp"] = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(7),
                                                  jcfg))
    return out


def _batch(cfg):
    b = make_dummy_batch(cfg, batch=8, seq_len=32)
    nbr = torch.zeros_like(b["nbr_bits"])
    nbr[:, 8:12] = 3                      # neighbor windows on some rows
    return dict(b, nbr_bits=nbr)


def _np(t):
    return t.detach().cpu().numpy().copy()


def _dp_tp(tree, tie, mesh):
    """Loss and one step on the mesh; the replicated leaves' gradients of
    the loss (TP)."""
    _, cfg = _cfgs(tie)
    batch = _batch(cfg)
    init_state, step = make_sharded_train_step(
        cfg, mesh, optimizer=make_optimizer(1e-2))
    state = init_state(params_from_numpy(tree, cfg, device="cpu"))
    from sdag_tpu_torch.parallel.train import local_batch
    loss = lm_loss(state.params, cfg, local_batch(batch, mesh),
                   tp_group=mesh.group("model"))
    flat = flatten_with_paths(state.params)
    rep = [k for k in flat if k in ("embed", "final_norm")
           or k.endswith("ln1") or k.endswith("ln2")]
    grads = torch.autograd.grad(loss, [flat[k] for k in rep])
    state, l1 = step(state, batch)
    _, l2 = step(state, batch)
    return {"step_losses": (float(l1), float(l2)),
            "rep_grads": {k: _np(g) for k, g in zip(rep, grads)}}


def _pp(tree, mesh, tp_axis):
    _, cfg = _cfgs(True, n_layers=4)
    batch = _batch(cfg)
    init_state, step, pp_loss = make_pp_train_step(
        cfg, mesh, n_micro=4, optimizer=make_optimizer(1e-2),
        tp_axis=tp_axis)
    state = init_state(params_from_numpy(tree, cfg, device="cpu"))
    embed0 = _np(state.params["embed"])
    loss = float(pp_loss(state.params, batch))
    state, l1 = step(state, batch)
    return {"loss": loss, "step_loss": float(l1), "step": state.step,
            "embed_moved": float(np.abs(_np(state.params["embed"])
                                        - embed0).max()),
            "embed": _np(state.params["embed"]),
            "local_layers": state.params["layers"]["ln1"].shape[0]}


def _world2(rank, world, trees):
    out = {"dp": _dp_tp(trees[True], True,
                        make_mesh(data=2, model=1, device="cpu"))}
    tp = make_mesh(data=1, model=2, device="cpu")
    for tie in (True, False):
        out[f"tp_{tie}"] = _dp_tp(trees[tie], tie, tp)
    out["pp"] = _pp(trees["pp"], make_pipe_mesh(2, device="cpu"), None)
    return out


def _world4(rank, world, trees):
    return {"dp_tp": _dp_tp(trees[True], True,
                            make_mesh(data=2, model=2, device="cpu")),
            "pp_tp": _pp(trees["pp"], make_pipe_mesh(2, 2, device="cpu"),
                         "model")}


@pytest.fixture(scope="module")
def trees():
    return _trees()


@pytest.fixture(scope="module")
def world2(trees):
    return run_ranks(_world2, 2, trees)


@pytest.fixture(scope="module")
def world4(trees):
    return run_ranks(_world4, 4, trees)


def _jax_loss(tree, tie, n_layers=2):
    jcfg, _ = _cfgs(tie, n_layers)
    batch = jax_dummy_batch(jcfg, batch=8, seq_len=32)
    nbr = np.zeros((8, 32), np.int32)
    nbr[:, 8:12] = 3
    batch = dict(batch, nbr_bits=jax.numpy.asarray(nbr))
    params = jax.tree.map(jax.numpy.asarray, tree)
    return float(jax_lm_loss(params, jcfg, batch))


def _one_device_losses(tree, tie):
    return _dp_tp(tree, tie, make_mesh(data=1, model=1,
                                       device="cpu"))["step_losses"]


def test_the_dummy_batch_is_the_jax_one():
    jcfg, cfg = _cfgs()
    want = jax_dummy_batch(jcfg, batch=4, seq_len=32)
    got = make_dummy_batch(cfg, batch=4, seq_len=32)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


@pytest.mark.parametrize("case", ["dp", "tp_True", "tp_False"])
def test_two_ranks_match_the_jax_single_device_loss(world2, trees, case):
    tie = case != "tp_False"
    ref = _jax_loss(trees[tie], tie)
    one = _one_device_losses(trees[tie], tie)
    for r in world2:
        l1, l2 = r[case]["step_losses"]
        np.testing.assert_allclose(l1, ref, rtol=DP_RTOL)
        # the step after one AdamW update, against the same step on one
        # device
        np.testing.assert_allclose(l2, one[1], rtol=DP_RTOL)
        assert l2 < l1


@pytest.mark.parametrize("tie", [True, False])
def test_tp_replicated_leaves_get_equal_gradients(world2, tie):
    a, b = (r[f"tp_{tie}"]["rep_grads"] for r in world2)
    assert set(a) == set(b) and "final_norm" in a and "layers/0/ln1" in a
    for k in a:
        assert np.abs(a[k]).max() > 0, k
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_tp_replicated_gradients_equal_one_device(world2, trees):
    """The model ranks' gradients of the norms are the whole model's,
    not a rank's share."""
    _, cfg = _cfgs(True)
    from sdag_tpu_torch.parallel.train import _trainable
    params = _trainable(params_from_numpy(trees[True], cfg, device="cpu"))
    loss = lm_loss(params, cfg, _batch(cfg))
    g = torch.autograd.grad(loss, [params["final_norm"],
                                   params["layers"][1]["ln2"]])
    got = world2[0]["tp_True"]["rep_grads"]
    np.testing.assert_allclose(got["final_norm"], _np(g[0]), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(got["layers/1/ln2"], _np(g[1]), rtol=1e-4,
                               atol=1e-7)


def test_dp_tp_2x2_matches_the_jax_single_device_loss(world4, trees):
    ref = _jax_loss(trees[True], True)
    one = _one_device_losses(trees[True], True)
    for r in world4:
        l1, l2 = r["dp_tp"]["step_losses"]
        np.testing.assert_allclose(l1, ref, rtol=DP_RTOL)
        np.testing.assert_allclose(l2, one[1], rtol=DP_RTOL)


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_gpipe_matches_the_jax_single_device_loss(world, trees, request):
    ranks = request.getfixturevalue(world)
    key = "pp" if world == "world2" else "pp_tp"
    ref = _jax_loss(trees["pp"], True, n_layers=4)
    embeds = []
    for r in ranks:
        c = r[key]
        np.testing.assert_allclose(c["loss"], ref, rtol=PP_RTOL)
        np.testing.assert_allclose(c["step_loss"], ref, rtol=PP_RTOL)
        assert c["step"] == 1 and c["local_layers"] == 2
        # the tied embedding moved: its gather (stage 0) and unembed
        # (last stage) gradients summed over 'pipe'
        assert c["embed_moved"] > 1e-3
        embeds.append(c["embed"])
    for e in embeds[1:]:
        np.testing.assert_array_equal(e, embeds[0])


def test_gpipe_step_equals_one_device_step(world2, trees):
    """The stages' summed embedding gradient is the whole model's: the
    updated embedding equals one device's AdamW step."""
    _, cfg = _cfgs(True, n_layers=4)
    mesh = make_mesh(data=1, model=1, device="cpu")
    init_state, step = make_sharded_train_step(
        cfg, mesh, optimizer=make_optimizer(1e-2))
    state = init_state(params_from_numpy(trees["pp"], cfg, device="cpu"))
    state, _ = step(state, _batch(cfg))
    want = _np(state.params["embed"])
    got = world2[0]["pp"]["embed"]
    moved = np.abs(want - trees["pp"]["embed"]) > 1e-3
    # Adam flips the sign of an update whose gradient is rounding noise;
    # the rows the batch touches move by the same steps
    agree = np.isclose(got, want, rtol=0, atol=1e-5)
    assert agree[moved].mean() > 0.99
