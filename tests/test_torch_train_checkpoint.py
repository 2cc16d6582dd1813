"""Checkpoints of the port's training: parameter trees and train states in
the port's own format (a safetensors file of global tensors and a JSON
skeleton; never orbax).  On the CPU a restored state continues bit-equal
to the uninterrupted run, for the plain and the stage-stacked (GPipe)
layouts; states written by gloo ranks (TP=2, a 2-stage pipeline) restore
onto one device; and native decoder checkpoints cross between the
packages both ways with equal arrays."""

import os

import jax
import numpy as np
import pytest
import torch

from sdag_tpu.models.llama import DecoderConfig as JaxDecoderConfig
from sdag_tpu.models.llama import init_decoder_params as jax_init
from sdag_tpu.models.native_ckpt import load_decoder as jax_load_decoder
from sdag_tpu.models.native_ckpt import save_decoder as jax_save_decoder
from sdag_tpu_torch.core.mesh import make_mesh, make_pipe_mesh
from sdag_tpu_torch.models.llama import DecoderConfig, params_from_numpy
from sdag_tpu_torch.models.native_ckpt import load_decoder, save_decoder
from sdag_tpu_torch.parallel.checkpoint import (load_pytree,
                                                restore_train_state,
                                                save_pytree,
                                                save_train_state)
from sdag_tpu_torch.parallel.launch import run_ranks
from sdag_tpu_torch.parallel.pipeline import (make_pp_train_step,
                                              stack_layer_params,
                                              unstack_layer_params)
from sdag_tpu_torch.parallel.train import (make_dummy_batch, make_optimizer,
                                           make_sharded_train_step)
from sdag_tpu_torch.utils.tree import flatten_with_paths


def _cfgs(tie=True, n_layers=2):
    kw = dict(vocab_size=128, d_model=32, n_layers=n_layers, n_heads=4,
              n_kv_heads=2, d_ff=64, tie_embeddings=tie)
    return JaxDecoderConfig(**kw), DecoderConfig(**kw)


def _tree(seed=0, tie=True, n_layers=2):
    jcfg, _ = _cfgs(tie, n_layers)
    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(seed),
                                             jcfg))


def _flat_equal(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


def test_pytree_roundtrip(tmp_path):
    tree = {"a": torch.arange(6.).reshape(2, 3),
            "b": [torch.ones(2, dtype=torch.bfloat16), {"c": 7}],
            "d": torch.tensor([1, -2], dtype=torch.int8), "n": 3}
    save_pytree(str(tmp_path / "t"), tree)
    got = load_pytree(str(tmp_path / "t"))
    assert got["n"] == 3 and got["b"][1] == {"c": 7}
    for k in ("a", "d"):
        assert torch.equal(got[k], tree[k])
    assert torch.equal(got["b"][0], tree["b"][0])
    assert not os.path.exists(tmp_path / "t" / "checkpoint")  # no orbax


@pytest.mark.parametrize("tie", [True, False])
def test_train_state_resume_is_bit_equal(tmp_path, tie):
    _, cfg = _cfgs(tie)
    mesh = make_mesh(data=1, model=1, device="cpu")
    init, step = make_sharded_train_step(cfg, mesh,
                                         optimizer=make_optimizer(1e-2))
    batches = [make_dummy_batch(cfg, 4, 32, num_docs=n) for n in (1, 2, 3)]
    state = init(params_from_numpy(_tree(0, tie), cfg, device="cpu"))
    state, _ = step(state, batches[0])
    save_train_state(str(tmp_path / "s"), state)
    cont = []
    for b in batches[1:]:
        state, loss = step(state, b)
        cont.append(float(loss))
    fresh = init(params_from_numpy(_tree(9, tie), cfg, device="cpu"))
    restored = restore_train_state(str(tmp_path / "s"), fresh)
    assert restored.step == 1 and restored.opt_state["count"] == 1
    assert all(p.requires_grad for p in
               flatten_with_paths(restored.params).values())
    again = []
    for b in batches[1:]:
        restored, loss = step(restored, b)
        again.append(float(loss))
    assert again == cont
    _flat_equal(restored.params, state.params)
    _flat_equal(restored.opt_state["mu"], state.opt_state["mu"])


def test_stacked_train_state_resume_is_bit_equal(tmp_path):
    _, cfg = _cfgs(True, n_layers=4)
    mesh = make_pipe_mesh(1, device="cpu")
    init, step, pp_loss = make_pp_train_step(
        cfg, mesh, n_micro=2, optimizer=make_optimizer(1e-2))
    b = make_dummy_batch(cfg, 4, 16)
    state = init(params_from_numpy(_tree(0, n_layers=4), cfg, device="cpu"))
    assert state.params["layers"]["attn"]["wq"].shape[0] == 4
    state, _ = step(state, b)
    save_train_state(str(tmp_path / "pp"), state)
    state, want = step(state, b)
    restored = restore_train_state(
        str(tmp_path / "pp"),
        init(params_from_numpy(_tree(5, n_layers=4), cfg, device="cpu")))
    restored, got = step(restored, b)
    assert float(got) == float(want)
    _flat_equal(restored.params, state.params)
    # the stacked tree maps back to the plain one
    plain = unstack_layer_params(state.params)
    again = stack_layer_params(plain)
    _flat_equal(again, state.params)


def _ranks_save(rank, world, tree, tree_pp, root):
    _, cfg = _cfgs(True)
    b = make_dummy_batch(cfg, 4, 32)
    tp = make_mesh(data=1, model=2, device="cpu")
    init, step = make_sharded_train_step(cfg, tp,
                                         optimizer=make_optimizer(1e-2))
    state, _ = step(init(params_from_numpy(tree, cfg, device="cpu")), b)
    save_train_state(os.path.join(root, "tp"), state)
    _, tp_next = step(state, b)
    _, cfg4 = _cfgs(True, n_layers=4)
    init, step, pp_loss = make_pp_train_step(
        cfg4, make_pipe_mesh(2, device="cpu"), n_micro=2,
        optimizer=make_optimizer(1e-2))
    state, _ = step(init(params_from_numpy(tree_pp, cfg4, device="cpu")),
                    make_dummy_batch(cfg4, 4, 16))
    save_train_state(os.path.join(root, "pp"), state)
    return {"tp_next": float(tp_next),
            "pp_next": float(pp_loss(state.params,
                                     make_dummy_batch(cfg4, 4, 16)))}


def test_states_written_by_two_ranks_restore_on_one_device(tmp_path):
    """TP=2 slices and 2-stage layer stacks are gathered to global
    tensors; one device restores both and continues as the ranks did."""
    res = run_ranks(_ranks_save, 2, _tree(0), _tree(1, n_layers=4),
                    str(tmp_path))
    _, cfg = _cfgs(True)
    init, step = make_sharded_train_step(
        cfg, make_mesh(data=1, model=1, device="cpu"),
        optimizer=make_optimizer(1e-2))
    st = restore_train_state(
        str(tmp_path / "tp"),
        init(params_from_numpy(_tree(3), cfg, device="cpu")))
    assert st.step == 1
    _, loss = step(st, make_dummy_batch(cfg, 4, 32))
    np.testing.assert_allclose(float(loss), res[0]["tp_next"], rtol=1e-5)
    _, cfg4 = _cfgs(True, n_layers=4)
    init, _step, pp_loss = make_pp_train_step(
        cfg4, make_pipe_mesh(1, device="cpu"), n_micro=2,
        optimizer=make_optimizer(1e-2))
    st = restore_train_state(
        str(tmp_path / "pp"),
        init(params_from_numpy(_tree(3, n_layers=4), cfg4, device="cpu")))
    np.testing.assert_allclose(
        float(pp_loss(st.params, make_dummy_batch(cfg4, 4, 16))),
        res[0]["pp_next"], rtol=1e-6)


@pytest.mark.parametrize("tie", [True, False])
def test_native_decoder_checkpoints_cross_both_ways(tmp_path, tie):
    jcfg, cfg = _cfgs(tie)
    tree = _tree(2, tie)
    params = params_from_numpy(tree, cfg, device="cpu")
    save_decoder(params, cfg, str(tmp_path / "port"), extra={"x": 1})
    jp, jc = jax_load_decoder(str(tmp_path / "port"))
    assert jc == jcfg
    jflat = {"/".join(str(getattr(p, "key", getattr(p, "idx", None)))
                      for p in path): np.asarray(leaf) for path, leaf in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    for k, v in flatten_with_paths(params).items():
        np.testing.assert_array_equal(v.numpy(), jflat[k], err_msg=k)
    jax_save_decoder(jax.tree.map(jax.numpy.asarray, tree), jcfg,
                     str(tmp_path / "jax"))
    got, c = load_decoder(str(tmp_path / "jax"), device="cpu")
    assert c == cfg
    _flat_equal(got, params)
