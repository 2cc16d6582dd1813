"""The port's meshes and Megatron slicing on gloo ranks against the JAX
package's: ``make_mesh`` / ``make_index_mesh`` shapes and errors over a
world of n ranks equal JAX's over n devices; ``shard_rows`` blocks and
``shard_params`` slices (n = 2 and 4, tied and untied) equal the matching
``addressable_shards`` of JAX's exactly; the groups reduce over the right
ranks; torchrun's environment is read as JAX reads its own (absent: no
group; incomplete: ValueError); without a process group every mesh has
one rank and its collectives are the identity."""

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from sdag_tpu.core import mesh as jmesh
from sdag_tpu.models.llama import DecoderConfig as JaxDecoderConfig
from sdag_tpu.models.llama import init_decoder_params as jax_init
from sdag_tpu.parallel.sharding import decoder_param_specs as jax_specs
from sdag_tpu.parallel.sharding import shard_params as jax_shard_params
from sdag_tpu_torch.core import mesh as tmesh
from sdag_tpu_torch.models.llama import DecoderConfig, params_from_numpy
from sdag_tpu_torch.parallel import collectives as C
from sdag_tpu_torch.parallel.launch import run_ranks
from sdag_tpu_torch.parallel.sharding import (decoder_param_specs,
                                              shard_params)

# (data, model) requests: fitting ones, data=0 fills, too large ones
SHAPES = [(0, 1), (0, 2), (1, 2), (2, 1), (2, 2), (4, 1), (1, 4), (0, 4),
          (3, 2), (8, 1)]
ROWS = np.arange(48 * 3, dtype=np.float32).reshape(48, 3)


def _cfgs(tie):
    kw = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
              n_kv_heads=4, d_ff=128, tie_embeddings=tie)
    return JaxDecoderConfig(**kw), DecoderConfig(**kw)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _worker(rank, world, trees):
    out = {"shapes": {}}
    for data, model in SHAPES:
        try:
            m = tmesh.make_mesh(data, model, device="cpu")
            out["shapes"][(data, model)] = (m.shape, m.coords)
        except ValueError as e:
            out["shapes"][(data, model)] = str(e)
    im = tmesh.make_index_mesh("cpu")
    out["index"] = (im.shape, im.rank("index"))
    out["rows"] = tmesh.shard_rows(torch.from_numpy(ROWS), im).numpy()
    out["replicate"] = tmesh.replicate(torch.ones(2), im).device.type
    # each axis group sums the ranks that share it (2 x 2, or 1 x 2)
    m = tmesh.make_mesh(world // 2, 2, device="cpu")
    x = torch.tensor([float(rank)])
    out["sum_model"] = float(C.all_reduce_(x.clone(), m.group("model")))
    out["sum_data"] = float(C.all_reduce_(x.clone(), m.group("data")))
    again = tmesh.make_mesh(world // 2, 2, device="cpu")
    out["groups_reused"] = all(again.group(a) is m.group(a)
                               for a in ("data", "model"))
    out["gather"] = C.gather_rows(tmesh.shard_rows(
        torch.from_numpy(ROWS), im), im).numpy()
    for tie, tree in trees.items():
        _, tcfg = _cfgs(tie)
        mesh = tmesh.make_mesh(1, world, device="cpu")
        sliced = shard_params(params_from_numpy(tree, tcfg, device="cpu"),
                              tcfg, mesh)
        out[f"params_{tie}"] = {k: v.numpy()
                                for k, v in _flat(sliced).items()}
    return out


def _trees():
    return {tie: jax.tree.map(np.asarray,
                              jax_init(jax.random.PRNGKey(3), _cfgs(tie)[0]))
            for tie in (True, False)}


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    n = request.param
    return n, run_ranks(_worker, n, _trees())


def _jax_shape(data, model, n):
    try:
        m = jmesh.make_mesh(data, model, devices=jax.devices()[:n])
        return dict(m.shape)
    except ValueError as e:
        return str(e)


def test_make_mesh_shapes_and_errors_follow_jax(world):
    n, ranks = world
    for (data, model) in SHAPES:
        want = _jax_shape(data, model, n)
        for rank, r in enumerate(ranks):
            got = r["shapes"][(data, model)]
            if isinstance(want, str):
                assert isinstance(got, str) and got.startswith(want)
                continue
            if isinstance(got, str):
                # a mesh that does not tile the world (JAX idles the rest)
                assert n % (want["data"] * want["model"]) and "tile" in got
                continue
            shape, coords = got
            assert shape == want
            local = rank % (want["data"] * want["model"])
            assert coords == {"data": local // want["model"],
                              "model": local % want["model"]}


def test_index_mesh_and_shard_rows_equal_jax_shards(world):
    n, ranks = world
    jm = jmesh.make_index_mesh(devices=jax.devices()[:n])
    x = jmesh.shard_rows(ROWS, jm)
    for rank, r in enumerate(ranks):
        assert r["index"] == ({"index": n}, rank)
        shard = next(s for s in x.addressable_shards
                     if s.device == jm.devices[rank])
        np.testing.assert_array_equal(r["rows"], np.asarray(shard.data))
        np.testing.assert_array_equal(r["gather"], ROWS)
        assert r["replicate"] == "cpu"


def test_axis_groups_reduce_over_their_ranks(world):
    """(n/2) x 2 mesh: a model group is ranks {2d, 2d + 1}, a data group
    the ranks of one model index."""
    n, ranks = world
    for rank, r in enumerate(ranks):
        base = rank - rank % 2
        assert r["sum_model"] == base + base + 1
        assert r["sum_data"] == sum(range(rank % 2, n, 2))


def test_a_mesh_asked_for_again_reuses_its_groups(world):
    """make_mesh makes a shape's process groups once: a second call hands
    back the same communicators instead of adding new ones."""
    _, ranks = world
    assert all(r["groups_reused"] for r in ranks)


@pytest.mark.parametrize("tie", [True, False])
def test_shard_params_slices_equal_jax_addressable_shards(world, tie):
    n, ranks = world
    jcfg, _ = _cfgs(tie)
    jm = jmesh.make_mesh(1, n, devices=jax.devices()[:n])
    params = jax_init(jax.random.PRNGKey(3), jcfg)
    sharded = _flat(jax_shard_params(params, jcfg, jm))
    for rank, r in enumerate(ranks):
        got = r[f"params_{tie}"]
        assert set(got) == set(sharded)
        for key, arr in sharded.items():
            shard = next(s for s in arr.addressable_shards
                         if s.device == jm.devices[0, rank])
            np.testing.assert_array_equal(got[key], np.asarray(shard.data),
                                          err_msg=key)


@pytest.mark.parametrize("tie", [True, False])
def test_param_specs_equal_jax(tie):
    jcfg, tcfg = _cfgs(tie)
    want = jax.tree.map(tuple, jax_specs(jcfg),
                        is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))
    assert decoder_param_specs(tcfg) == want


def test_without_a_process_group_meshes_have_one_rank():
    m = tmesh.make_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1}
    assert m.group("data") is None and m.group("model") is None
    im = tmesh.make_index_mesh("cpu")
    assert im.shape == {"index": 1} and im.group("index") is None
    x = torch.arange(6.0)
    assert C.all_reduce_(x, None) is x
    assert C.all_gather_cat(x, None) is x
    assert tmesh.is_writer() and tmesh.world_size() == 1
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tmesh.make_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tmesh.make_mesh(0, 2, device="cpu")


def test_torchrun_environment(monkeypatch):
    for v in tmesh._TORCHRUN_VARS:
        monkeypatch.delenv(v, raising=False)
    assert tmesh.maybe_init_distributed("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        tmesh.maybe_init_distributed("cpu")
    assert tmesh.rank_device("cpu") == torch.device("cpu")


def test_int8_tree_is_not_sliced_over_a_model_axis():
    from sdag_tpu_torch.models.llama import quantize_decoder_params_int8
    _, tcfg = _cfgs(False)
    tree = params_from_numpy(_trees()[False], tcfg, device="cpu")
    q = quantize_decoder_params_int8(tree)
    mesh = tmesh.Mesh({"data": 1, "model": 2}, {"data": 0, "model": 0},
                      {"data": None, "model": None}, torch.device("cpu"))
    with pytest.raises(ValueError, match="MESH_MODEL=1"):
        shard_params(q, tcfg, mesh)
    one = tmesh.make_mesh(device="cpu")
    kept = shard_params(q, tcfg, one)
    assert torch.equal(kept["layers"][0]["attn"]["wq"]["w"],
                       q["layers"][0]["attn"]["wq"]["w"])


def test_a_mesh_that_does_not_tile_the_world_raises():
    with pytest.raises(ValueError, match="does not tile"):
        tmesh.mesh_shape(3, 1, 4)
    assert tmesh.mesh_shape(0, 2, 4) == (2, 2)
    assert tmesh.mesh_shape(1, 2, 4) == (1, 2)


def _failing_worker(rank, world):
    if rank == 1:
        raise KeyError("rank one fails")
    return rank


def test_run_ranks_raises_a_ranks_error_with_its_traceback():
    with pytest.raises(mp.ProcessRaisedException, match="rank one fails"):
        run_ranks(_failing_worker, 2, timeout=120)
