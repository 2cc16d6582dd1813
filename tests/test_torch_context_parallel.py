"""Context-parallel SDAG prefill of the port on gloo ranks against the JAX
package's ``context_parallel_prefill_attention`` over the same number of
devices (all-gather and ring), f32, within 1e-5 on the valid rows; the
ring's chunk skip predicate equal to JAX's on random layouts (more than
31 docs included) and sound against the port's tile mask; an explicit
kernel request on the ring raises as JAX's does.  Each world is spawned
once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from sdag_tpu.parallel import context as jctx
from sdag_tpu_torch.core.mesh import make_mesh
from sdag_tpu_torch.ops.attention import _tile_mask
from sdag_tpu_torch.parallel import context as tctx
from sdag_tpu_torch.parallel.launch import run_ranks

B, H, HKV, L, DH = 2, 4, 2, 128, 16


def _layout(seed=0):
    """Two rows: a 6-doc isolation layout with neighbour windows and a
    ragged valid length, and a plain causal row."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, L, DH)).astype(np.float32)
    k = rng.standard_normal((B, HKV, L, DH)).astype(np.float32)
    v = rng.standard_normal((B, HKV, L, DH)).astype(np.float32)
    did = np.full((B, L), -1, np.int32)
    nbr = np.zeros((B, L), np.int32)
    pos = 12
    for d in range(6):
        did[0, pos:pos + 15] = d
        if d:
            nbr[0, pos:pos + 15] = 1 << (d - 1)
        pos += 17
    sul = np.array([12, 0], np.int32)
    vl = np.array([110, L], np.int32)
    return q, k, v, did, nbr, sul, vl


def _worker(rank, world):
    q, k, v, did, nbr, sul, vl = (torch.from_numpy(a) for a in _layout())
    mesh = make_mesh(data=1, model=world, device="cpu")
    ls = L // world
    rows = slice(rank * ls, (rank + 1) * ls)
    local = (q[:, :, rows], k[:, :, rows], v[:, :, rows], did[:, rows],
             nbr[:, rows])
    out = {}
    for ex in ("all_gather", "ring"):
        out[ex] = tctx.context_parallel_prefill_attention(
            *local, sul, vl, mesh, kv_exchange=ex).numpy()
    try:
        tctx.context_parallel_prefill_attention(*local, sul, vl, mesh,
                                                impl="pallas",
                                                kv_exchange="ring")
        out["ring_impl"] = None
    except ValueError as e:
        out["ring_impl"] = str(e)
    return out


@pytest.fixture(scope="module", params=[2, 4])
def world(request):
    n = request.param
    return n, run_ranks(_worker, n)


@pytest.mark.parametrize("ex", ["all_gather", "ring"])
def test_context_parallel_equals_jax(world, ex):
    n, ranks = world
    q, k, v, did, nbr, sul, vl = _layout()
    mesh = JaxMesh(np.array(jax.devices()[:n]), axis_names=("model",))
    want = np.asarray(jctx.context_parallel_prefill_attention(
        *(jnp.asarray(a) for a in (q, k, v, did, nbr, sul, vl)), mesh,
        kv_exchange=ex))
    got = np.concatenate([r[ex] for r in ranks], axis=2)
    for b in range(B):
        np.testing.assert_allclose(got[b, :, :vl[b]], want[b, :, :vl[b]],
                                   atol=1e-5, rtol=1e-5)


def test_ring_equals_all_gather(world):
    n, ranks = world
    _, _, _, _, _, _, vl = _layout()
    ag = np.concatenate([r["all_gather"] for r in ranks], axis=2)
    ring = np.concatenate([r["ring"] for r in ranks], axis=2)
    for b in range(B):
        np.testing.assert_allclose(ring[b, :, :vl[b]], ag[b, :, :vl[b]],
                                   atol=1e-5, rtol=1e-5)


def test_ring_rejects_a_kernel_request(world):
    n, ranks = world
    with pytest.raises(ValueError) as jerr:
        q, k, v, did, nbr, sul, vl = _layout()
        mesh = JaxMesh(np.array(jax.devices()[:n]), axis_names=("model",))
        jctx.context_parallel_prefill_attention(
            *(jnp.asarray(a) for a in (q, k, v, did, nbr, sul, vl)), mesh,
            impl="pallas", kv_exchange="ring")
    assert "impl='pallas'" in str(jerr.value)
    for r in ranks:
        assert r["ring_impl"] is not None
        assert "impl='pallas'" in r["ring_impl"]
        assert "kv_exchange='all_gather'" in r["ring_impl"]


def _random_layout(rng, n_docs_max, Lx=256):
    sul = int(rng.integers(8, 48))
    did = np.full(Lx, -1, np.int32)
    nbr = np.zeros(Lx, np.int32)
    pos, d = sul, 0
    while pos < Lx - 8 and d < n_docs_max:
        dl = int(rng.integers(4, 40))
        did[pos:pos + dl] = d
        if rng.random() < 0.4 and d > 0:
            nbr[pos:pos + dl] = 1 << int(rng.integers(0, min(d, 31)))
        if rng.random() < 0.1:
            did[pos + dl - 2:pos + dl] = -2          # holes
        pos += dl + int(rng.integers(0, 6))
        d += 1
    vl = int(rng.integers(min(pos, Lx), Lx + 1))
    return did, nbr, sul, vl


@pytest.mark.parametrize("n_docs_max,shards", [(12, 8), (40, 16)])
def test_chunk_needed_equals_jax_and_is_sound(n_docs_max, shards):
    """Every (q shard, k chunk) pair of 20 random layouts: the port's
    predicate equals JAX's, and False implies an all-False tile mask."""
    rng = np.random.default_rng(7 + n_docs_max)
    Lx = 256
    ls = Lx // shards
    jfn = jax.jit(jax.vmap(jctx.chunk_needed,
                           in_axes=(0, 0, 0, 0, 0, 0, None, None)))
    skipped = 0
    for _ in range(20):
        did, nbr, sul, vl = _random_layout(rng, n_docs_max, Lx)
        si, sj = np.meshgrid(np.arange(shards), np.arange(shards),
                             indexing="ij")
        si, sj = si.ravel(), sj.ravel()
        rows = si[:, None] * ls + np.arange(ls)[None, :]
        cols = sj[:, None] * ls + np.arange(ls)[None, :]
        args = (did[rows], nbr[rows], did[cols], si * ls + ls - 1, sj * ls,
                cols.astype(np.int32))
        want = np.asarray(jfn(*(jnp.asarray(a) for a in args), sul, vl))
        got = tctx.chunk_needed(*(torch.from_numpy(np.asarray(a))
                                  for a in args), sul, vl).numpy()
        np.testing.assert_array_equal(got, want)
        for p in np.flatnonzero(~got):
            mask = _tile_mask(torch.from_numpy(rows[p])[:, None],
                              torch.from_numpy(cols[p])[None, :],
                              torch.from_numpy(did[rows[p]])[:, None],
                              torch.from_numpy(did[cols[p]])[None, :],
                              torch.from_numpy(nbr[rows[p]])[:, None],
                              sul, vl)
            assert not bool(mask.any())
        skipped += int((~got).sum())
    assert skipped > 100          # the predicate skips real work
