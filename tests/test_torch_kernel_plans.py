"""Launch geometry and work plans of the port's kernels, on the CPU: the
pure functions that decide what the CUDA kernels K1 (both bodies), K4 (both
bodies) and K5 are launched with, held against their own invariants and,
where the JAX package has the same function, against it."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sdag_tpu.ops import attention as JA
from sdag_tpu.ops import topk as jtopk
from sdag_tpu_torch.ops import attention as TA
from sdag_tpu_torch.ops import topk as ttopk

SMEM_LIMIT = 232448   # bytes of dynamic shared memory a block may use


# ------------------------------------------------------------ K4 / K5
@pytest.mark.parametrize("qn", [1, 24, 64, 65, 129, 256, 1000])
@pytest.mark.parametrize("k", [1, 10, 16, 17, 64, 65, 128])
def test_topk_mma_geometry_invariants(qn, k):
    """Over corpus sizes, feature widths, both tensor-core dtypes and two
    SM counts: the splits cover every 128-row tile exactly once, the block
    fits in shared memory, the candidate buffer leaves room for the 32
    columns appended between two checks, 128-row query tiles only where
    their buffers fit, one split skips the merge pass."""
    for dtype in (torch.bfloat16, torch.int8):
        for n in (50, 384, 513, 5000, 1 << 20):
            for d in (48, 1024, 1040):
                for sms in (132, 108):
                    g = ttopk.topk_mma_geometry(qn, n, d, k, dtype, sms)
                    tiles = max(1, -(-n // ttopk.K4_TILE_N))
                    assert g["tiles"] == tiles
                    # every tile in exactly one split, no empty split
                    assert g["n_splits"] * g["tiles_per_split"] >= tiles
                    assert (g["n_splits"] - 1) * g["tiles_per_split"] < tiles
                    assert g["smem_bytes"] <= SMEM_LIMIT
                    assert 2 <= g["stages"] <= ttopk.K4_MAX_STAGES
                    assert g["cap"] in (64, 128, 256)
                    assert g["cap"] >= k + 32
                    assert g["q_rows"] == (128 if qn > 64 and k <= 64 else 64)
                    assert g["q_tiles"] == -(-qn // g["q_rows"])
                    assert g["direct"] == (g["n_splits"] == 1)
                    if tiles <= ttopk.K4_ONE_SPLIT_TILES:
                        assert g["direct"]
                    else:
                        # one block per SM across the query tiles
                        assert g["n_splits"] <= max(1, sms // g["q_tiles"])
                    es = 2 if dtype == torch.bfloat16 else 1
                    assert g["n_chunks"] * 128 >= d * es \
                        > (g["n_chunks"] - 1) * 128


def test_topk_mma_geometry_takes_the_most_stages_that_fit():
    for qn, k in ((256, 10), (256, 64), (32, 64), (130, 128)):
        g = ttopk.topk_mma_geometry(qn, 1 << 20, 1024, k, torch.bfloat16, 132)
        more = ttopk._mma_smem_bytes(g["q_rows"], g["cap"], g["stages"] + 1)
        assert g["stages"] == ttopk.K4_MAX_STAGES or more > SMEM_LIMIT


def test_topk_mma_smem_bytes_by_hand():
    """128 query rows, 128-entry buffers, 3 stages: 3 x (128 + 128) rows of
    128 bytes, 3 x 128 row scales, 2 x 128 x 128 words of buffer, 6
    barriers."""
    assert ttopk._mma_smem_bytes(128, 128, 3) == \
        3 * 256 * 128 + 3 * 512 + 2 * 128 * 128 * 4 + 6 * 8
    g = ttopk.topk_mma_geometry(256, 1 << 20, 1024, 64, torch.bfloat16, 132)
    assert (g["q_rows"], g["cap"], g["stages"]) == (128, 128, 3)
    assert g["n_splits"] == 66 and g["tiles_per_split"] == 125


@pytest.mark.parametrize("qn,n,sms", [(1, 50, 132), (256, 131072, 132),
                                      (32, 130072, 108), (1000, 4096, 132),
                                      (24, 384, 132), (33, 5000, 132),
                                      (65, 131072, 132), (129, 5000, 108)])
def test_topk_f32_geometry_covers_every_tile(qn, n, sms):
    """K4's float32 body over k: the splits cover every 128-row tile
    exactly once, at most two blocks per SM across the query tiles, the
    candidate buffer leaves room for the 16 columns appended between two
    checks and stays within its budget, the query tile is the least of
    32 / 64 / 128 rows that covers Q where the buffers allow (never past the
    next tile size above Q), one split skips the merge pass, and the shared
    memory of two blocks fits on an SM."""
    for k in (1, 5, 10, 48, 49, 64, 112, 113, 128):
        g = ttopk.topk_f32_geometry(qn, n, k, sms)
        tiles = max(1, -(-n // ttopk.K4_F32_TILE_N))
        assert g["tiles"] == tiles
        assert g["n_splits"] * g["tiles_per_split"] >= tiles
        assert (g["n_splits"] - 1) * g["tiles_per_split"] < tiles
        assert g["n_splits"] * g["q_tiles"] <= max(g["q_tiles"], 2 * sms)
        assert g["q_tiles"] == -(-qn // g["q_rows"])
        assert g["direct"] == (g["n_splits"] == 1)
        assert g["cap"] in (64, 128, 256) and g["cap"] >= k + 16
        assert g["q_rows"] * g["cap"] <= ttopk.K4_F32_BUFFER_ENTRIES
        assert g["q_rows"] in (32, 64, 128)
        least = next(r for r in (32, 64, 128) if r >= min(qn, 128))
        assert g["q_rows"] <= least
        if g["q_rows"] < least:            # held back by the buffers only
            assert 2 * g["q_rows"] * g["cap"] > ttopk.K4_F32_BUFFER_ENTRIES
        assert 2 * g["smem_bytes"] + 2048 <= 233472


def test_topk_f32_smem_bytes_by_hand():
    """128 query rows, 64-entry buffers: two chunks of 16 x (132 + 132)
    floats, the next query chunk (128 x 16), three words a row, 2 x 128 x 64
    words of buffer."""
    assert ttopk._f32_smem_bytes(128, 64) == \
        4 * (2 * 16 * 264 + 128 * 16 + 3 * 128 + 2 * 128 * 64)
    g = ttopk.topk_f32_geometry(256, 131072, 10, 132)
    assert (g["q_rows"], g["cap"], g["q_tiles"]) == (128, 64, 2)
    assert g["n_splits"] == 128 and g["tiles_per_split"] == 8
    g = ttopk.topk_f32_geometry(24, 384, 5, 132)
    assert (g["q_rows"], g["n_splits"], g["direct"]) == (32, 3, False)


@pytest.mark.parametrize("rows,width", [(1, 48), (24, 1024), (7, 1040)])
def test_query_quantiser_rule_bit_equal_to_jax(rows, width):
    """The rule K5's prologue kernel implements (its plain version on the
    CPU): scales and values equal the JAX package's eager quantiser bit
    for bit, zero rows and exact halves included."""
    rng = np.random.default_rng(rows * width)
    x = rng.standard_normal((rows, width)).astype(np.float32)
    x[0, :] = 0.0 if rows > 1 else x[0, :]
    x[-1, :4] = (0.5, 1.5, -2.5, 127.0)
    jq, js = jtopk.quantize_rows_int8(x)
    tq, ts = ttopk.quantize_last_axis_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantiser_kernel_wrapper_needs_a_cuda_matrix():
    with pytest.raises(ValueError):
        ttopk.quantize_rows_int8_cuda(torch.zeros(4, 16))


# ----------------------------------------------------------------- K1
def _meta(rng, B, L, n_docs, holes, neighbors):
    """Seeded prompt layouts: a system prefix, documents with 2-NN bits,
    optional hole runs, a tail, ragged valid lengths."""
    doc_id = np.full((B, L), -1, np.int32)
    nbr = np.zeros((B, L), np.int32)
    sul = np.zeros(B, np.int32)
    vl = np.zeros(B, np.int32)
    for b in range(B):
        pos = int(rng.integers(8, 40))
        sul[b] = pos
        for d in range(n_docs):
            ln = int(rng.integers(5, max(6, 2 * L // (3 * max(n_docs, 1)))))
            if pos + ln > int(L * 0.85):
                break
            doc_id[b, pos:pos + ln] = d
            if neighbors and d < 31:
                for nn in (d - 1, d + 1):
                    if 0 <= nn < min(n_docs, 31):
                        nbr[b, pos:pos + ln] |= np.int32(1 << nn)
            pos += ln
            if holes and rng.random() < 0.5:
                h = int(rng.integers(1, 6))
                doc_id[b, pos:pos + h] = -2
                pos += h
        vl[b] = int(rng.integers(int(L * 0.8), L + 1))
    return doc_id, nbr, sul, vl


PLAN_CASES = [
    # (name, B, Lk, Lq, n_docs, holes, neighbors)
    ("docs_2nn", 2, 640, 640, 6, False, True),
    ("holes_2nn_ragged", 3, 700, 700, 9, True, True),
    ("qoffset_slice", 2, 1990, 995, 30, True, True),
    ("over_31_docs", 1, 1000, 1000, 40, True, False),
    ("causal_only", 2, 333, 333, 0, False, False),
    ("decode_like_slice", 2, 520, 70, 5, False, True),
]


def _plan(case, seed):
    name, B, Lk, Lq, n_docs, holes, nbrs = case
    rng = np.random.default_rng(seed)
    doc_id, nbr, sul, vl = _meta(rng, B, Lk, n_docs, holes, nbrs)
    if B > 2:
        vl[1] = 0                        # a batch row nobody can see
    t = torch.from_numpy
    qo = np.full(B, Lk - Lq, np.int32)
    plan = TA.k1_plan(t(doc_id), t(nbr), t(sul), t(vl),
                      doc_id_q=t(doc_id[:, Lk - Lq:].copy()),
                      nbr_bits_q=t(nbr[:, Lk - Lq:].copy()), q_offset=t(qo))
    return plan


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: c[0])
def test_k1_plan_equals_jax_block_kinds_at_k1_tiles(case):
    """K1's plan at the tile sizes its kernels use (K1_BLOCK_Q x
    K1_BLOCK_K), lengths off the tile grid included: kinds, counts, packed
    kv lists and kind lists equal the JAX package's on the same padded
    metadata."""
    plan = _plan(case, seed=11)
    j = np.asarray(JA.compute_block_kinds(
        jnp.asarray(plan["doc_id"].numpy()),
        # key-side neighbor bits do not enter the kinds
        jnp.zeros(plan["doc_id"].shape, jnp.int32),
        jnp.asarray(plan["sys_user_len"].numpy()),
        jnp.asarray(plan["valid_len"].numpy()),
        TA.K1_BLOCK_Q, TA.K1_BLOCK_K,
        doc_id_q=jnp.asarray(plan["doc_id_q"].numpy()),
        nbr_bits_q=jnp.asarray(plan["nbr_bits_q"].numpy()),
        q_offset=jnp.asarray(plan["q_offset"].numpy())))
    np.testing.assert_array_equal(plan["kinds"].numpy(), j)
    jl = [np.asarray(a) for a in JA._pack_kv_lists(jnp.asarray(j))]
    for key, ref in zip(("counts", "kv_list", "kind_list"), jl):
        np.testing.assert_array_equal(plan[key].numpy(), ref)
    assert plan["nq"] == -(-plan["Lq"] // TA.K1_BLOCK_Q)
    assert plan["nk"] == -(-plan["Lk"] // TA.K1_BLOCK_K)


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: c[0])
def test_k1_partial_tile_mask_bits_equal_the_token_rule(case):
    """The bit tiles both K1 bodies test on PARTIAL tiles: every PARTIAL
    tile of a worklist has a slot, no other tile has one, and the bits
    equal the JAX package's int8 mask tiles (its token rule) on the same
    padded metadata."""
    plan = _plan(case, seed=13)
    j = np.asarray(JA.tile_masks_from_metadata(
        jnp.asarray(plan["doc_id"].numpy()),
        jnp.zeros(plan["doc_id"].shape, jnp.int32),
        jnp.asarray(plan["sys_user_len"].numpy()),
        jnp.asarray(plan["valid_len"].numpy()),
        TA.K1_BLOCK_Q, TA.K1_BLOCK_K,
        doc_id_q=jnp.asarray(plan["doc_id_q"].numpy()),
        nbr_bits_q=jnp.asarray(plan["nbr_bits_q"].numpy()),
        q_offset=jnp.asarray(plan["q_offset"].numpy())))
    kinds = plan["kinds"].numpy()
    kv, slot = plan["kv_list"].numpy(), plan["mask_slot"].numpy()
    counts = plan["counts"].numpy()
    bits = plan["mask_bits"].numpy().astype(np.int64) & 0xFFFFFFFF
    assert bits.shape[1:] == (TA.K1_BLOCK_Q, TA.K1_BLOCK_K // 32)
    seen = set()
    for b, qi in np.ndindex(*counts.shape):
        for t in range(kinds.shape[2]):
            ki, sl = int(kv[b, qi, t]), int(slot[b, qi, t])
            live = t < counts[b, qi]
            assert (sl >= 0) == (live and kinds[b, qi, ki] == TA.BLOCK_PARTIAL)
            if sl >= 0:
                seen.add(sl)
                tile = ((bits[sl][:, :, None] >> np.arange(32)) & 1).reshape(
                    TA.K1_BLOCK_Q, TA.K1_BLOCK_K)
                np.testing.assert_array_equal(tile, j[b, qi, ki])
    n_part = int((kinds == TA.BLOCK_PARTIAL).sum())
    assert seen == set(range(n_part))
    assert bits.shape[0] == max(n_part, 1)


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: c[0])
def test_k1_heavy_first_order(case):
    """The order both K1 bodies hand out (batch, q-tile) pairs in: every
    pair once, live-tile counts never rising, ties in index order."""
    plan = _plan(case, seed=12)
    order = plan["order"].numpy()
    counts = plan["counts"].numpy().reshape(-1)
    assert order.dtype == np.int32
    assert sorted(order.tolist()) == list(range(counts.size))
    walked = counts[order]
    assert (np.diff(walked) <= 0).all()
    same = np.diff(walked) == 0
    assert (np.diff(order)[same] > 0).all()


@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("n_kv", [1, 2, 8])
def test_k1_group_items_cover_every_head_once(group, n_kv):
    """How both K1 bodies pack a GQA layout: two q heads of one kv head
    per block when the group is even, one otherwise; every q head in
    exactly one item, with its own kv head."""
    nwg, items = TA.k1_group_items(group * n_kv, n_kv)
    assert nwg == (2 if group % 2 == 0 else 1)
    heads = [h for _kvh, hs in items for h in hs]
    assert sorted(heads) == list(range(group * n_kv))
    for kvh, hs in items:
        assert len(hs) == nwg
        assert all(h // group == kvh for h in hs)
    assert len(items) == n_kv * (group // nwg)


def test_k1_cuda_wrapper_checks_the_plan_against_the_tensors():
    q = torch.zeros(1, 2, 64, 32)
    with pytest.raises(ValueError):
        TA.sdag_prefill_cuda(q, q, q, None)


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: c[0])
def test_k1_live_tile_stats_by_hand(case):
    """The most and mean live key tiles per (batch, q-tile) that
    chip_smoke.py logs beside K1's times, against numpy on the plan's
    counts and against the JAX package's worklist counts."""
    plan = _plan(case, seed=14)
    counts = plan["counts"].numpy()
    st = TA.live_tile_stats(plan["counts"])
    assert st["max"] == int(counts.max())
    assert st["mean"] == pytest.approx(float(counts.mean()))
    assert st["max_over_mean"] == pytest.approx(
        counts.max() / counts.mean() if counts.mean() else 0.0)
    kinds = jnp.asarray(plan["kinds"].numpy())
    jcounts = np.asarray(JA._pack_kv_lists(kinds)[0])
    assert st["max"] == int(jcounts.max())


def test_k1_live_tile_stats_of_an_empty_plan():
    st = TA.live_tile_stats(torch.zeros(2, 3, dtype=torch.int32))
    assert st == {"max": 0, "mean": 0.0, "max_over_mean": 0.0}


def test_k1_f32_cuda_wrapper_rejects_cpu_tensors_with_a_plan():
    """The f32 body reads the same plan as the bf16 body (kinds, worklists,
    heavy-first order, PARTIAL bit tiles); a CPU tensor handed to the CUDA
    wrapper raises instead of falling back."""
    plan = _plan(PLAN_CASES[0], seed=15)
    for key in ("order", "mask_bits", "mask_slot", "counts", "kv_list",
                "kind_list", "valid_len", "q_offset"):
        assert plan[key].dtype == torch.int32 and plan[key].is_contiguous()
    B, Lq = plan["doc_id_q"].shape
    q = torch.zeros(B, 2, plan["Lq"], 32)
    k = torch.zeros(B, 2, plan["Lk"], 32)
    with pytest.raises(ValueError):
        TA.sdag_prefill_cuda(q, k, k, plan)
