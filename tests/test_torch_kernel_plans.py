"""Launch geometry and work plans of the port's kernels, on the CPU: the
pure functions that decide what the CUDA kernels K1 (both bodies), K2, K3
(both bodies), K4 (both bodies) and K5 are launched with, held against
their own invariants and, where the JAX package has the same function,
against it; K2's and both K3 bodies' arithmetic simulated over their
plans against the JAX kernels in interpret mode."""

import collections

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sdag_tpu.ops import attention as JA
from sdag_tpu.ops import bm25 as JB
from sdag_tpu.ops import encoder_attention as jea
from sdag_tpu.ops import topk as jtopk
from sdag_tpu_torch.ops import attention as TA
from sdag_tpu_torch.ops import bm25 as tb
from sdag_tpu_torch.ops import encoder_attention as tea
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


# ----------------------------------------------------------------- K3
K3_SHAPES = [(B, H, L, dh) for dh in (32, 64, 128)
             for (B, H, L) in ((1, 1, 1), (3, 2, 64), (32, 16, 64),
                               (2, 3, 100), (64, 16, 256), (4, 2, 300),
                               (32, 16, 512), (1, 16, 512))]


@pytest.mark.parametrize("B,H,L,dh", K3_SHAPES)
@pytest.mark.parametrize("sms", [132, 108])
def test_k3_geometry_covers_every_q_tile_once(B, H, L, dh, sms):
    """K3's bf16 body over Dh 32/64/128 and L up to 512: every (b, h,
    q-tile) is computed by exactly one warpgroup of one block, the block
    fits in shared memory (as many times as it claims an SM), the ring has
    at least 3 stages and holds every key tile when L <= 512 at Dh <= 64,
    and the split of a pair's rounds is the one the kernel derives."""
    g = tea.encoder_attention_geometry(B, H, L, dh, sms)
    assert g["smem_bytes"] == tea._k3_smem_bytes(dh, g["nwg"], g["stages"])
    assert g["smem_bytes"] <= SMEM_LIMIT
    assert g["blocks_per_sm"] >= 1
    assert g["blocks_per_sm"] * (g["smem_bytes"] + 1024) <= 233472
    assert 3 <= g["stages"] <= tea.K3_MAX_STAGES
    assert g["nwg"] == (1 if L <= 64 else 2)
    if dh <= 64:
        assert g["resident"]
    # the kernel's share of rounds per unit: ceil(rounds / splits)
    assert -(-g["rounds"] // g["splits"]) == g["per_unit"]
    assert 1 <= g["grid"] <= sms * g["blocks_per_sm"]
    seen = collections.Counter()
    for blk in range(g["grid"]):
        for b, h, qt, w in tea.encoder_attention_work(g, H, blk):
            assert 0 <= w < g["nwg"]
            seen[(b, h, qt)] += 1
    nqt = -(-L // 64)
    assert set(seen) == {(b, h, qt) for b in range(B) for h in range(H)
                         for qt in range(nqt)}
    assert set(seen.values()) == {1}


def test_k3_smem_bytes_by_hand():
    """Dh 64, two warpgroups, 8 stages: 2 x 2 Q tiles and 8 x (K, V) tiles
    of 64 x 64 bf16, two 8-word records, 2 x 8 + 2 x 2 barriers; the
    plan fills shared memory with stages (12 at one block an SM)."""
    assert tea._k3_smem_bytes(64, 2, 8) == \
        4 * 8192 + 16 * 8192 + 2 * 8 * 4 + 20 * 8
    g = tea.encoder_attention_geometry(32, 16, 512, 64, 132)
    assert (g["nwg"], g["stages"], g["rounds"], g["grid"]) == (2, 12, 4, 132)
    assert g["smem_bytes"] == 4 * 8192 + 24 * 8192 + 64 + 28 * 8
    g = tea.encoder_attention_geometry(32, 16, 64, 64, 132)
    assert (g["nwg"], g["stages"], g["blocks_per_sm"]) == (1, 6, 2)
    # Dh 128 at L 512 does not fit resident: the K/V tiles stream
    g = tea.encoder_attention_geometry(4, 16, 512, 128, 132)
    assert not g["resident"] and g["stages"] == 5


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _k3_tiles_simulated(qkv, vl, H):
    """K3's bf16 arithmetic tile by tile, in float32 on the CPU, over the
    launch plan's (b, h, q-tile) assignments: q * scale in bf16, p =
    exp2(s * log2 e - m * log2 e), on the edge tile only -1e30 past
    valid_len (0 for every column when valid_len is 0: the same uniform
    softmax) and -inf past L, key tiles past valid_len skipped (all L when
    it is 0), P rounded to bf16 for P.V, the row sum over f32 P, the
    output times the sum's reciprocal last."""
    B, L, d3 = qkv.shape
    d = d3 // 3
    dh = d // H
    log2e = 1.4426950408889634
    scale = float(torch.tensor(dh ** -0.5).to(torch.bfloat16))
    x = qkv.float()
    out = torch.full((B, L, d), float("nan"))
    g = tea.encoder_attention_geometry(B, H, L, dh, 132)
    for blk in range(g["grid"]):
        for b, h, qt, _ in tea.encoder_attention_work(g, H, blk):
            q = _bf16(x[b, qt * 64:(qt + 1) * 64, h * dh:(h + 1) * dh]
                      * scale)
            v_len = int(vl[b])
            live = min(v_len, L) if v_len > 0 else L
            m = torch.full((q.shape[0],), float("-inf"))
            lsum = torch.zeros(q.shape[0])
            o = torch.zeros(q.shape[0], dh)
            for t in range(-(-live // 64)):
                rows = slice(t * 64, min((t + 1) * 64, L))
                k = x[b, rows, d + h * dh:d + (h + 1) * dh]
                v = x[b, rows, 2 * d + h * dh:2 * d + (h + 1) * dh]
                s = q @ k.T
                col = torch.arange(rows.start, rows.stop)
                s = torch.where(col[None] >= v_len,
                                -1e30 if v_len > 0 else 0.0, s)
                m_new = torch.maximum(m, s.max(1).values)
                alpha = torch.exp2((m - m_new) * log2e)
                p = torch.exp2(s * log2e - (m_new * log2e)[:, None])
                lsum = lsum * alpha + p.sum(1)
                o = o * alpha[:, None] + _bf16(p) @ v
                m = m_new
            out[b, qt * 64:qt * 64 + q.shape[0], h * dh:(h + 1) * dh] = \
                o * (1.0 / lsum)[:, None]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("H,Dh,L,vl", [
    (4, 32, 64, [64, 1, 0, 37]),
    (2, 64, 200, [200, 64, 0, 1, 130]),
    (2, 128, 72, [72, 65, 0]),
])
def test_k3_bf16_tile_arithmetic_matches_pallas_interpret(H, Dh, L, vl):
    """The bf16 body's arithmetic, simulated over its launch plan, against
    the JAX kernel in interpret mode on the same bf16 inputs: within the
    limits chip_smoke.py holds the CUDA kernel to (2e-2 absolute, 5e-2 of
    a row's RMS); every output element is written; valid_len 0 gives the
    mean of V."""
    rng = np.random.default_rng(len(vl) * L)
    qkv = rng.standard_normal((len(vl), L, 3 * H * Dh)).astype(np.float32)
    qkv_b = torch.from_numpy(qkv).to(torch.bfloat16)
    vl_np = np.asarray(vl, np.int32)
    ref = np.asarray(jea.encoder_attention_fused_qkv(
        jnp.asarray(qkv_b.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(vl_np), n_heads=H, interpret=True).astype(jnp.float32))
    got = _k3_tiles_simulated(qkv_b, vl_np, H).float()
    assert torch.isfinite(got).all()
    diff = (got.numpy() - ref).reshape(len(vl), L, H, Dh)
    rms = np.sqrt((ref.reshape(len(vl), L, H, Dh) ** 2).mean(-1))
    assert np.abs(diff).max() <= 2e-2
    assert (np.abs(diff).max(-1) / np.maximum(rms, 1e-30)).max() <= 5e-2
    plain = tea.encoder_attention_qkv_reference(
        qkv_b, torch.from_numpy(vl_np), H).float()
    assert (got - plain).abs().max() <= 2e-2


@pytest.mark.parametrize("B,H,L,dh", K3_SHAPES)
def test_k3_f32_geometry_covers_every_q_tile_once(B, H, L, dh):
    """K3's f32 body: one block per (b, h, q-tile), each computed exactly
    once, a pair's q-tiles neighbours in the grid, and the block's two K/V
    stages within shared memory as many times as it claims an SM."""
    g = tea.encoder_attention_geometry(B, H, L, dh, 132, "float32")
    assert g["smem_bytes"] == tea._k3f_smem_bytes(dh) <= SMEM_LIMIT
    assert g["stages"] == tea.K3F_STAGES == 2
    assert 1 <= g["blocks_per_sm"] <= tea.K3F_MIN_BLOCKS[dh]
    assert g["blocks_per_sm"] * (g["smem_bytes"] + 1024) <= 233472
    nqt = -(-L // 64)
    assert g["grid"] == B * H * nqt
    seen = collections.Counter()
    for blk in range(g["grid"]):
        work = list(tea.encoder_attention_work(g, H, blk))
        assert len(work) == 1
        b, h, qt, w = work[0]
        assert w == 0 and blk == (b * H + h) * nqt + qt
        seen[(b, h, qt)] += 1
    assert set(seen) == {(b, h, qt) for b in range(B) for h in range(H)
                         for qt in range(nqt)}
    assert set(seen.values()) == {1}


def test_k3_f32_smem_bytes_by_hand():
    """Two stages of a 64 x Dh float32 K tile and V tile, and at Dh 128 the
    64 q rows; blocks an SM by the kernel's launch bounds."""
    for dh, nbytes, blocks in ((32, 32768, 3), (64, 65536, 2),
                               (128, 163840, 1)):
        g = tea.encoder_attention_geometry(64, 16, 256, dh, 132, "float32")
        assert (g["smem_bytes"], g["blocks_per_sm"]) == (nbytes, blocks)
    # the bf16 plan is the default body's
    assert tea.encoder_attention_geometry(64, 16, 256, 64, 132) == \
        tea.encoder_attention_geometry(64, 16, 256, 64, 132, "bfloat16")


def _tf32_hi(x):
    """x rounded to TF32 as the kernel's split does: (bits + 0x1000) with
    the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """What the tensor core reads of an f32 register: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the f32 body's mma.sync sequence computes it: each operand
    split into hi (TF32-rounded) and lo (the exact remainder, truncated to
    TF32 by the tensor core), hi.lo + lo.hi + hi.hi accumulated in f32.
    The TF32 products are exact in f32."""
    ah, bh = _tf32_hi(a), _tf32_hi(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def _mm_tf32(a, b):
    """a @ b in plain TF32 (operands truncated by the tensor core)."""
    return _tf32_trunc(a) @ _tf32_trunc(b)


def _k3_f32_tiles_simulated(qkv, vl, H, mm=_mm_3xtf32):
    """K3's f32 arithmetic tile by tile over the f32 launch plan: q * scale
    in f32, both products through ``mm`` (split TF32 in the kernel), the
    online softmax as exp2(s log2 e - m log2 e) per 64-key tile, -1e30
    past valid_len on the edge tile (0 when valid_len is 0), -inf past L,
    key tiles past valid_len skipped, the output times the row sum's
    reciprocal last."""
    B, L, d3 = qkv.shape
    d = d3 // 3
    dh = d // H
    log2e = 1.4426950408889634
    x = qkv.float()
    out = torch.full((B, L, d), float("nan"))
    g = tea.encoder_attention_geometry(B, H, L, dh, 132, "float32")
    for blk in range(g["grid"]):
        for b, h, qt, _ in tea.encoder_attention_work(g, H, blk):
            q = x[b, qt * 64:(qt + 1) * 64, h * dh:(h + 1) * dh] \
                * torch.tensor(dh ** -0.5, dtype=torch.float32)
            v_len = int(vl[b])
            live = min(v_len, L) if v_len > 0 else L
            m = torch.full((q.shape[0],), float("-inf"))
            lsum = torch.zeros(q.shape[0])
            o = torch.zeros(q.shape[0], dh)
            for t in range(-(-live // 64)):
                rows = slice(t * 64, min((t + 1) * 64, L))
                k = x[b, rows, d + h * dh:d + (h + 1) * dh]
                v = x[b, rows, 2 * d + h * dh:2 * d + (h + 1) * dh]
                s = mm(q, k.T)
                col = torch.arange(rows.start, rows.stop)
                s = torch.where(col[None] >= v_len,
                                -1e30 if v_len > 0 else 0.0, s)
                m_new = torch.maximum(m, s.max(1).values)
                alpha = torch.exp2((m - m_new) * log2e)
                p = torch.exp2(s * log2e - (m_new * log2e)[:, None])
                lsum = lsum * alpha + p.sum(1)
                o = o * alpha[:, None] + mm(p, v)
                m = m_new
            out[b, qt * 64:qt * 64 + q.shape[0], h * dh:(h + 1) * dh] = \
                o * (1.0 / lsum)[:, None]
    return out


def _k3_f32_errors(got, ref, B, L, H, Dh):
    diff = np.abs(got - ref).reshape(B, L, H, Dh)
    rms = np.sqrt((ref.reshape(B, L, H, Dh) ** 2).mean(-1))
    return diff.max(), (diff.max(-1) / np.maximum(rms, 1e-30)).max()


@pytest.mark.parametrize("H,Dh,L,vl", [
    (4, 32, 64, [64, 1, 0, 37]),
    (2, 64, 200, [200, 64, 0, 1, 130]),
    (16, 64, 128, [128, 77]),
    (2, 128, 72, [72, 65, 0]),
])
def test_k3_f32_split_tf32_arithmetic_matches_pallas_interpret(H, Dh, L, vl):
    """The f32 body's split-TF32 arithmetic, simulated over its launch
    plan, against the JAX kernel in interpret mode on the same f32 inputs:
    within the limits chip_smoke.py holds the CUDA kernel to (1e-4
    absolute, 1e-3 of a row's RMS); every output element is written.
    Plain TF32 through the same tiles misses those limits, so they tell
    the split from a single TF32 product."""
    B = len(vl)
    rng = np.random.default_rng(B * L + Dh)
    qkv = rng.standard_normal((B, L, 3 * H * Dh)).astype(np.float32)
    vl_np = np.asarray(vl, np.int32)
    ref = np.asarray(jea.encoder_attention_fused_qkv(
        jnp.asarray(qkv), jnp.asarray(vl_np), n_heads=H, interpret=True))
    got = _k3_f32_tiles_simulated(torch.from_numpy(qkv), vl_np, H)
    assert torch.isfinite(got).all()
    err, row_err = _k3_f32_errors(got.numpy(), ref, B, L, H, Dh)
    assert err <= 1e-4 and row_err <= 1e-3, (err, row_err)
    plain = tea.encoder_attention_qkv_reference(
        torch.from_numpy(qkv), torch.from_numpy(vl_np), H)
    assert (got - plain).abs().max() <= 1e-4
    one = _k3_f32_tiles_simulated(torch.from_numpy(qkv), vl_np, H,
                                  mm=_mm_tf32).numpy()
    err1, row_err1 = _k3_f32_errors(one, ref, B, L, H, Dh)
    assert err1 > 1e-4 or row_err1 > 1e-3, (err1, row_err1)


def test_k3_cuda_wrapper_rejects_cpu_tensors():
    qkv = torch.zeros(2, 64, 3 * 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tea.encoder_attention_cuda(qkv, torch.ones(2, dtype=torch.int32), 1)


# ----------------------------------------------------------------- K2
@pytest.mark.parametrize("valid_n", [0, 1, 7, 384, 4321, 5000, 1 << 20])
@pytest.mark.parametrize("qn,t,k", [(32, 16, 10), (32, 32, 64), (33, 16, 20),
                                    (1, 1, 1), (24, 32, 5)])
def test_k2_geometry_covers_every_doc_once(valid_n, qn, t, k):
    """Every valid doc falls in exactly one warp's range of one tile of one
    block, ranges ascend within a block, the block fits in shared memory
    (as many times as it claims an SM), the lists fit the sorted merge, and
    at 384 docs every SM of the card gets a block."""
    sms = 132
    g = tb.bm25_scan_geometry(valid_n, qn, t, k, sms)
    assert g["smem_bytes"] <= SMEM_LIMIT
    assert g["blocks_per_sm"] >= 1
    assert g["blocks_per_sm"] * (g["smem_bytes"] + 1024) <= 233472
    assert 1 <= g["n_blocks"] <= tb.K2_MERGE_MAX_LISTS
    assert g["n_blocks"] * g["groups"] <= max(
        g["groups"], sms * g["blocks_per_sm"])
    assert 1 <= g["td"] <= tb.K2_TILE_MAX
    assert g["cap"] >= k + 32
    assert g["ht"] >= 2 * 32 * t and g["ht"] == 1 << g["ht_log2"]
    assert g["groups"] == -(-qn // 32)
    hit = np.zeros(valid_n, np.int32)
    for blk in range(g["n_blocks"]):
        last = -1
        for _tile, _w, first, end in tb.bm25_scan_work(g, valid_n, blk):
            assert first > last
            hit[first:end] += 1
            last = end - 1
    assert (hit == 1).all()
    if valid_n == 384 and qn <= 32:
        assert g["n_blocks"] >= sms


def test_k2_smem_bytes_by_hand():
    """T 16, 64-entry buffers: two 32 x 65 score tiles, 2 x 32 x 64 words
    of buffer, 8 warps x 8 chunks x 2 x 64 words of ring, 1024 table
    slots of 8 bytes, 512 entries of 32 slot bytes, 8 x 16 x 32
    accumulators, 16 x 32 weights and terms, 32 query states of 12 bytes,
    8 x 32 hits of 8 bytes, 16 bytes."""
    assert tb._k2_smem_bytes(16, 64, 1024) == \
        2 * 32 * 65 * 4 + 2 * 32 * 64 * 4 + 8 * 8 * 2 * 64 * 4 \
        + 1024 * 8 + 512 * 32 + 8 * 16 * 32 * 4 + 2 * 16 * 32 * 4 \
        + 32 * 12 + 8 * 32 * 8 + 16
    g = tb.bm25_scan_geometry(1 << 20, 32, 16, 10, 132)
    assert (g["blocks_per_sm"], g["td"], g["n_blocks"]) == (2, 64, 264)


def _k2_simulated(term_ids, impacts, q_terms, q_weights, k, valid_n):
    """K2 step by step on the CPU in float32: the launch plan's blocks and
    warp ranges, a per-query slot mask with each slot's impact stored at
    its first match and added after, the score summed over the set slots
    in slot order with one rounding per multiply and add, the (score, doc)
    threshold and buffer compaction of the selection, each block's sorted
    list, and the heads-only merge of the lists."""
    qn, t = q_terms.shape
    lp = term_ids.shape[1]
    g = tb.bm25_scan_geometry(valid_n, qn, t, k, 132)
    cap = g["cap"]
    f32 = np.float32
    key = lambda e: (-e[0], e[1])  # noqa: E731
    lists = [[[] for _ in range(qn)] for _ in range(g["n_blocks"])]
    for blk in range(g["n_blocks"]):
        buf = [[] for _ in range(qn)]
        thr = [(f32(-np.inf), 2 ** 31 - 1)] * qn
        for tile in range(blk, g["n_tiles"], g["n_blocks"]):
            scores = {}
            for _, _, first, end in tb.bm25_scan_work(g, valid_n, blk):
                if not tile * g["td"] <= first < (tile + 1) * g["td"]:
                    continue
                for doc in range(first, end):
                    for q in range(qn):
                        c, matched = {}, 0
                        for l in range(lp):
                            term = term_ids[doc, l]
                            if term < 0:
                                continue
                            for s in range(t):
                                if q_terms[q, s] == term:
                                    if matched >> s & 1:
                                        c[s] = f32(c[s] + impacts[doc, l])
                                    else:
                                        c[s] = impacts[doc, l]
                                        matched |= 1 << s
                        sc = f32(0.0)
                        for s in range(t):
                            if matched >> s & 1:
                                sc = f32(sc + f32(q_weights[q, s] * c[s]))
                        scores[(q, doc)] = sc
            for q in range(qn):
                for doc in sorted(d for (qq, d) in scores if qq == q):
                    e = (scores[(q, doc)], doc)
                    if key(e) < key(thr[q]):
                        buf[q].append(e)
                    if len(buf[q]) > cap - 32:
                        buf[q] = sorted(buf[q], key=key)[:k]
                        if len(buf[q]) == k:
                            thr[q] = buf[q][-1]
        for q in range(qn):
            lists[blk][q] = sorted(buf[q], key=key)[:k]
    vals = np.full((qn, k), -np.inf, np.float32)
    idx = np.full((qn, k), -1, np.int32)
    for q in range(qn):
        merged = sorted((e for blk in lists for e in blk[q]), key=key)[:k]
        for j, (v, d) in enumerate(merged):
            vals[q, j], idx[q, j] = v, d
    return vals, idx


@pytest.mark.parametrize("k,valid_n", [(5, None), (10, 250), (4, 2),
                                       (40, 300)])
def test_k2_simulated_kernel_bit_equal_to_plain_and_pallas(k, valid_n):
    """K2's arithmetic and selection, simulated over its launch plan, give
    the plain version's scores bit for bit and the JAX kernel's (interpret
    mode) doc ids, with queries that repeat a term in two slots, 0-score
    docs ranked by index and (-inf, -1) past valid_n."""
    rng = np.random.default_rng(k)
    n, lp, v, qn, tq = 300, 24, 40, 5, 8
    term_ids = np.full((n, lp), -1, np.int32)
    impacts = np.zeros((n, lp), np.float32)
    for i in range(n):
        terms = rng.choice(v, size=int(rng.integers(3, 20)), replace=False)
        term_ids[i, :len(terms)] = terms
        impacts[i, :len(terms)] = rng.random(len(terms)) + 0.01
    q_terms = rng.integers(0, v, size=(qn, tq)).astype(np.int32)
    q_terms[:, tq - 2:] = -1
    q_terms[0, 1] = q_terms[0, 0]          # one term in two slots
    q_weights = np.where(q_terms == -1, 0.0, rng.integers(
        1, 3, size=(qn, tq)) + 0.3).astype(np.float32)
    vn = n if valid_n is None else valid_n
    sv, si = _k2_simulated(term_ids, impacts, q_terms, q_weights, k, vn)
    pv, pi = tb.bm25_topk(torch.from_numpy(term_ids),
                          torch.from_numpy(impacts),
                          torch.from_numpy(q_terms),
                          torch.from_numpy(q_weights), k, valid_n=valid_n)
    np.testing.assert_array_equal(sv, pv.numpy())
    np.testing.assert_array_equal(si, pi.numpy())
    jv, ji = JB.bm25_topk(jnp.asarray(term_ids), jnp.asarray(impacts),
                          jnp.asarray(q_terms), jnp.asarray(q_weights), k,
                          valid_n=valid_n, block_n=128, interpret=True)
    np.testing.assert_array_equal(si, np.asarray(ji))


def test_k2_cuda_wrapper_rejects_cpu_tensors():
    z = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="not on CUDA"):
        tb.bm25_topk_cuda(z, z.float(), z, z.float(), 2)


# ------------------------------------------------------------ launch
class _FakeLib:
    """A library whose launch function records its arguments and returns
    the code it is given."""

    def __init__(self, rc):
        self.rc, self.args = rc, None

    def k(self, *args):
        self.args = args
        return self.rc

    def kernel_error_string(self, rc):
        return b"planted"


def test_launch_passes_pointers_and_the_stream_then_counts(monkeypatch):
    """``_build.launch``: a tensor goes as its data pointer, None as a
    null pointer, a number as it is, the current stream's handle last;
    the count rises by ``n`` only after a launch that returned 0, and a
    CUDA error code raises with the function's name."""
    from sdag_tpu_torch import _build
    stream = type("S", (), {"cuda_stream": 77})()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: stream)
    t = torch.zeros(4)
    lib = _FakeLib(0)
    before = _build.LAUNCHES["fake"]
    _build.launch(lib, "k", t, None, 3, 0.5, device="cuda",
                  count_key="fake", n=2)
    ptr, null, i, f, s = lib.args
    assert (ptr.value, null.value, i, f, s.value) == (t.data_ptr(), None, 3,
                                                      0.5, 77)
    assert _build.LAUNCHES["fake"] == before + 2
    _build.launch(lib, "k", t, device="cuda")
    assert _build.LAUNCHES["fake"] == before + 2
    with pytest.raises(RuntimeError, match="k launch failed.*planted"):
        _build.launch(_FakeLib(719), "k", t, device="cuda", count_key="fake")
    assert _build.LAUNCHES["fake"] == before + 2
    del _build.LAUNCHES["fake"]
