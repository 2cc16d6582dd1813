"""K6's bfloat16 body (int8 weights on ``mma.sync``; the splits of K
reduced inside a thread block cluster; weights and activations streamed
through a ring of shared-memory stages): its launch geometry, and its
order of sums emulated on the CPU against the plain version and JAX's
``_mm``.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` phase 8(a)
holds it to its plain version.  Here its order of sums is replayed in
torch: each split's f32 sum over its k range in the kernel's order
(64-wide blocks, k steps of 16 columns in the kernel's permutation, each
step's exact products added in f32), the splits added in rank order, then
``T(T(acc) T(s))``."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sdag_tpu.models import llama as JL
from sdag_tpu_torch.models.llama import DecoderConfig
from sdag_tpu_torch.models.native_ckpt import load_config
from sdag_tpu_torch.ops.int8_matmul import (K6_BF16_CHUNK, K6_BF16_SMEM_2,
                                            K6_MAX_CLUSTER,
                                            int8_matmul_reference,
                                            k6_geometry, k6_plan)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132
TOL = chip_smoke.K6_BF16_TOL
PRODUCTS_8B = chip_smoke.k6_products(DecoderConfig.llama3_8b())
PRODUCTS_QA = chip_smoke.k6_products(
    load_config(os.path.join(REPO, "experiments", "data", "qa_ckpt")))
PRODUCTS = [(p[0], p[1], p[2]) for p in PRODUCTS_8B + PRODUCTS_QA]
BLOCK_SMEM = 232448     # shared bytes one block may use on an H100
CHANNELS = 128          # output channels emulated per product
# k step j of a 64-wide block: actual columns 16 t + 4 j + {0..3}, t = 0..3
STEPS = [[16 * t + 4 * j + e for t in range(4) for e in range(4)]
         for j in range(4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Parallel test workers share the CPU; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,N,K", PRODUCTS)
def test_bf16_geometry_plan_fixed_ring_fits(name, N, K):
    """At every row count 1..128: the plan (warps, splits, k blocks a split,
    channel blocks, cluster) does not vary; the cluster is the splits (so
    it divides the grid's splits), at most 8, and the blocks fit one wave
    of two an SM unless there is one split; no split is empty; the ring
    has 2 to 4 stages of whole 64-wide blocks, fits the shared memory a
    block may use, leaves two blocks an SM with at least 3 stages up to
    40 rows, and holds the split's f32 partial tile; one producer warp."""
    plan = None
    kblocks = -(-K // 64)
    for m in range(1, 129):
        g = k6_geometry(m, N, K, torch.bfloat16, SMS)
        fixed = (g["warps"], g["splits"], g["per"], g["blocks"],
                 g["cluster"], g["kc"], g["threads"])
        plan = plan or fixed
        assert fixed == plan
        assert g["nt"] == -(-m // 8)
        assert 2 <= g["stages"] <= 4
        assert g["smem_bytes"] <= BLOCK_SMEM
        assert m * (16 * g["warps"] + 4) * 4 <= g["smem_bytes"]
        if m <= 40:
            assert g["smem_bytes"] <= K6_BF16_SMEM_2 and g["stages"] >= 3
    warps, splits, per, blocks, cluster, kc, threads = plan
    assert (warps, splits) == k6_plan(N, K, SMS)
    assert cluster == splits <= K6_MAX_CLUSTER and splits % cluster == 0
    assert (splits - 1) * per < kblocks <= splits * per
    assert blocks * 16 * warps >= N and warps in (1, 2, 4, 8)
    assert blocks * splits <= 2 * SMS or splits == 1
    assert kc == K6_BF16_CHUNK and kc % 64 == 0
    assert threads == 32 * warps + 32


def test_csrc_mirrors_the_bf16_constants():
    """csrc/int8_matmul.cu's chunk, two-block shared bytes and cluster
    limit are the ones k6_geometry and k6_plan use."""
    with open(os.path.join(REPO, "sdag_tpu_torch", "csrc",
                           "int8_matmul.cu")) as fh:
        src = fh.read()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["KB"]) == K6_BF16_CHUNK
    assert int(consts["BF16_SMEM_2"]) == K6_BF16_SMEM_2
    assert int(consts["MAX_CLUSTER"]) == K6_MAX_CLUSTER


def _k6_bf16_emulated(x, w, s, n_plan):
    """The bf16 body's order of sums: x [M, K] bf16, w [n, K] int8 (some
    of a product's channels), s [n] f32; the splits from the geometry at
    M rows and the product's full width ``n_plan``."""
    M, K = x.shape
    geo = k6_geometry(M, n_plan, K, torch.bfloat16, SMS)
    kpad = -(-K // 64) * 64
    xf = torch.nn.functional.pad(x.float(), (0, kpad - K))
    wf = torch.nn.functional.pad(w.float(), (0, kpad - K))
    acc = None
    for sp in range(geo["splits"]):
        c = torch.zeros(M, w.shape[0])
        for kb in range(sp * geo["per"],
                        min(kpad // 64, (sp + 1) * geo["per"])):
            for cols in STEPS:
                step = None
                for col in cols:
                    k = 64 * kb + col
                    p = xf[:, k:k + 1] * wf[:, k]       # exact in f32
                    step = p if step is None else step + p
                c = c + step
        acc = c if acc is None else acc + c
    return acc.to(torch.bfloat16) * s.to(torch.bfloat16)


def _row_rel_err(y, ref):
    d = (y.double() - ref.double()).abs()
    return float((d.amax(-1) / ref.double().abs().amax(-1)).max())


def _case(M, K, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.integers(-127, 128, size=(n, K)).astype(np.int8)
    s = (rng.random(n) * 2e-3 + 1e-4).astype(np.float32)
    return (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
            torch.from_numpy(s))


@pytest.mark.parametrize("M", [8, 40])
@pytest.mark.parametrize("name,N,K", PRODUCTS)
def test_bf16_sum_order_within_limit_and_rows_alone(name, N, K, M):
    """At every decode product (128 of its channels, the plan of its full
    width): the emulated sum order stays within chip_smoke's K6-bf16 limit
    (1e-2 of each row's max |y|) of int8_matmul_reference, and its first
    8 rows and first row, computed alone (their own geometry), are the
    same bits."""
    x, w, s = _case(M, K, min(N, CHANNELS), seed=N + K + M)
    got = _k6_bf16_emulated(x, w, s, N)
    assert got.dtype == torch.bfloat16 and got.shape == (M, w.shape[0])
    assert _row_rel_err(got, int8_matmul_reference(x, w, s)) <= TOL
    for m in (8, 1):
        assert torch.equal(_k6_bf16_emulated(x[:m], w, s, N), got[:m])


def test_bf16_emulation_and_plain_version_match_jax_mm():
    """384 channels, K = 1024, 40 rows in bf16: the emulated sum order and
    int8_matmul_reference are both within the K6-bf16 limit of JAX's
    ``_mm`` (``(x @ w.astype(bf16)) * s.astype(bf16)``) on the CPU."""
    N, K, M = 384, 1024, 40
    x, w, s = _case(M, K, N, seed=11)
    ref_jax = JL._mm(jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16),
                     {"w": jnp.asarray(w.numpy().T),
                      "s": jnp.asarray(s.numpy())})
    assert ref_jax.dtype == jnp.bfloat16
    ref = torch.from_numpy(np.asarray(ref_jax.astype(jnp.float32)).copy())
    assert _row_rel_err(_k6_bf16_emulated(x, w, s, N), ref) <= TOL
    assert _row_rel_err(int8_matmul_reference(x, w, s), ref) <= TOL


def test_dropping_the_last_split_misses_the_limit():
    """The planted fault of phase 8(a) at wq (M = 40): the sum without the
    last split's last 64-wide block misses the limit, as does one without
    the last rank; so the limit catches a cluster sum that drops a rank."""
    N, K, M = 4096, 4096, 40
    x, w, s = _case(M, K, CHANNELS, seed=5)
    geo = k6_geometry(M, N, K, torch.bfloat16, SMS)
    ref = int8_matmul_reference(x, w, s)
    w_block = w.clone()
    w_block[:, K - 64:] = 0
    w_rank = w.clone()
    w_rank[:, (geo["splits"] - 1) * geo["per"] * 64:] = 0
    assert _row_rel_err(_k6_bf16_emulated(x, w_block, s, N), ref) > TOL
    assert _row_rel_err(_k6_bf16_emulated(x, w_rank, s, N), ref) > TOL


def test_chip_smoke_reads_bf16_ptxas_counts(tmp_path):
    """chip_smoke.k6_bf16_ptxas (phase 8(a)'s plan log, kernel_times'
    K6_bf16_ptxas) takes each bf16 instantiation's registers and spills
    from nvcc's -Xptxas=-v log by its row tiles, and skips other bodies."""
    body = "_ZN47_GLOBAL__N__0_int8_matmul_cu_23int8_matmul_bf16_kernelILi{}EEv"
    log = "".join(
        f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
        f"    0 bytes stack frame, {st} bytes spill stores, {ld} bytes "
        f"spill loads\nptxas info    : Used {regs} registers\n"
        for name, regs, st, ld in (
            (body.format(5), 77, 0, 0), (body.format(16), 96, 64, 32),
            ("_ZN47_GLOBAL__N__0_int8_matmul_cu_22int8_matmul_f32_kernel"
             "ILi5EEv", 127, 0, 0)))
    (tmp_path / "int8_matmul.log").write_text(log)

    class Build:
        BUILD = str(tmp_path)
    assert chip_smoke.k6_bf16_ptxas(Build) == {
        5: {"registers": 77, "spill_store_bytes": 0, "spill_load_bytes": 0},
        16: {"registers": 96, "spill_store_bytes": 64,
             "spill_load_bytes": 32}}
    Build.BUILD = str(tmp_path / "missing")
    assert chip_smoke.k6_bf16_ptxas(Build) == {}
