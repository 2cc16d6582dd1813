"""K6's float32 body (split TF32 on the tensor cores): its arithmetic
emulated on the CPU against float64 and JAX's ``_mm``, and its launch plan.

The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
phase 8(a) holds it to its plain version; here its arithmetic is replayed
in torch: each activation split as the kernel splits it (hi = x rounded to
TF32 by the kernel's mask, lo = x - hi truncated to TF32's 19 bits as the
tensor core reads it), the int8 weights exact, two products a k step in
the kernel's column order, each 64-wide k block summed apart and then
added in f32, the plan's splits added in split order, then scaled."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sdag_tpu.models import llama as JL
from sdag_tpu_torch.models.llama import DecoderConfig
from sdag_tpu_torch.models.native_ckpt import load_config
from sdag_tpu_torch.ops.int8_matmul import k6_geometry, k6_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132
TOL = chip_smoke.K6_F32_TOL
PRODUCTS_8B = chip_smoke.k6_products(DecoderConfig.llama3_8b())
PRODUCTS_QA = chip_smoke.k6_products(
    load_config(os.path.join(REPO, "experiments", "data", "qa_ckpt")))
CHANNELS = 256      # output channels emulated per 8B product


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Parallel test workers share the CPU; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf32_round(x):
    """The kernel's hi: (bits + 0x1000) & 0xffffe000."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """A float as the tensor core reads a TF32 operand: its low 13 bits
    dropped."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _k6_f32_emulated(x, w, s, n_plan, two_terms=True):
    """The f32 body's arithmetic: x [M, K] f32, w [N, K] int8 (a subset of
    a product's channels), s [N]; the splits from ``k6_plan`` at the
    product's full width ``n_plan``."""
    M, K = x.shape
    geo = k6_geometry(M, n_plan, K, torch.float32, SMS)
    kpad = -(-K // 64) * 64
    hi = _tf32_round(x)
    lo = _tf32_trunc(x - hi)
    pad = lambda t: torch.nn.functional.pad(t, (0, kpad - K))  # noqa: E731
    hi, lo, wf = pad(hi), pad(lo), pad(w.float())
    # k step j of a 64-wide block: columns 16 t + 2 j + {0, 1}, t = 0..3
    steps = [torch.tensor([16 * t + 2 * j + e for t in range(4)
                           for e in range(2)]) for j in range(8)]
    acc = None
    for sp in range(geo["splits"]):
        c = torch.zeros(M, w.shape[0])
        for kb in range(sp * geo["per"],
                        min(kpad // 64, (sp + 1) * geo["per"])):
            d = torch.zeros(M, w.shape[0])
            for cols in steps:
                cols = cols + 64 * kb
                wc = wf[:, cols].T
                if two_terms:
                    d = d + lo[:, cols] @ wc
                d = d + hi[:, cols] @ wc
            c = c + d
        acc = c if acc is None else acc + c
    return acc * s


def _row_rel_err(y, ref):
    d = (y.double() - ref.double()).abs()
    return float((d.amax(-1) / ref.double().abs().amax(-1)).max())


def _case(M, N, K, n_emulated, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.integers(-127, 128, size=(n_emulated, K)).astype(np.int8)
    s = (rng.random(n_emulated) * 2e-3 + 1e-4).astype(np.float32)
    return x, w, s


@pytest.mark.parametrize("M", [8, 40])
@pytest.mark.parametrize("name,N,K", [(p[0], p[1], p[2])
                                      for p in PRODUCTS_8B + PRODUCTS_QA])
def test_split_tf32_emulation_within_limit_of_f64_and_jax(name, N, K, M):
    """At every decode product of the 8B model (256 of its channels, the
    plan of its full width) and of qa_ckpt (every channel): within
    chip_smoke's K6-f32 limit (1e-5 of each row's max |y|) of the float64
    product and of JAX's f32 ``_mm``."""
    n = min(N, CHANNELS)
    x, w, s = _case(M, N, K, n, seed=N + K + M)
    got = _k6_f32_emulated(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(s), N)
    ref64 = (torch.from_numpy(x).double() @ torch.from_numpy(w).double().T
             ) * torch.from_numpy(s).double()
    assert got.dtype == torch.float32 and got.shape == (M, n)
    assert _row_rel_err(got, ref64) <= TOL
    ref_jax = np.asarray(JL._mm(jnp.asarray(x), {"w": jnp.asarray(w.T),
                                                 "s": jnp.asarray(s)}))
    assert _row_rel_err(got, torch.from_numpy(ref_jax.copy())) <= TOL


@pytest.mark.parametrize("M", [8, 40])
def test_one_tf32_product_misses_the_limit(M):
    """Dropping lo (one TF32 product a fragment) misses the limit at
    K = 14336 by far, so the limit tells the split from a single TF32
    product; the two-term split meets it with room."""
    N, K = 4096, 14336
    x, w, s = _case(M, N, K, CHANNELS, seed=7 + M)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(s), N)
    ref64 = (torch.from_numpy(x).double() @ torch.from_numpy(w).double().T
             ) * torch.from_numpy(s).double()
    one = _row_rel_err(_k6_f32_emulated(*args, two_terms=False), ref64)
    two = _row_rel_err(_k6_f32_emulated(*args), ref64)
    assert one > 4 * TOL and two < TOL / 4, (one, two)


def test_every_int8_value_is_exact_in_tf32():
    """All 256 int8 values: the kernel's magic-number conversion gives the
    value exactly, and as f32 its low 13 mantissa bits are 0 (TF32 holds
    it, so the weight operand needs no split)."""
    v = np.arange(-128, 128, dtype=np.int32)
    u = (v & 0xFF) ^ 0x80                      # byte ^ 0x80, as unsigned
    f = (np.uint32(0x4B000000) | u.astype(np.uint32)).view(np.float32) \
        - np.float32(8388736.0)
    assert np.array_equal(f, v.astype(np.float32))
    assert (f.view(np.uint32) & 0x1FFF == 0).all()
    t = torch.from_numpy(f.copy())
    assert torch.equal(_tf32_trunc(t), t) and torch.equal(_tf32_round(t), t)


@pytest.mark.parametrize("name,N,K", [(p[0], p[1], p[2])
                                      for p in PRODUCTS_8B + PRODUCTS_QA])
def test_f32_plan_depends_on_n_and_k_only(name, N, K):
    """The f32 geometry at every row count 1..128: warps, splits, k blocks
    a split and channel blocks equal the plan's (so a row's sums are the
    same bits in a decode step and a window); the splits cover K's 64-wide
    blocks with none empty; the staged chunk is whole 64-wide blocks and
    fits 64 KB of shared memory; the blocks fit one wave of two an SM
    unless one split already overfills it, and 4096 x 4096 fills the card;
    the bf16 plan there is its own (4 warps, 4 splits)."""
    plan = None
    kblocks = -(-K // 64)
    for m in range(1, 129):
        g = k6_geometry(m, N, K, torch.float32, SMS)
        fixed = (g["warps"], g["splits"], g["per"], g["blocks"])
        plan = plan or fixed
        assert fixed == plan
        assert g["nt"] == -(-m // 8) and g["kc"] % 64 == 0
        assert g["smem_bytes"] <= 64 * 1024
    warps, splits, per, blocks = plan
    assert (warps, splits) == k6_plan(N, K, SMS, torch.float32)
    assert (splits - 1) * per < kblocks <= splits * per
    assert blocks * 16 * warps >= N
    assert blocks * splits <= 2 * SMS or splits == 1
    if (N, K) == (4096, 4096):
        assert blocks * splits >= SMS
        assert k6_plan(N, K, SMS) == (4, 4)
