// Kernel K6: weight-only int8 product for decode-shaped activations, for
// Hopper (sm_90a).
//
// Replaces the int8 branch of sdag_tpu/models/llama.py _mm (and the tied
// unembed of _unembed), where XLA fuses the int8 -> x.dtype convert into
// the matrix unit's operand read so that device memory streams int8 bytes.
// No Pallas site: on the TPU this is an XLA fusion.  Computes
//
//   y[m, o] = T( T(sum_k x[m, k] * w[o, k]) * T(s[o]) )
//
// for x [M, K] of type T (bfloat16 or float32), w [N, K] int8 (one output
// channel's weights contiguous), s [N] f32 scales, y [M, N] of type T: the
// sum in f32, rounded to T, times the scale cast to T, rounded again --
// the JAX formula's two roundings, scale cast included.
//
// What bounds it: at M <= 128 rows (a decode step's batch, or a
// speculative verification window of batch x (D + 1) tokens) the product
// does at most 2 M operations per weight byte, below the ~295 at which the
// tensor cores, not device memory, become the limit: it is bound by the
// weight bytes, N K of them, read once.  The f32 body's two TF32 products
// do 4 M operations a weight byte against ~148 at the TF32 rate: bytes
// bind up to M ~ 37, the tensor cores just above (2.4 against 2.3 ms over
// an 8B window round at M = 40).
//
// bfloat16 body (the 8B model): mma.sync.m16n8k16 on the tensor cores,
// f32 accumulators, warp-specialised.  A block is 1-8 consumer warps and
// one producer warp.  A consumer warp owns 16 output channels (the A
// operand) and every activation row, in tiles of 8 (the B operand; NT
// tiles, a template argument, so the accumulators stay in registers: 4 NT
// floats a thread).  One thread of the producer warp keeps a ring of 2-4
// stages full; a stage is a 128-column chunk of the block's k range as
// three TMA boxes (the block's weight rows x 128 bytes, then the
// activation rows x 64 columns twice; 128-byte swizzle; rows past N or M
// and columns past K arrive as zeros) completing on the stage's full
// mbarrier.  Consumers wait on it, convert, multiply and arrive on the
// stage's empty mbarrier: no block barrier in the k loop, so loads stay
// in flight while warps convert and multiply.  (One cp.async.bulk a row
// a chunk, 168 small copies a stage, ran far slower: bound by the rate at
// which the copy unit takes requests.)  The contraction index is permuted
// so that both operands load 16 bytes a thread: in k step j of a 64-wide
// block, the logical columns {2t, 2t + 1, 2t + 8, 2t + 9} of thread group
// t are the actual columns 16 t + 4 j + {0, 1, 2, 3}, for A and B alike;
// a warp's A rows are permuted (row_of) so that every 16-byte read phase
// of the swizzled tiles hits all 32 banks.  int8 -> bf16 is exact (a byte
// permute and a magic-number float subtract, then a packed round).  Small
// N splits K across blocks (blockIdx.y) to fill one wave of the card; the
// splits of a channel tile are one thread block cluster, and their f32
// partial sums are added in split order through distributed shared
// memory, then rounded and scaled, in the same launch (no partial sums
// in device memory, no second kernel).  Each fragment keeps one
// accumulator summed along k in order, and the plan (warps, splits)
// depends on N and K alone, so a row's sums are the same bits at any M:
// a decode step and a verification window row agree.
//
// float32 body (an HF checkpoint's tree is float32, so its int8 tree runs
// it at 8B width; also the trained qa_ckpt decoder, d=192; an FMA body
// before, which re-read the weights for every 8 rows): split TF32 on
// mma.sync.m16n8k8: weights loaded to registers a chunk ahead of the
// activations, staged by cp.async (the bf16 body's earlier skeleton).
// Every int8 value is exact
// in TF32 (10 mantissa bits), so only the activation is split: x = hi +
// lo, hi = x rounded to TF32 by the mask below, lo = x - hi (exact in
// f32; the tensor core keeps its top 19 bits), and y = w.lo + w.hi, two
// products a fragment, both exact, the residual ~2^-21 |x| a term.  A warp
// owns 16 channels (A) and every activation row in n8 tiles (B, NT of
// them), so a block reads each weight byte once for all M rows.  Within
// a 64-wide k block, k step j (0..7) of thread group t takes the actual
// columns 16 t + 2 j + {0, 1} as its logical columns {t, t + 4}: one
// 16-byte weight load a row, four 16-byte activation loads a row tile.
// Activation chunks of f32_kc columns (256, or 128 above 8 row tiles, so
// shared memory stays at 64 KB) go to shared memory by cp.async, 16-byte
// chunk c of row r at c ^ (2 (c / 8 % 2) + r % 2): the eight lanes of one
// 16-byte read phase (two rows, four thread groups) then hit all 32
// banks.  The tensor core does not round to nearest when it accumulates:
// one accumulator over K = 14336 drifted past the 1e-5 row-relative
// limit on the H100.  So each 64-wide k block sums into a fresh fragment,
// which is then added to the running sum in f32, rounding to nearest.
// The k order (64-wide blocks, splits from the plan) depends on neither M
// nor f32_kc, so a row's sums are the same bits at any M.  K splits as in
// the bf16 body, added in split order by a second kernel
// (int8_matmul_f32_reduce), with a plan of its own: at most one wave of
// two blocks an SM (the body's occupancy at 40 rows, 127 registers a
// thread), as a second, partial wave cost more time than the extra split
// saved.  y = acc * s, the f32 formula's one rounding.
// The weights convert by one byte permute and one subtract each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_ROWS = 128;        // 16 activation-row tiles of 8
constexpr int MAX_CLUSTER = 8;       // the portable thread block cluster

// the bf16 body's ring (ops/int8_matmul.py k6_geometry mirrors this; the
// entry point checks the two agree): chunks of KB columns; a stage holds
// three TMA boxes, 128-byte swizzled: the block's C weight rows x KB bytes,
// then the activation rows x 64 columns twice; as many stages (2 to 4) as
// leave two blocks an SM; the stages' full and empty mbarriers after them
constexpr int KB = 128;
constexpr int BF16_SMEM_2 = 114688;  // shared bytes a block, two an SM
constexpr int BF16_THREADS = (WARPS + 1) * 32;   // + the producer warp

__host__ __device__ constexpr int bf16_stage_bytes(int nt, int C) {
  return C * KB + 2 * nt * 8 * 128;
}
__host__ __device__ constexpr int bf16_stages(int nt, int C) {
  return (BF16_SMEM_2 - 64) / bf16_stage_bytes(nt, C) >= 4   ? 4
         : (BF16_SMEM_2 - 64) / bf16_stage_bytes(nt, C) <= 2 ? 2
                                                             : 3;
}
__host__ __device__ constexpr int bf16_smem_bytes(int nt, int C) {
  return bf16_stages(nt, C) * bf16_stage_bytes(nt, C) + 64;
}
// A fragment row g of a warp reads weight row 16 warp + row_of(g) (and + 8):
// rows 0 and 4, 1 and 5, .. share a shared-memory read phase, and the
// 128-byte swizzle puts their 16-byte chunks in opposite halves of the
// banks
__device__ __forceinline__ int row_of(int g) {
  return ((g & 1) << 2) | (g >> 1);
}

// the f32 body's activation columns staged a chunk (ops/int8_matmul.py
// k6_geometry mirrors this; the entry point checks the two agree)
__host__ __device__ constexpr int f32_kc(int nt) {
  return nt <= 8 ? 256 : 128;
}

// Four int8 (the bytes of q) as float: byte b + 128 is an unsigned byte u,
// and 2^23 + u is exact in the mantissa of 0x4B0000uu, put there by one
// byte permute; then the magic-number subtract.
__device__ __forceinline__ void i8x4_to_f32_prmt(uint32_t q, float (&f)[4]) {
  const uint32_t u = q ^ 0x80808080u;
  const float magic = 8388736.0f;    // 2^23 + 128
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - magic;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - magic;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - magic;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - magic;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits), lo the exact
// remainder (as csrc/encoder_attention.cu's K3-f32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the f32 body's staged position of 16-byte chunk c of activation row r
__device__ __forceinline__ int f32_chunk(int r, int c) {
  return c ^ ((((c >> 3) & 1) << 1) | (r & 1));
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The product's two roundings in bf16: T(T(acc) * T(s)).
__device__ __forceinline__ __nv_bfloat16 scale_bf16(float acc, float s) {
  const float a = __bfloat162float(__float2bfloat16_rn(acc));
  const float b = __bfloat162float(__float2bfloat16_rn(s));
  return __float2bfloat16_rn(a * b);
}

// Several splits: the splits of one channel tile are one cluster, and
// blockIdx.y, the split, is the block's rank in it.  Each block's consumer
// warps leave its f32 partial tile [M][C + 4] (C channels; the pad makes
// the stores free of bank conflicts) in its own shared memory, where the
// ring was; after
// a cluster barrier, rank r sums its share of the tile's outputs over
// ranks 0, 1, .., splits - 1 in that order (the k order of the splits),
// rounds, scales and stores them; a last barrier keeps every block, and so
// its shared memory, alive until all have read it.
template <int NT>
__device__ __forceinline__ void bf16_cluster_epilogue(
    const float (&c)[NT][4], const float* __restrict__ s,
    __nv_bfloat16* __restrict__ y, int M, int N, int C, bool consumer) {
  extern __shared__ __align__(1024) uint8_t ring[];
  float* pt = reinterpret_cast<float*>(ring);
  const int CP = C + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if (consumer) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mm = n * 8 + 2 * t + (i & 1);
        if (mm < M)
          pt[mm * CP + 16 * warp + row_of(g) + (i >= 2 ? 8 : 0)] =
              c[n][i];
      }
    }
  }
  cluster_sync();
  const int quads = C / 4, units = M * quads;
  const int share = (units + gridDim.y - 1) / gridDim.y;
  const int u1 = min(units, ((int)blockIdx.y + 1) * share);
  const int o_blk = blockIdx.x * C;
  const uint32_t base = smem_u32(pt);
  for (int u = blockIdx.y * share + threadIdx.x; u < u1; u += blockDim.x) {
    const int mm = u / quads, p = 4 * (u % quads);
    const uint32_t addr = base + 4u * (mm * CP + p);
    float4 acc = ld_cluster_f4(addr, 0);
    for (int r = 1; r < (int)gridDim.y; ++r) {
      const float4 v = ld_cluster_f4(addr, r);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    const float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = o_blk + p + e;
      if (o < N) y[(size_t)mm * N + o] = scale_bf16(a[e], s[o]);
    }
  }
  cluster_sync();
}

template <int NT>
__global__ void __launch_bounds__(BF16_THREADS, 2)
int8_matmul_bf16_kernel(const __grid_constant__ CUtensorMap w_map,
                        const __grid_constant__ CUtensorMap x_map,
                        const float* __restrict__ s,
                        __nv_bfloat16* __restrict__ y, int M, int K,
                        int N, int per, int stages) {
  extern __shared__ __align__(1024) uint8_t ring[];
  constexpr int ROWS = NT * 8;
  const int warps = blockDim.x / 32 - 1;          // consumer warps
  const int C = 16 * warps;                       // channels a block
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o_blk = blockIdx.x * C;
  const int sbytes = bf16_stage_bytes(NT, C);
  const uint32_t full0 = smem_u32(ring) + stages * sbytes;
  const uint32_t empty0 = full0 + 32;

  // this block's k range: `per` 64-wide blocks from split blockIdx.y, in
  // chunks of KB columns (the last may be 64 wide)
  const int kblocks = (K + 63) / 64;
  const int kbeg = blockIdx.y * per * 64;
  const int kstop = min(kblocks, (int)(blockIdx.y + 1) * per) * 64;
  const int chunks = (kstop - kbeg + KB - 1) / KB;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, warps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  float c[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] = 0.f;

  if (warp == warps) {
    // producer: one thread keeps up to `stages` chunks in flight, three
    // TMA boxes a chunk (rows past N or M and columns past K arrive as
    // zeros; a chunk cut at the split's end loads 64 columns it skips)
    if (lane == 0) {
      for (int i = 0; i < chunks; ++i) {
        const int st = i % stages, kc = kbeg + i * KB;
        const uint32_t stage = smem_u32(ring) + st * sbytes;
        const uint32_t bar = full0 + 8 * st;
        mbar_wait(empty0 + 8 * st, ((i / stages) & 1) ^ 1);
        mbar_arrive_expect_tx(bar, sbytes);
        tma_load_2d(stage, &w_map, bar, kc, o_blk);
        tma_load_2d(stage + C * KB, &x_map, bar, kc, 0);
        tma_load_2d(stage + C * KB + ROWS * 128, &x_map, bar, kc + 64, 0);
      }
    }
    __syncwarp();
  } else {
    // consumers: a warp owns 16 channels (A fragment rows g and g + 8:
    // weight rows pa and pa + 8) and every activation row (NT tiles of 8,
    // the B fragment); chunk c of a 128-byte row r lies at c ^ (r % 8)
    const int g = lane >> 2, t = lane & 3;
    const int pa = 16 * warp + row_of(g);
    for (int i = 0; i < chunks; ++i) {
      const int st = i % stages;
      const int cols = min(KB, kstop - kbeg - i * KB);
      const uint8_t* stage = ring + st * sbytes;
      mbar_wait(full0 + 8 * st, (i / stages) & 1);
#pragma unroll
      for (int j = 0; j < KB / 64; ++j) {
        if (64 * j >= cols) break;
        const int ca = ((4 * j + t) ^ (pa & 7)) * 16;
        const uint4 qa = *reinterpret_cast<const uint4*>(stage + pa * KB + ca);
        const uint4 qb =
            *reinterpret_cast<const uint4*>(stage + (pa + 8) * KB + ca);
        // A fragments of the k block's four k steps
        uint32_t a[4][4];
        const uint32_t wa_w[4] = {qa.x, qa.y, qa.z, qa.w};
        const uint32_t wb_w[4] = {qb.x, qb.y, qb.z, qb.w};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          float fa[4], fb[4];
          i8x4_to_f32_prmt(wa_w[ks], fa);
          i8x4_to_f32_prmt(wb_w[ks], fb);
          a[ks][0] = pack_bf16x2(fa[0], fa[1]);
          a[ks][1] = pack_bf16x2(fb[0], fb[1]);
          a[ks][2] = pack_bf16x2(fa[2], fa[3]);
          a[ks][3] = pack_bf16x2(fb[2], fb[3]);
        }
        const uint8_t* xs = stage + C * KB + j * ROWS * 128;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint8_t* xr = xs + (n * 8 + g) * 128;
          const uint4 x0 =
              *reinterpret_cast<const uint4*>(xr + ((2 * t) ^ g) * 16);
          const uint4 x1 =
              *reinterpret_cast<const uint4*>(xr + ((2 * t + 1) ^ g) * 16);
          mma_bf16(c[n], a[0], x0.x, x0.y);
          mma_bf16(c[n], a[1], x0.z, x0.w);
          mma_bf16(c[n], a[2], x1.x, x1.y);
          mma_bf16(c[n], a[3], x1.z, x1.w);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * st);
    }
  }

  if (gridDim.y == 1) {
    // one split: round, scale, store
    if (warp == warps) return;
    const int g = lane >> 2, t = lane & 3;
    const int row_a = o_blk + 16 * warp + row_of(g), row_b = row_a + 8;
    const bool ok_a = row_a < N, ok_b = row_b < N;
    const float sa = ok_a ? s[row_a] : 0.f, sb = ok_b ? s[row_b] : 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mm = n * 8 + 2 * t + (i & 1);
        const bool hi = i >= 2;
        if (mm < M && (hi ? ok_b : ok_a))
          y[(size_t)mm * N + (hi ? row_b : row_a)] =
              scale_bf16(c[n][i], hi ? sb : sa);
      }
    }
    return;
  }
  // several splits: every chunk has been read, so the ring is free for
  // the partial tile
  __syncthreads();
  bf16_cluster_epilogue<NT>(c, s, y, M, N, C, warp < warps);
}

template <int NT>
__global__ void __launch_bounds__(THREADS)
int8_matmul_f32_kernel(const float* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ s, float* __restrict__ y,
                       float* __restrict__ part, int M, int K, int N,
                       int per) {
  constexpr int KCF = f32_kc(NT), ROWS = NT * 8;
  extern __shared__ uint4 smem[];
  float* xs = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int o0 = (blockIdx.x * (blockDim.x >> 5) + warp) * 16;
  const int row_a = o0 + g, row_b = o0 + g + 8;
  const bool ok_a = row_a < N, ok_b = row_b < N;
  const int8_t* wa = w + (size_t)(ok_a ? row_a : 0) * K;
  const int8_t* wb = w + (size_t)(ok_b ? row_b : 0) * K;

  const int kblocks = (K + 63) / 64;
  const int kb0 = blockIdx.y * per;
  const int kb1 = min(kblocks, kb0 + per);

  float c[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] = 0.f;

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int kc = kb0 * 64; kc < kb1 * 64; kc += KCF) {
    const int kend = min(min(kc + KCF, kb1 * 64), K);
    // the chunk's weight loads go out first, then the activation rows to
    // shared memory by cp.async, all in flight together
    uint4 qa[KCF / 64], qb[KCF / 64];
#pragma unroll
    for (int j = 0; j < KCF / 64; ++j) {
      const int k = kc + 64 * j + 16 * t;
      qa[j] = ok_a && k < kend ? ldg16(wa + k) : zero;
      qb[j] = ok_b && k < kend ? ldg16(wb + k) : zero;
    }
    for (int i = threadIdx.x; i < ROWS * (KCF / 4); i += blockDim.x) {
      const int r = i / (KCF / 4), c4 = i % (KCF / 4);
      const int k = kc + 4 * c4;
      const bool ok = r < M && k < kend;
      cp_async16(smem_u32(xs + r * KCF + 4 * f32_chunk(r, c4)),
                 ok ? x + (size_t)r * K + k : x, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KCF / 64; ++j) {
      if (kc + 64 * j >= kend) break;
      // the 64-wide k block sums into a fresh fragment, then into c
      float d[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[n][i] = 0.f;
      const uint32_t wa_w[4] = {qa[j].x, qa[j].y, qa[j].z, qa[j].w};
      const uint32_t wb_w[4] = {qb[j].x, qb[j].y, qb[j].z, qb[j].w};
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        // k steps 2 st and 2 st + 1: actual columns 16 t + 4 st + {0, 1}
        // and + {2, 3}
        float fa[4], fb[4];
        i8x4_to_f32_prmt(wa_w[st], fa);
        i8x4_to_f32_prmt(wb_w[st], fb);
        const uint32_t a0[4] = {
            __float_as_uint(fa[0]), __float_as_uint(fb[0]),
            __float_as_uint(fa[1]), __float_as_uint(fb[1])};
        const uint32_t a1[4] = {
            __float_as_uint(fa[2]), __float_as_uint(fb[2]),
            __float_as_uint(fa[3]), __float_as_uint(fb[3])};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int r = n * 8 + g;
          const float4 v = *reinterpret_cast<const float4*>(
              xs + r * KCF + 4 * f32_chunk(r, 16 * j + 4 * t + st));
          uint32_t h0, l0, h1, l1, h2, l2, h3, l3;
          split_tf32(v.x, h0, l0);
          split_tf32(v.y, h1, l1);
          split_tf32(v.z, h2, l2);
          split_tf32(v.w, h3, l3);
          mma_tf32(d[n], a0, l0, l1);
          mma_tf32(d[n], a0, h0, h1);
          mma_tf32(d[n], a1, l2, l3);
          mma_tf32(d[n], a1, h2, h3);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[n][i] += d[n][i];
    }
    __syncthreads();
  }

  // one split: scale and store; several: f32 partial sums, which
  // int8_matmul_f32_reduce adds in split order
  const float sa = ok_a ? s[row_a] : 0.f, sb = ok_b ? s[row_b] : 0.f;
  float* pr = part + (size_t)blockIdx.y * M * N;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int m = n * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mm = m + (i & 1);
      const bool hi = i >= 2;
      const int o = hi ? row_b : row_a;
      if (mm >= M || !(hi ? ok_b : ok_a)) continue;
      if (gridDim.y == 1)
        y[(size_t)mm * N + o] = c[n][i] * (hi ? sb : sa);
      else
        pr[(size_t)mm * N + o] = c[n][i];
    }
  }
}

__global__ void int8_matmul_f32_reduce(const float* __restrict__ part,
                                       const float* __restrict__ s,
                                       float* __restrict__ y, int M, int N,
                                       int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  float acc = part[i];
  for (int sp = 1; sp < splits; ++sp) acc += part[(size_t)sp * M * N + i];
  y[i] = acc * s[i % N];
}

template <int NT>
int launch_f32(const void* x, const void* w, const void* s, void* y,
               void* part, int M, int K, int N, int warps, int splits,
               cudaStream_t stream) {
  const int smem = NT * 8 * f32_kc(NT) * 4;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        int8_matmul_f32_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int per = ((K + 63) / 64 + splits - 1) / splits;
  dim3 grid((N + 16 * warps - 1) / (16 * warps), splits);
  int8_matmul_f32_kernel<NT><<<grid, warps * 32, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<float*>(y),
      static_cast<float*>(part), M, K, N, per);
  if (splits > 1) {
    const int total = M * N;
    int8_matmul_f32_reduce<<<(total + 255) / 256, 256, 0, stream>>>(
        static_cast<const float*>(part), static_cast<const float*>(s),
        static_cast<float*>(y), M, N, splits);
  }
  return (int)cudaGetLastError();
}

// The bf16 body's launch: grid (blocks, splits), the splits of a channel
// tile one cluster (1, splits, 1); the body's dynamic shared-memory limit
// raised to the ring's bytes where it is lower.
template <int NT>
cudaError_t bf16_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& cluster,
                        int N, int warps, int splits) {
  static int allowed = 0;
  const int C = 16 * warps, smem = bf16_smem_bytes(NT, C);
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        int8_matmul_bf16_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = splits;
  cluster.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((N + C - 1) / C, splits);
  cfg.blockDim = dim3((warps + 1) * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaSuccess;
}

// TMA maps: w [N, K] int8 in boxes of C rows x KB bytes, x [M, K] bf16 in
// boxes of 8 NT rows x 64 columns, both 128-byte swizzled
template <int NT>
int launch_bf16(const void* x, const void* w, const void* s, void* y, int M,
                int K, int N, int warps, int splits, cudaStream_t stream) {
  const int C = 16 * warps;
  CUtensorMap w_map, x_map;
  const uint64_t w_dims[2] = {(uint64_t)K, (uint64_t)N};
  const uint64_t x_dims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t w_stride[1] = {(uint64_t)K}, x_stride[1] = {2ull * K};
  const uint32_t w_box[2] = {KB, (uint32_t)C}, x_box[2] = {64, NT * 8};
  if (!make_tensor_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, w_dims,
                       w_stride, w_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_tensor_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x,
                       x_dims, x_stride, x_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  cudaError_t e = bf16_config<NT>(cfg, cluster, N, warps, splits);
  if (e != cudaSuccess) return (int)e;
  cfg.stream = stream;
  const int per = ((K + 63) / 64 + splits - 1) / splits;
  void (*kernel)(const CUtensorMap, const CUtensorMap, const float*,
                 __nv_bfloat16*, int, int, int, int, int) =
      int8_matmul_bf16_kernel<NT>;
  e = cudaLaunchKernelEx(&cfg, kernel, w_map, x_map,
                         static_cast<const float*>(s),
                         static_cast<__nv_bfloat16*>(y), M, K, N, per,
                         bf16_stages(NT, C));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// clusters of the bf16 body's launch at NT row tiles the card holds at once
template <int NT>
int bf16_clusters(int warps, int splits) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  if (bf16_config<NT>(cfg, cluster, 16 * warps, warps, splits) != cudaSuccess)
    return -1;
  cfg.gridDim = dim3(1, splits);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(
          &n, (const void*)int8_matmul_bf16_kernel<NT>, &cfg) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  if (code == -1) return "unsupported shape, dtype or row-tile count";
  if (code == -2) return "cuTensorMapEncodeTiled refused a TMA tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

// x [M, K] (dtype 0 = float32, 1 = bfloat16), w [N, K] int8, s [N] f32,
// y [M, N] of x's type; all contiguous, 16-byte aligned, K % 16 == 0,
// 1 <= M <= 128.  warps: 16-channel tiles a block (f32: 4 or 8; bf16: 1,
// 2, 4 or 8) and splits of K across blocks (ops/int8_matmul.py k6_plan,
// from N and K alone, so a row's sums do not depend on M).  f32 with
// splits > 1: part is f32 scratch [splits, M, N]; bf16: splits <= 8 (one
// cluster), part unused.  kc and stages as ops/int8_matmul.py
// k6_geometry gives them for M: the columns staged a chunk (f32: f32_kc;
// bf16: KB) and the ring's stages (f32: 1; bf16: bf16_stages).  Returns
// 0, a CUDA error code or -1.
int int8_matmul(const void* x, const void* w, const void* s, void* y,
                void* part, int M, int K, int N, int dtype, int warps,
                int splits, int kc, int stages, void* stream) {
  if (M < 1 || M > MAX_ROWS || K < 16 || K % 16 || N < 1 || splits < 1)
    return -1;
  if (dtype == 0 &&
      ((warps != 4 && warps != 8) || (splits > 1 && part == nullptr)))
    return -1;
  if (dtype == 1 && ((warps != 1 && warps != 2 && warps != 4 && warps != 8) ||
                     splits > MAX_CLUSTER))
    return -1;
  if (dtype != 0 && dtype != 1) return -1;
  const int nt = (M + 7) / 8;
  if (kc != (dtype == 0 ? f32_kc(nt) : KB) ||
      stages != (dtype == 0 ? 1 : bf16_stages(nt, 16 * warps)))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nt) {
#define K6_CASE(nt)                                                         \
  case nt:                                                                  \
    return dtype == 0                                                       \
               ? launch_f32<nt>(x, w, s, y, part, M, K, N, warps, splits,   \
                                st)                                         \
               : launch_bf16<nt>(x, w, s, y, M, K, N, warps, splits, st);
    K6_CASE(1) K6_CASE(2) K6_CASE(3) K6_CASE(4) K6_CASE(5) K6_CASE(6)
    K6_CASE(7) K6_CASE(8) K6_CASE(9) K6_CASE(10) K6_CASE(11) K6_CASE(12)
    K6_CASE(13) K6_CASE(14) K6_CASE(15) K6_CASE(16)
#undef K6_CASE
  }
  return -1;
}

// How many clusters of K6's bf16 launch (1 <= nt <= 16 row tiles, warps,
// splits blocks a cluster) the card holds at once
// (cudaOccupancyMaxActiveClusters; a split of 1 counts blocks); -1 if it
// cannot tell.
int int8_matmul_bf16_clusters(int nt, int warps, int splits) {
  switch (nt) {
#define K6_CASE(nt) \
  case nt:          \
    return bf16_clusters<nt>(warps, splits);
    K6_CASE(1) K6_CASE(2) K6_CASE(3) K6_CASE(4) K6_CASE(5) K6_CASE(6)
    K6_CASE(7) K6_CASE(8) K6_CASE(9) K6_CASE(10) K6_CASE(11) K6_CASE(12)
    K6_CASE(13) K6_CASE(14) K6_CASE(15) K6_CASE(16)
#undef K6_CASE
  }
  return -1;
}

}  // extern "C"
