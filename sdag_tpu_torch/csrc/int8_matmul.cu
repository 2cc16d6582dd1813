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
// weight bytes, N K of them, read once.
//
// bfloat16 body (the 8B model): mma.sync.m16n8k16 on the tensor cores,
// f32 accumulators.  A warp owns 16 output channels (the A operand) and
// every activation row, in tiles of 8 (the B operand; NT tiles, a template
// argument, so the accumulators stay in registers: 4 NT floats a thread).
// A 64-wide k block arrives as one 16-byte load a thread per weight row
// (lanes with the same group read 64 contiguous bytes of a row).  The
// contraction index is permuted so that both operands load contiguously:
// in k step j of a block, logical columns {2t, 2t + 1, 2t + 8, 2t + 9} of
// thread group t are the actual columns 16 t + 4 j + {0, 1, 2, 3}, for A
// and B alike.  int8 -> bf16 is exact (a magic-number float subtract, then
// a packed round).  A block of 4 or 8 warps walks its k range in chunks of
// 256: each thread's weight loads for the chunk go out, the chunk's
// activation rows go to shared memory by cp.async (no registers, all in
// flight at once; rows padded by 16 bytes, so the fragment reads are free
// of bank conflicts), and every warp reads them there -- any K fits, and
// the activations cross L2 once per block, not once per warp (double-
// buffering the chunks timed slower: 198 registers a thread).  Small N
// splits K across blocks (blockIdx.y) to fill the card; the splits' f32
// partial sums are added in split order by a second kernel, which also
// rounds and scales.  The plan (warps, splits) depends
// on N and K alone, so a row's sums are the same bits at any M: a decode
// step and a verification window row agree.
//
// float32 body (the trained qa_ckpt decoder, d=192): f32 FMA.  A warp
// owns 4 channels x 8 activation rows (blockIdx.y walks row tiles); lane
// l takes 16-byte weight chunks at k = 16 (l + 32 i), the 32 partial sums
// meet by warp shuffles, lane i writes sum i.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_ROWS = 128;        // 16 activation-row tiles of 8
constexpr int F32_ROWS_PER_WARP = 4;
constexpr int KC = 256;              // activation columns staged a chunk
constexpr int XS = KC + 8;           // staged row stride: 16 bytes of pad
constexpr int F32_M_TILE = 8;

// Four int8 (the bytes of q) as float: byte b + 128 is an unsigned byte u,
// and 2^23 + u is exact in the mantissa of 0x4B0000uu.
__device__ __forceinline__ void i8x4_to_f32(uint32_t q, float (&f)[4]) {
  const uint32_t u = q ^ 0x80808080u;
  const float magic = 8388736.0f;    // 2^23 + 128
  f[0] = __uint_as_float(0x4B000000u | __byte_perm(u, 0, 0x4440)) - magic;
  f[1] = __uint_as_float(0x4B000000u | __byte_perm(u, 0, 0x4441)) - magic;
  f[2] = __uint_as_float(0x4B000000u | __byte_perm(u, 0, 0x4442)) - magic;
  f[3] = __uint_as_float(0x4B000000u | __byte_perm(u, 0, 0x4443)) - magic;
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

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The product's two roundings in bf16: T(T(acc) * T(s)).
__device__ __forceinline__ __nv_bfloat16 scale_bf16(float acc, float s) {
  const float a = __bfloat162float(__float2bfloat16_rn(acc));
  const float b = __bfloat162float(__float2bfloat16_rn(s));
  return __float2bfloat16_rn(a * b);
}

template <int NT>
__global__ void __launch_bounds__(THREADS)
int8_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ s,
                        __nv_bfloat16* __restrict__ y,
                        float* __restrict__ part, int M, int K, int N,
                        int per) {
  extern __shared__ uint4 smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int o0 = (blockIdx.x * (blockDim.x >> 5) + warp) * 16;
  const int row_a = o0 + g, row_b = o0 + g + 8;
  const bool ok_a = row_a < N, ok_b = row_b < N;
  const int8_t* wa = w + (size_t)(ok_a ? row_a : 0) * K;
  const int8_t* wb = w + (size_t)(ok_b ? row_b : 0) * K;
  constexpr int ROWS = NT * 8;

  // this block's k range: `per` 64-wide blocks from split blockIdx.y
  const int kblocks = (K + 63) / 64;
  const int kb0 = blockIdx.y * per;
  const int kb1 = min(kblocks, kb0 + per);

  float c[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[n][i] = 0.f;

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int kc = kb0 * 64; kc < kb1 * 64; kc += KC) {
    const int kend = min(min(kc + KC, kb1 * 64), K);
    // the chunk's weight chunks go out first, then the activation rows'
    // chunk to shared memory by cp.async (rows >= M and columns past the
    // range zero-filled), all in flight together
    uint4 qa[KC / 64], qb[KC / 64];
#pragma unroll
    for (int j = 0; j < KC / 64; ++j) {
      const int k = kc + 64 * j + 16 * t;
      qa[j] = ok_a && k < kend ? ldg16(wa + k) : zero;
      qb[j] = ok_b && k < kend ? ldg16(wb + k) : zero;
    }
    for (int i = threadIdx.x; i < ROWS * (KC / 8); i += blockDim.x) {
      const int r = i / (KC / 8), c8 = i % (KC / 8);
      const int k = kc + 8 * c8;
      const bool ok = r < M && k < kend;
      cp_async16(smem_u32(xs + r * XS + 8 * c8),
                 ok ? x + (size_t)r * K + k : x, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KC / 64; ++j) {
      if (kc + 64 * j >= kend) break;
      // A fragments of the k block's four k steps
      uint32_t a[4][4];
      const uint32_t wa_w[4] = {qa[j].x, qa[j].y, qa[j].z, qa[j].w};
      const uint32_t wb_w[4] = {qb[j].x, qb[j].y, qb[j].z, qb[j].w};
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        float fa[4], fb[4];
        i8x4_to_f32(wa_w[st], fa);
        i8x4_to_f32(wb_w[st], fb);
        a[st][0] = pack_bf16x2(fa[0], fa[1]);
        a[st][1] = pack_bf16x2(fb[0], fb[1]);
        a[st][2] = pack_bf16x2(fa[2], fa[3]);
        a[st][3] = pack_bf16x2(fb[2], fb[3]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const __nv_bfloat16* xr = xs + (n * 8 + g) * XS + 64 * j + 16 * t;
        const uint4 x0 = *reinterpret_cast<const uint4*>(xr);
        const uint4 x1 = *reinterpret_cast<const uint4*>(xr + 8);
        mma_bf16(c[n], a[0], x0.x, x0.y);
        mma_bf16(c[n], a[1], x0.z, x0.w);
        mma_bf16(c[n], a[2], x1.x, x1.y);
        mma_bf16(c[n], a[3], x1.z, x1.w);
      }
    }
    __syncthreads();
  }

  // one split: round, scale, store; several: f32 partial sums, which
  // int8_matmul_bf16_reduce adds in split order
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
        y[(size_t)mm * N + o] = scale_bf16(c[n][i], hi ? sb : sa);
      else
        pr[(size_t)mm * N + o] = c[n][i];
    }
  }
}

__global__ void int8_matmul_bf16_reduce(const float* __restrict__ part,
                                        const float* __restrict__ s,
                                        __nv_bfloat16* __restrict__ y, int M,
                                        int N, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  float acc = part[i];
  for (int sp = 1; sp < splits; ++sp) acc += part[(size_t)sp * M * N + i];
  y[i] = scale_bf16(acc, s[i % N]);
}

__global__ void __launch_bounds__(THREADS)
int8_matmul_f32_kernel(const float* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ s, float* __restrict__ y,
                       int M, int K, int N) {
  constexpr int R = F32_ROWS_PER_WARP, MT = F32_M_TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o0 = (blockIdx.x * WARPS + warp) * R;
  const int m0 = blockIdx.y * MT;
  float acc[R][MT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < MT; ++i) acc[r][i] = 0.f;

  for (int k = lane * 16; k < K; k += 512) {
    float wf[R][16];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uint4 q = make_uint4(0, 0, 0, 0);
      if (o0 + r < N) q = ldg16(w + (size_t)(o0 + r) * K + k);
      const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float f[4];
        i8x4_to_f32(words[j], f);
#pragma unroll
        for (int e = 0; e < 4; ++e) wf[r][4 * j + e] = f[e];
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (m0 + i >= M) break;
      const float* xr = x + (size_t)(m0 + i) * K + k;
      float xv[16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(xr) + j);
        xv[4 * j] = v.x;
        xv[4 * j + 1] = v.y;
        xv[4 * j + 2] = v.z;
        xv[4 * j + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[r][i] = fmaf(xv[e], wf[r][e], acc[r][i]);
    }
  }
  // every lane gets all R * MT sums; lane r * MT + i keeps (r, i)
  float out = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float v = acc[r][i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == r * MT + i) out = v;
    }
  const int r = lane / MT, i = lane % MT;
  const int o = o0 + r, m = m0 + i;
  if (o < N && m < M) y[(size_t)m * N + o] = out * s[o];
}

template <int NT>
int launch_bf16(const void* x, const void* w, const void* s, void* y,
                void* part, int M, int K, int N, int warps, int splits,
                cudaStream_t stream) {
  const int smem = NT * 8 * XS * 2;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        int8_matmul_bf16_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int per = ((K + 63) / 64 + splits - 1) / splits;
  dim3 grid((N + 16 * warps - 1) / (16 * warps), splits);
  int8_matmul_bf16_kernel<NT><<<grid, warps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(part), M, K, N, per);
  if (splits > 1) {
    const int total = M * N;
    int8_matmul_bf16_reduce<<<(total + 255) / 256, 256, 0, stream>>>(
        static_cast<const float*>(part), static_cast<const float*>(s),
        static_cast<__nv_bfloat16*>(y), M, N, splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  if (code == -1) return "unsupported shape, dtype or row-tile count";
  return cudaGetErrorString((cudaError_t)code);
}

// x [M, K] (dtype 0 = float32, 1 = bfloat16), w [N, K] int8, s [N] f32,
// y [M, N] of x's type; all contiguous, 16-byte aligned, K % 16 == 0,
// 1 <= M <= 128.  bf16 only: warps (4 or 8) 16-channel tiles a block and
// splits of K across blocks (ops/int8_matmul.py k6_plan, from N and K
// alone, so a row's sums do not depend on M); with splits > 1, part is f32
// scratch [splits, M, N].  Returns 0, a CUDA error code or -1.
int int8_matmul(const void* x, const void* w, const void* s, void* y,
                void* part, int M, int K, int N, int dtype, int warps,
                int splits, void* stream) {
  if (M < 1 || M > MAX_ROWS || K < 16 || K % 16 || N < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dim3 grid((N + WARPS * F32_ROWS_PER_WARP - 1) / (WARPS * F32_ROWS_PER_WARP),
              (M + F32_M_TILE - 1) / F32_M_TILE);
    int8_matmul_f32_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(s), static_cast<float*>(y), M, K, N);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || (warps != 4 && warps != 8) || splits < 1 ||
      (splits > 1 && part == nullptr))
    return -1;
  switch ((M + 7) / 8) {
#define K6_CASE(nt) \
  case nt:          \
    return launch_bf16<nt>(x, w, s, y, part, M, K, N, warps, splits, st);
    K6_CASE(1) K6_CASE(2) K6_CASE(3) K6_CASE(4) K6_CASE(5) K6_CASE(6)
    K6_CASE(7) K6_CASE(8) K6_CASE(9) K6_CASE(10) K6_CASE(11) K6_CASE(12)
    K6_CASE(13) K6_CASE(14) K6_CASE(15) K6_CASE(16)
#undef K6_CASE
  }
  return -1;
}

}  // extern "C"
