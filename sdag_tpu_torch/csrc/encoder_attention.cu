// Kernel K3: bidirectional (encoder) attention straight from the packed
// QKV projection, for Hopper (sm_90a).
//
// Replaces sdag_tpu/ops/encoder_attention.py encoder_attention_fused_qkv
// (_kernel / _one_head).  Input qkv [B, L, 3d], columns [q heads | k heads
// | v heads]; head h's q, k, v are the column slices at h*Dh, d + h*Dh and
// 2d + h*Dh with row stride 3d, so nothing is split or transposed before
// the kernel.  Output [B, L, d], heads side by side, ready for the output
// projection.  What the TPU body does and this one keeps:
//   * the scale is multiplied into q in q's dtype before the dot (for
//     bf16: scale rounded to bf16, product rounded to bf16);
//   * key columns >= valid_len[b] score -1e30, not -inf: a row of a
//     sequence with valid_len == 0 attends all L columns uniformly (the
//     mean of V), never NaN; query rows past valid_len are computed like
//     any other;
//   * P is rounded to v's dtype for P.V, the row sum is taken over the f32
//     P, and the division comes after P.V.
//
// What bounds it: at the encoder's lengths (L <= 512) the packed input is
// read once and the output written once (bytes); the two L x L x Dh
// products per head are small beside that on the tensor cores.
// chip_smoke.py and kernel_times.py report the times beside the bound.
//
// bf16 inputs (the serving path), encoder_attention_wgmma_kernel:
// persistent blocks walk the (batch, head) pairs.  One producer thread
// loads by TMA through one 3D tensor map over the packed [B, L, 3d] row
// (rows >= L arrive as zeros; a box never reaches into batch b + 1): each
// consumer warpgroup's 64-row Q tile into a double buffer, and the pair's
// K and V tiles (only the key tiles below valid_len, all L when it is 0)
// into a ring of mbarrier-guarded stages.  A pair's q-tiles go to the
// consumer warpgroups in rounds; every warpgroup of a round reads the same
// K/V stage (when the pairs are too few to fill the card, a pair's rounds
// are split between blocks).  When the ring holds all of a pair's live key
// tiles the tiles stay resident: later rounds re-arm the stages without
// loading them again, so each K/V byte leaves device memory once per pair (at
// L <= 512, Dh = 64).  Otherwise (Dh = 128 at L = 512) the tiles stream
// through the ring once per round.  A pair of a single q-tile (L <= 64,
// the ranker's batches) runs on blocks of one warpgroup, two to an SM.
// The ring has as many stages as fit, so the next pair's tiles load while
// this pair runs.
// A consumer scales its Q tile in shared memory (bf16 multiply, then
// fence.proxy.async before wgmma reads it), computes S = Q.K^T with wgmma
// from shared memory (m64n64k16), masks only the tile that holds the
// valid_len or L edge, runs the online softmax as exp2(s log2 e -
// m log2 e) (one FFMA and one MUFU.EX2 an element; with valid_len 0 the
// masked columns score 0 instead of -1e30, the same uniform softmax), and
// feeds P, rounded to bf16, from registers into the wgmma for P.V (V
// MN-major).  At Dh <= 64 two score tiles are in flight: the scores of
// tile t + 1 run on the tensor cores under tile t's softmax, and P.V of
// tile t - 1 has finished by then (at Dh = 128 the registers hold one
// score tile, and tile t + 1's scores run under tile t's P.V, as in K1).
// Tiles go in pairs with the odd tail peeled, so no branch sits around a
// wgmma in the loop.  The output is staged in the Q tile and stored in
// 16-byte row segments.
//
// f32 inputs (a converted E5 checkpoint loads at f32),
// encoder_attention_f32_kernel: split-TF32 on mma.sync, one block of four
// warps per (64-row q-tile, head, batch), K/V streamed through a cp.async
// ring; see the comment above the kernel.  Its bound at e5-large-v2's
// width is the operations: 4 L^2 Dh flops a head against 67 TFLOP/s of f32
// FMA, or 495 / 3 TFLOP/s for split TF32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr float MASKED = -1e30f;
typedef __nv_bfloat16 bf16;

// key rows to visit for a sequence of valid_len vl
__device__ __forceinline__ int live_keys(int vl, int L) {
  return vl > 0 ? min(vl, L) : L;
}

// ------------------------------------------------------------------ f32
// encoder_attention_f32_kernel: split-TF32 ("3xTF32") on the tensor cores
// through mma.sync.m16n8k8.tf32.  An f32 operand x is split into
// hi = x rounded to TF32 and lo = x - hi (exact in f32; the tensor core
// reads lo's top 19 bits), and each product takes hi.lo + lo.hi + hi.hi
// with f32 accumulation: about f32 accuracy at a third of the TF32 rate.
// wgmma would need both TF32 operands K-major in shared memory, which V of
// P.V is not, and whole-warpgroup register budgets; mma.sync takes P from
// the registers the scores land in and V row-major.
//
// A block of four warps takes one 64-row q-tile of one (batch, head) pair;
// the q-tiles of a pair are neighbours in the grid, so they find the
// pair's K/V in L2.  Each warp keeps its 16 q rows, scaled, in registers
// (in shared memory at Dh = 128) and streams the live 64-key K/V tiles
// through a two-stage cp.async ring (tile t + 1 loads under tile t's
// math).  Permutations that change no sum
// give every fragment a 16-byte shared-memory load: the head dim of Q.K^T
// is walked in 16-wide chunks of which thread t4 holds elements
// 4 t4 .. 4 t4 + 3 (k-step 2c takes +0/+1, 2c + 1 takes +2/+3, the same in
// A and B); P.V takes the score fragment as its A fragment with the keys
// of a k-step in the order 0, 2, 4, 6, 1, 3, 5, 7; output group jj's
// column n is head dim n * DH/8 + jj, so a thread's B fragments are
// contiguous in a V row and its outputs contiguous in an output row.  The
// K and V rows are stored with an XOR swizzle of their 16-byte chunks that
// keeps those loads free of bank conflicts.  The softmax is online in the
// exp2 domain, as in the bf16 body.
constexpr int F32_WARPS = 4;
constexpr int F32_NT = F32_WARPS * 32;
constexpr int F32_STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct F32Geom {
  static constexpr int CHUNKS = DH / 4;  // 16-byte chunks of a K/V row
  static constexpr int TILE_FLOATS = BK * DH;
  static constexpr int STAGE_FLOATS = 2 * TILE_FLOATS;  // K tile, V tile
  // at Dh = 128 the q rows wait in shared memory (in registers beside the
  // 64 output registers they spill)
  static constexpr bool Q_SMEM = DH == 128;
  static constexpr int SMEM =
      (F32_STAGES * STAGE_FLOATS + (Q_SMEM ? BQ * DH : 0)) * 4;
  // blocks an SM holds, bounding the registers a thread may take so that
  // nothing spills (ops/encoder_attention.py K3F_MIN_BLOCKS mirrors this)
  static constexpr int MIN_BLOCKS = DH == 128 ? 1 : (DH == 64 ? 2 : 3);
};

// chunk swizzle of K row `key`: the two rows a quarter-warp reads at once
// land in opposite halves of the banks
__device__ __forceinline__ int k_swz(int key) { return (key & 1) << 2; }

// chunk swizzle of V row `key`: (key >> 1) & 3 is the reading thread's t4;
// its two bits go to the chunk-index bits (mod 8) that the thread's g does
// not use (bit log2(DH / 32))
template <int DH>
__device__ __forceinline__ int v_swz(int key) {
  const int t = (key >> 1) & 3;
  if constexpr (DH == 32) return t << 1;
  else if constexpr (DH == 64) return (t & 1) | ((t & 2) << 1);
  else return t;
}

// 2^x in one MUFU instruction (denormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits), lo the exact
// remainder
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in split TF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bh0, bh1);
}

template <int DH>
__global__ void __launch_bounds__(F32_NT, F32Geom<DH>::MIN_BLOCKS)
encoder_attention_f32_kernel(const float* __restrict__ qkv,
                             const int* __restrict__ valid_len,
                             float* __restrict__ out, int H, int L, int nqt,
                             float scale) {
  typedef F32Geom<DH> G;
  constexpr int QC = DH / 16;  // 16-wide head-dim chunks of Q.K^T
  constexpr int NJ = BK / 8;   // 8-key groups of a score tile
  constexpr int NO = DH / 8;   // 8-column groups of the output
  constexpr int VC = DH / 32;  // 16-byte V chunks a thread reads per row
  extern __shared__ __align__(16) float smem_f[];
  const uint32_t smem_s = smem_u32(smem_f);

  const int pair = blockIdx.x / nqt, qt = blockIdx.x % nqt;
  const int b = pair / H, h = pair % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int d = H * DH;
  const size_t ld = (size_t)3 * d;
  const float* base = qkv + (size_t)b * L * ld + (size_t)h * DH;
  const int vl = valid_len[b];
  const int nkt = (live_keys(vl, L) + BK - 1) / BK;

  // K and V rows of key tile t into ring stage st; rows >= L are zeros
  auto load_tile = [&](int t, int st) {
    const uint32_t ks = smem_s + st * G::STAGE_FLOATS * 4;
    const uint32_t vs = ks + G::TILE_FLOATS * 4;
    for (int e = tid; e < BK * G::CHUNKS; e += F32_NT) {
      const int r = e / G::CHUNKS, c = e % G::CHUNKS;
      const int key = t * BK + r;
      const bool in = key < L;
      const float* src = base + (size_t)(in ? key : 0) * ld + 4 * c;
      cp_async16(ks + (r * DH + 4 * (c ^ k_swz(r))) * 4, src + d,
                 in ? 16 : 0);
      cp_async16(vs + (r * DH + 4 * (c ^ v_swz<DH>(r))) * 4, src + 2 * d,
                 in ? 16 : 0);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  // this warp's q rows row0 and row0 + 8, times the scale in f32: in
  // registers, or at Dh = 128 in the warp's [16][DH] shared rows (chunks
  // swizzled as K's)
  const int row0 = qt * BQ + 16 * warp + g;
  float4 q[G::Q_SMEM ? 1 : QC][2];
  float* sq = smem_f + F32_STAGES * G::STAGE_FLOATS + warp * 16 * DH;
  auto sq_at = [&](int r, int c) {
    return reinterpret_cast<float4*>(sq + r * DH +
                                     4 * ((4 * c + t4) ^ k_swz(r)));
  };
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row0 + 8 * i < L;
    const float* qp = base + (size_t)(in ? row0 + 8 * i : 0) * ld + 4 * t4;
#pragma unroll
    for (int c = 0; c < QC; ++c) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in) v = *reinterpret_cast<const float4*>(qp + 16 * c);
      v = make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale);
      if constexpr (G::Q_SMEM) *sq_at(g + 8 * i, c) = v;
      else q[c][i] = v;
    }
  }
  if constexpr (G::Q_SMEM) __syncwarp();

  float o[NO][4];
#pragma unroll
  for (int jj = 0; jj < NO; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[jj][e] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};  // running row maxima
  float l_i[2] = {0.f, 0.f};              // per-thread partial row sums
  // a sequence with valid_len 0 attends all L columns uniformly: its masked
  // columns score 0 instead of -1e30 (the same softmax; the exp2 argument
  // stays exact)
  const float masked = vl > 0 ? MASKED : 0.f;

  for (int t = 0; t < nkt; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t is staged; every warp is done with tile t - 1
    if (t + 1 < nkt) load_tile(t + 1, (t + 1) & 1);
    cp_async_commit();
    const float* ks = smem_f + (t & 1) * G::STAGE_FLOATS;
    const float* vs = ks + G::TILE_FLOATS;

    // S = Q . K^T; s[j][e]: row g + 8 (e >> 1), key 8 j + 2 t4 + (e & 1)
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < QC; ++c) {
      uint32_t ah[2][4], al[2][4];
      float4 q0, q1;
      if constexpr (G::Q_SMEM) {
        q0 = *sq_at(g, c);
        q1 = *sq_at(g + 8, c);
      } else {
        q0 = q[c][0];
        q1 = q[c][1];
      }
      const float qa[2][4] = {{q0.x, q1.x, q0.y, q1.y},
                              {q0.z, q1.z, q0.w, q1.w}};
#pragma unroll
      for (int ksp = 0; ksp < 2; ++ksp)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(qa[ksp][e], ah[ksp][e], al[ksp][e]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int key = 8 * j + g;
        const float4 kv = *reinterpret_cast<const float4*>(
            ks + key * DH + 4 * ((4 * c + t4) ^ k_swz(key)));
        uint32_t bh[4], bl[4];
        split_tf32(kv.x, bh[0], bl[0]);
        split_tf32(kv.y, bh[1], bl[1]);
        split_tf32(kv.z, bh[2], bl[2]);
        split_tf32(kv.w, bh[3], bl[3]);
        mma_3xtf32(s[j], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
        mma_3xtf32(s[j], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
      }
    }

    // online softmax over the tile: -1e30 past valid_len, -inf past L
    const int k0 = t * BK;
    if (k0 + BK > vl || k0 + BK > L) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t4 + (e & 1);
          if (col >= vl) s[j][e] = masked;
          if (col >= L) s[j][e] = -INFINITY;
        }
    }
    float alpha[2], mb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mt = fmaxf(mt, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      // column k0 < L always, so m_new is finite from the first tile on
      const float m_new = fmaxf(m_i[i], mt);
      alpha[i] = ex2((m_i[i] - m_new) * LOG2E);  // 0 at the first tile
      m_i[i] = m_new;
      mb[i] = m_new * LOG2E;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], LOG2E, -mb[e >> 1]));
        ls[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_i[i] = l_i[i] * alpha[i] + ls[i];
#pragma unroll
    for (int jj = 0; jj < NO; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[jj][e] *= alpha[e >> 1];

    // O += P . V; k-step j covers keys 8 j .. 8 j + 7, A column t4 being
    // key 2 t4 and column t4 + 4 key 2 t4 + 1
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t ph[4], pl[4];
      split_tf32(s[j][0], ph[0], pl[0]);
      split_tf32(s[j][2], ph[1], pl[1]);
      split_tf32(s[j][1], ph[2], pl[2]);
      split_tf32(s[j][3], ph[3], pl[3]);
      const int key0 = 8 * j + 2 * t4;
#pragma unroll
      for (int m = 0; m < VC; ++m) {
        const float4 v0 = *reinterpret_cast<const float4*>(
            vs + key0 * DH + 4 * ((g * VC + m) ^ v_swz<DH>(key0)));
        const float4 v1 = *reinterpret_cast<const float4*>(
            vs + (key0 + 1) * DH + 4 * ((g * VC + m) ^ v_swz<DH>(key0 + 1)));
        const float b0[4] = {v0.x, v0.y, v0.z, v0.w};
        const float b1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(b0[e], bh0, bl0);
          split_tf32(b1[e], bh1, bl1);
          mma_3xtf32(o[4 * m + e], ph, pl, bh0, bh1, bl0, bl1);
        }
      }
    }
  }

  // o[jj][e]: row g + 8 (e >> 1), head-dim column (2 t4 + (e & 1)) NO + jj
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
    const int row = row0 + 8 * i;
    if (row >= L) continue;
    const float inv = 1.f / l_i[i];  // l >= 1: the row's max has p 1
    float* op = out + ((size_t)b * L + row) * d + (size_t)h * DH;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int m = 0; m < VC; ++m) {
        const int e = 2 * i + p;
        *reinterpret_cast<float4*>(op + (2 * t4 + p) * NO + 4 * m) =
            make_float4(o[4 * m][e] * inv, o[4 * m + 1][e] * inv,
                        o[4 * m + 2][e] * inv, o[4 * m + 3][e] * inv);
      }
  }
}

template <int DH>
int launch_f32(const void* qkv, const int* valid_len, void* out, int B, int H,
               int L, float scale, int stages, int grid,
               cudaStream_t stream) {
  typedef F32Geom<DH> G;
  const int nqt = (L + BQ - 1) / BQ;
  // the launch plan (ops/encoder_attention.py) must describe this body
  if (stages != F32_STAGES || (long long)grid != (long long)B * H * nqt)
    return -1;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        encoder_attention_f32_kernel<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  encoder_attention_f32_kernel<DH><<<grid, F32_NT, G::SMEM, stream>>>(
      static_cast<const float*>(qkv), valid_len, static_cast<float*>(out), H,
      L, nqt, scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- bf16
// encoder_attention_wgmma_kernel, warp-specialised on wgmma + TMA
// (hopper_async.cuh); see the header comment for the design.
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int Q_BUFS = 2;        // each warpgroup's Q tile, double-buffered
constexpr int ITEM_WORDS = 8;    // b, h, first q-tile, live key tiles, vl,
                                 // first ring stage, unused
constexpr int MAX_STAGES = 16;   // per-stage phases live in 32-bit masks
constexpr int SMEM_LIMIT = 232448;

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 in one register times a bf16 scale, rounded to bf16 (a bf16
// product is exact in f32, so this is the bf16 multiply)
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float scale) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 f = __bfloat1622float2(v);
  return pack_bf16(f.x * scale, f.y * scale);
}

// the 128 threads of one warpgroup (named barrier id) meet
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// A [64 rows][DH] bf16 tile in shared memory is DH / PW panels of
// [64][PW elements], PW = min(DH, 64), written by TMA with the swizzle of
// PW * 2 bytes (128 or 64).
template <int DH>
struct TileGeom {
  static constexpr int PW = DH < 64 ? DH : 64;  // panel width, elements
  static constexpr int SW = PW * 2;             // swizzle span, bytes
  static constexpr int NP = DH / PW;            // panels per tile
  static constexpr int PANEL_BYTES = 64 * SW;
  static constexpr int TILE_BYTES = 64 * DH * 2;
};

// Shared-memory layout from a 1024-aligned base (ops/encoder_attention.py
// _k3_smem_bytes mirrors it): [Q_BUFS][NWG] Q tiles, [stages][K, V]
// tiles, [Q_BUFS] item records, then the barriers kv_full, kv_empty
// [stages] and q_full, q_empty [Q_BUFS].
template <int DH, int NWG>
struct EncLayout {
  static constexpr int TILE = TileGeom<DH>::TILE_BYTES;
  static constexpr int kv = Q_BUFS * NWG * TILE;
  __host__ __device__ static int item(int stages) {
    return kv + stages * 2 * TILE;
  }
  __host__ __device__ static int bars(int stages) {
    return item(stages) + Q_BUFS * ITEM_WORDS * 4;
  }
  __host__ __device__ static int total(int stages) {
    return bars(stages) + (2 * stages + 2 * Q_BUFS) * 8;
  }
};

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DH == 128) wgmma_m64n128k16_bf16_rs_tb(o, a, db, 1);
  else if constexpr (DH == 64) wgmma_m64n64k16_bf16_rs_tb(o, a, db, 1);
  else wgmma_m64n32k16_bf16_rs_tb(o, a, db, 1);
}

// Blocks of one warpgroup (pairs of one q-tile) run two to an SM
// (ops/encoder_attention.py K3_MIN_BLOCKS mirrors the launch bounds).
// ptxas sizes a wgmma kernel's registers for whole warpgroups: 288 or
// 2 x 160 threads get 168 registers each.
template <int DH, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, NWG == 1 ? 2 : 1)
encoder_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qkv_map,
                               const int* __restrict__ valid_len,
                               bf16* __restrict__ out, int B, int H, int L,
                               int stages, int splits, float scale_bf16) {
  typedef TileGeom<DH> T;
  typedef EncLayout<DH, NWG> Lay;
  constexpr int KS = DH / 16;  // k-steps of Q.K^T over the head dim
  constexpr int NTK = BK / 8;  // 8-column groups of the score tile
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t q_s = smem_u32(smem);
  const uint32_t kv_s = smem_u32(smem + Lay::kv);
  int* s_item = reinterpret_cast<int*>(smem + Lay::item(stages));
  const uint32_t bars = smem_u32(smem + Lay::bars(stages));
  const uint32_t kv_full = bars, kv_empty = bars + 8 * stages;
  const uint32_t q_full = bars + 16 * stages;
  const uint32_t q_empty = q_full + 8 * Q_BUFS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int d = H * DH;
  const int nqt = (L + BQ - 1) / BQ;
  const int rounds = (nqt + NWG - 1) / NWG;
  // a work unit is one pair's rounds, or a share of them when the pairs
  // alone would leave SMs idle
  const int units = B * H * splits;
  const int per_unit = (rounds + splits - 1) / splits;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(kv_full + 8 * s, 1);         // the producer's arrive
      mbar_init(kv_empty + 8 * s, NWG * 4);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < Q_BUFS; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, NWG * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // ---- producer: one thread feeds the rounds' Q tiles and records and
    // the K/V ring; a stage's phase is bit s of a mask, since a pair uses
    // only as many stages as it has live key tiles ----
    if (lane != 0) return;
    int qb = 0, cursor = 0;
    uint32_t qph = 0, empty_ph = 0;
    for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
      const int pair = unit / splits;
      const int r0 = (unit % splits) * per_unit;
      const int r1 = min(rounds, r0 + per_unit);
      const int b = pair / H, h = pair % H;
      const int vl = valid_len[b];
      const int nkt = (live_keys(vl, L) + BK - 1) / BK;
      const bool resident = nkt <= stages;
      for (int r = r0; r < r1; ++r) {
        const int qt0 = r * NWG;
        const int active = min(NWG, nqt - qt0);
        mbar_wait(q_empty + 8 * qb, qph ^ 1);
        int* it = s_item + qb * ITEM_WORDS;
        it[0] = b;
        it[1] = h;
        it[2] = qt0;
        it[3] = nkt;
        it[4] = vl;
        it[5] = cursor;
        const uint32_t full_q = q_full + 8 * qb;
        mbar_arrive_expect_tx(full_q, active * T::TILE_BYTES);
        for (int w = 0; w < active; ++w)
          for (int p = 0; p < T::NP; ++p)
            tma_load_3d(q_s + (qb * NWG + w) * T::TILE_BYTES +
                            p * T::PANEL_BYTES,
                        &qkv_map, full_q, h * DH + p * T::PW,
                        (qt0 + w) * BQ, b);
        if (++qb == Q_BUFS) {
          qb = 0;
          qph ^= 1;
        }
        for (int t = 0; t < nkt; ++t) {
          const int s = (cursor + t) % stages;
          mbar_wait(kv_empty + 8 * s, ((empty_ph >> s) & 1u) ^ 1u);
          empty_ph ^= 1u << s;
          const uint32_t full = kv_full + 8 * s;
          if (resident && r > r0) {
            mbar_arrive(full);  // the tile is still in the stage
          } else {
            mbar_arrive_expect_tx(full, 2 * T::TILE_BYTES);
            const uint32_t kdst = kv_s + s * 2 * T::TILE_BYTES;
            for (int p = 0; p < T::NP; ++p) {
              tma_load_3d(kdst + p * T::PANEL_BYTES, &qkv_map, full,
                          d + h * DH + p * T::PW, t * BK, b);
              tma_load_3d(kdst + T::TILE_BYTES + p * T::PANEL_BYTES,
                          &qkv_map, full, 2 * d + h * DH + p * T::PW, t * BK,
                          b);
            }
          }
        }
        if (!resident || r + 1 == r1) cursor = (cursor + nkt) % stages;
      }
    }
    return;
  }

  // ---- consumers: warpgroup w takes q-tile qt0 + w of each round ----
  const int wg = warp >> 2;
  const int ctid = tid & 127;
  const int g = lane >> 2;             // fragment row group
  const int t4 = lane & 3;             // fragment column pair
  const int wr = 16 * (warp & 3) + g;  // this thread's rows: wr and wr + 8
  int qb = 0;
  uint32_t qph = 0, full_ph = 0;
  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int r0 = (unit % splits) * per_unit;
    for (int r = r0; r < min(rounds, r0 + per_unit); ++r) {
      mbar_wait(q_full + 8 * qb, qph);
      const int* it = s_item + qb * ITEM_WORDS;
      const int b = it[0], h = it[1], qt = it[2] + wg, nkt = it[3];
      const int vl = it[4], cursor = it[5];
      unsigned char* q_tile_p =
          smem + (qb * NWG + wg) * T::TILE_BYTES;
      const uint32_t q_tile = smem_u32(q_tile_p);
      auto stage_of = [&](int t) { return (cursor + t) % stages; };
      auto wait_full = [&](int s) {
        mbar_wait(kv_full + 8 * s, (full_ph >> s) & 1u);
        full_ph ^= 1u << s;
      };
      auto release = [&](int s) {
        __syncwarp();
        if (lane == 0) mbar_arrive(kv_empty + 8 * s);
      };

      if (qt >= nqt) {
        // an idle warpgroup of the last round still passes every stage
        for (int t = 0; t < nkt; ++t) {
          const int s = stage_of(t);
          wait_full(s);
          release(s);
        }
      } else {
        // q * scale in bf16, in place; the swizzle does not matter to an
        // elementwise product.  wgmma reads the tile through the async
        // proxy, so the generic writes are fenced before the barrier.
        uint4* q4 = reinterpret_cast<uint4*>(q_tile_p);
        for (int c = ctid; c < T::TILE_BYTES / 16; c += 128) {
          uint4 v = q4[c];
          v.x = scale_bf16x2(v.x, scale_bf16);
          v.y = scale_bf16x2(v.y, scale_bf16);
          v.z = scale_bf16x2(v.z, scale_bf16);
          v.w = scale_bf16x2(v.w, scale_bf16);
          q4[c] = v;
        }
        fence_proxy_async();
        warpgroup_sync(1 + wg);

        float o[DH / 2];
#pragma unroll
        for (int e = 0; e < DH / 2; ++e) o[e] = 0.f;
        float m_i[2] = {-INFINITY, -INFINITY};  // running row maxima
        float l_i[2] = {0.f, 0.f};              // per-thread partial sums
        float sc_a[BK / 2], sc_b[BK / 2];       // two score tiles in flight
        uint32_t pa[BK / 16][4];
        float alpha[2];
        // a sequence with valid_len 0 attends all L columns uniformly: its
        // masked columns score 0 instead of -1e30 (the same softmax, and
        // the exp2 argument below stays exact)
        const float masked = vl > 0 ? MASKED : 0.f;

        // S = Q . K^T of the tile in stage st: both operands K-major
        auto issue_scores = [&](float (&acc)[BK / 2], int st) {
          const uint32_t k_tile = kv_s + st * 2 * T::TILE_BYTES;
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const int off = (ks * 16 / T::PW) * T::PANEL_BYTES +
                            (ks * 16 % T::PW) * 2;
            wgmma_m64n64k16_bf16(
                acc, smem_desc(q_tile + off, T::SW, 8 * T::SW, 0),
                smem_desc(k_tile + off, T::SW, 8 * T::SW, 0), ks != 0);
          }
          wgmma_commit();
        };

        // acc[4 * nt + e] (row wr + 8 * (e >> 1), key k0 + 8 * nt + 2 * t4 +
        // (e & 1)) from scores of key tile t to unnormalised probabilities,
        // exp2(s * log2 e - m * log2 e); alpha is what the running output
        // must shrink by first
        auto scores_to_probs = [&](float (&acc)[BK / 2], int t) {
          const int k0 = t * BK;
          if (k0 + BK > vl || k0 + BK > L) {
            // the valid_len / L edge: -1e30 past valid_len, -inf past L
#pragma unroll
            for (int x = 0; x < BK / 2; ++x) {
              const int col = k0 + 8 * (x >> 2) + 2 * t4 + (x & 1);
              if (col >= vl) acc[x] = masked;
              if (col >= L) acc[x] = -INFINITY;
            }
          }
          float mt[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            // a tree over the row's 16 values (max is exact in any order)
            float m8[NTK];
#pragma unroll
            for (int nt = 0; nt < NTK; ++nt)
              m8[nt] = fmaxf(acc[4 * nt + 2 * i], acc[4 * nt + 2 * i + 1]);
#pragma unroll
            for (int w = NTK / 2; w > 0; w >>= 1)
#pragma unroll
              for (int nt = 0; nt < w; ++nt)
                m8[nt] = fmaxf(m8[nt], m8[nt + w]);
            mt[i] = m8[0];
            mt[i] = fmaxf(mt[i], __shfl_xor_sync(FULL_MASK, mt[i], 1));
            mt[i] = fmaxf(mt[i], __shfl_xor_sync(FULL_MASK, mt[i], 2));
          }
          float mb[2], ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            // column k0 < L always, so m_new is finite from the first tile
            const float m_new = fmaxf(m_i[i], mt[i]);
            alpha[i] = ex2((m_i[i] - m_new) * LOG2E);  // 0 at the first
            m_i[i] = m_new;
            mb[i] = m_new * LOG2E;
          }
#pragma unroll
          for (int x = 0; x < BK / 2; ++x) {
            const int i = (x >> 1) & 1;
            acc[x] = ex2(fmaf(acc[x], LOG2E, -mb[i]));
            ls[i][(x >> 2) & 1] += acc[x];
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
            l_i[i] = l_i[i] * alpha[i] + (ls[i][0] + ls[i][1]);
        };

        // P, rounded to bf16, is the A operand of P.V: the score fragment
        // of k-step j (keys 16 j .. 16 j + 15) is the m16k16 A fragment
        auto pack_probs = [&](const float (&acc)[BK / 2]) {
#pragma unroll
          for (int nt = 0; nt < NTK; ++nt) {
            pa[nt >> 1][2 * (nt & 1)] =
                pack_bf16(acc[4 * nt], acc[4 * nt + 1]);
            pa[nt >> 1][2 * (nt & 1) + 1] =
                pack_bf16(acc[4 * nt + 2], acc[4 * nt + 3]);
          }
#pragma unroll
          for (int j = 0; j < BK / 16; ++j) wgmma_pin(pa[j]);
        };

        // O += P . V of the tile in stage st: V is [key][dh], B MN-major
        auto issue_pv = [&](int st) {
          const uint32_t v_tile =
              kv_s + st * 2 * T::TILE_BYTES + T::TILE_BYTES;
          wgmma_pin(o);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < BK / 16; ++j)
            wgmma_pv<DH>(o, pa[j],
                         smem_desc(v_tile + j * 16 * T::SW, T::SW, 8 * T::SW,
                                   T::PANEL_BYTES));
          wgmma_commit();
        };

        // Tile t's scores are in cur.  The scores of tile t + 1 are issued
        // first, so they run on the tensor cores under tile t's softmax;
        // P.V of tile t - 1 has finished by then too.
        auto step = [&](float (&cur)[BK / 2], float (&nxt)[BK / 2], int t) {
          const int sn = stage_of(t + 1);
          wait_full(sn);
          issue_scores(nxt, sn);
          scores_to_probs(cur, t);
          wgmma_wait<1>();  // P.V of tile t - 1 (the older group)
          wgmma_pin(o);
          if (t > 0) release(stage_of(t - 1));
#pragma unroll
          for (int x = 0; x < DH / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
          pack_probs(cur);
          issue_pv(stage_of(t));
          wgmma_wait<1>();  // the scores of tile t + 1; P.V of t may run
          wgmma_pin(nxt);
        };
        // the last tile: no scores to issue ahead
        auto last = [&](float (&cur)[BK / 2], int t) {
          scores_to_probs(cur, t);
          wgmma_wait<0>();
          wgmma_pin(o);
          if (t > 0) release(stage_of(t - 1));
#pragma unroll
          for (int x = 0; x < DH / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
          pack_probs(cur);
          issue_pv(stage_of(t));
          wgmma_wait<0>();
          wgmma_pin(o);
          release(stage_of(t));
        };

        wait_full(stage_of(0));
        issue_scores(sc_a, stage_of(0));
        wgmma_wait<0>();
        wgmma_pin(sc_a);
        if constexpr (DH <= 64) {
          // tiles in pairs, so each score tile keeps its registers (no
          // branch around a wgmma inside the loop; the odd tail is peeled)
          const int pairs2 = (nkt - 1) / 2;
          for (int p = 0; p < pairs2; ++p) {
            step(sc_a, sc_b, 2 * p);
            step(sc_b, sc_a, 2 * p + 1);
          }
          if ((nkt - 1) & 1) {
            step(sc_a, sc_b, nkt - 2);
            last(sc_b, nkt - 1);
          } else {
            last(sc_a, nkt - 1);
          }
        } else {
          // Dh = 128: two score tiles and the 64 output registers do not
          // fit beside each other (ptxas then serialises the wgmma), so one
          // score tile: tile t + 1's scores run under tile t's P.V
          scores_to_probs(sc_a, 0);
          pack_probs(sc_a);
          int s = stage_of(0);
          for (int t = 0; t + 1 < nkt; ++t) {
            const int sn = stage_of(t + 1);
            wait_full(sn);
            issue_scores(sc_a, sn);
            issue_pv(s);
            wgmma_wait<1>();
            wgmma_pin(sc_a);
            scores_to_probs(sc_a, t + 1);
            wgmma_wait<0>();
            wgmma_pin(o);
            release(s);
#pragma unroll
            for (int x = 0; x < DH / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
            pack_probs(sc_a);
            s = sn;
          }
          issue_pv(s);
          wgmma_wait<0>();
          wgmma_pin(o);
          release(s);
        }

        // Every product that reads the Q tile has completed: the warp
        // stages its 16 output rows there (16-byte chunk c of row r at
        // chunk c ^ swz(r)) and stores whole row segments, 16 bytes a lane.
        constexpr int RB = DH * 2;   // bytes of an output row segment
        constexpr int CPR = DH / 8;  // 16-byte chunks of a row segment
        auto swz = [](int rr) {
          return CPR >= 8 ? (rr & 7) : ((rr >> 1) & (CPR - 1));
        };
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l_i[i] += __shfl_xor_sync(FULL_MASK, l_i[i], 1);
          l_i[i] += __shfl_xor_sync(FULL_MASK, l_i[i], 2);
          const float inv = 1.f / l_i[i];  // l >= 1: the row's max has p 1
          const int rr = wr + 8 * i;
#pragma unroll
          for (int dn = 0; dn < CPR; ++dn)
            *reinterpret_cast<uint32_t*>(q_tile_p + rr * RB +
                                         ((dn ^ swz(rr)) << 4) + 4 * t4) =
                pack_bf16(o[4 * dn + 2 * i] * inv,
                          o[4 * dn + 2 * i + 1] * inv);
        }
        __syncwarp();
        const int q0 = qt * BQ;
        bf16* op = out + (size_t)b * L * d + (size_t)h * DH;
#pragma unroll
        for (int idx = lane; idx < 16 * CPR; idx += 32) {
          const int rr = 16 * (warp & 3) + idx / CPR;
          const int c = idx % CPR;
          if (q0 + rr < L)
            *reinterpret_cast<uint4*>(op + (size_t)(q0 + rr) * d + 8 * c) =
                *reinterpret_cast<const uint4*>(q_tile_p + rr * RB +
                                                ((c ^ swz(rr)) << 4));
        }
      }
      // the Q tile and the record are free; the TMA unit writes the tile
      // next, after these generic-proxy accesses
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty + 8 * qb);
      if (++qb == Q_BUFS) {
        qb = 0;
        qph ^= 1;
      }
    }
  }
}

template <int DH, int NWG>
int launch_wgmma(const void* qkv, const int* valid_len, void* out, int B,
                 int H, int L, float scale, int stages, int splits,
                 int grid, cudaStream_t stream) {
  typedef TileGeom<DH> T;
  const int smem = EncLayout<DH, NWG>::total(stages);
  // a step waits for tile t + 1 before it frees tile t - 1: >= 3 stages
  if (stages < 3 || stages > MAX_STAGES || smem > SMEM_LIMIT || grid < 1 ||
      splits < 1)
    return -1;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        encoder_attention_wgmma_kernel<DH, NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  // the packed [B][L][3d] rows in boxes of [1][64][PW]; rows past L arrive
  // as zeros
  const int d = H * DH;
  const CUtensorMapSwizzle sw =
      T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const uint32_t box[3] = {(uint32_t)T::PW, (uint32_t)BQ, 1u};
  const uint64_t dims[3] = {(uint64_t)3 * d, (uint64_t)L, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)3 * d * 2, (uint64_t)L * 3 * d * 2};
  CUtensorMap map;
  if (!make_tensor_map(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, qkv, dims,
                       strides, box, sw))
    return -2;
  // the scale as q's dtype holds it
  const float scale_bf16 = __bfloat162float(__float2bfloat16_rn(scale));
  encoder_attention_wgmma_kernel<DH, NWG>
      <<<grid, NWG * 128 + 32, smem, stream>>>(
          map, valid_len, static_cast<bf16*>(out), B, H, L, stages, splits,
          scale_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  if (code == -1) return "unsupported dtype / head dim / batch / launch plan";
  if (code == -2) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

// qkv [B, L, 3*H*Dh] contiguous, valid_len [B] int32, out [B, L, H*Dh].
// dtype: 0 = float32, 1 = bfloat16.  Both take the launch plan of
// ops/encoder_attention.py encoder_attention_geometry: consumer
// warpgroups per block (1 or 2), ring stages, splits of a pair's rounds
// and grid size (float32 reads only the stages and the grid, and refuses
// a plan that does not describe its body).  Returns 0, a CUDA error code,
// or a negative code of kernel_error_string.
int encoder_attention(const void* qkv, const int* valid_len, void* out, int B,
                      int H, int L, int Dh, float scale, int dtype, int nwg,
                      int stages, int splits, int grid, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || L < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ENC_F32(D) \
  return launch_f32<D>(qkv, valid_len, out, B, H, L, scale, stages, grid, s)
#define ENC_WGMMA(D, W)                                                   \
  return launch_wgmma<D, W>(qkv, valid_len, out, B, H, L, scale, stages, \
                            splits, grid, s)
  if (dtype == 0) {
    if (Dh == 32) ENC_F32(32);
    if (Dh == 64) ENC_F32(64);
    if (Dh == 128) ENC_F32(128);
  } else if (dtype == 1) {
    if (Dh == 32 && nwg == 1) ENC_WGMMA(32, 1);
    if (Dh == 32 && nwg == 2) ENC_WGMMA(32, 2);
    if (Dh == 64 && nwg == 1) ENC_WGMMA(64, 1);
    if (Dh == 64 && nwg == 2) ENC_WGMMA(64, 2);
    if (Dh == 128 && nwg == 1) ENC_WGMMA(128, 1);
    if (Dh == 128 && nwg == 2) ENC_WGMMA(128, 2);
  }
#undef ENC_F32
#undef ENC_WGMMA
  return -1;
}

}  // extern "C"
