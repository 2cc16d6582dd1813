// Kernels K4 and K5: fused inner-product search (matmul + exact top-k)
// for Hopper (sm_90a).
//
// Replaces sdag_tpu/ops/topk.py fused_topk_matmul (_topk_kernel; bf16 or
// f32 corpus, queries in the corpus dtype, f32 accumulation) and
// fused_topk_matmul_int8 (_topk_kernel_int8; int8 corpus and per-row
// quantised int8 queries, exact int32 dot, score = float(acc) * q_scale *
// row_scale in that order).  Both return, per query, the k best corpus
// rows ordered (score desc, index asc); rows >= valid_n never rank and
// missing entries are (-inf, -1).  The [Q, N] score matrix never reaches
// device memory.
//
// What bounds it: one pass over the corpus (bytes) until Q grows past
// ~150 (bf16) queries, then the product (operations).  chip_smoke.py
// reports the times beside the bound.
//
// Tensor-core bodies (bf16, int8): topk_matmul_mma, warp-specialised on
// wgmma + TMA (hopper_async.cuh).
//   grid (query tile, corpus split); one block per SM walks its split's
//   128-row corpus tiles in ascending order.  A producer thread streams
//   128-byte chunks of the feature axis through a ring of shared-memory
//   stages with TMA (128-byte swizzle; rows past N or bytes past the row
//   arrive as zeros): the corpus tile's chunk with the query tile's chunk
//   beside it; int8 also gets the tile's 128 row scales with the last
//   chunk.  (Keeping the whole query tile resident instead was measured:
//   it leaves room for two stages only and read slower at every shape.)
//   The ring runs on across tiles.  One or two consumer warpgroups own 64
//   query rows each and accumulate the [64, 128] scores in registers with
//   four wgmma per chunk (m64n128k16 bf16 / m64n128k32 s8), one chunk's
//   group in flight while the previous stage is released.  Both
//   warpgroups read the same corpus chunk, so a stage is free only when
//   both have used it: they stay within a ring's length of each other, and
//   one's epilogue overlaps the other's products only that far (this is
//   what k = 64 still pays for).
//   Epilogue.  A row belongs to one warp (4 lanes hold its 128 scores).
//   Each row keeps its k-th best score so far as a threshold in a
//   register; scores above it are appended to the row's unsorted buffer in
//   shared memory (capacity CAP = 64 / 128 / 256 for k <= 16 / 64 / 128),
//   at slots from a prefix sum over the row's 4 lanes, stored by predicate.
//   After every 32 columns a vote finds rows holding more than CAP - 32
//   entries; the warp sorts such a row in registers (bitonic network over
//   shuffles, order (score desc, index asc)), keeps the best k and
//   refreshes the threshold.  Tiles ascend, so a later score equal to the
//   threshold has a larger index and is rightly dropped by the strict
//   compare.  A row's cost per tile is a compare per score; the sort is
//   paid once per >= CAP - 32 - k appended candidates, whatever k.
//   At the end every row is sorted once more and its k entries go out as
//   [split][Q][k], or straight to the result when there is one split.
//   Pass 2 (topk_merge.cuh, shared with bm25_scan_topk.cu): one block per
//   query merges the splits' lists exactly.
// The int8 query quantiser (row abs-max / 127, round half to even, clamp)
// is quantize_rows_int8_kernel below, bit-equal to the plain rule.
// f32 corpora stay f32 on CUDA-core FMA with register-staged 64-row tiles
// and warp-cooperative sorted lists (TF32 would reorder near-equal
// scores).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_async.cuh"
#include "topk_merge.cuh"

namespace {

constexpr int BN = 128;             // corpus rows per tile
constexpr int CHUNK = 128;          // bytes of a row per ring stage
constexpr int C_BYTES = BN * CHUNK; // a stage's corpus chunk
constexpr int WG_ROWS = 64;         // query rows per consumer warpgroup
constexpr int Q_BYTES = WG_ROWS * CHUNK;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of a block
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory layout of topk_matmul_mma, in bytes from a 1024-aligned
// base (ops/topk.py topk_mma_geometry computes the same total).
struct MmaLayout {
  int stage_bytes, ring, scales, bv, bi, bars, total;
};

__host__ __device__ inline MmaLayout mma_layout(int bq, int cap, int stages) {
  MmaLayout l;
  l.stage_bytes = C_BYTES + bq * CHUNK;  // corpus chunk, then query chunk
  l.ring = 0;
  l.scales = l.ring + stages * l.stage_bytes;
  l.bv = l.scales + stages * BN * 4;
  l.bi = l.bv + bq * cap * 4;
  l.bars = l.bi + bq * cap * 4;
  l.total = l.bars + 2 * stages * 8;
  return l;
}

// Sort 32 * R entries held R per lane (entry c * 32 + lane in v[c], ix[c])
// into (score desc, index asc) order with a bitonic network: partners a
// multiple of 32 apart sit in the same lane, nearer ones are a shuffle away.
template <int R>
__device__ __forceinline__ void warp_sort_desc(float (&v)[R], int (&ix)[R],
                                               int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * R; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int m = stride >> 5;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          if (c & m) continue;
          const int c2 = c | m;
          const bool desc = ((c * 32) & size) == 0;
          const bool swap = desc ? better(v[c2], ix[c2], v[c], ix[c])
                                 : better(v[c], ix[c], v[c2], ix[c2]);
          if (swap) {
            const float tv = v[c];
            const int ti = ix[c];
            v[c] = v[c2];
            ix[c] = ix[c2];
            v[c2] = tv;
            ix[c2] = ti;
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const float ov = __shfl_xor_sync(FULL, v[c], stride);
          const int oi = __shfl_xor_sync(FULL, ix[c], stride);
          const bool desc = ((c * 32 + lane) & size) == 0;
          const bool lower = (lane & stride) == 0;
          // the lower slot of a descending pair keeps the better entry
          const bool take = (lower == desc) ? better(ov, oi, v[c], ix[c])
                                            : better(v[c], ix[c], ov, oi);
          if (take) {
            v[c] = ov;
            ix[c] = oi;
          }
        }
      }
    }
  }
}

// The warp sorts one row's buffer of n entries and keeps its best k (sorted,
// at the front).  Returns the row's new threshold to every lane: the k-th
// score once k entries exist, -inf before.  The row then holds min(n, k).
// Not inlined: five inlined copies of the network (one per 32-column part
// and one at the end) read 2x slower at k = 64 than one shared copy.
template <int R>
__device__ __noinline__ float compact_row(float* bv, int* bi, int row,
                                                 int n, int k, int lane) {
  constexpr int CAP = 32 * R;
  float v[R];
  int ix[R];
#pragma unroll
  for (int c = 0; c < R; ++c) {
    const int j = lane + 32 * c;
    v[c] = j < n ? bv[row * CAP + j] : -INFINITY;
    ix[c] = j < n ? bi[row * CAP + j] : TOPK_INT_MAX;
  }
  warp_sort_desc<R>(v, ix, lane);
  float kth = -INFINITY;
#pragma unroll
  for (int c = 0; c < R; ++c) {
    const int j = lane + 32 * c;
    if (j < k) {
      bv[row * CAP + j] = v[c];
      bi[row * CAP + j] = ix[c];
    }
    const float t = __shfl_sync(FULL, v[c], (k - 1) & 31);
    if (c == ((k - 1) >> 5)) kth = t;
  }
  __syncwarp();
  return n >= k ? kth : -INFINITY;
}

template <bool INT8, int NWG, int R>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
topk_matmul_mma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap c_map,
                const __grid_constant__ CUtensorMap s_map,
                const float* __restrict__ q_scales, float* vals_out,
                int* idx_out, int Q, int k, int valid_n, int n_chunks,
                int tiles_per_split, int stages, int direct) {
  constexpr int BQ = WG_ROWS * NWG;
  constexpr int CAP = 32 * R;
  constexpr int EPC = INT8 ? CHUNK : CHUNK / 2;  // elements per chunk
  typedef typename std::conditional<INT8, int, float>::type acc_t;
  extern __shared__ __align__(1024) unsigned char smem[];
  const MmaLayout L = mma_layout(BQ, CAP, stages);
  float* bv = reinterpret_cast<float*>(smem + L.bv);  // [BQ][CAP]
  int* bi = reinterpret_cast<int*>(smem + L.bi);      // [BQ][CAP]
  const uint32_t ring = smem_u32(smem + L.ring);
  const uint32_t bars = smem_u32(smem + L.bars);
  // barriers: full[stages], empty[stages]
  const uint32_t empty0 = bars + 8 * stages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int tile_begin = split * tiles_per_split;
  const int tile_end =
      min(tile_begin + tiles_per_split, (valid_n + BN - 1) / BN);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);          // the producer's expect_tx
      mbar_init(empty0 + 8 * s, NWG * 4);  // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // ---- producer: one thread keeps the ring full ----
    if (lane != 0 || tile_begin >= tile_end) return;
    int s = 0;
    uint32_t ph = 0;
    for (int tile = tile_begin; tile < tile_end; ++tile) {
      for (int c = 0; c < n_chunks; ++c) {
        const bool with_scales = INT8 && c == n_chunks - 1;
        const uint32_t full = bars + 8 * s;
        const uint32_t base = ring + s * L.stage_bytes;
        mbar_wait(empty0 + 8 * s, ph ^ 1);
        mbar_arrive_expect_tx(full,
                              L.stage_bytes + (with_scales ? BN * 4 : 0));
        tma_load_2d(base, &c_map, full, c * EPC, tile * BN);
        for (int w = 0; w < NWG; ++w)
          tma_load_2d(base + C_BYTES + w * Q_BYTES, &q_map, full, c * EPC,
                      q0 + WG_ROWS * w);
        if (with_scales)
          tma_load_1d(smem_u32(smem + L.scales) + s * BN * 4, &s_map, full,
                      tile * BN);
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers ----
  const int wg = warp >> 2;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow0 = WG_ROWS * wg + 16 * (warp & 3);  // the warp's 16 rows
  const int r0 = wrow0 + g;                          // this thread's: r0, r0+8
  // per row, in the registers of its 4 lanes (kept equal): the entries in
  // its buffer and its threshold; rows past Q never take a candidate
  int cnt_r[2] = {0, 0};
  float thr_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    thr_r[i] = q0 + r0 + 8 * i < Q ? -INFINITY : INFINITY;
  float qs[2] = {0.f, 0.f};
  if constexpr (INT8) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (q0 + r0 + 8 * i < Q) qs[i] = q_scales[q0 + r0 + 8 * i];
  }
  acc_t acc[BN / 2];
  int s = 0;
  uint32_t ph = 0;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int n0 = tile * BN;
    int prev = -1;
    for (int c = 0; c < n_chunks; ++c) {
      mbar_wait(bars + 8 * s, ph);
      const uint32_t base = ring + s * L.stage_bytes;
      const uint64_t da =
          smem_desc(base + C_BYTES + wg * Q_BYTES, 128, 1024, 0);
      const uint64_t db = smem_desc(base, 128, 1024, 0);
      if (c == 0) wgmma_pin(acc);  // the epilogue's reads stay above
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < CHUNK / 32; ++ks) {
        // 32 bytes along the row: 2 units of the descriptor's address
        if constexpr (INT8)
          wgmma_m64n128k32_s8(acc, da + 2 * ks, db + 2 * ks, (c | ks) != 0);
        else
          wgmma_m64n128k16_bf16(acc, da + 2 * ks, db + 2 * ks, (c | ks) != 0);
      }
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();  // the previous chunk's products have read its stage
        if (lane == 0) mbar_arrive(empty0 + 8 * prev);
      }
      prev = s;
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    wgmma_pin(acc);  // no read of the scores moves above the wait
    // this thread's 32 columns' scales, staged with the tile's last chunk
    float cs[BN / 4];
    if constexpr (INT8) {
      const float2* sc2 = reinterpret_cast<const float2*>(
          smem + L.scales + prev * BN * 4);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 t = sc2[4 * j + t4];
        cs[2 * j] = t.x;
        cs[2 * j + 1] = t.y;
      }
      __syncwarp();  // every lane has read before lane 0 releases the stage
    }
    if (lane == 0) mbar_arrive(empty0 + 8 * prev);

    // acc[4 * j + e]: row r0 + 8 * (e >> 1), corpus row n0 + 8 * j + 2 * t4
    // + (e & 1).  32 columns at a time: flag the scores above the row's
    // threshold, give every flagged score a slot behind the row's count (a
    // prefix sum over the row's 4 lanes, no atomics), store by predicate.
#pragma unroll
    for (int part = 0; part < 4; ++part) {
      float sc[16];
      unsigned m[2] = {0u, 0u};  // bit 2 * jj + (e & 1) of row e >> 1
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * part + jj;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + 8 * j + 2 * t4 + (e & 1);
          float x;
          if constexpr (INT8)
            x = __fmul_rn(__fmul_rn((float)acc[4 * j + e], qs[e >> 1]),
                          cs[2 * j + (e & 1)]);
          else
            x = acc[4 * j + e];
          sc[4 * jj + e] = x;
          const bool pass = x > thr_r[e >> 1] && col < valid_n;
          m[e >> 1] |= (unsigned)pass << (2 * jj + (e & 1));
        }
      }
      if (!__any_sync(FULL, (m[0] | m[1]) != 0u)) continue;
      // counts of both rows in one word; the quad's exclusive prefix
      const int mine = __popc(m[0]) | (__popc(m[1]) << 16);
      int pre = 0, tot = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = __shfl_sync(FULL, mine, (lane & ~3) | i);
        tot += o;
        if (i < t4) pre += o;
      }
      int slot[2] = {cnt_r[0] + (pre & 0xffff), cnt_r[1] + (pre >> 16)};
      cnt_r[0] += tot & 0xffff;
      cnt_r[1] += tot >> 16;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          if ((m[i] >> (2 * jj + (e & 1))) & 1u) {
            // below CAP: a row holds <= CAP - 32 entries before a part
            const int at = (r0 + 8 * i) * CAP + min(slot[i], CAP - 1);
            bv[at] = sc[4 * jj + e];
            bi[at] = n0 + 8 * (4 * part + jj) + 2 * t4 + (e & 1);
            ++slot[i];
          }
        }
      }
      __syncwarp();
      // rows over the mark: bit 4 * g of the vote is row g (+ 8 * i)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        unsigned need =
            __ballot_sync(FULL, cnt_r[i] > CAP - 32) & 0x11111111u;
        while (need) {
          const int src = __ffs(need) - 1;
          need &= need - 1;
          const int n = __shfl_sync(FULL, cnt_r[i], src);
          const float t = compact_row<R>(bv, bi, wrow0 + (src >> 2) + 8 * i,
                                         n, k, lane);
          if (g == (src >> 2)) {
            cnt_r[i] = min(n, k);
            thr_r[i] = t;
          }
        }
      }
    }
  }

  // each warp sorts and writes the lists of its own 16 rows
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    for (int gg = 0; gg < 8; ++gg) {
      const int row = wrow0 + gg + 8 * i;
      const int n = __shfl_sync(FULL, cnt_r[i], 4 * gg);
      if (q0 + row >= Q) continue;
      compact_row<R>(bv, bi, row, n, k, lane);
      const size_t off = ((size_t)split * Q + q0 + row) * k;
      for (int j = lane; j < k; j += 32) {
        const int ix = j < n ? bi[row * CAP + j] : TOPK_INT_MAX;
        vals_out[off + j] = j < n ? bv[row * CAP + j] : -INFINITY;
        idx_out[off + j] = (direct && ix == TOPK_INT_MAX) ? -1 : ix;
      }
    }
  }
}

// Symmetric per-row int8 quantisation of the queries (ops/topk.py
// quantize_last_axis_int8): scale = max(|x|, 1e-12) / 127 as a division,
// value = clamp(round-half-even(x / scale), +-127).  One block per row.
constexpr int QUANT_NT = 128;

__global__ void __launch_bounds__(QUANT_NT)
quantize_rows_int8_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                          float* __restrict__ scales, int D) {
  __shared__ float red[QUANT_NT / 32];
  const float* xr = x + (size_t)blockIdx.x * D;
  int8_t* qr = q + (size_t)blockIdx.x * D;
  float m = 0.f;
  for (int d = threadIdx.x; d < D; d += QUANT_NT) m = fmaxf(m, fabsf(xr[d]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < QUANT_NT / 32; ++w) m = fmaxf(m, red[w]);
  const float scale = __fdiv_rn(fmaxf(m, 1e-12f), 127.f);
  for (int d = threadIdx.x; d < D; d += QUANT_NT) {
    const float v = rintf(__fdiv_rn(xr[d], scale));
    qr[d] = (int8_t)(int)fminf(fmaxf(v, -127.f), 127.f);
  }
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
}

// f32 corpus: CUDA-core FMA, 256 threads; thread (ty, tx) = (tid/16,
// tid%16) owns query rows ty+16i and corpus columns tx+16j (i, j < 4).  A
// query row is shared by the 16 lanes of one half-warp, so its list is
// still touched by one warp only.
constexpr int F32_NT = 256;
constexpr int F32_BN = 64;  // corpus rows per tile
constexpr int F32_DK = 32;
constexpr int F32_RP = F32_DK + 1;

__global__ void __launch_bounds__(F32_NT)
topk_matmul_f32(const float* __restrict__ queries,
                const float* __restrict__ corpus, float* cand_vals,
                int* cand_idx, int Q, int N, int D, int k, int valid_n,
                int tiles_per_split) {
  constexpr int BQ = 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [BQ][F32_RP]
  float* sC = sQ + BQ * F32_RP;                    // [F32_BN][F32_RP]
  float* lv = sC + F32_BN * F32_RP;                // [BQ][k]
  int* li = reinterpret_cast<int*>(lv + BQ * k);   // [BQ][k]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;

  for (int e = tid; e < BQ * k; e += F32_NT) {
    lv[e] = -INFINITY;
    li[e] = TOPK_INT_MAX;
  }
  __syncthreads();

  const int tile_begin = split * tiles_per_split;
  for (int tile = tile_begin; tile < tile_begin + tiles_per_split; ++tile) {
    const int n0 = tile * F32_BN;
    if (n0 >= valid_n) break;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += F32_DK) {
      __syncthreads();
      for (int e = tid; e < BQ * F32_DK; e += F32_NT) {
        const int r = e / F32_DK, d = e % F32_DK;
        const bool din = d0 + d < D;
        sQ[r * F32_RP + d] = (din && q0 + r < Q)
            ? queries[(size_t)(q0 + r) * D + d0 + d] : 0.f;
        sC[r * F32_RP + d] = (din && n0 + r < N)
            ? corpus[(size_t)(n0 + r) * D + d0 + d] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < F32_DK; ++d) {
        float qv[4], cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * F32_RP + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) cv[j] = sC[(tx + 16 * j) * F32_RP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], cv[j], s[i][j]);
      }
    }

    bool mine = false;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float thr_v = lv[r * k + k - 1];
      const int thr_i = li[r * k + k - 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx + 16 * j;
        if (col < valid_n && q0 + r < Q &&
            better(s[i][j], col, thr_v, thr_i))
          mine = true;
      }
    }
    if (__any_sync(0xffffffffu, mine)) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const float thr_v = lv[r * k + k - 1];
        const int thr_i = li[r * k + k - 1];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + tx + 16 * j;
          const bool cand = col < valid_n && q0 + r < Q &&
                            better(s[i][j], col, thr_v, thr_i);
          unsigned m = __ballot_sync(0xffffffffu, cand);
          while (m) {
            const int src = __ffs(m) - 1;
            m &= m - 1;
            const float cs_ = __shfl_sync(0xffffffffu, s[i][j], src);
            const int cc = __shfl_sync(0xffffffffu, col, src);
            const int cr = __shfl_sync(0xffffffffu, r, src);
            warp_topk_insert(lv + cr * k, li + cr * k, k, cs_, cc, lane);
          }
        }
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < BQ * k; e += F32_NT) {
    const int r = e / k, j = e % k;
    if (q0 + r < Q) {
      const size_t off = ((size_t)split * Q + q0 + r) * k + j;
      cand_vals[off] = lv[e];
      cand_idx[off] = li[e];
    }
  }
}

template <bool INT8, int NWG, int R>
int launch_mma(const CUtensorMap& q_map, const CUtensorMap& c_map,
               const CUtensorMap& s_map, const float* q_scales,
               float* vals_out, int* idx_out, int Q, int k, int valid_n,
               int n_chunks, int n_splits, int tiles_per_split, int stages,
               int direct, cudaStream_t stream) {
  constexpr int BQ = WG_ROWS * NWG;
  const int smem = mma_layout(BQ, 32 * R, stages).total;
  if (smem > SMEM_LIMIT) return -1;
  static int smem_set = 0;  // per instantiation
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        topk_matmul_mma<INT8, NWG, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dim3 grid((Q + BQ - 1) / BQ, n_splits);
  topk_matmul_mma<INT8, NWG, R><<<grid, NWG * 128 + 32, smem, stream>>>(
      q_map, c_map, s_map, q_scales, vals_out, idx_out, Q, k, valid_n,
      n_chunks, tiles_per_split, stages, direct);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  if (code == -1)
    return "unsupported dtype, k, feature width or launch geometry";
  if (code == -2) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (queries int8 with q_scales
// [Q], corpus int8 with c_scales [N]; both null otherwise).  cand_* are
// scratch [n_splits, Q, k] (unused with one split of a tensor-core body,
// which writes out_* itself); out_* are [Q, k].  Split s covers corpus
// tiles [s * tiles_per_split, (s + 1) * tiles_per_split) of 128 rows (64
// for float32).  q_rows (64 or 128 query rows a block), cap (entries of a
// row's candidate buffer: 64, 128 or 256, at least k + 32) and stages come
// from ops/topk.py topk_mma_geometry and are ignored for float32.  Returns
// 0, a CUDA error code, or a negative code of kernel_error_string.
int topk_matmul(const void* queries, const void* corpus,
                const float* q_scales, const float* c_scales,
                float* cand_vals, int* cand_idx, float* out_vals,
                int* out_idx, int Q, int N, int D, int k, int valid_n,
                int n_splits, int tiles_per_split, int q_rows, int cap,
                int stages, int dtype, void* stream) {
  if (k < 1 || k > TOPK_MAX_K || Q < 1 || N < 1 || n_splits < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  if (dtype == 0) {
    const size_t smem =
        (size_t)(64 + F32_BN) * F32_RP * 4 + (size_t)64 * k * 8;
    cudaError_t err = cudaFuncSetAttribute(
        topk_matmul_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Q + 63) / 64, n_splits);
    topk_matmul_f32<<<grid, F32_NT, smem, s>>>(
        static_cast<const float*>(queries), static_cast<const float*>(corpus),
        cand_vals, cand_idx, Q, N, D, k, valid_n, tiles_per_split);
    rc = (int)cudaGetLastError();
  } else if (dtype == 1 || dtype == 2) {
    const bool int8 = dtype == 2;
    const int row_bytes = int8 ? D : 2 * D;
    if (row_bytes % 16 || cap < k + 32 || stages < 2) return -1;
    const int n_chunks = (row_bytes + CHUNK - 1) / CHUNK;
    const int direct = n_splits == 1;
    // boxes: [64 query rows | 128 corpus rows] x 128 bytes of the row, and
    // 128 row scales
    const CUtensorMapDataType type =
        int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const uint32_t epc = int8 ? CHUNK : CHUNK / 2;
    CUtensorMap q_map, c_map, s_map;
    const uint64_t q_dims[2] = {(uint64_t)D, (uint64_t)Q};
    const uint64_t c_dims[2] = {(uint64_t)D, (uint64_t)N};
    const uint64_t strides[1] = {(uint64_t)row_bytes};
    const uint32_t q_box[2] = {epc, WG_ROWS}, c_box[2] = {epc, BN};
    if (!make_tensor_map(&q_map, type, 2, queries, q_dims, strides, q_box,
                         CU_TENSOR_MAP_SWIZZLE_128B) ||
        !make_tensor_map(&c_map, type, 2, corpus, c_dims, strides, c_box,
                         CU_TENSOR_MAP_SWIZZLE_128B))
      return -2;
    s_map = c_map;  // unused unless int8
    if (int8) {
      const uint64_t s_dims[1] = {(uint64_t)N};
      const uint32_t s_box[1] = {BN};
      if (!make_tensor_map(&s_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                           c_scales, s_dims, strides, s_box,
                           CU_TENSOR_MAP_SWIZZLE_NONE))
        return -2;
    }
    float* vals = direct ? out_vals : cand_vals;
    int* idx = direct ? out_idx : cand_idx;
#define TOPK_LAUNCH(I8, NWG, R)                                              \
  rc = launch_mma<I8, NWG, R>(q_map, c_map, s_map, q_scales, vals, idx, Q,   \
                              k, valid_n, n_chunks, n_splits,                \
                              tiles_per_split, stages, direct, s)
#define TOPK_BY_SHAPE(I8)                                                    \
  if (q_rows == 128 && cap == 64) TOPK_LAUNCH(I8, 2, 2);                     \
  else if (q_rows == 128 && cap == 128) TOPK_LAUNCH(I8, 2, 4);               \
  else if (q_rows == 64 && cap == 64) TOPK_LAUNCH(I8, 1, 2);                 \
  else if (q_rows == 64 && cap == 128) TOPK_LAUNCH(I8, 1, 4);                \
  else if (q_rows == 64 && cap == 256) TOPK_LAUNCH(I8, 1, 8)
    if (int8) {
      TOPK_BY_SHAPE(true);
    } else {
      TOPK_BY_SHAPE(false);
    }
#undef TOPK_BY_SHAPE
#undef TOPK_LAUNCH
    if (rc != 0 || direct) return rc;
  }
  if (rc != 0) return rc;
  // every first pass above writes sorted lists
  if (n_splits <= MERGE_SORTED_MAX_LISTS)
    topk_merge_sorted_pass<<<Q, MERGE_NT, 0, s>>>(
        cand_vals, cand_idx, out_vals, out_idx, n_splits, Q, k);
  else
    topk_merge_pass<<<Q, MERGE_NT, 0, s>>>(cand_vals, cand_idx, out_vals,
                                           out_idx, n_splits, Q, k);
  return (int)cudaGetLastError();
}

// queries [Q, D] float32 -> q [Q, D] int8 and scales [Q] float32 (the rule
// of ops/topk.py quantize_last_axis_int8, bit for bit).
int quantize_rows_int8(const float* x, void* q, float* scales, int Q, int D,
                       void* stream) {
  if (Q < 1 || D < 1) return -1;
  quantize_rows_int8_kernel<<<Q, QUANT_NT, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<int8_t*>(q), scales, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
