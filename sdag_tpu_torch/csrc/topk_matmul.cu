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
// f32 corpora stay f32 on CUDA-core FMA (topk_matmul_f32 below): 128-row
// corpus tiles against up to 128 query rows, 8 x 8 register tiles fed by
// 128-bit shared reads from double-buffered chunks, and the same epilogue
// as the tensor-core bodies (TF32 would reorder near-equal scores).

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

struct RankedEntry {
  float v;
  int i;
};

// The warp sorts one row's buffer of n entries, keeps its best k (sorted,
// at the front) and returns the k-th entry once k exist, else (-inf,
// INT_MAX): the row's new threshold, on every lane.  The row then holds
// min(n, k).  Not inlined: five inlined copies of the network (one per
// 32-column part and one at the end) read 2x slower at k = 64 than one
// shared copy.
template <int R>
__device__ __noinline__ RankedEntry compact_row_ranked(float* bv, int* bi,
                                                       int row, int n, int k,
                                                       int lane) {
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
  RankedEntry kth = {-INFINITY, TOPK_INT_MAX};
#pragma unroll
  for (int c = 0; c < R; ++c) {
    const int j = lane + 32 * c;
    if (j < k) {
      bv[row * CAP + j] = v[c];
      bi[row * CAP + j] = ix[c];
    }
    const float tv = __shfl_sync(FULL, v[c], (k - 1) & 31);
    const int ti = __shfl_sync(FULL, ix[c], (k - 1) & 31);
    if (c == ((k - 1) >> 5) && n >= k) kth = {tv, ti};
  }
  __syncwarp();
  return kth;
}

// The same, returning the threshold's score only (the tensor-core bodies
// see their tiles in ascending order, so a strict compare on the score
// keeps ties in index order).
template <int R>
__device__ __forceinline__ float compact_row(float* bv, int* bi, int row,
                                             int n, int k, int lane) {
  return compact_row_ranked<R>(bv, bi, row, n, k, lane).v;
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

// ---------------------------------------------------------------------------
// f32 corpus: topk_matmul_f32, exact float32 on CUDA-core FMA (TF32 would
// reorder near-equal scores).  What bounds it: the FMAs (2 Q N D flops at
// 67 TFLOP/s) once Q passes ~16 queries; the design keeps the FMA pipes fed.
//   grid (query tile, corpus split), 256 threads, two blocks per SM.  A
//   block's tile is BQ (128, 64 or 32: the least that covers Q) query rows
//   x 128 corpus rows; thread (ty, tx) = (tid / 16, tid % 16) holds BQ / 16
//   query rows x 8 corpus rows of scores in registers: rows ty * 4 + i
//   (+ 64) (ty * 2 + i at BQ = 32) and columns tx * 4 + j, 64 + tx * 4 + j.
//   The feature axis goes in chunks of 16 floats, stored d-major in shared
//   memory ([16][rows + 4]), so a thread's operands for one feature are
//   128-bit reads: 4 of them feed 64 FMAs at BQ = 128.  Chunks are double
//   buffered: the next chunk's 16-byte global loads (the next tile's first
//   chunk across a tile boundary) are issued before this chunk's FMAs and
//   stored transposed into the other buffer after them; one barrier a
//   chunk.  Features past D, rows past Q or valid_n read as zeros.  Each
//   score is one fmaf chain in ascending feature order.
//   Epilogue (as the tensor-core bodies', per 16 columns): a row belongs to
//   the 16 lanes of one half-warp; each row keeps its k-th best (score,
//   index) as a threshold, and a column passes when it ranks strictly
//   before it (so ties keep index order whatever order columns are seen
//   in).  Passing scores are appended to the row's buffer in shared memory
//   at slots from a ballot over the half-warp; a row over CAP - 16 entries
//   is sorted by the whole warp (warp_sort_desc), cut to k, and its
//   threshold refreshed.  Thresholds and counts live in shared memory
//   between tiles (each written by the row's own lanes only) so the
//   product loop keeps its registers.  At the end each row is sorted once
//   more and written as a sorted list for the merge pass, or straight to
//   the result when there is one split.
constexpr int F32_NT = 256;
constexpr int F32_BN = 128;    // corpus rows per tile
constexpr int F32_DK = 16;     // features per staged chunk
constexpr int F32_PART = 16;   // columns of a row appended between checks
constexpr int F32_CS = F32_BN + 4;

// shared memory of topk_matmul_f32 in 4-byte words (ops/topk.py
// _f32_smem_bytes computes the same): the two chunk buffers, the next query
// chunk as copied, the per-row threshold value / index and count, the rows'
// candidate buffers
__host__ __device__ constexpr int f32_stage_words(int bq) {
  return F32_DK * (bq + 4 + F32_CS);
}
__host__ __device__ constexpr int f32_smem_words(int bq, int cap) {
  return 2 * f32_stage_words(bq) + bq * F32_DK + 3 * bq + 2 * bq * cap;
}

template <int BQ, int R>
__global__ void __launch_bounds__(F32_NT, 2)
topk_matmul_f32(const float* __restrict__ queries,
                const float* __restrict__ corpus, float* vals_out,
                int* idx_out, int Q, int D, int k, int valid_n,
                int tiles_per_split, int direct) {
  constexpr int RM = BQ / 16;          // query rows a thread holds
  constexpr int RG = RM < 4 ? RM : 4;  // rows in one contiguous group
  constexpr int QS = BQ + 4;
  constexpr int CAP = 32 * R;
  constexpr int STAGE = f32_stage_words(BQ);
  constexpr int F4 = F32_DK / 4;       // 16-byte pieces of a row's chunk
  constexpr int QLOADS = (BQ * F4 + F32_NT - 1) / F32_NT;
  constexpr int CLOADS = F32_BN * F32_DK / 4 / F32_NT;
  extern __shared__ __align__(16) float smem_f32[];
  float* raw_q = smem_f32 + 2 * STAGE;                        // [BQ][DK]
  float* thr_v = raw_q + BQ * F32_DK;                         // [BQ]
  int* thr_i = reinterpret_cast<int*>(thr_v + BQ);            // [BQ]
  int* cnt = thr_i + BQ;                                      // [BQ]
  float* bv = reinterpret_cast<float*>(cnt + BQ);             // [BQ][CAP]
  int* bi = reinterpret_cast<int*>(bv + BQ * CAP);            // [BQ][CAP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split,
                           (valid_n + F32_BN - 1) / F32_BN);
  const int n_chunks = (D + F32_DK - 1) / F32_DK;
  const int total = tile_end > tile_begin ? (tile_end - tile_begin) * n_chunks
                                          : 0;
  // a row past Q never takes a candidate: (+inf, -1) ranks before all
  if (tid < BQ) {
    const bool ok = q0 + tid < Q;
    thr_v[tid] = ok ? -INFINITY : INFINITY;
    thr_i[tid] = ok ? TOPK_INT_MAX : -1;
    cnt[tid] = 0;
  }
  auto row_of = [&](int i) { return (i / 4) * 64 + ty * RG + (i % 4); };
  auto col_of = [&](int j) { return (j / 4) * 64 + tx * 4 + (j % 4); };

  // element e = tid + 256 u of a chunk is row e / F4, features
  // 4 (e % F4) .. + 3.  The query chunk goes to raw_q by cp.async (holding
  // it in registers across the products spilled it at 128 registers), the
  // corpus chunk to registers.
  float4 cr[CLOADS];
  auto fetch_q = [&](int c) {
    const int d = c * F32_DK;
#pragma unroll
    for (int u = 0; u < QLOADS; ++u) {
      const int e = tid + F32_NT * u;
      const int r = e / F4, f = d + 4 * (e % F4);
      if (e < BQ * F4) {
        const bool in = q0 + r < Q && f < D;
        cp_async16(smem_u32(raw_q + 4 * e),
                   in ? queries + (size_t)(q0 + r) * D + f : queries,
                   in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  auto fetch_c = [&](int tile, int c) {
    const int d = c * F32_DK;
#pragma unroll
    for (int u = 0; u < CLOADS; ++u) {
      const int e = tid + F32_NT * u;
      const int r = e / F4, f = d + 4 * (e % F4), n = tile * F32_BN + r;
      cr[u] = (n < valid_n && f < D)
          ? __ldg(reinterpret_cast<const float4*>(corpus + (size_t)n * D + f))
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // registers -> buffer, transposed to [feature][row]
  auto stage_q = [&](int buf) {
    float* sq = smem_f32 + buf * STAGE;
    cp_async_wait<0>();  // this thread's copies; it reads only those
#pragma unroll
    for (int u = 0; u < QLOADS; ++u) {
      const int e = tid + F32_NT * u;
      if (e < BQ * F4) {
        const int r = e / F4, f = 4 * (e % F4);
        const float4 t = *reinterpret_cast<const float4*>(raw_q + 4 * e);
        sq[(f + 0) * QS + r] = t.x;
        sq[(f + 1) * QS + r] = t.y;
        sq[(f + 2) * QS + r] = t.z;
        sq[(f + 3) * QS + r] = t.w;
      }
    }
  };
  auto stage_c = [&](int buf) {
    float* sc = smem_f32 + buf * STAGE + F32_DK * QS;
#pragma unroll
    for (int u = 0; u < CLOADS; ++u) {
      const int e = tid + F32_NT * u;
      const int r = e / F4, f = 4 * (e % F4);
      sc[(f + 0) * F32_CS + r] = cr[u].x;
      sc[(f + 1) * F32_CS + r] = cr[u].y;
      sc[(f + 2) * F32_CS + r] = cr[u].z;
      sc[(f + 3) * F32_CS + r] = cr[u].w;
    }
  };

  float acc[RM][8];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (total > 0) {
    fetch_q(0);
    fetch_c(tile_begin, 0);
    stage_q(0);
    stage_c(0);
  }
  __syncthreads();

  int tile = tile_begin, c = 0;
  for (int it = 0; it < total; ++it) {
    const bool last_chunk = c == n_chunks - 1;
    const bool has_next = it + 1 < total;
    const int nt = last_chunk ? tile + 1 : tile, nc = last_chunk ? 0 : c + 1;
    const float* sq = smem_f32 + (it & 1) * STAGE;
    const float* sc = sq + F32_DK * QS;
    if (has_next) {
      fetch_q(nc);
      fetch_c(nt, nc);
    }
#pragma unroll
    for (int d = 0; d < F32_DK; ++d) {
      float a[RM], b[8];
      if constexpr (RM == 2) {
        const float2 t = *reinterpret_cast<const float2*>(sq + d * QS + ty * 2);
        a[0] = t.x;
        a[1] = t.y;
      } else {
#pragma unroll
        for (int g = 0; g < RM / 4; ++g) {
          const float4 t = *reinterpret_cast<const float4*>(
              sq + d * QS + g * 64 + ty * 4);
          a[4 * g] = t.x;
          a[4 * g + 1] = t.y;
          a[4 * g + 2] = t.z;
          a[4 * g + 3] = t.w;
        }
      }
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 t = *reinterpret_cast<const float4*>(
            sc + d * F32_CS + g * 64 + tx * 4);
        b[4 * g] = t.x;
        b[4 * g + 1] = t.y;
        b[4 * g + 2] = t.z;
        b[4 * g + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (has_next) {
      stage_q((it + 1) & 1);
      stage_c((it + 1) & 1);
    }
    __syncthreads();
    if (!last_chunk) {
      ++c;
      continue;
    }

    // ---- epilogue of corpus tile `tile`: this warp's 2 x RM rows, one
    // row of each half-warp at a time (few registers beside the scores) ----
    const int n0 = tile * F32_BN;
    const unsigned below = (1u << (lane & 15)) - 1u;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = row_of(i);
      float tv = thr_v[row];
      int ti = thr_i[row], cn = cnt[row];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + col_of(j);
        const bool pass = col < valid_n && better(acc[i][j], col, tv, ti);
        const unsigned votes = __ballot_sync(FULL, pass);
        if (!votes) continue;
        const unsigned half = (votes >> (lane & 16)) & 0xffffu;
        if (pass) {
          const int slot = cn + __popc(half & below);
          bv[row * CAP + slot] = acc[i][j];
          bi[row * CAP + slot] = col;
        }
        cn += __popc(half);
        __syncwarp();
        // a row over the mark (bit 0: the lower half-warp's, bit 16: the
        // upper's); a row holds <= CAP - F32_PART entries before a part
        unsigned need = __ballot_sync(FULL, cn > CAP - F32_PART) & 0x00010001u;
        while (need) {
          const int src = __ffs(need) - 1;
          need &= need - 1;
          const int n = __shfl_sync(FULL, cn, src);
          const int r = (i / 4) * 64 + ((ty & ~1) | (src >> 4)) * RG + i % 4;
          const RankedEntry t = compact_row_ranked<R>(bv, bi, r, n, k, lane);
          if ((lane & 16) == src) {
            cn = min(n, k);
            tv = t.v;
            ti = t.i;
          }
        }
      }
      if (tx == 0) {
        thr_v[row] = tv;
        thr_i[row] = ti;
        cnt[row] = cn;
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    ++tile;
    c = 0;
  }

  // each warp sorts and writes the lists of its own rows
  __syncthreads();  // the row state initialised by other warps is visible
  const int warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    for (int h = 0; h < 2; ++h) {
      const int row = (i / 4) * 64 + (2 * warp + h) * RG + i % 4;
      const int n = cnt[row];
      if (q0 + row >= Q) continue;
      compact_row_ranked<R>(bv, bi, row, n, k, lane);
      const size_t off = ((size_t)blockIdx.y * Q + q0 + row) * k;
      for (int j = lane; j < k; j += 32) {
        const int ix = j < n ? bi[row * CAP + j] : TOPK_INT_MAX;
        vals_out[off + j] = j < n ? bv[row * CAP + j] : -INFINITY;
        idx_out[off + j] = (direct && ix == TOPK_INT_MAX) ? -1 : ix;
      }
    }
  }
}

template <int BQ, int R>
int launch_f32(const float* queries, const float* corpus, float* vals_out,
               int* idx_out, int Q, int D, int k, int valid_n, int n_splits,
               int tiles_per_split, int direct, cudaStream_t stream) {
  constexpr int smem = 4 * f32_smem_words(BQ, 32 * R);
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        topk_matmul_f32<BQ, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid((Q + BQ - 1) / BQ, n_splits);
  topk_matmul_f32<BQ, R><<<grid, F32_NT, smem, stream>>>(
      queries, corpus, vals_out, idx_out, Q, D, k, valid_n, tiles_per_split,
      direct);
  return (int)cudaGetLastError();
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
// scratch [n_splits, Q, k] (unused with one split, which writes out_*
// itself); out_* are [Q, k].  Split s covers corpus tiles
// [s * tiles_per_split, (s + 1) * tiles_per_split) of 128 rows.  q_rows
// (query rows a block), cap (entries of a row's candidate buffer) and
// stages come from ops/topk.py: topk_mma_geometry for the tensor-core
// bodies (q_rows 64 or 128; cap 64, 128 or 256, at least k + 32),
// topk_f32_geometry for float32 (q_rows 32, 64 or 128; cap at least
// k + 16; stages unused).  Returns 0, a CUDA error code, or a negative
// code of kernel_error_string.
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
    if (D % 4 || cap < k + F32_PART) return -1;
    const int direct = n_splits == 1;
    const float* qf = static_cast<const float*>(queries);
    const float* cf = static_cast<const float*>(corpus);
    float* vals = direct ? out_vals : cand_vals;
    int* idx = direct ? out_idx : cand_idx;
#define TOPK_F32(BQ, R)                                                      \
  rc = launch_f32<BQ, R>(qf, cf, vals, idx, Q, D, k, valid_n, n_splits,      \
                         tiles_per_split, direct, s)
    if (q_rows == 128 && cap == 64) TOPK_F32(128, 2);
    else if (q_rows == 64 && cap == 64) TOPK_F32(64, 2);
    else if (q_rows == 64 && cap == 128) TOPK_F32(64, 4);
    else if (q_rows == 32 && cap == 64) TOPK_F32(32, 2);
    else if (q_rows == 32 && cap == 128) TOPK_F32(32, 4);
    else if (q_rows == 32 && cap == 256) TOPK_F32(32, 8);
#undef TOPK_F32
    if (rc != 0 || direct) return rc;
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
