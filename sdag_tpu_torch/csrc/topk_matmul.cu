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
// ~150 (bf16) queries, then the product (operations).  The tensor-core
// bodies use mma.sync fed by a three-stage cp.async ring (no wgmma or TMA
// yet); f32 corpora stay f32 on CUDA-core FMA with register-staged tiles
// (TF32 would reorder near-equal scores).  chip_smoke.py reports the times beside the
// bound.
//
// Design.  The TPU kernel folds corpus tiles into one running top-k in
// grid order; CUDA blocks run in no order, so:
//   pass 1: grid (query tile, corpus split).  A block walks its split's
//   64-row corpus tiles in ascending order.  Per tile it accumulates the
//   [BQ, 64] scores over the feature axis in 128-byte chunks staged
//   through shared memory (the ring runs on across tile boundaries, so a
//   tile's first chunk is in flight while the previous tile is scored),
//   then offers each score that beats the current
//   k-th entry to the query's sorted list in shared memory (lists live in
//   shared memory, so k up to 128 costs no registers).  A query's list is
//   touched by one warp only, and the whole warp inserts one candidate at
//   a time (topk_merge.cuh warp_topk_insert: a vote finds the position,
//   the entries behind it shift in parallel), so an insert costs the same
//   at every k and lanes do not diverge over private insert loops.  A
//   warp-wide vote skips the whole step when no score qualifies.  Lists
//   go out as [split][Q][k].
//   pass 2 (topk_merge.cuh, shared with bm25_scan_topk.cu): one block per
//   query merges the splits' lists exactly.
// Tensor-core bodies: 4 warps; warp w owns MT m16 tiles of query rows and
// all 64 corpus columns.  One k-step of mma.sync is 32 bytes of a row in
// both types (m16n8k16 bf16, m16n8k32 s8) with the same fragment layout in
// bytes, so one body serves both; only the instruction and the epilogue
// differ.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "topk_merge.cuh"

namespace {

constexpr int BN = 64;           // corpus rows per tile
constexpr int CHUNK = 128;       // bytes of a row staged per step
constexpr int RPB = CHUNK + 16;  // padded shared row, bytes
constexpr int MMA_NT = 128;
constexpr int STAGES = 3;        // cp.async ring depth

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds_u32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes global -> shared without passing through registers; src_bytes 0
// writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(unsigned char* dst,
                                           const unsigned char* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// bytes [b0, b0 + CHUNK) of rows [row0, row0 + rows) of a row-major matrix
// (row_bytes per row, a multiple of 16) into a padded shared tile, 16 bytes
// per cp.async; rows >= n_rows and bytes >= row_bytes arrive as zeros
__device__ __forceinline__ void load_chunk_async(unsigned char* dst,
                                                 const unsigned char* src,
                                                 int row0, int rows,
                                                 int n_rows, int b0,
                                                 int row_bytes, int tid,
                                                 int nt) {
  constexpr int CH = CHUNK / 16;
  for (int c = tid; c < rows * CH; c += nt) {
    const int r = c / CH, cc = c % CH, gr = row0 + r, gb = b0 + cc * 16;
    const bool in = gr < n_rows && gb < row_bytes;
    cp_async16(dst + r * RPB + cc * 16,
               in ? src + (size_t)gr * row_bytes + gb : src, in ? 16 : 0);
  }
}

template <bool INT8, int MT>
__global__ void __launch_bounds__(MMA_NT)
topk_matmul_mma(const unsigned char* __restrict__ queries,
                const unsigned char* __restrict__ corpus,
                const float* __restrict__ q_scales,
                const float* __restrict__ c_scales, float* cand_vals,
                int* cand_idx, int Q, int N, int row_bytes, int k,
                int valid_n, int tiles_per_split) {
  constexpr int BQ = 64 * MT;
  constexpr int NTK = BN / 8;
  typedef typename std::conditional<INT8, int, float>::type acc_t;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int STAGE_BYTES = (BQ + BN) * RPB;  // [BQ][RPB] Q, [BN][RPB] C
  unsigned char* ring = smem_raw;               // [STAGES][STAGE_BYTES]
  float* lv = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);
  int* li = reinterpret_cast<int*>(lv + BQ * k);  // lv, li: [BQ][k]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;

  for (int e = tid; e < BQ * k; e += MMA_NT) {
    lv[e] = -INFINITY;
    li[e] = TOPK_INT_MAX;
  }
  // this thread's query rows (tile-local): rows[2 * mt + i]
  int rows[2 * MT];
  float qs[2 * MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * (warp * MT + mt) + g + 8 * i;
      rows[2 * mt + i] = r;
      qs[2 * mt + i] = (INT8 && q0 + r < Q) ? q_scales[q0 + r] : 0.f;
    }
  __syncthreads();

  // this split's tiles that hold a valid row, times the chunks of a row:
  // one step stages one chunk of the Q tile and of one corpus tile
  const int tile_begin = split * tiles_per_split;
  const int tile_end = min(tile_begin + tiles_per_split, (valid_n + BN - 1) / BN);
  const int n_chunks = (row_bytes + CHUNK - 1) / CHUNK;
  const int n_steps = max(tile_end - tile_begin, 0) * n_chunks;
  auto stage_in = [&](int step) {
    if (step < n_steps) {
      unsigned char* st = ring + (step % STAGES) * STAGE_BYTES;
      const int b0 = (step % n_chunks) * CHUNK;
      const int n0 = (tile_begin + step / n_chunks) * BN;
      load_chunk_async(st, queries, q0, BQ, Q, b0, row_bytes, tid, MMA_NT);
      load_chunk_async(st + BQ * RPB, corpus, n0, BN, N, b0, row_bytes, tid,
                       MMA_NT);
    }
    cp_async_commit();  // one group per step from every thread, even empty
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) stage_in(st);

  acc_t acc[MT][NTK][4];
  for (int step = 0; step < n_steps; ++step) {
    const int chunk = step % n_chunks;
    const int n0 = (tile_begin + step / n_chunks) * BN;
    if (chunk == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTK; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
    }
    cp_async_wait<STAGES - 2>();  // this thread's copies of `step` landed
    __syncthreads();  // everyone's did, and step - 1's readers are done
    stage_in(step + STAGES - 1);  // into the stage step - 1 just released
    const unsigned char* sQ = ring + (step % STAGES) * STAGE_BYTES;
    const unsigned char* sC = sQ + BQ * RPB;
    {
#pragma unroll
      for (int ks = 0; ks < CHUNK / 32; ++ks) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const unsigned char* base =
              sQ + rows[2 * mt] * RPB + 32 * ks + 4 * t4;
          a[mt][0] = lds_u32(base);
          a[mt][1] = lds_u32(base + 8 * RPB);
          a[mt][2] = lds_u32(base + 16);
          a[mt][3] = lds_u32(base + 8 * RPB + 16);
        }
#pragma unroll
        for (int nt = 0; nt < NTK; ++nt) {
          const unsigned char* cb = sC + (8 * nt + g) * RPB + 32 * ks + 4 * t4;
          const uint32_t b0r = lds_u32(cb), b1r = lds_u32(cb + 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if constexpr (INT8)
              mma_s8(acc[mt][nt], a[mt], b0r, b1r);
            else
              mma_bf16(acc[mt][nt], a[mt], b0r, b1r);
          }
        }
      }
    }
    if (chunk != n_chunks - 1) continue;  // the tile's scores are not whole

    // element e of (mt, nt): row rows[2*mt + (e>>1)], corpus row
    // n0 + 8*nt + 2*t4 + (e&1)
    float sc[MT][NTK][4];
    float thr_v[2 * MT];  // each row's current k-th entry
    int thr_i[2 * MT];
#pragma unroll
    for (int x = 0; x < 2 * MT; ++x) {
      thr_v[x] = lv[rows[x] * k + k - 1];
      thr_i[x] = li[rows[x] * k + k - 1];
    }
    bool mine = false;
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
      float cs[2] = {0.f, 0.f};
      if constexpr (INT8) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n0 + 8 * nt + 2 * t4 + c;
          cs[c] = col < N ? c_scales[col] : 0.f;
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + 8 * nt + 2 * t4 + (e & 1);
          const int r = rows[2 * mt + (e >> 1)];
          float s;
          if constexpr (INT8)
            s = __fmul_rn(__fmul_rn((float)acc[mt][nt][e],
                                    qs[2 * mt + (e >> 1)]), cs[e & 1]);
          else
            s = acc[mt][nt][e];
          sc[mt][nt][e] = s;
          if (col < valid_n && q0 + r < Q &&
              better(s, col, thr_v[2 * mt + (e >> 1)],
                     thr_i[2 * mt + (e >> 1)]))
            mine = true;
        }
    }
    if (__any_sync(0xffffffffu, mine)) {
      // element by element, the warp inserts every lane's qualifying score
      // together (the thresholds in registers may lag behind this tile's
      // inserts; warp_topk_insert checks the list's current k-th entry)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTK; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n0 + 8 * nt + 2 * t4 + (e & 1);
            const int r = rows[2 * mt + (e >> 1)];
            const bool cand =
                col < valid_n && q0 + r < Q &&
                better(sc[mt][nt][e], col, thr_v[2 * mt + (e >> 1)],
                       thr_i[2 * mt + (e >> 1)]);
            unsigned m = __ballot_sync(0xffffffffu, cand);
            while (m) {
              const int src = __ffs(m) - 1;
              m &= m - 1;
              const float cs_ = __shfl_sync(0xffffffffu, sc[mt][nt][e], src);
              const int cc = __shfl_sync(0xffffffffu, col, src);
              const int cr = __shfl_sync(0xffffffffu, r, src);
              warp_topk_insert(lv + cr * k, li + cr * k, k, cs_, cc, lane);
            }
          }
    }
  }

  __syncwarp();
  // each warp writes the lists of its own 16 * MT rows
  for (int e = lane; e < 16 * MT * k; e += 32) {
    const int r = 16 * MT * warp + e / k, j = e % k;
    if (q0 + r < Q) {
      const size_t off = ((size_t)split * Q + q0 + r) * k + j;
      cand_vals[off] = lv[r * k + j];
      cand_idx[off] = li[r * k + j];
    }
  }
}

// f32 corpus: CUDA-core FMA, 256 threads; thread (ty, tx) = (tid/16,
// tid%16) owns query rows ty+16i and corpus columns tx+16j (i, j < 4).  A
// query row is shared by the 16 lanes of one half-warp, so its list is
// still touched by one warp only.
constexpr int F32_NT = 256;
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
  float* sC = sQ + BQ * F32_RP;                    // [BN][F32_RP]
  float* lv = sC + BN * F32_RP;                    // [BQ][k]
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
    const int n0 = tile * BN;
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

template <bool INT8, int MT>
int launch_mma(const void* queries, const void* corpus, const float* q_scales,
               const float* c_scales, float* cand_vals, int* cand_idx, int Q,
               int N, int row_bytes, int k, int valid_n, int n_splits,
               int tiles_per_split, cudaStream_t stream) {
  constexpr int BQ = 64 * MT;
  const size_t smem =
      (size_t)STAGES * (BQ + BN) * RPB + (size_t)BQ * k * 8;
  cudaError_t err = cudaFuncSetAttribute(
      topk_matmul_mma<INT8, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + BQ - 1) / BQ, n_splits);
  topk_matmul_mma<INT8, MT><<<grid, MMA_NT, smem, stream>>>(
      static_cast<const unsigned char*>(queries),
      static_cast<const unsigned char*>(corpus), q_scales, c_scales,
      cand_vals, cand_idx, Q, N, row_bytes, k, valid_n, tiles_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  if (code == -1) return "unsupported dtype, k or feature width";
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (queries int8 with q_scales
// [Q], corpus int8 with c_scales [N]; both null otherwise).  q_rows: query
// rows per block, 64 or 128 (128 only for bfloat16 / int8).  cand_* are
// scratch [n_splits, Q, k]; out_* are [Q, k].  Split s covers corpus tiles
// [s * tiles_per_split, (s + 1) * tiles_per_split) of 64 rows.  Returns 0
// or a CUDA error code.
int topk_matmul(const void* queries, const void* corpus,
                const float* q_scales, const float* c_scales,
                float* cand_vals, int* cand_idx, float* out_vals,
                int* out_idx, int Q, int N, int D, int k, int valid_n,
                int n_splits, int tiles_per_split, int q_rows, int dtype,
                void* stream) {
  if (k < 1 || k > TOPK_MAX_K || Q < 1 || N < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  if (dtype == 0) {
    if (q_rows != 64) return -1;
    const size_t smem = (size_t)(64 + BN) * F32_RP * 4 + (size_t)64 * k * 8;
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
    const int row_bytes = dtype == 1 ? 2 * D : D;
    if (row_bytes % 16) return -1;
#define TOPK_LAUNCH(I8, MT)                                                  \
  rc = launch_mma<I8, MT>(queries, corpus, q_scales, c_scales, cand_vals,    \
                          cand_idx, Q, N, row_bytes, k, valid_n, n_splits,   \
                          tiles_per_split, s)
    if (dtype == 1 && q_rows == 64) TOPK_LAUNCH(false, 1);
    else if (dtype == 1 && q_rows == 128) TOPK_LAUNCH(false, 2);
    else if (dtype == 2 && q_rows == 64) TOPK_LAUNCH(true, 1);
    else if (dtype == 2 && q_rows == 128) TOPK_LAUNCH(true, 2);
#undef TOPK_LAUNCH
  }
  if (rc != 0) return rc;
  topk_merge_pass<<<Q, MERGE_NT, 0, s>>>(cand_vals, cand_idx, out_vals,
                                         out_idx, n_splits, Q, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
