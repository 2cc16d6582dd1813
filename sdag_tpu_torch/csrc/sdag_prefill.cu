// Kernel K1: SDAG block-sparse prefill attention for Hopper (sm_90a).
//
// Replaces the four Pallas schedules of sdag_tpu/ops/attention.py that
// compute one function: sdag_flash_attention (_flash_kernel), the
// KV-resident sdag_flash_attention_kvres (the main-path default), its
// worklist body _kvres_worklist_call, and sdag_splash_attention
// (_splash_kernel, the long-L schedule).  On the TPU the schedule split
// came from VMEM capacity; here one kernel walks a per-(batch, q-tile)
// list of live key tiles, so SKIP tiles cost neither bytes nor flops at
// every length.
//
// What bounds it: at the main path's prompts (640 tokens, document
// isolation) the live area is small and the bound is bytes (q, k, v and the
// output once); at long L it is operations (two Lq x Lk x Dh products per
// head over the live tiles).  chip_smoke.py reports the times beside the
// bound.
//
// Both bodies read the same plan (ops/attention.py k1_plan): per (batch,
// q-tile) the live key tiles with their kinds, the (batch, q-tile) pairs
// heaviest first, and a PARTIAL tile's mask as 64 x 64 bits.  A PARTIAL
// tile's mask depends on neither the layer nor the head, so the plan
// evaluates the token rule once per prefill and the kernels only test bits
// (evaluating the rule in the kernel took 3x the whole softmax of a tile,
// and 63% of the main path's live tiles are PARTIAL).  Tile kinds: FULL ->
// no mask; CAUSAL -> j<=i & j<vl & i<vl; PARTIAL -> the bits.  Softmax runs
// in f32 in the exp2 domain (scale * log2 e folded into one multiply).  A
// row that sees no key outputs 0 (l == 0 -> divide by 1).
//
// bf16 inputs (the serving path), sdag_prefill_wgmma_kernel: persistent
// blocks, one per SM, each walking work items (batch, q-tile, kv head, pair
// of q heads) in the plan's heavy-first order.  One producer thread loads by
// TMA (hopper_async.cuh): the item's Q tiles and metadata into a double
// buffer, and each live K and V tile once for the two q heads, with a
// PARTIAL tile's mask bits beside them, into a 4-stage ring guarded by
// mbarriers.  Two consumer warpgroups, one per q head, compute S = Q.K^T
// with wgmma from shared memory (m64n64k16), apply the mask, run the online
// softmax, and feed P, rounded to bf16, from registers into the wgmma for
// P.V (V read MN-major from its row-major tile).  The loop is
// software-pipelined: the next tile's scores are issued before this tile's
// P.V, so its mask and softmax run while the tensor cores work on P.V; the
// warpgroups are not tied to each other, so one's softmax also overlaps the
// other's products.  A GQA group of odd size runs one warpgroup per block.
// An item's output tile is staged in its Q tile (free by then) and leaves
// as whole rows in 16-byte stores.
//
// f32 inputs stay f32 end to end on CUDA-core FMA (sdag_prefill_f32_kernel),
// which is what keeps them within 1e-4 of the f32 reference.  What bounds
// it: the two products' FMAs over the live tiles.
//   One block per work item (batch, q-tile, kv head, one or two q heads of
//   its group: 256 threads a q head), the items numbered in the plan's
//   heavy-first order: blocks go out in index order, so the heaviest
//   q-tiles start first and the light ones fill in behind them (in index
//   order the same shape reads 1.35x slower).  All threads copy the live K/V
//   tiles (and a PARTIAL tile's mask bits) with 16-byte cp.async into a
//   ring of 3 (Dh 32) or 2 stages, a tile or two ahead of the products: one
//   barrier a tile.  Thread (ty, tx) = (tid / 16, tid % 16) of a q head
//   holds rows ty + 16 i (i < 4) and keys 4 tx + j of the score tile, and
//   dims 2 tx (Dh 32) or 4 tx + 64 g of the output.  Q.K^T reads Q and K
//   rows as 128-bit words (16 FMAs a read); K and V rows are stored with
//   their 16-byte chunks swizzled, so the four key rows of a thread and the
//   rows of its neighbours fall on distinct banks.  S stays in registers; P
//   goes to shared memory as one float4 per row and is read back by the
//   same half-warp (no block barrier) as float4s of four keys for P.V.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int KIND_FULL = 1;
constexpr int KIND_PARTIAL = 2;
constexpr int KIND_CAUSAL = 3;

// ---------------------------------------------------------------------------
// f32 inputs: sdag_prefill_f32_kernel, exact float32 on CUDA-core FMA (what
// keeps them within 1e-4 of the f32 reference; TF32 would not).
constexpr unsigned ALL_LANES = 0xffffffffu;

// Shared-memory layout in 4-byte words: the item's Q tiles (one per q head
// of the block), a ring of K/V tile pairs, the P tiles, a PARTIAL tile's
// mask bits per ring stage.  K and V rows hold their 16-byte chunks at
// chunk c ^ ((row / 4) % 8), so the 128-bit reads of four consecutive key
// rows (Q.K^T) or of one row (P.V) fall on distinct banks.
template <int DH, int NH>
struct F32Layout {
  static constexpr int STAGES = DH == 32 ? 3 : 2;
  static constexpr int TILE = BK * DH;
  static constexpr int PS = BK + 4;  // P row stride
  static constexpr int q = 0;                            // [NH][BQ][DH]
  static constexpr int kv = q + NH * BQ * DH;            // [STAGES][K, V]
  static constexpr int p = kv + STAGES * 2 * TILE;       // [NH][BQ][PS]
  static constexpr int mask = p + NH * BQ * PS;          // [STAGES][BQ][2]
  static constexpr int words = mask + STAGES * BQ * (BK / 32);
};

// two blocks an SM where their shared memory fits (Dh 32, 64), one else
// two blocks an SM where their shared memory fits (Dh 32, 64), else one (a
// third block at Dh 32 forces 80 registers and read slower)
template <int DH, int NH>
__global__ void __launch_bounds__(NT * NH, NH == 1 && DH <= 64 ? 2 : 1)
sdag_prefill_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        const int* __restrict__ mask_bits,
                        const int* __restrict__ mask_slot,
                        const int* __restrict__ vl_b,
                        const int* __restrict__ qoff_b,
                        const int* __restrict__ counts,
                        const int* __restrict__ kv_list,
                        const int* __restrict__ kind_list,
                        const int* __restrict__ order, int Hq, int Hkv, int Lq,
                        int Lk, int nq_tiles, int nk_tiles, float scale_log2) {
  typedef F32Layout<DH, NH> L;
  constexpr int S = L::STAGES;
  constexpr int C4 = DH / 4;    // 16-byte chunks of a row
  constexpr int DJ = DH / 16;   // output dims per thread and row
  extern __shared__ __align__(16) float smem_f[];

  const int tid = threadIdx.x;
  const int hs = tid >> 8;      // the block's q head this thread serves
  const int lt = tid & 255;
  const int ty = lt >> 4;       // rows ty + 16 i
  const int tx = lt & 15;       // keys 4 tx + j of a tile; dims of 4 tx
  const int group = Hq / Hkv;
  const int chunks = group / NH;
  const int per_pair = Hkv * chunks;
  const int pair = order[blockIdx.x / per_pair];
  const int rem = blockIdx.x % per_pair;
  const int b = pair / nq_tiles, qt = pair % nq_tiles;
  const int kvh = rem / chunks;
  const int h0 = kvh * group + (rem % chunks) * NH;
  const int q0 = qt * BQ;
  const int cnt = counts[pair];
  const int vl = vl_b[b];
  const int qoff = qoff_b[b];
  const size_t list_off = (size_t)pair * nk_tiles;
  const float* kp = k + (size_t)(b * Hkv + kvh) * Lk * DH;
  const float* vp = v + (size_t)(b * Hkv + kvh) * Lk * DH;

  // the block's Q tiles (rows past Lq as zeros), with the first K/V tile
  for (int e = tid; e < NH * BQ * C4; e += NT * NH) {
    const int w = e / (BQ * C4), r = (e / C4) % BQ, c = e % C4;
    const bool in = q0 + r < Lq;
    const float* src =
        q + ((size_t)(b * Hq + h0 + w) * Lq + (in ? q0 + r : 0)) * DH + 4 * c;
    cp_async16(smem_u32(smem_f + L::q + (w * BQ + r) * DH + 4 * c), src,
               in ? 16 : 0);
  }
  // live tile t into ring stage st: K, V (rows past Lk as zeros) and, for a
  // PARTIAL tile, its 64 x 64 mask bits
  auto load_tile = [&](int t, int st) {
    const int k0 = kv_list[list_off + t] * BK;
    float* dst = smem_f + L::kv + st * 2 * L::TILE;
    for (int e = tid; e < 2 * BK * C4; e += NT * NH) {
      const int w = e / (BK * C4), r = (e / C4) % BK, c = e % C4;
      const bool in = k0 + r < Lk;
      const float* src = (w ? vp : kp) + (size_t)(in ? k0 + r : 0) * DH + 4 * c;
      cp_async16(smem_u32(dst + w * L::TILE + r * DH + 4 * (c ^ ((r >> 2) & 7))),
                 src, in ? 16 : 0);
    }
    if (kind_list[list_off + t] == KIND_PARTIAL && tid < BQ * (BK / 32) / 4) {
      const int slot = mask_slot[list_off + t];
      cp_async16(smem_u32(smem_f + L::mask + st * BQ * (BK / 32) + 4 * tid),
                 mask_bits + (size_t)slot * BQ * (BK / 32) + 4 * tid, 16);
    }
  };
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < cnt) load_tile(st, st);
    cp_async_commit();
  }

  int row_i[4];
  float m_i[4], l_i[4], o[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_i[i] = qoff + q0 + ty + 16 * i;
    m_i[i] = -INFINITY;  // in the exp2 domain
    l_i[i] = 0.f;        // this thread's part of the row sum
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) o[i][jj] = 0.f;
  }
  const float* sQ = smem_f + L::q + hs * BQ * DH;
  float* sP = smem_f + L::p + hs * BQ * L::PS;
  const int ksw = tx & 7;  // the swizzle of key rows 4 tx .. 4 tx + 3

  for (int t = 0; t < cnt; ++t) {
    cp_async_wait<S - 2>();  // tile t (and the Q tiles) have landed
    __syncthreads();         // for every thread; tile t - 1's stage is free
    if (t + S - 1 < cnt) load_tile(t + S - 1, (t + S - 1) % S);
    cp_async_commit();
    const int st = t % S;
    const int kind = kind_list[list_off + t];
    const int k0 = kv_list[list_off + t] * BK;
    const float* sK = smem_f + L::kv + st * 2 * L::TILE;
    const float* sV = sK + L::TILE;

    // S = Q . K^T: rows ty + 16 i, keys 4 tx + j; one fmaf chain per score
    // in ascending d
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    // (unrolled by 4, not fully: a full unroll spills at 128 registers)
#pragma unroll 4
    for (int c = 0; c < C4; ++c) {
      float4 qv[4], kv4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * DH +
                                                 4 * c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv4[j] = *reinterpret_cast<const float4*>(sK + (4 * tx + j) * DH +
                                                  4 * (c ^ ksw));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv4[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv4[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv4[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv4[j].w, s[i][j]);
        }
    }

    // mask, online softmax in the exp2 domain (scale * log2 e folded into
    // one multiply); P goes to shared memory as one float4 per row
    __syncwarp();  // this warp's reads of the previous P are done
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned bits = 0xfu;
      if (kind == KIND_CAUSAL) {
        bits = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + 4 * tx + j;
          bits |= (unsigned)(col <= row_i[i] && col < vl && row_i[i] < vl) << j;
        }
      } else if (kind == KIND_PARTIAL) {
        // bit c of row r's two words is key k0 + c
        const unsigned w = reinterpret_cast<const unsigned*>(
            smem_f + L::mask)[st * BQ * (BK / 32) + (ty + 16 * i) * 2 +
                              (tx >> 3)];
        bits = (w >> (4 * (tx & 7))) & 0xfu;
      }
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (bits >> j) & 1u ? s[i][j] * scale_log2 : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(ALL_LANES, mt, off));
      const float m_new = fmaxf(m_i[i], mt);
      // rows with no visible key so far keep m = -inf: guard the shift
      const float safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = (m_i[i] == -INFINITY) ? 0.f : exp2f(m_i[i] - safe);
      m_i[i] = m_new;
      float4 p4;
      p4.x = exp2f(s[i][0] - safe);  // masked: exp2(-inf) == 0
      p4.y = exp2f(s[i][1] - safe);
      p4.z = exp2f(s[i][2] - safe);
      p4.w = exp2f(s[i][3] - safe);
      l_i[i] = l_i[i] * alpha + ((p4.x + p4.y) + (p4.z + p4.w));
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) o[i][jj] *= alpha;
      *reinterpret_cast<float4*>(sP + (ty + 16 * i) * L::PS + 4 * tx) = p4;
    }
    __syncwarp();  // a row's P is written and read by its own half-warp

    // O += P . V: dims 2 tx (Dh 32) or 4 tx + 64 g; V row c's chunks are
    // swizzled by (c / 4) % 8
#pragma unroll 4
    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * L::PS +
                                                 c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = sV + (c + e) * DH;
        const int vsw = ((c + e) >> 2) & 7;
        float vv[DJ];
        if constexpr (DH == 32) {
          const float2 t2 = *reinterpret_cast<const float2*>(
              vr + 4 * ((tx >> 1) ^ vsw) + 2 * (tx & 1));
          vv[0] = t2.x;
          vv[1] = t2.y;
        } else {
#pragma unroll
          for (int g = 0; g < DH / 64; ++g) {
            const float4 t4 = *reinterpret_cast<const float4*>(
                vr + 4 * ((tx + 16 * g) ^ vsw));
            vv[4 * g] = t4.x;
            vv[4 * g + 1] = t4.y;
            vv[4 * g + 2] = t4.z;
            vv[4 * g + 3] = t4.w;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pe = e == 0 ? pv[i].x : e == 1 ? pv[i].y
                         : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int jj = 0; jj < DJ; ++jj) o[i][jj] = fmaf(pe, vv[jj], o[i][jj]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // a row that sees no key outputs 0
  float* op = out + (size_t)(b * Hq + h0 + hs) * Lq * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l_i[i] += __shfl_xor_sync(ALL_LANES, l_i[i], off);
    const int r = q0 + ty + 16 * i;
    if (r >= Lq) continue;
    const float inv = (l_i[i] == 0.f) ? 1.f : 1.f / l_i[i];
    float* orow = op + (size_t)r * DH;
    if constexpr (DH == 32) {
      *reinterpret_cast<float2*>(orow + 2 * tx) =
          make_float2(o[i][0] * inv, o[i][1] * inv);
    } else {
#pragma unroll
      for (int g = 0; g < DH / 64; ++g)
        *reinterpret_cast<float4*>(orow + 64 * g + 4 * tx) =
            make_float4(o[i][4 * g] * inv, o[i][4 * g + 1] * inv,
                        o[i][4 * g + 2] * inv, o[i][4 * g + 3] * inv);
    }
  }
}

template <int DH, int NH>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               const int* mask_bits, const int* mask_slot, const int* vl,
               const int* qoff, const int* counts, const int* kv_list,
               const int* kind_list, const int* order, int B, int Hq, int Hkv,
               int Lq, int Lk, int nq_tiles, int nk_tiles, float scale,
               cudaStream_t stream) {
  constexpr int smem = 4 * F32Layout<DH, NH>::words;
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        sdag_prefill_f32_kernel<DH, NH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int n_items = B * nq_tiles * Hkv * ((Hq / Hkv) / NH);
  sdag_prefill_f32_kernel<DH, NH><<<n_items, NT * NH, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), mask_bits,
      mask_slot, vl, qoff, counts, kv_list, kind_list, order, Hq, Hkv, Lq, Lk,
      nq_tiles, nk_tiles, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 inputs: sdag_prefill_wgmma_kernel, warp-specialised on wgmma + TMA
// (hopper_async.cuh).  See the header comment for the design.
typedef __nv_bfloat16 bf16;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int KV_STAGES = 4;   // ring of K/V tiles
constexpr int Q_BUFS = 2;      // an item's Q tiles, double-buffered

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// Shared-memory layout from a 1024-aligned base.
constexpr int ITEM_WORDS = 8;  // b, q-tile, live tiles, first q head, vl,
                               // q_offset, unused
constexpr int MASK_TILE_BYTES = BQ * (BK / 32) * 4;
template <int DH, int NWG>
struct WgmmaLayout {
  static constexpr int TILE = TileGeom<DH>::TILE_BYTES;
  static constexpr int q = 0;                            // [Q_BUFS][NWG] tiles
  static constexpr int kv = q + Q_BUFS * NWG * TILE;     // [KV_STAGES][K, V]
  // a PARTIAL tile's mask, one bit per (row, key): [KV_STAGES][64][2] words
  static constexpr int mask = kv + KV_STAGES * 2 * TILE;
  static constexpr int item = mask + KV_STAGES * MASK_TILE_BYTES;  // [Q_BUFS][8]
  static constexpr int meta = item + Q_BUFS * ITEM_WORDS * 4;  // [STAGES][2]
  static constexpr int bars = meta + KV_STAGES * 8;
  // kv_full, kv_empty [KV_STAGES]; q_full, q_empty [Q_BUFS]
  static constexpr int total = bars + (2 * KV_STAGES + 2 * Q_BUFS) * 8;
};

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DH == 128) wgmma_m64n128k16_bf16_rs_tb(o, a, db, 1);
  else if constexpr (DH == 64) wgmma_m64n64k16_bf16_rs_tb(o, a, db, 1);
  else wgmma_m64n32k16_bf16_rs_tb(o, a, db, 1);
}

template <int DH, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
sdag_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          bf16* __restrict__ out,
                          const int* __restrict__ mask_bits,
                          const int* __restrict__ mask_slot,
                          const int* __restrict__ vl_b,
                          const int* __restrict__ qoff_b,
                          const int* __restrict__ counts,
                          const int* __restrict__ kv_list,
                          const int* __restrict__ kind_list,
                          const int* __restrict__ order, int Hq, int Hkv,
                          int Lq, int nq_tiles, int nk_tiles, int n_items,
                          float scale_log2) {
  typedef TileGeom<DH> T;
  typedef WgmmaLayout<DH, NWG> L;
  constexpr int KS = DH / 16;  // k-steps of Q.K^T over the head dim
  constexpr int NTK = BK / 8;  // 8-column groups of the score tile
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t q_s = smem_u32(smem + L::q);
  const uint32_t kv_s = smem_u32(smem + L::kv);
  const unsigned* s_mask = reinterpret_cast<const unsigned*>(smem + L::mask);
  int* s_item = reinterpret_cast<int*>(smem + L::item);
  int* s_meta = reinterpret_cast<int*>(smem + L::meta);
  const uint32_t bars = smem_u32(smem + L::bars);
  const uint32_t kv_full = bars, kv_empty = bars + 8 * KV_STAGES;
  const uint32_t q_full = bars + 16 * KV_STAGES;
  const uint32_t q_empty = q_full + 8 * Q_BUFS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(kv_full + 8 * s, 1);         // the producer's expect_tx
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
    // ---- producer: one thread feeds the items' Q tiles and metadata and
    // the K/V ring; what it stores with plain writes is released to the
    // consumers by the arrive that follows ----
    if (lane != 0) return;
    const int group = Hq / Hkv;
    const int chunks = group / NWG;     // head chunks of a kv head
    const int per_tile = Hkv * chunks;  // items per (batch, q-tile)
    int s = 0, qb = 0;
    uint32_t ph = 0, qph = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int bq = order[item / per_tile];
      const int rem = item % per_tile;
      const int b = bq / nq_tiles, qt = bq % nq_tiles;
      const int kvh = rem / chunks;
      const int h0 = kvh * group + (rem % chunks) * NWG;
      const int cnt = counts[(size_t)b * nq_tiles + qt];
      const int vl = vl_b[b], qoff = qoff_b[b];
      mbar_wait(q_empty + 8 * qb, qph ^ 1);
      int* it = s_item + qb * ITEM_WORDS;
      it[0] = b;
      it[1] = qt;
      it[2] = cnt;
      it[3] = h0;
      it[4] = vl;
      it[5] = qoff;
      const uint32_t full_q = q_full + 8 * qb;
      mbar_arrive_expect_tx(full_q, NWG * T::TILE_BYTES);
      for (int w = 0; w < NWG; ++w)
        for (int p = 0; p < T::NP; ++p)
          tma_load_3d(q_s + (qb * NWG + w) * T::TILE_BYTES + p * T::PANEL_BYTES,
                      &q_map, full_q, p * T::PW, qt * BQ, b * Hq + h0 + w);
      if (++qb == Q_BUFS) {
        qb = 0;
        qph ^= 1;
      }
      const size_t list_off = ((size_t)b * nq_tiles + qt) * nk_tiles;
      for (int t = 0; t < cnt; ++t) {
        const int kt = kv_list[list_off + t];
        const int kind = kind_list[list_off + t];
        // a PARTIAL tile's mask bits travel with it
        const int slot = kind == KIND_PARTIAL ? mask_slot[list_off + t] : -1;
        mbar_wait(kv_empty + 8 * s, ph ^ 1);
        s_meta[2 * s] = kind;
        s_meta[2 * s + 1] = kt * BK;
        const uint32_t full = kv_full + 8 * s;
        mbar_arrive_expect_tx(
            full, 2 * T::TILE_BYTES + (slot >= 0 ? MASK_TILE_BYTES : 0));
        const uint32_t kdst = kv_s + s * 2 * T::TILE_BYTES;
        for (int p = 0; p < T::NP; ++p) {
          tma_load_3d(kdst + p * T::PANEL_BYTES, &k_map, full, p * T::PW,
                      kt * BK, b * Hkv + kvh);
          tma_load_3d(kdst + T::TILE_BYTES + p * T::PANEL_BYTES, &v_map, full,
                      p * T::PW, kt * BK, b * Hkv + kvh);
        }
        if (slot >= 0)
          bulk_load(smem_u32(smem + L::mask) + s * MASK_TILE_BYTES,
                    mask_bits + (size_t)slot * (MASK_TILE_BYTES / 4),
                    MASK_TILE_BYTES, full);
        if (++s == KV_STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup w serves q head h0 + w of the item ----
  const int wg = warp >> 2;
  const int g = lane >> 2;   // fragment row group
  const int t4 = lane & 3;   // fragment column pair
  const int wr = 16 * (warp & 3) + g;  // this thread's rows: wr and wr + 8
  int s = 0, qb = 0;
  uint32_t ph = 0, qph = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    mbar_wait(q_full + 8 * qb, qph);
    const int* it = s_item + qb * ITEM_WORDS;
    const int b = it[0], q0 = it[1] * BQ, cnt = it[2], h = it[3] + wg;
    const int vl = it[4], qoff = it[5];
    int row_i[2];
    bool row_ok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      row_i[i] = qoff + q0 + wr + 8 * i;
      row_ok[i] = row_i[i] < vl;
    }
    float o[DH / 2];
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) o[e] = 0.f;
    float m_i[2] = {-INFINITY, -INFINITY};  // in the exp2 domain
    float l_i[2] = {0.f, 0.f};              // per-thread partial row sums
    const uint32_t q_tile = q_s + (qb * NWG + wg) * T::TILE_BYTES;
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];
    float alpha[2];

    // S = Q . K^T of the tile in stage st: both operands K-major (the head
    // dim contiguous); one wgmma group
    auto issue_scores = [&](int st) {
      const uint32_t k_tile = kv_s + st * 2 * T::TILE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int off = (ks * 16 / T::PW) * T::PANEL_BYTES +
                        (ks * 16 % T::PW) * 2;
        wgmma_m64n64k16_bf16(sc, smem_desc(q_tile + off, T::SW, 8 * T::SW, 0),
                             smem_desc(k_tile + off, T::SW, 8 * T::SW, 0),
                             ks != 0);
      }
      wgmma_commit();
    };

    // sc[4 * nt + e] (row wr + 8 * (e >> 1), key k0 + 8 * nt + 2 * t4 +
    // (e & 1)) from scores to unnormalised probabilities: mask, exp2
    // domain with one multiply, online max and sum; alpha is the factor
    // the running output must shrink by before this tile is added
    auto scores_to_probs = [&](int st) {
      const int kind = s_meta[2 * st];
      const int k0 = s_meta[2 * st + 1];
      float mt[2] = {-INFINITY, -INFINITY};
      if (kind == KIND_FULL) {
#pragma unroll
        for (int x = 0; x < BK / 2; ++x) {
          sc[x] *= scale_log2;
          mt[(x >> 1) & 1] = fmaxf(mt[(x >> 1) & 1], sc[x]);
        }
      } else if (kind == KIND_CAUSAL) {
#pragma unroll
        for (int x = 0; x < BK / 2; ++x) {
          const int i = (x >> 1) & 1;
          const int col = k0 + 8 * (x >> 2) + 2 * t4 + (x & 1);
          const bool vis = col <= row_i[i] && col < vl && row_ok[i];
          sc[x] = vis ? sc[x] * scale_log2 : -INFINITY;
          mt[i] = fmaxf(mt[i], sc[x]);
        }
      } else {
        // PARTIAL: the token rule was evaluated once for the whole prefill
        // (ops/attention.py k1_plan: every layer and head shares it); bit
        // c of row r's two words is key k0 + c
        unsigned w[2][BK / 32];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint2 m2 = *reinterpret_cast<const uint2*>(
              s_mask + st * (MASK_TILE_BYTES / 4) + 2 * (wr + 8 * i));
          w[i][0] = m2.x >> (2 * t4);
          w[i][1] = m2.y >> (2 * t4);
        }
#pragma unroll
        for (int x = 0; x < BK / 2; ++x) {
          const int i = (x >> 1) & 1;
          const int nt = x >> 2;
          const bool vis = (w[i][nt >> 2] >> (8 * (nt & 3) + (x & 1))) & 1u;
          sc[x] = vis ? sc[x] * scale_log2 : -INFINITY;
          mt[i] = fmaxf(mt[i], sc[x]);
        }
      }
      float safe[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(FULL_MASK, mt[i], 1));
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(FULL_MASK, mt[i], 2));
        const float m_new = fmaxf(m_i[i], mt[i]);
        // rows with no visible key so far keep m = -inf: guard the shift
        safe[i] = (m_new == -INFINITY) ? 0.f : m_new;
        alpha[i] = (m_i[i] == -INFINITY) ? 0.f : exp2f(m_i[i] - safe[i]);
        m_i[i] = m_new;
      }
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) {
        sc[x] = exp2f(sc[x] - safe[(x >> 1) & 1]);  // masked: exp2(-inf) = 0
        ls[(x >> 1) & 1] += sc[x];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_i[i] = l_i[i] * alpha[i] + ls[i];
    };

    // P, rounded to bf16, is the A operand of P.V: the score fragment of
    // k-step j (keys 16 j .. 16 j + 15) is the m16k16 A fragment
    auto pack_probs = [&]() {
#pragma unroll
      for (int nt = 0; nt < NTK; ++nt) {
        pa[nt >> 1][2 * (nt & 1)] = pack_bf16(sc[4 * nt], sc[4 * nt + 1]);
        pa[nt >> 1][2 * (nt & 1) + 1] =
            pack_bf16(sc[4 * nt + 2], sc[4 * nt + 3]);
      }
      // the reads of sc end here: the next tile's scores, issued right
      // after, overwrite it while they run
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wgmma_pin(pa[j]);
    };

    // Software pipeline over the live tiles: while P.V of tile t runs on
    // the tensor cores, the scores of tile t + 1 (issued just before it)
    // complete and go through mask and softmax.
    if (cnt > 0) {
      mbar_wait(kv_full + 8 * s, ph);
      issue_scores(s);
      wgmma_wait<0>();
      wgmma_pin(sc);
      scores_to_probs(s);
      pack_probs();
    }
    // O += P . V of the tile in stage st: V is [key][dh], i.e. B with its
    // N axis contiguous (MN-major): 8-key groups 8 * SW bytes apart, panels
    // of PW dims PANEL_BYTES apart; a k-step is 16 keys; one wgmma group
    auto issue_pv = [&](int st) {
      const uint32_t v_tile = kv_s + st * 2 * T::TILE_BYTES + T::TILE_BYTES;
      wgmma_pin(o);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wgmma_pv<DH>(o, pa[j],
                     smem_desc(v_tile + j * 16 * T::SW, T::SW, 8 * T::SW,
                               T::PANEL_BYTES));
      wgmma_commit();
    };
    auto release = [&](int st) {
      __syncwarp();  // every lane is done with the stage's mask and metadata
      if (lane == 0) mbar_arrive(kv_empty + 8 * st);
    };
    // (no branch around a wgmma inside the loop: the last tile is peeled)
    for (int t = 0; t + 1 < cnt; ++t) {
      const int sn = s + 1 == KV_STAGES ? 0 : s + 1;
      const uint32_t phn = sn == 0 ? ph ^ 1 : ph;
      mbar_wait(kv_full + 8 * sn, phn);
      issue_scores(sn);
      issue_pv(s);
      wgmma_wait<1>();  // the next tile's scores; P.V may still run
      wgmma_pin(sc);
      scores_to_probs(sn);
      wgmma_wait<0>();
      wgmma_pin(o);
      release(s);
      // o[4 * dn + e]: row wr + 8 * (e >> 1), dim 8 * dn + 2 * t4 + (e & 1)
#pragma unroll
      for (int x = 0; x < DH / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
      pack_probs();
      s = sn;
      ph = phn;
    }
    if (cnt > 0) {
      issue_pv(s);
      wgmma_wait<0>();
      wgmma_pin(o);
      release(s);
      if (++s == KV_STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    // Every product that reads the Q tile has completed, so the warp stages
    // its 16 output rows in them (16-byte chunk c of row r at chunk
    // c ^ swz(r): the fragment's 4-byte writes and the 16-byte reads both
    // spread over the banks) and stores whole rows, 16 bytes a lane.
    constexpr int RB = DH * 2;   // bytes of an output row
    constexpr int CPR = DH / 8;  // 16-byte chunks of a row
    auto swz = [](int r) {
      return CPR >= 8 ? (r & 7) : ((r >> 1) & (CPR - 1));
    };
    unsigned char* stage = smem + L::q + (qb * NWG + wg) * T::TILE_BYTES;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_i[i] += __shfl_xor_sync(FULL_MASK, l_i[i], 1);
      l_i[i] += __shfl_xor_sync(FULL_MASK, l_i[i], 2);
      const float inv = (l_i[i] == 0.f) ? 1.f : 1.f / l_i[i];
      const int r = wr + 8 * i;
#pragma unroll
      for (int dn = 0; dn < CPR; ++dn)
        *reinterpret_cast<uint32_t*>(stage + r * RB + ((dn ^ swz(r)) << 4) +
                                     4 * t4) =
            pack_bf16(o[4 * dn + 2 * i] * inv, o[4 * dn + 2 * i + 1] * inv);
    }
    __syncwarp();
    bf16* op = out + ((size_t)b * Hq + h) * Lq * DH;
#pragma unroll
    for (int idx = lane; idx < 16 * CPR; idx += 32) {
      const int r = 16 * (warp & 3) + idx / CPR;
      const int c = idx % CPR;
      if (q0 + r < Lq)
        *reinterpret_cast<uint4*>(op + (size_t)(q0 + r) * DH + 8 * c) =
            *reinterpret_cast<const uint4*>(stage + r * RB +
                                            ((c ^ swz(r)) << 4));
    }
    // the Q tile and the item's metadata are free; the TMA unit writes the
    // tile next, after these generic-proxy accesses
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty + 8 * qb);
    if (++qb == Q_BUFS) {
      qb = 0;
      qph ^= 1;
    }
  }
}

template <int DH, int NWG>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 const int* mask_bits, const int* mask_slot, const int* vl,
                 const int* qoff, const int* counts, const int* kv_list,
                 const int* kind_list, const int* order, int B, int Hq,
                 int Hkv, int Lq, int Lk, int nq_tiles, int nk_tiles,
                 float scale, int sms, cudaStream_t stream) {
  typedef TileGeom<DH> T;
  constexpr int smem = WgmmaLayout<DH, NWG>::total;
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        sdag_prefill_wgmma_kernel<DH, NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  // [B * H][L][DH] in boxes of [1][64][PW]; rows past L arrive as zeros
  const CUtensorMapSwizzle sw =
      T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const uint32_t box[3] = {(uint32_t)T::PW, (uint32_t)BQ, 1u};
  CUtensorMap q_map, k_map, v_map;
  const uint64_t q_dims[3] = {(uint64_t)DH, (uint64_t)Lq, (uint64_t)B * Hq};
  const uint64_t q_str[2] = {(uint64_t)DH * 2, (uint64_t)Lq * DH * 2};
  const uint64_t k_dims[3] = {(uint64_t)DH, (uint64_t)Lk, (uint64_t)B * Hkv};
  const uint64_t k_str[2] = {(uint64_t)DH * 2, (uint64_t)Lk * DH * 2};
  const CUtensorMapDataType bt = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!make_tensor_map(&q_map, bt, 3, q, q_dims, q_str, box, sw) ||
      !make_tensor_map(&k_map, bt, 3, k, k_dims, k_str, box, sw) ||
      !make_tensor_map(&v_map, bt, 3, v, k_dims, k_str, box, sw))
    return -2;
  const int n_items = B * nq_tiles * Hkv * ((Hq / Hkv) / NWG);
  const int grid = n_items < sms ? n_items : sms;
  sdag_prefill_wgmma_kernel<DH, NWG><<<grid, NWG * 128 + 32, smem, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(out), mask_bits, mask_slot, vl,
      qoff, counts, kv_list, kind_list, order, Hq, Hkv, Lq, nq_tiles,
      nk_tiles, n_items, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  if (code == -1) return "unsupported dtype, head dim or head grouping";
  if (code == -2) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32, 1 = bfloat16.  order, the (batch, q-tile) pairs
// b * nq_tiles + qt sorted by live tiles, most first; mask_bits [P][64][2],
// the PARTIAL tiles' masks (bit c of row r's two words: key c of the tile);
// mask_slot, parallel to kv_list, a tile's index into mask_bits or -1;
// heads_per_block, 2 (two q heads of a GQA group share a block and its K/V
// tiles; the group size must be even) or 1; sms, the device's SM count.
// Returns 0, a CUDA error code, or a negative code of kernel_error_string.
int sdag_prefill(const void* q, const void* k, const void* v, void* out,
                 const int* vl, const int* qoff, const int* counts,
                 const int* kv_list, const int* kind_list, const int* order,
                 const int* mask_bits, const int* mask_slot, int B, int Hq,
                 int Hkv, int Lq, int Lk, int Dh, int nq_tiles, int nk_tiles,
                 float scale, int dtype, int heads_per_block, int sms,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((heads_per_block != 1 && heads_per_block != 2) || Hq % Hkv ||
      (Hq / Hkv) % heads_per_block)
    return -1;
  const bool pair = heads_per_block == 2;
#define SDAG_F32(D, W)                                                       \
  return launch_f32<D, W>(q, k, v, out, mask_bits, mask_slot, vl, qoff,      \
                          counts, kv_list, kind_list, order, B, Hq, Hkv, Lq, \
                          Lk, nq_tiles, nk_tiles, scale, s)
#define SDAG_WGMMA(D, W)                                                     \
  return launch_wgmma<D, W>(q, k, v, out, mask_bits, mask_slot, vl, qoff,    \
                            counts, kv_list, kind_list, order, B, Hq, Hkv,   \
                            Lq, Lk, nq_tiles, nk_tiles, scale, sms, s)
  if (dtype == 0) {
    if (Dh == 32 && pair) SDAG_F32(32, 2);
    if (Dh == 32) SDAG_F32(32, 1);
    if (Dh == 64 && pair) SDAG_F32(64, 2);
    if (Dh == 64) SDAG_F32(64, 1);
    if (Dh == 128 && pair) SDAG_F32(128, 2);
    if (Dh == 128) SDAG_F32(128, 1);
  } else if (dtype == 1) {
    if (Dh == 32 && pair) SDAG_WGMMA(32, 2);
    if (Dh == 32) SDAG_WGMMA(32, 1);
    if (Dh == 64 && pair) SDAG_WGMMA(64, 2);
    if (Dh == 64) SDAG_WGMMA(64, 1);
    if (Dh == 128 && pair) SDAG_WGMMA(128, 2);
    if (Dh == 128) SDAG_WGMMA(128, 1);
  }
#undef SDAG_F32
#undef SDAG_WGMMA
  return -1;
}

}  // extern "C"
