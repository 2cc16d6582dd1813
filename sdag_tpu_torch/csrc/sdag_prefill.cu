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
// bf16 inputs (the serving path), sdag_prefill_wgmma_kernel: persistent
// blocks, one per SM, each walking work items (batch, q-tile, kv head, pair
// of q heads) in an order that puts the q-tiles with the most live key
// tiles first.  One producer thread loads by TMA (hopper_async.cuh): the
// item's Q tiles and metadata into a double buffer, and each live K and V
// tile once for the two q heads, with a PARTIAL tile's 64 x 64 mask bits
// beside them, into a 4-stage ring guarded by mbarriers.  Two consumer
// warpgroups, one per q head, compute S = Q.K^T with wgmma from shared
// memory (m64n64k16), apply the mask, run the online softmax in f32 in the
// exp2 domain (scale * log2 e folded into one multiply), and feed P,
// rounded to bf16, from registers into the wgmma for P.V (V read MN-major
// from its row-major tile).  The loop is software-pipelined: the next
// tile's scores are issued before this tile's P.V, so its mask and softmax
// run while the tensor cores work on P.V; the warpgroups are not tied to
// each other, so one's softmax also overlaps the other's products.  A GQA
// group of odd size runs one warpgroup per block.  An item's output tile is
// staged in its Q tile (free by then) and leaves as whole rows in 16-byte
// stores.  A PARTIAL tile's mask
// does not depend on the layer or the head, so the token rule is evaluated
// once per prefill into bit tiles (ops/attention.py k1_plan) and the bf16
// body only tests bits: evaluating the rule in the kernel took 3x the
// whole softmax of a tile, and 63% of the main path's live tiles are
// PARTIAL.  (The f32 body below evaluates the rule itself.)  Tile kinds:
// FULL -> no mask; CAUSAL -> j<=i & j<vl & i<vl; PARTIAL -> the full
// _tile_mask rule from doc_id, doc_id_q, nbr_bits_q, sys_user_len,
// valid_len and q_offset.  A row that sees no key outputs 0 (l == 0 ->
// divide by 1).
//
// f32 inputs stay f32 end to end on CUDA-core FMA (sdag_prefill_kernel),
// which is what keeps them within 1e-4 of the f32 reference:
//   grid (q-tile, batch*q-head); BQ = BK = 64.  The block keeps its Q
//   tile on chip, loops over its live key tiles (kv head h / (Hq/Hkv) for
//   GQA), and runs online softmax in f32 with the same tile kinds.
//   256 threads; thread (ty, tx) = (tid/16, tid%16) owns rows
//   ty+16i (i<4) and, in the score tile, columns tx+16j (j<4); in the
//   output, dims tx+16jj.  A row is shared by 16 consecutive lanes, so
//   row max/sum are 16-lane shuffles.  Shared rows are padded by one word
//   so column walks hit distinct banks.

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
constexpr int HOLE = -2;

// _tile_mask (sdag_tpu/ops/attention.py): the token-level SDAG rule.
__device__ __forceinline__ bool sdag_visible(int i, int j, int dq, int dk,
                                             unsigned nbr_q, int sul,
                                             int vl) {
  const bool causal = j <= i;
  const bool is_doc_q = dq >= 0;
  const bool same_doc = (dq == dk) && is_doc_q;
  const bool prefix = (dk == -1) && (j < sul);
  // logical shift of an unsigned by 0..31 only: a shift >= 32 is undefined
  const bool nbr = (dk >= 0) && (dk < 32) && ((nbr_q >> dk) & 1u);
  const bool doc_row = (causal && (same_doc || prefix)) || nbr;
  const bool nondoc_row = causal && (dk != HOLE);
  const bool m = is_doc_q ? doc_row : nondoc_row;
  return m && (j < vl) && (i < vl);
}

// f32 path: Q, K (rows padded by one word), V and the P tile
template <int DH>
constexpr size_t smem_bytes() {
  return (size_t)(BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1)) *
         sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(NT)
sdag_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    const int* __restrict__ doc_k,
                    const int* __restrict__ doc_q,
                    const int* __restrict__ nbr_q,
                    const int* __restrict__ sul_b,
                    const int* __restrict__ vl_b,
                    const int* __restrict__ qoff_b,
                    const int* __restrict__ counts,
                    const int* __restrict__ kv_list,
                    const int* __restrict__ kind_list, int Hq, int Hkv,
                    int Lq, int Lk, int nq_tiles, int nk_tiles, int ldk,
                    float scale) {
  constexpr int QP = DH + 1;   // padded Q/K row
  constexpr int DJ = DH / 16;  // output dims per thread
  constexpr int SP = BK + 1;   // padded P row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [BQ][QP]
  float* sK = sQ + BQ * QP;                        // [BK][QP]
  float* sV = sK + BK * QP;                        // [BK][DH]
  float* sP = sV + BK * DH;                        // [BQ][SP]

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int ldq = nq_tiles * BQ;

  const float* qp = q + (size_t)bh * Lq * DH;
  const float* kp = k + (size_t)(b * Hkv + kvh) * Lk * DH;
  const float* vp = v + (size_t)(b * Hkv + kvh) * Lk * DH;
  float* op = out + (size_t)bh * Lq * DH;
  const int sul = sul_b[b];
  const int vl = vl_b[b];
  const int qoff = qoff_b[b];
  const int q0 = qt * BQ;

  for (int e = tid; e < BQ * DH; e += NT) {
    const int r = e / DH, d = e % DH, gr = q0 + r;
    sQ[r * QP + d] = gr < Lq ? qp[(size_t)gr * DH + d] : 0.f;
  }

  int row_i[4], dq[4];
  unsigned nbq[4];
  float m_i[4], l_i[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty + 16 * i;  // < ldq: metadata is tile-padded
    row_i[i] = qoff + gr;
    dq[i] = doc_q[(size_t)b * ldq + gr];
    nbq[i] = (unsigned)nbr_q[(size_t)b * ldq + gr];
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  const size_t list_off = ((size_t)b * nq_tiles + qt) * nk_tiles;
  const int cnt = counts[(size_t)b * nq_tiles + qt];
  for (int t = 0; t < cnt; ++t) {
    const int kt = kv_list[list_off + t];
    const int kind = kind_list[list_off + t];
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's readers of sK/sV/sP are done
    for (int e = tid; e < BK * DH; e += NT) {
      const int r = e / DH, d = e % DH, gr = k0 + r;
      const bool in = gr < Lk;
      sK[r * QP + d] = in ? kp[(size_t)gr * DH + d] : 0.f;
      sV[r * DH + d] = in ? vp[(size_t)gr * DH + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    int dk[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[j] = doc_k[(size_t)b * ldk + k0 + tx + 16 * j];

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool vis = true;
        if (kind == KIND_CAUSAL) {
          vis = (col <= row_i[i]) && (col < vl) && (row_i[i] < vl);
        } else if (kind != KIND_FULL) {
          vis = sdag_visible(row_i[i], col, dq[i], dk[j], nbq[i], sul, vl);
        }
        s[i][j] = vis ? s[i][j] * scale : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m_i[i], mt);
      // rows with no visible key so far keep m = -inf: guard the shift
      const float safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = (m_i[i] == -INFINITY) ? 0.f : expf(m_i[i] - safe);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - safe);  // masked: exp(-inf) == 0
        sP[(ty + 16 * i) * SP + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l_i[i] = l_i[i] * alpha + ps;
      m_i[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float vv = sV[c * DH + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty + 16 * i;
    if (gr < Lq) {
      const float denom = (l_i[i] == 0.f) ? 1.f : l_i[i];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
        op[(size_t)gr * DH + tx + 16 * jj] = acc[i][jj] / denom;
    }
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               const int* doc_k, const int* doc_q, const int* nbr_q,
               const int* sul, const int* vl, const int* qoff,
               const int* counts, const int* kv_list, const int* kind_list,
               int B, int Hq, int Hkv, int Lq, int Lk, int nq_tiles,
               int nk_tiles, int ldk, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      sdag_prefill_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nq_tiles, B * Hq);
  sdag_prefill_kernel<DH><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), doc_k, doc_q,
      nbr_q, sul, vl, qoff, counts, kv_list, kind_list, Hq, Hkv, Lq, Lk,
      nq_tiles, nk_tiles, ldk, scale);
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

// dtype: 0 = float32, 1 = bfloat16.  bfloat16 only: order, the (batch,
// q-tile) pairs b * nq_tiles + qt sorted by live tiles, most first;
// mask_bits [P][64][2], the PARTIAL tiles' masks (bit c of row r's two
// words: key c of the tile); mask_slot, parallel to kv_list, a tile's index
// into mask_bits or -1; heads_per_block, 2 (two q heads of a GQA group
// share a block and its K/V tiles; the group size must be even) or 1; sms,
// the device's SM count.  float32 only: doc_k, doc_q, nbr_q, sul.  Returns
// 0, a CUDA error code, or a negative code of kernel_error_string.
int sdag_prefill(const void* q, const void* k, const void* v, void* out,
                 const int* doc_k, const int* doc_q, const int* nbr_q,
                 const int* sul, const int* vl, const int* qoff,
                 const int* counts, const int* kv_list, const int* kind_list,
                 const int* order, const int* mask_bits, const int* mask_slot,
                 int B, int Hq, int Hkv, int Lq, int Lk, int Dh, int nq_tiles,
                 int nk_tiles, int ldk, float scale, int dtype,
                 int heads_per_block, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SDAG_LAUNCH(FN, D)                                                   \
  return FN<D>(q, k, v, out, doc_k, doc_q, nbr_q, sul, vl, qoff, counts,     \
               kv_list, kind_list, B, Hq, Hkv, Lq, Lk, nq_tiles, nk_tiles,   \
               ldk, scale, s)
#define SDAG_WGMMA(D, W)                                                     \
  return launch_wgmma<D, W>(q, k, v, out, mask_bits, mask_slot, vl, qoff,    \
                            counts, kv_list, kind_list, order, B, Hq, Hkv,   \
                            Lq, Lk, nq_tiles, nk_tiles, scale, sms, s)
  if (dtype == 0) {
    if (Dh == 32) SDAG_LAUNCH(launch_f32, 32);
    if (Dh == 64) SDAG_LAUNCH(launch_f32, 64);
    if (Dh == 128) SDAG_LAUNCH(launch_f32, 128);
  } else if (dtype == 1) {
    const bool pair = heads_per_block == 2;
    if ((heads_per_block != 1 && heads_per_block != 2) || Hq % Hkv ||
        (Hq / Hkv) % heads_per_block)
      return -1;
    if (Dh == 32 && pair) SDAG_WGMMA(32, 2);
    if (Dh == 32) SDAG_WGMMA(32, 1);
    if (Dh == 64 && pair) SDAG_WGMMA(64, 2);
    if (Dh == 64) SDAG_WGMMA(64, 1);
    if (Dh == 128 && pair) SDAG_WGMMA(128, 2);
    if (Dh == 128) SDAG_WGMMA(128, 1);
  }
#undef SDAG_LAUNCH
#undef SDAG_WGMMA
  return -1;
}

}  // extern "C"
