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
// What bounds it: at prefill lengths the live area is compute (two
// Lq x Lk x Dh products per head); K/V tile bytes are re-read once per
// q-tile.  bf16 inputs (the serving path) run on the tensor cores with
// mma.sync (no wgmma / TMA / warp specialisation yet, so well below the
// bf16 bound); f32 inputs stay f32 end to end on CUDA-core FMA, which is
// what keeps them within 1e-4 of the f32 reference.  chip_smoke.py
// reports the times beside the bound.
//
// Design (both paths):
//   grid (q-tile, batch*q-head); BQ = BK = 64.  The block keeps its Q
//   tile on chip, loops over its live key tiles (kv head h / (Hq/Hkv) for
//   GQA), and runs online softmax in f32.  Tile kinds: FULL -> no mask;
//   CAUSAL -> j<=i & j<vl & i<vl; PARTIAL -> the full _tile_mask rule from
//   doc_id, doc_id_q, nbr_bits_q, sys_user_len, valid_len and q_offset.
//   A row that sees no key outputs 0 (l == 0 -> divide by 1).
// f32 path: 256 threads; thread (ty, tx) = (tid/16, tid%16) owns rows
//   ty+16i (i<4) and, in the score tile, columns tx+16j (j<4); in the
//   output, dims tx+16jj.  A row is shared by 16 consecutive lanes, so
//   row max/sum are 16-lane shuffles.  Shared rows are padded by one word
//   so column walks hit distinct banks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int KIND_FULL = 1;
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
// bf16 inputs: tensor cores through mma.sync.m16n8k16 (bf16 operands, f32
// accumulation -- the TPU kernels' "bf16 dots, f32 accumulate").  4 warps,
// each owning 16 of the tile's 64 q rows; Q fragments stay in registers,
// the score accumulators are re-packed in registers as the A operand of
// P.V (the FlashAttention-2 layout identity between the m16n8 C fragment
// and the m16k16 A fragment), V fragments come from ldmatrix.trans.
// Shared rows are padded by 16 bytes so fragment loads hit distinct banks.
constexpr int MMA_WARPS = 4;
constexpr int MMA_NT = MMA_WARPS * 32;
typedef __nv_bfloat16 bf16;

template <int DH>
constexpr size_t mma_smem_bytes() {
  return (size_t)3 * BQ * (DH + 8) * sizeof(bf16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// B fragment (k = key, n = head dim) of a row-major [key][dh] V tile
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const bf16* row) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// rows [row0, row0+64) of a [L][DH] bf16 matrix into a padded shared tile,
// 16 bytes per thread per step; rows >= L read as zeros
template <int DH>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               int row0, int L, int tid) {
  constexpr int CH = DH / 8;
  constexpr int RP = DH + 8;
  for (int c = tid; c < BQ * CH; c += MMA_NT) {
    const int r = c / CH, cc = c % CH, gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < L)
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * DH + cc * 8);
    *reinterpret_cast<uint4*>(dst + r * RP + cc * 8) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(MMA_NT)
sdag_prefill_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out,
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
  constexpr int RP = DH + 8;   // padded shared row (bf16 elements)
  constexpr int KS = DH / 16;  // k-steps of Q.K^T over the head dim
  constexpr int DN = DH / 8;   // n-tiles of the output
  constexpr int NTK = BK / 8;  // n-tiles of the score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * RP;
  bf16* sV = sK + BK * RP;

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row group
  const int t4 = lane & 3;   // fragment column pair
  const int ldq = nq_tiles * BQ;

  const bf16* qp = q + (size_t)bh * Lq * DH;
  const bf16* kp = k + (size_t)(b * Hkv + kvh) * Lk * DH;
  const bf16* vp = v + (size_t)(b * Hkv + kvh) * Lk * DH;
  bf16* op = out + (size_t)bh * Lq * DH;
  const int sul = sul_b[b];
  const int vl = vl_b[b];
  const int qoff = qoff_b[b];
  const int q0 = qt * BQ;
  const int wr = 16 * warp + g;  // this thread's rows: wr and wr + 8

  load_tile_bf16<DH>(sQ, qp, q0, Lq, tid);
  __syncthreads();

  int row_i[2], dq[2];
  unsigned nbq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = q0 + wr + 8 * i;  // < ldq: metadata is tile-padded
    row_i[i] = qoff + gr;
    dq[i] = doc_q[(size_t)b * ldq + gr];
    nbq[i] = (unsigned)nbr_q[(size_t)b * ldq + gr];
  }
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const bf16* base = sQ + wr * RP + 16 * ks + 2 * t4;
    qa[ks][0] = ld_u32(base);
    qa[ks][1] = ld_u32(base + 8 * RP);
    qa[ks][2] = ld_u32(base + 8);
    qa[ks][3] = ld_u32(base + 8 * RP + 8);
  }
  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};  // per-thread partial row sums

  const size_t list_off = ((size_t)b * nq_tiles + qt) * nk_tiles;
  const int cnt = counts[(size_t)b * nq_tiles + qt];
  for (int t = 0; t < cnt; ++t) {
    const int kind = kind_list[list_off + t];
    const int k0 = kv_list[list_off + t] * BK;
    __syncthreads();  // previous tile's readers of sK/sV are done
    load_tile_bf16<DH>(sK, kp, k0, Lk, tid);
    load_tile_bf16<DH>(sV, vp, k0, Lk, tid);
    __syncthreads();

    float s[NTK][4];
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const bf16* kb = sK + (8 * nt + g) * RP + 16 * ks + 2 * t4;
        mma_bf16(s[nt], qa[ks], ld_u32(kb), ld_u32(kb + 8));
      }
    }

    // element e of n-tile nt: row wr + 8*(e>>1), key k0 + 8*nt + 2*t4 + (e&1)
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int col = k0 + 8 * nt + 2 * t4 + (e & 1);
        bool vis = true;
        if (kind == KIND_CAUSAL) {
          vis = (col <= row_i[i]) && (col < vl) && (row_i[i] < vl);
        } else if (kind != KIND_FULL) {
          vis = sdag_visible(row_i[i], col, dq[i],
                             doc_k[(size_t)b * ldk + col], nbq[i], sul, vl);
        }
        s[nt][e] = vis ? s[nt][e] * scale : -INFINITY;
        mt[i] = fmaxf(mt[i], s[nt][e]);
      }
    }
    float safe[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m_i[i], mt[i]);
      // rows with no visible key so far keep m = -inf: guard the shift
      safe[i] = (m_new == -INFINITY) ? 0.f : m_new;
      alpha[i] = (m_i[i] == -INFINITY) ? 0.f : expf(m_i[i] - safe[i]);
      m_i[i] = m_new;
    }

    uint32_t pa[BK / 16][4];  // P as the A operand of P.V, per key k-step
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
      const float p0 = expf(s[nt][0] - safe[0]);  // masked: exp(-inf) == 0
      const float p1 = expf(s[nt][1] - safe[0]);
      const float p2 = expf(s[nt][2] - safe[1]);
      const float p3 = expf(s[nt][3] - safe[1]);
      ls[0] += p0 + p1;
      ls[1] += p2 + p3;
      pa[nt >> 1][2 * (nt & 1)] = pack_bf16(p0, p1);
      pa[nt >> 1][2 * (nt & 1) + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_i[i] = l_i[i] * alpha[i] + ls[i];
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }

#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, sV + (16 * j + (lane & 15)) * RP + 8 * dn);
        mma_bf16(o[dn], pa[j], b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
    const int gr = q0 + wr + 8 * i;
    if (gr < Lq) {
      const float denom = (l_i[i] == 0.f) ? 1.f : l_i[i];
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
        *reinterpret_cast<uint32_t*>(op + (size_t)gr * DH + 8 * dn + 2 * t4) =
            pack_bf16(o[dn][2 * i] / denom, o[dn][2 * i + 1] / denom);
    }
  }
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               const int* doc_k, const int* doc_q, const int* nbr_q,
               const int* sul, const int* vl, const int* qoff,
               const int* counts, const int* kv_list, const int* kind_list,
               int B, int Hq, int Hkv, int Lq, int Lk, int nq_tiles,
               int nk_tiles, int ldk, float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      sdag_prefill_mma_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nq_tiles, B * Hq);
  sdag_prefill_mma_kernel<DH><<<grid, MMA_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), doc_k, doc_q,
      nbr_q, sul, vl, qoff, counts, kv_list, kind_list, Hq, Hkv, Lq, Lk,
      nq_tiles, nk_tiles, ldk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  if (code == -1) return "unsupported dtype / head dim";
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32, 1 = bfloat16.  Returns 0 or a CUDA error code.
int sdag_prefill(const void* q, const void* k, const void* v, void* out,
                 const int* doc_k, const int* doc_q, const int* nbr_q,
                 const int* sul, const int* vl, const int* qoff,
                 const int* counts, const int* kv_list, const int* kind_list,
                 int B, int Hq, int Hkv, int Lq, int Lk, int Dh, int nq_tiles,
                 int nk_tiles, int ldk, float scale, int dtype,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SDAG_LAUNCH(FN, D)                                                   \
  return FN<D>(q, k, v, out, doc_k, doc_q, nbr_q, sul, vl, qoff, counts,     \
               kv_list, kind_list, B, Hq, Hkv, Lq, Lk, nq_tiles, nk_tiles,   \
               ldk, scale, s)
  if (dtype == 0) {
    if (Dh == 32) SDAG_LAUNCH(launch_f32, 32);
    if (Dh == 64) SDAG_LAUNCH(launch_f32, 64);
    if (Dh == 128) SDAG_LAUNCH(launch_f32, 128);
  } else if (dtype == 1) {
    if (Dh == 32) SDAG_LAUNCH(launch_mma, 32);
    if (Dh == 64) SDAG_LAUNCH(launch_mma, 64);
    if (Dh == 128) SDAG_LAUNCH(launch_mma, 128);
  }
#undef SDAG_LAUNCH
  return -1;
}

}  // extern "C"
