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
// products per head are small beside that on the tensor cores.  First
// version: mma.sync, register-staged shared tiles, no wgmma / TMA.
// chip_smoke.py reports the times beside the bound.
//
// Design: grid (q-tile of 64 rows, head, batch).  The block keeps its
// scaled Q tile on chip and streams the head's K/V in 64-row tiles with an
// online softmax in f32.  With valid_len > 0 the masked columns weigh
// exp(-1e30 - m) == 0 exactly, so key tiles wholly past valid_len are not
// visited; with valid_len == 0 all tiles are.  Columns >= L (a ragged last
// tile) score -inf.  bf16: 4 warps, each 16 q rows, mma.sync.m16n8k16 with
// f32 accumulation; the score fragments are re-packed in registers as the
// A operand of P.V and V comes through ldmatrix.trans.  f32: 256 threads
// on CUDA-core FMA, thread (ty, tx) owning rows ty+16i and columns tx+16j.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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
constexpr int F32_NT = 256;

template <int DH>
constexpr size_t f32_smem_bytes() {
  return (size_t)(BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1)) *
         sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(F32_NT)
encoder_attention_f32_kernel(const float* __restrict__ qkv,
                             const int* __restrict__ valid_len,
                             float* __restrict__ out, int H, int L,
                             float scale) {
  constexpr int QP = DH + 1;
  constexpr int DJ = DH / 16;
  constexpr int SP = BK + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [BQ][QP]
  float* sK = sQ + BQ * QP;                        // [BK][QP]
  float* sV = sK + BK * QP;                        // [BK][DH]
  float* sP = sV + BK * DH;                        // [BQ][SP]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int d = H * DH;
  const size_t ld = (size_t)3 * d;
  const float* qp = qkv + (size_t)b * L * ld + (size_t)h * DH;
  const float* kp = qp + d;
  const float* vp = qp + 2 * d;
  const int vl = valid_len[b];
  const int nkeys = live_keys(vl, L);

  for (int e = tid; e < BQ * DH; e += F32_NT) {
    const int r = e / DH, c = e % DH, gr = q0 + r;
    sQ[r * QP + c] = gr < L ? qp[(size_t)gr * ld + c] * scale : 0.f;
  }

  float m_i[4], l_i[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int k0 = 0; k0 < nkeys; k0 += BK) {
    __syncthreads();  // previous tile's readers of sK/sV/sP are done
    for (int e = tid; e < BK * DH; e += F32_NT) {
      const int r = e / DH, c = e % DH, gr = k0 + r;
      const bool in = gr < L;
      sK[r * QP + c] = in ? kp[(size_t)gr * ld + c] : 0.f;
      sV[r * DH + c] = in ? vp[(size_t)gr * ld + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DH; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * QP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * QP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= vl) s[i][j] = MASKED;
        if (col >= L) s[i][j] = -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      // column k0 < L always, so m_new is finite from the first tile on
      const float m_new = fmaxf(m_i[i], mt);
      const float alpha = expf(m_i[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
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

  float* op = out + (size_t)b * L * d + (size_t)h * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = q0 + ty + 16 * i;
    if (gr < L) {
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
        op[(size_t)gr * d + tx + 16 * jj] = acc[i][jj] / l_i[i];
    }
  }
}

template <int DH>
int launch_f32(const void* qkv, const int* valid_len, void* out, int B, int H,
               int L, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      encoder_attention_f32_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + BQ - 1) / BQ, H, B);
  encoder_attention_f32_kernel<DH><<<grid, F32_NT, smem, stream>>>(
      static_cast<const float*>(qkv), valid_len, static_cast<float*>(out), H,
      L, scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- bf16
constexpr int MMA_WARPS = 4;
constexpr int MMA_NT = MMA_WARPS * 32;

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

// two bf16 in one register times a bf16 scale, rounded to bf16 (a bf16
// product is exact in f32, so this is the bf16 multiply)
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float scale) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 f = __bfloat1622float2(v);
  return pack_bf16(f.x * scale, f.y * scale);
}

// rows [row0, row0+64) x DH columns of a matrix with row stride ld
// (elements) into a padded shared tile, 16 bytes per thread per step; rows
// >= L read as zeros.  SCALE multiplies by `scale` in bf16.
template <int DH, bool SCALE>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               size_t ld, int row0, int L,
                                               int tid, float scale) {
  constexpr int CH = DH / 8;
  constexpr int RP = DH + 8;
  for (int c = tid; c < BQ * CH; c += MMA_NT) {
    const int r = c / CH, cc = c % CH, gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < L) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * ld + cc * 8);
      if (SCALE) {
        val.x = scale_bf16x2(val.x, scale);
        val.y = scale_bf16x2(val.y, scale);
        val.z = scale_bf16x2(val.z, scale);
        val.w = scale_bf16x2(val.w, scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * RP + cc * 8) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(MMA_NT)
encoder_attention_mma_kernel(const bf16* __restrict__ qkv,
                             const int* __restrict__ valid_len,
                             bf16* __restrict__ out, int H, int L,
                             float scale_bf16) {
  constexpr int RP = DH + 8;   // padded shared row (bf16 elements)
  constexpr int KS = DH / 16;  // k-steps of Q.K^T over the head dim
  constexpr int DN = DH / 8;   // n-tiles of the output
  constexpr int NTK = BK / 8;  // n-tiles of the score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * RP;
  bf16* sV = sK + BK * RP;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row group
  const int t4 = lane & 3;   // fragment column pair
  const int d = H * DH;
  const size_t ld = (size_t)3 * d;
  const bf16* qp = qkv + (size_t)b * L * ld + (size_t)h * DH;
  const bf16* kp = qp + d;
  const bf16* vp = qp + 2 * d;
  const int vl = valid_len[b];
  const int nkeys = live_keys(vl, L);
  const int wr = 16 * warp + g;  // this thread's rows: wr and wr + 8

  load_tile_bf16<DH, true>(sQ, qp, ld, q0, L, tid, scale_bf16);
  __syncthreads();

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

  for (int k0 = 0; k0 < nkeys; k0 += BK) {
    __syncthreads();  // previous tile's readers of sK/sV are done
    load_tile_bf16<DH, false>(sK, kp, ld, k0, L, tid, 0.f);
    load_tile_bf16<DH, false>(sV, vp, ld, k0, L, tid, 0.f);
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
    const bool edge = k0 + BK > vl || k0 + BK > L;
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int col = k0 + 8 * nt + 2 * t4 + (e & 1);
          if (col >= vl) s[nt][e] = MASKED;
          if (col >= L) s[nt][e] = -INFINITY;
        }
        mt[e >> 1] = fmaxf(mt[e >> 1], s[nt][e]);
      }
    }
    float m_new[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      // column k0 < L always, so m_new is finite from the first tile on
      m_new[i] = fmaxf(m_i[i], mt[i]);
      alpha[i] = expf(m_i[i] - m_new[i]);
      m_i[i] = m_new[i];
    }

    uint32_t pa[BK / 16][4];  // P as the A operand of P.V, per key k-step
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
      const float p0 = expf(s[nt][0] - m_new[0]);
      const float p1 = expf(s[nt][1] - m_new[0]);
      const float p2 = expf(s[nt][2] - m_new[1]);
      const float p3 = expf(s[nt][3] - m_new[1]);
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

  bf16* op = out + (size_t)b * L * d + (size_t)h * DH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 1);
    l_i[i] += __shfl_xor_sync(0xffffffffu, l_i[i], 2);
    const int gr = q0 + wr + 8 * i;
    if (gr < L) {
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
        *reinterpret_cast<uint32_t*>(op + (size_t)gr * d + 8 * dn + 2 * t4) =
            pack_bf16(o[dn][2 * i] / l_i[i], o[dn][2 * i + 1] / l_i[i]);
    }
  }
}

template <int DH>
int launch_mma(const void* qkv, const int* valid_len, void* out, int B, int H,
               int L, float scale, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      encoder_attention_mma_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // the scale as q's dtype holds it
  const float scale_bf16 = __bfloat162float(__float2bfloat16_rn(scale));
  dim3 grid((L + BQ - 1) / BQ, H, B);
  encoder_attention_mma_kernel<DH><<<grid, MMA_NT, smem, stream>>>(
      static_cast<const bf16*>(qkv), valid_len, static_cast<bf16*>(out), H, L,
      scale_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  if (code == -1) return "unsupported dtype / head dim / batch";
  return cudaGetErrorString((cudaError_t)code);
}

// qkv [B, L, 3*H*Dh] contiguous, valid_len [B] int32, out [B, L, H*Dh].
// dtype: 0 = float32, 1 = bfloat16.  Returns 0 or a CUDA error code.
int encoder_attention(const void* qkv, const int* valid_len, void* out, int B,
                      int H, int L, int Dh, float scale, int dtype,
                      void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || L < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ENC_LAUNCH(FN, D) return FN<D>(qkv, valid_len, out, B, H, L, scale, s)
  if (dtype == 0) {
    if (Dh == 32) ENC_LAUNCH(launch_f32, 32);
    if (Dh == 64) ENC_LAUNCH(launch_f32, 64);
    if (Dh == 128) ENC_LAUNCH(launch_f32, 128);
  } else if (dtype == 1) {
    if (Dh == 32) ENC_LAUNCH(launch_mma, 32);
    if (Dh == 64) ENC_LAUNCH(launch_mma, 64);
    if (Dh == 128) ENC_LAUNCH(launch_mma, 128);
  }
#undef ENC_LAUNCH
  return -1;
}

}  // extern "C"
