// Kernel K8: the expert layer of one decode step, for Hopper (sm_90a):
// each row's routing, then the SwiGLU experts it picked, then each row's
// weighted sum, with no host value (a CUDA graph captures it).
//
// Replaces no Pallas kernel: the JAX package serves dense decoders only.
// It was added because a decode step's expert layer has data-dependent
// shapes (which experts, how many rows each), which a captured graph cannot
// take from the host, and because its weights are nearly all of a step's
// bytes: at batch 8 and top 8 of 64 experts (2,304 x 896), the 64 picks of
// a layer name about 42 experts, 12.4 MB each in bf16.
//
// What bounds it: bytes.  Each picked expert's three matrices are read
// once a step whatever the rows that picked it, an expert nobody picked
// costs nothing; the products, 2 x 3 x d x F flops a pick, are tens of
// times fewer than the bytes allow on CUDA cores at these batches.  At the
// cell's shape the down pass streams at 38% of the card's bandwidth and
// the gate/up pass at 63%, with expert blocks of 16 warps (one SM's
// registers at 128 a thread) as with blocks of 8 (PERF.md, section 6).
// Four launches a call:
//
//   sdag_moe_route: a block a row.  Logits x . router[:, e] in f32 (32
//   warps over the hidden dim, eight router rows a warp in flight, their
//   partial sums added in warp order),
//   softmax over all E in f32, the top k by a warp's k argmax rounds (ties
//   to the lower expert), divided by their sum where norm_topk.  A row not
//   live picks nothing (expert -1).
//
//   sdag_moe_gate_up: blocks of 16 warps over (32 columns of F, expert).
//   A block finds its expert's picks (a warp's ballots over the B x k
//   picks, in pick order) and leaves at once when there are none; else it
//   stages those rows of x in shared memory, 8 at a time, and each warp
//   streams the gate and up rows of two columns (16 bytes a lane, [out, in]
//   layout, so a warp reads 512 contiguous bytes a row) against every
//   staged row.  It writes h = SiLU(gate) * up in f32 for each pick.  The
//   block of column tile 0 adds 1 to the distinct-expert counter.
//
//   sdag_moe_down: blocks of 16 warps over (64 columns of d, expert), the
//   same walk over the down rows with the picks' h rows staged in f32;
//   writes each pick's down product in f32.
//
//   sdag_moe_combine: out[b, c] = sum_j w[b, j] * y[b k + j, c] in f32 in
//   slot order, rounded once to bf16 (0 for a row not live).
//
// Arithmetic (ops/moe.py moe_experts_reference's, up to the order of
// sums): bf16 inputs, f32 products and sums, SiLU in f32, h and the down
// products kept in f32, one rounding at the end.  Sums over a warp's lanes
// are butterflies and over warps in warp order, so the bits of a row
// depend on its own picks only, never on the other rows or on B.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 256;           // threads of the combine's blocks
constexpr int NT_EXP = 512;       // threads of an expert block (16 warps)
constexpr int NT_ROUTE = 1024;    // the router's block: 32 warps over d
constexpr int NW_ROUTE = NT_ROUTE / 32;
constexpr int COLS_GU = 32;       // gate/up columns a block: 2 a warp
constexpr int COLS_DOWN = 64;     // down columns a block: 4 a warp
constexpr int ROWS = 8;           // picks staged at once
constexpr int MAX_ROWS = 1024;    // rows a call (picks of one expert)
constexpr int MAX_TOPK = 32;

__device__ __forceinline__ void unpack8(uint4 v, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The picks (b * k + j) of expert e, in pick order, into picks[]; their
// count is returned to every thread.  Warp 0 scans, 32 picks a ballot.
__device__ int find_picks(const int* __restrict__ idx, int P, int e,
                          int* picks, int* count) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int base = 0; base < P; base += 32) {
      const int t = base + lane;
      const bool hit = t < P && idx[t] == e;
      const unsigned m = __ballot_sync(FULL, hit);
      if (hit) picks[n + __popc(m & ((1u << lane) - 1u))] = t;
      n += __popc(m);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

template <int EP>
__global__ void __launch_bounds__(NT_ROUTE)
sdag_moe_route(const bf16* __restrict__ x, long long sx,
               const bf16* __restrict__ router,
               const uint8_t* __restrict__ live, int d, int k, int norm,
               int* __restrict__ idx, float* __restrict__ w) {
  constexpr int E = 32 * EP;
  __shared__ float part[NW_ROUTE][E];
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* xr = x + (long long)b * sx;
  float acc[EP];
#pragma unroll
  for (int i = 0; i < EP; ++i) acc[i] = 0.f;
#pragma unroll 8
  for (int kk = warp; kk < d; kk += NW_ROUTE) {
    const float xv = __bfloat162float(xr[kk]);
    const bf16* r = router + (long long)kk * E + lane * EP;
#pragma unroll
    for (int i = 0; i < EP; ++i)
      acc[i] = fmaf(xv, __bfloat162float(r[i]), acc[i]);
  }
#pragma unroll
  for (int i = 0; i < EP; ++i) part[warp][lane * EP + i] = acc[i];
  __syncthreads();
  if (warp != 0) return;

  float p[EP];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < EP; ++i) {
    float s = part[0][lane * EP + i];
    for (int v = 1; v < NW_ROUTE; ++v) s += part[v][lane * EP + i];
    p[i] = s;
    mx = fmaxf(mx, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < EP; ++i) {
    p[i] = expf(p[i] - mx);
    sum += p[i];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int i = 0; i < EP; ++i) p[i] = p[i] / sum;

  const bool on = live == nullptr || live[b] != 0;
  float sel_v = 0.f, tot = 0.f;
  int sel_i = -1;
  unsigned taken = 0;
  for (int j = 0; j < k; ++j) {
    float bv = -1.f;
    int bi = E;
#pragma unroll
    for (int i = 0; i < EP; ++i)
      if (!((taken >> i) & 1u) && p[i] > bv) {
        bv = p[i];
        bi = lane * EP + i;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, o);
      const int oi = __shfl_xor_sync(FULL, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (bi / EP == lane) taken |= 1u << (bi % EP);
    if (lane == j) {
      sel_v = bv;
      sel_i = bi;
    }
    tot += bv;
  }
  if (lane < k) {
    idx[b * k + lane] = on ? sel_i : -1;
    w[b * k + lane] = norm ? sel_v / tot : sel_v;
  }
}

__global__ void __launch_bounds__(NT_EXP)
sdag_moe_gate_up(const bf16* __restrict__ x, long long sx,
                 const bf16* __restrict__ gate_up,
                 const int* __restrict__ idx, int P, int k, int d, int f,
                 float* __restrict__ h,
                 unsigned long long* __restrict__ reads) {
  extern __shared__ uint4 xs[];            // [ROWS][d / 8]
  __shared__ int picks[MAX_ROWS];
  __shared__ int count;
  const int e = blockIdx.y, tile = blockIdx.x;
  const int n = find_picks(idx, P, e, picks, &count);
  if (n == 0) return;
  if (tile == 0 && threadIdx.x == 0 && reads != nullptr)
    atomicAdd(reads, 1ull);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d8 = d / 8;
  const int c0 = tile * COLS_GU + warp * 2;
  const bf16* wg = gate_up + ((long long)e * 2 * f + c0) * d;
  const bf16* wu = wg + (long long)f * d;
  const bool two = c0 + 1 < f;
  for (int r0 = 0; r0 < n; r0 += ROWS) {
    const int nr = min(ROWS, n - r0);
    if (r0) __syncthreads();
    for (int i = threadIdx.x; i < nr * d8; i += NT_EXP) {
      const int r = i / d8, c = i % d8;
      xs[r * d8 + c] = *reinterpret_cast<const uint4*>(
          x + (long long)(picks[r0 + r] / k) * sx + c * 8);
    }
    __syncthreads();
    if (c0 >= f) continue;
    float ag[2][ROWS], au[2][ROWS];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) ag[t][r] = au[t][r] = 0.f;
#pragma unroll 2
    for (int c = lane; c < d8; c += 32) {
      float g[2][8], u[2][8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(wg) + c), g[0]);
      unpack8(__ldg(reinterpret_cast<const uint4*>(wu) + c), u[0]);
      if (two) {
        unpack8(__ldg(reinterpret_cast<const uint4*>(wg + d) + c), g[1]);
        unpack8(__ldg(reinterpret_cast<const uint4*>(wu + d) + c), u[1]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) g[1][i] = u[1][i] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < nr) {
          float xv[8];
          unpack8(xs[r * d8 + c], xv);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              ag[t][r] = fmaf(xv[i], g[t][i], ag[t][r]);
              au[t][r] = fmaf(xv[i], u[t][i], au[t][r]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < nr) {
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const float gs = warp_sum(ag[t][r]), us = warp_sum(au[t][r]);
          if (lane == 0 && (t == 0 || two))
            h[(long long)picks[r0 + r] * f + c0 + t] =
                gs / (1.f + expf(-gs)) * us;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(NT_EXP)
sdag_moe_down(const bf16* __restrict__ down, const int* __restrict__ idx,
              const float* __restrict__ h, int P, int d, int f,
              float* __restrict__ y) {
  extern __shared__ float4 hs[];           // [ROWS][f / 4]
  __shared__ int picks[MAX_ROWS];
  __shared__ int count;
  const int e = blockIdx.y, tile = blockIdx.x;
  const int n = find_picks(idx, P, e, picks, &count);
  if (n == 0) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f4 = f / 4, f8 = f / 8;
  const int c0 = tile * COLS_DOWN + warp * 4;
  const int nc = min(4, d - c0);
  const bf16* wd = down + ((long long)e * d + c0) * f;
  for (int r0 = 0; r0 < n; r0 += ROWS) {
    const int nr = min(ROWS, n - r0);
    if (r0) __syncthreads();
    for (int i = threadIdx.x; i < nr * f4; i += NT_EXP) {
      const int r = i / f4, c = i % f4;
      hs[r * f4 + c] = *reinterpret_cast<const float4*>(
          h + (long long)picks[r0 + r] * f + c * 4);
    }
    __syncthreads();
    if (nc <= 0) continue;
    float acc[4][ROWS];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[t][r] = 0.f;
#pragma unroll 2
    for (int c = lane; c < f8; c += 32) {
      float wv[4][8];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t < nc) {
          unpack8(__ldg(reinterpret_cast<const uint4*>(wd + (long long)t * f)
                        + c), wv[t]);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) wv[t][i] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < nr) {
          const float4 a = hs[r * f4 + 2 * c], b = hs[r * f4 + 2 * c + 1];
          const float hv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int t = 0; t < 4; ++t)
              acc[t][r] = fmaf(hv[i], wv[t][i], acc[t][r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < nr) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float s = warp_sum(acc[t][r]);
          if (lane == 0 && t < nc)
            y[(long long)picks[r0 + r] * d + c0 + t] = s;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(NT)
sdag_moe_combine(const int* __restrict__ idx, const float* __restrict__ w,
                 const float* __restrict__ y, int k, int d,
                 bf16* __restrict__ out) {
  const int b = blockIdx.y, c = blockIdx.x * NT + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int j = 0; j < k; ++j) {
    const int p = b * k + j;
    if (idx[p] >= 0) s += w[p] * y[(long long)p * d + c];
  }
  out[(long long)b * d + c] = __float2bfloat16(s);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int& allowed) {
  if (bytes <= 48 * 1024 || bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  if (code == -1)
    return "unsupported expert count, top k, widths or row count";
  return cudaGetErrorString((cudaError_t)code);
}

// One decode step's expert layer.  x [B, d] bf16 by row stride sx
// (elements); router [d, E], gate_up [E, 2F, d] (gate rows, then up rows),
// down [E, d, F] bf16 contiguous; live bytes [B] or NULL (every row).
// Scratch: idx int32 [B, k], w f32 [B, k], h f32 [B k, F], y f32 [B k, d];
// out [B, d] bf16; reads a uint64 counter or NULL.  E in {64, 128, 256},
// k <= 32, d and F multiples of 8, B <= 1024.  Returns 0, a CUDA error code
// or -1.
int moe_experts(const void* x, const void* router, const void* gate_up,
                const void* down, const void* live, void* idx, void* w,
                void* h, void* y, void* out, void* reads, int B, int d, int f,
                int E, int k, int sx, int norm, void* stream) {
  if (B < 1 || B > MAX_ROWS || k < 1 || k > MAX_TOPK || k > E || d % 8 ||
      f % 8 || d < 8 || f < 8)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t* lv = static_cast<const uint8_t*>(live);
  int* ib = static_cast<int*>(idx);
  float* wb = static_cast<float*>(w);
  switch (E) {
    case 64:
      sdag_moe_route<2><<<B, NT_ROUTE, 0, s>>>(xb, sx,
          static_cast<const bf16*>(router), lv, d, k, norm, ib, wb);
      break;
    case 128:
      sdag_moe_route<4><<<B, NT_ROUTE, 0, s>>>(xb, sx,
          static_cast<const bf16*>(router), lv, d, k, norm, ib, wb);
      break;
    case 256:
      sdag_moe_route<8><<<B, NT_ROUTE, 0, s>>>(xb, sx,
          static_cast<const bf16*>(router), lv, d, k, norm, ib, wb);
      break;
    default:
      return -1;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  static int allowed_gu = 0, allowed_down = 0;
  const int smem_gu = ROWS * d * (int)sizeof(bf16);
  const int smem_down = ROWS * f * (int)sizeof(float);
  e = allow_smem(sdag_moe_gate_up, smem_gu, allowed_gu);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(sdag_moe_down, smem_down, allowed_down);
  if (e != cudaSuccess) return (int)e;
  const int P = B * k;
  sdag_moe_gate_up<<<dim3((f + COLS_GU - 1) / COLS_GU, E), NT_EXP, smem_gu,
                     s>>>(
      xb, sx, static_cast<const bf16*>(gate_up), ib, P, k, d, f,
      static_cast<float*>(h), static_cast<unsigned long long*>(reads));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sdag_moe_down<<<dim3((d + COLS_DOWN - 1) / COLS_DOWN, E), NT_EXP, smem_down,
                  s>>>(static_cast<const bf16*>(down), ib,
                       static_cast<const float*>(h), P, d, f,
                       static_cast<float*>(y));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sdag_moe_combine<<<dim3((d + NT - 1) / NT, B), NT, 0, s>>>(
      ib, wb, static_cast<const float*>(y), k, d,
      static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
