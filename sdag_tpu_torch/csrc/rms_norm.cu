// Kernel K9: a decoder layer's residual add and the RMSNorm after it, for
// Hopper (sm_90a): s = x + delta (rounded to T), h = RMSNorm(s) * w.
//
// Replaces no Pallas kernel: the JAX package leaves rms_norm
// (sdag_tpu/models/llama.py) and the residual adds to XLA, which fuses
// them.  It was added because the port's plain PyTorch version launched
// nine kernels a norm (the f32 copy, square, mean, + eps, rsqrt, multiply,
// cast, gain; the residual add before it), 18 a layer: inside the
// captured decode graph about 2 us a node at batch 8, and in a prefill a
// float32 copy of each row written out four times, ~42 bytes of traffic an
// element of x where the fused pass needs 8 (bf16).
//
// What bounds it: bytes.  Each row of x and delta is read once and s and h
// are written once; w (one row) stays in registers across the rows a
// block takes.  One launch a call, for every row count:
//
//   sdag_rms_norm: one block a row at a time, blocks striding over the
//   rows (a grid of one wave of resident blocks, or one block a row when
//   there are fewer).  A block of nt threads holds its row in registers
//   as 16-byte vectors, vector v in thread v mod nt, and writes s as soon
//   as it is added; the squares are summed, the row's inverse RMS taken
//   and h written from the same registers.  At batch 8 (a decode step)
//   that is 8 blocks of 256 threads, two vectors a thread: one round trip
//   to memory for the loads, one for the stores.
//
// Arithmetic (ops/norm.py add_rms_norm_reference's, bit for bit but for
// the order of one sum):
//   * s = x + delta in f32, rounded once to T (torch's x + delta);
//   * each square f32(s)^2 rounded to f32 (no FMA contraction), summed in
//     f32; var = sum * f32(1 / d), as torch's CUDA mean; r = rsqrtf(var +
//     f32(eps));
//   * h = (f32(s) * r rounded to T) * w, the product of two T values
//     rounded to T (for f32 both roundings are the identity).
//
// Row independence: the sum runs in an order fixed by d alone: each
// thread adds its vectors' squares in order (its vectors, then a vector's
// elements), a warp's xor tree (16, 8, 4, 2, 1) adds the lanes, and the
// warps' totals are added in warp order; nt and the vectors a thread
// takes depend on d alone (k9_plan in ops/norm.py).  So a row's s and h
// are the same bits alone, among a decode step's 8 rows or a prefill's
// 25,600, whatever the grid.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;  // threads a block (a row) at most
constexpr unsigned FULL = 0xffffffffu;

typedef __nv_bfloat16 bf16;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int E = 4;     // elements in 16 bytes
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float round(float x) { return x; }
};

template <>
struct Vec<bf16> {
  static constexpr int E = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t bits(float x) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
  }
  __device__ static uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = bits(f[2 * i]) | (bits(f[2 * i + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void st16(void* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// x, delta, s and h [R, d] contiguous, w [d]; delta and s NULL: s = x,
// nothing written but h.  nt = blockDim.x threads a row, each holding the
// vectors v = tid + i * nt, i < vpt <= MAXV, of the row's d / E.
template <typename T, int MAXV>
__global__ void __launch_bounds__(MAX_THREADS)
sdag_rms_norm(const T* __restrict__ x, const T* __restrict__ delta,
              const T* __restrict__ w, T* __restrict__ s_out,
              T* __restrict__ h_out, int R, int d, int vpt, float eps) {
  constexpr int E = Vec<T>::E;
  __shared__ float part[2][MAX_THREADS / 32];
  const int nt = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const int V = d / E;
  const float inv_d = 1.0f / static_cast<float>(d);
  uint4 wv[MAXV];
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int v = tid + i * nt;
    if (i < vpt && v < V) wv[i] = ld16(w + static_cast<size_t>(v) * E);
  }
  int buf = 0;
  for (int r = blockIdx.x; r < R; r += gridDim.x, buf ^= 1) {
    const size_t row = static_cast<size_t>(r) * d;
    uint4 sv[MAXV];
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int v = tid + i * nt;
      if (i < vpt && v < V) sv[i] = ld16(x + row + static_cast<size_t>(v) * E);
    }
    if (delta != nullptr) {
#pragma unroll
      for (int i = 0; i < MAXV; ++i) {
        const int v = tid + i * nt;
        if (i < vpt && v < V) {
          const size_t off = row + static_cast<size_t>(v) * E;
          float a[E], b[E];
          Vec<T>::unpack(sv[i], a);
          Vec<T>::unpack(ld16(delta + off), b);
#pragma unroll
          for (int e = 0; e < E; ++e) a[e] = __fadd_rn(a[e], b[e]);
          sv[i] = Vec<T>::pack(a);
          st16(s_out + off, sv[i]);
        }
      }
    }
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int v = tid + i * nt;
      if (i < vpt && v < V) {
        float f[E];
        Vec<T>::unpack(sv[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) acc = __fadd_rn(acc, __fmul_rn(f[e], f[e]));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(FULL, acc, off));
    // two buffers: a warp may write the next row's total while another
    // still reads this row's (the barrier below separates two rows apart)
    if (lane == 0) part[buf][warp] = acc;
    __syncthreads();
    float total = part[buf][0];
    for (int k = 1; k < n_warps; ++k) total = __fadd_rn(total, part[buf][k]);
    const float rs = rsqrtf(__fadd_rn(__fmul_rn(total, inv_d), eps));
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int v = tid + i * nt;
      if (i < vpt && v < V) {
        float f[E], g[E];
        Vec<T>::unpack(sv[i], f);
        Vec<T>::unpack(wv[i], g);
#pragma unroll
        for (int e = 0; e < E; ++e)
          f[e] = __fmul_rn(Vec<T>::round(__fmul_rn(f[e], rs)), g[e]);
        st16(h_out + row + static_cast<size_t>(v) * E, Vec<T>::pack(f));
      }
    }
  }
}

struct Args {
  const void* x;
  const void* delta;
  const void* w;
  void* s;
  void* h;
  int R, d, vpt, nt, sms;
  float eps;
};

template <typename T, int MAXV>
int launch(const Args& a, cudaStream_t stream) {
  // resident blocks an SM, asked once per body and block size
  static int per_sm[MAX_THREADS / 32 + 1] = {0};
  int& bps = per_sm[a.nt / 32];
  if (bps == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &bps, sdag_rms_norm<T, MAXV>, a.nt, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (bps < 1) bps = 1;
  }
  const int grid = a.R < a.sms * bps ? a.R : a.sms * bps;
  sdag_rms_norm<T, MAXV><<<grid, a.nt, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.delta),
      static_cast<const T*>(a.w), static_cast<T*>(a.s), static_cast<T*>(a.h),
      a.R, a.d, a.vpt, a.eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_v(const Args& a, cudaStream_t stream) {
  if (a.vpt <= 1) return launch<T, 1>(a, stream);
  if (a.vpt <= 2) return launch<T, 2>(a, stream);
  if (a.vpt <= 4) return launch<T, 4>(a, stream);
  if (a.vpt <= 8) return launch<T, 8>(a, stream);
  return -1;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  if (code == -1) return "unsupported dtype, width or block plan";
  return cudaGetErrorString((cudaError_t)code);
}

// s = x + delta, h = RMSNorm(s) * w over R rows of d.  x, delta, s and h
// [R, d] contiguous and 16-byte aligned, w [d]; delta and s NULL for h =
// RMSNorm(x) * w alone.  nt threads a block (a multiple of 32, at most
// 256), each holding vpt 16-byte vectors of a row (k9_plan: both from d
// alone); sms the SM count.  dtype 0 = float32, 1 = bfloat16.  Returns 0,
// a CUDA error code or -1.
int rms_norm(const void* x, const void* delta, const void* w, void* s,
             void* h, int R, int d, int nt, int vpt, int sms, int dtype,
             float eps, void* stream) {
  const int E = dtype == 0 ? 4 : 8;
  if (R < 1 || d < E || d % E || nt < 32 || nt % 32 || nt > MAX_THREADS ||
      vpt < 1 || static_cast<long long>(nt) * vpt < d / E || sms < 1 ||
      (delta == nullptr) != (s == nullptr))
    return -1;
  const Args a{x, delta, w, s, h, R, d, vpt, nt, sms, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_v<float>(a, st);
  if (dtype == 1) return launch_v<bf16>(a, st);
  return -1;
}

}  // extern "C"
