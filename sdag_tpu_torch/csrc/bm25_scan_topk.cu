// Kernel K2: dense-scan BM25 scoring + exact top-k for Hopper (sm_90a).
//
// Replaces sdag_tpu/ops/bm25.py bm25_topk (_bm25_topk_kernel + the
// running top-k merge of ops/topk.py _merge_topk_tile).  Score of doc d
// for query q: sum over q's term slots t (in slot order, PAD_TERM = -1
// skipped) of weight[q,t] * impact[d, l] where term_ids[d, l] == term[q,t];
// top-k ordered (score desc, doc idx asc); docs >= valid_n never rank;
// empty slots are (-inf, -1).  0-score docs rank by index, as on the TPU.
//
// What bounds it: one pass over the packed index (term ids + impacts,
// 8 bytes per slot): memory bandwidth.  The TPU kernel compared every doc
// term with every query term (O(N*Lp*Q*T) VPU work); here each block puts
// its 32 queries' terms into a hashed bitmap in shared memory, so a doc
// term costs one shared-memory probe and only probe hits (true matches
// plus rare hash collisions) are compared against the query slots.
//
// Design:
//   pass 1: grid (doc blocks, query groups of 32); 8 warps per block; a
//   warp walks a contiguous doc range in ascending order, lane = query.
//   Per doc the warp reads the doc's term ids coalesced (32 slots per
//   step), ballots the bitmap hits into a shared list, and each lane adds
//   each hit's impact to its matching slots c[t].  The score is then
//   summed in slot order with non-contracted multiply/add, the same float
//   operations as the plain PyTorch version.  Each lane keeps a sorted
//   top-k of its query in registers and writes it out per warp.
//   pass 2 (topk_merge.cuh, shared with topk_matmul.cu): one block per
//   query selects the k best of all warps' lists by repeated block-wide
//   arg-max over (score desc, idx asc), each round taking the best entry
//   ordered strictly after the previous pick.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_merge.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;
constexpr int HASH_BITS = 16;
constexpr unsigned HASH_MASK = (1u << HASH_BITS) - 1u;
constexpr int INT_MAX_ = 0x7fffffff;

template <int TMAX, int KMAX>
__global__ void __launch_bounds__(NT)
bm25_scan_pass1(const int* __restrict__ term_ids,
                const float* __restrict__ impacts,
                const int* __restrict__ q_terms,
                const float* __restrict__ q_weights, float* cand_vals,
                int* cand_idx, int Lp, int Q, int T, int k, int valid_n,
                int docs_per_warp) {
  __shared__ unsigned bitmap[(1u << HASH_BITS) / 32];
  __shared__ int s_term[WARPS][32];
  __shared__ float s_imp[WARPS][32];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * 32;
  const int qq = q0 + lane;
  const bool qvalid = qq < Q;

  for (int i = threadIdx.x; i < (1 << HASH_BITS) / 32; i += NT) bitmap[i] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * T; i += NT) {
    const int qi = q0 + i / T;
    if (qi < Q) {
      const int term = q_terms[(size_t)qi * T + i % T];
      if (term >= 0) {
        const unsigned hsh = (unsigned)term & HASH_MASK;
        atomicOr(&bitmap[hsh >> 5], 1u << (hsh & 31u));
      }
    }
  }
  __syncthreads();

  int qt[TMAX];
  float qw[TMAX];
#pragma unroll
  for (int t = 0; t < TMAX; ++t) {
    const bool in = qvalid && t < T;
    qt[t] = in ? q_terms[(size_t)qq * T + t] : -1;
    qw[t] = in ? q_weights[(size_t)qq * T + t] : 0.f;
  }
  float topv[KMAX];
  int topi[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    topv[j] = -INFINITY;
    topi[j] = INT_MAX_;
  }
  float thr_v = -INFINITY;
  int thr_i = INT_MAX_;

  const int gw = blockIdx.x * WARPS + warp;
  const long long d_begin = (long long)gw * docs_per_warp;
  const long long d_end = min(d_begin + docs_per_warp, (long long)valid_n);
  for (long long d = d_begin; d < d_end; ++d) {
    float c[TMAX];
#pragma unroll
    for (int t = 0; t < TMAX; ++t) c[t] = 0.f;
    const int* trow = term_ids + d * Lp;
    const float* irow = impacts + d * Lp;
    for (int base = 0; base < Lp; base += 32) {
      const int l = base + lane;
      const int term = l < Lp ? trow[l] : -1;
      bool hit = false;
      if (term >= 0) {
        const unsigned hsh = (unsigned)term & HASH_MASK;
        hit = (bitmap[hsh >> 5] >> (hsh & 31u)) & 1u;
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int pos = __popc(m & ((1u << lane) - 1u));
        s_term[warp][pos] = term;
        s_imp[warp][pos] = irow[l];
      }
      __syncwarp();
      const int n = __popc(m);
      for (int e = 0; e < n; ++e) {
        const int tm = s_term[warp][e];
        const float im = s_imp[warp][e];
#pragma unroll
        for (int t = 0; t < TMAX; ++t)
          if (qt[t] == tm) c[t] += im;
      }
      __syncwarp();
    }
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < TMAX; ++t)
      if (qt[t] != -1) s = __fadd_rn(s, __fmul_rn(qw[t], c[t]));

    const int di = (int)d;
    if (qvalid && better(s, di, thr_v, thr_i)) {
      // sorted insert; the old k-th entry drops out
      bool placed = false;
#pragma unroll
      for (int j = KMAX - 1; j > 0; --j) {
        if (j < k && !placed) {
          if (better(s, di, topv[j - 1], topi[j - 1])) {
            topv[j] = topv[j - 1];
            topi[j] = topi[j - 1];
          } else {
            topv[j] = s;
            topi[j] = di;
            placed = true;
          }
        }
      }
      if (!placed) {
        topv[0] = s;
        topi[0] = di;
      }
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j == k - 1) {
          thr_v = topv[j];
          thr_i = topi[j];
        }
    }
  }

  if (qvalid) {
    const size_t base = ((size_t)gw * Q + qq) * k;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < k) {
        cand_vals[base + j] = topv[j];
        cand_idx[base + j] = topi[j];
      }
  }
}

template <int TMAX, int KMAX>
void launch_pass1(dim3 grid, cudaStream_t s, const int* term_ids,
                  const float* impacts, const int* q_terms,
                  const float* q_weights, float* cv, int* ci, int Lp, int Q,
                  int T, int k, int valid_n, int docs_per_warp) {
  bm25_scan_pass1<TMAX, KMAX><<<grid, NT, 0, s>>>(
      term_ids, impacts, q_terms, q_weights, cv, ci, Lp, Q, T, k, valid_n,
      docs_per_warp);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  if (code == -1) return "unsupported query-term count or k";
  return cudaGetErrorString((cudaError_t)code);
}

// cand_* are scratch [n_blocks * 8 warps, Q, k]; out_* are [Q, k].
// Returns 0 or a CUDA error code.
int bm25_scan_topk(const int* term_ids, const float* impacts,
                   const int* q_terms, const float* q_weights,
                   float* cand_vals, int* cand_idx, float* out_vals,
                   int* out_idx, int Lp, int Q, int T, int k, int valid_n,
                   int n_blocks, int docs_per_warp, void* stream) {
  if (T > 32 || k > 64 || k < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(n_blocks, (Q + 31) / 32);
  if (T <= 16 && k <= 16)
    launch_pass1<16, 16>(grid, s, term_ids, impacts, q_terms, q_weights,
                         cand_vals, cand_idx, Lp, Q, T, k, valid_n,
                         docs_per_warp);
  else if (T <= 16)
    launch_pass1<16, 64>(grid, s, term_ids, impacts, q_terms, q_weights,
                         cand_vals, cand_idx, Lp, Q, T, k, valid_n,
                         docs_per_warp);
  else if (k <= 16)
    launch_pass1<32, 16>(grid, s, term_ids, impacts, q_terms, q_weights,
                         cand_vals, cand_idx, Lp, Q, T, k, valid_n,
                         docs_per_warp);
  else
    launch_pass1<32, 64>(grid, s, term_ids, impacts, q_terms, q_weights,
                         cand_vals, cand_idx, Lp, Q, T, k, valid_n,
                         docs_per_warp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_merge_pass<<<Q, MERGE_NT, 0, s>>>(cand_vals, cand_idx, out_vals,
                                         out_idx, n_blocks * WARPS, Q, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
