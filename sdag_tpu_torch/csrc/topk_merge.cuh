// Shared by the top-k kernels (bm25_scan_topk.cu, topk_matmul.cu): the
// (score desc, index asc) order and the exact merge of per-block lists.
//
// CUDA blocks run in no order, so a running top-k cannot be folded tile by
// tile as the TPU kernels do (sdag_tpu/ops/topk.py _merge_topk_tile).  Each
// first pass writes one list of k entries per (block or warp, query); the
// merge pass below picks the k best of all lists of a query.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MERGE_WARPS = 8;
constexpr int MERGE_NT = MERGE_WARPS * 32;
constexpr int TOPK_INT_MAX = 0x7fffffff;

// (va, ia) ranks before (vb, ib): higher score, then lower index
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Warp-cooperative insert of (s, idx) into a list of k <= 128 entries kept
// sorted in rank order; the old k-th entry drops out.  Every lane of the
// warp calls it with the same arguments (plus its own lane id).  Lane l
// holds entries l, l+32, ...: a vote counts the entries that rank before
// the candidate (its position), the entries behind it move down one slot in
// parallel, lane 0 writes the candidate.  Cost is independent of k and of
// the position.  Empty slots are (-inf, TOPK_INT_MAX).
constexpr int TOPK_MAX_K = 128;

__device__ __forceinline__ void warp_topk_insert(float* lv, int* li, int k,
                                                 float s, int idx, int lane) {
  if (!better(s, idx, lv[k - 1], li[k - 1])) return;  // warp-uniform
  float v[TOPK_MAX_K / 32];
  int ix[TOPK_MAX_K / 32];
  int pos = 0;
#pragma unroll
  for (int c = 0; c < TOPK_MAX_K / 32; ++c) {
    if (32 * c >= k) break;  // warp-uniform
    const int j = lane + 32 * c;
    bool before = false;
    if (j < k) {
      v[c] = lv[j];
      ix[c] = li[j];
      before = better(v[c], ix[c], s, idx);
    }
    pos += __popc(__ballot_sync(0xffffffffu, before));
  }
  __syncwarp();  // every entry is read before any is overwritten
#pragma unroll
  for (int c = 0; c < TOPK_MAX_K / 32; ++c) {
    if (32 * c >= k) break;
    const int j = lane + 32 * c;
    if (j >= pos && j < k - 1) {
      lv[j + 1] = v[c];
      li[j + 1] = ix[c];
    }
  }
  if (lane == 0) {
    lv[pos] = s;
    li[pos] = idx;
  }
  __syncwarp();
}

// One block per query: the k best of n_lists lists (in any order) laid out
// [list][Q][k], by repeated block-wide arg-max over (score desc, idx asc),
// each round taking the best entry ordered strictly after the previous
// pick.  Index TOPK_INT_MAX (an empty slot) is written as -1.
__global__ void __launch_bounds__(MERGE_NT)
topk_merge_pass(const float* __restrict__ cand_vals,
                const int* __restrict__ cand_idx, float* out_vals,
                int* out_idx, int n_lists, int Q, int k) {
  __shared__ float red_v[MERGE_WARPS];
  __shared__ int red_i[MERGE_WARPS];
  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = n_lists * k;
  float pv = INFINITY;  // previous pick; (+inf, -1) ranks before all
  int pi = -1;
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = TOPK_INT_MAX;
    for (int e = threadIdx.x; e < n; e += MERGE_NT) {
      const int w = e / k, j = e % k;
      const size_t off = ((size_t)w * Q + qi) * k + j;
      const float v = cand_vals[off];
      const int ix = cand_idx[off];
      if (better(pv, pi, v, ix) && better(v, ix, bv, bi)) {
        bv = v;
        bi = ix;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    bv = red_v[0];
    bi = red_i[0];
#pragma unroll
    for (int w = 1; w < MERGE_WARPS; ++w)
      if (better(red_v[w], red_i[w], bv, bi)) {
        bv = red_v[w];
        bi = red_i[w];
      }
    __syncthreads();  // red_* reused next round
    if (threadIdx.x == 0) {
      out_vals[(size_t)qi * k + r] = bv;
      out_idx[(size_t)qi * k + r] = bi == TOPK_INT_MAX ? -1 : bi;
    }
    pv = bv;
    pi = bi;
  }
}

// The same merge for lists that are each sorted in rank order (empty slots
// last): thread t keeps the heads of lists t and t + MERGE_NT in registers,
// each round is one block-wide arg-max over the heads, and only the winner
// reloads.  k rounds of a few shuffles instead of k scans of every entry.
constexpr int MERGE_SORTED_MAX_LISTS = 2 * MERGE_NT;

__global__ void __launch_bounds__(MERGE_NT)
topk_merge_sorted_pass(const float* __restrict__ cand_vals,
                       const int* __restrict__ cand_idx, float* out_vals,
                       int* out_idx, int n_lists, int Q, int k) {
  __shared__ float red_v[MERGE_WARPS];
  __shared__ int red_i[MERGE_WARPS];
  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float hv[2];
  int hi[2], pos[2] = {0, 0};
  size_t off[2];
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const int w = threadIdx.x + l * MERGE_NT;
    off[l] = ((size_t)w * Q + qi) * k;
    hv[l] = w < n_lists ? cand_vals[off[l]] : -INFINITY;
    hi[l] = w < n_lists ? cand_idx[off[l]] : TOPK_INT_MAX;
  }
  for (int r = 0; r < k; ++r) {
    const bool second = better(hv[1], hi[1], hv[0], hi[0]);
    float bv = second ? hv[1] : hv[0];
    int bi = second ? hi[1] : hi[0];
    const int my_i = bi;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    bv = red_v[0];
    bi = red_i[0];
#pragma unroll
    for (int w = 1; w < MERGE_WARPS; ++w)
      if (better(red_v[w], red_i[w], bv, bi)) {
        bv = red_v[w];
        bi = red_i[w];
      }
    __syncthreads();  // red_* reused next round
    if (threadIdx.x == 0) {
      out_vals[(size_t)qi * k + r] = bv;
      out_idx[(size_t)qi * k + r] = bi == TOPK_INT_MAX ? -1 : bi;
    }
    // indices are unique across lists: the owner of the pick moves on
    if (bi != TOPK_INT_MAX && my_i == bi) {
#pragma unroll
      for (int l = 0; l < 2; ++l)
        if (hi[l] == bi) {
          ++pos[l];
          hv[l] = pos[l] < k ? cand_vals[off[l] + pos[l]] : -INFINITY;
          hi[l] = pos[l] < k ? cand_idx[off[l] + pos[l]] : TOPK_INT_MAX;
        }
    }
  }
}

}  // namespace
