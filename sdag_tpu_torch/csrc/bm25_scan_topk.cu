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
// term with every query term (O(N*Lp*Q*T) VPU work); here a doc term costs
// one probe of a hashed table of the block's query terms, and a hit costs
// a few shared-memory operations whatever the number of query slots T.
//
// Design: grid (blocks, query groups of 32); 8 warps a block; blocks walk
// tiles of `td` consecutive docs (the wrapper's bm25_scan_geometry picks
// td so that every SM has work at small N and tiles of 64 docs at large N).
//   Setup, once per block: a hash table (buckets of 4 keys, one 16-byte
//   probe each) from term to an entry; an entry holds, per query lane,
//   the first slot of the query that holds the term or 0xff (a query with
//   a term in two slots takes a slow path that is never hot: the index
//   encodes each term once).
//   Scoring: warp w takes docs [w td / 8, (w + 1) td / 8) of a tile.  Its
//   rows arrive in 64-slot chunks by cp.async through an 8-stage ring of
//   its own that runs ahead across docs and tiles (16 warps of an SM keep
//   64 KB in flight).  Lane l probes slot l of a 32-slot step; a ballot
//   compacts the hits (entry, impact) into a per-warp list; for each hit
//   (four at a time, so their lookups overlap) every lane whose query
//   holds the term adds the impact to its slot of a per-warp [T][32] array
//   of accumulators (0 until then: a doc term repeated in the row adds to
//   the first impact) and sets the slot's bit.  At the doc's end each
//   lane walks its set bits in slot order: s = __fadd_rn(s,
//   __fmul_rn(w[t], c[t])) -- the plain version's float operations in its
//   order (an unmatched slot adds an exact 0 there), so the scores are
//   bit-equal -- and sets those accumulators back to 0.  The 32 scores go
//   to a [32][td] tile.
//   Selection, after one block barrier a tile (the score tile is
//   double-buffered): warp w owns queries 4w .. 4w + 3; a query's (score,
//   doc) threshold and count live in shared memory, the threshold filters
//   the tile's scores, survivors are
//   appended to the query's buffer in shared memory, and a buffer within
//   32 of its capacity is sorted by a warp-wide bitonic network (one
//   out-of-line function) and cut to k (nothing of size k lives in
//   registers: no spills at any k).
//   At the end each query's best k go out sorted, one list per block.
//   Pass 2 (topk_merge.cuh topk_merge_sorted_pass, shared with
//   topk_matmul.cu): one block per query merges the blocks' sorted lists
//   by their heads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_merge.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;
constexpr int TILE_MAX = 64;    // docs of a tile
constexpr int SP = TILE_MAX + 1;  // score tile row stride (floats)
constexpr int CHUNK = 64;       // slots of a staged chunk
constexpr int RING = 8;         // chunks in flight per warp
constexpr int EMPTY = -1;       // free hash-table key (terms are >= 0)

// Shared-memory layout (ops/bm25.py _k2_smem_bytes mirrors it), byte
// offsets; every part is a multiple of 16 bytes.
struct ScanLayout {
  int scores, cand_v, cand_i, ring, table, ent_slot, cacc, wts, qterm,
      qstate, hits, misc, total;
  __host__ __device__ ScanLayout(int T, int cap, int ht) {
    scores = 0;                                   // [2][32][SP] f32
    cand_v = scores + 2 * 32 * SP * 4;            // [32][cap] f32
    cand_i = cand_v + 32 * cap * 4;               // [32][cap] int
    ring = cand_i + 32 * cap * 4;                 // [WARPS][RING][2][CHUNK]
    table = ring + WARPS * RING * 2 * CHUNK * 4;  // [ht] keys, [ht] entries
    ent_slot = table + ht * 8;                    // [32 T][32] first slots
    cacc = ent_slot + 32 * T * 32;                // [WARPS][T][32] f32
    wts = cacc + WARPS * T * 32 * 4;              // [T][32] f32
    qterm = wts + T * 32 * 4;                     // [T][32] int
    qstate = qterm + T * 32 * 4;                  // [32] QueryState
    hits = qstate + 32 * 12;                      // [WARPS][32] int2
    misc = hits + WARPS * 32 * 8;                 // entry count, dup lanes
    total = misc + 16;
  }
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The term table: buckets of 4 keys (one 16-byte load probes a bucket)
// beside their entries.  Keys fill a bucket in order and a bucket is left
// only when full, so a probe stops at the first bucket with a free key.
__device__ __forceinline__ unsigned bucket_of(int term, int bshift) {
  return ((unsigned)term * 2654435761u) >> bshift;
}

// the entry of a term, or -1 (the table is at most half full)
__device__ __forceinline__ int find_entry(const int* keys, const int* ents,
                                          int bshift, int term) {
  const unsigned bmask = (1u << (32 - bshift)) - 1u;
  unsigned b = bucket_of(term, bshift);
  while (true) {
    const int4 k4 = reinterpret_cast<const int4*>(keys)[b];
    if (k4.x == term) return ents[4 * b];
    if (k4.y == term) return ents[4 * b + 1];
    if (k4.z == term) return ents[4 * b + 2];
    if (k4.w == term) return ents[4 * b + 3];
    if (k4.w == EMPTY) return -1;
    b = (b + 1u) & bmask;
  }
}

// Bitonic sort of 32 R entries held R to a lane (entry lane + 32 c in
// v[c], ix[c]) into rank order (score desc, index asc).
template <int R>
__device__ __forceinline__ void warp_rank_sort(float (&v)[R], int (&ix)[R],
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

// A query's selection state: the k-th best (score, doc) so far (the
// threshold, (-inf, INT_MAX) until there are k) and its buffer's count.
struct QueryState {
  float thr_v;
  int thr_i, n;
};

// Sort the first n entries of a query's buffer and keep the best k (out
// of line: the selection runs once a tile and its code stays small).
template <int CAP>
__device__ __noinline__ QueryState compact_query(float* bv, int* bi,
                                                 QueryState st, int k,
                                                 int lane) {
  constexpr int R = CAP / 32;
  float v[R];
  int ix[R];
  __syncwarp();  // the buffer's appends are visible
#pragma unroll
  for (int c = 0; c < R; ++c) {
    const int j = lane + 32 * c;
    v[c] = j < st.n ? bv[j] : -INFINITY;
    ix[c] = j < st.n ? bi[j] : TOPK_INT_MAX;
  }
  warp_rank_sort<R>(v, ix, lane);
  __syncwarp();  // every entry is read before any is overwritten
#pragma unroll
  for (int c = 0; c < R; ++c) {
    const int j = lane + 32 * c;
    if (j < k) {
      bv[j] = v[c];
      bi[j] = ix[c];
    }
    const float tv = __shfl_sync(FULL, v[c], (k - 1) & 31);
    const int ti = __shfl_sync(FULL, ix[c], (k - 1) & 31);
    if (c == ((k - 1) >> 5) && st.n >= k) {
      st.thr_v = tv;
      st.thr_i = ti;
    }
  }
  __syncwarp();
  st.n = min(st.n, k);
  return st;
}

// docs [first, end) of warp w in tile `tile` (clipped to valid_n)
__device__ __forceinline__ void warp_docs(int tile, int td, int w,
                                          int valid_n, int& first, int& end) {
  const int t0 = tile * td;
  first = min(t0 + (w * td) / WARPS, valid_n);
  end = min(t0 + ((w + 1) * td) / WARPS, valid_n);
}

template <int CAP>
__global__ void __launch_bounds__(NT, 2)
bm25_scan_kernel(const int* __restrict__ term_ids,
                 const float* __restrict__ impacts,
                 const int* __restrict__ q_terms,
                 const float* __restrict__ q_weights, float* cand_vals,
                 int* cand_idx, int Lp, int Q, int T, int k, int valid_n,
                 int td, int n_tiles, int ht_log2, int vec16) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ScanLayout lay(T, CAP, 1 << ht_log2);
  float* s_scores = reinterpret_cast<float*>(smem + lay.scores);
  float* s_cv = reinterpret_cast<float*>(smem + lay.cand_v);
  int* s_ci = reinterpret_cast<int*>(smem + lay.cand_i);
  int* s_keys = reinterpret_cast<int*>(smem + lay.table);
  int* s_ents = s_keys + (1 << ht_log2);
  unsigned char* s_eslot = smem + lay.ent_slot;
  float* s_w = reinterpret_cast<float*>(smem + lay.wts);
  int* s_qt = reinterpret_cast<int*>(smem + lay.qterm);
  QueryState* s_qs = reinterpret_cast<QueryState*>(smem + lay.qstate);
  int* s_misc = reinterpret_cast<int*>(smem + lay.misc);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.y * 32;
  const int ht = 1 << ht_log2;
  const int bshift = 32 - (ht_log2 - 2);  // ht / 4 buckets

  // ---- setup: the block's query terms, weights and term table ----
  for (int i = tid; i < ht; i += NT) s_keys[i] = EMPTY;
  // a lane's slot byte of an entry is 0xff where its query lacks the term
  for (int i = tid; i < 32 * T * 8; i += NT)
    reinterpret_cast<unsigned*>(s_eslot)[i] = 0xffffffffu;
  for (int i = tid; i < 32 * T; i += NT) {
    const int t = i >> 5, qq = q0 + (i & 31);
    s_qt[i] = qq < Q ? q_terms[(size_t)qq * T + t] : EMPTY;
    s_w[i] = qq < Q ? q_weights[(size_t)qq * T + t] : 0.f;
  }
  if (tid == 0) s_misc[0] = 0;
  if (tid < 32) s_qs[tid] = QueryState{-INFINITY, TOPK_INT_MAX, 0};
  __syncthreads();
  for (int i = tid; i < 32 * T; i += NT) {
    const int term = s_qt[i];
    if (term < 0) continue;
    unsigned b = bucket_of(term, bshift);
    for (int j = 0;; ++j) {
      if (j == 4) {
        j = 0;
        b = (b + 1u) & (unsigned)(ht / 4 - 1);
      }
      const int old = atomicCAS(&s_keys[4 * b + j], EMPTY, term);
      if (old == EMPTY || old == term) break;
    }
  }
  __syncthreads();
  for (int i = tid; i < ht; i += NT)
    if (s_keys[i] != EMPTY) s_ents[i] = atomicAdd(&s_misc[0], 1);
  __syncthreads();
  if (warp == 0) {
    // lane = query: an entry records the first slot of the lane's query
    // that holds its term; a second such slot marks the lane
    bool dup = false;
    for (int t = 0; t < T; ++t) {
      const int term = s_qt[t * 32 + lane];
      if (term < 0) continue;
      unsigned char* slot =
          s_eslot + find_entry(s_keys, s_ents, bshift, term) * 32;
      if (slot[lane] != 0xff)
        dup = true;
      else
        slot[lane] = (unsigned char)t;
    }
    const unsigned dups = __ballot_sync(FULL, dup);
    if (lane == 0) s_misc[1] = (int)dups;
  }
  __syncthreads();
  const unsigned dup_lanes = (unsigned)s_misc[1];

  // ---- the warp's ring: chunk (doc, c) of its docs, in consumption order
  const int nchunks = (Lp + CHUNK - 1) / CHUNK;
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(
      smem + lay.ring + warp * RING * 2 * CHUNK * 4);
  int pf_r = 0, pf_doc = 0, pf_end = 0, pf_c = 0;
  auto pf_seek = [&]() {  // first tile from round pf_r on with docs
    while (true) {
      const int tile = blockIdx.x + pf_r * gridDim.x;
      if (tile >= n_tiles) {
        pf_doc = pf_end = 0;
        return;
      }
      warp_docs(tile, td, warp, valid_n, pf_doc, pf_end);
      if (pf_doc < pf_end) {
        pf_c = 0;
        return;
      }
      ++pf_r;
    }
  };
  auto issue = [&](int slot) {
    if (pf_doc < pf_end) {
      const size_t e0 = (size_t)pf_doc * Lp + (size_t)pf_c * CHUNK;
      const int n = min(CHUNK, Lp - pf_c * CHUNK);
      const uint32_t dst_t = ring + slot * 2 * CHUNK * 4;
      const uint32_t dst_i = dst_t + CHUNK * 4;
      if (vec16) {
        // lanes 0-15 copy the chunk's term ids, lanes 16-31 its impacts
        const int j = 4 * (lane & 15);
        const int bytes = j < n ? 16 : 0;
        const size_t src = e0 + (j < n ? j : 0);
        if (lane < 16)
          cp_async16(dst_t + 4 * j, term_ids + src, bytes);
        else
          cp_async16(dst_i + 4 * j, impacts + src, bytes);
      } else {
        for (int j = lane; j < CHUNK; j += 32) {
          const int bytes = j < n ? 4 : 0;
          cp_async4(dst_t + 4 * j, term_ids + e0 + (j < n ? j : 0), bytes);
          cp_async4(dst_i + 4 * j, impacts + e0 + (j < n ? j : 0), bytes);
        }
      }
      if (++pf_c == nchunks) {
        pf_c = 0;
        if (++pf_doc == pf_end) {
          ++pf_r;
          pf_seek();
        }
      }
    }
    cp_async_commit();
  };
  pf_seek();
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) issue(i);

  float* cacc = reinterpret_cast<float*>(smem + lay.cacc) + warp * T * 32;
  for (int i = lane; i < T * 32; i += 32) cacc[i] = 0.f;
  int2* s_hit = reinterpret_cast<int2*>(smem + lay.hits) + warp * 32;
  const int* ring_g = reinterpret_cast<const int*>(
      smem + lay.ring + warp * RING * 2 * CHUNK * 4);
  int seq = 0;
  for (int r = 0; blockIdx.x + r * gridDim.x < n_tiles; ++r) {
    const int tile = blockIdx.x + r * gridDim.x;
    const int tile0 = tile * td;
    float* sc = s_scores + (r & 1) * 32 * SP;
    int first, end;
    warp_docs(tile, td, warp, valid_n, first, end);
    // ---- scoring: lane = query of the group ----
    for (int doc = first; doc < end; ++doc) {
      unsigned matched = 0u;  // slots of this lane's query that matched
      for (int c = 0; c < nchunks; ++c) {
        issue((seq + RING - 1) % RING);
        cp_async_wait<RING - 1>();
        __syncwarp();
        const int slot = seq % RING;
        const int* st = ring_g + slot * 2 * CHUNK;
        const float* si = reinterpret_cast<const float*>(st + CHUNK);
        const int n = min(CHUNK, Lp - c * CHUNK);
        for (int base = 0; base < n; base += 32) {
          const int l = base + lane;
          const int term = l < n ? st[l] : EMPTY;
          int ent = -1;
          float imp = 0.f;
          if (term >= 0) {
            ent = find_entry(s_keys, s_ents, bshift, term);
            if (ent >= 0) imp = si[l];
          }
          // the step's hits, compacted: (entry * 32, impact) each
          const unsigned hits = __ballot_sync(FULL, ent >= 0);
          if (ent >= 0)
            s_hit[__popc(hits & ((1u << lane) - 1u))] =
                make_int2(ent * 32, __float_as_int(imp));
          __syncwarp();
          const int nh = __popc(hits);
          // four hits at a time: their slot lookups are independent loads;
          // a slot's accumulator is 0 until its first hit, so a doc term
          // repeated in the row adds to the first impact
          for (int e = 0; e < nh; e += 4) {
            int sl[4];
            float im[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const bool has = e + u < nh;
              const int2 hv = has ? s_hit[e + u] : make_int2(0, 0);
              im[u] = __int_as_float(hv.y);
              sl[u] = has ? s_eslot[hv.x + lane] : 0xff;
            }
            if (dup_lanes == 0u) {
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int t = sl[u];
                if (t == 0xff) continue;
                cacc[t * 32 + lane] += im[u];
                matched |= 1u << t;
              }
            } else {
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                int t = sl[u];
                if (t == 0xff) continue;
                const int qterm = s_qt[t * 32 + lane];
                // this slot, then later slots of the query with the term
                while (t < T) {
                  cacc[t * 32 + lane] += im[u];
                  matched |= 1u << t;
                  if (!((dup_lanes >> lane) & 1u)) break;
                  do {
                    ++t;
                  } while (t < T && s_qt[t * 32 + lane] != qterm);
                }
              }
            }
          }
          __syncwarp();  // s_hit is rewritten next step
        }
        __syncwarp();  // the slot is refilled next step
        ++seq;
      }
      // the score over the matched slots in slot order, four loads ahead
      float s = 0.f;
      unsigned mm = matched;
      while (mm) {
        float w[4], cv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool has = mm != 0u;
          const int t = has ? __ffs(mm) - 1 : 0;
          mm &= mm - 1u;
          w[u] = has ? s_w[t * 32 + lane] : 0.f;
          cv[u] = has ? cacc[t * 32 + lane] : 0.f;
          if (has) cacc[t * 32 + lane] = 0.f;  // ready for the next doc
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (w[u] != 0.f || cv[u] != 0.f)
            s = __fadd_rn(s, __fmul_rn(w[u], cv[u]));
      }
      sc[lane * SP + (doc - tile0)] = s;
    }
    __syncthreads();
    // ---- selection: warp w owns queries 4w .. 4w + 3 ----
    const int ndocs = min(td, valid_n - tile0);
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      const int q = 4 * warp + j;
      if (q0 + q >= Q) break;
      float* bv = s_cv + q * CAP;
      int* bi = s_ci + q * CAP;
      QueryState st = s_qs[q];
      for (int base = 0; base < ndocs; base += 32) {
        const int jj = base + lane;
        const float v = jj < ndocs ? sc[q * SP + jj] : -INFINITY;
        const int doc = tile0 + jj;
        const bool pass = jj < ndocs && better(v, doc, st.thr_v, st.thr_i);
        const unsigned m = __ballot_sync(FULL, pass);
        if (pass) {
          const int pos = st.n + __popc(m & ((1u << lane) - 1u));
          bv[pos] = v;
          bi[pos] = doc;
        }
        st.n += __popc(m);
        if (st.n > CAP - 32) st = compact_query<CAP>(bv, bi, st, k, lane);
      }
      __syncwarp();
      if (lane == 0) s_qs[q] = st;
    }
  }

  // ---- each query's best k, sorted, as this block's list ----
#pragma unroll 1
  for (int j = 0; j < 4; ++j) {
    const int q = 4 * warp + j;
    const int qq = q0 + q;
    if (qq >= Q) break;
    float* bv = s_cv + q * CAP;
    int* bi = s_ci + q * CAP;
    const int n = compact_query<CAP>(bv, bi, s_qs[q], k, lane).n;
    const size_t base = ((size_t)blockIdx.x * Q + qq) * k;
    for (int e = lane; e < k; e += 32) {
      cand_vals[base + e] = e < n ? bv[e] : -INFINITY;
      cand_idx[base + e] = e < n ? bi[e] : TOPK_INT_MAX;
    }
  }
}

template <int CAP>
int launch_scan(const int* term_ids, const float* impacts, const int* q_terms,
                const float* q_weights, float* cv, int* ci, int Lp, int Q,
                int T, int k, int valid_n, int td, int n_tiles, int n_blocks,
                int ht_log2, int vec16, cudaStream_t s) {
  const int smem = ScanLayout(T, CAP, 1 << ht_log2).total;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        bm25_scan_kernel<CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        232448);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  if (smem > 232448) return -1;
  dim3 grid(n_blocks, (Q + 31) / 32);
  bm25_scan_kernel<CAP><<<grid, NT, smem, s>>>(
      term_ids, impacts, q_terms, q_weights, cv, ci, Lp, Q, T, k, valid_n, td,
      n_tiles, ht_log2, vec16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  if (code == -1) return "unsupported query-term count, k or launch plan";
  return cudaGetErrorString((cudaError_t)code);
}

// The launch plan (td, n_tiles, n_blocks, ht_log2) comes from
// ops/bm25.py bm25_scan_geometry; vec16 = 1 when every row chunk is 16-byte
// aligned (Lp % 4 == 0, aligned bases).  cand_* are scratch
// [n_blocks, Q, k]; out_* are [Q, k].  Returns 0, a CUDA error code or -1.
int bm25_scan_topk(const int* term_ids, const float* impacts,
                   const int* q_terms, const float* q_weights,
                   float* cand_vals, int* cand_idx, float* out_vals,
                   int* out_idx, int Lp, int Q, int T, int k, int valid_n,
                   int td, int n_tiles, int n_blocks, int ht_log2, int vec16,
                   void* stream) {
  if (T < 0 || T > 32 || k > 64 || k < 1 || Lp < 1 || td < 1 ||
      td > TILE_MAX || n_blocks < 1 || n_blocks > MERGE_SORTED_MAX_LISTS ||
      (1 << ht_log2) < 64 * T || ht_log2 > 16)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      k <= 32 ? launch_scan<64>(term_ids, impacts, q_terms, q_weights,
                                cand_vals, cand_idx, Lp, Q, T, k, valid_n, td,
                                n_tiles, n_blocks, ht_log2, vec16, s)
              : launch_scan<128>(term_ids, impacts, q_terms, q_weights,
                                 cand_vals, cand_idx, Lp, Q, T, k, valid_n,
                                 td, n_tiles, n_blocks, ht_log2, vec16, s);
  if (rc != 0) return rc;
  topk_merge_sorted_pass<<<Q, MERGE_NT, 0, s>>>(cand_vals, cand_idx, out_vals,
                                                out_idx, n_blocks, Q, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
