// Kernel K8: the expert layer of one decode step, for Hopper (sm_90a):
// each row's routing, a work list of the experts the rows picked, the
// SwiGLU experts streamed by persistent blocks, each row's weighted sum;
// no host value (a CUDA graph captures it).
//
// Replaces no Pallas kernel: the JAX package serves dense decoders only.
// It was added because a decode step's expert layer has data-dependent
// shapes (which experts, how many rows each), which a captured graph cannot
// take from the host, and because its weights are nearly all of a step's
// bytes: at batch 8 and top 8 of 64 experts (2,304 x 896), a layer's 64
// picks name 16-40 experts, 12.4 MB each in bf16.
//
// What bounds it: bytes.  Each picked expert's three matrices are read
// once a step whatever the rows that picked it, an expert nobody picked
// costs nothing; the products, 2 x 3 x d x F flops a pick, are hundreds
// of times fewer than the bytes allow on the tensor cores.  So the design
// keeps every SM's share of the weight stream in flight, spends no SM on
// an expert nobody picked, and keeps the instructions a weight byte costs
// few.  Four launches a call:
//
//   sdag_moe_route: blocks over (32 slices of d, 8 rows).  A block stages
//   its slice of the router and of x in shared memory and sums x[b, kk] *
//   router[kk, e] in f32 (fmaf, kk ascending).  The last block of a row
//   group to finish (an atomic ticket) adds the 32 partials in slice
//   order, takes the softmax over all E in f32 and the top k by a warp's k
//   argmax rounds (ties to the lower expert), divided by their sum where
//   norm_topk; a row not live picks nothing (expert -1).  The last row
//   group builds the work list: the distinct picked experts in ascending
//   order, each expert's picks (b * k + j) in pick order, and their count,
//   which it adds to the distinct-expert counter.  Tickets reset
//   themselves.
//
//   sdag_moe_gate_up: a persistent block an SM over tiles (picked expert,
//   4 columns of F) in list order, block i taking the i-th of gridDim.x
//   equal runs, so every block streams the same bytes whatever the
//   experts.  A producer thread fills a ring of shared-memory slots with
//   bulk copies (cp.async.bulk on mbarriers), a tile a slot: its 8 rows (4
//   gate, 4 up, interleaved), d bf16 each, padded so the mma's loads miss
//   no bank; first it copies x's B rows after the ring, where they fit.
//   A consumer warp a slot takes its tiles in turn, and the producer
//   refills each slot as soon as its warp frees it, whatever the others:
//   mma.sync m16n8k16 with the picks' x rows (16 picks a group) as A and
//   the tile's rows as B; then h = SiLU(gate) * up in f32 for each pick,
//   stored as three bf16 parts whose sum is h exactly.  The ring does not
//   drain between tiles or experts.
//
//   sdag_moe_down: the same over (picked expert, 8 rows of down); before
//   each expert of its run the producer copies the picks' h parts after
//   the ring (where they fit), once every consumer warp is done with the
//   last expert's.  Each pick's eight down products in f32 into y.
//
//   sdag_moe_combine: out[b, c] = sum_j w[b, j] * y[b k + j, c] in f32 in
//   slot order, rounded once to bf16 (0 for a row not live).  Folded into
//   down (the last expert of a column tile sums it) it cost each down
//   tile a memory fence, more than this launch.
//
// The mma (bf16 in, f32 out): a k step of 16 columns permutes its columns
// alike in A and B so that a lane reads each row's four columns by one
// 8-byte load; the tensor core truncates as it accumulates, so 4 steps
// (64 columns) are summed on a fresh accumulator, two such chains at a
// time, and each is added in f32.  With at most 8 picks, down puts a
// pick's h part 0 in A's row g and part 1 in row g + 8 (two mmas a step,
// not three).
//
// Arithmetic (ops/moe.py moe_experts_reference's, up to the order of
// sums): bf16 inputs, products exact in f32, f32 sums, SiLU in f32, h and
// the down products kept in f32 (h's three bf16 parts are exact), one
// rounding at the end.  The order of every sum is fixed by d and F alone:
// a slice's columns, then the 32 slices; 16 columns a k step on the
// tensor core, 64-column blocks added in order, h's parts from the
// smallest; the rows' k terms in slot order.  No float atomics: the bits
// of a row depend on its own picks only, never on the other rows, on B,
// or on which block, tile or mma row ran them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NT_ROUTE = 256;     // the router's blocks: 8 warps
constexpr int SLICES = 32;        // slices of d the logits are summed in
constexpr int ROUTE_CHUNK = 256;  // router rows a route block stages, x EP
constexpr int RG = 8;             // rows of a router block (a warp each)
constexpr int NCW = 16;           // consumer warps of an expert block
constexpr int NT_STREAM = (NCW + 1) * 32;   // + one producer warp
constexpr int TILE_ROWS = 8;      // weight rows a tile: the mma's n
constexpr int GU_COLS = TILE_ROWS / 2;      // a gate/up tile's columns of F
constexpr int GROUP = 16;         // picks an mma takes: its m
constexpr int MAX_SLOTS = NCW;    // a ring's slots: one consumer warp each
constexpr int BAR_BYTES = 1024;    // the ring's barriers, then the rows'

constexpr int MAX_ROWS = 1024;    // rows a call
constexpr int MAX_TOPK = 32;
constexpr int MAX_E = 256;
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on sm_90

// Bytes between rows of n bf16 in shared memory (a tile's, or staged x or
// h): the row, padded so that its 32-bit words are 8 more than a multiple
// of 16, so that the 8 rows an mma reads by 8-byte loads (each half-warp 4
// rows of 8 words) fall on distinct banks.
__host__ __device__ __forceinline__ int row_stride(int n) {
  return 2 * n + 4 * ((8 - n / 2 % 16 + 16) % 16);
}

// The columns of d in each of the logits' slices: slice s sums
// [s * len, (s + 1) * len) within d, len a multiple of 8.
__host__ __device__ __forceinline__ int slice_len(int d) {
  return ((d + SLICES - 1) / SLICES + 7) / 8 * 8;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// D[16, 8] += A[16, 16] * B[16, 8] on the tensor cores: bf16 operands,
// products exact in f32, f32 sums.  Lane l (g = l / 4, t = l % 4) holds
// a0 = A[g][2t, 2t + 1], a1 = A[g + 8][2t, ..], a2 = A[g][2t + 8, ..],
// a3 = A[g + 8][2t + 8, ..]; b0 = B[2t, 2t + 1][g], b1 = B[2t + 8, ..][g];
// d = D[g][2t, 2t + 1], D[g + 8][2t, 2t + 1] (lower index in the low half).
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// h in f32 as three bf16 parts whose sum is h exactly (8 + 8 + 8 bits of
// a 24-bit significand), each in its plane hp + q * plane: the down
// products of h stay exact in f32.
__device__ __forceinline__ void store_split3(bf16* hp, long long plane,
                                             float v) {
  const bf16 a = __float2bfloat16_rn(v);
  const float r = v - __bfloat162float(a);
  const bf16 b = __float2bfloat16_rn(r);
  hp[0] = a;
  hp[plane] = b;
  hp[2 * plane] = __float2bfloat16_rn(r - __bfloat162float(b));
}

// The work list in int32 scratch: [0] the distinct experts n; [1, 1 + E)
// the experts in ascending order; [1 + E, 2 + 2E) where each one's picks
// start (n + 1 entries); then the picks, grouped by expert.
struct WorkList {
  int n;
  const int* expert;
  const int* start;
  const int* picks;
};

__device__ __forceinline__ WorkList read_list(const int* list, int E) {
  return {__ldg(list), list + 1, list + 1 + E, list + 2 + 2 * E};
}

// The run of n_items that block blockIdx.x takes: [lo, hi).
__device__ __forceinline__ void block_run(int n_items, int& lo, int& hi) {
  lo = (int)((long long)n_items * blockIdx.x / gridDim.x);
  hi = (int)((long long)n_items * (blockIdx.x + 1) / gridDim.x);
}

// The ring's barriers sit before its slots: full[s] completes when slot s
// holds its tile's bytes, empty[s] when its consumer has read them.  Tile
// r of a block's run goes to slot r % n_slots and to consumer warp
// r % n_slots: a slot has one consumer, which waits on each of its phases
// in turn, so a wait never meets a barrier two phases behind.
struct Ring {
  unsigned char* slots;
  uint32_t bars;
  int slot_bytes;
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (32 + s); }
  // the staged rows (x, or an expert's h): landed, and read by every
  // consumer warp
  __device__ uint32_t rows_full() const { return bars + 8 * 64; }
  __device__ uint32_t rows_empty() const { return bars + 8 * 65; }
  __device__ uint32_t slot(int s) const {
    return smem_u32(slots + (size_t)s * slot_bytes);
  }
};

__device__ Ring ring_init(unsigned char* smem, int n_slots, int slot_bytes) {
  Ring r{smem + BAR_BYTES, smem_u32(smem), slot_bytes};
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_slots; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), 1);
    }
    mbar_init(r.rows_full(), 1);
    mbar_init(r.rows_empty(), n_slots);
    mbar_init_fence();
  }
  __syncthreads();
  return r;
}

// The producer's loop: tile r of the block's run (r < n) goes to slot (and
// warp) r % n_slots; each slot's next tile is issued as soon as its warp
// has freed it, whatever the other slots (load(s, r) issues tile r into
// slot s, its bytes counted on full(s); hook() runs before each round).
template <typename Load, typename Hook>
__device__ __forceinline__ void produce(const Ring& ring, int n_slots, int n,
                                        Load load, Hook hook) {
  int next[MAX_SLOTS];
#pragma unroll
  for (int s = 0; s < MAX_SLOTS; ++s) next[s] = s;
  for (int left = n; left > 0;) {
    hook();
#pragma unroll
    for (int s = 0; s < MAX_SLOTS; ++s) {
      if (s >= n_slots || next[s] >= n) continue;
      const int u = next[s] / n_slots;
      if (u > 0 && !mbar_test(ring.empty(s), (u & 1) ^ 1)) continue;
      load(s, next[s]);
      next[s] += n_slots;
      --left;
    }
  }
}

// A consumer lane's two picks of an expert's group of up to GROUP from its
// q-th (rows g and g + 8 of the mma's A; past the group's end they repeat
// its last pick, whose products are computed and not written).
__device__ __forceinline__ int group_picks(const WorkList& L, int slot, int q,
                                           int g, int& pa, int& pb) {
  const int p0 = L.start[slot] + q;
  const int nr = min(GROUP, L.start[slot + 1] - p0);
  pa = L.picks[p0 + min(g, nr - 1)];
  pb = L.picks[p0 + min(g + 8, nr - 1)];
  return nr;
}

// Build the work list from the routes idx(p), p < P (-1: no pick), by the 8
// warps of one block: per-warp counts over runs of the picks, the
// experts' order and starts (warp 0), then each warp places its run in
// pick order.  Adds the distinct experts to *reads.
template <typename Idx>
__device__ void build_list(Idx idx, int P, int E, int* __restrict__ list,
                           unsigned long long* reads) {
  __shared__ int cur[NT_ROUTE / 32][MAX_E];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int NW = NT_ROUTE / 32;
  for (int i = threadIdx.x; i < NW * MAX_E; i += NT_ROUTE)
    cur[i / MAX_E][i % MAX_E] = 0;
  __syncthreads();
  const int run = (P + NW * 32 - 1) / (NW * 32) * 32;
  const int p_lo = min(P, warp * run), p_hi = min(P, p_lo + run);
  for (int base = p_lo; base < p_hi; base += 32) {
    const int p = base + lane;
    const int e = p < p_hi ? idx(p) : -1;
    const unsigned m = __match_any_sync(FULL, e);
    if (e >= 0 && lane == __ffs(m) - 1) cur[warp][e] += __popc(m);
    __syncwarp();
  }
  __syncthreads();
  int* expert = list + 1;
  int* start = list + 1 + E;
  if (warp == 0) {
    const int ep = E / 32;
    int used = 0, picked = 0;
    for (int i = 0; i < ep; ++i) {
      int t = 0;
      for (int v = 0; v < NW; ++v) t += cur[v][lane * ep + i];
      used += t > 0;
      picked += t;
    }
    int u0 = used, p0 = picked;   // inclusive scans over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(FULL, u0, o), b = __shfl_up_sync(FULL, p0, o);
      if (lane >= o) {
        u0 += a;
        p0 += b;
      }
    }
    int slot = u0 - used, off = p0 - picked;
    for (int i = 0; i < ep; ++i) {
      const int e = lane * ep + i;
      int t = 0;
      for (int v = 0; v < NW; ++v) {   // counts become each warp's cursor
        const int c = cur[v][e];
        cur[v][e] = off + t;
        t += c;
      }
      if (t > 0) {
        expert[slot] = e;
        start[slot] = off;
        ++slot;
      }
      off += t;
    }
    if (lane == 31) {
      list[0] = u0;
      start[u0] = p0;
      if (reads != nullptr) *reads += (unsigned long long)u0;
    }
  }
  __syncthreads();
  int* picks = list + 2 + 2 * E;
  const unsigned below = (1u << lane) - 1u;
  for (int base = p_lo; base < p_hi; base += 32) {
    const int p = base + lane;
    const int e = p < p_hi ? idx(p) : -1;
    const unsigned m = __match_any_sync(FULL, e);
    if (e >= 0) picks[cur[warp][e] + __popc(m & below)] = p;
    __syncwarp();
    if (e >= 0 && lane == __ffs(m) - 1) cur[warp][e] += __popc(m);
    __syncwarp();
  }
}

// state: [0] the row groups' ticket, [1 + g] row group g's slice ticket.
template <int EP>
__global__ void __launch_bounds__(NT_ROUTE)
sdag_moe_route(const bf16* __restrict__ x, long long sx,
               const bf16* __restrict__ router,
               const uint8_t* __restrict__ live, int B, int d, int k,
               int norm, float* __restrict__ part, int* __restrict__ idx,
               float* __restrict__ w, int* __restrict__ list,
               int* __restrict__ state, unsigned long long* reads) {
  constexpr int E = 32 * EP;
  __shared__ int s_last;
  __shared__ int s_idx[RG * MAX_TOPK];   // one row group's picks
  constexpr int CHUNK = ROUTE_CHUNK / EP;        // 16 KB of router rows
  __shared__ __align__(16) bf16 rs[CHUNK * E];   // router rows of a chunk
  __shared__ __align__(16) bf16 xs[RG * CHUNK];  // the rows' x there
  const int s = blockIdx.x, g = blockIdx.y;
  const int e = threadIdx.x % E, b0 = g * RG + threadIdx.x / E * EP;
  const int len = slice_len(d), k_lo = min(d, s * len);
  const int k_hi = min(d, k_lo + len);
  float acc[EP];
#pragma unroll
  for (int j = 0; j < EP; ++j) acc[j] = 0.f;
  for (int c0 = k_lo; c0 < k_hi; c0 += CHUNK) {
    const int n = min(CHUNK, k_hi - c0);   // a multiple of 8
    const uint4* rg = reinterpret_cast<const uint4*>(router + (long long)c0 * E);
    for (int i = threadIdx.x; i < n * E / 8; i += NT_ROUTE)
      reinterpret_cast<uint4*>(rs)[i] = __ldg(rg + i);
    for (int i = threadIdx.x; i < RG * n / 8; i += NT_ROUTE) {
      const int b = g * RG + i / (n / 8), c = i % (n / 8);
      reinterpret_cast<uint4*>(xs)[i] =
          b < B ? __ldg(reinterpret_cast<const uint4*>(
                      x + (long long)b * sx + c0) + c)
                : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < n; ++kk) {
      const float r = __bfloat162float(rs[kk * E + e]);
#pragma unroll
      for (int j = 0; j < EP; ++j)
        acc[j] = fmaf(__bfloat162float(xs[(b0 - g * RG + j) * n + kk]), r,
                      acc[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < EP; ++j)
    if (b0 + j < B) part[((long long)(b0 + j) * E + e) * SLICES + s] = acc[j];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(state + 1 + g, 1) == SLICES - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = g * RG + warp;
  if (b < B) {
    float p[EP];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < EP; ++i) {
      const float4* q = reinterpret_cast<const float4*>(
          part + ((long long)b * E + lane * EP + i) * SLICES);
      float4 v[SLICES / 4];   // the 32 partials at once, summed in order
#pragma unroll
      for (int u = 0; u < SLICES / 4; ++u) v[u] = __ldcg(q + u);
      float t = v[0].x;
      t += v[0].y;
      t += v[0].z;
      t += v[0].w;
#pragma unroll
      for (int u = 1; u < SLICES / 4; ++u) {
        t += v[u].x;
        t += v[u].y;
        t += v[u].z;
        t += v[u].w;
      }
      p[i] = t;
      mx = fmaxf(mx, t);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
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
      if (gridDim.y == 1) s_idx[warp * k + lane] = on ? sel_i : -1;
    }
  }
  if (gridDim.y > 1) {   // the last row group to finish builds the list
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      s_last = atomicAdd(state, 1) == (int)gridDim.y - 1;
    __syncthreads();
    if (!s_last) {
      if (threadIdx.x == 0) state[1 + g] = 0;
      return;
    }
    __threadfence();
    if (threadIdx.x == 0) state[0] = state[1 + g] = 0;
    build_list([&](int p) { return __ldcg(idx + p); }, B * k, E, list, reads);
  } else {
    __syncthreads();
    if (threadIdx.x == 0) state[1] = 0;
    build_list([&](int p) { return s_idx[p]; }, B * k, E, list, reads);
  }
}

// Where the mma's A rows come from: rows of x or of h's parts staged in
// shared memory, or in device memory.  A lane reads its row at columns
// k0 + 4t .. k0 + 4t + 3 of each 16-column step by one 8-byte load: the
// step's k order is permuted alike in A and B (hardware column 2t + e is
// column 4t + e, column 2t + 8 + e is 4t + 2 + e), which sums the same
// 16 products.
__device__ __forceinline__ uint2 pair(const unsigned char* row, int k0) {
  return *reinterpret_cast<const uint2*>(row + 2 * k0);
}
__device__ __forceinline__ uint2 pair(const bf16* row, int k0) {
  return __ldg(reinterpret_cast<const uint2*>(row + k0));
}

// A lane's A rows (g and g + 8) of each of PARTS parts, and its B row.
template <int PARTS, typename A>
struct Operands {
  A ra[PARTS], rb[PARTS];
  const unsigned char* w;
};

// One 16-column step at column k0 (this lane's 4t already added) onto
// t[q] (q the part); where !on, this lane's columns lie past the row's end
// (lanes t >= 2 of an 8-column last step) and count as zero.
template <int PARTS, bool TWO, typename A>
__device__ __forceinline__ void mma_step(float (&t)[PARTS][4],
                                         const Operands<PARTS, A>& o, int k0,
                                         bool on) {
  const uint2 zero = make_uint2(0u, 0u);
  const uint2 b = on ? pair(o.w, k0) : zero;
#pragma unroll
  for (int q = 0; q < PARTS; ++q) {
    const uint2 a = on ? pair(o.ra[q], k0) : zero;
    const uint2 c = TWO && on ? pair(o.rb[q], k0) : zero;
    mma16816(t[q], a.x, c.x, a.y, c.y, b.x, b.y);
  }
}

// acc += A * B over n columns (rows g, g + 8 of A's parts, a tile's 8 rows
// as B).  The tensor core truncates as it accumulates, so it sums 4 steps
// (64 columns) a part on a fresh accumulator, two such blocks at a time,
// and adds each block to acc in f32 (round to nearest): blocks in column
// order, within a block the parts from the smallest.
template <int PARTS, bool TWO, typename A>
__device__ __forceinline__ void dots(float (&acc)[4],
                                     const Operands<PARTS, A>& o, int n,
                                     int t4) {
  auto add = [&](float (&v)[PARTS][4]) {
#pragma unroll
    for (int q = PARTS - 1; q >= 0; --q)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += v[q][i];
  };
  const int n16 = n / 16 * 16;
  int k0 = 0;
  for (; k0 + 128 <= n16; k0 += 128) {
    float u[PARTS][4] = {}, v[PARTS][4] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mma_step<PARTS, TWO>(u, o, k0 + 16 * j + t4, true);
      mma_step<PARTS, TWO>(v, o, k0 + 64 + 16 * j + t4, true);
    }
    add(u);
    add(v);
  }
  float u[PARTS][4] = {};
  for (; k0 < n16; k0 += 16) mma_step<PARTS, TWO>(u, o, k0 + t4, true);
  if (n16 < n) mma_step<PARTS, TWO>(u, o, n16 + t4, t4 < 8);
  add(u);
}

// Down's dots for up to 8 picks: one mma takes each pick's h part 0 (A
// row g) and part 1 (row g + 8), a second its part 2 (row g; rows g + 8
// zero), so that a lane's (g, 2t..) sum is its rows g and g + 8 of the
// first plus row g of the second.  As dots: 4 steps a chain, two blocks
// at a time, each block added to acc (acc[0..1]) from the smallest part.
template <typename A>
__device__ __forceinline__ void down_dots8(float (&acc)[4],
                                          const Operands<3, A>& o, int n,
                                          int t4) {
  auto step = [&](float (&t)[2][4], int k0, bool on) {
    const uint2 zero = make_uint2(0u, 0u);
    const uint2 b = on ? pair(o.w, k0) : zero;
    const uint2 a0 = on ? pair(o.ra[0], k0) : zero;
    const uint2 a1 = on ? pair(o.ra[1], k0) : zero;
    const uint2 a2 = on ? pair(o.ra[2], k0) : zero;
    mma16816(t[0], a0.x, a1.x, a0.y, a1.y, b.x, b.y);
    mma16816(t[1], a2.x, 0u, a2.y, 0u, b.x, b.y);
  };
  auto add = [&](float (&v)[2][4]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) acc[i] += v[1][i];      // part 2
#pragma unroll
    for (int i = 0; i < 2; ++i) acc[i] += v[0][2 + i];  // part 1
#pragma unroll
    for (int i = 0; i < 2; ++i) acc[i] += v[0][i];      // part 0
  };
  const int n16 = n / 16 * 16;
  int k0 = 0;
  for (; k0 + 128 <= n16; k0 += 128) {
    float u[2][4] = {}, v[2][4] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      step(u, k0 + 16 * j + t4, true);
      step(v, k0 + 64 + 16 * j + t4, true);
    }
    add(u);
    add(v);
  }
  float u[2][4] = {};
  for (; k0 < n16; k0 += 16) step(u, k0 + t4, true);
  if (n16 < n) step(u, n16 + t4, t4 < 8);
  add(u);
}

// A tile: an expert's GU_COLS columns c.. of F, its gate and up rows
// interleaved (row 2j gate c + j, row 2j + 1 up c + j) as the mma's B, so
// that a lane's D holds gate and up of column c + t for its picks.
__global__ void __launch_bounds__(NT_STREAM, 1)
sdag_moe_gate_up(const bf16* __restrict__ x, long long sx, int B,
                 const bf16* __restrict__ gate_up,
                 const int* __restrict__ list, int E, int k, int d, int f,
                 int n_slots, int staged, bf16* __restrict__ hp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WorkList L = read_list(list, E);
  const int per_e = f / GU_COLS;
  int lo, hi;
  block_run(L.n * per_e, lo, hi);
  if (lo >= hi) return;
  const int stride = row_stride(d), row_bytes = d * (int)sizeof(bf16);
  const Ring ring = ring_init(smem, n_slots, TILE_ROWS * stride);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // x's B rows in shared memory after the ring (where the plan fits them),
  // copied before the first tile
  unsigned char* xs = ring.slots + (size_t)n_slots * ring.slot_bytes;
  if (warp == NCW) {
    if (lane == 0 && staged) {
      mbar_arrive_expect_tx(ring.rows_full(), B * row_bytes);
      for (int b = 0; b < B; ++b)
        bulk_load(smem_u32(xs + (size_t)b * stride), x + b * sx, row_bytes,
                  ring.rows_full());
    }
    if (lane == 0)
      produce(ring, n_slots, hi - lo, [&](int s, int r) {
        const int i = lo + r;
        const bf16* gr = gate_up + ((long long)L.expert[i / per_e] * 2 * f
                                    + (long long)(i % per_e) * GU_COLS) * d;
        mbar_arrive_expect_tx(ring.full(s), TILE_ROWS * row_bytes);
        for (int j = 0; j < GU_COLS; ++j) {
          bulk_load(ring.slot(s) + 2 * j * stride, gr + (long long)j * d,
                    row_bytes, ring.full(s));
          bulk_load(ring.slot(s) + (2 * j + 1) * stride,
                    gr + ((long long)f + j) * d, row_bytes, ring.full(s));
        }
      }, [] {});
    return;
  }
  if (staged && warp < n_slots) mbar_wait(ring.rows_full(), 0);
  const int g = lane / 4, t4 = 4 * (lane % 4);
  const long long plane = (long long)B * k * f;
  for (int i = lo + warp; warp < n_slots && i < hi; i += n_slots) {
    const int r = i - lo, s = r % n_slots, slot = i / per_e;
    const int c = i % per_e * GU_COLS;
    const int n = L.start[slot + 1] - L.start[slot];
    mbar_wait(ring.full(s), (r / n_slots) & 1);
    const unsigned char* w =
        ring.slots + (size_t)s * ring.slot_bytes + g * stride;
    for (int q = 0; q < n; q += GROUP) {
      int pa, pb;
      const int nr = group_picks(L, slot, q, g, pa, pb);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (staged) {
        const Operands<1, const unsigned char*> o{
            {xs + (size_t)(pa / k) * stride}, {xs + (size_t)(pb / k) * stride},
            w};
        if (nr > 8)
          dots<1, true>(acc, o, d, t4);
        else
          dots<1, false>(acc, o, d, t4);
      } else {
        const Operands<1, const bf16*> o{{x + (long long)(pa / k) * sx},
                                         {x + (long long)(pb / k) * sx}, w};
        if (nr > 8)
          dots<1, true>(acc, o, d, t4);
        else
          dots<1, false>(acc, o, d, t4);
      }
      const int col = c + t4 / 4;
      if (g < nr)
        store_split3(hp + (long long)pa * f + col, plane,
                     acc[0] / (1.f + expf(-acc[0])) * acc[1]);
      if (g + 8 < nr)
        store_split3(hp + (long long)pb * f + col, plane,
                     acc[2] / (1.f + expf(-acc[2])) * acc[3]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty(s));
  }
}

// A tile: an expert's TILE_ROWS rows c.. of down (columns of d) as the
// mma's B, each pick's h as its three bf16 parts (A; three products a
// step, two where a group has at most 8 picks).  The block's run goes
// expert by expert; where the plan fits them, the consumers stage the
// expert's picks' h parts in shared memory first.
__global__ void __launch_bounds__(NT_STREAM, 1)
sdag_moe_down(const bf16* __restrict__ down, const int* __restrict__ list,
              const bf16* __restrict__ hp, int E, int B, int k, int d, int f,
              int n_slots, int staged, float* __restrict__ y) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WorkList L = read_list(list, E);
  const int per_e = d / TILE_ROWS;
  int lo, hi;
  block_run(L.n * per_e, lo, hi);
  if (lo >= hi) return;
  const int stride = row_stride(f), row_bytes = f * (int)sizeof(bf16);
  const Ring ring = ring_init(smem, n_slots, TILE_ROWS * stride);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // staged: part q of the expert's j-th pick at hs + (q B + j) * stride,
  // copied by the producer for each expert of the run in turn, once every
  // consumer warp is done with the last one's
  unsigned char* hs = ring.slots + (size_t)n_slots * ring.slot_bytes;
  const long long plane = (long long)B * k * f;
  const int seg0 = lo / per_e, n_segs = (hi - 1) / per_e - seg0 + 1;
  if (warp == NCW) {
    if (lane == 0) {
      int seg = 0;
      auto stage = [&] {   // the h of the run's next expert, when free
        if (!staged || seg == n_segs
            || (seg > 0 && !mbar_test(ring.rows_empty(), (seg - 1) & 1)))
          return;
        const int p0 = L.start[seg0 + seg];
        const int n = L.start[seg0 + seg + 1] - p0;
        mbar_arrive_expect_tx(ring.rows_full(), 3 * n * row_bytes);
        for (int q = 0; q < 3; ++q)
          for (int j = 0; j < n; ++j)
            bulk_load(smem_u32(hs + (size_t)(q * B + j) * stride),
                      hp + q * plane + (long long)L.picks[p0 + j] * f,
                      row_bytes, ring.rows_full());
        ++seg;
      };
      produce(ring, n_slots, hi - lo, [&](int s, int r) {
        const int i = lo + r;
        const bf16* src = down + ((long long)L.expert[i / per_e] * d
                                  + (long long)(i % per_e) * TILE_ROWS) * f;
        mbar_arrive_expect_tx(ring.full(s), TILE_ROWS * row_bytes);
        for (int j = 0; j < TILE_ROWS; ++j)
          bulk_load(ring.slot(s) + j * stride, src + (long long)j * f,
                    row_bytes, ring.full(s));
      }, stage);
      while (staged && seg < n_segs) stage();
    }
    return;
  }
  if (warp >= n_slots) return;
  const int g = lane / 4, t4 = 4 * (lane % 4);
  for (int seg = lo; seg < hi;) {
    const int slot = seg / per_e, seg_end = min(hi, (slot + 1) * per_e);
    const int n = L.start[slot + 1] - L.start[slot];
    // every consumer warp waits for each expert's h in turn, so that no
    // wait meets the barrier two phases behind
    if (staged) mbar_wait(ring.rows_full(), (slot - seg0) & 1);
    // this warp's tiles of the expert: r = i - lo = warp (mod n_slots)
    int i = seg + ((warp - (seg - lo)) % n_slots + n_slots) % n_slots;
    for (; i < seg_end; i += n_slots) {
      const int r = i - lo, s = r % n_slots, c0 = i % per_e * TILE_ROWS;
      mbar_wait(ring.full(s), (r / n_slots) & 1);
      const unsigned char* wt =
          ring.slots + (size_t)s * ring.slot_bytes + g * stride;
      for (int q = 0; q < n; q += GROUP) {
        int pa, pb;
        const int nr = group_picks(L, slot, q, g, pa, pb);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        if (staged) {
          const int ja = q + min(g, nr - 1), jb = q + min(g + 8, nr - 1);
          Operands<3, const unsigned char*> o;
#pragma unroll
          for (int u = 0; u < 3; ++u) {
            o.ra[u] = hs + (size_t)(u * B + ja) * stride;
            o.rb[u] = hs + (size_t)(u * B + jb) * stride;
          }
          o.w = wt;
          if (nr > 8)
            dots<3, true>(acc, o, f, t4);
          else
            down_dots8(acc, o, f, t4);
        } else {
          Operands<3, const bf16*> o;
#pragma unroll
          for (int u = 0; u < 3; ++u) {
            o.ra[u] = hp + u * plane + (long long)pa * f;
            o.rb[u] = hp + u * plane + (long long)pb * f;
          }
          o.w = wt;
          if (nr > 8)
            dots<3, true>(acc, o, f, t4);
          else
            down_dots8(acc, o, f, t4);
        }
        const int col = c0 + t4 / 2;
        if (g < nr)
          *reinterpret_cast<float2*>(y + (long long)pa * d + col) =
              make_float2(acc[0], acc[1]);
        if (g + 8 < nr)
          *reinterpret_cast<float2*>(y + (long long)pb * d + col) =
              make_float2(acc[2], acc[3]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(ring.empty(s));
    }
    __syncwarp();
    if (staged && lane == 0) mbar_arrive(ring.rows_empty());
    seg = seg_end;
  }
}

// out[b, c] = sum_j w[b, j] * y[b k + j, c] in f32 in slot order, rounded
// once to bf16 (0 for a row not live): a thread a column, a block row of
// 256 columns.
__global__ void __launch_bounds__(NT_ROUTE)
sdag_moe_combine(const int* __restrict__ idx, const float* __restrict__ w,
                 const float* __restrict__ y, int k, int d,
                 bf16* __restrict__ out) {
  const int b = blockIdx.y, c = blockIdx.x * NT_ROUTE + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int j = 0; j < k; ++j) {
    const int p = b * k + j;
    if (idx[p] >= 0) s += w[p] * y[(long long)p * d + c];
  }
  out[(long long)b * d + c] = __float2bfloat16(s);
}

// Lets `kernel` take `bytes` of dynamic shared memory, and asks for the
// least shared-memory carve-out that holds them, so that the rest of the
// SM's 256 KB stays L1.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int& allowed) {
  if (bytes == allowed) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const int percent = (int)((100LL * (bytes + 1024) + SMEM_LIMIT - 1)
                            / SMEM_LIMIT);
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           percent < 100 ? percent : 100);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  if (code == -1)
    return "unsupported expert count, top k, widths, row count or plan";
  return cudaGetErrorString((cudaError_t)code);
}

// One decode step's expert layer.  x [B, d] bf16 by row stride sx
// (elements); router [d, E], gate_up [E, 2F, d] (gate rows, then up rows),
// down [E, d, F] bf16 contiguous; live bytes [B] or NULL (every row).
// Outputs: idx int32 [B, k] and w f32 [B, k] (the routes), out [B, d]
// bf16; reads a uint64 counter or NULL.  Scratch: fs f32 of
// 32 B E + B k d + 3 B k F / 2 (the logits' partials by slice, y, then h
// as three bf16 planes), is int32 of 2 + 2E + B k (the work list); state
// int32 [1 + 128], zero before the first call (the route's tickets, which
// reset themselves; one call at a time a state).  The plan: grid blocks
// of the expert passes, gu_slots and down_slots slots of their rings,
// whether x's rows and h are staged after them.  E in {64, 128, 256},
// k <= 32, d and F multiples of 8, B <= 1024.  Returns 0, a CUDA error
// code or -1.
int moe_experts(const void* x, const void* router, const void* gate_up,
                const void* down, const void* live, void* idx, void* w,
                void* fs, void* is, void* state, void* out, void* reads,
                int B, int d, int f, int E, int k, int sx, int norm, int grid,
                int gu_slots, int down_slots, int x_staged, int h_staged,
                void* stream) {
  const int gu_smem = BAR_BYTES + gu_slots * TILE_ROWS * row_stride(d)
                      + (x_staged ? B * row_stride(d) : 0);
  const int down_smem = BAR_BYTES + down_slots * TILE_ROWS * row_stride(f)
                        + (h_staged ? 3 * B * row_stride(f) : 0);
  if (B < 1 || B > MAX_ROWS || k < 1 || k > MAX_TOPK || k > E || d % 8 ||
      f % 8 || d < 8 || f < 8 || grid < 1 || gu_slots < 1 ||
      gu_slots > MAX_SLOTS || down_slots < 1 || down_slots > MAX_SLOTS ||
      gu_smem > SMEM_LIMIT || down_smem > SMEM_LIMIT)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t* lv = static_cast<const uint8_t*>(live);
  int* ib = static_cast<int*>(idx);
  float* wb = static_cast<float*>(w);
  const int P = B * k;
  float* part = static_cast<float*>(fs);
  float* y = part + (long long)SLICES * B * E;
  bf16* hp = reinterpret_cast<bf16*>(y + (long long)P * d);
  int* list = static_cast<int*>(is);
  int* tickets = static_cast<int*>(state);
  auto* rd = static_cast<unsigned long long*>(reads);
  bf16* ob = static_cast<bf16*>(out);
  const dim3 route_grid(SLICES, (B + RG - 1) / RG);
  switch (E) {
    case 64:
      sdag_moe_route<2><<<route_grid, NT_ROUTE, 0, st>>>(
          xb, sx, static_cast<const bf16*>(router), lv, B, d, k, norm, part,
          ib, wb, list, tickets, rd);
      break;
    case 128:
      sdag_moe_route<4><<<route_grid, NT_ROUTE, 0, st>>>(
          xb, sx, static_cast<const bf16*>(router), lv, B, d, k, norm, part,
          ib, wb, list, tickets, rd);
      break;
    case 256:
      sdag_moe_route<8><<<route_grid, NT_ROUTE, 0, st>>>(
          xb, sx, static_cast<const bf16*>(router), lv, B, d, k, norm, part,
          ib, wb, list, tickets, rd);
      break;
    default:
      return -1;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  static int allowed_gu = 0, allowed_down = 0;
  e = allow_smem(sdag_moe_gate_up, gu_smem, allowed_gu);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(sdag_moe_down, down_smem, allowed_down);
  if (e != cudaSuccess) return (int)e;
  sdag_moe_gate_up<<<grid, NT_STREAM, gu_smem, st>>>(
      xb, sx, B, static_cast<const bf16*>(gate_up), list, E, k, d, f,
      gu_slots, x_staged, hp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sdag_moe_down<<<grid, NT_STREAM, down_smem, st>>>(
      static_cast<const bf16*>(down), list, hp, E, B, k, d, f, down_slots,
      h_staged, y);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sdag_moe_combine<<<dim3((d + NT_ROUTE - 1) / NT_ROUTE, B), NT_ROUTE, 0,
                     st>>>(ib, wb, y, k, d, ob);
  return (int)cudaGetLastError();
}

}  // extern "C"
