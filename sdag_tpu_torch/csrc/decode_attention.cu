// Kernel K7: the attention block of one decode step, for Hopper (sm_90a):
// RoPE of q and k, the step's K and V written into the cache slot, and
// each query head's GQA attention over the cache slots its row's mask marks
// valid.
//
// Replaces no Pallas kernel: the JAX package leaves decode attention
// (sdag_tpu/ops/attention.py masked_decode_attention) and decode_step's
// rope and cache update to XLA.  It was added because the port's plain
// PyTorch version of that block launched 33 kernels a layer inside the
// captured decode graph (rope 2 x 12, two index_copy_, seven for the
// attention), about 1,000 graph nodes a step of 2.4-2.8 us each, while the
// cache bytes it reads take 0.3 ms a step at the byte bound (Mistral-7B
// widths, batch 8, 928 slots).
//
// What bounds it: bytes.  Each valid K/V slot is read once (2 x B x Hkv x S
// x Dh x sizeof(T)); q, the new K/V, the f32 scores and the output are
// small beside that, and the FMA work (4 B Hq S Dh flops) is a fifth of
// the byte time on CUDA cores.  Two launches a call:
//
//   pass 1, sdag_decode_attn_scores: blocks over (split, KV head, row),
//   each taking every n_split-th 64-slot chunk of its row (chunks are fixed
//   from slot 0; n_split fills the SMs once, since B x Hkv is only 64 on
//   the serving path).  A block reads its chunks' mask bits once, rotates
//   its group's q rows (or takes them rotated), and streams its chunks' K
//   rows through a ring of cp.async stages (Dh / 16 lanes a slot, 16 dims a
//   lane; the two dims a rotation pairs lie in the same lane).  It writes
//   the f32 scores of its live chunks (-inf at masked slots), each chunk's
//   liveness and its own maximum per head.  The block whose chunk holds the
//   write slot rotates the new k, writes it and v into the cache, and
//   scores that slot from registers.  A chunk with no valid slot (prompt
//   padding, slots not yet written) reads no K.
//
//   pass 2, sdag_decode_attn_pv: one block per (32-dim slice, KV head,
//   row).  It takes each head's maximum from pass 1's blocks, sums exp(s -
//   max) over the valid slots (64 scores a thread in flight), then streams
//   its V slice of the live chunks and their scores through a ring of
//   cp.async stages (16 bytes a lane): a tile's probabilities, exp(s - max)
//   / sum rounded to T, are computed once in shared memory and every lane
//   of a slot reads them.  Sums over the block's slot groups are taken in a
//   fixed order.  The four slices recompute the same probabilities; on the
//   card a 4-block cluster a (row, KV head) over whole rows, which computes
//   each once, ran slower (PERF.md, section 6), as did deeper rings and other
//   tile sizes: at 16 warps an SM the pass issues about as long as it
//   waits on memory.
//
// Arithmetic (ops/attention.py decode_attention_reference's, bit for bit
// where stated):
//   * RoPE: angle = f32(position) * freqs[i] (the cached frequency tensor,
//     so HF llama3 scaling is served as it is), precise cosf / sinf, x1 cos
//     - x2 sin and x2 cos + x1 sin from rounded products (no FMA
//     contraction), rounded once to T: the K written equals the plain
//     rope's bit for bit, and so does the q attended;
//   * scores: f32 dot products (FMA) of the T values, times the f32 scale;
//     masked slots are excluded;
//   * softmax: max and sum in f32 over the valid slots, p = exp(s - max) /
//     sum rounded to T before the value product (the JAX op's cast);
//   * the value product sums in f32; the output is rounded to T.
// Only the order of summation differs from cuBLAS and torch.softmax.  A
// row with no valid slot outputs 0.
//
// Row independence: a row's result depends on its q, the slots its mask
// marks valid and the chunk boundaries, never on B, the group size or the
// attended length S.  Every sum runs in an order fixed by the slot index
// alone, and slots that are masked, lie past S or sit in a skipped chunk
// add exact zeros.  So a verification window's row (the attention entry:
// q given rotated, nothing written) and a decode step that see the same
// cache give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_async.cuh"

namespace {

constexpr int CHUNK = 64;         // slots a pass-1 block scores
constexpr int NT1 = 128;          // pass-1 threads
constexpr int NT2 = 256;          // pass-2 threads
constexpr int SLICE = 32;         // dims a pass-2 block accumulates
constexpr int PER2 = 4;           // slots a pass-2 lane group takes a tile
constexpr int STAGES = 3;         // chunks (tiles) a block has in flight
constexpr int MAX_PER_BLOCK = 64; // chunks a pass-1 block takes at most
constexpr int MAX_CHUNKS = 1024;  // attended slots <= 65,536
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
  __device__ static float cast(float x) { return x; }
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
  __device__ static bf16 cast(float x) { return __float2bfloat16_rn(x); }
};

__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// RoPE of one lane's 16 values: x[u] and x[u + 8] are a rotation's pair
// (dims d and d + Dh / 2); cs / sn the cosine and sine of their angle
template <typename T>
__device__ __forceinline__ void rope16(float* x, const float* cs,
                                       const float* sn) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const float x1 = x[u], x2 = x[u + 8];
    const float r1 = __fsub_rn(__fmul_rn(x1, cs[u]), __fmul_rn(x2, sn[u]));
    const float r2 = __fadd_rn(__fmul_rn(x2, cs[u]), __fmul_rn(x1, sn[u]));
    x[u] = Vec<T>::round(r1);
    x[u + 8] = Vec<T>::round(r2);
  }
}

// Pass 1.  A block takes the chunks c = split, split + n_split, ... of one
// (KV head, row).  Lane `lane` of a slot's Dh / 16 lanes holds, in load i,
// dims i * (Dh / 16) * E + lane * E .. + E - 1: loads 0 .. NL / 2 - 1
// cover the first half of the head and the rest the second, so value u
// and value u + 8 of the lane are a rotation's pair.  The block's mask
// bits are read once; K chunks stream through a ring of STAGES stages by
// cp.async, each thread reading back only its own copies (no barrier).
template <typename T, int DH, int G>
__global__ void __launch_bounds__(NT1)
sdag_decode_attn_scores(const T* __restrict__ q, long long sqb, long long sqh,
                        const T* __restrict__ k_new,
                        const T* __restrict__ v_new, long long snb,
                        long long snh, const long long* __restrict__ positions,
                        const float* __restrict__ freqs,
                        const long long* __restrict__ write_index,
                        T* k_cache, T* v_cache,
                        const uint8_t* __restrict__ mask, long long smb,
                        float* __restrict__ scores, float* __restrict__ bmax,
                        uint8_t* __restrict__ live, int Hkv, int S,
                        int S_cache, int n_chunks, int n_split, float scale) {
  using V = Vec<T>;
  constexpr int E = V::E;
  constexpr int LPS = DH / 16;       // lanes a slot
  constexpr int NL = 16 / E;         // 16-byte loads a lane a slot
  constexpr int STRIDE = LPS * E;    // dims between a lane's loads
  constexpr int NG = NT1 / LPS;      // slot groups
  constexpr int PER = CHUNK / NG;    // slots a group takes a chunk
  constexpr int PIECES = PER * NL;   // 16-byte copies a thread a chunk
  static_assert(PER >= 1 && NG * PER == CHUNK, "chunk geometry");
  extern __shared__ uint4 ring[];    // [STAGES][PIECES][NT1]
  __shared__ uint32_t mbits[2 * MAX_PER_BLOCK];
  __shared__ float wmax[NT1 / 32][G];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % LPS, gi = tid / LPS;
  const int warp = tid / 32, ln = tid % 32;
  const int nck = split < n_chunks ? (n_chunks - split + n_split - 1) / n_split
                                   : 0;
  const long long hq0 = (long long)b * Hkv * G + (long long)kvh * G;
  const long long ncs = (long long)n_chunks * CHUNK;

  // what needs no mask first: the write slot, the rotation's angles (one
  // cosine and sine a frequency, in shared memory), this lane's q
  const bool step = positions != nullptr;
  const long long w = step ? *write_index : -1;
  const long long wc = w >= 0 && w < S_cache ? w / CHUNK : -1;
  __shared__ float cs_s[DH / 2], sn_s[DH / 2];
  if (step && tid < DH / 2) {
    const float a = __fmul_rn((float)positions[b], freqs[tid]);
    cs_s[tid] = cosf(a);
    sn_s[tid] = sinf(a);
  }
  uint4 qr[G][NL];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < NL; ++i)
      qr[g][i] = ld16(q + (long long)b * sqb + (long long)(kvh * G + g) * sqh +
                      lane * E + i * STRIDE);

  // the valid bits of the block's chunks (word 2i + h: slots 32h .. 32h +
  // 31 of its chunk i), eight bytes a thread in flight at once
  const uint8_t* mrow = mask + (long long)b * smb;
  const int rounds = (nck * CHUNK + NT1 - 1) / NT1;
  for (int r0 = 0; r0 < rounds; r0 += 8) {
    uint32_t got = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int idx = (r0 + r) * NT1 + tid;
      const int j = (split + idx / CHUNK * n_split) * CHUNK + idx % CHUNK;
      if (idx < nck * CHUNK && j < S && mrow[j] != 0) got |= 1u << r;
    }
    for (int r = 0; r < 8 && r0 + r < rounds; ++r) {
      const uint32_t word = __ballot_sync(FULL, (got >> r) & 1u);
      if (ln == 0) mbits[(r0 + r) * (NT1 / 32) + warp] = word;
    }
  }
  __syncthreads();

  const long long head = (long long)b * Hkv + kvh;
  T* krow = k_cache + head * S_cache * DH + lane * E;
  auto issue = [&](int i) {
    if (i < nck && (mbits[2 * i] | mbits[2 * i + 1])) {
      const int c = split + i * n_split;
      uint4* st = ring + (i % STAGES) * PIECES * NT1 + tid;
#pragma unroll
      for (int it = 0; it < PER; ++it) {
        const int jj = it * NG + gi;
        const bool ok = (mbits[2 * i + jj / 32] >> (jj % 32)) & 1u;
        const T* src = ok ? krow + (long long)(c * CHUNK + jj) * DH : krow;
#pragma unroll
        for (int n = 0; n < NL; ++n)
          cp_async16(smem_u32(st + (it * NL + n) * NT1), src + n * STRIDE,
                     ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  float cs[8], sn[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int d = (u / E) * STRIDE + lane * E + u % E;
    cs[u] = step ? cs_s[d] : 0.f;
    sn[u] = step ? sn_s[d] : 0.f;
  }
  float qf[G][16];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < NL; ++i) V::unpack(qr[g][i], qf[g] + i * E);
    if (step) rope16<T>(qf[g], cs, sn);
  }

  float mx[G];
#pragma unroll
  for (int g = 0; g < G; ++g) mx[g] = -INFINITY;
  for (int i = 0; i < nck; ++i) {
    issue(i + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    const int c = split + i * n_split;
    const uint32_t w0 = mbits[2 * i], w1 = mbits[2 * i + 1];
    if (kvh == 0 && tid == 0) live[(long long)b * n_chunks + c] = (w0 | w1) != 0;
    const bool wchunk = c == wc;
    if (!(w0 | w1) && !wchunk) continue;
    const uint4* st = ring + (i % STAGES) * PIECES * NT1 + tid;
    uint4 kr[PER][NL];
#pragma unroll
    for (int it = 0; it < PER; ++it)
#pragma unroll
      for (int n = 0; n < NL; ++n) kr[it][n] = st[(it * NL + n) * NT1];

    // the write slot's lanes: rotate the new k, write k and v, and score
    // the slot from the rotated values (the ring holds it stale)
    if (wchunk && (int)(w - c * CHUNK) % NG == gi) {
      const int wit = (int)(w - c * CHUNK) / NG;
      const T* kp = k_new + (long long)b * snb + (long long)kvh * snh + lane * E;
      const T* vp = v_new + (long long)b * snb + (long long)kvh * snh + lane * E;
      float x[16];
#pragma unroll
      for (int n = 0; n < NL; ++n) V::unpack(ld16(kp + n * STRIDE), x + n * E);
      rope16<T>(x, cs, sn);
      T* vrow = v_cache + head * S_cache * DH + lane * E;
#pragma unroll
      for (int n = 0; n < NL; ++n) {
        const uint4 kn = V::pack(x + n * E);
        *reinterpret_cast<uint4*>(krow + w * DH + n * STRIDE) = kn;
        *reinterpret_cast<uint4*>(vrow + w * DH + n * STRIDE) =
            ld16(vp + n * STRIDE);
#pragma unroll
        for (int it = 0; it < PER; ++it)
          if (it == wit) kr[it][n] = kn;
      }
    }

    float* srow = scores + hq0 * ncs + (long long)c * CHUNK;
#pragma unroll
    for (int it = 0; it < PER; ++it) {
      const int jj = it * NG + gi;
      const bool ok = ((jj < 32 ? w0 : w1) >> (jj % 32)) & 1u;
      float kf[16];
#pragma unroll
      for (int n = 0; n < NL; ++n) V::unpack(kr[it][n], kf + n * E);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float a = 0.f;
#pragma unroll
        for (int u = 0; u < 16; ++u) a = fmaf(qf[g][u], kf[u], a);
#pragma unroll
        for (int off = LPS / 2; off > 0; off >>= 1)
          a += __shfl_xor_sync(FULL, a, off);
        const float sg = ok ? __fmul_rn(a, scale) : -INFINITY;
        mx[g] = fmaxf(mx[g], sg);
        if (lane == 0) srow[g * ncs + jj] = sg;
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx[g] = fmaxf(mx[g], __shfl_xor_sync(FULL, mx[g], off));
  }
  if (ln == 0)
#pragma unroll
    for (int g = 0; g < G; ++g) wmax[warp][g] = mx[g];
  __syncthreads();
  if (tid < G) {
    float m = wmax[0][tid];
    for (int k = 1; k < NT1 / 32; ++k) m = fmaxf(m, wmax[k][tid]);
    bmax[(hq0 + tid) * n_split + split] = m;
  }
}

// G values of every thread reduced over the block (max or sum): the lanes
// of a warp by a fixed xor tree, then the warps in order.  Every thread
// returns with the results in `res`.
template <int G, bool MAX>
__device__ __forceinline__ void block_reduce(float (&v)[G],
                                             float (*buf)[G], float* res) {
  const int warp = threadIdx.x / 32, ln = threadIdx.x % 32;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(FULL, v[g], off);
      v[g] = MAX ? fmaxf(v[g], o) : v[g] + o;
    }
  }
  if (ln == 0)
#pragma unroll
    for (int g = 0; g < G; ++g) buf[warp][g] = v[g];
  __syncthreads();
  if (threadIdx.x < G) {
    float a = buf[0][threadIdx.x];
    for (int w = 1; w < NT2 / 32; ++w)
      a = MAX ? fmaxf(a, buf[w][threadIdx.x]) : a + buf[w][threadIdx.x];
    res[threadIdx.x] = a;
  }
  __syncthreads();
}

// Pass 2.  Lane group gi (SLICE / E lanes, 16 bytes each) takes slots
// t0 + it * NG + gi of the tile at t0.  A tile's V slice and its scores
// stream through a ring of STAGES stages by cp.async; each thread turns
// the scores it copied into probabilities in place, and one barrier a
// tile publishes them.
template <typename T, int G>
struct PvGeom {
  static constexpr int E = Vec<T>::E;
  static constexpr int LPS = SLICE / E;        // lanes a slot
  static constexpr int NG = NT2 / LPS;         // slot groups
  static constexpr int TILE = NG * PER2;       // slots a tile
  static constexpr int QUADS = G * TILE / 4;   // 16-byte score copies a tile
  static constexpr int VSTAGE = PER2 * NT2;    // 16-byte V copies a tile
  static constexpr int SMEM = STAGES * (VSTAGE + QUADS) * 16;
};

template <typename T, int G>
__global__ void __launch_bounds__(NT2, 2)
sdag_decode_attn_pv(const T* __restrict__ v_cache,
                    const float* __restrict__ scores,
                    const float* __restrict__ bmax,
                    const uint8_t* __restrict__ live, T* __restrict__ out,
                    long long sob, long long soh, int Hkv, int DH, int S,
                    int S_cache, int n_chunks, int n_split) {
  using V = Vec<T>;
  using P = PvGeom<T, G>;
  constexpr int E = P::E, LPS = P::LPS, NG = P::NG, TILE = P::TILE;
  constexpr int QUADS = P::QUADS, VSTAGE = P::VSTAGE;
  constexpr int QT = (QUADS + NT2 - 1) / NT2;  // score copies a thread
  constexpr int SU = 64 / G;                   // slots a thread sums at once
  constexpr int NW = NT2 / 32;
  static_assert(TILE % CHUNK == 0, "tile geometry");
  extern __shared__ uint4 ring[];  // [STAGES][VSTAGE] V, [STAGES][QUADS] s
  __shared__ float red[NW][G][SLICE];
  __shared__ float wred[NW][G];
  __shared__ float M_s[G], L_s[G];
  __shared__ uint8_t live_s[MAX_CHUNKS];

  const int sl = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % LPS, gi = tid / LPS;
  const int warp = tid / 32, ln = tid % 32;
  const long long hq0 = (long long)b * Hkv * G + (long long)kvh * G;
  const long long ncs = (long long)n_chunks * CHUNK;
  const float* srow = scores + hq0 * ncs;

  float m[G];
#pragma unroll
  for (int g = 0; g < G; ++g) m[g] = -INFINITY;
  for (int k = tid; k < n_split; k += NT2)
#pragma unroll
    for (int g = 0; g < G; ++g) m[g] = fmaxf(m[g], bmax[(hq0 + g) * n_split + k]);
  for (int c = tid; c < n_chunks; c += NT2)
    live_s[c] = live[(long long)b * n_chunks + c];
  block_reduce<G, true>(m, wred, M_s);

  const T* vrow = v_cache + ((long long)b * Hkv + kvh) * S_cache * DH +
                  sl * SLICE + lane * E;
  uint4* sring = ring + STAGES * VSTAGE;
  const int ntiles = (S + TILE - 1) / TILE;
  auto issue = [&](int n) {
    if (n < ntiles) {
      uint4* vst = ring + (n % STAGES) * VSTAGE + tid;
#pragma unroll
      for (int it = 0; it < PER2; ++it) {
        const int j = n * TILE + it * NG + gi;
        const bool ok = j < S && live_s[j / CHUNK];
        cp_async16(smem_u32(vst + it * NT2), ok ? vrow + (long long)j * DH : vrow,
                   ok ? 16 : 0);
      }
      uint4* sst = sring + (n % STAGES) * QUADS;
#pragma unroll
      for (int k = 0; k < QT; ++k) {
        const int qd = k * NT2 + tid;
        const int g = qd / (TILE / 4), j = n * TILE + qd % (TILE / 4) * 4;
        const bool ok = qd < QUADS && j < S && live_s[j / CHUNK];
        if (qd < QUADS)
          cp_async16(smem_u32(sst + qd), ok ? srow + g * ncs + j : srow,
                     ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int n = 0; n < STAGES - 1; ++n) issue(n);

  // each head's sum of exp(s - max) over the valid slots: thread tid takes
  // slots tid, tid + NT2, ... in order, SU of them loaded at once
  float l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) l[g] = 0.f;
  for (int j0 = 0; j0 < S; j0 += SU * NT2) {
    float sv[SU][G];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int j = j0 + u * NT2 + tid;
      const bool ok = j < S && live_s[j / CHUNK];
#pragma unroll
      for (int g = 0; g < G; ++g) sv[u][g] = ok ? srow[g * ncs + j] : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < SU; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (sv[u][g] != -INFINITY) l[g] += expf(__fsub_rn(sv[u][g], M_s[g]));
  }
  block_reduce<G, false>(l, wred, L_s);

  float acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  for (int n = 0; n < ntiles; ++n) {
    cp_async_wait<STAGES - 2>();
    float4* sst = reinterpret_cast<float4*>(sring + (n % STAGES) * QUADS);
#pragma unroll
    for (int k = 0; k < QT; ++k) {
      const int qd = k * NT2 + tid;
      if (qd >= QUADS) continue;
      const int g = qd / (TILE / 4), j = n * TILE + qd % (TILE / 4) * 4;
      const bool ok = j < S && live_s[j / CHUNK];
      const float4 sv = sst[qd];
      const float x[4] = {sv.x, sv.y, sv.z, sv.w};
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = ok && j + i < S && x[i] != -INFINITY
                   ? V::round(__fdiv_rn(expf(__fsub_rn(x[i], M_s[g])), L_s[g]))
                   : 0.f;
      sst[qd] = make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();
    issue(n + STAGES - 1);
    const uint4* vst = ring + (n % STAGES) * VSTAGE + tid;
    const float* ps = reinterpret_cast<const float*>(sst);
#pragma unroll
    for (int it = 0; it < PER2; ++it) {
      float vf[E];
      V::unpack(vst[it * NT2], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = ps[g * TILE + it * NG + gi];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int off = LPS; off < 32; off <<= 1)
        acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], off);
  if (ln < LPS)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e) red[warp][g][ln * E + e] = acc[g][e];
  __syncthreads();
  for (int idx = tid; idx < G * SLICE; idx += NT2) {
    const int g = idx / SLICE, d = idx % SLICE;
    float a = red[0][g][d];
    for (int k = 1; k < NW; ++k) a += red[k][g][d];
    out[(long long)b * sob + (long long)(kvh * G + g) * soh + sl * SLICE + d] =
        V::cast(a);
  }
}

struct Args {
  const void* q;
  long long sqb, sqh;
  const void* k_new;
  const void* v_new;
  long long snb, snh;
  const long long* positions;
  const float* freqs;
  const long long* write_index;
  void* k_cache;
  void* v_cache;
  const uint8_t* mask;
  long long smb;
  float* scores;
  float* bmax;
  uint8_t* live;
  void* out;
  long long sob, soh;
  int B, Hkv, S, S_cache, n_chunks, n_split;
  float scale;
};

// raise a kernel's dynamic shared-memory limit once per instantiation
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

template <typename T, int DH, int G>
int launch(const Args& a, cudaStream_t s) {
  static int allowed1 = 0, allowed2 = 0;
  const int smem1 = STAGES * CHUNK * DH * (int)sizeof(T);
  const int smem2 = PvGeom<T, G>::SMEM;
  cudaError_t e = allow_smem(sdag_decode_attn_scores<T, DH, G>, smem1, allowed1);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(sdag_decode_attn_pv<T, G>, smem2, allowed2);
  if (e != cudaSuccess) return (int)e;
  sdag_decode_attn_scores<T, DH, G>
      <<<dim3(a.n_split, a.Hkv, a.B), NT1, smem1, s>>>(
          static_cast<const T*>(a.q), a.sqb, a.sqh,
          static_cast<const T*>(a.k_new), static_cast<const T*>(a.v_new),
          a.snb, a.snh, a.positions, a.freqs, a.write_index,
          static_cast<T*>(a.k_cache), static_cast<T*>(a.v_cache), a.mask,
          a.smb, a.scores, a.bmax, a.live, a.Hkv, a.S, a.S_cache, a.n_chunks,
          a.n_split, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sdag_decode_attn_pv<T, G><<<dim3(DH / SLICE, a.Hkv, a.B), NT2, smem2, s>>>(
      static_cast<const T*>(a.v_cache), a.scores, a.bmax, a.live,
      static_cast<T*>(a.out), a.sob, a.soh, a.Hkv, DH, a.S, a.S_cache,
      a.n_chunks, a.n_split);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_g(const Args& a, int G, cudaStream_t s) {
  switch (G) {
    case 1: return launch<T, DH, 1>(a, s);
    case 2: return launch<T, DH, 2>(a, s);
    case 4: return launch<T, DH, 4>(a, s);
    case 8: return launch<T, DH, 8>(a, s);
  }
  return -1;
}

template <typename T>
int launch_dh(const Args& a, int G, int DH, cudaStream_t s) {
  switch (DH) {
    case 32: return launch_g<T, 32>(a, G, s);
    case 64: return launch_g<T, 64>(a, G, s);
    case 128: return launch_g<T, 128>(a, G, s);
  }
  return -1;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int code) {
  if (code == -1)
    return "unsupported head dim, group size, dtype or attended slot count";
  return cudaGetErrorString((cudaError_t)code);
}

// One decode step's attention block (positions != NULL: rotate q and k at
// positions[b], write k and v into slot *write_index, attend) or the
// attention alone (positions, k_new, v_new, freqs and write_index NULL: q
// given rotated, nothing written).  q [B, Hkv * G, DH] and out (same shape)
// by batch / head strides, k_new / v_new [B, Hkv, DH] likewise, the caches
// [B, Hkv, S_cache, DH] contiguous, mask [B, >= S] bytes by row stride, the
// first S slots attended.  Scratch: scores f32 [B, Hkv * G, n_chunks * 64],
// bmax f32 [B, Hkv * G, n_split], live bytes [B, n_chunks]; n_chunks =
// ceil(S / 64); pass 1 runs n_split blocks a (row, KV head), each on at
// most 64 chunks.  dtype 0 = float32, 1 = bfloat16.  Returns 0, a CUDA
// error code or -1.
int decode_attention(const void* q, long long sqb, long long sqh,
                     const void* k_new, const void* v_new, long long snb,
                     long long snh, const void* positions, const void* freqs,
                     const void* write_index, void* k_cache, void* v_cache,
                     const void* mask, long long smb, void* scores, void* bmax,
                     void* live, void* out, long long sob, long long soh,
                     int B, int Hkv, int G, int DH, int S, int S_cache,
                     int n_split, int dtype, float scale, void* stream) {
  const int n_chunks = (S + CHUNK - 1) / CHUNK;
  if (S < 1 || S > S_cache || n_chunks > MAX_CHUNKS || B < 1 || Hkv < 1 ||
      n_split < 1 || n_split > n_chunks ||
      n_split * MAX_PER_BLOCK < n_chunks)
    return -1;
  Args a{q, sqb, sqh, k_new, v_new, snb, snh,
         static_cast<const long long*>(positions),
         static_cast<const float*>(freqs),
         static_cast<const long long*>(write_index), k_cache, v_cache,
         static_cast<const uint8_t*>(mask), smb, static_cast<float*>(scores),
         static_cast<float*>(bmax), static_cast<uint8_t*>(live), out, sob,
         soh, B, Hkv, S, S_cache, n_chunks, n_split, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float>(a, G, DH, s);
  if (dtype == 1) return launch_dh<bf16>(a, G, DH, s);
  return -1;
}

}  // extern "C"
