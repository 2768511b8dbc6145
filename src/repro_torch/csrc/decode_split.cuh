// Split-KV body of the single-token GQA decode kernels (flash-decoding),
// shared by the dense-cache kernel (decode_attention.cu) and the paged one
// (paged_attention.cu).  A thread block serves one chunk of the keys of one
// (slot b, KV head): it attends the G query heads of the group to the
// chunk's rows and leaves a partial softmax state (m, l, acc); the last
// block of the (b, KV head) to finish combines the partial states in split
// order.
//
// Bound: decode attention moves every valid KV byte once and does ~4*G
// flops per byte pair, far below the ~295 flop/byte ridge of an H100, so
// the floor is (bytes of K and V below `length`) / 3.35 TB/s.  What held a
// one-block-per-(b, KV head) body back was latency, not bytes: 32 blocks on
// 132 SMs, each with 8 rows in flight, and a dependent chain of load,
// shuffle reduction and `expf` per row.  Here:
//  - the grid is (splits, K, B); at the decode path's main shape (B = 4,
//    K = 8, 1088 keys a slot, lengths 577-1041) 64-key splits make 544
//    blocks, 432 of them with keys, and 128-key splits 288 and 224, so
//    every SM holds one or more;
//  - a block copies each 64-row tile of K and V into shared memory with
//    16-byte `cp.async` copies from every thread, each row found through
//    a row map (the chunk's page ids for the paged kernel, a fixed stride
//    for the dense one);
//  - a chunk of two tiles runs through a ring of S = 2 stages (the dense
//    kernel), so the second tile's load overlaps the first's arithmetic;
//    a one-tile chunk takes S = 1 (the paged kernel);
//  - the online softmax rescales once per tile, not once per row.
// The combine needs no second launch: each block with keys writes its
// partial state to scratch, and the one that takes the last ticket of a
// per-(b, KV head) counter reads all of them back in split order (so the
// result does not depend on which block finishes last), writes the output
// and resets the counter for the next launch.  A slot whose keys fit one
// split writes its output directly; a length-0 slot returns zeros.
//
// Numerics follow the Pallas kernels: scores in fp32 as dot(q, k) /
// sqrt(hd), an fp32 online softmax started at m = -1e30, and
// out = acc / max(l, 1e-30).
#pragma once

#include "decode_attention_common.cuh"
#include "hopper.cuh"

namespace decode_attn {

constexpr int kTileKeys = 64;      // K/V rows per shared-memory tile
constexpr int kMaxSplitPages = 64; // page ids a block keeps
constexpr int kMaxSmem = 232448;   // an H100 block's shared-memory limit

// Scratch of one launch: partial states (B, K, splits, G * (HD + 2)) in
// fp32, acc first, then m[G] and l[G]; one counter per (b, KV head), zero
// between launches.
struct SplitScratch {
  float* partial;
  unsigned* counters;
  int splits;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Two neighbouring values as fp32.
__device__ __forceinline__ void load_pair(const float* p, float2& x) {
  x = *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float2& x) {
  x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Shared memory of the split body, in bytes: S stages of a K tile and a V
// tile of kTileKeys rows, each row padded by 32 bytes so the score loop's
// 16-byte reads of neighbouring rows are free of bank conflicts; then q,
// the tile's probabilities and the softmax statistics.
template <typename T, int G, int HD, int S>
struct SplitLayout {
  static constexpr int LD = HD + 32 / static_cast<int>(sizeof(T));
  static constexpr int KV = kTileKeys * LD * static_cast<int>(sizeof(T));
  static constexpr int STAGE = 2 * KV;                    // K, then V
  static constexpr int Q_OFF = S * STAGE;                 // float q[G][HD]
  static constexpr int P_OFF = Q_OFF + G * HD * 4;        // float p[G][tile]
  static constexpr int STAT_OFF = P_OFF + G * kTileKeys * 4;   // m, l, alpha
  static constexpr int BYTES = STAT_OFF + 3 * G * 4 + 16;
  // Key groups of P V: each group's HD / 2 threads hold one column pair
  // each; 2 * kThreads / HD groups, rounded down, so where HD does not
  // divide 2 * kThreads (HD = 96: 2 groups of 48 threads) the last
  // threads hold no column pair.
  static constexpr int KG = 2 * kThreads / HD;
  static_assert(S == 1 || S == 2, "ring depth");
  static_assert(KG >= 1 && HD % Vec<T>::N == 0, "head_dim");
  static_assert(KG * G * HD * 4 <= S * STAGE, "reduction buffer");
  static_assert(2 * kTileKeys == kThreads, "two threads per key");
};

// This thread's share of the (G, HD) query tile, as fp32, loaded before the
// block knows whether it has keys, so the load overlaps the length's.
template <typename T, int G, int HD>
struct QShare {
  static constexpr int N = (G * HD + kThreads - 1) / kThreads;
  float x[N];
  __device__ __forceinline__ void load(const T* __restrict__ q) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * kThreads;
      x[j] = i < G * HD ? to_float(q[i]) : 0.f;
    }
  }
  __device__ __forceinline__ void stage(float* sq) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < G * HD) sq[i] = x[j];
    }
  }
};

template <int G>
constexpr int combine_bytes(int splits) {
  return (2 * splits + 1) * G * 4;
}

// Copy tile i of rows [t_begin, t_end) of k and v (rows t_begin +
// i * kTileKeys on, each found through `rows`: row t -> element offset of
// (t, kvh, 0)) into stage i % S, 16 bytes a `cp.async` from every thread,
// as one cp.async group.
template <typename T, int G, int HD, int S, class Rows>
__device__ __forceinline__ void load_tile(const T* __restrict__ k,
                                          const T* __restrict__ v,
                                          int t_begin, int t_end,
                                          const Rows& rows, uint8_t* smem,
                                          int i) {
  using L = SplitLayout<T, G, HD, S>;
  constexpr int VEC = Vec<T>::N;           // values per 16 bytes
  constexpr int CPR = HD / VEC;            // 16-byte pieces per row
  T* sk = reinterpret_cast<T*>(smem + (i % S) * L::STAGE);
  T* sv = reinterpret_cast<T*>(smem + (i % S) * L::STAGE + L::KV);
  const int t0 = t_begin + i * kTileKeys;
  const int n = min(kTileKeys, t_end - t0);
  for (int j = threadIdx.x; j < n * CPR; j += kThreads) {
    const int r = j / CPR;
    const int c = (j - r * CPR) * VEC;
    const int64_t off = rows(t0 + r) + c;
    hopper::cp_async_16(hopper::smem_addr(sk + r * L::LD + c), k + off, 16);
    hopper::cp_async_16(hopper::smem_addr(sv + r * L::LD + c), v + off, 16);
  }
  hopper::cp_async_commit();
}

// Attend the query tile (staged by QShare into shared memory at Q_OFF) to
// rows [t_begin, t_end) of k and v, addressed through `rows`, on a ring of
// S stages: tile i + S is requested as soon as tile i's buffers are free.
// Whatever `rows` reads from shared memory is written before the call.  On
// return, shared memory holds m[G] and l[G] at STAT_OFF and acc[G][HD]
// (fp32) at offset 0.
template <typename T, int G, int HD, int S, class Rows>
__device__ __forceinline__ void split_attend(const T* __restrict__ k,
                                             const T* __restrict__ v,
                                             int t_begin, int t_end,
                                             const Rows& rows, uint8_t* smem) {
  using L = SplitLayout<T, G, HD, S>;
  constexpr int VEC = Vec<T>::N;           // values per 16 bytes
  constexpr int CPR = HD / VEC;            // 16-byte pieces per row
  const float* sq = reinterpret_cast<const float*>(smem + L::Q_OFF);
  float* sp = reinterpret_cast<float*>(smem + L::P_OFF);
  float* s_m = reinterpret_cast<float*>(smem + L::STAT_OFF);
  float* s_l = s_m + G;
  float* s_alpha = s_l + G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float scale = rsqrtf(static_cast<float>(HD));

  if (tid < G) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }
  __syncthreads();   // q, the caller's row table and the stats are in place
  const int n_tiles = (t_end - t_begin + kTileKeys - 1) / kTileKeys;
  for (int i = 0; i < min(S, n_tiles); ++i)
    load_tile<T, G, HD, S>(k, v, t_begin, t_end, rows, smem, i);
  // P V: this thread's column pair and key group; a thread of no group
  // (kg >= KG) takes no key but reaches every barrier.
  const int dp = tid % (HD / 2);
  const int kg = tid / (HD / 2);
  const int kg_first = kg < L::KG ? kg : kTileKeys;
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;

  int i = 0;
  for (int t0 = t_begin; t0 < t_end; t0 += kTileKeys, ++i) {
    const int n = min(kTileKeys, t_end - t0);
    const T* sk = reinterpret_cast<const T*>(smem + (i % S) * L::STAGE);
    const T* sv = reinterpret_cast<const T*>(smem + (i % S) * L::STAGE + L::KV);
    if (S == 2 && i + 1 < n_tiles)
      hopper::cp_async_wait<1>();   // tile i + 1 stays in flight
    else
      hopper::cp_async_wait<0>();
    __syncthreads();

    // Scores: two threads per key, each over every other 16-byte piece.
    {
      const int key = tid >> 1;
      const int half = tid & 1;
      float d[G];
#pragma unroll
      for (int g = 0; g < G; ++g) d[g] = 0.f;
      if (key < n) {
#pragma unroll 4
        for (int c = half; c < CPR; c += 2) {
          float kx[VEC];
          load_vec(sk + key * L::LD + c * VEC, kx);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4* q4 =
                reinterpret_cast<const float4*>(sq + g * HD + c * VEC);
#pragma unroll
            for (int e = 0; e < VEC / 4; ++e) {
              const float4 qq = q4[e];
              d[g] = fmaf(qq.x, kx[4 * e], d[g]);
              d[g] = fmaf(qq.y, kx[4 * e + 1], d[g]);
              d[g] = fmaf(qq.z, kx[4 * e + 2], d[g]);
              d[g] = fmaf(qq.w, kx[4 * e + 3], d[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        d[g] += __shfl_xor_sync(0xffffffffu, d[g], 1);
        if (key < n && half == 0) sp[g * kTileKeys + key] = d[g] * scale;
      }
    }
    __syncthreads();

    // Online softmax of the tile, one warp per head.
    for (int g = warp; g < G; g += kNumWarps) {
      const float x0 = lane < n ? sp[g * kTileKeys + lane] : kNegInf;
      const float x1 = lane + 32 < n ? sp[g * kTileKeys + lane + 32] : kNegInf;
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_old = s_m[g];
      const float mn = fmaxf(m_old, mx);
      const float p0 = lane < n ? expf(x0 - mn) : 0.f;
      const float p1 = lane + 32 < n ? expf(x1 - mn) : 0.f;
      sp[g * kTileKeys + lane] = p0;
      sp[g * kTileKeys + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      if (lane == 0) {
        const float alpha = expf(m_old - mn);
        s_alpha[g] = alpha;
        s_l[g] = s_l[g] * alpha + sum;
        s_m[g] = mn;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over this thread's keys kg, kg + KG, ...
#pragma unroll
    for (int g = 0; g < G; ++g) {
      acc[g][0] *= s_alpha[g];
      acc[g][1] *= s_alpha[g];
    }
    for (int key = kg_first; key < n; key += L::KG) {
      float2 vv;
      load_pair(sv + key * L::LD + 2 * dp, vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pg = sp[g * kTileKeys + key];
        acc[g][0] = fmaf(pg, vv.x, acc[g][0]);
        acc[g][1] = fmaf(pg, vv.y, acc[g][1]);
      }
    }
    __syncthreads();   // the tile's buffers are free again
    if (i + S < n_tiles)
      load_tile<T, G, HD, S>(k, v, t_begin, t_end, rows, smem, i + S);
  }

  // Sum the key groups' partial accumulators into acc[G][HD] at offset 0.
  float* red = reinterpret_cast<float*>(smem);
  if (kg < L::KG) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      red[(kg * G + g) * HD + 2 * dp] = acc[g][0];
      red[(kg * G + g) * HD + 2 * dp + 1] = acc[g][1];
    }
  }
  __syncthreads();
  for (int j = tid; j < G * HD; j += kThreads) {
    float a = red[j];
#pragma unroll
    for (int r = 1; r < L::KG; ++r) a += red[r * G * HD + j];
    red[j] = a;   // row r = 0 of the buffer; only this thread reads index j
  }
  __syncthreads();
}

// Write the result of split `split` of (b, KV head) `bk`: directly when the
// slot has one split with keys, else through the partial states and the
// last-block combine.  `n_active` splits hold keys; out is the (G, HD)
// output tile; S is the ring depth split_attend ran with.  The combine
// needs combine_bytes(splits) of shared memory.
template <typename T, int G, int HD, int S>
__device__ __forceinline__ void split_finish(T* __restrict__ out, int split,
                                             int n_active, int64_t bk,
                                             const SplitScratch& scratch,
                                             uint8_t* smem) {
  using L = SplitLayout<T, G, HD, S>;
  constexpr int PART = G * (HD + 2);
  const float* acc = reinterpret_cast<const float*>(smem);
  const float* s_m = reinterpret_cast<const float*>(smem + L::STAT_OFF);
  const float* s_l = s_m + G;
  const int tid = threadIdx.x;
  if (n_active == 1) {
    for (int i = tid; i < G * HD; i += kThreads)
      store(out + i, acc[i] / fmaxf(s_l[i / HD], 1e-30f));
    return;
  }
  float* part = scratch.partial + (bk * scratch.splits + split) * PART;
  for (int i = tid; i < G * HD; i += kThreads) part[i] = acc[i];
  if (tid < G) {
    part[G * HD + tid] = s_m[tid];
    part[G * HD + G + tid] = s_l[tid];
  }
  __threadfence();   // the partial state is visible before the ticket
  __syncthreads();
  __shared__ int last;
  if (tid == 0)
    last = atomicAdd(scratch.counters + bk, 1u) == static_cast<unsigned>(n_active - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Read every split's (m, l) at once, weight the splits per head, then
  // sum the accumulators; all in split order.  Shared memory holds
  // 2 * n_active * G + G floats (the launch sizes it for the grid's splits).
  const float* base = scratch.partial + bk * scratch.splits * PART;
  float* c_m = reinterpret_cast<float*>(smem);   // m, then the weights
  float* c_l = c_m + n_active * G;
  float* c_den = c_l + n_active * G;
  for (int i = tid; i < n_active * G; i += kThreads) {
    const float* pj = base + (i / G) * PART + G * HD + i % G;
    c_m[i] = __ldcg(pj);
    c_l[i] = __ldcg(pj + G);
  }
  __syncthreads();
  if (tid < G) {
    float mx = kNegInf;
    for (int j = 0; j < n_active; ++j) mx = fmaxf(mx, c_m[j * G + tid]);
    float lsum = 0.f;
    for (int j = 0; j < n_active; ++j) {
      const float w = expf(c_m[j * G + tid] - mx);
      c_m[j * G + tid] = w;
      lsum += c_l[j * G + tid] * w;
    }
    c_den[tid] = fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    float a = 0.f;
#pragma unroll 4
    for (int j = 0; j < n_active; ++j)
      a += __ldcg(base + j * PART + i) * c_m[j * G + g];
    store(out + i, a / c_den[g]);
  }
  if (tid == 0) scratch.counters[bk] = 0u;   // ready for the next launch
}

}  // namespace decode_attn
