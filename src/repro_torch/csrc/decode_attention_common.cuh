// Shared body of the single-token GQA decode-attention kernels (dense and
// paged KV).  One thread block serves one (slot b, KV head): the G query
// heads of that KV group sit in registers, and the block's warps stride
// over the slot's valid KV rows with 16-byte loads, each row read once.
//
// Bound: decode attention moves every valid KV byte once and does ~4*G
// flops per byte pair, far below the ~295 flop/byte ridge of an H100, so
// the floor is (bytes of K and V below `length`) / 3.35 TB/s.  This design
// reads exactly those bytes (rows past `length` are never loaded, as the
// TPU kernel skips whole blocks past it).  Its grid is (K, B), 32 blocks at
// B=4 and K=8 on 132 SMs, so most of the card idles; splitting the KV axis
// across blocks (flash-decoding) is the next step and is not done here.
//
// Numerics follow the Pallas kernels: scores in fp32 as dot(q, k) / sqrt(hd),
// an fp32 online softmax (m, l, acc) started at m = -1e30, and
// out = acc / max(l, 1e-30), so a row with length 0 returns zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace decode_attn {

constexpr int kNumWarps = 4;
constexpr int kThreads = kNumWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr int kUnsupported = -1;   // returned for a (dtype, hd, G) not built

// 16-byte vectors: 4 fp32 or 8 bf16 values per lane.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ void load_vec(const float* p, float (&x)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  x[0] = r.x;
  x[1] = r.y;
  x[2] = r.z;
  x[3] = r.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Dense cache (B, T, K, hd): row t of slot b, KV head kvh.
struct DenseRows {
  int64_t slot_base;   // b * T
  int num_kv;          // K
  int kvh;
  int hd;
  __device__ __forceinline__ int64_t operator()(int t) const {
    return ((slot_base + t) * num_kv + kvh) * hd;
  }
};

// Page pool (N, block, K, hd) through the slot's page-table row; entries
// are clamped into [0, N-1] (page 0 is the trash page).
struct PagedRows {
  const int* table_row;   // table + b * W
  int num_pages;          // N
  int block;
  int num_kv;
  int kvh;
  int hd;
  __device__ __forceinline__ int64_t operator()(int t) const {
    int page = table_row[t / block];
    page = min(max(page, 0), num_pages - 1);
    return ((static_cast<int64_t>(page) * block + t % block) * num_kv + kvh) * hd;
  }
};

// q, out: the (G, HD) query/output tile of this (b, kvh); k, v: the KV
// tensors, addressed through `rows`; rows [0, length) are attended.
template <typename T, int G, int HD, class Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       T* __restrict__ out, int length,
                                       const Rows& rows) {
  constexpr int VEC = Vec<T>::N;
  constexpr int LPR = HD / VEC;            // lanes per KV row
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "head_dim");
  constexpr int RPW = 32 / LPR;            // rows per warp per step
  constexpr int NGROUPS = kNumWarps * RPW; // rows in flight per block
  __shared__ float s_m[NGROUPS][G];
  __shared__ float s_l[NGROUPS][G];
  __shared__ float s_acc[NGROUPS][G][HD];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LPR;               // this lane's slice of the row
  const int grp = warp * RPW + lane / LPR;  // this lane's row group
  const float scale = rsqrtf(static_cast<float>(HD));

  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) load_vec(q + g * HD + sub * VEC, qr[g]);

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }

  // Every lane of a warp runs the same number of steps (the loop bound
  // depends on the warp only), so the full-mask shuffles below are safe;
  // lanes whose row is past `length` load nothing and skip the update.
  for (int t0 = warp * RPW; t0 < length; t0 += NGROUPS) {
    const int t = t0 + lane / LPR;
    const bool valid = t < length;
    float kr[VEC], vr[VEC];
    if (valid) {
      const int64_t off = rows(t) + sub * VEC;
      load_vec(k + off, kr);
      load_vec(v + off, vr);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) kr[i] = vr[i] = 0.f;
    }
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) d += qr[g][i] * kr[i];
      s[g] = d;
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
    }
    if (valid) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float sg = s[g] * scale;
        const float mn = fmaxf(m[g], sg);
        const float alpha = expf(m[g] - mn);
        const float p = expf(sg - mn);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] = acc[g][i] * alpha + p * vr[i];
        m[g] = mn;
      }
    }
  }

  // Block-level combine of the NGROUPS partial softmax states.
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) s_acc[grp][g][sub * VEC + i] = acc[g][i];
    if (sub == 0) {
      s_m[grp][g] = m[g];
      s_l[grp][g] = l[g];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD;
    const int d = idx % HD;
    float mx = kNegInf;
#pragma unroll 4
    for (int j = 0; j < NGROUPS; ++j) mx = fmaxf(mx, s_m[j][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll 4
    for (int j = 0; j < NGROUPS; ++j) {
      const float w = expf(s_m[j][g] - mx);
      lsum += s_l[j][g] * w;
      a += s_acc[j][g][d] * w;
    }
    store(out + g * HD + d, a / fmaxf(lsum, 1e-30f));
  }
}

// Compile-time (dtype, head_dim, G) dispatch.  dtype: 0 = fp32, 1 = bf16.
template <typename T_, int G_, int HD_>
struct Config {
  using T = T_;
  static constexpr int G = G_;
  static constexpr int HD = HD_;
};

template <typename T, int HD, class F>
int dispatch_g(int g, F& f) {
  switch (g) {
    case 1: return f(Config<T, 1, HD>{});
    case 2: return f(Config<T, 2, HD>{});
    case 3: return f(Config<T, 3, HD>{});
    case 4: return f(Config<T, 4, HD>{});
    case 5: return f(Config<T, 5, HD>{});
    case 6: return f(Config<T, 6, HD>{});
    case 7: return f(Config<T, 7, HD>{});
    case 8: return f(Config<T, 8, HD>{});
    default: return kUnsupported;
  }
}

template <typename T, class F>
int dispatch_hd(int hd, int g, F& f) {
  switch (hd) {
    case 32: return dispatch_g<T, 32>(g, f);
    case 64: return dispatch_g<T, 64>(g, f);
    case 128: return dispatch_g<T, 128>(g, f);
    default: return kUnsupported;
  }
}

template <class F>
int dispatch(int dtype, int hd, int g, F&& f) {
  if (dtype == 0) return dispatch_hd<float>(hd, g, f);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(hd, g, f);
  return kUnsupported;
}

}  // namespace decode_attn
