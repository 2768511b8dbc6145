// Common pieces of the single-token GQA decode-attention kernels (dense
// and paged KV): the block size, 16-byte vector loads, the dense cache's
// row map and the compile-time (dtype, head_dim, G) dispatch.  The kernels'
// body, its bound and its design are in decode_split.cuh: both kernels
// split each slot's keys over the grid (splits, K, B) and combine the
// splits' partial softmax states in the same launch.
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
    case 96: return dispatch_g<T, 96>(g, f);
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
