// Causal (or full) GQA flash attention for Hopper (sm_90a), the forward of
// the teacher-forced loss.  Replaces the Pallas TPU kernel
// `flash_attention_pallas` (src/repro/kernels/flash_attention/
// flash_attention.py:80): softmax(q k^T / sqrt(hd)) v with fp32 scores, an
// online softmax (m, l, acc) started at m = -1e30, out = acc / max(l, 1e-30).
//
// q, out: (B, S, H, hd) with H = K * G, head h = kvh * G + g; k, v:
// (B, T, K, hd); all contiguous, T >= S.  Causal: key t is visible to query
// s iff t <= s + (T - S) (the diagonal shifted for an offset cache).
//
// Bound: at the loss's shape (B=2, S=T=2048, H=24, K=8, hd=128, bf16) the
// causal products are 4*B*H*hd*S(S+1)/2 = 5.2e10 operations, 0.052 ms at
// 989 TFLOP/s, against 67 MB of q, k, v and out (0.020 ms at 3.35 TB/s):
// the tensor cores bound it.
//
// Design.  The TPU grid (b, h, q_blk, kv_blk) ran its KV axis in order,
// carrying (m, l, acc) in VMEM.  Here the KV axis is a loop inside a block,
// and the block covers the G heads of one KV head: for a fixed (b, kvh) the
// rows (s, g) are flattened to r = s * G + g, and one block takes 64
// consecutive rows (64 / G query positions x G heads), so any G runs on one
// kernel and every K/V tile staged in shared memory serves all G heads of
// the group.  Grid: (ceil(S*G / 64), K, B); 1536 blocks at the loss's shape.
// The KV loop stops at the block's causal limit (the last row's position +
// T - S), which replaces the `@pl.when` skip of blocks above the diagonal;
// the diagonal tile and keys past T are masked elementwise.
//
// bf16: 4 warps, each owning 16 rows; Q^T K and P V run on the tensor cores
// with `mma.sync.m16n8k16` (bf16 in, fp32 accumulate).  The Q fragments and
// the fp32 output accumulators stay in registers for the whole loop; P is
// rounded to bf16 for its product with V (the Pallas kernel keeps P in
// fp32; the difference is within the bf16 tolerance).  K and V tiles of 64
// keys are staged in shared memory with rows padded by 16 bytes, so the
// fragment loads (and `ldmatrix.trans` for V) are free of bank conflicts.
// fp32: no tensor-core path keeps fp32 accuracy, so one thread owns one row
// and runs the same loop in scalar fp32, 32 keys per tile.  Neither path
// pipelines its loads (no cp.async, TMA or wgmma yet): right first, fast
// later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_attn {

constexpr int kRows = 64;          // flattened (query, head) rows per block
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kUnsupported = -1;   // returned for a (dtype, hd) not built

struct Problem {
  int seq_q;    // S
  int seq_kv;   // T
  int num_kv;   // K
  int group;    // G
  int causal;
};

// Offset of flattened row r = s * G + g of (b, kvh) in q and out.
__device__ __forceinline__ int64_t row_offset(int b, int r, int kvh,
                                              const Problem& p, int hd) {
  const int s = r / p.group;
  const int g = r - s * p.group;
  return ((static_cast<int64_t>(b) * p.seq_q + s) * p.num_kv * p.group +
          static_cast<int64_t>(kvh) * p.group + g) * hd;
}

// Keys [0, n) that any row of the block starting at r0 may see.
__device__ __forceinline__ int keys_needed(int r0, const Problem& p) {
  if (!p.causal) return p.seq_kv;
  const int last = min(r0 + kRows, p.seq_q * p.group) - 1;
  return min(p.seq_kv, last / p.group + (p.seq_kv - p.seq_q) + 1);
}

__device__ __forceinline__ int64_t kv_offset(int b, int t, int kvh,
                                             const Problem& p, int hd) {
  return ((static_cast<int64_t>(b) * p.seq_kv + t) * p.num_kv + kvh) * hd;
}

// ------------------------------------------------------------------ bf16 --

constexpr int kMmaThreads = 128;   // 4 warps x 16 rows
constexpr int kMmaKeys = 64;       // keys per K/V tile

__device__ __forceinline__ uint32_t load32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 8x8 bf16 matrices from shared memory, transposed: lanes 0-7 give the
// row addresses of the first, lanes 8-15 those of the second.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, Problem p,
                  float scale_log2) {
  constexpr int LD = HD + 8;          // padded shared-memory row
  constexpr int KC = HD / 16;         // k-steps of Q K^T
  constexpr int NT = kMmaKeys / 8;    // 8-key column tiles of the scores
  constexpr int OT = HD / 8;          // 8-wide column tiles of the output
  constexpr int CPR = HD / 8;         // 16-byte chunks per K/V row
  static_assert(HD % 16 == 0, "head_dim");
  __shared__ __align__(16) __nv_bfloat16 sk[kMmaKeys * LD];
  __shared__ __align__(16) __nv_bfloat16 sv[kMmaKeys * LD];

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int rows = p.seq_q * p.group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;          // fragment row within 8
  const int tig = lane & 3;           // fragment column pair
  const int off = p.seq_kv - p.seq_q;

  // This thread's two rows: ra (fragment rows 0-7) and rb = ra + 8.
  const int ra = r0 + warp * 16 + gid;
  const int rb = ra + 8;
  const bool va = ra < rows;
  const bool vb = rb < rows;
  const int lim_a = va ? ra / p.group + off : -1;   // last visible key
  const int lim_b = vb ? rb / p.group + off : -1;
  const int64_t oa = va ? row_offset(b, ra, kvh, p, HD) : 0;
  const int64_t ob = vb ? row_offset(b, rb, kvh, p, HD) : 0;

  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = kc * 16 + tig * 2;
    qf[kc][0] = va ? load32(q + oa + c) : 0u;
    qf[kc][1] = vb ? load32(q + ob + c) : 0u;
    qf[kc][2] = va ? load32(q + oa + c + 8) : 0u;
    qf[kc][3] = vb ? load32(q + ob + c + 8) : 0u;
  }

  float o[OT][4];
#pragma unroll
  for (int ot = 0; ot < OT; ++ot) o[ot][0] = o[ot][1] = o[ot][2] = o[ot][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  const int n_keys = keys_needed(r0, p);
  for (int t0 = 0; t0 < n_keys; t0 += kMmaKeys) {
    __syncthreads();   // the previous tile is no longer read
    for (int i = threadIdx.x; i < kMmaKeys * CPR; i += kMmaThreads) {
      const int row = i / CPR;
      const int c = (i - row * CPR) * 8;
      const int t = t0 + row;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u);
      uint4 vx = kx;
      if (t < n_keys) {
        const int64_t base = kv_offset(b, t, kvh, p, HD) + c;
        kx = *reinterpret_cast<const uint4*>(k + base);
        vx = *reinterpret_cast<const uint4*>(v + base);
      }
      *reinterpret_cast<uint4*>(sk + row * LD + c) = kx;
      *reinterpret_cast<uint4*>(sv + row * LD + c) = vx;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kp = sk + (nt * 8 + gid) * LD + tig * 2;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        mma_bf16(s[nt], qf[kc], load32(kp + kc * 16), load32(kp + kc * 16 + 8));
    }

    // Scale into the log2 domain, mask, and take each row's maximum; a row
    // is spread over the 4 lanes of a quad.
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t0 + nt * 8 + tig * 2 + (e & 1);
        const int lim = e < 2 ? lim_a : lim_b;
        const bool ok = col < n_keys && (!p.causal || col <= lim);
        const float x = ok ? s[nt][e] * scale_log2 : kNegInf;
        s[nt][e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
    }
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    const float al_a = exp2f(m_a - mn_a);
    const float al_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn_a);
      s[nt][1] = exp2f(s[nt][1] - mn_a);
      s[nt][2] = exp2f(s[nt][2] - mn_b);
      s[nt][3] = exp2f(s[nt][3] - mn_b);
      ps_a += s[nt][0] + s[nt][1];
      ps_b += s[nt][2] + s[nt][3];
    }
    l_a = l_a * al_a + ps_a;   // this lane's part of the row sum
    l_b = l_b * al_b + ps_b;
#pragma unroll
    for (int ot = 0; ot < OT; ++ot) {
      o[ot][0] *= al_a;
      o[ot][1] *= al_a;
      o[ot][2] *= al_b;
      o[ot][3] *= al_b;
    }

    // O += P V: the score accumulators of two 8-key tiles are exactly the
    // A fragment of one 16-key step.
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vp = sv + (kk * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int ot = 0; ot < OT; ++ot) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vp + ot * 8);
        mma_bf16(o[ot], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
  }
  const float d_a = fmaxf(l_a, 1e-30f);
  const float d_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int ot = 0; ot < OT; ++ot) {
    const int c = ot * 8 + tig * 2;
    if (va)
      *reinterpret_cast<__nv_bfloat162*>(out + oa + c) =
          __floats2bfloat162_rn(o[ot][0] / d_a, o[ot][1] / d_a);
    if (vb)
      *reinterpret_cast<__nv_bfloat162*>(out + ob + c) =
          __floats2bfloat162_rn(o[ot][2] / d_b, o[ot][3] / d_b);
  }
}

// ------------------------------------------------------------------ fp32 --

constexpr int kScalarThreads = kRows;   // one row per thread
constexpr int kScalarKeys = 32;

template <int HD>
__global__ void __launch_bounds__(kScalarThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 Problem p, float scale) {
  constexpr int C4 = HD / 4;   // float4 chunks per row
  __shared__ __align__(16) float sk[kScalarKeys][HD];
  __shared__ __align__(16) float sv[kScalarKeys][HD];

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int r = r0 + threadIdx.x;
  const bool valid = r < p.seq_q * p.group;
  const int lim = valid ? r / p.group + (p.seq_kv - p.seq_q) : -1;
  const int64_t orow = valid ? row_offset(b, r, kvh, p, HD) : 0;

  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;

  const int n_keys = keys_needed(r0, p);
  for (int t0 = 0; t0 < n_keys; t0 += kScalarKeys) {
    __syncthreads();
    for (int i = threadIdx.x; i < kScalarKeys * C4; i += kScalarThreads) {
      const int row = i / C4;
      const int c = (i - row * C4) * 4;
      const int t = t0 + row;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (t < n_keys) {
        const int64_t base = kv_offset(b, t, kvh, p, HD) + c;
        kx = *reinterpret_cast<const float4*>(k + base);
        vx = *reinterpret_cast<const float4*>(v + base);
      }
      *reinterpret_cast<float4*>(&sk[row][c]) = kx;
      *reinterpret_cast<float4*>(&sv[row][c]) = vx;
    }
    __syncthreads();

    float s[kScalarKeys];
#pragma unroll
    for (int j = 0; j < kScalarKeys; ++j) s[j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      const float4 qv = valid ? *reinterpret_cast<const float4*>(q + orow + d)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kScalarKeys; ++j) {
        s[j] = fmaf(qv.x, sk[j][d], s[j]);
        s[j] = fmaf(qv.y, sk[j][d + 1], s[j]);
        s[j] = fmaf(qv.z, sk[j][d + 2], s[j]);
        s[j] = fmaf(qv.w, sk[j][d + 3], s[j]);
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kScalarKeys; ++j) {
      const int col = t0 + j;
      const bool ok = col < n_keys && (!p.causal || col <= lim);
      s[j] = ok ? s[j] * scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kScalarKeys; ++j) {
      s[j] = expf(s[j] - mn);
      psum += s[j];
    }
    l = l * alpha + psum;
    m = mn;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      float a = acc[d] * alpha;
#pragma unroll
      for (int j = 0; j < kScalarKeys; ++j) a = fmaf(s[j], sv[j][d], a);
      acc[d] = a;
    }
  }

  if (valid) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < HD; ++d) out[orow + d] = acc[d] / den;
  }
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           const Problem& p, int batch, cudaStream_t stream) {
  const dim3 grid((p.seq_q * p.group + kRows - 1) / kRows, p.num_kv, batch);
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  if (dtype == 0) {
    flash_f32_kernel<HD><<<grid, kScalarThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), p, scale);
  } else if (dtype == 1) {
    flash_bf16_kernel<HD><<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), p,
        scale * kLog2e);
  } else {
    return kUnsupported;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_attn

// dtype: 0 = fp32, 1 = bf16.  Returns 0, a cudaError_t, or -1 for a
// (dtype, head_dim) that is not built.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int seq_q, int seq_kv, int num_kv,
                                      int group, int head_dim, int causal,
                                      int dtype, void* stream) {
  using namespace flash_attn;
  const Problem p{seq_q, seq_kv, num_kv, group, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch<32>(dtype, q, k, v, out, p, batch, st);
    case 64: return launch<64>(dtype, q, k, v, out, p, batch, st);
    case 96: return launch<96>(dtype, q, k, v, out, p, batch, st);
    case 128: return launch<128>(dtype, q, k, v, out, p, batch, st);
    default: return kUnsupported;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
