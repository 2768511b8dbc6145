// fp32 body of the flash-attention kernel (K3): the same function as the
// bf16 body (fp32 scores and P, the -1e30 fill, the causal diagonal shifted
// by T - S, out = acc / max(l, 1e-30)) on the CUDA cores, since no tensor-
// core type keeps fp32's 2e-5.  Included by flash_attention.cu after its
// Problem, row_offset, keys_needed and kv_offset.
//
// Bound: fp32 FMAs at 67 TFLOP/s.  At bench_kernels.py's shape (B 1,
// S = T = 512, H 8, K 2, hd 64, causal) that is 1.34e8 FMAs, 0.0040 ms,
// against 2.6 MB of q, k, v and out; at the loss's shape (B 2,
// S = T = 2048, H 24, K 8, hd 128) 2.6e10 FMAs, 0.77 ms.  What holds it
// back: a thread that loads one float from shared memory per FMA runs at
// a quarter of that (128 bytes a clock feed 32 of the SM's 128 FMAs); a
// grid of fewer blocks than the card holds leaves SMs idle; and under a
// causal mask the last row block has 32x the keys of the first.  So:
//  - Register micro-tiles.  A task is 64 flattened (query, head) rows of
//    one (b, KV head) and a range of keys, on 128 threads: 16 row groups
//    of 8 lanes.  In S = Q K^T a thread owns 4 rows x BN/8 keys (keys
//    lane, lane + 8, ...) and reads Q and K rows from shared memory as
//    float4 along hd: 4 + BN/8 loads of 16 bytes feed 16 * BN/8 FMAs.  In
//    O += P V it owns the same 4 rows x hd/8 columns (float4 units at
//    lane * 4 + 32 u): per key one float4 of P^T and hd/32 of V feed hd/2
//    FMAs.  Rows of Q, K and V are padded to hd + 4 floats and P^T to
//    64 + 4, so a quarter-warp's 16-byte loads hit 8 distinct bank groups
//    or one broadcast address.  A row's max and sum are reduced over its
//    8 lanes with shuffles; its (m, l) stay in the lanes' registers.
//  - The Q tile is loaded once a task; K and V tiles of BN keys are
//    double-buffered with 16-byte cp.async copies: tile i + 1 streams in
//    while tile i is computed.  BN is 32 (64 at hd 32), so at every hd two
//    blocks fit an SM's shared memory and registers (202 a thread at hd
//    128, none spilled).  benchmarks/bench_torch_flash_f32_sweep.py times
//    the alternatives; on an H100 SXM at 700 W, 64-key tiles took 254
//    registers and one block an SM, 1.35x the time at bench_kernels.py's
//    shape and 4.2x at the loss's; 16-key tiles 1.09x and 1.13x; one
//    block an SM in __launch_bounds__ within 4%.
//  - Split keys.  Where the row blocks alone would leave the card short of
//    two tasks an SM (split_plan in kernels/flash_attention/ops.py), each
//    row block's causal key range is cut into chunks of `chunk` keys, the
//    longest that still fills the card (64 at the bench shape: 288 tasks
//    of two tiles, against 64 row blocks of up to 16 tiles; in the same
//    sweep 128-key chunks took 1.21x the time and no split 3.0x, and at
//    the loss's shape 1024- and 512-key chunks 1.17x and 1.35x of one
//    chunk); each chunk is a task that writes a partial (m, l, acc) to
//    scratch, and flash_f32_merge_kernel merges a row block's partials
//    into out.  A row block with one chunk writes out itself, and so does
//    every row block at the loss's shape (1,536 row blocks: no split, no
//    merge).  The plan gives only `chunk` and `chunks`; the kernel derives
//    each row block's keys (keys_needed) and the task order itself.  Tasks
//    run longest first: the last row blocks (the most causal keys) get the
//    lowest block indices.  The grid has `chunks` slots a row block; the
//    slots past a row block's own chunks exit at once.  Nothing persists
//    between launches.
// Only tiles that reach past the block's first row limit or past the
// chunk's end are masked elementwise.  Rows past S * G load zeros and are
// not written.
#pragma once

#include <climits>

namespace flash_attn {

constexpr int kF32Rows = 64;       // flattened rows per task
constexpr int kF32Threads = 128;   // 16 row groups of 8 lanes
constexpr int kF32Rpt = kF32Rows * 8 / kF32Threads;   // rows a thread
static_assert(kF32Rpt == 4, "a thread's rows are one float4 of P^T");
constexpr int kBadSplit = -3;      // a split that misses keys, or no scratch

template <int HD>
struct F32Tile {
  static constexpr int BN = HD <= 32 ? 64 : 32;   // keys per K/V tile
  static constexpr int RS = HD + 4;               // Q, K, V row stride
  static constexpr int PS = kF32Rows + 4;         // P^T row (key) stride
  static constexpr int KPT = BN / 8;              // keys a thread scores
  static constexpr int U = HD / 32;               // float4 columns a thread
  static constexpr int C4 = HD / 4;               // float4s a row
  static constexpr int K_OFF = kF32Rows * RS;     // floats; Q at 0
  static constexpr int V_OFF = K_OFF + 2 * BN * RS;
  static constexpr int P_OFF = V_OFF + 2 * BN * RS;
  static constexpr int BYTES = (P_OFF + BN * PS) * 4;
  static_assert(HD % 32 == 0, "head_dim");
  static_assert(kF32Rows * C4 % kF32Threads == 0, "Q copies");
  static_assert(BN * C4 % kF32Threads == 0, "K/V copies");
};

struct F32Split {
  int bk;       // B * K
  int n_rb;     // row blocks of kF32Rows rows
  int chunk;    // keys per task
  int chunks;   // task slots per row block
};

// Keys [0, n) that the last row block may see: the most of any row block.
inline int f32_longest_keys(const Problem& p) {
  if (!p.causal) return p.seq_kv;
  return min(p.seq_kv, (p.seq_q * p.group - 1) / p.group +
                           (p.seq_kv - p.seq_q) + 1);
}

// Keys [t0, t_end) of one (b, KV head) into a K and a V tile (BN rows of
// RS floats); keys at or past t_end are zero-filled.
template <int HD>
__device__ __forceinline__ void load_kv_f32(float* sk, float* sv,
                                            const float* __restrict__ k,
                                            const float* __restrict__ v,
                                            int b, int kvh, int t0, int t_end,
                                            const Problem& p) {
  using L = F32Tile<HD>;
#pragma unroll
  for (int it = 0; it < L::BN * L::C4 / kF32Threads; ++it) {
    const int idx = threadIdx.x + kF32Threads * it;
    const int rr = idx / L::C4;
    const int c = (idx - rr * L::C4) * 4;
    const int t = t0 + rr;
    const bool ok = t < t_end;
    const int64_t off = ok ? kv_offset(b, t, kvh, p, HD) + c : 0;
    hopper::cp_async_16(hopper::smem_addr(sk + rr * L::RS + c), k + off,
                        ok ? 16u : 0u);
    hopper::cp_async_16(hopper::smem_addr(sv + rr * L::RS + c), v + off,
                        ok ? 16u : 0u);
  }
}

template <int HD>
__global__ void __launch_bounds__(kF32Threads, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ part, Problem p, F32Split sp,
                 float scale) {
  using L = F32Tile<HD>;
  extern __shared__ __align__(16) float smem_f32[];

  // Slot -> task: row blocks last first, then chunks, then (b, KV head).
  const int per_rb = sp.bk * sp.chunks;
  const int rb_rev = blockIdx.x / per_rb;
  const int rb = sp.n_rb - 1 - rb_rev;
  const int rest = blockIdx.x - rb_rev * per_rb;
  const int c = rest / sp.bk;
  const int bkx = rest - c * sp.bk;
  const int b = bkx / p.num_kv;
  const int kvh = bkx - b * p.num_kv;
  const int r0 = rb * kF32Rows;
  const int n_keys = keys_needed(r0, kF32Rows, p);
  const int nc = (n_keys + sp.chunk - 1) / sp.chunk;
  if (c >= nc) return;
  const int k_begin = c * sp.chunk;
  const int k_end = min(n_keys, k_begin + sp.chunk);
  const int n_tiles = (k_end - k_begin + L::BN - 1) / L::BN;
  const int rows = p.seq_q * p.group;
  const int off = p.seq_kv - p.seq_q;

  float* sq = smem_f32;
  float* sp_t = smem_f32 + L::P_OFF;                 // P^T: [key][row]
  auto sk = [&](int s) { return smem_f32 + L::K_OFF + s * L::BN * L::RS; };
  auto sv = [&](int s) { return smem_f32 + L::V_OFF + s * L::BN * L::RS; };

#pragma unroll
  for (int it = 0; it < kF32Rows * L::C4 / kF32Threads; ++it) {
    const int idx = threadIdx.x + kF32Threads * it;
    const int rr = idx / L::C4;
    const int cc = (idx - rr * L::C4) * 4;
    const int r = r0 + rr;
    const bool ok = r < rows;
    const int64_t src = ok ? row_offset(b, r, kvh, p, HD) + cc : 0;
    hopper::cp_async_16(hopper::smem_addr(sq + rr * L::RS + cc), q + src,
                        ok ? 16u : 0u);
  }
  load_kv_f32<HD>(sk(0), sv(0), k, v, b, kvh, k_begin, k_end, p);
  hopper::cp_async_commit();

  constexpr int R = kF32Rpt;
  const int rg = threadIdx.x >> 3;        // rows rg * R .. rg * R + R - 1
  const int lane8 = threadIdx.x & 7;      // keys lane8 + 8 j; columns
                                          // lane8 * 4 + 32 u
  int lim[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + rg * R + i;
    lim[i] = r >= rows ? -1 : p.causal ? r / p.group + off : INT_MAX;
  }
  // the block's first row has the lowest limit
  const int lim_lo = p.causal ? r0 / p.group + off : INT_MAX;

  float acc[R][L::U][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int u = 0; u < L::U; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][u][e] = 0.f;
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  for (int ti = 0; ti < n_tiles; ++ti) {
    hopper::cp_async_wait<0>();
    __syncthreads();   // tile ti is in; every thread is past tile ti - 1
    const int t0 = k_begin + ti * L::BN;
    if (ti + 1 < n_tiles)
      load_kv_f32<HD>(sk((ti + 1) & 1), sv((ti + 1) & 1), k, v, b, kvh,
                      t0 + L::BN, k_end, p);
    hopper::cp_async_commit();
    const float* kt = sk(ti & 1);
    const float* vt = sv(ti & 1);

    // S = Q K^T: R rows x KPT keys a thread
    float sc[R][L::KPT];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < L::KPT; ++j) sc[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float4 a[R], kb[L::KPT];
#pragma unroll
      for (int i = 0; i < R; ++i)
        a[i] = *reinterpret_cast<const float4*>(sq + (rg * R + i) * L::RS + d);
#pragma unroll
      for (int j = 0; j < L::KPT; ++j)
        kb[j] = *reinterpret_cast<const float4*>(kt + (lane8 + 8 * j) * L::RS +
                                                 d);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < L::KPT; ++j) {
          sc[i][j] = fmaf(a[i].x, kb[j].x, sc[i][j]);
          sc[i][j] = fmaf(a[i].y, kb[j].y, sc[i][j]);
          sc[i][j] = fmaf(a[i].z, kb[j].z, sc[i][j]);
          sc[i][j] = fmaf(a[i].w, kb[j].w, sc[i][j]);
        }
    }

    // online softmax of the tile, row by row over the row's 8 lanes
    const bool masked = t0 + L::BN > k_end || t0 + L::BN - 1 > lim_lo;
    float alpha[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < L::KPT; ++j) {
        float s = sc[i][j] * scale;
        if (masked) {
          const int key = t0 + lane8 + 8 * j;
          if (key >= k_end || key > lim[i]) s = kNegInf;
        }
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int sh = 1; sh < 8; sh <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float mn = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - mn);
      m[i] = mn;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < L::KPT; ++j) {
        sc[i][j] = expf(sc[i][j] - mn);
        ps += sc[i][j];
      }
      l[i] = l[i] * alpha[i] + ps;     // this lane's part of the row sum
    }
#pragma unroll
    for (int j = 0; j < L::KPT; ++j)
      *reinterpret_cast<float4*>(sp_t + (lane8 + 8 * j) * L::PS + rg * R) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int u = 0; u < L::U; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][u][e] *= alpha[i];
    __syncthreads();   // P^T is complete

    // O += P V: R rows x hd/8 columns a thread
#pragma unroll
    for (int j = 0; j < L::BN; ++j) {
      const float4 pj = *reinterpret_cast<const float4*>(sp_t + j * L::PS +
                                                         rg * R);
      const float pr[R] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
      for (int u = 0; u < L::U; ++u) {
        const float4 vj = *reinterpret_cast<const float4*>(
            vt + j * L::RS + u * 32 + lane8 * 4);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc[i][u][0] = fmaf(pr[i], vj.x, acc[i][u][0]);
          acc[i][u][1] = fmaf(pr[i], vj.y, acc[i][u][1]);
          acc[i][u][2] = fmaf(pr[i], vj.z, acc[i][u][2]);
          acc[i][u][3] = fmaf(pr[i], vj.w, acc[i][u][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int sh = 1; sh < 8; sh <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], sh);

  if (nc == 1) {                 // the row block's only chunk: write out
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = r0 + rg * R + i;
      if (r >= rows) continue;
      const float den = fmaxf(l[i], 1e-30f);
      float* o = out + row_offset(b, r, kvh, p, HD) + lane8 * 4;
#pragma unroll
      for (int u = 0; u < L::U; ++u)
        *reinterpret_cast<float4*>(o + u * 32) =
            make_float4(acc[i][u][0] / den, acc[i][u][1] / den,
                        acc[i][u][2] / den, acc[i][u][3] / den);
    }
    return;
  }
  // a partial (m, l, acc) of this chunk: acc of every slot first, then
  // (m, l) pairs
  const int64_t slot = (static_cast<int64_t>(bkx) * sp.n_rb + rb) *
                           sp.chunks + c;
  float* pa = part + slot * kF32Rows * HD;
  float2* pml = reinterpret_cast<float2*>(
                    part + static_cast<int64_t>(sp.bk) * sp.n_rb * sp.chunks *
                               kF32Rows * HD) +
                slot * kF32Rows;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int rr = rg * R + i;
#pragma unroll
    for (int u = 0; u < L::U; ++u)
      *reinterpret_cast<float4*>(pa + rr * HD + u * 32 + lane8 * 4) =
          make_float4(acc[i][u][0], acc[i][u][1], acc[i][u][2],
                      acc[i][u][3]);
    if (lane8 == 0) pml[rr] = make_float2(m[i], l[i]);
  }
}

// Merge a row block's partials: out = sum_c w_c acc_c / max(sum_c w_c l_c,
// 1e-30) with w_c = exp(m_c - max m).  One block of kMergeThreads a
// (row block, b, KV head) and quarter of the rows, one thread a float4 of
// a row; the chunk loops are unrolled so their loads are in flight
// together.
constexpr int kMergeThreads = 256;
constexpr int kMergeSplit = 4;     // blocks a row block
template <int HD>
__global__ void __launch_bounds__(kMergeThreads)
flash_f32_merge_kernel(const float* __restrict__ part,
                       float* __restrict__ out, Problem p, F32Split sp) {
  using L = F32Tile<HD>;
  constexpr int ROWS = kF32Rows / kMergeSplit;
  const int rb = blockIdx.x / sp.bk;
  const int bkx = blockIdx.x - rb * sp.bk;
  const int b = bkx / p.num_kv;
  const int kvh = bkx - b * p.num_kv;
  const int r0 = rb * kF32Rows;
  const int nc = (keys_needed(r0, kF32Rows, p) + sp.chunk - 1) / sp.chunk;
  if (nc <= 1) return;
  const int rows = p.seq_q * p.group;
  const int64_t slot0 = (static_cast<int64_t>(bkx) * sp.n_rb + rb) *
                        sp.chunks;
  const float* pa = part + slot0 * kF32Rows * HD;
  const float2* pml = reinterpret_cast<const float2*>(
                          part + static_cast<int64_t>(sp.bk) * sp.n_rb *
                                     sp.chunks * kF32Rows * HD) +
                      slot0 * kF32Rows;
  for (int idx = threadIdx.x; idx < ROWS * L::C4; idx += kMergeThreads) {
    const int rr = blockIdx.y * ROWS + idx / L::C4;
    const int cc = (idx % L::C4) * 4;
    const int r = r0 + rr;
    if (r >= rows) continue;
    // chunks in groups of 8, each group's loads issued together
    float mx = kNegInf;
    for (int c0 = 0; c0 < nc; c0 += 8) {
#pragma unroll
      for (int ch = c0; ch < c0 + 8; ++ch)
        if (ch < nc) mx = fmaxf(mx, pml[ch * kF32Rows + rr].x);
    }
    float den = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < nc; c0 += 8) {
#pragma unroll
      for (int ch = c0; ch < c0 + 8; ++ch) {
        if (ch >= nc) continue;
        const float2 ml = pml[ch * kF32Rows + rr];
        const float w = expf(ml.x - mx);
        const float4 a = *reinterpret_cast<const float4*>(
            pa + (ch * kF32Rows + rr) * HD + cc);
        den = fmaf(ml.y, w, den);
        o.x = fmaf(w, a.x, o.x);
        o.y = fmaf(w, a.y, o.y);
        o.z = fmaf(w, a.z, o.z);
        o.w = fmaf(w, a.w, o.w);
      }
    }
    den = fmaxf(den, 1e-30f);
    *reinterpret_cast<float4*>(out + row_offset(b, r, kvh, p, HD) + cc) =
        make_float4(o.x / den, o.y / den, o.z / den, o.w / den);
  }
}

// Launch the fp32 body: `chunk` keys a task, `chunks` slots a row block
// (chunk * chunks must cover the longest row block's keys); `part` holds
// B * K * row blocks * chunks * 64 * (hd + 2) floats when chunks > 1 and
// may be null otherwise.
template <int HD>
int launch_f32(const float* q, const float* k, const float* v, float* out,
               float* part, const Problem& p, int batch, int chunk,
               int chunks, cudaStream_t stream) {
  using L = F32Tile<HD>;
  F32Split sp;
  sp.bk = batch * p.num_kv;
  sp.n_rb = (p.seq_q * p.group + kF32Rows - 1) / kF32Rows;
  sp.chunk = chunk;
  sp.chunks = chunks;
  if (chunk < 1 || chunks < 1 ||
      static_cast<int64_t>(chunk) * chunks < f32_longest_keys(p) ||
      (chunks > 1 && part == nullptr))
    return kBadSplit;
  const int64_t blocks = static_cast<int64_t>(sp.bk) * sp.n_rb * chunks;
  if (blocks < 1 || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t e = cudaFuncSetAttribute(
      flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  flash_f32_kernel<HD><<<static_cast<int>(blocks), kF32Threads, L::BYTES,
                         stream>>>(q, k, v, out, part, p, sp, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || chunks == 1) return static_cast<int>(e);
  flash_f32_merge_kernel<HD>
      <<<dim3(sp.n_rb * sp.bk, kMergeSplit), kMergeThreads, 0, stream>>>(
          part, out, p, sp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_attn
