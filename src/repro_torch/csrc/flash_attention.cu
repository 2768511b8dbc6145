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
// Rows.  The TPU grid (b, h, q_blk, kv_blk) ran its KV axis in order,
// carrying (m, l, acc) in VMEM.  Here the KV axis is a loop inside a block,
// and the block covers the G heads of one KV head: for a fixed (b, kvh) the
// rows (s, g) are flattened to r = s * G + g, so any G runs on one kernel
// and every K/V tile in shared memory serves all G heads of the group.  The
// KV loop stops at the block's causal limit (its last row's position +
// T - S), which replaces the `@pl.when` skip of blocks above the diagonal;
// only the tiles that reach past a row's limit or past T are masked
// elementwise.
//
// bf16, the loss's path: persistent and warp-specialised, 128 rows a task.
//  - A task is one block of 128 flattened rows of one (b, KV head).  The
//    grid is one block per SM (132 on an H100); the tasks are ordered
//    longest first (the last row blocks, with the most causal tiles, come
//    first) and dealt to the blocks in snake order, so the one-tile tasks
//    fill the tail.  A block that ran one task and exited would pay its
//    start-up (barriers, descriptors, the first loads) on every task; a
//    persistent block pays it once and its producer runs ahead into the
//    next task (benchmarks/bench_torch_flash_ablation.py measures the
//    difference as `one_block_per_task`).
//  - A producer warp keeps K and V tiles of 128 keys in flight across the
//    block's tasks: each tile is one TMA box per 128- (or 64-) byte column
//    chunk, (keys x chunk) at a row stride of K*hd*2 bytes, into a ring of
//    2 stages with full and empty mbarriers, K and V released separately;
//    it waits on nothing but the ring.  The tensor maps are encoded on the
//    host (cuTensorMapEncodeTiled) and passed as __grid_constant__
//    parameters.
//  - Two consumer warpgroups own 64 rows each.  Their Q rows (runs of G*hd
//    contiguous values at a stride of H*hd) go into shared memory with
//    16-byte cp.async copies, swizzled as wgmma reads them, one task ahead
//    into a second buffer.  S = Q K^T is `wgmma.m64n128k16` with both
//    operands in shared memory (K-major).  The online softmax runs in
//    registers in the log2 domain, one FFMA and one EX2 a score.  P is
//    rounded to bf16 (the Pallas kernel keeps P in fp32; the difference is
//    within the bf16 tolerance) and O += P V is `wgmma.m64n{hd}k16` with P
//    from registers and V from shared memory as an MN-major operand.
//  - Tile i's Q K^T is issued together with tile i-1's P V, so the softmax
//    of tile i runs while the tensor cores do that P V; and the two
//    warpgroups take turns to issue (named barriers), so one's softmax
//    also overlaps the other's products.
//  - `setmaxnreg` moves registers from the producer warpgroup (24 a
//    thread) to the consumers (240), which hold 64 fp32 scores, 32 bf16
//    pairs of P and hd/2 fp32 outputs a thread.
// hd = 64 and 128 use 128-byte swizzled chunks of 64 columns; hd = 32 and
// 96 use 64-byte chunks of 32.  Rows past S*G load zeros and are not
// written.
// fp32 (flash_attention_f32.cuh): no tensor-core type keeps fp32's 2e-5, so
// the products run on the CUDA cores, bound by fp32 FMAs: 64-row tasks on
// 128 threads with register micro-tiles fed by float4 shared-memory loads,
// cp.async double-buffered K/V tiles, and each row block's keys split into
// chunks merged by a second kernel where the row blocks alone would leave
// SMs idle.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper.cuh"

namespace flash_attn {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kUnsupported = -1;   // returned for a (dtype, hd) not built
constexpr int kTensorMapError = -2;   // cuTensorMapEncodeTiled refused

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

// Keys [0, n) that any row of the `rows`-row block starting at r0 may see.
__device__ __forceinline__ int keys_needed(int r0, int rows, const Problem& p) {
  if (!p.causal) return p.seq_kv;
  const int last = min(r0 + rows, p.seq_q * p.group) - 1;
  return min(p.seq_kv, last / p.group + (p.seq_kv - p.seq_q) + 1);
}

__device__ __forceinline__ int64_t kv_offset(int b, int t, int kvh,
                                             const Problem& p, int hd) {
  return ((static_cast<int64_t>(b) * p.seq_kv + t) * p.num_kv + kvh) * hd;
}

// ------------------------------------------------------------------ bf16 --

constexpr int kBlockM = 128;       // flattened rows per block
constexpr int kBlockN = 128;       // keys per K/V tile
constexpr int kStages = 2;         // K/V ring depth
constexpr int kThreads = 384;      // 2 consumer warpgroups + 1 producer
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared memory of the bf16 kernel for head_dim HD; every region starts on
// a multiple of its swizzle repeat.
template <int HD>
struct Layout {
  static constexpr int CW = HD % 64 == 0 ? 64 : 32;   // columns per chunk
  static constexpr int SW = CW * 2;                    // bytes per chunk row
  static constexpr int NCH = HD / CW;                  // chunks per row
  static constexpr int DESC = SW == 128 ? 1 : 2;       // wgmma swizzle mode
  static constexpr int ATOM = 8 * SW;                  // 8-row swizzle atom
  static constexpr int Q_CHUNK = 64 * SW;              // a warpgroup's rows
  static constexpr int KV_CHUNK = kBlockN * SW;
  static constexpr int KV_TILE = NCH * KV_CHUNK;       // kBlockN * HD * 2
  static constexpr int Q_OFF = 0;                      // 2 buffers x 2 groups
  static constexpr int K_OFF = Q_OFF + 4 * NCH * Q_CHUNK;
  static constexpr int V_OFF = K_OFF + kStages * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + kStages * KV_TILE;
  static constexpr int BYTES = BAR_OFF + 4 * kStages * 8;
  static constexpr int ALIGN = 1024;                   // 128-byte swizzle repeat
  static_assert(HD % CW == 0 && HD % 16 == 0, "head_dim");
  static_assert(K_OFF % ALIGN == 0 && KV_CHUNK % ALIGN == 0, "alignment");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Issue S = Q K^T for a warpgroup's 64 rows and a tile's 128 keys: hd / 16
// `wgmma` steps with both operands in shared memory, K-major.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_addr,
                                         uint32_t k_addr) {
  using L = Layout<HD>;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const int c = ks / (L::CW / 16);
    const uint32_t kk = (ks % (L::CW / 16)) * 32;
    const uint64_t da = hopper::make_desc(q_addr + c * L::Q_CHUNK + kk, 16,
                                          L::ATOM, L::DESC);
    const uint64_t db = hopper::make_desc(k_addr + c * L::KV_CHUNK + kk, 16,
                                          L::ATOM, L::DESC);
    hopper::wgmma_ss_n128(sc, da, db, ks > 0);
  }
}

// Issue O += P V: 128 keys in steps of 16, P from registers, V's rows are
// keys (MN-major).
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&pa)[kBlockN / 16][4],
                                         uint32_t v_addr) {
  using L = Layout<HD>;
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk)
    hopper::WgmmaRS<HD>::run(
        o, pa[kk],
        hopper::make_desc(v_addr + kk * 16 * L::SW, L::KV_CHUNK, L::ATOM,
                          L::DESC));
}

// The online softmax of one tile, for this thread's rows a and b.  Masks
// keys past a row's limit or past n_keys (when `mask`), keeps the running
// maximum m in the scores' own units, and leaves
// p = exp2(s * scale_log2 - m * scale_log2) in sc, one FFMA and one EX2 a
// score.  Updates (m, l) and returns the factors that rescale the rows'
// earlier output.  A row with no visible key so far keeps p = 0.
// sc[n8 * 4 + e] is row a (e < 2) or b, key t0 + n8 * 8 + 2 * (lane % 4) +
// (e & 1); a row is spread over the 4 lanes of a quad.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], bool mask,
                                             int t0, int lim_a, int lim_b,
                                             int n_keys, int lane,
                                             float scale_log2, float& m_a,
                                             float& m_b, float& l_a,
                                             float& l_b, float& al_a,
                                             float& al_b) {
  if (mask) {
#pragma unroll
    for (int n8 = 0; n8 < kBlockN / 8; ++n8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t0 + n8 * 8 + 2 * (lane % 4) + (e & 1);
        const bool ok = col < n_keys && col <= (e < 2 ? lim_a : lim_b);
        if (!ok) sc[n8 * 4 + e] = kNegInf;
      }
    }
  }
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int n8 = 0; n8 < kBlockN / 8; ++n8) {
    mx_a = fmaxf(mx_a, fmaxf(sc[n8 * 4], sc[n8 * 4 + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[n8 * 4 + 2], sc[n8 * 4 + 3]));
  }
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
  }
  const float mn_a = fmaxf(m_a, mx_a);
  const float mn_b = fmaxf(m_b, mx_b);
  al_a = hopper::exp2_ftz((m_a - mn_a) * scale_log2);
  al_b = hopper::exp2_ftz((m_b - mn_b) * scale_log2);
  m_a = mn_a;
  m_b = mn_b;
  const float neg_a = mn_a == kNegInf ? 0.f : -mn_a * scale_log2;
  const float neg_b = mn_b == kNegInf ? 0.f : -mn_b * scale_log2;
  float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
  for (int n8 = 0; n8 < kBlockN / 8; ++n8) {
    sc[n8 * 4] = hopper::exp2_ftz(fmaf(sc[n8 * 4], scale_log2, neg_a));
    sc[n8 * 4 + 1] = hopper::exp2_ftz(fmaf(sc[n8 * 4 + 1], scale_log2, neg_a));
    sc[n8 * 4 + 2] = hopper::exp2_ftz(fmaf(sc[n8 * 4 + 2], scale_log2, neg_b));
    sc[n8 * 4 + 3] = hopper::exp2_ftz(fmaf(sc[n8 * 4 + 3], scale_log2, neg_b));
    ps_a += sc[n8 * 4] + sc[n8 * 4 + 1];
    ps_b += sc[n8 * 4 + 2] + sc[n8 * 4 + 3];
  }
  l_a = l_a * al_a + ps_a;   // this lane's part of the row sum
  l_b = l_b * al_b + ps_b;
}

// P rounded to bf16 in the A-operand layout of P V: the accumulators of
// two 8-key column tiles of the scores are one 16-key step's fragment.
__device__ __forceinline__ void to_fragments(const float (&sc)[64],
                                             uint32_t (&pa)[kBlockN / 16][4]) {
#pragma unroll
  for (int n8 = 0; n8 < kBlockN / 8; ++n8) {
    pa[n8 / 2][(n8 & 1) * 2] = pack_bf16(sc[n8 * 4], sc[n8 * 4 + 1]);
    pa[n8 / 2][(n8 & 1) * 2 + 1] = pack_bf16(sc[n8 * 4 + 2], sc[n8 * 4 + 3]);
  }
}

// Longest-first task order, dealt to the persistent blocks.  A task is
// one 128-row block of one (b, KV head); the tasks of the last row block
// (the most keys when causal) come first.  Block j takes task
// r * G + j in even rounds r and r * G + G - 1 - j in odd ones (a snake
// over the G blocks), which evens out the blocks' sums of decreasing task
// sizes; only the last round can run out of tasks.
struct Schedule {
  int n_tasks;
  int per_row_block;   // B * K
  int n_row_blocks;
  __device__ __forceinline__ int rounds() const {
    return (n_tasks + gridDim.x - 1) / gridDim.x;
  }
  __device__ __forceinline__ int task(int r) const {   // -1: none
    const int t = r * gridDim.x +
                  ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
    return t < n_tasks ? t : -1;
  }
};

struct Task {
  int b, kvh, r0, n_keys, n_tiles;
};

__device__ __forceinline__ Task decode_task(int t, const Schedule& sch,
                                            const Problem& p) {
  Task tk;
  const int rest = t % sch.per_row_block;
  tk.b = rest / p.num_kv;
  tk.kvh = rest - tk.b * p.num_kv;
  tk.r0 = (sch.n_row_blocks - 1 - t / sch.per_row_block) * kBlockM;
  tk.n_keys = keys_needed(tk.r0, kBlockM, p);
  tk.n_tiles = (tk.n_keys + kBlockN - 1) / kBlockN;
  return tk;
}

// A warpgroup's 64 rows of Q for task `tk`, 16 bytes a copy, into its Q
// buffer at `dst` (shared address), swizzled as wgmma reads it; rows past
// S * G are filled with zeros.
template <int HD>
__device__ __forceinline__ void prefetch_q(const __nv_bfloat16* __restrict__ q,
                                           const Task& tk, int wg,
                                           const Problem& p, uint32_t dst) {
  using L = Layout<HD>;
  constexpr int UPR = HD / 8;                 // 16-byte units per row
  const int tw = threadIdx.x % 128;
  const int rows = p.seq_q * p.group;
#pragma unroll
  for (int it = 0; it < 64 * UPR / 128; ++it) {
    const int idx = tw + 128 * it;
    const int rr = idx / UPR;
    const int u = idx - rr * UPR;
    const int r = tk.r0 + wg * 64 + rr;
    const bool valid = r < rows;
    const __nv_bfloat16* src =
        valid ? q + row_offset(tk.b, r, tk.kvh, p, HD) + u * 8 : q;
    const int c = u / (L::CW / 8);
    const int j = u - c * (L::CW / 8);
    hopper::cp_async_16(dst + c * L::Q_CHUNK +
                            hopper::swizzle<L::SW>(rr * L::SW + j * 16),
                        src, valid ? 16u : 0u);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tmap_k,
                  const __grid_constant__ CUtensorMap tmap_v,
                  const __nv_bfloat16* __restrict__ q,
                  __nv_bfloat16* __restrict__ out, Problem p, Schedule sch,
                  float scale_log2) {
  using L = Layout<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + L::ALIGN - 1) &
      ~static_cast<uintptr_t>(L::ALIGN - 1));
  const uint32_t base = hopper::smem_addr(smem);
  // Ring barriers: full_k, full_v (the producer's TMA bytes landed),
  // empty_k, empty_v (all 8 consumer warps are done with the stage).
  const uint32_t bar = base + L::BAR_OFF;
  auto full_k = [&](int s) { return bar + 8u * s; };
  auto full_v = [&](int s) { return bar + 8u * (kStages + s); };
  auto empty_k = [&](int s) { return bar + 8u * (2 * kStages + s); };
  auto empty_v = [&](int s) { return bar + 8u * (3 * kStages + s); };
  const int rounds = sch.rounds();

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full_k(s), 1);
      hopper::mbar_init(full_v(s), 1);
      hopper::mbar_init(empty_k(s), 8);    // one arrival per consumer warp
      hopper::mbar_init(empty_v(s), 8);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---------------- producer: one thread keeps the ring full, ---------
    // ---------------- running ahead across this block's tasks -----------
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      hopper::tma_prefetch_desc(&tmap_k);
      hopper::tma_prefetch_desc(&tmap_v);
      int it = 0;                           // tiles through the ring
      for (int r = 0; r < rounds; ++r) {
        const int t = sch.task(r);
        if (t < 0) continue;
        const Task tk = decode_task(t, sch, p);
        for (int i = 0; i < tk.n_tiles; ++i, ++it) {
          const int s = it % kStages;
          const uint32_t free_parity = ((it / kStages) & 1) ^ 1;
          hopper::mbar_wait(empty_k(s), free_parity);
          hopper::mbar_expect_tx(full_k(s), L::KV_TILE);
#pragma unroll
          for (int c = 0; c < L::NCH; ++c)
            hopper::tma_load_3d(
                base + L::K_OFF + s * L::KV_TILE + c * L::KV_CHUNK, &tmap_k,
                full_k(s), tk.kvh * HD + c * L::CW, i * kBlockN, tk.b);
          hopper::mbar_wait(empty_v(s), free_parity);
          hopper::mbar_expect_tx(full_v(s), L::KV_TILE);
#pragma unroll
          for (int c = 0; c < L::NCH; ++c)
            hopper::tma_load_3d(
                base + L::V_OFF + s * L::KV_TILE + c * L::KV_CHUNK, &tmap_v,
                full_v(s), tk.kvh * HD + c * L::CW, i * kBlockN, tk.b);
        }
      }
    }
  } else {
    // ---------------- consumers: 64 rows per warpgroup ------------------
    hopper::setmaxnreg_inc<kConsumerRegs>();
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int rows = p.seq_q * p.group;
    const int off = p.seq_kv - p.seq_q;
    // Q buffer `buf` of this warpgroup (shared address).
    auto q_buf = [&](int buf) {
      return base + L::Q_OFF + (buf * 2 + wg) * L::NCH * L::Q_CHUNK;
    };
    auto k_addr = [&](int s) { return base + L::K_OFF + s * L::KV_TILE; };
    auto v_addr = [&](int s) { return base + L::V_OFF + s * L::KV_TILE; };

    // Ping-pong: the two warpgroups take turns to issue their products
    // (named barriers 3 and 4), so one's softmax runs while the tensor
    // cores work on the other's; warpgroup 0 goes first.
    auto my_turn = [&] { hopper::named_barrier_sync(3 + wg, 256); };
    auto your_turn = [&] { hopper::named_barrier_arrive(4 - wg, 256); };
    if (wg == 1) your_turn();

    prefetch_q<HD>(q, decode_task(sch.task(0), sch, p), wg, p, q_buf(0));
    hopper::cp_async_commit();
    int it = 0;                             // tiles through the ring
    int buf = 0;                            // this task's Q buffer
    for (int r = 0; r < rounds; ++r) {
      const int t = sch.task(r);
      if (t < 0) continue;
      const Task tk = decode_task(t, sch, p);
      // The other Q buffer is free once every warp of the warpgroup is
      // past the previous task; fetch the next task's rows into it, then
      // wait for this task's.
      hopper::named_barrier_sync(1 + wg, 128);
      const int tn = r + 1 < rounds ? sch.task(r + 1) : -1;
      if (tn >= 0)
        prefetch_q<HD>(q, decode_task(tn, sch, p), wg, p, q_buf(buf ^ 1));
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(1 + wg, 128);
      const uint32_t q_addr = q_buf(buf);

      // This thread's two rows (accumulator rows g and g + 8 of its warp).
      const int ra = tk.r0 + wg * 64 + warp * 16 + lane / 4;
      const int rb = ra + 8;
      const bool va = ra < rows;
      const bool vb = rb < rows;
      const int lim_a = !va ? -1 : p.causal ? ra / p.group + off : p.seq_kv;
      const int lim_b = !vb ? -1 : p.causal ? rb / p.group + off : p.seq_kv;
      const int lim_lo = min(lim_a, lim_b);
      // Only tiles that reach past a row's limit or past T are masked.
      auto masked = [&](int t0) {
        return t0 + kBlockN - 1 > lim_lo || t0 + kBlockN > tk.n_keys;
      };

      float o[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
      float al_a, al_b;
      float sc[64];
      uint32_t pa[kBlockN / 16][4];

      // Tile 0: its scores and P.
      const int s0 = it % kStages;
      hopper::mbar_wait(full_k(s0), (it / kStages) & 1);
      my_turn();
      hopper::wgmma_fence();
      issue_qk<HD>(sc, q_addr, k_addr(s0));
      hopper::wgmma_commit();
      your_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      if (lane == 0) hopper::mbar_arrive(empty_k(s0));
      softmax_tile(sc, masked(0), 0, lim_a, lim_b, tk.n_keys, lane,
                   scale_log2, m_a, m_b, l_a, l_b, al_a, al_b);
      to_fragments(sc, pa);

      // Tile i's scores run on the tensor cores beside tile i-1's P V;
      // the softmax of tile i overlaps that P V.
      for (int i = 1; i < tk.n_tiles; ++i) {
        const int g = it + i;               // ring index of tile i
        const int s = g % kStages;
        const int sp = (g - 1) % kStages;
        hopper::mbar_wait(full_k(s), (g / kStages) & 1);
        hopper::mbar_wait(full_v(sp), ((g - 1) / kStages) & 1);
        my_turn();
        hopper::wgmma_fence();
        issue_qk<HD>(sc, q_addr, k_addr(s));
        hopper::wgmma_commit();
        issue_pv<HD>(o, pa, v_addr(sp));
        hopper::wgmma_commit();
        your_turn();
        hopper::wgmma_wait<1>();            // the scores are in
        hopper::fence_regs(sc);
        if (lane == 0) hopper::mbar_arrive(empty_k(s));
        softmax_tile(sc, masked(i * kBlockN), i * kBlockN, lim_a, lim_b,
                     tk.n_keys, lane, scale_log2, m_a, m_b, l_a, l_b, al_a,
                     al_b);
        hopper::wgmma_wait<0>();            // P V of tile i-1 is in
        hopper::fence_regs(o);
        hopper::fence_regs(pa);
        if (lane == 0) hopper::mbar_arrive(empty_v(sp));
#pragma unroll
        for (int n8 = 0; n8 < HD / 8; ++n8) {
          o[n8 * 4] *= al_a;
          o[n8 * 4 + 1] *= al_a;
          o[n8 * 4 + 2] *= al_b;
          o[n8 * 4 + 3] *= al_b;
        }
        to_fragments(sc, pa);
      }

      // The last tile's P V.
      const int gl = it + tk.n_tiles - 1;
      const int sl = gl % kStages;
      hopper::mbar_wait(full_v(sl), (gl / kStages) & 1);
      my_turn();
      hopper::wgmma_fence();
      issue_pv<HD>(o, pa, v_addr(sl));
      hopper::wgmma_commit();
      your_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      if (lane == 0) hopper::mbar_arrive(empty_v(sl));
      it += tk.n_tiles;
      buf ^= 1;

#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
      }
      const float d_a = fmaxf(l_a, 1e-30f);
      const float d_b = fmaxf(l_b, 1e-30f);
      const int64_t oa = va ? row_offset(tk.b, ra, tk.kvh, p, HD) : 0;
      const int64_t ob = vb ? row_offset(tk.b, rb, tk.kvh, p, HD) : 0;
#pragma unroll
      for (int n8 = 0; n8 < HD / 8; ++n8) {
        const int c = n8 * 8 + 2 * (lane % 4);
        if (va)
          *reinterpret_cast<__nv_bfloat162*>(out + oa + c) =
              __floats2bfloat162_rn(o[n8 * 4] / d_a, o[n8 * 4 + 1] / d_a);
        if (vb)
          *reinterpret_cast<__nv_bfloat162*>(out + ob + c) =
              __floats2bfloat162_rn(o[n8 * 4 + 2] / d_b, o[n8 * 4 + 3] / d_b);
      }
    }
  }
}

}  // namespace flash_attn

#include "flash_attention_f32.cuh"   // fp32 body

namespace flash_attn {

// Tensor map of k or v viewed as (B, T, K * hd), innermost first: boxes of
// (CW columns, kBlockN keys, 1 batch), swizzled as wgmma reads them; keys
// past T are filled with zeros.
template <int HD>
CUresult encode_kv(CUtensorMap* map, const void* ptr, const Problem& p,
                   int batch) {
  using L = Layout<HD>;
  const cuuint64_t row = static_cast<cuuint64_t>(p.num_kv) * HD;
  const cuuint64_t dims[3] = {row, static_cast<cuuint64_t>(p.seq_kv),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {row * 2, row * 2 * p.seq_kv};   // bytes
  const cuuint32_t box[3] = {L::CW, kBlockN, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      L::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

CUresult g_tensor_map_error = CUDA_SUCCESS;   // the last refused encode

// Streaming multiprocessors of the current device: one persistent block
// each.
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  return n;
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                const Problem& p, int batch, float scale_log2,
                cudaStream_t stream) {
  using L = Layout<HD>;
  CUtensorMap tk, tv;
  CUresult cr = encode_kv<HD>(&tk, k, p, batch);
  if (cr == CUDA_SUCCESS) cr = encode_kv<HD>(&tv, v, p, batch);
  if (cr != CUDA_SUCCESS) {
    g_tensor_map_error = cr;
    return kTensorMapError;
  }
  const int smem = L::BYTES + L::ALIGN;   // + room to align the base
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  Schedule sch;
  sch.n_row_blocks = (p.seq_q * p.group + kBlockM - 1) / kBlockM;
  sch.per_row_block = batch * p.num_kv;
  sch.n_tasks = sch.n_row_blocks * sch.per_row_block;
  const int blocks = min(sch.n_tasks, sm_count());
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_bf16_kernel<HD><<<blocks, kThreads, smem, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(out), p, sch, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* out,
           const Problem& p, int batch, cudaStream_t stream) {
  const float scale = 1.f / sqrtf(static_cast<float>(HD));
  if (dtype == 1)
    return launch_bf16<HD>(q, k, v, out, p, batch, scale * kLog2e, stream);
  return kUnsupported;
}

}  // namespace flash_attn

// dtype: 1 = bf16 (fp32 runs through flash_attention_f32_launch; 0 is
// refused).  Returns 0, a cudaError_t, -1 for a (dtype, head_dim) that is
// not built, or -2 when the driver refuses a tensor map (see
// flash_attention_error_string).
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

// fp32 with split keys: `chunk` keys a task and `chunks` task slots a row
// block of 64 flattened rows, as kernels/flash_attention/ops.py's
// split_plan gives them; `partial` is fp32 scratch of B * K * row blocks *
// chunks * 64 * (head_dim + 2) elements when chunks > 1 (else unused).
// Returns 0, a cudaError_t, -1 for a head_dim that is not built, or -3 for
// a split that does not cover the keys or lacks its scratch.
extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, void* out,
                                          void* partial, int batch,
                                          int seq_q, int seq_kv, int num_kv,
                                          int group, int head_dim, int causal,
                                          int chunk, int chunks,
                                          void* stream) {
  using namespace flash_attn;
  const Problem p{seq_q, seq_kv, num_kv, group, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(out);
  float* fp = static_cast<float*>(partial);
  switch (head_dim) {
    case 32: return launch_f32<32>(fq, fk, fv, fo, fp, p, batch, chunk, chunks, st);
    case 64: return launch_f32<64>(fq, fk, fv, fo, fp, p, batch, chunk, chunks, st);
    case 96: return launch_f32<96>(fq, fk, fv, fo, fp, p, batch, chunk, chunks, st);
    case 128: return launch_f32<128>(fq, fk, fv, fo, fp, p, batch, chunk, chunks, st);
    default: return kUnsupported;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  static char msg[96];
  if (code == flash_attn::kBadSplit)
    return "the fp32 split misses keys or has no scratch";
  if (code == flash_attn::kTensorMapError) {
    snprintf(msg, sizeof(msg), "cuTensorMapEncodeTiled failed (CUresult %d)",
             static_cast<int>(flash_attn::g_tensor_map_error));
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
