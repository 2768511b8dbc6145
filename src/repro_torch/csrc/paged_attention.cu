// Paged single-token GQA decode attention over a global KV page pool, for
// Hopper (sm_90a).  Replaces the Pallas TPU kernel `paged_attention_pallas`
// (src/repro/kernels/paged_attention/paged_attention.py:66).  The body,
// its bound and its design are in decode_split.cuh: the KV axis is split
// into chunks of whole pages, one thread block per (chunk, KV head, slot),
// with a deterministic combine by the last block of each (slot, KV head).
// The pages of a chunk lie anywhere in the pool, so every thread of the
// block gathers rows with 16-byte `cp.async` copies, one tile at a time.
// Where the TPU kernel had the page table prefetched as scalars ahead of
// its grid, each block reads its own chunk's page ids once, before its
// first K/V load.
//
// Split size: 64 keys (4 pages of 16).  At the paged path's main shape
// (B = 4, K = 8, W = 68, lengths 1041/913/760/577) that gives a grid of
// 17 x 8 x 4 = 544 blocks, 432 with keys, ~3.3 per SM of an H100's 132:
// enough to keep ~100 KB of loads in flight per SM, against the ~25 KB
// that 3.35 TB/s at ~1 us of latency needs.  128-key splits (224 blocks
// with keys) on a 2-stage ring measured ~10% faster for the dense kernel
// on the same shape (H100 80GB HBM3 at 700 W, PERF.md §6) and are untried
// here.  The host computes the plan (`split_plan` in
// kernels/paged_attention/ops.py) and allocates the scratch.
//
// q, out: (B, H, hd) with H = K * G; k_pool, v_pool: (N, block, K, hd);
// table: (B, W) int32, entries clamped to [0, N-1]; lengths: (B,) int32,
// clamped to [0, W * block].  All contiguous.
#include "decode_split.cuh"

namespace decode_attn {

// Rows of one split: row t of the slot, t in the split's chunk, through
// the chunk's page ids (already clamped into the pool).
struct SplitPages {
  const int* pages;   // shared memory
  int t_begin;        // the chunk's first row, a multiple of `block`
  int block;
  int num_kv;
  int kvh;
  int hd;
  __device__ __forceinline__ int64_t operator()(int t) const {
    const int local = t - t_begin;
    const int page = pages[local / block];
    return ((static_cast<int64_t>(page) * block + local % block) * num_kv +
            kvh) * hd;
  }
};

template <typename T, int G, int HD>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool, const int* __restrict__ table,
                   const int* __restrict__ lengths, T* __restrict__ out,
                   int num_pages, int block, int width, int num_kv,
                   int chunk_pages, SplitScratch scratch) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_pages[kMaxSplitPages];
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int chunk = chunk_pages * block;
  const int first = split * chunk_pages;
  const int64_t bk = static_cast<int64_t>(b) * num_kv + kvh;
  // Everything the block reads before its K/V, issued together: its
  // chunk's page ids (once, not once per row), the slot's length, q.
  const bool reads_page = threadIdx.x < chunk_pages &&
                          first + static_cast<int>(threadIdx.x) < width;
  const int page = reads_page
      ? table[static_cast<int64_t>(b) * width + first + threadIdx.x] : 0;
  const int length = min(max(lengths[b], 0), width * block);
  QShare<T, G, HD> qs;
  qs.load(q + bk * G * HD);
  const int n_active = (length + chunk - 1) / chunk;   // splits with keys
  if (split >= max(n_active, 1)) return;
  T* o = out + bk * G * HD;
  if (n_active == 0) {   // an empty slot returns zeros
    for (int i = threadIdx.x; i < G * HD; i += kThreads) store(o + i, 0.f);
    return;
  }
  if (reads_page) s_pages[threadIdx.x] = min(max(page, 0), num_pages - 1);
  qs.stage(reinterpret_cast<float*>(smem + SplitLayout<T, G, HD, 1>::Q_OFF));
  const int t_begin = split * chunk;
  const SplitPages rows{s_pages, t_begin, block, num_kv, kvh, HD};
  // one tile a split: a ring of one stage
  split_attend<T, G, HD, 1>(k_pool, v_pool, t_begin,
                            min(length, t_begin + chunk), rows, smem);
  split_finish<T, G, HD, 1>(o, split, n_active, bk, scratch, smem);
}

}  // namespace decode_attn

// partial: fp32 scratch of (batch, num_kv, splits, group * (head_dim + 2));
// counters: batch * num_kv zeros, left zero by the launch; chunk_pages:
// pages per split (at most 64); splits: ceil(width / chunk_pages).
// Returns 0, a cudaError_t, or -1 for shapes no kernel is built for.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* table,
                                      const void* lengths, void* out, int batch,
                                      int num_pages, int block, int width,
                                      int num_kv, int group, int head_dim,
                                      int dtype, void* stream, void* partial,
                                      void* counters, int splits,
                                      int chunk_pages) {
  using namespace decode_attn;
  if (chunk_pages < 1 || chunk_pages > kMaxSplitPages || splits < 1)
    return kUnsupported;
  const SplitScratch scratch{static_cast<float*>(partial),
                             static_cast<unsigned*>(counters), splits};
  return dispatch(dtype, head_dim, group, [&](auto cfg) -> int {
    using C = decltype(cfg);
    using T = typename C::T;
    const int bytes = max(SplitLayout<T, C::G, C::HD, 1>::BYTES,
                          combine_bytes<C::G>(splits));
    if (bytes > kMaxSmem) return kUnsupported;
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          paged_split_kernel<T, C::G, C::HD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    paged_split_kernel<T, C::G, C::HD>
        <<<dim3(splits, num_kv, batch), kThreads, bytes,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(q), static_cast<const T*>(k_pool),
            static_cast<const T*>(v_pool), static_cast<const int*>(table),
            static_cast<const int*>(lengths), static_cast<T*>(out), num_pages,
            block, width, num_kv, chunk_pages, scratch);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
