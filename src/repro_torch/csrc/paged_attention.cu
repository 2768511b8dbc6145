// Paged single-token GQA decode attention over a global KV page pool, for
// Hopper (sm_90a).  Replaces the Pallas TPU kernel `paged_attention_pallas`
// (src/repro/kernels/paged_attention/paged_attention.py).  Same body as the
// dense kernel (decode_attention_common.cuh); where the TPU kernel had the
// page table prefetched as scalars ahead of its grid, each block here reads
// its own slot's table row and walks the slot's pages in order.
//
// q, out: (B, H, hd) with H = K * G; k_pool, v_pool: (N, block, K, hd);
// table: (B, W) int32, entries clamped to [0, N-1]; lengths: (B,) int32,
// clamped to [0, W * block].  All contiguous.
#include "decode_attention_common.cuh"

namespace decode_attn {

template <typename T, int G, int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool, const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int num_pages, int block, int width, int num_kv) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int length = min(max(lengths[b], 0), width * block);
  const int64_t tile = (static_cast<int64_t>(b) * num_kv + kvh) * G * HD;
  const PagedRows rows{table + static_cast<int64_t>(b) * width, num_pages,
                       block, num_kv, kvh, HD};
  attend<T, G, HD>(q + tile, k_pool, v_pool, out + tile, length, rows);
}

}  // namespace decode_attn

extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* table,
                                      const void* lengths, void* out, int batch,
                                      int num_pages, int block, int width,
                                      int num_kv, int group, int head_dim,
                                      int dtype, void* stream) {
  using namespace decode_attn;
  return dispatch(dtype, head_dim, group, [&](auto cfg) -> int {
    using C = decltype(cfg);
    using T = typename C::T;
    paged_decode_kernel<T, C::G, C::HD>
        <<<dim3(num_kv, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(q), static_cast<const T*>(k_pool),
            static_cast<const T*>(v_pool), static_cast<const int*>(table),
            static_cast<const int*>(lengths), static_cast<T*>(out), num_pages,
            block, width, num_kv);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
