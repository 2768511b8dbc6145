// Ragged single-token GQA decode attention over a dense KV cache, for
// Hopper (sm_90a).  Replaces the Pallas TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention/decode_attention.py); the body, its
// bound and its design are described in decode_attention_common.cuh.
//
// q, out: (B, H, hd) with H = K * G, head h = kvh * G + g; k, v: (B, T, K, hd);
// lengths: (B,) int32, clamped to [0, T].  All contiguous.
#include "decode_attention_common.cuh"

namespace decode_attn {

template <typename T, int G, int HD>
__global__ void __launch_bounds__(kThreads)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ out, int seq_len, int num_kv) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int length = min(max(lengths[b], 0), seq_len);
  const int64_t tile = (static_cast<int64_t>(b) * num_kv + kvh) * G * HD;
  const DenseRows rows{static_cast<int64_t>(b) * seq_len, num_kv, kvh, HD};
  attend<T, G, HD>(q + tile, k, v, out + tile, length, rows);
}

}  // namespace decode_attn

extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int batch, int seq_len,
                                       int num_kv, int group, int head_dim,
                                       int dtype, void* stream) {
  using namespace decode_attn;
  return dispatch(dtype, head_dim, group, [&](auto cfg) -> int {
    using C = decltype(cfg);
    using T = typename C::T;
    dense_decode_kernel<T, C::G, C::HD>
        <<<dim3(num_kv, batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const int*>(lengths),
            static_cast<T*>(out), seq_len, num_kv);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
