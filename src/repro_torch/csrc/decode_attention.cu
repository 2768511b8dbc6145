// Ragged single-token GQA decode attention over a dense KV cache, for
// Hopper (sm_90a).  Replaces the Pallas TPU kernel `decode_attention_pallas`
// (src/repro/kernels/decode_attention/decode_attention.py:61).  The body,
// its bound and its design are in decode_split.cuh: each slot's keys are
// split into chunks, one thread block per (chunk, KV head, slot), with a
// deterministic combine by the last block of each (slot, KV head).
//
// Split size: 128 keys (the host's plan, `split_plan` in
// kernels/decode_attention/ops.py), two 64-row tiles a block on a 2-stage
// ring, so the second tile's load overlaps the first tile's arithmetic.  At
// the main shape (B = 4, K = 8, T = 1088, lengths 1041/913/760/577) that
// gives a grid of 9 x 8 x 4 = 288 blocks, 224 with keys.  64-key splits of
// one tile (544 blocks, 432 with keys) measured slower on an H100: more
// blocks pay the fixed cost of q, the first load's latency and the
// combine, over twice as many partial states.
//
// q, out: (B, H, hd) with H = K * G, head h = kvh * G + g; k, v: (B, T, K, hd);
// lengths: (B,) int32, clamped to [0, T].  All contiguous, 16-byte aligned.
#include "decode_split.cuh"

namespace decode_attn {

constexpr int kDenseStages = 2;   // a 128-key split is two 64-row tiles
template <typename T, int G, int HD>
using DenseLayout = SplitLayout<T, G, HD, kDenseStages>;

template <typename T, int G, int HD>
__global__ void __launch_bounds__(kThreads)
dense_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   T* __restrict__ out, int seq_len, int num_kv, int chunk,
                   SplitScratch scratch) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t bk = static_cast<int64_t>(b) * num_kv + kvh;
  // The slot's length and q, issued together before the early exit.
  const int length = min(max(lengths[b], 0), seq_len);
  QShare<T, G, HD> qs;
  qs.load(q + bk * G * HD);
  const int n_active = (length + chunk - 1) / chunk;   // splits with keys
  if (split >= max(n_active, 1)) return;
  T* o = out + bk * G * HD;
  if (n_active == 0) {   // an empty slot returns zeros
    for (int i = threadIdx.x; i < G * HD; i += kThreads) store(o + i, 0.f);
    return;
  }
  const int t_begin = split * chunk;
  qs.stage(reinterpret_cast<float*>(smem + DenseLayout<T, G, HD>::Q_OFF));
  split_attend<T, G, HD, kDenseStages>(
      k, v, t_begin, min(length, t_begin + chunk),
      DenseRows{static_cast<int64_t>(b) * seq_len, num_kv, kvh, HD}, smem);
  split_finish<T, G, HD, kDenseStages>(o, split, n_active, bk, scratch, smem);
}

}  // namespace decode_attn

// partial: fp32 scratch of (batch, num_kv, splits, group * (head_dim + 2));
// counters: batch * num_kv zeros, left zero by the launch; chunk: keys per
// split; splits: ceil(seq_len / chunk).  Returns 0, a cudaError_t, or -1
// for shapes no kernel is built for.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int batch, int seq_len,
                                       int num_kv, int group, int head_dim,
                                       int dtype, void* stream, void* partial,
                                       void* counters, int splits, int chunk) {
  using namespace decode_attn;
  if (chunk < 1 || splits < 1 ||
      static_cast<int64_t>(splits) * chunk < seq_len)
    return kUnsupported;
  const SplitScratch scratch{static_cast<float*>(partial),
                             static_cast<unsigned*>(counters), splits};
  return dispatch(dtype, head_dim, group, [&](auto cfg) -> int {
    using C = decltype(cfg);
    using T = typename C::T;
    const int bytes = max(DenseLayout<T, C::G, C::HD>::BYTES,
                          combine_bytes<C::G>(splits));
    if (bytes > kMaxSmem) return kUnsupported;
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          dense_split_kernel<T, C::G, C::HD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    dense_split_kernel<T, C::G, C::HD>
        <<<dim3(splits, num_kv, batch), kThreads, bytes,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<const int*>(lengths),
            static_cast<T*>(out), seq_len, num_kv, chunk, scratch);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
