// The Mamba-2 (SSD) single-token decode step, for Hopper (sm_90a): the
// state update and its readout in one pass over the state.
//
// It replaces no Pallas kernel: the JAX package's `_ssd_step`
// (src/repro/models/ssm.py) is plain jnp.  It is added because the step is
// bound by the state's bytes.  The plain PyTorch step
// (`ssd_step_plain`, kernels/ssd_step/ops.py) makes about ten passes over
// the fp32 state: the outer product B·dx, the decay, the sum, the readout's
// layout copy and read, and the model's copy of the new state back into the
// cache.  This kernel reads each state tile once and writes it once, in
// place.  At Nemotron-H's shape (32 slots, 256 heads, N = 256, P = 64) the
// state is 537 MB a layer, so its bound is 1.074 GB a layer, 0.3205 ms at
// 3.35 TB/s; x, dt, B, C and y add under 0.1%.
//
// Per (row b, head h), with g = h / (H / G) the head's group:
//   a      = exp(-exp(A_log[h]) * dt[b, h])
//   dx[p]  = dt[b, h] * x[b, h, p]
//   h'[n, p] = h[n, p] * a + B[b, g, n] * dx[p]       (written in place)
//   y[b, h, p] = sum_n C[b, g, n] * h'[n, p]           (fp32)
// Every product and sum of the update is rounded as the plain step rounds
// it, in its order (`__fmul_rn`/`__fadd_rn`, so no FMA contracts them): the
// new state equals the plain step's bit for bit.  The readout sums in
// another order than the plain step's batched product, so y agrees to fp32
// summation order only.
//
// Design: one block per (head, row), 8,192 blocks at 32 slots.  A thread
// owns a float4 of P (P / 4 threads span a state row) and every 16th row
// of n, 16 rows a pass (8 at P = 128).  It issues all of a pass's state
// loads before any arithmetic, so at P = 64 and N = 256 the whole 64 KB
// tile of a block is in flight at once, in registers, with no
// shared-memory staging; two blocks fit an SM, so one block's loads
// overlap the other's stores and reduction.  B and C of the head's group
// are read in x's dtype (bf16 on the serving path), widened and shared
// through shared memory, a pass's rows at a time.  The readout is summed
// per thread, then across the 16 row groups in shared memory, in
// row-group order.
//
// x: (B, H, P) and b_in, c_in: (B, G, N), in T (bf16 or fp32), each row at
// its own stride, contiguous within it; dt: (B, H) fp32; a_log: (H,) fp32 or
// bf16; state: (B, H, N, P) fp32, contiguous and 16-byte aligned; y: (B, H,
// P) fp32, contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ssd_step {

constexpr int kRowGroups = 16;   // threads down N
// rows a thread holds in a pass: 64 floats of state in registers (P =
// 128 runs 512 threads a block, at most 128 registers a thread)
template <int P>
constexpr int kUnroll = P > 64 ? 8 : 16;
constexpr int kUnsupported = -1;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Two blocks an SM where they fit (P <= 64): one block's loads then
// overlap the other's stores, reduction and start
template <int P>
constexpr int kMinBlocks = P > 64 ? 1 : 2;

template <typename T, int P>
__global__ void __launch_bounds__(P / 4 * kRowGroups, kMinBlocks<P>)
ssd_step_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const void* __restrict__ a_log, int a_log_f32,
                const T* __restrict__ b_in, const T* __restrict__ c_in,
                float* __restrict__ state, float* __restrict__ y, int heads,
                int groups, int n, int64_t x_row, int64_t b_row,
                int64_t c_row) {
  constexpr int kCols = P / 4;
  constexpr int U = kUnroll<P>;
  constexpr int kRows = kRowGroups * U;   // rows of n a pass
  __shared__ float4 part[kRowGroups][kCols];
  __shared__ float bs[kRows], cs[kRows];
  const int col = threadIdx.x % kCols;
  const int rg = threadIdx.x / kCols;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t bh = static_cast<int64_t>(b) * heads + h;
  const int g = h / (heads / groups);

  const float dtv = dt[bh];
  const float al =
      a_log_f32 ? static_cast<const float*>(a_log)[h]
                : __bfloat162float(static_cast<const __nv_bfloat16*>(a_log)[h]);
  const float a = expf(__fmul_rn(-expf(al), dtv));
  const T* xp = x + b * x_row + static_cast<int64_t>(h) * P + 4 * col;
  const float dx0 = __fmul_rn(dtv, widen(xp[0]));
  const float dx1 = __fmul_rn(dtv, widen(xp[1]));
  const float dx2 = __fmul_rn(dtv, widen(xp[2]));
  const float dx3 = __fmul_rn(dtv, widen(xp[3]));
  const T* bp = b_in + b * b_row + static_cast<int64_t>(g) * n;
  const T* cp = c_in + b * c_row + static_cast<int64_t>(g) * n;
  float4* tile = reinterpret_cast<float4*>(state + bh * n * P);

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = 0; base < n; base += kRows) {
    float4 s[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {   // every state load of the pass first
      const int row = base + k * kRowGroups + rg;
      if (row < n) s[k] = tile[static_cast<int64_t>(row) * kCols + col];
    }
    // the pass's B and C, widened, in shared memory (not in registers,
    // which two blocks an SM leave no room for)
    if (base) __syncthreads();       // the last pass has read them
    for (int i = threadIdx.x; i < kRows; i += kCols * kRowGroups) {
      const int row = base + i;
      bs[i] = row < n ? widen(bp[row]) : 0.f;
      cs[i] = row < n ? widen(cp[row]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int row = base + k * kRowGroups + rg;
      if (row < n) {
        const float bv = bs[k * kRowGroups + rg];
        const float cv = cs[k * kRowGroups + rg];
        float4 v = s[k];
        v.x = __fadd_rn(__fmul_rn(v.x, a), __fmul_rn(bv, dx0));
        v.y = __fadd_rn(__fmul_rn(v.y, a), __fmul_rn(bv, dx1));
        v.z = __fadd_rn(__fmul_rn(v.z, a), __fmul_rn(bv, dx2));
        v.w = __fadd_rn(__fmul_rn(v.w, a), __fmul_rn(bv, dx3));
        tile[static_cast<int64_t>(row) * kCols + col] = v;
        acc.x = fmaf(cv, v.x, acc.x);
        acc.y = fmaf(cv, v.y, acc.y);
        acc.z = fmaf(cv, v.z, acc.z);
        acc.w = fmaf(cv, v.w, acc.w);
      }
    }
  }
  part[rg][col] = acc;
  __syncthreads();
  if (rg == 0) {
    float4 sum = part[0][col];
#pragma unroll
    for (int r = 1; r < kRowGroups; ++r) {
      const float4 o = part[r][col];
      sum.x += o.x;
      sum.y += o.y;
      sum.z += o.z;
      sum.w += o.w;
    }
    reinterpret_cast<float4*>(y + bh * P)[col] = sum;
  }
}

template <typename T, int P>
int launch(const void* x, const void* dt, const void* a_log, int a_log_f32,
           const void* b_in, const void* c_in, void* state, void* y,
           int batch, int heads, int groups, int n, int64_t x_row,
           int64_t b_row, int64_t c_row, cudaStream_t stream) {
  ssd_step_kernel<T, P><<<dim3(heads, batch), P / 4 * kRowGroups, 0,
                          stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), a_log,
      a_log_f32, static_cast<const T*>(b_in), static_cast<const T*>(c_in),
      static_cast<float*>(state), static_cast<float*>(y), heads, groups, n,
      x_row, b_row, c_row);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(int p, const void* x, const void* dt, const void* a_log,
             int a_log_f32, const void* b_in, const void* c_in, void* state,
             void* y, int batch, int heads, int groups, int n, int64_t x_row,
             int64_t b_row, int64_t c_row, cudaStream_t stream) {
#define SSD_STEP_P(PV)                                                     \
  case PV:                                                                 \
    return launch<T, PV>(x, dt, a_log, a_log_f32, b_in, c_in, state, y,    \
                         batch, heads, groups, n, x_row, b_row, c_row,     \
                         stream);
  switch (p) {
    SSD_STEP_P(16)
    SSD_STEP_P(32)
    SSD_STEP_P(64)
    SSD_STEP_P(128)
    default:
      return kUnsupported;
  }
#undef SSD_STEP_P
}

}  // namespace ssd_step

// dtype: 0 fp32, 1 bf16 (x, b_in, c_in); a_log_f32: 1 if a_log is fp32, 0
// if bf16; x_row, b_row, c_row: elements from one row's x, B, C to the
// next's.  Returns 0, a cudaError_t, or -1 for a shape or dtype not built.
extern "C" int ssd_step_launch(const void* x, const void* dt,
                               const void* a_log, int a_log_f32,
                               const void* b_in, const void* c_in,
                               void* state, void* y, int batch, int heads,
                               int groups, int n, int p, int dtype,
                               long long x_row, long long b_row,
                               long long c_row, void* stream) {
  using namespace ssd_step;
  if (batch < 1 || heads < 1 || groups < 1 || heads % groups || n < 1 ||
      batch > 65535)
    return kUnsupported;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_p<float>(p, x, dt, a_log, a_log_f32, b_in, c_in, state, y,
                           batch, heads, groups, n, x_row, b_row, c_row, s);
  if (dtype == 1)
    return launch_p<__nv_bfloat16>(p, x, dt, a_log, a_log_f32, b_in, c_in,
                                   state, y, batch, heads, groups, n, x_row,
                                   b_row, c_row, s);
  return kUnsupported;
}

extern "C" const char* ssd_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
