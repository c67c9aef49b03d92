// Helpers shared by csrc/paged_attn.cu and csrc/flash_attn.cu: dtype
// conversions, warp reductions, cp.async, and the combine kernel that
// merges a split launch's float32 partial states.
//
// combine_states_kernel
//   acc (S, R, D), m, l (S, R) float32: S partial online-softmax states
//   of R rows (one per split of the key range, unnormalized).  Writes
//   out (R, D) in T: acc / max(l, 1e-30) of the log-sum-exp merge, taken
//   in split order (fixed, so a call is reproducible bit for bit).  Split
//   s is weighted by exp(m_s - M), M the largest m: a split whose keys are
//   all masked for a row (m_s = -1e30) drops out exactly once any split
//   has a real key, and an all-empty row gives 0.  It is the multi-way
//   form of csrc/cascade_attn.cu's two-state merge.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros
// (src must still be a valid address).  No memory clobber, so the loads
// that compute the next address may move ahead of it; the ring's order is
// kept by cp_async_wait and the barriers around it.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kCombineThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_states_kernel(const float* __restrict__ acc,
                      const float* __restrict__ m,
                      const float* __restrict__ l, T* __restrict__ out,
                      int S, long long R, int D) {
  const long long r = blockIdx.x;
  float M = kNegInf;
  for (int s = 0; s < S; ++s) M = fmaxf(M, m[s * R + r]);
  float L = 0.f;
  for (int s = 0; s < S; ++s) L += expf(m[s * R + r] - M) * l[s * R + r];
  const float lf = fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float a = 0.f;
    for (int s = 0; s < S; ++s)
      a += expf(m[s * R + r] - M) * acc[(s * R + r) * D + d];
    out[r * D + d] = from_f32<T>(a / lf);
  }
}

template <typename T>
cudaError_t combine_states(const float* acc, const float* m, const float* l,
                           T* out, int S, long long R, int D,
                           cudaStream_t stream) {
  if (R > 0x7fffffffLL) return cudaErrorInvalidValue;
  combine_states_kernel<T><<<(unsigned)R, kCombineThreads, 0, stream>>>(
      acc, m, l, out, S, R, D);
  return cudaGetLastError();
}

}  // namespace attn
