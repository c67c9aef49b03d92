// Helpers shared by csrc/paged_attn.cu, csrc/cascade_attn.cu and
// csrc/flash_attn.cu: dtype conversions, warp reductions, cp.async, and the
// combine kernel that merges float32 partial softmax states.
//
// combine_states_kernel
//   S partial online-softmax states of R rows, unnormalized float32 (one
//   per split of a key range): a split launch's scratch acc (S, R, D), m,
//   l (S, R), or two states that lie apart (acc (R, D), m, l (R) each),
//   so the cascade's two-state merge takes the same kernel.  The
//   log-sum-exp merge, in split order (fixed, so a call is reproducible
//   bit for bit): M = max_s m_s, l = sum_s exp(m_s - M) l_s, acc = sum_s
//   exp(m_s - M) acc_s.  Two epilogues (a template flag): combine_states
//   writes acc / max(l, 1e-30) to out (R, D) in T; combine_to_state writes
//   the float32 state (acc, M, l) itself.  A split whose keys are all
//   masked for a row (m_s = -1e30, l_s = 0, acc_s = 0) drops out exactly
//   once any split has a real key (exp(-1e30 - M) is 0), and an all-empty
//   row gives exactly the empty state (acc 0, m -1e30, l 0: exp(0) = 1
//   times zeros), or 0 normalized.
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

// The S states a combine reads: split 0, then split 1 (and, stacked after
// it, splits 2 .. S-1).
struct States {
  const float *acc0, *m0, *l0;
  const float *acc1, *m1, *l1;
};

// The states of a split launch's scratch: acc (S, R, D), m, l (S, R).
inline States stacked_states(const float* acc, const float* m,
                             const float* l, long long R, int D) {
  return {acc, m, l, acc + R * D, m + R, l + R};
}

// kS > 0 fixes S at compile time (the two-state merge, and the prefix
// pass's 8 splits at a decode tick), so the loops unroll and every load of
// a row is issued before the arithmetic that waits on it.  Split s of row
// r lies at s*R rows from split 0 (the stacked layout), except that the
// two-state form (kS == 2) reads its second state from acc1, m1, l1.
// kState picks the epilogue: the state itself, or acc / max(l, 1e-30).
template <typename T, int kS, bool kState>
__global__ void __launch_bounds__(kCombineThreads)
combine_states_kernel(const float* __restrict__ acc0,
                      const float* __restrict__ m0,
                      const float* __restrict__ l0,
                      const float* __restrict__ acc1,
                      const float* __restrict__ m1,
                      const float* __restrict__ l1, int S_arg, long long R,
                      int D, T* __restrict__ out, float* __restrict__ m_out,
                      float* __restrict__ l_out) {
  const int S = kS > 0 ? kS : S_arg;
  const long long r = blockIdx.x;
  auto m_of = [&](int s) { return kS == 2 && s ? m1[r] : m0[s * R + r]; };
  auto l_of = [&](int s) { return kS == 2 && s ? l1[r] : l0[s * R + r]; };
  float M = kNegInf;
  for (int s = 0; s < S; ++s) M = fmaxf(M, m_of(s));
  float L = 0.f;
  for (int s = 0; s < S; ++s) L += expf(m_of(s) - M) * l_of(s);
  const float lf = fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float a = 0.f;
    for (int s = 0; s < S; ++s)
      a += expf(m_of(s) - M) *
           (kS == 2 && s ? acc1[r * D + d] : acc0[(s * R + r) * D + d]);
    out[r * D + d] = from_f32<T>(kState ? a : a / lf);
  }
  if (kState && threadIdx.x == 0) {
    m_out[r] = M;
    l_out[r] = L;
  }
}

// One CTA per row.  Two states may lie anywhere; more must be stacked
// (stacked_states).
template <typename T, bool kState>
cudaError_t launch_combine(const States& in, int S, long long R, int D,
                           T* out, float* m_out, float* l_out,
                           cudaStream_t stream) {
  if (R <= 0 || R > 0x7fffffffLL ||
      (S != 2 && (in.acc1 != in.acc0 + R * D || in.m1 != in.m0 + R ||
                  in.l1 != in.l0 + R)))
    return cudaErrorInvalidValue;
  const auto kernel = S == 2   ? combine_states_kernel<T, 2, kState>
                      : S == 8 ? combine_states_kernel<T, 8, kState>
                               : combine_states_kernel<T, 0, kState>;
  kernel<<<(unsigned)R, kCombineThreads, 0, stream>>>(
      in.acc0, in.m0, in.l0, in.acc1, in.m1, in.l1, S, R, D, out, m_out,
      l_out);
  return cudaGetLastError();
}

// The merged rows normalized, out (R, D) in T.
template <typename T>
cudaError_t combine_states(const States& in, int S, long long R, int D,
                           T* out, cudaStream_t stream) {
  return launch_combine<T, false>(in, S, R, D, out, nullptr, nullptr,
                                  stream);
}

// The merged state itself: acc (R, D), m, l (R) float32.
inline cudaError_t combine_to_state(const States& in, int S, long long R,
                                    int D, float* acc, float* m, float* l,
                                    cudaStream_t stream) {
  return launch_combine<float, true>(in, S, R, D, acc, m, l, stream);
}

}  // namespace attn
