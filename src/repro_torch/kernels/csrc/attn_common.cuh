// Helpers shared by csrc/paged_attn.cu, csrc/cascade_attn.cu,
// csrc/flash_attn.cu and csrc/flash_attn_bwd.cu: dtype conversions, warp
// reductions, cp.async, the bf16 tensor-core building blocks (ldmatrix,
// mma.sync), the two-state merge, and the combine kernel that merges
// float32 partial softmax states.
//
// merge_two
//   The cascade's log-sum-exp merge of two states over disjoint key sets,
//   prefix first, normalized: m = max(m1, m2), c = exp(m_side - m), out =
//   (c1 a1 + c2 a2) / max(c1 l1 + c2 l2, 1e-30), each product and sum
//   rounded on its own (the intrinsics keep nvcc from contracting them
//   into FMAs), as the reference's plain merge computes it.  Every merge
//   of the port calls it: the standalone merge_attn_states kernel, the
//   one-split suffix pass's merging epilogue and the combine's, so the
//   fused suffix pass is bit for bit the three-launch composition (state,
//   then the standalone merge, then the cast).  An empty side (m = -1e30,
//   l = 0, a = 0) drops out exactly; two empty sides give 0.
//
// combine_states_kernel
//   S partial online-softmax states of R rows, unnormalized float32 (one
//   per split of a key range), stacked: a split launch's scratch acc (S,
//   R, D), m, l (S, R).  The log-sum-exp merge, in split order (fixed, so
//   a call is reproducible bit for bit): M = max_s m_s, l = sum_s exp(m_s
//   - M) l_s, acc = sum_s exp(m_s - M) acc_s.  Three epilogues (a template
//   argument): combine_states writes acc / max(l, 1e-30) to out (R, D) in
//   T (and, given an lse (R) float32, M + log(max(l, 1e-30)) to it);
//   combine_to_state writes the float32 state (acc, M, l) itself;
//   combine_merge computes that same state and merges each row's prefix
//   state into it (merge_two, the Prefix below), writing out (R, D) in T.
//   A split whose keys are all masked for a row (m_s = -1e30, l_s = 0,
//   acc_s = 0) drops out exactly once any split has a real key (exp(-1e30
//   - M) is 0), and an all-empty row gives exactly the empty state (acc 0,
//   m -1e30, l 0: exp(0) = 1 times zeros), or 0 normalized.
//
// allow_max_smem
//   Lifts a kernel's dynamic shared memory limit to the most a block can
//   take, once per device and process, so that a later launch, one being
//   captured into a CUDA graph included, makes no attribute call.
#pragma once
#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr float kNegInf = -1e30f;
constexpr int kMaxSmemPerBlock = 227 * 1024;   // H100: 232,448 bytes
constexpr int kMaxDevices = 64;

template <auto Kernel>
cudaError_t allow_max_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmemPerBlock);
  if (e == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return e;
}

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

// The bf16 tensor-core building blocks of csrc/flash_attn.cu and
// csrc/flash_attn_bwd.cu: ldmatrix of four 8 x 8 b16 tiles (plain and
// transposed), mma.sync m16n8k16 and a pair of floats packed to bf16.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, float32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// Row stride, in bf16 elements, of a tile whose rows hold KS x 16 columns:
// an odd number of 16-byte units, so ldmatrix's eight row addresses fall
// in distinct banks.
__host__ __device__ constexpr int mma_ld(int KS) { return KS * 16 + 8; }

// The cascade's two-state merge, normalized (see the top of the file).
__device__ __forceinline__ float merge_two(float m1, float l1, float a1,
                                           float m2, float l2, float a2) {
  const float m = fmaxf(m1, m2);
  const float c1 = expf(m1 - m), c2 = expf(m2 - m);
  const float a = __fadd_rn(__fmul_rn(c1, a1), __fmul_rn(c2, a2));
  const float l = __fadd_rn(__fmul_rn(c1, l1), __fmul_rn(c2, l2));
  return __fdiv_rn(a, fmaxf(l, 1e-30f));
}

// The prefix pass's states in group layout, for a merging epilogue: acc
// (slots * Hq, D), m, l (slots * Hq) float32, slots = G * Lc; lane_slot
// (B,) int32 names lane b's flat slot g * Lc + c.  A slot outside [0,
// slots) (-1: a lane in no group) stands for the empty state, which the
// merge still takes, as the composition does.  lane_slot == nullptr: no
// prefix.
struct Prefix {
  const float *acc, *m, *l;
  const int32_t* lane_slot;
  long long slots;
  int Hq;
};

// Lane b's merged, normalized output at query head hq, column d, given its
// suffix state's a2 (that column), m2 and l2.
__device__ __forceinline__ float merge_prefix(const Prefix& p, long long b,
                                              int hq, int d, int D, float m2,
                                              float l2, float a2) {
  const long long s = p.lane_slot[b];
  if (s < 0 || s >= p.slots) return merge_two(kNegInf, 0.f, 0.f, m2, l2, a2);
  const long long row = s * p.Hq + hq;
  return merge_two(p.m[row], p.l[row], p.acc[row * D + d], m2, l2, a2);
}

constexpr int kCombineThreads = 128;

// The S stacked states a combine reads: acc (S, R, D), m, l (S, R).
struct States {
  const float *acc, *m, *l;
};

inline States stacked_states(const float* acc, const float* m,
                             const float* l) {
  return {acc, m, l};
}

enum Epilogue { kNormalize, kState, kMerge };

// kS > 0 fixes S at compile time (2 splits, and the prefix pass's 8 splits
// at a decode tick), so the loops unroll and every load of a row is issued
// before the arithmetic that waits on it.  Split s of row r lies s*R rows
// after split 0.  kEpi picks the epilogue; pre is read only by kMerge.
template <typename T, int kS, int kEpi>
__global__ void __launch_bounds__(kCombineThreads)
combine_states_kernel(const float* __restrict__ acc,
                      const float* __restrict__ m,
                      const float* __restrict__ l, int S_arg, long long R,
                      int D, T* __restrict__ out, float* __restrict__ m_out,
                      float* __restrict__ l_out, const Prefix pre) {
  const int S = kS > 0 ? kS : S_arg;
  const long long r = blockIdx.x;
  float M = kNegInf;
  for (int s = 0; s < S; ++s) M = fmaxf(M, m[s * R + r]);
  float L = 0.f;
  for (int s = 0; s < S; ++s) L += expf(m[s * R + r] - M) * l[s * R + r];
  const float lf = fmaxf(L, 1e-30f);
  const long long b = kEpi == kMerge ? r / pre.Hq : 0;
  const int hq = kEpi == kMerge ? (int)(r - b * pre.Hq) : 0;
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float a = 0.f;
    for (int s = 0; s < S; ++s)
      a += expf(m[s * R + r] - M) * acc[(s * R + r) * D + d];
    if (kEpi == kMerge)
      out[r * D + d] = from_f32<T>(merge_prefix(pre, b, hq, d, D, M, L, a));
    else
      out[r * D + d] = from_f32<T>(kEpi == kState ? a : a / lf);
  }
  if (kEpi == kState && threadIdx.x == 0) {
    m_out[r] = M;
    l_out[r] = L;
  }
  // kNormalize: m_out, when given, takes the merged rows' log-sum-exp
  if (kEpi == kNormalize && m_out != nullptr && threadIdx.x == 0)
    m_out[r] = M + logf(lf);
}

// One CTA per row.
template <typename T, int kEpi>
cudaError_t launch_combine(const States& in, int S, long long R, int D,
                           T* out, float* m_out, float* l_out,
                           const Prefix& pre, cudaStream_t stream) {
  if (R <= 0 || R > 0x7fffffffLL || S < 2 ||
      (kEpi == kMerge && (pre.lane_slot == nullptr || pre.Hq <= 0)))
    return cudaErrorInvalidValue;
  const auto kernel = S == 2   ? combine_states_kernel<T, 2, kEpi>
                      : S == 8 ? combine_states_kernel<T, 8, kEpi>
                               : combine_states_kernel<T, 0, kEpi>;
  kernel<<<(unsigned)R, kCombineThreads, 0, stream>>>(
      in.acc, in.m, in.l, S, R, D, out, m_out, l_out, pre);
  return cudaGetLastError();
}

// The merged rows normalized, out (R, D) in T; with lse, each merged row's
// M + log(max(l, 1e-30)) there, (R) float32.
template <typename T>
cudaError_t combine_states(const States& in, int S, long long R, int D,
                           T* out, cudaStream_t stream,
                           float* lse = nullptr) {
  return launch_combine<T, kNormalize>(in, S, R, D, out, lse, nullptr,
                                       Prefix{}, stream);
}

// The merged state itself: acc (R, D), m, l (R) float32.
inline cudaError_t combine_to_state(const States& in, int S, long long R,
                                    int D, float* acc, float* m, float* l,
                                    cudaStream_t stream) {
  return launch_combine<float, kState>(in, S, R, D, acc, m, l, Prefix{},
                                       stream);
}

// The merged state, computed as combine_to_state computes it, merged with
// each row's prefix state (row r = b * Hq + hq) and normalized: out (R, D)
// in T.
template <typename T>
cudaError_t combine_merge(const States& in, int S, long long R, int D,
                          const Prefix& pre, T* out, cudaStream_t stream) {
  return launch_combine<T, kMerge>(in, S, R, D, out, nullptr, nullptr, pre,
                                   stream);
}

}  // namespace attn
