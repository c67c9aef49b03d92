// Prompt attention for Hopper (sm_90a): a tiled forward flash attention
// with a float32 online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py
//   flash_attention (_flash_kernel)            -> flash_attn_launch
// and serves, through the same launch, the form the reference computes in
// XLA for every prompt (src/repro/nn/attention.py _flash_fwd_impl, reached
// from attend_chunked): queries at an offset into a longer key range, a
// sliding window, and GQA by index.  Templated on float and __nv_bfloat16.
//
// flash_attn_launch
//   q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D); out (B, Sq, Hq, D), all in one
//   dtype.  Query i of head h sits at absolute position q_offset + i and
//   reads KV head h / n_rep (n_rep = Hq / Hkv).  Key j attends when
//   rel = q_offset + i - j has rel < win and, with causal, rel >= 0.  The
//   TPU kernel's (BH, S, D) call is B = BH, Hq = Hkv = 1, Sk = Sq,
//   q_offset 0, no window.
//   Scores q.k are float32 sums of float32 products, times the scale;
//   masked scores are -1e30; the running max m and sum l are float32; the
//   probabilities p = exp(s - m) enter l as they are and the value product
//   rounded to v's dtype (as the TPU kernel and the reference do); the
//   result is acc / max(l, 1e-30) in v's dtype.  A key tile that holds no
//   key in the band of any of the CTA's queries is never read; inside a
//   tile a row whose keys are all masked gets p = 1 on them while its m is
//   still -1e30, exactly as in the reference, and its first real key wipes
//   that through corr = exp(-1e30 - m) = 0.  A row with no valid key at all
//   is garbage (in the reference too).  No atomics and no order that
//   depends on anything but the inputs: a call is reproducible bit for bit,
//   which the chunked prefill's resume relies on.
//
//   Bound on the H100.  One-shot prefill of a 1,000-token prompt (32 heads
//   of 80, bf16): q, k, v and out are 20.5 MB, 6.1 us at 3.35 TB/s; the
//   causal band is 5.1 GFLOP, 5.2 us at the 989 TFLOP/s bf16 tensor-core
//   peak, so the two are even.  A fold chunk (16 queries against ~1,100
//   keys) is bound by bytes: the key range is read once per KV head, ~11 MB.
//   Design: one CTA of 128 threads per (query tile, head, batch row), with
//   tiles of 64 queries (16 when Sq <= 16, the fold's chunk).  The CTA walks
//   the key tiles of 64 that meet its band, staging each K and V tile in
//   shared memory as float32 (16-byte loads; D = 80 bf16 is 10 per row;
//   rows padded to D + 1 floats against bank conflicts).  Each thread
//   scores a fixed 8 x 4 (or 2 x 4) patch of the tile with FMAs held in
//   registers, a warp per row updates m and l, and each thread keeps a
//   fixed patch of the float32 accumulator in registers across tiles.
//   FMAs, not tensor cores, and loads that do not overlap the math: this
//   first version trades the bound for simplicity (PERF.md has its time).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTX = 16;                 // thread columns
constexpr int kTY = kThreads / kTX;     // thread rows (8)
constexpr int kBK = 64;                 // keys per tile
constexpr int kNB = kBK / kTX;          // score columns per thread (4)
constexpr int kMaxD = 128;
constexpr int kMaxC = kMaxD / kTX;      // accumulator columns per thread (8)
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

// rows of `vpr` 16-byte vectors from src (row stride `stride` elements)
// into float rows of `ld` floats; rows >= n are zero
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src,
                                           size_t stride, int rows, int n,
                                           int vpr) {
  constexpr int kVec = 16 / sizeof(T);
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr, c = i - r * vpr;
    float* d = dst + r * ld + c * kVec;
    if (r < n) {
      const uint4 x =
          __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * stride) + c);
      const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
      for (int t = 0; t < kVec; ++t) d[t] = to_f32(e[t]);
    } else {
#pragma unroll
      for (int t = 0; t < kVec; ++t) d[t] = 0.f;
    }
  }
}

// Shared memory, in floats: Q tile [BQ][D + 1], K tile [kBK][D + 1],
// V tile [kBK][D], scores/probabilities [BQ][kBK + 1], then m, l, corr
// [BQ] each.
size_t smem_bytes(int BQ, int D) {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)kBK * (D + 1) +
                          (size_t)kBK * D + (size_t)BQ * (kBK + 1) +
                          3 * (size_t)BQ);
}

template <typename T, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int Sq,
                  int Sk, int Hq, int Hkv, int D, int q_offset, int win,
                  int causal, float scale) {
  constexpr int A = BQ / kTY;           // rows per thread
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldq = D + 1, ldk = D + 1, lds = kBK + 1;
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + BQ * ldq;
  float* vs = ks + kBK * ldk;
  float* ss = vs + kBK * D;
  float* ms = ss + BQ * lds;
  float* ls = ms + BQ;
  float* cs = ls + BQ;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, Sq - q0);
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t q_row = (size_t)Hq * D, k_row = (size_t)Hkv * D;
  const size_t kv0 = (size_t)b * Sk * k_row + (size_t)(h / (Hq / Hkv)) * D;
  const int vpr = D * (int)sizeof(T) / 16;

  stage_rows(qs, ldq, q + ((size_t)b * Sq + q0) * q_row + (size_t)h * D,
             q_row, BQ, nq, vpr);
  for (int r = tid; r < BQ; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }
  float acc[A][kMaxC];
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) acc[a][c] = 0.f;

  // the keys that meet the band of queries [q0, q0 + nq)
  const long long p_lo = (long long)q_offset + q0;
  const long long p_hi = p_lo + nq - 1;
  const int k_lo = (int)max(0LL, p_lo - win + 1);
  const int k_hi = causal ? (int)min((long long)Sk, p_hi + 1) : Sk;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    const int nk = min(kBK, k_hi - k0);
    __syncthreads();                    // previous tile consumed
    stage_rows(ks, ldk, k + kv0 + (size_t)k0 * k_row, k_row, kBK, nk, vpr);
    stage_rows(vs, D, v + kv0 + (size_t)k0 * k_row, k_row, kBK, nk, vpr);
    __syncthreads();
    // scores: rows ty + kTY*a, keys tx + kTX*n
    float s[A][kNB];
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int n = 0; n < kNB; ++n) s[a][n] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[A], kv[kNB];
#pragma unroll
      for (int a = 0; a < A; ++a) qv[a] = qs[(ty + kTY * a) * ldq + d];
#pragma unroll
      for (int n = 0; n < kNB; ++n) kv[n] = ks[(tx + kTX * n) * ldk + d];
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int n = 0; n < kNB; ++n) s[a][n] = fmaf(qv[a], kv[n], s[a][n]);
    }
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int r = ty + kTY * a;
      const long long qp = p_lo + r;
#pragma unroll
      for (int n = 0; n < kNB; ++n) {
        const int j = tx + kTX * n;
        const long long rel = qp - (k0 + j);
        const bool ok = j < nk && rel < win && (!causal || rel >= 0);
        ss[r * lds + j] = ok ? s[a][n] * scale : kNegInf;
      }
    }
    __syncthreads();
    // online softmax: one warp per row
    for (int r = warp; r < BQ; r += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < kBK; j += 32) mx = fmaxf(mx, ss[r * lds + j]);
      mx = warp_max(mx);
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kBK; j += 32) {
        const float p = expf(ss[r * lds + j] - m_new);
        sum += p;
        ss[r * lds + j] = to_f32(from_f32<T>(p));   // p in v's dtype
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        cs[r] = c;
        ls[r] = ls[r] * c + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
    // value product: rows ty + kTY*a, columns tx + kTX*c; key slots past
    // nk hold zero values, so they are left out
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float c = cs[ty + kTY * a];
#pragma unroll
      for (int cc = 0; cc < kMaxC; ++cc) acc[a][cc] *= c;
    }
    for (int j = 0; j < nk; ++j) {
      float pv[A];
#pragma unroll
      for (int a = 0; a < A; ++a) pv[a] = ss[(ty + kTY * a) * lds + j];
#pragma unroll
      for (int cc = 0; cc < kMaxC; ++cc) {
        const int d = tx + kTX * cc;
        if (d < D) {
          const float x = vs[j * D + d];
#pragma unroll
          for (int a = 0; a < A; ++a) acc[a][cc] = fmaf(pv[a], x, acc[a][cc]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int r = ty + kTY * a;
    if (r >= nq) continue;
    const float l = fmaxf(ls[r], 1e-30f);
    T* o = out + ((size_t)b * Sq + q0 + r) * q_row + (size_t)h * D;
#pragma unroll
    for (int cc = 0; cc < kMaxC; ++cc) {
      const int d = tx + kTX * cc;
      if (d < D) o[d] = from_f32<T>(acc[a][cc] / l);
    }
  }
}

int tile_rows(int Sq) { return Sq <= 16 ? 16 : 64; }

template <typename T, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int Hq, int Hkv, int D,
                   int q_offset, int win, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(BQ, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_kernel<T, BQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_attn_kernel<T, BQ><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, Hq, Hkv, D,
      q_offset, win, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_any(const void* q, const void* k, const void* v,
                       void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                       int D, int q_offset, int win, int causal, float scale,
                       cudaStream_t stream) {
  if (tile_rows(Sq) == 16)
    return launch<T, 16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, q_offset, win,
                         causal, scale, stream);
  return launch<T, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, q_offset, win,
                       causal, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Rows of D elements must be whole
// 16-byte vectors, D <= 128, Hq a multiple of Hkv, and every pointer
// 16-byte aligned (the wrapper checks).  Returns cudaGetLastError() after
// the launch.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int B, int Sq, int Sk, int Hq,
                                 int Hkv, int D, int q_offset, int win,
                                 int causal, float scale, int dtype,
                                 void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (B <= 0 || B > 65535 || Sq <= 0 || Sk <= 0 || Hq <= 0 || Hq > 65535 ||
      Hkv <= 0 || Hq % Hkv != 0 || D <= 0 || D > kMaxD ||
      (D * elem) % 16 != 0 || q_offset < 0 || win <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_any<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D,
                                  q_offset, win, causal, scale, s);
  return (int)launch_any<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D,
                                        q_offset, win, causal, scale, s);
}

// Shared-memory bytes flash_attn_launch asks for at these sizes (the
// wrapper refuses a call above the card's per-block limit).
extern "C" long long flash_attn_smem_bytes(int Sq, int D) {
  return (long long)smem_bytes(tile_rows(Sq), D);
}
