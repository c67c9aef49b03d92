// Comparator SNG + LSB-first bit packing for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sng_pack.py::sng_pack_pallas
// (_sng_pack_kernel).  Bit t of output word w of a level is
// (codes[32*w + t] < level); for streams shorter than 32 bits (N = 4, 8, 16)
// the one word holds N valid low bits and zeros above them, which add
// nothing to a later AND + popcount.
//
// Bound on the H100: memory.  Per level it reads 4 bytes and writes N/8
// bytes (one 32-bit word per 32 stream bits), and does N integer compares.
// Design: one thread per output word, so consecutive threads write
// consecutive words (coalesced stores); the N <= 256 codes are staged once
// per block in shared memory, read without bank conflicts (threads on the
// same word read the same code, a broadcast; threads on different words read
// different banks).  No scratch, no allocation; launched on the caller's
// stream.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLength = 256;
constexpr int kThreads = 256;

__global__ void sng_pack_kernel(const int32_t* __restrict__ levels,
                                const int32_t* __restrict__ codes,
                                uint32_t* __restrict__ out,
                                int n_words_total, int length, int nw) {
  __shared__ int32_t codes_s[kMaxLength];
  for (int i = threadIdx.x; i < length; i += blockDim.x) codes_s[i] = codes[i];
  __syncthreads();
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_words_total) return;
  const int level = levels[idx / nw];
  const int wi = idx % nw;
  const int base = wi * 32;
  const int nbits = min(32, length - base);
  uint32_t word = 0u;
  // Threads of a warp building different words of a level would read
  // codes_s[wi*32 + t], all in one bank; starting word wi at bit wi instead
  // puts them in distinct banks.  (nw > 1 means nbits == 32; for nw == 1,
  // wi == 0 and the order is plain.)
  for (int i = 0; i < nbits; ++i) {
    const int t = (i + wi) & 31;
    word |= (uint32_t)(codes_s[base + t] < level) << t;
  }
  out[idx] = word;
}

}  // namespace

// levels: (n_levels,) int32; codes: (length,) int32; out: (n_levels, nw)
// 32-bit words with nw = ceil(length / 32).  Returns cudaGetLastError().
extern "C" int sng_pack_launch(const void* levels, const void* codes, void* out,
                               int n_levels, int length, void* stream) {
  const int nw = (length + 31) / 32;
  if (n_levels <= 0 || length < 1 || length > kMaxLength ||
      (long long)n_levels * nw > 0x7fffffff - kThreads)
    return (int)cudaErrorInvalidValue;
  const int total = n_levels * nw;
  const int blocks = (total + kThreads - 1) / kThreads;
  sng_pack_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)levels, (const int32_t*)codes, (uint32_t*)out, total,
      length, nw);
  return (int)cudaGetLastError();
}
