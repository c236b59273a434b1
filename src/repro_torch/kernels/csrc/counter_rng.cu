// Counter-based draws of the training step for Hopper, sm_90a: the
// sampler's permutation keys and the dropout keep-mask.
//
// Not the port of a TPU kernel: the reference draws with XLA's threefry
// (jax.random.permutation in src/repro/core/sampling.py, jax.random.bernoulli
// in src/repro/core/forward.py). The port's draws are pure functions of a
// 64-bit key through splitmix64, fold_in(k, i) = mix(mix(k) ^ i), with the
// key read from device memory, so a CUDA graph that replays the step reads
// the current step's key instead of the one it was captured with.
//
//   hash_keys: out[i] = fold_in(key, i) for i < n, int64 (the bits of the
//     uint64 hash). The sampler argsorts them: fold_in(key, .) is a
//     bijection, so the keys are distinct and the permutation exact.
//   keep_mask: out[i] = (fold_in(key, i) >> 40) < threshold, one byte each
//     (torch.bool); i = row * cols + col, and the caller's threshold is
//     ceil(float32(1 - rate) * 2^24), so a lane is kept with probability
//     1 - rate rounded to 24 bits.
//
// What bounds them on the H100: bytes written. hash_keys writes 8 B an
// item (19.6 MB for the 2,449,029 vertices of the training graph, 5.8 us
// at 3.35 TB/s); keep_mask 1 B (2.1 MB at (8192, 256), 0.63 us). A hash is
// three 64-bit multiplies, which Hopper emulates with 32-bit ones: about
// 20 integer instructions an item, well under the memory's pace.
//
// Design: grid-stride loops of 256-thread CTAs, the key read once a
// thread. hash_keys stores one int64 a thread (a warp writes 256
// contiguous bytes); keep_mask packs 16 mask bytes a thread into one
// 16-byte store, and the last n % 16 bytes one a thread. Both write their
// output once and read nothing else.

#include <cuda_runtime.h>

#include <cstdint>

#include "splitmix64.cuh"

namespace {

using repro::splitmix64;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

__global__ void __launch_bounds__(kThreads) hash_keys_kernel(
    const int64_t* __restrict__ key, long long n, int64_t* __restrict__ out) {
  const uint64_t k = splitmix64(static_cast<uint64_t>(__ldg(key)));
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = static_cast<int64_t>(splitmix64(k ^ static_cast<uint64_t>(i)));
  }
}

__device__ __forceinline__ uint32_t keep_byte(uint64_t k, long long i,
                                              uint32_t threshold) {
  return repro::keep_lane(k, static_cast<uint64_t>(i), threshold) ? 1u : 0u;
}

__global__ void __launch_bounds__(kThreads) keep_mask_kernel(
    const int64_t* __restrict__ key, long long n, uint32_t threshold,
    uint8_t* __restrict__ out) {
  const uint64_t k = splitmix64(static_cast<uint64_t>(__ldg(key)));
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n16 = n / 16;
  for (long long v = tid; v < n16; v += stride) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = v * 16 + j * 4;
      w[j] = keep_byte(k, i, threshold) |
             (keep_byte(k, i + 1, threshold) << 8) |
             (keep_byte(k, i + 2, threshold) << 16) |
             (keep_byte(k, i + 3, threshold) << 24);
    }
    reinterpret_cast<uint4*>(out)[v] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (long long i = n16 * 16 + tid; i < n; i += stride) {
    out[i] = static_cast<uint8_t>(keep_byte(k, i, threshold));
  }
}

int blocks_for(long long items) {
  const long long b = (items + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

}  // namespace

// key: one int64 in device memory; out: n int64. Returns the launch's
// cudaError_t (0 on success).
extern "C" int repro_hash_keys(const void* key, long long n, void* out,
                               void* stream) {
  hash_keys_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(key), n, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// key: one int64 in device memory; out: n bytes, 16-byte aligned; lane i
// is kept when (fold_in(key, i) >> 40) < threshold (threshold <= 2^24).
// Returns the launch's cudaError_t (0 on success).
extern "C" int repro_keep_mask(const void* key, long long n, int threshold,
                               void* out, void* stream) {
  keep_mask_kernel<<<blocks_for((n + 15) / 16), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(key), n, static_cast<uint32_t>(threshold),
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
