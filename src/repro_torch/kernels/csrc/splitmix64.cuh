// splitmix64 and the dropout keep test on the device, shared by the counter
// draws (counter_rng.cu) and the fused tail (fused_layer.cu), which draws
// the keep bits in its registers instead of reading a mask.
//
// fold_in(key, i) = splitmix64(splitmix64(key) ^ i); lane i of a (rows,
// cols) keep-mask (i = row * cols + col) is kept when
// (fold_in(key, i) >> 40) < threshold, threshold = ceil(float32(1 - rate)
// * 2^24) (kernels/counter_rng.py keep_threshold).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// fold_in(key, i) >> 40 for k = splitmix64(key): lane i's 24-bit uniform.
// The last step of splitmix64, x ^ (x >> 31), leaves bits 40-63 of x as
// they are, so it is left out.
__device__ __forceinline__ uint32_t keep_u24(uint64_t k, uint64_t i) {
  uint64_t x = (k ^ i) + 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return static_cast<uint32_t>(x >> 40);
}

__device__ __forceinline__ bool keep_lane(uint64_t k, uint64_t i,
                                          uint32_t threshold) {
  return keep_u24(k, i) < threshold;
}

// keep_lane of lanes i0 .. i0 + 3 (i0 % 4 == 0) as bits 0-3, on 32-bit
// halves: the four lanes share k ^ i0 but for its two low bits, and of the
// last product only the high word of its low 64 bits is formed
__device__ __forceinline__ uint32_t keep_lanes4(uint64_t k, uint64_t i0,
                                                uint32_t threshold) {
  const uint64_t kb = k ^ i0;
  uint32_t bits = 0;
#pragma unroll
  for (uint32_t e = 0; e < 4; ++e) {
    uint64_t x = (kb ^ e) + 0x9E3779B97F4A7C15ull;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
    x ^= x >> 27;
    const uint32_t lo = static_cast<uint32_t>(x);
    const uint32_t hi = static_cast<uint32_t>(x >> 32);
    const uint32_t top =
        __umulhi(lo, 0x133111EBu) + lo * 0x94D049BBu + hi * 0x133111EBu;
    bits |= static_cast<uint32_t>((top >> 8) < threshold) << e;
  }
  return bits;
}

}  // namespace repro
