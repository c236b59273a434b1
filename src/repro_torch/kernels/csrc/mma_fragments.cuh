// Helpers shared by the flash-attention kernels (sm_90a): the bf16
// tensor-core product mma.sync m16n8k16 with float32 accumulation,
// and the ldmatrix address patterns that load its fragments from shared
// memory tiles of rows padded to mma_stride<HD>() bf16.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): lane l holds, of a 16 x 16
// A tile, rows l/4 and l/4 + 8 at columns 2(l%4) + {0, 1} and + 8; of a
// 16 x 8 B tile, columns l/4 at rows 2(l%4) + {0, 1} and + 8; of the 16 x 8
// float32 accumulator, rows l/4 (elements 0, 1) and l/4 + 8 (2, 3) at
// columns 2(l%4) + {0, 1}. The accumulator of a 16 x 16 product, packed to
// bf16 (pack_a), is the A fragment of the next product as it stands.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"

namespace {

using bf16 = __nv_bfloat16;

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one bf16x2 register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the accumulators of two 16 x 8 n-tiles (columns 0-7 and 8-15 of a 16 x 16
// product) as the bf16 A fragment of a product whose k runs over those 16
// columns
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// shared-memory row of HD bf16, padded by 16 bytes: ldmatrix's 8 rows land
// on 8 distinct 16-byte bank groups for every HD in {16, 32, 64, 128}
template <int HD>
__host__ __device__ constexpr int mma_stride() {
  return HD + 8;
}

// A fragment of the 16 x 16 tile at `tile` (row-major, row stride s)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int s, int lane) {
  ldmatrix_x4(a, smem_addr(tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * s +
                           (lane >> 4) * 8));
}

// B fragments of two n-tiles from the 16 x 16 tile at `tile` stored with n
// along its rows and k along each row (B = tile^T): b[0], b[1] for rows
// 0-7, b[2], b[3] for rows 8-15
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile,
                                       int s, int lane) {
  ldmatrix_x4(b, smem_addr(tile + ((lane & 7) + (lane >> 4) * 8) * s +
                           ((lane >> 3) & 1) * 8));
}

// B fragments of two n-tiles from the 16 x 16 tile at `tile` stored with k
// along its rows and n along each row (B = tile): b[0], b[1] for columns
// 0-7, b[2], b[3] for columns 8-15
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                             const bf16* tile, int s,
                                             int lane) {
  ldmatrix_x4_trans(b, smem_addr(tile +
                                 ((lane & 7) + ((lane >> 3) & 1) * 8) * s +
                                 (lane >> 4) * 8));
}

// 2^x on the special-function unit (2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
