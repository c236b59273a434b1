// Helpers shared by the flash-attention kernels (sm_90a) of
// flash_attention.cu and flash_attention_bwd.cu: which query rows and key
// blocks the mask lets through, and the float32 register tiles of the
// routes that run on the CUDA cores (a CTA of one warpgroup owning 64 rows,
// the other side streamed through shared memory in rows padded by 16
// bytes, filled with cp.async). Each source that includes this header gets
// its own copy (device code is compiled per translation unit).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "async_copy.cuh"

namespace {

constexpr int kTileThreads = 128;     // a float32 CTA: one warpgroup
constexpr int kXLd = 64 + 16;         // a row of p^T / ds^T (f32), padded

// Query row qp (of sq) sits at position qp + qo against keys 0 .. t - 1:
// qo > 0 is a query offset (a sequence shard's first row, or a q chunk's),
// and the masks compare keys with that position.
__device__ __forceinline__ bool allowed(int qp, int key, int sq, int t,
                                        int causal, int use_window,
                                        int window, int qo) {
  const int pos = qp + qo;
  return qp < sq && key < t && (!causal || key <= pos) &&
         (!use_window || key > pos - window);
}

// every (query, key) pair of the block is allowed: no mask to apply
__device__ __forceinline__ bool all_visible(int q0, int qn, int k0, int kn,
                                            int sq, int t, int causal,
                                            int use_window, int window,
                                            int qo) {
  return q0 + qn <= sq && k0 + kn <= t &&
         (!causal || k0 + kn - 1 <= q0 + qo) &&
         (!use_window || k0 > q0 + qo + qn - 1 - window);
}

// the key blocks (of kn) that query rows [q0, q0 + qn) can see: blocks
// wholly past the last row's position are never walked
__device__ __forceinline__ void key_blocks(int q0, int qn, int kn, int sq,
                                           int t, int causal, int use_window,
                                           int window, int qo, int& begin,
                                           int& end) {
  end = (t + kn - 1) / kn;
  if (causal) end = min(end, (min(q0 + qn, sq) - 1 + qo) / kn + 1);
  begin = 0;
  if (use_window) {
    const int first = q0 + qo - window + 1;  // smallest key the window reaches
    begin = first > 0 ? first / kn : 0;
  }
  if (end < begin) end = begin;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows [r0, r0 + n) of one head of a (.., rows, heads, HD) float32 array
// (`src` at the head's first element, rows `stride` floats apart) into
// shared rows of HD + 4 floats, asynchronously; rows >= limit read as zeros
template <int HD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           size_t stride, int r0, int n,
                                           int limit, int tid) {
  constexpr int kPieces = HD / 4;
  for (int i = tid; i < n * kPieces; i += kTileThreads) {
    const int r = i / kPieces, c = i % kPieces;
    const bool ok = r0 + r < limit;
    cp_async16(smem_addr(dst + r * (HD + 4) + c * 4),
               src + static_cast<size_t>(ok ? r0 + r : 0) * stride + c * 4,
               ok);
  }
}

// DPT floats of a shared row at p
template <int DPT>
__device__ __forceinline__ void ld_cols(float (&v)[DPT], const float* p) {
  if constexpr (DPT % 4 == 0) {
#pragma unroll
    for (int c = 0; c < DPT; c += 4) {
      const float4 f = ld4(p + c);
      v[c] = f.x;
      v[c + 1] = f.y;
      v[c + 2] = f.z;
      v[c + 3] = f.w;
    }
  } else if constexpr (DPT == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  } else {  // 1, or 5 at hd 80: p is 4-byte aligned only
#pragma unroll
    for (int c = 0; c < DPT; ++c) v[c] = p[c];
  }
}
template <int DPT>
__device__ __forceinline__ void st_cols(float* p, const float (&v)[DPT]) {
  if constexpr (DPT % 4 == 0) {
#pragma unroll
    for (int c = 0; c < DPT; c += 4)
      *reinterpret_cast<float4*>(p + c) =
          make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
  } else if constexpr (DPT == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {  // 1, or 5 at hd 80
#pragma unroll
    for (int c = 0; c < DPT; ++c) p[c] = v[c];
  }
}

// acc[i][c] (own row 8 kg + i, column DPT dg + c) += sum over the OT
// streamed rows r of x[r][8 kg + i] * tile[r][DPT dg + c], x's rows XLD
// floats apart, the loop over r unrolled kUnroll times (the backward's
// kernels: 1 at hd 128, for the registers, else 4)
template <int HD, int OT, int kUnroll = HD == 128 ? 1 : 4, int XLD = kXLd>
__device__ __forceinline__ void tn_product(float (&acc)[8][HD / 16],
                                           const float* x, const float* tile,
                                           int kg, int dg) {
  constexpr int LD = HD + 4, DPT = HD / 16;
#pragma unroll (kUnroll)
  for (int r = 0; r < OT; ++r) {
    const float4 x0 = ld4(x + r * XLD + 8 * kg);
    const float4 x1 = ld4(x + r * XLD + 8 * kg + 4);
    const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    float tv[DPT];
    ld_cols<DPT>(tv, tile + r * LD + DPT * dg);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(xs[i], tv[c], acc[i][c]);
  }
}

}  // namespace
