// Fused Alg.-2 extraction (phases 2-4) for Hopper, sm_90a.
//
// Replaces the TPU kernel `_extract_kernel` of
// src/repro/kernels/extract_gather.py (its pallas_call is
// `extract_dense_fused`): for each sampled row, walk its CSR edges (at most
// max_deg of them), keep the edges whose column is one of the sorted,
// distinct sampled columns, rescale per column (self-loops exempt on a
// diagonal block, Eq. 24) and write the dense (b_r, b_c) row once.
//
// What bounds it on the H100: bytes, and at serving shapes the launch. A
// call reads each sampled row's two row pointers, the edges it walks (8 B
// each), the sampled columns and their scales, and writes the b_r x b_c
// float32 block. At the serving shape (256 x 256, max_deg 52) that is about
// 0.3 MB, a tenth of a microsecond at 3.35 TB/s, so the launch dominates.
//
// Design: one CTA per sampled row. The CTA stages the b_c sampled columns in
// shared memory and zeroes a b_c-float row accumulator beside them (8 B per
// column: 2 KB at b_c = 256). Its threads stride over the row's edges,
// binary-search each edge's column among the staged columns and, on a hit,
// add the edge value into the accumulator with a shared-memory atomicAdd.
// After a barrier the row is multiplied by its lane scale and stored with
// coalesced writes. The Pallas kernel compared every edge with all b_c lanes
// in one vector compare, which suits the TPU's wide VPU; here each edge
// costs log2(b_c) shared-memory reads instead of b_c compares.
//
// The arithmetic is the Pallas kernel's `acc * lane_scale`. On a graph
// without duplicate edges every cell receives at most one value, so the
// block is bit-identical to the reference `extract_dense_block` whatever
// order the atomics land in.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

__global__ void extract_dense_kernel(
    const int* __restrict__ rp, const int* __restrict__ ci,
    const float* __restrict__ val, const int* __restrict__ rows,
    const int* __restrict__ cols, const float* __restrict__ col_scale,
    float scalar_scale, int diag, int b_c, int max_deg,
    float* __restrict__ out) {
  extern __shared__ int smem[];
  int* s_cols = smem;
  float* s_acc = reinterpret_cast<float*>(smem + b_c);

  const int r = blockIdx.x;
  const int row = rows[r];
  for (int j = threadIdx.x; j < b_c; j += blockDim.x) {
    s_cols[j] = cols[j];
    s_acc[j] = 0.0f;
  }
  __syncthreads();

  const int start = rp[row];
  const int cnt = min(rp[row + 1] - start, max_deg);
  for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
    const int c = ci[start + e];
    int lo = 0, hi = b_c;                       // lower bound of c
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_cols[mid] < c) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo < b_c && s_cols[lo] == c) atomicAdd(&s_acc[lo], val[start + e]);
  }
  __syncthreads();

  float* orow = out + static_cast<size_t>(r) * b_c;
  for (int j = threadIdx.x; j < b_c; j += blockDim.x) {
    const float s = (diag && s_cols[j] == row)
                        ? 1.0f
                        : (col_scale != nullptr ? col_scale[j] : scalar_scale);
    orow[j] = s_acc[j] * s;
  }
}

}  // namespace

// col_scale is a (b_c,) float32 vector or null, in which case every column
// takes scalar_scale. Returns the launch's cudaError_t (0 on success).
extern "C" int repro_extract_dense_fused(
    const void* rp, const void* ci, const void* val, const void* rows,
    const void* cols, const void* col_scale, float scalar_scale, int diag,
    int b_r, int b_c, int max_deg, void* out, void* stream) {
  const size_t smem = static_cast<size_t>(b_c) * (sizeof(int) + sizeof(float));
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        extract_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  extract_dense_kernel<<<b_r, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rp), static_cast<const int*>(ci),
      static_cast<const float*>(val), static_cast<const int*>(rows),
      static_cast<const int*>(cols), static_cast<const float*>(col_scale),
      scalar_scale, diag, b_c, max_deg, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
