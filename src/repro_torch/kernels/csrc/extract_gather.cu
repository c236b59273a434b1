// Fused Alg.-2 extraction (phases 2-4) for Hopper, sm_90a.
//
// Replaces the TPU kernel `_extract_kernel` of
// src/repro/kernels/extract_gather.py (its pallas_call is
// `extract_dense_fused`): for each sampled row, walk its CSR edges (at most
// max_deg of them), keep the edges whose column is one of the sorted,
// distinct sampled columns, rescale per column (self-loops exempt on a
// diagonal block, Eq. 24) and write the dense (b_r, b_c) row once.
//
// What bounds it on the H100: the bytes it writes. The block is dense and
// almost all zeros: at the training shape (8192 x 8192) it writes 268 MB
// and places about one value a row, while the edges it walks are about
// 3 MB. So the kernel is a zero-fill at the card's write rate with a few
// scattered values; at the serving shape (256 x 256) the launch and a chain
// of dependent loads dominate.
//
// Design: a CTA of 8 warps owns `rows_per_cta` consecutive rows (a power
// of two, 4 to 16), so its part of the block is one contiguous range. The
// CTA stages the sorted sampled columns (and per-column scales) in shared
// memory once, where they fit in the default 48 KB, with cp.async copies
// that fly while it zero-fills; otherwise it binary-searches them in global
// memory through the read-only path, so any b_c launches. Before the
// zero-fill each thread also loads its first rows' extents and first two
// edges, so their latency hides behind the stores. Its threads zero-fill
// the range with 16-byte stores (a scalar head and tail where the range is
// not 16-byte aligned), like a fill kernel. After a CTA barrier, which
// orders those stores before the values, the threads split into
// min(rows_per_cta, 8) groups, each taking a row at a time: a thread
// binary-searches its edges' columns among the sorted columns and adds
// `val * lane_scale` into the zeroed cell with a global atomicAdd. The
// Pallas kernel compared every edge with all b_c lanes in one vector
// compare, which suits the TPU's wide VPU; here each edge costs log2(b_c)
// reads of the staged columns instead of b_c compares.
//
// Measured on the H100 at the training shape behind a 256 MB write, these
// were slower: a warp a row over a grid-stride loop, the same stores with a
// streaming hint (st.global.cs), a rotated start per CTA, and a zero-fill
// split around the edge loads (PERF.md).
//
// Arithmetic: the reference computes `acc * lane_scale` with acc the sum of
// the cell's edge values. On a graph without duplicate edges every cell
// receives at most one value v, and 0 + v * s is bit-identical to the
// reference's (0 + v) * s. With duplicate edges a cell gets the sum of
// v_i * s in the order the atomics land, which differs from (sum v_i) * s
// by rounding only (within 1e-6 of the largest |output|, tested).
//
// The bf16 route (the reference's `dtype=bfloat16`, the training step's
// `block_dtype="bf16"`): the same kernel, templated on the output type,
// writes a bfloat16 block, half the bytes of the float32 one that bounds
// it. Each value is v * s in float32, rounded once to nearest even and
// added into the zeroed bf16 cell with the native bf16 atomicAdd; where a
// cell receives one value that is exactly the reference's cast of
// (0 + v) * s, bit for bit. With duplicate edges every add rounds, so the
// cell is within a bf16 ulp or so of the largest output (tested). There is
// no float32 scratch block and no convert pass: that would write the bytes
// this route exists to save.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// the staged scales start 16-byte aligned after the b_c columns
__host__ __device__ __forceinline__ int scale_offset(int b_c) {
  return (b_c + 3) & ~3;
}

// n values from global to shared memory: 16-byte asynchronous copies
// (cp.async, committed as one group, waited for by the caller) where g is
// 16-byte aligned, plain loads for the rest
template <typename T>
__device__ __forceinline__ void stage_async(T* __restrict__ s,
                                            const T* __restrict__ g, int n) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int n4 = n >> 2;
    for (int j = threadIdx.x; j < n4; j += kThreads) {
      cp_async16(smem_addr(s + 4 * j), g + 4 * j, true);
    }
    done = n4 << 2;
  }
  cp_async_commit();
  for (int j = done + threadIdx.x; j < n; j += kThreads) s[j] = __ldg(g + j);
}

using bf16 = __nv_bfloat16;

// a zero, and v (computed in float32) added into a zeroed output cell: a
// float32 add, or v rounded once to bf16 and a bf16 add
template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ bf16 zero_value<bf16>() {
  return __float2bfloat16(0.0f);
}
__device__ __forceinline__ void add_value(float* p, float v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void add_value(bf16* p, float v) {
  atomicAdd(p, __float2bfloat16(v));
}

// n zeros of T at p (sizeof(T)-aligned) by the whole CTA: a scalar head up
// to 16-byte alignment, 16-byte stores, a scalar tail
template <typename T>
__device__ __forceinline__ void zero_fill(T* __restrict__ p, size_t n) {
  constexpr size_t kPer16 = 16 / sizeof(T);
  const size_t to_align =
      ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(T);
  const size_t head = to_align < n ? to_align : n;
  const T zero = zero_value<T>();
  if (threadIdx.x < head) p[threadIdx.x] = zero;
  const size_t n16 = (n - head) / kPer16;
  uint4* body = reinterpret_cast<uint4*>(p + head);
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 8
  for (size_t j = threadIdx.x; j < n16; j += kThreads) body[j] = z;
  const size_t tail = head + n16 * kPer16;
  // at most kPer16 - 1 (< kThreads) elements remain
  if (tail + threadIdx.x < n) p[tail + threadIdx.x] = zero;
}

// first position in cols[0, n) whose column is >= c
template <bool kStaged>
__device__ __forceinline__ int lower_bound(const int* __restrict__ cols,
                                           int n, int c) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int v = kStaged ? cols[mid] : __ldg(cols + mid);
    if (v < c) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// one row's extent and the two edges a thread takes first, at e = t and
// t + gsize of the row's first cnt edges (column -1 where there is none)
struct RowEdges {
  int row = 0, first = 0, cnt = 0;
  int c[2] = {-1, -1};
  float v[2] = {0.0f, 0.0f};
};

__device__ __forceinline__ void load_extent(RowEdges& re, const int* rp,
                                            const int* rows, int r,
                                            int max_deg) {
  re.row = __ldg(rows + r);
  re.first = __ldg(rp + re.row);
  re.cnt = min(__ldg(rp + re.row + 1) - re.first, max_deg);
}

__device__ __forceinline__ void load_edges(RowEdges& re, const int* ci,
                                           const float* val, int e0, int t,
                                           int gsize) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = e0 + t + gsize * h;
    re.c[h] = e < re.cnt ? __ldg(ci + re.first + e) : -1;
    re.v[h] = e < re.cnt ? __ldg(val + re.first + e) : 0.0f;
  }
}

// the values of a row's loaded edges into its zeroed output row
template <bool kStaged, typename TO>
struct Placer {
  const int* cols;           // staged or global, sorted
  const float* scale;        // staged or global; null: scalar for all
  float scalar;
  int b_c, diag;

  __device__ __forceinline__ void operator()(const RowEdges& re,
                                             TO* orow) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = re.c[h];
      if (c < 0) continue;
      const int pos = lower_bound<kStaged>(cols, b_c, c);
      if (pos < b_c && cols[pos] == c) {
        const float s = (diag && c == re.row)
                            ? 1.0f
                            : (scale != nullptr ? scale[pos] : scalar);
        add_value(orow + pos, re.v[h] * s);
      }
    }
  }
};

template <bool kStaged, typename TO>
__global__ void __launch_bounds__(kThreads) extract_dense_kernel(
    const int* __restrict__ rp, const int* __restrict__ ci,
    const float* __restrict__ val, const int* __restrict__ rows,
    const int* __restrict__ cols, const float* __restrict__ col_scale,
    float scalar_scale, int diag, int b_r, int b_c, int max_deg,
    int rows_per_cta, TO* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  const int lo = blockIdx.x * rows_per_cta;
  const int hi = min(lo + rows_per_cta, b_r);
  // the CTA's threads form `groups` groups (up to 8), each placing the
  // edges of every groups-th row, two a thread at a time: with at most 16
  // rows a CTA (checked by the entry point) a group has one or two rows
  const int groups = min(rows_per_cta, kWarps);
  const int gsize = kThreads / groups;
  const int g = threadIdx.x / gsize, t = threadIdx.x % gsize;

  // a group's two rows: extents and first edges loaded before the
  // zero-fill, so their latency hides behind it
  RowEdges a, b;
  const int ra = lo + g, rb = ra + groups;
  if (ra < hi) load_extent(a, rp, rows, ra, max_deg);
  if (rb < hi) load_extent(b, rp, rows, rb, max_deg);

  Placer<kStaged, TO> place{cols, col_scale, scalar_scale, b_c, diag};
  if (kStaged) {           // copies in flight during the zero-fill
    stage_async(smem, cols, b_c);
    place.cols = smem;
    if (col_scale != nullptr) {
      float* staged = reinterpret_cast<float*>(smem + scale_offset(b_c));
      stage_async(staged, col_scale, b_c);
      place.scale = staged;
    }
  }
  load_edges(a, ci, val, 0, t, gsize);
  load_edges(b, ci, val, 0, t, gsize);
  zero_fill(out + static_cast<size_t>(lo) * b_c,
            static_cast<size_t>(hi - lo) * b_c);
  if (kStaged) cp_async_wait<0>();
  __syncthreads();        // the staged columns, and the zeros before values

  for (int k = 0; k < 2 && ra + k * groups < hi; ++k) {
    RowEdges re = k == 0 ? a : b;
    TO* orow = out + static_cast<size_t>(ra + k * groups) * b_c;
    for (int e0 = 0; e0 < re.cnt; e0 += 2 * gsize) {
      if (e0 > 0) load_edges(re, ci, val, e0, t, gsize);
      place(re, orow);
    }
  }
}

template <typename TO>
int launch(const void* rp, const void* ci, const void* val, const void* rows,
           const void* cols, const void* col_scale, float scalar_scale,
           int diag, int b_r, int b_c, int max_deg, int grid,
           int rows_per_cta, int staged, void* out, cudaStream_t st) {
  const auto kernel = staged ? extract_dense_kernel<true, TO>
                             : extract_dense_kernel<false, TO>;
  const size_t smem =
      !staged ? 0
      : col_scale != nullptr
          ? static_cast<size_t>(scale_offset(b_c) + b_c) * sizeof(int)
          : static_cast<size_t>(b_c) * sizeof(int);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const int*>(rp), static_cast<const int*>(ci),
      static_cast<const float*>(val), static_cast<const int*>(rows),
      static_cast<const int*>(cols), static_cast<const float*>(col_scale),
      scalar_scale, diag, b_r, b_c, max_deg, rows_per_cta,
      static_cast<TO*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// col_scale is a (b_c,) float32 vector or null, in which case every column
// takes scalar_scale. `grid` CTAs of 8 warps take `rows_per_cta` (1 to 16)
// consecutive rows each and must cover the b_r rows; `staged` stages the
// columns (and col_scale, from a 16-byte boundary) in shared memory, at
// most 48 KB in all, else they are read from global memory. The block `out`
// is float32 (bf16_out == 0) or bfloat16 (bf16_out == 1). Returns the
// launch's cudaError_t: 0 on success, 1 (cudaErrorInvalidValue), without a
// launch, for rows_per_cta outside 1-16 or a grid that leaves rows out.
extern "C" int repro_extract_dense_fused(
    const void* rp, const void* ci, const void* val, const void* rows,
    const void* cols, const void* col_scale, float scalar_scale, int diag,
    int b_r, int b_c, int max_deg, int grid, int rows_per_cta, int staged,
    int bf16_out, void* out, void* stream) {
  if (rows_per_cta < 1 || rows_per_cta > 16 ||
      static_cast<long long>(grid) * rows_per_cta < b_r) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_out
             ? launch<bf16>(rp, ci, val, rows, cols, col_scale, scalar_scale,
                            diag, b_r, b_c, max_deg, grid, rows_per_cta,
                            staged, out, st)
             : launch<float>(rp, ci, val, rows, cols, col_scale,
                             scalar_scale, diag, b_r, b_c, max_deg, grid,
                             rows_per_cta, staged, out, st);
}
