// Block-ELL SpMM for Hopper, sm_90a: the paper's aggregation A @ H (Eq. 5)
// over a mini-batch adjacency stored as block-ELL.
//
// Replaces the TPU kernel `_spmm_ell_kernel` of src/repro/kernels/spmm_ell.py
// (its pallas_call is `spmm_ell_pallas`):
//
//   out[i*bm : (i+1)*bm] = sum_s tiles[i, s] @ x[colidx[i, s]*bn : +bn]
//
// accumulated in float32, with tiles (n_rb, S, bm, bn), colidx (n_rb, S)
// int32 and x (n_cb*bn, d); the output (n_rb*bm, d) has x's type. Padding
// slots are all-zero tiles at column-block 0 and are computed like any other
// slot, as the TPU kernel computes them. A column-block index outside
// [0, n_cb) is clamped, as the reference's dynamic slice clamps it.
//
// What bounds it on the H100: operations. At the training shape (n_rb = 64,
// bm = bn = 128, d = 256, S = 32) a call does 2*64*32*128*128*256 = 17.2
// GFLOP, 0.26 ms at 67 TFLOP/s on the float32 CUDA cores, against 134 MB of
// tiles, 0.04 ms at 3.35 TB/s.
//
// Design: the TPU kernel keeps all of x resident in VMEM and walks the slots
// in a sequential fori_loop per (row-block, feature-tile) grid cell; 227 KB
// of shared memory cannot hold x here. Instead one CTA computes a 64 x 64
// output tile (64 rows of one row-block, 64 features) and walks the S slots
// in order. Each slot's (bm, bn) tile and the matching (bn, 64) slice of x
// are staged through shared memory in chunks of 16 along bn (converted to
// float32 on the way in, through the intrinsics for bf16); each of the 256
// threads accumulates a 4 x 4 micro-tile in float32 registers with FMAs.
// Any bm and bn (the reference sweeps 8, 16, 32 and 128) and a ragged d are
// masked at the edges. No wgmma or TMA yet: this is the simple, right
// version; the tensor-core design is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTM = 64;        // output rows per CTA (within one row-block)
constexpr int kTN = 64;        // output features per CTA
constexpr int kTK = 16;        // depth of one staged chunk along bn
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) spmm_ell_kernel(
    const T* __restrict__ tiles, const int* __restrict__ colidx,
    const T* __restrict__ x, T* __restrict__ out, int n_slots, int bm,
    int bn, int n_cb, int d, int row_tiles) {
  // the tile chunk k-major, one float of padding per row against bank
  // conflicts on the transposing store
  __shared__ float s_a[kTK][kTM + 1];
  __shared__ float s_x[kTK][kTN];

  const int i = blockIdx.x / row_tiles;             // row-block
  const int r0 = (blockIdx.x % row_tiles) * kTM;    // first row in it
  const int j0 = blockIdx.y * kTN;                  // first feature
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.0f;

  for (int s = 0; s < n_slots; ++s) {
    int c = colidx[static_cast<size_t>(i) * n_slots + s];
    c = min(max(c, 0), n_cb - 1);
    const T* a = tiles + (static_cast<size_t>(i) * n_slots + s) * bm * bn;
    const T* xb = x + static_cast<size_t>(c) * bn * d;
    for (int k0 = 0; k0 < bn; k0 += kTK) {
      for (int e = threadIdx.x; e < kTM * kTK; e += kThreads) {
        const int r = e / kTK, k = e % kTK;
        const int rr = r0 + r, kk = k0 + k;
        s_a[k][r] = (rr < bm && kk < bn)
                        ? to_f32(a[static_cast<size_t>(rr) * bn + kk])
                        : 0.0f;
      }
      for (int e = threadIdx.x; e < kTK * kTN; e += kThreads) {
        const int k = e / kTN, n = e % kTN;
        const int kk = k0 + k, jj = j0 + n;
        s_x[k][n] = (kk < bn && jj < d)
                        ? to_f32(xb[static_cast<size_t>(kk) * d + jj])
                        : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kTK; ++k) {
        float av[4], xv[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) av[m] = s_a[k][ty + 16 * m];
#pragma unroll
        for (int n = 0; n < 4; ++n) xv[n] = s_x[k][tx + 16 * n];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(av[m], xv[n], acc[m][n]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int rr = r0 + ty + 16 * m;
    if (rr >= bm) continue;
    T* orow = out + (static_cast<size_t>(i) * bm + rr) * d;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int jj = j0 + tx + 16 * n;
      if (jj < d) store(orow + jj, acc[m][n]);
    }
  }
}

template <typename T>
int launch(const void* tiles, const void* colidx, const void* x, void* out,
           int n_rb, int n_slots, int bm, int bn, int n_cb, int d,
           cudaStream_t stream) {
  const int row_tiles = (bm + kTM - 1) / kTM;
  const dim3 grid(n_rb * row_tiles, (d + kTN - 1) / kTN);
  spmm_ell_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(tiles), static_cast<const int*>(colidx),
      static_cast<const T*>(x), static_cast<T*>(out), n_slots, bm, bn, n_cb,
      d, row_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tiles (n_rb, n_slots, bm, bn), x (n_cb * bn, d) and out (n_rb * bm, d) are
// all float32 (bf16 == 0) or all bfloat16 (bf16 == 1); colidx is (n_rb,
// n_slots) int32. Returns the launch's cudaError_t (0 on success).
extern "C" int repro_spmm_ell(const void* tiles, const void* colidx,
                              const void* x, void* out, int n_rb,
                              int n_slots, int bm, int bn, int n_cb, int d,
                              int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(tiles, colidx, x, out, n_rb, n_slots, bm,
                                 bn, n_cb, d, st);
  }
  return launch<float>(tiles, colidx, x, out, n_rb, n_slots, bm, bn, n_cb, d,
                       st);
}
