// Block-ELL SpMM for Hopper, sm_90a: the paper's aggregation A @ H (Eq. 5)
// over a mini-batch adjacency stored as block-ELL.
//
// Replaces the TPU kernel `_spmm_ell_kernel` of src/repro/kernels/spmm_ell.py
// (its pallas_call is `spmm_ell_pallas`):
//
//   out[i*bm : (i+1)*bm] = sum_s tiles[i, s] @ x[colidx[i, s]*bn : +bn]
//
// accumulated in float32, with tiles (n_rb, S, bm, bn), colidx (n_rb, S)
// int32 and x (n_cb*bn, d); the output (n_rb*bm, d) has x's type. A
// column-block index outside [0, n_cb) is clamped, as the reference's
// dynamic slice clamps it.
//
// Padding. A padding slot is an all-zero tile at column-block 0, and in the
// top-k layout it can stand in any slot (a live tile of column-block 0 can
// stand in a slot other than 0), so padding is found from the tile itself,
// never from colidx: the kernel skips every chunk of a tile (32 rows x 32
// columns) that is all zero -- the x chunk under it is not loaded and its
// product not computed. For finite x that is the function the TPU kernel
// computes; a non-finite x under an all-zero chunk no longer turns the
// output to NaN, as 0 * inf would.
//
// What bounds it on the H100. At the training shape (n_rb = 64, bm = bn =
// 128, d = 256, S = 32, 506 of the 2,048 slots live) all tiles are read
// once, padding included, to find it: 134 MB, 0.040 ms at 3.35 TB/s. The
// live tiles need 2*506*128*128*256 = 4.24 GFLOP, 0.063 ms at 67 TFLOP/s
// on the float32 CUDA cores (every slot would be 17.2 GFLOP), but most of
// their 32 x 32 chunks are empty in a sampled adjacency, so the products
// of the nonzeros are few and the bytes bound it. No route uses TF32,
// which keeps about three decimal digits: the training path is held to
// 1e-4.
//
// Design: the TPU kernel keeps all of x resident in VMEM and walks the slots
// in a sequential fori_loop per (row-block, feature-tile) grid cell; 227 KB
// of shared memory cannot hold x here. One CTA of 128 threads owns 32 rows
// of one row-block and 256 features, so that every tile byte is read by one
// CTA only; each warp owns 8 rows and each lane an 8 x 8 micro-tile of
// float32 FMAs (rows read as shared-memory broadcasts). The CTA works in
// two passes over its strip of the row-block's slots. The scan reads the
// strip with 16 loads of 16 bytes in flight a thread and sets a bit in a
// shared-memory mask for every chunk that holds a nonzero (a warp's 32
// lanes read one chunk, so one vote and one shared atomicOr mark it): it
// runs at the memory's rate whatever the padding. The product then walks
// the live chunks only, the tile chunk and its x chunk (32 x 256) double-
// buffered with cp.async (16 bytes a thread). Any bm and bn (the reference
// sweeps 8, 16, 32 and 128) and a ragged d are masked at the edges; when
// bn or d is not a multiple of 16 bytes, or a pointer is not 16-byte
// aligned, both passes use plain loads. bfloat16 tiles and x are staged as
// they are and converted on their way into the FMAs.
//
// Routes. The kernel is templated on the tile type and the operand type
// (x and out) apart: all float32, all bfloat16, and bfloat16 tiles with a
// float32 x and output -- the reference's `block_dtype="bf16"` training
// step, where `jnp.dot(tile, x, preferred_element_type=float32)` promotes
// the bf16 tile and the output keeps x's type. On that route the scan reads
// 2-byte tiles (half the bytes that bound it: 67 MB at the training shape),
// each tile element is converted to float32 in registers, and the products
// stay float32 FMAs (no TF32), so it is held to the f32 route's 1e-4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTM = 32;         // output rows per CTA (within one row-block)
constexpr int kTN = 256;        // output features per CTA
constexpr int kTK = 32;         // columns of a tile chunk
constexpr int kThreads = 128;   // 4 warps of 8 rows; a lane owns 8 features
constexpr int kMaskWords = 128;  // the live-chunk mask: 4096 chunks a pass
constexpr int kScanBatch = 16;   // 16-byte loads in flight a thread (scan)

// elements in a 16-byte piece
template <typename T>
__host__ __device__ constexpr int vec() {
  return 16 / sizeof(T);
}
// a staged tile row, padded by 16 bytes
template <typename T>
__host__ __device__ constexpr int a_stride() {
  return kTK + vec<T>();
}
// the mask, then the tile chunks (TA) and the x chunks (TX), double-buffered
template <typename TA, typename TX>
__host__ __device__ constexpr size_t smem_bytes() {
  return kMaskWords * sizeof(uint32_t) +
         2 * static_cast<size_t>(kTM) * a_stride<TA>() * sizeof(TA) +
         2 * static_cast<size_t>(kTK) * kTN * sizeof(TX);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// four consecutive staged elements as floats
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// one 16-byte piece: cp.async when kVec, else element by element (masked)
template <typename T, bool kVec>
__device__ __forceinline__ void stage_piece(T* dst, const T* src, int valid) {
  constexpr int V = vec<T>();
  if (kVec) {
    cp_async16(smem_addr(dst), src, valid == V);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (e < valid) {
        dst[e] = src[e];
      } else {
        store(dst + e, 0.0f);
      }
    }
  }
}

// does a 16-byte piece hold a nonzero? (-0 counts as zero, NaN does not)
template <typename T>
__device__ __forceinline__ bool nonzero16(const uint4& u) {
  constexpr uint32_t kMagnitude = sizeof(T) == 4 ? 0x7fffffffu : 0x7fff7fffu;
  return ((u.x | u.y | u.z | u.w) & kMagnitude) != 0;
}

// tiles of type TA; x and out of type TX
template <typename TA, typename TX, bool kVec>
__global__ void __launch_bounds__(kThreads) spmm_ell_kernel(
    const TA* __restrict__ tiles, const int* __restrict__ colidx,
    const TX* __restrict__ x, TX* __restrict__ out, int n_slots, int bm,
    int bn, int n_cb, int d, int row_tiles) {
  constexpr int V = vec<TA>();                     // a tile piece
  constexpr int VX = vec<TX>();                    // an x piece
  constexpr int AS = a_stride<TA>();
  constexpr int kRowPieces = kTK / V;              // pieces in a chunk row
  constexpr int kChunkPieces = kTM * kRowPieces;   // pieces in a chunk
  constexpr int kAPieces = kChunkPieces / kThreads;  // a thread's share
  constexpr int kXPieces = kTK * kTN / VX / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem_raw);  // [kMaskWords]
  TA* s_a = reinterpret_cast<TA*>(mask + kMaskWords);       // [2][kTM][AS]
  TX* s_x = reinterpret_cast<TX*>(s_a + 2 * kTM * AS);      // [2][kTK][kTN]

  const int i = blockIdx.x / row_tiles;           // row-block
  const int r0 = (blockIdx.x % row_tiles) * kTM;  // first row in it
  const int j0 = blockIdx.y * kTN;                // first feature
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // rows warp * 8 + {0..7}
  const int k_chunks = (bn + kTK - 1) / kTK;
  const int n_chunks = n_slots * k_chunks;
  const TA* tiles_i = tiles + static_cast<size_t>(i) * n_slots * bm * bn;

  // piece q of chunk c: its row in the strip, its first column in the tile
  // and its address (slot c / k_chunks, columns from (c % k_chunks) * kTK)
  auto a_piece = [&](int c, int q, int& r, int& col) {
    r = q / kRowPieces;
    col = (c % k_chunks) * kTK + (q % kRowPieces) * V;
    return tiles_i + static_cast<size_t>(c / k_chunks) * bm * bn +
           static_cast<size_t>(r0 + r) * bn + col;
  };
  // tile chunk c and the x chunk under it into buffer buf
  auto stage = [&](int c, int buf) {
#pragma unroll
    for (int p = 0; p < kAPieces; ++p) {
      int r, col;
      const TA* src = a_piece(c, tid + p * kThreads, r, col);
      const bool in = r0 + r < bm && col < bn;
      stage_piece<TA, kVec>(s_a + (buf * kTM + r) * AS + (col % kTK),
                            in ? src : tiles, in ? min(V, bn - col) : 0);
    }
    int cb = colidx[static_cast<size_t>(i) * n_slots + c / k_chunks];
    cb = min(max(cb, 0), n_cb - 1);
    const int k0 = (c % k_chunks) * kTK;
    const TX* xb = x + (static_cast<size_t>(cb) * bn + k0) * d + j0;
#pragma unroll
    for (int p = 0; p < kXPieces; ++p) {
      const int e = tid + p * kThreads;
      const int k = e / (kTN / VX), n = (e % (kTN / VX)) * VX;
      const bool in = k0 + k < bn && j0 + n < d;
      stage_piece<TX, kVec>(s_x + (buf * kTK + k) * kTN + n,
                            in ? xb + static_cast<size_t>(k) * d + n : x,
                            in ? min(VX, d - j0 - n) : 0);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0.0f;

  for (int c0 = 0; c0 < n_chunks; c0 += 32 * kMaskWords) {
    const int n_win = min(n_chunks - c0, 32 * kMaskWords);
    for (int w = tid; w < kMaskWords; w += kThreads) mask[w] = 0;
    __syncthreads();

    // pass 1: mark the chunks of the window that hold a nonzero; a warp's
    // 32 consecutive items are pieces of one chunk
    const int n_items = n_win * kChunkPieces;
    for (int base = 0; base < n_items; base += kThreads * kScanBatch) {
      bool nz[kScanBatch];
      if (kVec) {
        uint4 raw[kScanBatch];
#pragma unroll
        for (int j = 0; j < kScanBatch; ++j) {
          const int e = base + tid + j * kThreads;
          int r, col;
          const TA* src = a_piece(c0 + e / kChunkPieces, e % kChunkPieces,
                                  r, col);
          raw[j] = e < n_items && r0 + r < bm && col < bn
                       ? __ldg(reinterpret_cast<const uint4*>(src))
                       : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int j = 0; j < kScanBatch; ++j) nz[j] = nonzero16<TA>(raw[j]);
      } else {
#pragma unroll
        for (int j = 0; j < kScanBatch; ++j) {
          const int e = base + tid + j * kThreads;
          int r, col;
          const TA* src = a_piece(c0 + e / kChunkPieces, e % kChunkPieces,
                                  r, col);
          nz[j] = false;
          if (e < n_items && r0 + r < bm)
            for (int v = 0; v < V && col + v < bn; ++v)
              nz[j] |= to_f32(src[v]) != 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < kScanBatch; ++j) {
        const int c = (base + tid + j * kThreads) / kChunkPieces;
        if (__any_sync(0xffffffffu, nz[j]) && lane == 0)
          atomicOr(&mask[c >> 5], 1u << (c & 31));
      }
    }
    __syncthreads();

    // pass 2: the live chunks, double-buffered
    auto next_live = [&](int c) {  // the first live chunk >= c, or n_win
      while (c < n_win) {
        const uint32_t word = mask[c >> 5] >> (c & 31);
        if (word) return c + __ffs(word) - 1;
        c = (c | 31) + 1;
      }
      return n_win;
    };
    int cur = next_live(0), buf = 0;
    if (cur < n_win) stage(c0 + cur, 0);
    cp_async_commit();
    while (cur < n_win) {
      const int nxt = next_live(cur + 1);
      if (nxt < n_win) stage(c0 + nxt, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // chunk cur has landed
      __syncthreads();
      const TA* a = s_a + buf * kTM * AS;
      const TX* xs = s_x + buf * kTK * kTN;
#pragma unroll
      for (int k = 0; k < kTK; k += 4) {
        float av[8][4];
#pragma unroll
        for (int m = 0; m < 8; ++m) load4(a + (warp * 8 + m) * AS + k, av[m]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float xl[4], xh[4];
          load4(xs + (k + u) * kTN + lane * 4, xl);
          load4(xs + (k + u) * kTN + kTN / 2 + lane * 4, xh);
#pragma unroll
          for (int m = 0; m < 8; ++m)
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              acc[m][n] = fmaf(av[m][u], xl[n], acc[m][n]);
              acc[m][n + 4] = fmaf(av[m][u], xh[n], acc[m][n + 4]);
            }
        }
      }
      __syncthreads();  // buffer buf is read before it is refilled
      cur = nxt;
      buf ^= 1;
    }
    cp_async_wait<0>();
    __syncthreads();  // the mask is read before the next window clears it
  }

#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int rr = r0 + warp * 8 + m;
    if (rr >= bm) continue;
    TX* orow = out + (static_cast<size_t>(i) * bm + rr) * d;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int jj = j0 + (n / 4) * (kTN / 2) + lane * 4 + n % 4;
      if (jj < d) store(orow + jj, acc[m][n]);
    }
  }
}

template <typename TA, typename TX, bool kVec>
int launch(const void* tiles, const void* colidx, const void* x, void* out,
           int n_rb, int n_slots, int bm, int bn, int n_cb, int d,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<TA, TX>();
  auto kernel = spmm_ell_kernel<TA, TX, kVec>;
  static bool opted_in = false;
  const cudaError_t e = opt_in(kernel, smem, opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int row_tiles = (bm + kTM - 1) / kTM;
  const dim3 grid(n_rb * row_tiles, (d + kTN - 1) / kTN);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TA*>(tiles), static_cast<const int*>(colidx),
      static_cast<const TX*>(x), static_cast<TX*>(out), n_slots, bm, bn, n_cb,
      d, row_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TX>
int dispatch(const void* tiles, const void* colidx, const void* x, void* out,
             int n_rb, int n_slots, int bm, int bn, int n_cb, int d,
             cudaStream_t stream) {
  const bool aligned =
      bn % vec<TA>() == 0 && d % vec<TX>() == 0 &&
      (reinterpret_cast<uintptr_t>(tiles) | reinterpret_cast<uintptr_t>(x)) %
              16 ==
          0;
  return aligned ? launch<TA, TX, true>(tiles, colidx, x, out, n_rb, n_slots,
                                        bm, bn, n_cb, d, stream)
                 : launch<TA, TX, false>(tiles, colidx, x, out, n_rb,
                                         n_slots, bm, bn, n_cb, d, stream);
}

}  // namespace

// tiles (n_rb, n_slots, bm, bn), x (n_cb * bn, d) and out (n_rb * bm, d);
// colidx is (n_rb, n_slots) int32. `route` names the types: 0 all float32,
// 1 all bfloat16, 2 bfloat16 tiles with float32 x and out. Returns the
// launch's cudaError_t (0 on success; cudaErrorInvalidValue, without a
// launch, for another route).
extern "C" int repro_spmm_ell(const void* tiles, const void* colidx,
                              const void* x, void* out, int n_rb,
                              int n_slots, int bm, int bn, int n_cb, int d,
                              int route, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (route) {
    case 0:
      return dispatch<float, float>(tiles, colidx, x, out, n_rb, n_slots, bm,
                                    bn, n_cb, d, st);
    case 1:
      return dispatch<bf16, bf16>(tiles, colidx, x, out, n_rb, n_slots, bm,
                                  bn, n_cb, d, st);
    case 2:
      return dispatch<bf16, float>(tiles, colidx, x, out, n_rb, n_slots, bm,
                                   bn, n_cb, d, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
