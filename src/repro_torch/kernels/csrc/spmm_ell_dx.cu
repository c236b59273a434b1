// The block-ELL SpMM's input gradient for Hopper, sm_90a: dX = A^T @ G.
//
// There is no TPU kernel for it: the reference's custom VJP `_spmm_bwd`
// (src/repro/kernels/ops.py:34-62) is plain jnp, two fori_loops that add,
// slot by slot and row block by row block,
//
//   dX[cb*bn : +bn] += tiles[rb, s]^T @ G[rb*bm : +bm]   for colidx[rb, s] == cb
//
// in float32, with tiles (n_rb, S, bm, bn), colidx (n_rb, S) int32 (clamped
// into [0, n_cb)) and G (n_rb*bm, d); dX (n_cb*bn, d) has G's type. Three
// routes, the forward's: all float32, all bfloat16, and bfloat16 tiles with a
// float32 G and dX (the `block_dtype="bf16"` training step: the reference's
// `_spmm_bwd` promotes the bf16 tile in `tiles[i, s].T @ g` and returns
// `dx.astype(x.dtype)`, float32). On that route the scan reads 2-byte tiles
// and each tile element becomes float32 in registers before the float32
// FMAs. It replaces PyTorch's batched GEMM over
// every slot followed by `index_add_`, whose float atomics made a training
// run on the card differ from run to run.
//
// Deterministic. No float is added with an atomic. Each CTA owns 32 rows of
// one column block of dX and 256 features, and adds its terms in one fixed
// order: the (s, rb) pairs of its column block in the reference's order,
// each pair's 32-row chunks in order, each chunk's rows in order, one FMA
// chain per output element. Integer atomics count the pairs of each column
// block, which commutes.
//
// Three kernels, no host synchronisation between them (a CUDA graph can
// capture the call):
//   1. scan: one CTA per tile reads it once and records which of its
//      32 x 32 chunks hold a nonzero (-0 counts as zero, NaN does not), and
//      counts the live tile into its column block;
//   2. fill: one CTA per column block finds where its pairs start (the sum
//      of the counts before it) and writes its live (rb, s) pairs in (s, rb)
//      order with a ballot compaction: the transposed slot list, a CSR over
//      column blocks;
//   3. product: the CTAs of a column block walk its list, gather the live
//      chunks of their 32 tile columns into shared memory, then stream the
//      tile chunk (32 x 32) and the G rows under it (32 x 256) through a
//      double buffer with cp.async (16 bytes a thread), and add them in
//      float32 FMAs: a lane owns an 8 x 8 micro-tile (8 output rows read as
//      shared-memory broadcasts, 8 features).
// Padding slots are all-zero tiles at column block 0, so column block 0
// has the longest list of slots; the scan drops them from every list, and
// a dead chunk of a live tile is skipped too. As in the forward, a
// non-finite G under an all-zero chunk therefore gives 0 where the
// reference gives NaN.
//
// What bounds it on the H100. At the training shape (64 row blocks x 32
// slots of 128 x 128, d 256, 506 live tiles) the scan reads every tile once:
// 134 MB, 0.040 ms at 3.35 TB/s. The live tiles need 2*506*128*128*256 =
// 4.24 GFLOP, 0.063 ms at 67 TFLOP/s on the float32 CUDA cores (no TF32,
// which keeps about three decimal digits); most of their chunks are empty
// in a sampled adjacency, so the bytes bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 32;       // rows and columns of a tile chunk
constexpr int kTN = 256;         // features per product CTA
constexpr int kThreads = 128;    // product and scan CTAs: 4 warps
constexpr int kFillThreads = 256;
constexpr int kMaxChunks = 1024;  // chunks of a tile the scan can mark
constexpr int kScanBatch = 8;    // 16-byte loads in flight a thread (scan)
constexpr int kWindow = 1024;    // (pair, chunk) items listed at a time

template <typename T>
__host__ __device__ constexpr int vec() {
  return 16 / sizeof(T);
}
// a staged tile-chunk row, padded by 16 bytes
template <typename T>
__host__ __device__ constexpr int a_stride() {
  return kChunk + vec<T>();
}
// the live-item list, then the tile chunks (TA) and the G chunks (TG),
// double-buffered
template <typename TA, typename TG>
__host__ __device__ constexpr size_t product_smem_bytes() {
  return kWindow * sizeof(int) +
         2 * static_cast<size_t>(kChunk) * a_stride<TA>() * sizeof(TA) +
         2 * static_cast<size_t>(kChunk) * kTN * sizeof(TG);
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

__device__ __forceinline__ int clamp_cb(int cb, int n_cb) {
  return min(max(cb, 0), n_cb - 1);
}

// 1. one CTA per tile t = rb * S + s: its chunk flags, its liveness, and
// one count for its column block when it is live
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) dx_scan_kernel(
    const T* __restrict__ tiles, const int* __restrict__ colidx,
    uint8_t* __restrict__ flags, uint8_t* __restrict__ live,
    int* __restrict__ counts, int bm, int bn, int n_cb, int cc_n,
    int chunks) {
  constexpr int V = vec<T>();
  __shared__ int s_flag[kMaxChunks];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  for (int c = tid; c < chunks; c += kThreads) s_flag[c] = 0;
  __syncthreads();
  const T* tile = tiles + static_cast<size_t>(t) * bm * bn;
  if (kVec) {
    const int row_pieces = bn / V;
    const int n_pieces = bm * row_pieces;
    for (int base = 0; base < n_pieces; base += kThreads * kScanBatch) {
      uint4 raw[kScanBatch];
#pragma unroll
      for (int j = 0; j < kScanBatch; ++j) {
        const int e = base + tid + j * kThreads;
        raw[j] = e < n_pieces ? __ldg(reinterpret_cast<const uint4*>(tile) + e)
                              : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < kScanBatch; ++j) {
        if (nonzero16<T>(raw[j])) {  // zero beyond the tile
          const int e = base + tid + j * kThreads;
          const int r = e / row_pieces, col = (e % row_pieces) * V;
          s_flag[(r / kChunk) * cc_n + col / kChunk] = 1;
        }
      }
    }
  } else {
    for (int e = tid; e < bm * bn; e += kThreads) {
      if (to_f32(tile[e]) != 0.0f) {
        const int r = e / bn, col = e % bn;
        s_flag[(r / kChunk) * cc_n + col / kChunk] = 1;
      }
    }
  }
  __syncthreads();
  int any = 0;
  for (int c = tid; c < chunks; c += kThreads) {
    flags[static_cast<size_t>(t) * chunks + c] = static_cast<uint8_t>(s_flag[c]);
    any |= s_flag[c];
  }
  any = __syncthreads_or(any);
  if (tid == 0) {
    live[t] = static_cast<uint8_t>(any != 0);
    if (any) atomicAdd(&counts[clamp_cb(colidx[t], n_cb)], 1);
  }
}

// 2. one CTA per column block: where its pairs start, then its live tiles
// in (s, rb) order
__global__ void __launch_bounds__(kFillThreads) dx_fill_kernel(
    const int* __restrict__ colidx, const uint8_t* __restrict__ live,
    const int* __restrict__ counts, int* __restrict__ starts,
    int* __restrict__ pairs, int n_rb, int n_slots, int n_cb) {
  constexpr int kWarps = kFillThreads / 32;
  __shared__ int s_warp[kWarps];
  const int cb = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int part = 0;
  for (int c = tid; c < cb; c += kFillThreads) part += counts[c];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if (lane == 0) s_warp[warp] = part;
  __syncthreads();
  int base = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) base += s_warp[w];
  if (tid == 0) starts[cb] = base;
  __syncthreads();

  const int n = n_rb * n_slots;
  for (int i0 = 0; i0 < n; i0 += kFillThreads) {
    const int i = i0 + tid;
    int t = 0;
    bool hit = false;
    if (i < n) {
      const int s = i / n_rb, rb = i % n_rb;
      t = rb * n_slots + s;
      hit = live[t] && clamp_cb(colidx[t], n_cb) == cb;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp[warp] = __popc(m);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? s_warp[w] : 0;
      total += s_warp[w];
    }
    if (hit) pairs[base + before + __popc(m & ((1u << lane) - 1u))] = t;
    base += total;
    __syncthreads();  // s_warp is read before the next batch writes it
  }
}

// 3. the product: CTA (column block cb, strip of 32 tile columns, 256
// features); tiles of type TA, G and dX of type TG
template <typename TA, typename TG, bool kVec>
__global__ void __launch_bounds__(kThreads) dx_product_kernel(
    const TA* __restrict__ tiles, const TG* __restrict__ g,
    const uint8_t* __restrict__ flags, const int* __restrict__ counts,
    const int* __restrict__ starts, const int* __restrict__ pairs,
    TG* __restrict__ out, int n_slots, int bm, int bn, int d, int kc_n,
    int cc_n) {
  constexpr int V = vec<TA>();                                // a tile piece
  constexpr int VG = vec<TG>();                               // a G piece
  constexpr int AS = a_stride<TA>();
  constexpr int kRowPieces = kChunk / V;                      // in a chunk row
  constexpr int kAPieces = kChunk * kRowPieces / kThreads;    // a thread's
  constexpr int kGPieces = kChunk * kTN / VG / kThreads;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* list = reinterpret_cast<int*>(smem_raw);              // [kWindow]
  TA* s_a = reinterpret_cast<TA*>(list + kWindow);           // [2][32][AS]
  TG* s_g = reinterpret_cast<TG*>(s_a + 2 * kChunk * AS);    // [2][32][kTN]
  __shared__ int s_warp[kWarps];

  const int cb = blockIdx.x / cc_n;
  const int strip = blockIdx.x % cc_n;
  const int c0 = strip * kChunk;  // first tile column = first output row
  const int j0 = blockIdx.y * kTN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunks = kc_n * cc_n;
  const int n_items = counts[cb] * kc_n;
  const int* my_pairs = pairs + starts[cb];

  // item = t * kc_n + kc: rows kc*32.. of tile t, and the G rows under them
  auto stage = [&](int item, int buf) {
    const int t = item / kc_n, k0 = (item % kc_n) * kChunk;
    const int rb = t / n_slots;
    const TA* tile = tiles + static_cast<size_t>(t) * bm * bn;
#pragma unroll
    for (int p = 0; p < kAPieces; ++p) {
      const int q = tid + p * kThreads;
      const int r = q / kRowPieces, col = (q % kRowPieces) * V;
      const bool in = k0 + r < bm && c0 + col < bn;
      stage_piece<TA, kVec>(
          s_a + (buf * kChunk + r) * AS + col,
          in ? tile + static_cast<size_t>(k0 + r) * bn + c0 + col : tiles,
          in ? min(V, bn - c0 - col) : 0);
    }
    const TG* gb = g + (static_cast<size_t>(rb) * bm + k0) * d + j0;
#pragma unroll
    for (int p = 0; p < kGPieces; ++p) {
      const int e = tid + p * kThreads;
      const int k = e / (kTN / VG), n = (e % (kTN / VG)) * VG;
      const bool in = k0 + k < bm && j0 + n < d;
      stage_piece<TG, kVec>(s_g + (buf * kChunk + k) * kTN + n,
                            in ? gb + static_cast<size_t>(k) * d + n : g,
                            in ? min(VG, d - j0 - n) : 0);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0.0f;

  for (int w0 = 0; w0 < n_items; w0 += kWindow) {
    const int n_win = min(kWindow, n_items - w0);
    // the window's live items, in order
    int n_live = 0;
    for (int q0 = 0; q0 < n_win; q0 += kThreads) {
      const int q = q0 + tid;
      int item = 0;
      bool hit = false;
      if (q < n_win) {
        const int it = w0 + q;
        const int t = my_pairs[it / kc_n], kc = it % kc_n;
        hit = flags[static_cast<size_t>(t) * chunks + kc * cc_n + strip] != 0;
        item = t * kc_n + kc;
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_warp[warp] = __popc(m);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? s_warp[w] : 0;
        total += s_warp[w];
      }
      if (hit) list[n_live + before + __popc(m & ((1u << lane) - 1u))] = item;
      n_live += total;
      __syncthreads();
    }

    // the live items, double-buffered
    if (n_live > 0) stage(list[0], 0);
    cp_async_commit();
    for (int c = 0; c < n_live; ++c) {
      const int buf = c & 1;
      if (c + 1 < n_live) stage(list[c + 1], buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // item c has landed
      __syncthreads();
      const TA* a = s_a + buf * kChunk * AS;
      const TG* gs = s_g + buf * kChunk * kTN;
#pragma unroll 8
      for (int k = 0; k < kChunk; ++k) {
        // tile row k, columns warp*8.. (this warp's 8 output rows), and
        // G row k, this lane's 8 features
        float av[8], part[4], gl[4], gh[4];
        load4(a + k * AS + warp * 8, part);
#pragma unroll
        for (int m = 0; m < 4; ++m) av[m] = part[m];
        load4(a + k * AS + warp * 8 + 4, part);
#pragma unroll
        for (int m = 0; m < 4; ++m) av[m + 4] = part[m];
        load4(gs + k * kTN + lane * 4, gl);
        load4(gs + k * kTN + kTN / 2 + lane * 4, gh);
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            acc[m][n] = fmaf(av[m], gl[n], acc[m][n]);
            acc[m][n + 4] = fmaf(av[m], gh[n], acc[m][n + 4]);
          }
      }
      __syncthreads();  // buffer buf is read before it is refilled
    }
    cp_async_wait<0>();
    __syncthreads();  // the list is read before the next window writes it
  }

#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int rr = c0 + warp * 8 + m;
    if (rr >= bn) continue;
    TG* orow = out + (static_cast<size_t>(cb) * bn + rr) * d;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int jj = j0 + (n / 4) * (kTN / 2) + lane * 4 + n % 4;
      if (jj < d) store(orow + jj, acc[m][n]);
    }
  }
}

template <typename TA, typename TG, bool kVec>
int launch(const void* tiles, const void* colidx, const void* g, void* out,
           void* work, int n_rb, int n_slots, int bm, int bn, int n_cb, int d,
           cudaStream_t stream) {
  const int n_t = n_rb * n_slots;
  const int kc_n = (bm + kChunk - 1) / kChunk;
  const int cc_n = (bn + kChunk - 1) / kChunk;
  const int chunks = kc_n * cc_n;
  if (chunks > kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
  int* counts = static_cast<int*>(work);
  int* starts = counts + n_cb;
  int* pairs = starts + n_cb;
  uint8_t* live = reinterpret_cast<uint8_t*>(pairs + n_t);
  uint8_t* flags = live + n_t;
  const TA* tl = static_cast<const TA*>(tiles);
  const int* ci = static_cast<const int*>(colidx);
  cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int) * n_cb, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_t > 0) {
    dx_scan_kernel<TA, kVec><<<n_t, kThreads, 0, stream>>>(
        tl, ci, flags, live, counts, bm, bn, n_cb, cc_n, chunks);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dx_fill_kernel<<<n_cb, kFillThreads, 0, stream>>>(ci, live, counts, starts,
                                                    pairs, n_rb, n_slots,
                                                    n_cb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr size_t smem = product_smem_bytes<TA, TG>();
  auto kernel = dx_product_kernel<TA, TG, kVec>;
  static bool opted_in = false;
  e = opt_in(kernel, smem, opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_cb * cc_n, (d + kTN - 1) / kTN);
  kernel<<<grid, kThreads, smem, stream>>>(
      tl, static_cast<const TG*>(g), flags, counts, starts, pairs,
      static_cast<TG*>(out), n_slots, bm, bn, d, kc_n, cc_n);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TG>
int dispatch(const void* tiles, const void* colidx, const void* g, void* out,
             void* work, int n_rb, int n_slots, int bm, int bn, int n_cb,
             int d, cudaStream_t stream) {
  const bool aligned =
      bn % vec<TA>() == 0 && d % vec<TG>() == 0 &&
      (reinterpret_cast<uintptr_t>(tiles) | reinterpret_cast<uintptr_t>(g)) %
              16 ==
          0;
  return aligned ? launch<TA, TG, true>(tiles, colidx, g, out, work, n_rb,
                                        n_slots, bm, bn, n_cb, d, stream)
                 : launch<TA, TG, false>(tiles, colidx, g, out, work, n_rb,
                                         n_slots, bm, bn, n_cb, d, stream);
}

}  // namespace

// tiles (n_rb, n_slots, bm, bn), g (n_rb * bm, d) and out (n_cb * bn, d);
// colidx is (n_rb, n_slots) int32. `route` names the types, as the
// forward's: 0 all float32, 1 all bfloat16, 2 bfloat16 tiles with float32 g
// and out. work holds 4 * (2 * n_cb + T) + T + T * chunks bytes (T = n_rb *
// n_slots tiles, chunks = ceil(bm / 32) * ceil(bn / 32) <= 1024), 4-byte
// aligned. Returns the first failing call's cudaError_t (0 on success;
// cudaErrorInvalidValue, without a launch, for another route).
extern "C" int repro_spmm_ell_dx(const void* tiles, const void* colidx,
                                 const void* g, void* out, void* work,
                                 int n_rb, int n_slots, int bm, int bn,
                                 int n_cb, int d, int route, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (route) {
    case 0:
      return dispatch<float, float>(tiles, colidx, g, out, work, n_rb,
                                    n_slots, bm, bn, n_cb, d, st);
    case 1:
      return dispatch<bf16, bf16>(tiles, colidx, g, out, work, n_rb, n_slots,
                                  bm, bn, n_cb, d, st);
    case 2:
      return dispatch<bf16, float>(tiles, colidx, g, out, work, n_rb,
                                   n_slots, bm, bn, n_cb, d, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
