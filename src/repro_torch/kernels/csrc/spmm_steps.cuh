// What the block-ELL SpMM (spmm_ell.cu) and its input gradient
// (spmm_ell_dx.cu) share on Hopper, sm_90a: the element types of their three
// routes, the liveness of 16-byte tile pieces, and the product of the live
// chunks of a CTA's strip, step by step.
//
// The unit of work. A CTA owns 32 output rows (a strip) and 256 features;
// each of its four warps owns 8 of those rows, each lane 8 features (lane*4
// + {0..3} and 128 + lane*4 + {0..3}), an 8 x 8 micro-tile of float32
// accumulators. A tile chunk is 32 x 32 elements: its 32 steps k each add
// one operand row (x in the forward, g in the dX) times one value a row of
// the warp. A step is live for a warp if one of its 8 values is nonzero;
// a chunk is live if a step of any warp is. `walk_chunks` stages a live
// chunk's tile values, converted once to float32 and laid out step-major
// (a[k][r]), and only the operand rows under steps that some warp needs;
// each warp then adds its own live steps in order of k (all 32 steps, the
// dense loop, when half or more are live). So a sampled adjacency's chunk
// that holds one nonzero costs one step of one warp, and a diagonal chunk
// 8 steps a warp. Each output element's FMA chain keeps the order of a
// dense walk over the live chunks with only zero terms left out; the
// accumulator starts at +0, so on finite operands the result is the dense
// walk's bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 32;             // rows and columns of a tile chunk
constexpr int kTN = 256;               // output features per CTA
constexpr int kThreads = 128;          // 4 warps of 8 output rows
constexpr int kAStride = kChunk + 4;   // a staged step's 32 values, padded

// elements in a 16-byte piece
template <typename T>
__host__ __device__ constexpr int vec() {
  return 16 / sizeof(T);
}
// a thread's 16-byte pieces of one tile chunk
template <typename T>
__host__ __device__ constexpr int chunk_pieces() {
  return kChunk * kChunk / vec<T>() / kThreads;
}
// the staged chunks, double-buffered: float32 tile values (step-major),
// then the operand rows under them (TX)
template <typename TX>
__host__ __device__ constexpr size_t stage_bytes() {
  return 2 * static_cast<size_t>(kChunk) * kAStride * sizeof(float) +
         2 * static_cast<size_t>(kChunk) * kTN * sizeof(TX);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ uint32_t raw_bits(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t raw_bits(bf16 v) {
  return __bfloat16_as_ushort(v);
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

// one 16-byte piece into shared memory: cp.async when kVec, else element by
// element (masked, zero beyond `valid`)
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

// one 16-byte piece of tiles into registers, its elements' bits packed as
// they lie in memory: one 16-byte load when kVec, else element by element
// (zero beyond `valid`; 0 valid reads nothing)
template <typename T, bool kVec>
__device__ __forceinline__ uint4 load_piece(const T* src, int valid) {
  if (kVec) {
    return valid > 0 ? __ldg(reinterpret_cast<const uint4*>(src))
                     : make_uint4(0u, 0u, 0u, 0u);
  }
  constexpr int V = vec<T>();
  constexpr int kBits = 8 * sizeof(T);  // bits an element
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (e < valid) w[e * kBits / 32] |= raw_bits(src[e]) << (e * kBits % 32);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// which elements of a piece of T are nonzero, as bits (element e, bit e);
// -0 counts as zero, NaN does not
template <typename T>
__device__ __forceinline__ uint32_t nonzero_bits(const uint4& u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (sizeof(T) == 4) {
      m |= static_cast<uint32_t>((w[j] & 0x7fffffffu) != 0) << j;
    } else {
      m |= static_cast<uint32_t>((w[j] & 0x7fffu) != 0) << (2 * j);
      m |= static_cast<uint32_t>((w[j] & 0x7fff0000u) != 0) << (2 * j + 1);
    }
  }
  return m;
}

// a piece's elements as floats
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// an exclusive prefix sum over the CTA's threads (kThreads); `total` gets
// the sum. s_warp holds kThreads / 32 ints. Every thread must call it.
__device__ __forceinline__ int cta_exclusive_sum(int v, int* s_warp,
                                                 int& total) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
  }
  __syncthreads();  // s_warp is read before the next call writes it
  return before + incl - v;
}

// one step's operands: the warp's 8 values and the lane's 8 features
struct Step {
  float av[8], xl[4], xh[4];
};

template <typename TX>
__device__ __forceinline__ void load_step(const float* a, const TX* xs,
                                          int k, int warp, int lane,
                                          Step& s) {
  float lo[4], hi[4];
  load4(a + k * kAStride + warp * 8, lo);
  load4(a + k * kAStride + warp * 8 + 4, hi);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    s.av[m] = lo[m];
    s.av[m + 4] = hi[m];
  }
  load4(xs + k * kTN + lane * 4, s.xl);
  load4(xs + k * kTN + kTN / 2 + lane * 4, s.xh);
}

__device__ __forceinline__ void add_step(float (&acc)[8][8], const Step& s) {
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      acc[m][n] = fmaf(s.av[m], s.xl[n], acc[m][n]);
      acc[m][n + 4] = fmaf(s.av[m], s.xh[n], acc[m][n + 4]);
    }
}

// One warp's steps of a staged chunk, in order of k: a holds the chunk's
// values step-major (a[k * kAStride + r], r the strip's row), xs the
// operand row under each step (xs[k * kTN + feature]). A warp with half
// its 32 steps live or more runs the dense loop, all 32 steps (a dead
// step's values are zeros and its operand row is staged, rows_to_stage:
// it adds 0 * x); a sparser one only its live steps, two at a time.
template <typename TX>
__device__ __forceinline__ void chunk_steps(float (&acc)[8][8],
                                            const float* a, const TX* xs,
                                            uint32_t word, int warp,
                                            int lane) {
  if (__popc(word) >= kChunk / 2) {
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      Step s;
      load_step(a, xs, k, warp, lane, s);
      add_step(acc, s);
    }
    return;
  }
  while (word != 0u) {  // both loads before both adds
    const int k0 = __ffs(word) - 1;
    word &= word - 1u;
    const int k1 = word != 0u ? __ffs(word) - 1 : -1;
    word &= word - 1u;
    Step s0, s1;
    load_step(a, xs, k0, warp, lane, s0);
    if (k1 >= 0) load_step(a, xs, k1, warp, lane, s1);
    add_step(acc, s0);
    if (k1 >= 0) add_step(acc, s1);
  }
}

// The CTA's walk over its live chunks cur, next(cur + 1), ... (< end),
// double-buffered: the operand rows under the next chunk's live steps go in
// with cp.async and its tile values into registers while the warps add the
// current chunk's steps; the values are converted and stored after.
//   load_tile(c, raw)      a thread's chunk_pieces<TA>() pieces of chunk c
//   store_tile(a, raw)     them into a staged buffer, step-major
//   stage_rows(c, xs)      the operand rows under chunk c's live steps
//   word(c)                this warp's live steps of chunk c
// s_a is [2][kChunk][kAStride] floats, s_x [2][kChunk][kTN] of TX. Ends with
// every copy landed; the caller syncs before it reuses what `word` reads.
template <typename TA, typename TX, typename Next, typename LoadTile,
          typename StoreTile, typename StageRows, typename Word>
__device__ __forceinline__ void walk_chunks(
    float (&acc)[8][8], float* s_a, TX* s_x, int cur, int end, Next next,
    LoadTile load_tile, StoreTile store_tile, StageRows stage_rows,
    Word word) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint4 raw[chunk_pieces<TA>()];
  int buf = 0;
  if (cur < end) {
    stage_rows(cur, s_x);
    load_tile(cur, raw);
  }
  cp_async_commit();
  if (cur < end) store_tile(s_a, raw);
  while (cur < end) {
    const int nxt = next(cur + 1);
    if (nxt < end) {
      stage_rows(nxt, s_x + (buf ^ 1) * kChunk * kTN);
      load_tile(nxt, raw);
    }
    cp_async_commit();
    cp_async_wait<1>();  // chunk cur's rows have landed
    __syncthreads();     // and its values are stored
    chunk_steps(acc, s_a + buf * kChunk * kAStride, s_x + buf * kChunk * kTN,
                word(cur), warp, lane);
    if (nxt < end) store_tile(s_a + (buf ^ 1) * kChunk * kAStride, raw);
    __syncthreads();  // buffer buf is read before it is refilled
    cur = nxt;
    buf ^= 1;
  }
  cp_async_wait<0>();
}

// which operand rows a chunk stages, from its four warps' words: those
// under some warp's live steps, or all 32 when a warp runs the dense loop
__device__ __forceinline__ uint32_t rows_to_stage(uint32_t w0, uint32_t w1,
                                                  uint32_t w2, uint32_t w3) {
  const int most = max(max(__popc(w0), __popc(w1)), max(__popc(w2), __popc(w3)));
  return most >= kChunk / 2 ? 0xffffffffu : (w0 | w1 | w2 | w3);
}

// the operand rows under the set bits of `rows` into xs [kChunk][kTN]: row
// k is src + k * ld, its first kTN features below d_left, when k <
// n_valid, and zeros past the edge of the block
template <typename TX, bool kVec>
__device__ __forceinline__ void stage_operand_rows(TX* xs, const TX* src,
                                                   size_t ld, uint32_t rows,
                                                   int n_valid, int d_left,
                                                   const TX* any) {
  constexpr int VX = vec<TX>();
  constexpr int kRowPieces = kTN / VX;
  constexpr int kPieces = kChunk * kRowPieces / kThreads;
  auto piece = [&](int p, bool all) {
    const int e = threadIdx.x + p * kThreads;
    const int k = e / kRowPieces, n = (e % kRowPieces) * VX;
    if (!all && !((rows >> k) & 1u)) return;
    const bool in = k < n_valid && n < d_left;
    stage_piece<TX, kVec>(xs + k * kTN + n, in ? src + k * ld + n : any,
                          in ? min(VX, d_left - n) : 0);
  };
  if constexpr (kVec) {
    // every row (a dense chunk) without a test a piece: the dense loop
    // ran about a fifth slower on the card when this copy tested rows
    if (rows == 0xffffffffu) {
#pragma unroll
      for (int p = 0; p < kPieces; ++p) piece(p, true);
    } else {
#pragma unroll
      for (int p = 0; p < kPieces; ++p) piece(p, false);
    }
  } else {  // element by element: one piece at a time
#pragma unroll 1
    for (int p = 0; p < kPieces; ++p) piece(p, false);
  }
}

// the micro-tile's rows below n_rows (row warp * 8 + m of the strip at
// out_rows), features below d
template <typename TX>
__device__ __forceinline__ void store_acc(const float (&acc)[8][8],
                                          TX* out_rows, int n_rows, int j0,
                                          int d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int rr = warp * 8 + m;
    if (rr >= n_rows) continue;
    TX* orow = out_rows + static_cast<size_t>(rr) * d;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int jj = j0 + (n / 4) * (kTN / 2) + lane * 4 + n % 4;
      if (jj < d) store(orow + jj, acc[m][n]);
    }
  }
}

}  // namespace
