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
// never from colidx: the kernel skips every step (8 rows x 1 column of a
// tile, spmm_steps.cuh) that is all zero -- the x row under it is not
// loaded and its products not computed. For finite x that is the function
// the TPU kernel computes; a non-finite x under an all-zero step no longer
// turns the output to NaN, as 0 * inf would.
//
// What bounds it on the H100. At the training shape (n_rb = 64, bm = bn =
// 128, d = 256, S = 32) all tiles are read once, padding included, to find
// it: 134 MB in float32, 0.040 ms at 3.35 TB/s, and 67 MB (0.020 ms) as
// bfloat16. A sampled batch holds about one nonzero a row (8,806 in 33.5 M
// tile elements: a self-loop a row and ~0.1 other edges), so the products
// its nonzeros need, 2 * 8,806 * 256 operations, are nothing beside the
// bytes. A 32 x 32 chunk of it holds about one nonzero, or 32 on the
// diagonal: multiplying whole live chunks (the kernel before this design)
// did 32 to 1024 times the work that counts, after the scan, and took as
// long again as the scan. No route uses TF32, which keeps about three
// decimal digits: the training path is held to 1e-4.
//
// Design: the TPU kernel keeps all of x resident in VMEM and walks the slots
// in a sequential fori_loop per (row-block, feature-tile) grid cell; 227 KB
// of shared memory cannot hold x here. One CTA of 128 threads owns 32 rows
// of one row-block and 256 features, so that every tile byte is read by one
// CTA only; each warp owns 8 rows. The CTA works in two passes over a
// window of its strip's chunks (slot-major, 32 columns each). The scan:
// each warp streams its own 8 rows of the strip through a cp.async ring in
// the (still unused) x buffers, half of it in flight while the lanes fold
// the other half's bits, and one word per (chunk, warp) records which of
// the chunk's 32 columns hold a nonzero in those rows (the lanes' piece
// bits ORed with five shuffles, only where any lane saw one); no barrier,
// as each lane reads back only what it copied. The product then walks the
// live chunks (walk_chunks): it stages the chunk's tile values converted to
// float32 once and transposed to step-major, and the x rows under the
// columns some warp needs (1 KB each in float32); each warp adds its own
// live columns in order. Any bm and bn (the reference sweeps 8, 16, 32 and
// 128) and a ragged d are masked at the edges; when bn or d is not a
// multiple of 16 bytes, or a pointer is not 16-byte aligned, both passes
// use plain loads.
//
// Routes. The kernel is templated on the tile type and the operand type
// (x and out) apart: all float32, all bfloat16, and bfloat16 tiles with a
// float32 x and output -- the reference's `block_dtype="bf16"` training
// step, where `jnp.dot(tile, x, preferred_element_type=float32)` promotes
// the bf16 tile and the output keeps x's type. On that route the scan reads
// 2-byte tiles (half the bytes that bound it), each tile element is
// converted to float32 once as its chunk is staged, and the products stay
// float32 FMAs (no TF32), so it is held to the f32 route's 1e-4.

#include "spmm_steps.cuh"

namespace {

constexpr int kWinChunks = 512;  // chunks a window: one word a warp each

// the staged chunks, the window's words [kWinChunks][4] and its live-chunk
// mask
template <typename TX>
__host__ __device__ constexpr size_t smem_bytes() {
  return stage_bytes<TX>() +
         (4 * kWinChunks + kWinChunks / 32) * sizeof(uint32_t);
}

// tiles of type TA; x and out of type TX
template <typename TA, typename TX, bool kVec>
__global__ void __launch_bounds__(kThreads) spmm_ell_kernel(
    const TA* __restrict__ tiles, const int* __restrict__ colidx,
    const TX* __restrict__ x, TX* __restrict__ out, int n_slots, int bm,
    int bn, int n_cb, int d, int row_tiles) {
  constexpr int V = vec<TA>();               // elements of a tile piece
  constexpr int P = kChunk / V;              // pieces in a chunk row
  constexpr int kUnit = 8 * P / 32;          // a lane's pieces of 8 rows
  // the scan's ring: 16-byte pieces a lane, and chunks in half of it
  constexpr int kRing = 2 * kChunk * kTN * sizeof(TX) / (16 * kThreads);
  constexpr int kHalf = kRing / 2 / kUnit;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_a = reinterpret_cast<float*>(smem_raw);            // staged values
  TX* s_x = reinterpret_cast<TX*>(s_a + 2 * kChunk * kAStride);  // x rows
  uint32_t* words = reinterpret_cast<uint32_t*>(s_x + 2 * kChunk * kTN);
  uint32_t* mask = words + 4 * kWinChunks;   // [kWinChunks / 32]

  const int i = blockIdx.x / row_tiles;           // row-block
  const int r0 = (blockIdx.x % row_tiles) * kChunk;  // first row in it
  const int j0 = blockIdx.y * kTN;                // first feature
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // rows r0 + warp * 8 + {0..7}
  const int k_chunks = (bn + kChunk - 1) / kChunk;
  const int n_chunks = n_slots * k_chunks;
  const TA* tiles_i = tiles + static_cast<size_t>(i) * n_slots * bm * bn;
  // chunk c's tile element (row r of the strip, column col of the chunk)
  auto at = [&](int c, int r, int col) {
    return tiles_i + static_cast<size_t>(c / k_chunks) * bm * bn +
           static_cast<size_t>(r0 + r) * bn + (c % k_chunks) * kChunk + col;
  };
  auto cols_left = [&](int c, int col) {  // columns of chunk c from col
    return bn - (c % k_chunks) * kChunk - col;
  };

  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0.0f;

  for (int c0 = 0; c0 < n_chunks; c0 += kWinChunks) {
    const int n_win = min(n_chunks - c0, kWinChunks);

    // pass 1: this warp's word of each chunk of the window. Lane piece q =
    // u * 32 + lane lies in row q / P of the warp's 8 and columns
    // (q % P) * V.. of the chunk; every q of a lane has p = lane % P
    const int p = lane % P;
    // the word of window chunk c from the lanes' piece bits m: the 8 rows
    // of column piece p, then the chunk's P column pieces
    auto finish = [&](int c, uint32_t m) {
      uint32_t word = 0;
      if (__any_sync(0xffffffffu, m != 0u)) {
#pragma unroll
        for (int o = P; o < 32; o <<= 1)
          m |= __shfl_xor_sync(0xffffffffu, m, o);
        word = m << (p * V);
#pragma unroll
        for (int o = 1; o < P; o <<= 1)
          word |= __shfl_xor_sync(0xffffffffu, word, o);
      }
      if (lane == 0 && c < n_win) words[c * 4 + warp] = word;
    };
    if constexpr (kVec) {
      // a ring in the operand rows' buffers (free until the product): each
      // lane copies its pieces with cp.async and reads back only its own,
      // so no barrier; half the ring is in flight while the other's bits
      // are folded
      uint4* ring = reinterpret_cast<uint4*>(s_x);  // [kRing][kThreads]
      auto slot = [&](int h, int j, int u) {
        return ring + ((h * kHalf + j) * kUnit + u) * kThreads + tid;
      };
      auto issue = [&](int b) {  // chunks b * kHalf.. into half b & 1
        int sl = (c0 + b * kHalf) / k_chunks, kc = (c0 + b * kHalf) % k_chunks;
#pragma unroll
        for (int j = 0; j < kHalf; ++j) {
          const TA* src = tiles_i + static_cast<size_t>(sl) * bm * bn +
                          static_cast<size_t>(r0 + warp * 8) * bn +
                          kc * kChunk + p * V;
          const bool cols = b * kHalf + j < n_win && kc * kChunk + p * V < bn;
#pragma unroll
          for (int u = 0; u < kUnit; ++u) {
            const int r = (u * 32 + lane) / P;  // of the warp's 8 rows
            const bool in = cols && r0 + warp * 8 + r < bm;
            cp_async16(smem_addr(slot(b & 1, j, u)),
                       in ? src + static_cast<size_t>(r) * bn : tiles, in);
          }
          if (++kc == k_chunks) {
            kc = 0;
            ++sl;
          }
        }
        cp_async_commit();
      };
      const int n_b = (n_win + kHalf - 1) / kHalf;
      issue(0);
      if (n_b > 1) {
        issue(1);
      } else {
        cp_async_commit();
      }
      for (int b = 0; b < n_b; ++b) {
        cp_async_wait<1>();  // half b & 1 has landed
#pragma unroll
        for (int j = 0; j < kHalf; ++j) {
          uint32_t m = 0;
#pragma unroll
          for (int u = 0; u < kUnit; ++u)
            m |= nonzero_bits<TA>(*slot(b & 1, j, u));
          finish(b * kHalf + j, m);
        }
        if (b + 2 < n_b) {
          issue(b + 2);
        } else {
          cp_async_commit();
        }
      }
      cp_async_wait<0>();
    } else {  // plain loads, a chunk at a time
      for (int c = 0; c < n_win; ++c) {
        uint32_t m = 0;
#pragma unroll
        for (int u = 0; u < kUnit; ++u) {
          const int r = warp * 8 + (u * 32 + lane) / P;
          const int valid = r0 + r < bm ? min(V, cols_left(c0 + c, p * V))
                                        : 0;
          m |= nonzero_bits<TA>(load_piece<TA, false>(
              valid > 0 ? at(c0 + c, r, p * V) : tiles, valid));
        }
        finish(c, m);
      }
    }
    __syncthreads();
    for (int c = tid; c < (n_win + 31) / 32 * 32; c += kThreads) {
      const bool live =
          c < n_win && (words[c * 4] | words[c * 4 + 1] | words[c * 4 + 2] |
                        words[c * 4 + 3]) != 0u;
      const unsigned bits = __ballot_sync(0xffffffffu, live);
      if (lane == 0) mask[c >> 5] = bits;
    }
    __syncthreads();

    // pass 2: the live chunks
    auto next_live = [&](int c) {  // the first live chunk >= c, or n_win
      while (c < n_win) {
        const uint32_t w = mask[c >> 5] >> (c & 31);
        if (w) return c + __ffs(w) - 1;
        c = (c | 31) + 1;
      }
      return n_win;
    };
    auto load_tile = [&](int c, uint4(&raw)[chunk_pieces<TA>()]) {
#pragma unroll
      for (int q = 0; q < chunk_pieces<TA>(); ++q) {
        const int e = tid + q * kThreads;
        const int r = e / P, col = (e % P) * V;
        const int valid =
            r0 + r < bm ? min(V, cols_left(c0 + c, col)) : 0;
        raw[q] = load_piece<TA, kVec>(valid > 0 ? at(c0 + c, r, col) : tiles,
                                      valid);
      }
    };
    auto store_tile = [&](float* a, const uint4(&raw)[chunk_pieces<TA>()]) {
#pragma unroll
      for (int q = 0; q < chunk_pieces<TA>(); ++q) {
        const int e = tid + q * kThreads;
        const int r = e / P, col = (e % P) * V;
        float v[V];
        unpack(raw[q], v);
#pragma unroll
        for (int k = 0; k < V; ++k) a[(col + k) * kAStride + r] = v[k];
      }
    };
    auto stage_rows = [&](int c, TX* xs) {
      const uint32_t rows = rows_to_stage(words[c * 4], words[c * 4 + 1],
                                          words[c * 4 + 2], words[c * 4 + 3]);
      int cb = colidx[static_cast<size_t>(i) * n_slots + (c0 + c) / k_chunks];
      cb = min(max(cb, 0), n_cb - 1);
      const int k0 = ((c0 + c) % k_chunks) * kChunk;
      stage_operand_rows<TX, kVec>(
          xs, x + (static_cast<size_t>(cb) * bn + k0) * d + j0,
          static_cast<size_t>(d), rows, bn - k0, d - j0, x);
    };
    walk_chunks<TA, TX>(acc, s_a, s_x, next_live(0), n_win, next_live,
                        load_tile, store_tile, stage_rows,
                        [&](int c) { return words[c * 4 + warp]; });
    __syncthreads();  // the words are read before the next window's scan
  }

  store_acc(acc, out + (static_cast<size_t>(i) * bm + r0) * d,
            min(kChunk, bm - r0), j0, d);
}

template <typename TA, typename TX, bool kVec>
int launch(const void* tiles, const void* colidx, const void* x, void* out,
           int n_rb, int n_slots, int bm, int bn, int n_cb, int d,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<TX>();
  auto kernel = spmm_ell_kernel<TA, TX, kVec>;
  static bool opted_in = false;
  const cudaError_t e = opt_in(kernel, smem, opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int row_tiles = (bm + kChunk - 1) / kChunk;
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
