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
// and each tile element becomes float32 once, as its chunk is staged, before
// the float32 FMAs. It replaces PyTorch's batched GEMM over every slot
// followed by `index_add_`, whose float atomics made a training run on the
// card differ from run to run.
//
// Deterministic. No float is added with an atomic. Each CTA owns 32 rows of
// one column block of dX (32 tile columns, a strip) and 256 features, and
// adds its terms in one fixed order: the live (s, rb) pairs of its column
// block in the reference's order, each pair's 32-row chunks in order, each
// chunk's rows in order, one FMA chain per output element.
//
// Two kernels, no host synchronisation between them (a CUDA graph can
// capture the call):
//   1. scan: each CTA streams a run of consecutive tiles (about 32 KB)
//      and records, for every tile row and group of 8 tile columns, whether
//      it holds a nonzero (-0 counts as zero, NaN does not): a word of 32
//      row bits per (tile, 32-row chunk, column group), set with shared
//      atomics only where a 16-byte piece holds a nonzero, and a byte of
//      liveness per tile;
//   2. product: CTA (column block, strip, feature tile) lists the live
//      tiles of its column block in (s, rb) order (a CTA-wide prefix sum
//      over 2,048 candidates at a time), then their live chunks with this
//      strip's four column-group words, and walks them (walk_chunks in
//      spmm_steps.cuh): a warp owns 8 output rows, i.e. 8 tile columns, and
//      its steps are the tile rows with a nonzero under them, so a chunk
//      that holds one nonzero costs one step of one warp; only the G rows
//      under some warp's live steps are staged.
// Padding slots are all-zero tiles at column block 0; the scan drops them
// from every list, and a dead step of a live tile is skipped too. As in the
// forward, a non-finite G under an all-zero step therefore gives 0 where
// the reference gives NaN.
//
// What bounds it on the H100. At the training shape (64 row blocks x 32
// slots of 128 x 128, d 256) the scan reads every tile once: 134 MB in
// float32, 0.040 ms at 3.35 TB/s, 67 MB (0.020 ms) as bfloat16. A sampled
// batch holds about one nonzero a tile row (a self-loop a row, ~0.1 other
// edges), so its products are nothing beside the bytes (no TF32, which
// keeps about three decimal digits).

#include "spmm_steps.cuh"

namespace {

constexpr int kScanThreads = 128;
constexpr int kScanLoads = 8;        // 16-byte loads in flight a thread
constexpr int kScanBytes = 32768;    // tile bytes a scan CTA streams
constexpr int kScanWords = 4096;     // its row words, at most
constexpr int kCandidates = 16;      // (s, rb) candidates a thread a round
constexpr int kPairCap = kThreads * kCandidates;
constexpr int kItemsPerThread = 4;   // (pair, chunk) items a thread a round
constexpr int kItemCap = kThreads * kItemsPerThread;

// the staged chunks, then the pair list, the live items and their words
template <typename TG>
__host__ __device__ constexpr size_t product_smem_bytes() {
  return stage_bytes<TG>() + kItemCap * sizeof(uint4) +
         (kPairCap + 3 * kItemCap) * sizeof(int);
}

__device__ __forceinline__ int clamp_cb(int cb, int n_cb) {
  return min(max(cb, 0), n_cb - 1);
}

// 1. the run blockIdx.x of `run` consecutive tiles: each tile's row words
// (rowbits[t][kc][q], q < cc_n * 4 column groups of 8) and liveness
template <typename T, bool kVec>
__global__ void __launch_bounds__(kScanThreads) dx_scan_kernel(
    const T* __restrict__ tiles, uint32_t* __restrict__ rowbits,
    uint8_t* __restrict__ live, int n_t, int bm, int bn, int cc_n,
    int words_per_tile, int run) {
  constexpr int V = vec<T>();
  extern __shared__ uint32_t s_bits[];       // [run][words_per_tile]
  int* s_live = reinterpret_cast<int*>(s_bits + run * words_per_tile);
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * run;
  const int n_here = min(run, n_t - t0);
  const int n_words = n_here * words_per_tile;
  for (int w = tid; w < n_words; w += kScanThreads) s_bits[w] = 0u;
  for (int w = tid; w < n_here; w += kScanThreads) s_live[w] = 0;
  __syncthreads();
  const T* base = tiles + static_cast<size_t>(t0) * bm * bn;
  // element (tile tl, row r, column col) holds a nonzero
  auto mark = [&](int tl, int r, int col) {
    atomicOr(&s_bits[tl * words_per_tile + (r / kChunk) * cc_n * 4 +
                     col / 8],
             1u << (r % kChunk));
    s_live[tl] = 1;
  };
  if (kVec) {
    const int row_pieces = bn / V;
    const int tile_pieces = bm * row_pieces;
    const int n_pieces = n_here * tile_pieces;
    for (int b = 0; b < n_pieces; b += kScanThreads * kScanLoads) {
      uint4 raw[kScanLoads];
#pragma unroll
      for (int j = 0; j < kScanLoads; ++j) {
        const int e = b + tid + j * kScanThreads;
        raw[j] = load_piece<T, true>(
            reinterpret_cast<const T*>(
                reinterpret_cast<const uint4*>(base) +
                (e < n_pieces ? e : 0)),
            e < n_pieces ? V : 0);
      }
#pragma unroll
      for (int j = 0; j < kScanLoads; ++j) {
        if (nonzero_bits<T>(raw[j]) != 0u) {  // zero beyond the run
          const int e = b + tid + j * kScanThreads;
          const int tl = e / tile_pieces, q = e % tile_pieces;
          mark(tl, q / row_pieces, (q % row_pieces) * V);
        }
      }
    }
  } else {
    const int n_elems = n_here * bm * bn;
    for (int e = tid; e < n_elems; e += kScanThreads) {
      if ((raw_bits(base[e]) & (sizeof(T) == 4 ? 0x7fffffffu : 0x7fffu)) !=
          0u) {
        const int tl = e / (bm * bn), q = e % (bm * bn);
        mark(tl, q / bn, q % bn);
      }
    }
  }
  __syncthreads();
  uint32_t* dst = rowbits + static_cast<size_t>(t0) * words_per_tile;
  for (int w = tid; w < n_words; w += kScanThreads) dst[w] = s_bits[w];
  for (int w = tid; w < n_here; w += kScanThreads)
    live[t0 + w] = static_cast<uint8_t>(s_live[w]);
}

// 2. the product: CTA (column block cb, strip of 32 tile columns, 256
// features); tiles of type TA, G and dX of type TG
template <typename TA, typename TG, bool kVec>
__global__ void __launch_bounds__(kThreads) dx_product_kernel(
    const TA* __restrict__ tiles, const int* __restrict__ colidx,
    const TG* __restrict__ g, const uint32_t* __restrict__ rowbits,
    const uint8_t* __restrict__ live, TG* __restrict__ out, int n_rb,
    int n_slots, int bm, int bn, int n_cb, int d, int kc_n, int cc_n) {
  constexpr int V = vec<TA>();   // elements of a tile piece
  constexpr int P = kChunk / V;  // pieces in a chunk row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_a = reinterpret_cast<float*>(smem_raw);               // values
  TG* s_g = reinterpret_cast<TG*>(s_a + 2 * kChunk * kAStride);  // G rows
  uint4* item_words = reinterpret_cast<uint4*>(s_g + 2 * kChunk * kTN);
  int* pairs = reinterpret_cast<int*>(item_words + kItemCap);  // tiles
  int* item_tile = pairs + kPairCap;       // a live item's tile
  int* item_k0 = item_tile + kItemCap;     // its first tile row
  int* item_grow = item_k0 + kItemCap;     // and the G row under it
  __shared__ int s_warp[kThreads / 32];

  const int cb = blockIdx.x / cc_n;
  const int strip = blockIdx.x % cc_n;
  const int c0 = strip * kChunk;  // first tile column = first output row
  const int j0 = blockIdx.y * kTN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n = n_rb * n_slots;
  const int words_per_tile = kc_n * cc_n * 4;

  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[m][k] = 0.0f;

  for (int i0 = 0; i0 < n; i0 += kPairCap) {
    // the live tiles of column block cb among candidates i0.. (i = s * n_rb
    // + rb), in order: a thread takes kCandidates consecutive ones
    // (every load issued before any is used)
    int cand[kCandidates], cols[kCandidates], lives[kCandidates];
#pragma unroll
    for (int j = 0; j < kCandidates; ++j) {
      const int i = i0 + tid * kCandidates + j;
      cand[j] = i < n ? (i % n_rb) * n_slots + i / n_rb : 0;
      cols[j] = colidx[cand[j]];
      lives[j] = live[cand[j]];
    }
    int hit_bits = 0;
#pragma unroll
    for (int j = 0; j < kCandidates; ++j) {
      if (i0 + tid * kCandidates + j < n && lives[j] &&
          clamp_cb(cols[j], n_cb) == cb)
        hit_bits |= 1 << j;
    }
    int n_pairs;
    int at = cta_exclusive_sum(__popc(hit_bits), s_warp, n_pairs);
#pragma unroll
    for (int j = 0; j < kCandidates; ++j)
      if ((hit_bits >> j) & 1) pairs[at++] = cand[j];
    __syncthreads();

    // their chunks with a live step in this strip, in order, with the
    // strip's four column-group words
    const int n_cand = n_pairs * kc_n;
    for (int it0 = 0; it0 < n_cand; it0 += kItemCap) {
      uint4 w[kItemsPerThread];
#pragma unroll
      for (int j = 0; j < kItemsPerThread; ++j) {
        const int it = min(it0 + tid * kItemsPerThread + j, n_cand - 1);
        w[j] = *reinterpret_cast<const uint4*>(
            rowbits + static_cast<size_t>(pairs[it / kc_n]) * words_per_tile +
            ((it % kc_n) * cc_n + strip) * 4);
      }
      int hits = 0;
#pragma unroll
      for (int j = 0; j < kItemsPerThread; ++j) {
        if (it0 + tid * kItemsPerThread + j < n_cand &&
            (w[j].x | w[j].y | w[j].z | w[j].w) != 0u)
          hits |= 1 << j;
      }
      int n_live;
      int pos = cta_exclusive_sum(__popc(hits), s_warp, n_live);
#pragma unroll
      for (int j = 0; j < kItemsPerThread; ++j) {
        if ((hits >> j) & 1) {
          const int it = it0 + tid * kItemsPerThread + j;
          const int t = pairs[it / kc_n], k0 = (it % kc_n) * kChunk;
          item_tile[pos] = t;
          item_k0[pos] = k0;
          item_grow[pos] = (t / n_slots) * bm + k0;
          item_words[pos++] = w[j];
        }
      }
      __syncthreads();

      auto load_tile = [&](int l, uint4(&raw)[chunk_pieces<TA>()]) {
        const TA* tile = tiles + static_cast<size_t>(item_tile[l]) * bm * bn;
        const int k0 = item_k0[l];
#pragma unroll
        for (int q = 0; q < chunk_pieces<TA>(); ++q) {
          const int e = tid + q * kThreads;
          const int r = e / P, col = (e % P) * V;
          const int valid = k0 + r < bm ? min(V, bn - c0 - col) : 0;
          raw[q] = load_piece<TA, kVec>(
              valid > 0 ? tile + static_cast<size_t>(k0 + r) * bn + c0 + col
                        : tiles,
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
          for (int k = 0; k < V; k += 4)
            *reinterpret_cast<float4*>(a + r * kAStride + col + k) =
                make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
        }
      };
      auto stage_rows = [&](int l, TG* gs) {
        const uint4 wl = item_words[l];
        stage_operand_rows<TG, kVec>(
            gs, g + static_cast<size_t>(item_grow[l]) * d + j0,
            static_cast<size_t>(d), rows_to_stage(wl.x, wl.y, wl.z, wl.w),
            bm - item_k0[l], d - j0, g);
      };
      auto word = [&](int l) {
        const uint4 wl = item_words[l];
        return warp == 0 ? wl.x : warp == 1 ? wl.y : warp == 2 ? wl.z : wl.w;
      };
      walk_chunks<TA, TG>(acc, s_a, s_g, 0, n_live,
                          [](int l) { return l; }, load_tile, store_tile,
                          stage_rows, word);
      __syncthreads();  // the items are read before the next round's
    }
  }

  store_acc(acc, out + (static_cast<size_t>(cb) * bn + c0) * d,
            min(kChunk, bn - c0), j0, d);
}

template <typename TA, typename TG, bool kVec>
int launch(const void* tiles, const void* colidx, const void* g, void* out,
           void* work, int n_rb, int n_slots, int bm, int bn, int n_cb, int d,
           cudaStream_t stream) {
  const int n_t = n_rb * n_slots;
  const int kc_n = (bm + kChunk - 1) / kChunk;
  const int cc_n = (bn + kChunk - 1) / kChunk;
  const int words_per_tile = kc_n * cc_n * 4;
  if (words_per_tile > kScanWords)
    return static_cast<int>(cudaErrorInvalidValue);
  uint32_t* rowbits = static_cast<uint32_t*>(work);
  uint8_t* live = reinterpret_cast<uint8_t*>(
      rowbits + static_cast<size_t>(n_t) * words_per_tile);
  const TA* tl = static_cast<const TA*>(tiles);
  if (n_t > 0) {
    // consecutive tiles a scan CTA streams: about kScanBytes, as many as
    // its shared words hold
    const size_t tile_bytes = static_cast<size_t>(bm) * bn * sizeof(TA);
    int run = static_cast<int>(kScanBytes / tile_bytes);
    if (run > kScanWords / words_per_tile) run = kScanWords / words_per_tile;
    if (run < 1) run = 1;
    const size_t scan_smem =
        static_cast<size_t>(run) * (words_per_tile + 1) * sizeof(uint32_t);
    dx_scan_kernel<TA, kVec><<<(n_t + run - 1) / run, kScanThreads,
                               scan_smem, stream>>>(
        tl, rowbits, live, n_t, bm, bn, cc_n, words_per_tile, run);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  constexpr size_t smem = product_smem_bytes<TG>();
  auto kernel = dx_product_kernel<TA, TG, kVec>;
  static bool opted_in = false;
  const cudaError_t e = opt_in(kernel, smem, opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_cb * cc_n, (d + kTN - 1) / kTN);
  kernel<<<grid, kThreads, smem, stream>>>(
      tl, static_cast<const int*>(colidx), static_cast<const TG*>(g), rowbits,
      live, static_cast<TG*>(out), n_rb, n_slots, bm, bn, n_cb, d, kc_n,
      cc_n);
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
// and out. work holds 16 * T * chunks + T bytes (T = n_rb * n_slots tiles,
// chunks = ceil(bm / 32) * ceil(bn / 32) <= 1024), 16-byte aligned. Returns
// the first failing call's cudaError_t (0 on success;
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
