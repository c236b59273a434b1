// Flash-attention backward for Hopper, sm_90a: dq, dk and dv of the
// grouped-query attention of flash_attention.cu, from the forward's out and
// lse, causal and/or sliding-window masks, deterministic.
//
// Replaces no TPU kernel: the reference's backward is plain jnp
// (`_flash_bwd` in src/repro/models/layers.py, reached from `_fa_bwd` in
// src/repro/kernels/ops.py), and this computes what it computes:
//
//   D     = sum_d dout . out                    float32, per query row
//   p     = exp(s * scale - lse)  where allowed, else 0 (s = q . k, f32)
//   dv    = sum over q and the group's g q heads of  bf(p)^T . dout
//   dp    = dout . v^T
//   ds    = p * (dp - D) * scale
//   dq    = bf(ds) . k,     dk = sum over q and g of  bf(ds)^T . q
//
// with bf() the rounding to the input type (a no-op in float32) and float32
// accumulation; q, out, dout, dq (B, Sq, H, hd), k, v, dk, dv (B, T, KV,
// hd), lse (B, H, Sq) float32; q head h reads kv head h / (H / KV).
//
// What bounds it on the H100: operations. At (4, 2048, 32/4, 64) bf16,
// causal, the function's five products are 172 GFLOP, 0.17 ms at 989
// TFLOP/s, against 0.08 GB of inputs and outputs (0.02 ms at 3.35 TB/s);
// in float32 at (2, 2048) 86 GFLOP, 1.28 ms at 67 TFLOP/s.
//
// The plan (chosen by the wrapper, flash_attention.bwd_plan, in Python):
// two kernels, or three, in stream order, and no float atomics, so two
// calls give the same bits.
//   dq:     one CTA per (batch row, q head, 64 query rows), heaviest first,
//           loops over the key blocks that the mask lets those rows see,
//           recomputing p and dp; it computes D for its rows first and
//           writes (lse * log2 e, D) to `stats`, (B * H, sq_pad) float2
//           with sq_pad = Sq rounded up to 64.
//   dk/dv:  one CTA per unit = (batch row, kv head, key blocks of 64, a
//           share of the group's q heads). Under a causal mask (and no
//           window) a unit pairs key blocks j and n - 1 - j, so every unit
//           walks n + 1 query blocks a head and none waits on the heaviest.
//           With a query offset (query row i at position q_offset + i, the
//           reference's q chunks and a sequence shard's rows) the visible
//           rectangle is no square triangle: the key blocks every row sees
//           whole run one a unit, those the diagonal crosses are paired
//           among themselves (bwd_plan's pair_lo .. pair_hi), and the
//           blocks past the last row's position get no unit: their dk and
//           dv rows are set to zero (a memset), their keys never loaded.
//           The group's g q heads may be split over `split` units: each
//           then sums dk and dv over its g / split heads and writes float32
//           partials to `part` (2 x split x B x T x KV x hd floats, dk's
//           then dv's), and
//   reduce: sums the partials in the order 0 .. split - 1 into dk and dv.
// s and dp are computed in both kernels (seven products where a kernel with
// atomics on dq would do five): the price of writing every output once.
//
// bfloat16 (flash_bwd_*_wgmma_kernel): one warpgroup a CTA, every product
// on wgmma (wgmma.cuh) with float32 accumulation. The CTA's own rows (64
// keys of K and V in dk/dv, 64 rows of q and dout in dq) are loaded once
// into registers as the A operands of s and dp; the other side (q and
// dout in dk/dv, K and V in dq) streams through a ring of three stages (two
// at hd 128 in dq) that TMA fills -- tensor maps of the (B, S, heads, hd)
// arrays, rows past the end read as zeros, dk/dv's stages also carrying
// their rows' stats -- and mbarriers complete; thread 0 refills a stage as
// soon as the warpgroup has read it. Those bytes are the K-major B operand
// of s and dp and the MN-major B operand of the products that contract
// over their rows (dv += p^T . dout, dk += ds^T . q, dq += ds . k): no
// transposed copy is staged, and only B is read from shared memory. p and
// ds are computed from the accumulators in registers and packed to bf16 as
// the register A operands of those products -- the rounding that the
// reference applies -- each while the next product runs: p while dp is
// multiplied, ds while dv is. At hd 128 the dk/dv kernel takes query blocks
// of 32, so that dk, dv, s, dp and K and V's fragments fit the registers.
// At hd 80 (zamba2's shared attention) the 160-byte row has no swizzle of
// its own: every tile is five 16-column panels of 32-byte rows
// (wgmma.cuh's Tile<80, R>), five TMA boxes a tile, so that one descriptor
// spans the row, the products over hd take their five k-steps a panel
// each, and those whose N is hd run as one m64n80 wgmma; the dk/dv kernel
// keeps 64-query blocks there (246 registers, no spill, no serialized
// wgmma in ptxas's report).
//
// float32 (flash_bwd_*_f32_kernel): on the float32 CUDA cores, never
// through TF32. The CTA's own tile (64 rows) stays in shared memory; the
// other side streams 32 rows a step (16 in dk/dv at hd 128, for the
// registers), double-buffered with cp.async (16 bytes a thread, zero-filled
// past the end) while the previous block computes; rows are padded by 16
// bytes. Each thread owns a 4 x 4 tile of s and dp (float4 loads along
// hd), writes p and ds transposed to shared memory, and owns an 8 x hd/16
// tile of dk and dv (or of dq) for the products over the streamed rows (at
// hd 80 five columns, read and written one float at a time; 234 registers
// in dk/dv at 32 rows a step, no spill).
// The staging, the 8 x hd/16 product and the mask's block ranges are in
// flash_tiles.cuh, shared with the forward's float32 route.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"
#include "flash_tiles.cuh"
#include "mma_fragments.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kTile = 64;      // rows a CTA owns: keys (dk/dv), queries (dq)
constexpr int kThreads = 128;  // one warpgroup
constexpr int kOther = 32;     // keys the f32 dq kernel streams a step
constexpr float kLog2e = 1.4426950408889634f;

// the query blocks (of qb rows, row i at position qo + i) that can see
// keys [k0, k0 + kn)
__device__ __forceinline__ void query_blocks(int k0, int kn, int sq, int qb,
                                             int causal, int use_window,
                                             int window, int qo, int& begin,
                                             int& end) {
  end = (sq + qb - 1) / qb;
  begin = causal ? max(k0 - qo, 0) / qb : 0;  // positions >= the first key
  if (causal && k0 - qo >= sq) end = 0;       // past the last row
  if (use_window) {  // positions < the last key + window
    const long long last =
        static_cast<long long>(k0) + kn + window - 2 - qo;
    end = last < 0 ? 0 : min(static_cast<long long>(end), last / qb + 1);
  }
  if (end < begin) end = begin;
}

// The dk/dv units of one (batch row, kv head, share): key blocks [0,
// pair_lo) one a unit, blocks [pair_lo, pair_hi) paired j with pair_lo +
// pair_hi - 1 - j (under a causal mask their work falls along the
// diagonal, so every pair walks about the same number of query blocks);
// without pairing pair_lo = pair_hi = the key blocks. Blocks from pair_hi
// on (past the last query's position under a causal mask) get no unit:
// the launch sets their dk and dv rows to zero, without a load.
__host__ __device__ __forceinline__ int units_per_head(int pair_lo,
                                                      int pair_hi) {
  return pair_lo + (pair_hi - pair_lo + 1) / 2;
}

// A dk/dv unit: blockIdx.x = ((b * kv + kv head) * split + share) * n_units
// + u; its key blocks as units_per_head lays them out; its q heads the
// share-th g / split of the group; its steps (key block, q head, query
// block) in that order, the query blocks of each key block those that see
// it (none for a key block that no row of a window sees: its dk and dv
// are written as zeros, without a load).
struct Unit {
  int b, kvh, share, head0, heads;  // q heads head0 .. head0 + heads - 1
  int n_blocks, kb0, kb1, qbb0, qbe0, qbb1, qbe1, steps0, steps1, total;

  __device__ Unit(int pair_lo, int pair_hi, int split, int kv, int h,
                  int sq, int qb, int causal, int use_window, int window,
                  int qo) {
    const int n_pairs = (pair_hi - pair_lo + 1) / 2;
    const int n_units = units_per_head(pair_lo, pair_hi);
    const int u = blockIdx.x % n_units;
    int r = blockIdx.x / n_units;
    share = r % split;
    r /= split;
    kvh = r % kv;
    b = r / kv;
    heads = h / kv / split;
    head0 = kvh * (h / kv) + share * heads;
    kb0 = u;
    kb1 = u < pair_lo ? u : pair_hi - 1 - (u - pair_lo);
    n_blocks = kb1 != kb0 ? 2 : 1;
    query_blocks(kb0 * kTile, kTile, sq, qb, causal, use_window, window, qo,
                 qbb0, qbe0);
    query_blocks(kb1 * kTile, kTile, sq, qb, causal, use_window, window, qo,
                 qbb1, qbe1);
    steps0 = heads * (qbe0 - qbb0);
    steps1 = n_blocks == 2 ? heads * (qbe1 - qbb1) : 0;
    total = steps0 + steps1;
  }
  __device__ int kb(int c) const { return c ? kb1 : kb0; }
  __device__ int qb_begin(int c) const { return c ? qbb1 : qbb0; }
  __device__ int n_qb(int c) const { return c ? qbe1 - qbb1 : qbe0 - qbb0; }
  __device__ int steps(int c) const { return c ? steps1 : steps0; }
  // flat step i -> (q head, first query row)
  __device__ void step(int i, int qb, int& head, int& q0) const {
    const int c = i >= steps0 ? 1 : 0;
    const int f = c ? i - steps0 : i;
    head = head0 + f / n_qb(c);
    q0 = (qb_begin(c) + f % n_qb(c)) * qb;
  }
};

// ---------------------------------------------------------------------------
// bfloat16 route: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

// the register A operand of an m64nNk16 product over hd: rows row_a and
// row_a + 8 (this lane's rows of the warpgroup's 64) of one head of a (.., S,
// heads, hd) bf16 array (`src` at the head's first element, rows `stride`
// elements apart), every k-step; rows >= limit read as zeros
template <int HD>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[HD / 16][4],
                                            const bf16* src, size_t stride,
                                            int row_a, int limit, int lane) {
  const int c = (lane & 3) * 2;
  const bool ok_a = row_a < limit, ok_b = row_a + 8 < limit;
  const uint32_t* ra = reinterpret_cast<const uint32_t*>(
      src + static_cast<size_t>(ok_a ? row_a : 0) * stride + c);
  const uint32_t* rb = reinterpret_cast<const uint32_t*>(
      src + static_cast<size_t>(ok_b ? row_a + 8 : 0) * stride + c);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    a[kk][0] = ok_a ? ra[8 * kk] : 0u;
    a[kk][1] = ok_b ? rb[8 * kk] : 0u;
    a[kk][2] = ok_a ? ra[8 * kk + 4] : 0u;
    a[kk][3] = ok_b ? rb[8 * kk + 4] : 0u;
  }
}

// the accumulator of an m64nN product (N = 16 R) as the bf16 A operand of
// R k-steps over its columns
template <int R>
__device__ __forceinline__ void pack_rows(uint32_t (&a)[R][4],
                                          const float (&d)[8 * R]) {
#pragma unroll
  for (int kk = 0; kk < R; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// shared memory of the dq kernel, bytes from a 1024-byte boundary: the K/V
// ring, then lse and D of the CTA's 64 rows
template <int HD>
struct DqLayout {
  using T = Tile<HD, kTile>;
  static constexpr int kStages = HD == 128 ? 2 : 3;
  static constexpr int kStage = 2 * T::kBytes;  // K, V
  static constexpr int kStats = kStages * kStage;
  static constexpr int kBytes = kStats + 2 * kTile * 4 + 1024;  // + align
};

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const bf16* __restrict__ q,
    const bf16* __restrict__ out, const bf16* __restrict__ dout,
    const float* __restrict__ lse, float2* __restrict__ stats,
    bf16* __restrict__ dq, int sq, int sq_pad, int t, int h, int kv,
    int causal, int use_window, int window, int qo, float scale) {
  using T = Tile<HD, kTile>;
  using L = DqLayout<HD>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kStages];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* lse_s = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kStats);
  float* d_s = lse_s + kTile;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int head = blockIdx.x % h;
  const int b = blockIdx.x / h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest first
  const int kvh = head / (h / kv);
  int kb_begin, kb_end;
  key_blocks(q0, kTile, kTile, sq, t, causal, use_window, window, qo,
             kb_begin, kb_end);
  const int n = kb_end - kb_begin;
  const uint32_t bar0 = smem_addr(&bars[0]);

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bar0 + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto load_kv = [&](int i) {  // ring entry i: key block kb_begin + i
    const int st = i % kStages;
    const uint32_t dst = base + st * L::kStage;
    const uint32_t bar = bar0 + 8 * st;
    const int k0 = (kb_begin + i) * kTile;
    mbar_expect(bar, 2 * T::kBytes);
    for (int p = 0; p < T::kPanels; ++p) {
      tma_load_4d(dst + p * T::kPanelBytes, &tm_k, bar, p * T::kBoxCols, kvh,
                  k0, b);
      tma_load_4d(dst + T::kBytes + p * T::kPanelBytes, &tm_v, bar,
                  p * T::kBoxCols, kvh, k0, b);
    }
  };
  if (tid == 0)
    for (int i = 0; i < kStages && i < n; ++i) load_kv(i);

  // q and dout of this lane's rows as the A operands of s and dp
  const size_t q_head = (static_cast<size_t>(b) * sq * h + head) * HD;
  const int ra = warp * 16 + (lane >> 2);  // this lane's rows: ra, ra + 8
  const int row_a = q0 + ra, row_b = row_a + 8;
  uint32_t qf[HD / 16][4], df[HD / 16][4];
  load_a_rows<HD>(qf, q + q_head, static_cast<size_t>(h) * HD, row_a, sq,
                  lane);
  load_a_rows<HD>(df, dout + q_head, static_cast<size_t>(h) * HD, row_a, sq,
                  lane);

  // D = sum(dout * out) and lse * log2 e of the 64 rows, two threads a row,
  // written for the dk/dv kernel (rows past sq: zeros)
  {
    const int r = tid >> 1, half = tid & 1;
    const int row = q0 + r;
    float acc = 0.0f;
    if (row < sq) {
      const size_t off =
          q_head + static_cast<size_t>(row) * h * HD + half * (HD / 2);
#pragma unroll
      for (int c = 0; c < HD / 2; c += 8) {
        const uint4 a = *reinterpret_cast<const uint4*>(dout + off + c);
        const uint4 o = *reinterpret_cast<const uint4*>(out + off + c);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fa = __bfloat1622float2(a2[e]);
          const float2 fo = __bfloat1622float2(o2[e]);
          acc = fmaf(fa.x, fo.x, acc);
          acc = fmaf(fa.y, fo.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    const float l2 =
        row < sq ? lse[(static_cast<size_t>(b) * h + head) * sq + row] * kLog2e
                 : 0.0f;
    if (half == 0) {
      lse_s[r] = l2;
      d_s[r] = acc;
      stats[(static_cast<size_t>(b) * h + head) * sq_pad + row] =
          make_float2(l2, acc);
    }
  }
  __syncthreads();

  const float lse_a = lse_s[ra], lse_b = lse_s[ra + 8];
  const float d_a = d_s[ra], d_b = d_s[ra + 8];
  const float scale_log2 = scale * kLog2e;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;

  for (int i = 0; i < n; ++i) {
    const int st = i % kStages;
    const uint32_t ks = base + st * L::kStage;
    const uint32_t vs = ks + T::kBytes;
    const int k0 = (kb_begin + i) * kTile;
    mbar_wait(bar0 + 8 * st, (i / kStages) & 1);
    // s = q . k^T and dp = dout . v^T, 64 rows x 64 keys, in two groups
    float s[kTile / 2], dp[kTile / 2];
#pragma unroll
    for (int e = 0; e < kTile / 2; ++e) s[e] = dp[e] = 0.0f;
    own(s);
    own(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      Wgmma<kTile>::rs<0>(s, qf[kk], T::k_major(ks, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      Wgmma<kTile>::rs<0>(dp, df[kk], T::k_major(vs, kk), kk > 0);
    wgmma_commit();
    // p, while dp is computed
    wgmma_wait<1>();
    own(s);
    const bool full = all_visible(q0, kTile, k0, kTile, sq, t, causal,
                                  use_window, window, qo);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * j + e;
        const bool hi = e >= 2;
        const int key = k0 + 8 * j + (lane & 3) * 2 + (e & 1);
        const bool ok = full || allowed(hi ? row_b : row_a, key, sq, t,
                                        causal, use_window, window, qo);
        s[idx] = ok ? fast_exp2(fmaf(s[idx], scale_log2,
                                     -(hi ? lse_b : lse_a)))
                    : 0.0f;
      }
    // ds = p * (dp - D) * scale, in place of s
    wgmma_wait<0>();
    own(dp);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = 4 * j + e;
        s[idx] = s[idx] * (dp[idx] - (e >= 2 ? d_b : d_a)) * scale;
      }
    // dq += bf(ds) . k, k read MN-major
    uint32_t a[kTile / 16][4];
    pack_rows<kTile / 16>(a, s);
    own(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      Wgmma<HD>::template rs<1>(acc, a[kk], T::mn_major(ks, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    own(acc);
    own(a);
    __syncthreads();  // every warp is done with the stage
    if (tid == 0 && i + kStages < n) load_kv(i + kStages);
  }
  own(qf);
  own(df);

  const int rows[2] = {row_a, row_b};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= sq) continue;
    bf16* orow = dq + q_head + static_cast<size_t>(rows[r]) * h * HD +
                 (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// query rows a step of the bf16 dk/dv kernel: fewer at hd 128, where dk,
// dv and K and V's fragments take 192 registers a thread (ptxas then
// serializes the wgmma chain; 16 rows measured slower still)
template <int HD>
__host__ __device__ constexpr int dkdv_q_block() {
  return HD == 128 ? 32 : 64;
}

// shared memory of the dk/dv kernel: the q/dout ring, each stage q, dout,
// then (lse * log2 e, D) of its QB rows
template <int HD>
struct DkdvLayout {
  static constexpr int QB = dkdv_q_block<HD>();
  using TQ = Tile<HD, QB>;
  static constexpr int kStages = 3;
  static constexpr int kStats = 2 * TQ::kBytes;
  static constexpr int kStage = 2 * TQ::kBytes + 1024;
  static constexpr int kBytes = kStages * kStage + 1024;  // + align
};

// dk and dv (or the unit's float32 partials) of keys key_a and key_a + 8,
// from the accumulators of an m64nHD product
template <int HD>
__device__ __forceinline__ void store_kv_rows(
    const float (&dka)[HD / 2], const float (&dva)[HD / 2], int key_a,
    int lane, int t, size_t row0, int row_step, bf16* dk, bf16* dv,
    float* pk, float* pv) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    if (key >= t) continue;
    const size_t off =
        row0 + static_cast<size_t>(key) * row_step + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int e = 4 * j + 2 * r;
      if (pk != nullptr) {
        *reinterpret_cast<float2*>(pk + off + 8 * j) =
            make_float2(dka[e], dka[e + 1]);
        *reinterpret_cast<float2*>(pv + off + 8 * j) =
            make_float2(dva[e], dva[e + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
            __floats2bfloat162_rn(dka[e], dka[e + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
            __floats2bfloat162_rn(dva[e], dva[e + 1]);
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_dout,
    const __grid_constant__ CUtensorMap tm_stats, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ part, int nb, int sq, int t, int h, int kv,
    int pair_lo, int pair_hi, int split, int causal, int use_window,
    int window, int qo, float scale) {
  using L = DkdvLayout<HD>;
  using TQ = typename L::TQ;
  constexpr int QB = L::QB;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kStages];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Unit unit(pair_lo, pair_hi, split, kv, h, sq, QB, causal,
                  use_window, window, qo);
  const int b = unit.b, kvh = unit.kvh;
  const uint32_t bar0 = smem_addr(&bars[0]);

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bar0 + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto load_q = [&](int i) {  // ring entry i: flat step i
    int head, q0;
    unit.step(i, QB, head, q0);
    const int st = i % kStages;
    const uint32_t dst = base + st * L::kStage;
    const uint32_t bar = bar0 + 8 * st;
    mbar_expect(bar, 2 * TQ::kBytes + QB * 8);
    for (int p = 0; p < TQ::kPanels; ++p) {
      tma_load_4d(dst + p * TQ::kPanelBytes, &tm_q, bar, p * TQ::kBoxCols,
                  head, q0, b);
      tma_load_4d(dst + TQ::kBytes + p * TQ::kPanelBytes, &tm_dout, bar,
                  p * TQ::kBoxCols, head, q0, b);
    }
    tma_load_2d(dst + L::kStats, &tm_stats, bar, 2 * q0, b * h + head);
  };
  if (tid == 0)
    for (int i = 0; i < kStages && i < unit.total; ++i) load_q(i);

  const float scale_log2 = scale * kLog2e;
  const size_t kv_head = (static_cast<size_t>(b) * t * kv + kvh) * HD;
  const size_t plane = static_cast<size_t>(nb) * t * kv * HD;
  float* pk = split > 1 ? part + unit.share * plane : nullptr;
  float* pv = split > 1 ? part + (split + unit.share) * plane : nullptr;
  // step i's dv and dk products run on while step i + 1's s^T and dp^T
  // are issued; the stage they read is refilled once they are done
  uint32_t pf[QB / 16][4], sf[QB / 16][4];
  int i = 0;  // flat step
  for (int c = 0; c < unit.n_blocks; ++c) {
    const int k0 = unit.kb(c) * kTile;
    const int key_a = k0 + warp * 16 + (lane >> 2);  // and key_a + 8
    const int nq = unit.n_qb(c);
    // K and V of this lane's keys as the A operands of s^T and dp^T (a key
    // block that no query sees is not loaded: its dk and dv are zeros)
    uint32_t kf[HD / 16][4], vf[HD / 16][4];
    const int limit = nq > 0 ? t : 0;
    load_a_rows<HD>(kf, k + kv_head, static_cast<size_t>(kv) * HD, key_a,
                    limit, lane);
    load_a_rows<HD>(vf, v + kv_head, static_cast<size_t>(kv) * HD, key_a,
                    limit, lane);
    float dka[HD / 2], dva[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) dka[e] = dva[e] = 0.0f;
    for (int s = 0; s < unit.steps(c); ++s, ++i) {
      const int q0 = (unit.qb_begin(c) + s % nq) * QB;
      const int st = i % kStages;
      const uint32_t qs = base + st * L::kStage;
      const uint32_t dos = qs + TQ::kBytes;
      const float* stat = reinterpret_cast<const float*>(
          smem_raw + (qs - raw) + L::kStats);
      mbar_wait(bar0 + 8 * st, (i / kStages) & 1);
      // s^T = k . q^T and dp^T = v . dout^T, 64 keys x QB queries
      float sa[QB / 2], dpa[QB / 2];
#pragma unroll
      for (int e = 0; e < QB / 2; ++e) sa[e] = dpa[e] = 0.0f;
      own(sa);
      own(dpa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<QB>::template rs<0>(sa, kf[kk], TQ::k_major(qs, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<QB>::template rs<0>(dpa, vf[kk], TQ::k_major(dos, kk), kk > 0);
      wgmma_commit();
      if (i > 0) {  // step i - 1's dv and dk products, then its stage
        wgmma_wait<2>();
        own(dva);
        own(dka);
        own(pf);
        own(sf);
        __syncthreads();  // every warp is done with the stage
        if (tid == 0 && i - 1 + kStages < unit.total)
          load_q(i - 1 + kStages);
      }
      // p^T in place of s^T, while dp^T is computed
      wgmma_wait<1>();
      own(sa);
      const bool full = all_visible(q0, QB, k0, kTile, sq, t, causal,
                                    use_window, window, qo);
#pragma unroll
      for (int j = 0; j < QB / 8; ++j) {
        const int col = 8 * j + (lane & 3) * 2;
        const float4 sv = *reinterpret_cast<const float4*>(stat + 2 * col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 4 * j + e;
          const bool odd = e & 1;
          const bool ok =
              full || allowed(q0 + col + odd, key_a + (e >= 2 ? 8 : 0), sq,
                              t, causal, use_window, window, qo);
          sa[idx] = ok ? fast_exp2(fmaf(sa[idx], scale_log2,
                                        -(odd ? sv.z : sv.x)))
                       : 0.0f;
        }
      }
      // dv += bf(p)^T . dout, dout read MN-major, while ds^T is computed
      pack_rows<QB / 16>(pf, sa);
      own(dva);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QB / 16; ++kk)
        Wgmma<HD>::template rs<1>(dva, pf[kk], TQ::mn_major(dos, kk), 1);
      wgmma_commit();
      wgmma_wait<1>();  // dp^T
      own(dpa);
#pragma unroll
      for (int j = 0; j < QB / 8; ++j) {
        const int col = 8 * j + (lane & 3) * 2;
        const float4 sv = *reinterpret_cast<const float4*>(stat + 2 * col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 4 * j + e;
          dpa[idx] = sa[idx] * (dpa[idx] - (e & 1 ? sv.w : sv.y)) * scale;
        }
      }
      // dk += bf(ds)^T . q, q read MN-major
      pack_rows<QB / 16>(sf, dpa);
      own(dka);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QB / 16; ++kk)
        Wgmma<HD>::template rs<1>(dka, sf[kk], TQ::mn_major(qs, kk), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    own(dva);
    own(dka);
    own(pf);
    own(sf);
    own(kf);
    own(vf);
    store_kv_rows<HD>(dka, dva, key_a, lane, t, kv_head, kv * HD, dk, dv, pk,
                      pv);
  }
}

// ---------------------------------------------------------------------------
// float32 route: register tiles on the CUDA cores
// ---------------------------------------------------------------------------

// a[i][j] = own_a[og + 16 i] . other_a[xg + 8 j] and the same for b: two
// (64 own x OT other) products over hd, a 4 x OT/8 tile a thread (the
// backward's own: a row's scores spread over the CTA's four warps)
template <int HD, int OT>
__device__ __forceinline__ void nt_products(float (&a)[4][OT / 8],
                                            float (&b)[4][OT / 8],
                                            const float* own_a,
                                            const float* other_a,
                                            const float* own_b,
                                            const float* other_b, int og,
                                            int xg) {
  constexpr int LD = HD + 4;
  constexpr int kUnroll = HD == 128 ? 1 : 2;  // registers at hd 128
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OT / 8; ++j) a[i][j] = b[i][j] = 0.0f;
#pragma unroll (kUnroll)
  for (int d = 0; d < HD; d += 4) {
    float4 o[4], x[OT / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = ld4(own_a + (og + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < OT / 8; ++j)
      x[j] = ld4(other_a + (xg + 8 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < OT / 8; ++j) {
        a[i][j] = fmaf(o[i].x, x[j].x, a[i][j]);
        a[i][j] = fmaf(o[i].y, x[j].y, a[i][j]);
        a[i][j] = fmaf(o[i].z, x[j].z, a[i][j]);
        a[i][j] = fmaf(o[i].w, x[j].w, a[i][j]);
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = ld4(own_b + (og + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < OT / 8; ++j)
      x[j] = ld4(other_b + (xg + 8 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < OT / 8; ++j) {
        b[i][j] = fmaf(o[i].x, x[j].x, b[i][j]);
        b[i][j] = fmaf(o[i].y, x[j].y, b[i][j]);
        b[i][j] = fmaf(o[i].z, x[j].z, b[i][j]);
        b[i][j] = fmaf(o[i].w, x[j].w, b[i][j]);
      }
  }
}

template <int HD>
__host__ __device__ constexpr size_t dq_f32_smem_bytes() {
  // q and dout tiles; K and V double-buffered; ds^T; lse and D of the rows
  return (static_cast<size_t>(2 * kTile) * (HD + 4) +
          static_cast<size_t>(4 * kOther) * (HD + 4) + kOther * kXLd +
          2 * kTile) *
         sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ out,
    const float* __restrict__ lse, const float* __restrict__ dout,
    float2* __restrict__ stats, float* __restrict__ dq, int sq, int sq_pad,
    int t, int h, int kv, int causal, int use_window, int window, int qo,
    float scale) {
  constexpr int LD = HD + 4, DPT = HD / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kTile][LD]
  float* dos = qs + kTile * LD;                 // [kTile][LD]
  float* kvbuf = dos + kTile * LD;              // [2][K, V: kOther][LD]
  float* dst = kvbuf + 4 * kOther * LD;         // ds^T [kOther][kXLd]
  float* lse_s = dst + kOther * kXLd;           // [kTile]
  float* d_s = lse_s + kTile;                   // [kTile]

  const int tid = threadIdx.x;
  const int head = blockIdx.x % h;
  const int b = blockIdx.x / h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest first
  const int kvh = head / (h / kv);
  const size_t q_head = (static_cast<size_t>(b) * sq * h + head) * HD;
  const size_t kv_head = (static_cast<size_t>(b) * t * kv + kvh) * HD;
  int kb_begin, kb_end;
  key_blocks(q0, kTile, kOther, sq, t, causal, use_window, window, qo,
             kb_begin, kb_end);
  const int n = kb_end - kb_begin;
  auto load_kv = [&](int i, int buf) {
    float* kb = kvbuf + buf * 2 * kOther * LD;
    const int k0 = (kb_begin + i) * kOther;
    stage_rows<HD>(kb, k + kv_head, static_cast<size_t>(kv) * HD, k0, kOther,
                   t, tid);
    stage_rows<HD>(kb + kOther * LD, v + kv_head,
                   static_cast<size_t>(kv) * HD, k0, kOther, t, tid);
  };
  stage_rows<HD>(qs, q + q_head, static_cast<size_t>(h) * HD, q0, kTile, sq,
                 tid);
  stage_rows<HD>(dos, dout + q_head, static_cast<size_t>(h) * HD, q0, kTile,
                 sq, tid);
  if (n > 0) load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // D = sum(dout * out) and lse * log2 e of the 64 rows, two threads a row
  {
    const int r = tid >> 1, half = tid & 1;
    const int row = q0 + r;
    float acc = 0.0f;
    if (row < sq) {
      const float* orow =
          out + q_head + static_cast<size_t>(row) * h * HD + half * (HD / 2);
      const float* drow = dos + r * LD + half * (HD / 2);
#pragma unroll
      for (int c = 0; c < HD / 2; c += 4) {
        const float4 o = *reinterpret_cast<const float4*>(orow + c);
        const float4 g = ld4(drow + c);
        acc = fmaf(g.x, o.x, acc);
        acc = fmaf(g.y, o.y, acc);
        acc = fmaf(g.z, o.z, acc);
        acc = fmaf(g.w, o.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    const float l2 =
        row < sq ? lse[(static_cast<size_t>(b) * h + head) * sq + row] * kLog2e
                 : 0.0f;
    if (half == 0) {
      lse_s[r] = l2;
      d_s[r] = acc;
      stats[(static_cast<size_t>(b) * h + head) * sq_pad + row] =
          make_float2(l2, acc);
    }
  }
  __syncthreads();

  const int og = tid % 16, xg = tid / 16;  // s: rows og + 16 i, keys xg + 8 j
  const int kg = tid / 16, dg = tid % 16;  // dq: rows 8 kg + i, cols DPT dg
  float l2[4], dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l2[i] = lse_s[og + 16 * i];
    dd[i] = d_s[og + 16 * i];
  }
  const float scale_log2 = scale * kLog2e;
  float acc[8][DPT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.0f;

  for (int i = 0; i < n; ++i) {
    const int buf = i & 1;
    if (i + 1 < n) load_kv(i + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // block i
    __syncthreads();
    const float* kb = kvbuf + buf * 2 * kOther * LD;
    const float* vb = kb + kOther * LD;
    const int k0 = (kb_begin + i) * kOther;
    float s[4][4], dp[4][4];
    nt_products<HD, kOther>(s, dp, qs, kb, dos, vb, og, xg);
    const bool full = all_visible(q0, kTile, k0, kOther, sq, t, causal,
                                  use_window, window, qo);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + og + 16 * a, key = k0 + xg + 8 * j;
        const bool ok =
            full || allowed(row, key, sq, t, causal, use_window, window, qo);
        const float p = ok ? exp2f(fmaf(s[a][j], scale_log2, -l2[a])) : 0.0f;
        dst[(xg + 8 * j) * kXLd + og + 16 * a] =
            p * (dp[a][j] - dd[a]) * scale;
      }
    __syncthreads();
    tn_product<HD, kOther>(acc, dst, kb, kg, dg);
    __syncthreads();  // ds^T and the buffer are read before they are refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + 8 * kg + i;
    if (row < sq)
      st_cols<DPT>(dq + q_head + static_cast<size_t>(row) * h * HD + DPT * dg,
                   acc[i]);
  }
}

// query rows a step of the f32 dk/dv kernel: fewer at hd 128 (registers)
template <int HD>
__host__ __device__ constexpr int dkdv_f32_q_block() {
  return HD == 128 ? 16 : 32;
}

template <int HD>
__host__ __device__ constexpr size_t dkdv_f32_smem_bytes() {
  constexpr int OT = dkdv_f32_q_block<HD>();
  // K and V tiles; q, dout and their stats double-buffered; p^T and ds^T
  return (static_cast<size_t>(2 * kTile) * (HD + 4) +
          2 * (static_cast<size_t>(2 * OT) * (HD + 4) + 2 * OT) +
          2 * OT * kXLd) *
         sizeof(float);
}

// two CTAs an SM (bwd_plan's BWD_CTAS_PER_SM): without the bound ptxas
// capped hd 16 at 168 registers and spilled
template <int HD>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float2* __restrict__ stats, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ part, int nb, int sq,
    int sq_pad, int t, int h, int kv, int pair_lo, int pair_hi, int split,
    int causal, int use_window, int window, int qo, float scale) {
  constexpr int LD = HD + 4, DPT = HD / 16;
  constexpr int OT = dkdv_f32_q_block<HD>();
  constexpr int kBuf = 2 * OT * LD + 2 * OT;  // q, dout, stats
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kTile][LD]
  float* vs = ks + kTile * LD;                  // [kTile][LD]
  float* bufs = vs + kTile * LD;                // [2][kBuf]
  float* pt = bufs + 2 * kBuf;                  // p^T [OT][kXLd]
  float* dst = pt + OT * kXLd;                  // ds^T [OT][kXLd]

  const int tid = threadIdx.x;
  const Unit unit(pair_lo, pair_hi, split, kv, h, sq, OT, causal,
                  use_window, window, qo);
  const int b = unit.b, kvh = unit.kvh;
  const size_t kv_head = (static_cast<size_t>(b) * t * kv + kvh) * HD;
  auto load_kv = [&](int c) {  // none for a key block no query sees
    if (unit.steps(c) == 0) return;
    const int k0 = unit.kb(c) * kTile;
    stage_rows<HD>(ks, k + kv_head, static_cast<size_t>(kv) * HD, k0, kTile,
                   t, tid);
    stage_rows<HD>(vs, v + kv_head, static_cast<size_t>(kv) * HD, k0, kTile,
                   t, tid);
  };
  auto load_q = [&](int i, int buf) {
    int head, q0;
    unit.step(i, OT, head, q0);
    float* bq = bufs + buf * kBuf;
    const size_t q_head = (static_cast<size_t>(b) * sq * h + head) * HD;
    stage_rows<HD>(bq, q + q_head, static_cast<size_t>(h) * HD, q0, OT,
                   sq, tid);
    stage_rows<HD>(bq + OT * LD, dout + q_head,
                   static_cast<size_t>(h) * HD, q0, OT, sq, tid);
    const float2* srow =
        stats + (static_cast<size_t>(b) * h + head) * sq_pad + q0;
    for (int r = tid; r < OT / 2; r += kThreads)  // q0 + OT <= sq_pad
      cp_async16(smem_addr(bq + 2 * OT * LD + 4 * r), srow + 2 * r, true);
  };
  load_kv(0);
  if (unit.total > 0) load_q(0, 0);
  cp_async_commit();

  const int og = tid % 16, xg = tid / 16;  // s^T: keys og + 16 i, q xg + 8 j
  const int kg = tid / 16, dg = tid % 16;  // dk, dv: keys 8 kg + i, DPT dg
  const float scale_log2 = scale * kLog2e;
  const size_t plane = static_cast<size_t>(nb) * t * kv * HD;
  int i = 0;  // flat step
  for (int c = 0; c < unit.n_blocks; ++c) {
    const int k0 = unit.kb(c) * kTile;
    const int nq = unit.n_qb(c);
    float dka[8][DPT], dva[8][DPT];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < DPT; ++e) dka[r][e] = dva[r][e] = 0.0f;
    for (int s = 0; s < unit.steps(c); ++s, ++i) {
      const int buf = i & 1;
      if (i + 1 < unit.total) load_q(i + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // step i (and K and V)
      __syncthreads();
      const int q0 = (unit.qb_begin(c) + s % nq) * OT;
      const float* bq = bufs + buf * kBuf;
      const float* bdo = bq + OT * LD;
      const float* bst = bdo + OT * LD;
      float st[4][OT / 8], dpt[4][OT / 8];
      nt_products<HD, OT>(st, dpt, ks, bq, vs, bdo, og, xg);
      const bool full = all_visible(q0, OT, k0, kTile, sq, t, causal,
                                    use_window, window, qo);
#pragma unroll
      for (int j = 0; j < OT / 8; ++j) {
        const int qi = xg + 8 * j;
        const float2 sv = *reinterpret_cast<const float2*>(bst + 2 * qi);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int key = k0 + og + 16 * a;
          const bool ok = full || allowed(q0 + qi, key, sq, t, causal,
                                          use_window, window, qo);
          const float p = ok ? exp2f(fmaf(st[a][j], scale_log2, -sv.x)) : 0.0f;
          pt[qi * kXLd + og + 16 * a] = p;
          dst[qi * kXLd + og + 16 * a] = p * (dpt[a][j] - sv.y) * scale;
        }
      }
      __syncthreads();
      tn_product<HD, OT>(dva, pt, bdo, kg, dg);
      tn_product<HD, OT>(dka, dst, bq, kg, dg);
      __syncthreads();  // p^T, ds^T and the buffer are read
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int key = k0 + 8 * kg + r;
      if (key >= t) continue;
      const size_t off =
          kv_head + static_cast<size_t>(key) * kv * HD + DPT * dg;
      if (split > 1) {
        st_cols<DPT>(part + unit.share * plane + off, dka[r]);
        st_cols<DPT>(part + (split + unit.share) * plane + off, dva[r]);
      } else {
        st_cols<DPT>(dk + off, dka[r]);
        st_cols<DPT>(dv + off, dva[r]);
      }
    }
    if (c + 1 < unit.n_blocks) {
      __syncthreads();  // K and V are read
      load_kv(c + 1);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// the partials' fixed-order sum
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// dk = sum of part[0][s], dv = sum of part[1][s], s = 0 .. split - 1 in
// order; n floats a plane (a multiple of 4)
template <typename T>
__global__ void flash_bwd_reduce_kernel(const float* __restrict__ part,
                                        T* __restrict__ dk,
                                        T* __restrict__ dv, size_t n,
                                        int split) {
  for (size_t i = (static_cast<size_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x) * 4;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x * 4) {
    float4 a = ld4(part + i);
    float4 c = ld4(part + split * n + i);
    for (int s = 1; s < split; ++s) {
      const float4 x = ld4(part + s * n + i);
      const float4 y = ld4(part + (split + s) * n + i);
      a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
      c.x += y.x, c.y += y.y, c.z += y.z, c.w += y.w;
    }
    store4(dk + i, a);
    store4(dv + i, c);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *out, *lse, *dout;
  void *stats, *dq, *dk, *dv, *part;
  int b, sq, sq_pad, t, h, kv, causal, use_window, window, qo, pair_lo,
      pair_hi, split;
  float scale;
};

int n_units(const Args& a) {
  return units_per_head(a.pair_lo, a.pair_hi) * a.split * a.kv * a.b;
}

// dk and dv rows of the key blocks from pair_hi on, which no unit walks
// (no query sees them): zeros, after the reduce (which sums the partials'
// whole planes)
template <typename T, int HD>
int zero_tail(const Args& a, cudaStream_t stream) {
  const int k0 = a.pair_hi * kTile;
  if (k0 >= a.t) return static_cast<int>(cudaSuccess);
  const size_t row = static_cast<size_t>(a.kv) * HD * sizeof(T);
  for (void* x : {a.dk, a.dv}) {
    const cudaError_t e = cudaMemset2DAsync(
        static_cast<char*>(x) + k0 * row, a.t * row, 0, (a.t - k0) * row,
        a.b, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaSuccess);
}

template <typename T, int HD>
int reduce(const Args& a, cudaStream_t stream) {
  if (a.split <= 1) return static_cast<int>(cudaSuccess);
  const size_t n = static_cast<size_t>(a.b) * a.t * a.kv * HD;
  const int grid = static_cast<int>(std::min<size_t>(n / 4 / 256 + 1, 2048));
  flash_bwd_reduce_kernel<T><<<grid, 256, 0, stream>>>(
      static_cast<const float*>(a.part), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), n, a.split);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_f32_smem_bytes<HD>();
  constexpr size_t smem_dkdv = dkdv_f32_smem_bytes<HD>();
  auto dq_kernel = flash_bwd_dq_f32_kernel<HD>;
  auto dkdv_kernel = flash_bwd_dkdv_f32_kernel<HD>;
  static bool dq_in = false, dkdv_in = false;
  cudaError_t e = opt_in(dq_kernel, smem_dq, dq_in);
  if (e == cudaSuccess) e = opt_in(dkdv_kernel, smem_dkdv, dkdv_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  using F = const float*;
  dq_kernel<<<dim3(a.b * a.h, (a.sq + kTile - 1) / kTile), kThreads, smem_dq,
              stream>>>(
      static_cast<F>(a.q), static_cast<F>(a.k), static_cast<F>(a.v),
      static_cast<F>(a.out), static_cast<F>(a.lse), static_cast<F>(a.dout),
      static_cast<float2*>(a.stats), static_cast<float*>(a.dq), a.sq,
      a.sq_pad, a.t, a.h, a.kv, a.causal, a.use_window, a.window, a.qo,
      a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkdv_kernel<<<n_units(a), kThreads, smem_dkdv, stream>>>(
      static_cast<F>(a.q), static_cast<F>(a.k), static_cast<F>(a.v),
      static_cast<F>(a.dout), static_cast<const float2*>(a.stats),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      static_cast<float*>(a.part), a.b, a.sq, a.sq_pad, a.t, a.h, a.kv,
      a.pair_lo, a.pair_hi, a.split, a.causal, a.use_window, a.window, a.qo,
      a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rc = reduce<float, HD>(a, stream);
  return rc ? rc : zero_tail<float, HD>(a, stream);
}

template <int HD>
int launch_bf16(const Args& a, cudaStream_t stream) {
  using T64 = Tile<HD, kTile>;
  using TQ = typename DkdvLayout<HD>::TQ;
  constexpr int QB = DkdvLayout<HD>::QB;
  CUtensorMap k64, v64, qq, dod, st;
  const bool ok =
      bshd_map(&k64, a.k, a.b, a.t, a.kv, HD, kTile, T64::kBoxCols,
               T64::kRowBytes) &&
      bshd_map(&v64, a.v, a.b, a.t, a.kv, HD, kTile, T64::kBoxCols,
               T64::kRowBytes) &&
      bshd_map(&qq, a.q, a.b, a.sq, a.h, HD, QB, TQ::kBoxCols,
               TQ::kRowBytes) &&
      bshd_map(&dod, a.dout, a.b, a.sq, a.h, HD, QB, TQ::kBoxCols,
               TQ::kRowBytes) &&
      f32_map(&st, a.stats, a.b * a.h, 2 * a.sq_pad, 2 * a.sq_pad, 1,
              2 * QB);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem_dq = DqLayout<HD>::kBytes;
  constexpr size_t smem_dkdv = DkdvLayout<HD>::kBytes;
  auto dq_kernel = flash_bwd_dq_wgmma_kernel<HD>;
  auto dkdv_kernel = flash_bwd_dkdv_wgmma_kernel<HD>;
  static bool dq_in = false, dkdv_in = false;
  cudaError_t e = opt_in(dq_kernel, smem_dq, dq_in);
  if (e == cudaSuccess) e = opt_in(dkdv_kernel, smem_dkdv, dkdv_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  using B = const bf16*;
  // (batch x head) fastest, the q tile slowest, reversed: heaviest first
  dq_kernel<<<dim3(a.b * a.h, (a.sq + kTile - 1) / kTile), kThreads, smem_dq,
              stream>>>(k64, v64, static_cast<B>(a.q), static_cast<B>(a.out),
                        static_cast<B>(a.dout),
                        static_cast<const float*>(a.lse),
                        static_cast<float2*>(a.stats),
                        static_cast<bf16*>(a.dq), a.sq, a.sq_pad, a.t, a.h,
                        a.kv, a.causal, a.use_window, a.window, a.qo,
                        a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkdv_kernel<<<n_units(a), kThreads, smem_dkdv, stream>>>(
      qq, dod, st, static_cast<B>(a.k), static_cast<B>(a.v),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      static_cast<float*>(a.part), a.b, a.sq, a.t, a.h, a.kv, a.pair_lo,
      a.pair_hi, a.split, a.causal, a.use_window, a.window, a.qo, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rc = reduce<bf16, HD>(a, stream);
  return rc ? rc : zero_tail<bf16, HD>(a, stream);
}

template <int HD>
int launch(int bf16_route, const Args& a, cudaStream_t stream) {
  return bf16_route ? launch_bf16<HD>(a, stream) : launch_f32<HD>(a, stream);
}

}  // namespace

// q, out, dout, dq (b, sq, h, hd), k, v, dk, dv (b, t, kv, hd), lse (b, h,
// sq) float32; all contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1;
// q, k, v, out and dout 16-byte aligned); hd in {16, 32, 64, 80, 128},
// h % kv == 0, b, sq, t > 0. Scratch: stats (b * h, sq_pad) float2 with
// sq_pad = sq rounded up to 64; part 2 * split * b * t * kv * hd floats
// when split > 1 (else unused); split divides h / kv; key blocks
// [pair_lo, pair_hi) are paired (units_per_head) and those from pair_hi on
// zeroed, 0 <= pair_lo <= pair_hi <= the key blocks of 64; query row i at
// position q_offset + i (q_offset >= 0). Two kernels, or three with split
// > 1, in stream order, then the zeroed rows' memsets. Returns the first
// failed launch's cudaError_t (0 on success).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* stats, void* part, void* dq,
    void* dk, void* dv, int b, int sq, int t, int h, int kv, int hd,
    int causal, int use_window, int window, int q_offset, int pair_lo,
    int pair_hi, int split, float scale, int bf16, void* stream) {
  const int sq_pad = (sq + kTile - 1) / kTile * kTile;
  const int n_kb = (t + kTile - 1) / kTile;
  if (b <= 0 || sq <= 0 || t <= 0 || kv <= 0 || h % kv != 0 || split <= 0 ||
      (h / kv) % split != 0 || (split > 1 && part == nullptr) ||
      q_offset < 0 || pair_lo < 0 || pair_lo > pair_hi || pair_hi > n_kb)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,       k,       v,      out,    lse,        dout,
               stats,   dq,      dk,     dv,     part,       b,
               sq,      sq_pad,  t,      h,      kv,         causal,
               use_window, window, q_offset, pair_lo, pair_hi, split,
               scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(bf16, a, s);
    case 32:
      return launch<32>(bf16, a, s);
    case 64:
      return launch<64>(bf16, a, s);
    case 80:
      return launch<80>(bf16, a, s);
    case 128:
      return launch<128>(bf16, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the dynamic shared memory, in bytes, of the dq and dk/dv kernels of a
// route at head dim hd (for the build report); 0 on success
extern "C" int repro_flash_attention_bwd_smem(int hd, int bf16, int* dq,
                                              int* dkdv) {
  switch (hd * 2 + (bf16 ? 1 : 0)) {
#define REPRO_SMEM(HD)                                                  \
  case 2 * HD:                                                          \
    *dq = static_cast<int>(dq_f32_smem_bytes<HD>());                    \
    *dkdv = static_cast<int>(dkdv_f32_smem_bytes<HD>());                \
    return 0;                                                           \
  case 2 * HD + 1:                                                      \
    *dq = DqLayout<HD>::kBytes;                                         \
    *dkdv = DkdvLayout<HD>::kBytes;                                     \
    return 0;
    REPRO_SMEM(16)
    REPRO_SMEM(32)
    REPRO_SMEM(64)
    REPRO_SMEM(80)
    REPRO_SMEM(128)
#undef REPRO_SMEM
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
