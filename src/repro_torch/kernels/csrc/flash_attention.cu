// Flash-attention forward for Hopper, sm_90a: grouped-query attention with
// a running softmax, causal and/or sliding-window masks, returning the
// output and the log-sum-exp of every query row.
//
// Replaces the TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (its pallas_call is
// `flash_attention_pallas`), and computes what it computes:
//
//   s     = (q . k) * hd^-0.5            products in float32
//   allow = k_pos < T  [and k_pos <= q_pos]  [and k_pos > q_pos - window]
//   m, l, acc: the running max, sum and hd-wide accumulator, float32
//   out   = acc / max(l, 1e-20)          in q's type
//   lse   = (m if finite else 0) + log(max(l, 1e-20))
//
// with q (B, Sq, H, hd), k and v (B, T, KV, hd), out (B, Sq, H, hd) and lse
// (B, H, Sq) float32; q head h reads kv head h / (H / KV), with no copy of
// K/V per q head. As in the TPU kernel, p is rounded to the input type
// before the p @ v product (a no-op in float32). Two routes, one per type.
//
// Query row i sits at q_pos = q_offset + i (q_offset >= 0; the TPU kernel
// knows only 0): the reference's q-chunked causal attention passes a
// chunk's first row, and a sequence-sharded hidden state a shard's first
// row, against all the keys. A CTA walks only the key blocks its rows can
// see (blocks wholly past its last row's position are never loaded), so a
// row walks the same key blocks, in the same order, at any offset: the
// shards of one call concatenate to the unsharded call's out and lse bit
// for bit. Under a causal mask the last tile still sees the most keys.
//
// What bounds it on the H100. At the serving shape (q (1, 512, 32, 64), K/V
// with 4 heads, bf16, causal) bytes: q, k, v, out and the lse are about
// 4.6 MB, 1.4 us at 3.35 TB/s, against 2*2*32*512*512*64 / 2 = 1.1 GFLOP
// under the causal mask, 1.1 us at 989 TFLOP/s. At long T operations: about
// 2*B*H*Sq*T*hd under the causal mask, 137 GFLOP at (8, 2048, 32, 64).
//
// bfloat16: flash_attention_mma_kernel, both products on the tensor cores
// (mma.sync m16n8k16, bf16 in, float32 accumulation). One CTA of 4 warps
// owns 64 query rows of one head of one batch row; each warp owns 16 rows
// and keeps their q fragments (read once with ldmatrix) in registers for
// the whole K/V loop. K/V stream through shared memory in blocks of 64 keys,
// double-buffered with cp.async (16 bytes a thread, zero-filled past T), in
// rows padded by 16 bytes so that ldmatrix's eight row addresses hit
// distinct banks. S = Q.K^T lands in float32 registers in the mma's
// accumulator layout; the running softmax works on those registers (a row
// is spread over the 4 lanes of a quad: max and sum reduced with two
// shuffles), on the raw scores, one FFMA and one ex2.approx a score (p =
// 2^(s * scale * log2 e - m * scale * log2 e)); P is packed to bf16 in
// registers -- the rounding the TPU kernel applies -- and is the A operand
// of the P.V mma as it stands, V read with ldmatrix.trans. The mask is
// applied only on the blocks that the ragged end of T, the diagonal or the
// window edge cross; blocks masked for a whole warp's rows are skipped by
// that warp, and blocks masked for the whole tile are not visited (the
// causal loop stops at the tile's last row, the window's starts at its
// first key). Under a causal mask the tiles differ in work by up to T / 64,
// so the grid puts the tile index in its slowest dimension, reversed: the
// heaviest tiles of every head start first and the short ones fill in.
// At hd <= 64 the registers are capped at 128 a thread, so that four CTAs
// share an SM and one's softmax overlaps another's products; a CTA of 8
// warps (128 rows, half the K/V traffic into shared memory) was slower.
//
// float32: flash_attention_kernel, on the float32 CUDA cores (an f32 call
// must not go through TF32, which keeps about three decimal digits). What
// bounds it: operations, 2 * 2 * hd FMAs' worth a visible (query, key) pair
// and q head at 67 TFLOP/s -- 34.4 GFLOP, 0.513 ms at the LLM training
// shape (2, 2048, 32/4 heads of 64, causal), against 76 MB of inputs and
// outputs (0.023 ms at 3.35 TB/s). Every FMA takes an issue slot of its
// warp scheduler, so the design keeps shared-memory loads, shuffles and
// the softmax few beside the FMAs. One CTA of 4 warps owns 64 query rows of
// one head of one batch row, kept in shared memory; K and V stream through
// a cp.async double buffer (16 bytes a thread, zero-filled past T) in
// blocks of 64 keys (32 at hd 80 and 128), block i + 1 loading while block i
// computes (one CTA barrier a block), in rows padded by 16 bytes. Each warp owns 16 of the rows and
// a lane 8 of those: it scores them against 4 keys of a 64-key block (12
// float4 loads per 128 FMAs), reduces the running max over the 16 lanes
// that share a row (four shuffles; the row sums stay per lane until the
// end), computes p with one FFMA and one ex2.approx a score (p = 2^(s *
// scale * log2 e - m * scale * log2 e)) and rescales its part of the
// output once a row a block, writes p transposed into the warp's own
// columns of shared memory (no CTA barrier between the products), and
// accumulates an 8 x hd/16 tile of the output over the block's keys
// (tn_product, flash_tiles.cuh; 3 float4 loads per 32 FMAs). The mask is
// applied only on the blocks that the ragged end of T, the diagonal or the
// window edge cross; a warp skips the blocks none of its rows may see.
// Shared memory is 102 KB a CTA at hd 64, 71 KB at hd 80 and 107 KB at hd
// 128: two CTAs an SM or more. Under a causal mask the tiles differ in work
// by up to T / 64, so the grid puts (batch, head) fastest and the tile
// slowest, the last tile first (flash_attention.fwd_plan lists each CTA's
// blocks): the heaviest tiles start first and the light ones fill in.
// Nothing is summed across CTAs, so two calls give the same bits. On an
// NVIDIA H100 80GB HBM3 at 700 W it takes 0.96-0.97 ms on the device at the
// training shape, 0.53 of the bound, with 210 registers a thread at hd 64
// and no spill. By count, loads, shuffles and the softmax take about 15 % of
// the issue slots from the FMAs; the rest of the gap would be latency that 8
// warps an SM do not hide (no stall counters were read).
//
// Both routes mask ragged Sq and T, so neither needs padding.
//
// Head dim 80 (zamba2's shared attention block): hd / 16 = 5 is odd, and
// nothing above needs a power of two. The bf16 route takes 5 k-steps of
// Q.K^T and 5 pairs of P.V n-tiles; its rows of 88 bf16 (176 B) are
// 16-byte aligned for ldmatrix and cp.async, and ldmatrix's 8 row
// addresses fall on 16-byte bank groups 11 r mod 8, all distinct. Its
// registers are not capped (one CTA an SM by the bound, more by the
// occupancy). The float32 route's lane owns 5 output columns: they are
// loaded and stored one float at a time (5 dg is no multiple of 4), 16
// lanes on 16 distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"
#include "flash_tiles.cuh"
#include "mma_fragments.cuh"

namespace {

constexpr int kRows = 64;                     // query rows per CTA
constexpr int kKeys = 64;                     // keys per staged block
constexpr int kWarps = 4;

// ---------------------------------------------------------------------------
// float32 route: CUDA cores
// ---------------------------------------------------------------------------

// a row of p^T: the tile's rows padded by 16 bytes, so that the 8 lanes
// of a float4 store phase, 8 keys' rows, hit 8 distinct bank groups (the
// backward's kXLd, padded by 64 bytes, puts 4 of them on each of 2)
constexpr int kPtLd = kRows + 4;

// keys of a staged K/V block: 32 at hd 80 and 128, so that two CTAs share
// an SM (64 at hd 80 would stage 122 KB, one CTA an SM)
template <int HD>
__host__ __device__ constexpr int f32_k_block() {
  return HD >= 80 ? 32 : 64;
}

// the q tile, K and V double-buffered, p^T of the tile's rows
template <int HD>
__host__ __device__ constexpr size_t f32_smem_bytes() {
  constexpr int KB = f32_k_block<HD>();
  return (static_cast<size_t>(kRows + 4 * KB) * (HD + 4) +
          static_cast<size_t>(KB) * kPtLd) *
         sizeof(float);
}

// s[i][j] = q[i] . k[16 j] over hd, for 8 rows of q (`q` at the first,
// rows HD + 4 floats apart) and KB / 16 keys (`k` at the first)
template <int HD, int KB>
__device__ __forceinline__ void qk_product(float (&s)[8][KB / 16],
                                           const float* q, const float* k) {
  constexpr int LD = HD + 4, KJ = KB / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < KJ; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 kx[KJ];
#pragma unroll
    for (int j = 0; j < KJ; ++j) kx[j] = ld4(k + 16 * j * LD + d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 qv = ld4(q + i * LD + d);
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        s[i][j] = fmaf(qv.x, kx[j].x, s[i][j]);
        s[i][j] = fmaf(qv.y, kx[j].y, s[i][j]);
        s[i][j] = fmaf(qv.z, kx[j].z, s[i][j]);
        s[i][j] = fmaf(qv.w, kx[j].w, s[i][j]);
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kTileThreads, 2) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int sq, int t, int h, int kv, int causal,
    int use_window, int window, int qo, float scale, float scale_log2) {
  constexpr int LD = HD + 4, KB = f32_k_block<HD>(), KJ = KB / 16;
  constexpr int DPT = HD / 16;  // output columns a lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][LD]
  float* kvbuf = qs + kRows * LD;               // [2][K, V: KB][LD]
  float* pt = kvbuf + 4 * KB * LD;              // p^T [KB][kPtLd]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int head = blockIdx.x % h;
  const int b = blockIdx.x / h;
  // under a causal mask the last tile sees the most keys: heaviest first
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kRows;
  const int kvh = head / (h / kv);
  const size_t q_head = (static_cast<size_t>(b) * sq * h + head) * HD;
  const size_t kv_head = (static_cast<size_t>(b) * t * kv + kvh) * HD;
  int kb_begin, kb_end;
  key_blocks(q0, kRows, KB, sq, t, causal, use_window, window, qo, kb_begin,
             kb_end);
  const int n = kb_end - kb_begin;
  auto load_kv = [&](int i, int buf) {
    float* kb = kvbuf + buf * 2 * KB * LD;
    const int k0 = (kb_begin + i) * KB;
    stage_rows<HD>(kb, k + kv_head, static_cast<size_t>(kv) * HD, k0, KB, t,
                   tid);
    stage_rows<HD>(kb + KB * LD, v + kv_head, static_cast<size_t>(kv) * HD,
                   k0, KB, t, tid);
  };
  stage_rows<HD>(qs, q + q_head, static_cast<size_t>(h) * HD, q0, kRows, sq,
                 tid);
  if (n > 0) load_kv(0, 0);
  cp_async_commit();

  // the warp owns rows 16 warp .. 16 warp + 15; a lane holds rows r0 + i (i
  // < 8) of them: their scores against keys kg + 16 j of each block, and
  // their output columns DPT kg .. DPT kg + DPT - 1
  const int kg = lane & 15;
  const int r0 = 16 * warp + 8 * (lane >> 4);
  const int w_first = q0 + 16 * warp, w_last = w_first + 15;
  float m[8], l[8], acc[8][DPT];  // l: this lane's part of the row sums
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[r][c] = 0.0f;
  }

  for (int i = 0; i < n; ++i) {
    const int buf = i & 1;
    cp_async_wait<0>();  // block i (and the q tile)
    // block i is in every thread's view, and block i - 1 is read: its
    // buffer takes block i + 1 while this one computes
    __syncthreads();
    if (i + 1 < n) {
      load_kv(i + 1, buf ^ 1);
      cp_async_commit();
    }
    const float* kb = kvbuf + buf * 2 * KB * LD;
    const int k0 = (kb_begin + i) * KB;
    // a block that no row of this warp may see (past sq, above the
    // diagonal, or before the window) leaves its state as it is
    const bool visible =
        w_first < sq && !(causal && k0 > w_last + qo) &&
        !(use_window && k0 + KB - 1 <= w_first + qo - window);
    if (visible) {
      float s[8][KJ];
      qk_product<HD, KB>(s, qs + r0 * LD, kb + kg * LD);
      // mask only where the block needs it
      if (!all_visible(w_first, 16, k0, KB, sq, t, causal, use_window,
                       window, qo)) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int j = 0; j < KJ; ++j)
            if (!allowed(q0 + r0 + r, k0 + kg + 16 * j, sq, t, causal,
                         use_window, window, qo))
              s[r][j] = -INFINITY;
      }
      // running statistics: a row lives on 16 lanes; p = 2^(s * scale *
      // log2 e - m * scale * log2 e), one FFMA and one ex2 a score
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        float mx = s[r][0];
#pragma unroll
        for (int j = 1; j < KJ; ++j) mx = fmaxf(mx, s[r][j]);
#pragma unroll
        for (int o = 1; o < 16; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[r], mx);
        const float m_scaled = m_new == -INFINITY ? 0.0f : m_new * scale_log2;
        // 0 while m is -inf
        const float corr = fast_exp2(m[r] * scale_log2 - m_scaled);
        m[r] = m_new;
        l[r] *= corr;
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[r][c] *= corr;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const float p = fast_exp2(fmaf(s[r][j], scale_log2, -m_scaled));
          l[r] += p;
          s[r][j] = p;
        }
      }
      // p^T into the warp's 16 columns, then acc += p . v over the block
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        float* dst = pt + (kg + 16 * j) * kPtLd + r0;
        *reinterpret_cast<float4*>(dst) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
      }
      __syncwarp();
      tn_product<HD, KB, KB == 32 ? 4 : 16, kPtLd>(acc, pt, kb + KB * LD,
                                                  r0 / 8, kg);
    }
  }
  cp_async_wait<0>();  // in flight only where the tile saw no block

#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
    const int row = q0 + r0 + r;
    if (row >= sq) continue;
    const float denom = fmaxf(l[r], 1e-20f);
    float val[DPT];
#pragma unroll
    for (int c = 0; c < DPT; ++c) val[c] = acc[r][c] / denom;
    st_cols<DPT>(out + q_head + static_cast<size_t>(row) * h * HD + DPT * kg,
                 val);
    if (kg == 0)
      lse[(static_cast<size_t>(b) * h + head) * sq + row] =
          (m[r] == -INFINITY ? 0.0f : m[r] * scale) + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 route: tensor cores (mma.sync)
// ---------------------------------------------------------------------------

// the q tile, then K and V double-buffered
template <int HD>
__host__ __device__ constexpr size_t mma_smem_bytes() {
  return static_cast<size_t>(kRows + 4 * kKeys) * mma_stride<HD>() *
         sizeof(bf16);
}

// at hd <= 64 registers are capped at 128 a thread: four CTAs on an SM
template <int HD>
__global__ void __launch_bounds__(kWarps * 32, HD <= 64 ? 4 : 1)
    flash_attention_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out,
    float* __restrict__ lse, int sq, int t, int h, int kv, int causal,
    int use_window, int window, int qo, float scale_log2) {
  constexpr int S = mma_stride<HD>();
  constexpr int kThreads = kWarps * 32;
  constexpr int kPieces = HD / 8;  // 16-byte pieces in a row
  constexpr int kDSteps = HD / 16;  // k-steps of Q.K^T, pairs of P.V n-tiles
  constexpr int kNTiles = kKeys / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][S]
  bf16* ks = qs + kRows * S;                     // [2][kKeys][S]
  bf16* vs = ks + 2 * kKeys * S;                 // [2][kKeys][S]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int head = blockIdx.x % h;
  const int b = blockIdx.x / h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  const int kvh = head / (h / kv);
  const bf16* qb = q + (static_cast<size_t>(b) * sq * h + head) * HD;
  const size_t kv_base = (static_cast<size_t>(b) * t * kv + kvh) * HD;

  // the key blocks this tile can see
  int kb_begin, kb_end;
  key_blocks(q0, kRows, kKeys, sq, t, causal, use_window, window, qo,
             kb_begin, kb_end);

  for (int i = tid; i < kRows * kPieces; i += kThreads) {
    const int r = i / kPieces, c = i % kPieces;
    const bool ok = q0 + r < sq;
    cp_async16(smem_addr(qs + r * S + c * 8),
               qb + static_cast<size_t>(ok ? q0 + r : 0) * h * HD + c * 8, ok);
  }
  cp_async_commit();
  auto load_kv = [&](int kb, int buf) {
    const int k0 = kb * kKeys;
    for (int i = tid; i < kKeys * kPieces; i += kThreads) {
      const int r = i / kPieces, c = i % kPieces;
      const bool ok = k0 + r < t;
      const size_t off =
          kv_base + static_cast<size_t>(ok ? k0 + r : 0) * kv * HD + c * 8;
      const int dst = (buf * kKeys + r) * S + c * 8;
      cp_async16(smem_addr(ks + dst), k + off, ok);
      cp_async16(smem_addr(vs + dst), v + off, ok);
    }
  };
  if (kb_begin < kb_end) load_kv(kb_begin, 0);
  cp_async_commit();
  cp_async_wait<1>();  // the q tile
  __syncthreads();

  // the warp's 16 q rows as A fragments, one per k-step of 16 columns
  uint32_t qf[kDSteps][4];
#pragma unroll
  for (int ds = 0; ds < kDSteps; ++ds)
    load_a(qf[ds], qs + warp * 16 * S + ds * 16, S, lane);

  // the warp's rows at their positions (row + qo, what the masks compare),
  // this lane's two of them (g and g + 8), their state
  const bool live = q0 + warp * 16 < sq;
  const int p_first = q0 + warp * 16 + qo, p_last = p_first + 15;
  const int p_a = p_first + (lane >> 2), p_b = p_a + 8;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
  float l[2] = {0.0f, 0.0f};            // this lane's part of the row sums
  float o[2 * kDSteps][4];
#pragma unroll
  for (int n = 0; n < 2 * kDSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int buf = (kb - kb_begin) & 1;
    if (kb + 1 < kb_end) load_kv(kb + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // block kb
    __syncthreads();
    const bf16* kbuf = ks + buf * kKeys * S;
    const bf16* vbuf = vs + buf * kKeys * S;
    // a block that no row of this warp may see (past sq, above the
    // diagonal, or before the window) leaves its state as it is
    const int k0 = kb * kKeys;
    const bool visible =
        live && !(causal && k0 > p_last) &&
        !(use_window && k0 + kKeys - 1 <= p_first - window);
    if (visible) {
      // s = q . k^T for the warp's 16 rows and the block's 64 keys
      float s[kNTiles][4];
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
      for (int ds = 0; ds < kDSteps; ++ds)
#pragma unroll
        for (int np = 0; np < kNTiles / 2; ++np) {
          uint32_t kf[4];
          load_b(kf, kbuf + np * 16 * S + ds * 16, S, lane);
          mma_bf16(s[2 * np], qf[ds], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf[ds], kf[2], kf[3]);
        }

      // mask only where the block needs it
      const bool edge = k0 + kKeys > t ||
                        (causal && k0 + kKeys - 1 > p_first) ||
                        (use_window && k0 <= p_last - window);
      if (edge) {
#pragma unroll
        for (int n = 0; n < kNTiles; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
            const int pos = e < 2 ? p_a : p_b;
            const bool ok = key < t && (!causal || key <= pos) &&
                            (!use_window || key > pos - window);
            s[n][e] = ok ? s[n][e] : -INFINITY;
          }
      }

      // running statistics: a row lives on the 4 lanes of a quad; p =
      // 2^(s * scale * log2 e - m * scale * log2 e), one FFMA a score
      float m_scaled[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < kNTiles; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        m_scaled[i] = m_new == -INFINITY ? 0.0f : m_new * scale_log2;
        // 0 while m is -inf
        const float corr = fast_exp2(m[i] * scale_log2 - m_scaled[i]);
        m[i] = m_new;
        l[i] *= corr;
#pragma unroll
        for (int n = 0; n < 2 * kDSteps; ++n) {
          o[n][2 * i] *= corr;
          o[n][2 * i + 1] *= corr;
        }
      }
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // 0 where masked
          const float p =
              fast_exp2(fmaf(s[n][e], scale_log2, -m_scaled[e >> 1]));
          l[e >> 1] += p;
          s[n][e] = p;
        }

      // o += p . v: the score accumulators are the A fragments of p, in bf16
#pragma unroll
      for (int kk = 0; kk < kNTiles / 2; ++kk) {
        uint32_t pf[4];
        pack_a(pf, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < kDSteps; ++dp) {
          uint32_t vf[4];
          load_b_trans(vf, vbuf + kk * 16 * S + dp * 16, S, lane);
          mma_bf16(o[2 * dp], pf, vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pf, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // the buffer is read before the next load refills it
  }
  cp_async_wait<0>();

  const int row_a = q0 + warp * 16 + (lane >> 2);
  const int rows[2] = {row_a, row_a + 8};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (rows[i] >= sq) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    bf16* orow = out + ((static_cast<size_t>(b) * sq + rows[i]) * h + head) *
                           HD +
                 (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < 2 * kDSteps; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(
          o[n][2 * i] / denom, o[n][2 * i + 1] / denom);
    if ((lane & 3) == 0) {
      const float m_nat = m[i] * scale_log2 * 0.69314718055994531f;
      lse[(static_cast<size_t>(b) * h + head) * sq + rows[i]] =
          (m[i] == -INFINITY ? 0.0f : m_nat) + logf(denom);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int b, int sq, int t, int h, int kv, int causal,
               int use_window, int window, int qo, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<HD>();
  auto kernel = flash_attention_kernel<HD>;
  static bool opted_in = false;
  const cudaError_t e = opt_in(kernel, smem, opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  // (batch x head) fastest, the q tile slowest (flash_attention.fwd_plan)
  const dim3 grid(b * h, (sq + kRows - 1) / kRows);
  kernel<<<grid, kTileThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), sq, t, h, kv, causal, use_window, window,
      qo, scale, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int b, int sq, int t, int h, int kv, int causal,
                int use_window, int window, int qo, float scale,
                cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<HD>();
  auto kernel = flash_attention_mma_kernel<HD>;
  static bool opted_in = false;
  const cudaError_t e = opt_in(kernel, smem, opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  // (batch x head) fastest, the q tile slowest: heaviest tiles first
  const dim3 grid(b * h, (sq + kRows - 1) / kRows);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), sq, t, h, kv, causal, use_window, window,
      qo, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(int bf16_route, const void* q, const void* k, const void* v,
           void* out, void* lse, int b, int sq, int t, int h, int kv,
           int causal, int use_window, int window, int qo, float scale,
           cudaStream_t stream) {
  return bf16_route
             ? launch_bf16<HD>(q, k, v, out, lse, b, sq, t, h, kv, causal,
                               use_window, window, qo, scale, stream)
             : launch_f32<HD>(q, k, v, out, lse, b, sq, t, h, kv, causal,
                              use_window, window, qo, scale, stream);
}

}  // namespace

// q (b, sq, h, hd), k and v (b, t, kv, hd), out like q, lse (b, h, sq)
// float32; all contiguous and 16-byte aligned, float32 (bf16 = 0) or
// bfloat16 (bf16 = 1); hd in {16, 32, 64, 80, 128}, h % kv == 0; query row
// i at position q_offset + i (q_offset >= 0). Returns the launch's
// cudaError_t (0 on success).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, void* lse, int b,
    int sq, int t, int h, int kv, int hd, int causal, int use_window,
    int window, int q_offset, float scale, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_offset < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
#define REPRO_HD(HD)                                                      \
  case HD:                                                                \
    return launch<HD>(bf16, q, k, v, out, lse, b, sq, t, h, kv, causal,   \
                      use_window, window, q_offset, scale, s);
    REPRO_HD(16)
    REPRO_HD(32)
    REPRO_HD(64)
    REPRO_HD(80)
    REPRO_HD(128)
#undef REPRO_HD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the dynamic shared memory (bytes) of the forward's route at head dim hd
// and the CTAs of it that fit one SM, by the occupancy calculator (for the
// build report); 0 on success
extern "C" int repro_flash_attention_smem(int hd, int bf16, int* bytes,
                                          int* ctas_per_sm) {
  auto report = [&](auto kernel, size_t smem) {
    bool done = false;
    cudaError_t e = opt_in(kernel, smem, done);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, kernel, kTileThreads, smem);
    *bytes = static_cast<int>(smem);
    return static_cast<int>(e);
  };
  switch (hd * 2 + (bf16 ? 1 : 0)) {
#define REPRO_SMEM(HD)                                                  \
  case 2 * HD:                                                          \
    return report(flash_attention_kernel<HD>, f32_smem_bytes<HD>());    \
  case 2 * HD + 1:                                                      \
    return report(flash_attention_mma_kernel<HD>, mma_smem_bytes<HD>());
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
