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
// Two kernels a call, in stream order, and no float atomics, so two calls
// give the same bits:
//   dq:    one CTA per (batch row, q head, 64 query rows) loops over the key
//          blocks that the mask lets those rows see, recomputing p from the
//          lse; it also computes D for its rows and writes it to `delta`;
//   dk/dv: one CTA per (batch row, kv head, 64 keys) loops over the g q
//          heads of its group and, for each, over the query blocks that can
//          see those keys, recomputing p and ds (reading D from `delta`), and
//          sums dk and dv in registers in that fixed order.
// s and dp are computed in both kernels (seven products where a kernel with
// atomics on dq would do five): the price of writing every output once.
//
// What bounds it on the H100: operations. At (4, 2048, 32/4, 64) bf16,
// causal, the function's five products are 2 * 2*B*H*Sq*T*hd / 2 * 5 = 172
// GFLOP, 0.17 ms at 989 TFLOP/s, against 0.08 GB of inputs and outputs
// (0.02 ms at 3.35 TB/s).
//
// bfloat16 (flash_bwd_*_mma_kernel): every product on the tensor cores,
// mma.sync m16n8k16, bf16 in and float32 accumulation, with the forward's
// fragment code (mma_fragments.cuh). Each warp owns 16 rows of its CTA's
// tile (queries in dq, keys in dk/dv); the other side streams through shared
// memory double-buffered with cp.async (16 bytes a thread, zero-filled past
// the end), in rows padded by 16 bytes. The recomputed scores land in the
// accumulator layout, become p and ds in registers, and are packed to bf16
// as the A fragments of the next products -- the rounding that the
// reference applies. At hd 128 the dk/dv kernel takes query blocks of 32,
// so that dk, dv, s and dp fit the registers.
//
// float32 (flash_bwd_*_kernel): on the float32 CUDA cores, never through
// TF32, as the forward's float32 route: each lane scores two columns against
// its warp's 16 rows from tiles staged transposed and padded in shared
// memory, writes p and ds to its warp's strips, and accumulates hd / 32
// output columns a lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"
#include "mma_fragments.cuh"

namespace {

constexpr int kTile = 64;                   // rows a CTA owns (16 a warp)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kTile / kWarps;  // 16
constexpr int kTStride = kTile + 1;         // a transposed tile's padded row
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool allowed(int qp, int key, int sq, int t,
                                        int causal, int use_window,
                                        int window) {
  return qp < sq && key < t && (!causal || key <= qp) &&
         (!use_window || key > qp - window);
}

// the key blocks (of kTile) that query rows [q0, q0 + kTile) can see
__device__ __forceinline__ void key_blocks(int q0, int sq, int t, int causal,
                                           int use_window, int window,
                                           int& begin, int& end) {
  end = (t + kTile - 1) / kTile;
  if (causal) end = min(end, (min(q0 + kTile, sq) - 1) / kTile + 1);
  begin = 0;
  if (use_window) {
    const int first = q0 - window + 1;  // smallest key the window reaches
    begin = first > 0 ? first / kTile : 0;
  }
  if (end < begin) end = begin;
}

// the query blocks (of qb rows) that can see keys [k0, k0 + kTile)
__device__ __forceinline__ void query_blocks(int k0, int sq, int qb,
                                             int causal, int use_window,
                                             int window, int& begin,
                                             int& end) {
  end = (sq + qb - 1) / qb;
  begin = causal ? k0 / qb : 0;  // rows >= the first key
  if (use_window) {              // rows < the last key + window
    const long long last = static_cast<long long>(k0) + kTile + window - 2;
    end = last < 0 ? 0 : min(static_cast<long long>(end), last / qb + 1);
  }
  if (end < begin) end = begin;
}

// ---------------------------------------------------------------------------
// bfloat16 route: tensor cores (mma.sync)
// ---------------------------------------------------------------------------

template <int HD>
__host__ __device__ constexpr size_t dq_mma_smem_bytes() {
  // q and dout tiles, K and V double-buffered; lse and D of the rows
  return static_cast<size_t>(6 * kTile) * mma_stride<HD>() * sizeof(bf16) +
         2 * kTile * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ out,
    const float* __restrict__ lse, const bf16* __restrict__ dout,
    float* __restrict__ delta, bf16* __restrict__ dq, int sq, int t, int h,
    int kv, int causal, int use_window, int window, float scale) {
  constexpr int S = mma_stride<HD>();
  constexpr int kPieces = HD / 8;   // 16-byte pieces in a row
  constexpr int kDSteps = HD / 16;
  constexpr int kNTiles = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kTile][S]
  bf16* dos = qs + kTile * S;                    // [kTile][S]
  bf16* ks = dos + kTile * S;                    // [2][kTile][S]
  bf16* vs = ks + 2 * kTile * S;                 // [2][kTile][S]
  float* lse_s = reinterpret_cast<float*>(vs + 2 * kTile * S);  // [kTile]
  float* d_s = lse_s + kTile;                                   // [kTile]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int head = blockIdx.x % h;
  const int b = blockIdx.x / h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest first
  const int kvh = head / (h / kv);
  const size_t row_stride = static_cast<size_t>(h) * HD;
  const size_t q_base = (static_cast<size_t>(b) * sq * h + head) * HD;
  const size_t kv_base = (static_cast<size_t>(b) * t * kv + kvh) * HD;
  const size_t stat_base = (static_cast<size_t>(b) * h + head) * sq;

  int kb_begin, kb_end;
  key_blocks(q0, sq, t, causal, use_window, window, kb_begin, kb_end);

  for (int i = tid; i < kTile * kPieces; i += kThreads) {
    const int r = i / kPieces, c = i % kPieces;
    const bool ok = q0 + r < sq;
    const size_t off =
        q_base + static_cast<size_t>(ok ? q0 + r : 0) * row_stride + c * 8;
    cp_async16(smem_addr(qs + r * S + c * 8), q + off, ok);
    cp_async16(smem_addr(dos + r * S + c * 8), dout + off, ok);
  }
  cp_async_commit();
  auto load_kv = [&](int kb, int buf) {
    const int k0 = kb * kTile;
    for (int i = tid; i < kTile * kPieces; i += kThreads) {
      const int r = i / kPieces, c = i % kPieces;
      const bool ok = k0 + r < t;
      const size_t off =
          kv_base + static_cast<size_t>(ok ? k0 + r : 0) * kv * HD + c * 8;
      const int dst = (buf * kTile + r) * S + c * 8;
      cp_async16(smem_addr(ks + dst), k + off, ok);
      cp_async16(smem_addr(vs + dst), v + off, ok);
    }
  };
  if (kb_begin < kb_end) load_kv(kb_begin, 0);
  cp_async_commit();

  // D = sum(dout * out) of the warp's 16 rows, from device memory while the
  // tiles arrive; written for the dk/dv kernel
#pragma unroll 1
  for (int r = warp * kRowsPerWarp; r < (warp + 1) * kRowsPerWarp; ++r) {
    float acc = 0.0f;
    if (q0 + r < sq) {
      const size_t off = q_base + static_cast<size_t>(q0 + r) * row_stride;
      for (int d = lane; d < HD; d += 32)
        acc += __bfloat162float(dout[off + d]) * __bfloat162float(out[off + d]);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      d_s[r] = acc;
      if (q0 + r < sq) delta[stat_base + q0 + r] = acc;
    }
  }
  for (int i = tid; i < kTile; i += kThreads)
    lse_s[i] = q0 + i < sq ? lse[stat_base + q0 + i] * kLog2e : 0.0f;
  cp_async_wait<1>();  // the q and dout tiles
  __syncthreads();

  const int w_first = q0 + warp * 16, w_last = w_first + 15;
  const int ra = warp * 16 + (lane >> 2);  // this lane's rows: ra, ra + 8
  const int row_a = q0 + ra, row_b = row_a + 8;
  const float lse_a = lse_s[ra], lse_b = lse_s[ra + 8];
  const float d_a = d_s[ra], d_b = d_s[ra + 8];
  const float scale_log2 = scale * kLog2e;
  float acc[2 * kDSteps][4];
#pragma unroll
  for (int n = 0; n < 2 * kDSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int buf = (kb - kb_begin) & 1;
    if (kb + 1 < kb_end) load_kv(kb + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // block kb
    __syncthreads();
    const bf16* kbuf = ks + buf * kTile * S;
    const bf16* vbuf = vs + buf * kTile * S;
    const int k0 = kb * kTile;
    const bool visible = w_first < sq && !(causal && k0 > w_last) &&
                         !(use_window && k0 + kTile - 1 <= w_first - window);
    if (visible) {
      // s = q . k^T and dp = dout . v^T, 16 rows x 64 keys
      float s[kNTiles][4], dp[kNTiles][4];
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int ds = 0; ds < kDSteps; ++ds) {
        uint32_t qa[4], da[4];
        load_a(qa, qs + warp * 16 * S + ds * 16, S, lane);
        load_a(da, dos + warp * 16 * S + ds * 16, S, lane);
#pragma unroll
        for (int np = 0; np < kNTiles / 2; ++np) {
          uint32_t kf[4], vf[4];
          load_b(kf, kbuf + np * 16 * S + ds * 16, S, lane);
          load_b(vf, vbuf + np * 16 * S + ds * 16, S, lane);
          mma_bf16(s[2 * np], qa, kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
          mma_bf16(dp[2 * np], da, vf[0], vf[1]);
          mma_bf16(dp[2 * np + 1], da, vf[2], vf[3]);
        }
      }
      // ds = p * (dp - D) * scale, in place of s
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
          const bool hi = e >= 2;
          const bool ok = allowed(hi ? row_b : row_a, key, sq, t, causal,
                                  use_window, window);
          const float p =
              ok ? fast_exp2(fmaf(s[n][e], scale_log2, -(hi ? lse_b : lse_a)))
                 : 0.0f;
          s[n][e] = p * (dp[n][e] - (hi ? d_b : d_a)) * scale;
        }
      // dq += bf(ds) . k
#pragma unroll
      for (int kk = 0; kk < kNTiles / 2; ++kk) {
        uint32_t af[4];
        pack_a(af, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp2 = 0; dp2 < kDSteps; ++dp2) {
          uint32_t kf[4];
          load_b_trans(kf, kbuf + kk * 16 * S + dp2 * 16, S, lane);
          mma_bf16(acc[2 * dp2], af, kf[0], kf[1]);
          mma_bf16(acc[2 * dp2 + 1], af, kf[2], kf[3]);
        }
      }
    }
    __syncthreads();  // the buffer is read before the next load refills it
  }
  cp_async_wait<0>();

  const int rows[2] = {row_a, row_b};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= sq) continue;
    bf16* orow = dq + q_base + static_cast<size_t>(rows[i]) * row_stride +
                 (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < 2 * kDSteps; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// query rows a step of the dk/dv kernel: fewer at hd 128 (registers)
template <int HD>
__host__ __device__ constexpr int dkdv_q_block() {
  return HD == 128 ? 32 : 64;
}

template <int HD>
__host__ __device__ constexpr size_t dkdv_mma_smem_bytes() {
  constexpr int QB = dkdv_q_block<HD>();
  // K and V tiles, q and dout double-buffered; lse and D of the rows
  return static_cast<size_t>(2 * kTile + 4 * QB) * mma_stride<HD>() *
             sizeof(bf16) +
         4 * QB * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ lse,
    const bf16* __restrict__ dout, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int t, int h,
    int kv, int causal, int use_window, int window, float scale) {
  constexpr int S = mma_stride<HD>();
  constexpr int QB = dkdv_q_block<HD>();
  constexpr int kPieces = HD / 8;
  constexpr int kDSteps = HD / 16;
  constexpr int kNTiles = QB / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kTile][S]
  bf16* vs = ks + kTile * S;                     // [kTile][S]
  bf16* qs = vs + kTile * S;                     // [2][QB][S]
  bf16* dos = qs + 2 * QB * S;                   // [2][QB][S]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * QB * S);  // [2][QB]
  float* d_s = lse_s + 2 * QB;                                // [2][QB]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kvh = blockIdx.x % kv;
  const int b = blockIdx.x / kv;
  const int k0 = blockIdx.y * kTile;  // under a causal mask: heaviest first
  const int g = h / kv;
  const size_t row_stride = static_cast<size_t>(h) * HD;
  const size_t kv_base = (static_cast<size_t>(b) * t * kv + kvh) * HD;

  for (int i = tid; i < kTile * kPieces; i += kThreads) {
    const int r = i / kPieces, c = i % kPieces;
    const bool ok = k0 + r < t;
    const size_t off =
        kv_base + static_cast<size_t>(ok ? k0 + r : 0) * kv * HD + c * 8;
    cp_async16(smem_addr(ks + r * S + c * 8), k + off, ok);
    cp_async16(smem_addr(vs + r * S + c * 8), v + off, ok);
  }
  cp_async_commit();

  int qb_begin, qb_end;
  query_blocks(k0, sq, QB, causal, use_window, window, qb_begin, qb_end);
  const int n_qb = qb_end - qb_begin;
  const int n_steps = g * n_qb;  // (q head of the group, query block)
  auto load_q = [&](int step, int buf) {
    const int head = kvh * g + step / n_qb;
    const int q0 = (qb_begin + step % n_qb) * QB;
    const size_t q_base = (static_cast<size_t>(b) * sq * h + head) * HD;
    for (int i = tid; i < QB * kPieces; i += kThreads) {
      const int r = i / kPieces, c = i % kPieces;
      const bool ok = q0 + r < sq;
      const size_t off =
          q_base + static_cast<size_t>(ok ? q0 + r : 0) * row_stride + c * 8;
      const int dst = (buf * QB + r) * S + c * 8;
      cp_async16(smem_addr(qs + dst), q + off, ok);
      cp_async16(smem_addr(dos + dst), dout + off, ok);
    }
    const size_t stat_base = (static_cast<size_t>(b) * h + head) * sq;
    for (int i = tid; i < QB; i += kThreads) {
      const bool ok = q0 + i < sq;
      lse_s[buf * QB + i] = ok ? lse[stat_base + q0 + i] * kLog2e : 0.0f;
      d_s[buf * QB + i] = ok ? delta[stat_base + q0 + i] : 0.0f;
    }
  };
  if (n_steps > 0) load_q(0, 0);
  cp_async_commit();

  const int w_first = k0 + warp * 16, w_last = w_first + 15;
  const int key_a = w_first + (lane >> 2), key_b = key_a + 8;
  const float scale_log2 = scale * kLog2e;
  float dka[2 * kDSteps][4], dva[2 * kDSteps][4];
#pragma unroll
  for (int n = 0; n < 2 * kDSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < n_steps) load_q(step + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // step's tiles (and, at step 0, K and V)
    __syncthreads();
    const int q0 = (qb_begin + step % n_qb) * QB;
    const bf16* qbuf = qs + buf * QB * S;
    const bf16* dobuf = dos + buf * QB * S;
    const float* lbuf = lse_s + buf * QB;
    const float* dbuf = d_s + buf * QB;
    // a block that none of this warp's keys is seen by adds nothing
    const bool visible = w_first < t && !(causal && q0 + QB - 1 < w_first) &&
                         !(use_window && q0 >= w_last + window);
    if (visible) {
      // s^T = k . q^T and dp^T = v . dout^T, 16 keys x QB queries
      float st[kNTiles][4], dpt[kNTiles][4];
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
#pragma unroll
      for (int ds = 0; ds < kDSteps; ++ds) {
        uint32_t ka[4], va[4];
        load_a(ka, ks + warp * 16 * S + ds * 16, S, lane);
        load_a(va, vs + warp * 16 * S + ds * 16, S, lane);
#pragma unroll
        for (int np = 0; np < kNTiles / 2; ++np) {
          uint32_t qf[4], of[4];
          load_b(qf, qbuf + np * 16 * S + ds * 16, S, lane);
          load_b(of, dobuf + np * 16 * S + ds * 16, S, lane);
          mma_bf16(st[2 * np], ka, qf[0], qf[1]);
          mma_bf16(st[2 * np + 1], ka, qf[2], qf[3]);
          mma_bf16(dpt[2 * np], va, of[0], of[1]);
          mma_bf16(dpt[2 * np + 1], va, of[2], of[3]);
        }
      }
      // p^T in place of s^T, ds^T in place of dp^T
#pragma unroll
      for (int n = 0; n < kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = n * 8 + (lane & 3) * 2 + (e & 1);
          const bool ok = allowed(q0 + qi, e >= 2 ? key_b : key_a, sq, t,
                                  causal, use_window, window);
          const float p =
              ok ? fast_exp2(fmaf(st[n][e], scale_log2, -lbuf[qi])) : 0.0f;
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dbuf[qi]) * scale;
        }
      // dv += bf(p)^T . dout and dk += bf(ds)^T . q
#pragma unroll
      for (int kk = 0; kk < kNTiles / 2; ++kk) {
        uint32_t pf[4], sf[4];
        pack_a(pf, st[2 * kk], st[2 * kk + 1]);
        pack_a(sf, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int dp2 = 0; dp2 < kDSteps; ++dp2) {
          uint32_t of[4], qf[4];
          load_b_trans(of, dobuf + kk * 16 * S + dp2 * 16, S, lane);
          mma_bf16(dva[2 * dp2], pf, of[0], of[1]);
          mma_bf16(dva[2 * dp2 + 1], pf, of[2], of[3]);
          load_b_trans(qf, qbuf + kk * 16 * S + dp2 * 16, S, lane);
          mma_bf16(dka[2 * dp2], sf, qf[0], qf[1]);
          mma_bf16(dka[2 * dp2 + 1], sf, qf[2], qf[3]);
        }
      }
    }
    __syncthreads();  // the buffer is read before the next load refills it
  }
  cp_async_wait<0>();

  const int keys[2] = {key_a, key_b};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= t) continue;
    const size_t off =
        kv_base + static_cast<size_t>(keys[i]) * kv * HD + (lane & 3) * 2;
#pragma unroll
    for (int n = 0; n < 2 * kDSteps; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + n * 8) =
          __floats2bfloat162_rn(dka[n][2 * i], dka[n][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + n * 8) =
          __floats2bfloat162_rn(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32 route: CUDA cores
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t dq_smem_floats() {
  return static_cast<size_t>(2 * kTile) * HD       // q and dout tiles
         + static_cast<size_t>(2 * HD) * kTStride  // K and V, transposed
         + static_cast<size_t>(kTile) * kTile;     // ds, one strip a warp
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ out,
    const float* __restrict__ lse, const float* __restrict__ dout,
    float* __restrict__ delta, float* __restrict__ dq, int sq, int t, int h,
    int kv, int causal, int use_window, int window, float scale) {
  constexpr int kDpl = HD >= 32 ? HD / 32 : 1;  // output columns a lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kTile][HD]
  float* dos = qs + kTile * HD;                 // [kTile][HD]
  float* kt = dos + kTile * HD;                 // [HD][kTStride]
  float* vt = kt + HD * kTStride;               // [HD][kTStride]
  float* ps = vt + HD * kTStride;               // [kTile][kTile]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kTile;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / kv);
  const int r0 = warp * kRowsPerWarp;
  const size_t q_base = (static_cast<size_t>(b) * sq * h + head) * HD;
  const size_t row_stride = static_cast<size_t>(h) * HD;
  const size_t stat_base = (static_cast<size_t>(b) * h + head) * sq;

  for (int i = tid; i < kTile * HD; i += kThreads) {
    const int row = q0 + i / HD;
    const size_t off = q_base + static_cast<size_t>(row) * row_stride + i % HD;
    qs[i] = row < sq ? q[off] : 0.0f;
    dos[i] = row < sq ? dout[off] : 0.0f;
  }
  __syncthreads();

  // D and the lse of the warp's rows, every lane holding all 16
  float dr[kRowsPerWarp], lr[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + r0 + r;
    float acc = 0.0f;
    if (row < sq) {
      const float* orow = out + q_base + static_cast<size_t>(row) * row_stride;
      for (int d = lane; d < HD; d += 32)
        acc = fmaf(dos[(r0 + r) * HD + d], orow[d], acc);
    }
    dr[r] = warp_sum(acc);
    lr[r] = row < sq ? lse[stat_base + row] : 0.0f;
    if (lane == 0 && row < sq) delta[stat_base + row] = dr[r];
  }

  int kb_begin, kb_end;
  key_blocks(q0, sq, t, causal, use_window, window, kb_begin, kb_end);
  float acc[kRowsPerWarp][kDpl];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < kDpl; ++i) acc[r][i] = 0.0f;
  float* pw = ps + r0 * kTile;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    __syncthreads();  // the last block is read
    const int k0 = kb * kTile;
    for (int i = tid; i < kTile * HD; i += kThreads) {
      const int j = i / HD, d = i % HD, key = k0 + j;
      float kval = 0.0f, vval = 0.0f;
      if (key < t) {
        const size_t off =
            ((static_cast<size_t>(b) * t + key) * kv + kvh) * HD + d;
        kval = k[off];
        vval = v[off];
      }
      kt[d * kTStride + j] = kval;
      vt[d * kTStride + j] = vval;
    }
    __syncthreads();

    // s and dp of keys k0 + lane and k0 + lane + 32 against the warp's rows
    float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float ka[4], kb2[4], va[4], vb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ka[u] = kt[(d + u) * kTStride + lane];
        kb2[u] = kt[(d + u) * kTStride + lane + 32];
        va[u] = vt[(d + u) * kTStride + lane];
        vb[u] = vt[(d + u) * kTStride + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (r0 + r) * HD + d);
        const float4 ov =
            *reinterpret_cast<const float4*>(dos + (r0 + r) * HD + d);
        s[r][0] = fmaf(qv.x, ka[0], s[r][0]);
        s[r][0] = fmaf(qv.y, ka[1], s[r][0]);
        s[r][0] = fmaf(qv.z, ka[2], s[r][0]);
        s[r][0] = fmaf(qv.w, ka[3], s[r][0]);
        s[r][1] = fmaf(qv.x, kb2[0], s[r][1]);
        s[r][1] = fmaf(qv.y, kb2[1], s[r][1]);
        s[r][1] = fmaf(qv.z, kb2[2], s[r][1]);
        s[r][1] = fmaf(qv.w, kb2[3], s[r][1]);
        dp[r][0] = fmaf(ov.x, va[0], dp[r][0]);
        dp[r][0] = fmaf(ov.y, va[1], dp[r][0]);
        dp[r][0] = fmaf(ov.z, va[2], dp[r][0]);
        dp[r][0] = fmaf(ov.w, va[3], dp[r][0]);
        dp[r][1] = fmaf(ov.x, vb[0], dp[r][1]);
        dp[r][1] = fmaf(ov.y, vb[1], dp[r][1]);
        dp[r][1] = fmaf(ov.z, vb[2], dp[r][1]);
        dp[r][1] = fmaf(ov.w, vb[3], dp[r][1]);
      }
    }

    // ds = p * (dp - D) * scale into the warp's strip
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qp = q0 + r0 + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + lane + 32 * c;
        const float p =
            allowed(qp, key, sq, t, causal, use_window, window)
                ? expf(s[r][c] * scale - lr[r])
                : 0.0f;
        pw[r * kTile + lane + 32 * c] = p * (dp[r][c] - dr[r]) * scale;
      }
    }
    __syncwarp();

    // dq += ds . k: lane owns columns lane, lane + 32, ...; k[j][d] is
    // kt[d][j], the lanes' reads on distinct banks
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float kk[4][kDpl];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < kDpl; ++i) {
          const int d = lane + 32 * i;
          kk[u][i] = d < HD ? kt[d * kTStride + j + u] : 0.0f;
        }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + r * kTile + j);
#pragma unroll
        for (int i = 0; i < kDpl; ++i) {
          acc[r][i] = fmaf(p4.x, kk[0][i], acc[r][i]);
          acc[r][i] = fmaf(p4.y, kk[1][i], acc[r][i]);
          acc[r][i] = fmaf(p4.z, kk[2][i], acc[r][i]);
          acc[r][i] = fmaf(p4.w, kk[3][i], acc[r][i]);
        }
      }
    }
    __syncwarp();  // the strip is read before the next block writes it
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + r0 + r;
    if (row >= sq) continue;
    float* o = dq + q_base + static_cast<size_t>(row) * row_stride;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) o[d] = acc[r][i];
    }
  }
}

template <int HD>
constexpr size_t dkdv_smem_floats() {
  return static_cast<size_t>(2 * kTile) * HD       // K and V tiles
         + static_cast<size_t>(2 * HD) * kTStride  // q and dout, transposed
         + static_cast<size_t>(2 * kTile) * kTile  // p and ds strips
         + static_cast<size_t>(2 * kTile);         // lse and D of the rows
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ lse,
    const float* __restrict__ dout, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int sq, int t, int h,
    int kv, int causal, int use_window, int window, float scale) {
  constexpr int kDpl = HD >= 32 ? HD / 32 : 1;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kTile][HD]
  float* vs = ks + kTile * HD;                  // [kTile][HD]
  float* qt = vs + kTile * HD;                  // [HD][kTStride]
  float* ot = qt + HD * kTStride;               // [HD][kTStride]
  float* ps = ot + HD * kTStride;               // [kTile][kTile]
  float* dss = ps + kTile * kTile;              // [kTile][kTile]
  float* lse_s = dss + kTile * kTile;           // [kTile]
  float* d_s = lse_s + kTile;                   // [kTile]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / kv;
  const int r0 = warp * kRowsPerWarp;
  const size_t row_stride = static_cast<size_t>(h) * HD;

  for (int i = tid; i < kTile * HD; i += kThreads) {
    const int key = k0 + i / HD;
    const size_t off =
        ((static_cast<size_t>(b) * t + key) * kv + kvh) * HD + i % HD;
    ks[i] = key < t ? k[off] : 0.0f;
    vs[i] = key < t ? v[off] : 0.0f;
  }

  int qb_begin, qb_end;
  query_blocks(k0, sq, kTile, causal, use_window, window, qb_begin, qb_end);
  const int w_first = k0 + r0, w_last = w_first + kRowsPerWarp - 1;
  float dka[kRowsPerWarp][kDpl], dva[kRowsPerWarp][kDpl];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < kDpl; ++i) dka[r][i] = dva[r][i] = 0.0f;
  float* pw = ps + r0 * kTile;
  float* sw = dss + r0 * kTile;

  for (int gi = 0; gi < g; ++gi) {
    const int head = kvh * g + gi;
    const size_t q_base = (static_cast<size_t>(b) * sq * h + head) * HD;
    const size_t stat_base = (static_cast<size_t>(b) * h + head) * sq;
    for (int qb = qb_begin; qb < qb_end; ++qb) {
      const int q0 = qb * kTile;
      __syncthreads();  // the last block is read (and K, V are staged)
      for (int i = tid; i < kTile * HD; i += kThreads) {
        const int j = i / HD, d = i % HD, row = q0 + j;
        const size_t off = q_base + static_cast<size_t>(row) * row_stride + d;
        qt[d * kTStride + j] = row < sq ? q[off] : 0.0f;
        ot[d * kTStride + j] = row < sq ? dout[off] : 0.0f;
      }
      for (int i = tid; i < kTile; i += kThreads) {
        const bool ok = q0 + i < sq;
        lse_s[i] = ok ? lse[stat_base + q0 + i] : 0.0f;
        d_s[i] = ok ? delta[stat_base + q0 + i] : 0.0f;
      }
      __syncthreads();
      const bool visible = w_first < t && !(causal && q0 + kTile - 1 < w_first)
                           && !(use_window && q0 >= w_last + window);
      if (!visible) continue;

      // s^T and dp^T of queries q0 + lane and q0 + lane + 32 against the
      // warp's 16 keys
      float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.0f;
#pragma unroll 2
      for (int d = 0; d < HD; d += 4) {
        float qa[4], qb2[4], oa[4], ob[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          qa[u] = qt[(d + u) * kTStride + lane];
          qb2[u] = qt[(d + u) * kTStride + lane + 32];
          oa[u] = ot[(d + u) * kTStride + lane];
          ob[u] = ot[(d + u) * kTStride + lane + 32];
        }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float4 kv4 =
              *reinterpret_cast<const float4*>(ks + (r0 + r) * HD + d);
          const float4 vv4 =
              *reinterpret_cast<const float4*>(vs + (r0 + r) * HD + d);
          s[r][0] = fmaf(kv4.x, qa[0], s[r][0]);
          s[r][0] = fmaf(kv4.y, qa[1], s[r][0]);
          s[r][0] = fmaf(kv4.z, qa[2], s[r][0]);
          s[r][0] = fmaf(kv4.w, qa[3], s[r][0]);
          s[r][1] = fmaf(kv4.x, qb2[0], s[r][1]);
          s[r][1] = fmaf(kv4.y, qb2[1], s[r][1]);
          s[r][1] = fmaf(kv4.z, qb2[2], s[r][1]);
          s[r][1] = fmaf(kv4.w, qb2[3], s[r][1]);
          dp[r][0] = fmaf(vv4.x, oa[0], dp[r][0]);
          dp[r][0] = fmaf(vv4.y, oa[1], dp[r][0]);
          dp[r][0] = fmaf(vv4.z, oa[2], dp[r][0]);
          dp[r][0] = fmaf(vv4.w, oa[3], dp[r][0]);
          dp[r][1] = fmaf(vv4.x, ob[0], dp[r][1]);
          dp[r][1] = fmaf(vv4.y, ob[1], dp[r][1]);
          dp[r][1] = fmaf(vv4.z, ob[2], dp[r][1]);
          dp[r][1] = fmaf(vv4.w, ob[3], dp[r][1]);
        }
      }

      // p^T and ds^T into the warp's strips
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int key = w_first + r;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = lane + 32 * c;
          const float p =
              allowed(q0 + qi, key, sq, t, causal, use_window, window)
                  ? expf(s[r][c] * scale - lse_s[qi])
                  : 0.0f;
          pw[r * kTile + qi] = p;
          sw[r * kTile + qi] = p * (dp[r][c] - d_s[qi]) * scale;
        }
      }
      __syncwarp();

      // dv += p^T . dout, then dk += ds^T . q: lane owns columns lane,
      // lane + 32, ...; dout[j][d] is ot[d][j]
#pragma unroll 2
      for (int j = 0; j < kTile; j += 4) {
        float oo[4][kDpl];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int i = 0; i < kDpl; ++i) {
            const int d = lane + 32 * i;
            oo[u][i] = d < HD ? ot[d * kTStride + j + u] : 0.0f;
          }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(pw + r * kTile + j);
#pragma unroll
          for (int i = 0; i < kDpl; ++i) {
            dva[r][i] = fmaf(p4.x, oo[0][i], dva[r][i]);
            dva[r][i] = fmaf(p4.y, oo[1][i], dva[r][i]);
            dva[r][i] = fmaf(p4.z, oo[2][i], dva[r][i]);
            dva[r][i] = fmaf(p4.w, oo[3][i], dva[r][i]);
          }
        }
      }
#pragma unroll 2
      for (int j = 0; j < kTile; j += 4) {
        float qq[4][kDpl];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int i = 0; i < kDpl; ++i) {
            const int d = lane + 32 * i;
            qq[u][i] = d < HD ? qt[d * kTStride + j + u] : 0.0f;
          }
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float4 s4 =
              *reinterpret_cast<const float4*>(sw + r * kTile + j);
#pragma unroll
          for (int i = 0; i < kDpl; ++i) {
            dka[r][i] = fmaf(s4.x, qq[0][i], dka[r][i]);
            dka[r][i] = fmaf(s4.y, qq[1][i], dka[r][i]);
            dka[r][i] = fmaf(s4.z, qq[2][i], dka[r][i]);
            dka[r][i] = fmaf(s4.w, qq[3][i], dka[r][i]);
          }
        }
      }
      __syncwarp();  // the strips are read before the next block writes them
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int key = w_first + r;
    if (key >= t) continue;
    const size_t off =
        ((static_cast<size_t>(b) * t + key) * kv + kvh) * HD;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) {
        dk[off + d] = dka[r][i];
        dv[off + d] = dva[r][i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *out, *lse, *dout;
  void *delta, *dq, *dk, *dv;
  int b, sq, t, h, kv, causal, use_window, window;
  float scale;
};

template <int HD>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem_floats<HD>() * sizeof(float);
  constexpr size_t smem_dkdv = dkdv_smem_floats<HD>() * sizeof(float);
  auto dq_kernel = flash_bwd_dq_kernel<HD>;
  auto dkdv_kernel = flash_bwd_dkdv_kernel<HD>;
  static bool dq_in = false, dkdv_in = false;
  cudaError_t e = opt_in(dq_kernel, smem_dq, dq_in);
  if (e == cudaSuccess) e = opt_in(dkdv_kernel, smem_dkdv, dkdv_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  using F = const float*;
  dq_kernel<<<dim3((a.sq + kTile - 1) / kTile, a.h, a.b), kThreads, smem_dq,
              stream>>>(
      static_cast<F>(a.q), static_cast<F>(a.k), static_cast<F>(a.v),
      static_cast<F>(a.out), static_cast<F>(a.lse), static_cast<F>(a.dout),
      static_cast<float*>(a.delta), static_cast<float*>(a.dq), a.sq, a.t,
      a.h, a.kv, a.causal, a.use_window, a.window, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkdv_kernel<<<dim3((a.t + kTile - 1) / kTile, a.kv, a.b), kThreads,
                smem_dkdv, stream>>>(
      static_cast<F>(a.q), static_cast<F>(a.k), static_cast<F>(a.v),
      static_cast<F>(a.lse), static_cast<F>(a.dout),
      static_cast<F>(a.delta), static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.sq, a.t, a.h, a.kv, a.causal,
      a.use_window, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const Args& a, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_mma_smem_bytes<HD>();
  constexpr size_t smem_dkdv = dkdv_mma_smem_bytes<HD>();
  auto dq_kernel = flash_bwd_dq_mma_kernel<HD>;
  auto dkdv_kernel = flash_bwd_dkdv_mma_kernel<HD>;
  static bool dq_in = false, dkdv_in = false;
  cudaError_t e = opt_in(dq_kernel, smem_dq, dq_in);
  if (e == cudaSuccess) e = opt_in(dkdv_kernel, smem_dkdv, dkdv_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  using B = const bf16*;
  // (batch x head) fastest, the q tile slowest, reversed: heaviest first
  dq_kernel<<<dim3(a.b * a.h, (a.sq + kTile - 1) / kTile), kThreads, smem_dq,
              stream>>>(
      static_cast<B>(a.q), static_cast<B>(a.k), static_cast<B>(a.v),
      static_cast<B>(a.out), static_cast<const float*>(a.lse),
      static_cast<B>(a.dout), static_cast<float*>(a.delta),
      static_cast<bf16*>(a.dq), a.sq, a.t, a.h, a.kv, a.causal,
      a.use_window, a.window, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // (batch x kv head) fastest, the key block slowest: under a causal mask
  // the first key blocks see the most queries and start first
  dkdv_kernel<<<dim3(a.b * a.kv, (a.t + kTile - 1) / kTile), kThreads,
                smem_dkdv, stream>>>(
      static_cast<B>(a.q), static_cast<B>(a.k), static_cast<B>(a.v),
      static_cast<const float*>(a.lse), static_cast<B>(a.dout),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.sq, a.t, a.h, a.kv, a.causal,
      a.use_window, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(int bf16_route, const Args& a, cudaStream_t stream) {
  return bf16_route ? launch_bf16<HD>(a, stream) : launch_f32<HD>(a, stream);
}

}  // namespace

// q, out, dout, dq (b, sq, h, hd), k, v, dk, dv (b, t, kv, hd), lse and
// delta (b, h, sq) float32 (delta: scratch the call fills with D); all
// contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1, q, k, v and dout
// 16-byte aligned); hd in {16, 32, 64, 128}, h % kv == 0, b, sq, t > 0.
// Two kernels, in stream order. Returns the first failed launch's
// cudaError_t (0 on success).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, int b, int sq, int t, int h, int kv, int hd, int causal,
    int use_window, int window, float scale, int bf16, void* stream) {
  if (b <= 0 || sq <= 0 || t <= 0 || kv <= 0 || h % kv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  k,  v,  out, lse,    dout,       delta,  dq,    dk, dv,
               b,  sq, t,  h,   kv,     causal,     use_window, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(bf16, a, s);
    case 32:
      return launch<32>(bf16, a, s);
    case 64:
      return launch<64>(bf16, a, s);
    case 128:
      return launch<128>(bf16, a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
