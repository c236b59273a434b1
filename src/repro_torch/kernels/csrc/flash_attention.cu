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
// must not go through TF32, which keeps about three decimal digits). One
// CTA owns a tile of 64 query rows of one head of one batch row and loops
// over K/V itself, staged through shared memory in blocks of 64 keys. Each
// of the 4 warps owns 16 of the rows and keeps their m, l and accumulator
// in registers: a lane scores 2 keys against the 16 rows (q rows read as
// float4 broadcasts, K stored transposed and padded so the lanes' reads hit
// distinct banks), the warp reduces max and sum with shuffles, writes p to
// its own strip of shared memory, and each lane then accumulates hd / 32
// output columns (fewer lanes work at hd 16). Under the causal mask the
// loop stops at the block that holds the tile's last row; under a window it
// starts at the first block the window reaches.
//
// Both routes mask ragged Sq and T, so neither needs padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "async_copy.cuh"
#include "mma_fragments.cuh"

namespace {

constexpr int kRows = 64;                     // query rows per CTA
constexpr int kKeys = 64;                     // keys per staged block
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kRows / kWarps;  // 16

// ---------------------------------------------------------------------------
// float32 route: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kKtStride = kKeys + 1;          // transposed K, padded row

template <int HD>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kRows) * HD        // q tile
         + static_cast<size_t>(HD) * kKtStride  // K block, transposed
         + static_cast<size_t>(kKeys) * HD      // V block
         + static_cast<size_t>(kRows) * kKeys;  // p, one strip per warp
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int sq, int t, int h, int kv, int causal,
    int use_window, int window, float scale) {
  constexpr int kDpl = HD >= 32 ? HD / 32 : 1;  // output columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kRows][HD]
  float* kt = qs + kRows * HD;                  // [HD][kKtStride]
  float* vs = kt + HD * kKtStride;              // [kKeys][HD]
  float* ps = vs + kKeys * HD;                  // [kRows][kKeys]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kRows;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / kv);
  const int r0 = warp * kRowsPerWarp;

  for (int i = tid; i < kRows * HD; i += kWarps * 32) {
    const int row = q0 + i / HD;
    qs[i] = row < sq ? q[((static_cast<size_t>(b) * sq + row) * h + head) *
                             HD +
                         i % HD]
                     : 0.0f;
  }

  // the key blocks this tile can see
  int kb_end = (t + kKeys - 1) / kKeys;
  if (causal) {
    const int last = min(q0 + kRows, sq) - 1;
    kb_end = min(kb_end, last / kKeys + 1);
  }
  int kb_begin = 0;
  if (use_window) {
    const int first = q0 - window + 1;  // smallest key the window reaches
    kb_begin = first > 0 ? first / kKeys : 0;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDpl];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) acc[r][i] = 0.0f;
  }
  float* pw = ps + r0 * kKeys;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    __syncthreads();  // the last block is read (and q is staged)
    const int k0 = kb * kKeys;
    for (int i = tid; i < kKeys * HD; i += kWarps * 32) {
      const int j = i / HD, d = i % HD, key = k0 + j;
      float kval = 0.0f, vval = 0.0f;
      if (key < t) {
        const size_t off =
            ((static_cast<size_t>(b) * t + key) * kv + kvh) * HD + d;
        kval = k[off];
        vval = v[off];
      }
      kt[d * kKtStride + j] = kval;
      vs[j * HD + d] = vval;
    }
    __syncthreads();

    // scores of keys k0 + lane and k0 + lane + 32 against the warp's rows
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float ka[4], kb2[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        ka[u] = kt[(d + u) * kKtStride + lane];
        kb2[u] = kt[(d + u) * kKtStride + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (r0 + r) * HD + d);
        s[r][0] = fmaf(qv.x, ka[0], s[r][0]);
        s[r][0] = fmaf(qv.y, ka[1], s[r][0]);
        s[r][0] = fmaf(qv.z, ka[2], s[r][0]);
        s[r][0] = fmaf(qv.w, ka[3], s[r][0]);
        s[r][1] = fmaf(qv.x, kb2[0], s[r][1]);
        s[r][1] = fmaf(qv.y, kb2[1], s[r][1]);
        s[r][1] = fmaf(qv.z, kb2[2], s[r][1]);
        s[r][1] = fmaf(qv.w, kb2[3], s[r][1]);
      }
    }

    // mask, running statistics, p into the warp's strip
    const int key_a = k0 + lane, key_b = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qp = q0 + r0 + r;
      const bool ok_a = key_a < t && (!causal || key_a <= qp) &&
                        (!use_window || key_a > qp - window);
      const bool ok_b = key_b < t && (!causal || key_b <= qp) &&
                        (!use_window || key_b > qp - window);
      const float sa = ok_a ? s[r][0] * scale : -INFINITY;
      const float sb = ok_b ? s[r][1] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sa, sb)));
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      const float pa = ok_a ? expf(sa - m_safe) : 0.0f;
      const float pb = ok_b ? expf(sb - m_safe) : 0.0f;
      const float corr = m[r] == -INFINITY ? 0.0f : expf(m[r] - m_safe);
      l[r] = l[r] * corr + warp_sum(pa + pb);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < kDpl; ++i) acc[r][i] *= corr;
      pw[r * kKeys + lane] = pa;
      pw[r * kKeys + lane + 32] = pb;
    }
    __syncwarp();

    // acc += p @ v: lane owns columns lane, lane + 32, ...
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      float vv[4][kDpl];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < kDpl; ++i) {
          const int d = lane + 32 * i;
          vv[u][i] = d < HD ? vs[(j + u) * HD + d] : 0.0f;
        }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + r * kKeys + j);
#pragma unroll
        for (int i = 0; i < kDpl; ++i) {
          acc[r][i] = fmaf(p4.x, vv[0][i], acc[r][i]);
          acc[r][i] = fmaf(p4.y, vv[1][i], acc[r][i]);
          acc[r][i] = fmaf(p4.z, vv[2][i], acc[r][i]);
          acc[r][i] = fmaf(p4.w, vv[3][i], acc[r][i]);
        }
      }
    }
    __syncwarp();  // the strip is read before the next block writes it
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + r0 + r;
    if (row >= sq) continue;
    const float denom = fmaxf(l[r], 1e-20f);
    float* o = out + ((static_cast<size_t>(b) * sq + row) * h + head) * HD;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) o[d] = acc[r][i] / denom;
    }
    if (lane == 0)
      lse[(static_cast<size_t>(b) * h + head) * sq + row] =
          (m[r] == -INFINITY ? 0.0f : m[r]) + logf(denom);
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
    int use_window, int window, float scale_log2) {
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
  int kb_end = (t + kKeys - 1) / kKeys;
  if (causal) {
    const int last = min(q0 + kRows, sq) - 1;
    kb_end = min(kb_end, last / kKeys + 1);
  }
  int kb_begin = 0;
  if (use_window) {
    const int first = q0 - window + 1;  // smallest key the window reaches
    kb_begin = first > 0 ? first / kKeys : 0;
  }

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

  // the warp's rows, this lane's two of them (g and g + 8), their state
  const int w_first = q0 + warp * 16, w_last = w_first + 15;
  const int row_a = w_first + (lane >> 2);
  const int row_b = row_a + 8;
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
    const bool visible = w_first < sq && !(causal && k0 > w_last) &&
                         !(use_window && k0 + kKeys - 1 <= w_first - window);
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
                        (causal && k0 + kKeys - 1 > w_first) ||
                        (use_window && k0 <= w_last - window);
      if (edge) {
#pragma unroll
        for (int n = 0; n < kNTiles; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            const bool ok = key < t && (!causal || key <= row) &&
                            (!use_window || key > row - window);
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

  const int rows[2] = {row_a, row_b};
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
               int use_window, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<HD>() * sizeof(float);
  auto kernel = flash_attention_kernel<HD>;
  static bool opted_in = false;
  const cudaError_t e = opt_in(kernel, smem, opted_in);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((sq + kRows - 1) / kRows, h, b);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), sq, t, h, kv, causal, use_window, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int b, int sq, int t, int h, int kv, int causal,
                int use_window, int window, float scale,
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
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(int bf16_route, const void* q, const void* k, const void* v,
           void* out, void* lse, int b, int sq, int t, int h, int kv,
           int causal, int use_window, int window, float scale,
           cudaStream_t stream) {
  return bf16_route
             ? launch_bf16<HD>(q, k, v, out, lse, b, sq, t, h, kv, causal,
                               use_window, window, scale, stream)
             : launch_f32<HD>(q, k, v, out, lse, b, sq, t, h, kv, causal,
                              use_window, window, scale, stream);
}

}  // namespace

// q (b, sq, h, hd), k and v (b, t, kv, hd), out like q, lse (b, h, sq)
// float32; all contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1, every
// pointer 16-byte aligned); hd in {16, 32, 64, 128}, h % kv == 0. Returns
// the launch's cudaError_t (0 on success).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, void* lse, int b,
    int sq, int t, int h, int kv, int hd, int causal, int use_window,
    int window, float scale, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(bf16, q, k, v, out, lse, b, sq, t, h, kv, causal,
                        use_window, window, scale, s);
    case 32:
      return launch<32>(bf16, q, k, v, out, lse, b, sq, t, h, kv, causal,
                        use_window, window, scale, s);
    case 64:
      return launch<64>(bf16, q, k, v, out, lse, b, sq, t, h, kv, causal,
                        use_window, window, scale, s);
    case 128:
      return launch<128>(bf16, q, k, v, out, lse, b, sq, t, h, kv, causal,
                         use_window, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
