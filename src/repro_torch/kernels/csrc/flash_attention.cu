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
// before the p @ v product (a no-op in float32).
//
// What bounds it on the H100. At the serving shape (q (1, 512, 32, 64), K/V
// with 4 heads, bf16, causal) bytes: q, k, v, out and the lse are about
// 4.6 MB, 1.4 us at 3.35 TB/s, against 2*2*32*512*512*64 / 2 = 1.1 GFLOP
// under the causal mask, 1.1 us at 989 TFLOP/s. At long T operations: about
// 2*B*H*Sq*T*hd under the causal mask, 137 GFLOP at (8, 2048, 32, 64).
//
// Design. The TPU kernel keeps the whole (T, hd) K/V panel of a head in
// VMEM; 227 KB of shared memory cannot hold it at T = 4096, and the grid
// runs in no order. So one CTA owns a tile of 64 query rows of one head of
// one batch row and loops over K/V itself, staged through shared memory in
// blocks of 64 keys (converted to float32 on the way in, through the
// intrinsics for bf16). Each of the 4 warps owns 16 of the rows and keeps
// their m, l and accumulator in registers: a lane scores 2 keys against the
// 16 rows (q rows read as float4 broadcasts, K stored transposed and padded
// so the lanes' reads hit distinct banks), the warp reduces max and sum with
// shuffles, writes p to its own strip of shared memory, and each lane then
// accumulates hd / 32 output columns (fewer lanes work at hd 16). Under the
// causal mask the loop stops at the block that holds the tile's last row,
// as the TPU kernel does; under a window it starts at the first block the
// window reaches. Ragged Sq and T are masked, so neither needs padding. All
// products run on the float32 CUDA cores: mma.sync, wgmma and TMA are later
// work, so at long T this kernel is far from its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kRows = 64;                     // query rows per CTA
constexpr int kKeys = 64;                     // keys per staged block
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kRows / kWarps;  // 16
constexpr int kKtStride = kKeys + 1;          // transposed K, padded row

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// p in the input type, as the TPU kernel's p.astype(v.dtype)
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kRows) * HD        // q tile
         + static_cast<size_t>(HD) * kKtStride  // K block, transposed
         + static_cast<size_t>(kKeys) * HD      // V block
         + static_cast<size_t>(kRows) * kKeys;  // p, one strip per warp
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    int sq, int t, int h, int kv, int causal, int use_window, int window,
    float scale) {
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
    qs[i] = row < sq
                ? to_f32(q[((static_cast<size_t>(b) * sq + row) * h + head) *
                               HD +
                           i % HD])
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
        kval = to_f32(k[off]);
        vval = to_f32(v[off]);
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
      pw[r * kKeys + lane] = round_as(pa, q);
      pw[r * kKeys + lane + 32] = round_as(pb, q);
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
    T* o = out + ((static_cast<size_t>(b) * sq + row) * h + head) * HD;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) store(o + d, acc[r][i] / denom);
    }
    if (lane == 0)
      lse[(static_cast<size_t>(b) * h + head) * sq + row] =
          (m[r] == -INFINITY ? 0.0f : m[r]) + logf(denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int b, int sq, int t, int h, int kv, int causal, int use_window,
           int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<HD>() * sizeof(float);
  auto kernel = flash_attention_kernel<T, HD>;
  // above 48 KB a launch needs the opt-in; once per instantiation
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid((sq + kRows - 1) / kRows, h, b);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), sq, t, h, kv, causal, use_window, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             void* lse, int b, int sq, int t, int h, int kv, int causal,
             int use_window, int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, out, lse, b, sq, t, h, kv, causal,
                           use_window, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, lse, b, sq, t, h, kv, causal,
                           use_window, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, b, sq, t, h, kv, causal,
                           use_window, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, b, sq, t, h, kv, causal,
                            use_window, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (b, sq, h, hd), k and v (b, t, kv, hd), out like q, lse (b, h, sq)
// float32; all contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// hd in {16, 32, 64, 128}, h % kv == 0. Returns the launch's cudaError_t
// (0 on success).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, void* lse, int b,
    int sq, int t, int h, int kv, int hd, int causal, int use_window,
    int window, float scale, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(hd, q, k, v, out, lse, b, sq, t, h,
                                        kv, causal, use_window, window, scale,
                                        s)
              : dispatch<float>(hd, q, k, v, out, lse, b, sq, t, h, kv,
                                causal, use_window, window, scale, s);
}
