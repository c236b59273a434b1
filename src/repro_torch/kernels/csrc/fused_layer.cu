// Fused GCN layer tail for Hopper, sm_90a: RMSNorm (Eq. 7) -> ReLU (Eq. 8)
// -> dropout by a keep-mask (Eq. 9) -> residual add (Eq. 10), in float32,
// and its backward.
//
// The forward replaces the TPU kernel `_fused_kernel` of
// src/repro/kernels/fused_layer.py (its pallas_call is
// `fused_layer_pallas`), the paper's §V-C fusion: one pass over each row
// instead of four round trips through device memory. The backward has no
// TPU kernel: the reference's `_fused_bwd` (src/repro/kernels/ops.py) is
// plain jnp, which XLA fuses.
//
// The keep bits come from one of three sources: none, a (rows, d) bool
// mask in device memory ("bytes"), or the counter: the 0-d int64 key in
// device memory, lane i = row * d + col kept when
// (fold_in(key, i) >> 40) < threshold (splitmix64.cuh), the test of
// counter_rng.cu's keep_mask_kernel, so a counter call equals a bytes call
// fed that kernel's mask, bit for bit. The counter source draws in
// registers where the bytes source loads: the training step writes and
// reads no mask at all.
//
// What bounds them on the H100: bytes. The forward reads x (4 B per
// element), the residual (4 B) and a bytes mask (1 B) where present, and
// writes the output (4 B): 25.2 MB at the training shape (8192, 256) with
// a residual and the counter, 7.5 us at 3.35 TB/s (27.3 MB with a bytes
// mask). The backward reads the cotangent g and x (4 B each) and writes dx
// (4 B): 25.2 MB too. A counter draw is one splitmix64 of the lane's index,
// two 64-bit multiplies that Hopper emulates with 32-bit ones, about 20
// integer instructions an element: about 4 us of issue over the card at
// (8192, 256), under the loads of a bytes-bound pass.
//
// Forward design: one warp per row, 8 rows per CTA, each input read once.
// The vector route (d % 4 == 0, every row 16-byte aligned) keeps the row in
// registers: a lane holds kChunks float4 of x and of the residual and
// kChunks uchar4 of a bytes mask (d = 256: two of each), all loaded with
// streaming 16- and 4-byte loads before the first use, so a lane has up to
// 3 * kChunks loads in flight; the warp reduces the sum of squares with
// __shfl_xor_sync, applies the tail and writes float4 streaming stores.
// kChunks = ceil(d / 128) is a template parameter up to d = 1024, and so is
// the counter source (the key read once a thread with __ldg and mixed
// once). A kept element is divided by keep_prob as the reference does, but
// on the vector route from the reciprocal: q = v * (1 / keep_prob), then
// one FMA step corrects q to the correctly rounded quotient (Markstein's
// theorem: the reciprocal is correctly rounded on the host, q is within an
// ulp), two FMAs where the IEEE division takes about ten instructions,
// which at the training shape made the kernel wait on arithmetic after its
// loads had landed. Two rows a warp at 64 registers, or one at 32, were
// slower on the H100. The scalar route takes any (B, d) and alignment:
// each lane takes every 32nd element, and a second pass over the row
// (served from L1) applies the tail. The Pallas kernel needed B % 256 == 0;
// both routes take any B. Mask and residual are optional (null pointers),
// not zero tensors.
//
// Backward design: the same warp a row and the same routes. A warp walks
// rows_per_warp consecutive rows; on the vector route it loads them in
// batches (d = 256: 4 rows, 8 KB of g and x a warp in registers), every
// load of a batch issued before the first row's arithmetic (one row at a
// time with the next one's loads in flight reached 0.435 of the bound at
// the training shape on the H100, the batch 0.49). Per row it recomputes
// inv = rsqrt(mean(x^2) + eps) and the ReLU's sign of x * inv * scale,
// redraws (keep_lanes4, four lanes at a time) or loads the keep bits,
// reduces dot = sum(g' * scale * x) across the warp and writes
// dx = inv * g' * scale - x * inv^3 * dot / d with streaming stores, in the
// reference's order of operations. d_scale = sum over rows of g' * x * inv
// must not depend on the order in which CTAs finish (a training run repeats
// bit for bit on the card), so no float atomics: on the vector route a lane
// sums its columns over its warp's rows in registers, the CTA adds its
// warps in warp order through shared memory and writes one row of a
// (grid, d) partial; on the scalar route each warp adds into its own row of
// a (grid * 8, d) partial. A second kernel sums it into d_scale (zeros
// without RMSNorm) in a fixed order: 8 columns a CTA, its threads 32 slices
// of the partial's rows. The grid depends on the row count only. Finishing
// d_scale in the rows kernel instead (an integer ticket electing the CTAs
// that add the partial) lost to the two kernels at the training shape on
// the H100, 0.0167 against 0.0151 ms: the handoff pays loaded L2 round
// trips while dx drains, and a second launch waits for that drain anyway.

#include <cuda_runtime.h>

#include <cstdint>

#include "splitmix64.cuh"

namespace {

constexpr int kWarps = 8;        // one warp a row, 8 rows a CTA

struct Tail {
  float eps, keep, inv_keep;   // keep_prob and 1 / keep_prob, rounded
  int use_rmsnorm, use_relu;

  // v / keep_prob, correctly rounded: the IEEE division where kDivide,
  // else the reciprocal's product corrected by one FMA step
  template <bool kDivide>
  __device__ __forceinline__ float div_keep(float v) const {
    if (kDivide) return v / keep;
    const float q = v * inv_keep;
    return fmaf(fmaf(-q, keep, v), inv_keep, q);
  }

  // one element after the norm's factor inv is known
  template <bool kDivide>
  __device__ __forceinline__ float apply(float v, float inv, float s,
                                         bool has_mask, bool kept,
                                         bool has_res, float r) const {
    if (use_rmsnorm) v = v * inv * s;
    if (use_relu) v = fmaxf(v, 0.0f);
    if (has_mask) v = kept ? div_keep<kDivide>(v) : 0.0f;
    if (has_res) v += r;
    return v;
  }

  // the backward of one element, up to the norm's Jacobian: g masked and
  // gated by the ReLU's sign (gated), its share of d_scale (dscale) and
  // g' * scale (returned, the gs of dx = inv * gs - x * inv^3 * dot / d)
  template <bool kDivide>
  __device__ __forceinline__ float back(float g, float x, float inv,
                                        float s, bool has_mask, bool kept,
                                        float& dscale) const {
    if (has_mask) g = kept ? div_keep<kDivide>(g) : 0.0f;
    const float normed = use_rmsnorm ? x * inv : x;
    if (use_relu && !((use_rmsnorm ? normed * s : x) > 0.0f)) g = 0.0f;
    if (!use_rmsnorm) return g;
    dscale += g * normed;
    return g * s;
  }
};

// where the keep bits come from (a bytes mask or the counter; neither
// where both pointers are null)
struct Keep {
  const uint8_t* mask;
  uint64_t k;                  // splitmix64(key) for the counter
  uint32_t threshold;
  bool counter;

  __device__ __forceinline__ bool has() const {
    return counter || mask != nullptr;
  }
  __device__ __forceinline__ bool kept(size_t i) const {
    return counter ? repro::keep_lane(k, i, threshold) : mask[i] != 0;
  }
};

__device__ __forceinline__ Keep make_keep(const uint8_t* mask,
                                          const int64_t* key,
                                          uint32_t threshold) {
  Keep kp{mask, 0, threshold, key != nullptr};
  if (kp.counter) {
    kp.k = repro::splitmix64(static_cast<uint64_t>(__ldg(key)));
  }
  return kp;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float& comp(float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ bool comp(const uchar4& m, int e) {
  return (e == 0 ? m.x : e == 1 ? m.y : e == 2 ? m.z : m.w) != 0;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// any d, any alignment: two passes over the row
__global__ void __launch_bounds__(kWarps * 32) fused_layer_kernel(
    const float* __restrict__ x, const float* __restrict__ scale,
    const uint8_t* __restrict__ mask, const int64_t* __restrict__ key,
    uint32_t threshold, const float* __restrict__ res,
    float* __restrict__ out, int rows, int d, Tail t) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;                  // whole warp leaves together
  const size_t base = static_cast<size_t>(row) * d;
  const Keep kp = make_keep(mask, key, threshold);

  float inv = 1.0f;
  if (t.use_rmsnorm) {
    float ss = 0.0f;
    for (int j = lane; j < d; j += 32) {
      const float v = x[base + j];
      ss += v * v;
    }
    inv = rsqrtf(warp_sum(ss) / static_cast<float>(d) + t.eps);
  }
  for (int j = lane; j < d; j += 32) {
    out[base + j] = t.apply<true>(x[base + j], inv, scale[j], kp.has(),
                                  kp.has() && kp.kept(base + j),
                                  res != nullptr,
                                  res != nullptr ? res[base + j] : 0.0f);
  }
}

// d % 4 == 0 and 16-byte aligned rows; d4 = d / 4 <= 32 * kChunks
template <int kChunks, bool kCounter>
__global__ void __launch_bounds__(kWarps * 32) fused_layer_kernel_vec(
    const float4* __restrict__ x, const float4* __restrict__ scale,
    const uchar4* __restrict__ mask, const int64_t* __restrict__ key,
    uint32_t threshold, const float4* __restrict__ res,
    float4* __restrict__ out, int rows, int d4, Tail t) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;                  // whole warp leaves together
  const size_t base = static_cast<size_t>(row) * d4;
  const bool has_mask = kCounter || mask != nullptr;
  const bool has_res = res != nullptr;
  const uint64_t k =
      kCounter ? repro::splitmix64(static_cast<uint64_t>(__ldg(key))) : 0;

  // every load of the row issued before the first use
  float4 v[kChunks], r[kChunks];
  uchar4 m[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int j = lane + 32 * c;
    v[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    r[c] = v[c];
    m[c] = make_uchar4(0, 0, 0, 0);
    if (j < d4) {
      v[c] = __ldcs(x + base + j);
      if (has_res) r[c] = __ldcs(res + base + j);
      if (!kCounter && has_mask) m[c] = __ldcs(mask + base + j);
    }
  }

  float inv = 1.0f;
  if (t.use_rmsnorm) {
    float ss = 0.0f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      ss += v[c].x * v[c].x + v[c].y * v[c].y + v[c].z * v[c].z
            + v[c].w * v[c].w;
    }
    inv = rsqrtf(warp_sum(ss) / static_cast<float>(4 * d4) + t.eps);
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int j = lane + 32 * c;
    if (j < d4) {
      float4 s = __ldg(scale + j);
      float4 o;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool kept =
            kCounter ? repro::keep_lane(k, 4 * (base + j) + e, threshold)
                     : comp(m[c], e);
        comp(o, e) = t.apply<false>(comp(v[c], e), inv, comp(s, e),
                                    has_mask, kept, has_res, comp(r[c], e));
      }
      __stcs(out + base + j, o);
    }
  }
}

template <int kChunks>
void launch_vec(const void* x, const void* scale, const void* mask,
                const void* key, uint32_t threshold, const void* res,
                void* out, int rows, int d, Tail t, int grid,
                cudaStream_t st) {
  auto kernel = key != nullptr ? fused_layer_kernel_vec<kChunks, true>
                               : fused_layer_kernel_vec<kChunks, false>;
  kernel<<<grid, kWarps * 32, 0, st>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(scale),
      static_cast<const uchar4*>(mask), static_cast<const int64_t*>(key),
      threshold, static_cast<const float4*>(res), static_cast<float4*>(out),
      rows, d / 4, t);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// any d, any alignment: the warp adds each row's share of d_scale into its
// own row of `partial` (grid * 8 rows; null without RMSNorm)
__global__ void __launch_bounds__(kWarps * 32) fused_layer_bwd_kernel(
    const float* __restrict__ g, const float* __restrict__ x,
    const float* __restrict__ scale, const uint8_t* __restrict__ mask,
    const int64_t* __restrict__ key, uint32_t threshold,
    float* __restrict__ dx, float* __restrict__ partial, int rows, int d,
    int rows_per_warp, Tail t) {
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const Keep kp = make_keep(mask, key, threshold);
  float* mine = partial != nullptr
                    ? partial + static_cast<size_t>(gw) * d : nullptr;
  if (mine != nullptr) {
    for (int j = lane; j < d; j += 32) mine[j] = 0.0f;
  }
  const int first = gw * rows_per_warp;
  const int last = min(first + rows_per_warp, rows);
  for (int row = first; row < last; ++row) {
    const size_t base = static_cast<size_t>(row) * d;
    // g' (masked, gated) times the scale, from L1 after the first pass
    auto gs_at = [&](int j, float inv, float& ds) {
      return t.back<true>(g[base + j], x[base + j], inv, scale[j], kp.has(),
                          kp.has() && kp.kept(base + j), ds);
    };
    float unused = 0.0f;
    if (!t.use_rmsnorm) {
      for (int j = lane; j < d; j += 32) dx[base + j] = gs_at(j, 1.0f, unused);
      continue;
    }
    float ss = 0.0f;
    for (int j = lane; j < d; j += 32) {
      const float v = x[base + j];
      ss += v * v;
    }
    const float inv = rsqrtf(warp_sum(ss) / static_cast<float>(d) + t.eps);
    float dot = 0.0f;
    for (int j = lane; j < d; j += 32) {
      dot += gs_at(j, inv, mine[j]) * x[base + j];
    }
    const float c = inv * inv * inv * warp_sum(dot) / static_cast<float>(d);
    for (int j = lane; j < d; j += 32) {
      dx[base + j] = inv * gs_at(j, inv, unused) - x[base + j] * c;
    }
  }
}

// the rows a warp of the backward's vector route loads before working on
// any of them: every load of the batch is in flight at once (d = 256: 4
// rows, 8 KB a warp), in about 64 registers of g and x
template <int kChunks>
__host__ __device__ constexpr int bwd_batch() {
  return kChunks <= 1 ? 8 : kChunks == 2 ? 4 : kChunks <= 4 ? 2 : 1;
}

template <int kChunks>
struct Row {
  float4 g[kChunks], x[kChunks];
  uchar4 m[kChunks];
};

template <int kChunks, bool kCounter>
__device__ __forceinline__ void load_row(Row<kChunks>& r,
                                         const float4* __restrict__ g,
                                         const float4* __restrict__ x,
                                         const uchar4* __restrict__ mask,
                                         size_t base, int lane, int d4) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int j = lane + 32 * c;
    r.g[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    r.x[c] = r.g[c];
    r.m[c] = make_uchar4(0, 0, 0, 0);
    if (j < d4) {
      r.g[c] = __ldcs(g + base + j);
      r.x[c] = __ldcs(x + base + j);
      if (!kCounter && mask != nullptr) r.m[c] = __ldcs(mask + base + j);
    }
  }
}

// one row held in registers: dx written, its share of d_scale added to ds
template <int kChunks, bool kCounter>
__device__ __forceinline__ void bwd_row(Row<kChunks>& cur,
                                        const float4* __restrict__ scale,
                                        float4* __restrict__ dx,
                                        float4 (&ds)[kChunks], size_t base,
                                        int lane, int d4, bool has_mask,
                                        uint64_t k, uint32_t threshold,
                                        Tail t) {
  float inv = 1.0f;
  if (t.use_rmsnorm) {
    float ss = 0.0f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      ss += cur.x[c].x * cur.x[c].x + cur.x[c].y * cur.x[c].y
            + cur.x[c].z * cur.x[c].z + cur.x[c].w * cur.x[c].w;
    }
    inv = rsqrtf(warp_sum(ss) / static_cast<float>(4 * d4) + t.eps);
  }
  float dot = 0.0f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int j = lane + 32 * c;
    if (j < d4) {
      float4 s = __ldg(scale + j);
      const uint32_t drawn =
          kCounter ? repro::keep_lanes4(k, 4 * (base + j), threshold) : 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool kept =
            kCounter ? ((drawn >> e) & 1u) != 0 : comp(cur.m[c], e);
        const float xv = comp(cur.x[c], e);
        // cur.g becomes g' * scale (or, without RMSNorm, g')
        float& gv = comp(cur.g[c], e);
        gv = t.back<false>(gv, xv, inv, comp(s, e), has_mask, kept,
                           comp(ds[c], e));
        dot += gv * xv;
      }
    }
  }
  if (t.use_rmsnorm) {
    const float cf = inv * inv * inv * warp_sum(dot)
                     / static_cast<float>(4 * d4);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        comp(cur.g[c], e) = inv * comp(cur.g[c], e) - comp(cur.x[c], e) * cf;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int j = lane + 32 * c;
    if (j < d4) __stcs(dx + base + j, cur.g[c]);
  }
}

// d % 4 == 0 and 16-byte aligned rows; d4 = d / 4 <= 32 * kChunks. A warp
// takes its rows in batches of bwd_batch<kChunks>(), every load of a batch
// issued before the first row's arithmetic. The CTA writes its warps'
// column sums of d_scale, added in warp order, to row blockIdx.x of
// `partial` (grid rows; null without RMSNorm).
template <int kChunks, bool kCounter>
__global__ void __launch_bounds__(kWarps * 32) fused_layer_bwd_kernel_vec(
    const float4* __restrict__ g, const float4* __restrict__ x,
    const float4* __restrict__ scale, const uchar4* __restrict__ mask,
    const int64_t* __restrict__ key, uint32_t threshold,
    float4* __restrict__ dx, float4* __restrict__ partial, int rows, int d4,
    int rows_per_warp, Tail t) {
  constexpr int kBatch = bwd_batch<kChunks>();
  __shared__ float4 sums[kWarps][32 * kChunks];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool has_mask = kCounter || mask != nullptr;
  const uint64_t k =
      kCounter ? repro::splitmix64(static_cast<uint64_t>(__ldg(key))) : 0;
  float4 ds[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) ds[c] = make_float4(0.0f, 0.0f, 0.0f,
                                                        0.0f);

  const int first = (blockIdx.x * kWarps + warp) * rows_per_warp;
  const int last = min(first + rows_per_warp, rows);
  for (int r0 = first; r0 < last; r0 += kBatch) {
    Row<kChunks> batch[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (r0 + i < last) {
        load_row<kChunks, kCounter>(batch[i], g, x, mask,
                                    static_cast<size_t>(r0 + i) * d4, lane,
                                    d4);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (r0 + i < last) {
        bwd_row<kChunks, kCounter>(batch[i], scale, dx, ds,
                                   static_cast<size_t>(r0 + i) * d4, lane,
                                   d4, has_mask, k, threshold, t);
      }
    }
  }

  if (partial == nullptr) return;           // uniform over the CTA
#pragma unroll
  for (int c = 0; c < kChunks; ++c) sums[warp][lane + 32 * c] = ds[c];
  __syncthreads();
  for (int j = threadIdx.x; j < d4; j += kWarps * 32) {
    float4 a = sums[0][j];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 b = sums[w][j];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    partial[static_cast<size_t>(blockIdx.x) * d4 + j] = a;
  }
}

constexpr int kSumCols = 8;      // d_scale columns a CTA of the sum takes
constexpr int kSumSlices = kWarps * 32 / kSumCols;

// d_scale[col] = the sum of partial[p][col] over p < n_partial: a CTA takes
// 8 columns, and its 256 threads 32 slices of the partial's rows: slice s
// adds rows s, s + 32, ... in order, then the slices are added in slice
// order. n_partial = 0 writes zeros.
__global__ void __launch_bounds__(kWarps * 32) fused_layer_dscale_kernel(
    const float* __restrict__ partial, int n_partial, int d,
    float* __restrict__ d_scale) {
  __shared__ float sums[kSumSlices][kSumCols];
  const int c = threadIdx.x % kSumCols, slice = threadIdx.x / kSumCols;
  const int col = blockIdx.x * kSumCols + c;
  float s = 0.0f;
  if (col < d) {
#pragma unroll 8
    for (int p = slice; p < n_partial; p += kSumSlices) {
      s += partial[static_cast<size_t>(p) * d + col];
    }
  }
  sums[slice][c] = s;
  __syncthreads();
  if (threadIdx.x < kSumCols && col < d) {
    float a = sums[0][c];
#pragma unroll
    for (int w = 1; w < kSumSlices; ++w) a += sums[w][c];
    d_scale[col] = a;
  }
}

template <int kChunks>
void launch_bwd_vec(const void* g, const void* x, const void* scale,
                    const void* mask, const void* key, uint32_t threshold,
                    void* dx, void* partial, int rows, int d,
                    int rows_per_warp, Tail t, int grid, cudaStream_t st) {
  auto kernel = key != nullptr ? fused_layer_bwd_kernel_vec<kChunks, true>
                               : fused_layer_bwd_kernel_vec<kChunks, false>;
  kernel<<<grid, kWarps * 32, 0, st>>>(
      static_cast<const float4*>(g), static_cast<const float4*>(x),
      static_cast<const float4*>(scale), static_cast<const uchar4*>(mask),
      static_cast<const int64_t*>(key), threshold, static_cast<float4*>(dx),
      static_cast<float4*>(partial), rows, d / 4, rows_per_warp, t);
}

}  // namespace

// mask (rows, d) bool, key (0-d int64: the counter source, with threshold)
// and res (rows, d) float32 may be null; mask and key are not both given.
// CTAs of 8 warps, one row a warp, cover the rows. `chunks` picks the
// route: 0 the scalar one, 1-8 the vector one with that many float4 a lane
// (the caller checks d % 4 == 0, d <= 128 * chunks and 16-byte alignment).
// Returns the launch's cudaError_t (0 on success; 1, cudaErrorInvalidValue,
// for chunks outside 0-8).
extern "C" int repro_fused_layer(
    const void* x, const void* scale, const void* mask, const void* key,
    const void* res, void* out, int rows, int d, float eps, float keep_prob,
    int threshold, int use_rmsnorm, int use_relu, int chunks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (rows + kWarps - 1) / kWarps;
  const Tail t{eps, keep_prob, 1.0f / keep_prob, use_rmsnorm, use_relu};
  const uint32_t th = static_cast<uint32_t>(threshold);
#define REPRO_VEC(n)                                                      \
  case n:                                                                 \
    launch_vec<n>(x, scale, mask, key, th, res, out, rows, d, t, grid, st); \
    break;
  switch (chunks) {
    case 0:
      fused_layer_kernel<<<grid, kWarps * 32, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(scale),
          static_cast<const uint8_t*>(mask), static_cast<const int64_t*>(key),
          th, static_cast<const float*>(res), static_cast<float*>(out), rows,
          d, t);
      break;
    REPRO_VEC(1) REPRO_VEC(2) REPRO_VEC(3) REPRO_VEC(4)
    REPRO_VEC(5) REPRO_VEC(6) REPRO_VEC(7) REPRO_VEC(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_VEC
  return static_cast<int>(cudaGetLastError());
}

// The tail's backward: dx (rows, d) and d_scale (d,) from the cotangent g,
// x and scale, with the forward's keep source (mask or key, or neither).
// `grid` CTAs of 8 warps, each warp rows_per_warp consecutive rows, must
// cover the rows; `partial` holds grid rows of d floats on the vector route
// (chunks 1-8) and grid * 8 on the scalar one (chunks 0), and is unused
// (may be null) without RMSNorm, when d_scale is written as zeros. Returns
// the first launch error (0 on success; 1, cudaErrorInvalidValue, for
// chunks outside 0-8 or a grid that does not cover the rows, launching
// nothing).
extern "C" int repro_fused_layer_bwd(
    const void* g, const void* x, const void* scale, const void* mask,
    const void* key, void* dx, void* partial, void* d_scale, int rows, int d,
    float eps, float keep_prob, int threshold, int use_rmsnorm, int use_relu,
    int chunks, int grid, int rows_per_warp, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunks < 0 || chunks > 8 || rows_per_warp < 1 || grid < 1 ||
      static_cast<long long>(grid) * kWarps * rows_per_warp < rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tail t{eps, keep_prob, 1.0f / keep_prob, use_rmsnorm, use_relu};
  const uint32_t th = static_cast<uint32_t>(threshold);
  void* part = use_rmsnorm ? partial : nullptr;
#define REPRO_BWD_VEC(n)                                                  \
  case n:                                                                 \
    launch_bwd_vec<n>(g, x, scale, mask, key, th, dx, part, rows, d,      \
                      rows_per_warp, t, grid, st);                        \
    break;
  switch (chunks) {
    case 0:
      fused_layer_bwd_kernel<<<grid, kWarps * 32, 0, st>>>(
          static_cast<const float*>(g), static_cast<const float*>(x),
          static_cast<const float*>(scale), static_cast<const uint8_t*>(mask),
          static_cast<const int64_t*>(key), th, static_cast<float*>(dx),
          static_cast<float*>(part), rows, d, rows_per_warp, t);
      break;
    REPRO_BWD_VEC(1) REPRO_BWD_VEC(2) REPRO_BWD_VEC(3) REPRO_BWD_VEC(4)
    REPRO_BWD_VEC(5) REPRO_BWD_VEC(6) REPRO_BWD_VEC(7) REPRO_BWD_VEC(8)
  }
#undef REPRO_BWD_VEC
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n_partial = !use_rmsnorm ? 0 : chunks ? grid : grid * kWarps;
  fused_layer_dscale_kernel<<<(d + kSumCols - 1) / kSumCols, kWarps * 32,
                              0, st>>>(
      static_cast<const float*>(partial), n_partial, d,
      static_cast<float*>(d_scale));
  return static_cast<int>(cudaGetLastError());
}
