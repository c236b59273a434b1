// Fused GCN layer tail for Hopper, sm_90a: RMSNorm (Eq. 7) -> ReLU (Eq. 8)
// -> dropout by a keep-mask (Eq. 9) -> residual add (Eq. 10), in float32.
//
// Replaces the TPU kernel `_fused_kernel` of src/repro/kernels/fused_layer.py
// (its pallas_call is `fused_layer_pallas`), the paper's §V-C fusion: one
// pass over each row instead of four round trips through device memory.
//
// What bounds it on the H100: bytes. Per call it reads x (4 B per element),
// the residual (4 B) and the mask (1 B) where present, and writes the output
// (4 B): 27.3 MB at the training shape (8192, 256), 8.1 us at 3.35 TB/s;
// about 0.8 MB at the serving shape (256, 256), where the launch dominates.
//
// Design: one warp per row, 8 rows per CTA, each input read once. The
// vector route (d % 4 == 0, every row 16-byte aligned) keeps the row in
// registers: a lane holds kChunks float4 of x and of the residual and
// kChunks uchar4 of the mask (d = 256: two of each), all loaded with
// streaming 16- and 4-byte loads before the first use, so a lane has up to
// 3 * kChunks loads in flight; the warp reduces the sum of squares with
// __shfl_xor_sync, applies the tail and writes float4 streaming stores.
// kChunks = ceil(d / 128) is a template parameter up to d = 1024. A kept
// element is divided by keep_prob as the reference does, but on the vector
// route from the reciprocal: q = v * (1 / keep_prob), then one FMA step
// corrects q to the correctly rounded quotient (Markstein's theorem: the
// reciprocal is correctly rounded on the host, q is within an ulp), two
// FMAs where the IEEE division takes about ten instructions, which at the
// training shape made the kernel wait on arithmetic after its loads had
// landed. Two rows a warp at 64 registers, or one at 32, were slower on
// the H100. The scalar route takes any (B, d) and alignment: each lane
// takes every 32nd element, and a second pass over the row (served from
// L1) applies the tail. The Pallas kernel needed B % 256 == 0; both routes
// take any B.
// Mask and residual are optional (null pointers), not zero tensors.

#include <cuda_runtime.h>

#include <cstdint>

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
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// any d, any alignment: two passes over the row
__global__ void __launch_bounds__(kWarps * 32) fused_layer_kernel(
    const float* __restrict__ x, const float* __restrict__ scale,
    const uint8_t* __restrict__ mask, const float* __restrict__ res,
    float* __restrict__ out, int rows, int d, Tail t) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;                  // whole warp leaves together
  const size_t base = static_cast<size_t>(row) * d;

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
    out[base + j] = t.apply<true>(x[base + j], inv, scale[j],
                                  mask != nullptr,
                                  mask != nullptr && mask[base + j],
                                  res != nullptr,
                                  res != nullptr ? res[base + j] : 0.0f);
  }
}

// d % 4 == 0 and 16-byte aligned rows; d4 = d / 4 <= 32 * kChunks
template <int kChunks>
__global__ void __launch_bounds__(kWarps * 32) fused_layer_kernel_vec(
    const float4* __restrict__ x, const float4* __restrict__ scale,
    const uchar4* __restrict__ mask, const float4* __restrict__ res,
    float4* __restrict__ out, int rows, int d4, Tail t) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;                  // whole warp leaves together
  const size_t base = static_cast<size_t>(row) * d4;
  const bool has_mask = mask != nullptr, has_res = res != nullptr;

  // every load of the row issued before the first use
  float4 v[kChunks], r[kChunks];
  uchar4 m[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int j = lane + 32 * k;
    v[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    r[k] = v[k];
    m[k] = make_uchar4(0, 0, 0, 0);
    if (j < d4) {
      v[k] = __ldcs(x + base + j);
      if (has_res) r[k] = __ldcs(res + base + j);
      if (has_mask) m[k] = __ldcs(mask + base + j);
    }
  }

  float inv = 1.0f;
  if (t.use_rmsnorm) {
    float ss = 0.0f;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      ss += v[k].x * v[k].x + v[k].y * v[k].y + v[k].z * v[k].z
            + v[k].w * v[k].w;
    }
    inv = rsqrtf(warp_sum(ss) / static_cast<float>(4 * d4) + t.eps);
  }
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int j = lane + 32 * k;
    if (j < d4) {
      const float4 s = __ldg(scale + j);
      float4 o;
      o.x = t.apply<false>(v[k].x, inv, s.x, has_mask, m[k].x, has_res,
                           r[k].x);
      o.y = t.apply<false>(v[k].y, inv, s.y, has_mask, m[k].y, has_res,
                           r[k].y);
      o.z = t.apply<false>(v[k].z, inv, s.z, has_mask, m[k].z, has_res,
                           r[k].z);
      o.w = t.apply<false>(v[k].w, inv, s.w, has_mask, m[k].w, has_res,
                           r[k].w);
      __stcs(out + base + j, o);
    }
  }
}

template <int kChunks>
void launch_vec(const void* x, const void* scale, const void* mask,
                const void* res, void* out, int rows, int d, Tail t,
                int grid, cudaStream_t st) {
  fused_layer_kernel_vec<kChunks><<<grid, kWarps * 32, 0, st>>>(
      static_cast<const float4*>(x), static_cast<const float4*>(scale),
      static_cast<const uchar4*>(mask), static_cast<const float4*>(res),
      static_cast<float4*>(out), rows, d / 4, t);
}

}  // namespace

// mask (rows, d) bool and res (rows, d) float32 may be null. CTAs of 8
// warps, one row a warp, cover the rows. `chunks` picks the route: 0
// the scalar one, 1-8 the vector one with that many float4 a lane (the
// caller checks d % 4 == 0, d <= 128 * chunks and 16-byte alignment).
// Returns the launch's cudaError_t (0 on success; 1, cudaErrorInvalidValue,
// for chunks outside 0-8).
extern "C" int repro_fused_layer(
    const void* x, const void* scale, const void* mask, const void* res,
    void* out, int rows, int d, float eps, float keep_prob, int use_rmsnorm,
    int use_relu, int chunks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (rows + kWarps - 1) / kWarps;
  const Tail t{eps, keep_prob, 1.0f / keep_prob, use_rmsnorm, use_relu};
  switch (chunks) {
    case 0:
      fused_layer_kernel<<<grid, kWarps * 32, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(scale),
          static_cast<const uint8_t*>(mask), static_cast<const float*>(res),
          static_cast<float*>(out), rows, d, t);
      break;
    case 1: launch_vec<1>(x, scale, mask, res, out, rows, d, t, grid, st); break;
    case 2: launch_vec<2>(x, scale, mask, res, out, rows, d, t, grid, st); break;
    case 3: launch_vec<3>(x, scale, mask, res, out, rows, d, t, grid, st); break;
    case 4: launch_vec<4>(x, scale, mask, res, out, rows, d, t, grid, st); break;
    case 5: launch_vec<5>(x, scale, mask, res, out, rows, d, t, grid, st); break;
    case 6: launch_vec<6>(x, scale, mask, res, out, rows, d, t, grid, st); break;
    case 7: launch_vec<7>(x, scale, mask, res, out, rows, d, t, grid, st); break;
    case 8: launch_vec<8>(x, scale, mask, res, out, rows, d, t, grid, st); break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
