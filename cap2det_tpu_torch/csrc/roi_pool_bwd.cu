// Fused ROI crop_and_resize + VALID max-pool, backward, for Hopper (sm_90a).
//
// Replaces: cap2det_tpu/kernels/roi_pool.py, `_backward` ->
// `_bwd_kernel_catf` (with `_fold_recompute`; `_bwd_kernel_cat` for other
// pools), the Pallas TPU kernel behind `roi_crop_maxpool`'s custom VJP,
// and `_backward_mm` -> `_bwd_kernel_mm`, which computes the same
// function. The TPU kernel keeps an image's dF block in VMEM across the
// sequential proposal axis of its grid and lands each group of proposals
// with one interpolation-matrix matmul; blocks here run in no order, so
// they add into dF with atomics instead.
//
// Function: dF[b, y, x, c] = sum over proposals p and pooled cells o of
// grad[b, p, o, c] * wy * wx, where (i, j) is the first sample of o's
// k x k window, in row-major order, whose value equals the window's
// maximum (TF MaxPoolGrad routing), and (y, x) runs over that sample's
// four bilinear corners with their weights wy, wx. The samples are
// recomputed with the forward's exact arithmetic (roi_common.cuh), so the
// winner is the sample the forward's maximum came from. Boxes get no
// gradient. Any k <= S and any stride.
//
// Reproducible sums. Float atomics add in whatever order the blocks reach
// them, so two launches on the same inputs would differ in the last bits
// (by up to 2.06e-4 in float32 at the coco17 shape). Each contribution v is
// instead rounded to 64-bit fixed point, q = rint(v * 2^32), and added with
// an integer atomicAdd into an int64 map the caller zeroes; integer
// addition is associative and commutative, so every order gives the same
// bits. A second kernel converts the map to the features' dtype, rounding
// once. Range +-2^31 at a resolution of 2^-32: each contribution is off by
// at most 2^-33, so a dF value built from a thousand of them is within
// 1.2e-7 of the exact sum before its one rounding to float32.
// Overflow: |v| <= |g| (the bilinear weights are in [0, 1]), and the
// two's-complement sum wraps and unwraps exactly, so only the final
// values have to lie within +-2^31 = 2.1e9, and every single |g| below it;
// |dF| at the coco17 shape with unit-normal pooled gradients is at most
// 155, seven orders of magnitude inside; gradients that large mean
// training has already diverged.
//
// What bounds it on the H100: bytes. At the coco17 training shape
// (features [2, 64, 96, 576] bf16, P = 500, S = 14, 2x2/s2) the
// compulsory traffic is one read of the 14 MB map and of the 113 MB
// pooled gradient plus one write of the dF map; the work is ~60 float32
// operations per pooled cell. The design: K1's grid (one block per
// (proposal, channel tile), threads along C), so the recompute reads,
// gradient reads and dF atomics of a warp are coalesced over 32
// consecutive channels; the sample coordinates are computed once per
// block into shared memory. The int64 map (57 MB at coco17) is slightly
// larger than the 50 MB L2, where the atomics resolve.

#include "roi_common.cuh"

namespace {

using cap2det::kMaxCrop;

constexpr float kFixedScale = 4294967296.0f;               // 2^32
constexpr float kFixedInvScale = 2.3283064365386963e-10f;  // 2^-32

template <typename T>
__global__ void roi_crop_maxpool_grad_kernel(
    const T* __restrict__ feat, const float* __restrict__ boxes,
    const T* __restrict__ grad, unsigned long long* __restrict__ dfeat, int H,
    int W, int C, int P, int S, int pk, int ps, int pooled) {
  __shared__ int s_idx[2][kMaxCrop];
  __shared__ float s_wa[2][kMaxCrop];
  __shared__ float s_wb[2][kMaxCrop];

  const int p = blockIdx.x;
  const int b = blockIdx.z;
  cap2det::sample_coords(boxes + ((size_t)b * P + p) * 4, H, W, S, s_idx,
                         s_wa, s_wb);
  __syncthreads();

  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const T* fb = feat + (size_t)b * H * W * C + c;
  const T* gb = grad + ((size_t)b * P + p) * pooled * pooled * C + c;
  unsigned long long* db = dfeat + (size_t)b * H * W * C + c;
  const size_t row = (size_t)W * C;

  for (int oy = 0; oy < pooled; ++oy) {
    for (int ox = 0; ox < pooled; ++ox) {
      const float g = cap2det::to_f32(gb[(size_t)(oy * pooled + ox) * C]);
      if (g == 0.0f) continue;
      // First maximal sample in row-major order: a later equal value
      // does not replace it.
      float best = -INFINITY;
      int bi = oy * ps;
      int bj = ox * ps;
      for (int ky = 0; ky < pk; ++ky) {
        for (int kx = 0; kx < pk; ++kx) {
          const int i = oy * ps + ky;
          const int j = ox * ps + kx;
          const float v =
              cap2det::crop_sample(fb, row, C, s_idx, s_wa, s_wb, i, j);
          if (v > best) {
            best = v;
            bi = i;
            bj = j;
          }
        }
      }
      const float gy[2] = {__fmul_rn(g, s_wa[0][bi]),
                           __fmul_rn(g, s_wb[0][bi])};
      const float wx[2] = {s_wa[1][bj], s_wb[1][bj]};
      unsigned long long* d0 =
          db + (size_t)s_idx[0][bi] * row + (size_t)s_idx[1][bj] * C;
      for (int dy = 0; dy < 2; ++dy) {
        for (int dx = 0; dx < 2; ++dx) {
          const float v = __fmul_rn(gy[dy], wx[dx]);
          if (v != 0.0f) {
            atomicAdd(d0 + dy * row + (size_t)dx * C,
                      (unsigned long long)__float2ll_rn(
                          __fmul_rn(v, kFixedScale)));
          }
        }
      }
    }
  }
}

// The int64 fixed-point map to float32 or bf16: one rounding of the exact
// sum to float32 (2^-32 scales exactly), then to bf16.
template <typename T>
__global__ void fixed_to_float_kernel(const long long* __restrict__ acc,
                                      T* __restrict__ out, size_t total) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    out[i] = cap2det::from_f32<T>(
        __fmul_rn(__ll2float_rn(acc[i]), kFixedInvScale));
  }
}

}  // namespace

extern "C" int cap2det_roi_crop_maxpool_bwd(const void* feat,
                                            const void* boxes,
                                            const void* grad, void* dfeat,
                                            int B, int H, int W, int C,
                                            int P, int S, int pk, int ps,
                                            int is_bf16, int threads,
                                            void* stream) {
  if (S < 1 || S > kMaxCrop || pk < 1 || ps < 1 || pk > S || H < 2 ||
      W < 2 || threads < 32 || threads > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const int pooled = (S - pk) / ps + 1;
  const dim3 grid(P, (C + threads - 1) / threads, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    roi_crop_maxpool_grad_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        (const __nv_bfloat16*)feat, (const float*)boxes,
        (const __nv_bfloat16*)grad, (unsigned long long*)dfeat, H, W, C, P,
        S, pk, ps, pooled);
  } else {
    roi_crop_maxpool_grad_kernel<float><<<grid, threads, 0, st>>>(
        (const float*)feat, (const float*)boxes, (const float*)grad,
        (unsigned long long*)dfeat, H, W, C, P, S, pk, ps, pooled);
  }
  return (int)cudaGetLastError();
}

// dF in the features' dtype from the int64 map the backward filled.
extern "C" int cap2det_roi_grad_from_fixed(const void* acc, void* out,
                                           long long total, int is_bf16,
                                           void* stream) {
  if (total < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    fixed_to_float_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, st>>>(
        (const long long*)acc, (__nv_bfloat16*)out, (size_t)total);
  } else {
    fixed_to_float_kernel<float><<<(unsigned)blocks, threads, 0, st>>>(
        (const long long*)acc, (float*)out, (size_t)total);
  }
  return (int)cudaGetLastError();
}
