// Fused ROI crop_and_resize + VALID max-pool, forward, for Hopper (sm_90a).
//
// Replaces: cap2det_tpu/kernels/roi_pool.py, `_forward` -> `_fwd_kernel`
// (with `_precompute_coords`, `_crop_pool_pass` and `_crop_pass`), the
// Pallas TPU kernel behind `roi_crop_maxpool`. It computes the same
// function, not the same block structure: the TPU kernel keeps an image's
// [H, W, CB] feature block resident in VMEM and walks proposals in order;
// here every (proposal, channel tile) is an independent block.
//
// Function: for each image b, proposal p and channel c, a TF
// crop_and_resize of the normalised box to S x S samples (0 outside the
// map; y-lerp of two feature rows, then x-lerp; floor index clamped to
// [0, extent-2]), then a k x k / stride s VALID max-pool. Any k and s with
// k <= S are handled, so the rare configs that the TPU kernel sends to the
// XLA path (stride != kernel, or a crop the pool does not tile) run here
// too. Arithmetic is float32 in the operation order of `_crop_pool_pass`
// (roi_common.cuh, shared with the backward in roi_pool_bwd.cu); the
// result is stored in the features' dtype.
//
// What bounds it on the H100: bytes. At the serving shapes (features
// [1, 76, 114, 576] bf16, P = 2000, S = 14, 2x2/s2) the compulsory traffic
// is one read of the 10 MB map plus the 113 MB pooled output, about
// 0.04 ms at 3.35 TB/s; the arithmetic (about 40 flops per output) is
// below that. The design: threads run along C, which is contiguous in
// NHWC, so every feature read and output write of a warp is one coalesced
// transaction; each block computes its proposal's 2 x S sample
// coordinates once into shared memory; the map of one image (10 MB) stays
// in the 50 MB L2, so the four-tap re-reads are L2 hits rather than HBM
// traffic. Shared-memory tiling of the feature rows and 16-byte vector
// loads are left for a later change.

#include "roi_common.cuh"

namespace {

using cap2det::kMaxCrop;

template <typename T>
__global__ void roi_crop_maxpool_kernel(const T* __restrict__ feat,
                                        const float* __restrict__ boxes,
                                        T* __restrict__ out, int H, int W,
                                        int C, int P, int S, int pk, int ps,
                                        int pooled) {
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
  T* ob = out + ((size_t)b * P + p) * pooled * pooled * C + c;
  const size_t row = (size_t)W * C;

  for (int oy = 0; oy < pooled; ++oy) {
    for (int ox = 0; ox < pooled; ++ox) {
      float m = -INFINITY;
      for (int ky = 0; ky < pk; ++ky) {
        for (int kx = 0; kx < pk; ++kx) {
          m = fmaxf(m, cap2det::crop_sample(fb, row, C, s_idx, s_wa, s_wb,
                                            oy * ps + ky, ox * ps + kx));
        }
      }
      ob[(size_t)(oy * pooled + ox) * C] = cap2det::from_f32<T>(m);
    }
  }
}

}  // namespace

extern "C" int cap2det_roi_crop_maxpool_fwd(const void* feat,
                                            const void* boxes, void* out,
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
    roi_crop_maxpool_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        (const __nv_bfloat16*)feat, (const float*)boxes,
        (__nv_bfloat16*)out, H, W, C, P, S, pk, ps, pooled);
  } else {
    roi_crop_maxpool_kernel<float><<<grid, threads, 0, st>>>(
        (const float*)feat, (const float*)boxes, (float*)out, H, W, C, P, S,
        pk, ps, pooled);
  }
  return (int)cudaGetLastError();
}
