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
// (rounded intrinsics keep nvcc from contracting it into FMAs); the
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kMaxCrop = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// t0 * a + t1 * b, rounded after each operation (no FMA contraction).
__device__ __forceinline__ float lerp2(float t0, float a, float t1, float b) {
  return __fadd_rn(__fmul_rn(t0, a), __fmul_rn(t1, b));
}

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
  const float* box = boxes + ((size_t)b * P + p) * 4;

  // Sample coordinates, as `_precompute_coords`: axis 0 = y, 1 = x.
  for (int t = threadIdx.x; t < 2 * S; t += blockDim.x) {
    const int axis = t / S;
    const int i = t - axis * S;
    const int extent = axis == 0 ? H : W;
    const float start = box[axis];
    const float end = box[axis + 2];
    const float h_max = (float)(extent - 1);
    float coord;
    if (S > 1) {
      float step = __fmul_rn((float)i, __fsub_rn(end, start));
      step = __fdiv_rn(__fmul_rn(step, h_max), (float)(S - 1));
      coord = __fadd_rn(__fmul_rn(start, h_max), step);
    } else {
      coord = __fmul_rn(__fmul_rn(__fadd_rn(start, end), 0.5f), h_max);
    }
    const float inside = (coord >= 0.0f && coord <= h_max) ? 1.0f : 0.0f;
    const float idx = fminf(fmaxf(floorf(coord), 0.0f), (float)(extent - 2));
    const float frac = __fmul_rn(__fsub_rn(coord, idx), inside);
    s_idx[axis][i] = (int)idx;
    s_wa[axis][i] = __fmul_rn(__fsub_rn(1.0f, frac), inside);
    s_wb[axis][i] = __fmul_rn(frac, inside);
  }
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
        const int i = oy * ps + ky;
        const T* r0 = fb + (size_t)s_idx[0][i] * row;
        const T* r1 = r0 + row;
        const float ya = s_wa[0][i];
        const float yb = s_wb[0][i];
        for (int kx = 0; kx < pk; ++kx) {
          const int j = ox * ps + kx;
          const size_t x0 = (size_t)s_idx[1][j] * C;
          const float t0 = lerp2(to_f32(r0[x0]), ya, to_f32(r1[x0]), yb);
          const float t1 =
              lerp2(to_f32(r0[x0 + C]), ya, to_f32(r1[x0 + C]), yb);
          m = fmaxf(m, lerp2(t0, s_wa[1][j], t1, s_wb[1][j]));
        }
      }
      ob[(size_t)(oy * pooled + ox) * C] = from_f32<T>(m);
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
