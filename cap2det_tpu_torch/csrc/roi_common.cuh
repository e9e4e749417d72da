// Helpers shared by the ROI crop+pool forward (roi_pool.cu) and backward
// (roi_pool_bwd.cu), so the two kernels sample the feature map at exactly
// the same points with exactly the same arithmetic.
//
// The sampling follows TF crop_and_resize as the JAX package's
// `_sample_coords` and `_precompute_coords` spell it:
//   coord = start*h_max + i*(end-start)*h_max/(S-1)
// evaluated left to right; a sample outside [0, h_max] gets zero weights;
// the floor index is clamped to [0, extent-2] so idx and idx+1 are both
// rows (or columns) of the map. Rounded intrinsics keep nvcc from
// contracting any of it into FMAs, so the plain PyTorch versions
// (ops/roi.py), which run the same operations one at a time, see the same
// values bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace cap2det {

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

// One proposal's sample coordinates into shared memory: axis 0 = y,
// 1 = x; idx is the floor row/column, wa and wb the weights of idx and
// idx+1 ((1-frac)*inside and frac*inside). Every thread of the block
// takes part; the caller synchronises afterwards.
__device__ __forceinline__ void sample_coords(const float* box, int H, int W,
                                              int S, int (*s_idx)[kMaxCrop],
                                              float (*s_wa)[kMaxCrop],
                                              float (*s_wb)[kMaxCrop]) {
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
}

// The crop sample (i, j) of one channel: the y-lerp of the two feature
// rows at columns x0 and x0+1, then the x-lerp, in `_crop_pool_pass`'s
// order. `fb` points at channel c of the image; `row` = W*C.
template <typename T>
__device__ __forceinline__ float crop_sample(const T* fb, size_t row, int C,
                                             int (*s_idx)[kMaxCrop],
                                             float (*s_wa)[kMaxCrop],
                                             float (*s_wb)[kMaxCrop],
                                             int i, int j) {
  const T* r0 = fb + (size_t)s_idx[0][i] * row;
  const T* r1 = r0 + row;
  const float ya = s_wa[0][i];
  const float yb = s_wb[0][i];
  const size_t x0 = (size_t)s_idx[1][j] * C;
  const float t0 = lerp2(to_f32(r0[x0]), ya, to_f32(r1[x0]), yb);
  const float t1 = lerp2(to_f32(r0[x0 + C]), ya, to_f32(r1[x0 + C]), yb);
  return lerp2(t0, s_wa[1][j], t1, s_wb[1][j]);
}

}  // namespace cap2det
