// SAME-padded k x k / stride pool forward (max or avg), for Hopper (sm_90a).
//
// Replaces: cap2det_tpu/kernels/pool_grad.py, `pool_fwd` ->
// `_fwd_pool_kernel`, the Pallas TPU kernel that serves the second stage's
// three pools (Mixed_5a max 3/s2, Mixed_5b avg 3/s1, Mixed_5c max 3/s1) on
// [B*P, 7x7 or 4x4, C] maps.
//
// Function: TF SAME padding, split as `_same_pads` (pad_total // 2 before,
// the rest after, so stride 2 on an even extent pads 0 before and 1
// after). Max takes the maximum over the in-bounds taps, which is the
// -inf padding; avg sums the in-bounds taps in float32, row by row and
// then over rows as the TPU kernel's separable reduction does, and
// divides by the count of in-bounds taps (count_h * count_w). The result
// is stored in the input's dtype.
//
// What bounds it on the H100: bytes. Each output reads at most 9 inputs
// and does at most 9 adds or compares, far below the card's balance
// point; at [2000, 7, 7, 576] bf16 the compulsory traffic (113 MB in,
// 37 MB out) is about 0.045 ms at 3.35 TB/s. The design: one thread per
// output (n, oy, ox, c) with c innermost, so a warp's 32 threads read and
// write 32 consecutive channels of one pixel, one coalesced transaction
// per tap; the overlapping windows re-read neighbours that are still in
// L1/L2, so HBM sees roughly one read of the input. Packed two-channel
// loads are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

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

template <typename T, bool kMax>
__global__ void pool_same_fwd_kernel(const T* __restrict__ x,
                                     T* __restrict__ out, size_t total,
                                     int H, int W, int C, int OH, int OW,
                                     int k, int s, int pad_t, int pad_l) {
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    size_t r = idx / C;
    const int ox = (int)(r % OW);
    r /= OW;
    const int oy = (int)(r % OH);
    const size_t n = r / OH;
    const int y_lo = max(oy * s - pad_t, 0);
    const int y_hi = min(oy * s - pad_t + k, H);
    const int x_lo = max(ox * s - pad_l, 0);
    const int x_hi = min(ox * s - pad_l + k, W);
    const T* xn = x + n * H * W * C + c;
    float acc = kMax ? -INFINITY : 0.0f;
    for (int y = y_lo; y < y_hi; ++y) {
      const T* xr = xn + (size_t)y * W * C;
      if (kMax) {
        for (int xx = x_lo; xx < x_hi; ++xx) {
          acc = fmaxf(acc, to_f32(xr[(size_t)xx * C]));
        }
      } else {
        float row = 0.0f;
        for (int xx = x_lo; xx < x_hi; ++xx) {
          row = __fadd_rn(row, to_f32(xr[(size_t)xx * C]));
        }
        acc = __fadd_rn(acc, row);
      }
    }
    if (!kMax) {
      acc = __fdiv_rn(acc, __fmul_rn((float)(y_hi - y_lo),
                                     (float)(x_hi - x_lo)));
    }
    out[idx] = from_f32<T>(acc);
  }
}

template <typename T>
void launch(const void* x, void* out, size_t total, int H, int W, int C,
            int OH, int OW, int k, int s, int pad_t, int pad_l, int is_max,
            cudaStream_t st) {
  const int threads = 256;
  size_t blocks = (total + threads - 1) / threads;
  if (blocks > (1u << 20)) blocks = 1u << 20;
  if (is_max) {
    pool_same_fwd_kernel<T, true><<<(unsigned)blocks, threads, 0, st>>>(
        (const T*)x, (T*)out, total, H, W, C, OH, OW, k, s, pad_t, pad_l);
  } else {
    pool_same_fwd_kernel<T, false><<<(unsigned)blocks, threads, 0, st>>>(
        (const T*)x, (T*)out, total, H, W, C, OH, OW, k, s, pad_t, pad_l);
  }
}

}  // namespace

extern "C" int cap2det_pool_same_fwd(const void* x, void* out, int N, int H,
                                     int W, int C, int OH, int OW, int k,
                                     int s, int pad_t, int pad_l, int is_max,
                                     int is_bf16, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || k < 1 || s < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t total = (size_t)N * OH * OW * C;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    launch<__nv_bfloat16>(x, out, total, H, W, C, OH, OW, k, s, pad_t, pad_l,
                          is_max, st);
  } else {
    launch<float>(x, out, total, H, W, C, OH, OW, k, s, pad_t, pad_l, is_max,
                  st);
  }
  return (int)cudaGetLastError();
}
