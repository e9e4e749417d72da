// SAME-padded k x k / stride pool backward (max and avg), for Hopper
// (sm_90a).
//
// Replaces: cap2det_tpu/kernels/pool_grad.py, `maxpool_grad` ->
// `_grad_kernel` (routing of `_routed_taps_hier`, oracle
// `maxpool_grad_reference`) and `avgpool_grad` -> `_avg_grad_kernel`, the
// Pallas TPU kernels behind the second stage's pool gradients (Mixed_5a
// max 3/s2 on [B*P, 7, 7, 576], Mixed_5b avg 3/s1 and Mixed_5c max 3/s1
// on [B*P, 4, 4, 1024]).
//
// Function. SAME padding as `_same_pads` (pad_total // 2 before). Max: the
// whole upstream gradient of a window goes to its first maximal in-bounds
// tap in row-major order (TF MaxPoolGrad), summed where windows overlap.
// Avg: each window spreads g / count over its in-bounds taps, count being
// the number of in-bounds taps. Both accumulate in float32 and store dx in
// x's dtype.
//
// What bounds it on the H100: bytes. A max window is at most 9 compares and
// every input element lies in at most 9 windows (4 at stride 2), far
// below the card's balance point; at [1000, 7, 7, 576] bf16 the
// compulsory traffic (x and dx 56 MB each, g 18 MB) is about 0.04 ms at
// 3.35 TB/s. The design is the gather form: one thread per input element
// (n, iy, ix, c), c innermost so a warp reads and writes 32 consecutive
// channels; the thread walks the windows that contain its element,
// recomputes each window's winner from x (max) or its count (avg), and
// sums what lands on it. Nothing is scattered, so there are no atomics,
// no zeroed buffer, and the result is deterministic. Windows are walked
// in descending (oy, ox), which is the order in which the tap-by-tap
// plain versions (kernels/pool_grad.py) add them, so float32 results agree
// bit for bit. The re-reads of neighbouring x values hit L1/L2.

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

// Output windows along one axis that contain input index i: [lo, hi].
__device__ __forceinline__ void windows_of(int i, int pad, int k, int s,
                                           int out, int* lo, int* hi) {
  const int a = i + pad - k + 1;
  *lo = a <= 0 ? 0 : (a + s - 1) / s;
  *hi = min((i + pad) / s, out - 1);
}

template <typename T, bool kMax>
__global__ void pool_same_grad_kernel(const T* __restrict__ x,
                                      const T* __restrict__ g,
                                      T* __restrict__ dx, size_t total, int H,
                                      int W, int C, int OH, int OW, int k,
                                      int s, int pad_t, int pad_l) {
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    size_t r = idx / C;
    const int ix = (int)(r % W);
    r /= W;
    const int iy = (int)(r % H);
    const size_t n = r / H;
    int oy_lo, oy_hi, ox_lo, ox_hi;
    windows_of(iy, pad_t, k, s, OH, &oy_lo, &oy_hi);
    windows_of(ix, pad_l, k, s, OW, &ox_lo, &ox_hi);
    const T* xn = x + n * H * W * C + c;
    const T* gn = g + n * OH * OW * C + c;
    float acc = 0.0f;
    for (int oy = oy_hi; oy >= oy_lo; --oy) {
      const int y_lo = max(oy * s - pad_t, 0);
      const int y_hi = min(oy * s - pad_t + k, H);
      for (int ox = ox_hi; ox >= ox_lo; --ox) {
        const int x_lo = max(ox * s - pad_l, 0);
        const int x_hi = min(ox * s - pad_l + k, W);
        const float go = to_f32(gn[((size_t)oy * OW + ox) * C]);
        if (kMax) {
          // First maximal in-bounds tap in row-major order.
          float best = -INFINITY;
          int by = y_lo;
          int bx = x_lo;
          for (int yy = y_lo; yy < y_hi; ++yy) {
            for (int xx = x_lo; xx < x_hi; ++xx) {
              const float v = to_f32(xn[((size_t)yy * W + xx) * C]);
              if (v > best) {
                best = v;
                by = yy;
                bx = xx;
              }
            }
          }
          if (by == iy && bx == ix) acc = __fadd_rn(acc, go);
        } else {
          const float count =
              __fmul_rn((float)(y_hi - y_lo), (float)(x_hi - x_lo));
          acc = __fadd_rn(acc, __fdiv_rn(go, count));
        }
      }
    }
    dx[idx] = from_f32<T>(acc);
  }
}

template <typename T>
void launch(const void* x, const void* g, void* dx, size_t total, int H,
            int W, int C, int OH, int OW, int k, int s, int pad_t, int pad_l,
            int is_max, cudaStream_t st) {
  const int threads = 256;
  size_t blocks = (total + threads - 1) / threads;
  if (blocks > (1u << 20)) blocks = 1u << 20;
  if (is_max) {
    pool_same_grad_kernel<T, true><<<(unsigned)blocks, threads, 0, st>>>(
        (const T*)x, (const T*)g, (T*)dx, total, H, W, C, OH, OW, k, s,
        pad_t, pad_l);
  } else {
    pool_same_grad_kernel<T, false><<<(unsigned)blocks, threads, 0, st>>>(
        (const T*)x, (const T*)g, (T*)dx, total, H, W, C, OH, OW, k, s,
        pad_t, pad_l);
  }
}

}  // namespace

// x is read only by the max form (the avg form passes null).
extern "C" int cap2det_pool_same_grad(const void* x, const void* g, void* dx,
                                      int N, int H, int W, int C, int OH,
                                      int OW, int k, int s, int pad_t,
                                      int pad_l, int is_max, int is_bf16,
                                      void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || k < 1 || s < 1 ||
      (is_max && x == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t total = (size_t)N * H * W * C;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    launch<__nv_bfloat16>(x, g, dx, total, H, W, C, OH, OW, k, s, pad_t,
                          pad_l, is_max, st);
  } else {
    launch<float>(x, g, dx, total, H, W, C, OH, OW, k, s, pad_t, pad_l,
                  is_max, st);
  }
  return (int)cudaGetLastError();
}
