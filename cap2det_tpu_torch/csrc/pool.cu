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
// 37 MB out) is about 0.045 ms at 3.35 TB/s. What keeps a simple kernel
// far from it: one thread per output element re-reads each input up to 9
// times through L1/L2 in 2-byte loads and splits a flat size_t index with
// 64-bit division (emulated in software). The design (pool_common.cuh):
// a block per (ROI, channel tile) copies the tile of the whole ROI map
// into shared memory with 16-byte cp.async, reduces each input row over
// every output column's window into a float32 row buffer (pass A),
// reduces those over each output row's window (pass B), and writes
// 16-byte vectors; HBM sees one read of x and one write of the output, and
// all index math is 32-bit, with the model's (7x7, 3/s2) and (4x4, 3/s1)
// fixed at compile time.
// Maps whose tile exceeds 48 KB of shared memory run the untiled kernel.

#include "pool_common.cuh"

namespace {

using namespace cap2det::pool;

template <typename T, bool kMax>
__global__ void pool_same_fwd_untiled(const T* __restrict__ x,
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

__device__ __forceinline__ float reduce(float acc, float v, bool is_max) {
  return is_max ? fmaxf(acc, v) : __fadd_rn(acc, v);
}

// Shared memory: the x tile [H*W][CT] in T, then the row buffer
// [H][OW][CT] in float32.
template <typename T, int VW, int LANES, bool kMax, class G>
__global__ void __launch_bounds__(kThreads)
    pool_same_fwd_tiled(const T* __restrict__ x, T* __restrict__ out, int C,
                        int tiles, G geo) {
  constexpr int kCT = VW * LANES;
  using V = Vec<T, VW>;
  using F = Vec<float, VW>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = geo.H(), W = geo.W(), K = geo.K(), S = geo.S();
  const int OH = geo.OH(), OW = geo.OW(), PT = geo.PT(), PL = geo.PL();
  T* sx = reinterpret_cast<T*>(smem);
  float* srow = reinterpret_cast<float*>(sx + H * W * kCT);

  const int n = blockIdx.x / tiles;
  const int c0 = (blockIdx.x - n * tiles) * kCT;
  const int lanes = min(LANES, (C - c0) / VW);
  stage<T, VW, LANES>(sx, x + (size_t)n * H * W * C + c0, H * W, C, lanes);
  cp_async_wait_all();
  __syncthreads();

  // Pass A: every input row reduced over each output column's window.
  const float init = kMax ? -INFINITY : 0.0f;
  for (int i = threadIdx.x; i < H * OW * LANES; i += kThreads) {
    const int lane = i % LANES;
    const int r = i / LANES;
    if (lane >= lanes) continue;
    const int y = r / OW;
    const int ox = r - y * OW;
    const int x0 = ox * S - PL;
    F acc;
#pragma unroll
    for (int c = 0; c < VW; ++c) acc.v[c] = init;
    for (int kx = 0; kx < K; ++kx) {
      const int xx = x0 + kx;
      if (xx < 0 || xx >= W) continue;
      const V v =
          *reinterpret_cast<const V*>(sx + (y * W + xx) * kCT + lane * VW);
#pragma unroll
      for (int c = 0; c < VW; ++c) {
        acc.v[c] = reduce(acc.v[c], to_f32(v.v[c]), kMax);
      }
    }
    *reinterpret_cast<F*>(srow + r * kCT + lane * VW) = acc;
  }
  __syncthreads();

  // Pass B: the row results reduced over each output row's window.
  T* on = out + (size_t)n * OH * OW * C + c0;
  for (int i = threadIdx.x; i < OH * OW * LANES; i += kThreads) {
    const int lane = i % LANES;
    const int o = i / LANES;
    if (lane >= lanes) continue;
    const int oy = o / OW;
    const int ox = o - oy * OW;
    const int y0 = oy * S - PT;
    F acc;
#pragma unroll
    for (int c = 0; c < VW; ++c) acc.v[c] = init;
    for (int ky = 0; ky < K; ++ky) {
      const int yy = y0 + ky;
      if (yy < 0 || yy >= H) continue;
      const F r = *reinterpret_cast<const F*>(srow + (yy * OW + ox) * kCT +
                                              lane * VW);
#pragma unroll
      for (int c = 0; c < VW; ++c) acc.v[c] = reduce(acc.v[c], r.v[c], kMax);
    }
    V res;
    if (kMax) {
#pragma unroll
      for (int c = 0; c < VW; ++c) res.v[c] = from_f32<T>(acc.v[c]);
    } else {
      const int x0 = ox * S - PL;
      const float count =
          __fmul_rn((float)(min(y0 + K, H) - max(y0, 0)),
                    (float)(min(x0 + K, W) - max(x0, 0)));
#pragma unroll
      for (int c = 0; c < VW; ++c) {
        res.v[c] = from_f32<T>(__fdiv_rn(acc.v[c], count));
      }
    }
    *reinterpret_cast<V*>(on + o * C + lane * VW) = res;
  }
}

// Runs the tiled kernel when the tile fits in shared memory; false if not.
template <typename T>
bool try_tiled(const void* x, void* out, int N, int H, int W, int C, int OH,
               int OW, int k, int s, int pad_t, int pad_l, int is_max,
               cudaStream_t st) {
  const void* ptrs[2] = {x, out};
  const Tiling t = tiling_for<T>(C, ptrs, 2);
  const size_t smem = (size_t)H * W * t.ct * sizeof(T) +
                      (size_t)H * OW * t.ct * sizeof(float);
  if (smem > kSmemBudget || (size_t)H * W * C >= (1u << 31) ||
      (size_t)N * t.tiles >= (1u << 31)) {
    return false;
  }
  const unsigned grid = (unsigned)N * (unsigned)t.tiles;
  dispatch(t.vector, H, W, k, s, OH, OW, pad_t, pad_l,
           [&](auto geo, auto vec) {
             constexpr bool kVec = decltype(vec)::value;
             constexpr int kVW = kVec ? (int)(16 / sizeof(T)) : 1;
             constexpr int kLanes = kVec ? kVecLanes : kScalarLanes;
             using G = decltype(geo);
             if (is_max) {
               pool_same_fwd_tiled<T, kVW, kLanes, true, G>
                   <<<grid, kThreads, smem, st>>>((const T*)x, (T*)out, C,
                                                  t.tiles, geo);
             } else {
               pool_same_fwd_tiled<T, kVW, kLanes, false, G>
                   <<<grid, kThreads, smem, st>>>((const T*)x, (T*)out, C,
                                                  t.tiles, geo);
             }
           });
  return true;
}

template <typename T>
void launch(const void* x, void* out, int N, int H, int W, int C, int OH,
            int OW, int k, int s, int pad_t, int pad_l, int is_max,
            cudaStream_t st) {
  if (try_tiled<T>(x, out, N, H, W, C, OH, OW, k, s, pad_t, pad_l, is_max,
                   st)) {
    return;
  }
  const size_t total = (size_t)N * OH * OW * C;
  const int threads = 256;
  size_t blocks = (total + threads - 1) / threads;
  if (blocks > (1u << 20)) blocks = 1u << 20;
  if (is_max) {
    pool_same_fwd_untiled<T, true><<<(unsigned)blocks, threads, 0, st>>>(
        (const T*)x, (T*)out, total, H, W, C, OH, OW, k, s, pad_t, pad_l);
  } else {
    pool_same_fwd_untiled<T, false><<<(unsigned)blocks, threads, 0, st>>>(
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
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    launch<__nv_bfloat16>(x, out, N, H, W, C, OH, OW, k, s, pad_t, pad_l,
                          is_max, st);
  } else {
    launch<float>(x, out, N, H, W, C, OH, OW, k, s, pad_t, pad_l, is_max,
                  st);
  }
  return (int)cudaGetLastError();
}
