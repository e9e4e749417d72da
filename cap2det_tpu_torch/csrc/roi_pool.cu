// Fused ROI crop_and_resize + VALID max-pool, forward (K1), for Hopper
// (sm_90a).
//
// Replaces: cap2det_tpu/kernels/roi_pool.py, `_forward` -> `_fwd_kernel`
// (with `_precompute_coords`, `_crop_pool_pass`, `_narrow_window` and
// `_crop_pass`), the Pallas TPU kernel behind `roi_crop_maxpool`, and its
// alternatives `_forward_ymm` / `_forward_mm`, which compute the same
// function.
//
// Function: for each image b, proposal p and channel c, a TF
// crop_and_resize of the normalised box to S x S samples (0 outside the
// map; y-lerp of two feature rows, then x-lerp; floor index clamped to
// [0, extent-2]), then a k x k / stride s VALID max-pool. Arithmetic is
// float32 in the operation order of `_crop_pool_pass` (roi_common.cuh,
// shared with the backward in roi_pool_bwd.cu); the result is stored in the
// features' dtype. It equals `ops/roi.crop_resize_maxpool_exact` bit for
// bit.
//
// What bounds it on the H100. At the serving shape (features
// [1, 76, 114, 576] bf16, P = 2000, S = 14, 2x2/s2) there are two floors:
//  - HBM bytes: one read of the 10 MB map and one write of the 113 MB
//    pooled output, 0.0367 ms at 3.35 TB/s;
//  - the gathered footprint: a proposal's samples touch |R| x |C| map
//    positions (R, C its distinct rows and columns, each at most 2S), and
//    summed over the proposals that is about 1.02 GB at 76x114 (mean 444 of
//    784 positions), served from the 50 MB L2, where the map stays.
// The arithmetic (about 40 float32 operations per output) is below both.
//
// The design (staged kernel). A block takes one proposal and one 128-byte
// channel tile (64 bf16 or 32 float32 channels, 8 lanes of 16 bytes). It
// computes the 2 x S sample coordinates and the footprint R x C once
// (roi_common.cuh `footprint`, one warp scan per axis) and, when |R| |C|
// fits the launch's slot budget, copies R x C x tile into shared memory
// with 16-byte cp.async, one read per distinct position. Then every thread
// owns one 16-byte lane of one pooled cell: it makes the k x k samples of
// its 8 (or 4) channels, takes their maximum and writes 16 bytes, so a
// tile's 8 lanes write 128 contiguous bytes per cell. A footprint above
// the budget is read from L2 with the same 16-byte loads: wide boxes touch
// each position about once, so staging them buys nothing, and a budget of
// all (2S)^2 = 784 positions (100 KB) would leave room for two blocks per
// SM. The budget (roi_common.cuh kStagedSlots, 256 positions, 32 KB) was
// chosen on the card from timings over budgets of 64 to 784 (PERF.md).
// That replaces the first port's one bf16 channel per thread with 784
// scalar L2 loads per proposal and channel. Measured so, the kernel's time
// no longer follows the footprint bytes (all-narrow and all-wide boxes
// within 4% of each other at every serving map): it follows the
// instructions it issues per output (float32 lerps, each operation on its
// own so that no FMA changes a bit, bf16 conversions, 16-byte loads).
//
// Dispatch (static, on the host: kernels/roi_pool.py `_staged`). The staged
// kernel takes rows of C channels that are a multiple of 16 bytes, 16-byte
// aligned pointers, S <= 32, k*k <= 256 and a map of fewer than 2^31
// values, when its shared memory (with the backward's gradient tile) fits
// 220 KB. Everything else (C = 130 or 33, crops above 32) runs the generic
// kernel: one channel per thread, samples read from the map (L2), any
// k <= S and any stride. Both are hand-written kernels; neither falls back
// to PyTorch.

#include "roi_common.cuh"

namespace {

using cap2det::Footprint;
using cap2det::kLanes;
using cap2det::kMaxCrop;
using cap2det::Vec;

template <typename T>
__global__ void __launch_bounds__(cap2det::kStagedThreads)
    roi_crop_maxpool_staged_kernel(const T* __restrict__ feat,
                                   const float* __restrict__ boxes,
                                   T* __restrict__ out, int H, int W, int C,
                                   int P, int S, int pk, int ps, int pooled,
                                   int slots) {
  constexpr int VW = 16 / sizeof(T);
  constexpr int kCT = VW * kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Footprint f;

  const int p = blockIdx.x;
  const int tile = blockIdx.y;
  const int b = blockIdx.z;
  const int lanes = min(kLanes, (C - tile * kCT) / VW);
  const T* fb = feat + (size_t)b * H * W * C + tile * kCT;
  T* fs = reinterpret_cast<T*>(smem);

  cap2det::footprint<kCT>(boxes + ((size_t)b * P + p) * 4, H, W, C, S,
                          slots, f);
  cap2det::stage_footprint(fs, fb, f, W, C, lanes);
  const T* src = f.staged ? fs : fb;

  T* ob = out + ((size_t)b * P + p) * pooled * pooled * C + tile * kCT;
  for (int w = threadIdx.x; w < pooled * pooled * kLanes; w += blockDim.x) {
    const int lane = w % kLanes;
    const int cell = w / kLanes;
    if (lane >= lanes) continue;
    const int oy = cell / pooled;
    const int ox = cell - oy * pooled;
    float m[VW];
#pragma unroll
    for (int e = 0; e < VW; ++e) m[e] = -INFINITY;
    for (int ky = 0; ky < pk; ++ky) {
      for (int kx = 0; kx < pk; ++kx) {
        float v[VW];
        cap2det::staged_sample<T, VW>(src + lane * VW, f, oy * ps + ky,
                                      ox * ps + kx, v);
#pragma unroll
        for (int e = 0; e < VW; ++e) m[e] = fmaxf(m[e], v[e]);
      }
    }
    Vec<T, VW> o;
#pragma unroll
    for (int e = 0; e < VW; ++e) o.v[e] = cap2det::from_f32<T>(m[e]);
    *reinterpret_cast<Vec<T, VW>*>(ob + (size_t)cell * C + lane * VW) = o;
  }
}

template <typename T>
__global__ void roi_crop_maxpool_generic_kernel(
    const T* __restrict__ feat, const float* __restrict__ boxes,
    T* __restrict__ out, int H, int W, int C, int P, int S, int pk, int ps,
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

template <typename T>
int launch_staged(const void* feat, const void* boxes, void* out, int B,
                  int H, int W, int C, int P, int S, int pk, int ps,
                  cudaStream_t st) {
  static size_t allowed = 0;
  const void* ptrs[] = {feat, out};
  if (!cap2det::staged_args_ok(H, W, C, S, pk, ps, sizeof(T), ptrs, 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const int slots = cap2det::staged_slots(S, H, W);
  const size_t bytes = (size_t)slots * cap2det::kTileBytes;
  auto kernel = roi_crop_maxpool_staged_kernel<T>;
  const cudaError_t rc = cap2det::allow_smem(kernel, bytes, &allowed);
  if (rc != cudaSuccess) return (int)rc;
  constexpr int kCT = 16 / sizeof(T) * kLanes;
  const dim3 grid(P, (C + kCT - 1) / kCT, B);
  kernel<<<grid, cap2det::kStagedThreads, bytes, st>>>(
      (const T*)feat, (const float*)boxes, (T*)out, H, W, C, P, S, pk, ps,
      (S - pk) / ps + 1, slots);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cap2det_roi_crop_maxpool_fwd_staged(
    const void* feat, const void* boxes, void* out, int B, int H, int W,
    int C, int P, int S, int pk, int ps, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_staged<__nv_bfloat16>(feat, boxes, out, B, H, W, C,
                                                P, S, pk, ps, st)
                 : launch_staged<float>(feat, boxes, out, B, H, W, C, P, S,
                                        pk, ps, st);
}

extern "C" int cap2det_roi_crop_maxpool_fwd_generic(
    const void* feat, const void* boxes, void* out, int B, int H, int W,
    int C, int P, int S, int pk, int ps, int is_bf16, int threads,
    void* stream) {
  if (S < 1 || S > kMaxCrop || pk < 1 || ps < 1 || pk > S || H < 2 ||
      W < 2 || threads < 32 || threads > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const int pooled = (S - pk) / ps + 1;
  const dim3 grid(P, (C + threads - 1) / threads, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    roi_crop_maxpool_generic_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        (const __nv_bfloat16*)feat, (const float*)boxes,
        (__nv_bfloat16*)out, H, W, C, P, S, pk, ps, pooled);
  } else {
    roi_crop_maxpool_generic_kernel<float><<<grid, threads, 0, st>>>(
        (const float*)feat, (const float*)boxes, (float*)out, H, W, C, P, S,
        pk, ps, pooled);
  }
  return (int)cudaGetLastError();
}
