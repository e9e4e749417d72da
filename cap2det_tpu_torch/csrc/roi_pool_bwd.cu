// Fused ROI crop_and_resize + VALID max-pool, backward (K2), for Hopper
// (sm_90a).
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
// gradient. Cells whose gradient is 0 and corners whose contribution is 0
// add nothing.
//
// Reproducible sums. Each contribution v = (g * wy) * wx is rounded once
// to 64-bit fixed point, q = rint(v * 2^32), and added as an integer into
// an int64 map the caller zeroes; a second kernel converts the map to the
// features' dtype, rounding once. Integer addition is associative and
// commutative, so any order and any grouping of the same q's gives the
// same bits: the shared-memory partial sums below cannot change a bit, and
// the result equals `ops/roi.crop_resize_maxpool_grad(..., fixed_point=
// True)`, which quantises each contribution the same way and adds with
// index_add_ on int64. Range +-2^31 at a resolution of 2^-32: each
// contribution is off by at most 2^-33, so a dF value built from a
// thousand of them is within 1.2e-7 of the exact sum before its one
// rounding to float32. Overflow: |v| <= |g| (the bilinear weights are in
// [0, 1]), and the two's-complement sum wraps and unwraps exactly (a
// shared partial sum is just another grouping), so only the final values
// have to lie within +-2^31 = 2.1e9, and every single |g| below it; |dF|
// at the coco17 shape with unit-normal pooled gradients is at most 155,
// seven orders of magnitude inside.
//
// What bounds it on the H100: bytes, and the atomics. At the coco17
// training shape (features [2, 64, 96, 576] bf16, P = 500, S = 14, 2x2/s2)
// the compulsory traffic is one read of the 14 MB map and of the 56 MB
// pooled gradient plus one write of the dF map, 0.0253 ms. What costs the
// time is the int64 atomics into a 57 MB map that does not fit the 50 MB
// L2: the kernel's time grows with their count, about linearly. The first
// port issued one per nonzero (winner corner, channel): 99.7 M per launch
// with chip_smoke.py's box mix at that shape. This kernel issues 73.9 M
// (all-narrow boxes: 38.1 M of 108.1 M; all-wide: 101.3 M of 102.7 M).
// Both counts come from the fixed-point oracle with this kernel's rule
// (kernels/roi_pool.py `grad_atomic_counts`, ops/roi.py
// `crop_resize_maxpool_grad_atomics`); chip_smoke.py phase 5 prints them.
// Times are in PERF.md.
//
// The design (staged kernel), the forward's block geometry: one proposal
// and one 128-byte channel tile per block, the footprint R x C x tile
// staged in shared memory when it fits the slot budget, read from L2 with
// the same 16-byte loads when not (roi_common.cuh), so the winners come
// from the same values as K1's maxima. Pass 1: each thread owns one
// 16-byte lane of one pooled cell, reads its gradients with one 16-byte
// load, recomputes the k x k samples, and keeps each channel's winning tap
// (a byte) and gradient in shared memory. Pass 2: each thread owns one
// channel of one cell and lands its four corner contributions. When the
// footprint is small (|R| |C| x tile x 8 bytes fits the slot budget's
// bytes, which the staged features no longer need), corners repeat across
// cells, so the contributions go into an int64 accumulator over the
// footprint slots in shared memory, and one global atomic per touched
// (slot, channel) follows, a warp's 32 of them on 32 consecutive int64
// addresses. Wider boxes add straight to the global map.
//
// A gather form without global atomics (one block per image and channel
// pair, holding the pair's map and int64 dF in shared memory and walking
// every (proposal, cell)) was measured too: exact, flat across box sizes,
// and no faster on the box mix, since it recomputes each window for two
// channels at a time (PERF.md). It is not kept.
//
// Dispatch: as the forward (kernels/roi_pool.py `_staged`); the generic
// kernel (one channel per thread, samples from L2, one atomic per
// contribution) takes the rest.

#include "roi_common.cuh"

namespace {

using cap2det::Footprint;
using cap2det::kLanes;
using cap2det::kMaxCrop;
using cap2det::Vec;

constexpr float kFixedScale = 4294967296.0f;               // 2^32
constexpr float kFixedInvScale = 2.3283064365386963e-10f;  // 2^-32

__device__ __forceinline__ unsigned long long fixed_of(float v) {
  return (unsigned long long)__float2ll_rn(__fmul_rn(v, kFixedScale));
}

// Bytes of the backward's per-cell region: a tile of gradients (T) and of
// winner taps (one byte each) for every pooled cell.
template <typename T>
__host__ __device__ constexpr size_t cell_bytes(int pooled) {
  return (size_t)pooled * pooled * (cap2det::kTileBytes / sizeof(T)) *
         (sizeof(T) + 1);
}

template <typename T>
__global__ void __launch_bounds__(cap2det::kStagedThreads)
    roi_crop_maxpool_grad_staged_kernel(
        const T* __restrict__ feat, const float* __restrict__ boxes,
        const T* __restrict__ grad, unsigned long long* __restrict__ dfeat,
        int H, int W, int C, int P, int S, int pk, int ps, int pooled,
        int slots) {
  constexpr int VW = 16 / sizeof(T);
  constexpr int kCT = VW * kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Footprint f;

  const int p = blockIdx.x;
  const int tile = blockIdx.y;
  const int b = blockIdx.z;
  const int lanes = min(kLanes, (C - tile * kCT) / VW);
  const int nch = lanes * VW;
  const T* fb = feat + (size_t)b * H * W * C + tile * kCT;
  const int slot_bytes = slots * cap2det::kTileBytes;
  T* fs = reinterpret_cast<T*>(smem);
  T* gs = reinterpret_cast<T*>(smem + slot_bytes);
  unsigned char* taps =
      smem + slot_bytes + (size_t)pooled * pooled * kCT * sizeof(T);

  cap2det::footprint<kCT>(boxes + ((size_t)b * P + p) * 4, H, W, C, S,
                          slots, f);
  cap2det::stage_footprint(fs, fb, f, W, C, lanes);
  const T* src = f.staged ? fs : fb;

  // Pass 1: winners, first maximal tap in row-major order per channel.
  const size_t gbase = ((size_t)b * P + p) * pooled * pooled * C + tile * kCT;
  for (int w = threadIdx.x; w < pooled * pooled * kLanes; w += blockDim.x) {
    const int lane = w % kLanes;
    const int cell = w / kLanes;
    if (lane >= lanes) continue;
    const int oy = cell / pooled;
    const int ox = cell - oy * pooled;
    *reinterpret_cast<Vec<T, VW>*>(gs + cell * kCT + lane * VW) =
        *reinterpret_cast<const Vec<T, VW>*>(grad + gbase + (size_t)cell * C +
                                             lane * VW);
    float best[VW];
    unsigned char tap[VW];
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      best[e] = -INFINITY;
      tap[e] = 0;
    }
    for (int ky = 0; ky < pk; ++ky) {
      for (int kx = 0; kx < pk; ++kx) {
        float v[VW];
        cap2det::staged_sample<T, VW>(src + lane * VW, f, oy * ps + ky,
                                      ox * ps + kx, v);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          if (v[e] > best[e]) {  // a later equal value does not replace it
            best[e] = v[e];
            tap[e] = (unsigned char)(ky * pk + kx);
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < VW; ++e) taps[cell * kCT + lane * VW + e] = tap[e];
  }
  __syncthreads();

  // Pass 2: the corner contributions, into shared partial sums over the
  // footprint slots (which reuse the staged features' bytes) when they fit.
  const int nc = f.n[1];
  const int nslots = f.n[0] * nc;
  const bool local = (size_t)nslots * kCT * 8 <= (size_t)slot_bytes;
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(smem);
  if (local) {
    for (int t = threadIdx.x; t < nslots * kCT; t += blockDim.x) acc[t] = 0;
    __syncthreads();
  }
  unsigned long long* db = dfeat + (size_t)b * H * W * C + tile * kCT;
  for (int w = threadIdx.x; w < pooled * pooled * kCT; w += blockDim.x) {
    const int ch = w % kCT;
    const int cell = w / kCT;
    if (ch >= nch) continue;
    const float g = cap2det::to_f32(gs[w]);
    if (g == 0.0f) continue;
    const int t = taps[w];
    const int ky = t / pk;
    const int oy = cell / pooled;
    const int i = oy * ps + ky;
    const int j = (cell - oy * pooled) * ps + (t - ky * pk);
    const float gy[2] = {__fmul_rn(g, f.wa[0][i]), __fmul_rn(g, f.wb[0][i])};
    const float wx[2] = {f.wa[1][j], f.wb[1][j]};
    for (int dy = 0; dy < 2; ++dy) {
      for (int dx = 0; dx < 2; ++dx) {
        const float v = __fmul_rn(gy[dy], wx[dx]);
        if (v == 0.0f) continue;
        if (local) {
          const int slot = (f.slot[0][i] + dy) * nc + f.slot[1][j] + dx;
          atomicAdd(acc + slot * kCT + ch, fixed_of(v));
        } else {
          atomicAdd(db + ((size_t)(f.idx[0][i] + dy) * W + f.idx[1][j] + dx) *
                             C + ch,
                    fixed_of(v));
        }
      }
    }
  }
  if (local) {
    __syncthreads();
    for (int t = threadIdx.x; t < nslots * kCT; t += blockDim.x) {
      const int ch = t % kCT;
      const int slot = t / kCT;
      const unsigned long long q = acc[t];
      if (ch >= nch || q == 0) continue;
      atomicAdd(db + ((size_t)f.set[0][slot / nc] * W + f.set[1][slot % nc]) *
                         C + ch,
                q);
    }
  }
}

template <typename T>
__global__ void roi_crop_maxpool_grad_generic_kernel(
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
            atomicAdd(d0 + dy * row + (size_t)dx * C, fixed_of(v));
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

template <typename T>
int launch_staged(const void* feat, const void* boxes, const void* grad,
                  void* dfeat, int B, int H, int W, int C, int P, int S,
                  int pk, int ps, cudaStream_t st) {
  static size_t allowed = 0;
  const void* ptrs[] = {feat, grad};
  if (!cap2det::staged_args_ok(H, W, C, S, pk, ps, sizeof(T), ptrs, 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const int pooled = (S - pk) / ps + 1;
  const int slots = cap2det::staged_slots(S, H, W);
  const size_t bytes =
      (size_t)slots * cap2det::kTileBytes + cell_bytes<T>(pooled);
  if (bytes > cap2det::kStagedSmem) return (int)cudaErrorInvalidValue;
  auto kernel = roi_crop_maxpool_grad_staged_kernel<T>;
  const cudaError_t rc = cap2det::allow_smem(kernel, bytes, &allowed);
  if (rc != cudaSuccess) return (int)rc;
  constexpr int kCT = 16 / sizeof(T) * kLanes;
  const dim3 grid(P, (C + kCT - 1) / kCT, B);
  kernel<<<grid, cap2det::kStagedThreads, bytes, st>>>(
      (const T*)feat, (const float*)boxes, (const T*)grad,
      (unsigned long long*)dfeat, H, W, C, P, S, pk, ps, pooled, slots);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cap2det_roi_crop_maxpool_bwd_staged(
    const void* feat, const void* boxes, const void* grad, void* dfeat,
    int B, int H, int W, int C, int P, int S, int pk, int ps, int is_bf16,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_staged<__nv_bfloat16>(feat, boxes, grad, dfeat, B,
                                                H, W, C, P, S, pk, ps, st)
                 : launch_staged<float>(feat, boxes, grad, dfeat, B, H, W, C,
                                        P, S, pk, ps, st);
}

extern "C" int cap2det_roi_crop_maxpool_bwd_generic(
    const void* feat, const void* boxes, const void* grad, void* dfeat,
    int B, int H, int W, int C, int P, int S, int pk, int ps, int is_bf16,
    int threads, void* stream) {
  if (S < 1 || S > kMaxCrop || pk < 1 || ps < 1 || pk > S || H < 2 ||
      W < 2 || threads < 32 || threads > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const int pooled = (S - pk) / ps + 1;
  const dim3 grid(P, (C + threads - 1) / threads, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    roi_crop_maxpool_grad_generic_kernel<__nv_bfloat16>
        <<<grid, threads, 0, st>>>(
            (const __nv_bfloat16*)feat, (const float*)boxes,
            (const __nv_bfloat16*)grad, (unsigned long long*)dfeat, H, W, C,
            P, S, pk, ps, pooled);
  } else {
    roi_crop_maxpool_grad_generic_kernel<float><<<grid, threads, 0, st>>>(
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
