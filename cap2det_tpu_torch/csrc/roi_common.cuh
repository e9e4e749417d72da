// Helpers shared by the ROI crop+pool forward (roi_pool.cu, K1) and
// backward (roi_pool_bwd.cu, K2), so the two kernels sample the feature map
// at exactly the same points with exactly the same arithmetic.
//
// Replaces the shared pieces of cap2det_tpu/kernels/roi_pool.py:
// `_sample_coords` / `_precompute_coords` (the sampling), and the VMEM
// residency of `_fwd_kernel` / `_bwd_kernel_catf`, which keep an image's
// [H, W, CB] feature block on chip while they walk its proposals. Hopper
// has 227 KB of shared memory a block, not megabytes of VMEM, so the
// counterpart here is per proposal: `footprint` finds the few rows and
// columns a proposal's samples touch, and `stage_footprint` copies exactly
// those positions of one 128-byte channel tile into shared memory with
// 16-byte cp.async, one read per distinct position, when they fit the
// launch's slot budget. Every sample is then computed from there.
//
// The sampling follows TF crop_and_resize as the JAX package spells it:
//   coord = start*h_max + i*(end-start)*h_max/(S-1)
// evaluated left to right; a sample outside [0, h_max] gets zero weights;
// the floor index is clamped to [0, extent-2] so idx and idx+1 are both
// rows (or columns) of the map. Rounded intrinsics keep nvcc from
// contracting any of it into FMAs, so the plain PyTorch versions
// (ops/roi.py, `crop_samples`), which run the same operations one at a
// time, see the same values bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "pool_common.cuh"

namespace cap2det {

constexpr int kMaxCrop = 64;
// The staged kernels: crops up to kStagedMaxCrop (one warp scans an
// axis), a block of kStagedThreads, a channel tile of kLanes 16-byte lanes
// (128 bytes: 64 bf16 or 32 float32 channels), and at most kStagedSmem
// bytes of dynamic shared memory (the footprint slots, plus the backward's
// gradients and winners).
constexpr int kStagedMaxCrop = 32;
constexpr int kStagedThreads = 256;
constexpr int kLanes = 8;
constexpr int kTileBytes = 16 * kLanes;
constexpr size_t kStagedSmem = 220 * 1024;
// Footprint positions a staged block may hold in shared memory, its slot
// budget (256 x 128 B = 32 KB): a block whose proposal touches more reads
// them from L2 instead. The budget sets every block's shared memory, hence
// how many blocks share an SM; 256 was chosen from timings of both kernels
// over budgets of 64 to 784 positions on the H100 (PERF.md).
constexpr int kStagedSlots = 256;

// A launch's slot budget: kStagedSlots, or the largest footprint,
// min(2S, H) x min(2S, W), if that is smaller.
inline int staged_slots(int S, int H, int W) {
  const int rows = 2 * S < H ? 2 * S : H;
  const int cols = 2 * S < W ? 2 * S : W;
  return rows * cols < kStagedSlots ? rows * cols : kStagedSlots;
}

using pool::cp_async16;
using pool::cp_async_wait_all;
using pool::Vec;

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
template <int N>
__device__ __forceinline__ void sample_coords(const float* box, int H, int W,
                                              int S, int (*s_idx)[N],
                                              float (*s_wa)[N],
                                              float (*s_wb)[N]) {
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
// order. `fb` points at channel c of the image; `row` = W*C. (The
// generic kernels, one channel per thread, read straight from the map.)
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

// ---------------------------------------------------------------------------
// The staged kernels' footprint.
//
// A proposal's samples read rows idx_y[i], idx_y[i]+1 and columns
// idx_x[j], idx_x[j]+1 only: the product of a row set R and a column set
// C, each at most 2S entries. The sample coordinate is monotone in i (each
// rounded operation of `sample_coords` is), so idx is non-decreasing, or
// non-increasing for a reversed box (ymin > ymax, which TF crop_and_resize
// flips). Walking the samples in increasing idx, each adds min(d, 2) new
// values to the sorted set, d the step from the previous idx: one warp scan
// per axis gives every sample's slot in the set, and the slot of idx+1 is
// the slot of idx plus one. Zero padding boxes give R = C = {0, 1}.
//
// A block stages its footprint when |R| |C| fits the launch's slot budget
// (the dynamic shared memory it asked for); a larger one, which rarely
// reads a position twice, reads the same positions from the map (L2) with
// the same 16-byte loads. Either way a sample sees the same values and
// makes the same bits.
// ---------------------------------------------------------------------------

constexpr int kMaxSet = 2 * kStagedMaxCrop;

struct Footprint {
  int idx[2][kStagedMaxCrop];
  float wa[2][kStagedMaxCrop];
  float wb[2][kStagedMaxCrop];
  int slot[2][kStagedMaxCrop];  // slot of idx[axis][i] in set[axis]
  int off[2][kStagedMaxCrop];   // offset of sample i's idx row / column
  int set[2][kMaxSet];          // R and C, ascending
  int n[2];                     // |R|, |C|
  int step[2];                  // offset from row idx to idx+1, column too
  int staged;                   // the footprint is in shared memory
};

// Fills f for one box, for a tile whose map rows hold C channels and whose
// staged copy, if |R| |C| <= slots, holds kCT channels per position. Every
// thread of the block takes part; f is ready (and synchronised) on return.
template <int kCT>
__device__ __forceinline__ void footprint(const float* box, int H, int W,
                                          int C, int S, int slots,
                                          Footprint& f) {
  sample_coords(box, H, W, S, f.idx, f.wa, f.wb);
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp < 2) {  // warp a builds axis a
    const int* idx = f.idx[warp];
    const bool reversed = idx[S - 1] < idx[0];
    const int i = reversed ? S - 1 - lane : lane;
    const int v = lane < S ? idx[i] : 0;
    const int prev = __shfl_up_sync(0xffffffffu, v, 1);
    int slot = lane == 0 || lane >= S ? 0 : min(max(v - prev, 0), 2);
    for (int d = 1; d < 32; d *= 2) {
      const int other = __shfl_up_sync(0xffffffffu, slot, d);
      if (lane >= d) slot += other;
    }
    if (lane < S) {
      f.slot[warp][i] = slot;
      f.set[warp][slot] = v;
      f.set[warp][slot + 1] = v + 1;
    }
    const int last = __shfl_sync(0xffffffffu, slot, S - 1);
    if (lane == 0) f.n[warp] = last + 2;
  }
  __syncthreads();
  const int staged = f.n[0] * f.n[1] <= slots;
  for (int t = threadIdx.x; t < 2 * S; t += blockDim.x) {
    const int axis = t / S;
    const int i = t - axis * S;
    f.off[axis][i] = staged ? (axis == 0 ? f.slot[0][i] * f.n[1] * kCT
                                         : f.slot[1][i] * kCT)
                            : (axis == 0 ? f.idx[0][i] * W * C
                                         : f.idx[1][i] * C);
  }
  if (threadIdx.x == 0) {
    f.step[0] = staged ? f.n[1] * kCT : W * C;
    f.step[1] = staged ? kCT : C;
    f.staged = staged;
  }
  __syncthreads();
}

// Copies the footprint R x C of one channel tile (`lanes` 16-byte lanes
// from `fb`, the image's map at the tile's first channel) into shared
// `dst` [|R| * |C|][kCT], row-major over (R, C), when f.staged: one
// cp.async of 16 bytes per lane and distinct position, a warp per row of
// R. Waits and synchronises.
template <typename T>
__device__ __forceinline__ void stage_footprint(T* dst, const T* fb,
                                                const Footprint& f, int W,
                                                int C, int lanes) {
  constexpr int VW = 16 / sizeof(T);
  constexpr int kCT = VW * kLanes;
  if (f.staged) {
    const int nc = f.n[1];
    for (int r = threadIdx.x / 32; r < f.n[0]; r += blockDim.x / 32) {
      const T* src = fb + f.set[0][r] * W * C;
      T* row = dst + r * nc * kCT;
      for (int t = threadIdx.x % 32; t < nc * kLanes; t += 32) {
        const int lane = t % kLanes;
        const int c = t / kLanes;
        if (lane < lanes) {
          cp_async16(row + c * kCT + lane * VW,
                     src + f.set[1][c] * C + lane * VW);
        }
      }
    }
    cp_async_wait_all();
  }
  __syncthreads();
}

// The VW channels of one lane at crop sample (i, j): the four corners at
// `src` (the staged footprint, or the map when the footprint was too large
// to stage; at the lane's first channel) plus f's offsets, then the y-lerp
// at the two columns and the x-lerp, exactly `crop_sample`'s operations.
template <typename T, int VW>
__device__ __forceinline__ void staged_sample(const T* src,
                                              const Footprint& f, int i,
                                              int j, float* v) {
  const T* p00 = src + f.off[0][i] + f.off[1][j];
  const T* p10 = p00 + f.step[0];
  const Vec<T, VW> a00 = *reinterpret_cast<const Vec<T, VW>*>(p00);
  const Vec<T, VW> a01 = *reinterpret_cast<const Vec<T, VW>*>(p00 + f.step[1]);
  const Vec<T, VW> a10 = *reinterpret_cast<const Vec<T, VW>*>(p10);
  const Vec<T, VW> a11 = *reinterpret_cast<const Vec<T, VW>*>(p10 + f.step[1]);
  const float ya = f.wa[0][i];
  const float yb = f.wb[0][i];
  const float xa = f.wa[1][j];
  const float xb = f.wb[1][j];
#pragma unroll
  for (int e = 0; e < VW; ++e) {
    const float t0 = lerp2(to_f32(a00.v[e]), ya, to_f32(a10.v[e]), yb);
    const float t1 = lerp2(to_f32(a01.v[e]), ya, to_f32(a11.v[e]), yb);
    v[e] = lerp2(t0, xa, t1, xb);
  }
}

// The host-side checks both staged entries share (the wrapper's rule in
// kernels/roi_pool.py mirrors them and never sends anything else here).
inline bool staged_args_ok(int H, int W, int C, int S, int pk, int ps,
                           size_t elem, const void* const* ptrs, int nptrs) {
  if (S < 1 || S > kStagedMaxCrop || pk < 1 || ps < 1 || pk > S ||
      pk * pk > 256 || H < 2 || W < 2 || C < 1 ||
      (C * elem) % 16 != 0 || (long long)H * W * C >= (1LL << 31)) {
    return false;
  }
  for (int i = 0; i < nptrs; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  }
  return true;
}

// Raises a kernel's dynamic shared-memory limit above the 48 KB default
// and asks for the largest shared-memory carveout, once per size; returns
// the CUDA error, if any.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc == cudaSuccess) {
    rc = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
  }
  if (rc == cudaSuccess) *allowed = bytes;
  return rc;
}

}  // namespace cap2det
