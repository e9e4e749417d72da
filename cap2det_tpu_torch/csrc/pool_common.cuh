// Pieces shared by the SAME pool forward (pool.cu) and backward
// (pool_grad.cu) kernels.
//
// The tiled kernels give one block one ROI n of an [N, H, W, C] map and
// one channel tile, stage the tile of every pixel of that ROI in shared
// memory, and work on it there: HBM sees each input read once and each
// output written once. The vector path, taken when a pixel's C channels
// span a multiple of 16 bytes, moves 16 bytes per thread (8 bf16 or 4
// float32 channels) with cp.async and 16-byte stores; a tile is 8 such
// lanes, 128 bytes of each pixel. Otherwise the scalar path moves one
// channel per thread, 32 channels per tile. All index arithmetic is 32-bit
// within a block; a Geom whose template arguments are nonzero fixes H, W,
// k and s at compile time for the shapes the model runs, so its divisions
// become multiplies.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace cap2det {
namespace pool {

constexpr int kThreads = 128;
constexpr int kVecLanes = 8;      // 16-byte lanes per tile, vector path
constexpr int kScalarLanes = 32;  // channels per tile, scalar path
// Dynamic shared memory a block may take without an opt-in attribute;
// larger maps run the untiled kernels.
constexpr size_t kSmemBudget = 48 * 1024;

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

// VW values of T moved as one access (at most 16 bytes aligned).
template <typename T, int VW>
struct alignas(sizeof(T) * VW > 16 ? 16 : sizeof(T) * VW) Vec {
  T v[VW];
};

// TF SAME geometry. Nonzero template arguments are the compile-time H, W,
// k and s; zero means the runtime fields.
template <int kH, int kW, int kK, int kS>
struct Geom {
  int h, w, k, s, oh, ow, pt, pl;

  __host__ __device__ static constexpr int out_of(int n, int st) {
    return (n + st - 1) / st;
  }
  __host__ __device__ static constexpr int pad_of(int n, int kk, int st) {
    return (out_of(n, st) - 1) * st + kk - n > 0
               ? ((out_of(n, st) - 1) * st + kk - n) / 2
               : 0;
  }
  __device__ __forceinline__ int H() const { return kH ? kH : h; }
  __device__ __forceinline__ int W() const { return kW ? kW : w; }
  __device__ __forceinline__ int K() const { return kK ? kK : k; }
  __device__ __forceinline__ int S() const { return kS ? kS : s; }
  // (kS1: a nonzero stand-in, so the runtime form folds no division by
  // zero.)
  static constexpr int kS1 = kS ? kS : 1;
  __device__ __forceinline__ int OH() const {
    return kH ? out_of(kH, kS1) : oh;
  }
  __device__ __forceinline__ int OW() const {
    return kW ? out_of(kW, kS1) : ow;
  }
  __device__ __forceinline__ int PT() const {
    return kH ? pad_of(kH, kK, kS1) : pt;
  }
  __device__ __forceinline__ int PL() const {
    return kW ? pad_of(kW, kK, kS1) : pl;
  }
};

// True when the runtime geometry is the one Geom<kH, kW, kK, kS> fixes.
template <int kH, int kW, int kK, int kS>
inline bool geom_is(int H, int W, int k, int s, int OH, int OW, int pt,
                    int pl) {
  using G = Geom<kH, kW, kK, kS>;
  return H == kH && W == kW && k == kK && s == kS &&
         OH == G::out_of(kH, kS) && OW == G::out_of(kW, kS) &&
         pt == G::pad_of(kH, kK, kS) && pl == G::pad_of(kW, kK, kS);
}

// Output windows along one axis that contain input index i: [lo, hi]
// (empty when lo > hi, as for a stride above the kernel).
__device__ __forceinline__ void windows_of(int i, int pad, int k, int s,
                                           int out, int* lo, int* hi) {
  const int a = i + pad - k + 1;
  *lo = a <= 0 ? 0 : (a + s - 1) / s;
  *hi = min((i + pad) / s, out - 1);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Copies `rows` pixels x `lanes` lanes of one channel tile from a
// [rows, C] slab in global memory (src at the tile's first channel) into
// shared [rows][VW * LANES]. Every thread of the block takes part; the
// caller waits (cp_async_wait_all) and synchronises afterwards.
template <typename T, int VW, int LANES>
__device__ __forceinline__ void stage(T* dst, const T* src, int rows, int C,
                                      int lanes) {
  constexpr int kCT = VW * LANES;
  for (int i = threadIdx.x; i < rows * LANES; i += kThreads) {
    const int lane = i % LANES;
    const int r = i / LANES;
    if (lane >= lanes) continue;
    T* d = dst + r * kCT + lane * VW;
    const T* s = src + r * C + lane * VW;
    if constexpr (sizeof(T) * VW == 16) {
      cp_async16(d, s);
    } else {
      *reinterpret_cast<Vec<T, VW>*>(d) =
          *reinterpret_cast<const Vec<T, VW>*>(s);
    }
  }
}

// Channel tiling of a [N, H, W, C] launch: `ct` channels per tile, as
// 16-byte lanes when `vector`, else one channel per lane.
struct Tiling {
  bool vector;
  int ct, tiles;
};

template <typename T>
inline Tiling tiling_for(int C, const void* const* ptrs, int nptrs) {
  bool vector = (C * sizeof(T)) % 16 == 0;
  for (int i = 0; i < nptrs; ++i) {
    vector = vector && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  }
  const int ct = vector ? (int)(16 / sizeof(T)) * kVecLanes : kScalarLanes;
  return {vector, ct, (C + ct - 1) / ct};
}

// Calls launch(geo, std::integral_constant<bool, vector>{}) with a Geom that
// fixes the model's (7x7, 3/s2) and (4x4, 3/s1) at compile time on the
// vector path, and a runtime Geom otherwise.
template <class Launch>
inline void dispatch(bool vector, int H, int W, int k, int s, int OH, int OW,
                     int pt, int pl, Launch&& launch) {
  using Vector = std::true_type;
  if (vector && geom_is<7, 7, 3, 2>(H, W, k, s, OH, OW, pt, pl)) {
    launch(Geom<7, 7, 3, 2>{}, Vector{});
  } else if (vector && geom_is<4, 4, 3, 1>(H, W, k, s, OH, OW, pt, pl)) {
    launch(Geom<4, 4, 3, 1>{}, Vector{});
  } else if (vector) {
    launch(Geom<0, 0, 0, 0>{H, W, k, s, OH, OW, pt, pl}, Vector{});
  } else {
    launch(Geom<0, 0, 0, 0>{H, W, k, s, OH, OW, pt, pl}, std::false_type{});
  }
}

}  // namespace pool
}  // namespace cap2det
