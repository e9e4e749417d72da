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
// x's dtype. Windows are added in descending (oy, ox), the order in which
// the tap-by-tap plain versions (kernels/pool_grad.py) add them, so float32
// results agree bit for bit; nothing is scattered, so there are no atomics
// and the result is deterministic.
//
// What bounds it on the H100: bytes. A max window is at most 9 compares and
// every input element lies in at most 9 windows (4 at stride 2), far
// below the card's balance point; at [1000, 7, 7, 576] bf16 the
// compulsory traffic (x and dx 56 MB each, g 18 MB) is about 0.04 ms at
// 3.35 TB/s.
//
// Max form (K5), tiled. A thread per input element that recomputes the
// winner of every window containing it makes up to 9 windows x 9 taps = 81
// scalar loads per element at stride 1, where the forward needs 9; with
// 2-byte accesses and 64-bit index division that ran 4x slower than
// PyTorch's max_pool2d backward. So each winner is found once: a block
// takes one ROI and one channel tile (pool_common.cuh) and stages x and g
// of that ROI in shared memory with 16-byte cp.async. Pass 1 finds each
// window's winner once per channel (9 compares) and keeps its tap index as
// a byte in shared memory. Pass 2 gives each thread 8 bf16 (4 float32)
// channels of one input pixel: it walks the windows containing the pixel in
// descending (oy, ox), adds g where the window's winner is this pixel, and
// writes dx with a 16-byte store. HBM sees one read of x and g and one
// write of dx; index math is 32-bit, with the model's (7x7, 3/s2) and (4x4,
// 3/s1) fixed at compile time. Maps whose tile exceeds 48 KB of shared
// memory, and kernels above 16x16 (tap index past a byte), run the untiled
// gather kernel below, which computes the same function.
//
// Avg form (K6): the untiled gather kernel, one thread per input element
// summing g / count over its windows (no winner to find).

#include "pool_common.cuh"

namespace {

using namespace cap2det::pool;

template <typename T, bool kMax>
__global__ void pool_same_grad_untiled(const T* __restrict__ x,
                                       const T* __restrict__ g,
                                       T* __restrict__ dx, size_t total,
                                       int H, int W, int C, int OH, int OW,
                                       int k, int s, int pad_t, int pad_l) {
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

// Shared memory: the x tile [H*W][CT] and the g tile [OH*OW][CT] in T,
// then each window's winning tap index [OH*OW][CT] as a byte.
template <typename T, int VW, int LANES, class G>
__global__ void __launch_bounds__(kThreads)
    maxpool_grad_tiled(const T* __restrict__ x, const T* __restrict__ g,
                       T* __restrict__ dx, int C, int tiles, G geo) {
  constexpr int kCT = VW * LANES;
  using V = Vec<T, VW>;
  using Taps = Vec<unsigned char, VW>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = geo.H(), W = geo.W(), K = geo.K(), S = geo.S();
  const int OH = geo.OH(), OW = geo.OW(), PT = geo.PT(), PL = geo.PL();
  T* sx = reinterpret_cast<T*>(smem);
  T* sg = sx + H * W * kCT;
  unsigned char* swin = reinterpret_cast<unsigned char*>(sg + OH * OW * kCT);

  const int n = blockIdx.x / tiles;
  const int c0 = (blockIdx.x - n * tiles) * kCT;
  const int lanes = min(LANES, (C - c0) / VW);
  const size_t x_off = (size_t)n * H * W * C + c0;
  stage<T, VW, LANES>(sx, x + x_off, H * W, C, lanes);
  stage<T, VW, LANES>(sg, g + (size_t)n * OH * OW * C + c0, OH * OW, C,
                      lanes);
  cp_async_wait_all();
  __syncthreads();

  // Pass 1: each window's first maximal in-bounds tap, per channel.
  for (int i = threadIdx.x; i < OH * OW * LANES; i += kThreads) {
    const int lane = i % LANES;
    const int o = i / LANES;
    if (lane >= lanes) continue;
    const int oy = o / OW;
    const int y0 = oy * S - PT;
    const int x0 = (o - oy * OW) * S - PL;
    const int first = (max(y0, 0) - y0) * K + (max(x0, 0) - x0);
    float best[VW];
    Taps win;
#pragma unroll
    for (int c = 0; c < VW; ++c) {
      best[c] = -INFINITY;
      win.v[c] = (unsigned char)first;
    }
    for (int ky = 0; ky < K; ++ky) {
      const int yy = y0 + ky;
      if (yy < 0 || yy >= H) continue;
      for (int kx = 0; kx < K; ++kx) {
        const int xx = x0 + kx;
        if (xx < 0 || xx >= W) continue;
        const V v =
            *reinterpret_cast<const V*>(sx + (yy * W + xx) * kCT + lane * VW);
#pragma unroll
        for (int c = 0; c < VW; ++c) {
          const float f = to_f32(v.v[c]);
          if (f > best[c]) {
            best[c] = f;
            win.v[c] = (unsigned char)(ky * K + kx);
          }
        }
      }
    }
    *reinterpret_cast<Taps*>(swin + o * kCT + lane * VW) = win;
  }
  __syncthreads();

  // Pass 2: each input pixel gathers the windows it won, in descending
  // (oy, ox).
  T* dn = dx + x_off;
  for (int i = threadIdx.x; i < H * W * LANES; i += kThreads) {
    const int lane = i % LANES;
    const int p = i / LANES;
    if (lane >= lanes) continue;
    const int iy = p / W;
    const int ix = p - iy * W;
    int oy_lo, oy_hi, ox_lo, ox_hi;
    windows_of(iy, PT, K, S, OH, &oy_lo, &oy_hi);
    windows_of(ix, PL, K, S, OW, &ox_lo, &ox_hi);
    float acc[VW];
#pragma unroll
    for (int c = 0; c < VW; ++c) acc[c] = 0.0f;
    for (int oy = oy_hi; oy >= oy_lo; --oy) {
      const int ty = (iy - (oy * S - PT)) * K;
      for (int ox = ox_hi; ox >= ox_lo; --ox) {
        const int o = oy * OW + ox;
        const unsigned char tap = (unsigned char)(ty + ix - (ox * S - PL));
        const Taps win =
            *reinterpret_cast<const Taps*>(swin + o * kCT + lane * VW);
        const V gv =
            *reinterpret_cast<const V*>(sg + o * kCT + lane * VW);
#pragma unroll
        for (int c = 0; c < VW; ++c) {
          if (win.v[c] == tap) acc[c] = __fadd_rn(acc[c], to_f32(gv.v[c]));
        }
      }
    }
    V res;
#pragma unroll
    for (int c = 0; c < VW; ++c) res.v[c] = from_f32<T>(acc[c]);
    *reinterpret_cast<V*>(dn + p * C + lane * VW) = res;
  }
}

// Runs the tiled max-pool backward when it applies; false if not.
template <typename T>
bool try_tiled_max(const void* x, const void* g, void* dx, int N, int H,
                   int W, int C, int OH, int OW, int k, int s, int pad_t,
                   int pad_l, cudaStream_t st) {
  const void* ptrs[3] = {x, g, dx};
  const Tiling t = tiling_for<T>(C, ptrs, 3);
  const size_t smem = ((size_t)H * W + (size_t)OH * OW) * t.ct * sizeof(T) +
                      (size_t)OH * OW * t.ct;
  if (k > 16 || smem > kSmemBudget || (size_t)H * W * C >= (1u << 31) ||
      (size_t)N * t.tiles >= (1u << 31)) {
    return false;
  }
  const unsigned grid = (unsigned)N * (unsigned)t.tiles;
  dispatch(t.vector, H, W, k, s, OH, OW, pad_t, pad_l,
           [&](auto geo, auto vec) {
             constexpr bool kVec = decltype(vec)::value;
             constexpr int kVW = kVec ? (int)(16 / sizeof(T)) : 1;
             constexpr int kLanes = kVec ? kVecLanes : kScalarLanes;
             maxpool_grad_tiled<T, kVW, kLanes, decltype(geo)>
                 <<<grid, kThreads, smem, st>>>((const T*)x, (const T*)g,
                                                (T*)dx, C, t.tiles, geo);
           });
  return true;
}

template <typename T>
void launch(const void* x, const void* g, void* dx, int N, int H, int W,
            int C, int OH, int OW, int k, int s, int pad_t, int pad_l,
            int is_max, cudaStream_t st) {
  if (is_max && try_tiled_max<T>(x, g, dx, N, H, W, C, OH, OW, k, s, pad_t,
                                 pad_l, st)) {
    return;
  }
  const size_t total = (size_t)N * H * W * C;
  const int threads = 256;
  size_t blocks = (total + threads - 1) / threads;
  if (blocks > (1u << 20)) blocks = 1u << 20;
  if (is_max) {
    pool_same_grad_untiled<T, true><<<(unsigned)blocks, threads, 0, st>>>(
        (const T*)x, (const T*)g, (T*)dx, total, H, W, C, OH, OW, k, s,
        pad_t, pad_l);
  } else {
    pool_same_grad_untiled<T, false><<<(unsigned)blocks, threads, 0, st>>>(
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
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    launch<__nv_bfloat16>(x, g, dx, N, H, W, C, OH, OW, k, s, pad_t, pad_l,
                          is_max, st);
  } else {
    launch<float>(x, g, dx, N, H, W, C, OH, OW, k, s, pad_t, pad_l, is_max,
                  st);
  }
  return (int)cudaGetLastError();
}
