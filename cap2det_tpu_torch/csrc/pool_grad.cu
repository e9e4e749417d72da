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
// the number of in-bounds taps (IEEE division). Both accumulate in float32
// from 0 and store dx in x's dtype. Windows are added in descending
// (oy, ox), the order in which the tap-by-tap plain versions
// (kernels/pool_grad.py) add them, so the results equal theirs bit for bit;
// nothing is scattered, so there are no atomics and the result is
// deterministic.
//
// What bounds it on the H100: bytes. A max window is at most 9 compares,
// an avg window one division, and every input element lies in at most 9
// windows (4 at stride 2), far below the card's balance point; at
// [1000, 7, 7, 576] bf16 the compulsory traffic of the max form (x and dx
// 56 MB each, g 18 MB) is about 0.04 ms at 3.35 TB/s, and at
// [1000, 4, 4, 1024] the avg form moves 65.5 MB (g in, dx out), 0.0196 ms.
//
// A thread per input element that recomputes what it needs of every
// window containing it issues far more than the bytes need: for the max
// form up to 9 windows x 9 taps = 81 scalar loads per element at stride 1
// (4x slower than PyTorch's max_pool2d backward), for the avg form 2-byte
// loads and stores, 64-bit index division and one IEEE division per
// (window, element), 100 per ROI-channel at 4x4 where 16 windows need 16
// (19x its bound). So both forms are tiled: a block takes one ROI and one
// channel tile (pool_common.cuh), does each window's work once in pass 1
// and keeps its result in shared memory, and pass 2 gives each thread 8
// bf16 (4 float32) channels of one input pixel: it walks the windows
// containing the pixel in descending (oy, ox), adds their float32 terms
// and writes dx with a 16-byte store. HBM sees one read of each input and
// one write of dx; index math is 32-bit, with the model's (7x7, 3/s2) and
// (4x4, 3/s1) fixed at compile time.
//
// Max form (K5): x and g of the ROI are staged with 16-byte cp.async; pass
// 1 finds each window's winner (9 compares) and keeps its tap index as a
// byte; pass 2 adds g where the window's winner is this pixel.
//
// Avg form (K6): pass 1 reads each window's g once, 16 bytes a thread
// straight from HBM (each value is read by one thread, so staging it
// would buy nothing), and keeps g / count in float32 in shared memory
// (4 KB at 4x4 bf16); pass 2 adds those terms. A lane's floats lie in
// groups of four, group-major, so that the 8 lanes of a quarter warp read
// 128 contiguous bytes without bank conflicts.
//
// Which kernel runs is the host's choice (kernels/pool_grad._tiled, the
// rule tiled_fits below checks): maps whose tile exceeds 48 KB of shared
// memory, and max kernels above 16x16 (tap index past a byte), run the
// untiled gather kernel, one thread per input element, which computes the
// same function.

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

// Shared memory: g / count of each window [OH*OW][CT] in float32; a
// lane's VW floats lie in groups of kQ (at most four), group q of lane l
// at q * LANES * kQ + l * kQ.
template <typename T, int VW, int LANES, class G>
__global__ void __launch_bounds__(kThreads)
    avgpool_grad_tiled(const T* __restrict__ g, T* __restrict__ dx, int C,
                       int tiles, G geo) {
  constexpr int kCT = VW * LANES;
  constexpr int kQ = VW < 4 ? VW : 4;
  using V = Vec<T, VW>;
  using Q = Vec<float, kQ>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = geo.H(), W = geo.W(), K = geo.K(), S = geo.S();
  const int OH = geo.OH(), OW = geo.OW(), PT = geo.PT(), PL = geo.PL();
  float* sgt = reinterpret_cast<float*>(smem);

  const int n = blockIdx.x / tiles;
  const int c0 = (blockIdx.x - n * tiles) * kCT;
  const int lanes = min(LANES, (C - c0) / VW);

  // Pass 1: g / count, one IEEE division per window and channel.
  const T* gn = g + (size_t)n * OH * OW * C + c0;
  for (int i = threadIdx.x; i < OH * OW * LANES; i += kThreads) {
    const int lane = i % LANES;
    const int o = i / LANES;
    if (lane >= lanes) continue;
    const int oy = o / OW;
    const int y0 = oy * S - PT;
    const int x0 = (o - oy * OW) * S - PL;
    const float count = __fmul_rn((float)(min(y0 + K, H) - max(y0, 0)),
                                  (float)(min(x0 + K, W) - max(x0, 0)));
    const V gv = *reinterpret_cast<const V*>(gn + o * C + lane * VW);
#pragma unroll
    for (int q = 0; q < VW / kQ; ++q) {
      Q gt;
#pragma unroll
      for (int c = 0; c < kQ; ++c) {
        gt.v[c] = __fdiv_rn(to_f32(gv.v[q * kQ + c]), count);
      }
      *reinterpret_cast<Q*>(sgt + o * kCT + q * LANES * kQ + lane * kQ) = gt;
    }
  }
  __syncthreads();

  // Pass 2: each input pixel sums the terms of its windows in descending
  // (oy, ox).
  T* dn = dx + (size_t)n * H * W * C + c0;
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
      for (int ox = ox_hi; ox >= ox_lo; --ox) {
        const float* src = sgt + (oy * OW + ox) * kCT + lane * kQ;
#pragma unroll
        for (int q = 0; q < VW / kQ; ++q) {
          const Q t = *reinterpret_cast<const Q*>(src + q * LANES * kQ);
#pragma unroll
          for (int c = 0; c < kQ; ++c) {
            acc[q * kQ + c] = __fadd_rn(acc[q * kQ + c], t.v[c]);
          }
        }
      }
    }
    V res;
#pragma unroll
    for (int c = 0; c < VW; ++c) res.v[c] = from_f32<T>(acc[c]);
    *reinterpret_cast<V*>(dn + p * C + lane * VW) = res;
  }
}

// True when the tiled kernel of the form takes the launch under tiling t:
// its shared memory (max: the x and g tiles in T and a winner byte per
// window and channel; avg: g / count per window and channel in float32)
// fits kSmemBudget, a max kernel's tap index fits a byte, and the indices
// fit 32 bits. kernels/pool_grad._tiled is the same rule on the host.
template <typename T>
bool tiled_fits(const Tiling& t, int N, int H, int W, int C, int OH, int OW,
                int k, int is_max, size_t* smem) {
  const size_t windows = (size_t)OH * OW * t.ct;
  *smem = is_max ? ((size_t)H * W * t.ct + windows) * sizeof(T) + windows
                 : windows * sizeof(float);
  return !(is_max && k > 16) && *smem <= kSmemBudget &&
         (size_t)H * W * C < (1u << 31) && (size_t)N * t.tiles < (1u << 31);
}

template <typename T>
int launch_tiled(const void* x, const void* g, void* dx, int N, int H, int W,
                 int C, int OH, int OW, int k, int s, int pad_t, int pad_l,
                 int is_max, cudaStream_t st) {
  const void* ptrs[3] = {x, g, dx};
  const Tiling t = tiling_for<T>(C, ptrs, 3);
  size_t smem;
  if (!tiled_fits<T>(t, N, H, W, C, OH, OW, k, is_max, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned grid = (unsigned)N * (unsigned)t.tiles;
  dispatch(t.vector, H, W, k, s, OH, OW, pad_t, pad_l,
           [&](auto geo, auto vec) {
             constexpr bool kVec = decltype(vec)::value;
             constexpr int kVW = kVec ? (int)(16 / sizeof(T)) : 1;
             constexpr int kLanes = kVec ? kVecLanes : kScalarLanes;
             using G = decltype(geo);
             if (is_max) {
               maxpool_grad_tiled<T, kVW, kLanes, G>
                   <<<grid, kThreads, smem, st>>>((const T*)x, (const T*)g,
                                                  (T*)dx, C, t.tiles, geo);
             } else {
               avgpool_grad_tiled<T, kVW, kLanes, G>
                   <<<grid, kThreads, smem, st>>>((const T*)g, (T*)dx, C,
                                                  t.tiles, geo);
             }
           });
  return 0;
}

template <typename T>
int launch(const void* x, const void* g, void* dx, int N, int H, int W,
           int C, int OH, int OW, int k, int s, int pad_t, int pad_l,
           int is_max, int tiled, cudaStream_t st) {
  if (tiled) {
    return launch_tiled<T>(x, g, dx, N, H, W, C, OH, OW, k, s, pad_t, pad_l,
                           is_max, st);
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
  return 0;
}

}  // namespace

// x is read only by the max form (the avg form passes null). `tiled`
// selects the tiled kernel, which refuses (cudaErrorInvalidValue) a launch
// it cannot take, or the untiled one.
extern "C" int cap2det_pool_same_grad(const void* x, const void* g, void* dx,
                                      int N, int H, int W, int C, int OH,
                                      int OW, int k, int s, int pad_t,
                                      int pad_l, int is_max, int tiled,
                                      int is_bf16, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || k < 1 || s < 1 ||
      (is_max && x == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int rc =
      is_bf16 ? launch<__nv_bfloat16>(x, g, dx, N, H, W, C, OH, OW, k, s,
                                      pad_t, pad_l, is_max, tiled, st)
              : launch<float>(x, g, dx, N, H, W, C, OH, OW, k, s, pad_t,
                              pad_l, is_max, tiled, st);
  return rc ? rc : (int)cudaGetLastError();
}
