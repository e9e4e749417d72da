// Frozen-BatchNorm fold of every convolution of a prepared tree, forward
// and backward, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The fold is the BN arithmetic of
// cap2det_tpu/models/inception_v2.py `_fold_bn` (a reciprocal square
// root, a product, the bias, the cast to the compute dtype), which XLA
// fuses into the TPU's step program. In eager PyTorch the port's fold was
// a chain of 7-8 small launches per convolution, about 520 a training
// step over InceptionV2's 69 convolutions, and 3 more per trainable
// convolution in the backward. This is one launch forward over every
// convolution (InceptionV2's 69, ResNet-101's 104) and one backward over
// the trainable ones.
//
// Function, per convolution (kernels/bn_fold.py `fold_reference` is the
// plain version):
//   inv[o]             = rsqrtf(var[o] + eps)
//   scale[o]           = gamma[o] * inv[o], or inv[o] without a gamma
//   weight[o, h, w, i] = out(w[o, i, h, w] * scale[o])    (channels-last)
//   bias[o]            = out(beta[o] - mean[o] * scale[o])
// and its gradient, for the convolutions whose leaves train:
//   dW[o, i, h, w]     = float(g_weight[o, i, h, w]) * scale[o]
//   dbeta[o]           = float(g_bias[o])
//   dgamma[o]          = (S[o] - float(g_bias[o]) * mean[o]) * inv[o]
// with S[o] the sum of float(g_weight) * w over the filter of o in (tap,
// input channel) order, taken by one warp: lane l adds elements l, l+32,
// ... in turn, then the lanes' sums are added pairwise (xor 16, 8, 4, 2,
// 1), the order kernels/bn_fold.py `channel_sum` writes out.
// `out` rounds to nearest even into bfloat16 (__float2bfloat16_rn, as
// c10::BFloat16 converts on the card) or keeps float32. Every operation
// is an IEEE-rounded intrinsic (__fadd_rn, __fmul_rn, __fsub_rn), so
// nvcc contracts no product and sum into an FMA the plain version lacks;
// the reciprocal square root is rsqrtf, as PyTorch's CUDA rsqrt computes
// it. So both kernels equal the plain version on the card bit for bit.
//
// What bounds it on the H100: bytes. Forward: each float32 weight read
// once and written once in bfloat16, 6 bytes a weight: InceptionV2's
// 10.14 M weights over both stages, ~61 MB, 0.018 ms at 3.35 TB/s;
// ResNet-101's 42.4 M, ~254 MB, 0.076 ms. Backward: a bfloat16 gradient
// read and a float32 one written, 6 bytes a trainable weight:
// coco17_extend_match's 7.0 M, ~42 MB, 0.0125 ms; voc07_inc2's 5.9 M,
// ~35 MB, 0.0106 ms; for a trainable gamma its float32 weights read too,
// 4 bytes more: coco17_resnet101's 41.4 M, ~414 MB, 0.124 ms. The BN
// vectors add under 0.1%.
//
// Design: a multi-tensor apply, as csrc/fused_optimizer.cu. The host cuts
// each convolution's weight and bias into chunks (no chunk crosses a
// convolution; gamma's gradient in chunks of 64 output channels) and
// uploads that table, with each convolution's shape, weight strides and
// offsets into the buffers, once per tree structure
// (kernels/bn_fold.FoldPlan). Each launch passes every convolution's
// input pointers by value in its parameter struct (FoldArgs 5,160 bytes,
// GradArgs 4,648: above the 4 KB that CUDA before 12.1 allowed, within
// the 32,764 bytes of 12.1 and later) with the step's fresh output
// buffer, so nothing is uploaded per step and nothing keyed on an address
// is kept. A block takes one chunk; a thread takes eight consecutive
// outputs: it gathers their inputs, a channels-last weight being a
// transpose inside one filter of the OIHW one (L1 and L2 serve the
// scattered reads of a filter), then writes the eight with 16-byte stores.
// Where input and output orders agree (1x1 weights, contiguous or 1x1
// gradients) it reads with 16-byte loads too. In a gamma chunk each warp
// takes one output channel at a time and reads its filter in gradient
// order, 32 lanes on neighbouring elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxConvs = 128;
constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kVec = 8;

enum Kind : int { kWeight = 0, kBias = 1, kGamma = 2 };
enum Dtype : int { kBf16 = 0, kF32 = 1 };
// GradArgs::flags
constexpr int kGradChannelsLast = 1;

// One convolution (kernels/bn_fold.py CONV_DTYPE mirrors it;
// cap2det_bn_fold_layout reports the offsets).
struct Conv {
  int out_channels;
  int in_channels;
  int taps;                // kh * kw
  int pad;
  long long w_stride_o;    // the float32 weight's strides in elements;
  long long w_stride_i;    // its taps are packed (kh, kw strides kw, 1)
  long long out_w;         // element offsets into the output buffer
  long long out_b;
  long long scale;         // into the scale buffer
  long long inv;           // into the scale buffer (-1: no gamma)
  long long grad_w;        // into the gradient buffer (-1: none)
  long long grad_b;
  long long grad_g;
};

struct FoldArgs {
  const float* w[kMaxConvs];
  const float* beta[kMaxConvs];
  const float* mean[kMaxConvs];
  const float* var[kMaxConvs];
  const float* gamma[kMaxConvs];  // or null: no gamma
  const Conv* convs;   // device memory
  const int4* chunks;  // (conv, start, length, kind) per block
  void* out;           // bfloat16 or float32
  float* scale;        // each convolution's scale and inv, for the
                       // backward; or null
  float eps;
  int n_chunks;
};

struct GradArgs {
  const void* gw[kMaxConvs];  // the weights' gradients (the output dtype)
  const void* gb[kMaxConvs];  // the biases' gradients, or null
  const float* w[kMaxConvs];  // the weights, for gamma's gradient
  const float* mean[kMaxConvs];
  int flags[kMaxConvs];       // kGradChannelsLast
  const Conv* convs;
  const int4* chunks;
  const float* scale;
  float* out;
  int n_chunks;
};

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

__device__ __forceinline__ unsigned pack2(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

// Eight values to 16-byte aligned memory.
__device__ __forceinline__ void put8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  u.x = pack2(v[0], v[1]);
  u.y = pack2(v[2], v[3]);
  u.z = pack2(v[4], v[5]);
  u.w = pack2(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void put8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Eight values from 16-byte aligned memory.
__device__ __forceinline__ void get8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void get8(const float* p, float* v) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Writes `n` (< kVec) values, or all kVec with one aligned store.
template <typename T>
__device__ __forceinline__ void store(T* p, const float* v, int n) {
  if (n == kVec) {
    put8(p, v);
    return;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (k < n) put(p + k, v[k]);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    fold_kernel(const __grid_constant__ FoldArgs a) {
  const int4 ch = a.chunks[blockIdx.x];
  const Conv c = a.convs[ch.x];
  const float* __restrict__ var = a.var[ch.x];
  const float* __restrict__ gamma = a.gamma[ch.x];
  OutT* __restrict__ out = static_cast<OutT*>(a.out);
  const int end = ch.y + ch.z;
  if (ch.w == kBias) {
    const float* __restrict__ beta = a.beta[ch.x];
    const float* __restrict__ mean = a.mean[ch.x];
    for (int o = ch.y + threadIdx.x; o < end; o += kThreads) {
      const float inv = rsqrtf(__fadd_rn(var[o], a.eps));
      const float scale = gamma ? __fmul_rn(gamma[o], inv) : inv;
      put(out + c.out_b + o, __fsub_rn(beta[o], __fmul_rn(mean[o], scale)));
      if (a.scale) {
        a.scale[c.scale + o] = scale;
        if (c.inv >= 0) a.scale[c.inv + o] = inv;
      }
    }
    return;
  }
  const float* __restrict__ w = a.w[ch.x];
  const int cin = c.in_channels;
  const int taps = c.taps;
  const int filter = cin * taps;
  const bool dense = taps == 1 && c.w_stride_i == 1 && c.w_stride_o == cin;
  for (int j0 = ch.y + threadIdx.x * kVec; j0 < end;
       j0 += kThreads * kVec) {
    // j0 in the output's (o, tap, i) order.
    const int n = end - j0 < kVec ? end - j0 : kVec;
    int o = j0 / filter;
    const int r = j0 - o * filter;
    int s = r / cin;
    int ci = r - s * cin;
    float v[kVec];
    int ok[kVec];
    const bool vec = dense && n == kVec && aligned16(w + j0);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      ok[k] = o;
      if (!vec && k < n) {
        v[k] = w[o * c.w_stride_o + ci * c.w_stride_i + s];
      }
      if (++ci == cin) {
        ci = 0;
        if (++s == taps) {
          s = 0;
          ++o;
        }
      }
    }
    if (vec) get8(w + j0, v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (k < n) {
        const float inv = rsqrtf(__fadd_rn(var[ok[k]], a.eps));
        v[k] = __fmul_rn(v[k], gamma ? __fmul_rn(gamma[ok[k]], inv) : inv);
      }
    }
    store(out + c.out_w + j0, v, n);
  }
}

template <typename GradT>
__global__ void __launch_bounds__(kThreads)
    fold_grad_kernel(const __grid_constant__ GradArgs a) {
  const int4 ch = a.chunks[blockIdx.x];
  const Conv c = a.convs[ch.x];
  float* __restrict__ out = a.out;
  const int end = ch.y + ch.z;
  if (ch.w == kBias) {
    const GradT* __restrict__ g = static_cast<const GradT*>(a.gb[ch.x]);
    for (int o = ch.y + threadIdx.x; o < end; o += kThreads) {
      out[c.grad_b + o] = to_float(g[o]);
    }
    return;
  }
  const GradT* __restrict__ g = static_cast<const GradT*>(a.gw[ch.x]);
  const int cin = c.in_channels;
  const int taps = c.taps;
  const int filter = cin * taps;
  if (ch.w == kGamma) {
    // One warp an output channel: S over its filter in (tap, input
    // channel) order, lane l taking elements l, l + 32, ...
    const bool channels_last =
        (a.flags[ch.x] & kGradChannelsLast) || taps == 1;
    const float* __restrict__ w = a.w[ch.x];
    const GradT* __restrict__ gb = static_cast<const GradT*>(a.gb[ch.x]);
    const int lane = threadIdx.x % kWarp;
    for (int o = ch.y + threadIdx.x / kWarp; o < end;
         o += kThreads / kWarp) {
      float acc = 0.0f;
      for (int j = lane; j < filter; j += kWarp) {
        const int s = j / cin;
        const int ci = j - s * cin;
        const float gv = to_float(
            g[o * filter + (channels_last ? j : ci * taps + s)]);
        acc = __fadd_rn(
            acc, __fmul_rn(gv, w[o * c.w_stride_o + ci * c.w_stride_i + s]));
      }
#pragma unroll
      for (int off = kWarp / 2; off > 0; off /= 2) {
        acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
      }
      if (lane == 0) {
        if (gb) acc = __fsub_rn(acc, __fmul_rn(to_float(gb[o]), a.mean[ch.x][o]));
        out[c.grad_g + o] = __fmul_rn(acc, a.scale[c.inv + o]);
      }
    }
    return;
  }
  const float* __restrict__ inv = a.scale + c.scale;
  // A 1x1 gradient is the same in both layouts.
  const bool gather = (a.flags[ch.x] & kGradChannelsLast) && taps > 1;
  for (int j0 = ch.y + threadIdx.x * kVec; j0 < end;
       j0 += kThreads * kVec) {
    // j0 in the leaf's (o, i, tap) order.
    const int n = end - j0 < kVec ? end - j0 : kVec;
    int o = j0 / filter;
    const int r = j0 - o * filter;
    int ci = r / taps;
    int s = r - ci * taps;
    float v[kVec];
    int ok[kVec];
    const bool vec = !gather && n == kVec && aligned16(g + j0);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      ok[k] = o;
      if (!vec && k < n) {
        v[k] = to_float(g[gather ? o * filter + s * cin + ci : j0 + k]);
      }
      if (++s == taps) {
        s = 0;
        if (++ci == cin) {
          ci = 0;
          ++o;
        }
      }
    }
    if (vec) get8(g + j0, v);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (k < n) v[k] = __fmul_rn(v[k], inv[ok[k]]);
    }
    store(out + c.grad_w + j0, v, n);
  }
}

}  // namespace

// Sizes and offsets of the parameter structs, for the host to check its
// mirror of them: sizeof(Conv), sizeof(FoldArgs), sizeof(GradArgs),
// kMaxConvs, kVec, then the offsets in Conv of out_channels, in_channels,
// taps, w_stride_o, w_stride_i, out_w, out_b, scale, inv, grad_w, grad_b,
// grad_g; in FoldArgs of w, beta, mean, var, gamma, convs, chunks, out,
// scale, eps, n_chunks; in GradArgs of gw, gb, w, mean, flags, convs,
// chunks, scale, out, n_chunks.
extern "C" int cap2det_bn_fold_layout(long long* out, int n) {
  const size_t v[] = {
      sizeof(Conv), sizeof(FoldArgs), sizeof(GradArgs), (size_t)kMaxConvs,
      (size_t)kVec,
      offsetof(Conv, out_channels), offsetof(Conv, in_channels),
      offsetof(Conv, taps), offsetof(Conv, w_stride_o),
      offsetof(Conv, w_stride_i), offsetof(Conv, out_w),
      offsetof(Conv, out_b), offsetof(Conv, scale), offsetof(Conv, inv),
      offsetof(Conv, grad_w), offsetof(Conv, grad_b), offsetof(Conv, grad_g),
      offsetof(FoldArgs, w), offsetof(FoldArgs, beta),
      offsetof(FoldArgs, mean), offsetof(FoldArgs, var),
      offsetof(FoldArgs, gamma), offsetof(FoldArgs, convs),
      offsetof(FoldArgs, chunks), offsetof(FoldArgs, out),
      offsetof(FoldArgs, scale), offsetof(FoldArgs, eps),
      offsetof(FoldArgs, n_chunks),
      offsetof(GradArgs, gw), offsetof(GradArgs, gb), offsetof(GradArgs, w),
      offsetof(GradArgs, mean), offsetof(GradArgs, flags),
      offsetof(GradArgs, convs), offsetof(GradArgs, chunks),
      offsetof(GradArgs, scale), offsetof(GradArgs, out),
      offsetof(GradArgs, n_chunks),
  };
  const int count = (int)(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < n && i < count; ++i) out[i] = (long long)v[i];
  return count;
}

// The fold: `args` points to a FoldArgs on the host; `dtype` is the
// output's (kBf16 or kF32). Returns the launch's error.
extern "C" int cap2det_bn_fold(int dtype, const void* args, void* stream) {
  FoldArgs a;
  memcpy(&a, args, sizeof(FoldArgs));
  if (a.n_chunks < 1 || (dtype != kBf16 && dtype != kF32)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kBf16) {
    fold_kernel<__nv_bfloat16><<<a.n_chunks, kThreads, 0, st>>>(a);
  } else {
    fold_kernel<float><<<a.n_chunks, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// The fold's gradient: `args` points to a GradArgs on the host; `dtype` is
// the incoming gradients' (the fold's output dtype).
extern "C" int cap2det_bn_fold_grad(int dtype, const void* args,
                                    void* stream) {
  GradArgs a;
  memcpy(&a, args, sizeof(GradArgs));
  if (a.n_chunks < 1 || (dtype != kBf16 && dtype != kF32)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == kBf16) {
    fold_grad_kernel<__nv_bfloat16><<<a.n_chunks, kThreads, 0, st>>>(a);
  } else {
    fold_grad_kernel<float><<<a.n_chunks, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}
