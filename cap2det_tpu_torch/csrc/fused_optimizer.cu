// Fused flat optimizer update, for Hopper (sm_90a).
//
// Replaces: cap2det_tpu/train/optimizers.py, `_fused_flat_transform`
// followed by `optax.apply_updates`, the JAX package's default update
// (build_optimizer(fused=None)). It is no Pallas kernel: on the TPU, XLA
// fuses the flat chain into a few kernels. In eager PyTorch the same
// chain is about ten small launches per trainable leaf; this is one
// launch over every leaf (two with per-leaf clipping).
//
// Function, per trainable leaf and element, in the plain version's order
// (kernels/fused_optimizer.py `fused_update_reference`, which runs the
// rule of train/optimizers.py `BaseRule.update` over one flat vector):
//   g  = grad [* multiplier, where it is not 1] [* clip factor]
//   u  = rule(g, slots) * -lr        (sgd, adagrad, adam, rmsprop with
//                                     centering and momentum, momentum
//                                     and nesterov; optax's formulas)
//   p += u                           (the float32 param, in place)
// The clip factor of a leaf is min(1, clip * (1 / max(|g|_2, 1e-12))),
// spelled as PyTorch evaluates `clip / t` (a reciprocal, then a product).
// Every operation is an IEEE-rounded intrinsic (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn), so nvcc cannot contract a product and a sum
// into one FMA the plain version does not have. The reciprocal square
// root is rsqrtf, as PyTorch's CUDA rsqrt computes it; adam's bias
// corrections divide by float32 tensors in the plain version, so here by
// __fdiv_rn. So the update equals the plain version on the card bit for
// bit, except under clipping, where the leaf's norm is a sum in another
// order (here in float64, per chunk, then the chunks in order; PyTorch's
// sum in float32 in its own tree) and the factor can differ in its last
// bits.
//
// What bounds it on the H100: bytes. Per parameter the update reads the
// gradient, the param and each slot once and writes the param and each
// slot once (Adagrad: 20 bytes; 148 MB for the coco17 trainable set of
// 7,417,427 parameters, 0.044 ms at 3.35 TB/s); a handful of flops per
// byte is far below the card's balance point.
//
// Design: a multi-tensor apply. The host cuts each leaf into chunks of
// at most kernels/fused_optimizer.CHUNK elements (no chunk crosses a
// leaf) and uploads that table (leaf, start, length) once per leaf set.
// Each launch passes, by value in the kernel's parameter struct (Args,
// 3160 bytes, under the 4 KB limit), every leaf's gradient and param
// pointers, its offset into the flat slot buffers (one float32 buffer
// per slot name), its multiplier and its gradient layout; a set of more
// than kMaxLeaves leaves is split into several launches. So no gradient
// is copied into a flat vector and nothing is uploaded per step. A block takes one chunk; each thread
// loads kUnroll elements of every stream before it computes, so that
// enough loads are in flight to cover HBM latency. A gradient may arrive
// channels-last ([O, C, H, W] stored as O, H, W, C, as cuDNN returns a
// 3x3 convolution's weight gradient): its elements are gathered in the
// param's order; the block's reads stay inside one filter, so L1 and L2
// serve the scattered ones.
// Clipping adds a first launch: a float64 sum of squares per chunk, in a
// fixed order (a per-thread sum, a warp tree, the warps in order), then
// the update's blocks add their leaf's chunk sums in chunk order. Both
// launches give the same bits in every run.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

namespace {

constexpr int kMaxLeaves = 64;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;

enum Kind : int { kSgd = 0, kAdagrad = 1, kAdam = 2, kRmsprop = 3,
                  kMomentum = 4 };

// Leaf::flags
constexpr int kGradChannelsLast = 1;
// Args::options
constexpr int kCentered = 1;
constexpr int kTrace = 2;  // rmsprop with momentum
constexpr int kNesterov = 4;

// One trainable leaf of a launch (kernels/fused_optimizer.py LEAF_DTYPE
// mirrors it; cap2det_fused_optimizer_layout reports the offsets).
struct Leaf {
  const float* g;
  float* p;
  long long slot_offset;  // into each flat slot buffer
  float multiplier;
  int flags;        // kGradChannelsLast
  int channels;     // C of a channels-last [O, C, H, W] gradient
  int spatial;      // H * W of it
  int first_chunk;  // the leaf's chunks are [first_chunk, + n_chunks)
  int n_chunks;
};

struct Args {
  Leaf leaf[kMaxLeaves];
  const int4* chunks;  // (leaf, start, length, 0) per block, device memory
  double* partials;    // a sum of squares per chunk (clipping only)
  float* slot[3];      // flat slot buffers, in the rule's slot order
  float neg_lr;
  float c[7];          // the rule's constants, as float32 (see below)
  float clip_norm;
  int options;         // kCentered | kTrace | kNesterov
  int clip;
  int n_chunks;
};

__device__ __forceinline__ float load_grad(const Leaf& L, int j) {
  int at = j;
  if (L.flags & kGradChannelsLast) {
    const int filter = L.channels * L.spatial;
    const int o = j / filter;
    const int r = j - o * filter;
    const int ci = r / L.spatial;
    const int s = r - ci * L.spatial;
    at = o * filter + s * L.channels + ci;
  }
  return L.g[at];
}

__device__ __forceinline__ float scaled_grad(const Leaf& L, int j) {
  const float g = load_grad(L, j);
  return L.multiplier != 1.0f ? __fmul_rn(g, L.multiplier) : g;
}

// Thread 0 gets the block's sum; the order is fixed.
__device__ double block_sum(double v) {
  __shared__ double warp_sums[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, o);
    }
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    chunk_sum_of_squares(const __grid_constant__ Args a) {
  const int4 ch = a.chunks[blockIdx.x];
  const Leaf L = a.leaf[ch.x];
  double acc = 0.0;
  for (int j = ch.y + threadIdx.x; j < ch.y + ch.z; j += kThreads) {
    const float g = scaled_grad(L, j);
    acc += (double)__fmul_rn(g, g);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) a.partials[blockIdx.x] = acc;
}

// The leaf's clip factor from its chunks' sums, on thread 0.
__device__ float clip_factor(const Args& a, const Leaf& L) {
  double sum = 0.0;
  for (int k = 0; k < L.n_chunks; ++k) sum += a.partials[L.first_chunk + k];
  const float norm = __fsqrt_rn(__double2float_rn(sum));
  const float t = norm < 1e-12f ? 1e-12f : norm;  // clamp_min(norm, 1e-12)
  const float f = __fmul_rn(__fdiv_rn(1.0f, t), a.clip_norm);
  return f > 1.0f ? 1.0f : f;  // clamp(max=1), NaN kept
}

// The rule on one element: updates the slots in v0..v2 and returns the
// step to add. Constants c (float32 of the Python values):
//   adagrad  c0 = 1e-7
//   adam     c0 = 1 - b1, c1 = b1, c2 = 1 - b2, c3 = b2,
//            c4 = 1 - b1^(count+1), c5 = 1 - b2^(count+1), c6 = eps
//   rmsprop  c0 = 1 - decay, c1 = decay, c2 = eps, c3 = momentum
//   momentum c0 = momentum
template <int KIND>
__device__ __forceinline__ float rule(const Args& a, float g, float& v0,
                                      float& v1, float& v2) {
  const float* c = a.c;
  float u;
  if (KIND == kSgd) {
    u = g;
  } else if (KIND == kAdagrad) {
    const float sos = __fadd_rn(__fmul_rn(g, g), v0);
    v0 = sos;
    const float scale = sos > 0.0f ? rsqrtf(__fadd_rn(sos, c[0])) : 0.0f;
    u = __fmul_rn(scale, g);
  } else if (KIND == kAdam) {
    const float mu = __fadd_rn(__fmul_rn(c[0], g), __fmul_rn(c[1], v0));
    const float nu = __fadd_rn(__fmul_rn(c[2], __fmul_rn(g, g)),
                               __fmul_rn(c[3], v1));
    v0 = mu;
    v1 = nu;
    const float mu_hat = __fdiv_rn(mu, c[4]);
    const float nu_hat = __fdiv_rn(nu, c[5]);
    u = __fdiv_rn(mu_hat, __fadd_rn(__fsqrt_rn(nu_hat), c[6]));
  } else if (KIND == kRmsprop) {
    const float nu = __fadd_rn(__fmul_rn(c[0], __fmul_rn(g, g)),
                               __fmul_rn(c[1], v0));
    v0 = nu;
    if (a.options & kCentered) {
      const float mu = __fadd_rn(__fmul_rn(c[0], g), __fmul_rn(c[1], v1));
      v1 = mu;
      u = __fmul_rn(g, rsqrtf(__fadd_rn(__fsub_rn(nu, __fmul_rn(mu, mu)),
                                        c[2])));
    } else {
      u = __fmul_rn(g, rsqrtf(__fadd_rn(nu, c[2])));
    }
    u = __fmul_rn(u, a.neg_lr);
    if (a.options & kTrace) {
      u = __fadd_rn(u, __fmul_rn(c[3], v2));
      v2 = u;
    }
    return u;
  } else {  // kMomentum
    const float trace = __fadd_rn(g, __fmul_rn(c[0], v0));
    v0 = trace;
    u = (a.options & kNesterov) ? __fadd_rn(g, __fmul_rn(c[0], trace))
                                : trace;
  }
  return __fmul_rn(u, a.neg_lr);
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
    fused_update(const __grid_constant__ Args a) {
  const int4 ch = a.chunks[blockIdx.x];
  const Leaf L = a.leaf[ch.x];
  float factor = 1.0f;
  if (a.clip) {
    __shared__ float s_factor;
    if (threadIdx.x == 0) s_factor = clip_factor(a, L);
    __syncthreads();
    factor = s_factor;
  }
  const int n_slots = KIND == kSgd ? 0
                      : KIND == kAdagrad || KIND == kMomentum ? 1
                      : KIND == kAdam ? 2 : 3;
  float* __restrict__ p = L.p;
  float* __restrict__ s0 = n_slots > 0 ? a.slot[0] + L.slot_offset : nullptr;
  float* __restrict__ s1 =
      n_slots > 1 && (KIND == kAdam || (a.options & kCentered))
          ? a.slot[1] + L.slot_offset : nullptr;
  float* __restrict__ s2 = n_slots > 2 && (a.options & kTrace)
                               ? a.slot[2] + L.slot_offset : nullptr;
  const int end = ch.y + ch.z;
  for (int base = ch.y + threadIdx.x; base < end;
       base += kThreads * kUnroll) {
    float g[kUnroll], pv[kUnroll], v0[kUnroll], v1[kUnroll], v2[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int j = base + k * kThreads;
      if (j < end) {
        g[k] = scaled_grad(L, j);
        pv[k] = p[j];
        v0[k] = s0 ? s0[j] : 0.0f;
        v1[k] = s1 ? s1[j] : 0.0f;
        v2[k] = s2 ? s2[j] : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int j = base + k * kThreads;
      if (j < end) {
        const float gk = a.clip ? __fmul_rn(g[k], factor) : g[k];
        const float u = rule<KIND>(a, gk, v0[k], v1[k], v2[k]);
        p[j] = __fadd_rn(pv[k], u);
        if (s0) s0[j] = v0[k];
        if (s1) s1[j] = v1[k];
        if (s2) s2[j] = v2[k];
      }
    }
  }
}

template <int KIND>
void launch_update(const Args& a, cudaStream_t st) {
  fused_update<KIND><<<a.n_chunks, kThreads, 0, st>>>(a);
}

}  // namespace

// Sizes and offsets of the parameter structs, for the host to check its
// mirror of them: sizeof(Leaf), sizeof(Args), kMaxLeaves, then the
// offsets in Leaf of g, p, slot_offset, multiplier, flags, channels,
// spatial, first_chunk, n_chunks, and in Args of chunks, partials, slot,
// neg_lr, c, clip_norm, options, clip, n_chunks.
extern "C" int cap2det_fused_optimizer_layout(long long* out, int n) {
  const size_t v[] = {
      sizeof(Leaf), sizeof(Args), (size_t)kMaxLeaves,
      offsetof(Leaf, g), offsetof(Leaf, p), offsetof(Leaf, slot_offset),
      offsetof(Leaf, multiplier), offsetof(Leaf, flags),
      offsetof(Leaf, channels), offsetof(Leaf, spatial),
      offsetof(Leaf, first_chunk), offsetof(Leaf, n_chunks),
      offsetof(Args, chunks), offsetof(Args, partials), offsetof(Args, slot),
      offsetof(Args, neg_lr), offsetof(Args, c), offsetof(Args, clip_norm),
      offsetof(Args, options), offsetof(Args, clip), offsetof(Args, n_chunks),
  };
  const int count = (int)(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < n && i < count; ++i) out[i] = (long long)v[i];
  return count;
}

// One update of a leaf group: `args` points to an Args on the host. With
// args->clip, the chunk sums launch first. Returns the launch's error.
extern "C" int cap2det_fused_optimizer(int kind, const void* args,
                                       void* stream) {
  Args a;
  memcpy(&a, args, sizeof(Args));
  if (a.n_chunks < 1 || kind < kSgd || kind > kMomentum) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (a.clip) {
    chunk_sum_of_squares<<<a.n_chunks, kThreads, 0, st>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  switch (kind) {
    case kSgd: launch_update<kSgd>(a, st); break;
    case kAdagrad: launch_update<kAdagrad>(a, st); break;
    case kAdam: launch_update<kAdam>(a, st); break;
    case kRmsprop: launch_update<kRmsprop>(a, st); break;
    default: launch_update<kMomentum>(a, st); break;
  }
  return (int)cudaGetLastError();
}
