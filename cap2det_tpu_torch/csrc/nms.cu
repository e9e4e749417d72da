// Greedy class-wise non-max suppression, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. cap2det_tpu/ops/nms.py `_per_image_nms`
// runs the greedy pass as one `lax.fori_loop` over the P ranks, with all
// classes at once, inside the postprocess that cap2det_tpu/eval/
// evaluator.py jits into one TPU program. Eager PyTorch ran the same loop
// from Python, a few small launches per rank. This is that loop as two
// kernels per batch_multiclass_nms call, for every image and class.
//
// Function (cap2det_tpu_torch/ops/nms.py `_per_image_nms`, the plain
// version and oracle), per image and class: the ranks are the class's
// stable descending score order (given, from torch.argsort); a rank is a
// candidate when its score > score_thresh (strict, float32); walking the
// ranks in order, a candidate still kept clears every later rank whose
// IoU with it is > iou_thresh (float32); the first max_per_class
// survivors are kept. The output is the [B, P, C] bool mask of survivors.
// The IoU is cap2det_tpu_torch/ops/boxes.py `pairwise_iou` to the bit:
//   ih = max(min(ymax1, ymax2) - max(ymin1, ymin2), 0), iw the same,
//   inter = ih * iw, a = max(ymax - ymin, 0) * max(xmax - xmin, 0),
//   union = (a1 + a2) - inter,
//   iou = union > 0 ? inter / max(union, 1e-12) : 0,
// each step an IEEE-rounded intrinsic, so nvcc cannot contract a product
// and a sum into an FMA the plain version does not have. The clamps at 0
// keep a NaN as PyTorch's clamp_min does; a NaN coordinate then makes the
// union NaN and the pair not overlap, as in the plain version, so fminf
// and fmaxf (which drop a NaN) are safe in the intersection. The rounded
// division and its comparison are decided exactly without dividing
// (Threshold): an IEEE division is a call with a slow path, which kept
// the compiler from overlapping independent IoUs.
//
// Two early exits, both exact:
// - Candidates form a prefix of the order: the order is non-increasing
//   in score, `score > score_thresh` is monotone in the score, and a NaN
//   score sorts last and is no candidate. So the walk ends at the first
//   non-candidate; no later rank is kept or can suppress.
// - Suppression reaches only later ranks, and the cap keeps the first
//   max_per_class survivors in rank order. So once the survivor numbered
//   max_per_class is found, every later rank is capped off whatever the
//   walk would do to it, and the walk ends there.
//
// What bounds it on the H100: neither bytes nor operations. The inputs
// are small (at P=2000 and C=20: 32 KB of boxes, 160 KB of scores, 320
// KB of order, 40 KB of mask out; 0.16 us at 3.35 TB/s), and a class
// needs at most (max_per_class - 1) x P IoUs of 25 operations. The walk
// is a chain of dependent steps: each survivor must finish clearing later
// ranks before the next survivor is known. The design takes the IoUs off
// that chain (the mask kernel computes all P^2 of them at once, across
// the card) and leaves on it shared-memory work per 32 ranks walked.
//
// Design, two kernels a call:
// 1. overlap_bits, over the whole card. An IoU does not depend on the
//    class, only the walk order does, so the call's overlap mask is built
//    once for all classes, [B, P, row_words(P)] uint32: bit j % 32 of
//    word j / 32 of row i is overlaps(box i, box j), and the words past
//    ceil(P / 32) that pad a row to 16 bytes are 0, as are the bits of
//    columns at or past P. The mask is symmetric (the IoU as spelled
//    is), so a warp tests each pair of 32-box tiles (I, J >= I) once,
//    every IoU independent of the others, and writes both tiles' words:
//    the ballots give the rows of tile I, and each lane gathers its own
//    row of tile J. No shared memory, no block barrier. The mask is
//    scratch the wrapper allocates (about B P^2 / 8 bytes).
// 2. greedy_walk, a block per (image, class) of a walker warp and
//    kProducers producer warps, and no block barrier after their set-up.
//    The walker keeps the class's "removed" bits over box indices
//    (ceil(P / 32) words) in shared memory and walks the ranks 32 at a
//    time, a lane a rank, its order and scores loaded a group ahead. The
//    producers read the order too and, taking the groups in turn, copy
//    each group's 32 mask rows (its boxes' rows) into a ring of
//    stages_for(row) buffers in shared memory with 16-byte loads, then
//    arrive on the buffer's "full" mbarrier; a producer reuses a buffer once the walker
//    arrives on its "empty" mbarrier, and stops when the walker is done.
//    (One bulk copy a row from the Tensor Memory Accelerator was tried:
//    issuing a group's 32 took longer than the walker's work on it.)
//    When two or more of the group's ranks are neither non-candidates
//    nor removed, the walker's lanes read, from their own boxes' rows,
//    the bits of the group's 32 boxes (the group's 32 x 32 overlaps, in
//    registers) and, lane by lane in rank order, a survivor drops the
//    later lanes its box overlaps: a fixed run of 31 steps whose
//    shuffles do not wait on each other. The cap keeps the first
//    survivors. The walker ORs the group's survivors' staged rows into
//    the removed words. No IoU and no load from device memory is left on
//    the walker's chain: only shared memory, registers, and a wait for
//    rows the producers copied while it walked earlier groups. ORing
//    whole rows marks earlier ranks' boxes too, which is harmless: their
//    fate is already written. The walker clears its class's mask column
//    before it walks, and each survivor's lane sets its entry.
//    Shared memory holds a row of removed words and at least kMinStages x
//    32 rows at stage_stride, so P is limited by the 227 KB a block may
//    opt in to (kMaxProposals, mirrored by kernels/nms.py MAX_PROPOSALS);
//    the C
//    entries refuse a larger P. A wait that outlasts any walk by far
//    traps (a launch error) rather than hangs the card.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kBitsWarps = 8;  // tile pairs a block of overlap_bits tests
// Buffers of 32 mask rows a greedy_walk block stages: the group walked
// and the next ones, as many as fit (stages_for), from kMinStages to
// kMaxStages, copied by kProducers warps (taking the groups in turn)
// with kCopyLoads 16-byte loads a lane in flight.
constexpr int kMinStages = 3;
constexpr int kMaxStages = 6;
constexpr int kProducers = 4;
constexpr int kCopyLoads = 16;
// Dynamic shared memory a block may take: the H100's 227 KB less a
// reserve for the static shared memory (kernels/nms.py mirrors these).
constexpr size_t kSmemLimit = 227 * 1024;
constexpr size_t kSmemReserve = 1024;
constexpr int kSmemWords =
    (int)((kSmemLimit - kSmemReserve) / sizeof(unsigned));
// The walk's words: a row's worth of removed words and kMinStages x 32
// rows at a stride of at most 4 words more than a row (stage_stride), so
// a row may hold kMaxWords words, a multiple of 4.
constexpr int kMaxWords =
    (kSmemWords - kMinStages * 32 * 4) / (1 + kMinStages * 32) / 4 * 4;
constexpr int kMaxProposals = 32 * kMaxWords;
// overlap_bits takes the image from gridDim.z.
constexpr int kMaxImages = 65535;
constexpr unsigned kFull = 0xffffffffu;

// Words of a mask row: ceil(P / 32) words of bits, then zero words to a
// multiple of 4 (16 bytes, the unit of the producers' copies).
__host__ __device__ constexpr int row_words(int P) {
  return ((P + 31) / 32 + 3) / 4 * 4;
}

// Row stride of a staged group: 16-byte aligned, and an odd number of
// 16-byte units, so the 32 lanes reading one word of their own rows
// spread over all 8 bank quads (4-way, the least a 16-byte stride gives).
__host__ __device__ constexpr int stage_stride(int row) {
  return (row / 4) % 2 ? row : row + 4;
}

// Staged groups at a row of `row` words: as many as fit, at most
// kMaxStages (at least kMinStages for a row of at most kMaxWords).
__host__ __device__ constexpr int stages_for(int row) {
  return (kSmemWords - row) / (32 * stage_stride(row)) < kMaxStages
             ? (kSmemWords - row) / (32 * stage_stride(row))
             : kMaxStages;
}

// max(x, 0) that keeps a NaN, as torch.clamp_min does.
__device__ __forceinline__ float clamp0(float x) {
  return x < 0.0f ? 0.0f : x;
}

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(clamp0(__fsub_rn(b.z, b.x)), clamp0(__fsub_rn(b.w, b.y)));
}

// The comparison `iou > t` of a correctly rounded iou = inter / u with u
// > 0, without the division: RN(q) > t exactly when the real q exceeds
// the midpoint m of t and the next float up, or equals it and that float
// is even (ties go to even). inter and m * u are exact in double (m has
// 25 significant bits, u 24), so `inter > m * u` is exact too.
struct Threshold {
  double mid;
  bool tie_up;     // m rounds up to the next float
  bool zero_above; // 0 > t: an iou of 0 (union <= 0, or NaN) overlaps
};

__device__ __forceinline__ Threshold threshold(float t) {
  const float up = nextafterf(t, __int_as_float(0x7f800000));
  return {((double)t + (double)up) * 0.5, (__float_as_uint(up) & 1u) == 0u,
          0.0f > t};
}

// pairwise_iou(a, b) > t, boxes as (ymin, xmin, ymax, xmax).
__device__ __forceinline__ bool overlaps(float4 a, float4 b, Threshold t) {
  const float ih = clamp0(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)));
  const float iw = clamp0(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)));
  const float inter = __fmul_rn(ih, iw);
  const float uni = __fsub_rn(__fadd_rn(area(a), area(b)), inter);
  const double lhs = inter;
  const double rhs = t.mid * (double)fmaxf(uni, 1e-12f);
  return uni > 0.0f ? lhs > rhs || (lhs == rhs && t.tie_up) : t.zero_above;
}

// Box j of an image, read a float at a time (a contiguous tensor's data
// need not start on a 16-byte boundary).
__device__ __forceinline__ float4 load_box(const float* bx, int j) {
  const float* p = bx + (size_t)j * 4;
  return make_float4(p[0], p[1], p[2], p[3]);
}

// A warp a tile pair (I, J >= I) of 32 x 32 boxes: lane l holds row box
// 32 I + l and column box 32 J + l. Step r tests row box r (a shuffle)
// against every lane's column box: the ballot is row 32 I + r's word J,
// and bit r of lane l's word is row 32 J + l's word I (the IoU as spelled
// is symmetric: fminf, fmaxf and __fadd_rn commute, and a signed zero
// changes no comparison). So every pair is tested once.
__global__ void __launch_bounds__(kBitsWarps * 32)
    overlap_bits(const float* __restrict__ boxes,
                 unsigned* __restrict__ bits, int P, int row,
                 float iou_thresh) {
  const int lane = threadIdx.x & 31;
  const int W = (P + 31) / 32;
  const int I = blockIdx.y;
  const int J = I + blockIdx.x * kBitsWarps + (threadIdx.x >> 5);
  if (J >= W) return;  // the whole warp; no barrier follows
  const size_t b = blockIdx.z;
  const float* bx = boxes + b * P * 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int i = I * 32 + lane;
  const int j = J * 32 + lane;
  const float4 row_box = i < P ? load_box(bx, i) : zero;
  const float4 col_box = j < P ? load_box(bx, j) : zero;
  const Threshold t = threshold(iou_thresh);
  unsigned row_word = 0u;
  unsigned col_word = 0u;
#pragma unroll 8
  for (int r = 0; r < 32; ++r) {
    const float4 a = make_float4(
        __shfl_sync(kFull, row_box.x, r), __shfl_sync(kFull, row_box.y, r),
        __shfl_sync(kFull, row_box.z, r), __shfl_sync(kFull, row_box.w, r));
    const bool o =
        I * 32 + r < P && j < P && overlaps(a, col_box, t);
    const unsigned word = __ballot_sync(kFull, o);
    if (lane == r) row_word = word;
    col_word |= (unsigned)o << r;
  }
  unsigned* out = bits + b * P * row;
  if (i < P) out[(size_t)i * row + J] = row_word;
  if (J != I && j < P) out[(size_t)j * row + I] = col_word;
  if (J == I && i < P) {
    for (int w = W; w < row; ++w) out[(size_t)i * row + w] = 0u;  // pad
  }
}

__device__ __forceinline__ bool removed_bit(const unsigned* removed, int i) {
  return (removed[i >> 5] >> (i & 31)) & 1u;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Whether the mbarrier's phase of this parity has completed.
__device__ __forceinline__ bool bar_done(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done;
}

// Traps (a launch error) once a wait has outlasted any walk by far,
// about a second of the SM's clock, rather than hang the card.
__device__ __forceinline__ void trap_after(long long start) {
  if (clock64() - start > (1LL << 31)) __trap();
}

// Waits until the mbarrier's phase of this parity has completed.
__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  for (const long long start = clock64(); !bar_done(bar, parity);) {
    trap_after(start);
  }
}

// Arrives on the mbarrier, releasing this thread's earlier writes.
__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// A producer warp: copies the mask rows of every producers-th group's 32
// boxes (from the order) into the ring of `stages` buffers, 16 bytes a
// lane a load with kCopyLoads loads in flight, once the walker has freed
// the buffer, and arrives on its "full" mbarrier; until the groups run
// out or the walker is done. Nothing is left in flight when it returns.
__device__ __forceinline__ void stage_groups(
    const long long* ord, const unsigned* rows, int P, int row, int stride,
    int stages, unsigned* stage_words, unsigned long long* full,
    unsigned long long* empty, volatile int* walked, int first, int lane) {
  const int quads = row / 4;  // 16-byte pieces of a row
  const int total = 32 * quads;
  // A parity wait tells only the newest two phases apart: with no more
  // producers than buffers, none waits for a buffer two phases ahead.
  const int producers = kProducers < stages ? kProducers : stages;
  if (first >= producers) return;
  int box = 32 * first + lane < P ? (int)ord[32 * first + lane] : 0;
  for (int g = first; 32 * g < P; g += producers) {
    const int s = g % stages;
    // This producer's next group's boxes, ahead of the wait.
    const int next = 32 * (g + producers) + lane;
    const int next_box = next < P ? (int)ord[next] : 0;
    // Lane 0 decides for the warp: stop once the walker is done; else,
    // from the stages-th group on, wait until the walker's group
    // g - stages freed the buffer.
    int stop = 0;
    if (lane == 0) {
      for (const long long start = clock64();
           !(stop = *walked) && g >= stages &&
           !bar_done(&empty[s], (g / stages - 1) & 1);) {
        trap_after(start);
      }
    }
    if (__shfl_sync(kFull, stop, 0)) return;
    __syncwarp();  // every lane's copies after lane 0's wait
    uint4* stage = reinterpret_cast<uint4*>(stage_words + s * 32 * stride);
    for (int c0 = 0; c0 < total; c0 += 32 * kCopyLoads) {
      uint4 v[kCopyLoads];
#pragma unroll
      for (int u = 0; u < kCopyLoads; ++u) {
        const int c = min(c0 + u * 32 + lane, total - 1);
        const int k = c / quads;
        const int src = __shfl_sync(kFull, box, k);
        v[u] = __ldg(reinterpret_cast<const uint4*>(rows + (size_t)src * row) +
                     c - k * quads);
      }
#pragma unroll
      for (int u = 0; u < kCopyLoads; ++u) {
        const int c = c0 + u * 32 + lane;
        const int k = c / quads;
        if (c < total) stage[(k * stride) / 4 + c - k * quads] = v[u];
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&full[s]);  // after every lane's copies
    box = next_box;
  }
}

// 1 + kProducers warps a block: the walker (warp 0) walks one (image,
// class); the producers stage its groups' mask rows ahead of it.
__global__ void __launch_bounds__(32 * (1 + kProducers))
    greedy_walk(const float* __restrict__ scores,
                const long long* __restrict__ order,
                const unsigned* __restrict__ bits, bool* __restrict__ keep,
                int C, int P, float score_thresh, int max_per_class) {
  extern __shared__ __align__(16) unsigned smem_words[];
  __shared__ unsigned long long full[kMaxStages];
  __shared__ unsigned long long empty[kMaxStages];
  __shared__ int walked;
  const int lane = threadIdx.x & 31;
  const int c = (int)(blockIdx.x % C);
  const size_t b = blockIdx.x / C;
  const int W = (P + 31) / 32;
  const int row = row_words(P);
  const int stride = stage_stride(row);
  const int stages = stages_for(row);
  unsigned* removed = smem_words;
  unsigned* stage_words = smem_words + row;
  const long long* ord = order + (size_t)blockIdx.x * P;
  const unsigned* rows = bits + b * P * row;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      bar_init(&full[s]);
      bar_init(&empty[s]);
    }
    walked = max_per_class <= 0;
  }
  // The block's one barrier: the mbarriers and the flag are set up.
  __syncthreads();
  if (threadIdx.x >= 32) {
    stage_groups(ord, rows, P, row, stride, stages, stage_words, full,
                 empty, &walked, threadIdx.x / 32 - 1, lane);
    return;
  }

  const float* sc = scores + b * P * C + c;
  bool* out = keep + b * P * C + c;
  for (int w = lane; w < W; w += 32) removed[w] = 0u;
  for (int i = lane; i < P; i += 32) out[(size_t)i * C] = false;
  // Orders the clearing stores before the survivors' stores below, which
  // other lanes may make to the same entries.
  __syncwarp();
  if (max_per_class <= 0) return;

  // Each lane's rank of the group: its box and its score; the next
  // group's box and score, and the order of the one after, come a group
  // ahead. The rows come from the producer.
  int box = lane < P ? (int)ord[lane] : 0;
  float score = lane < P ? __ldg(sc + (size_t)box * C) : 0.0f;
  int next_box = 32 + lane < P ? (int)ord[32 + lane] : 0;
  int kept = 0;
  for (int g = 0;; ++g) {
    const int base = g * 32;
    const bool more = base + 32 < P;  // the same for the whole warp
    const float next_score =
        base + 32 + lane < P ? __ldg(sc + (size_t)next_box * C) : 0.0f;
    const int after_box =
        base + 64 + lane < P ? (int)ord[base + 64 + lane] : 0;
    const int s = g % stages;
    bar_wait(&full[s], (g / stages) & 1);
    const unsigned* group = stage_words + s * 32 * stride;

    const bool candidate = base + lane < P && score > score_thresh;
    // Ranks of the group before its first non-candidate (or past P).
    const unsigned stop = __ballot_sync(kFull, !candidate);
    const int n = stop ? __ffs(stop) - 1 : 32;
    // The group's ranks that no earlier group's survivor removed.
    unsigned picks =
        __ballot_sync(kFull, lane < n && !removed_bit(removed, box));
    if (picks & (picks - 1)) {  // two or more: one may drop another
      // Bit k: this lane's box overlaps lane k's (its row, at that box).
      unsigned over = 0;
      const unsigned* my_row = group + lane * stride;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int box_k = __shfl_sync(kFull, box, k);
        over |= ((my_row[box_k >> 5] >> (box_k & 31)) & 1u) << k;
      }
      // In rank order, each survivor drops the later ones its box
      // overlaps.
#pragma unroll
      for (int k = 0; k < 31; ++k) {
        const unsigned drop = __shfl_sync(kFull, over, k) & (~0u << (k + 1));
        if ((picks >> k) & 1u) picks &= ~drop;
      }
    }
    // The cap keeps the first max_per_class survivors.
    const int room = max_per_class - kept;
    const int found = __popc(picks);
    for (int extra = found - room; extra > 0; --extra) {
      picks &= ~(0x80000000u >> __clz(picks));
    }
    kept += __popc(picks);
    if ((picks >> lane) & 1u) out[(size_t)box * C] = true;
    if (found >= room || n < 32 || !more) {
      if (lane == 0) *(volatile int*)&walked = 1;  // the producer stops
      return;
    }

    // The group's survivors' rows, staged, into the removed words.
    for (int w = lane; w < W; w += 32) {
      unsigned acc = removed[w];
      for (unsigned p = picks; p; p &= p - 1) {
        acc |= group[(__ffs(p) - 1) * stride + w];
      }
      removed[w] = acc;
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);  // the buffer is free again
    box = next_box;
    score = next_score;
    next_box = after_box;
  }
}

int check_shape(int B, int P, int C) {
  if (B < 1 || B > kMaxImages || P < 1 || P > kMaxProposals || C < 1 ||
      (long long)B * C > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaSuccess;
}

}  // namespace

// bits [B, P, row_words(P)] int32 (scratch) from boxes [B, P, 4] float32,
// both contiguous. Returns the launch's error; refuses a B or P past
// kMaxImages or kMaxProposals.
extern "C" int cap2det_nms_bits(const void* boxes, void* bits, int B, int P,
                                float iou_thresh, void* stream) {
  const int rc = check_shape(B, P, 1);
  if (rc != (int)cudaSuccess) return rc;
  const int row = row_words(P);
  const int W = (P + 31) / 32;
  const dim3 grid((W + kBitsWarps - 1) / kBitsWarps, W, B);
  overlap_bits<<<grid, kBitsWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)boxes, (unsigned*)bits, P, row, iou_thresh);
  return (int)cudaGetLastError();
}

// keep [B, P, C] bool from scores [B, P, C] float32, order [B, C, P] int64
// (each class's stable descending score order) and the bits that
// cap2det_nms_bits made, all contiguous, bits 16-byte aligned. Returns the
// launch's error.
extern "C" int cap2det_nms_walk(const void* scores, const void* order,
                                const void* bits, void* keep, int B, int P,
                                int C, float score_thresh, int max_per_class,
                                void* stream) {
  const int rc = check_shape(B, P, C);
  if (rc != (int)cudaSuccess) return rc;
  const int row = row_words(P);
  const size_t smem =
      ((size_t)row + (size_t)stages_for(row) * 32 * stage_stride(row)) *
      sizeof(unsigned);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        greedy_walk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  greedy_walk<<<B * C, 32 * (1 + kProducers), smem,
                (cudaStream_t)stream>>>(
      (const float*)scores, (const long long*)order, (const unsigned*)bits,
      (bool*)keep, C, P, score_thresh, max_per_class);
  return (int)cudaGetLastError();
}

// The whole pass, both kernels on one stream: keep [B, P, C] bool from
// boxes [B, P, 4], scores [B, P, C], order [B, C, P] and the scratch bits
// [B, P, row_words(P)] int32, all contiguous, bits 16-byte aligned.
extern "C" int cap2det_nms(const void* boxes, const void* scores,
                           const void* order, void* bits, void* keep, int B,
                           int P, int C, float score_thresh,
                           float iou_thresh, int max_per_class,
                           void* stream) {
  const int rc = check_shape(B, P, C);
  if (rc != (int)cudaSuccess) return rc;
  const int bits_rc = cap2det_nms_bits(boxes, bits, B, P, iou_thresh, stream);
  if (bits_rc != (int)cudaSuccess) return bits_rc;
  return cap2det_nms_walk(scores, order, bits, keep, B, P, C, score_thresh,
                          max_per_class, stream);
}
