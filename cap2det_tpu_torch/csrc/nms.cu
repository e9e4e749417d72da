// Greedy class-wise non-max suppression, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. cap2det_tpu/ops/nms.py `_per_image_nms`
// runs the greedy pass as one `lax.fori_loop` over the P ranks, with all
// classes at once, inside the postprocess that cap2det_tpu/eval/
// evaluator.py jits into one TPU program. Eager PyTorch ran the same loop
// from Python, a few small launches per rank. This is that loop as one
// launch per batch_multiclass_nms call, for every image and class.
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
// and fmaxf (which drop a NaN) are safe in the intersection.
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
// does at most (max_per_class - 1) x P IoUs of 25 operations. The walk is
// a chain of dependent steps: each survivor must finish clearing later
// ranks before the next survivor is known.
//
// Design: one block per (image, class). The block stages the class's
// boxes in rank order in shared memory (16 bytes a rank) beside a keep
// byte a rank (its candidate flag), so the walk never touches device
// memory. Every warp finds the next kept rank alone, 32 ranks a step with
// a ballot over the keep bytes; a rank that is not kept costs no
// barrier. For a kept rank, the block's threads test the later
// candidates in parallel, clear the keep byte of each one it overlaps,
// and meet at one __syncthreads: one barrier per survivor, at most
// max_per_class - 1 a class. The block then writes its class's column of
// the mask, P bytes at a stride of C. Shared memory holds 17 bytes a
// rank, so P is limited by the 227 KB a block may opt in to
// (kernels/nms.py MAX_PROPOSALS); the C entry refuses a larger P.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
// Dynamic shared memory a block may take: the H100's 227 KB less a
// reserve for the static shared memory (kernels/nms.py mirrors both).
constexpr size_t kSmemLimit = 227 * 1024;
constexpr size_t kSmemReserve = 1024;
constexpr size_t kBytesPerRank = sizeof(float4) + 1;

// max(x, 0) that keeps a NaN, as torch.clamp_min does.
__device__ __forceinline__ float clamp0(float x) {
  return x < 0.0f ? 0.0f : x;
}

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(clamp0(__fsub_rn(b.z, b.x)), clamp0(__fsub_rn(b.w, b.y)));
}

// pairwise_iou(a, b) > thresh, boxes as (ymin, xmin, ymax, xmax).
__device__ __forceinline__ bool overlaps(float4 a, float4 b, float thresh) {
  const float ih = clamp0(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)));
  const float iw = clamp0(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)));
  const float inter = __fmul_rn(ih, iw);
  const float uni = __fsub_rn(__fadd_rn(area(a), area(b)), inter);
  const float iou =
      uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
  return iou > thresh;
}

__global__ void __launch_bounds__(kThreads)
    greedy_nms(const float* __restrict__ boxes,
               const float* __restrict__ scores,
               const long long* __restrict__ order, bool* __restrict__ keep,
               int P, int C, float score_thresh, float iou_thresh,
               int max_per_class) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* box = reinterpret_cast<float4*>(smem);
  unsigned char* alive = smem + (size_t)P * sizeof(float4);
  __shared__ int num_candidates;

  const int c = blockIdx.x % C;
  const size_t b = blockIdx.x / C;
  const long long* ord = order + (b * C + c) * P;
  const float* bx = boxes + b * P * 4;
  const float* sc = scores + b * P * C + c;

  if (threadIdx.x == 0) num_candidates = P;
  __syncthreads();
  for (int r = threadIdx.x; r < P; r += blockDim.x) {
    const size_t i = (size_t)ord[r];
    box[r] = make_float4(bx[i * 4], bx[i * 4 + 1], bx[i * 4 + 2],
                         bx[i * 4 + 3]);
    const bool candidate = sc[i * C] > score_thresh;
    alive[r] = candidate;
    if (!candidate) atomicMin(&num_candidates, r);
  }
  __syncthreads();

  // Ranks from `end` on are not kept: the first non-candidate, or one
  // past the survivor numbered max_per_class.
  const int n = max_per_class > 0 ? num_candidates : 0;
  int end = n;
  const int lane = threadIdx.x & 31;
  int kept = 0;
  int from = 0;
  for (;;) {
    // The first kept rank from `from` on. Ranks below it are cleared and
    // it is kept: no thread writes either until the next barrier (writes
    // go only to later ranks), so every warp finds the same rank even
    // while a faster warp already clears ranks beyond it.
    int next = n;
    for (int base = from; base < n; base += 32) {
      const int r = base + lane;
      const unsigned hit = __ballot_sync(0xffffffffu, r < n && alive[r]);
      if (hit) {
        next = base + __ffs(hit) - 1;
        break;
      }
    }
    if (next >= n) break;
    if (++kept == max_per_class) {
      end = next + 1;
      break;
    }
    const float4 a = box[next];
    for (int j = next + 1 + threadIdx.x; j < n; j += blockDim.x) {
      if (alive[j] && overlaps(a, box[j], iou_thresh)) alive[j] = 0;
    }
    __syncthreads();
    from = next + 1;
  }
  // No barrier: nothing is written to `alive` after the last one.
  bool* out = keep + b * P * C + c;
  for (int r = threadIdx.x; r < P; r += blockDim.x) {
    out[(size_t)ord[r] * C] = r < end && alive[r];
  }
}

}  // namespace

// keep [B, P, C] bool from boxes [B, P, 4] and scores [B, P, C] float32
// and order [B, C, P] int64 (each class's stable descending score order),
// all contiguous. Returns the launch's error; refuses a P whose staged
// ranks exceed kSmemLimit - kSmemReserve bytes.
extern "C" int cap2det_nms(const void* boxes, const void* scores,
                           const void* order, void* keep, int B, int P, int C,
                           float score_thresh, float iou_thresh,
                           int max_per_class, void* stream) {
  const size_t smem = (size_t)P * kBytesPerRank;
  if (B < 1 || P < 1 || C < 1 || (long long)B * C > INT_MAX ||
      smem > kSmemLimit - kSmemReserve) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        greedy_nms, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  greedy_nms<<<B * C, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)boxes, (const float*)scores, (const long long*)order,
      (bool*)keep, P, C, score_thresh, iou_thresh, max_per_class);
  return (int)cudaGetLastError();
}
