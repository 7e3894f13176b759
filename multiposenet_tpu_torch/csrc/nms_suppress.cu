// Greedy NMS suppression for a batch of score-sorted candidate boxes.
//
// Replaces the TPU kernel multiposenet_tpu/ops/pallas_nms.py::_nms_suppress_kernel
// (pallas_nms.py:33-78): K score-sorted x1y1x2y2 boxes and a validity row in,
// the greedy keep mask out, with the +1-pixel IoU convention and strict `>`.
// The JAX pipeline launches that kernel once per image under vmap; here one
// launch covers the whole batch, one thread block of kThreads per image, and
// everything between the loads and the keep mask stays in shared memory and
// registers.
//
// What bounds it on an H100: latency, not bytes or operations.  At the serving
// shapes (B = 64 images, K = 100 candidates) the kernel moves ~115 KB and does
// ~5 MFLOP, well under a microsecond of the card's rates, and less than one
// kernel launch costs.  What is left is the chain of dependent steps inside a
// block: global loads, the bitmask, the greedy scan, the stores.  The design
// makes each stage short:
//   stage    whole warps load the image's boxes, +1-px areas and valid bits
//            (one __ballot_sync per 32 boxes) into shared memory;
//   bitmask  the warps share out the tasks (row i, word w) with w >= i / 32,
//            the upper triangle including the diagonal word.  In a task lane l
//            tests j = 32 w + l (j > i, j < K, IoU(i, j) > thresh) and one
//            __ballot_sync forms the 32-bit word: ~9 ballots per warp at
//            K = 100 with 32 warps, against 99 IoUs one after another for a
//            thread that computes a whole row.  Words below the triangle are
//            never written and never read;
//   scan     one warp, blocked by words.  For word-block c (boxes 32c..32c+31)
//            lane r holds row 32c+r's diagonal word.  The greedy steps inside
//            the block visit, in order, only the rows whose word is not zero
//            (one ballot finds them): each visit reads the word by shuffle
//            and updates the block's "removed" word in registers.  The kept
//            rows of block c then OR their words w > c into the "removed"
//            words with one __reduce_or_sync per word.  The chain is
//            ceil(K/32) blocks of at most 32 register steps and a few
//            reductions, against K steps with a shared-memory load each for
//            a scan that goes box by box;
//   write    keep = valid && !removed, one byte per thread.
// Clusters, TMA and wgmma have no work to do at these sizes.
//
// Bit-exactness with the plain PyTorch version (ops/nms.py::nms_suppress_plain):
// every float op rounds on its own (__fadd_rn and friends, which nvcc never
// contracts into FMA; the build also passes -fmad=false) in the op order of
// ops/boxes.py::box_iou_plus1: iw = min(x2) - max(x1) + 1 clamped at 0,
// inter = iw * ih, iou = inter / ((area_i + area_j) - inter).  min and max
// propagate NaN as torch.minimum / torch.maximum do (PTX min.NaN / max.NaN;
// the sign of a zero they return cannot reach the result: each min and max
// feeds a difference to which 1 is added, or clamps such a sum, which is never
// -0), and a NaN IoU compares false.  The divide is kept: inter > thresh *
// union would change results near the threshold.  One shortcut: when inter is
// 0 or NaN the IoU is +-0 or NaN, which is not > thresh for any thresh >= 0,
// so for thresh >= 0 such a pair's bit is 0 without the divide.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;              // words per row <= 32: one warp scans
constexpr int kMaxWords = kMaxK / 32;
constexpr int kThreads = 1024;           // 32 warps share out the bitmask
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kFull = 0xffffffffu;

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float area_plus1(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// IoU(a, b) > thresh, with box_iou_plus1's rounding
__device__ __forceinline__ bool iou_over(float4 a, float area_a, float4 b,
                                         float area_b, float thresh) {
  float iw = __fadd_rn(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)), 1.0f);
  float ih = __fadd_rn(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)), 1.0f);
  iw = max_nan(iw, 0.0f);
  ih = max_nan(ih, 0.0f);
  const float inter = __fmul_rn(iw, ih);
  if (!(inter > 0.0f) && thresh >= 0.0f) return false;
  return __fdiv_rn(inter, __fsub_rn(__fadd_rn(area_a, area_b), inter)) > thresh;
}

// Row pitch of the bitmask: odd, so that the scan warp, reading one word of
// 32 consecutive rows, meets 32 different banks.
__host__ __device__ constexpr int mask_pitch(int words) { return words | 1; }

// One image's shared memory: boxes and areas (k each), the bitmask (k rows of
// mask_pitch(words) words), and one word per 32 boxes of valid bits and of
// kept bits.
struct Shared {
  float4* box;
  float* area;
  uint32_t* mask;
  uint32_t* valid;
  uint32_t* kept;
  __device__ Shared(float4* base, int k, int words)
      : box(base),
        area(reinterpret_cast<float*>(base + k)),
        mask(reinterpret_cast<uint32_t*>(area + k)),
        valid(mask + k * mask_pitch(words)),
        kept(valid + kMaxWords) {}
};

__device__ __forceinline__ void stage(const Shared& s, const float4* boxes,
                                      const uint8_t* valid, int k, int words) {
  const int lane = threadIdx.x & 31;
  for (int base = threadIdx.x & ~31; base < words * 32; base += kThreads) {
    const int i = base + lane;
    bool v = false;
    if (i < k) {
      const float4 b = boxes[i];
      s.box[i] = b;
      s.area[i] = area_plus1(b);
      v = valid[i] != 0;
    }
    const uint32_t bits = __ballot_sync(kFull, v);
    if (lane == 0) s.valid[base >> 5] = bits;
  }
}

// mask[i * pitch + w] bit l: box 32 w + l lies after box i and overlaps it
// by more than thresh.  Written for w >= i / 32 only.
__device__ __forceinline__ void build_mask(const Shared& s, int k, int words,
                                           float thresh) {
  const int lane = threadIdx.x & 31;
  const int pitch = mask_pitch(words);
  for (int i = threadIdx.x >> 5; i < k; i += kWarps) {
    const float4 bi = s.box[i];
    const float ai = s.area[i];
    for (int w = i >> 5; w < words; ++w) {
      const int j = w * 32 + lane;
      // every lane reaches the ballot; lanes out of range vote 0
      bool over = false;
      if (j > i && j < k) over = iou_over(bi, ai, s.box[j], s.area[j], thresh);
      const uint32_t bits = __ballot_sync(kFull, over);
      if (lane == 0) s.mask[i * pitch + w] = bits;
    }
  }
}

// The greedy scan in one warp: kept[c] gets the kept boxes of word-block c.
__device__ __forceinline__ void scan(const Shared& s, int words) {
  const int lane = threadIdx.x & 31;
  const int pitch = mask_pitch(words);
  uint32_t removed = 0;  // lane w: word w of the boxes removed by earlier blocks
  for (int c = 0; c < words; ++c) {
    const int row = c * 32 + lane;
    const uint32_t valid = s.valid[c];
    // lane r: what box 32c+r removes inside the block, 0 if it is invalid
    const uint32_t diag =
        ((valid >> lane) & 1u) ? s.mask[row * pitch + c] : 0u;
    uint32_t cur = __shfl_sync(kFull, removed, c);
    // visit in order the rows that remove something inside the block; a row
    // that is itself removed by then leaves cur as it is
    for (uint32_t m = __ballot_sync(kFull, diag != 0u); m; m &= m - 1) {
      const int r = __ffs(m) - 1;
      const uint32_t d = __shfl_sync(kFull, diag, r);
      cur |= d & (((cur >> r) & 1u) - 1u);
    }
    const uint32_t kept = valid & ~cur;
    if (lane == 0) s.kept[c] = kept;
    const bool row_kept = (kept >> lane) & 1u;
    for (int w = c + 1; w < words; ++w) {
      const uint32_t x =
          __reduce_or_sync(kFull, row_kept ? s.mask[row * pitch + w] : 0u);
      if (lane == w) removed |= x;
    }
  }
}

__device__ __forceinline__ void write_keep(const Shared& s, uint8_t* keep,
                                           int k) {
  for (int i = threadIdx.x; i < k; i += kThreads)
    keep[i] = (s.kept[i >> 5] >> (i & 31)) & 1u;
}

__global__ void __launch_bounds__(kThreads)
nms_suppress_kernel(const float4* __restrict__ boxes,
                    const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep, int k, float thresh) {
  extern __shared__ float4 smem[];
  const int words = (k + 31) / 32;
  const Shared s(smem, k, words);
  const size_t img = blockIdx.x;
  stage(s, boxes + img * k, valid + img * k, k, words);
  __syncthreads();
  build_mask(s, k, words, thresh);
  __syncthreads();
  if (threadIdx.x < 32) scan(s, words);
  __syncthreads();
  write_keep(s, keep + img * k, k);
}

}  // namespace

extern "C" size_t nms_suppress_smem_bytes(int k) {
  const size_t pitch = mask_pitch((k + 31) / 32);
  return (sizeof(float4) + sizeof(float)) * k +
         sizeof(uint32_t) * (k * pitch + 2 * kMaxWords);
}

// boxes (B, K, 4) float32, valid (B, K) bool/uint8, keep (B, K) bool/uint8,
// all contiguous on the device; launches on `stream` and returns
// cudaGetLastError() so a refused launch reaches the caller.
extern "C" int nms_suppress_launch(const void* boxes, const void* valid,
                                   void* keep, int b, int k, float thresh,
                                   void* stream) {
  if (b <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  if (k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = nms_suppress_smem_bytes(k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_suppress_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, thresh);
  return static_cast<int>(cudaGetLastError());
}
