// Greedy NMS suppression for a batch of score-sorted candidate boxes.
//
// Replaces the TPU kernel multiposenet_tpu/ops/pallas_nms.py::_nms_suppress_kernel
// (pallas_nms.py:33-78): K score-sorted x1y1x2y2 boxes and a validity row in,
// the greedy keep mask out, with the +1-pixel IoU convention and strict `>`.
// The JAX pipeline launches that kernel once per image under vmap; here one
// launch covers the whole batch, one thread block per image.
//
// What bounds it: at the serving shapes (B = 64 images, K = 100 candidates)
// the kernel reads ~100 KB and does ~5 MFLOP, nothing for a card that moves
// 3.35 TB/s.  What is left is latency: K = 100 dependent scan steps per image
// plus the launch itself.  The design keeps every step on chip and short:
//   phase 1  thread i computes row i of the suppression bitmask (bit j set
//            when j > i and IoU(i, j) > thresh) into shared memory,
//            K x ceil(K/32) uint32 words (1.6 KB at K = 100), all rows at once;
//   phase 2  one warp runs the greedy scan: lane w holds "removed" word w in a
//            register; each step reads the word holding bit i with one
//            shuffle and, if box i is valid and alive, ORs row i in with one
//            shared-memory load per lane.  No block barrier inside the scan
//            and no round trip to the host (the reference's CUDA NMS reduced
//            its mask on the host).
//
// Bit-exactness with the plain PyTorch version (ops/nms.py::nms_suppress_plain):
// every float op rounds on its own (__fadd_rn and friends, which nvcc never
// contracts into FMA; the build also passes -fmad=false) in the op order of
// ops/boxes.py::box_iou_plus1: iw = min(x2) - max(x1) + 1 clamped at 0,
// inter = iw * ih, iou = inter / ((area_i + area_j) - inter).  min and max
// propagate NaN as torch.minimum / torch.maximum do, and a NaN IoU compares
// false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;  // one thread per candidate, K words per row <= 32

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}

__device__ __forceinline__ float area_plus1(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

__global__ void nms_suppress_kernel(const float4* __restrict__ boxes,
                                    const uint8_t* __restrict__ valid,
                                    uint8_t* __restrict__ keep,
                                    int k, float thresh) {
  extern __shared__ float4 smem[];
  const int words = (k + 31) / 32;
  float4* sbox = smem;                                      // k
  float* sarea = reinterpret_cast<float*>(sbox + k);        // k
  uint32_t* mask = reinterpret_cast<uint32_t*>(sarea + k);  // k * words
  uint32_t* removed = mask + k * words;                     // 32
  uint8_t* sval = reinterpret_cast<uint8_t*>(removed + 32); // k

  const int img = blockIdx.x;
  const int i = threadIdx.x;
  const float4* ib = boxes + static_cast<size_t>(img) * k;
  const uint8_t* iv = valid + static_cast<size_t>(img) * k;

  if (i < k) {
    float4 b = ib[i];
    sbox[i] = b;
    sarea[i] = area_plus1(b);
    sval[i] = iv[i];
  }
  __syncthreads();

  // phase 1: row i of the suppression bitmask
  if (i < k) {
    const float4 bi = sbox[i];
    const float ai = sarea[i];
    for (int w = 0; w < words; ++w) {
      uint32_t bits = 0;
      const int j0 = w * 32;
      const int j1 = min(j0 + 32, k);
      for (int j = max(j0, i + 1); j < j1; ++j) {
        const float4 bj = sbox[j];
        float iw = __fadd_rn(__fsub_rn(min_nan(bi.z, bj.z), max_nan(bi.x, bj.x)), 1.0f);
        float ih = __fadd_rn(__fsub_rn(min_nan(bi.w, bj.w), max_nan(bi.y, bj.y)), 1.0f);
        iw = max_nan(iw, 0.0f);
        ih = max_nan(ih, 0.0f);
        const float inter = __fmul_rn(iw, ih);
        const float iou = __fdiv_rn(inter, __fsub_rn(__fadd_rn(ai, sarea[j]), inter));
        if (iou > thresh) bits |= 1u << (j - j0);
      }
      mask[i * words + w] = bits;
    }
  }
  __syncthreads();

  // phase 2: greedy scan in warp 0
  if (i < 32) {
    const int lane = i;
    uint32_t rem = 0;
    for (int r = 0; r < k; ++r) {
      const uint32_t wr = __shfl_sync(0xffffffffu, rem, r >> 5);
      const bool alive = sval[r] != 0 && !((wr >> (r & 31)) & 1u);
      if (alive && lane < words) rem |= mask[r * words + lane];
    }
    if (lane < words) removed[lane] = rem;
  }
  __syncthreads();

  if (i < k) {
    const bool sup = (removed[i >> 5] >> (i & 31)) & 1u;
    keep[static_cast<size_t>(img) * k + i] = (sval[i] != 0 && !sup) ? 1 : 0;
  }
}

}  // namespace

extern "C" size_t nms_suppress_smem_bytes(int k) {
  const int words = (k + 31) / 32;
  return sizeof(float4) * k + sizeof(float) * k +
         sizeof(uint32_t) * (static_cast<size_t>(k) * words + 32) + k;
}

// boxes (B, K, 4) float32, valid (B, K) bool/uint8, keep (B, K) bool/uint8,
// all contiguous on the device; launches on `stream` and returns
// cudaGetLastError() so a refused launch reaches the caller.
extern "C" int nms_suppress_launch(const void* boxes, const void* valid,
                                   void* keep, int b, int k, float thresh,
                                   void* stream) {
  if (b <= 0 || k <= 0) return static_cast<int>(cudaSuccess);
  if (k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((k + 31) / 32) * 32;
  const size_t smem = nms_suppress_smem_bytes(k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_suppress_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, thresh);
  return static_cast<int>(cudaGetLastError());
}
