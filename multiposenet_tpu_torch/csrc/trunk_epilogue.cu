// Trunk epilogue: one pass for a frozen ResNet trunk layer's BatchNorm,
// residual add and ReLU,
//
//     y = max(x * s + b [+ r] [+ x2 * s2 + b2], 0),
//     s = weight / sqrt(running_var + eps),  b = bias - running_mean * s,
//
// over NHWC float32 activations, C a multiple of 4.
//
// It replaces no TPU kernel.  On the TPU, XLA fuses the BatchNorm, the add
// and the ReLU into the convolution's output.  Eager PyTorch runs each as a
// pass of its own over the activation in device memory: cuDNN's BatchNorm
// (read, write), F.relu (read, write), and at a block's end `out + x` (two
// reads, a write) and F.relu again.  In the detection stage the trunk is
// frozen and those passes were a quarter to a third of the train step's
// device time at 608 px, batch 25.  Here the layer's conv output is read
// once and its activation written once; a block's end also reads the
// residual, or the downsample conv's raw output, whose BatchNorm then needs
// no pass of its own.
//
// What bounds it on an H100: bytes.  It does 2-5 flops per 8-12 bytes moved,
// so its least time is bytes / 3.35 TB/s: 4 * n * (2 + [1 if a second input])
// bytes for n activation values; the per-channel parameters are noise.
//
// Design:
//   layout    a thread reads and writes 16-byte vectors (4 channels), a
//             warp 512 contiguous bytes.  The grid's thread count is a
//             multiple of C/4, so in its grid-stride loop a thread keeps its
//             4 channels and computes their s and b once, in registers, from
//             the BatchNorm's own buffers: no pass over the parameters, and
//             nothing cached between calls (a restored checkpoint is read
//             at the next launch);
//   in flight as many blocks of 256 threads as an SM holds at the kernel's
//             registers (the grid is that many per SM: a grid-stride loop
//             with no second wave), each thread with 4 vectors of each
//             input loaded before any is used: 64-96 KB in flight per SM,
//             above what hides HBM's latency;
//   caching   inputs are read once, with evict-first loads; the output is
//             stored plainly, since the next conv reads it (from L2 when
//             it fits).
// Clusters, TMA and wgmma have no work to do in a streaming pass.
//
// Rounding: that of the plain twin on the CPU (ops/trunk_epilogue.py;
// ATen's BatchNorm inference): inv = 1 / sqrt(var + eps) rounded at each
// step, s = inv * weight, b = fma(-mean, s, bias), x * s + b as one fma; the
// residual, or the downsample's fma, added with one rounding; the ReLU keeps
// NaN (NaN < 0 is false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // vectors of each input in flight per thread
constexpr int kMaxDevices = 64;

struct Bn {   // one BatchNorm's running statistics and affine, each [C]
  const float* mean;
  const float* var;
  const float* weight;
  const float* bias;
  float eps;
};

struct Affine4 {   // s and b of a thread's 4 channels
  float s[4];
  float b[4];
};

__device__ __forceinline__ Affine4 affine4(const Bn& bn, int c) {
  Affine4 a;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float inv =
        __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(bn.var[c + j], bn.eps)));
    a.s[j] = __fmul_rn(inv, bn.weight[c + j]);
    a.b[j] = __fmaf_rn(-bn.mean[c + j], a.s[j], bn.bias[c + j]);
  }
  return a;
}

// kMode 0: bn(x); 1: bn(x) + r; 2: bn(x) + bn2(r)
template <int kMode>
__device__ __forceinline__ float one(float x, float r, const Affine4& a,
                                     const Affine4& a2, int j) {
  float v = __fmaf_rn(x, a.s[j], a.b[j]);
  if (kMode == 1) v = __fadd_rn(v, r);
  if (kMode == 2) v = __fadd_rn(v, __fmaf_rn(r, a2.s[j], a2.b[j]));
  return v < 0.0f ? 0.0f : v;
}

template <int kMode>
__device__ __forceinline__ float4 epilogue(float4 x, float4 r, const Affine4& a,
                                           const Affine4& a2) {
  return make_float4(one<kMode>(x.x, r.x, a, a2, 0), one<kMode>(x.y, r.y, a, a2, 1),
                     one<kMode>(x.z, r.z, a, a2, 2), one<kMode>(x.w, r.w, a, a2, 3));
}

// x, r, y: n4 float4 vectors of an NHWC tensor with c4 = C / 4 vectors per
// pixel; the grid's thread count must be a multiple of c4
template <int kMode>
__global__ void __launch_bounds__(kThreads)
trunk_epilogue_kernel(const float4* __restrict__ x, const float4* __restrict__ r,
                      float4* __restrict__ y, Bn bn, Bn bn2, int64_t n4, int c4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int c = static_cast<int>(first % c4) * 4;
  const Affine4 a = affine4(bn, c);
  const Affine4 a2 = kMode == 2 ? affine4(bn2, c) : a;
  for (int64_t base = first; base < n4; base += stride * kUnroll) {
    float4 xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = base + k * stride;
      if (i < n4) {
        xv[k] = __ldcs(x + i);
        rv[k] = kMode != 0 ? __ldcs(r + i) : xv[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = base + k * stride;
      if (i < n4) y[i] = epilogue<kMode>(xv[k], rv[k], a, a2);
    }
  }
}

int gcd(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// blocks of kMode's kernel resident on the current device at once
template <int kMode>
cudaError_t resident_blocks(int64_t* out) {
  static int counts[kMaxDevices];   // 0 until first asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (counts[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, trunk_epilogue_kernel<kMode>, kThreads, 0);
    if (err != cudaSuccess) return err;
    counts[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *out = counts[dev];
  return cudaSuccess;
}

template <int kMode>
cudaError_t launch(const float4* x, const float4* r, float4* y, const Bn& bn,
                   const Bn& bn2, int64_t n4, int c4, cudaStream_t stream) {
  int64_t resident = 0;
  cudaError_t err = resident_blocks<kMode>(&resident);
  if (err != cudaSuccess) return err;
  int64_t blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  // a multiple of c4 threads in all, so that no thread changes channels
  const int g = c4 / gcd(c4, kThreads);
  blocks = (blocks + g - 1) / g * g;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  trunk_epilogue_kernel<kMode><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      x, r, y, bn, bn2, n4, c4);
  return cudaGetLastError();
}

}  // namespace

// x, r and y: n float32 values of NHWC tensors with c channels (c % 4 == 0,
// n % c == 0), 16-byte aligned, on the current device.  mode 0: y =
// relu(bn(x)), r unused; 1: y = relu(bn(x) + r); 2: y = relu(bn(x) + bn2(r)),
// r being the downsample conv's raw output.  Each BatchNorm is four float32
// [c] arrays and its eps.  Launches on `stream` and returns
// cudaGetLastError(), so a refused launch reaches the caller.
extern "C" int trunk_epilogue_launch(
    const void* x, const void* r, int mode, void* y, long long n, int c,
    const void* mean, const void* var, const void* weight, const void* bias,
    float eps, const void* mean2, const void* var2, const void* weight2,
    const void* bias2, float eps2, void* stream) {
  if (c <= 0 || c % 4 != 0 || n % c != 0 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Bn bn{static_cast<const float*>(mean), static_cast<const float*>(var),
              static_cast<const float*>(weight), static_cast<const float*>(bias), eps};
  const Bn bn2{static_cast<const float*>(mean2), static_cast<const float*>(var2),
               static_cast<const float*>(weight2), static_cast<const float*>(bias2),
               eps2};
  const float4* xv = static_cast<const float4*>(x);
  const float4* rv = static_cast<const float4*>(r);
  float4* yv = static_cast<float4*>(y);
  const int64_t n4 = n / 4;
  const int c4 = c / 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      mode == 0 ? launch<0>(xv, rv, yv, bn, bn2, n4, c4, s)
      : mode == 1 ? launch<1>(xv, rv, yv, bn, bn2, n4, c4, s)
                  : launch<2>(xv, rv, yv, bn, bn2, n4, c4, s);
  return static_cast<int>(err);
}
