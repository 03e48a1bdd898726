// Instance normalisation, f32, NCHW: y = x * scale[b,c] + shift[b,c] with
//   mean = E[x], var = max(E[x^2] - mean^2, 0) over one (b, c) plane of H*W,
//   scale = gamma[c] * rsqrt(var + eps), shift = beta[c] - mean * scale.
//
// Replaces the TPU kernel shmgan_tpu/ops/pallas/instance_norm.py
// (_kernel / _pallas_instance_norm / instance_norm_pallas), which streams one
// batch element's NHWC slab through VMEM and folds 128-lane partial sums back
// to channels. On Hopper the activation is NCHW, so each (b, c) plane is
// contiguous and one block owns one plane: no cross-block reduction, no
// atomics, and 512..4096 blocks at the generator's shapes fill the 132 SMs.
//
// Bound: memory. Per element it does ~5 flops against 8 bytes (one read, one
// write), far below the card's ~20 flops/byte balance point in f32. Pass 1
// reads the plane and reduces sum / sum-of-squares (f32, warp shuffles, then
// shared memory across warps); pass 2 reads it again and writes the output.
// The second read is the cost this simple design pays: a plane is at most
// 256 KB, and it hits L2 only while the planes in flight fit the 50 MB L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums (a, b) over the block; every thread gets the totals.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kThreads / 32];
  __shared__ float sb[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {  // same order in every thread
    a += sa[w];
    b += sb[w];
  }
}

__global__ void __launch_bounds__(kThreads)
instance_norm_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, float* __restrict__ y,
                     int channels, long long hw, float eps) {
  const long long plane = blockIdx.x;
  const int c = static_cast<int>(plane % channels);
  const float* xp = x + plane * hw;
  float* yp = y + plane * hw;
  // float4 path when every plane starts on a 16-byte boundary; the wrapper
  // hands over tensors from the caching allocator, whose bases are aligned.
  const bool vec = (hw % 4 == 0) && ((reinterpret_cast<uintptr_t>(x) & 15) == 0) &&
                   ((reinterpret_cast<uintptr_t>(y) & 15) == 0);

  float s = 0.f, s2 = 0.f;
  if (vec) {
    const float4* xv = reinterpret_cast<const float4*>(xp);
    for (long long i = threadIdx.x; i < hw / 4; i += kThreads) {
      const float4 v = xv[i];
      s += (v.x + v.y) + (v.z + v.w);
      s2 += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
    }
  } else {
    for (long long i = threadIdx.x; i < hw; i += kThreads) {
      const float v = xp[i];
      s += v;
      s2 += v * v;
    }
  }
  block_sum2(s, s2);

  const float inv_n = 1.f / static_cast<float>(hw);
  const float mean = s * inv_n;
  const float var = fmaxf(s2 * inv_n - mean * mean, 0.f);
  const float scale = gamma[c] * rsqrtf(var + eps);
  const float shift = beta[c] - mean * scale;

  if (vec) {
    const float4* xv = reinterpret_cast<const float4*>(xp);
    float4* yv = reinterpret_cast<float4*>(yp);
    for (long long i = threadIdx.x; i < hw / 4; i += kThreads) {
      float4 v = xv[i];
      v.x = fmaf(v.x, scale, shift);
      v.y = fmaf(v.y, scale, shift);
      v.z = fmaf(v.z, scale, shift);
      v.w = fmaf(v.w, scale, shift);
      yv[i] = v;
    }
  } else {
    for (long long i = threadIdx.x; i < hw; i += kThreads) yp[i] = fmaf(xp[i], scale, shift);
  }
}

}  // namespace

// planes = B * C. Returns cudaGetLastError() after the launch.
extern "C" int shm_instance_norm_f32(const float* x, const float* gamma, const float* beta,
                                     float* y, long long planes, int channels, long long hw,
                                     float eps, void* stream) {
  instance_norm_kernel<<<static_cast<unsigned int>(planes), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, gamma, beta, y, channels,
                                                              hw, eps);
  return static_cast<int>(cudaGetLastError());
}
