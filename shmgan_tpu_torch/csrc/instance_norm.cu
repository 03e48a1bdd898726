// Instance normalisation, f32, NCHW, forward and backward.
//
// Forward: y = x * scale[b,c] + shift[b,c] with
//   mean = E[x], var = max(E[x^2] - mean^2, 0) over one (b, c) plane of H*W,
//   scale = gamma[c] * rsqrt(var + eps), shift = beta[c] - mean * scale;
// on request it also writes each plane's mean and rstd = rsqrt(var + eps).
//
// Backward, from the saved mean and rstd, with xhat = (x - mean) * rstd:
//   dgamma[c] = sum over (b, h, w) of g * xhat,  dbeta[c] = sum of g,
//   dx = rstd * gamma[c] * (g - sum(g) / n - xhat * sum(g * xhat) / n) per plane.
//
// Replaces the TPU kernel shmgan_tpu/ops/pallas/instance_norm.py
// (_kernel / _pallas_instance_norm / instance_norm_pallas), which streams one
// batch element's NHWC slab through VMEM and folds 128-lane partial sums back
// to channels, and its custom VJP (_fwd / _bwd, plain XLA there). On Hopper
// the activation is NCHW, so each (b, c) plane is contiguous and one block
// owns one plane: no cross-block reduction inside a plane, no atomics, and
// 512..81920 blocks at the train step's shapes fill the 132 SMs.
//
// Bound: memory. The forward does ~5 flops against 8 bytes per element (one
// read, one write), the backward ~10 against 12 (x and g read, dx written),
// far below the card's ~20 flops/byte balance point in f32. Each kernel reads
// its plane twice: pass 1 reduces (sum, sum of squares) or (sum g, sum g*xhat)
// with warp shuffles, then shared memory across warps; pass 2 reads again and
// writes. The second read is the cost this simple design pays: a plane is at
// most 256 KB, and it hits L2 only while the planes in flight fit the 50 MB L2.
//
// dgamma and dbeta: each backward block writes its plane's two sums into a
// (B, C) scratch; a second, small launch adds the B rows of each channel in
// order. Both sums are deterministic: repeat calls are bit-identical.
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
                     float* __restrict__ mean_out, float* __restrict__ rstd_out,
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
  const float rstd = rsqrtf(var + eps);
  const float scale = gamma[c] * rstd;
  const float shift = beta[c] - mean * scale;
  if (mean_out != nullptr && threadIdx.x == 0) {
    mean_out[plane] = mean;
    rstd_out[plane] = rstd;
  }

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

__global__ void __launch_bounds__(kThreads)
instance_norm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                         const float* __restrict__ gamma, const float* __restrict__ mean,
                         const float* __restrict__ rstd, float* __restrict__ dx,
                         float* __restrict__ sum_gxhat, float* __restrict__ sum_g,
                         int channels, long long hw) {
  const long long plane = blockIdx.x;
  const int c = static_cast<int>(plane % channels);
  const float* xp = x + plane * hw;
  const float* gp = g + plane * hw;
  float* dxp = dx + plane * hw;
  const float mu = mean[plane];
  const float rs = rstd[plane];
  const bool vec = (hw % 4 == 0) && ((reinterpret_cast<uintptr_t>(x) & 15) == 0) &&
                   ((reinterpret_cast<uintptr_t>(g) & 15) == 0) &&
                   ((reinterpret_cast<uintptr_t>(dx) & 15) == 0);

  float sg = 0.f, sgx = 0.f;
  if (vec) {
    const float4* xv = reinterpret_cast<const float4*>(xp);
    const float4* gv = reinterpret_cast<const float4*>(gp);
    for (long long i = threadIdx.x; i < hw / 4; i += kThreads) {
      const float4 a = xv[i];
      const float4 b = gv[i];
      sg += (b.x + b.y) + (b.z + b.w);
      sgx += (b.x * ((a.x - mu) * rs) + b.y * ((a.y - mu) * rs)) +
             (b.z * ((a.z - mu) * rs) + b.w * ((a.w - mu) * rs));
    }
  } else {
    for (long long i = threadIdx.x; i < hw; i += kThreads) {
      const float b = gp[i];
      sg += b;
      sgx += b * ((xp[i] - mu) * rs);
    }
  }
  block_sum2(sg, sgx);
  if (threadIdx.x == 0) {
    sum_g[plane] = sg;
    sum_gxhat[plane] = sgx;
  }

  const float inv_n = 1.f / static_cast<float>(hw);
  const float k = gamma[c] * rs;
  const float mg = sg * inv_n;
  const float mgx = sgx * inv_n;
  if (vec) {
    const float4* xv = reinterpret_cast<const float4*>(xp);
    const float4* gv = reinterpret_cast<const float4*>(gp);
    float4* dv = reinterpret_cast<float4*>(dxp);
    for (long long i = threadIdx.x; i < hw / 4; i += kThreads) {
      const float4 a = xv[i];
      const float4 b = gv[i];
      float4 o;
      o.x = k * (b.x - mg - ((a.x - mu) * rs) * mgx);
      o.y = k * (b.y - mg - ((a.y - mu) * rs) * mgx);
      o.z = k * (b.z - mg - ((a.z - mu) * rs) * mgx);
      o.w = k * (b.w - mg - ((a.w - mu) * rs) * mgx);
      dv[i] = o;
    }
  } else {
    for (long long i = threadIdx.x; i < hw; i += kThreads) {
      dxp[i] = k * (gp[i] - mg - ((xp[i] - mu) * rs) * mgx);
    }
  }
}

// dgamma[c] = sum_b sum_gxhat[b, c], dbeta[c] = sum_b sum_g[b, c], b in order.
__global__ void channel_sums_kernel(const float* __restrict__ sum_gxhat,
                                    const float* __restrict__ sum_g,
                                    float* __restrict__ dgamma, float* __restrict__ dbeta,
                                    int batch, int channels) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= channels) return;
  float a = 0.f, b = 0.f;
  for (int i = 0; i < batch; ++i) {
    a += sum_gxhat[static_cast<long long>(i) * channels + c];
    b += sum_g[static_cast<long long>(i) * channels + c];
  }
  dgamma[c] = a;
  dbeta[c] = b;
}

}  // namespace

// planes = B * C. mean / rstd: (B * C) outputs, or both null when the caller
// needs no backward. Returns cudaGetLastError() after the launch.
extern "C" int shm_instance_norm_f32(const float* x, const float* gamma, const float* beta,
                                     float* y, float* mean, float* rstd, long long planes,
                                     int channels, long long hw, float eps, void* stream) {
  instance_norm_kernel<<<static_cast<unsigned int>(planes), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, gamma, beta, y, mean, rstd,
                                                              channels, hw, eps);
  return static_cast<int>(cudaGetLastError());
}

// The backward of shm_instance_norm_f32 for a (batch, channels, hw) tensor:
// dx, dgamma (channels), dbeta (channels); scratch holds 2 * batch * channels
// floats. Two launches on `stream`; returns cudaGetLastError() after them.
extern "C" int shm_instance_norm_bwd_f32(const float* x, const float* g, const float* gamma,
                                         const float* mean, const float* rstd, float* dx,
                                         float* dgamma, float* dbeta, float* scratch,
                                         int batch, int channels, long long hw, void* stream) {
  const long long planes = static_cast<long long>(batch) * channels;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  instance_norm_bwd_kernel<<<static_cast<unsigned int>(planes), kThreads, 0, s>>>(
      x, g, gamma, mean, rstd, dx, scratch, scratch + planes, channels, hw);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int threads = 128;
  channel_sums_kernel<<<(channels + threads - 1) / threads, threads, 0, s>>>(
      scratch, scratch + planes, dgamma, dbeta, batch, channels);
  return static_cast<int>(cudaGetLastError());
}
