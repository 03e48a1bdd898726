// Instance normalisation, NCHW, forward and backward, for float32 and
// bfloat16 activations.
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
// Element types: x, y, g and dx are all float or all __nv_bfloat16; gamma,
// beta, mean, rstd, dgamma, dbeta and the scratch are float, and every sum
// and every affine is float, as in the TPU kernel, whose slab stays in x's
// dtype while its moments and affine are f32. A bf16 value is widened with
// __bfloat162float and a result rounded with __float2bfloat16_rn (to nearest
// even, as XLA's convert).
//
// Replaces the TPU kernel shmgan_tpu/ops/pallas/instance_norm.py
// (_kernel / _pallas_instance_norm / instance_norm_pallas), which streams one
// batch element's NHWC slab through VMEM and folds 128-lane partial sums back
// to channels, and its custom VJP (_fwd / _bwd, plain XLA there). On Hopper
// the activation is NCHW, so each (b, c) plane is contiguous and one block
// owns one plane: no cross-block reduction inside a plane, no atomics, and
// 512..81920 blocks at the train step's shapes fill the 132 SMs.
//
// Bound: memory. The forward does ~5 flops against 8 bytes per element in
// f32 (one read, one write) and 4 in bf16, the backward ~10 against 12 in f32
// (x and g read, dx written) and 6 in bf16, far below the card's ~20
// flops/byte balance point in f32. Each kernel reads its plane twice: pass 1
// reduces (sum, sum of squares) or (sum g, sum g*xhat) with warp shuffles,
// then shared memory across warps; pass 2 reads again and writes. The second
// read is the cost this simple design pays: a plane is at most 256 KB, and it
// hits L2 only while the planes in flight fit the 50 MB L2. Loads and stores
// are 16 bytes a thread (4 floats or 8 bf16) when H*W allows it and the
// bases are aligned, else one element at a time.
//
// dgamma and dbeta: each backward block writes its plane's two sums into a
// (B, C) scratch; a second, small launch adds the B rows of each channel in
// order. Both sums are deterministic: repeat calls are bit-identical.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// 16 bytes of bf16 (8 elements, element 0 in the low half of .x) to floats
// and back.
__device__ __forceinline__ void unpack8(const uint4 u, float (&v)[8]) {
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w[k])));
    v[2 * k + 1] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w[k] >> 16)));
  }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  unsigned int w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = static_cast<unsigned int>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k]))) |
           (static_cast<unsigned int>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * k + 1])))
            << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
instance_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y,
                     float* __restrict__ mean_out, float* __restrict__ rstd_out,
                     int channels, long long hw, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  const long long plane = blockIdx.x;
  const int c = static_cast<int>(plane % channels);
  const T* xp = x + plane * hw;
  T* yp = y + plane * hw;
  // 16-byte path when every plane starts on a 16-byte boundary; the wrapper
  // hands over tensors from the caching allocator, whose bases are aligned.
  const bool vec = (hw % kVec == 0) && aligned16(x) && aligned16(y);

  float s = 0.f, s2 = 0.f;
  if (vec) {
    if constexpr (std::is_same_v<T, float>) {
      const float4* xv = reinterpret_cast<const float4*>(xp);
      for (long long i = threadIdx.x; i < hw / 4; i += kThreads) {
        const float4 v = xv[i];
        s += (v.x + v.y) + (v.z + v.w);
        s2 += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
      }
    } else {
      const uint4* xv = reinterpret_cast<const uint4*>(xp);
      for (long long i = threadIdx.x; i < hw / 8; i += kThreads) {
        float v[8];
        unpack8(xv[i], v);
        s += ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
        s2 += ((v[0] * v[0] + v[1] * v[1]) + (v[2] * v[2] + v[3] * v[3])) +
              ((v[4] * v[4] + v[5] * v[5]) + (v[6] * v[6] + v[7] * v[7]));
      }
    }
  } else {
    for (long long i = threadIdx.x; i < hw; i += kThreads) {
      const float v = to_f32(xp[i]);
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
    if constexpr (std::is_same_v<T, float>) {
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
      const uint4* xv = reinterpret_cast<const uint4*>(xp);
      uint4* yv = reinterpret_cast<uint4*>(yp);
      for (long long i = threadIdx.x; i < hw / 8; i += kThreads) {
        float v[8];
        unpack8(xv[i], v);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = fmaf(v[k], scale, shift);
        yv[i] = pack8(v);
      }
    }
  } else {
    for (long long i = threadIdx.x; i < hw; i += kThreads) {
      yp[i] = from_f32<T>(fmaf(to_f32(xp[i]), scale, shift));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
instance_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const float* __restrict__ gamma, const float* __restrict__ mean,
                         const float* __restrict__ rstd, T* __restrict__ dx,
                         float* __restrict__ sum_gxhat, float* __restrict__ sum_g,
                         int channels, long long hw) {
  constexpr int kVec = 16 / sizeof(T);
  const long long plane = blockIdx.x;
  const int c = static_cast<int>(plane % channels);
  const T* xp = x + plane * hw;
  const T* gp = g + plane * hw;
  T* dxp = dx + plane * hw;
  const float mu = mean[plane];
  const float rs = rstd[plane];
  const bool vec = (hw % kVec == 0) && aligned16(x) && aligned16(g) && aligned16(dx);

  float sg = 0.f, sgx = 0.f;
  if (vec) {
    if constexpr (std::is_same_v<T, float>) {
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
      const uint4* xv = reinterpret_cast<const uint4*>(xp);
      const uint4* gv = reinterpret_cast<const uint4*>(gp);
      for (long long i = threadIdx.x; i < hw / 8; i += kThreads) {
        float a[8], b[8];
        unpack8(xv[i], a);
        unpack8(gv[i], b);
        sg += ((b[0] + b[1]) + (b[2] + b[3])) + ((b[4] + b[5]) + (b[6] + b[7]));
        float p[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) p[k] = b[k] * ((a[k] - mu) * rs);
        sgx += ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]));
      }
    }
  } else {
    for (long long i = threadIdx.x; i < hw; i += kThreads) {
      const float b = to_f32(gp[i]);
      sg += b;
      sgx += b * ((to_f32(xp[i]) - mu) * rs);
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
    if constexpr (std::is_same_v<T, float>) {
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
      const uint4* xv = reinterpret_cast<const uint4*>(xp);
      const uint4* gv = reinterpret_cast<const uint4*>(gp);
      uint4* dv = reinterpret_cast<uint4*>(dxp);
      for (long long i = threadIdx.x; i < hw / 8; i += kThreads) {
        float a[8], b[8], o[8];
        unpack8(xv[i], a);
        unpack8(gv[i], b);
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = k * (b[j] - mg - ((a[j] - mu) * rs) * mgx);
        dv[i] = pack8(o);
      }
    }
  } else {
    for (long long i = threadIdx.x; i < hw; i += kThreads) {
      dxp[i] = from_f32<T>(k * (to_f32(gp[i]) - mg - ((to_f32(xp[i]) - mu) * rs) * mgx));
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

template <typename T>
int launch_forward(const T* x, const float* gamma, const float* beta, T* y, float* mean,
                   float* rstd, long long planes, int channels, long long hw, float eps,
                   void* stream) {
  instance_norm_kernel<T><<<static_cast<unsigned int>(planes), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(x, gamma, beta, y, mean, rstd,
                                                                 channels, hw, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const T* x, const T* g, const float* gamma, const float* mean,
                    const float* rstd, T* dx, float* dgamma, float* dbeta, float* scratch,
                    int batch, int channels, long long hw, void* stream) {
  const long long planes = static_cast<long long>(batch) * channels;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  instance_norm_bwd_kernel<T><<<static_cast<unsigned int>(planes), kThreads, 0, s>>>(
      x, g, gamma, mean, rstd, dx, scratch, scratch + planes, channels, hw);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int threads = 128;
  channel_sums_kernel<<<(channels + threads - 1) / threads, threads, 0, s>>>(
      scratch, scratch + planes, dgamma, dbeta, batch, channels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// planes = B * C. mean / rstd: (B * C) outputs, or both null when the caller
// needs no backward. Returns cudaGetLastError() after the launch.
extern "C" int shm_instance_norm_f32(const float* x, const float* gamma, const float* beta,
                                     float* y, float* mean, float* rstd, long long planes,
                                     int channels, long long hw, float eps, void* stream) {
  return launch_forward(x, gamma, beta, y, mean, rstd, planes, channels, hw, eps, stream);
}

// The same with x and y in bf16; gamma, beta, mean and rstd stay float.
extern "C" int shm_instance_norm_bf16(const __nv_bfloat16* x, const float* gamma,
                                      const float* beta, __nv_bfloat16* y, float* mean,
                                      float* rstd, long long planes, int channels, long long hw,
                                      float eps, void* stream) {
  return launch_forward(x, gamma, beta, y, mean, rstd, planes, channels, hw, eps, stream);
}

// The backward of shm_instance_norm_f32 for a (batch, channels, hw) tensor:
// dx, dgamma (channels), dbeta (channels); scratch holds 2 * batch * channels
// floats. Two launches on `stream`; returns cudaGetLastError() after them.
extern "C" int shm_instance_norm_bwd_f32(const float* x, const float* g, const float* gamma,
                                         const float* mean, const float* rstd, float* dx,
                                         float* dgamma, float* dbeta, float* scratch,
                                         int batch, int channels, long long hw, void* stream) {
  return launch_backward(x, g, gamma, mean, rstd, dx, dgamma, dbeta, scratch, batch, channels,
                         hw, stream);
}

// The same with x, g and dx in bf16; everything else stays float.
extern "C" int shm_instance_norm_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
                                          const float* gamma, const float* mean,
                                          const float* rstd, __nv_bfloat16* dx, float* dgamma,
                                          float* dbeta, float* scratch, int batch, int channels,
                                          long long hw, void* stream) {
  return launch_backward(x, g, gamma, mean, rstd, dx, dgamma, dbeta, scratch, batch, channels,
                         hw, stream);
}
