// Fused ingest, f32: RGB -> YUV (TF's matrix), then per image divide by
//   scale = max(sqrt(max(E[v^2] - E[v]^2, 0)), 1/256)
// with the moments taken over all H*W*3 YUV values of the image and no mean
// subtraction. Input (B, H, W, 3) NHWC in [0, 1]; outputs the standardised
// YUV (B, H, W, 3) and the per-image scale (B,).
//
// Replaces the TPU kernel shmgan_tpu/ops/pallas/preprocess.py (_kernel under
// fused_standardize_yuv(use_pallas=True)), which runs one program per image.
// One block per image would leave most of the 132 SMs idle at batch 8, so
// each image is split over `nblk` blocks in two launches:
//   pass 1: each block writes its partial (sum, sum of squares) to scratch;
//   pass 2: each block reduces all partials of its image in a fixed order
//           (deterministic, no float atomics), then converts and divides
//           its own pixels. Block 0 of each image writes the scale.
// The colour transform is recomputed in pass 2 instead of stored, so device
// memory sees the RGB twice and the YUV once.
//
// Bound: memory, and tiny. At (8, 256, 256, 3) the function must move
// 12.6 MB (one read, one write), about 4 us at 3.35 TB/s; launch latency is
// of the same order.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void to_yuv(const float* p, float& y, float& u, float& v) {
  const float r = p[0], g = p[1], b = p[2];
  y = 0.299f * r + 0.587f * g + 0.114f * b;
  u = -0.14714119f * r + -0.28886916f * g + 0.43601035f * b;
  v = 0.61497538f * r + -0.51496512f * g + -0.10001026f * b;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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
  for (int w = 0; w < kThreads / 32; ++w) {
    a += sa[w];
    b += sb[w];
  }
}

__global__ void __launch_bounds__(kThreads)
partial_moments(const float* __restrict__ rgb, float* __restrict__ partials,
                long long npix, long long chunk) {
  const int nblk = gridDim.x;
  const long long img = blockIdx.y;
  const long long p0 = blockIdx.x * chunk;
  const long long p1 = min(p0 + chunk, npix);
  const float* base = rgb + img * npix * 3;
  float s = 0.f, s2 = 0.f;
  for (long long p = p0 + threadIdx.x; p < p1; p += kThreads) {
    float y, u, v;
    to_yuv(base + p * 3, y, u, v);
    s += (y + u) + v;
    s2 += (y * y + u * u) + v * v;
  }
  block_sum2(s, s2);
  if (threadIdx.x == 0) {
    partials[(img * nblk + blockIdx.x) * 2] = s;
    partials[(img * nblk + blockIdx.x) * 2 + 1] = s2;
  }
}

__global__ void __launch_bounds__(kThreads)
standardize(const float* __restrict__ rgb, const float* __restrict__ partials,
            float* __restrict__ yuv, float* __restrict__ scale_out, long long npix,
            long long chunk) {
  const int nblk = gridDim.x;
  const long long img = blockIdx.y;
  float s = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < nblk; i += kThreads) {
    s += partials[(img * nblk + i) * 2];
    s2 += partials[(img * nblk + i) * 2 + 1];
  }
  block_sum2(s, s2);
  const float n = 3.f * static_cast<float>(npix);
  const float mean = s / n;
  const float var = fmaxf(s2 / n - mean * mean, 0.f);
  const float scale = fmaxf(sqrtf(var), 1.f / 256.f);
  if (blockIdx.x == 0 && threadIdx.x == 0) scale_out[img] = scale;

  const long long p0 = blockIdx.x * chunk;
  const long long p1 = min(p0 + chunk, npix);
  const float* in = rgb + img * npix * 3;
  float* out = yuv + img * npix * 3;
  for (long long p = p0 + threadIdx.x; p < p1; p += kThreads) {
    float y, u, v;
    to_yuv(in + p * 3, y, u, v);
    out[p * 3] = y / scale;
    out[p * 3 + 1] = u / scale;
    out[p * 3 + 2] = v / scale;
  }
}

}  // namespace

// rgb (batch, npix, 3); partials (batch, nblk, 2) scratch; yuv like rgb;
// scale (batch,). Returns cudaGetLastError() after the two launches.
extern "C" int shm_standardize_yuv_f32(const float* rgb, float* partials, float* yuv,
                                       float* scale, int batch, long long npix, int nblk,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long chunk = (npix + nblk - 1) / nblk;
  const dim3 grid(static_cast<unsigned int>(nblk), static_cast<unsigned int>(batch));
  partial_moments<<<grid, kThreads, 0, st>>>(rgb, partials, npix, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  standardize<<<grid, kThreads, 0, st>>>(rgb, partials, yuv, scale, npix, chunk);
  return static_cast<int>(cudaGetLastError());
}
