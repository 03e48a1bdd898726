// Fused ingest, f32: RGB -> YUV (TF's matrix), then per image multiply by
// 1 / scale with
//   scale = max(sqrt(max(E[v^2] - E[v]^2, 0)), 1/256)
// the moments taken over all H*W*3 YUV values of the image and no mean
// subtraction. Input (B, H, W, 3) NHWC in [0, 1]; outputs the standardised
// YUV (B, H, W, 3) and the per-image scale (B,).
//
// Replaces the TPU kernel shmgan_tpu/ops/pallas/preprocess.py (_kernel under
// fused_standardize_yuv(use_pallas=True)), which runs one program per image
// with the whole image in VMEM, and takes its one-pass moments and its
// multiply by 1 / scale.
//
// Bound: bytes, one read of the RGB and one write of the YUV (12.6 MB at
// (8, 256, 256, 3), 3.8 us at 3.35 TB/s); the arithmetic is ~25 flops a
// pixel. The design reads each byte once, in one launch:
//   - one thread-block cluster of K blocks owns one image (grid B * K), so the
//     moments are reduced inside the cluster through distributed shared
//     memory: no second launch, no global scratch, no atomics;
//   - resident variant: each block copies its contiguous run of the image
//     (whole pixels, 12 B each) into shared memory with 16-byte loads,
//     converts it to YUV there and sums its moments; it writes its partial
//     into a slot of every block's shared memory (DSMEM), and after one
//     cluster barrier each block adds the K partials in rank order from its
//     own shared memory (deterministic); it then scales its YUV and stores it
//     with 16-byte stores. Since every DSMEM access comes before that
//     barrier, no block has to wait for the others before it exits (reading
//     the partials remotely after the barrier measured slower on the H100,
//     and needs a second barrier before exit). The largest image the
//     resident variant takes is what the cluster's blocks hold within
//     the wrapper's budget of 231,424 B each, at 12 B a pixel in runs of 4:
//     16 x 19,284 = 308,544 pixels at K = 16 (555 x 555), 154,272 at K = 8
//     (392 x 392);
//   - streaming variant, for larger images: the same steps over 48 KB tiles
//     of the block's run, so the moments pass reads the RGB from device
//     memory and the store pass reads it again (the last tile of pass 1 is
//     still in shared memory and is not reloaded). With one cluster per image
//     it runs on 16 SMs an image.
// A run whose global address is not 16-byte aligned (an unaligned input, or
// every other image when H*W is odd) is copied with 4-byte accesses. The
// wrapper (ops/kernels/preprocess.py, _plan) picks the variant and K from the
// shape alone; the kernel takes any K from 1 to 16.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kInFlight = 8;  // loads a thread issues before it stores any

__device__ __forceinline__ void to_yuv(float r, float g, float b, float& y, float& u,
                                       float& v) {
  y = 0.299f * r + 0.587f * g + 0.114f * b;
  u = -0.14714119f * r + -0.28886916f * g + 0.43601035f * b;
  v = 0.61497538f * r + -0.51496512f * g + -0.10001026f * b;
}

__device__ __forceinline__ void add_moments(float y, float u, float v, float& s,
                                            float& s2) {
  s += (y + u) + v;
  s2 += (y * y + u * u) + v * v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums (a, b) over the block in a fixed order; every thread gets the totals.
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

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Copies n floats from device memory into the (16-byte aligned) tile.
__device__ void load_tile(float* __restrict__ tile, const float* __restrict__ src, int n) {
  if (aligned16(src)) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* t4 = reinterpret_cast<float4*>(tile);
    const int n4 = n >> 2;
    for (int i0 = threadIdx.x; i0 < n4; i0 += kThreads * kInFlight) {
      float4 r[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const int i = i0 + j * kThreads;
        if (i < n4) r[j] = __ldg(s4 + i);
      }
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const int i = i0 + j * kThreads;
        if (i < n4) t4[i] = r[j];
      }
    }
    for (int i = (n4 << 2) + threadIdx.x; i < n; i += kThreads) tile[i] = __ldg(src + i);
  } else {
    for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kInFlight) {
      float r[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const int i = i0 + j * kThreads;
        if (i < n) r[j] = __ldg(src + i);
      }
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) {
        const int i = i0 + j * kThreads;
        if (i < n) tile[i] = r[j];
      }
    }
  }
}

// Converts the tile's npx pixels to YUV in place and adds them to (s, s2).
// A thread takes four pixels (three float4 of shared memory) at a time.
__device__ void convert_tile(float* __restrict__ tile, int npx, float& s, float& s2) {
  float4* t4 = reinterpret_cast<float4*>(tile);
  const int groups = npx >> 2;
  for (int q = threadIdx.x; q < groups; q += kThreads) {
    float4 a = t4[3 * q], b = t4[3 * q + 1], c = t4[3 * q + 2];
    float y, u, v;
    to_yuv(a.x, a.y, a.z, y, u, v);
    add_moments(y, u, v, s, s2);
    a.x = y, a.y = u, a.z = v;
    to_yuv(a.w, b.x, b.y, y, u, v);
    add_moments(y, u, v, s, s2);
    a.w = y, b.x = u, b.y = v;
    to_yuv(b.z, b.w, c.x, y, u, v);
    add_moments(y, u, v, s, s2);
    b.z = y, b.w = u, c.x = v;
    to_yuv(c.y, c.z, c.w, y, u, v);
    add_moments(y, u, v, s, s2);
    c.y = y, c.z = u, c.w = v;
    t4[3 * q] = a, t4[3 * q + 1] = b, t4[3 * q + 2] = c;
  }
  for (int p = (groups << 2) + threadIdx.x; p < npx; p += kThreads) {
    float* px = tile + 3 * p;
    float y, u, v;
    to_yuv(px[0], px[1], px[2], y, u, v);
    add_moments(y, u, v, s, s2);
    px[0] = y, px[1] = u, px[2] = v;
  }
}

// Writes the tile's n floats, times inv = 1 / scale, to device memory.
__device__ void store_tile(float* __restrict__ dst, const float* __restrict__ tile, int n,
                           float inv) {
  if (aligned16(dst)) {
    const float4* t4 = reinterpret_cast<const float4*>(tile);
    float4* d4 = reinterpret_cast<float4*>(dst);
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      float4 v = t4[i];
      v.x *= inv, v.y *= inv, v.z *= inv, v.w *= inv;
      d4[i] = v;
    }
    for (int i = (n4 << 2) + threadIdx.x; i < n; i += kThreads) dst[i] = tile[i] * inv;
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = tile[i] * inv;
  }
}

// One cluster of K blocks per image; block `rank` owns pixels
// [rank * px_per_block, min((rank + 1) * px_per_block, npix)). px_per_block
// and tile_px are multiples of 4, so every range starts on a 48-byte
// boundary of its image. Resident: tile_px >= px_per_block.
template <bool kStream>
__global__ void __launch_bounds__(kThreads)
standardize_yuv(const float* __restrict__ rgb, float* __restrict__ yuv,
                float* __restrict__ scale_out, long long npix, int px_per_block,
                int tile_px) {
  extern __shared__ float4 smem[];
  float* tile = reinterpret_cast<float*>(smem);
  __shared__ float2 partials[16];  // slot r: block r's (sum, sum of squares)

  cg::cluster_group cluster = cg::this_cluster();
  // Half of a barrier that only says this block has started: no block may
  // touch another's shared memory before that one runs.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const unsigned int rank = cluster.block_rank();
  const unsigned int nrank = cluster.num_blocks();
  const long long img = blockIdx.x / nrank;
  const long long p0 = static_cast<long long>(rank) * px_per_block;
  const int npx = static_cast<int>(
      max(0LL, min(static_cast<long long>(px_per_block), npix - p0)));
  const long long off = (img * npix + p0) * 3;
  const float* src = rgb + off;
  float* dst = yuv + off;

  // Pass 1: RGB -> YUV in shared memory, and this block's moments.
  float s = 0.f, s2 = 0.f;
  if (kStream) {
    for (int t0 = 0; t0 < npx; t0 += tile_px) {
      const int n = min(tile_px, npx - t0);
      load_tile(tile, src + 3LL * t0, 3 * n);
      __syncthreads();
      convert_tile(tile, n, s, s2);
      __syncthreads();
    }
  } else {
    load_tile(tile, src, 3 * npx);
    __syncthreads();
    convert_tile(tile, npx, s, s2);
  }
  block_sum2(s, s2);
  // Lane r of warp 0 writes this block's partial into slot `rank` of block r
  // (DSMEM). After the barrier every block holds all K partials in its own
  // shared memory, and no block touches another's again, so none has to wait
  // for the others before it exits.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // all blocks run
  if (threadIdx.x < nrank)
    *cluster.map_shared_rank(&partials[rank], threadIdx.x) = make_float2(s, s2);
  cluster.sync();
  // Every thread adds the K partials in rank order: the same scale everywhere,
  // and the same from run to run.
  float ts = 0.f, ts2 = 0.f;
  for (unsigned int r = 0; r < nrank; ++r) {
    ts += partials[r].x;
    ts2 += partials[r].y;
  }
  const float n = 3.f * static_cast<float>(npix);
  const float mean = ts / n;
  const float var = fmaxf(ts2 / n - mean * mean, 0.f);
  const float scale = fmaxf(sqrtf(var), 1.f / 256.f);
  if (rank == 0 && threadIdx.x == 0) scale_out[img] = scale;
  const float inv = 1.f / scale;

  // Pass 2: scale and store. Streaming: last tile first, since it is still
  // in shared memory, then reload and convert the others.
  if (kStream) {
    const int ntiles = (npx + tile_px - 1) / tile_px;
    for (int k = ntiles - 1; k >= 0; --k) {
      const int t0 = k * tile_px;
      const int n = min(tile_px, npx - t0);
      if (k != ntiles - 1) {
        __syncthreads();  // the previous tile is stored
        load_tile(tile, src + 3LL * t0, 3 * n);
        __syncthreads();
        float unused_s = 0.f, unused_s2 = 0.f;
        convert_tile(tile, n, unused_s, unused_s2);
        __syncthreads();
      }
      store_tile(dst + 3LL * t0, tile, 3 * n, inv);
    }
  } else {
    store_tile(dst, tile, 3 * npx, inv);
  }
}

template <bool kStream>
cudaError_t configure() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, standardize_yuv<kStream>);
  if (err != cudaSuccess) return err;
  int dev = 0, optin = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(standardize_yuv<kStream>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attr.sharedSizeBytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(standardize_yuv<kStream>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaLaunchConfig_t launch_config(long long batch, int cluster, long long smem_bytes,
                                 cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned int>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(batch * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Sets both variants' shared-memory limit (the device's opt-in maximum less
// their static shared memory) and allows clusters of 16 on the current
// device. cudaFuncSetAttribute holds for the device current when it runs, so
// the wrapper calls this once on each device before its first launch there.
extern "C" int shm_standardize_yuv_init(void) {
  cudaError_t err = configure<false>();
  if (err == cudaSuccess) err = configure<true>();
  return static_cast<int>(err);
}

// rgb and yuv (batch, npix, 3); scale (batch,). One launch of batch clusters
// of `cluster` blocks with smem_bytes of dynamic shared memory each. Returns
// the launch's error, then cudaGetLastError(): a refused launch never runs.
extern "C" int shm_standardize_yuv_f32(const float* rgb, float* yuv, float* scale,
                                       long long batch, long long npix, int cluster,
                                       int px_per_block, int tile_px,
                                       long long smem_bytes, int streaming,
                                       void* stream) {
  if (batch <= 0 || cluster <= 0 || cluster > 16 || batch * cluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(batch, cluster, smem_bytes, static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t err =
      streaming ? cudaLaunchKernelEx(&cfg, standardize_yuv<true>, rgb, yuv, scale, npix,
                                     px_per_block, tile_px)
                : cudaLaunchKernelEx(&cfg, standardize_yuv<false>, rgb, yuv, scale, npix,
                                     px_per_block, tile_px);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// How many clusters of `cluster` blocks with smem_bytes each the device can
// run at once (cudaOccupancyMaxActiveClusters), into *count.
extern "C" int shm_standardize_yuv_max_active_clusters(int cluster, long long smem_bytes,
                                                       int streaming, int* count) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, cluster, smem_bytes, nullptr, &attr);
  const cudaError_t err =
      streaming ? cudaOccupancyMaxActiveClusters(count, standardize_yuv<true>, &cfg)
                : cudaOccupancyMaxActiveClusters(count, standardize_yuv<false>, &cfg);
  return static_cast<int>(err);
}
