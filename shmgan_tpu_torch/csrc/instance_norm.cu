// Instance normalisation, NCHW, forward and backward, for float32 and
// bfloat16 activations.
//
// Forward: y = (x - mean[b,c]) * scale[b,c] + beta[c] with
//   mean = E[x], var = E[(x - mean)^2] over one (b, c) plane of H*W,
//   scale = gamma[c] * rsqrt(var + eps);
// on request it also writes each plane's mean and rstd = rsqrt(var + eps).
// The moments are taken in one pass, as the TPU kernel takes them, but not
// as E[x^2] - mean^2: each thread keeps a count, mean and sum of squared
// deviations, folding in one 16-byte load at a time, and the block merges
// the threads' (Chan et al.'s pairwise update). x - mean is formed before
// the affine, where the TPU kernel writes x * scale + (beta - mean * scale).
// In f32 E[x^2] - mean^2 loses the variance of a plane whose mean is large
// against its spread (a flat image region), more so over the 3072-long
// per-thread sums of a 2048x1536 plane, and the two large products of the
// TPU kernel's affine lose its output.
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
// the activation is NCHW, so each (b, c) plane is contiguous: no cross-block
// reduction inside a plane except within one thread-block cluster, and no
// atomics.
//
// Bound: memory. The forward does ~8 flops (and a division a 16-byte load)
// against 8 bytes per element in f32 (one read, one write) and 4 in bf16,
// the backward ~10 against 12 in f32 (x and g read, dx written) and 6 in
// bf16, far below the card's ~20 flops/byte balance point in f32. Loads and
// stores are 16 bytes a thread (4 floats or 8 bf16) when H*W allows it; when
// a base is not 16-byte aligned the same 16 bytes move one element at a time.
//
// Forward: one 256-thread block per plane, two passes over it: pass 1
// merges the threads' moments with warp shuffles, then shared memory
// across warps; pass 2 reads again and writes. The second read hits L2 only
// while the planes in flight fit the 50 MB L2.
//
// Backward: each thread loads its share of x and g once, keeps it in
// registers while the plane's two sums are reduced, and computes and stores
// dx from those registers, so x and g are read from device memory once and
// dx written once. The wrapper (ops/kernels/instance_norm.py, _bwd_plan)
// picks one of three variants from the shape alone and passes the plan in;
// the launch refuses a plan it cannot run (cudaErrorInvalidValue):
//   - packed, planes of up to 256 elements (16x16, 8x8, 4x4 in the train
//     step): `lanes` consecutive threads (a power of 2, at most 32) own one
//     plane, so one warp holds 32 / lanes planes and a 256-thread block
//     256 / lanes of them; the plane's sums are a butterfly of
//     __shfl_xor_sync over offsets lanes/2 .. 1, which stays inside the
//     plane's segment of the warp, with no block barrier. One block per
//     plane spent two barriers on 16 elements, in up to 81,920 blocks;
//   - resident, larger planes whose H*W is a multiple of 16 bytes and whose
//     x fits 2 x 512 threads x 4 chunks of 16 bytes (128x128 in f32, 32,768
//     elements in bf16): a block of 64 to 512 threads, or a cluster of 2
//     blocks of 512, holds the plane; the sums go through shared memory
//     across warps and, in a cluster, through distributed shared memory,
//     where each block writes its partial into a slot of every block and,
//     after one cluster barrier, adds the slots in rank order (as
//     csrc/preprocess.cu). Two blocks of 512 fit on an SM (64 registers a
//     thread);
//   - streaming, anything larger (or larger than 256 elements with H*W not a
//     multiple of 16 bytes): one 256-thread block per plane in two passes,
//     which reads x and g twice.
// dgamma and dbeta: each plane's two sums go into a (B, C) scratch; a
// second, small launch adds the B rows of each channel in order. Every sum
// is taken in a fixed order: repeat calls are bit-identical.
#include <climits>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

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

// Running moments: count, mean, and sum of squared deviations (M2).
struct Moments {
  float n, mean, m2;
};

// Folds moments b into a (Chan et al.): exact in the counts, and no
// cancellation between large sums whatever the mean.
__device__ __forceinline__ void merge(Moments& a, float nb, float mb, float m2b) {
  const float n = a.n + nb;
  if (n == 0.f) return;
  const float w = __fdividef(nb, n);  // within 2 ulp: a weight, not a result
  const float delta = mb - a.mean;
  a.mean = fmaf(delta, w, a.mean);
  a.m2 += m2b + delta * delta * a.n * w;
  a.n = n;
}

// Folds k values (one 16-byte load) into a.
template <int k>
__device__ __forceinline__ void fold(Moments& a, const float (&v)[k]) {
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < k; ++j) sum += v[j];
  const float mean = sum * (1.f / k);
  float m2 = 0.f;
#pragma unroll
  for (int j = 0; j < k; ++j) m2 = fmaf(v[j] - mean, v[j] - mean, m2);
  merge(a, static_cast<float>(k), mean, m2);
}

// Merges the moments over the block, in the same order in every thread,
// which gets the totals.
__device__ __forceinline__ void block_moments(Moments& a) {
  __shared__ float sn[kThreads / 32], sm[kThreads / 32], sq[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float n = __shfl_xor_sync(0xffffffffu, a.n, o);
    const float m = __shfl_xor_sync(0xffffffffu, a.mean, o);
    const float q = __shfl_xor_sync(0xffffffffu, a.m2, o);
    merge(a, n, m, q);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    sn[warp] = a.n;
    sm[warp] = a.mean;
    sq[warp] = a.m2;
  }
  __syncthreads();
  a = Moments{0.f, 0.f, 0.f};
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) merge(a, sn[w], sm[w], sq[w]);
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

  Moments acc{0.f, 0.f, 0.f};
  if (vec) {
    if constexpr (std::is_same_v<T, float>) {
      const float4* xv = reinterpret_cast<const float4*>(xp);
      for (long long i = threadIdx.x; i < hw / 4; i += kThreads) {
        const float4 v = xv[i];
        const float w[4] = {v.x, v.y, v.z, v.w};
        fold<4>(acc, w);
      }
    } else {
      const uint4* xv = reinterpret_cast<const uint4*>(xp);
      for (long long i = threadIdx.x; i < hw / 8; i += kThreads) {
        float v[8];
        unpack8(xv[i], v);
        fold<8>(acc, v);
      }
    }
  } else {
    for (long long i = threadIdx.x; i < hw; i += kThreads) {
      const float w[1] = {to_f32(xp[i])};
      fold<1>(acc, w);
    }
  }
  block_moments(acc);

  const float mean = acc.mean;
  const float var = fmaxf(acc.m2 / static_cast<float>(hw), 0.f);
  const float rstd = rsqrtf(var + eps);
  const float scale = gamma[c] * rstd;
  const float bias = beta[c];
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
        v.x = fmaf(v.x - mean, scale, bias);
        v.y = fmaf(v.y - mean, scale, bias);
        v.z = fmaf(v.z - mean, scale, bias);
        v.w = fmaf(v.w - mean, scale, bias);
        yv[i] = v;
      }
    } else {
      const uint4* xv = reinterpret_cast<const uint4*>(xp);
      uint4* yv = reinterpret_cast<uint4*>(yp);
      for (long long i = threadIdx.x; i < hw / 8; i += kThreads) {
        float v[8];
        unpack8(xv[i], v);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = fmaf(v[k] - mean, scale, bias);
        yv[i] = pack8(v);
      }
    }
  } else {
    for (long long i = threadIdx.x; i < hw; i += kThreads) {
      yp[i] = from_f32<T>(fmaf(to_f32(xp[i]) - mean, scale, bias));
    }
  }
}

// ---------------------------------------------------------------- backward

// The plan's variant, as the wrapper passes it.
enum Variant { kPacked = 0, kResident = 1, kStreaming = 2 };

constexpr int kPackedThreads = 256;    // threads of a packed block, at most
constexpr int kPackedElems = 8;        // elements of x (and of g) a packed lane holds, at most
constexpr int kResidentThreads = 512;  // threads of a resident block, at most
constexpr int kResidentChunks = 4;     // 16-byte chunks of x (and of g) a resident thread holds
constexpr int kResidentMaxCluster = 2;

// 16 bytes of T at p, as raw bits: one vector load where every base is
// 16-byte aligned, else one element at a time.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, bool aligned) {
  if (aligned) return __ldg(reinterpret_cast<const uint4*>(p));
  unsigned int w[4];
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __float_as_uint(__ldg(p + k));
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = static_cast<unsigned int>(__ldg(s + 2 * k)) |
             (static_cast<unsigned int>(__ldg(s + 2 * k + 1)) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const uint4 u, bool aligned) {
  if (aligned) {
    *reinterpret_cast<uint4*>(p) = u;
    return;
  }
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = __uint_as_float(w[k]);
  } else {
    unsigned short* s = reinterpret_cast<unsigned short*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s[2 * k] = static_cast<unsigned short>(w[k]);
      s[2 * k + 1] = static_cast<unsigned short>(w[k] >> 16);
    }
  }
}

__device__ __forceinline__ float tree_sum(const float (&v)[1]) { return v[0]; }
__device__ __forceinline__ float tree_sum(const float (&v)[4]) {
  return (v[0] + v[1]) + (v[2] + v[3]);
}
__device__ __forceinline__ float tree_sum(const float (&v)[8]) {
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
}

// One chunk of a plane as a thread keeps it in registers: 16 bytes of raw
// bits (4 floats or 8 bf16) in the vector form, one element widened to float
// in the scalar form (H*W not a multiple of 16 bytes).
template <typename T, bool kVector>
struct Chunk {
  static constexpr int kW = kVector ? 16 / static_cast<int>(sizeof(T)) : 1;  // elements
  using Raw = std::conditional_t<kVector, uint4, float>;

  static __device__ __forceinline__ Raw load(const T* p, bool aligned) {
    if constexpr (kVector) {
      return load16(p, aligned);
    } else {
      return to_f32(*p);
    }
  }
  static __device__ __forceinline__ void store(T* p, Raw r, bool aligned) {
    if constexpr (kVector) {
      store16(p, r, aligned);
    } else {
      *p = from_f32<T>(r);
    }
  }
  static __device__ __forceinline__ void unpack(Raw r, float (&v)[kW]) {
    if constexpr (!kVector) {
      v[0] = r;
    } else if constexpr (std::is_same_v<T, float>) {
      v[0] = __uint_as_float(r.x), v[1] = __uint_as_float(r.y);
      v[2] = __uint_as_float(r.z), v[3] = __uint_as_float(r.w);
    } else {
      unpack8(r, v);
    }
  }
  static __device__ __forceinline__ Raw pack(const float (&v)[kW]) {
    if constexpr (!kVector) {
      return v[0];
    } else if constexpr (std::is_same_v<T, float>) {
      return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                        __float_as_uint(v[3]));
    } else {
      return pack8(v);
    }
  }
};

// Adds one chunk's g and g * xhat to (sg, sgx): each chunk summed as a tree
// in element order, the chunks in the order a thread holds them.
template <typename C>
__device__ __forceinline__ void add_chunk(typename C::Raw xr, typename C::Raw gr, float mu,
                                          float rs, float& sg, float& sgx) {
  float a[C::kW], b[C::kW], p[C::kW];
  C::unpack(xr, a);
  C::unpack(gr, b);
#pragma unroll
  for (int k = 0; k < C::kW; ++k) p[k] = b[k] * ((a[k] - mu) * rs);
  sg += tree_sum(b);
  sgx += tree_sum(p);
}

// dx of one chunk: k * (g - mean(g) - xhat * mean(g * xhat)), k = gamma * rstd.
template <typename C>
__device__ __forceinline__ typename C::Raw dx_chunk(typename C::Raw xr, typename C::Raw gr,
                                                    float mu, float rs, float k, float mg,
                                                    float mgx) {
  float a[C::kW], b[C::kW], o[C::kW];
  C::unpack(xr, a);
  C::unpack(gr, b);
#pragma unroll
  for (int j = 0; j < C::kW; ++j) o[j] = k * (b[j] - mg - ((a[j] - mu) * rs) * mgx);
  return C::pack(o);
}

// Packed: thread t of the grid is lane t % lanes of plane t / lanes, and
// lane l holds chunks l, l + lanes, ... of its plane (at most kPackedElems
// elements of x and of g). Every thread of a warp takes part in the
// butterfly, those past the last plane with zeros.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kPackedThreads)
instance_norm_bwd_packed(const T* __restrict__ x, const T* __restrict__ g,
                         const float* __restrict__ gamma, const float* __restrict__ mean,
                         const float* __restrict__ rstd, T* __restrict__ dx,
                         float* __restrict__ sum_gxhat, float* __restrict__ sum_g,
                         long long planes, int channels, int hw, int lanes) {
  using C = Chunk<T, kVector>;
  constexpr int kChunks = kPackedElems / C::kW;
  const int nchunks = hw / C::kW;
  const int lane = threadIdx.x & (lanes - 1);
  const long long plane =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / lanes;
  const bool live = plane < planes;
  const bool aligned = aligned16(x) && aligned16(g) && aligned16(dx);
  const long long off = plane * hw;

  float mu = 0.f, rs = 0.f;
  typename C::Raw xs[kChunks], gs[kChunks];
  if (live) {
    mu = mean[plane];
    rs = rstd[plane];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int j = lane + k * lanes;
      if (j < nchunks) {
        xs[k] = C::load(x + off + j * C::kW, aligned);
        gs[k] = C::load(g + off + j * C::kW, aligned);
      }
    }
  }
  float sg = 0.f, sgx = 0.f;
  if (live) {
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if (lane + k * lanes < nchunks) add_chunk<C>(xs[k], gs[k], mu, rs, sg, sgx);
    }
  }
  for (int o = lanes >> 1; o > 0; o >>= 1) {
    sg += __shfl_xor_sync(0xffffffffu, sg, o);
    sgx += __shfl_xor_sync(0xffffffffu, sgx, o);
  }
  if (!live) return;
  if (lane == 0) {
    sum_g[plane] = sg;
    sum_gxhat[plane] = sgx;
  }

  const float inv_n = 1.f / static_cast<float>(hw);
  const float k = gamma[plane % channels] * rs;
  const float mg = sg * inv_n;
  const float mgx = sgx * inv_n;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int j = lane + c * lanes;
    if (j < nchunks)
      C::store(dx + off + j * C::kW, dx_chunk<C>(xs[c], gs[c], mu, rs, k, mg, mgx), aligned);
  }
}

// Resident: block `rank` of the plane's cluster (rank 0 without one) owns
// chunks [rank * run, min((rank + 1) * run, H*W / kW)) of it, and its thread
// t holds chunks t, t + blockDim.x, ... of that run, at most kResidentChunks.
template <typename T, bool kCluster>
__global__ void __launch_bounds__(kResidentThreads, 2)
instance_norm_bwd_resident(const T* __restrict__ x, const T* __restrict__ g,
                           const float* __restrict__ gamma, const float* __restrict__ mean,
                           const float* __restrict__ rstd, T* __restrict__ dx,
                           float* __restrict__ sum_gxhat, float* __restrict__ sum_g,
                           int channels, int hw, int run) {
  using C = Chunk<T, true>;
  __shared__ float2 warp_sums[kResidentThreads / 32];
  __shared__ float2 partials[kResidentMaxCluster];  // slot r: block r's sums

  unsigned int rank = 0, nrank = 1;
  if constexpr (kCluster) {
    // Half of a barrier that only says this block has started: no block may
    // touch another's shared memory before that one runs.
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    cg::cluster_group cluster = cg::this_cluster();
    rank = cluster.block_rank();
    nrank = cluster.num_blocks();
  }
  const long long plane = blockIdx.x / nrank;
  const int first = static_cast<int>(rank) * run;
  const int n = min(run, hw / C::kW - first);
  const long long off = plane * hw + static_cast<long long>(first) * C::kW;
  const bool aligned = aligned16(x) && aligned16(g) && aligned16(dx);
  const float mu = mean[plane];
  const float rs = rstd[plane];

  uint4 xs[kResidentChunks], gs[kResidentChunks];
#pragma unroll
  for (int k = 0; k < kResidentChunks; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n) {
      xs[k] = C::load(x + off + i * C::kW, aligned);
      gs[k] = C::load(g + off + i * C::kW, aligned);
    }
  }
  float sg = 0.f, sgx = 0.f;
#pragma unroll
  for (int k = 0; k < kResidentChunks; ++k) {
    if (threadIdx.x + k * blockDim.x < n) add_chunk<C>(xs[k], gs[k], mu, rs, sg, sgx);
  }
  sg = warp_sum(sg);
  sgx = warp_sum(sgx);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = make_float2(sg, sgx);
  __syncthreads();
  sg = 0.f;
  sgx = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {  // same order everywhere
    sg += warp_sums[w].x;
    sgx += warp_sums[w].y;
  }
  if constexpr (kCluster) {
    // Thread r writes this block's sums into slot `rank` of block r (DSMEM);
    // after the barrier each block reads only its own shared memory, so none
    // has to wait for the others before it exits.
    cg::cluster_group cluster = cg::this_cluster();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // all blocks run
    if (threadIdx.x < nrank)
      *cluster.map_shared_rank(&partials[rank], threadIdx.x) = make_float2(sg, sgx);
    cluster.sync();
    sg = 0.f;
    sgx = 0.f;
    for (unsigned int r = 0; r < nrank; ++r) {
      sg += partials[r].x;
      sgx += partials[r].y;
    }
  }
  if (rank == 0 && threadIdx.x == 0) {
    sum_g[plane] = sg;
    sum_gxhat[plane] = sgx;
  }

  const float inv_n = 1.f / static_cast<float>(hw);
  const float k = gamma[plane % channels] * rs;
  const float mg = sg * inv_n;
  const float mgx = sgx * inv_n;
#pragma unroll
  for (int c = 0; c < kResidentChunks; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    if (i < n)
      C::store(dx + off + i * C::kW, dx_chunk<C>(xs[c], gs[c], mu, rs, k, mg, mgx), aligned);
  }
}

// Streaming: one 256-thread block per plane, two passes. Pass 1 reduces
// (sum g, sum g * xhat); pass 2 reads x and g again and writes dx.
template <typename T>
__global__ void __launch_bounds__(kThreads)
instance_norm_bwd_streaming(const T* __restrict__ x, const T* __restrict__ g,
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

// The plan is valid for this shape: the kernel it names covers every element
// of every plane once, within its registers.
template <typename T>
bool valid_plan(long long planes, long long hw, int variant, int lanes, int threads,
                int cluster) {
  constexpr long long kVec = 16 / sizeof(T);
  if (planes <= 0 || hw <= 0 || threads < 32 || threads % 32 != 0) return false;
  switch (variant) {
    case kPacked: {
      const bool vec = hw % kVec == 0;
      const long long nchunks = vec ? hw / kVec : hw;
      const long long per_lane = vec ? kPackedElems / kVec : kPackedElems;
      return lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0 &&
             threads <= kPackedThreads && cluster == 1 && nchunks <= lanes * per_lane &&
             (planes * lanes + threads - 1) / threads <= INT_MAX;
    }
    case kResident: {
      if (hw % kVec != 0 || cluster < 1 || cluster > kResidentMaxCluster ||
          threads > kResidentThreads || lanes != threads * cluster ||
          planes * cluster > INT_MAX)
        return false;
      const long long nchunks = hw / kVec;
      const long long run = (nchunks + cluster - 1) / cluster;
      return run <= static_cast<long long>(threads) * kResidentChunks &&
             (cluster - 1) * run < nchunks;
    }
    case kStreaming:
      return threads == kThreads && lanes == kThreads && cluster == 1 && planes <= INT_MAX;
    default:
      return false;
  }
}

template <typename T>
int launch_backward(const T* x, const T* g, const float* gamma, const float* mean,
                    const float* rstd, T* dx, float* dgamma, float* dbeta, float* scratch,
                    int batch, int channels, long long hw, int variant, int lanes, int threads,
                    int cluster, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long planes = static_cast<long long>(batch) * channels;
  if (batch <= 0 || channels <= 0 || !valid_plan<T>(planes, hw, variant, lanes, threads, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sum_gxhat = scratch;
  float* sum_g = scratch + planes;
  cudaError_t err = cudaSuccess;
  if (variant == kPacked) {
    const unsigned int blocks = static_cast<unsigned int>((planes * lanes + threads - 1) / threads);
    if (hw % kVec == 0)
      instance_norm_bwd_packed<T, true><<<blocks, threads, 0, s>>>(
          x, g, gamma, mean, rstd, dx, sum_gxhat, sum_g, planes, channels,
          static_cast<int>(hw), lanes);
    else
      instance_norm_bwd_packed<T, false><<<blocks, threads, 0, s>>>(
          x, g, gamma, mean, rstd, dx, sum_gxhat, sum_g, planes, channels,
          static_cast<int>(hw), lanes);
  } else if (variant == kResident) {
    const int run = static_cast<int>((hw / kVec + cluster - 1) / cluster);
    if (cluster == 1) {
      instance_norm_bwd_resident<T, false><<<static_cast<unsigned int>(planes), threads, 0, s>>>(
          x, g, gamma, mean, rstd, dx, sum_gxhat, sum_g, channels, static_cast<int>(hw), run);
    } else {
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = static_cast<unsigned int>(cluster);
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(static_cast<unsigned int>(planes * cluster));
      cfg.blockDim = dim3(threads);
      cfg.dynamicSmemBytes = 0;
      cfg.stream = s;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      err = cudaLaunchKernelEx(&cfg, instance_norm_bwd_resident<T, true>, x, g, gamma, mean,
                               rstd, dx, sum_gxhat, sum_g, channels, static_cast<int>(hw), run);
    }
  } else {
    instance_norm_bwd_streaming<T><<<static_cast<unsigned int>(planes), kThreads, 0, s>>>(
        x, g, gamma, mean, rstd, dx, sum_gxhat, sum_g, channels, hw);
  }
  const cudaError_t last = cudaGetLastError();
  if (err == cudaSuccess) err = last;
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sum_threads = 128;
  channel_sums_kernel<<<(channels + sum_threads - 1) / sum_threads, sum_threads, 0, s>>>(
      sum_gxhat, sum_g, dgamma, dbeta, batch, channels);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the plan's kernel that fit on one SM at once.
template <typename T>
int backward_blocks_per_sm(int variant, int vector, int threads, int cluster, int* count) {
  cudaError_t err = cudaErrorInvalidValue;
  if (variant == kPacked)
    err = vector ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       count, instance_norm_bwd_packed<T, true>, threads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       count, instance_norm_bwd_packed<T, false>, threads, 0);
  else if (variant == kResident)
    err = cluster > 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            count, instance_norm_bwd_resident<T, true>, threads, 0)
                      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            count, instance_norm_bwd_resident<T, false>, threads, 0);
  else if (variant == kStreaming)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        count, instance_norm_bwd_streaming<T>, threads, 0);
  return static_cast<int>(err);
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
// floats. The plan: variant (0 packed, 1 resident, 2 streaming), the threads
// that own one plane (lanes), threads per block, blocks per plane (cluster).
// Two launches on `stream`. Returns cudaErrorInvalidValue, launching nothing,
// for a plan the kernels cannot run at this shape; else the first launch's
// error, or cudaGetLastError() after the second.
extern "C" int shm_instance_norm_bwd_f32(const float* x, const float* g, const float* gamma,
                                         const float* mean, const float* rstd, float* dx,
                                         float* dgamma, float* dbeta, float* scratch,
                                         int batch, int channels, long long hw, int variant,
                                         int lanes, int threads, int cluster, void* stream) {
  return launch_backward(x, g, gamma, mean, rstd, dx, dgamma, dbeta, scratch, batch, channels,
                         hw, variant, lanes, threads, cluster, stream);
}

// The same with x, g and dx in bf16; everything else stays float.
extern "C" int shm_instance_norm_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g,
                                          const float* gamma, const float* mean,
                                          const float* rstd, __nv_bfloat16* dx, float* dgamma,
                                          float* dbeta, float* scratch, int batch, int channels,
                                          long long hw, int variant, int lanes, int threads,
                                          int cluster, void* stream) {
  return launch_backward(x, g, gamma, mean, rstd, dx, dgamma, dbeta, scratch, batch, channels,
                         hw, variant, lanes, threads, cluster, stream);
}

// cudaOccupancyMaxActiveBlocksPerMultiprocessor of the backward kernel a plan
// launches (vector: H*W a multiple of 16 bytes), into *count.
extern "C" int shm_instance_norm_bwd_blocks_per_sm(int bf16, int variant, int vector,
                                                   int threads, int cluster, int* count) {
  return bf16 ? backward_blocks_per_sm<__nv_bfloat16>(variant, vector, threads, cluster, count)
              : backward_blocks_per_sm<float>(variant, vector, threads, cluster, count);
}

// ------------------------------------------------------------------ bands
//
// Instance norm of a map cut into bands of rows over the ranks of a model
// row (parallel/spatial.py): each rank holds rows of every (b, c) plane, and
// no rank holds a whole plane. Forward in two launches around a gather:
//   moments  each plane's band: mean and M2 (the forward's per-thread
//            Welford and block merge), into (2, planes);
//   (the ranks' (2, planes) gathered into (M, 2, planes), rank order)
//   apply    each block merges the M partials of its plane in rank order
//            (Chan et al.'s pairwise update, every band the same count), then
//            y = (x - mean) * gamma * rstd + beta as the forward, and writes
//            the plane's mean and rstd.
// Never E[x^2] - E[x]^2 across ranks: a flat plane cancels in that.
// Backward in two launches around an all_reduce:
//   sums     each plane's band: sum of g and of g * xhat, into (2, planes);
//   (the ranks' sums added in float over the row)
//   apply    dx = rstd / n * (n * g * gamma - gamma * sum(g) - xhat * gamma
//            * sum(g * xhat)), n the whole plane's count, as the TPU kernel's
//            VJP (_bwd); the blocks of batch row 0 also add each channel's
//            band sums over the batch, in order: dgamma and dbeta of this
//            band, which the train step sums over the row with the other
//            gradients.
// One 256-thread block a plane in every launch: simple, and correct at any
// band; the moments and apply launches take 16-byte loads where the plane
// allows them, the backward's one element at a time.

namespace {

// Folds the partial (nb, mb, m2b) into a in rank order; the first is copied,
// so that a row of one band is that band's moments exactly.
__device__ __forceinline__ void merge_band(Moments& a, float nb, float mb, float m2b) {
  if (a.n == 0.f) {
    a = Moments{nb, mb, m2b};
    return;
  }
  const float n = a.n + nb;
  const float delta = mb - a.mean;
  a.mean = fmaf(delta, nb / n, a.mean);
  a.m2 += m2b + delta * delta * (a.n * nb / n);
  a.n = n;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_moments_kernel(const T* __restrict__ x, float* __restrict__ out, long long planes,
                    long long hw) {
  constexpr int kVec = 16 / sizeof(T);
  const long long plane = blockIdx.x;
  const T* xp = x + plane * hw;
  const bool vec = (hw % kVec == 0) && aligned16(x);
  Moments acc{0.f, 0.f, 0.f};
  if (vec) {
    if constexpr (std::is_same_v<T, float>) {
      const float4* xv = reinterpret_cast<const float4*>(xp);
      for (long long i = threadIdx.x; i < hw / 4; i += kThreads) {
        const float4 v = xv[i];
        const float w[4] = {v.x, v.y, v.z, v.w};
        fold<4>(acc, w);
      }
    } else {
      const uint4* xv = reinterpret_cast<const uint4*>(xp);
      for (long long i = threadIdx.x; i < hw / 8; i += kThreads) {
        float v[8];
        unpack8(xv[i], v);
        fold<8>(acc, v);
      }
    }
  } else {
    for (long long i = threadIdx.x; i < hw; i += kThreads) {
      const float w[1] = {to_f32(xp[i])};
      fold<1>(acc, w);
    }
  }
  block_moments(acc);
  if (threadIdx.x == 0) {
    out[plane] = acc.mean;
    out[planes + plane] = acc.m2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_apply_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, const float* __restrict__ parts, int nparts,
                  long long planes, int channels, long long hw, float eps, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out) {
  constexpr int kVec = 16 / sizeof(T);
  const long long plane = blockIdx.x;
  const int c = static_cast<int>(plane % channels);
  const T* xp = x + plane * hw;
  T* yp = y + plane * hw;
  const bool vec = (hw % kVec == 0) && aligned16(x) && aligned16(y);

  Moments acc{0.f, 0.f, 0.f};
  for (int r = 0; r < nparts; ++r)  // the same order in every thread
    merge_band(acc, static_cast<float>(hw), parts[(2LL * r) * planes + plane],
               parts[(2LL * r + 1) * planes + plane]);
  const float mean = acc.mean;
  const float var = fmaxf(acc.m2 / acc.n, 0.f);
  const float rstd = rsqrtf(var + eps);
  const float scale = gamma[c] * rstd;
  const float bias = beta[c];
  if (threadIdx.x == 0) {
    mean_out[plane] = mean;
    rstd_out[plane] = rstd;
  }
  if (vec) {
    if constexpr (std::is_same_v<T, float>) {
      const float4* xv = reinterpret_cast<const float4*>(xp);
      float4* yv = reinterpret_cast<float4*>(yp);
      for (long long i = threadIdx.x; i < hw / 4; i += kThreads) {
        float4 v = xv[i];
        v.x = fmaf(v.x - mean, scale, bias);
        v.y = fmaf(v.y - mean, scale, bias);
        v.z = fmaf(v.z - mean, scale, bias);
        v.w = fmaf(v.w - mean, scale, bias);
        yv[i] = v;
      }
    } else {
      const uint4* xv = reinterpret_cast<const uint4*>(xp);
      uint4* yv = reinterpret_cast<uint4*>(yp);
      for (long long i = threadIdx.x; i < hw / 8; i += kThreads) {
        float v[8];
        unpack8(xv[i], v);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = fmaf(v[k] - mean, scale, bias);
        yv[i] = pack8(v);
      }
    }
  } else {
    for (long long i = threadIdx.x; i < hw; i += kThreads)
      yp[i] = from_f32<T>(fmaf(to_f32(xp[i]) - mean, scale, bias));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ mean, const float* __restrict__ rstd,
                     float* __restrict__ out, long long planes, long long hw) {
  const long long plane = blockIdx.x;
  const T* xp = x + plane * hw;
  const T* gp = g + plane * hw;
  const float m = mean[plane], inv = rstd[plane];
  float sg = 0.f, sgx = 0.f;
  for (long long i = threadIdx.x; i < hw; i += kThreads) {
    const float gv = to_f32(gp[i]);
    sg += gv;
    sgx = fmaf(gv, (to_f32(xp[i]) - m) * inv, sgx);
  }
  block_sum2(sg, sgx);
  if (threadIdx.x == 0) {
    out[plane] = sg;
    out[planes + plane] = sgx;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
band_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ gamma, const float* __restrict__ mean,
                      const float* __restrict__ rstd, const float* __restrict__ local,
                      const float* __restrict__ total, long long batch, int channels,
                      long long hw, float n, T* __restrict__ dx, float* __restrict__ dgamma,
                      float* __restrict__ dbeta) {
  const long long planes = batch * channels;
  const long long plane = blockIdx.x;
  const int c = static_cast<int>(plane % channels);
  const T* xp = x + plane * hw;
  const T* gp = g + plane * hw;
  T* dp = dx + plane * hw;
  const float m = mean[plane], inv = rstd[plane], gm = gamma[c];
  const float sum_gg = gm * total[plane];
  const float sum_gg_xhat = gm * total[planes + plane];
  const float k = inv / n;
  for (long long i = threadIdx.x; i < hw; i += kThreads) {
    const float xhat = (to_f32(xp[i]) - m) * inv;
    const float gg = to_f32(gp[i]) * gm;
    dp[i] = from_f32<T>(k * (n * gg - sum_gg - xhat * sum_gg_xhat));
  }
  if (plane < channels && threadIdx.x == 0) {  // batch row 0: channel c's band sums
    float sg = 0.f, sgx = 0.f;
    for (long long b = 0; b < batch; ++b) {
      sg += local[b * channels + c];
      sgx += local[planes + b * channels + c];
    }
    dgamma[c] = sgx;
    dbeta[c] = sg;
  }
}

cudaError_t launched() { return cudaGetLastError(); }

bool bad_grid(long long planes) { return planes <= 0 || planes > INT_MAX; }

}  // namespace

// x (planes, hw) of this band -> out (2, planes): each plane's band mean, M2.
#define SHM_BAND_MOMENTS(SUFFIX, T)                                                      \
  extern "C" int shm_instance_norm_band_moments_##SUFFIX(const T* x, float* out,         \
                                                          long long planes, long long hw, \
                                                          void* stream) {                 \
    if (bad_grid(planes) || hw <= 0) return static_cast<int>(cudaErrorInvalidValue);      \
    band_moments_kernel<T><<<static_cast<unsigned int>(planes), kThreads, 0,              \
                             static_cast<cudaStream_t>(stream)>>>(x, out, planes, hw);   \
    return static_cast<int>(launched());                                                  \
  }
SHM_BAND_MOMENTS(f32, float)
SHM_BAND_MOMENTS(bf16, __nv_bfloat16)

// parts (nparts, 2, planes), the row's band moments in rank order, each band
// of hw elements a plane -> y, and each plane's mean and rstd (planes).
#define SHM_BAND_APPLY(SUFFIX, T)                                                         \
  extern "C" int shm_instance_norm_band_apply_##SUFFIX(                                   \
      const T* x, const float* gamma, const float* beta, const float* parts, int nparts,  \
      long long planes, int channels, long long hw, float eps, T* y, float* mean,         \
      float* rstd, void* stream) {                                                         \
    if (bad_grid(planes) || hw <= 0 || nparts <= 0 || channels <= 0)                      \
      return static_cast<int>(cudaErrorInvalidValue);                                     \
    band_apply_kernel<T><<<static_cast<unsigned int>(planes), kThreads, 0,                \
                           static_cast<cudaStream_t>(stream)>>>(                          \
        x, gamma, beta, parts, nparts, planes, channels, hw, eps, y, mean, rstd);         \
    return static_cast<int>(launched());                                                  \
  }
SHM_BAND_APPLY(f32, float)
SHM_BAND_APPLY(bf16, __nv_bfloat16)

// x, g (planes, hw) of this band, the plane's mean and rstd -> out (2,
// planes): each plane's band sums of g and of g * xhat.
#define SHM_BAND_BWD_SUMS(SUFFIX, T)                                                      \
  extern "C" int shm_instance_norm_band_bwd_sums_##SUFFIX(                                \
      const T* x, const T* g, const float* mean, const float* rstd, float* out,           \
      long long planes, long long hw, void* stream) {                                      \
    if (bad_grid(planes) || hw <= 0) return static_cast<int>(cudaErrorInvalidValue);      \
    band_bwd_sums_kernel<T><<<static_cast<unsigned int>(planes), kThreads, 0,             \
                              static_cast<cudaStream_t>(stream)>>>(x, g, mean, rstd, out, \
                                                                   planes, hw);           \
    return static_cast<int>(launched());                                                  \
  }
SHM_BAND_BWD_SUMS(f32, float)
SHM_BAND_BWD_SUMS(bf16, __nv_bfloat16)

// local (2, planes): this band's sums; total: the row's; n: the whole plane's
// count -> dx of this band, and dgamma, dbeta (channels) of this band.
#define SHM_BAND_BWD_APPLY(SUFFIX, T)                                                     \
  extern "C" int shm_instance_norm_band_bwd_apply_##SUFFIX(                               \
      const T* x, const T* g, const float* gamma, const float* mean, const float* rstd,   \
      const float* local, const float* total, long long batch, int channels,              \
      long long hw, float n, T* dx, float* dgamma, float* dbeta, void* stream) {          \
    if (bad_grid(batch * channels) || hw <= 0 || channels <= 0)                           \
      return static_cast<int>(cudaErrorInvalidValue);                                     \
    band_bwd_apply_kernel<T><<<static_cast<unsigned int>(batch * channels), kThreads, 0,  \
                               static_cast<cudaStream_t>(stream)>>>(                      \
        x, g, gamma, mean, rstd, local, total, batch, channels, hw, n, dx, dgamma, dbeta);\
    return static_cast<int>(launched());                                                  \
  }
SHM_BAND_BWD_APPLY(f32, float)
SHM_BAND_BWD_APPLY(bf16, __nv_bfloat16)
