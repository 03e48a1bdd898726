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
// Forward: one launch a call, of one of four variants that the wrapper
// (ops/kernels/instance_norm.py, _fwd_plan) picks from the shape alone and
// passes in; the launch refuses a plan it cannot run (cudaErrorInvalidValue):
//   - two-pass (instance_norm_kernel), the first design: one 256-thread
//     block per plane; thread t folds chunks t, t + 256, ... in order, the
//     block merges the threads' moments (warp shuffles, then the warps in
//     order through shared memory), then reads the plane again and writes.
//     The second read hits L2 only while the planes in flight fit the 50 MB
//     L2 (at 256 x 256 and 128 x 128 they do not). It takes what the others
//     do not: H*W not a multiple of 16 bytes, or x not 16-byte aligned; and
//     tensors small enough to stay in L2 whose planes would take 4 or more
//     chunks a thread in registers, where its 8 blocks an SM beat resident's
//     2 to 4;
//   - packed, planes of up to 64 chunks of 16 bytes (16 x 16, 8 x 8, 4 x 4):
//     `lanes` threads (a power of 2, at most 32) own one plane, many planes
//     a block, the plane's moments a __shfl_xor_sync butterfly within its
//     segment of the warp: no block barrier;
//   - resident, planes whose x the registers of one block, or of a cluster
//     of up to 8 blocks, hold: read once from device memory into registers,
//     merged (warps through shared memory, the cluster's blocks through
//     distributed shared memory in rank order), normalised from the
//     registers and written once. Several planes of up to 256 chunks share
//     a block;
//   - split, planes too large for that, or too few to fill the card: a
//     cluster of up to 8 blocks shares each plane, each block folds its part
//     in rounds of 16-byte loads, the parts are merged through distributed
//     shared memory, then each block normalises its part: the last round
//     from its registers, the others read again, the latest first, while
//     they may still be in L2.
// Without a cluster, packed and resident keep the two-pass kernel's thread
// -> chunk map and its merge sequence (below), so their y, mean and rstd
// are the two-pass kernel's bit for bit: the train step's shapes, all up to
// 128 x 128, take them. They make the same merges on the same values, so
// this holds whatever __fdividef(n, n) rounds to. No variant needs a launch
// attribute set: clusters have at most 8 blocks (the portable size) and
// shared memory is static, under 48 KB.
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
//     x fits 8 x 512 threads x 4 chunks of 16 bytes (256x256 in f32, 131,072
//     elements in bf16): a block of 64 to 512 threads, or a cluster of up to
//     8 blocks (the portable cluster size: no non-portable attribute),
//     holds the plane; the sums go through shared memory across warps and,
//     in a cluster, through distributed shared memory, where each block
//     writes its partial into a slot of every block and, after one cluster
//     barrier, adds the slots in rank order (as csrc/preprocess.cu). At 4
//     chunks a thread two blocks of 512 fit on an SM (64 registers a
//     thread), at 8 chunks two blocks of 256 (112 registers); a cluster of 8
//     takes 4 SMs of one GPC. Above two blocks the wrapper gives a thread 32
//     elements: 4 chunks of bf16 in blocks of 512, 8 chunks of f32 in
//     blocks of 256. Phase B's 256x256 planes, which the streaming variant
//     reads twice, are read once here;
//   - streaming, anything larger (512x512 training), or larger than 256
//     elements with H*W not a multiple of 16 bytes: one 256-thread block per
//     plane in two passes, which reads x and g twice.
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
// 16-byte chunks of x (and of g) a resident thread holds: 4 (64 registers a
// thread, two blocks of 512 an SM) or, at most, 8 (112 registers, two blocks
// of 256)
constexpr int kResidentChunks = 4;
constexpr int kResidentMaxChunks = 8;
constexpr int kResidentMaxCluster = 8;  // blocks a plane: the portable cluster size

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
// t holds chunks t, t + blockDim.x, ... of that run, at most kChunks. A
// cluster's blocks add their sums in rank order, each from its own slots.
template <typename T, bool kCluster, int kChunks>
__global__ void __launch_bounds__(kResidentThreads, kChunks <= kResidentChunks ? 2 : 1)
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

  uint4 xs[kChunks], gs[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < n) {
      xs[k] = C::load(x + off + i * C::kW, aligned);
      gs[k] = C::load(g + off + i * C::kW, aligned);
    }
  }
  float sg = 0.f, sgx = 0.f;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
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
  for (int c = 0; c < kChunks; ++c) {
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

// ------------------------------------------------------ forward variants

// The forward plan's variant, as the wrapper passes it.
enum FwdVariant { kFwdPacked = 0, kFwdResident = 1, kFwdSplit = 2, kFwdTwoPass = 3 };

constexpr int kFwdPackedThreads = 256;  // threads of a packed block, at most
constexpr int kFwdPackedChunks = 2;     // 16-byte chunks a packed lane holds, at most
constexpr int kFwdThreads = 512;        // threads of a resident or split block, at most
constexpr int kFwdMaxCluster = 8;       // blocks a plane: the portable cluster size

// y of one 16-byte chunk, as the two-pass kernel computes it.
template <typename C>
__device__ __forceinline__ typename C::Raw normalise(typename C::Raw r, float mean, float scale,
                                                     float bias) {
  float v[C::kW];
  C::unpack(r, v);
#pragma unroll
  for (int k = 0; k < C::kW; ++k) v[k] = fmaf(v[k] - mean, scale, bias);
  return C::pack(v);
}

// Packed: thread t of the grid is lane t % lanes of plane t / lanes, and lane
// l holds chunks l, l + lanes, ... (kChunks slots; a second only where lanes
// is 32). The two-pass kernel's thread 32 k + l holds chunk 32 k + l, and its
// warp k merges by a butterfly over offsets 16 .. 1, then the block merges the
// warps in order from empty moments. Here slot k has moments of its own and a
// butterfly of its own over the plane's segment, and the slots' results, read
// from the segment's first lane, are merged in k order from empty moments:
// the same operations on the same values, so the same bits (the two-pass
// butterfly's steps wider than a segment merge empty moments into lanes of
// the segment, which changes no bit, and its empty warps likewise). Every
// thread of a warp takes part in the shuffles, those past the last plane with
// empty moments.
template <typename T, int kChunks>
__global__ void __launch_bounds__(kFwdPackedThreads)
instance_norm_fwd_packed(const T* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ y,
                         float* __restrict__ mean_out, float* __restrict__ rstd_out,
                         long long planes, int channels, int hw, int lanes, float eps) {
  using C = Chunk<T, true>;
  const int nchunks = hw / C::kW;
  const int lane = threadIdx.x & (lanes - 1);
  const int head = (threadIdx.x & 31) & ~(lanes - 1);  // the segment's first lane
  const long long plane =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / lanes;
  const bool live = plane < planes;
  const uint4* xv = reinterpret_cast<const uint4*>(x + plane * hw);
  const int c = static_cast<int>(plane % channels);
  const float gm = live ? gamma[c] : 0.f;  // read while x is in flight
  const float bias = live ? beta[c] : 0.f;
  uint4 xs[kChunks];
  Moments part[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    part[k] = Moments{0.f, 0.f, 0.f};
    if (live && lane + k * lanes < nchunks) xs[k] = __ldg(xv + lane + k * lanes);
  }
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    if (live && lane + k * lanes < nchunks) {
      float v[C::kW];
      C::unpack(xs[k], v);
      fold<C::kW>(part[k], v);
    }
  }
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    for (int o = lanes >> 1; o > 0; o >>= 1) {
      const float n = __shfl_xor_sync(0xffffffffu, part[k].n, o);
      const float m = __shfl_xor_sync(0xffffffffu, part[k].mean, o);
      const float q = __shfl_xor_sync(0xffffffffu, part[k].m2, o);
      merge(part[k], n, m, q);
    }
  }
  Moments acc{0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const float n = __shfl_sync(0xffffffffu, part[k].n, head);
    const float m = __shfl_sync(0xffffffffu, part[k].mean, head);
    const float q = __shfl_sync(0xffffffffu, part[k].m2, head);
    merge(acc, n, m, q);
  }
  if (!live) return;
  const float var = fmaxf(acc.m2 / static_cast<float>(hw), 0.f);
  const float rstd = rsqrtf(var + eps);
  const float scale = gm * rstd;
  if (mean_out != nullptr && lane == 0) {
    mean_out[plane] = acc.mean;
    rstd_out[plane] = rstd;
  }
  uint4* yv = reinterpret_cast<uint4*>(y + plane * hw);
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    if (lane + k * lanes < nchunks)
      yv[lane + k * lanes] = normalise<C>(xs[k], acc.mean, scale, bias);
  }
}

// Resident and split. Without a cluster, group g of `lanes` threads of block
// i owns plane i * (blockDim.x / lanes) + g; in a cluster (lanes ==
// blockDim.x) block `rank` of plane i's cluster owns chunks [rank * run,
// min((rank + 1) * run, H*W / kW)) of it. Thread l of a group holds, in round
// r, chunks r * lanes * kChunks + l + lanes * k of its run, k < kChunks, and
// folds them in that order: with one block of 256 threads to a plane, the
// two-pass kernel's thread l folds the same chunks in the same order. A group
// merges its warps' moments in order from empty moments (the two-pass
// kernel's block_moments, whose warps past the group's are empty), a cluster
// its blocks' in rank order. One round (resident): x is read once and
// normalised from the registers. More (split): the rounds before the last are
// read again for the output, the latest first.
template <typename T, int kChunks, bool kCluster>
__global__ void __launch_bounds__(kFwdThreads, kChunks <= 2 ? 4 : kChunks == 4 ? 3 : 1)
instance_norm_fwd_blocks(const T* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ beta, T* __restrict__ y,
                         float* __restrict__ mean_out, float* __restrict__ rstd_out,
                         long long planes, int channels, long long hw, int lanes, int run,
                         float eps) {
  using C = Chunk<T, true>;
  __shared__ float sn[kFwdThreads / 32], sm[kFwdThreads / 32], sq[kFwdThreads / 32];
  __shared__ float3 parts[kFwdMaxCluster];  // slot r: block r's moments
  __shared__ float2 plane_stats[kFwdThreads / 32];  // a group's mean and M2

  unsigned int rank = 0, nrank = 1;
  if constexpr (kCluster) {
    // Half of a barrier that only says this block has started: no block may
    // touch another's shared memory before that one runs.
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    cg::cluster_group cluster = cg::this_cluster();
    rank = cluster.block_rank();
    nrank = cluster.num_blocks();
  }
  const int group = threadIdx.x / lanes;
  const int l = threadIdx.x - group * lanes;
  const long long plane =
      kCluster ? static_cast<long long>(blockIdx.x / nrank)
               : static_cast<long long>(blockIdx.x) * (blockDim.x / lanes) + group;
  const bool live = plane < planes;
  const long long first = static_cast<long long>(rank) * run;
  const int n = live ? static_cast<int>(min(static_cast<long long>(run), hw / C::kW - first)) : 0;
  const int step = lanes * kChunks;  // chunks of a round
  const uint4* xv = reinterpret_cast<const uint4*>(x + plane * hw) + first;
  const int c = static_cast<int>(plane % channels);
  const float gm = live ? gamma[c] : 0.f;  // read while x is in flight
  const float bias = live ? beta[c] : 0.f;

  Moments acc{0.f, 0.f, 0.f};
  uint4 xs[kChunks];
  int last = -1;  // this thread's last round
  for (int base = l; base < n; base += step) {
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
      if (base + k * lanes < n) xs[k] = __ldg(xv + base + k * lanes);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if (base + k * lanes < n) {
        float v[C::kW];
        C::unpack(xs[k], v);
        fold<C::kW>(acc, v);
      }
    }
    ++last;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, acc.n, o);
    const float mb = __shfl_xor_sync(0xffffffffu, acc.mean, o);
    const float qb = __shfl_xor_sync(0xffffffffu, acc.m2, o);
    merge(acc, nb, mb, qb);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sn[warp] = acc.n;
    sm[warp] = acc.mean;
    sq[warp] = acc.m2;
  }
  __syncthreads();
  // The group's first warp merges its warps (and, in a cluster, the blocks)
  // and hands the result to the others through shared memory: the same
  // merges as every thread of the two-pass kernel makes, made once.
  const bool first_warp = l < 32;
  if (first_warp) {
    acc = Moments{0.f, 0.f, 0.f};
    const int w0 = group * (lanes >> 5);
    for (int w = w0; w < w0 + (lanes >> 5); ++w) merge(acc, sn[w], sm[w], sq[w]);
  }
  if constexpr (kCluster) {
    // Thread r writes this block's moments into slot `rank` of block r
    // (DSMEM); after the barrier each block reads only its own shared memory,
    // so none has to wait for the others before it exits.
    cg::cluster_group cluster = cg::this_cluster();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // all blocks run
    if (threadIdx.x < nrank)
      *cluster.map_shared_rank(&parts[rank], threadIdx.x) = make_float3(acc.n, acc.mean, acc.m2);
    cluster.sync();
    if (first_warp) {
      acc = Moments{0.f, 0.f, 0.f};
      for (unsigned int r = 0; r < nrank; ++r) merge(acc, parts[r].x, parts[r].y, parts[r].z);
    }
  }
  if (l == 0) plane_stats[group] = make_float2(acc.mean, acc.m2);
  __syncthreads();
  acc.mean = plane_stats[group].x;
  acc.m2 = plane_stats[group].y;
  if (!live) return;

  const float var = fmaxf(acc.m2 / static_cast<float>(hw), 0.f);
  const float rstd = rsqrtf(var + eps);
  const float scale = gm * rstd;
  if (mean_out != nullptr && rank == 0 && l == 0) {
    mean_out[plane] = acc.mean;
    rstd_out[plane] = rstd;
  }
  uint4* yv = reinterpret_cast<uint4*>(y + plane * hw) + first;
  for (int r = last; r >= 0; --r) {
    const int base = l + r * step;
    if (r != last) {
#pragma unroll
      for (int k = 0; k < kChunks; ++k)
        if (base + k * lanes < n) xs[k] = __ldg(xv + base + k * lanes);
    }
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
      if (base + k * lanes < n) yv[base + k * lanes] = normalise<C>(xs[k], acc.mean, scale, bias);
  }
}

bool pow2(long long v) { return v > 0 && (v & (v - 1)) == 0; }

bool host_aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The forward plan is valid for this shape and these pointers: the kernel it
// names covers every element of every plane once, within its registers, the
// grid and (but for two-pass) 16-byte loads. Resident means one round a
// thread, split more than one.
template <typename T>
bool valid_fwd_plan(long long planes, long long hw, int variant, int lanes, int threads,
                    int cluster, int chunks, bool aligned) {
  constexpr long long kVec = 16 / sizeof(T);
  if (planes <= 0 || hw <= 0 || threads < 32 || threads % 32 != 0) return false;
  if (variant == kFwdTwoPass)
    return threads == kThreads && lanes == kThreads && cluster == 1 && planes <= INT_MAX;
  if (hw % kVec != 0 || !aligned || hw > INT_MAX) return false;
  const long long nchunks = hw / kVec;
  if (variant == kFwdPacked)
    return pow2(lanes) && lanes <= 32 && threads <= kFwdPackedThreads && threads % lanes == 0 &&
           cluster == 1 && chunks >= 1 && chunks <= kFwdPackedChunks &&
           nchunks <= static_cast<long long>(lanes) * chunks &&
           (planes * lanes + threads - 1) / threads <= INT_MAX;
  if (variant != kFwdResident && variant != kFwdSplit) return false;
  if (threads > kFwdThreads || lanes < 32 || lanes % 32 != 0 || lanes > threads ||
      threads % lanes != 0 || cluster < 1 || cluster > kFwdMaxCluster ||
      (cluster > 1 && lanes != threads) || !pow2(chunks) || chunks > 16)
    return false;
  const long long run = (nchunks + cluster - 1) / cluster;
  const long long blocks = cluster > 1 ? planes * cluster
                                       : (planes + threads / lanes - 1) / (threads / lanes);
  if ((cluster - 1) * run >= nchunks || blocks > INT_MAX) return false;
  const long long rounds = (run + static_cast<long long>(lanes) * chunks - 1) /
                           (static_cast<long long>(lanes) * chunks);
  return variant == kFwdResident ? rounds == 1 : rounds > 1;
}

template <typename T, int kChunks>
cudaError_t launch_fwd_blocks(const T* x, const float* gamma, const float* beta, T* y,
                              float* mean, float* rstd, long long planes, int channels,
                              long long hw, int lanes, int threads, int cluster, float eps,
                              cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int run = static_cast<int>((hw / kVec + cluster - 1) / cluster);
  if (cluster == 1) {
    const unsigned int blocks =
        static_cast<unsigned int>((planes + threads / lanes - 1) / (threads / lanes));
    instance_norm_fwd_blocks<T, kChunks, false><<<blocks, threads, 0, s>>>(
        x, gamma, beta, y, mean, rstd, planes, channels, hw, lanes, run, eps);
    return cudaSuccess;
  }
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
  return cudaLaunchKernelEx(&cfg, instance_norm_fwd_blocks<T, kChunks, true>, x, gamma, beta, y,
                            mean, rstd, planes, channels, hw, lanes, run, eps);
}

template <typename T>
int launch_forward(const T* x, const float* gamma, const float* beta, T* y, float* mean,
                   float* rstd, long long planes, int channels, long long hw, float eps,
                   int variant, int lanes, int threads, int cluster, int chunks, void* stream) {
  if (channels <= 0 ||
      !valid_fwd_plan<T>(planes, hw, variant, lanes, threads, cluster, chunks,
                         host_aligned16(x) && host_aligned16(y)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (variant == kFwdTwoPass) {
    instance_norm_kernel<T><<<static_cast<unsigned int>(planes), kThreads, 0, s>>>(
        x, gamma, beta, y, mean, rstd, channels, hw, eps);
  } else if (variant == kFwdPacked) {
    const unsigned int blocks = static_cast<unsigned int>((planes * lanes + threads - 1) / threads);
    if (chunks == 1)
      instance_norm_fwd_packed<T, 1><<<blocks, threads, 0, s>>>(
          x, gamma, beta, y, mean, rstd, planes, channels, static_cast<int>(hw), lanes, eps);
    else
      instance_norm_fwd_packed<T, 2><<<blocks, threads, 0, s>>>(
          x, gamma, beta, y, mean, rstd, planes, channels, static_cast<int>(hw), lanes, eps);
  } else {
    switch (chunks) {
      case 1:
        err = launch_fwd_blocks<T, 1>(x, gamma, beta, y, mean, rstd, planes, channels, hw, lanes,
                                      threads, cluster, eps, s);
        break;
      case 2:
        err = launch_fwd_blocks<T, 2>(x, gamma, beta, y, mean, rstd, planes, channels, hw, lanes,
                                      threads, cluster, eps, s);
        break;
      case 4:
        err = launch_fwd_blocks<T, 4>(x, gamma, beta, y, mean, rstd, planes, channels, hw, lanes,
                                      threads, cluster, eps, s);
        break;
      case 8:
        err = launch_fwd_blocks<T, 8>(x, gamma, beta, y, mean, rstd, planes, channels, hw, lanes,
                                      threads, cluster, eps, s);
        break;
      default:
        err = launch_fwd_blocks<T, 16>(x, gamma, beta, y, mean, rstd, planes, channels, hw,
                                       lanes, threads, cluster, eps, s);
    }
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Blocks of the forward plan's kernel that fit on one SM at once.
template <typename T, int kChunks>
cudaError_t fwd_blocks_per_sm(int cluster, int threads, int* count) {
  return cluster > 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           count, instance_norm_fwd_blocks<T, kChunks, true>, threads, 0)
                     : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           count, instance_norm_fwd_blocks<T, kChunks, false>, threads, 0);
}

template <typename T>
int forward_blocks_per_sm(int variant, int threads, int cluster, int chunks, int* count) {
  cudaError_t err = cudaErrorInvalidValue;
  if (variant == kFwdTwoPass) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(count, instance_norm_kernel<T>, threads, 0);
  } else if (variant == kFwdPacked) {
    err = chunks == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            count, instance_norm_fwd_packed<T, 1>, threads, 0)
                      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            count, instance_norm_fwd_packed<T, 2>, threads, 0);
  } else if (variant == kFwdResident || variant == kFwdSplit) {
    switch (chunks) {
      case 1: err = fwd_blocks_per_sm<T, 1>(cluster, threads, count); break;
      case 2: err = fwd_blocks_per_sm<T, 2>(cluster, threads, count); break;
      case 4: err = fwd_blocks_per_sm<T, 4>(cluster, threads, count); break;
      case 8: err = fwd_blocks_per_sm<T, 8>(cluster, threads, count); break;
      case 16: err = fwd_blocks_per_sm<T, 16>(cluster, threads, count); break;
      default: break;
    }
  }
  return static_cast<int>(err);
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
      return run <= static_cast<long long>(threads) * kResidentMaxChunks &&
             (cluster - 1) * run < nchunks;
    }
    case kStreaming:
      return threads == kThreads && lanes == kThreads && cluster == 1 && planes <= INT_MAX;
    default:
      return false;
  }
}

// The launch of a resident plan of `cluster` blocks of `threads` a plane:
// a cluster attribute where cluster > 1.
cudaLaunchConfig_t resident_config(long long planes, int threads, int cluster, cudaStream_t s,
                                   cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned int>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(planes * cluster));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

template <typename T, int kChunks>
cudaError_t launch_bwd_resident(const T* x, const T* g, const float* gamma, const float* mean,
                                const float* rstd, T* dx, float* sum_gxhat, float* sum_g,
                                long long planes, int channels, int hw, int threads,
                                int cluster, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int run = (hw / kVec + cluster - 1) / cluster;
  if (cluster == 1) {
    instance_norm_bwd_resident<T, false, kChunks>
        <<<static_cast<unsigned int>(planes), threads, 0, s>>>(
            x, g, gamma, mean, rstd, dx, sum_gxhat, sum_g, channels, hw, run);
    return cudaSuccess;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = resident_config(planes, threads, cluster, s, &attr);
  return cudaLaunchKernelEx(&cfg, instance_norm_bwd_resident<T, true, kChunks>, x, g, gamma,
                            mean, rstd, dx, sum_gxhat, sum_g, channels, hw, run);
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
    // the kernel's register arrays: kResidentChunks, or kResidentMaxChunks
    // where a thread holds more
    const long long run = (hw / kVec + cluster - 1) / cluster;
    err = (run + threads - 1) / threads > kResidentChunks
              ? launch_bwd_resident<T, kResidentMaxChunks>(
                    x, g, gamma, mean, rstd, dx, sum_gxhat, sum_g, planes, channels,
                    static_cast<int>(hw), threads, cluster, s)
              : launch_bwd_resident<T, kResidentChunks>(
                    x, g, gamma, mean, rstd, dx, sum_gxhat, sum_g, planes, channels,
                    static_cast<int>(hw), threads, cluster, s);
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

// The resident kernel a plan of `chunks` chunks a thread launches.
template <typename T, bool kCluster>
const void* resident_kernel(int chunks) {
  return chunks > kResidentChunks
             ? reinterpret_cast<const void*>(
                   instance_norm_bwd_resident<T, kCluster, kResidentMaxChunks>)
             : reinterpret_cast<const void*>(
                   instance_norm_bwd_resident<T, kCluster, kResidentChunks>);
}

// Blocks of the plan's kernel that fit on one SM at once (resident: at
// `chunks` chunks a thread).
template <typename T>
int backward_blocks_per_sm(int variant, int vector, int threads, int cluster, int chunks,
                           int* count) {
  cudaError_t err = cudaErrorInvalidValue;
  if (variant == kPacked)
    err = vector ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       count, instance_norm_bwd_packed<T, true>, threads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       count, instance_norm_bwd_packed<T, false>, threads, 0);
  else if (variant == kResident)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        count, cluster > 1 ? resident_kernel<T, true>(chunks) : resident_kernel<T, false>(chunks),
        threads, 0);
  else if (variant == kStreaming)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        count, instance_norm_bwd_streaming<T>, threads, 0);
  return static_cast<int>(err);
}

// Clusters of a resident plan of `cluster` blocks (> 1) that the device runs
// at once.
template <typename T>
int backward_max_active_clusters(int threads, int cluster, int chunks, int* count) {
  if (cluster < 2 || cluster > kResidentMaxCluster || threads < 32 ||
      threads > kResidentThreads || chunks < 1 || chunks > kResidentMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = resident_config(cluster, threads, cluster, nullptr, &attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(count, resident_kernel<T, true>(chunks), &cfg));
}

}  // namespace

// planes = B * C. mean / rstd: (B * C) outputs, or both null when the caller
// needs no backward. The plan: variant (0 packed, 1 resident, 2 split, 3
// two-pass), the threads that own one plane in a block (lanes), threads per
// block, blocks per plane (cluster), 16-byte chunks a thread holds (chunks).
// One launch on `stream`. Returns cudaErrorInvalidValue, launching nothing,
// for a plan the kernels cannot run at this shape (or, but for two-pass, on
// x or y off a 16-byte boundary); else the launch's error.
extern "C" int shm_instance_norm_f32(const float* x, const float* gamma, const float* beta,
                                     float* y, float* mean, float* rstd, long long planes,
                                     int channels, long long hw, float eps, int variant,
                                     int lanes, int threads, int cluster, int chunks,
                                     void* stream) {
  return launch_forward(x, gamma, beta, y, mean, rstd, planes, channels, hw, eps, variant, lanes,
                        threads, cluster, chunks, stream);
}

// The same with x and y in bf16; gamma, beta, mean and rstd stay float.
extern "C" int shm_instance_norm_bf16(const __nv_bfloat16* x, const float* gamma,
                                      const float* beta, __nv_bfloat16* y, float* mean,
                                      float* rstd, long long planes, int channels, long long hw,
                                      float eps, int variant, int lanes, int threads,
                                      int cluster, int chunks, void* stream) {
  return launch_forward(x, gamma, beta, y, mean, rstd, planes, channels, hw, eps, variant, lanes,
                        threads, cluster, chunks, stream);
}

// cudaOccupancyMaxActiveBlocksPerMultiprocessor of the forward kernel a plan
// launches, into *count.
extern "C" int shm_instance_norm_fwd_blocks_per_sm(int bf16, int variant, int threads,
                                                   int cluster, int chunks, int* count) {
  return bf16 ? forward_blocks_per_sm<__nv_bfloat16>(variant, threads, cluster, chunks, count)
              : forward_blocks_per_sm<float>(variant, threads, cluster, chunks, count);
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
// launches (vector: H*W a multiple of 16 bytes; chunks: 16-byte chunks a
// resident thread holds), into *count.
extern "C" int shm_instance_norm_bwd_blocks_per_sm(int bf16, int variant, int vector,
                                                   int threads, int cluster, int chunks,
                                                   int* count) {
  return bf16 ? backward_blocks_per_sm<__nv_bfloat16>(variant, vector, threads, cluster, chunks,
                                                      count)
              : backward_blocks_per_sm<float>(variant, vector, threads, cluster, chunks, count);
}

// cudaOccupancyMaxActiveClusters of a resident backward plan with a cluster
// of `cluster` blocks of `threads`, `chunks` chunks a thread, into *count;
// cudaErrorInvalidValue for a plan without a cluster or past the kernel's
// limits.
extern "C" int shm_instance_norm_bwd_max_active_clusters(int bf16, int threads, int cluster,
                                                         int chunks, int* count) {
  return bf16 ? backward_max_active_clusters<__nv_bfloat16>(threads, cluster, chunks, count)
              : backward_max_active_clusters<float>(threads, cluster, chunks, count);
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
//            VJP (_bwd); the threads of batch row 0's planes also add each
//            channel's band sums over the batch, in order: dgamma and dbeta
//            of this band, which the train step sums over the row with the
//            other gradients.
// The moments and apply launches of the forward take one 256-thread block a
// plane and 16-byte loads where the plane allows them.
//
// Bound of the backward: memory. x and g are read, dx written (6 bytes an
// element in bf16, 12 in f32) against ~12 flops. The row's sums arrive
// between the launches, so both read x and g: 5 bytes' worth moved for the
// bound's 3 wherever the second read misses L2 (a largest band, 40 x 64
// planes of 64 x 128, holds 84 MB of x and g in bf16 against a 50 MB L2).
// What the design does about it:
//   - 16-byte loads and stores (4 floats, 8 bf16) wherever H*W is a
//     multiple of 16 bytes, a thread loading kBandUnroll chunks before it
//     uses them: bytes in flight to cover HBM's latency. One element a
//     thread (the element variant) where H*W is not such a multiple; a base
//     off 16 bytes moves its 16 bytes one element at a time (load16);
//   - the sums launch walks the planes (packed: the blocks) from the last,
//     the apply launch from the first, so that the apply launch reads first
//     the planes that the sums launch read last, still in L2; in repeated
//     calls the next sums launch then starts on the planes the apply launch
//     read last. The apply launch keeps grid order so that batch row 0's
//     blocks, which also add the channel sums over the batch, run first
//     and not in its tail;
//   - planes of up to 256 elements (the small bands of D's deep maps and
//     G's bottleneck) go `lanes` threads a plane, several planes a warp,
//     their sums a __shfl_xor_sync butterfly within the plane's segment
//     (the whole-plane backward's packed variant), not a block with two
//     barriers a plane.
// The wrapper (ops/kernels/instance_norm.py, _band_bwd_plan) picks the
// variant and block size from the band's shape alone and passes the plan to
// both launches, which refuse one they cannot run (cudaErrorInvalidValue).
// Every sum is in f32 in a fixed order, without atomics: repeat calls are
// bit-identical, and a band gives the same bits in a mesh and in its split.

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

// The band backward's plan variant, as the wrapper passes it.
enum BandVariant { kBandPacked = 0, kBandVector = 1, kBandElement = 2 };

constexpr int kBandThreads = 512;  // threads of a vector or element block, at most
constexpr int kBandUnroll = 4;     // chunks a thread loads before it uses them
constexpr long long kBandMaxHw = 1LL << 30;

// dx of one chunk of a band: rstd / n * (n * g * gamma - sum_gg - xhat *
// sum_gg_xhat), sum_gg = gamma * sum(g) and sum_gg_xhat = gamma * sum(g *
// xhat) over the whole plane; k = rstd / n.
template <typename C>
__device__ __forceinline__ typename C::Raw band_dx_chunk(typename C::Raw xr, typename C::Raw gr,
                                                         float mu, float rs, float gm, float k,
                                                         float n, float sum_gg,
                                                         float sum_gg_xhat) {
  float a[C::kW], b[C::kW], o[C::kW];
  C::unpack(xr, a);
  C::unpack(gr, b);
#pragma unroll
  for (int j = 0; j < C::kW; ++j) {
    const float xhat = (a[j] - mu) * rs;
    o[j] = k * (n * (b[j] * gm) - sum_gg - xhat * sum_gg_xhat);
  }
  return C::pack(o);
}

// dgamma[c] and dbeta[c]: channel c's band sums, b in order.
__device__ __forceinline__ void band_channel_sums(const float* __restrict__ local,
                                                  long long batch, int channels, int c,
                                                  float* __restrict__ dgamma,
                                                  float* __restrict__ dbeta) {
  const long long planes = batch * channels;
  float sg = 0.f, sgx = 0.f;
#pragma unroll 16
  for (long long b = 0; b < batch; ++b) {
    sg += local[b * channels + c];
    sgx += local[planes + b * channels + c];
  }
  dgamma[c] = sgx;
  dbeta[c] = sg;
}

// Packed: thread t of the grid, its blocks numbered from the last (the
// reverse of the apply launch), is lane t % lanes of plane t / lanes, and
// lane l holds chunks l, l + lanes, ... of its band (at most kPackedElems
// elements of x and of g), as the whole-plane packed variant. Every thread
// of a warp takes part in the butterfly, those past the last plane with
// zeros.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kPackedThreads)
band_bwd_sums_packed(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ mean, const float* __restrict__ rstd,
                     float* __restrict__ out, long long planes, int hw, int lanes) {
  using C = Chunk<T, kVector>;
  constexpr int kChunks = kPackedElems / C::kW;
  const int nchunks = hw / C::kW;
  const int lane = threadIdx.x & (lanes - 1);
  const unsigned int blk = gridDim.x - 1 - blockIdx.x;
  const long long plane = (static_cast<long long>(blk) * blockDim.x + threadIdx.x) / lanes;
  const bool live = plane < planes;
  const bool aligned = aligned16(x) && aligned16(g);
  float sg = 0.f, sgx = 0.f;
  if (live) {
    const long long off = plane * hw;
    const float mu = mean[plane], rs = rstd[plane];
    typename C::Raw xs[kChunks], gs[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int j = lane + k * lanes;
      if (j < nchunks) {
        xs[k] = C::load(x + off + j * C::kW, aligned);
        gs[k] = C::load(g + off + j * C::kW, aligned);
      }
    }
#pragma unroll
    for (int k = 0; k < kChunks; ++k)
      if (lane + k * lanes < nchunks) add_chunk<C>(xs[k], gs[k], mu, rs, sg, sgx);
  }
  for (int o = lanes >> 1; o > 0; o >>= 1) {
    sg += __shfl_xor_sync(0xffffffffu, sg, o);
    sgx += __shfl_xor_sync(0xffffffffu, sgx, o);
  }
  if (live && lane == 0) {
    out[plane] = sg;
    out[planes + plane] = sgx;
  }
}

// The packed apply: the blocks in grid order, the reverse of the sums
// launch's.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kPackedThreads)
band_bwd_apply_packed(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ gamma, const float* __restrict__ mean,
                      const float* __restrict__ rstd, const float* __restrict__ local,
                      const float* __restrict__ total, long long batch, int channels, int hw,
                      float n, T* __restrict__ dx, float* __restrict__ dgamma,
                      float* __restrict__ dbeta, int lanes) {
  using C = Chunk<T, kVector>;
  constexpr int kChunks = kPackedElems / C::kW;
  const long long planes = batch * channels;
  const int nchunks = hw / C::kW;
  const int lane = threadIdx.x & (lanes - 1);
  const long long plane =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / lanes;
  if (plane >= planes) return;
  const bool aligned = aligned16(x) && aligned16(g) && aligned16(dx);
  const long long off = plane * hw;
  const int c = static_cast<int>(plane % channels);
  const float mu = mean[plane], rs = rstd[plane], gm = gamma[c];
  const float sum_gg = gm * total[plane];
  const float sum_gg_xhat = gm * total[planes + plane];
  const float k = rs / n;
  typename C::Raw xs[kChunks], gs[kChunks];
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int i = lane + j * lanes;
    if (i < nchunks) {
      xs[j] = C::load(x + off + i * C::kW, aligned);
      gs[j] = C::load(g + off + i * C::kW, aligned);
    }
  }
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int i = lane + j * lanes;
    if (i < nchunks)
      C::store(dx + off + i * C::kW,
               band_dx_chunk<C>(xs[j], gs[j], mu, rs, gm, k, n, sum_gg, sum_gg_xhat), aligned);
  }
  if (plane < channels && lane == 0) band_channel_sums(local, batch, channels, c, dgamma, dbeta);
}

// Vector (kVector, H*W a multiple of 16 bytes) and element: block i takes
// plane planes - 1 - i (the reverse of the apply launch); thread t takes
// chunks t, t + blockDim.x, ..., kBandUnroll of them loaded before any is
// summed; the threads' sums are added over each warp by shuffles, then over
// the warps in order.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kBandThreads)
band_bwd_sums_block(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ mean, const float* __restrict__ rstd,
                    float* __restrict__ out, long long planes, int hw) {
  using C = Chunk<T, kVector>;
  __shared__ float2 warp_sums[kBandThreads / 32];
  const long long plane = planes - 1 - blockIdx.x;
  const int nchunks = hw / C::kW;
  const int step = static_cast<int>(blockDim.x);
  const bool aligned = aligned16(x) && aligned16(g);
  const T* xp = x + plane * hw;
  const T* gp = g + plane * hw;
  const float mu = mean[plane], rs = rstd[plane];
  float sg = 0.f, sgx = 0.f;
  for (int base = threadIdx.x; base < nchunks; base += kBandUnroll * step) {
    typename C::Raw xs[kBandUnroll], gs[kBandUnroll];
#pragma unroll
    for (int u = 0; u < kBandUnroll; ++u) {
      const int i = base + u * step;
      if (i < nchunks) {
        xs[u] = C::load(xp + static_cast<long long>(i) * C::kW, aligned);
        gs[u] = C::load(gp + static_cast<long long>(i) * C::kW, aligned);
      }
    }
#pragma unroll
    for (int u = 0; u < kBandUnroll; ++u)
      if (base + u * step < nchunks) add_chunk<C>(xs[u], gs[u], mu, rs, sg, sgx);
  }
  sg = warp_sum(sg);
  sgx = warp_sum(sgx);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = make_float2(sg, sgx);
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < (step >> 5); ++w) {
      a += warp_sums[w].x;
      b += warp_sums[w].y;
    }
    out[plane] = a;
    out[planes + plane] = b;
  }
}

// The vector and element apply: block i takes plane i.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kBandThreads)
band_bwd_apply_block(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ gamma, const float* __restrict__ mean,
                     const float* __restrict__ rstd, const float* __restrict__ local,
                     const float* __restrict__ total, long long batch, int channels, int hw,
                     float n, T* __restrict__ dx, float* __restrict__ dgamma,
                     float* __restrict__ dbeta) {
  using C = Chunk<T, kVector>;
  const long long planes = batch * channels;
  const long long plane = blockIdx.x;
  const int nchunks = hw / C::kW;
  const int step = static_cast<int>(blockDim.x);
  const bool aligned = aligned16(x) && aligned16(g) && aligned16(dx);
  const int c = static_cast<int>(plane % channels);
  const T* xp = x + plane * hw;
  const T* gp = g + plane * hw;
  T* dp = dx + plane * hw;
  const float mu = mean[plane], rs = rstd[plane], gm = gamma[c];
  const float sum_gg = gm * total[plane];
  const float sum_gg_xhat = gm * total[planes + plane];
  const float k = rs / n;
  for (int base = threadIdx.x; base < nchunks; base += kBandUnroll * step) {
    typename C::Raw xs[kBandUnroll], gs[kBandUnroll];
#pragma unroll
    for (int u = 0; u < kBandUnroll; ++u) {
      const int i = base + u * step;
      if (i < nchunks) {
        xs[u] = C::load(xp + static_cast<long long>(i) * C::kW, aligned);
        gs[u] = C::load(gp + static_cast<long long>(i) * C::kW, aligned);
      }
    }
#pragma unroll
    for (int u = 0; u < kBandUnroll; ++u) {
      const int i = base + u * step;
      if (i < nchunks)
        C::store(dp + static_cast<long long>(i) * C::kW,
                 band_dx_chunk<C>(xs[u], gs[u], mu, rs, gm, k, n, sum_gg, sum_gg_xhat),
                 aligned);
    }
  }
  if (plane < channels && threadIdx.x == 0)
    band_channel_sums(local, batch, channels, c, dgamma, dbeta);
}

// The band plan is valid for this shape: its kernel covers every element of
// every plane once, within its registers and the grid.
template <typename T>
bool valid_band_plan(long long planes, long long hw, int variant, int lanes, int threads) {
  constexpr long long kVec = 16 / sizeof(T);
  if (planes <= 0 || hw <= 0 || hw > kBandMaxHw || threads < 32 || threads % 32 != 0)
    return false;
  switch (variant) {
    case kBandPacked: {
      const bool vec = hw % kVec == 0;
      const long long nchunks = vec ? hw / kVec : hw;
      const long long per_lane = vec ? kPackedElems / kVec : kPackedElems;
      return lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0 &&
             threads <= kPackedThreads && nchunks <= lanes * per_lane &&
             (planes * lanes + threads - 1) / threads <= INT_MAX;
    }
    case kBandVector:
      if (hw % kVec != 0) return false;
      return lanes == threads && threads <= kBandThreads && planes <= INT_MAX;
    case kBandElement:
      return lanes == threads && threads <= kBandThreads && planes <= INT_MAX;
    default:
      return false;
  }
}

unsigned int band_blocks(long long planes, int variant, int lanes, int threads) {
  return static_cast<unsigned int>(variant == kBandPacked
                                       ? (planes * lanes + threads - 1) / threads
                                       : planes);
}

template <typename T>
int launch_band_bwd_sums(const T* x, const T* g, const float* mean, const float* rstd,
                         float* out, long long planes, long long hw, int variant, int lanes,
                         int threads, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (!valid_band_plan<T>(planes, hw, variant, lanes, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = band_blocks(planes, variant, lanes, threads);
  const int n = static_cast<int>(hw);
  if (variant == kBandPacked) {
    if (hw % kVec == 0)
      band_bwd_sums_packed<T, true><<<blocks, threads, 0, s>>>(x, g, mean, rstd, out, planes, n,
                                                              lanes);
    else
      band_bwd_sums_packed<T, false><<<blocks, threads, 0, s>>>(x, g, mean, rstd, out, planes,
                                                               n, lanes);
  } else if (variant == kBandVector) {
    band_bwd_sums_block<T, true><<<blocks, threads, 0, s>>>(x, g, mean, rstd, out, planes, n);
  } else {
    band_bwd_sums_block<T, false><<<blocks, threads, 0, s>>>(x, g, mean, rstd, out, planes, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_band_bwd_apply(const T* x, const T* g, const float* gamma, const float* mean,
                          const float* rstd, const float* local, const float* total,
                          long long batch, int channels, long long hw, float n, T* dx,
                          float* dgamma, float* dbeta, int variant, int lanes, int threads,
                          void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long planes = batch * channels;
  if (batch <= 0 || channels <= 0 || !valid_band_plan<T>(planes, hw, variant, lanes, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = band_blocks(planes, variant, lanes, threads);
  const int m = static_cast<int>(hw);
  if (variant == kBandPacked) {
    if (hw % kVec == 0)
      band_bwd_apply_packed<T, true><<<blocks, threads, 0, s>>>(
          x, g, gamma, mean, rstd, local, total, batch, channels, m, n, dx, dgamma, dbeta,
          lanes);
    else
      band_bwd_apply_packed<T, false><<<blocks, threads, 0, s>>>(
          x, g, gamma, mean, rstd, local, total, batch, channels, m, n, dx, dgamma, dbeta,
          lanes);
  } else if (variant == kBandVector) {
    band_bwd_apply_block<T, true><<<blocks, threads, 0, s>>>(
        x, g, gamma, mean, rstd, local, total, batch, channels, m, n, dx, dgamma, dbeta);
  } else {
    band_bwd_apply_block<T, false><<<blocks, threads, 0, s>>>(
        x, g, gamma, mean, rstd, local, total, batch, channels, m, n, dx, dgamma, dbeta);
  }
  return static_cast<int>(cudaGetLastError());
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
// planes): each plane's band sums of g and of g * xhat. The plan: variant
// (0 packed, 1 vector, 2 element), the threads that own one plane (lanes),
// threads per block. Returns cudaErrorInvalidValue, launching nothing, for a
// plan the kernels cannot run at this shape; else cudaGetLastError().
#define SHM_BAND_BWD_SUMS(SUFFIX, T)                                                      \
  extern "C" int shm_instance_norm_band_bwd_sums_##SUFFIX(                                \
      const T* x, const T* g, const float* mean, const float* rstd, float* out,           \
      long long planes, long long hw, int variant, int lanes, int threads, void* stream) { \
    return launch_band_bwd_sums(x, g, mean, rstd, out, planes, hw, variant, lanes, threads, \
                                stream);                                                  \
  }
SHM_BAND_BWD_SUMS(f32, float)
SHM_BAND_BWD_SUMS(bf16, __nv_bfloat16)

// local (2, planes): this band's sums; total: the row's; n: the whole plane's
// count -> dx of this band, and dgamma, dbeta (channels) of this band; the
// plan as for the sums launch, whose plane order this launch reverses.
#define SHM_BAND_BWD_APPLY(SUFFIX, T)                                                     \
  extern "C" int shm_instance_norm_band_bwd_apply_##SUFFIX(                               \
      const T* x, const T* g, const float* gamma, const float* mean, const float* rstd,   \
      const float* local, const float* total, long long batch, int channels,              \
      long long hw, float n, T* dx, float* dgamma, float* dbeta, int variant, int lanes,  \
      int threads, void* stream) {                                                         \
    return launch_band_bwd_apply(x, g, gamma, mean, rstd, local, total, batch, channels,  \
                                 hw, n, dx, dgamma, dbeta, variant, lanes, threads,       \
                                 stream);                                                 \
  }
SHM_BAND_BWD_APPLY(f32, float)
SHM_BAND_BWD_APPLY(bf16, __nv_bfloat16)
