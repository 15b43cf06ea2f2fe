// Caffe's local response normalization across channels (ACROSS_CHANNELS)
// in one pass over an NHWC map, for an H100 (sm_90a).
//
// It replaces no Pallas kernel: the JAX package leaves LRN to XLA, which
// fuses caffe_escoin_tpu/ops/norm.py's chain of shifted channel slices into
// one pass on the TPU. PyTorch runs that chain (kernels/lrn.py's plain
// version) as about fifteen ops, each a pass over the map in f32, some 130
// bytes of traffic an element: on an H100 GoogLeNet's norm1 and norm2 took
// 1.24 ms of a 3.5 ms batch-32 query there.
//
// What it computes: y[p, c] = x[p, c] * s^-beta with s = k + alpha/n *
// sum over d = lo..hi of x[p, c + d]^2, lo = -(n / 2), hi = n - 1 - n / 2,
// skipping the terms whose channel lies outside c's lane group (C / groups
// channels; groups > 1 is the W-pair packed layout of ops/wpack.py), in
// f32, rounded once to the output type. The arithmetic is the plain
// version's: the terms added in the order of d, no FMA contraction
// (__fmul_rn / __fadd_rn), s = k + (alpha/n) * window as a multiply and an
// add, s^-0.75 = r * sqrt(r) with r = rsqrt(s), any other exponent powf.
//
// What bounds it: one read and one write of the map, 4 bytes a bf16 element
// (8 in f32). At 3.35 TB/s norm2 at batch 32 (32x56x56x192) takes 23.0 us,
// norm1 (C = 64) 7.7 us.
//
// What the design does about it: a block copies a tile of whole pixels
// (a multiple of 16 bytes) into shared memory with 16-byte cp.async copies,
// neighbouring threads on neighbouring addresses, all in flight at once.
// Each thread then reads its 16-byte vector and the neighbour vectors that
// hold its window's halo from shared memory with 16-byte loads (free of
// bank conflicts), squares and sums in registers, and writes its 16 bytes of
// output with one store. Nothing but x and y touches device memory. Where
// every lane group spans whole vectors (C / groups a multiple of 8 in bf16,
// of 4 in f32) and n = 5, every LRN of the model zoo, a neighbour vector
// outside the group adds zeros (exact: the window's sum is of squares) and
// the sums run unmasked; any other C or groups, or n of 1 to 4, tests each
// term. n above 5, which no net of the repo uses, is refused. The wrapper (kernels/lrn.py) sizes the tile so that a
// batch-8 map still gives several blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// the reach of both paths: local_size up to 2 * kMaxHalf + 1 = 5, Caffe's
// default and every LRN of the model zoo
constexpr int kMaxHalf = 2;
constexpr int kMaxSmem = 48 * 1024;

// 16 bytes global -> shared, the first `bytes` of them read, the rest zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// one 16-byte vector of T as floats, and back
template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void unpack(const uint4& r, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float (&v)[8]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return r;
  }
  __device__ static void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};
template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void unpack(const uint4& r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  __device__ static void store1(float* p, float v) { *p = v; }
};

struct Params {
  int pixels, c, cg;  // pixels of the map, channels, channels of a lane group
  int lo, hi;         // the window's offsets
  int tile;           // elements of a block's tile: whole pixels, whole vectors
  int pow_form;       // 0: s^-0.75 as r * sqrt(r); 1: powf(s, neg_beta)
  float alpha_n, k, neg_beta;
};

// neighbour vectors on each side that a window of reach kH needs
template <typename T, int kH>
__host__ __device__ constexpr int halo_vecs() {
  return (kH + Vec<T>::n - 1) / Vec<T>::n;
}

// kH: the reach compiled in. kFixed: lo = -kH and hi = kH, and every lane
// group spans whole vectors; otherwise each term is tested against lo, hi and
// its group's edges.
template <typename T, int kH, bool kFixed>
__global__ void __launch_bounds__(kThreads)
    lrn_kernel(const T* __restrict__ x, T* __restrict__ y, const Params p) {
  constexpr int V = Vec<T>::n;
  constexpr int NB = halo_vecs<T, kH>();
  constexpr int W = (2 * NB + 1) * V;  // values a thread reads
  extern __shared__ uint4 smem[];      // NB pad vectors, the tile, NB pads
  uint4* tile = smem + NB;
  const long long t0 = (long long)blockIdx.x * p.tile;
  const int n = (int)min((long long)p.tile, (long long)p.pixels * p.c - t0);
  const int nv = (n + V - 1) / V;
  for (int v = threadIdx.x; v < nv; v += kThreads)
    cp_async16(tile + v, x + t0 + (long long)v * V,
               min(V, n - v * V) * (int)sizeof(T));
  cp_async_wait_all();
  __syncthreads();

  // channel, within its lane group, of the first element of the thread's
  // vector (a tile starts a pixel, so a group), and its step per vector
  int cl0 = (threadIdx.x * V) % p.cg;
  const int cl_step = (kThreads * V) % p.cg;
  for (int v = threadIdx.x; v < nv; v += kThreads) {
    float xs[V], q[W];
#pragma unroll
    for (int b = 0; b <= 2 * NB; ++b) {
      float f[V];
      Vec<T>::unpack(tile[v - NB + b], f);
      // kFixed: vector b lies wholly inside the group or wholly outside;
      // outside it adds zeros, which leave a sum of squares as it was
      const int off = cl0 + (b - NB) * V;
      const bool in = !kFixed || (off >= 0 && off < p.cg);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        q[b * V + j] = in ? __fmul_rn(f[j], f[j]) : 0.f;
        if (b == NB) xs[j] = f[j];
      }
    }
    float out[V];
    int cl = cl0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      // -0 + t == t: the first term is taken as it is, as in the plain sum
      float w = -0.f;
#pragma unroll
      for (int d = -kH; d <= kH; ++d) {
        const float t = q[NB * V + j + d];
        if (kFixed || (d >= p.lo && d <= p.hi && cl + d >= 0 && cl + d < p.cg))
          w = __fadd_rn(w, t);
      }
      const float s = __fadd_rn(p.k, __fmul_rn(p.alpha_n, w));
      float scale;
      if (p.pow_form) {
        scale = powf(s, p.neg_beta);
      } else {
        const float r = rsqrtf(s);
        scale = __fmul_rn(r, sqrtf(r));  // s^-0.75
      }
      out[j] = __fmul_rn(xs[j], scale);
      if (++cl == p.cg) cl = 0;
    }
    cl0 += cl_step;
    if (cl0 >= p.cg) cl0 -= p.cg;
    T* dst = y + t0 + (long long)v * V;
    if (v * V + V <= n) {
      *reinterpret_cast<uint4*>(dst) = Vec<T>::pack(out);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (v * V + j < n) Vec<T>::store1(dst + j, out[j]);
    }
  }
}

template <typename T, int kH, bool kFixed>
cudaError_t launch(const void* x, void* y, const Params& p, cudaStream_t st) {
  constexpr int V = Vec<T>::n;
  const int smem = (p.tile / V + 2 * halo_vecs<T, kH>()) * 16;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const long long blocks = ((long long)p.pixels * p.c + p.tile - 1) / p.tile;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  lrn_kernel<T, kH, kFixed><<<(unsigned)blocks, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<T*>(y), p);
  return cudaGetLastError();
}

template <typename T>
int run(const void* x, void* y, const int* d, const float* f, void* stream) {
  constexpr int V = Vec<T>::n;
  const Params p{d[0], d[1], d[2], d[3], d[4], d[5], d[6], f[0], f[1], f[2]};
  if (p.pixels <= 0 || p.c <= 0 || p.cg <= 0 || p.c % p.cg || p.tile <= 0 ||
      p.tile % p.c || p.tile % V || p.lo > 0 || p.hi < 0 ||
      -p.lo > kMaxHalf || p.hi > kMaxHalf)
    return cudaErrorInvalidValue;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t e =
      p.lo == -kMaxHalf && p.hi == kMaxHalf && p.cg % V == 0
          ? launch<T, kMaxHalf, true>(x, y, p, st)
          : launch<T, kMaxHalf, false>(x, y, p, st);
  return static_cast<int>(e);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take. x, y: the
// map and its output, contiguous NHWC, 16-byte aligned, bf16 (cet_lrn) or
// f32 (cet_lrn_f32). d: pixels, C, C / groups, lo, hi, the tile's elements,
// pow_form. f: alpha / n, k, -beta.
extern "C" int cet_lrn(const void* x, void* y, const int* d, const float* f,
                       void* stream) {
  return run<__nv_bfloat16>(x, y, d, f, stream);
}
extern "C" int cet_lrn_f32(const void* x, void* y, const int* d,
                           const float* f, void* stream) {
  return run<float>(x, y, d, f, stream);
}
