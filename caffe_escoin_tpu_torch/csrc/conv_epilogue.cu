// A dense conv's bias, residual and ReLU over its NHWC output in one pass,
// for an H100 (sm_90a).
//
// It replaces no Pallas kernel: the JAX package leaves the dense conv to XLA
// (caffe_escoin_tpu/ops/conv.py, conv2d_dense), which fuses the bias and the
// ReLU into the convolution on the TPU. PyTorch ran them as separate passes
// over cuDNN's output (kernels/conv_epilogue.py's plain version): ATen's
// F.conv2d runs cuDNN without the bias and then adds it with a broadcast
// add_, which over a channels_last output falls to an unvectorized
// elementwise kernel, and torch.relu is a second pass. On an H100 that took
// 1.56 ms of VGG-16's 3.33 ms batch-32 query, about 40% and 89% of the
// bound below for the two passes.
//
// What it computes: the plain version, bit for bit. With t the element type
// (bf16 or f32) and every sum taken in f32 and rounded to t, as PyTorch's
// two-operand adds do:
//   y = t(y + bias[c])         where a bias is given
//   y = t(y + residual)        where a residual is given
//   y = isnan(y) ? y : fmaxf(y, 0)   with ReLU (torch.relu's clamp)
// A NaN keeps its bits through the ReLU, as it does in the clamp.
//
// What bounds it: one read of the conv's output, of the residual where there
// is one, and one write. At 3.35 TB/s VGG-16's six dense convs at batch 32
// (719 MB of bf16 output) take 0.429 ms.
//
// What the design does about it: a thread owns one channel vector (16 bytes,
// 8 bf16 or 4 f32 lanes, where C and the pointers allow it; else one
// element), neighbouring threads on neighbouring vectors, so every load and
// store is coalesced, and the grid covers the map once, as a copy kernel
// does. The thread reads its bias vector, 16 bytes that every block shares
// from L1. Measured at VGG-16's conv1_2 b32 on an H100 (700 W): one vector a
// thread reaches 88.3% of the bound, a plain copy 88.7%; a grid of one
// resident wave walking the map in a grid-stride loop, which keeps each
// thread's bias in registers, 80.5-84.4%. Where cuDNN's output is contiguous
// NHWC (every conv of the model zoo) the kernel writes over it in place;
// otherwise it reads through the output's strides and writes a new
// contiguous map.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 256;

// the element types, held as their raw bits
struct Bf16 {
  using Bits = uint16_t;
  __device__ static float get(Bits b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  // round to nearest even, as c10::BFloat16's conversion on the card
  __device__ static Bits put(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};
struct F32 {
  using Bits = float;
  __device__ static float get(Bits b) { return b; }
  __device__ static Bits put(float f) { return f; }
};

// one channel vector of kLanes elements, loaded and stored as one word where
// it is 16 bytes
template <class E, int kLanes>
union Vec {
  using Bits = typename E::Bits;
  static constexpr bool kWide = sizeof(Bits) * kLanes == 16;
  std::conditional_t<kWide, uint4, Bits> word;
  Bits lane[kLanes];

  __device__ static Vec load(const Bits* p) {
    Vec v;
    if constexpr (kWide) {
      v.word = *reinterpret_cast<const uint4*>(p);
    } else {
#pragma unroll
      for (int l = 0; l < kLanes; ++l) v.lane[l] = p[l];
    }
    return v;
  }
  __device__ void store(Bits* p) const {
    if constexpr (kWide) {
      *reinterpret_cast<uint4*>(p) = word;
    } else {
#pragma unroll
      for (int l = 0; l < kLanes; ++l) p[l] = lane[l];
    }
  }
};

struct Params {
  int n, h, w, c;      // the map, NHWC, c in elements
  int sn, sh, sw, sc;  // the conv output's strides, in elements (kStrided)
  int lanes;           // elements of a thread's vector
  int threads, blocks;  // the launch
  int relu;
  int strided;         // read through the strides; else contiguous NHWC
};

// y: the conv's output, read; out: the contiguous result (y itself when in
// place); bias [C] and residual (contiguous NHWC) may be null
template <class E, int kLanes, bool kStrided>
__global__ void __launch_bounds__(kMaxThreads)
    conv_epilogue_kernel(const typename E::Bits* y,
                         const typename E::Bits* __restrict__ bias,
                         const typename E::Bits* __restrict__ res,
                         typename E::Bits* out, const Params p) {
  using V = Vec<E, kLanes>;
  using Bits = typename E::Bits;
  const int cvs = p.c / kLanes;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // the vector
  if (i >= p.n * p.h * p.w * cvs) return;
  const int cv = i % cvs;
  long long src = (long long)i * kLanes;
  if constexpr (kStrided) {
    const int pix = i / cvs, t = pix / p.w;
    src = (long long)(t / p.h) * p.sn + (long long)(t % p.h) * p.sh +
          (long long)(pix % p.w) * p.sw + (long long)cv * kLanes * p.sc;
  }
  V v = V::load(y + src);
  V r, b;
  if (res) r = V::load(res + (long long)i * kLanes);
  if (bias) b = V::load(bias + cv * kLanes);
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
    Bits x = v.lane[l];
    if (bias) x = E::put(E::get(x) + E::get(b.lane[l]));
    if (res) x = E::put(E::get(x) + E::get(r.lane[l]));
    if (p.relu) {
      const float a = E::get(x);
      if (!isnan(a)) x = E::put(fmaxf(a, 0.0f));
    }
    v.lane[l] = x;
  }
  v.store(out + (long long)i * kLanes);
}

template <class E, int kLanes>
cudaError_t launch(const void* y, const void* bias, const void* res, void* out,
                   const Params& p, cudaStream_t st) {
  using Bits = typename E::Bits;
  const dim3 grid(p.blocks), block(p.threads);
  const Bits* yb = static_cast<const Bits*>(y);
  const Bits* bb = static_cast<const Bits*>(bias);
  const Bits* rb = static_cast<const Bits*>(res);
  Bits* ob = static_cast<Bits*>(out);
  if (p.strided)
    conv_epilogue_kernel<E, kLanes, true><<<grid, block, 0, st>>>(yb, bb, rb,
                                                                  ob, p);
  else
    conv_epilogue_kernel<E, kLanes, false><<<grid, block, 0, st>>>(yb, bb, rb,
                                                                   ob, p);
  return cudaGetLastError();
}

template <class E>
int run(const void* y, const void* bias, const void* res, void* out,
        const int* d, void* stream) {
  const Params p{d[0], d[1], d[2], d[3],  d[4],  d[5], d[6],
                 d[7], d[8], d[9], d[10], d[11], d[12]};
  constexpr int kWide = 16 / static_cast<int>(sizeof(typename E::Bits));
  const long long vectors =
      p.lanes > 0 ? (long long)p.n * p.h * p.w * (p.c / p.lanes) : 0;
  if (p.n <= 0 || p.h <= 0 || p.w <= 0 || p.c <= 0 ||
      (p.lanes != 1 && p.lanes != kWide) || p.c % p.lanes ||
      p.threads <= 0 || p.threads > kMaxThreads || p.threads % 32 ||
      p.blocks <= 0 || vectors > INT_MAX - kMaxThreads ||
      (long long)p.blocks * p.threads < vectors ||
      (long long)(p.blocks - 1) * p.threads >= vectors ||
      (p.strided && (p.sn < 0 || p.sh < 0 || p.sw < 0 || p.sc < 0)) ||
      (p.strided && p.lanes > 1 &&
       (p.sc != 1 || p.sn % p.lanes || p.sh % p.lanes || p.sw % p.lanes)) ||
      (p.strided && y == out) || !y || !out)
    return cudaErrorInvalidValue;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t e = p.lanes == 1
                            ? launch<E, 1>(y, bias, res, out, p, st)
                            : launch<E, kWide>(y, bias, res, out, p, st);
  return static_cast<int>(e);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take. y: the conv's
// NHWC output (read through its strides where d says so); bias: [C] or null;
// residual: contiguous NHWC or null; out: the contiguous result, y itself
// when in place; all bf16 (cet_conv_epilogue) or f32 (cet_conv_epilogue_f32),
// aligned to the vector's bytes. d: N, H, W, C, y's strides over N, H, W, C
// in elements, the vector's lanes (8 in bf16 or 4 in f32, dividing C, or 1),
// threads a block, blocks (one thread a vector: the fewest that cover the
// map), ReLU, strided.
extern "C" int cet_conv_epilogue(const void* y, const void* bias,
                                 const void* residual, void* out,
                                 const int* d, void* stream) {
  return run<Bf16>(y, bias, residual, out, d, stream);
}
extern "C" int cet_conv_epilogue_f32(const void* y, const void* bias,
                                     const void* residual, void* out,
                                     const int* d, void* stream) {
  return run<F32>(y, bias, residual, out, d, stream);
}
