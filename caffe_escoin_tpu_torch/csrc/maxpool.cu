// Caffe's max pooling over an NHWC map in one pass, for an H100 (sm_90a).
//
// It replaces no Pallas kernel: the JAX package leaves pooling to XLA's
// reduce_window (caffe_escoin_tpu/ops/pool.py), which reads the map once on
// the TPU. PyTorch ran ops/pool.py's max branch (kernels/maxpool.py's plain
// version) as three passes: a pad with -inf (a fill and a copy of the whole
// map), F.max_pool2d, which on CUDA also writes an int64 index for every
// output (4x the bf16 output's bytes), and a crop. On an H100 that reached
// about a tenth of the bound below: 0.84 ms of GoogLeNet's 2.29 ms batch-32
// query, 0.66 ms of VGG-16's 3.98 ms.
//
// What it computes: the plain version, bit for bit. y[n, oh, ow, c] is the
// max over the window's rows h in [oh * sh - ph, oh * sh - ph + kh) and
// columns w in [ow * sw - pw, ow * sw - pw + kw) that lie inside the map,
// taken as F.max_pool2d takes it: in row-major order, an element replacing
// the running max when it is greater or NaN. So a window holding a NaN gives
// its last NaN, ties keep the first element (the sign of a zero), and a
// window with no element inside the map gives -inf, which is what the
// padding and the ceil-extended edge are in the plain version. Elements are
// compared as f32 and the selected bits are the input's, never rounded. A
// column's max over each row, then the max of those rows in order, selects
// the same element as the row-major walk: the first of the largest, or the
// last NaN.
//
// What bounds it: one read of the map and one write of the output. At 3.35
// TB/s GoogLeNet's thirteen max pools take 82 us at batch 32 (275 MB),
// VGG-16's five 146 us (490 MB), ResNet-50's pool1 19 us (64 MB).
//
// What the design does about it: a thread owns one channel vector (16 bytes,
// 8 bf16 or 4 f32 lanes, where C allows it; else 8, 4 or 2 bytes) of one
// output column and walks down a strip of output rows; neighbouring threads
// hold neighbouring vectors of a pixel, then neighbouring columns, so every
// load and store is coalesced. For 3x3 windows at stride 1 or 2 and 2x2 at
// stride 2 (every max pool of the model zoo) the thread keeps the max of each
// of the window's last kh rows in registers and loads only the rows a step
// brings in, sh rows of kw vectors: a thread reads a row of the map once
// for its whole strip, not once for each of the kh windows that cross it,
// and the kw threads of neighbouring columns that share a vector meet it in
// L1. A 2x2/s2 pool is a
// stream: each vector is read once. Other windows (spp's, any k and s) take
// the same walk without the ring. The wrapper (kernels/maxpool.py) sizes
// the strips: 4 rows at stride 1, 2 at stride 2, fewer where the map is too
// small to give every SM 256 threads; one row for a 2x2/s2 stream, which
// has no rows to share. Longer strips lose more to a thread's serial walk
// than they save in loads.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

// the element types, compared as f32 on their raw bits: a bf16 word holds
// two lanes, an f32 word one
struct Bf16 {
  static constexpr int kSize = 2;
  static constexpr uint32_t kNegInf = 0xff80ff80u;
  __device__ static uint32_t fold(uint32_t m, uint32_t v) {
    const float ml = __uint_as_float(m << 16), vl = __uint_as_float(v << 16);
    const float mh = __uint_as_float(m & 0xffff0000u);
    const float vh = __uint_as_float(v & 0xffff0000u);
    const uint32_t lo = (vl > ml || vl != vl) ? v : m;
    const uint32_t hi = (vh > mh || vh != vh) ? v : m;
    return (hi & 0xffff0000u) | (lo & 0x0000ffffu);
  }
};
struct F32 {
  static constexpr int kSize = 4;
  static constexpr uint32_t kNegInf = 0xff800000u;
  __device__ static uint32_t fold(uint32_t m, uint32_t v) {
    const float mf = __uint_as_float(m), vf = __uint_as_float(v);
    return (vf > mf || vf != vf) ? v : m;
  }
};

// one channel vector of kBytes bytes as 32-bit words (a 2-byte vector in the
// low half of its word)
template <class E, int kBytes>
struct Vec {
  static constexpr int kWords = (kBytes + 3) / 4;
  uint32_t w[kWords];

  __device__ static Vec neg_inf() {
    Vec r;
#pragma unroll
    for (int i = 0; i < kWords; ++i) r.w[i] = E::kNegInf;
    return r;
  }
  // the running max m replaced, lane by lane, by v where v is greater or NaN
  __device__ void fold(const Vec& v) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = E::fold(w[i], v.w[i]);
  }
  __device__ static Vec load(const char* p) {
    Vec r;
    if constexpr (kBytes == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      r.w[0] = v.x, r.w[1] = v.y, r.w[2] = v.z, r.w[3] = v.w;
    } else if constexpr (kBytes == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      r.w[0] = v.x, r.w[1] = v.y;
    } else if constexpr (kBytes == 4) {
      r.w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      r.w[0] = *reinterpret_cast<const uint16_t*>(p);
    }
    return r;
  }
  __device__ void store(char* p) const {
    if constexpr (kBytes == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else if constexpr (kBytes == 4) {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    } else {
      *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(w[0]);
    }
  }
};

struct Params {
  int n, h, w, c;          // the input map, NHWC, c in elements
  int ho, wo;              // the output's rows and columns
  int kh, kw, sh, sw, ph, pw;
  int lanes;               // elements of a thread's vector
  int rows;                // output rows of a strip, walked by one thread
  int threads, blocks;     // the launch
};

// a thread's place: image, channel vector, output column, strip of rows
struct Place {
  int n, cv, ow, oh0, oh1;
};

__device__ __forceinline__ bool place(const Params& p, Place& t) {
  const int cvs = p.c / p.lanes;
  const int strips = (p.ho + p.rows - 1) / p.rows;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n * strips * p.wo * cvs) return false;
  t.cv = i % cvs;
  i /= cvs;
  t.ow = i % p.wo;
  i /= p.wo;
  const int strip = i % strips;
  t.n = i / strips;
  t.oh0 = strip * p.rows;
  t.oh1 = min(t.oh0 + p.rows, p.ho);
  return true;
}

// kKH x kKW windows at row stride kSH: the max of each of the window's rows
// kept in a ring of registers, only the rows a step brings in loaded
template <class E, int kBytes, int kKH, int kKW, int kSH>
__global__ void __launch_bounds__(kMaxThreads)
    maxpool_kernel(const char* __restrict__ x, char* __restrict__ y,
                   const Params p) {
  using V = Vec<E, kBytes>;
  Place t;
  if (!place(p, t)) return;
  const long long pix = (long long)p.c * E::kSize;
  const char* xn =
      x + (long long)t.n * p.h * p.w * pix + (long long)t.cv * kBytes;
  const int w0 = t.ow * p.sw - p.pw;
  // the max of input row h over the window's columns (-inf outside the map)
  auto row = [&](int h) {
    V m = V::neg_inf();
    if (h >= 0 && h < p.h) {
      const char* xr = xn + (long long)h * p.w * pix;
#pragma unroll
      for (int j = 0; j < kKW; ++j) {
        const int wc = w0 + j;
        if (wc >= 0 && wc < p.w) m.fold(V::load(xr + wc * pix));
      }
    }
    return m;
  };
  constexpr int kNew = kSH < kKH ? kSH : kKH;  // rows a step loads
  V r[kKH];
  int h0 = t.oh0 * kSH - p.ph;
#pragma unroll
  for (int i = 0; i < kKH; ++i) r[i] = row(h0 + i);
  char* out = y + (((long long)t.n * p.ho + t.oh0) * p.wo + t.ow) * pix +
              (long long)t.cv * kBytes;
  const long long out_row = (long long)p.wo * pix;
  for (int oh = t.oh0;;) {
    // fold(-inf, r[0]) is r[0], bit for bit
    V m = r[0];
#pragma unroll
    for (int i = 1; i < kKH; ++i) m.fold(r[i]);
    m.store(out);
    if (++oh == t.oh1) break;
    out += out_row;
    h0 += kSH;
#pragma unroll
    for (int i = 0; i < kKH - kNew; ++i) r[i] = r[i + kNew];
#pragma unroll
    for (int i = kKH - kNew; i < kKH; ++i) r[i] = row(h0 + i);
  }
}

// any window and stride: each output's window clipped to the map and walked
// in row-major order
template <class E, int kBytes>
__global__ void __launch_bounds__(kMaxThreads)
    maxpool_window_kernel(const char* __restrict__ x, char* __restrict__ y,
                          const Params p) {
  using V = Vec<E, kBytes>;
  Place t;
  if (!place(p, t)) return;
  const long long pix = (long long)p.c * E::kSize;
  const char* xn =
      x + (long long)t.n * p.h * p.w * pix + (long long)t.cv * kBytes;
  const int ws = t.ow * p.sw - p.pw;
  const int w_lo = max(ws, 0), w_hi = min(ws + p.kw, p.w);
  char* out = y + (((long long)t.n * p.ho + t.oh0) * p.wo + t.ow) * pix +
              (long long)t.cv * kBytes;
  for (int oh = t.oh0; oh < t.oh1; ++oh, out += (long long)p.wo * pix) {
    const int hs = oh * p.sh - p.ph;
    V m = V::neg_inf();
    for (int h = max(hs, 0); h < min(hs + p.kh, p.h); ++h)
      for (int w = w_lo; w < w_hi; ++w)
        m.fold(V::load(xn + ((long long)h * p.w + w) * pix));
    m.store(out);
  }
}

template <class E, int kBytes>
cudaError_t launch(const char* x, char* y, const Params& p, cudaStream_t st) {
  const dim3 grid(p.blocks), block(p.threads);
  if (p.kh == 3 && p.kw == 3 && p.sh == 1)
    maxpool_kernel<E, kBytes, 3, 3, 1><<<grid, block, 0, st>>>(x, y, p);
  else if (p.kh == 3 && p.kw == 3 && p.sh == 2)
    maxpool_kernel<E, kBytes, 3, 3, 2><<<grid, block, 0, st>>>(x, y, p);
  else if (p.kh == 2 && p.kw == 2 && p.sh == 2)
    maxpool_kernel<E, kBytes, 2, 2, 2><<<grid, block, 0, st>>>(x, y, p);
  else
    maxpool_window_kernel<E, kBytes><<<grid, block, 0, st>>>(x, y, p);
  return cudaGetLastError();
}

template <class E>
int run(const void* x, void* y, const int* d, void* stream) {
  const Params p{d[0], d[1], d[2],  d[3],  d[4],  d[5],  d[6],  d[7],
                 d[8], d[9], d[10], d[11], d[12], d[13], d[14], d[15]};
  if (p.n <= 0 || p.h <= 0 || p.w <= 0 || p.c <= 0 || p.ho <= 0 ||
      p.wo <= 0 || p.kh <= 0 || p.kw <= 0 || p.sh <= 0 || p.sw <= 0 ||
      p.ph < 0 || p.pw < 0 || p.lanes <= 0 || p.c % p.lanes || p.rows <= 0 ||
      p.threads <= 0 || p.threads > kMaxThreads || p.threads % 32 ||
      p.blocks <= 0)
    return cudaErrorInvalidValue;
  const long long threads = (long long)p.n * ((p.ho + p.rows - 1) / p.rows) *
                            p.wo * (p.c / p.lanes);
  if (threads > INT_MAX - kMaxThreads ||
      (long long)p.blocks * p.threads < threads ||
      (long long)(p.blocks - 1) * p.threads >= threads)
    return cudaErrorInvalidValue;
  const char* xc = static_cast<const char*>(x);
  char* yc = static_cast<char*>(y);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (p.lanes * E::kSize) {
    case 16: e = launch<E, 16>(xc, yc, p, st); break;
    case 8: e = launch<E, 8>(xc, yc, p, st); break;
    case 4: e = launch<E, 4>(xc, yc, p, st); break;
    case 2:
      if constexpr (E::kSize == 2) e = launch<E, 2>(xc, yc, p, st);
      break;
    default: break;
  }
  return static_cast<int>(e);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take. x, y: the
// map and its output, contiguous NHWC, aligned to the vector's bytes, bf16
// (cet_maxpool) or f32 (cet_maxpool_f32). d: N, H, W, C, Ho, Wo, kh, kw, sh,
// sw, ph, pw, the vector's lanes (8, 4, 2 or 1 in bf16; 4, 2 or 1 in f32,
// dividing C), the output rows a thread walks, threads a block, blocks.
extern "C" int cet_maxpool(const void* x, void* y, const int* d,
                           void* stream) {
  return run<Bf16>(x, y, d, stream);
}
extern "C" int cet_maxpool_f32(const void* x, void* y, const int* d,
                               void* stream) {
  return run<F32>(x, y, d, stream);
}
