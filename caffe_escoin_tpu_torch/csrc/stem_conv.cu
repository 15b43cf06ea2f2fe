// A dense conv over an NHWC image of at most 4 channels (a net's stem), as
// one implicit GEMM with its bias and ReLU, for an H100 (sm_90a).
//
// It replaces no Pallas kernel: the JAX package leaves the dense conv to XLA
// (caffe_escoin_tpu/ops/conv.py, conv2d_dense). On the card the port ran
// these convs as cuDNN plus kernels/conv_epilogue.py: for a 3-channel input
// cuDNN either falls to a CUDA-core direct conv (convolve_common_engine_
// float_NHWC: AlexNet's 11x11/s4 conv1, and the 7x7/s2 stems at batch 1) or
// pads the channels to 8 with a copy of the image (nhwcAddPaddingKernel)
// before a tensor-core fprop, and the bias and ReLU are a second pass over
// the output.
//
// What it computes: out[n, oy, ox, co] = bf16(relu(bias[co] + sum over
// (i, j, c) of x[n, oy*s - p + i, ox*s - p + j, c] * w[i, j, c, co])), the
// sum in f32 on the tensor cores, positions outside the image reading 0,
// rounded once. ReLU keeps a NaN (torch.relu's clamp).
//
// What bounds it: the GEMM is M = N*Ho*Wo pixels by N = Cout by K =
// kh*kw*Cin. At batch 32 AlexNet's conv1 does 6.75 GFLOP (6.8 us at 989
// TFLOP/s) against 28.5 MB of bf16 in and out (8.5 us at 3.35 TB/s); the
// 7x7/s2 stems 7.5 GFLOP against 61 MB (18 us); VGG's conv1_1 5.5 GFLOP
// against 215 MB (64 us). Bytes bound all three, AlexNet's barely, so the
// kernel must read the image and write the output once, and keep the
// multiply off the CUDA cores. Inside the block the shared-memory pipe is
// the limit: every A value is gathered from the staged image, and every
// warp reads the whole weight slice of a K step.
//
// What the design does about it:
// * Persistent blocks walk tiles of 256 consecutive output pixels of one
//   image. The whole weight, laid out once by the wrapper in the order the
//   wgmma B descriptors read it (``kernels/stem_conv.kernel_weight``),
//   stays in shared memory for the block's life (AlexNet's: 384 x 96 x 2 =
//   72 KB), with the bias and a table of each K step's offsets into the
//   input window. K runs over kernel rows i, each row's kw*Cin values
//   padded with zero weights to an even count (AlexNet 33 -> 34, the 7x7
//   stems 21 -> 22, VGG 9 -> 10), so that no pair of K values straddles
//   two rows; K_pad = kh * that, up to a multiple of 16 (384, 160, 32).
// * Input window: the full-width image rows a tile reads, (rows - 1)*s + kh
//   rows of (Wo - 1)*s + kw columns, each row one bulk copy (the TMA
//   engine, counted on an mbarrier) of the whole image row, which is
//   contiguous in NHWC. A 3-channel row is not 16-byte aligned, so each
//   window row is placed at the same offset modulo 8 elements as its
//   source (the row pitch is W*C modulo 8 and the window's first element
//   sits at 8 + its source offset modulo 8): the copy lands aligned and no
//   element moves twice. The conv's zero padding and the bytes a copy
//   reads past a row are zeroed in shared memory once it lands; the image
//   is never padded in device memory. The next tile's copies fly while
//   this tile multiplies.
// * Multiply: wgmma (m64 x Cout_pad x k16, bf16 -> f32) with A from
//   registers and B from shared memory. A warpgroup owns one or two m64
//   tiles, all of Cout: four warpgroups of one for Cout_pad > 64 (the
//   registers of 512 threads), else two of two, and two blocks a SM where
//   shared memory allows (64-wide stems): the phases of one block's tile
//   overlap the other's. A thread's A values come in pairs of
//   consecutive K in one kernel row, which are consecutive elements of
//   the window; a pair is read as one 32-bit load, from the window where
//   it starts at an even element and else from a copy of the window
//   shifted by one element, built in shared memory once a tile (only the
//   rows that need it where s*c is even). Element (pixel m, k) sits at
//   base(m) + koff(k), so a thread keeps two bases a pixel row and reads
//   its two pair offsets (and their masks of the padded K) a step with one
//   16-byte load. Three register sets of A: a step's loads run while the
//   two steps before it multiply. A padded K is masked to zero in A as
//   well, so a non-finite pixel never reaches a zero weight.
// * Epilogue: + bias in f32, ReLU, one rounding to bf16, the tile staged in
//   shared memory (over the window the tile no longer reads) and written
//   with coalesced 16-byte stores: the output is written once, and nothing
//   else runs for the layer.
// Measured on an H100 80GB HBM3 (700 W), b32, as a CUDA graph: AlexNet's
// conv1 0.034 ms, the 7x7/s2 stems 0.048-0.050, VGG's conv1_1 0.112. On
// the way: mma.sync with ldmatrix B fragments held AlexNet's conv1 at
// 0.039 ms and the 7x7 stems at 0.063-0.073; two blocks a SM took the 7x7
// stems from 0.064 to 0.050 and VGG's from 0.161 to 0.117. Not kept: one
// bulk store a pixel row (it queued on the TMA engine), two K steps a
// wgmma group (slower), and for AlexNet two 128-pixel tile walks a block
// sharing the weight (1 us, with or without turns at the tensor cores).

#include "sconv_pipe.cuh"

namespace {

using cet::pipe::cp_async16;
using cet::pipe::cp_async_commit;
using cet::pipe::cp_async_wait;
using cet::pipe::smem_u32;

constexpr int kTileM = 256;  // output pixels a tile
// A block's warps: 4 warpgroups of one m64 tile each for a wide output
// (Cout_pad > 64: registers for 512 threads), else 2 of two m64 tiles
// each, two blocks a SM where shared memory allows. Every warp owns 16
// pixel rows of each of its warpgroup's m64 tiles.
template <int kN8>
struct Shape {
  static constexpr int kMI = kN8 > 8 ? 1 : 2;  // m64 tiles a warpgroup
  static constexpr int kThreads = kTileM / kMI * 2;
  static constexpr int kBlocksPerSM = kN8 > 8 ? 1 : 2;
};
constexpr int kMaxSmem = 232448;
constexpr int kMaxC = 4;

struct Params {
  int n, h, w, c;     // the image, NHWC
  int ho, wo, cout;   // the output
  int kh, kw, s, p;   // the window: size, stride, padding (square)
  int cout_pad;       // 8 * the compiled n8 tiles
  int k_pad;          // kh * (kw*c rounded up to even), up to 16
  int rows;           // window rows a tile holds at most
  int rs;             // window row pitch, elements (= w*c modulo 8)
  int win;            // elements of one window buffer
  int tiles_per_img, tiles, blocks, smem;
  int relu;
};

// the layout of a block's dynamic shared memory, in bytes: the weight (as
// the wgmma B descriptors read it: for each K step, Cout_pad/8 x 2 core
// matrices of 8 output channels x 8 K values, 128 bytes each, the two K
// halves of a channel group adjacent), the K table, the bias, then window
// A0, the shifted copy, window A1. A tile's output is staged over its own
// window and the shifted copy (A0 + copy, or copy + A1), which it no
// longer reads by then.
struct Layout {
  int wp;  // stage row pitch, elements: cout_pad + 8
  int shifted;  // elements of the shifted copy's region
  int w_off, koff_off, bias_off, a0_off, b_off, a1_off, total;
  __host__ __device__ explicit Layout(const Params& p) {
    wp = p.cout_pad + 8;
    shifted = max(p.win, kTileM * wp - p.win);
    w_off = 0;
    koff_off = w_off + p.k_pad * p.cout_pad * 2;
    bias_off = koff_off + p.k_pad * 4;
    a0_off = bias_off + p.cout_pad * 4;
    b_off = a0_off + p.win * 2;
    a1_off = b_off + shifted * 2;
    total = a1_off + p.win * 2;
  }
};

// the bulk copy engine (TMA without a tensor map): whole rows from global
// to shared memory, completion counted on an mbarrier; sizes and
// addresses in multiples of 16 bytes
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// this thread's shared-memory writes before what the bulk copies do after
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a walk over i = first, first + blockDim.x, ... as (i / n, i % n) without
// a division a step
struct Walk {
  int q, r, dq, dr;
  __device__ Walk(int first, int n)
      : q(first % n),
        r(first / n),
        dq((int)blockDim.x % n),
        dr((int)blockDim.x / n) {}
  __device__ void next(int n) {
    q += dq;
    r += dr;
    if (q >= n) {
      q -= n;
      ++r;
    }
  }
};

struct Tile {
  int img, m0, valid;  // image, first pixel in it, pixels in the tile
  int oy0, y0, rows;   // first output row, its first image row, rows read
  int skew;            // window element of image column -p in row y0
};

__device__ Tile tile_of(int t, const Params& p) {
  Tile r;
  r.img = t / p.tiles_per_img;
  r.m0 = (t - r.img * p.tiles_per_img) * kTileM;
  r.valid = min(kTileM, p.ho * p.wo - r.m0);
  r.oy0 = r.m0 / p.wo;
  const int oy1 = (r.m0 + r.valid - 1) / p.wo;
  r.y0 = r.oy0 * p.s - p.p;
  r.rows = (oy1 - r.oy0) * p.s + p.kh;
  const long long g = ((long long)(r.img * p.h + r.y0) * p.w - p.p) * p.c;
  r.skew = 8 + (int)(g & 7);
  return r;
}

// the copies of a tile's in-image rows into `buf`, one bulk copy a row by
// the lanes of warp 0, counted on mbarrier `bar`; row r of the window
// starts at buf + skew + r*rs, image column x at + (x + p)*c. A row's
// copy runs from the 16-byte boundary before its first element to the one
// after its last, but not past the image tensor's last 16-byte boundary:
// elements past it are copied by the lane itself.
__device__ void issue_window(const __nv_bfloat16* x, __nv_bfloat16* buf,
                             const Tile& t, const Params& p, long long total,
                             uint32_t bar) {
  const int lane = threadIdx.x & 31;
  const int wc = p.w * p.c;
  const long long end8 = total & ~7LL;
  uint32_t bytes = 0;
  for (int r = lane; r < t.rows; r += 32) {
    const int y = t.y0 + r;
    if (y < 0 || y >= p.h) continue;
    const long long g0 = (long long)(t.img * p.h + y) * wc;
    const long long cs = g0 & ~7LL;
    const long long ce = min((g0 + wc + 7) & ~7LL, end8);
    if (ce > cs) bytes += (uint32_t)(2 * (ce - cs));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) bytes += __shfl_xor_sync(~0u, bytes, o);
  if (lane == 0) mbar_expect_tx(bar, bytes);
  __syncwarp();
  for (int r = lane; r < t.rows; r += 32) {
    const int y = t.y0 + r;
    if (y < 0 || y >= p.h) continue;
    const long long g0 = (long long)(t.img * p.h + y) * wc;
    const long long cs = g0 & ~7LL;
    const long long ce = min((g0 + wc + 7) & ~7LL, end8);
    __nv_bfloat16* row = buf + t.skew + r * p.rs + p.p * p.c - g0;
    if (ce > cs)
      bulk_load(smem_u32(row + cs), x + cs, (uint32_t)(2 * (ce - cs)), bar);
    for (long long e = max(ce, g0); e < g0 + wc; ++e) row[e] = x[e];
  }
}

// zeros where the window reads no image element: rows above or below the
// image, the columns of the padding, and what the copies wrote there
__device__ void zero_pads(__nv_bfloat16* buf, const Tile& t,
                          const Params& p) {
  const int width = ((p.wo - 1) * p.s + p.kw) * p.c;  // window row, elements
  const int lpad = p.p * p.c, rpad = (p.p + p.w) * p.c;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < t.rows; r += (int)(blockDim.x >> 5)) {
    __nv_bfloat16* row = buf + t.skew + r * p.rs;
    const int y = t.y0 + r;
    if (y < 0 || y >= p.h) {
      for (int e = lane; e < width; e += 32) row[e] = zero;
    } else {
      // the copies may write up to 7 elements before the row's first
      // image element and after its last
      for (int e = lane; e < lpad; e += 32) row[e] = zero;
      for (int e = rpad + lane; e < width; e += 32) row[e] = zero;
    }
  }
}

// sh[j] = a[j - 1] for the 16-byte chunk q of `sh`
__device__ __forceinline__ void shift_chunk(const __nv_bfloat16* a,
                                            __nv_bfloat16* sh, int q) {
  const uint4 v = reinterpret_cast<const uint4*>(a)[q];
  const uint32_t prev = reinterpret_cast<const uint16_t*>(a)[8 * q - 1];
  uint4 o;
  o.x = __funnelshift_l(prev << 16, v.x, 16);
  o.y = __funnelshift_l(v.x, v.y, 16);
  o.z = __funnelshift_l(v.y, v.z, 16);
  o.w = __funnelshift_l(v.z, v.w, 16);
  reinterpret_cast<uint4*>(sh)[q] = o;
}

// the window shifted by one element, sh[j] = a[j - 1], so that a pair
// starting at an odd element of `a` starts at an even one of `sh`: over
// the tile's rows where some pair starts at an odd element. With an even
// s*c every pair of window row r starts at the parity of its first
// element, so only the rows where that is odd are shifted; else all.
__device__ void shift_window(const __nv_bfloat16* a, __nv_bfloat16* sh,
                             const Tile& t, const Params& p) {
  if ((p.s * p.c) & 1) {
    const int lo = t.skew / 8, hi = (t.skew + t.rows * p.rs + 2 + 7) / 8;
    for (int q = lo + threadIdx.x; q < hi; q += (int)blockDim.x)
      shift_chunk(a, sh, q);
    return;
  }
  const int width = ((p.wo - 1) * p.s + p.kw) * p.c;
  const int per_row = width / 8 + 3;  // chunks of [first + 1, first + width + 2)
  for (Walk it(threadIdx.x, per_row); it.r < t.rows; it.next(per_row)) {
    const int first = t.skew + it.r * p.rs;
    if (!(first & 1)) continue;
    const int q = ((first + 1) >> 3) + it.q;
    if (8 * q < first + width + 2) shift_chunk(a, sh, q);
  }
}

// d[64 x 8*kN8] += a[64 x 16] @ B[16 x 8*kN8] for the warpgroup (wgmma, A
// from registers as mma.m16n8k16 holds it, 16 rows a warp; B from shared
// memory through its descriptor); d as kN8 n8 tiles in mma.m16n8k16's C
// layout
__device__ __forceinline__ void wgmma_n32(float (&d)[4][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, 1, 1;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, 1, 1;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
__device__ __forceinline__ void wgmma_n96(float (&d)[12][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, 1, 1;\n"
      " wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
__device__ __forceinline__ void wgmma_n128(float (&d)[16][4],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, 1, 1;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
template <int kN8>
__device__ __forceinline__ void wgmma_step(float (&d)[kN8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (kN8 == 4) wgmma_n32(d, a, desc);
  if constexpr (kN8 == 8) wgmma_n64(d, a, desc);
  if constexpr (kN8 == 12) wgmma_n96(d, a, desc);
  if constexpr (kN8 == 16) wgmma_n128(d, a, desc);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kN>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kN) : "memory");
}
// keeps a register where it is up to here: an asynchronous wgmma reads its
// A registers and writes its accumulators until a wait says it is done,
// which the compiler cannot see
__device__ __forceinline__ void hold(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void hold(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
template <typename T, int kA, int kB>
__device__ __forceinline__ void hold(T (&r)[kA][kB]) {
#pragma unroll
  for (int i = 0; i < kA; ++i)
#pragma unroll
    for (int j = 0; j < kB; ++j) hold(r[i][j]);
}

// the descriptor of a K-major B tile without swizzle: 8 x 16-byte core
// matrices, 128 contiguous bytes each; K-adjacent ones `lbo` bytes apart,
// N-adjacent ones `sbo` bytes apart
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, uint32_t lbo,
                                           uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3fff) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32);
}

// A of one k16 step for the warp's 16 rows of each of its kMI m64 tiles:
// the thread's pixel rows
// (mi, h) read their pairs at x[mi][h][0] + koff where koff/2 is even, at
// x[mi][h][1] + koff where it is odd (kOdd; with an even row pitch every
// koff/2 is even), each base already in the window or the shifted copy so
// that the address is 4-byte aligned; t: the table entry (koff of the lo
// and hi pair, bytes, then their masks).
template <int kMI, bool kOdd>
__device__ __forceinline__ void load_a(uint32_t (&a)[kMI][4], const char* sm,
                                       const int (&x)[kMI][2][2],
                                       const int4& t) {
  const bool odd_lo = kOdd && (t.x & 2), odd_hi = kOdd && (t.y & 2);
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int blo = odd_lo ? x[mi][h][1] : x[mi][h][0];
      const int bhi = odd_hi ? x[mi][h][1] : x[mi][h][0];
      a[mi][h] = *reinterpret_cast<const uint32_t*>(sm + blo + t.x) &
                 (uint32_t)t.z;
      a[mi][2 + h] = *reinterpret_cast<const uint32_t*>(sm + bhi + t.y) &
                     (uint32_t)t.w;
    }
  }
}

template <int kN8, bool kOdd>
__global__ void __launch_bounds__(Shape<kN8>::kThreads,
                                  Shape<kN8>::kBlocksPerSM)
    stem_conv_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ wg,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, const Params p) {
  constexpr int kMI = Shape<kN8>::kMI;
  constexpr int kThreads = Shape<kN8>::kThreads;
  extern __shared__ __align__(16) char smem[];
  __shared__ __align__(8) unsigned long long bars[2];  // window landed
  const Layout L(p);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + L.w_off);
  const int4* table = reinterpret_cast<const int4*>(smem + L.koff_off);
  float* bs = reinterpret_cast<float*>(smem + L.bias_off);
  __nv_bfloat16* shifted = reinterpret_cast<__nv_bfloat16*>(smem + L.b_off);
  const long long total = (long long)p.n * p.h * p.w * p.c;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  auto window_off = [&](int i) { return (i & 1) ? L.a1_off : L.a0_off; };
  auto window = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(smem + window_off(i));
  };
  const uint32_t bar0 = smem_u32(&bars[0]);
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the weight (cp.async, one group), the first tile's window (bulk)
  for (int i = tid; i < p.k_pad * p.cout_pad / 8; i += kThreads)
    cp_async16(smem_u32(ws + 8 * i), wg + 8 * i, true);
  cp_async_commit();
  int t = blockIdx.x;
  if (warp == 0) issue_window(x, window(0), tile_of(t, p), p, total, bar0);
  for (int i = tid; i < p.cout_pad; i += kThreads)
    bs[i] = (bias && i < p.cout) ? bias[i] : 0.0f;
  // one int4 a (K step ks, thread quad q): the window byte offsets of the
  // pairs k = 16*ks + 2*q + {0, 1} and + {8, 9}, then their masks (the
  // 16-bit halves that hold a padded K are 0). Pair k lies in kernel row
  // i = k / rk (rk: kw*c rounded up to even) at element k - i*rk of it.
  const int rk = (p.kw * p.c + 1) & ~1, row_real = p.kw * p.c;
  for (int i = tid; i < p.k_pad / 4; i += kThreads) {
    const int ks = i >> 2, q = i & 3;
    int v[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = ks * 16 + 2 * q + 8 * e;
      const int ki = k / rk, r = k - ki * rk;
      const bool live0 = ki < p.kh && r < row_real;
      const bool live1 = ki < p.kh && r + 1 < row_real;
      v[e] = live0 ? 2 * (ki * p.rs + r) : 0;
      v[2 + e] = (live0 ? 0xffff : 0) | (live1 ? (int)0xffff0000u : 0);
    }
    reinterpret_cast<int4*>(smem + L.koff_off)[i] =
        make_int4(v[0], v[1], v[2], v[3]);
  }
  const int steps = p.k_pad / 16;
  const uint32_t w_smem = smem_u32(ws);
  const int c8 = p.cout / 8;
  const uint32_t w_step = p.cout_pad * 32;  // bytes of a K step's B
  // warpgroup wgi owns tile rows [64*kMI*wgi, 64*kMI*(wgi + 1)) as kMI
  // m64 tiles; warp wq of it rows 16*wq + {g, g + 8} of each
  const int wgi = warp >> 2, wq = warp & 3;
  auto tile_row = [&](int mi, int h) {
    return 64 * kMI * wgi + 64 * mi + 16 * wq + 8 * h + g;
  };

  for (int it = 0; t < p.tiles; ++it, t += p.blocks) {
    const Tile tl = tile_of(t, p);
    __nv_bfloat16* cur = window(it);
    cp_async_wait<0>();  // the weight (the first tile)
    fence_async();       // the last tile's reads before the next copies
    mbar_wait(bar0 + 8 * (it & 1), (it >> 1) & 1);
    __syncthreads();
    if (warp == 0 && t + p.blocks < p.tiles)
      issue_window(x, window(it + 1), tile_of(t + p.blocks, p), p, total,
                   bar0 + 8 * ((it + 1) & 1));
    zero_pads(cur, tl, p);
    __syncthreads();
    shift_window(cur, shifted, tl, p);
    __syncthreads();

    float acc[kMI][kN8][4];
    const bool live = 64 * kMI * wgi < tl.valid;  // the whole warpgroup
    if (live) {
      // the byte offsets of this thread's pixel rows: [mi][h][0] for pairs
      // at an even koff/2, [mi][h][1] at an odd one; each in the window or
      // the shifted copy, whichever starts the pair at an even element
      int xs[kMI][2][2];
      const int a_off = window_off(it);
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = tl.m0 + min(tile_row(mi, h), tl.valid - 1);
          const int oy = m / p.wo, ox = m - oy * p.wo;
          const int base =
              tl.skew + (oy - tl.oy0) * p.s * p.rs + ox * p.s * p.c;
          const int in_a = a_off + 2 * base, in_b = L.b_off + 2 * (base + 1);
          xs[mi][h][0] = (base & 1) ? in_b : in_a;
          xs[mi][h][1] = (base & 1) ? in_a : in_b;
        }
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int f = 0; f < kN8; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][f][e] = 0.0f;
      // three register sets of A: step ks + 2's loads while the products
      // of steps ks and ks + 1 run; one wgmma group a step, at most two in
      // flight
      uint32_t a[3][kMI][4];
      const int4* te = table + tq;
      auto issue = [&](const uint32_t (&ak)[kMI][4], int ks) {
        wgmma_fence();
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
          wgmma_step<kN8>(acc[mi], ak[mi],
                          b_desc(w_smem + ks * w_step, 128, 256));
        wgmma_commit();
      };
      load_a<kMI, kOdd>(a[0], smem, xs, te[0]);
      if (steps > 1) load_a<kMI, kOdd>(a[1], smem, xs, te[4]);
      int ks = 0;
      for (; ks + 2 < steps; ks += 3) {
        issue(a[0], ks);
        wgmma_wait<1>();
        hold(a[2]);
        load_a<kMI, kOdd>(a[2], smem, xs, te[4 * ks + 8]);
        issue(a[1], ks + 1);
        wgmma_wait<1>();
        hold(a[0]);
        if (ks + 3 < steps) load_a<kMI, kOdd>(a[0], smem, xs, te[4 * ks + 12]);
        issue(a[2], ks + 2);
        wgmma_wait<1>();
        hold(a[1]);
        if (ks + 4 < steps) load_a<kMI, kOdd>(a[1], smem, xs, te[4 * ks + 16]);
      }
      if (ks < steps) issue(a[0], ks);
      if (ks + 1 < steps) issue(a[1], ks + 1);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 3; ++i) hold(a[i]);
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) hold(acc[mi]);
    }
    __syncthreads();  // the window and its copy are read: stage over them

    __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(
        smem + ((it & 1) ? L.b_off : L.a0_off));
    if (live) {
      // + bias, ReLU, one rounding; rows g and g + 8 of each m16 tile
#pragma unroll
      for (int f = 0; f < kN8; ++f) {
        const int col = f * 8 + 2 * tq;
        const float2 b2 = *reinterpret_cast<const float2*>(bs + col);
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = acc[mi][f][2 * h] + b2.x;
            float v1 = acc[mi][f][2 * h + 1] + b2.y;
            if (p.relu) {
              if (!isnan(v0)) v0 = fmaxf(v0, 0.0f);
              if (!isnan(v1)) v1 = fmaxf(v1, 0.0f);
            }
            const int r = tile_row(mi, h);
            *reinterpret_cast<__nv_bfloat162*>(stage + r * L.wp + col) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
    __syncthreads();
    // the tile's valid pixels are one contiguous run of the output
    uint4* dst = reinterpret_cast<uint4*>(
        out + ((long long)tl.img * p.ho * p.wo + tl.m0) * p.cout);
    for (Walk w(tid, c8); w.r < tl.valid; w.next(c8))
      dst[w.r * c8 + w.q] =
          *reinterpret_cast<const uint4*>(stage + w.r * L.wp + w.q * 8);
  }
  cp_async_wait<0>();
}

template <int kN8, bool kOdd>
cudaError_t launch(const void* x, const void* wg, const void* bias,
                   void* out, const Params& p, cudaStream_t st) {
  auto* kern = stem_conv_kernel<kN8, kOdd>;
  constexpr int kMaxDevices = 64;
  static int opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (p.smem > 48 * 1024 && p.smem > opted[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.smem);
    if (e != cudaSuccess) return e;
    opted[dev] = p.smem;
  }
  kern<<<dim3((unsigned)p.blocks), Shape<kN8>::kThreads, p.smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wg), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), p);
  return cudaGetLastError();
}

template <int kN8>
cudaError_t launch_pitch(const void* x, const void* wg, const void* bias,
                         void* out, const Params& p, cudaStream_t st) {
  return (p.rs & 1) ? launch<kN8, true>(x, wg, bias, out, p, st)
                    : launch<kN8, false>(x, wg, bias, out, p, st);
}

// what the wrapper's plan must agree with (kernels/stem_conv.py plan)
bool valid(const Params& p) {
  if (p.n <= 0 || p.h <= 0 || p.w <= 0 || p.c <= 0 || p.c > kMaxC ||
      p.kh <= 0 || p.kw <= 0 || p.s <= 0 || p.p < 0 || p.cout <= 0 ||
      p.cout % 8 || p.cout > p.cout_pad || p.relu < 0 || p.relu > 1)
    return false;
  if (p.ho != (p.h + 2 * p.p - p.kh) / p.s + 1 ||
      p.wo != (p.w + 2 * p.p - p.kw) / p.s + 1 || p.ho <= 0 || p.wo <= 0 ||
      p.h + 2 * p.p < p.kh || p.w + 2 * p.p < p.kw)
    return false;
  const int k = p.kh * ((p.kw * p.c + 1) & ~1);
  if (p.k_pad != (k + 15) / 16 * 16) return false;
  const int span = (kTileM - 1 + p.wo - 1) / p.wo + 1;  // output rows, most
  if (p.rows < (min(span, p.ho) - 1) * p.s + p.kh) return false;
  const int width = ((p.wo - 1) * p.s + p.kw) * p.c;
  const int need = max(width, (p.w + p.p) * p.c) + 8;
  if (p.rs < need || (p.rs - p.w * p.c) % 8) return false;
  if (p.win < 16 + p.rows * p.rs + 16 || p.win % 8) return false;
  const long long hw = (long long)p.ho * p.wo;
  if (p.tiles_per_img != (hw + kTileM - 1) / kTileM ||
      (long long)p.tiles != (long long)p.n * p.tiles_per_img ||
      p.blocks <= 0 || p.blocks > p.tiles)
    return false;
  const Layout L(p);
  return L.total == p.smem && p.smem <= kMaxSmem &&
         (long long)p.n * p.h * p.w * p.c < (1LL << 40);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a plan the kernel does not match. x: the image,
// contiguous NHWC bf16, 16-byte aligned; wg: [k_pad, cout_pad] bf16, the
// HWIO weight as rows (i, j*c + ch), each kernel row's kw*c padded to an
// even count, with zero padding; bias: [cout]
// f32 or null; out: [n, ho, wo, cout] bf16, 16-byte aligned. d: n, h, w, c,
// ho, wo, cout, kh, kw, stride, pad, then the plan of kernels/stem_conv.py:
// cout_pad, k_pad, rows, rs, win, tiles_per_img, tiles, blocks, smem, and
// relu.
extern "C" int cet_stem_conv(const void* x, const void* wg, const void* bias,
                             void* out, const int* d, void* stream) {
  const Params p{d[0],  d[1],  d[2],  d[3],  d[4],  d[5],  d[6],
                 d[7],  d[8],  d[9],  d[10], d[11], d[12], d[13],
                 d[14], d[15], d[16], d[17], d[18], d[19], d[20]};
  if (!valid(p) || !x || !wg || !out) return cudaErrorInvalidValue;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (p.cout_pad / 8) {
    case 4: e = launch_pitch<4>(x, wg, bias, out, p, st); break;
    case 8: e = launch_pitch<8>(x, wg, bias, out, p, st); break;
    case 12: e = launch_pitch<12>(x, wg, bias, out, p, st); break;
    case 16: e = launch_pitch<16>(x, wg, bias, out, p, st); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
