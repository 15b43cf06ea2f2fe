// Direct block-sparse convolution for Hopper: the port of the TPU kernel
// caffe_escoin_tpu/kernels/sconv_fused.py (_make_kernel / _run, the
// fused-slab Pallas kernel reached through sconv()).
//
// What it computes: stride-1, dilation-1 convolution of NHWC x [N,H,W,Cin]
// with a BSC GEMM-view weight (rows ordered kh, kw, cin; K-blocks bk deep,
// bk dividing cin_pad), bias, an optional NHWC residual and ReLU, into
// exact NHWC out [N,Ho,Wo,Cout]. Output row m = (n, ho, wo); a live K-block
// kblk decodes to off = kblk / n_cin_b, cb = kblk % n_cin_b,
// (khi, kwi) = (off / kw, off % kw), and contributes
// x[n, ho+khi-ph, wo+kwi-pw, cb*bk : cb*bk+bk] @ W_block.
//
// What bounds it on the card: at ResNet-50's shapes (b32, 90% block
// sparsity) a layer reads its activation and writes its output once and
// does about 10% of the dense MMA work; e.g. 56x56 64->64 3x3 keeps one of
// its nine 64x64 blocks: 0.82 GFLOP against 25.7 MB of bf16 activation in
// and out, 32 FLOP/byte, far below the ~295 FLOP/byte an H100 needs in
// bf16 to be MMA-bound. So memory bounds it, and latency: a block-column
// has 0-4 live K-blocks, too few steps for one block to hide a load behind
// the previous step's multiply. The 1x1 expand layers with a residual move
// as many bytes in the epilogue (residual in, output out) as in the loop.
// The first port's tile loop lost most of its time to exactly these:
// synchronous 32-deep chunks, and an epilogue of 2-byte scalar stores and
// residual reads that ran ResNet-50's res2 expand layers at ~400 GB/s
// (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
//
// What the design does about it: no slab. Each output tile gathers its
// shifted A rows straight from x with cp.async copies whose zero fill does
// the masking (outside the image, past M, past Cin), through the pipelined
// ring of sconv_pipe.cuh, which keeps the next steps' loads in flight
// across K-blocks; the residual add and ReLU ride the coalesced 16-byte
// epilogue there; block-columns of one M-tile launch side by side so the
// A rows they share come from L2; the wrapper picks 64-row tiles for the
// small late layers so they still fill the card. With mxu_dtype "float32"
// (cet_sconv_fused_f32) x and the weight blocks arrive in f32 and multiply
// as three TF32 products (sconv_pipe.cuh): twice the bytes, so the layer
// above moves 51 MB for its 0.82 GFLOP, ~16 FLOP/byte, still below the ~49
// at which three TF32 passes become the limit.

#include "sconv_pipe.cuh"

namespace {

template <typename E>
struct ConvRows {
  using Elem = E;
  const E* x;  // [N, H, W, Cin], Cin % kVec<E> == 0
  int H, W, Cin, Ho, Wo, kw, ph, pw, n_cin_b, bk, m_total;
  int m0;  // first output row of the tile

  struct Row {
    int n, ho, wo;  // n = -1 past M
  };
  struct Blk {
    int dh, dw, c0, limit;
  };

  __device__ void tile(int mt, int bm) { m0 = mt * bm; }

  __device__ Row row(int r) const {
    const int m = m0 + r;
    if (m >= m_total) return {-1, 0, 0};
    const int hw = Ho * Wo;
    const int n = m / hw, rem = m - n * hw, ho = rem / Wo;
    return {n, ho, rem - ho * Wo};
  }

  __device__ Blk block(int kblk) const {
    const int off = kblk / n_cin_b, cb = kblk - off * n_cin_b;
    const int khi = off / kw;
    // channel tail when cin_pad > Cin
    return {khi - ph, off - khi * kw - pw, cb * bk, min(bk, Cin - cb * bk)};
  }

  // the 16 bytes at column kk of the K-block for this row; null reads
  // zeros (padding, past M, past Cin)
  __device__ const E* at(const Row& rw, const Blk& b, int kk) const {
    if (rw.n < 0 || kk >= b.limit) return nullptr;
    const int hi = rw.ho + b.dh, wi = rw.wo + b.dw;
    if ((unsigned)hi >= (unsigned)H || (unsigned)wi >= (unsigned)W)
      return nullptr;
    return x + ((size_t)(rw.n * H + hi) * W + wi) * Cin + b.c0 + kk;
  }

  __device__ long long out_row(int r) const {
    const int m = m0 + r;
    return m < m_total ? m : -1;
  }
};

template <typename E>
int run(const void* x, const void* blocks, const void* block_row,
        const void* bcol_nnz, const void* bias, const void* residual,
        void* out, const int* d, void* stream) {
  const int n = d[0], h = d[1], w = d[2], cin = d[3], ho = d[4], wo = d[5];
  const int cout = d[6], kw = d[7], ph = d[8], pw = d[9], n_cin_b = d[10];
  const int bk = d[11], bn = d[12], n_bcols = d[13], max_bw = d[14];
  const int relu = d[15], bf16_io = d[16], tile_m = d[17], stages = d[18];
  const int chunk = d[19], smem = d[20];
  if (cin % cet::pipe::kVec<E> != 0 || tile_m <= 0)
    return cudaErrorInvalidValue;
  const int m_total = n * ho * wo;
  ConvRows<E> rows{static_cast<const E*>(x), h, w, cin, ho, wo, kw, ph, pw,
                   n_cin_b, bk, m_total, 0};
  const cet::pipe::Args a{blocks,
                          static_cast<const int*>(block_row),
                          static_cast<const int*>(bcol_nnz),
                          static_cast<const float*>(bias),
                          residual, out, cout, bk, bn, n_bcols, max_bw, relu,
                          stages};
  const int m_tiles = (m_total + tile_m - 1) / tile_m;
  const cudaError_t e =
      bf16_io ? cet::pipe::launch_sconv_pipe<__nv_bfloat16>(
                    rows, a, m_tiles, tile_m, chunk, smem, stream)
              : cet::pipe::launch_sconv_pipe<float>(rows, a, m_tiles, tile_m,
                                                    chunk, smem, stream);
  return static_cast<int>(e);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a plan the kernel does not match. x and blocks:
// bf16 (cet_sconv_fused) or f32 (cet_sconv_fused_f32), the multiply type.
// residual and out: bf16 if bf16_io, else f32. d: the integer arguments, n,
// h, w, cin, ho, wo, cout, kw, ph, pw, n_cin_b, bk, bn, n_bcols, max_bw,
// relu, bf16_io, then the launch plan of kernels/sconv_pipe.py: tile_m,
// stages, chunk, smem.
extern "C" int cet_sconv_fused(const void* x, const void* blocks,
                               const void* block_row, const void* bcol_nnz,
                               const void* bias, const void* residual,
                               void* out, const int* d, void* stream) {
  return run<__nv_bfloat16>(x, blocks, block_row, bcol_nnz, bias, residual,
                            out, d, stream);
}
extern "C" int cet_sconv_fused_f32(const void* x, const void* blocks,
                                   const void* block_row,
                                   const void* bcol_nnz, const void* bias,
                                   const void* residual, void* out,
                                   const int* d, void* stream) {
  return run<float>(x, blocks, block_row, bcol_nnz, bias, residual, out, d,
                    stream);
}
