// Garbage-column direct sparse convolution for Hopper: the port of the TPU
// kernel caffe_escoin_tpu/kernels/sconv_pallas.py (_make_kernel / _run, the
// v2 Pallas kernel reached through sconv()).
//
// What it computes: stride-1, dilation-1 convolution over a slab that
// the wrapper builds in the multiply type (bf16, or f32 in
// cet_sconv_gc_f32): x zero-padded to Hp x Wp and cin_pad channels, H x W
// flattened, slab [N, L, cin_pad] with L >= Hp*Wp + Kw - 1 rows per image.
// Output rows are computed over Ho x Wp per image: row mi = (ho, w) of
// image n reads, for a live K-block kblk (off = kblk / n_cin_b,
// cb = kblk % n_cin_b, (khi, kwi) = (off / kw, off % kw)),
// slab[n, mi + khi*Wp + kwi, cb*bk : cb*bk + bk] @ W_block: one contiguous
// row range per K-block, so the A rows need no spatial masks. The Wp - Wo
// "garbage" columns w >= Wo mix row edges; the epilogue skips them and
// writes the exact output [N, Ho, Wo, Cout]. Bias and ReLU ride the
// epilogue; a residual is added by the caller.
//
// What bounds it on the card: its main-path callers are VGG-16's conv2_x
// and conv3_2/3_3 at b16 (90% block sparsity): e.g. conv2_2, 112x112
// 128->128 3x3 with one of its nine 128x128 blocks live: 6.6 GFLOP against
// 103 MB of bf16 x, live weights and output, 64 FLOP/byte, below the ~295
// FLOP/byte an H100 needs in bf16 to be MMA-bound. So memory bounds it, and
// latency, as in the fused kernel; and the first port moved its bytes about
// three times over: a zero-filled slab then a strided copy into it, the
// kernel, and a crop of the garbage-column output.
//
// What the design does about it: the slab stays, since contiguous A rows
// per K-block are why this kernel exists; the wrapper builds it in one
// write (one F.pad of x, with one extra zero image row that covers the
// Kw - 1 rows the last output row reads past Hp*Wp). An M-tile lies inside
// one image, so its rows m0 + shift ... are one contiguous slab range. The
// tile loop is sconv_pipe.cuh's pipelined cp.async ring, shared with
// sconv_fused.cu; its epilogue maps each garbage-column row to its exact
// output row or skips it, so there is no crop copy and no [N, Ho*Wp, Cout]
// buffer.

#include "sconv_pipe.cuh"

namespace {

template <typename E>
struct SlabRows {
  using Elem = E;
  const E* slab;  // [N, L, cin_pad]
  int L, cin_pad, ho, wo, wp, kw, n_cin_b, bk, tiles_per_img;
  int img, m0;  // the tile's image and first garbage-column row in it

  struct Row {
    long long base;  // slab row of this output row; -1 past the image
  };
  struct Blk {
    int shift, c0;
  };

  __device__ void tile(int mt, int bm) {
    img = mt / tiles_per_img;
    m0 = (mt - img * tiles_per_img) * bm;
  }

  __device__ Row row(int r) const {
    const int mi = m0 + r;
    return {mi < ho * wp ? (long long)img * L + mi : -1};
  }

  __device__ Blk block(int kblk) const {
    const int off = kblk / n_cin_b, cb = kblk - off * n_cin_b;
    const int khi = off / kw;
    return {khi * wp + off - khi * kw, cb * bk};
  }

  // the 16 bytes at column kk of the K-block for this row; null reads
  // zeros (past the image's rows, past the block's depth). cin_pad % bk ==
  // 0: a K-block never leaves the row.
  __device__ const E* at(const Row& rw, const Blk& b, int kk) const {
    if (rw.base < 0 || kk >= bk) return nullptr;
    return slab + (size_t)(rw.base + b.shift) * cin_pad + b.c0 + kk;
  }

  // exact output row of garbage-column row m0 + r, or -1 to skip it
  __device__ long long out_row(int r) const {
    const int mi = m0 + r;
    if (mi >= ho * wp) return -1;
    const int h = mi / wp, w = mi - h * wp;
    return w < wo ? ((long long)img * ho + h) * wo + w : -1;
  }
};

template <typename E>
int run(const void* slab, const void* blocks, const void* block_row,
        const void* bcol_nnz, const void* bias, void* out, const int* d,
        void* stream) {
  const int n = d[0], L = d[1], cin_pad = d[2], ho = d[3], wo = d[4];
  const int wp = d[5], cout = d[6], kw = d[7], n_cin_b = d[8], bk = d[9];
  const int bn = d[10], n_bcols = d[11], max_bw = d[12], relu = d[13];
  const int bf16_io = d[14], tile_m = d[15], stages = d[16], chunk = d[17];
  const int smem = d[18];
  if (cin_pad % cet::pipe::kVec<E> != 0 || tile_m <= 0 || n <= 0 ||
      ho <= 0 || wo > wp)
    return cudaErrorInvalidValue;
  const int tiles_per_img = (ho * wp + tile_m - 1) / tile_m;
  SlabRows<E> rows{static_cast<const E*>(slab), L, cin_pad, ho, wo, wp, kw,
                   n_cin_b, bk, tiles_per_img, 0, 0};
  const cet::pipe::Args a{blocks,
                          static_cast<const int*>(block_row),
                          static_cast<const int*>(bcol_nnz),
                          static_cast<const float*>(bias),
                          nullptr, out, cout, bk, bn, n_bcols, max_bw, relu,
                          stages};
  const cudaError_t e =
      bf16_io ? cet::pipe::launch_sconv_pipe<__nv_bfloat16>(
                    rows, a, n * tiles_per_img, tile_m, chunk, smem, stream)
              : cet::pipe::launch_sconv_pipe<float>(
                    rows, a, n * tiles_per_img, tile_m, chunk, smem, stream);
  return static_cast<int>(e);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a plan the kernel does not match. slab and
// blocks: bf16 (cet_sconv_gc) or f32 (cet_sconv_gc_f32), the multiply type.
// out: bf16 if bf16_io, else f32. d: the integer arguments, n, L, cin_pad,
// ho, wo, wp, cout, kw, n_cin_b, bk, bn, n_bcols, max_bw, relu, bf16_io,
// then the launch plan of kernels/sconv_pipe.py: tile_m, stages, chunk,
// smem.
extern "C" int cet_sconv_gc(const void* slab, const void* blocks,
                            const void* block_row, const void* bcol_nnz,
                            const void* bias, void* out, const int* d,
                            void* stream) {
  return run<__nv_bfloat16>(slab, blocks, block_row, bcol_nnz, bias, out, d,
                            stream);
}
extern "C" int cet_sconv_gc_f32(const void* slab, const void* blocks,
                                const void* block_row, const void* bcol_nnz,
                                const void* bias, void* out, const int* d,
                                void* stream) {
  return run<float>(slab, blocks, block_row, bcol_nnz, bias, out, d, stream);
}
