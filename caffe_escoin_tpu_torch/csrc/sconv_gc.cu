// Garbage-column direct sparse convolution for Hopper: the port of the TPU
// kernel caffe_escoin_tpu/kernels/sconv_pallas.py (_make_kernel / _run, the
// v2 Pallas kernel reached through sconv()).
//
// What it computes: stride-1, dilation-1 convolution over a slab that the
// wrapper builds: x zero-padded to Hp x Wp and cin_pad channels, H x W
// flattened, slab [N, L, cin_pad] with L >= Hp*Wp + Kw - 1. The output is
// computed over Ho x Wp rows per image, out [N, Ho*Wp, Cout]; the Wp - Wo
// "garbage" columns of each row mix row edges and are sliced away by the
// wrapper. Output row m = (n, mi) over m_total = N*Ho*Wp (a tile may
// straddle two images). A live K-block kblk decodes to off = kblk / n_cin_b,
// cb = kblk % n_cin_b, (khi, kwi) = (off / kw, off % kw), and contributes
// slab[n, mi + khi*Wp + kwi, cb*bk : cb*bk + bk] @ W_block: one contiguous
// row range per K-block, so the A rows need no spatial masks. Bias and ReLU
// ride the shared epilogue; a residual is added by the caller.
//
// What bounds it on the card: its main-path callers are VGG-16's conv2_x
// and conv3_2/3_3 at b16 (90% block sparsity): e.g. conv2_2, 112x112
// 128->128 3x3 with one of its nine 128x128 blocks live, 16*112*114 rows:
// 6.7 GFLOP against 53 MB of bf16 slab in and 52 MB of garbage-column
// output out, 64 FLOP/byte, below the ~295 FLOP/byte an H100 needs in bf16
// to be MMA-bound. So it is bound by memory traffic and by latency, like
// the fused kernel, and the wrapper's slab and crop copies move about
// twice those bytes again around it.
//
// What the design does about it: the TPU kernel held a channel-block-major
// slab of one image in VMEM (a layout Mosaic's lane-slicing rule forced);
// here the slab keeps rows of stride cin_pad (a multiple of 8, so every row
// is 16-byte aligned in bf16 and load8's vector loads apply), a K-block is
// a column offset cb*bk into it, and the tile loop and epilogue are the
// ones sconv_fused.cu and bsc_spmm.cu share (bsc_tile.cuh).

#include "bsc_tile.cuh"

namespace {

using cet::kTileM;

template <typename T>
struct SlabRows {
  const T* slab;
  int L, cin_pad, m_img, wp, kw, n_cin_b, bk;
  int shift, c0, limit;

  // meta[0..1][r] = (n, mi) of output row m0 + r; n = -1 past M
  __device__ void init(int m0, int m_total, int (*meta)[kTileM]) {
    for (int r = threadIdx.x; r < kTileM; r += blockDim.x) {
      const int m = m0 + r;
      if (m < m_total) {
        const int n = m / m_img;
        meta[0][r] = n;
        meta[1][r] = m - n * m_img;
      } else {
        meta[0][r] = -1;
      }
    }
  }

  __device__ void begin(int kblk) {
    const int off = kblk / n_cin_b, cb = kblk - off * n_cin_b;
    const int khi = off / kw;
    shift = khi * wp + (off - khi * kw);
    c0 = cb * bk;
    limit = bk;  // cin_pad % bk == 0: a K-block never leaves the row
  }

  __device__ const T* row(int r, int (*meta)[kTileM]) const {
    const int n = meta[0][r];
    if (n < 0) return nullptr;
    return slab + ((size_t)n * L + meta[1][r] + shift) * cin_pad + c0;
  }
};

template <typename T>
int run(const void* slab, const void* blocks, const void* block_row,
        const void* bcol_nnz, const void* bias, void* out, int n, int L,
        int cin_pad, int ho, int wp, int cout, int kw, int n_cin_b, int bk,
        int bn, int n_bcols, int max_bw, int relu, int vec, void* stream) {
  SlabRows<T> rows{static_cast<const T*>(slab), L, cin_pad, ho * wp, wp, kw,
                   n_cin_b, bk, 0, 0, 0};
  return static_cast<int>(cet::launch_bsc_tile<T>(
      rows, blocks, block_row, bcol_nnz, bias, nullptr, out, n * ho * wp,
      cout, bk, bn, n_bcols, max_bw, relu, vec, stream));
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
// bf16_io: slab and out are bf16 (else f32). blocks: bf16.
extern "C" int cet_sconv_gc(const void* slab, const void* blocks,
                            const void* block_row, const void* bcol_nnz,
                            const void* bias, void* out, int n, int L,
                            int cin_pad, int ho, int wp, int cout, int kw,
                            int n_cin_b, int bk, int bn, int n_bcols,
                            int max_bw, int relu, int bf16_io, int vec,
                            void* stream) {
  if (bf16_io)
    return run<__nv_bfloat16>(slab, blocks, block_row, bcol_nnz, bias, out, n,
                              L, cin_pad, ho, wp, cout, kw, n_cin_b, bk, bn,
                              n_bcols, max_bw, relu, vec, stream);
  return run<float>(slab, blocks, block_row, bcol_nnz, bias, out, n, L,
                    cin_pad, ho, wp, cout, kw, n_cin_b, bk, bn, n_bcols,
                    max_bw, relu, vec, stream);
}
