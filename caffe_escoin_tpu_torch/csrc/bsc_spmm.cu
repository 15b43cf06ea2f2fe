// Dense x block-sparse matrix product for Hopper: the port of the TPU
// kernel caffe_escoin_tpu/kernels/bsc_pallas.py (_make_kernel / _run,
// reached through bsc_spmm_pallas()).
//
// What it computes: out[M, N] = epi(A[M, K] @ W[K, N]) with W in BSC
// (bk x bn blocks), f32 accumulation, + bias and ReLU, one cast to the
// output dtype. For each output block-column it loops over that column's
// live K-blocks and reads the contiguous A columns [kblk*bk, kblk*bk + bk),
// zero-filled past M and past K (the TPU wrapper padded A to a multiple of
// bk instead, a copy this kernel does not need). The store is masked on N,
// so N = 1000 = 7*128 + 104 needs no padded output.
//
// What bounds it on the card: its callers are the fc layers (ResNet-50's
// fc1000 at b32, VGG-16's fc6-8 at b16) and the lowered and 1x1 conv routes
// (VGG-16's conv1_2: an 802816 x 576 im2col against 64x64 blocks). All are
// memory-bound at 90% block sparsity: fc6 reads 20.5 MB of live weights
// for 0.33 GFLOP; conv1_2 reads the live ninth of A and writes its output,
// 206 MB. The fc layers are latency-bound besides: M = 16 or 32 is one
// M-tile, so (M-tile x block-column) gives 8-32 blocks on a 132-SM card,
// each walking up to 31 live K-blocks in series.
//
// What the design does about it: the tile loop, the cp.async ring whose
// zero fill masks the M and K tails, ldmatrix + mma.sync and the coalesced
// 16-byte epilogue are sconv_pipe.cuh's, with a DenseRows policy (a row of
// A is a row; a K-block is a column offset). For the small-M launches the
// wrapper's plan (kernels/sconv_pipe.spmm_plan) uses 64-row tiles and splits
// each column's live K-blocks over `split` blocks, about three blocks per SM;
// the shares meet in a deterministic reduction in the same launch (the
// split-K instance of sconv_pipe.cuh). The large-M callers run unsplit with
// 128-row tiles. A reaches the kernel in the multiply type, bf16 with K and
// bk multiples of 8 or f32 with multiples of 4 (cp.async does not convert;
// bsc_spmm.kernel_operands); in f32 (cet_bsc_spmm_f32) the split-K partial
// sums are f32 as in bf16, so the three-pass TF32 products keep f32
// accuracy through the reduction.

#include "sconv_pipe.cuh"

namespace {

template <typename E>
struct DenseRows {
  using Elem = E;
  const E* a;  // [m_total, K], K % kVec<E> == 0
  int K, bk, m_total;
  int m0;  // first row of the tile

  struct Row {
    const E* p;  // the row of A; null past M
  };
  struct Blk {
    int c0, limit;  // first column of the K-block, its columns inside K
  };

  __device__ void tile(int mt, int bm) { m0 = mt * bm; }

  __device__ Row row(int r) const {
    const int m = m0 + r;
    return {m < m_total ? a + (size_t)m * K : nullptr};
  }

  __device__ Blk block(int kblk) const {
    const int c0 = kblk * bk;
    return {c0, min(bk, K - c0)};
  }

  // the 16 bytes at column kk of the K-block for this row; null reads
  // zeros (past M, past K)
  __device__ const E* at(const Row& rw, const Blk& b, int kk) const {
    if (!rw.p || kk >= b.limit) return nullptr;
    return rw.p + b.c0 + kk;
  }

  __device__ long long out_row(int r) const {
    const int m = m0 + r;
    return m < m_total ? m : -1;
  }
};

template <typename E>
int run(const void* a, const void* blocks, const void* block_row,
        const void* bcol_nnz, const void* bias, void* out, void* ws,
        void* counters, const int* d, void* stream) {
  const int m = d[0], k = d[1], n = d[2], bk = d[3], bn = d[4];
  const int n_bcols = d[5], max_bw = d[6], relu = d[7], bf16_io = d[8];
  const int tile_m = d[9], stages = d[10], chunk = d[11], smem = d[12];
  const int split = d[13], share = d[14], n_counters = d[15];
  if (k % cet::pipe::kVec<E> != 0 || m <= 0 || tile_m <= 0 || split < 1)
    return cudaErrorInvalidValue;
  DenseRows<E> rows{static_cast<const E*>(a), k, bk, m, 0};
  const cet::pipe::Args args{blocks,
                             static_cast<const int*>(block_row),
                             static_cast<const int*>(bcol_nnz),
                             static_cast<const float*>(bias),
                             nullptr, out, n, bk, bn, n_bcols, max_bw, relu,
                             stages};
  const int m_tiles = (m + tile_m - 1) / tile_m;
  cudaError_t e;
  if (split == 1) {
    e = bf16_io ? cet::pipe::launch_sconv_pipe<__nv_bfloat16>(
                      rows, args, m_tiles, tile_m, chunk, smem, stream)
                : cet::pipe::launch_sconv_pipe<float>(
                      rows, args, m_tiles, tile_m, chunk, smem, stream);
  } else {
    const cet::pipe::Split sp{static_cast<float*>(ws),
                              static_cast<int*>(counters), m, split, share,
                              n_counters};
    e = bf16_io ? cet::pipe::launch_sconv_pipe_split<__nv_bfloat16>(
                      rows, args, sp, m_tiles, tile_m, chunk, smem, stream)
                : cet::pipe::launch_sconv_pipe_split<float>(
                      rows, args, sp, m_tiles, tile_m, chunk, smem, stream);
  }
  return static_cast<int>(e);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a plan the kernel does not match. a [m, k] and
// blocks: bf16 (cet_bsc_spmm) or f32 (cet_bsc_spmm_f32), the multiply type.
// out: bf16 if bf16_io, else f32. ws: f32 [split, m, n_bcols * bn] and
// counters: int32 [n_counters], zero, when split > 1 (else unused). d: the
// integer arguments, m, k, n, bk, bn, n_bcols, max_bw, relu, bf16_io, then
// the launch plan of kernels/sconv_pipe.py: tile_m, stages, chunk, smem,
// split, share, and n_counters.
extern "C" int cet_bsc_spmm(const void* a, const void* blocks,
                            const void* block_row, const void* bcol_nnz,
                            const void* bias, void* out, void* ws,
                            void* counters, const int* d, void* stream) {
  return run<__nv_bfloat16>(a, blocks, block_row, bcol_nnz, bias, out, ws,
                            counters, d, stream);
}
extern "C" int cet_bsc_spmm_f32(const void* a, const void* blocks,
                                const void* block_row, const void* bcol_nnz,
                                const void* bias, void* out, void* ws,
                                void* counters, const int* d, void* stream) {
  return run<float>(a, blocks, block_row, bcol_nnz, bias, out, ws, counters,
                    d, stream);
}

// Text of a CUDA error code returned by the entry points of this library.
extern "C" const char* cet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
