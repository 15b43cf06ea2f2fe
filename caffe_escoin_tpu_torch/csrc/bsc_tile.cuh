// The tile loop and epilogue of bsc_spmm.cu (dense A times a BSC weight),
// which alone uses this header now: the two direct convolutions moved to the
// pipelined loop of sconv_pipe.cuh, and bsc_spmm's own redesign onto that
// header is next (ROADMAP, queue 2), after which this file goes. It
// computes, for one output tile of kTileM rows and one weight block-column
// j, the sum over the column's live K-blocks of A_tile[:, kblock] @ W_block;
// a "Rows" policy class says where a row of A lives, everything else is
// here.
//
// Design, for an H100 (sm_90a):
// * Grid (M-tiles, block-columns). Each block reads its column's bcol_nnz[j]
//   and block_row[j, :] itself and loops to bcol_nnz[j] only, so padding
//   slots cost nothing and an empty column still runs its epilogue (bias,
//   residual, ReLU), which every output element needs.
// * Each live K-block is staged through shared memory in 32-deep chunks:
//   A chunk [128 x 32] and weight chunk [32 x BN_T], bf16. Chunking keeps a
//   block's static shared memory near 30 KB whatever bk is (64 or 128), so
//   no dynamic shared-memory opt-in is needed and several blocks fit on one
//   SM. A-loads are masked (rows past M, pixels outside the image, channels
//   past Cin or past the K tail read 0), which replaces the TPU kernels'
//   materialised zero-padded slab.
// * Tensor cores through nvcuda::wmma, bf16 x bf16 -> f32, 16x16x16
//   fragments. 8 warps as 4 (M) x 2 (N); a warp owns 32 x BN_T/2 outputs.
//   Activations in f32 are rounded to bf16 as they are staged ("auto" MXU
//   dtype, as on the TPU); the weight payloads arrive in bf16.
// * Epilogue in f32 from the accumulators: + bias, + residual, ReLU, cast to
//   the output dtype, masked store of exactly [M, n_out] (bn may be smaller
//   than BN_T and the last block-column may overhang n_out).
//
// This first version has no copy/compute overlap (no cp.async, TMA or
// wgmma pipeline); it is right and simple, and leaves speed to later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace cet {

using namespace nvcuda;

constexpr int kTileM = 128;        // output rows per block
constexpr int kChunk = 32;         // K depth staged per step
constexpr int kThreads = 256;      // 8 warps
constexpr int kALd = kChunk + 8;   // padded shared row of the A chunk

template <int BN_T>
struct Smem {
  __nv_bfloat16 a[kTileM * kALd];
  __nv_bfloat16 b[kChunk * (BN_T + 8)];
  float c[kThreads / 32][16 * 16];  // per-warp epilogue scratch
  int meta[3][kTileM];              // per-row data of the Rows policy
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

// Stage up to 8 consecutive values of A (nv of them valid, the rest 0) as
// bf16 into 16 bytes of shared memory. vec: p is 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, int nv, bool vec,
                                      __nv_bfloat16* dst) {
  __align__(16) __nv_bfloat16 v[8];
  if (vec && nv >= 8) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = __float2bfloat16(lo.x); v[1] = __float2bfloat16(lo.y);
    v[2] = __float2bfloat16(lo.z); v[3] = __float2bfloat16(lo.w);
    v[4] = __float2bfloat16(hi.x); v[5] = __float2bfloat16(hi.y);
    v[6] = __float2bfloat16(hi.z); v[7] = __float2bfloat16(hi.w);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __float2bfloat16(i < nv ? p[i] : 0.f);
  }
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, int nv, bool vec,
                                      __nv_bfloat16* dst) {
  if (vec && nv >= 8) {
    *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(p));
    return;
  }
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = i < nv ? p[i] : __float2bfloat16(0.f);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// out[m, j*bn + c] = epi(sum_s A[m, K-block s] @ blocks[j, s][:, c]) for the
// block's kTileM rows. T: activation/output dtype. BN_T: compiled tile width
// (>= bn). Rows: init(m0, m_total, meta) / begin(kblk) / row(r, meta) and
// a `limit` member (valid K columns of the current K-block).
template <typename T, int BN_T, class Rows>
__global__ void __launch_bounds__(kThreads)
bsc_tile_kernel(Rows rows, const __nv_bfloat16* __restrict__ blocks,
                const int* __restrict__ block_row,
                const int* __restrict__ bcol_nnz,
                const float* __restrict__ bias, const T* __restrict__ residual,
                T* __restrict__ out, int m_total, int n_out, int bk, int bn,
                int max_bw, int relu, int vec) {
  constexpr int kWN = BN_T / 2;    // warp tile width
  constexpr int kFN = kWN / 16;    // 16-wide fragments per warp
  constexpr int kBLd = BN_T + 8;   // padded shared row of the weight chunk
  __shared__ __align__(128) Smem<BN_T> sm;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int m0 = blockIdx.x * kTileM;
  const int j = blockIdx.y;

  rows.init(m0, m_total, sm.meta);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kFN];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < kFN; ++f) wmma::fill_fragment(acc[i][f], 0.f);

  const int nnz = bcol_nnz[j];
  for (int s = 0; s < nnz; ++s) {
    const int slot = j * max_bw + s;
    const int kblk = block_row[slot];
    const __nv_bfloat16* blk = blocks + (size_t)slot * bk * bn;
    rows.begin(kblk);
    for (int kc = 0; kc < bk; kc += kChunk) {
      for (int v = tid; v < kTileM * (kChunk / 8); v += kThreads) {
        const int r = v >> 2, q = (v & 3) * 8, kk = kc + q;
        const T* p = rows.row(r, sm.meta);
        const int nv = p ? min(rows.limit - kk, 8) : 0;
        load8(p ? p + kk : p, nv, vec, &sm.a[r * kALd + q]);
      }
      for (int v = tid; v < kChunk * (BN_T / 8); v += kThreads) {
        const int r = v / (BN_T / 8), col = (v % (BN_T / 8)) * 8;
        const int kk = kc + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (kk < bk && col < bn)
          val = __ldg(reinterpret_cast<const uint4*>(blk + kk * bn + col));
        *reinterpret_cast<uint4*>(&sm.b[r * kBLd + col]) = val;
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kChunk; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &sm.a[(warp_m * 32 + i * 16) * kALd + ks],
                                 kALd);
#pragma unroll
        for (int f = 0; f < kFN; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb;
          wmma::load_matrix_sync(fb, &sm.b[ks * kBLd + warp_n * kWN + f * 16],
                                 kBLd);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][f], fa[i], fb, acc[i][f]);
        }
      }
      __syncthreads();
    }
  }

  // epilogue: one 16x16 fragment at a time through the warp's scratch; a
  // lane owns 8 consecutive columns of one row
  float* scratch = sm.c[warp];
  const int r = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int f = 0; f < kFN; ++f) {
      wmma::store_matrix_sync(scratch, acc[i][f], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + warp_m * 32 + i * 16 + r;
      const int lc = warp_n * kWN + f * 16 + c8;  // column inside block-col j
      if (m < m_total) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int col = j * bn + lc + e;
          if (lc + e < bn && col < n_out) {
            float v = scratch[r * 16 + c8 + e];
            if (bias) v += bias[col];
            if (residual) v += to_f32(residual[(size_t)m * n_out + col]);
            if (relu) v = fmaxf(v, 0.f);
            from_f32(v, &out[(size_t)m * n_out + col]);
          }
        }
      }
      __syncwarp();
    }
  }
}

// Tile width compiled for a block width bn (a multiple of 8, at most 128).
template <typename T, class Rows>
cudaError_t launch_bsc_tile(const Rows& rows, const void* blocks,
                            const void* block_row, const void* bcol_nnz,
                            const void* bias, const void* residual, void* out,
                            int m_total, int n_out, int bk, int bn, int n_bcols,
                            int max_bw, int relu, int vec, void* stream) {
  if (bn <= 0 || bn > 128 || bn % 8 != 0 || bk <= 0 || m_total <= 0 ||
      n_bcols <= 0 || max_bw <= 0)
    return cudaErrorInvalidValue;
  const dim3 grid((m_total + kTileM - 1) / kTileM, n_bcols);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const __nv_bfloat16*>(blocks);
  const auto* br = static_cast<const int*>(block_row);
  const auto* nz = static_cast<const int*>(bcol_nnz);
  const auto* b = static_cast<const float*>(bias);
  const auto* res = static_cast<const T*>(residual);
  auto* o = static_cast<T*>(out);
  if (bn <= 32)
    bsc_tile_kernel<T, 32, Rows><<<grid, kThreads, 0, st>>>(
        rows, w, br, nz, b, res, o, m_total, n_out, bk, bn, max_bw, relu, vec);
  else if (bn <= 64)
    bsc_tile_kernel<T, 64, Rows><<<grid, kThreads, 0, st>>>(
        rows, w, br, nz, b, res, o, m_total, n_out, bk, bn, max_bw, relu, vec);
  else
    bsc_tile_kernel<T, 128, Rows><<<grid, kThreads, 0, st>>>(
        rows, w, br, nz, b, res, o, m_total, n_out, bk, bn, max_bw, relu, vec);
  return cudaGetLastError();
}

}  // namespace cet
