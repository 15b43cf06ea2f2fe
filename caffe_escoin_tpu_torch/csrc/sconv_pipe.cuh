// The pipelined tile loop and epilogue of the three block-sparse kernels,
// the two direct convolutions (sconv_fused.cu, sconv_gc.cu) and the SpMM
// (bsc_spmm.cu), for an H100 (sm_90a).
//
// One block computes one output tile of tile_m rows (64 or 128) and one
// weight block-column j: the sum over the column's live K-blocks of
// A_tile[:, kblock] @ W_block, then + bias, + residual, ReLU, one cast. A
// "Rows" policy class says where row r of the tile reads its A values and
// which output row it writes; everything else is here.
//
// What bounds these layers: at 90% block sparsity they do 32-126 FLOP per
// byte, below the ~295 at which an H100's bf16 tensor cores become the
// limit, so memory traffic and latency bound them. A conv's column has only
// 0-4 live K-blocks, so the loop is short and each load's latency shows
// unless the next ones are already in flight, and the epilogue moves as many
// bytes as the loop (output and residual). An fc layer at batch 16-32 is
// the other way round: one M-tile, few block-columns, and up to ~30 live
// K-blocks in a column, so (M-tile x block-column) blocks leave most SMs
// idle, each on a long serial chain.
//
// What the design does about it:
// * Grid: one dimension, block-column fastest (blockIdx.x = m_tile *
//   n_bcols + j), so the blocks that read the same A rows for different
//   block-columns run side by side and find those rows in L2. The wrapper
//   picks tile_m per launch: 128 when that makes a block for at least every
//   other one of the card's 132 SMs, else 64, so the smallest layers (7x7
//   at b32) make more blocks; the larger tile wins everywhere else.
// * One flat list of K steps per block: (live K-block s, chunk kc of it)
//   for s < bcol_nnz[j], so the pipeline never drains between K-blocks;
//   it is walked with running counters, a K-block decoded once, since at
//   these depths the integer work per step rivals the multiply.
//   The steps go through a ring of `stages` (2-4) buffers in dynamic shared
//   memory, filled by cp.async 16-byte copies. A copy whose source lies
//   outside the image, past M, past Cin or past the block's depth has
//   src-size 0 and fills zeros: that is all the masking, and it costs no
//   registers. cp.async.wait_group keeps stages-1 steps in flight while a
//   step multiplies. The wrapper picks `stages` from the column's step count
//   and keeps two blocks per SM. cp.async does not convert, so the operands
//   arrive in the type they are multiplied in (E, from the Rows policy):
//   bf16, the wrapper rounding f32 activations as the staging of the
//   earlier kernel did, or f32 for mxu_dtype "float32". A step is 128 bytes
//   of a row deep (64 bf16 or 32 f32 values), so a stage holds the same
//   bytes in both types; rows are 16-byte aligned (Cin % 8 == 0 in bf16,
//   Cin % 4 == 0 in f32).
// * bf16 operands: tensor cores through ldmatrix + mma.sync.m16n8k16 (bf16
//   x bf16 -> f32) from shared rows padded by 16 bytes, which keeps
//   ldmatrix free of bank conflicts. Warps are (tile_m / 32) x 2; a warp
//   owns 32 x bn_tile/2 outputs in registers. mma.sync suffices at these
//   FLOP/byte ratios.
// * f32 operands: the same warp tiles through mma.sync.m16n8k8 in TF32, three
//   products per fragment so that they keep f32 accuracy (one TF32 pass
//   keeps ~3 decimal digits): each value v splits into big = tf32(v) and
//   small = tf32(v - big), and the accumulator takes small*big + big*small
//   + big*big, small terms first (the dropped small*small is ~2^-22 of the
//   product). Three passes run at a third of the card's 495 TF32 TFLOP/s,
//   ~165, or ~49 FLOP per byte at 3.35 TB/s; at 90% block sparsity these
//   layers do 16-63 FLOP per f32 byte, so the larger convs turn MMA-bound,
//   and FFMA on the CUDA cores (67 TFLOP/s) would bound them lower still.
//   ldmatrix moves 16-bit elements only: each tf32 fragment value is one
//   32-bit shared load (A: rows g, g+8 x columns t, t+4; B: k = t, t+4 x
//   n = g), from A rows padded by 4 floats and B rows by 8, so that the 32
//   lanes of each load hit 32 distinct banks.
// * Epilogue through shared memory: the accumulator tile goes to shared
//   memory (reusing the ring), the bias is staged once per block, and each
//   thread then takes 8 consecutive channels of one row: one 16-byte read of
//   the residual (bf16; 32 bytes in f32), acc + bias + residual in f32,
//   ReLU, one cast, one 16-byte store. A warp writes whole 128-256 byte row
//   segments. The Rows policy maps tile rows to output rows, so sconv_gc's
//   garbage columns are skipped here and its output is exact.
// * Split K, for the few-block launches of the fc layers (a separate kernel
//   instance, kSplit, so the direct convs' instances are untouched): block
//   (M-tile, share s, j) walks only slots [s*share, (s+1)*share) of column
//   j's live K-blocks, and a share past the column's end exits at once. Each
//   share writes its f32 partial tile (valid rows) to a global workspace,
//   fences, and bumps a per-(M-tile, j) counter; the last share to arrive
//   sums the partials in share order (deterministic; read through L2), runs
//   the one epilogue above (bias, ReLU, one cast, 16-byte stores) and resets
//   the counter to 0, so the counters stay zero between launches.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cet {
namespace pipe {

// K depth of one pipeline step: 128 bytes of a row (64 bf16, 32 f32)
template <typename E>
constexpr int kChunk = 128 / (int)sizeof(E);
// values of E in one 16-byte cp.async copy
template <typename E>
constexpr int kVec = 16 / (int)sizeof(E);
// padded shared row of an A stage: 16 bytes of padding
template <typename E>
constexpr int kALd = kChunk<E> + kVec<E>;
constexpr int kRowsPerThread = 4;    // A rows each thread copies per step
constexpr int kMaxStages = 4;

// Tile width compiled for a block width bn (a multiple of 8, at most 128).
__host__ __device__ constexpr int bn_tile(int bn) {
  return bn <= 32 ? 32 : bn <= 64 ? 64 : 128;
}
// elements of one ring stage: the A tile, then the B tile (rows padded by 8)
template <typename E>
__host__ __device__ constexpr int stage_elems(int bm, int bn_t) {
  return bm * kALd<E> + kChunk<E> * (bn_t + 8);
}
// Dynamic shared memory of one block: the ring (or the f32 accumulator tile
// that reuses it, whichever is larger), then the bias of the block-column.
template <typename E>
__host__ __device__ constexpr int ring_bytes(int bm, int bn_t, int stages) {
  return stages * stage_elems<E>(bm, bn_t) * (int)sizeof(E) >
                 bm * (bn_t + 8) * 4
             ? stages * stage_elems<E>(bm, bn_t) * (int)sizeof(E)
             : bm * (bn_t + 8) * 4;
}
template <typename E>
__host__ __device__ constexpr int smem_bytes(int bm, int bn_t, int stages) {
  return ring_bytes<E>(bm, bn_t, stages) + bn_t * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !valid (src is then only a valid
// address, never read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait until at most `pending` (0-2) groups are in flight
__device__ __forceinline__ void cp_async_wait_dyn(int pending) {
  if (pending <= 0)
    cp_async_wait<0>();
  else if (pending == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<2>();
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c[16x8] += a[16x16] @ b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[16x8] += a[16x8] @ b[8x8], tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// v = big + small + O(2^-22 |v|): big = tf32(v), small = tf32(v - big), both
// as the tensor core reads them (the low 13 bits of big are cleared so that
// v - big is exact)
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  big = r & 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small)
      : "f"(v - __uint_as_float(big)));
}

// 8 consecutive values of T as loaded (one 16-byte vector of bf16, two of
// f32), to f32
__device__ __forceinline__ void unpack8(const uint4 (&u)[1], float (&v)[8]) {
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&u[0]);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack8(const uint4 (&u)[2], float (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = __uint_as_float(reinterpret_cast<const unsigned*>(u)[e]);
}
// 8 f32 values stored as T; p is 16-byte aligned
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  auto* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

// What every launch passes besides its Rows policy.
struct Args {
  const void* blocks;           // E [n_bcols, max_bw, bk, bn]
  const int* block_row;         // [n_bcols, max_bw]
  const int* bcol_nnz;          // [n_bcols]
  const float* bias;            // [n_out] or null
  const void* residual;         // T [rows, n_out] or null
  void* out;                    // T [rows, n_out]
  int n_out, bk, bn, n_bcols, max_bw, relu, stages;
};

// What a split-K launch passes besides (read by the kSplit instances only).
struct Split {
  float* ws;           // [split, rows, n_bcols * bn] f32 partial tiles
  int* counters;       // [m_tiles * n_bcols], all zero between launches
  long long rows;      // output rows: the workspace's second dimension
  int split, share;    // shares per column, live slots per share
  int n_counters;      // length of `counters`
};

// T: residual/output dtype. Rows: tile(mt, bm) / row(r) / block(kblk) /
// at(row, block, kk) / out_row(r), and Elem, the operand type E (see
// sconv_fused.cu, sconv_gc.cu, bsc_spmm.cu). kSplit: the split-K instance
// (Split above).
template <typename T, int BM, int BN_T, class Rows, bool kSplit>
__global__ void __launch_bounds__(2 * BM, 256 / BM)
sconv_pipe_kernel(Rows rows, Args a, Split sp) {
  using E = typename Rows::Elem;
  constexpr bool kF32 = std::is_same<E, float>::value;
  constexpr int kThreads = 2 * BM;
  constexpr int kWN = BN_T / 2;       // warp tile width
  constexpr int kNF = kWN / 8;        // n8 fragments per warp (even)
  constexpr int kC = kChunk<E>;       // K depth of a step
  constexpr int kV = kVec<E>;         // values per 16-byte copy
  constexpr int kAL = kALd<E>;
  constexpr int kBLd = BN_T + 8;      // padded shared row of a B stage
  constexpr int kCLd = BN_T + 8;      // padded shared row of the f32 tile
  constexpr int kStageA = BM * kAL;
  constexpr int kStage = stage_elems<E>(BM, BN_T);
  constexpr int kBG = BN_T / kV;      // 16-byte copies in a B tile row
  constexpr int kBPerThread = kC * kBG / kThreads;
  constexpr int kG = BN_T / 8;        // 8-channel groups in a tile row
  static_assert(kC / kV == 8, "eight 16-byte copies per A row and step");
  static_assert(kRowsPerThread * (kThreads / 8) == BM, "A copy roles");
  static_assert(kBPerThread * kThreads == kC * kBG, "B copy roles");

  extern __shared__ __align__(128) unsigned char smem[];
  auto* ring = reinterpret_cast<E*>(smem);
  float* s_bias = reinterpret_cast<float*>(
      smem + ring_bytes<E>(BM, BN_T, a.stages));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const int j = blockIdx.x % a.n_bcols;
  int tile_id = blockIdx.x / a.n_bcols;  // M-tile (times split, if kSplit)
  int first = 0;  // first live slot of column j that this block walks
  int col_nnz = 0, kblk0 = 0;
  float bias_v = 0.f;
  if constexpr (kSplit) {
    // these few-block launches are latency-bound: the column's count, the
    // share's first K-block (slot `first` < max_bw always exists) and the
    // bias all go out at once, before anything waits on one of them
    static_assert(BN_T <= kThreads, "one bias value per thread");
    const int s = tile_id % sp.split;
    tile_id /= sp.split;
    first = s * sp.share;
    col_nnz = __ldg(a.bcol_nnz + j);
    kblk0 = __ldg(a.block_row + (size_t)j * a.max_bw + first);
    const int col = j * a.bn + tid;
    if (a.bias && tid < a.bn && col < a.n_out) bias_v = __ldg(a.bias + col);
    // a share past the column's live slots has nothing to add; share 0
    // always runs, so an empty column still gets its epilogue
    if (s > 0 && first >= col_nnz) return;
  }
  rows.tile(tile_id, BM);

  if constexpr (!kSplit) {
    for (int c = tid; c < BN_T; c += kThreads) {
      const int col = j * a.bn + c;
      s_bias[c] = (a.bias && c < a.bn && col < a.n_out) ? a.bias[col] : 0.f;
    }
  }

  // copy roles: this thread copies 16-byte column chunk q of A rows
  // tid/8 + i*BM/4, and B chunks tid + i*kThreads of each step
  const int q = tid & 7;
  typename Rows::Row arow[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
    arow[i] = rows.row(tid / 8 + i * (kThreads / 8));

  int nnz;
  if constexpr (kSplit)
    nnz = min(sp.share, col_nnz - first);
  else
    nnz = a.bcol_nnz[j];
  const int cpb = (a.bk + kC - 1) / kC;  // steps per K-block
  const int nsteps = nnz * cpb;
  const int* brow = a.block_row + (size_t)j * a.max_bw + first;
  const E* wcol = static_cast<const E*>(a.blocks) +
                  ((size_t)j * a.max_bw + first) * a.bk * a.bn;

  // the copy side walks the steps in order: K-block ld_s, chunk ld_kc, into
  // ring stage ld_st; a K-block is decoded once, not once per chunk
  int ld_s = 0, ld_kc = 0, ld_st = 0;
  typename Rows::Blk ld_blk{};
  if constexpr (kSplit)
    ld_blk = rows.block(kblk0);
  else if (nnz > 0)
    ld_blk = rows.block(__ldg(brow));
  auto load_next = [&]() {
    E* sa = ring + ld_st * kStage;
    E* sb = sa + kStageA;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = tid / 8 + i * (kThreads / 8);
      const E* src = rows.at(arow[i], ld_blk, ld_kc + q * kV);
      cp_async16(smem_u32(sa + r * kAL + q * kV),
                 src ? static_cast<const void*>(src) : a.blocks,
                 src != nullptr);
    }
    const E* w = wcol + (size_t)ld_s * a.bk * a.bn;
#pragma unroll
    for (int i = 0; i < kBPerThread; ++i) {
      const int v = tid + i * kThreads;
      const int k = v / kBG, c = (v - k * kBG) * kV;
      const bool ok = ld_kc + k < a.bk && c < a.bn;
      cp_async16(smem_u32(sb + k * kBLd + c),
                 ok ? static_cast<const void*>(w + (size_t)(ld_kc + k) * a.bn
                                               + c)
                    : a.blocks,
                 ok);
    }
    if (++ld_st == a.stages) ld_st = 0;
    ld_kc += kC;
    if (ld_kc >= a.bk) {
      ld_kc = 0;
      if (++ld_s < nnz) ld_blk = rows.block(__ldg(brow + ld_s));
    }
  };

  float acc[2][kNF][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < kNF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][f][e] = 0.f;

  const int pre = a.stages - 1;
  for (int t = 0; t < pre; ++t) {
    if (t < nsteps) load_next();
    cp_async_commit();
  }
  int st = 0, kc = 0;  // the multiply side's ring stage and chunk
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait_dyn(a.stages - 2);  // step t has landed
    __syncthreads();                  // and every warp is done with t-1
    if (t + pre < nsteps) load_next();
    cp_async_commit();

    const int depth = min(kC, a.bk - kc);
    const E* sa = ring + st * kStage;
    const E* sb = sa + kStageA;
    if (++st == a.stages) st = 0;
    kc += kC;
    if (kc >= a.bk) kc = 0;
    if constexpr (!kF32) {
#pragma unroll
      for (int ks = 0; ks < kC; ks += 16) {
        if (ks >= depth) break;
        uint32_t fa[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4(smem_u32(sa + (warp_m * 32 + i * 16 + (lane & 15)) * kAL +
                           ks + (lane >> 4) * 8),
                  fa[i]);
#pragma unroll
        for (int f = 0; f < kNF; f += 2) {
          uint32_t fb[4];
          ldsm_x4_trans(smem_u32(sb + (ks + (lane & 15)) * kBLd +
                                 warp_n * kWN + f * 8 + (lane >> 4) * 8),
                        fb);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_bf16(acc[i][f], fa[i], fb[0], fb[1]);
            mma_bf16(acc[i][f + 1], fa[i], fb[2], fb[3]);
          }
        }
      }
    } else {
      // k8 steps; a step past the block's depth reads the zeros its copies
      // filled in (bk % 4 == 0, so a k8 step is at least half live)
      const int g = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int ks = 0; ks < kC; ks += 8) {
        if (ks >= depth) break;
        uint32_t ab[2][4], as[2][4];  // A's big and small halves
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* p = sa + (warp_m * 32 + i * 16 + g) * kAL + ks + tq;
          split_tf32(p[0], ab[i][0], as[i][0]);
          split_tf32(p[8 * kAL], ab[i][1], as[i][1]);
          split_tf32(p[4], ab[i][2], as[i][2]);
          split_tf32(p[8 * kAL + 4], ab[i][3], as[i][3]);
        }
#pragma unroll
        for (int f = 0; f < kNF; ++f) {
          const float* p = sb + (ks + tq) * kBLd + warp_n * kWN + f * 8 + g;
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(p[0], bb0, bs0);
          split_tf32(p[4 * kBLd], bb1, bs1);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_tf32(acc[i][f], as[i], bb0, bb1);
            mma_tf32(acc[i][f], ab[i], bs0, bs1);
            mma_tf32(acc[i][f], ab[i], bb0, bb1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the f32 tile

  float* sc = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < kNF; ++f) {
      const int r = warp_m * 32 + i * 16 + (lane >> 2);
      const int c = warp_n * kWN + f * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(sc + r * kCLd + c) =
          make_float2(acc[i][f][0], acc[i][f][1]);
      *reinterpret_cast<float2*>(sc + (r + 8) * kCLd + c) =
          make_float2(acc[i][f][2], acc[i][f][3]);
    }
  __syncthreads();

  if constexpr (kSplit) {
    if (tid < BN_T) s_bias[tid] = bias_v;
    const int parts = col_nnz > sp.share ? (col_nnz + sp.share - 1) / sp.share
                                         : 1;
    if (parts > 1) {
      // the partial tile of this share: rows out_row(r), the block's bn
      // columns, 8 floats (32 bytes) per group
      const int ldw = a.n_bcols * a.bn;
      const size_t part = (size_t)sp.rows * ldw;
      float* wsj = sp.ws + (size_t)j * a.bn;
      for (int g = tid; g < BM * kG; g += kThreads) {
        const int r = g / kG, lc = (g - r * kG) * 8;
        const long long m = rows.out_row(r);
        if (m < 0 || lc >= a.bn) continue;
        const float4* src = reinterpret_cast<const float4*>(sc + r * kCLd + lc);
        float4* dst = reinterpret_cast<float4*>(
            wsj + (first / sp.share) * part + (size_t)m * ldw + lc);
        __stcg(dst, src[0]);
        __stcg(dst + 1, src[1]);
      }
      __threadfence();
      __syncthreads();
      __shared__ int s_last;
      if (tid == 0) {
        __threadfence();
        int* cnt = sp.counters + tile_id * a.n_bcols + j;
        s_last = atomicAdd(cnt, 1) == parts - 1;
        if (s_last) *cnt = 0;  // every share has arrived: ready for the next
      }
      __syncthreads();
      if (!s_last) return;
      __threadfence();
      // the last share: the sum of the parts in share order, into the f32
      // tile the epilogue reads
      for (int g = tid; g < BM * kG; g += kThreads) {
        const int r = g / kG, lc = (g - r * kG) * 8;
        const long long m = rows.out_row(r);
        if (m < 0 || lc >= a.bn) continue;
        const float* p = wsj + (size_t)m * ldw + lc;
        float4 lo = __ldcg(reinterpret_cast<const float4*>(p));
        float4 hi = __ldcg(reinterpret_cast<const float4*>(p) + 1);
        for (int t = 1; t < parts; ++t) {
          p += part;
          const float4 l = __ldcg(reinterpret_cast<const float4*>(p));
          const float4 h = __ldcg(reinterpret_cast<const float4*>(p) + 1);
          lo.x += l.x; lo.y += l.y; lo.z += l.z; lo.w += l.w;
          hi.x += h.x; hi.y += h.y; hi.z += h.z; hi.w += h.w;
        }
        *reinterpret_cast<float4*>(sc + r * kCLd + lc) = lo;
        *reinterpret_cast<float4*>(sc + r * kCLd + lc + 4) = hi;
      }
    }
    __syncthreads();  // the bias; each thread reads back only its own sums
  }

  // each thread takes groups g = tid + i*kThreads, 8 channels of one tile
  // row each; all its residual reads go out before any store, so their
  // latencies overlap instead of adding up
  constexpr int kGPT = BM * kG / kThreads;  // groups per thread
  constexpr int kRaw = sizeof(T) / 2;       // 16-byte vectors per group
  static_assert(kGPT * kThreads == BM * kG, "epilogue roles");
  const T* res = static_cast<const T*>(a.residual);
  T* out = static_cast<T*>(a.out);
  const bool vec = (a.n_out & 7) == 0;  // 16-byte aligned output rows
  long long dst[kGPT];                  // output offset, -1: nothing to write
  uint4 raw[kGPT][kRaw];
#pragma unroll
  for (int i = 0; i < kGPT; ++i) {
    const int g = tid + i * kThreads, r = g / kG, lc = (g - r * kG) * 8;
    const int col = j * a.bn + lc;
    const long long m =
        (lc < a.bn && col < a.n_out) ? rows.out_row(r) : -1;
    dst[i] = m < 0 ? -1 : m * a.n_out + col;
    if (vec && res && dst[i] >= 0)
#pragma unroll
      for (int h = 0; h < kRaw; ++h)
        raw[i][h] = __ldg(reinterpret_cast<const uint4*>(res + dst[i]) + h);
  }
#pragma unroll
  for (int i = 0; i < kGPT; ++i) {
    if (dst[i] < 0) continue;
    const int g = tid + i * kThreads, r = g / kG, lc = (g - r * kG) * 8;
    float v[8];
    const float4 lo = *reinterpret_cast<const float4*>(sc + r * kCLd + lc);
    const float4 hi = *reinterpret_cast<const float4*>(sc + r * kCLd + lc + 4);
    const float4 blo = *reinterpret_cast<const float4*>(s_bias + lc);
    const float4 bhi = *reinterpret_cast<const float4*>(s_bias + lc + 4);
    v[0] = lo.x + blo.x; v[1] = lo.y + blo.y;
    v[2] = lo.z + blo.z; v[3] = lo.w + blo.w;
    v[4] = hi.x + bhi.x; v[5] = hi.y + bhi.y;
    v[6] = hi.z + bhi.z; v[7] = hi.w + bhi.w;
    if (vec) {
      if (res) {
        float rv[8];
        unpack8(raw[i], rv);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += rv[e];
      }
      if (a.relu)
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.f);
      store8(out + dst[i], v);
    } else {
      const int col = j * a.bn + lc;
      for (int e = 0; e < 8 && col + e < a.n_out; ++e) {
        float x = v[e];
        if (res) x += to_f32(res[dst[i] + e]);
        if (a.relu) x = fmaxf(x, 0.f);
        from_f32(x, out + dst[i] + e);
      }
    }
  }
}

template <typename T, int BM, int BN_T, bool kSplit, class Rows>
cudaError_t launch_one(const Rows& rows, const Args& a, const Split& sp,
                       int m_tiles, int smem, cudaStream_t st) {
  auto* kern = sconv_pipe_kernel<T, BM, BN_T, Rows, kSplit>;
  // dynamic shared bytes this instance may use, per device: the attribute
  // is set on the current device only
  constexpr int kMaxDevices = 64;
  static int opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > opted[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    opted[dev] = smem;
  }
  const long long split = kSplit ? sp.split : 1;
  kern<<<dim3((unsigned)(m_tiles * a.n_bcols * split)), 2 * BM, smem, st>>>(
      rows, a, sp);
  return cudaGetLastError();
}

// The launch plan (tile_m, stages, chunk, smem) comes from the wrapper
// (kernels/sconv_pipe.py); it is checked here against what the compiled
// kernel needs, and a plan it does not match is refused. E: the operand
// type, whose 16-byte copies need K-blocks of a multiple of kVec<E>.
template <typename E>
bool plan_ok(const Args& a, int m_tiles, int tile_m, int chunk, int smem) {
  return a.bn > 0 && a.bn <= 128 && a.bn % 8 == 0 && a.bk > 0 &&
         a.bk % kVec<E> == 0 && m_tiles > 0 && a.n_bcols > 0 &&
         a.max_bw > 0 && (tile_m == 64 || tile_m == 128) && a.stages >= 2 &&
         a.stages <= kMaxStages && chunk == kChunk<E> &&
         (long long)m_tiles * a.n_bcols <= 0x7fffffffLL &&
         smem == smem_bytes<E>(tile_m, bn_tile(a.bn), a.stages);
}

template <typename T, class Rows>
cudaError_t launch_sconv_pipe(const Rows& rows, const Args& a, int m_tiles,
                              int tile_m, int chunk, int smem, void* stream) {
  if (!plan_ok<typename Rows::Elem>(a, m_tiles, tile_m, chunk, smem))
    return cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Split sp{};
  const int bn_t = bn_tile(a.bn);
  if (tile_m == 128) {
    if (bn_t == 32)
      return launch_one<T, 128, 32, false>(rows, a, sp, m_tiles, smem, st);
    if (bn_t == 64)
      return launch_one<T, 128, 64, false>(rows, a, sp, m_tiles, smem, st);
    return launch_one<T, 128, 128, false>(rows, a, sp, m_tiles, smem, st);
  }
  if (bn_t == 32)
    return launch_one<T, 64, 32, false>(rows, a, sp, m_tiles, smem, st);
  if (bn_t == 64)
    return launch_one<T, 64, 64, false>(rows, a, sp, m_tiles, smem, st);
  return launch_one<T, 64, 128, false>(rows, a, sp, m_tiles, smem, st);
}

// A split-K launch: 64-row tiles only (the plan splits only launches with
// too few M-tiles to fill the card), shares that cover every column's live
// slots with none wholly past max_bw, and a counter per (M-tile, column).
template <typename T, class Rows>
cudaError_t launch_sconv_pipe_split(const Rows& rows, const Args& a,
                                    const Split& sp, int m_tiles, int tile_m,
                                    int chunk, int smem, void* stream) {
  if (!plan_ok<typename Rows::Elem>(a, m_tiles, tile_m, chunk, smem) ||
      tile_m != 64 ||
      sp.split < 2 || sp.share < 1 ||
      (long long)sp.split * sp.share < a.max_bw ||
      (long long)(sp.split - 1) * sp.share >= a.max_bw || !sp.ws ||
      !sp.counters || sp.rows <= 0 ||
      (long long)m_tiles * a.n_bcols > sp.n_counters ||
      (long long)m_tiles * a.n_bcols * sp.split > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int bn_t = bn_tile(a.bn);
  if (bn_t == 32)
    return launch_one<T, 64, 32, true>(rows, a, sp, m_tiles, smem, st);
  if (bn_t == 64)
    return launch_one<T, 64, 64, true>(rows, a, sp, m_tiles, smem, st);
  return launch_one<T, 64, 128, true>(rows, a, sp, m_tiles, smem, st);
}

}  // namespace pipe
}  // namespace cet
