"""Launch plan of the pipelined tile loop (``csrc/sconv_pipe.cuh``), shared
by ``sconv_fused``, ``sconv_gc`` and ``bsc_spmm``.

The wrapper computes the plan from shapes as plain integers and passes it
to the C entry, which refuses a plan its compiled kernel does not match.
So the CPU tests can check what a launch would use on the card: its shared
memory, its grid, and which output rows and live K-blocks each block
covers.

* ``tile_m``: 128 output rows per block when that makes at least one
  block for every other SM of the card, else 64, so the smallest layers
  (ResNet-50's res5 at b32: 52 blocks of 128 rows) make more blocks.
  Measured with ``plan_sweep.py`` at the repository root: 64-row tiles
  win only there, and lose from about 98 blocks of 128 rows up. An SpMM
  with at most 64 rows always takes 64.
* ``split`` and ``share`` (``spmm_plan`` only): a launch with too few
  M-tiles x block-columns to fill the card cuts each column's live
  K-blocks into ``split`` shares of ``share`` slots, one block each, for
  about three blocks per SM; the kernel sums the shares in the same launch.
* ``stages``: the depth of the cp.async ring, 2-4: as many steps as the
  longest share of a block-column has, while two blocks still fit on one
  SM.
* ``chunk``: the K depth of one step (``kChunk`` of the kernel): 128
  bytes of a row, 64 values in bf16 and 32 in f32.
* ``smem``: the dynamic shared bytes of one block: the ring or the f32
  accumulator tile that reuses it, whichever is larger, plus the bias.

Each plan is for one multiply type (``mul``, the resolved ``mxu_dtype``):
"bfloat16" or "float32". A stage holds the same bytes in both, but an f32
K-block takes twice the steps, so the ring may be deeper.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

CHUNK = 64               # the K depth of a bf16 step (chunk_of)
MAX_STAGES = 4
SMS = 132                 # streaming multiprocessors of an H100 SXM
SMEM_PER_BLOCK = 232448   # the most dynamic shared memory a block may use
SMEM_PER_SM = 233472      # 228 KB per SM, of which the runtime keeps
SMEM_RESERVED = 1024      # this much per resident block


def bn_tile(bn: int) -> int:
    """Tile width compiled for a block width ``bn`` (``bn_tile`` of the
    kernel)."""
    return 32 if bn <= 32 else 64 if bn <= 64 else 128


_ITEMSIZE = {"bfloat16": 2, "float32": 4}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def chunk_of(mul: str) -> int:
    """K depth of one step for multiply type ``mul`` (``kChunk``)."""
    return 128 // _ITEMSIZE[mul]


def vec_of(mul: str) -> int:
    """Values of ``mul`` in one 16-byte copy (``kVec``): channels and
    K-blocks are handed over in multiples of it."""
    return 16 // _ITEMSIZE[mul]


def smem_bytes(tile_m: int, bn_t: int, stages: int,
               mul: str = "bfloat16") -> int:
    """Dynamic shared bytes of one block (``smem_bytes`` of the kernel):
    ``stages`` stages of an A tile (rows padded by 16 bytes) and a B tile
    (rows padded by 8 values), or the f32 accumulator tile."""
    size, chunk = _ITEMSIZE[mul], chunk_of(mul)
    ring = stages * (tile_m * (chunk + vec_of(mul))
                     + chunk * (bn_t + 8)) * size
    return max(ring, tile_m * (bn_t + 8) * 4) + bn_t * 4


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch: ``tiles_per_image * images`` M-tiles times ``split``
    shares times ``n_bcols`` block-columns, block-column fastest. A tile
    never crosses an image: with ``images == 1`` the rows run over the
    whole batch (``sconv_fused``, whose rows decode their own image, and
    ``bsc_spmm``), else over one image each (``sconv_gc``). Share ``s`` of
    a column walks its live slots ``[s * share, (s + 1) * share)``."""

    tile_m: int
    stages: int
    chunk: int
    smem: int
    images: int
    rows_per_image: int
    n_bcols: int
    split: int = 1
    share: int = 0  # live slots per share; 0: the whole column (split 1)

    @property
    def tiles_per_image(self) -> int:
        return -(-self.rows_per_image // self.tile_m)

    @property
    def m_tiles(self) -> int:
        return self.images * self.tiles_per_image

    @property
    def grid(self) -> int:
        return self.m_tiles * self.split * self.n_bcols

    @property
    def threads(self) -> int:
        return 2 * self.tile_m

    def block(self, b: int) -> Tuple[int, int, int, int]:
        """(image, first row, end row, block-column) that block ``b`` of the
        grid computes, as the kernel decodes ``blockIdx.x``."""
        mt, j = divmod(b, self.n_bcols)
        img, t = divmod(mt // self.split, self.tiles_per_image)
        first = t * self.tile_m
        return img, first, min(first + self.tile_m, self.rows_per_image), j

    def slots(self, b: int, nnz: int) -> range:
        """The live slots of its column (``nnz`` of them) that block ``b``
        walks: all of them unsplit, else its share's."""
        if self.split == 1:
            return range(nnz)
        s = b // self.n_bcols % self.split
        return range(min(nnz, s * self.share),
                     min(nnz, (s + 1) * self.share))

    def __str__(self) -> str:
        split = (f", split {self.split} x {self.share} slots"
                 if self.split > 1 else "")
        return (f"tile_m {self.tile_m}, stages {self.stages}, chunk "
                f"{self.chunk}, {self.smem} B shared{split}, grid "
                f"{self.grid} x {self.threads} threads")


def _stages(tile_m: int, bn_t: int, steps: int, mul: str) -> int:
    """Ring depth: ``steps`` (those of a block's longest walk) within 2-4,
    while two blocks still fit on one SM."""
    stages = max(2, min(MAX_STAGES, steps))
    while stages > 2 and 2 * (smem_bytes(tile_m, bn_t, stages, mul)
                              + SMEM_RESERVED) > SMEM_PER_SM:
        stages -= 1
    return stages


@functools.lru_cache(maxsize=4096)
def plan(images: int, rows_per_image: int, block_shape: Tuple[int, int],
         n_bcols: int, max_bw: int, mul: str = "bfloat16") -> LaunchPlan:
    """The launch plan for ``images`` runs of ``rows_per_image`` output rows
    against a BSC weight of ``block_shape`` (bk, bn) blocks, ``n_bcols``
    block-columns and at most ``max_bw`` live K-blocks in one of them,
    multiplied in ``mul``. Cached: eager dispatch asks it again for every
    layer of every forward."""
    bk, bn = block_shape
    tiles_128 = images * -(-rows_per_image // 128) * n_bcols
    tile_m = 128 if tiles_128 >= SMS // 2 else 64
    bn_t = bn_tile(bn)
    chunk = chunk_of(mul)
    stages = _stages(tile_m, bn_t, max_bw * -(-bk // chunk), mul)
    return LaunchPlan(tile_m=tile_m, stages=stages, chunk=chunk,
                      smem=smem_bytes(tile_m, bn_t, stages, mul),
                      images=images, rows_per_image=rows_per_image,
                      n_bcols=n_bcols)


@functools.lru_cache(maxsize=4096)
def spmm_plan(m: int, block_shape: Tuple[int, int], n_bcols: int,
              max_bw: int, mul: str = "bfloat16") -> LaunchPlan:
    """The launch plan of ``bsc_spmm`` for an A of ``m`` rows against a BSC
    weight of ``block_shape`` (bk, bn; bk as the kernel reads it),
    ``n_bcols`` block-columns and at most ``max_bw`` live K-blocks in one,
    multiplied in ``mul``.

    Tile rows as ``plan``'s, but 64 whenever m <= 64. A launch of 64-row
    tiles with fewer blocks than about three per SM is split: each
    (M-tile, column) gets ``split`` blocks of ``share`` live slots and at
    least two ring steps each, about three blocks per SM in all; a split
    block's ring holds all of a short share's steps at once (steps + 1
    stages). Large-M launches (the lowered and 1x1 conv routes) already
    fill the card: split 1, stages as ``plan``'s. Measured with
    ``plan_sweep.py spmm``: on fc6 (32 columns of up to 31 live K-blocks)
    11 shares of 3 slots beat 8 of 4, the finer shares evening out columns
    of uneven length; 3 stages beat 2 on the two-step shares of fc1000 and
    fc8."""
    bk, bn = block_shape
    tiles_128 = -(-m // 128) * n_bcols
    tile_m = 128 if m > 64 and tiles_128 >= SMS // 2 else 64
    chunk = chunk_of(mul)
    cpb = -(-bk // chunk)  # steps per K-block
    tiles = -(-m // tile_m) * n_bcols
    split, share, steps = 1, 0, max_bw * cpb
    want = 3 * SMS // tiles
    if tile_m == 64 and want >= 2:
        share = min(max_bw, max(-(-max_bw // want), -(-2 // cpb)))
        split = -(-max_bw // share)
        steps = share * cpb + 1
    if split == 1:
        share, steps = 0, max_bw * cpb
    bn_t = bn_tile(bn)
    stages = _stages(tile_m, bn_t, steps, mul)
    return LaunchPlan(tile_m=tile_m, stages=stages, chunk=chunk,
                      smem=smem_bytes(tile_m, bn_t, stages, mul), images=1,
                      rows_per_image=m, n_bcols=n_bcols, split=split,
                      share=share)


def kernel_operands(x: torch.Tensor, aligned,
                    mul: str = "bfloat16") -> Tuple[torch.Tensor,
                                                    torch.Tensor, int]:
    """(x, weight blocks, bk) as the kernels copy them: 16 bytes at a time
    with ``cp.async``, which does not convert. So x and the blocks are in
    the multiply type ``mul``: bf16 (an f32 activation is rounded to
    nearest-even here, as the MMA rounds it) or f32 (never rounded; a bf16
    activation or weight is widened, which is exact, as the JAX kernels'
    ``astype(mxu)``). Its rows carry a multiple of ``vec_of(mul)`` channels
    (8 in bf16, 4 in f32; zero channels appended, which meet zero weight
    rows), and a K-block is a multiple of it deep: where bk is not, each
    cin-block of x and each weight block is zero-padded to the next
    multiple. On the main path (x and blocks already in ``mul``, Cin and bk
    multiples of the vector) nothing is copied."""
    bsc = aligned.bsc
    bk = bsc.block_shape[0]
    blocks = bsc.blocks
    dtype, vec = DTYPES[mul], vec_of(mul)
    # the dtype tests spare the main path the cost of a no-op .to()
    if x.dtype != dtype:
        x = x.to(dtype)
    if blocks.dtype != dtype:
        blocks = blocks.to(dtype)
    if bk % vec == 0:
        if x.shape[-1] % vec:
            x = F.pad(x, (0, -x.shape[-1] % vec))
        return (x if x.is_contiguous() else x.contiguous()), blocks, bk
    bkv = bk + -bk % vec
    x = F.pad(x, (0, aligned.cin_pad - x.shape[-1]))
    x = F.pad(x.unflatten(-1, (aligned.cin_pad // bk, bk)), (0, bkv - bk))
    return (x.flatten(-2).contiguous(),
            F.pad(blocks, (0, 0, 0, bkv - bk)).contiguous(), bkv)
