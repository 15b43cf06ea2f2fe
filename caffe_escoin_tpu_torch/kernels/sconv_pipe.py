"""Launch plan of the pipelined direct-conv tile loop (``csrc/sconv_pipe.cuh``),
shared by ``sconv_fused`` and ``sconv_gc``.

The wrapper computes the plan from shapes as plain integers and passes it
to the C entry, which refuses a plan its compiled kernel does not match.
So the CPU tests can check what a launch would use on the card: its shared
memory, its grid, and which output rows each tile covers.

* ``tile_m``: 128 output rows per block when that makes at least one
  block for every other SM of the card, else 64, so the smallest layers
  (ResNet-50's res5 at b32: 52 blocks of 128 rows) make more blocks.
  Measured with ``plan_sweep.py`` at the repository root: 64-row tiles
  win only there, and lose from about 98 blocks of 128 rows up.
* ``stages``: the depth of the cp.async ring, 2-4: as many steps as the
  longest block-column has, while two blocks still fit on one SM.
* ``chunk``: the K depth of one step (``kChunk`` of the kernel).
* ``smem``: the dynamic shared bytes of one block: the ring or the f32
  accumulator tile that reuses it, whichever is larger, plus the bias.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

CHUNK = 64
MAX_STAGES = 4
SMS = 132                 # streaming multiprocessors of an H100 SXM
SMEM_PER_BLOCK = 232448   # the most dynamic shared memory a block may use
SMEM_PER_SM = 233472      # 228 KB per SM, of which the runtime keeps
SMEM_RESERVED = 1024      # this much per resident block


def bn_tile(bn: int) -> int:
    """Tile width compiled for a block width ``bn`` (``bn_tile`` of the
    kernel)."""
    return 32 if bn <= 32 else 64 if bn <= 64 else 128


def smem_bytes(tile_m: int, bn_t: int, stages: int) -> int:
    """Dynamic shared bytes of one block (``smem_bytes`` of the kernel)."""
    ring = stages * (tile_m * (CHUNK + 8) + CHUNK * (bn_t + 8)) * 2
    return max(ring, tile_m * (bn_t + 8) * 4) + bn_t * 4


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One launch: ``tiles_per_image * images`` M-tiles times ``n_bcols``
    block-columns, block-column fastest. A tile never crosses an image:
    with ``images == 1`` the rows run over the whole batch (``sconv_fused``,
    whose rows decode their own image), else over one image each
    (``sconv_gc``)."""

    tile_m: int
    stages: int
    chunk: int
    smem: int
    images: int
    rows_per_image: int
    n_bcols: int

    @property
    def tiles_per_image(self) -> int:
        return -(-self.rows_per_image // self.tile_m)

    @property
    def m_tiles(self) -> int:
        return self.images * self.tiles_per_image

    @property
    def grid(self) -> int:
        return self.m_tiles * self.n_bcols

    @property
    def threads(self) -> int:
        return 2 * self.tile_m

    def block(self, b: int) -> Tuple[int, int, int, int]:
        """(image, first row, end row, block-column) that block ``b`` of the
        grid computes, as the kernel decodes ``blockIdx.x``."""
        mt, j = divmod(b, self.n_bcols)
        img, t = divmod(mt, self.tiles_per_image)
        first = t * self.tile_m
        return img, first, min(first + self.tile_m, self.rows_per_image), j

    def __str__(self) -> str:
        return (f"tile_m {self.tile_m}, stages {self.stages}, chunk "
                f"{self.chunk}, {self.smem} B shared, grid {self.grid} x "
                f"{self.threads} threads")


@functools.lru_cache(maxsize=4096)
def plan(images: int, rows_per_image: int, block_shape: Tuple[int, int],
         n_bcols: int, max_bw: int) -> LaunchPlan:
    """The launch plan for ``images`` runs of ``rows_per_image`` output rows
    against a BSC weight of ``block_shape`` (bk, bn) blocks, ``n_bcols``
    block-columns and at most ``max_bw`` live K-blocks in one of them.
    Cached: eager dispatch asks it again for every layer of every
    forward."""
    bk, bn = block_shape
    tiles_128 = images * -(-rows_per_image // 128) * n_bcols
    tile_m = 128 if tiles_128 >= SMS // 2 else 64
    bn_t = bn_tile(bn)
    steps = max_bw * -(-bk // CHUNK)
    stages = max(2, min(MAX_STAGES, steps))
    while stages > 2 and 2 * (smem_bytes(tile_m, bn_t, stages)
                              + SMEM_RESERVED) > SMEM_PER_SM:
        stages -= 1
    return LaunchPlan(tile_m=tile_m, stages=stages, chunk=CHUNK,
                      smem=smem_bytes(tile_m, bn_t, stages), images=images,
                      rows_per_image=rows_per_image, n_bcols=n_bcols)


def kernel_operands(x: torch.Tensor, aligned) -> Tuple[torch.Tensor,
                                                      torch.Tensor, int]:
    """(x, weight blocks, bk) as the kernels copy them: 16 bytes at a time
    with ``cp.async``, which does not convert. So x is bf16 (an f32
    activation is rounded to nearest-even here, as the MMA rounds it), its
    rows carry a multiple of 8 channels (zero channels appended; they meet
    zero weight rows), and a K-block is a multiple of 8 deep: where bk is
    not, each cin-block of x and each weight block is zero-padded to the
    next multiple of 8. On the main path (bf16 x, Cin and bk multiples of
    8) nothing is copied."""
    bsc = aligned.bsc
    bk = bsc.block_shape[0]
    blocks = bsc.blocks
    # the dtype tests spare the main path the cost of a no-op .to()
    if x.dtype != torch.bfloat16:
        x = x.to(torch.bfloat16)
    if blocks.dtype != torch.bfloat16:
        blocks = blocks.to(torch.bfloat16)
    if bk % 8 == 0:
        if x.shape[-1] % 8:
            x = F.pad(x, (0, -x.shape[-1] % 8))
        return (x if x.is_contiguous() else x.contiguous()), blocks, bk
    bk8 = bk + -bk % 8
    x = F.pad(x, (0, aligned.cin_pad - x.shape[-1]))
    x = F.pad(x.unflatten(-1, (aligned.cin_pad // bk, bk)), (0, bk8 - bk))
    return (x.flatten(-2).contiguous(),
            F.pad(blocks, (0, 0, 0, bk8 - bk)).contiguous(), bk8)
