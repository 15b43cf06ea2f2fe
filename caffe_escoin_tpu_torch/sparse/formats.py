"""Block compressed sparse column weights (port of
``caffe_escoin_tpu/sparse/formats.py:266-403``).

Only the padded per-block-column layout that the kernels read is carried
over; the flat view, ELL, CSR and BSR wait until something reads them.
Conversion is numpy, run once at weight-align time, and gives the same
arrays as the JAX package's ``dense_to_bsc``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BSC:
    """Block-sparse matrix W[K, N] stored by columns of (bk, bn) blocks.

    For a GEMM-view conv weight (rows ordered kh, kw, cin) each K-block
    index decodes to one (kernel offset, cin-block) pair, which is what the
    direct-conv kernel turns into a shifted input read.

    * ``blocks``    [n_bcols, max_bw, bk, bn]: zero-padded payloads.
    * ``block_row`` [n_bcols, max_bw] int32: K-block index per slot;
                    padding slots point at K-block 0 with a zero payload.
    * ``bcol_nnz``  [n_bcols] int32: live slots per block column.

    ``nnz_blocks`` is kept on the host, so the profitability gates never
    read a device tensor; so are numpy copies of ``block_row`` and
    ``bcol_nnz`` (``pattern``), which the XBSP arms and autotune read on
    every call: read from the device, each would wait for it. ``memo``
    holds what the XBSP arms derive from this object once (its live lists,
    the union-packed weight), so a forward copies nothing host to device;
    ``to`` starts the copy with an empty one.
    """

    blocks: torch.Tensor
    block_row: torch.Tensor
    bcol_nnz: torch.Tensor
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]
    nnz_blocks: int
    block_row_np: Optional[np.ndarray] = dataclasses.field(
        default=None, compare=False, repr=False)
    bcol_nnz_np: Optional[np.ndarray] = dataclasses.field(
        default=None, compare=False, repr=False)
    memo: dict = dataclasses.field(default_factory=dict, init=False,
                                   compare=False, repr=False)

    @property
    def n_bcols(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def n_brows(self) -> int:
        return -(-self.shape[0] // self.block_shape[0])

    @property
    def max_bw(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def block_density(self) -> float:
        return self.nnz_blocks / max(1, self.n_brows * self.n_bcols)

    def pattern(self) -> Tuple[np.ndarray, np.ndarray]:
        """(block_row, bcol_nnz) as host numpy arrays. A BSC built without
        them (by hand, from tensors) reads them from its tensors once."""
        if self.block_row_np is None or self.bcol_nnz_np is None:
            object.__setattr__(self, "block_row_np",
                               self.block_row.cpu().numpy())
            object.__setattr__(self, "bcol_nnz_np",
                               self.bcol_nnz.cpu().numpy())
        return self.block_row_np, self.bcol_nnz_np

    def to(self, device=None, dtype=None) -> "BSC":
        """Move to ``device``; ``dtype`` casts the payloads only."""
        return dataclasses.replace(
            self,
            blocks=self.blocks.to(device=device, dtype=dtype),
            block_row=self.block_row.to(device=device),
            bcol_nnz=self.bcol_nnz.to(device=device))

    def to_dense(self) -> torch.Tensor:
        bk, bn = self.block_shape
        rows, cols = self.shape
        dense = torch.zeros((self.n_brows, self.n_bcols, bk, bn),
                            dtype=self.blocks.dtype, device=self.blocks.device)
        bc = torch.arange(self.n_bcols, device=self.blocks.device
                          ).repeat_interleave(self.max_bw)
        dense.index_put_((self.block_row.reshape(-1).long(), bc),
                         self.blocks.reshape(-1, bk, bn), accumulate=True)
        return dense.permute(0, 2, 1, 3).reshape(
            self.n_brows * bk, self.n_bcols * bn)[:rows, :cols]


def dense_to_bsc(w, block_shape: Tuple[int, int]) -> BSC:
    """Dense (K, N) -> BSC with fixed (bk, bn) blocks (zero-padded edges).
    Returns CPU tensors; move them with ``BSC.to``."""
    w = np.asarray(w)
    rows, cols = w.shape
    bk, bn = block_shape
    R, C = -(-rows // bk) * bk, -(-cols // bn) * bn
    wp = np.zeros((R, C), w.dtype)
    wp[:rows, :cols] = w
    n_brows, n_bcols = R // bk, C // bn
    blocked = wp.reshape(n_brows, bk, n_bcols, bn).transpose(2, 0, 1, 3)
    live = (blocked != 0).any(axis=(2, 3))  # [n_bcols, n_brows]
    bcol_nnz = live.sum(axis=1).astype(np.int32)
    max_bw = max(1, int(bcol_nnz.max()) if n_bcols else 1)
    blocks = np.zeros((n_bcols, max_bw, bk, bn), w.dtype)
    block_row = np.zeros((n_bcols, max_bw), np.int32)
    bc, br = np.nonzero(live)
    if len(bc):
        within = np.concatenate([np.arange(n) for n in bcol_nnz])
        blocks[bc, within] = blocked[bc, br]
        block_row[bc, within] = br
    return BSC(
        blocks=torch.from_numpy(blocks),
        block_row=torch.from_numpy(block_row),
        bcol_nnz=torch.from_numpy(bcol_nnz),
        shape=(rows, cols),
        block_shape=(bk, bn),
        nnz_blocks=int(bcol_nnz.sum()),
        block_row_np=block_row,
        bcol_nnz_np=bcol_nnz,
    )
