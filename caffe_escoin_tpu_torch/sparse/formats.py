"""Sparse matrix containers and dense -> sparse conversion (port of
``caffe_escoin_tpu/sparse/formats.py``).

* ``CSR`` -- values/colidx/rowptr: the interchange format;
* ``ELL`` -- row-padded CSR: every row padded to the widest, padding slots
  holding value 0 at column 0, so a gather-FMA over all slots is exact
  (kernels/spmm.ell_spmm, the unstructured path);
* ``BSR`` -- block compressed sparse row, padded per block-row, with the
  flat view of the JAX package;
* ``BSC`` -- block compressed sparse column: the padded per-block-column
  layout the kernels and the XBSP arms read (the JAX package's flat view
  of it has no reader here).

Conversions are vectorised numpy, run once at weight-align time, and give
the same arrays as the JAX package's. Each format's ``to(device, dtype)``
casts its values only; indices stay integer. Every count a routing gate
reads (``nnz``, ``nnz_blocks``, ``width``) comes from the host, so no
forward waits for the device.
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


# ---------------------------------------------------------------------------
# CSR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CSR:
    """values[nnz], colidx[nnz] (int32), rowptr[rows+1] (int32)."""

    values: torch.Tensor
    colidx: torch.Tensor
    rowptr: torch.Tensor
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    @property
    def density(self) -> float:
        rows, cols = self.shape
        return self.nnz / max(1, rows * cols)

    def to(self, device=None, dtype=None) -> "CSR":
        """Move to ``device``; ``dtype`` casts the values only."""
        return dataclasses.replace(
            self, values=self.values.to(device=device, dtype=dtype),
            colidx=self.colidx.to(device=device),
            rowptr=self.rowptr.to(device=device))

    def to_dense(self) -> torch.Tensor:
        dense = torch.zeros(self.shape, dtype=self.values.dtype,
                            device=self.values.device)
        counts = (self.rowptr[1:] - self.rowptr[:-1]).long()
        rows = torch.repeat_interleave(
            torch.arange(self.shape[0], device=self.values.device), counts)
        dense[rows, self.colidx.long()] = self.values
        return dense


def dense_to_csr(w, dtype=None) -> CSR:
    """Dense (rows, cols) -> CSR (CPU tensors)."""
    w = np.asarray(w)
    if dtype is not None:
        w = w.astype(dtype)
    rows, cols = w.shape
    mask = w != 0
    rowptr = np.zeros(rows + 1, np.int32)
    np.cumsum(mask.sum(axis=1), out=rowptr[1:])
    ridx, cidx = np.nonzero(mask)
    return CSR(values=torch.from_numpy(w[ridx, cidx]),
               colidx=torch.from_numpy(cidx.astype(np.int32)),
               rowptr=torch.from_numpy(rowptr), shape=(rows, cols))


# ---------------------------------------------------------------------------
# ELL (row-padded CSR)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ELL:
    """values[rows, width], colidx[rows, width] (int32), row_nnz[rows]
    (int32). A padding slot holds value 0 at column 0, so an unmasked
    gather-FMA over every slot is exact (0 times a real row adds 0).
    ``row_nnz_np`` is the host copy that ``nnz`` reads."""

    values: torch.Tensor
    colidx: torch.Tensor
    row_nnz: torch.Tensor
    shape: Tuple[int, int]
    row_nnz_np: np.ndarray = dataclasses.field(compare=False, repr=False)

    @property
    def width(self) -> int:
        return int(self.values.shape[1])

    @property
    def nnz(self) -> int:
        """Live entries, padding excluded."""
        return int(self.row_nnz_np.sum())

    def to(self, device=None, dtype=None) -> "ELL":
        """Move to ``device``; ``dtype`` casts the values only."""
        return dataclasses.replace(
            self, values=self.values.to(device=device, dtype=dtype),
            colidx=self.colidx.to(device=device),
            row_nnz=self.row_nnz.to(device=device))

    def to_dense(self) -> torch.Tensor:
        rows, cols = self.shape
        dense = torch.zeros((rows, cols), dtype=self.values.dtype,
                            device=self.values.device)
        r = torch.arange(rows, device=self.values.device).repeat_interleave(
            self.width)
        return dense.index_put_((r, self.colidx.reshape(-1).long()),
                                self.values.reshape(-1), accumulate=True)


def dense_to_ell(w, width: Optional[int] = None, lane_pad: int = 1) -> ELL:
    """Dense -> ELL (CPU tensors). ``width`` defaults to the widest row's
    nnz; it is rounded up to a multiple of ``lane_pad`` and is at least
    1."""
    w = np.asarray(w)
    rows, cols = w.shape
    mask = w != 0
    row_nnz = mask.sum(axis=1).astype(np.int32)
    if width is None:
        width = int(row_nnz.max()) if rows else 0
    width = -(-max(1, width) // lane_pad) * lane_pad
    values = np.zeros((rows, width), w.dtype)
    colidx = np.zeros((rows, width), np.int32)
    ridx, cidx = np.nonzero(mask)
    if len(ridx):
        # rank of each nonzero within its row
        within = np.arange(len(ridx)) - np.repeat(
            np.cumsum(row_nnz) - row_nnz, row_nnz)
        values[ridx, within] = w[ridx, cidx]
        colidx[ridx, within] = cidx
    return ELL(values=torch.from_numpy(values),
               colidx=torch.from_numpy(colidx),
               row_nnz=torch.from_numpy(row_nnz), shape=(rows, cols),
               row_nnz_np=row_nnz)


# ---------------------------------------------------------------------------
# BSR (block compressed sparse row), padded per-block-row layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-sparse matrix W[rows, cols] stored by rows of (bm, bk) blocks.

    * ``blocks``    [n_brows, max_bw, bm, bk]: zero-padded payloads.
    * ``block_col`` [n_brows, max_bw] int32: block-column per slot; padding
                    slots point at block-column 0 with a zero payload.
    * ``brow_nnz``  [n_brows] int32: live slots per block row.
    * the flat view: ``flat_blocks`` [n_flat, bm, bk], ``flat_row`` and
      ``flat_col`` [n_flat], the live blocks row-major (n_flat >= 1).

    ``brow_nnz_np`` is the host copy that ``nnz_blocks`` reads.
    """

    blocks: torch.Tensor
    block_col: torch.Tensor
    brow_nnz: torch.Tensor
    flat_blocks: torch.Tensor
    flat_row: torch.Tensor
    flat_col: torch.Tensor
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]
    brow_nnz_np: np.ndarray = dataclasses.field(compare=False, repr=False)

    @property
    def n_brows(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def n_bcols(self) -> int:
        return -(-self.shape[1] // self.block_shape[1])

    @property
    def max_bw(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def n_flat(self) -> int:
        return int(self.flat_blocks.shape[0])

    @property
    def nnz_blocks(self) -> int:
        return int(self.brow_nnz_np.sum())

    @property
    def block_density(self) -> float:
        return self.nnz_blocks / max(1, self.n_brows * self.n_bcols)

    def to(self, device=None, dtype=None) -> "BSR":
        """Move to ``device``; ``dtype`` casts the payloads only."""
        return dataclasses.replace(
            self, blocks=self.blocks.to(device=device, dtype=dtype),
            block_col=self.block_col.to(device=device),
            brow_nnz=self.brow_nnz.to(device=device),
            flat_blocks=self.flat_blocks.to(device=device, dtype=dtype),
            flat_row=self.flat_row.to(device=device),
            flat_col=self.flat_col.to(device=device))

    def to_dense(self) -> torch.Tensor:
        bm, bk = self.block_shape
        rows, cols = self.shape
        dense = torch.zeros((self.n_brows, self.n_bcols, bm, bk),
                            dtype=self.blocks.dtype, device=self.blocks.device)
        br = torch.arange(self.n_brows, device=self.blocks.device
                          ).repeat_interleave(self.max_bw)
        dense.index_put_((br, self.block_col.reshape(-1).long()),
                         self.blocks.reshape(-1, bm, bk), accumulate=True)
        return dense.permute(0, 2, 1, 3).reshape(
            self.n_brows * bm, self.n_bcols * bk)[:rows, :cols]


def dense_to_bsr(w, block_shape: Tuple[int, int], pad_to: int = 1) -> BSR:
    """Dense (rows, cols) -> BSR with fixed (bm, bk) blocks (CPU tensors).
    rows and cols are zero-padded up to block multiples; a block is live
    iff any entry is nonzero. ``pad_to`` rounds ``max_bw`` up."""
    w = np.asarray(w)
    rows, cols = w.shape
    bm, bk = block_shape
    R, C = -(-rows // bm) * bm, -(-cols // bk) * bk
    wp = np.zeros((R, C), w.dtype)
    wp[:rows, :cols] = w
    n_brows, n_bcols = R // bm, C // bk
    blocked = wp.reshape(n_brows, bm, n_bcols, bk).transpose(0, 2, 1, 3)
    live = (blocked != 0).any(axis=(2, 3))  # [n_brows, n_bcols]
    brow_nnz = live.sum(axis=1).astype(np.int32)
    max_bw = max(1, int(brow_nnz.max()) if n_brows else 1)
    max_bw = -(-max_bw // pad_to) * pad_to
    blocks = np.zeros((n_brows, max_bw, bm, bk), w.dtype)
    block_col = np.zeros((n_brows, max_bw), np.int32)
    br, bc = np.nonzero(live)
    within = np.arange(len(br)) - np.repeat(np.cumsum(brow_nnz) - brow_nnz,
                                            brow_nnz)
    blocks[br, within] = blocked[br, bc]
    block_col[br, within] = bc
    n_flat = max(1, len(br))
    flat_blocks = np.zeros((n_flat, bm, bk), w.dtype)
    flat_row = np.zeros(n_flat, np.int32)
    flat_col = np.zeros(n_flat, np.int32)
    flat_blocks[:len(br)] = blocked[br, bc]
    flat_row[:len(br)] = br
    flat_col[:len(br)] = bc
    return BSR(blocks=torch.from_numpy(blocks),
               block_col=torch.from_numpy(block_col),
               brow_nnz=torch.from_numpy(brow_nnz),
               flat_blocks=torch.from_numpy(flat_blocks),
               flat_row=torch.from_numpy(flat_row),
               flat_col=torch.from_numpy(flat_col),
               shape=(rows, cols), block_shape=(bm, bk),
               brow_nnz_np=brow_nnz)
