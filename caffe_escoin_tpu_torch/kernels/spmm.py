"""Sparse x dense products for the unstructured and block-row formats (port
of ``caffe_escoin_tpu/kernels/spmm.py``: ``ell_spmm``, ``bsr_spmm`` and the
``spmm`` dispatch).

They are jnp gathers and scans in the JAX package, not Pallas kernels, so
here they are torch ops on the operands' device (``index_select`` and
batched products, cuBLAS on the card); no hand-written kernel runs. The
plain BSC SpMM stays with its kernel (kernels/bsc_spmm.py).

Numerics are those of ``preferred_element_type=float32``: products
accumulate in f32. On the card bf16 operands multiply with an f32 result
(``out_dtype``); on the CPU, which has no kernel for that, they are widened
to f32 first, which is exact.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.sparse.formats import BSR, ELL

# Bytes of gathered rows one step of ell_spmm holds. A slot gathers one
# [rows, N] operand: one launch per slot would mean over 500 launches for a
# res5 3x3 conv of ResNet-50 at b32 pruned element-wise to 90% (its ELL
# width), and all slots at once would hold width x rows x N elements (0.9 GB
# in bf16 at res2's 3x3). 256 MB takes every conv of that net in 1-4 steps.
GATHER_BYTES = 256 * 1024 * 1024


def _bmm_f32(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor) -> None:
    """acc += a @ b (batched) in f32. Operands of two dtypes are widened to
    f32; the out_dtype product gets contiguous operands (see
    xla_block_sparse._mm on the layouts the card's torch gets wrong)."""
    if a.dtype != b.dtype:
        a, b = a.float(), b.float()
    if a.dtype != torch.float32:
        if a.is_cuda:
            torch.baddbmm(acc, a.contiguous(), b.contiguous(),
                          out_dtype=torch.float32, out=acc)
            return
        a, b = a.float(), b.float()
    acc.baddbmm_(a, b)


def ell_spmm(ell: ELL, b: torch.Tensor) -> torch.Tensor:
    """out[r, n] = sum_j ell.values[r, j] * b[ell.colidx[r, j], n], in f32.

    ell: (R, K) sparse; b: (K, N) dense -> (R, N) float32. Padding slots
    hold value 0, so they add nothing. The slots are walked in steps of at
    most ``GATHER_BYTES`` of gathered rows of ``b``: one ``index_select``
    and one batched product per step."""
    rows, k = ell.shape
    if b.shape[0] != k:
        raise ValueError(f"b rows {b.shape[0]} != sparse K {k}")
    b = b.contiguous()  # gathered rows are read whole
    n, width = b.shape[1], ell.width
    step = max(1, min(width, GATHER_BYTES // max(1, rows * n
                                                  * b.element_size())))
    acc = torch.zeros((rows, 1, n), dtype=torch.float32, device=b.device)
    for j in range(0, width, step):
        cols = ell.colidx[:, j:j + step]
        gathered = b.index_select(0, cols.reshape(-1)).view(
            rows, cols.shape[1], n)
        _bmm_f32(ell.values[:, None, j:j + step], gathered, acc)
    return acc.view(rows, n)


def bsr_spmm(bsr: BSR, b: torch.Tensor) -> torch.Tensor:
    """Block-sparse (R, K) BSR @ (K, N) dense -> (R, N) float32. ``b`` has
    the logical height K; it is zero-padded to the block multiple here. One
    gather and one batched product per block slot."""
    bm, bk = bsr.block_shape
    rows, k = bsr.shape
    if b.shape[0] != k:
        raise ValueError(f"b rows {b.shape[0]} != sparse K {k}")
    n = b.shape[1]
    kp = bsr.n_bcols * bk
    if k != kp:
        b = F.pad(b, (0, 0, 0, kp - k))
    bblocks = b.reshape(bsr.n_bcols, bk, n)
    acc = torch.zeros((bsr.n_brows, bm, n), dtype=torch.float32,
                      device=b.device)
    for s in range(bsr.max_bw):
        _bmm_f32(bsr.blocks[:, s],
                 bblocks.index_select(0, bsr.block_col[:, s]), acc)
    return acc.reshape(bsr.n_brows * bm, n)[:rows]


def spmm(sparse, b: torch.Tensor) -> torch.Tensor:
    """Dispatch on the sparse operand's format."""
    if isinstance(sparse, ELL):
        return ell_spmm(sparse, b)
    if isinstance(sparse, BSR):
        return bsr_spmm(sparse, b)
    raise TypeError(f"unsupported sparse operand {type(sparse)!r}")
