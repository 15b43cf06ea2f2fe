"""Weight alignment: the per-layer dense -> sparse compile pass (port of
``caffe_escoin_tpu/sparse/weight_align.py``).

From a conv weight W[KH,KW,Cin/g,Cout] it builds:

* the GEMM view Wmat[KH*KW*cin_pad, Cout] (rows ordered kh, kw, cin, as
  im2col's columns) and its BSC with a per-layer (bk, bn) block shape.
  ``bk`` divides ``cin_pad``, so every K-block decodes to one (kernel
  offset, cin-block) pair;
* with ``sparse_format=ELL`` (or ``with_ell=True``), an ELL of Wmat^T,
  whose rows are the output channels (the reference's CSR orientation),
  for the unstructured path;
* ``SparsityStats``: sparsity, nnz, block density, nnz per kernel offset
  and per output channel.

The rules are the JAX package's, unchanged, so both packages build
identical arrays. ``split_payloads`` is not ported: it passes payloads as
jit arguments, and eager torch (or a CUDA graph of it) holds the tensors as
they are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from caffe_escoin_tpu_torch.engine.context import (ExecutionPolicy,
                                                   SparseFormat)
from caffe_escoin_tpu_torch.sparse.formats import (BSC, ELL, dense_to_bsc,
                                                   dense_to_ell)


def choose_cin_blocking(cin: int, target: int) -> Tuple[int, int]:
    """(bk, cin_pad): the K-block depth and the padded channel count. A
    channel count up to ``target`` is one block (padded to a multiple of 8);
    a larger one is cut into 128-deep blocks (or ``target``-deep when the
    target is below 128)."""
    if cin <= target:
        cin_pad = -(-cin // 8) * 8
        return cin_pad, cin_pad
    bk = 128 if target >= 128 else target
    cin_pad = -(-cin // bk) * bk
    return bk, cin_pad


def gemm_view(w_hwio, groups: int = 1, cin_pad: Optional[int] = None
              ) -> np.ndarray:
    """[KH,KW,Cin/g,Cout] -> block-diagonal [KH*KW*cin_pad, Cout], channels
    zero-padded to ``cin_pad`` so K-blocks never straddle kernel offsets."""
    w = np.asarray(w_hwio)
    kh, kw, cin_g, cout = w.shape
    cin = cin_g * groups
    if cin_pad is None:
        cin_pad = cin
    full = np.zeros((kh, kw, cin_pad, cout), w.dtype)
    if groups == 1:
        full[:, :, :cin, :] = w
    else:
        cout_g = cout // groups
        for g in range(groups):
            full[:, :, g * cin_g:(g + 1) * cin_g,
                 g * cout_g:(g + 1) * cout_g] = w[..., g * cout_g:(g + 1) * cout_g]
    return full.reshape(kh * kw * cin_pad, cout)


@dataclasses.dataclass(frozen=True)
class SparsityStats:
    """The reference's WeightAlign sparsity report."""

    sparsity: float
    nnz: int
    block_density: float
    nnz_per_offset: Tuple[int, ...]  # kernel-position histogram
    nnz_per_out_channel: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class AlignedConvWeight:
    """Execution-ready representations of one conv (or fc) layer's weight.

    ``bias`` is kept in float32 by ``to``: the sparse kernels add it in
    their f32 epilogue.
    """

    dense: torch.Tensor  # [KH,KW,Cin/g,Cout] as loaded
    bias: Optional[torch.Tensor]  # [Cout] or None
    bsc: Optional[BSC]  # GEMM-view block-sparse (None below threshold)
    ell_t: Optional[ELL]  # Wmat^T row-sparse (the unstructured path)
    kernel_shape: Tuple[int, int]
    cin: int  # full Cin (groups expanded)
    cin_pad: int  # channel dim padded for blocking
    cout: int
    groups: int = 1
    sparsity: float = 0.0
    block_density: float = 1.0
    stats: Optional[SparsityStats] = None

    @property
    def k(self) -> int:
        """GEMM K with channel padding (the BSC's row count)."""
        return self.kernel_shape[0] * self.kernel_shape[1] * self.cin_pad

    def to(self, device=None, dtype=None) -> "AlignedConvWeight":
        """Move to ``device``; ``dtype`` casts the weight payloads (dense,
        BSC blocks, ELL values) and leaves the bias in float32."""
        return dataclasses.replace(
            self,
            dense=self.dense.to(device=device, dtype=dtype),
            bias=None if self.bias is None else self.bias.to(
                device=device, dtype=torch.float32),
            bsc=None if self.bsc is None else self.bsc.to(device, dtype),
            ell_t=None if self.ell_t is None else self.ell_t.to(device,
                                                                dtype))


def weight_align(w_hwio, bias=None, *, groups: int = 1,
                 policy: Optional[ExecutionPolicy] = None,
                 with_stats: bool = True,
                 with_ell: Optional[bool] = None) -> AlignedConvWeight:
    """Build the aligned sparse representations of one conv layer. Runs on
    the host; the result holds CPU tensors (move it with ``.to``).

    The ELL of Wmat^T is built only where the BSC is, and only when the
    policy runs it (``sparse_format == ELL``) or ``with_ell=True``: for
    fc-scale matrices it is a large host-memory cost the block path never
    reads."""
    policy = policy or ExecutionPolicy()
    w = torch.as_tensor(w_hwio).detach().cpu().numpy()
    kh, kw, cin_g, cout = w.shape
    cin = cin_g * groups
    bk_target, bn_target = policy.block_shape
    bk, cin_pad = choose_cin_blocking(cin, bk_target)
    # adaptive output-block width: a 64-channel layer with bn=128 would write
    # (and zero-pad) twice the output traffic
    bn = min(bn_target, -(-cout // 8) * 8)
    wmat = gemm_view(w, groups, cin_pad)
    # sparsity of the stored weight, not of the padded/expanded GEMM view
    sparsity = 1.0 - (int((w != 0).sum()) / max(1, w.size))
    if with_ell is None:
        with_ell = policy.sparse_format == SparseFormat.ELL
    bsc = ell_t = stats = None
    if sparsity >= min(policy.sparse_threshold, policy.sconv_threshold):
        bsc = dense_to_bsc(wmat, (bk, bn))
        if with_ell:
            ell_t = dense_to_ell(wmat.T, lane_pad=8)
    block_density = bsc.block_density if bsc is not None else 1.0
    if with_stats:
        live = wmat != 0
        stats = SparsityStats(
            sparsity=sparsity, nnz=int(live.sum()),
            block_density=block_density,
            nnz_per_offset=tuple(int(v) for v in live.reshape(
                kh * kw, cin_pad, cout).sum(axis=(1, 2))),
            nnz_per_out_channel=tuple(int(v) for v in live.sum(axis=0)))
    if bias is not None:
        bias = torch.as_tensor(bias).detach().to("cpu", torch.float32)
    return AlignedConvWeight(
        dense=torch.tensor(w),
        bias=bias,
        bsc=bsc,
        ell_t=ell_t,
        kernel_shape=(kh, kw),
        cin=cin,
        cin_pad=cin_pad,
        cout=cout,
        groups=groups,
        sparsity=sparsity,
        block_density=block_density,
        stats=stats,
    )
