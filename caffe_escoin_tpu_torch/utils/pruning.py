"""Weight pruning (port of ``caffe_escoin_tpu/utils/pruning.py``, whole).

Numpy only and bit-identical to the JAX package's functions: magnitude
pruning element-wise, and block pruning by Frobenius norm that produces the
structured sparsity the block-sparse kernels turn into skipped work; and the
training side: the AGP (automated gradual pruning) schedule and the masks
that ``engine/solver.Solver`` pins pruned weights with. The masks are
computed from tensors on any device (copied to the host).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np


def prune_magnitude(w, sparsity: float):
    """Zero out the smallest-|w| fraction ``sparsity`` of entries."""
    w = np.asarray(w).copy()
    if sparsity <= 0:
        return w
    k = int(round(w.size * sparsity))
    if k >= w.size:
        return np.zeros_like(w)
    if k == 0:
        return w
    thresh = np.partition(np.abs(w).ravel(), k - 1)[k - 1]
    w[np.abs(w) <= thresh] = 0
    return w


def prune_blocks(w, sparsity: float, block_shape: Tuple[int, int]):
    """Zero out the lowest-norm fraction ``sparsity`` of (bm, bk) blocks of a
    2-D matrix (partial edge blocks are zero-padded for the ranking)."""
    w = np.asarray(w).copy()
    rows, cols = w.shape
    bm, bk = block_shape
    R, C = -(-rows // bm) * bm, -(-cols // bk) * bk
    wp = np.zeros((R, C), w.dtype)
    wp[:rows, :cols] = w
    nbr, nbc = R // bm, C // bk
    blocked = wp.reshape(nbr, bm, nbc, bk).transpose(0, 2, 1, 3)
    norms = np.sqrt((blocked.astype(np.float64) ** 2).sum(axis=(2, 3)))
    n_blocks = nbr * nbc
    k = int(round(n_blocks * sparsity))
    if k > 0:
        if k >= n_blocks:
            blocked[:] = 0
        else:
            thresh = np.partition(norms.ravel(), k - 1)[k - 1]
            blocked[norms <= thresh] = 0
    return blocked.transpose(0, 2, 1, 3).reshape(R, C)[:rows, :cols]


def prune_conv_weight(w_hwio, sparsity: float, block_shape=None):
    """Prune a conv weight [KH,KW,Cin,Cout]. With ``block_shape`` the weight
    is pruned block-wise in its per-offset (Cin, Cout) GEMM views, blocks
    ranked globally across all kernel offsets, and at least one block is
    kept. Otherwise element-wise magnitude."""
    w = np.asarray(w_hwio)
    if block_shape is None:
        return prune_magnitude(w, sparsity)
    kh, kw, cin, cout = w.shape
    bm, bk = block_shape
    R, C = -(-cin // bm) * bm, -(-cout // bk) * bk
    nbr, nbc = R // bm, C // bk
    wp = np.zeros((kh * kw, R, C), w.dtype)
    wp[:, :cin, :cout] = w.reshape(kh * kw, cin, cout)
    blocked = wp.reshape(kh * kw, nbr, bm, nbc, bk).transpose(0, 1, 3, 2, 4)
    norms = np.sqrt((blocked.astype(np.float64) ** 2).sum(axis=(3, 4)))
    n_blocks = norms.size
    k = min(int(round(n_blocks * sparsity)), n_blocks - 1) if sparsity < 1 \
        else n_blocks
    if k > 0:
        if k >= n_blocks:
            blocked[:] = 0
        else:
            thresh = np.partition(norms.ravel(), k - 1)[k - 1]
            blocked[norms <= thresh] = 0
    out = blocked.transpose(0, 1, 3, 2, 4).reshape(kh * kw, R, C)[:, :cin, :cout]
    return out.reshape(kh, kw, cin, cout)


def sparsity_of(w) -> float:
    return float((_host(w) == 0).mean())


def densify_blocks(w, block_shape: Tuple[int, int], min_density: float):
    """Turn an unstructured-sparse matrix into a block-executable one by
    zeroing the blocks whose element density is below ``min_density``.
    Returns (w_densified, stats) with the extra-zeroed weight fraction and
    the resulting block density."""
    w = _host(w).copy()
    rows, cols = w.shape
    bm, bk = block_shape
    R, C = -(-rows // bm) * bm, -(-cols // bk) * bk
    wp = np.zeros((R, C), w.dtype)
    wp[:rows, :cols] = w
    blocked = wp.reshape(R // bm, bm, C // bk, bk).transpose(0, 2, 1, 3)
    dens = (blocked != 0).mean(axis=(2, 3))
    nnz_before = int((w != 0).sum())
    kill = dens < min_density
    blocked[kill] = 0
    out = blocked.transpose(0, 2, 1, 3).reshape(R, C)[:rows, :cols]
    nnz_after = int((out != 0).sum())
    stats = dict(
        nnz_before=nnz_before,
        nnz_after=nnz_after,
        extra_zeroed_frac=round(
            (nnz_before - nnz_after) / max(1, nnz_before), 4),
        block_density=round(float((~kill).mean()), 4),
    )
    return out, stats


def agp_sparsity(it: int, *, start_iter: int, end_iter: int,
                 final_sparsity: float, initial_sparsity: float = 0.0,
                 freq: int = 100) -> float:
    """Automated-Gradual-Pruning target sparsity at iteration ``it`` (Zhu &
    Gupta 2017's cubic ramp): from ``initial_sparsity`` at ``start_iter``
    to ``final_sparsity`` at ``end_iter``, updated every ``freq``
    iterations (constant between updates)."""
    if it < start_iter:
        return float(initial_sparsity)
    if it >= end_iter:
        return float(final_sparsity)
    t = ((it - start_iter) // max(1, freq)) * max(1, freq)
    frac = t / max(1, end_iter - start_iter)
    return float(final_sparsity + (initial_sparsity - final_sparsity)
                 * (1.0 - frac) ** 3)


@dataclasses.dataclass(frozen=True)
class PruningSchedule:
    """In-training gradual pruning (``Solver.set_pruning_schedule``).

    ``granularity`` "block" prunes ``block_shape`` tiles of each weight's
    GEMM view (a conv's per-offset (Cin, Cout) planes ranked globally, as
    ``prune_conv_weight``); "element" prunes by |w|. Masks are recomputed
    from the current weights every ``freq`` iterations inside [start_iter,
    end_iter]; the final mask is frozen after end_iter."""
    final_sparsity: float
    start_iter: int
    end_iter: int
    freq: int = 100
    initial_sparsity: float = 0.0
    granularity: str = "block"  # "block" | "element"
    block_shape: Tuple[int, int] = (128, 128)


def default_prune_select(name: str, key: str, leaf) -> bool:
    """Which leaves a schedule prunes by default: the weight blobs of fc
    layers (2-D) and of convs (4-D) whose kh*kw*cin is at least 32. That
    is the JAX package's rule exactly: it prunes a 3-channel stem of 7x7
    or 11x11 (147 or 363), though the JAX docstring says the stem stays
    dense; a caller that keeps the stem dense passes ``select=``."""
    if key != "w":
        return False
    shp = tuple(np.shape(leaf))
    if len(shp) == 4:
        return int(np.prod(shp[:3])) >= 32
    return len(shp) == 2


def gradual_masks(params, sparsity: float, *, granularity: str = "block",
                  block_shape: Tuple[int, int] = (128, 128),
                  select: Optional[Callable] = None):
    """0/1 float32 numpy masks congruent with ``params`` (ones on the leaves
    ``select`` leaves out), pruning the lowest-magnitude (element) or
    lowest-norm (block) fraction ``sparsity`` of each selected weight as it
    is now."""
    select = select or default_prune_select

    def leaf_mask(name, key, leaf):
        w = _host(leaf)
        if not select(name, key, w) or sparsity <= 0:
            return np.ones(w.shape, np.float32)
        if granularity == "element":
            pruned = prune_magnitude(w, sparsity)
        elif w.ndim == 4:
            pruned = prune_conv_weight(w, sparsity, block_shape)
        else:
            pruned = prune_blocks(w, sparsity, block_shape)
        return (pruned != 0).astype(np.float32)

    out = {}
    for name, node in params.items():
        if isinstance(node, dict):
            out[name] = {k: leaf_mask(name, k, v) for k, v in node.items()}
        else:
            out[name] = np.ones(np.shape(node), np.float32)
    return out


def masks_of(params, keys=("w",)):
    """0/1 masks for ``Solver.set_param_masks``: the nonzero pattern of
    every leaf whose dict key is in ``keys`` (the pruned weights), all ones
    elsewhere (a zero-initialized bias must stay free to move)."""
    def rec(node, masked):
        if isinstance(node, dict):
            return {k: rec(v, masked or k in keys) for k, v in node.items()}
        if masked:
            return (_host(node) != 0).astype(np.float32)
        return np.ones(np.shape(node), np.float32)

    return rec(params, False)


def _host(w) -> np.ndarray:
    """``w`` as a numpy array (a tensor on any device is copied to the
    host)."""
    if hasattr(w, "detach"):
        return w.detach().cpu().numpy()
    return np.asarray(w)
