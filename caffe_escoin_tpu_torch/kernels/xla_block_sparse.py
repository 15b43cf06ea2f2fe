"""Static block-sparse convolution and SpMM as torch ops: the XBSP arms.

Port of ``caffe_escoin_tpu/kernels/xla_block_sparse.py``. The module keeps
that name so that a reader finds the counterpart; it holds no XLA and no
hand-written kernel. Each arm is plain PyTorch (``F.pad``, slicing,
``torch.cat``, matrix products, which are cuBLAS on the card) over the
weight's sparsity pattern, read on the host (``BSC.pattern``):

* ``conv`` (the unroll): one product per live (kernel offset, cin-block,
  cout-block) weight block, summed per output block-column::

      out[..., j] = sum over live (off, cb) of column j of
          x_pad[:, khi:khi+Ho, kwi:kwi+Wo, cb*bk:(cb+1)*bk] @ W[j, s]

* ``conv_gathered``: one GEMM over the union of live K-blocks (the im2col
  restricted to live blocks) against the union-packed weight;
* ``conv_gathered_cols``: one GEMM per block-column over its own live
  K-blocks;
* ``spmm``: the fc twin of the unroll, x[M, K] @ BSC[K, N].

``ops/conv.best_arm`` picks one per layer (the heuristic, or
engine/autotune.py's measurement), as the JAX dispatcher does.

Numerics are those of ``preferred_element_type=float32``: products
accumulate in f32 across blocks (on the card bf16 operands multiply on the
tensor cores with an f32 result, ``torch.mm(..., out_dtype=torch.float32)``;
on the CPU they are widened to f32 first, which is exact), bias and residual
are added in f32, then ReLU and one cast to x's dtype.

Host work: what an arm derives from the weight (the live lists, the
union-packed weight, the per-column weights) is built once per weight
object and dtype and kept in ``BSC.memo``, so a forward reads the pattern
from host copies and copies no weight to the device. Within one call each
distinct shifted slab is made contiguous once (XLA's common-subexpression
elimination does this in the JAX package). Spatial padding pads x once;
``CESCOIN_XBSP_NOPAD=1`` switches to the pad-free valid-slice form
(``_nopad_slab``), read per call as the JAX module reads it.

Autograd: with grad enabled and an operand that requires it (the
per-layer backward of utils/timing.py), the arms stay differentiable:
products are formed out of place on f32 operands (autograd takes neither
``out_dtype`` nor ``out=``), and what derives from payloads that require
grad is built per call instead of memoised (a kept tensor would carry one
call's graph into the next). Under ``inference_mode`` nothing changes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.sparse.formats import BSC
from caffe_escoin_tpu_torch.sparse.weight_align import AlignedConvWeight


def supported(aligned: AlignedConvWeight, policy) -> bool:
    """The XBSP arms take any aligned weight with a BSC under
    ``use_xla_sparse`` (its pattern is always on the host here)."""
    return aligned.bsc is not None and getattr(policy, "use_xla_sparse", True)


def spmm_supported(bsc: Optional[BSC], policy=None) -> bool:
    if bsc is None:
        return False
    return policy is None or getattr(policy, "use_xla_sparse", True)


def _live_slots(bsc: BSC) -> List[List[int]]:
    """K-block index of each live slot, per block-column."""
    got = bsc.memo.get("slots")
    if got is None:
        block_row, bcol_nnz = bsc.pattern()
        got = bsc.memo["slots"] = [
            [int(block_row[j, s]) for s in range(int(bcol_nnz[j]))]
            for j in range(block_row.shape[0])]
    return got


def _union(bsc: BSC) -> List[int]:
    """Sorted union of the live K-blocks over all block-columns."""
    got = bsc.memo.get("union")
    if got is None:
        got = bsc.memo["union"] = sorted(
            {kb for col in _live_slots(bsc) for kb in col})
    return got


def union_live_fraction(aligned: AlignedConvWeight) -> float:
    """Fraction of K-blocks live in at least one output block-column: the
    gathered arm's read volume relative to dense."""
    return len(_union(aligned.bsc)) / max(1, aligned.bsc.n_brows)


def _unit_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its rows are unit-stride, else a contiguous copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _mm(a: torch.Tensor, b: torch.Tensor,
        acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a @ b with an f32 result, added in place into the f32 ``acc`` when
    one is given. bf16 operands multiply with f32 accumulation: on the card
    through cuBLAS's ``out_dtype``; on the CPU (which has no kernel for
    it) widened to f32, which is exact. The ``out_dtype`` products get
    operands whose rows are unit-stride: the card's torch returns wrong
    sums for some other layouts (``tests/test_torch_cuda.py`` holds each
    layout the arms pass, and the ones they must not)."""
    if a.dtype != torch.float32:
        if a.is_cuda and not _recording(a, b, acc):
            a, b = _unit_rows(a), _unit_rows(b)
            if acc is None:
                return torch.mm(a, b, out_dtype=torch.float32)
            return torch.addmm(acc, a, b, out_dtype=torch.float32, out=acc)
        a, b = a.float(), b.float()
    return torch.mm(a, b) if acc is None else acc.addmm_(a, b)


def _recording(*ts) -> bool:
    """Autograd records this call: grad is enabled and a tensor of ``ts``
    requires it."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _memo(bsc: BSC, key, build):
    """``build()``, kept in ``bsc.memo[key]`` and reused, unless autograd
    records the payloads (then built per call)."""
    if _recording(bsc.blocks):
        return build()
    got = bsc.memo.get(key)
    if got is None:
        got = bsc.memo[key] = build()
    return got


def _blocks(bsc: BSC, dtype: torch.dtype) -> torch.Tensor:
    """The payloads in ``dtype``, cast once per weight object."""
    if bsc.blocks.dtype == dtype:
        return bsc.blocks
    return _memo(bsc, ("blocks", dtype), lambda: bsc.blocks.to(dtype))


def _finish(acc: torch.Tensor, aligned: AlignedConvWeight, lead, relu,
            residual, dtype) -> torch.Tensor:
    """f32 acc [M, >= cout] -> bias, residual (f32), ReLU, one cast:
    [*lead, cout] contiguous in ``dtype``. ``acc`` is the arm's own
    buffer and is updated in place."""
    cout = aligned.cout
    out = acc[:, :cout]
    if aligned.bias is not None:
        out.add_(aligned.bias.to(device=out.device, dtype=torch.float32))
    if residual is not None:
        out.add_(residual.reshape(-1, cout))
    if relu:
        out.relu_()
    return out.to(dtype, memory_format=torch.contiguous_format).reshape(
        *lead, cout)


def _geometry(x, aligned: AlignedConvWeight, stride, padding, dilation):
    kh, kw = aligned.kernel_shape
    n, h, w, _ = x.shape
    ho = (h + 2 * padding[0] - (dilation[0] * (kh - 1) + 1)) // stride[0] + 1
    wo = (w + 2 * padding[1] - (dilation[1] * (kw - 1) + 1)) // stride[1] + 1
    return n, ho, wo


def _nopad_slab(x, khi, kwi, ph, pw, sh, sw, ho, wo, cb, bk, c):
    """Shifted slab without a padded copy of x: the valid interior of the
    unpadded x, and the zero padding its product needs around it.

    Returns (slab or None, ((top, bottom), (left, right))); None when the
    offset reads only halo (its contribution is zero). The JAX package
    measured the padded form faster on its TPU and kept this one behind
    ``CESCOIN_XBSP_NOPAD=1``; the port keeps the same switch."""
    _, h, w, _ = x.shape
    # output index j reads input row r = khi - ph + sh*j; valid 0 <= r < h
    j0 = max(0, -(-(ph - khi) // sh))
    j1 = min(ho - 1, (h - 1 - khi + ph) // sh)
    i0 = max(0, -(-(pw - kwi) // sw))
    i1 = min(wo - 1, (w - 1 - kwi + pw) // sw)
    if j0 > j1 or i0 > i1:
        return None, ((0, ho), (0, wo))
    r0 = khi - ph + sh * j0
    c0 = kwi - pw + sw * i0
    a = x[:, r0:r0 + sh * (j1 - j0) + 1:sh,
          c0:c0 + sw * (i1 - i0) + 1:sw,
          cb * bk:min((cb + 1) * bk, c)]
    return a, ((j0, ho - 1 - j1), (i0, wo - 1 - i1))


class _Slabs:
    """The shifted input slabs of one call, each made once: the slice of x
    (padded once up front, or through ``_nopad_slab``) that K-block ``kb``
    reads, for the output positions of the conv."""

    def __init__(self, x, aligned: AlignedConvWeight, stride, padding,
                 dilation):
        self.x = x
        self.kernel = aligned.kernel_shape
        self.bk = aligned.bsc.block_shape[0]
        self.n_cin_b = aligned.cin_pad // self.bk
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.n, self.ho, self.wo = _geometry(x, aligned, stride, padding,
                                             dilation)
        self.nopad = bool(os.environ.get("CESCOIN_XBSP_NOPAD"))
        ph, pw = padding
        self.xp = x
        if (ph or pw) and not self.nopad:
            self.xp = F.pad(x, (0, 0, pw, pw, ph, ph))
        self._raw: Dict[int, Tuple] = {}
        self._full: Dict[int, torch.Tensor] = {}

    def raw(self, kb):
        """(slab [n, h', w', width] or None, output pad) for K-block kb:
        width < bk on a channel tail; h', w' < Ho, Wo in the pad-free
        form, whose product takes the pad."""
        got = self._raw.get(kb)
        if got is None:
            off, cb = kb // self.n_cin_b, kb % self.n_cin_b
            kw = self.kernel[1]
            khi = (off // kw) * self.dilation[0]
            kwi = (off % kw) * self.dilation[1]
            (ph, pw), (sh, sw) = self.padding, self.stride
            c, bk, ho, wo = self.x.shape[-1], self.bk, self.ho, self.wo
            if self.nopad:
                got = _nopad_slab(self.x, khi, kwi, ph, pw, sh, sw, ho, wo,
                                  cb, bk, c)
            else:
                got = (self.xp[:, khi:khi + sh * (ho - 1) + 1:sh,
                               kwi:kwi + sw * (wo - 1) + 1:sw,
                               cb * bk:min((cb + 1) * bk, c)],
                       ((0, 0), (0, 0)))
            self._raw[kb] = got
        return got

    def full(self, kb) -> torch.Tensor:
        """The slab at the output's full size and bk channels (zero halo
        and zero channel tail): [n, Ho, Wo, bk]."""
        got = self._full.get(kb)
        if got is None:
            a, ((t, b), (l, r)) = self.raw(kb)
            if a is None:
                got = self.x.new_zeros((self.n, self.ho, self.wo, self.bk))
            else:
                tail = self.bk - a.shape[-1]
                if tail or t or b or l or r:
                    a = F.pad(a, (0, tail, l, r, t, b))
                got = a
            self._full[kb] = got
        return got


def _rows(a: torch.Tensor) -> torch.Tensor:
    """[n, h, w, c] -> [n*h*w, c]; copies only a view that cannot merge."""
    return a.reshape(-1, a.shape[-1])


def conv(x, aligned: AlignedConvWeight, *, stride=(1, 1), padding=(0, 0),
         dilation=(1, 1), relu=False, residual=None):
    """Block-sparse conv by the per-block unroll. x: [N,H,W,Cin] (f32 or
    bf16) -> [N,Ho,Wo,Cout] in x's dtype; any kernel size, stride and
    dilation. ``residual`` [N,Ho,Wo,Cout] is added in f32 before the ReLU
    (a fused Eltwise sum, nn/fuse.py pass B)."""
    bsc = aligned.bsc
    bk, bn = bsc.block_shape
    slabs = _Slabs(x, aligned, tuple(stride), tuple(padding), tuple(dilation))
    n, ho, wo = slabs.n, slabs.ho, slabs.wo
    m = n * ho * wo
    wblocks = _blocks(bsc, x.dtype)
    rows: Dict[int, torch.Tensor] = {}
    cols = []
    for j, col in enumerate(_live_slots(bsc)):
        acc = None
        for s, kb in enumerate(col):
            a, ((t, b), (l, r)) = slabs.raw(kb)
            if a is None:
                continue
            a2 = rows.get(kb)
            if a2 is None:
                a2 = rows[kb] = _rows(a)
            blk = wblocks[j, s]
            if a.shape[-1] < bk:  # channel tail (cin_pad > cin)
                blk = blk[:a.shape[-1]]
            if t or b or l or r:  # pad-free form: pad the product
                d = _mm(a2, blk).reshape(*a.shape[:3], bn)
                d = _rows(F.pad(d, (0, 0, l, r, t, b)))
                acc = d if acc is None else acc.add_(d)
            else:
                acc = _mm(a2, blk, acc)
        if acc is None:
            acc = x.new_zeros((m, bn), dtype=torch.float32)
        cols.append(acc)
    acc = torch.cat(cols, dim=1) if len(cols) > 1 else cols[0]
    return _finish(acc, aligned, (n, ho, wo), relu, residual, x.dtype)


def _union_weight(bsc: BSC, dtype: torch.dtype) -> torch.Tensor:
    """The union-packed weight [U*bk, n_bcols*bn]: row block u holds
    K-block ``_union(bsc)[u]`` in every column where it is live, zeros
    elsewhere. Built once per weight object and dtype, on its device."""
    def build():
        bk, bn = bsc.block_shape
        union = _union(bsc)
        upos = {kb: u for u, kb in enumerate(union)}
        slots = [(upos[kb], j, s) for j, col in enumerate(_live_slots(bsc))
                 for s, kb in enumerate(col)]
        w = bsc.blocks.new_zeros((len(union), bk, bsc.n_bcols, bn))
        if slots:
            u, j, s = (torch.tensor(v, device=w.device) for v in zip(*slots))
            w[u, :, j, :] = bsc.blocks[j, s]
        return w.reshape(len(union) * bk, bsc.n_bcols * bn).to(dtype)

    return _memo(bsc, ("union_weight", dtype), build)


def conv_gathered(x, aligned: AlignedConvWeight, *, stride=(1, 1),
                  padding=(0, 0), dilation=(1, 1), relu=False,
                  residual=None):
    """Block-sparse conv as one dense GEMM over the gathered live K-blocks:
    concatenate the shifted slabs of the union of live (kernel offset,
    cin-block) K-blocks over all block-columns and multiply once by the
    union-packed weight (zero rows where a block is dead in a column). The
    output is written once; the price is the zeros inside the union."""
    bsc = aligned.bsc
    kh, kw = aligned.kernel_shape
    slabs = _Slabs(x, aligned, tuple(stride), tuple(padding), tuple(dilation))
    n, ho, wo = slabs.n, slabs.ho, slabs.wo
    union = _union(bsc)
    if not union:
        acc = x.new_zeros((n * ho * wo, aligned.cout), dtype=torch.float32)
        return _finish(acc, aligned, (n, ho, wo), relu, residual, x.dtype)
    ph, pw = padding
    sh, sw = stride
    # a 1x1 conv whose union is every cin-block reads x itself: no gather
    if (kh == kw == 1 and union == list(range(slabs.n_cin_b))
            and x.shape[-1] == aligned.cin_pad
            and not (slabs.nopad and (ph or pw))):
        xg = slabs.xp[:, ::sh, ::sw, :]
    else:
        parts = [slabs.full(kb) for kb in union]
        xg = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    acc = _mm(_rows(xg), _union_weight(bsc, x.dtype))
    return _finish(acc, aligned, (n, ho, wo), relu, residual, x.dtype)


def _column_weights(bsc: BSC, dtype: torch.dtype) -> List[torch.Tensor]:
    """Per block-column, its live payloads stacked [s_j*bk, bn] (views of
    the payloads)."""
    def build():
        bk, bn = bsc.block_shape
        wblocks = _blocks(bsc, dtype)
        return [wblocks[j, :len(col)].reshape(len(col) * bk, bn)
                for j, col in enumerate(_live_slots(bsc))]

    return _memo(bsc, ("column_weights", dtype), build)


def conv_gathered_cols(x, aligned: AlignedConvWeight, *, stride=(1, 1),
                       padding=(0, 0), dilation=(1, 1), relu=False,
                       residual=None):
    """Per-column gathered GEMM: for each output block-column, concatenate
    only that column's live K-block slabs and run one product
    [M, s_j*bk] x [s_j*bk, bn]. Between the unroll (one product per live
    block) and the single union GEMM (zeros where columns share few
    K-blocks). A slab that several columns read is made once."""
    bsc = aligned.bsc
    bn = bsc.block_shape[1]
    slabs = _Slabs(x, aligned, tuple(stride), tuple(padding), tuple(dilation))
    n, ho, wo = slabs.n, slabs.ho, slabs.wo
    m = n * ho * wo
    cols = []
    for col, wcol in zip(_live_slots(bsc), _column_weights(bsc, x.dtype)):
        if not col:
            cols.append(x.new_zeros((m, bn), dtype=torch.float32))
            continue
        parts = [slabs.full(kb) for kb in col]
        ag = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        cols.append(_mm(_rows(ag), wcol))
    acc = torch.cat(cols, dim=1) if len(cols) > 1 else cols[0]
    return _finish(acc, aligned, (n, ho, wo), relu, residual, x.dtype)


def spmm(x, bsc: BSC, *, bias=None, relu=False):
    """x[M, K] @ BSC[K, N] -> [M, N] in x's dtype by the block unroll: one
    product per live (K-block, N-block), f32 accumulation, bias and ReLU in
    f32, one cast. x may carry K or the K padded to whole blocks (the
    payloads' edge rows are zero)."""
    bk, bn = bsc.block_shape
    m, k = x.shape
    wblocks = _blocks(bsc, x.dtype)
    cols = []
    for j, col in enumerate(_live_slots(bsc)):
        acc = None
        for s, kb in enumerate(col):
            a = x[:, kb * bk:min((kb + 1) * bk, k)]
            blk = wblocks[j, s]
            if a.shape[-1] < bk:  # K tail (x not padded to n_brows*bk)
                blk = blk[:a.shape[-1]]
            acc = _mm(a, blk, acc)
        if acc is None:
            acc = x.new_zeros((m, bn), dtype=torch.float32)
        cols.append(acc)
    out = (torch.cat(cols, dim=1) if len(cols) > 1 else cols[0])[
        :, :bsc.shape[1]]
    if bias is not None:
        out.add_(bias.to(device=out.device, dtype=torch.float32))
    if relu:
        out.relu_()
    return out.to(x.dtype, memory_format=torch.contiguous_format)
