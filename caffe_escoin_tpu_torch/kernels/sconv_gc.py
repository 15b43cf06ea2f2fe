"""Garbage-column direct sparse convolution.

Port of the Pallas kernel ``caffe_escoin_tpu/kernels/sconv_pallas.py``
(``sconv``, the v2 direct conv) as the CUDA kernel ``csrc/sconv_gc.cu``.
The input is zero-padded to Hp x Wp and its H x W flattened into a slab;
the output is computed over Ho x Wp rows, of which the Wp - Wo "garbage"
columns of each row are sliced away afterwards. So each live K-block
(kh, kw, cin-block) reads one contiguous range of slab rows starting at
``m + kh * Wp + kw``: a row shift and a column offset, no spatial masks.
Bias and ReLU ride the kernel's epilogue; a residual is added by the
caller (``ops/conv.py``), as in the JAX route.

The plain version builds the slab ``[N, L, cin_pad]`` (L = Hp * Wp + Kw - 1
rows per image) and slices the garbage columns off its output with torch
ops (``_slab``, ``_crop``). The kernel route builds its slab, in the
multiply type, in one write (``_kernel_slab``: one ``F.pad`` with one extra
zero image row, which covers the Kw - 1 rows the last output row reads
past Hp * Wp), and the kernel's epilogue writes the exact output itself,
skipping the garbage columns: no crop copy. The TPU kernel's channel-block-major slab transpose
is dropped: it exists only for Mosaic's lane-slicing rule. Here a K-block
is a column offset ``cb * bk`` into rows of stride ``cin_pad``.
The kernel multiplies in the resolved ``mxu_dtype`` as the JAX kernel does:
bf16 ("auto" on the card), or f32 as three TF32 products per multiply,
which keep f32 accuracy (``cet_sconv_gc_f32``; ``csrc/sconv_pipe.cuh``).
``launch_plan`` is the kernel's tile size, ring depth and shared memory
for a shape and multiply type (``kernels/sconv_pipe.py``); its tiles never
cross an image.

``sconv`` runs the kernel for a CUDA tensor and the plain version for a
CPU tensor. ``calls`` counts entry calls on any device; ``launches``
counts kernel launches only, ``launches_f32`` those that multiplied in f32.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.engine.context import resolve_mxu_dtype
from caffe_escoin_tpu_torch.kernels import _build, sconv_pipe
from caffe_escoin_tpu_torch.sparse.weight_align import AlignedConvWeight

calls = 0
launches = 0
launches_f32 = 0

_IO_DTYPES = (torch.float32, torch.bfloat16)

# The reference's routing rule (caffe_escoin_tpu/kernels/sconv_pallas.py:48),
# carried over so that each layer takes the same kernel on both sides. It is
# the TPU kernel's VMEM residency, not a memory size of the card.
SLAB_BUDGET = 6 * 1024 * 1024


def reset_counts() -> None:
    global calls, launches, launches_f32
    calls = 0
    launches = 0
    launches_f32 = 0


def supported(x: torch.Tensor, aligned: AlignedConvWeight) -> bool:
    """The kernel's own limits (stride 1 and dilation 1 are the caller's):
    every K-block inside one kernel offset (cin_pad % bk == 0), the input
    carrying exactly ``cin`` channels, and a block width the epilogue tiles
    (bn % 8 == 0, bn <= 128)."""
    if aligned.bsc is None or x.dim() != 4:
        return False
    bk, bn = aligned.bsc.block_shape
    return (x.shape[-1] == aligned.cin and aligned.cin_pad % bk == 0
            and bn % 8 == 0 and bn <= 128)


def fits_budget(x, aligned: AlignedConvWeight) -> bool:
    """The gate of the reference's ``supported``
    (caffe_escoin_tpu/kernels/sconv_pallas.py:52-66): the padded slab, with
    pad = kernel - 1 as its upper bound, counted at x's itemsize (the
    activation after any compute-dtype cast), within ``SLAB_BUDGET``. ``x``
    needs only ``shape`` and ``dtype``."""
    kh, kw = aligned.kernel_shape
    _, h, w, _ = x.shape
    hp, wp = h + kh - 1, w + kw - 1
    slab = (hp * wp + wp) * aligned.cin_pad * x.dtype.itemsize
    return slab <= SLAB_BUDGET


def _geometry(x_shape, kernel_shape,
              padding) -> Tuple[int, int, int, int, int]:
    """(hp, wp, ho, wo, L) of the slab and the garbage-column output."""
    kh, kw = kernel_shape
    hp, wp = x_shape[1] + 2 * padding[0], x_shape[2] + 2 * padding[1]
    # the last output row m = Ho*Wp - 1 reads up to row Hp*Wp + Kw - 2
    return hp, wp, hp - kh + 1, wp - kw + 1, hp * wp + kw - 1


def _slab(x, aligned, padding, g):
    """x [N,H,W,Cin] zero-padded to Hp x Wp and cin_pad channels, H x W
    flattened, Kw - 1 zero rows appended: [N, L, cin_pad] in x's dtype."""
    n, h, w, c = x.shape
    hp, wp, _, _, length = g
    ph, pw = padding
    slab = x.new_zeros((n, length, aligned.cin_pad))
    slab[:, :hp * wp].view(n, hp, wp, aligned.cin_pad)[
        :, ph:ph + h, pw:pw + w, :c] = x
    return slab


def _crop(flat, aligned, g):
    """[N, Ho*Wp, Cout] -> [N, Ho, Wo, Cout]: drop the garbage columns."""
    _, wp, ho, wo, _ = g
    return flat.view(flat.shape[0], ho, wp, aligned.cout)[:, :, :wo, :
                                                          ].contiguous()


def _kernel_slab(xk, padding, cin_pad):
    """The kernel's slab in one write: ``xk`` (in the multiply type, from
    ``sconv_pipe.kernel_operands``) zero-padded to Hp + 1 rows, Wp columns
    and ``cin_pad`` channels, H x W flattened: [N, (Hp + 1) * Wp, cin_pad].
    Its first Hp * Wp + Kw - 1 rows are ``_slab``'s; the extra image row
    (Wp >= Kw - 1 rows) holds the zero tail rows."""
    ph, pw = padding
    slab = F.pad(xk, (0, cin_pad - xk.shape[-1], pw, pw, ph, ph + 1))
    return slab.flatten(1, 2)


def _plan(x_shape, kernel_shape, padding, block_shape, n_bcols, max_bw,
          mul) -> sconv_pipe.LaunchPlan:
    _, wp, ho, _, _ = _geometry(x_shape, kernel_shape, padding)
    return sconv_pipe.plan(x_shape[0], ho * wp, block_shape, n_bcols, max_bw,
                           mul)


def launch_plan(x_shape, aligned: AlignedConvWeight, padding,
                mul: str = "bfloat16") -> sconv_pipe.LaunchPlan:
    """The kernel's launch plan for an input of ``x_shape`` multiplied in
    ``mul`` (the resolved ``mxu_dtype``): its tiles run over the Ho * Wp
    garbage-column rows of one image each. ``_c_dims`` passes the kernel
    this plan."""
    bsc = aligned.bsc
    return _plan(tuple(x_shape), aligned.kernel_shape, tuple(padding),
                 bsc.block_shape, bsc.n_bcols, bsc.max_bw, mul)


def _dims(x_shape, slab_shape, bk, aligned: AlignedConvWeight, padding,
          relu: bool, bf16_io: bool, mul: str = "bfloat16"):
    """The kernel's integer arguments, as ``sconv`` passes them: x of
    ``x_shape`` handed over as a slab of ``slab_shape`` in K-blocks ``bk``
    deep, in ``mul`` (``_kernel_slab``)."""
    bsc = aligned.bsc
    return _c_dims(tuple(x_shape), tuple(slab_shape), tuple(padding),
                   aligned.kernel_shape, aligned.cout,
                   aligned.cin_pad // bsc.block_shape[0], bk,
                   bsc.block_shape, bsc.n_bcols, bsc.max_bw, int(relu),
                   int(bf16_io), mul)


@functools.lru_cache(maxsize=4096)
def _c_dims(x_shape, slab_shape, padding, kernel_shape, cout, n_cin_b, bk,
            block_shape, n_bcols, max_bw, relu, bf16_io, mul):
    """The kernel's integer arguments for one layer shape, ``launch_plan``'s
    plan included, in the order ``cet_sconv_gc`` (and ``_f32``) reads them;
    built once, since eager dispatch asks again on every forward."""
    n, length, cin_pad = slab_shape
    _, wp, ho, wo, _ = _geometry(x_shape, kernel_shape, padding)
    p = _plan(x_shape, kernel_shape, padding, block_shape, n_bcols, max_bw,
              mul)
    return _build.c_ints(n, length, cin_pad, ho, wo, wp, cout,
                         kernel_shape[1], n_cin_b, bk, block_shape[1],
                         n_bcols, max_bw, relu, bf16_io, p.tile_m, p.stages,
                         p.chunk, p.smem)


def _flat_plain(slab, aligned, g, relu, mxu_dtype, out_dtype):
    """What the kernel computes, in plain PyTorch: for each kernel offset the
    shifted slab rows times that offset's rows of the dense GEMM-view weight
    rebuilt from the BSC, f32 sums (f64 for an f64 slab), then bias and
    ReLU in that type."""
    kh, kw = aligned.kernel_shape
    _, wp, ho, _, _ = g
    ct = torch.promote_types(slab.dtype, torch.float32)
    w = aligned.bsc.to_dense().to(ct).reshape(kh, kw, aligned.cin_pad,
                                              aligned.cout)
    a = slab.to(ct)
    if mxu_dtype == "bfloat16":
        a, w = a.bfloat16().to(ct), w.bfloat16().to(ct)
    m = ho * wp
    out = torch.zeros((slab.shape[0], m, aligned.cout), dtype=ct,
                      device=slab.device)
    for khi in range(kh):
        for kwi in range(kw):
            shift = khi * wp + kwi
            out += a[:, shift:shift + m, :] @ w[khi, kwi]
    if aligned.bias is not None:
        out = out + aligned.bias.to(ct)
    if relu:
        out = torch.relu(out)
    return out.to(out_dtype)


def sconv_plain(x: torch.Tensor, aligned: AlignedConvWeight, *, padding,
                relu: bool, mxu_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version over the same slab and output slice as the
    kernel, in f32 (f64 for an f64 ``x``). With ``mxu_dtype="bfloat16"``
    the slab and the weight are rounded to bf16 first, as the kernel
    multiplies them."""
    padding = tuple(padding)
    g = _geometry(x.shape, aligned.kernel_shape, padding)
    flat = _flat_plain(_slab(x, aligned, padding, g), aligned, g, relu,
                       mxu_dtype, x.dtype)
    return _crop(flat, aligned, g)


def sconv(x: torch.Tensor, aligned: AlignedConvWeight, *, padding, relu: bool,
          mxu_dtype: str = "auto") -> torch.Tensor:
    """x [N,H,W,Cin] (f32 or bf16) -> [N,Ho,Wo,Cout] in x's dtype; stride 1,
    dilation 1 (callers route with ``supported`` and ``fits_budget``).
    Multiplied in ``mxu_dtype`` ("auto": bf16 on the card, f32 on the
    CPU); a shape or type the kernel does not take raises, in either."""
    global calls, launches, launches_f32
    calls += 1
    padding = tuple(padding)
    mxu = resolve_mxu_dtype(mxu_dtype, x.device)
    if x.device.type == "cpu":
        return sconv_plain(x, aligned, padding=padding, relu=relu,
                           mxu_dtype=mxu)
    if x.device.type != "cuda":
        raise ValueError(f"sconv_gc: unsupported device {x.device}")
    if not supported(x, aligned):
        raise ValueError("sconv_gc kernel does not take this shape "
                         "(see sconv_gc.supported)")
    if x.dtype not in _IO_DTYPES:
        raise TypeError(f"x has dtype {x.dtype}, expected one of {_IO_DTYPES}")
    bsc = aligned.bsc
    n = x.shape[0]
    _, _, ho, wo, _ = _geometry(x.shape, aligned.kernel_shape, padding)
    dev = x.device
    f32 = mxu == "float32"
    op = (torch.float32 if f32 else torch.bfloat16,)
    xk, blocks, bk = sconv_pipe.kernel_operands(x, aligned, mxu)
    n_cin_b = aligned.cin_pad // bsc.block_shape[0]
    slab = _kernel_slab(xk, padding, n_cin_b * bk)
    _build.check_operand(slab, "slab", dev, op)
    _build.check_operand(blocks, "bsc.blocks", dev, op)
    _build.check_operand(bsc.block_row, "bsc.block_row", dev, (torch.int32,))
    _build.check_operand(bsc.bcol_nnz, "bsc.bcol_nnz", dev, (torch.int32,))
    bias = aligned.bias
    if bias is not None:
        if bias.dtype != torch.float32:
            bias = bias.float()
        _build.check_operand(bias, "bias", dev, (torch.float32,))
    out = x.new_empty((n, ho, wo, aligned.cout))
    dims = _dims(x.shape, slab.shape, bk, aligned, padding, relu,
                 x.dtype == torch.bfloat16, mxu)
    lib = _build.load()
    entry = lib.cet_sconv_gc_f32 if f32 else lib.cet_sconv_gc
    rc = entry(
        slab.data_ptr(), blocks.data_ptr(), bsc.block_row.data_ptr(),
        bsc.bcol_nnz.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), dims, _build.stream_of(x))
    _build.check(rc, "cet_sconv_gc_f32" if f32 else "cet_sconv_gc")
    launches += 1
    launches_f32 += int(f32)
    return out
