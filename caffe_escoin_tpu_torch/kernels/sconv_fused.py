"""Direct block-sparse convolution on native NHWC.

Port of the Pallas fused-slab kernel ``caffe_escoin_tpu/kernels/sconv_fused.py``
(``sconv``) as the CUDA kernel ``csrc/sconv_fused.cu``. It reads what that
kernel computes, not its slab machinery: output tiles gather their shifted
input rows with masked loads, so there is no padded copy of the input, and
the residual add of a fused bottleneck (nn/fuse.py pass B) rides the
kernel's epilogue with the bias and ReLU.

Numerics: the epilogue runs in f32: acc + bias + residual, ReLU, then one
cast to the output dtype. The JAX package instead adds the residual after
the conv output is cast to bf16, and casts the folded bias to bf16 with the
other params (its ``ops/conv.py:283-286,321-323``, ``nn/layers.py:152-161``);
the port keeps the bias in f32. The plain version follows the kernel.

The kernel multiplies in the resolved ``mxu_dtype``, as the JAX kernel
does: "bfloat16" (``auto`` on the card) through bf16 tensor-core products,
or "float32" through three TF32 products per multiply, which keep f32
accuracy (``csrc/sconv_pipe.cuh``; the C entry ``cet_sconv_fused_f32``).
It copies its operands with ``cp.async``, which does not convert:
``sconv`` hands it x and the weight blocks in that type with 16-byte
aligned rows and K-blocks (``sconv_pipe.kernel_operands``).
``launch_plan`` is the kernel's tile size, ring depth and shared memory
for a shape and multiply type (``kernels/sconv_pipe.py``).

``sconv`` runs the kernel for a CUDA tensor and ``sconv_plain`` for a CPU
tensor. ``calls`` counts entry calls on any device; ``launches`` counts
kernel launches only, ``launches_f32`` those that multiplied in f32.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.engine.context import resolve_mxu_dtype
from caffe_escoin_tpu_torch.kernels import _build, sconv_pipe
from caffe_escoin_tpu_torch.sparse.weight_align import AlignedConvWeight

calls = 0
launches = 0
launches_f32 = 0

_IO_DTYPES = (torch.float32, torch.bfloat16)


def reset_counts() -> None:
    global calls, launches, launches_f32
    calls = 0
    launches = 0
    launches_f32 = 0


def supported(x: torch.Tensor, aligned: AlignedConvWeight, *,
              stride=(1, 1), dilation=(1, 1)) -> bool:
    """The kernel's own limits: stride 1, dilation 1, every K-block inside
    one kernel offset (cin_pad % bk == 0), the input carrying exactly
    ``cin`` channels, and a block width the epilogue tiles (bn % 8 == 0,
    bn <= 128). No memory budget: tiles stream through shared memory
    (``fits_budget`` is the routing rule, not a limit of this kernel)."""
    if aligned.bsc is None or x.dim() != 4:
        return False
    bk, bn = aligned.bsc.block_shape
    return (tuple(stride) == (1, 1) and tuple(dilation) == (1, 1)
            and x.shape[-1] == aligned.cin and aligned.cin_pad % bk == 0
            and bn % 8 == 0 and bn <= 128)


# The reference's routing rule (caffe_escoin_tpu/kernels/sconv_fused.py:56-57,
# 60-124), carried over so that each layer takes the same kernel on both
# sides. These are the TPU kernel's VMEM sizes, not a memory size of the
# card: this kernel has no such limit. An H100 router chosen by measurement
# is the autotune port's work.
VMEM_BUDGET = 10 * 1024 * 1024  # slab + acc + weights + out tile
W_BUDGET = 4 * 1024 * 1024


def _pack(n, hp, wp):
    """Images per grid step of the TPU kernel (must divide the batch)."""
    p = min(max(1, 512 // (hp * wp)), n)
    while n % p != 0:
        p -= 1
    return p


def _pick_tile_rows(w, pw):
    return max(1, 512 // (-(-(w + pw) // 8) * 8))


def _sizes(x_shape, kernel_shape, padding, block_shape, tile_rows):
    """The TPU kernel's slab geometry (its ``_sizes``, the keys the budget
    reads)."""
    n, h, w, c = x_shape
    kh, kw = kernel_shape
    ph, pw = padding
    hp, wp = h + 2 * ph, w + 2 * pw
    wp_s = -(-(w + pw) // 8) * 8
    pimg = _pack(n, hp, wp_s)
    q = max(1, min(tile_rows, pimg * hp))
    n_tiles = -(-(pimg * hp) // q)
    slab_len = -(-((1 + n_tiles * q + kh - 1) * wp_s + kw) // 8) * 8
    return dict(wp=wp, ho=hp - kh + 1, wo=wp - kw + 1, q=q,
                slab_len=slab_len, pimg=pimg)


@functools.lru_cache(maxsize=4096)
def _budget_total(x_shape, itemsize, kernel_shape, padding, block_shape,
                  cin_pad, n_bcols, max_bw):
    """Bytes the TPU kernel holds in VMEM (its ``supported``, integers
    only; cached because every forward asks it again per layer)."""
    _, h, w, c = x_shape
    bk, bn = block_shape
    z = _sizes(x_shape, kernel_shape, padding, block_shape,
               _pick_tile_rows(w, padding[1]))
    slab = (cin_pad // bk) * z["slab_len"] * bk * 4
    wmem = n_bcols * max_bw * bk * bn * 2
    out_tile = z["pimg"] * z["ho"] * z["wo"] * n_bcols * bn * itemsize
    ximg = z["pimg"] * h * w * c * itemsize
    acc = z["q"] * z["wp"] * bn * 4
    return slab + min(wmem, W_BUDGET) + 2 * out_tile + 2 * ximg + 2 * acc


def fits_budget(x, aligned: AlignedConvWeight, padding) -> bool:
    """The budget test of the reference's ``supported``
    (caffe_escoin_tpu/kernels/sconv_fused.py:100-118): slab + weights +
    double-buffered x/out + accumulator within ``VMEM_BUDGET``, counted at
    x's itemsize (the activation after any compute-dtype cast) and at the
    aligned BSC's ``max_bw``. ``x`` needs only ``shape`` and ``dtype``."""
    bsc = aligned.bsc
    return _budget_total(tuple(x.shape), x.dtype.itemsize,
                         aligned.kernel_shape, tuple(padding),
                         bsc.block_shape, aligned.cin_pad, bsc.n_bcols,
                         bsc.max_bw) <= VMEM_BUDGET


def _out_hw(x_shape, kernel_shape, padding) -> Tuple[int, int]:
    kh, kw = kernel_shape
    return (x_shape[1] + 2 * padding[0] - kh + 1,
            x_shape[2] + 2 * padding[1] - kw + 1)


def _plan(x_shape, kernel_shape, padding, block_shape, n_bcols, max_bw,
          mul) -> sconv_pipe.LaunchPlan:
    ho, wo = _out_hw(x_shape, kernel_shape, padding)
    return sconv_pipe.plan(1, x_shape[0] * ho * wo, block_shape, n_bcols,
                           max_bw, mul)


def launch_plan(x_shape, aligned: AlignedConvWeight, padding,
                mul: str = "bfloat16") -> sconv_pipe.LaunchPlan:
    """The kernel's launch plan for an input of ``x_shape`` multiplied in
    ``mul`` (the resolved ``mxu_dtype``): its tiles run over the
    N * Ho * Wo output rows of the whole batch. ``_c_dims`` passes the
    kernel this plan."""
    bsc = aligned.bsc
    return _plan(tuple(x_shape), aligned.kernel_shape, tuple(padding),
                 bsc.block_shape, bsc.n_bcols, bsc.max_bw, mul)


def _dims(x_shape, cin_k, bk, aligned: AlignedConvWeight, padding,
          relu: bool, bf16_io: bool, mul: str = "bfloat16"):
    """The kernel's integer arguments, as ``sconv`` passes them: x of
    ``x_shape`` handed over with ``cin_k`` channels in K-blocks ``bk``
    deep, in ``mul`` (``sconv_pipe.kernel_operands``)."""
    bsc = aligned.bsc
    return _c_dims(tuple(x_shape), cin_k, tuple(padding),
                   aligned.kernel_shape, aligned.cout,
                   aligned.cin_pad // bsc.block_shape[0], bk,
                   bsc.block_shape, bsc.n_bcols, bsc.max_bw, int(relu),
                   int(bf16_io), mul)


@functools.lru_cache(maxsize=4096)
def _c_dims(x_shape, cin_k, padding, kernel_shape, cout, n_cin_b, bk,
            block_shape, n_bcols, max_bw, relu, bf16_io, mul):
    """The kernel's integer arguments for one layer shape, ``launch_plan``'s
    plan included, in the order ``cet_sconv_fused`` (and ``_f32``) reads
    them; built once, since eager dispatch asks again on every forward."""
    n, h, w, _ = x_shape
    ho, wo = _out_hw(x_shape, kernel_shape, padding)
    p = _plan(x_shape, kernel_shape, padding, block_shape, n_bcols, max_bw,
              mul)
    return _build.c_ints(
        n, h, w, cin_k, ho, wo, cout, kernel_shape[1], padding[0],
        padding[1], n_cin_b, bk, block_shape[1], n_bcols, max_bw, relu,
        bf16_io, p.tile_m, p.stages, p.chunk, p.smem)


def sconv_plain(x: torch.Tensor, aligned: AlignedConvWeight, *, padding,
                relu: bool, residual: Optional[torch.Tensor] = None,
                mxu_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version: rebuild the dense HWIO weight from the BSC,
    run ``F.conv2d`` in f32 (in f64 for an f64 ``x``), then the kernel's
    epilogue in that type. With ``mxu_dtype="bfloat16"`` input and weight
    are rounded to bf16 first, as the kernel multiplies them."""
    kh, kw = aligned.kernel_shape
    ct = torch.promote_types(x.dtype, torch.float32)
    w = aligned.bsc.to_dense().to(ct).reshape(
        kh, kw, aligned.cin_pad, aligned.cout)[:, :, :aligned.cin, :]
    xf = x.to(ct)
    if mxu_dtype == "bfloat16":
        xf, w = xf.bfloat16().to(ct), w.bfloat16().to(ct)
    out = F.conv2d(xf.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   padding=tuple(padding)).permute(0, 2, 3, 1)
    if aligned.bias is not None:
        out = out + aligned.bias.to(ct)
    if residual is not None:
        out = out + residual.to(ct)
    if relu:
        out = torch.relu(out)
    return out.to(x.dtype).contiguous()


def sconv(x: torch.Tensor, aligned: AlignedConvWeight, *, padding, relu: bool,
          residual: Optional[torch.Tensor] = None,
          mxu_dtype: str = "auto") -> torch.Tensor:
    """x [N,H,W,Cin] (f32 or bf16) -> [N,Ho,Wo,Cout] in x's dtype; stride 1,
    dilation 1 (callers gate with ``supported``). ``residual``: optional
    [N,Ho,Wo,Cout] added before the ReLU. Multiplied in ``mxu_dtype``
    ("auto": bf16 on the card, f32 on the CPU); a shape or type the kernel
    does not take raises, in either."""
    global calls, launches, launches_f32
    calls += 1
    padding = tuple(padding)
    mxu = resolve_mxu_dtype(mxu_dtype, x.device)
    if x.device.type == "cpu":
        return sconv_plain(x, aligned, padding=padding, relu=relu,
                           residual=residual, mxu_dtype=mxu)
    if x.device.type != "cuda":
        raise ValueError(f"sconv: unsupported device {x.device}")
    if not supported(x, aligned):
        raise ValueError("sconv kernel does not take this shape "
                         "(see sconv_fused.supported)")
    if x.dtype not in _IO_DTYPES:
        raise TypeError(f"x has dtype {x.dtype}, expected one of {_IO_DTYPES}")
    bsc = aligned.bsc
    n, h, w, _ = x.shape
    ho, wo = _out_hw(x.shape, aligned.kernel_shape, padding)
    dev = x.device
    f32 = mxu == "float32"
    op = (torch.float32 if f32 else torch.bfloat16,)
    xk, blocks, bk = sconv_pipe.kernel_operands(x, aligned, mxu)
    _build.check_operand(xk, "x", dev, op)
    _build.check_operand(blocks, "bsc.blocks", dev, op)
    _build.check_operand(bsc.block_row, "bsc.block_row", dev, (torch.int32,))
    _build.check_operand(bsc.bcol_nnz, "bsc.bcol_nnz", dev, (torch.int32,))
    bias = aligned.bias
    if bias is not None:
        if bias.dtype != torch.float32:
            bias = bias.float()
        _build.check_operand(bias, "bias", dev, (torch.float32,))
    if residual is not None:
        _build.check_operand(residual, "residual", dev, (x.dtype,))
        if residual.shape != (n, ho, wo, aligned.cout):
            raise ValueError(f"residual shape {tuple(residual.shape)} != "
                             f"{(n, ho, wo, aligned.cout)}")
    out = x.new_empty((n, ho, wo, aligned.cout))
    dims = _dims(x.shape, xk.shape[-1], bk, aligned, padding, relu,
                 x.dtype == torch.bfloat16, mxu)
    lib = _build.load()
    entry = lib.cet_sconv_fused_f32 if f32 else lib.cet_sconv_fused
    rc = entry(
        xk.data_ptr(), blocks.data_ptr(), bsc.block_row.data_ptr(),
        bsc.bcol_nnz.data_ptr(), None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        dims, _build.stream_of(x))
    _build.check(rc, "cet_sconv_fused_f32" if f32 else "cet_sconv_fused")
    launches += 1
    launches_f32 += int(f32)
    return out
