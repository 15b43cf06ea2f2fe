"""A dense conv's bias, residual and ReLU over its NHWC output.

The CUDA kernel ``csrc/conv_epilogue.cu`` applies them in one pass: one read
of the conv's output (and of the residual) and one write
(``cet_conv_epilogue`` for bf16 maps, ``cet_conv_epilogue_f32`` for f32
ones). It is a hand kernel of an op that the JAX package leaves to XLA,
which fuses the bias and ReLU into the conv (``conv2d_dense`` in
``caffe_escoin_tpu/ops/conv.py``), not a port of a Pallas kernel. Its plain
version ``epilogue_plain`` is what PyTorch ran on the card after cuDNN: the
broadcast add of the bias (ATen's ``F.conv2d`` adds it after cuDNN), the
residual add and ``torch.relu``, each a pass of its own; the two agree bit
for bit.

``conv_epilogue`` runs the kernel where ``takes_kernel``: a CUDA tensor
with no autograd graph to record. It writes over a contiguous output in
place; a strided one is read through its strides into a new contiguous map.
Elsewhere (the CPU, a meta tensor, a training forward) it runs the plain
version. ``launch_args`` is its launch for a shape. ``calls`` counts entry
calls on any device; ``launches`` counts kernel launches only,
``launches_f32`` those over f32 maps.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from caffe_escoin_tpu_torch.kernels import _build

calls = 0
launches = 0
launches_f32 = 0

_IO_DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256
_MAX_VECTORS = 2 ** 31 - 1 - THREADS  # what csrc/conv_epilogue.cu indexes


def reset_counts() -> None:
    global calls, launches, launches_f32
    calls = 0
    launches = 0
    launches_f32 = 0


def epilogue_plain(y: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                   relu: bool = False,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: ``y`` [..., C] plus ``bias`` [C], plus
    ``residual``, then ReLU, each in y's dtype, contiguous. A two-operand
    bf16 add rounds once, so each add equals adding in f32 and casting, as
    the kernel and the fused conv kernel's epilogue do. ``ops/conv`` runs
    it after every conv route that applies no residual or ReLU itself."""
    if bias is not None:
        y = y + bias.to(y.dtype)
    if residual is not None:
        y = y + residual.to(y.dtype)
    if relu:
        y = torch.relu(y)
    return y.contiguous()


def takes_kernel(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether ``conv_epilogue`` launches the kernel for these operands (the
    first one given decides the device): on CUDA, with no autograd graph to
    record (grad off, or no operand requires it)."""
    given = [t for t in tensors if t is not None]
    return given[0].device.type == "cuda" and not (
        torch.is_grad_enabled() and any(t.requires_grad for t in given))


class Launch(NamedTuple):
    """The kernel's launch for one map: ``dims``, its integer arguments in
    the order ``cet_conv_epilogue`` reads them, and what they hold."""
    dims: object
    lanes: int     # elements of a thread's vector
    threads: int   # a block's
    blocks: int
    strided: bool  # read through the strides into a new map


@functools.lru_cache(maxsize=1024)
def launch_args(shape, dtype, strides, aligned, relu):
    """The launch for a map of ``shape`` ([N, H, W, C]) and ``dtype``,
    contiguous (``strides`` None: written in place) or with ``strides``
    (elements): the 16-byte vector where its lanes divide C, every pointer
    is ``aligned`` to 16 bytes and the strides keep a pixel's channels
    together at multiples of it, else one element a thread; one thread a
    vector, in the fewest blocks of ``THREADS`` that cover the map. Raises
    on what the kernel does not take. Built once per shape, since eager
    dispatch asks again on every forward."""
    if dtype not in _IO_DTYPES:
        raise TypeError(f"conv_epilogue kernel: dtype {dtype}, expected one "
                        f"of {_IO_DTYPES}")
    if len(shape) != 4 or min(shape) < 1:
        raise ValueError(f"conv_epilogue kernel: a non-empty NHWC map, got "
                         f"shape {shape}")
    n, h, w, c = shape
    wide = 16 // (torch.finfo(dtype).bits // 8)
    vector = c % wide == 0 and aligned and (
        strides is None
        or (strides[3] == 1 and all(s % wide == 0 for s in strides[:3])))
    lanes = wide if vector else 1
    total = n * h * w * c // lanes
    if total > _MAX_VECTORS or (strides is not None and (
            min(strides) < 0 or max(strides) > 2 ** 31 - 1)):
        raise ValueError(f"conv_epilogue kernel: shape {shape}, strides "
                         f"{strides}")
    blocks = -(-total // THREADS)
    dims = _build.c_ints(n, h, w, c, *(strides or (h * w * c, w * c, c, 1)),
                         lanes, THREADS, blocks, int(relu),
                         int(strides is not None))
    return Launch(dims, lanes, THREADS, blocks, strides is not None)


def _kernel(y, bias, relu, residual):
    """One launch of the kernel over CUDA tensor ``y``; none where there is
    nothing to do or nothing to read."""
    global launches, launches_f32
    if y.dtype not in _IO_DTYPES:
        raise TypeError(f"conv_epilogue kernel: dtype {y.dtype}, expected "
                        f"one of {_IO_DTYPES}")
    if y.dim() != 4:
        raise ValueError(f"conv_epilogue kernel: an NHWC map, got shape "
                         f"{tuple(y.shape)}")
    if bias is not None:
        if tuple(bias.shape) != (y.shape[3],):
            raise ValueError(f"conv_epilogue kernel: bias {tuple(bias.shape)}"
                             f" for {y.shape[3]} channels")
        bias = bias.to(device=y.device, dtype=y.dtype).contiguous()
    if residual is not None:
        if residual.shape != y.shape:
            raise ValueError(f"conv_epilogue kernel: residual "
                             f"{tuple(residual.shape)} for a map "
                             f"{tuple(y.shape)}")
        residual = residual.to(device=y.device, dtype=y.dtype).contiguous()
    if y.numel() == 0 or (bias is None and residual is None and not relu):
        return y.contiguous()
    in_place = y.is_contiguous()
    out = y if in_place else torch.empty(y.shape, dtype=y.dtype,
                                         device=y.device)
    ptrs = [t.data_ptr() for t in (y, out, bias, residual) if t is not None]
    la = launch_args(tuple(y.shape), y.dtype,
                     None if in_place else tuple(y.stride()),
                     all(p % 16 == 0 for p in ptrs), bool(relu))
    f32 = y.dtype == torch.float32
    lib = _build.load()
    entry = lib.cet_conv_epilogue_f32 if f32 else lib.cet_conv_epilogue
    rc = entry(y.data_ptr(), None if bias is None else bias.data_ptr(),
               None if residual is None else residual.data_ptr(),
               out.data_ptr(), la.dims, _build.stream_of(y))
    _build.check(rc, "cet_conv_epilogue_f32" if f32 else "cet_conv_epilogue")
    launches += 1
    launches_f32 += int(f32)
    return out


def conv_epilogue(y: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                  relu: bool = False,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y`` [N, H, W, C], a conv's output without the ``bias`` given here,
    plus the bias, plus ``residual``, then ReLU; contiguous NHWC. The kernel
    where ``takes_kernel`` (over ``y`` in place where it is contiguous: pass
    the conv's own output), the plain version elsewhere."""
    global calls
    calls += 1
    if not takes_kernel(y, bias, residual):
        return epilogue_plain(y, bias, relu=relu, residual=residual)
    return _kernel(y, bias, relu, residual)
