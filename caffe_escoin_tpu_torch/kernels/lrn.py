"""Caffe's LRN across channels (ACROSS_CHANNELS) over an NHWC map.

The CUDA kernel ``csrc/lrn.cu`` computes it in one pass: one read and one
write of the map (``cet_lrn`` for bf16 maps, ``cet_lrn_f32`` for f32 ones).
It is a hand kernel of an op that the JAX package leaves to XLA
(``caffe_escoin_tpu/ops/norm.py``), not a port of a Pallas kernel. Its plain
version ``lrn_plain`` is the chain of torch ops that ``ops/norm.py`` ran
before, about fifteen passes over the map on the card: the window summed
from shifted channel slices in f32, lane masks for ``groups > 1``.

``lrn`` runs the kernel for a CUDA tensor and the plain version for a CPU
tensor. On CUDA it is a ``torch.autograd.Function`` whose backward is the
plain version's gradient (the plain forward recomputed under grad), so a net
with LRN trains on the card with the numbers it had. The kernel takes
bf16 and f32 maps, any C, ``groups`` and beta, and ``local_size`` up to
``MAX_LOCAL_SIZE`` (5: Caffe's default, and every LRN of the model zoo);
``launch_args`` is its launch for a shape. ``calls``
counts entry calls on any device; ``launches`` counts kernel launches only,
``launches_f32`` those over f32 maps.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.kernels import _build

calls = 0
launches = 0
launches_f32 = 0

_IO_DTYPES = (torch.float32, torch.bfloat16)
# csrc/lrn.cu's reach (kMaxHalf) and shared memory per block
MAX_LOCAL_SIZE = 5
_MAX_SMEM = 48 * 1024
# a block's tile: whole pixels, at most this many bytes, and smaller where
# that leaves fewer than this many tiles per SM (batch-8 maps)
TILE_BYTES = 16 * 1024
TILES_PER_SM = 8


def reset_counts() -> None:
    global calls, launches, launches_f32
    calls = 0
    launches = 0
    launches_f32 = 0


@functools.lru_cache(maxsize=256)
def _lrn_mask(c: int, groups: int, d: int, device: torch.device
              ) -> torch.Tensor:
    """1 where lane l's window term at offset ``d`` stays inside its group
    (lane l holds group l // cg, logical channel l % cg), else 0. Built once
    per (c, groups, d, device): a tensor built inside a forward would break
    CUDA-graph capture. Built outside inference mode, so that a mask first
    built by an inference forward also serves a gradient."""
    with torch.inference_mode(False):
        lane_c = torch.arange(c) % (c // groups)
        return ((lane_c + d >= 0) & (lane_c + d < c // groups)).float().to(
            device)


def lrn_plain(x, *, local_size=5, alpha=1e-4, beta=0.75, k=1.0,
              groups: int = 1):
    """Plain PyTorch version, as the JAX function: in f32, cast back to x's
    dtype at the end; the windowed sum built from shifted channel slices,
    added in the same order; for beta = 0.75, s^-0.75 as r * sqrt(r) with
    r = rsqrt(s). ``groups=r`` normalizes r independent channel blocks that
    share the channel axis, with a lane mask on each shifted slice so that
    no window crosses a block."""
    half = local_size // 2
    xf = x.float()
    sq = xf * xf
    padded = F.pad(sq, (half, local_size - 1 - half))
    c = x.shape[-1]
    window = None
    for i in range(local_size):
        term = padded[..., i:i + c]
        if groups > 1:
            term = term * _lrn_mask(c, groups, i - half, x.device)
        window = term if window is None else window + term
    s = k + (alpha / local_size) * window
    if beta == 0.75:
        r = torch.rsqrt(s)
        scale = r * torch.sqrt(r)  # s^-0.75
    else:
        scale = torch.pow(s, -beta)
    return (xf * scale).to(x.dtype)


def tile_elems(pixels: int, c: int, itemsize: int, sms: int) -> int:
    """Elements of a block's tile: whole pixels, a multiple of the kernel's
    16-byte vector, at most ``TILE_BYTES`` and small enough that the map
    makes ``TILES_PER_SM`` tiles per SM of ``sms`` (or one pixel group
    whose bytes are a whole number of vectors, if larger)."""
    vec = 16 // itemsize
    step = vec // math.gcd(c, vec)  # pixels per tile come in multiples of it
    rows = min(TILE_BYTES // (c * itemsize),
               -(-pixels // (TILES_PER_SM * sms)))
    return max(step, rows // step * step) * c


@functools.lru_cache(maxsize=1024)
def launch_args(shape, dtype, local_size, alpha, beta, k, groups, sms):
    """(the kernel's integer arguments, its float arguments) in the order
    ``cet_lrn`` reads them, for a map of ``shape`` and ``dtype`` on a card
    of ``sms`` SMs; raises on what the kernel does not take. Built once per
    shape, since eager dispatch asks again on every forward."""
    if dtype not in _IO_DTYPES:
        raise TypeError(f"lrn kernel: dtype {dtype}, expected one of "
                        f"{_IO_DTYPES}")
    c = shape[-1]
    if groups < 1 or c % groups:
        raise ValueError(f"lrn: {c} channels do not split into {groups} "
                         f"groups")
    if not 1 <= local_size <= MAX_LOCAL_SIZE:
        raise ValueError(f"lrn kernel: local_size {local_size}, expected 1 "
                         f"to {MAX_LOCAL_SIZE}")
    itemsize = torch.finfo(dtype).bits // 8
    pixels = math.prod(shape[:-1])
    tile = tile_elems(pixels, c, itemsize, sms)
    # the tile plus the halo's pad vectors (at most 8 of 16 bytes)
    if tile * itemsize + 128 > _MAX_SMEM:
        raise ValueError(f"lrn kernel: a tile of {tile} elements "
                         f"({c} channels a pixel) exceeds its shared memory")
    half = local_size // 2
    return (_build.c_ints(pixels, c, c // groups, -half, local_size - 1 - half,
                          tile, int(beta != 0.75)),
            _build.c_floats(alpha / local_size, k, -beta))


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel(x, local_size, alpha, beta, k, groups):
    """One launch of the kernel on CUDA tensor ``x``."""
    global launches, launches_f32
    dims, floats = launch_args(tuple(x.shape), x.dtype, local_size,
                               float(alpha), float(beta), float(k), groups,
                               _sm_count(x.device.index))
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)  # 16-byte loads
    out = torch.empty_like(x)
    f32 = x.dtype == torch.float32
    lib = _build.load()
    entry = lib.cet_lrn_f32 if f32 else lib.cet_lrn
    rc = entry(x.data_ptr(), out.data_ptr(), dims, floats,
               _build.stream_of(x))
    _build.check(rc, "cet_lrn_f32" if f32 else "cet_lrn")
    launches += 1
    launches_f32 += int(f32)
    return out


class _LRN(torch.autograd.Function):
    """The kernel forward; the plain version's gradient backward."""

    @staticmethod
    def forward(ctx, x, local_size, alpha, beta, k, groups):
        ctx.save_for_backward(x)
        ctx.hyper = dict(local_size=local_size, alpha=alpha, beta=beta, k=k,
                         groups=groups)
        return _kernel(x, local_size, alpha, beta, k, groups)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            (gx,) = torch.autograd.grad(lrn_plain(xg, **ctx.hyper), xg, grad)
        return gx, None, None, None, None, None


def lrn(x: torch.Tensor, *, local_size=5, alpha=1e-4, beta=0.75, k=1.0,
        groups: int = 1) -> torch.Tensor:
    """y = x / (k + alpha/n * sum over the window of x_c^2)^beta over the
    last axis of ``x`` (NHWC), ``groups`` independent channel blocks: the
    kernel on CUDA, the plain version on the CPU."""
    global calls
    calls += 1
    if x.device.type == "cpu":
        return lrn_plain(x, local_size=local_size, alpha=alpha, beta=beta,
                         k=k, groups=groups)
    if x.device.type != "cuda":
        raise ValueError(f"lrn: unsupported device {x.device}")
    if x.numel() == 0:
        return torch.empty_like(x)
    return _LRN.apply(x, local_size, alpha, beta, k, groups)
