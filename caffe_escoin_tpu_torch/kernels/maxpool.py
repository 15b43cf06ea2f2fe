"""Caffe's max pooling over an NHWC map.

The CUDA kernel ``csrc/maxpool.cu`` computes it in one pass: one read of the
map and one write of the output (``cet_maxpool`` for bf16 maps,
``cet_maxpool_f32`` for f32 ones). It is a hand kernel of an op that the JAX
package leaves to XLA (``reduce_window`` in ``caffe_escoin_tpu/ops/pool.py``),
not a port of a Pallas kernel. Its plain version ``max_pool_plain`` is what
``ops/pool.pool2d``'s max branch ran before, three passes on the card: a pad
with -inf, ``F.max_pool2d`` (which on CUDA also writes an int64 index per
output), a crop.

``max_pool`` runs the kernel for a CUDA tensor and the plain version for any
other (a CPU tensor, or a meta tensor sizing a layer); the two agree bit for
bit (max selects, it does not round). Both take the output's size from the
caller (``ops/pool.pool2d`` sizes it by Caffe's rule): windows that reach
past the map or its padding see -inf there. On CUDA it is a
``torch.autograd.Function`` whose backward is the plain version's gradient
(the plain forward recomputed under grad), so a net with max pools trains
on the card with the numbers it had. The kernel takes bf16 and f32 maps, any
C, window, stride and padding; a strided map is copied to a contiguous one
first, and an empty one (no image or no channel) gives an empty output
without a launch. ``launch_args`` is its launch for a shape. ``calls``
counts entry calls on any device; ``launches`` counts kernel launches only,
``launches_f32`` those over f32 maps.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.kernels import _build

calls = 0
launches = 0
launches_f32 = 0

_IO_DTYPES = (torch.float32, torch.bfloat16)
# (kh, kw, sh) that csrc/maxpool.cu compiles its ring of row maxes for ->
# the most output rows a thread walks. Measured on an H100 80GB HBM3 at the
# zoo's pools: strips of 4 rows at stride 1 and 2 at stride 2 beat one row
# by 5-25%; longer strips, or any strip of a 2x2/s2 stream, which has no
# rows to share, lose parallelism (VGG-16 pool1 b32: 102.6 us with 22 rows,
# 86.8 with 1). Any other window takes one row a thread.
STRIP_ROWS = {(3, 3, 1): 4, (3, 3, 2): 2, (2, 2, 2): 1}
# a strip is shortened until the grid has this many threads per SM
MIN_THREADS_PER_SM = 256
# threads a block: the first that still gives every SM a block
BLOCK_THREADS = (128, 64)
_MAX_THREADS = 2 ** 31 - 1 - 256  # what csrc/maxpool.cu indexes (kMaxThreads)


def reset_counts() -> None:
    global calls, launches, launches_f32
    calls = 0
    launches = 0
    launches_f32 = 0


def max_pool_plain(x, kernel, stride, padding, out_size):
    """Plain PyTorch version: x [N, H, W, C] padded with -inf to cover every
    window of the ``out_size`` (Ho, Wo) output, ``F.max_pool2d`` on its
    channels-first view, the result cropped to that size."""
    n, h, w, c = x.shape
    kh, kw = kernel
    sh, sw = stride
    ph, pw = padding
    ho, wo = out_size
    # pad right/bottom enough to cover the (possibly ceil-extended) last window
    pad_h2 = max(0, (ho - 1) * sh + kh - h - ph)
    pad_w2 = max(0, (wo - 1) * sw + kw - w - pw)
    xp = F.pad(x, (0, 0, pw, pad_w2, ph, pad_h2), value=float("-inf"))
    out = F.max_pool2d(xp.permute(0, 3, 1, 2), (kh, kw), (sh, sw))
    return out.permute(0, 2, 3, 1)[:, :ho, :wo, :].contiguous()


class Launch(NamedTuple):
    """The kernel's launch for one map: ``dims``, its integer arguments in
    the order ``cet_maxpool`` reads them, and what they hold."""
    dims: object
    out_shape: tuple
    lanes: int    # elements of a thread's vector
    rows: int     # output rows a thread walks
    threads: int  # a block's
    blocks: int


@functools.lru_cache(maxsize=1024)
def launch_args(shape, dtype, kernel, stride, padding, out_size, sms):
    """The launch for a map of ``shape`` ([N, H, W, C]) and ``dtype``
    pooled to ``out_size`` (Ho, Wo) on a card of ``sms`` SMs: the widest vector (16, 8, 4 or 2 bytes) whose lanes
    divide C; strips of at most ``STRIP_ROWS`` output rows, shortened
    until the grid has ``MIN_THREADS_PER_SM`` threads per SM (one row for
    other windows); blocks of the first ``BLOCK_THREADS`` that still give
    every SM one. Raises on what the kernel does not take. Built once per
    shape, since eager dispatch asks again on every forward."""
    if dtype not in _IO_DTYPES:
        raise TypeError(f"maxpool kernel: dtype {dtype}, expected one of "
                        f"{_IO_DTYPES}")
    if len(shape) != 4:
        raise ValueError(f"maxpool kernel: an NHWC map, got shape {shape}")
    n, h, w, c = shape
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    if min(kh, kw, sh, sw) < 1 or min(ph, pw) < 0:
        raise ValueError(f"maxpool kernel: window {kernel}, stride {stride}, "
                         f"padding {padding}")
    ho, wo = out_size
    if min(h, w, ho, wo) < 1:
        raise ValueError(f"maxpool kernel: a {h}x{w} map pooled to "
                         f"{ho}x{wo}")
    itemsize = torch.finfo(dtype).bits // 8
    lanes = next(v for v in (16 // itemsize, 8 // itemsize, 4 // itemsize, 1)
                 if c % v == 0)
    per_row = n * wo * (c // lanes)  # threads of one output row
    rows = min(STRIP_ROWS.get((kh, kw, sh), 1), ho)
    while rows > 1 and -(-ho // rows) * per_row < sms * MIN_THREADS_PER_SM:
        rows -= 1
    total = -(-ho // rows) * per_row
    if total > _MAX_THREADS:
        raise ValueError(f"maxpool kernel: {total} threads for {shape}")
    threads = next((t for t in BLOCK_THREADS if -(-total // t) >= sms),
                   BLOCK_THREADS[-1])
    blocks = -(-total // threads)
    dims = _build.c_ints(n, h, w, c, ho, wo, kh, kw, sh, sw, ph, pw, lanes,
                         rows, threads, blocks)
    return Launch(dims, (n, ho, wo, c), lanes, rows, threads, blocks)


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel(x, kernel, stride, padding, out_size):
    """One launch of the kernel on CUDA tensor ``x``; none for an empty
    one."""
    global launches, launches_f32
    la = launch_args(tuple(x.shape), x.dtype, kernel, stride, padding,
                     out_size, _sm_count(x.device.index))
    if la.blocks == 0:  # no image or no channel: nothing to read or write
        return x.new_empty(la.out_shape)
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)  # aligned loads
    out = torch.empty(la.out_shape, dtype=x.dtype, device=x.device)
    f32 = x.dtype == torch.float32
    lib = _build.load()
    entry = lib.cet_maxpool_f32 if f32 else lib.cet_maxpool
    rc = entry(x.data_ptr(), out.data_ptr(), la.dims, _build.stream_of(x))
    _build.check(rc, "cet_maxpool_f32" if f32 else "cet_maxpool")
    launches += 1
    launches_f32 += int(f32)
    return out


class _MaxPool(torch.autograd.Function):
    """The kernel forward; the plain version's gradient backward."""

    @staticmethod
    def forward(ctx, x, kernel, stride, padding, out_size):
        ctx.save_for_backward(x)
        ctx.pool = (kernel, stride, padding, out_size)
        return _kernel(x, kernel, stride, padding, out_size)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            (gx,) = torch.autograd.grad(max_pool_plain(xg, *ctx.pool), xg,
                                        grad)
        return gx, None, None, None, None


def max_pool(x: torch.Tensor, kernel, stride, padding,
             out_size) -> torch.Tensor:
    """Caffe's max pooling of ``x`` [N, H, W, C] -> [N, Ho, Wo, C], with
    ``out_size`` (Ho, Wo): the kernel on CUDA, the plain version elsewhere
    (the CPU, and the meta tensors that size a layer's output)."""
    global calls
    calls += 1
    if x.device.type != "cuda":
        return max_pool_plain(x, kernel, stride, padding, out_size)
    return _MaxPool.apply(x, tuple(kernel), tuple(stride), tuple(padding),
                          tuple(out_size))
