"""A net's stem: a dense conv over an NHWC image of at most 4 channels,
with its bias and ReLU, in one pass.

The CUDA kernel ``csrc/stem_conv.cu`` (``cet_stem_conv``, bf16) computes it
as one implicit GEMM on the tensor cores: the image is read once through a
shared-memory window, the output written once with the bias added in f32,
ReLU'd and rounded to bf16 once. It is a hand kernel of an op that the JAX
package leaves to XLA (``conv2d_dense`` in ``caffe_escoin_tpu/ops/conv.py``),
not a port of a Pallas kernel. Its plain version ``stem_plain`` is what
``ops/conv.conv2d_dense`` runs for every other dense conv: ``F.conv2d``
with the bias in the input's dtype (cuDNN on the card), then
``conv_epilogue.epilogue_plain``'s ReLU. The two differ by the rounding of
the bias (the kernel adds it in f32 before its one rounding, the plain
version rounds the conv, the bias and their sum) and by the order of the
f32 sums.

``takes`` is the kernel's gate, which ``ops/conv`` alone asks: a bf16
input with no autograd graph to record, Cin <= 4, one group, dilation 1,
a square stride and padding, Cout a multiple of 8 up to 128, no residual,
and a launch ``plan`` that fits a block's shared memory. ``stem_conv`` runs
the kernel on a CUDA tensor and the plain version elsewhere (the CPU, a
meta tensor). ``kernel_weight`` is the weight as the kernel reads it, built
once per weight and device into the ``memo`` the caller hands in (an
aligned weight's), so a forward after the first lays out nothing.
``calls`` counts entry calls on any device; ``launches`` counts kernel
launches only (``launches_f32`` stays 0: the kernel is bf16 only).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.kernels import _build, conv_epilogue

calls = 0
launches = 0
launches_f32 = 0

MAX_CIN = 4
MAX_COUT = 128
TILE_M = 256       # output pixels a tile (csrc kTileM)
N8_TILES = (4, 8, 12, 16)  # the output widths / 8 that csrc/stem_conv.cu compiles
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024 + 16  # a block's reserved and static shared bytes


def reset_counts() -> None:
    global calls, launches, launches_f32
    calls = 0
    launches = 0
    launches_f32 = 0


def stem_plain(x: torch.Tensor, w_hwio: torch.Tensor,
               bias: Optional[torch.Tensor] = None, *, stride=(1, 1),
               padding=(0, 0), relu: bool = False) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv2d`` on x's channels-first view with
    the bias in x's dtype, then ReLU (``conv_epilogue.epilogue_plain``);
    contiguous NHWC."""
    out = F.conv2d(x.permute(0, 3, 1, 2),
                   w_hwio.to(x.dtype).permute(3, 2, 0, 1),
                   None if bias is None else bias.to(x.dtype),
                   stride=tuple(stride), padding=tuple(padding))
    return conv_epilogue.epilogue_plain(out.permute(0, 2, 3, 1), relu=relu)


class Plan(NamedTuple):
    """The kernel's launch for one shape, as ``launch_dims`` hands it to
    ``cet_stem_conv``."""
    out_shape: tuple
    cout_pad: int   # 8 x the compiled n8 tiles
    k_pad: int      # kh x row_k(kw, Cin), rounded up to 16
    rows: int       # window rows a tile holds at most
    rs: int         # window row pitch, elements
    win: int        # elements of one window buffer
    tiles: int
    tiles_per_img: int
    smem: int       # dynamic shared bytes a block
    per_sm: int     # blocks a SM: 2 for Cout_pad <= 64 where they fit


def row_k(kw: int, cin: int) -> int:
    """The K values of one kernel row as the kernel reads them: kw*Cin,
    rounded up to even, so that no pair of K values straddles two rows."""
    return -(-kw * cin // 2) * 2


@functools.lru_cache(maxsize=256)
def plan(shape, kernel, stride: int, padding: int, cout: int) -> Plan:
    """The launch plan of an NHWC image ``shape`` under a ``kernel`` (kh,
    kw) window of ``stride`` and ``padding`` to ``cout`` channels, as
    csrc/stem_conv.cu lays out its shared memory: the resident weight
    (``kernel_weight``), a table of K_pad offsets and masks, the bias, two
    window buffers of the most image rows 256 consecutive output pixels
    read (each row at a pitch congruent to W*Cin modulo 8, with room for
    the 16-byte copies' spill) and the window shifted by one element,
    whose region also holds what the 256 x (Cout_pad + 8) output stage
    needs beyond one window. Raises ValueError on what the kernel does not
    take."""
    n, h, w, c = shape
    kh, kw = kernel
    s, p = stride, padding
    if not (0 < c <= MAX_CIN and 0 < cout <= MAX_COUT and cout % 8 == 0
            and min(n, h, w, kh, kw, s) > 0 and p >= 0
            and h + 2 * p >= kh and w + 2 * p >= kw):
        raise ValueError(f"stem_conv kernel: image {shape}, window {kernel}"
                         f"/s{s}/p{p}, cout {cout}")
    ho, wo = (h + 2 * p - kh) // s + 1, (w + 2 * p - kw) // s + 1
    cout_pad = 8 * next(t for t in N8_TILES if 8 * t >= cout)
    k_pad = -(-kh * row_k(kw, c) // 16) * 16
    span = min(-(-(TILE_M - 1) // wo) + 1, ho)
    rows = (span - 1) * s + kh
    width = ((wo - 1) * s + kw) * c
    need = max(width, (w + p) * c) + 8
    rs = need + (w * c - need) % 8
    win = -(-(32 + rows * rs) // 8) * 8
    wp = cout_pad + 8
    shifted = max(win, TILE_M * wp - win)
    smem = (k_pad * cout_pad * 2 + k_pad * 4 + cout_pad * 4
            + (2 * win + shifted) * 2)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"stem_conv kernel: {smem} bytes of shared memory "
                         f"for image {shape}, window {kernel}/s{s}")
    tiles_per_img = -(-ho * wo // TILE_M)
    if n * tiles_per_img > 2 ** 31 - 1 or n * h * w * c >= 2 ** 40:
        raise ValueError(f"stem_conv kernel: image {shape}")
    per_sm = 2 if (cout_pad <= 64 and 2 * (smem + SMEM_RESERVED)
                   <= SMEM_PER_SM) else 1
    return Plan((n, ho, wo, cout), cout_pad, k_pad, rows, rs, win,
                n * tiles_per_img, tiles_per_img, smem, per_sm)


def fits(shape, kernel, stride: int, padding: int, cout: int) -> bool:
    """Whether ``plan`` takes the shape."""
    try:
        plan(tuple(shape), tuple(kernel), stride, padding, cout)
    except ValueError:
        return False
    return True


def takes(x, w_hwio, bias=None, *, stride=(1, 1), padding=(0, 0),
          dilation=(1, 1), groups=1, residual=False) -> bool:
    """The kernel's gate (``x`` needs only shape, dtype and device; a meta
    tensor will do): a bf16 NHWC input, an HWIO weight of Cin <= 4
    channels and Cout a multiple of 8 up to 128, one group, dilation 1, a
    square stride and padding, no ``residual``, no autograd graph to
    record, and a ``plan`` that fits. ``ops/conv.conv2d_dense`` runs
    ``stem_conv`` where it holds, on any device (off the card as the plain
    version)."""
    if (x.dtype != torch.bfloat16 or x.dim() != 4 or w_hwio.dim() != 4
            or residual or groups != 1 or tuple(dilation) != (1, 1)):
        return False
    kh, kw, cin, cout = w_hwio.shape
    (sh, sw), (ph, pw) = tuple(stride), tuple(padding)
    if (cin != x.shape[3] or cin > MAX_CIN or cout > MAX_COUT or cout % 8
            or sh != sw or ph != pw):
        return False
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w_hwio, bias)):
        return False
    return fits(tuple(x.shape), (kh, kw), sh, ph, cout)


def gemm_weight(w_hwio: torch.Tensor) -> torch.Tensor:
    """The weight as the kernel reads it: HWIO as rows (i, j*Cin + c), each
    kernel row's kw*Cin rows followed by zero rows up to ``row_k``,
    [K_pad, Cout_pad] bf16 with zero rows and columns in the padding."""
    kh, kw, cin, cout = w_hwio.shape
    rk = row_k(kw, cin)
    k = kh * rk
    cout_pad = 8 * next(t for t in N8_TILES if 8 * t >= cout)
    wg = F.pad(w_hwio.reshape(kh, kw * cin, cout).to(torch.bfloat16),
               (0, cout_pad - cout, 0, rk - kw * cin)).reshape(k, cout_pad)
    return F.pad(wg, (0, 0, 0, -(-k // 16) * 16 - k)).contiguous()


def kernel_weight(w_hwio: torch.Tensor) -> torch.Tensor:
    """``gemm_weight`` in the order the kernel's wgmma B descriptors read
    it from shared memory: for each K step of 16, for each group of 8
    output channels, the step's two halves of 8 K values, each a 128-byte
    core matrix of 8 channels x 8 K values (K contiguous)."""
    wg = gemm_weight(w_hwio)
    k_pad, cout_pad = wg.shape
    return (wg.reshape(k_pad // 16, 2, 8, cout_pad // 8, 8)
            .permute(0, 3, 1, 4, 2).contiguous().reshape(-1))


@functools.lru_cache(maxsize=256)
def launch_dims(pl: Plan, shape, kernel, stride, padding, sms: int,
                relu: bool):
    """``cet_stem_conv``'s integer arguments for ``pl`` on a card of
    ``sms`` SMs: ``pl.per_sm`` persistent blocks a SM, at most one a
    tile."""
    n, h, w, c = shape
    _, ho, wo, cout = pl.out_shape
    return _build.c_ints(n, h, w, c, ho, wo, cout, kernel[0], kernel[1],
                         stride, padding, pl.cout_pad, pl.k_pad, pl.rows,
                         pl.rs, pl.win, pl.tiles_per_img, pl.tiles,
                         min(pl.tiles, sms * pl.per_sm), pl.smem, int(relu))


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _operands(w_hwio, bias, device, memo):
    """The weight as the kernel reads it and the f32 bias on ``device``,
    from ``memo`` or built now (and kept there)."""
    key = ("stem_conv", device)
    got = None if memo is None else memo.get(key)
    if got is None:
        got = (kernel_weight(w_hwio.to(device)),
               None if bias is None
               else bias.to(device=device, dtype=torch.float32).contiguous())
        if memo is not None:
            memo[key] = got
    return got


def _kernel(x, w_hwio, bias, stride, padding, relu, memo):
    """One launch of the kernel on CUDA tensor ``x``."""
    global launches
    kh, kw, _, cout = w_hwio.shape
    pl = plan(tuple(x.shape), (kh, kw), stride, padding, cout)
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)  # aligned copies
    wg, b = _operands(w_hwio, bias, x.device, memo)
    out = torch.empty(pl.out_shape, dtype=x.dtype, device=x.device)
    dims = launch_dims(pl, tuple(x.shape), (kh, kw), stride, padding,
                       _sm_count(x.device.index), bool(relu))
    rc = _build.load().cet_stem_conv(
        x.data_ptr(), wg.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), dims, _build.stream_of(x))
    _build.check(rc, "cet_stem_conv")
    launches += 1
    return out


def stem_conv(x: torch.Tensor, w_hwio: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *, stride=(1, 1),
              padding=(0, 0), relu: bool = False,
              memo: Optional[dict] = None) -> torch.Tensor:
    """``x`` [N, H, W, Cin] conv ``w_hwio`` [kh, kw, Cin, Cout] + ``bias``,
    then ReLU: [N, Ho, Wo, Cout], contiguous NHWC, for a conv ``takes``
    admits. The kernel on CUDA (its weight layout kept in ``memo`` where
    one is given), the plain version elsewhere."""
    global calls
    calls += 1
    if x.device.type != "cuda":
        return stem_plain(x, w_hwio, bias, stride=stride, padding=padding,
                          relu=relu)
    return _kernel(x, w_hwio, bias, int(stride[0]), int(padding[0]), relu,
                   memo)
