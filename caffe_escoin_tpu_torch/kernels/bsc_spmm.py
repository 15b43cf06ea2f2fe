"""Dense x block-sparse SpMM: A[M, K] @ BSC W[K, N] -> [M, N].

Port of the Pallas kernel ``caffe_escoin_tpu/kernels/bsc_pallas.py``
(``bsc_spmm_pallas``) as the CUDA kernel ``csrc/bsc_spmm.cu``, with bias and
ReLU in its epilogue. Its plain version ``bsc_spmm_plain`` is the gather
over block slots of ``caffe_escoin_tpu/kernels/spmm.py:82-107``.

The kernel is the pipelined tile loop of ``csrc/sconv_pipe.cuh``. It
multiplies in the resolved ``mxu_dtype``, as the JAX kernel does: bf16
("auto" on the card), or f32 as three TF32 products per multiply, which
keep f32 accuracy (``cet_bsc_spmm_f32``). It copies A with ``cp.async``,
which does not convert: ``bsc_spmm`` hands it A and the blocks in that
type with K and bk multiples of 8 (bf16) or 4 (f32)
(``kernel_operands``). ``launch_plan`` is its tile size, split of K, ring
depth and shared memory for a shape and multiply type
(``sconv_pipe.spmm_plan``). A split launch sums its shares through an f32
workspace and a per-device counter buffer (``_counters``) that the kernel
leaves at zero; two launches running at once on two streams of one device
must therefore not both split.

``bsc_spmm`` runs the kernel for a CUDA tensor and the plain version for a
CPU tensor. ``calls`` counts entry calls on any device; ``launches`` counts
kernel launches only, ``launches_f32`` those that multiplied in f32.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from caffe_escoin_tpu_torch.engine.context import resolve_mxu_dtype
from caffe_escoin_tpu_torch.kernels import _build, sconv_pipe
from caffe_escoin_tpu_torch.sparse.formats import BSC

calls = 0
launches = 0
launches_f32 = 0

_IO_DTYPES = (torch.float32, torch.bfloat16)
# counters of one device: one per (M-tile, block-column) of a split launch,
# which the plan makes only below one block per SM
N_COUNTERS = 1024
_counters = {}  # device index -> int32 [N_COUNTERS], zero between launches


def reset_counts() -> None:
    global calls, launches, launches_f32
    calls = 0
    launches = 0
    launches_f32 = 0


def _epilogue(out, bias, relu, dtype):
    if bias is not None:
        out = out + bias.to(out.dtype)
    if relu:
        out = torch.relu(out)
    return out.to(dtype)


def bsc_spmm_plain(amat: torch.Tensor, bsc: BSC, *,
                   bias: Optional[torch.Tensor] = None, relu: bool = False,
                   mxu_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version: a loop over the padded block slots, each one
    gathering one K-block of A per block-column (padding slots carry zero
    payloads), f32 accumulation (f64 for an f64 A), then the kernel's
    epilogue in that type. With ``mxu_dtype="bfloat16"`` both operands are
    rounded to bf16 first, as the kernel multiplies them."""
    bk, bn = bsc.block_shape
    m, k = amat.shape
    if k != bsc.shape[0]:
        raise ValueError(f"amat cols {k} != sparse K {bsc.shape[0]}")
    ct = torch.promote_types(amat.dtype, torch.float32)
    a, w = amat.to(ct), bsc.blocks.to(ct)
    if mxu_dtype == "bfloat16":
        a, w = a.bfloat16().to(ct), w.bfloat16().to(ct)
    kp = bsc.n_brows * bk
    if k != kp:
        a = F.pad(a, (0, kp - k))
    ablocks = a.reshape(m, bsc.n_brows, bk)
    rows = bsc.block_row.long()
    out = torch.zeros((m, bsc.n_bcols, bn), dtype=ct, device=amat.device)
    for s in range(bsc.max_bw):
        out += torch.einsum("mjk,jkn->mjn", ablocks[:, rows[:, s], :], w[:, s])
    out = out.reshape(m, bsc.n_bcols * bn)[:, :bsc.shape[1]]
    return _epilogue(out, bias, relu, amat.dtype)


def kernel_operands(amat: torch.Tensor, bsc: BSC,
                    mul: str = "bfloat16") -> Tuple[torch.Tensor,
                                                    torch.Tensor, int]:
    """(A, weight blocks, bk) as the kernel copies them: 16 bytes at a time
    with ``cp.async``, which does not convert. So A and the blocks are in
    the multiply type ``mul``: bf16 (an f32 A is rounded to nearest-even
    here, as the MMA rounds it) or f32 (never rounded; bf16 is widened,
    exactly); the output keeps A's dtype. A's rows hold a multiple of
    ``sconv_pipe.vec_of(mul)`` columns (8 in bf16, 4 in f32; zero columns
    appended, which meet zero weight rows), and a K-block is a multiple of
    it deep: where bk is not, each K-block of A and each weight block is
    zero-padded to the next multiple. On the main path (A and blocks in
    ``mul``, K and bk multiples of the vector) nothing is copied."""
    bk = bsc.block_shape[0]
    blocks = bsc.blocks
    dtype, vec = sconv_pipe.DTYPES[mul], sconv_pipe.vec_of(mul)
    # the dtype tests spare the main path the cost of a no-op .to()
    if amat.dtype != dtype:
        amat = amat.to(dtype)
    if blocks.dtype != dtype:
        blocks = blocks.to(dtype)
    k = amat.shape[-1]
    if bk % vec == 0:
        if k % vec:
            amat = F.pad(amat, (0, -k % vec))
        return (amat if amat.is_contiguous() else amat.contiguous()), \
            blocks, bk
    bkv = bk + -bk % vec
    a = F.pad(amat, (0, bsc.n_brows * bk - k)).unflatten(-1, (bsc.n_brows, bk))
    return (F.pad(a, (0, bkv - bk)).flatten(-2).contiguous(),
            F.pad(blocks, (0, 0, 0, bkv - bk)).contiguous(), bkv)


def launch_plan(m: int, bsc: BSC,
                mul: str = "bfloat16") -> sconv_pipe.LaunchPlan:
    """The kernel's launch plan for an A of ``m`` rows against ``bsc``
    multiplied in ``mul``, with K-blocks as deep as ``kernel_operands``
    hands them over."""
    bk, bn = bsc.block_shape
    return sconv_pipe.spmm_plan(m, (bk + -bk % sconv_pipe.vec_of(mul), bn),
                                bsc.n_bcols, bsc.max_bw, mul)


@functools.lru_cache(maxsize=4096)
def _launch(m, k, n, bk, bn, n_bcols, max_bw, relu, bf16_io,
            mul="bfloat16"):
    """(plan, the kernel's integer arguments in the order ``cet_bsc_spmm``
    (and ``_f32``) reads them) for an A of ``m`` x ``k`` in K-blocks ``bk``
    deep, as ``kernel_operands`` hands them over in ``mul``; built once per
    shape, since eager dispatch asks again on every forward."""
    p = sconv_pipe.spmm_plan(m, (bk, bn), n_bcols, max_bw, mul)
    return p, _build.c_ints(m, k, n, bk, bn, n_bcols, max_bw, relu, bf16_io,
                            p.tile_m, p.stages, p.chunk, p.smem, p.split,
                            p.share, N_COUNTERS)


def _counter_buffer(dev: torch.device) -> torch.Tensor:
    """The split launches' counters on ``dev``, zeroed once and kept: the
    kernel resets each counter it uses, so eager calls and CUDA-graph
    replays find them at zero."""
    buf = _counters.get(dev.index)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("bsc_spmm: call it once outside CUDA-graph "
                               "capture first (its counters are made then)")
        buf = _counters[dev.index] = torch.zeros(N_COUNTERS, dtype=torch.int32,
                                                 device=dev)
    return buf


def bsc_spmm(amat: torch.Tensor, bsc: BSC, *,
             bias: Optional[torch.Tensor] = None, relu: bool = False,
             mxu_dtype: str = "auto") -> torch.Tensor:
    """amat [M, K] (f32 or bf16) @ bsc [K, N] (+ bias[N], ReLU) -> [M, N]
    in amat's dtype, multiplied in ``mxu_dtype`` ("auto": bf16 on the card,
    f32 on the CPU) and accumulated in f32. On CUDA, a launch the plan
    splits uses the device's counter buffer: do not run two such launches
    at once on two streams of one device."""
    global calls, launches, launches_f32
    calls += 1
    mxu = resolve_mxu_dtype(mxu_dtype, amat.device)
    if amat.device.type == "cpu":
        return bsc_spmm_plain(amat, bsc, bias=bias, relu=relu, mxu_dtype=mxu)
    if amat.device.type != "cuda":
        raise ValueError(f"bsc_spmm: unsupported device {amat.device}")
    bn = bsc.block_shape[1]
    m, k = amat.shape
    n = bsc.shape[1]
    if k != bsc.shape[0]:
        raise ValueError(f"amat cols {k} != sparse K {bsc.shape[0]}")
    if bn % 8 or bn > 128:
        raise ValueError(f"bsc_spmm kernel needs bn % 8 == 0 and bn <= 128, "
                         f"got bn={bn}")
    if amat.dtype not in _IO_DTYPES:
        raise TypeError(f"amat has dtype {amat.dtype}, expected one of "
                        f"{_IO_DTYPES}")
    dev = amat.device
    f32 = mxu == "float32"
    op = (torch.float32 if f32 else torch.bfloat16,)
    a, blocks, bk = kernel_operands(amat, bsc, mxu)
    _build.check_operand(a, "amat", dev, op)
    _build.check_operand(blocks, "bsc.blocks", dev, op)
    _build.check_operand(bsc.block_row, "bsc.block_row", dev, (torch.int32,))
    _build.check_operand(bsc.bcol_nnz, "bsc.bcol_nnz", dev, (torch.int32,))
    if bias is not None:
        if bias.dtype != torch.float32:
            bias = bias.float()
        _build.check_operand(bias, "bias", dev, (torch.float32,))
        if bias.shape != (n,):
            raise ValueError(f"bias shape {tuple(bias.shape)} != ({n},)")
    plan, dims = _launch(m, a.shape[1], n, bk, bn, bsc.n_bcols, bsc.max_bw,
                         int(relu), int(amat.dtype == torch.bfloat16), mxu)
    ws = counters = None
    if plan.split > 1:
        ws = torch.empty((plan.split, m, bsc.n_bcols * bn),
                         dtype=torch.float32, device=dev)
        counters = _counter_buffer(dev)
    out = torch.empty((m, n), dtype=amat.dtype, device=dev)
    lib = _build.load()
    entry = lib.cet_bsc_spmm_f32 if f32 else lib.cet_bsc_spmm
    rc = entry(
        a.data_ptr(), blocks.data_ptr(), bsc.block_row.data_ptr(),
        bsc.bcol_nnz.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), dims,
        _build.stream_of(amat))
    _build.check(rc, "cet_bsc_spmm_f32" if f32 else "cet_bsc_spmm")
    launches += 1
    launches_f32 += int(f32)
    return out
