"""Execution policy (port of ``caffe_escoin_tpu/engine/context.py``).

An explicit, per-net (or per-layer) object instead of Caffe's global
``conv_mode`` singleton. The port carries the fields its executors read,
with the JAX defaults: ``use_xla_sparse``, ``xbsp_arm``, ``autotune`` and
``autotune_cache`` select the XBSP arms (kernels/xla_block_sparse.py) and
their measured choice (engine/autotune.py). Pallas interpret, the Pallas
SpMM tile and the native CPU route of the JAX policy have no counterpart
here, so their switches are absent.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import torch


class SparseFormat(enum.Enum):
    CSR = "csr"  # interchange only
    ELL = "ell"  # unstructured: the gather SpMM (kernels/spmm.py)
    BSR = "bsr"  # block-structured: the block-sparse executors


class ConvMode(enum.IntEnum):
    """Convolution execution modes (same values as the JAX package).

    LOWERED_GEMM   -- dense convolution (``F.conv2d``).
    LOWERED_SPARSE -- im2col + sparse SpMM: with ``sparse_format=ELL``
                      (and the ELL artifact aligned) the gather SpMM of
                      kernels/spmm.py over the row-sparse W^T, else the
                      block-sparse SpMM (the XBSP ``spmm`` or
                      kernels/bsc_spmm.py).
    SCONV          -- direct sparse convolution. On the XBSP branch
                      (``use_xla_sparse``) the arm runs image by image, as
                      the reference's ``forward_gpu_sconv`` loops over the
                      batch; the direct kernels fold the batch into M.
    SCONV_PAR      -- batch-parallel direct sparse convolution: the whole
                      batch folds into every product's M dimension.
    """

    LOWERED_GEMM = 0
    LOWERED_SPARSE = 1
    SCONV = 2
    SCONV_PAR = 3


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """Per-layer (or net-default) execution policy.

    ``sparse_threshold`` / ``sconv_threshold``: minimum weight sparsity at
    which LOWERED_SPARSE / SCONV(_PAR) are used; a denser layer runs dense.

    ``compute_dtype`` (e.g. ``torch.bfloat16``) casts each conv/fc layer's
    input and weights; ``cast_back=False`` keeps the outputs in that dtype so
    the whole net runs at that width.

    ``mxu_dtype``: multiply dtype inside the sparse kernels (accumulation is
    always f32). "auto" is bf16 on a CUDA tensor and f32 on a CPU tensor.
    On CUDA only "bfloat16" is implemented: "float32" raises
    NotImplementedError there (the plain versions honour both on the CPU).

    ``sparse_format``: ELL makes ``weight_align`` build the row-sparse
    W^T (``AlignedConvWeight.ell_t``) and LOWERED_SPARSE run it through
    the gather SpMM; BSR (the default) keeps the block-sparse executors.

    ``use_xla_sparse`` (the default) runs each sparse conv and fc through
    the XBSP arms (kernels/xla_block_sparse.py: torch ops, the name kept
    from the JAX package); False takes the hand-written kernels' routes.
    ``xbsp_arm`` forces one arm ("unroll", "gathered", "gathered_cols",
    "dense", "fused"); "auto" picks per shape. ``autotune`` measures the
    candidate arms per (shape, pattern) on the device and caches the
    winner (engine/autotune.py), in ``autotune_cache`` when it names a
    JSON file.
    """

    conv_mode: ConvMode = ConvMode.LOWERED_GEMM
    sparse_format: SparseFormat = SparseFormat.BSR
    block_shape: Tuple[int, int] = (8, 128)  # (cin-block, cout-block)
    sparse_threshold: float = 0.5
    sconv_threshold: float = 0.5
    fuse_relu: bool = True
    compute_dtype: Optional[torch.dtype] = None
    cast_back: bool = True
    mxu_dtype: str = "auto"
    use_xla_sparse: bool = True
    xbsp_arm: str = "auto"
    autotune: bool = False
    autotune_cache: str = ""


def resolve_mxu_dtype(mxu_dtype: str, device) -> str:
    """"auto" -> "bfloat16" on a CUDA device, "float32" elsewhere."""
    if mxu_dtype == "auto":
        return "bfloat16" if torch.device(device).type == "cuda" else "float32"
    if mxu_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"unknown mxu_dtype {mxu_dtype!r}")
    return mxu_dtype
