"""caffe-escoin-tpu on PyTorch and CUDA: the block-sparse inference path.

A port of the JAX package ``caffe_escoin_tpu`` to PyTorch, with its Pallas
kernels rewritten by hand in CUDA C++ for NVIDIA Hopper (``sm_90a``). The
layout mirrors the JAX package module for module, so each counterpart is
found under the same name; activations are NHWC and conv weights HWIO at
every public function, as there.

The package imports torch and numpy only. It never imports jax, nor the JAX
package (whose ``__init__`` imports jax), so the numpy helpers it needs are
carried over rather than shared.

Device rule: every entry takes its device from its tensors. On a CUDA
tensor a kernel entry launches its kernel or raises; on a CPU tensor it runs
the kernel's plain PyTorch version. Nothing probes for a card, except where
no tensor names a device: a data layer puts its tops on its net's device,
and a net's device None means the card (nn/data_layers.py).
"""

__version__ = "0.1.0"

from caffe_escoin_tpu_torch.engine.context import (  # noqa: F401
    ConvMode,
    ExecutionPolicy,
)
