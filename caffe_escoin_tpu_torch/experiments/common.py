"""What the probes share: their command-line flags, the device, the rows
they print and append, and the sparse nets they build.

``sparse_net`` builds a net as the JAX scripts build theirs: the model's
weights from seed 0, every Convolution with KH*KW*Cin >= 32 pruned to 90%
in 128x128 blocks (the stem and the fcs stay dense), ``fuse_inference``,
optionally ``pack_narrow_chains``, ``weight_align``, SCONV_PAR in bf16
with ``autotune=True`` (the XBSP arms and the hand ``sconv_fused`` kernel
measured per key; call the forward under ``autotune.net_scope``). The
4 inputs come from ``default_rng(0)`` times 0.1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from caffe_escoin_tpu_torch.utils import benchmark
from caffe_escoin_tpu_torch.utils.benchmark import (PLATFORMS, device_label,
                                                    force_platform)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_DIR = os.path.join(ROOT, "build", "experiments")
# the JAX package's paths, which no probe writes under
REFUSED_DIRS = ("caffe_escoin_tpu", "scripts", "logs")
# as the port's bench sets it for a run: the CUDA autotune table
ENV_DEFAULTS = {
    "CESCOIN_AUTOTUNE_CACHE": os.path.join(ROOT, ".autotune_cuda.json"),
}
SPARSITY = 0.9
BLOCK = (128, 128)
N_INPUTS = 4


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def parser(name: str, doc: str) -> argparse.ArgumentParser:
    """The probe's parser with the flags every probe has: ``--platform``
    and ``--out`` (default ``build/experiments/<name>.jsonl``)."""
    ap = argparse.ArgumentParser(
        prog=f"python -m caffe_escoin_tpu_torch.experiments.{name}",
        description=doc.strip().splitlines()[0])
    ap.add_argument("--platform", default="auto", choices=PLATFORMS,
                    help="auto and cuda need the card (exit 2 without one)")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, f"{name}.jsonl"),
                    help="JSONL file the rows are appended to")
    return ap


def check_out(path: str) -> str:
    """``path`` made absolute; one under the JAX package, its scripts or
    their logs raises ValueError."""
    path = os.path.abspath(path)
    for d in REFUSED_DIRS:
        if os.path.commonpath([path, os.path.join(ROOT, d)]) == \
                os.path.join(ROOT, d):
            raise ValueError(f"--out {path}: under {d}/, which belongs to "
                             f"the JAX package; write under build/")
    return path


def device_of(platform: str) -> Optional[torch.device]:
    """``force_platform(platform)``, or None (after a message) where the
    card was asked for and there is none: the caller exits 2."""
    try:
        return force_platform(platform)
    except RuntimeError as e:
        log(f"{e}")
        return None


def env_defaults():
    """``ENV_DEFAULTS`` where the environment sets nothing, for the run."""
    return benchmark.env_defaults(ENV_DEFAULTS)


class Rows:
    """Prints each row as one JSON line on stdout and appends it to
    ``path``, with ``device`` (the card's name and power limit, or "cpu")
    and a time stamp."""

    def __init__(self, path: str, device: torch.device):
        self.path = check_out(path)
        self.device = device_label(device)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)

    def __call__(self, **row) -> Dict[str, Any]:
        row = {**row, "device": self.device,
               "ts": time.strftime("%Y-%m-%dT%H:%M:%S")}
        with open(self.path, "a") as fh:
            fh.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
        return row


@dataclasses.dataclass
class SparseNet:
    net: Any  # the fused (and packed) sparse Net
    aligned: Dict[str, Any]  # its aligned params on the device, bf16
    xs: List[torch.Tensor]  # the 4 inputs
    specs: Any  # the unfused specs
    params: Dict[str, Any]  # the unpruned params (CPU)
    state: Dict[str, Any]  # the BatchNorm state (CPU)


def sparse_net(model: str, batch: int, device, *, pack: bool = False,
               autotune: bool = True) -> SparseNet:
    """The probes' sparse net; see the module docstring."""
    from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy
    from caffe_escoin_tpu_torch.models import ZOO
    from caffe_escoin_tpu_torch.nn import Net, fuse_inference, params_to
    from caffe_escoin_tpu_torch.nn.fuse import pack_narrow_chains
    from caffe_escoin_tpu_torch.utils.pruning import prune_conv_weight

    builder, input_shapes = ZOO[model]
    specs = builder()
    shapes = {"data": (batch,) + tuple(input_shapes["data"][1:])}
    policy = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR, block_shape=BLOCK,
                             compute_dtype=torch.bfloat16, cast_back=False,
                             autotune=autotune)
    net = Net(specs, policy=policy, phase="test")
    params = net.init(torch.Generator().manual_seed(0), shapes)
    state = net.state0
    pruned = dict(params)
    for layer in net.layers:
        name = layer.spec.name
        if name not in pruned or layer.spec.type not in (
                "Convolution", "ConvolutionReLU"):
            continue
        w = pruned[name]["w"].numpy()
        if w.shape[0] * w.shape[1] * w.shape[2] < 32:
            continue
        pruned[name] = dict(pruned[name], w=torch.from_numpy(
            prune_conv_weight(w, SPARSITY, BLOCK)))
    net, pruned = fuse_inference(net, pruned, state=state)
    if pack:
        net = pack_narrow_chains(net)
    aligned = params_to(net.weight_align(pruned), device, torch.bfloat16)
    net.state0 = params_to(net.state0, device)
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal(shapes["data"]).astype(
        np.float32) * 0.1).to(device) for _ in range(N_INPUTS)]
    return SparseNet(net=net, aligned=aligned, xs=xs, specs=specs,
                     params=params, state=state)


def dense_bf16_net(s: SparseNet, device):
    """(net, params): the same model's unpruned weights fused, dense in
    bf16 (the probes' control)."""
    from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
    from caffe_escoin_tpu_torch.nn import Net, fuse_inference, params_to

    net = Net(s.specs, policy=ExecutionPolicy(
        compute_dtype=torch.bfloat16, cast_back=False), phase="test")
    net, params = fuse_inference(net, s.params, state=s.state)
    net.state0 = params_to(net.state0, device)
    return net, params_to(params, device, torch.bfloat16)


def first(out):
    """The first top of a forward's result."""
    return out[next(iter(out))]
