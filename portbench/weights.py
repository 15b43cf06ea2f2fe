"""Weights, BatchNorm statistics and images, made from the seed on the
device.

Frozen copies of what the benchmark needs from the program's set-up, so
that a change to the program cannot move the yardstick:

* the fillers (Caffe's ``constant``, ``gaussian``, ``xavier``, ``msra``,
  fan-in rules), as ``caffe_escoin_tpu_torch/nn/fillers.py`` has them;
* the block pruning of ``caffe_escoin_tpu_torch/utils/pruning``
  (``prune_conv_weight`` / ``prune_blocks``), applied as ``chip_smoke.py``'s
  ``_prune`` applies it: every conv with Cin/group >= ``min_cin`` (the
  3-channel stems stay dense) and every fc, its lowest-norm ``sparsity``
  share of (bm, bk) blocks zeroed, a conv's blocks cut from its per-offset
  (Cin, Cout) planes and ranked together, at least one block of a conv
  kept.

Each leaf kind is drawn in one call on the device (normals, uniforms), the
weights rounded to bfloat16, the type they are served in (kept as float32
tensors: both sides get the same values).

Which weights are kept is the configuration's own, found once from its
``pattern_seed`` and the same in every run, so that every seed asks the
same work of the program. To find it, layer by layer over a calibration
batch: the weights that read a channel which is zero on every calibration
image are zeroed (as weight decay leaves a trained net's weights that
never get a gradient), so that the rule, ranking blocks by norm, keeps
blocks that read live channels, as it does in a trained net, instead of
cutting whole stages off; then the layer is pruned. A run draws its values
from its seed, masks them with the pattern, and takes as BatchNorm
statistics those of its pruned net on its own calibration batch, as a
trained net's are of its data.

Scale's gamma is U(0.5, 1.5), and U(0.1, 0.3) on a residual branch's last
BatchNorm, as trained ResNets have it small there (and as zero-gamma
initialisation starts it): at gamma near 1 the seeded net is chaotic (a
random BatchNorm net amplifies a perturbation with depth), and bfloat16's
rounding alone reaches a third of float8's at the logits. Scale's beta is
0: a channel that no live block reaches stays 0, instead of feeding later
layers a constant that their BatchNorm would cancel.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import plain

# streams drawn from one seed, each for one purpose
WEIGHTS, CALIBRATION, POOL, SAMPLE = 1, 2, 3, 4
CALIBRATION_IMAGES = 8


def stream_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose, from the run's ``--seed`` (any whole
    number)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), purpose])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def generator(seed: int, purpose: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, purpose))
    return g


def _fan_in(shape) -> int:
    return math.prod(shape) // shape[-1]


def _leaves(table, data_shape):
    """(name, key, shape, filler) of every drawn leaf, in table order."""
    shapes = plain.weight_shapes(table, data_shape)
    for e in table:
        if e["type"] not in ("conv", "fc"):
            continue
        ws = shapes[e["name"]]
        yield e["name"], "w", ws["w"], e["weight_filler"]
        if e["bias"]:
            yield e["name"], "b", ws["b"], e["bias_filler"]
        if e.get("bn"):
            c = (e["cout"],)
            lo, hi = (0.1, 0.3) if e.get("residual") else (0.5, 1.5)
            yield e["name"], "gamma", c, {"type": "uniform", "min": lo,
                                          "max": hi}
            yield e["name"], "beta", c, {"type": "constant", "value": 0.0}


def _draw(kind: str) -> str:
    return {"gaussian": "normal", "msra": "normal", "xavier": "uniform",
            "uniform": "uniform", "constant": "none"}[kind]


def make_params(table, data_shape, seed: int, device) -> Dict[str, dict]:
    """Every conv's and fc's leaves, filled as the table's fillers say:
    one ``randn`` and one ``rand`` call on the device for all of them."""
    leaves = list(_leaves(table, data_shape))
    sizes = {"normal": 0, "uniform": 0}
    for _, _, shape, filler in leaves:
        d = _draw(filler["type"])
        if d != "none":
            sizes[d] += math.prod(shape)
    g = generator(seed, WEIGHTS, device)
    pools = {"normal": torch.randn(sizes["normal"], generator=g,
                                   device=device),
             "uniform": torch.rand(sizes["uniform"], generator=g,
                                   device=device)}
    at = {"normal": 0, "uniform": 0}
    params: Dict[str, dict] = {}
    for name, key, shape, filler in leaves:
        kind = filler["type"]
        d = _draw(kind)
        if d == "none":
            v = torch.full(shape, float(filler.get("value", 0.0)),
                           device=device)
        else:
            n = math.prod(shape)
            v = pools[d][at[d]:at[d] + n].view(shape)
            at[d] += n
            if kind == "gaussian":
                v = v * filler.get("std", 0.01) + filler.get("mean", 0.0)
            elif kind == "msra":
                v = v * math.sqrt(2.0 / _fan_in(shape))
            elif kind == "xavier":
                scale = math.sqrt(3.0 / _fan_in(shape))
                v = v * (2 * scale) - scale
            else:  # uniform
                v = v * (filler["max"] - filler["min"]) + filler["min"]
        if key == "w":  # served in bfloat16
            v = v.to(torch.bfloat16).float()
        params.setdefault(name, {})[key] = v.contiguous()
    return params


def prune_blocks(w2: torch.Tensor, sparsity: float, block, *,
                 keep_one: bool) -> torch.Tensor:
    """Zero the lowest-Frobenius-norm ``sparsity`` share of the (bm, bk)
    blocks of a stack of planes ``w2`` [P, rows, cols] (edge blocks padded
    with zeros for the ranking; norms in float64). ``keep_one`` keeps at
    least one block (a conv's rule)."""
    p, rows, cols = w2.shape
    bm, bk = block
    nbr, nbc = -(-rows // bm), -(-cols // bk)
    padded = torch.zeros((p, nbr * bm, nbc * bk), dtype=torch.float64,
                         device=w2.device)
    padded[:, :rows, :cols] = w2
    norms = padded.view(p, nbr, bm, nbc, bk).square().sum(dim=(2, 4)).sqrt()
    n = norms.numel()
    k = int(round(n * sparsity))
    if keep_one:
        k = min(k, n - 1) if sparsity < 1 else n
    if k <= 0:
        return w2.clone()
    if k >= n:
        return torch.zeros_like(w2)
    thresh = torch.kthvalue(norms.flatten(), k).values
    keep = (norms > thresh).to(w2.dtype)
    mask = keep[:, :, None, :, None].expand(p, nbr, bm, nbc, bk).reshape(
        p, nbr * bm, nbc * bk)[:, :rows, :cols]
    return w2 * mask


def prune_layer(e, w, sparsity: float, block, min_cin: int):
    """One conv's or fc's weight pruned by the rule above, or None where
    the rule leaves it dense."""
    if e["type"] == "conv":
        kh, kw, cin_g, cout = w.shape
        if cin_g < min_cin:
            return None
        return prune_blocks(w.reshape(kh * kw, cin_g, cout), sparsity, block,
                            keep_one=True).reshape(w.shape).contiguous()
    return prune_blocks(w[None], sparsity, block,
                        keep_one=False)[0].contiguous()


def silent_rows(e, w, x) -> torch.Tensor:
    """``w`` with the rows that read an input channel which is zero on
    every calibration image set to zero: training gives such weights no
    gradient, and weight decay takes them to zero. ``x`` is the layer's
    input, NCHW for a conv, [N, K] (NHWC order) for an fc."""
    if e["type"] == "fc":
        if x.dim() == 4:
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return w * (x.abs().amax(dim=0) > 0).to(w.dtype)[:, None]
    kh, kw, cin_g, cout = w.shape
    g = e["group"]
    live = (x.abs().amax(dim=(0, 2, 3)) > 0).to(w.dtype).view(g, cin_g)
    mask = live[torch.arange(cout, device=w.device) // (cout // g)].T
    return w * mask[None, None]

def images(n: int, hwc, g: torch.Generator, device) -> torch.Tensor:
    """``n`` NHWC float32 images at a mean-subtracted pixel scale: a
    smooth field (7x7 normals, bilinearly upsampled) and fine noise, so
    that each image has statistics of its own. Two draws on the device."""
    h, w, c = hwc
    low = torch.randn((n, c, 7, 7), generator=g, device=device)
    fine = torch.randn((n, c, h, w), generator=g, device=device)
    x = F.interpolate(low, size=(h, w), mode="bilinear",
                      align_corners=False) * 48.0 + fine * 16.0
    return x.clamp_(-128.0, 127.0).permute(0, 2, 3, 1).contiguous()


def _pattern(cfg, table, hwc, device):
    """{name: mask of the kept weights} of every pruned layer: the rule
    applied, layer by layer over the calibration images, to the weights of
    the configuration's own ``pattern_seed``."""
    sp = cfg["sparsity"]
    seed = sp["pattern_seed"]
    params = make_params(table, (1,) + hwc, seed, device)
    masks = {}

    def prepare(e, x):
        p = params[e["name"]]
        w = prune_layer(e, silent_rows(e, p["w"], x), sp["share"],
                        tuple(sp["block"]), sp["min_cin"])
        if w is not None:
            p["w"] = w
            masks[e["name"]] = w != 0

    calib = images(CALIBRATION_IMAGES, hwc,
                   generator(seed, CALIBRATION, device), device)
    plain.forward(table, params, calib, calibrate=True, prepare=prepare)
    return masks


def make_net(cfg, arch, seed: int, device):
    """(table, params, pruned names) of a configuration at ``seed``
    (``arch`` is its reference module). Which weights are kept is the
    configuration's own, the same in every run (``_pattern``), so that
    every seed asks the same work of the program; the values are drawn
    from ``seed`` and masked with it, and the BatchNorm statistics are
    those of this net on the seed's calibration images."""
    table = arch.table(cfg["num_classes"])
    hwc = tuple(cfg["input_hwc"])
    masks = _pattern(cfg, table, hwc, device)
    params = make_params(table, (1,) + hwc, seed, device)
    for name, keep in masks.items():
        params[name]["w"] = params[name]["w"] * keep
    calib = images(CALIBRATION_IMAGES, hwc,
                   generator(seed, CALIBRATION, device), device)
    plain.forward(table, params, calib, calibrate=True)
    return table, params, [e["name"] for e in table if e["name"] in masks]
