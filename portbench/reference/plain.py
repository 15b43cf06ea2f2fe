"""The plain forward that every architecture's table runs on.

A table is a list of layer entries (dicts), in order, each naming its
bottom blob(s) and its top. The input blob is ``data``, NHWC, as the
program takes it; inside, activations are NCHW float32 and every conv and
fc is one ``F.conv2d`` / matmul with TF32 off. Nothing here imports the
program: the tables, the shapes and the arithmetic are this benchmark's
own, written from the published descriptions.

Entry types and their keys:

* ``conv``: ``bottom``, ``top``, ``cout``, ``kernel``, ``stride``, ``pad``,
  ``group`` (1), ``bias`` (bool), ``bn`` (bool: Caffe's BatchNorm at its
  stored statistics, then Scale, eps 1e-5), ``residual`` (a blob added
  after the BatchNorm, or None), ``relu`` (after all of that), and the
  fillers ``weight_filler`` / ``bias_filler``;
* ``fc``: ``bottom``, ``top``, ``cout``, ``bias``, ``relu``, fillers; its
  input is flattened in NHWC order (channels fastest), the weight is
  [K, M];
* ``max_pool``: ``kernel``, ``stride``, ``pad``, Caffe's ceil-mode size;
* ``avg_pool_global``: the mean over the whole map;
* ``lrn``: ``size``, ``alpha``, ``beta``, ``k``, Caffe's ACROSS_CHANNELS
  (alpha divided by the window size);
* ``concat``: ``bottoms``, joined along the channels.

Params (one dict per conv and fc): ``w`` ([KH, KW, Cin/group, Cout] for a
conv), ``b``, and with ``bn`` the raw statistics ``mean`` and ``var`` and
the Scale's ``gamma`` and ``beta``.

``precision`` rounds each conv's and fc's input and weight before the
product (accumulation stays float32): ``float32`` is the reference,
``bfloat16`` a witness, ``float8_e4m3fn`` the control (per-tensor scale to
the format's largest value, 448).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
PRECISIONS = ("float32", "bfloat16", "float8_e4m3fn")
_FP8_MAX = 448.0


def conv(name, bottom, cout, kernel, *, stride=1, pad=0, group=1, bias=True,
         bn=False, residual=None, relu=True, weight_filler=None,
         bias_filler=None, top=None):
    return dict(type="conv", name=name, bottom=bottom, top=top or name,
                cout=cout, kernel=kernel, stride=stride, pad=pad, group=group,
                bias=bias, bn=bn, residual=residual, relu=relu,
                weight_filler=weight_filler or {"type": "xavier"},
                bias_filler=bias_filler or {"type": "constant", "value": 0.0})


def fc(name, bottom, cout, *, bias=True, relu=False, weight_filler=None,
       bias_filler=None, top=None):
    return dict(type="fc", name=name, bottom=bottom, top=top or name,
                cout=cout, bias=bias, relu=relu,
                weight_filler=weight_filler or {"type": "xavier"},
                bias_filler=bias_filler or {"type": "constant", "value": 0.0})


def max_pool(name, bottom, kernel, stride, pad=0, top=None):
    return dict(type="max_pool", name=name, bottom=bottom, top=top or name,
                kernel=kernel, stride=stride, pad=pad)


def avg_pool_global(name, bottom, top=None):
    return dict(type="avg_pool_global", name=name, bottom=bottom,
                top=top or name)


def lrn(name, bottom, size=5, alpha=1e-4, beta=0.75, k=1.0, top=None):
    return dict(type="lrn", name=name, bottom=bottom, top=top or name,
                size=size, alpha=alpha, beta=beta, k=k)


def concat(name, bottoms, top=None):
    return dict(type="concat", name=name, bottoms=list(bottoms),
                top=top or name)


def bottoms_of(entry) -> List[str]:
    return list(entry["bottoms"]) if "bottoms" in entry else (
        [entry["bottom"]] + ([entry["residual"]] if entry.get("residual")
                             else []))


def pooled_size(size, k, s, p):
    """Caffe's ceil-mode pooled size; the last window starts inside."""
    out = int(math.ceil((size + 2 * p - k) / s)) + 1
    if p > 0 and (out - 1) * s >= size + p:
        out -= 1
    return out


def shapes(table, data_shape) -> Dict[str, tuple]:
    """Every blob's NHWC shape for an NHWC ``data_shape``, from the table
    alone."""
    out = {"data": tuple(data_shape)}
    for e in table:
        t = e["type"]
        if t == "conv":
            n, h, w, _ = out[e["bottom"]]
            k, s, p = e["kernel"], e["stride"], e["pad"]
            out[e["top"]] = (n, (h + 2 * p - k) // s + 1,
                             (w + 2 * p - k) // s + 1, e["cout"])
        elif t == "fc":
            out[e["top"]] = (out[e["bottom"]][0], e["cout"])
        elif t == "max_pool":
            n, h, w, c = out[e["bottom"]]
            k, s, p = e["kernel"], e["stride"], e["pad"]
            out[e["top"]] = (n, pooled_size(h, k, s, p),
                             pooled_size(w, k, s, p), c)
        elif t == "avg_pool_global":
            n, _, _, c = out[e["bottom"]]
            out[e["top"]] = (n, 1, 1, c)
        elif t == "lrn":
            out[e["top"]] = out[e["bottom"]]
        elif t == "concat":
            first = out[e["bottoms"][0]]
            out[e["top"]] = first[:-1] + (
                sum(out[b][-1] for b in e["bottoms"]),)
        else:
            raise ValueError(f"unknown entry type {t!r} ({e['name']})")
    return out


def weight_shapes(table, data_shape) -> Dict[str, Dict[str, tuple]]:
    """name -> {"w": shape, "b": shape?} of every conv and fc."""
    blob = shapes(table, data_shape)
    out = {}
    for e in table:
        if e["type"] == "conv":
            cin = blob[e["bottom"]][-1]
            out[e["name"]] = {"w": (e["kernel"], e["kernel"],
                                    cin // e["group"], e["cout"])}
        elif e["type"] == "fc":
            k = math.prod(blob[e["bottom"]][1:])
            out[e["name"]] = {"w": (k, e["cout"])}
        else:
            continue
        if e["bias"]:
            out[e["name"]]["b"] = (e["cout"],)
    return out


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for the block, then restored."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rounder(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The rounding a product's operands get at ``precision``."""
    if precision == "float32":
        return lambda t: t
    if precision == "bfloat16":
        return lambda t: t.to(torch.bfloat16).float()
    if precision == "float8_e4m3fn":
        def fp8(t):
            scale = t.abs().amax().clamp_min(1e-30) / _FP8_MAX
            return (t / scale).to(torch.float8_e4m3fn).float() * scale
        return fp8
    raise ValueError(f"unknown precision {precision!r} (one of {PRECISIONS})")


def _batch_stats(y: torch.Tensor):
    """A conv output's per-channel mean and biased variance over a batch,
    the variance held at least a tenth of the median live channel's: a
    pruned net has channels that are constant over every input (fed only
    by channels that no live block reaches), and a variance of rounding
    noise would scale that noise up by 1/sqrt(eps), which no trained
    net's statistics do."""
    mean = y.mean(dim=(0, 2, 3))
    var = y.var(dim=(0, 2, 3), unbiased=False)
    live = var[var > 0]
    floor = 0.1 * (live.median() if live.numel() else torch.ones((),
                   device=var.device))
    return mean, torch.maximum(var, floor)


def _last_use(table) -> Dict[str, int]:
    last = {}
    for i, e in enumerate(table):
        for b in bottoms_of(e):
            last[b] = i
    return last


def forward(table, params, x, *, outputs=(), precision="float32",
            calibrate=False, prepare=None) -> Dict[str, torch.Tensor]:
    """Run the table on ``x`` (NHWC float32); returns the blobs named in
    ``outputs`` (NCHW blobs back in NHWC, fc outputs as [N, M]).

    ``calibrate=True`` sets each BatchNorm's ``mean`` and ``var`` in
    ``params`` to the batch's own statistics (biased variance) before
    applying them: how the benchmark gives a seeded net the statistics a
    trained one has. ``prepare(entry, x)``, where given, is called before
    each conv and fc with its NCHW (or [N, K]) input, and may set the
    layer's params."""
    q = rounder(precision)
    keep = set(outputs)
    last = _last_use(table)
    blobs = {"data": x.float().permute(0, 3, 1, 2)}
    with no_tf32(), torch.no_grad():
        for i, e in enumerate(table):
            t = e["type"]
            if prepare is not None and t in ("conv", "fc"):
                prepare(e, blobs[e["bottom"]])
            if t == "conv":
                p = params[e["name"]]
                w = p["w"].float().permute(3, 2, 0, 1)
                y = F.conv2d(q(blobs[e["bottom"]]), q(w), None,
                             stride=e["stride"], padding=e["pad"],
                             groups=e["group"])
                if e["bias"]:
                    y = y + p["b"].float().view(1, -1, 1, 1)
                if e["bn"]:
                    if calibrate:
                        p["mean"], p["var"] = _batch_stats(y)
                    inv = torch.rsqrt(p["var"].float() + BN_EPS)
                    y = ((y - p["mean"].float().view(1, -1, 1, 1))
                         * (inv * p["gamma"].float()).view(1, -1, 1, 1)
                         + p["beta"].float().view(1, -1, 1, 1))
                if e["residual"]:
                    y = y + blobs[e["residual"]]
                if e["relu"]:
                    y = torch.relu(y)
            elif t == "fc":
                p = params[e["name"]]
                xin = blobs[e["bottom"]]
                if xin.dim() == 4:  # flatten in NHWC order
                    xin = xin.permute(0, 2, 3, 1).reshape(xin.shape[0], -1)
                y = q(xin) @ q(p["w"].float())
                if e["bias"]:
                    y = y + p["b"].float()
                if e["relu"]:
                    y = torch.relu(y)
            elif t == "max_pool":
                y = F.max_pool2d(blobs[e["bottom"]], e["kernel"], e["stride"],
                                 e["pad"], ceil_mode=True)
            elif t == "avg_pool_global":
                y = blobs[e["bottom"]].mean(dim=(2, 3), keepdim=True)
            elif t == "lrn":
                xin = blobs[e["bottom"]]
                half = e["size"] // 2
                sq = F.pad(xin * xin, (0, 0, 0, 0, half,
                                       e["size"] - 1 - half))
                c = xin.shape[1]
                window = sum(sq[:, j:j + c] for j in range(e["size"]))
                y = xin * (e["k"] + e["alpha"] / e["size"] * window
                           ) ** (-e["beta"])
            elif t == "concat":
                y = torch.cat([blobs[b] for b in e["bottoms"]], dim=1)
            else:
                raise ValueError(f"unknown entry type {t!r} ({e['name']})")
            blobs[e["top"]] = y
            for b in bottoms_of(e):
                if last.get(b) == i and b not in keep:
                    blobs.pop(b, None)
    out = {}
    for name in outputs:
        y = blobs[name]
        out[name] = y.permute(0, 2, 3, 1) if y.dim() == 4 else y
    return out


def forward_chunked(table, params, x, output: str, *, chunk: int = 16,
                    precision="float32") -> torch.Tensor:
    """``forward``'s ``output`` blob over ``x`` in blocks of ``chunk``
    images, so that a large batch fits."""
    parts = [forward(table, params, x[i:i + chunk], outputs=(output,),
                     precision=precision)[output]
             for i in range(0, x.shape[0], chunk)]
    return torch.cat(parts)
