"""Inference-time graph passes (port of ``caffe_escoin_tpu/nn/fuse.py``: the
fusion passes A and B, the packed-layout pass ``pack_narrow_chains`` and
the space-to-depth stem fold ``fold_stem_s2d``).

* Pass A, affine fold: Conv -> [BatchNorm] -> [Scale] -> [ReLU] chains
  collapse into one conv whose weight and bias absorb the affine
  (w' = w * a, b' = b * a + c, a = gamma / sqrt(var + eps),
  c = beta - mean * a) and whose epilogue applies the ReLU. Zero weights
  stay zero, so the sparsity pattern is unchanged. InnerProduct -> ReLU
  sets ``fuse_relu`` on the fc.
* Pass B, residual fold: Eltwise(sum)(shortcut, conv_out) -> [ReLU]
  collapses into the producing conv (``fuse_add``): the conv takes the
  shortcut as a second bottom and adds it in its epilogue.

* ``pack_narrow_chains``: marks the narrow-channel towers that run on the
  W-pair packed layout (ops/wpack.py).
* ``fold_stem_s2d``: rewrites a strided small-cin stem conv as a stride-1
  conv over the space-to-depth layout (ops/s2d.py).

The order is bench.py's: ``fuse_inference``, then ``fold_stem_s2d``, then
``pack_narrow_chains`` (which leaves s2d convs alone).

The fold arithmetic is numpy float32, as in the JAX package, so both give
the same folded weights. Run before ``weight_align``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from caffe_escoin_tpu_torch.nn.net import LayerSpec, Net
from caffe_escoin_tpu_torch.ops import s2d as s2d_ops
from caffe_escoin_tpu_torch.ops import wpack
from caffe_escoin_tpu_torch.utils import trace

CONV_TYPES = ("Convolution", "ConvolutionReLU")
FOLDABLE_TYPES = CONV_TYPES + ("InnerProduct",)


def _np(t) -> np.ndarray:
    return torch.as_tensor(t).detach().cpu().numpy().astype(np.float32)


def _moving_stats(st: Optional[Dict[str, Any]], cout: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Decayed-sum buffers -> (mean, var); count 0 -> (0, 1)."""
    if st is None:
        return np.zeros(cout, np.float32), np.ones(cout, np.float32)
    mean_acc, var_acc = _np(st["mean_acc"]), _np(st["var_acc"])
    count = float(_np(st["count"]))
    if count > 0:
        return mean_acc / count, var_acc / count
    return np.zeros_like(mean_acc), np.ones_like(var_acc)


def _final_tops(specs) -> set:
    consumed = {b for s in specs for b in s.bottoms}
    return {t for s in specs for t in s.tops if t not in consumed}


def _consumers(specs) -> Dict[str, list]:
    out: Dict[str, list] = {}
    for i, s in enumerate(specs):
        for b in s.bottoms:
            out.setdefault(b, []).append(i)
    return out


def _fold_affine(net: Net, specs, params, state, finals):
    """Pass A. Returns (specs, params)."""
    consumers = _consumers(specs)
    removed: set = set()
    replaced: Dict[int, LayerSpec] = {}
    for i, s in enumerate(specs):
        if s.type not in FOLDABLE_TYPES or i in removed:
            continue
        p = params.get(s.name)
        if not isinstance(p, dict) or "w" not in p:
            continue  # already aligned: leave alone
        cout = p["w"].shape[-1]
        a = np.ones(cout, np.float32)
        c = np.zeros(cout, np.float32)
        affine = False
        fuse_relu = bool(s.type == "ConvolutionReLU" or s.params.get("fuse_relu"))
        top = s.tops[0]
        chain = []
        while True:
            cons = consumers.get(top, [])
            if len(cons) != 1 or top in finals:
                break
            j = cons[0]
            nxt = specs[j]
            if j in removed or fuse_relu:
                break
            if nxt.type == "BatchNorm":
                use_global = nxt.params.get("use_global_stats")
                if use_global is None:
                    use_global = net.phase == "test"
                if not use_global:
                    break
                eps = nxt.params.get("eps", 1e-5)
                mean, var = _moving_stats(state.get(nxt.name), cout)
                inv = 1.0 / np.sqrt(var + eps)
                a = a * inv
                c = (c - mean) * inv
                affine = True
            elif nxt.type == "Scale":
                sp = params.get(nxt.name, {})
                gamma = _np(sp["gamma"]) if "gamma" in sp \
                    else np.ones(cout, np.float32)
                a = a * gamma
                c = c * gamma
                if "beta" in sp:
                    c = c + _np(sp["beta"])
                affine = True
                params.pop(nxt.name, None)
            elif (nxt.type == "ReLU"
                  and nxt.params.get("negative_slope", 0.0) == 0.0):
                fuse_relu = True
            else:
                break
            chain.append(j)
            top = nxt.tops[0]
            if fuse_relu:
                break
        if not chain:
            continue
        q = dict(p)
        if affine:
            q["w"] = torch.from_numpy(_np(p["w"]) * a)
            b0 = _np(p["b"]) if "b" in p else 0.0
            q["b"] = torch.from_numpy(np.asarray(b0 * a + c, np.float32))
        params[s.name] = q
        sp_params = dict(s.params)
        if affine:
            sp_params["bias_term"] = True
        if fuse_relu:
            sp_params["fuse_relu"] = True
        replaced[i] = dataclasses.replace(s, tops=(top,), params=sp_params)
        removed.update(chain)
    return [replaced.get(i, s) for i, s in enumerate(specs)
            if i not in removed], params


def _fold_residual(specs, finals):
    """Pass B. Returns specs."""
    producer = {t: i for i, s in enumerate(specs) for t in s.tops}
    consumers = _consumers(specs)
    removed: set = set()
    replaced: Dict[int, LayerSpec] = {}
    for i, s in enumerate(specs):
        if (s.type != "Eltwise" or i in removed
                or s.params.get("operation", "sum") != "sum"
                or len(s.bottoms) != 2):
            continue
        coeffs = s.params.get("coeffs")
        if coeffs is not None and any(cf != 1.0 for cf in coeffs):
            continue
        # the LATER conv producer among the two bottoms (the residual branch
        # tail) whose top feeds only this Eltwise; the other bottom becomes
        # the fused add input
        best = None
        for pos, b in enumerate(s.bottoms):
            ci = producer.get(b)
            if ci is None or ci in removed or ci in replaced:
                continue
            pc = specs[ci]
            if (pc.type not in CONV_TYPES or len(pc.bottoms) != 1
                    or pc.params.get("fuse_relu")
                    or pc.params.get("fuse_add")):
                continue
            if consumers.get(b, []) != [i] or b in finals:
                continue
            other = s.bottoms[1 - pos]
            if producer.get(other, -1) >= ci:
                continue  # the shortcut must exist before the conv runs
            if best is None or ci > best[0]:
                best = (ci, other)
        if best is None:
            continue
        ci, other = best
        pc = specs[ci]
        top = s.tops[0]
        relu = False
        cons = consumers.get(top, [])
        if len(cons) == 1 and top not in finals:
            nxt = specs[cons[0]]
            if (nxt.type == "ReLU"
                    and nxt.params.get("negative_slope", 0.0) == 0.0):
                relu = True
                removed.add(cons[0])
                top = nxt.tops[0]
        sp_params = dict(pc.params)
        sp_params["fuse_add"] = True
        if relu:
            sp_params["fuse_relu"] = True
        replaced[ci] = dataclasses.replace(
            pc, bottoms=(pc.bottoms[0], other), tops=(top,), params=sp_params)
        removed.add(i)
    return [replaced.get(i, s) for i, s in enumerate(specs) if i not in removed]


def fuse_inference(net: Net, params: Dict[str, Any],
                   state: Optional[Dict[str, Any]] = None
                   ) -> Tuple[Net, Dict[str, Any]]:
    """Returns (fused_net, fused_params). ``state`` supplies the BatchNorm
    moving statistics (default ``net.state0``). A set-up span,
    ``setup:fuse``."""
    if state is None:
        state = net.state0
    with trace.span("setup:fuse", always=True):
        specs = list(net.specs)
        finals = _final_tops(specs)
        specs, new_params = _fold_affine(net, specs, dict(params), state,
                                         finals)
        specs = _fold_residual(specs, finals)
        fused = Net(specs, policy=net.policy, phase=net.phase,
                    device=net.device)
        names = {s.name for s in specs}
        # carry the state of BatchNorm layers that did not fold
        fused.state0 = {k: v for k, v in state.items() if k in names}
        fused.blob_shapes = dict(net.blob_shapes)
    return fused, new_params


def _wdim(s: LayerSpec, key: str, default: int) -> int:
    """The W entry of a spec's scalar or per-dimension parameter."""
    v = s.params.get(key, default)
    return int(v[-1]) if isinstance(v, (tuple, list)) else int(v)


def _pool_geom(s: LayerSpec):
    """(kernel_w, stride_w) of a Pooling spec (Caffe defaults)."""
    k = _wdim(s, "kernel", 2)
    return k, _wdim(s, "stride", k)


def _conv_geom(s: LayerSpec):
    """(kernel_w, stride_w, dilation_w, groups) of a 2-D conv spec."""
    return (_wdim(s, "kernel", 3), _wdim(s, "stride", 1),
            _wdim(s, "dilation", 1), int(s.params.get("group", 1)))


def pack_narrow_chains(net: Net, *, lanes: int = 128) -> Net:
    """W-pair packed-layout pass (ops/wpack.py; the JAX package's
    ``nn/fuse.py:269-473``, the same fixpoint): finds maximal subgraphs
    where r adjacent W-pixels ride the channel dimension, with pack and
    unpack folded into the boundary layers, so no retile pass runs:

    * seeds: interior 4-D blobs with pack_factor(C, W) > 1;
    * producers: convs emit packed via ``repack_weight`` (any stride), max
      and average pools via ``pool2d_packed``;
    * consumers: convs consume packed when the packed stride
      sw*r_out/r_in is integral, so strided stage-boundary convs end
      chains (e.g. a 1x1/s2 consumer of an r=2 blob);
    * residual (fuse_add) second bottoms must match the conv's output
      layout, which grows the packed set across whole residual stages;
    * blobs whose layout cannot be closed (pooling, concat or loss
      consumers, final tops, more than 512 packed channels) are dropped,
      and the constraints solved again, to a fixpoint.

    Runs after ``fuse_inference`` (it keys on fuse_add residual bottoms)
    and reads ``net.blob_shapes``. Params are untouched: the layers repack
    their logical weights when they align or run, so params stay in the
    public layout. Returns a new net with ``packed_blobs`` (blob -> r) and
    packed ``blob_shapes``, or ``net`` itself when nothing packs.

    An LRN layer is layout-transparent per (pixel, channel window): it
    passes a packed blob on at the same factor and normalizes each phase's
    channel block on its own (``pack_in``). Space-to-depth stems
    (``s2d_r``) keep their own layout. Layers that share params are
    refused, as in the JAX pass. Packing on the card is not a default: the JAX
    package packs for TPU lane padding, which a GPU does not have."""
    specs = list(net.specs)
    shapes: Dict[str, Tuple[int, ...]] = dict(net.blob_shapes)
    if not shapes:
        return net  # no shape information: nothing to do
    finals = _final_tops(specs)
    producer: Dict[str, int] = {}
    consumers = _consumers(specs)
    for i, s in enumerate(specs):
        for t in s.tops:
            producer[t] = i

    # params shared across layers cannot repack: align() is per layer and
    # the sharing twin may run unpacked geometry on the same weights
    share_targets = {s.share_params for s in specs if s.share_params}

    def markable(b, r):
        shp = shapes.get(b)
        return (b in producer and b not in finals and shp is not None
                and len(shp) == 4 and shp[2] % r == 0
                and shp[3] * r <= 512)  # keep packed lanes a sane width

    packed: Dict[str, int] = {}
    for b, shp in shapes.items():
        if b in producer and b not in finals and len(shp) == 4:
            r = wpack.pack_factor(shp[3], shp[2], lanes=lanes)
            if r > 1:
                packed[b] = r

    dead: set = set()

    def conv_ok(s):
        if s.params.get("s2d_r"):
            return False  # s2d stem convs keep their own layout
        if len(shapes.get(s.bottoms[0], ())) != 4:
            return False
        if s.share_params is not None or s.name in share_targets:
            return False
        _, _, dil, g = _conv_geom(s)
        return dil == 1 and g == 1

    def pool_ok(s):
        p = s.params
        return (not p.get("global_pooling")
                and p.get("mode", "max") in ("max", "avg"))

    def check(b, r):
        """(ok, [(blob, required_r), ...]) for blob b packed at r."""
        needs = []
        if not markable(b, r):
            return False, needs
        ps = specs[producer[b]]
        if ps.type in CONV_TYPES:
            if not conv_ok(ps):
                return False, needs
            _, sw, _, _ = _conv_geom(ps)
            if (sw * r) % packed.get(ps.bottoms[0], 1) != 0:
                return False, needs
            if len(ps.bottoms) > 1:  # a fuse_add residual rides the output
                if not ps.params.get("fuse_add"):
                    return False, needs
                needs.append((ps.bottoms[1], r))
        elif ps.type == "Pooling":
            if not pool_ok(ps):
                return False, needs
            _, sw = _pool_geom(ps)
            if (sw * r) % packed.get(ps.bottoms[0], 1) != 0:
                return False, needs
        elif ps.type == "LRN":
            # layout-transparent per (pixel, channel window)
            needs.append((ps.bottoms[0], r))
        else:
            return False, needs
        for ci in consumers.get(b, []):
            cs = specs[ci]
            if cs.type in CONV_TYPES:
                if not conv_ok(cs):
                    return False, needs
                _, sw, _, _ = _conv_geom(cs)
                if cs.bottoms[0] == b:
                    r_out = packed.get(cs.tops[0], 1)
                    if (sw * r_out) % r != 0:
                        needs.append((cs.tops[0], r // math.gcd(sw, r)))
                if len(cs.bottoms) > 1 and cs.bottoms[1] == b:
                    if not cs.params.get("fuse_add"):
                        return False, needs
                    needs.append((cs.tops[0], r))
            elif cs.type == "Pooling":
                if not pool_ok(cs):
                    return False, needs
                _, sw = _pool_geom(cs)
                r_out = packed.get(cs.tops[0], 1)
                if (sw * r_out) % r != 0:
                    # a packed-output pool needs its own top markable
                    needs.append((cs.tops[0], r // math.gcd(sw, r)))
            elif cs.type == "LRN":
                needs.append((cs.tops[0], r))
            else:
                return False, needs
        return True, needs

    stable = False
    while not stable:
        stable = True
        for b in sorted(packed):
            r = packed[b]
            ok, needs = check(b, r)
            if ok:
                for nb, nr in needs:
                    cur = packed.get(nb)
                    if cur == nr:
                        continue
                    if nb in dead or cur is not None or not markable(nb, nr):
                        ok = False
                        break
                    packed[nb] = nr
                    stable = False
            if not ok:
                del packed[b]
                dead.add(b)
                stable = False

    if not packed:
        return net

    new_specs = []
    for s in specs:
        r_in = packed.get(s.bottoms[0], 1) if s.bottoms else 1
        r_out = packed.get(s.tops[0], 1)
        if s.type in CONV_TYPES and (r_in > 1 or r_out > 1):
            s = dataclasses.replace(s, params=dict(
                s.params, pack_in=r_in, pack_out=r_out,
                pack_w=int(shapes[s.bottoms[0]][2])))
        elif s.type == "Pooling" and (r_in > 1 or r_out > 1):
            s = dataclasses.replace(s, params=dict(s.params, pack_in=r_in,
                                                   pack_out=r_out))
        elif s.type == "LRN" and r_in > 1:
            s = dataclasses.replace(s, params=dict(s.params, pack_in=r_in))
        new_specs.append(s)

    out = Net(new_specs, policy=net.policy, phase=net.phase,
              device=net.device)
    out.state0 = net.state0
    out.blob_shapes = {
        b: ((shp[0], shp[1], shp[2] // packed[b], shp[3] * packed[b])
            if b in packed and len(shp) == 4 else shp)
        for b, shp in shapes.items()}
    out.packed_blobs = dict(packed)
    return out


# a stem folds only while its s2d input, cin*r^2 channels, stays this narrow
# (the JAX package's rule: GoogLeNet's 3-channel stride-2 stem gives 12)
_S2D_MAX_LANES = 128


def fold_stem_s2d(net: Net, params: Dict[str, Any]
                  ) -> Tuple[Net, Dict[str, Any]]:
    """Space-to-depth reformulation of the stem conv (ops/s2d.py; the JAX
    package's ``nn/fuse.py:476-548``, the same eligibility rule).

    Rewrites every 2-D conv whose bottom is a net input, with a square
    stride r >= 2, dilation 1, group 1 and cin*r^2 <= ``_S2D_MAX_LANES``,
    to run at stride 1 over the [N, H/r, W/r, r*r*C] space-to-depth layout: the
    weight is remapped tap by tap (``s2d_weight``, zero structure kept),
    the spec's kernel, stride and pad become the remapped kernel's, and
    ``s2d_r``/``s2d_kernel``/``s2d_pad`` tell ``ConvolutionLayer`` to
    transform its input. Exact for every kernel size: the grid is padded
    or cropped to the strided conv's output size (ops/s2d.py), so a stem
    with k <= r folds too.

    Runs after ``fuse_inference`` (on folded dense weights) and before
    ``pack_narrow_chains``. Returns the folded net and params (the stem's
    weight remapped, the rest shared), or the arguments themselves when
    nothing folds."""
    specs = list(net.specs)
    produced = {t for s in specs for t in s.tops}
    new_params = dict(params)
    out_specs: list = []
    n_folded = 0
    for s in specs:
        prm = s.params
        if (s.type not in CONV_TYPES or not s.bottoms
                or s.bottoms[0] in produced
                or s.share_params is not None
                or prm.get("s2d_r") or prm.get("pack_in")
                or prm.get("pack_out") or prm.get("fuse_add")):
            out_specs.append(s)
            continue
        p = new_params.get(s.name)
        if not isinstance(p, dict) or "w" not in p or p["w"].ndim != 4:
            out_specs.append(s)
            continue
        cin = p["w"].shape[2]

        def dim(key, default, i):
            v = prm.get(key, default)
            return int(v[i]) if isinstance(v, (tuple, list)) else int(v)

        sh, sw = dim("stride", 1, 0), dim("stride", 1, -1)
        ph, pw = dim("pad", 0, 0), dim("pad", 0, -1)
        if (sh != sw or sh < 2 or dim("dilation", 1, 0) != 1
                or dim("dilation", 1, -1) != 1
                or int(prm.get("group", 1)) != 1
                or cin * sh * sh > _S2D_MAX_LANES):
            out_specs.append(s)
            continue
        kh, kw = p["w"].shape[:2]
        wp = s2d_ops.s2d_weight(_np(p["w"]), sh, (ph, pw))
        new_params[s.name] = dict(p, w=torch.from_numpy(wp))
        out_specs.append(dataclasses.replace(s, params=dict(
            prm, kernel=[wp.shape[0], wp.shape[1]], stride=1, pad=0,
            s2d_r=sh, s2d_kernel=[int(kh), int(kw)], s2d_pad=[ph, pw])))
        n_folded += 1
    if not n_folded:
        return net, params
    out = Net(out_specs, policy=net.policy, phase=net.phase,
              device=net.device)
    out.state0 = net.state0
    out.blob_shapes = dict(net.blob_shapes)
    return out, new_params
