"""The system under test, and what may stand in its place.

``PortSystem`` is the program: ``caffe_escoin_tpu_torch``'s net for the
configuration (its model zoo's layer specs, its execution policy), given
the benchmark's weights as its params dict and BatchNorm state, and set
up by the program itself: ``fuse_inference``, ``weight_align``, the move
to the card in the compute dtype, and ``Net.inference_fn(cuda_graph=
True)``, which runs the first call eagerly and captures the forward.
Set-up fails where the configuration names the ELL format and the
program would not run every pruned conv on it (``check_routes``).
A query hands it one input batch and copies the classifier's logits to
host memory, as a user's loop does.

``ReferenceSystem`` puts the plain reference in the program's place at a
given precision: the control (float8) and a witness (bfloat16).
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import sys
from typing import Dict, Tuple

import torch

from portbench.reference import plain


def _producers(specs) -> Dict[str, object]:
    return {t: s for s in specs for t in s.tops}


def port_params(net, table, params) -> Tuple[dict, dict]:
    """(params, BatchNorm state) in the program's format, keyed by its
    layer names: a conv's or fc's ``w`` / ``b`` by name; a BatchNorm's
    statistics and a Scale's gamma / beta from the conv they follow
    (found through the specs' bottoms, whatever the layers are called).
    Raises where the program's net and the table disagree on a layer."""
    by_name = {e["name"]: e for e in table if e["type"] in ("conv", "fc")}
    producers = _producers(net.specs)
    out, state, seen = {}, {}, set()

    def conv_before(spec):
        prod = producers.get(spec.bottoms[0])
        while prod is not None and prod.type == "BatchNorm":
            prod = producers.get(prod.bottoms[0])
        if prod is None or prod.name not in by_name:
            raise KeyError(f"{spec.name}: no conv of the reference before it")
        return by_name[prod.name]

    for layer in net.layers:
        spec = layer.spec
        if spec.type in ("Convolution", "ConvolutionReLU", "InnerProduct"):
            e = by_name.get(spec.name)
            if e is None:
                raise KeyError(f"the reference has no layer {spec.name!r}")
            has_bias = spec.params.get("bias_term", True)
            if has_bias != e["bias"]:
                raise ValueError(f"{spec.name}: bias {has_bias} in the "
                                 f"program, {e['bias']} in the reference")
            p = params[spec.name]
            out[spec.name] = {"w": p["w"], **({"b": p["b"]} if has_bias
                                             else {})}
            seen.add(spec.name)
        elif spec.type == "BatchNorm":
            p = params[conv_before(spec)["name"]]
            state[spec.name] = {"mean_acc": p["mean"], "var_acc": p["var"],
                                "count": torch.ones((), device=p["mean"].device)}
        elif spec.type == "Scale":
            p = params[conv_before(spec)["name"]]
            out[spec.name] = {"gamma": p["gamma"], "beta": p["beta"]}
    missing = set(by_name) - seen
    if missing:
        raise KeyError(f"the program's net lacks {sorted(missing)[:5]}")
    return out, state


def port_policy(policy: dict):
    """The program's ``ExecutionPolicy`` as a configuration's ``policy``
    states it: every field whose default is an enum member (``conv_mode``,
    ``sparse_format``) converted by member name, ``block_shape`` to a
    tuple, ``compute_dtype`` by torch's name; the rest as written. A name
    that is no member, or a value that is no name, fails with its key: the
    policy is frozen and coerces nothing, so a string passed through would
    compare unequal to every member and quietly run another route."""
    from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy

    kw = dict(policy)
    for f in dataclasses.fields(ExecutionPolicy):
        if f.name not in kw or not isinstance(f.default, enum.Enum):
            continue
        kind, name = type(f.default), kw[f.name]
        if not isinstance(name, str) or name not in kind.__members__:
            raise ValueError(f"policy {f.name}: {name!r} is none of "
                             f"{kind.__name__}'s {list(kind.__members__)}")
        kw[f.name] = kind[name]
    kw["block_shape"] = tuple(kw["block_shape"])
    if kw.get("compute_dtype"):
        dtype = getattr(torch, str(kw["compute_dtype"]), None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"policy compute_dtype: {kw['compute_dtype']!r} "
                             f"is no torch dtype")
        kw["compute_dtype"] = dtype
    return ExecutionPolicy(**kw)


def check_routes(cfg, net, aligned, table, params) -> None:
    """Where the configuration's policy names the ELL format, fails set-up
    naming the first pruned conv (a conv of the table whose weight holds a
    zero) that the program's net does not route ``ell``, and logs the
    routes' counts (``Net.routes``, from shapes alone: the route of a conv
    under ELL does not depend on the batch)."""
    if cfg["policy"].get("sparse_format") != "ELL":
        return
    routes = net.routes(aligned, {"data": (1,) + tuple(cfg["input_hwc"])})
    counted = collections.Counter(routes.values())
    print("routes: " + ", ".join(f"{r} {n}" for r, n in sorted(
        counted.items())), file=sys.stderr, flush=True)
    for e in table:
        if e["type"] == "conv" and bool((params[e["name"]]["w"] == 0).any()) \
                and routes.get(e["name"]) != "ell":
            raise RuntimeError(
                f"{e['name']}: the program routes this pruned conv "
                f"{routes.get(e['name'])!r}, where the configuration's "
                f"sparse_format ELL names 'ell'")


class PortSystem:
    """The program's forward for one configuration."""

    def __init__(self, cfg, table, params, device):
        from caffe_escoin_tpu_torch.models import ZOO
        from caffe_escoin_tpu_torch.nn import Net, fuse_inference, params_to

        policy = port_policy(cfg["policy"])
        specs = ZOO[cfg["port_model"]][0](num_classes=cfg["num_classes"])
        net = Net(specs, policy=policy, phase="test")
        pp, state = port_params(net, table, params)
        if cfg.get("fuse", True):
            net, pp = fuse_inference(net, pp, state=state)
        else:
            net.state0 = state
        aligned = net.weight_align(pp)
        self.net = net
        self.aligned = params_to(aligned, device, policy.compute_dtype)
        net.state0 = params_to(net.state0, device)
        self.blob = cfg["logits"]
        self.fn = net.inference_fn(self.aligned, cuda_graph=True,
                                   return_blobs=True)
        check_routes(cfg, net, self.aligned, table, params)

    def issue(self, x):
        """Hand one batch to the entry; returns its output blobs."""
        return self.fn({"data": x})

    def logits(self, out) -> torch.Tensor:
        """The classifier's logits among ``issue``'s outputs, where they
        lie."""
        return out[self.blob]

    def to_host(self, out) -> torch.Tensor:
        return self.logits(out).cpu()

    def query(self, x) -> torch.Tensor:
        return self.to_host(self.issue(x))

    def eager_forward(self, x, layer_hook=None):
        """One eager forward through ``Net.forward``, each layer handed to
        ``layer_hook`` (the program's public seam)."""
        with torch.inference_mode():
            return self.net.forward(self.aligned, {"data": x},
                                    layer_hook=layer_hook)

    def close(self):
        self.fn = self.aligned = self.net = None


class ReferenceSystem:
    """The plain reference in the program's place, at ``precision``."""

    def __init__(self, cfg, table, params, device, precision: str):
        self.table, self.params = table, params
        self.blob, self.precision = cfg["logits"], precision
        self.net = None

    def issue(self, x):
        return plain.forward(self.table, self.params, x,
                             outputs=(self.blob,), precision=self.precision)

    def logits(self, out) -> torch.Tensor:
        """The classifier's logits among ``issue``'s outputs, where they
        lie."""
        return out[self.blob]

    def to_host(self, out) -> torch.Tensor:
        return self.logits(out).cpu()

    def query(self, x) -> torch.Tensor:
        return self.to_host(self.issue(x))

    def eager_forward(self, x, layer_hook=None):
        return self.issue(x)

    def close(self):
        self.params = None
