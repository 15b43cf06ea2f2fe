"""Graph runtime: LayerSpec / layer registry / Net (port of
``caffe_escoin_tpu/nn/net.py``, inference only).

``Net`` is an ``nn.Module`` over a LayerSpec list. Parameters are not
registered on the modules: like the JAX package, the net takes them as an
argument (``forward(params, inputs)``, also named ``apply``), because they
pass through host-side transforms (pruning, ``fuse_inference``,
``weight_align``) as plain dicts before they run. BatchNorm moving
statistics live in a separate ``state`` dict.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from caffe_escoin_tpu_torch.engine.context import ExecutionPolicy
from caffe_escoin_tpu_torch.sparse.weight_align import AlignedConvWeight


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    name: str
    type: str
    bottoms: Tuple[str, ...] = ()
    tops: Tuple[str, ...] = ()
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    phase: Optional[str] = None  # "train" | "test" | None (both)

    def __post_init__(self):
        object.__setattr__(self, "bottoms", tuple(self.bottoms))
        tops = tuple(self.tops) if self.tops else (self.name,)
        object.__setattr__(self, "tops", tops)


LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(type_name: str):
    def deco(cls):
        if type_name in LAYER_REGISTRY:
            raise ValueError(f"duplicate layer type {type_name!r}")
        LAYER_REGISTRY[type_name] = cls
        cls.type_name = type_name
        return cls

    return deco


class Layer(torch.nn.Module):
    """Base layer: init_params (SetUp) / forward / align (WeightAlign)."""

    type_name = "?"
    has_state = False  # BatchNorm's moving statistics

    def __init__(self, spec: LayerSpec, policy: ExecutionPolicy):
        super().__init__()
        self.spec = spec
        self.policy = policy
        self.p = dict(spec.params)

    def init_params(self, gen: torch.Generator, in_shapes):
        return {}

    def init_state(self, in_shapes):
        return {}

    def align(self, params):
        """Host-side sparse compile; default no-op."""
        return params

    def out_shapes(self, in_shapes) -> List[Tuple[int, ...]]:
        return [tuple(in_shapes[0])]

    def route(self, params, in_shapes, in_dtype) -> Optional[str]:
        """The kernel route a conv or fc layer takes; None for the rest."""
        return None

    def forward(self, params, inputs: List[torch.Tensor], state=None):
        raise NotImplementedError


def params_to(params, device, dtype: Optional[torch.dtype] = None):
    """Move a params (or state) map to ``device``; ``dtype`` casts floating
    tensors (an AlignedConvWeight keeps its bias in f32)."""
    def conv(v):
        if isinstance(v, AlignedConvWeight):
            return v.to(device, dtype)
        if isinstance(v, dict):
            return {k: conv(u) for k, u in v.items()}
        if isinstance(v, torch.Tensor):
            cast = dtype if dtype is not None and v.is_floating_point() else None
            return v.to(device=device, dtype=cast)
        return v

    return conv(params)


class Net(torch.nn.Module):
    """Graph executor over a LayerSpec list."""

    def __init__(self, specs: Sequence[LayerSpec], *,
                 policy: Optional[ExecutionPolicy] = None,
                 phase: str = "test"):
        super().__init__()
        self.policy = policy or ExecutionPolicy()
        self.phase = phase
        self.specs = [s for s in specs if s.phase in (None, phase)]
        layers = []
        for s in self.specs:
            if s.type not in LAYER_REGISTRY:
                raise KeyError(f"layer type {s.type!r} not registered "
                               f"(known: {sorted(LAYER_REGISTRY)})")
            layers.append(LAYER_REGISTRY[s.type](s, self.policy))
        self.layers = torch.nn.ModuleList(layers)
        self.state0: Dict[str, Any] = {}

    def init(self, gen: torch.Generator,
             input_shapes: Dict[str, Tuple[int, ...]]):
        """Returns params (layer name -> dict of CPU tensors); also sets
        ``state0`` (initial BatchNorm buffers)."""
        params: Dict[str, Any] = {}
        state0: Dict[str, Any] = {}
        for layer, in_shapes in self.walk_shapes(input_shapes):
            p = layer.init_params(gen, in_shapes)
            if p:
                params[layer.spec.name] = p
            if layer.has_state:
                state0[layer.spec.name] = layer.init_state(in_shapes)
        self.state0 = state0
        return params

    def walk_shapes(self, input_shapes):
        """Each layer in order with the shapes of its bottoms."""
        shapes = {k: tuple(v) for k, v in input_shapes.items()}
        for layer in self.layers:
            spec = layer.spec
            in_shapes = [shapes[b] for b in spec.bottoms]
            yield layer, in_shapes
            for t, o in zip(spec.tops, layer.out_shapes(in_shapes)):
                shapes[t] = tuple(o)

    def routes(self, aligned_params, input_shapes: Dict[str, Tuple[int, ...]],
               input_dtype: torch.dtype = torch.float32) -> Dict[str, str]:
        """The route of every conv and fc layer (``Layer.route``: e.g.
        "unroll", "gathered", "fused", "xbsp_spmm", "dense", "ell" in
        LOWERED_SPARSE with the ELL format, or with
        ``use_xla_sparse=False`` "fused", "gc", "lowered", "spmm") for
        inputs of these shapes and dtype, from shapes alone: nothing runs.
        With ``autotune`` on, each sparse conv's arm is served from the
        autotune cache (inside the ``net_scope`` the forward runs in), so
        call it with the params on their device after calibration or a
        forward; a key not in the cache yet would be measured first."""
        out = {}
        for layer, in_shapes in self.walk_shapes(input_shapes):
            r = layer.route(aligned_params.get(layer.spec.name), in_shapes,
                            input_dtype)
            if r is not None:
                out[layer.spec.name] = r
        return out

    def forward(self, params: Dict[str, Any], inputs: Dict[str, torch.Tensor],
                *, state: Optional[Dict[str, Any]] = None,
                return_blobs: bool = False):
        """Topological forward. Returns the final tops (blobs no later layer
        reads), or every blob with ``return_blobs=True``."""
        blobs: Dict[str, torch.Tensor] = dict(inputs)
        if state is None:
            state = self.state0
        consumed = set()
        for layer in self.layers:
            spec = layer.spec
            ins = [blobs[b] for b in spec.bottoms]
            consumed.update(spec.bottoms)
            lp = params.get(spec.name, {})
            if layer.has_state:
                outs = layer(lp, ins, state[spec.name])
            else:
                outs = layer(lp, ins)
            for t, o in zip(spec.tops, outs):
                blobs[t] = o
        if return_blobs:
            return blobs
        all_tops = [t for l in self.layers for t in l.spec.tops]
        finals = [t for t in all_tops if t not in consumed and t in blobs]
        return {t: blobs[t] for t in dict.fromkeys(finals)}

    # the JAX package's name for the forward; it shadows nn.Module.apply(fn),
    # which nothing in this package uses (the layers hold no parameters)
    apply = forward

    def weight_align(self, params):
        """Host-side sparse compile of every layer's params."""
        out = dict(params)
        for layer in self.layers:
            name = layer.spec.name
            if name in out:
                out[name] = layer.align(out[name])
        return out

    def inference_fn(self, aligned_params, *,
                     state: Optional[Dict[str, Any]] = None,
                     return_blobs: bool = False, cuda_graph: bool = False):
        """Forward over fixed (aligned) params, under inference mode.

        ``cuda_graph=True`` gives the counterpart of the JAX package's
        jitted forward: on CUDA inputs, the first call for a set of input
        names, shapes and dtypes runs eagerly (which fills the autotune
        cache; autotune raises if it would measure during a capture) and
        then captures the forward as a CUDA graph over static copies of the
        inputs. Later calls with that signature copy their inputs in and
        replay the graph. A replay returns the graph's own output tensors:
        they stay valid until the next call with the same signature
        overwrites them, so clone what must outlive it. CPU inputs run
        eagerly."""
        def run(inputs):
            with torch.inference_mode():
                return self.forward(aligned_params, inputs, state=state,
                                    return_blobs=return_blobs)

        if not cuda_graph:
            return run
        graphs: Dict[Any, Any] = {}

        def replay(inputs):
            if not all(v.is_cuda for v in inputs.values()):
                return run(inputs)
            sig = tuple(sorted((k, tuple(v.shape), v.dtype, v.device)
                               for k, v in inputs.items()))
            if sig not in graphs:
                out = run(inputs)
                static = {k: v.clone() for k, v in inputs.items()}
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    captured = run(static)
                graphs[sig] = (graph, static, captured)
                return out
            graph, static, captured = graphs[sig]
            for k, v in inputs.items():
                static[k].copy_(v)
            graph.replay()
            return captured

        return replay
