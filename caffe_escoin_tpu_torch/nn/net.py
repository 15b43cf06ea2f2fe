"""Graph runtime: LayerSpec / layer registry / Net (port of
``caffe_escoin_tpu/nn/net.py``).

``Net`` is an ``nn.Module`` over a LayerSpec list. Parameters are not
registered on the modules: like the JAX package, the net takes them as an
argument (``forward(params, inputs)``, also named ``apply``), because they
pass through host-side transforms (pruning, ``fuse_inference``,
``weight_align``) and the solver's in-place updates as plain dicts.
BatchNorm moving statistics live in a separate ``state`` dict, which a
training forward returns updated (``return_state=True``); Dropout's masks
come from the ``generator`` it is given.

A data layer (nn/data_layers.py) has no bottom to take a device from, so
its tops land on the net's ``device``: None means the card (an error
without one), and tests pass ``"cpu"``. Such a net, and one with a layer
whose output shape depends on the data (Filter), runs eagerly:
``inference_fn(cuda_graph=True)`` refuses it (``Layer.graph_safe``).
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
    loss_weight: float = 0.0
    # Caffe param sharing (`param { name: ... }`): run on another layer's
    # params (siamese nets, tied weights)
    share_params: Optional[str] = None

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

    category = "other"  # timing bucket: conv | fc | data | other
    type_name = "?"
    # BatchNorm's moving statistics: forward takes the layer's state, and in
    # training (train=True) returns (outs, new state)
    has_state = False
    # Dropout: in training, forward takes train=True and the generator
    uses_generator = False
    # False for a layer a CUDA graph must not capture: host I/O at forward
    # time (the data layers) or an output shape that depends on the data
    graph_safe = True
    # set by Net: the net's phase ("train"/"test") and device (None: the
    # card), which the data layers read
    net_phase: Optional[str] = None
    device: Optional[torch.device] = None

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
                 phase: str = "test", device=None):
        super().__init__()
        self.policy = policy or ExecutionPolicy()
        self.phase = phase
        self.specs = [s for s in specs if s.phase in (None, phase)]
        layers = []
        for s in self.specs:
            if s.type not in LAYER_REGISTRY:
                raise KeyError(f"layer type {s.type!r} not registered "
                               f"(known: {sorted(LAYER_REGISTRY)})")
            layer = LAYER_REGISTRY[s.type](s, self.policy)
            layer.net_phase = phase
            layers.append(layer)
        self.layers = torch.nn.ModuleList(layers)
        self.device = device
        self.state0: Dict[str, Any] = {}
        # blob name -> shape, set by init and carried by the graph passes
        self.blob_shapes: Dict[str, Tuple[int, ...]] = {}

    @property
    def device(self) -> Optional[torch.device]:
        """Where the data layers put their tops (None: the card)."""
        return self._device

    @device.setter
    def device(self, device):
        self._device = None if device is None else torch.device(device)
        for layer in self.layers:
            layer.device = self._device

    def close(self):
        """Stop the loader threads of the data layers (a net without data
        layers has none); a later forward starts them again."""
        for layer in self.layers:
            if hasattr(layer, "close"):
                layer.close()

    def init(self, gen: torch.Generator,
             input_shapes: Dict[str, Tuple[int, ...]]):
        """Returns params (layer name -> dict of CPU tensors; a layer with
        ``share_params`` gets none of its own and runs on its target's);
        also sets ``state0`` (initial BatchNorm buffers) and
        ``blob_shapes`` (every blob's shape, inputs included, which
        nn/fuse.pack_narrow_chains reads)."""
        params: Dict[str, Any] = {}
        state0: Dict[str, Any] = {}
        shapes: Dict[str, Tuple[int, ...]] = {}
        for layer, in_shapes in self.walk_shapes(input_shapes, shapes):
            share = layer.spec.share_params
            if share is not None:
                if share not in params:
                    raise KeyError(f"{layer.spec.name}: share_params target "
                                   f"{share!r} not initialized yet")
            else:
                p = layer.init_params(gen, in_shapes)
                if p:
                    params[layer.spec.name] = p
            if layer.has_state:
                state0[layer.spec.name] = layer.init_state(in_shapes)
        self.state0 = state0
        self.blob_shapes = shapes
        return params

    def walk_shapes(self, input_shapes, shapes: Optional[Dict] = None):
        """Each layer in order with the shapes of its bottoms; ``shapes``,
        when given, is filled with every blob's shape."""
        if shapes is None:
            shapes = {}
        shapes.update({k: tuple(v) for k, v in input_shapes.items()})
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
                return_blobs: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None,
                return_state: bool = False, layer_hook=None):
        """Topological forward. Returns the final tops (blobs no later layer
        reads), or every blob with ``return_blobs=True``.

        ``state`` is the BatchNorm state (``init_with_state``); None uses
        ``state0``. ``train=True`` runs the training forward: BatchNorm at
        batch statistics (unless its spec pins ``use_global_stats``) and
        Dropout with masks drawn from ``generator`` (a ``torch.Generator``
        on the inputs' device). With ``return_state=True`` the result is
        ``(result, new_state)``; in training new_state holds the updated
        moving averages (a new dict; ``state`` is not changed).

        ``layer_hook(layer, params) -> (params, post)``, where given, hands
        each layer the params it returns and passes each of the layer's
        outputs through ``post`` (None: as they are); the tensor-parallel
        forward (``parallel/tp.forward_sharded``) gathers shards so."""
        blobs: Dict[str, torch.Tensor] = dict(inputs)
        if state is None:
            state = self.state0
        new_state = dict(state)
        consumed = set()
        for layer in self.layers:
            spec = layer.spec
            ins = [blobs[b] for b in spec.bottoms]
            consumed.update(spec.bottoms)
            lp = params.get(spec.share_params or spec.name, {})
            post = None
            if layer_hook is not None:
                lp, post = layer_hook(layer, lp)
            if layer.has_state and train:
                outs, new_state[spec.name] = layer(lp, ins, state[spec.name],
                                                   train=True)
            elif layer.has_state:
                outs = layer(lp, ins, state[spec.name])
            elif train and layer.uses_generator:
                outs = layer(lp, ins, train=True, generator=generator)
            else:
                outs = layer(lp, ins)
            if post is not None:
                outs = [post(o) for o in outs]
            for t, o in zip(spec.tops, outs):
                blobs[t] = o
        if return_blobs:
            result = blobs
        else:
            all_tops = [t for l in self.layers for t in l.spec.tops]
            finals = [t for t in all_tops if t not in consumed and t in blobs]
            result = {t: blobs[t] for t in dict.fromkeys(finals)}
        if return_state:
            return result, new_state
        return result

    # the JAX package's name for the forward; it shadows nn.Module.apply(fn),
    # which nothing in this package uses (the layers hold no parameters)
    apply = forward

    def loss(self, params, inputs, *, train: bool = True,
             generator: Optional[torch.Generator] = None,
             state: Optional[Dict[str, Any]] = None,
             return_state: bool = False):
        """The weighted sum of the loss layers' tops (Caffe's loss_weight);
        with ``return_state=True`` also the new BatchNorm state."""
        blobs, new_state = self.forward(
            params, inputs, state=state, return_blobs=True, train=train,
            generator=generator, return_state=True)
        total = 0.0
        for layer in self.layers:
            w = layer.spec.loss_weight
            if w:
                total = total + w * blobs[layer.spec.tops[0]]
        if return_state:
            return total, new_state
        return total

    def init_with_state(self, gen: torch.Generator,
                        input_shapes: Dict[str, Tuple[int, ...]]):
        """(params, state): the trainable params and the BatchNorm buffers
        (``state0``) that a training forward updates."""
        params = self.init(gen, input_shapes)
        return params, self.state0

    @staticmethod
    def num_params(params) -> int:
        """The number of elements over every tensor of ``params``."""
        def count(v):
            if isinstance(v, dict):
                return sum(count(u) for u in v.values())
            return v.numel()

        return count(params)

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
        eagerly. A net with a layer that is not ``graph_safe`` (a data
        layer, Filter, HDF5Output) raises a ValueError that names it."""
        if cuda_graph:
            unsafe = [f"{l.spec.name} ({l.spec.type})" for l in self.layers
                      if not l.graph_safe]
            if unsafe:
                raise ValueError(
                    f"inference_fn(cuda_graph=True): {', '.join(unsafe)} "
                    f"cannot be captured (host I/O at forward time or a "
                    f"data-dependent shape); run this net eagerly")

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
