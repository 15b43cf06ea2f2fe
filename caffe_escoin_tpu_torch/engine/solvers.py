"""SGD-family solvers with Caffe's update rules (port of
``caffe_escoin_tpu/engine/solvers.py``).

Reference: `src/caffe/solvers/{sgd,nesterov,adagrad,rmsprop,adadelta,
adam}_solver.cpp`. Each solver is ``init_state`` and ``update`` over nested
dicts of tensors (layer name -> blob name -> tensor), the JAX package's
pytrees. ``update`` steps the parameters and the solver state in place,
under ``torch.no_grad()``. ``torch.optim`` is not used: its formulas are
not Caffe's (its SGD scales the velocity by the rate after the momentum,
so the two diverge when the rate changes; its Adam corrects the bias and
places ``eps`` differently).

Caffe's formulas:

* SGD:       v = momentum*v + lr*g ;  w -= v          (sgd_solver.cpp:213-243)
* Nesterov:  v' = momentum*v + lr*g ; w -= (1+momentum)*v' - momentum*v
* AdaGrad:   h += g^2 ;  w -= lr * g / (sqrt(h) + eps)
* RMSProp:   h = delta*h + (1-delta)*g^2 ; w -= lr * g / (sqrt(h) + eps)
* AdaDelta:  h = m*h + (1-m)*g^2 ;
             u = g * sqrt((h2 + eps) / (h + eps)) ;
             h2 = m*h2 + (1-m)*u^2 ;  w -= lr * u
* Adam:      m = b1*m + (1-b1)*g ; v = b2*v + (1-b2)*g^2 ;
             w -= lr * sqrt(1-b2^t)/(1-b1^t) * m / (sqrt(v) + eps)

Regularization (SGDSolver::Regularize, sgd_solver.cpp:144-206): L2 adds
decay*w to the gradient, L1 adds decay*sign(w), group lasso adds decay *
w / ||block(w)||. Gradient normalization by iter_size and L2-norm clipping
mirror Normalize/ClipGradients (sgd_solver.cpp:102-142).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

Tree = Any


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    solver_type: str = "sgd"  # sgd|nesterov|adagrad|rmsprop|adadelta|adam
    base_lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 0.0
    regularization_type: str = "L2"  # "L1" | "group_lasso" (block-L1)
    # block shape of group_lasso: the executor's BSC block, so the pressure
    # shrinks whole blocks the sparse kernels skip
    group_block: tuple = (128, 128)
    delta: float = 1e-8  # eps of the adaptive solvers
    rms_decay: float = 0.99
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    clip_gradients: float = -1.0  # <=0 disables
    iter_size: int = 1
    # lr policy
    lr_policy: str = "fixed"
    gamma: float = 0.1
    step_size: int = 100000
    stepvalues: tuple = ()
    power: float = 1.0
    max_iter: int = 100000


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of nested dicts (``rest`` congruent)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[Any]:
    """The leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def group_lasso_grad(w, block, eps: float = 1e-12):
    """d/dw of sum_b ||w_b||_2 over (bm, bk) blocks of the weight's GEMM
    view: w / ||block(w)||. A conv weight [kh, kw, ci, co] blocks its
    per-offset (ci, co) planes (the direct conv's BSC structure); a 2-D fc
    weight blocks directly; another rank gets the plain L2 direction (w)."""
    if w.dim() == 4:
        kh, kw, ci, co = w.shape
        w2 = w.reshape(kh * kw, ci, co)
    elif w.dim() == 2:
        w2 = w.reshape((1,) + tuple(w.shape))
    else:
        return w
    bm, bk = block
    rows, cols = w2.shape[1], w2.shape[2]
    R = -(-rows // bm) * bm
    C = -(-cols // bk) * bk
    wp = F.pad(w2, (0, C - cols, 0, R - rows))
    b = wp.reshape(wp.shape[0], R // bm, bm, C // bk, bk)
    norms = torch.sqrt((b * b).sum(dim=(2, 4), keepdim=True) + eps)
    g = (b / norms).reshape(wp.shape)[:, :rows, :cols]
    return g.reshape(w.shape)


def regularize(cfg: SolverConfig, params: Tree, grads: Tree,
               reg_overrides: Optional[Dict[str, str]] = None,
               decay_mults: Optional[Tree] = None) -> Tree:
    """The gradients plus the decay term (new tensors). ``reg_overrides``
    maps a layer name to "L1"/"L2"/"group_lasso" (the
    ``ParamSpec.regularization_type`` analogue, caffe.proto:307-308);
    ``decay_mults`` holds per-blob multipliers congruent with the params
    (``ParamSpec.decay_mult``: local decay = weight_decay * decay_mult)."""
    if cfg.weight_decay == 0.0:
        return grads

    def leaf(name, w, g, dm=1.0):
        kind = (reg_overrides or {}).get(name, cfg.regularization_type)
        decay = cfg.weight_decay * dm
        if kind == "L1":
            return g + decay * torch.sign(w)
        if kind == "group_lasso":
            return g + decay * group_lasso_grad(w, cfg.group_block)
        return g + decay * w

    out = {}
    for name in grads:
        if decay_mults is not None and name in decay_mults:
            out[name] = tree_map(lambda w, g, dm, n=name: leaf(n, w, g, dm),
                                 params[name], grads[name], decay_mults[name])
        else:
            out[name] = tree_map(lambda w, g, n=name: leaf(n, w, g),
                                 params[name], grads[name])
    return out


def clip_gradients(cfg: SolverConfig, grads: Tree) -> Tree:
    """The gradients scaled to an L2 norm of at most ``clip_gradients``
    (over all of them together); no host synchronisation."""
    if cfg.clip_gradients <= 0:
        return grads
    leaves = tree_leaves(grads)
    norm = torch.sqrt(sum((g * g).sum() for g in leaves))
    scale = torch.where(norm > cfg.clip_gradients, cfg.clip_gradients / norm,
                        torch.ones_like(norm))
    return tree_map(lambda g: g * scale, grads)


# the solver state's trees, by solver type
_HISTORY = {"sgd": ("h",), "nesterov": ("h",), "adagrad": ("h",),
            "rmsprop": ("h",), "adadelta": ("h", "h2"), "adam": ("m", "v")}


def init_state(cfg: SolverConfig, params: Tree) -> Tree:
    """The solver's history, zeros like the params: {"h"} for sgd,
    nesterov, adagrad and rmsprop, {"h", "h2"} for adadelta, {"m", "v"}
    for adam (the JAX package's layout, so checkpoints carry over)."""
    def zeros():
        return tree_map(lambda p: torch.zeros_like(p).detach(), params)

    if cfg.solver_type not in _HISTORY:
        raise ValueError(f"unknown solver {cfg.solver_type!r}")
    return {k: zeros() for k in _HISTORY[cfg.solver_type]}


@torch.no_grad()
def update(cfg: SolverConfig, params: Tree, grads: Tree, state: Tree,
           lr: float, it: Optional[int] = None,
           lr_mults: Optional[Tree] = None):
    """One solver step, in place on ``params`` and ``state``; returns them.
    ``it`` (1-based iteration) is needed by adam.

    ``lr_mults`` holds per-blob LR multipliers congruent with the params
    (ParamSpec.lr_mult): each blob steps with lr * lr_mult (0 freezes a
    blob). The multiplier scales the step, not the accumulators, as in the
    reference (it applies in ComputeUpdateValue, not to the gradient).
    The state's trees are matched to the params by key, not by leaf order:
    a checkpoint of the JAX package holds its dicts in sorted key order."""
    t = cfg.solver_type
    if t not in _HISTORY:
        raise ValueError(f"unknown solver {t!r}")
    lrs = (tree_map(lambda p: lr, params) if lr_mults is None
           else tree_map(lambda m: lr * m, lr_mults))
    mom, eps = cfg.momentum, cfg.delta

    def sgd(w, g, l, h):
        h.mul_(mom).add_(g, alpha=l)
        w.sub_(h)

    def nesterov(w, g, l, h):
        prev = h.clone()
        h.mul_(mom).add_(g, alpha=l)
        w.sub_((1 + mom) * h - mom * prev)

    def adagrad(w, g, l, h):
        h.addcmul_(g, g)
        w.sub_(l * g / (torch.sqrt(h) + eps))

    def rmsprop(w, g, l, h):
        d = cfg.rms_decay
        h.mul_(d).addcmul_(g, g, value=1 - d)
        w.sub_(l * g / (torch.sqrt(h) + eps))

    def adadelta(w, g, l, h, h2):
        h.mul_(mom).addcmul_(g, g, value=1 - mom)
        u = g * torch.sqrt((h2 + eps) / (h + eps))
        h2.mul_(mom).addcmul_(u, u, value=1 - mom)
        w.sub_(l * u)

    def adam(w, g, l, m, v):
        step = 1 if it is None else int(it)
        corr = (math.sqrt(1.0 - cfg.adam_beta2 ** step)
                / (1.0 - cfg.adam_beta1 ** step))
        m.mul_(cfg.adam_beta1).add_(g, alpha=1 - cfg.adam_beta1)
        v.mul_(cfg.adam_beta2).addcmul_(g, g, value=1 - cfg.adam_beta2)
        w.sub_(l * corr * m / (torch.sqrt(v) + eps))

    fn = dict(sgd=sgd, nesterov=nesterov, adagrad=adagrad, rmsprop=rmsprop,
              adadelta=adadelta, adam=adam)[t]
    tree_map(fn, params, grads, lrs, *(state[k] for k in _HISTORY[t]))
    return params, state


# Caffe's blob order per layer type (param_specs[i] addresses blobs[i]);
# the default is (weights, bias)
_BLOB_ORDER = {
    "Scale": ("gamma", "beta"),
    "PReLU": ("alpha",),
    "Parameter": ("w",),
    "Embed": ("w",),
}


def param_multipliers(net, params):
    """(lr_mults, decay_mults) congruent with the params, from the net's
    ParamSpec entries (``spec.params["param_specs"]``, as parsed from
    prototxt ``param { lr_mult decay_mult }`` blocks or set on LayerSpecs).
    (None, None) when no layer declares a multiplier."""
    any_set = False
    lr_mults: Dict[str, Any] = {}
    decay_mults: Dict[str, Any] = {}
    for layer in net.layers:
        name = layer.spec.name
        if name not in params or not isinstance(params[name], dict):
            continue
        order = _BLOB_ORDER.get(layer.spec.type, ("w", "b"))
        pspecs = layer.spec.params.get("param_specs") or []
        lm = {k: 1.0 for k in params[name]}
        dm = {k: 1.0 for k in params[name]}
        for i, ps in enumerate(pspecs):
            if i >= len(order) or order[i] not in params[name]:
                continue
            if "lr_mult" in ps or "decay_mult" in ps:
                any_set = True
            lm[order[i]] = float(ps.get("lr_mult", 1.0))
            dm[order[i]] = float(ps.get("decay_mult", 1.0))
        lr_mults[name] = lm
        decay_mults[name] = dm
    if not any_set:
        return None, None
    return lr_mults, decay_mults
