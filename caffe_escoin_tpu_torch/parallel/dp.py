"""Data parallelism: batch-sharded training and inference steps (port of
``caffe_escoin_tpu/parallel/dp.py``).

The reference runs one solver per GPU, broadcasts rank 0's weights and
all-reduces the gradients (``parallel.cpp:189-256``); the JAX package
shards the batch over ``data`` and lets XLA insert the reduction. Here
each rank holds the whole params and its chunk of the batch
(``shard_batch``), and the step all-reduces the gradients over the data
axis's group. A training BatchNorm normalizes by the global batch's
statistics (``ops.norm.batch_stats_over``), as the JAX step does over its
sharded batch, so its moving averages stay equal on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from caffe_escoin_tpu_torch.engine import solvers
from caffe_escoin_tpu_torch.ops import norm as norm_ops
from caffe_escoin_tpu_torch.parallel.mesh import (axis_group, axis_size,
                                                  batch_sharding, local_shard)


def shard_batch(mesh, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """This rank's contiguous chunk of dim 0 of each input under
    ``batch_sharding`` (the JAX ``P("data")``): data coordinate i holds rows
    [i*B/n, (i+1)*B/n)."""
    placements = batch_sharding(mesh)
    return {k: local_shard(v, placements, mesh) for k, v in batch.items()}


def replicate_params(mesh, params):
    """Rank 0's params on every rank (a broadcast of each tensor over the
    whole group; new tensors, ``params`` left as it was)."""
    def bcast(t):
        t = t.detach().clone()
        dist.broadcast(t, src=0)
        return t

    return solvers.tree_map(bcast, params)


def _sum_over(tensors, group):
    """The tensors summed over ``group``, through one flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [f.view_as(t) for f, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def make_dp_train_step(net, cfg: solvers.SolverConfig, mesh, *,
                       lr_mults=None, decay_mults=None):
    """Returns ``step(params, state, net_state, batch, lr, it, generator)
    -> (params, state, net_state, loss)``: the batch is this rank's shard
    (``shard_batch``), params and solver state the replicated whole.

    ``Net.loss`` and its gradients on the shard, the gradients averaged
    over the data axis, then ``solvers.regularize``, ``clip_gradients``
    and ``update`` (in place, as ``Solver`` steps), in the JAX order. The
    loss returned is the global batch's mean. ``lr_mults`` and
    ``decay_mults`` are the ``Solver``'s ParamSpec multipliers (None: the
    JAX step's, none)."""
    n = axis_size(mesh, "data")
    group = axis_group(mesh, "data")
    stats_group = group if n > 1 else None

    def step(params, state, net_state, batch, lr, it,
             generator: Optional[torch.Generator] = None):
        live = solvers.tree_map(lambda p: p.detach().requires_grad_(),
                                params)
        leaves = solvers.tree_leaves(live)
        with torch.enable_grad(), norm_ops.batch_stats_over(stats_group):
            loss, new_ns = net.loss(live, batch, train=True,
                                    generator=generator, state=net_state,
                                    return_state=True)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        loss = loss.detach()
        if n > 1:
            *grads, loss = _sum_over(grads + [loss.reshape(1)], group)
            grads = [g / n for g in grads]
            loss = loss.reshape(()) / n
        flat = iter(grads)
        grads = solvers.tree_map(lambda p: next(flat), params)
        grads = solvers.regularize(cfg, params, grads,
                                   decay_mults=decay_mults)
        grads = solvers.clip_gradients(cfg, grads)
        solvers.update(cfg, params, grads, state, lr, it, lr_mults=lr_mults)
        return params, state, new_ns, loss

    return step


def make_dp_eval_step(net, mesh):
    """Returns ``fwd(params, batch)``: the inference forward on this rank's
    shard, with no collective (the JAX forward partitions every product's
    batch dim)."""
    def fwd(params, batch):
        with torch.inference_mode():
            return net.apply(params, batch)

    return fwd
