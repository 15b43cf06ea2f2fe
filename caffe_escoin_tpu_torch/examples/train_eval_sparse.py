"""End-to-end real-data experiment: train -> prune -> fine-tune -> sparse
inference accuracy parity (port of ``examples/train_eval_sparse.py``; the
analogue of the reference's `run.sh:3-20`, which scored pruned SkimCaffe
models against their dense runs).

Dataset: the offline digits set (``examples/digits.py``: 1,797 real 8x8
images, 10 classes), nearest-neighbour upscaled to the model's input size.
The pipeline is the port's own end to end: a ``.cerec`` database -> its
cursor -> ``engine/solver.Solver`` (the BatchNorm state channel for the bn
model) -> magnitude pruning (block AND unstructured) -> masked fine-tuning
-> ``weight_align`` -> sparse ``inference_fn`` scoring.

Every leg starts from a deep copy of the dense checkpoint: the Solver
updates its params and history in place, so a leg that took the
checkpoint's tensors would hand the next leg weights that are already
fine-tuned and pruned (the JAX script may share them: its arrays are
immutable).

Usage (``--platform`` auto, the default, is the card; an error without
one):
    python -m caffe_escoin_tpu_torch.examples.train_eval_sparse \\
        --model lenet --iters 800 --sparsities 0.7,0.8,0.9 \\
        --modes oneshot,deploy --platform cpu
    python -m caffe_escoin_tpu_torch.examples.train_eval_sparse \\
        --model alexnet --sparsities 0.9 --block 128,128 --iters 1200 \\
        --finetune_iters 500 --gradual_iters 800 --batch 64 \\
        --base_lr 0.01 --filler xavier --modes gradual

Prints a markdown results table and, with ``--report``, appends it to that
file and a JSON blob to ``<report>.json``; the JAX package's records
``docs/EXPERIMENTS*`` are refused. The training ``.cerec`` (0.95 GB at
AlexNet's 227x227) is written under ``--workdir`` (default: a fresh
temporary directory) and deleted when the run ends.
"""

from __future__ import annotations

import argparse
import dataclasses
import fnmatch
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from caffe_escoin_tpu_torch.data.datasets import cerec_source, write_cerec
from caffe_escoin_tpu_torch.engine import solvers
from caffe_escoin_tpu_torch.engine.context import ConvMode, ExecutionPolicy
from caffe_escoin_tpu_torch.engine.solver import Solver
from caffe_escoin_tpu_torch.examples.digits import load_digits_upscaled, log
from caffe_escoin_tpu_torch.models import ZOO
from caffe_escoin_tpu_torch.nn import Net, params_to
from caffe_escoin_tpu_torch.sparse.permute import deploy_unstructured
from caffe_escoin_tpu_torch.utils.benchmark import PLATFORMS, force_platform
from caffe_escoin_tpu_torch.utils.pruning import (PruningSchedule, masks_of,
                                                  prune_blocks,
                                                  prune_conv_weight,
                                                  prune_magnitude)

# the JAX package's records of this experiment, which no run of the port
# may extend
JAX_RECORDS = Path(__file__).resolve().parents[2] / "docs"
JAX_RECORD_NAMES = "EXPERIMENTS*"


def is_jax_record(path) -> bool:
    """Whether ``path`` is one of the JAX package's records: a
    ``docs/EXPERIMENTS*`` file (the tables and their ``.json``)."""
    p = Path(path).resolve()
    return p.parent == JAX_RECORDS and fnmatch.fnmatch(p.name,
                                                       JAX_RECORD_NAMES)


def evaluate(net, params, net_state, data, labels, batch=64):
    """Test-phase accuracy through ``Net.inference_fn`` on the net's device
    (``Net.device``; None is the card). The weights may be aligned sparse:
    the scoring the reference's `caffe test` did."""
    dev = net.device if net.device is not None else force_platform("auto")
    fwd = net.inference_fn(params_to(params, dev),
                           state=params_to(net_state, dev),
                           return_blobs=True)
    head = next((l.spec.bottoms[0] for l in net.layers
                 if l.spec.type in ("SoftmaxWithLoss", "Softmax",
                                    "Accuracy")), "ip1")
    correct = total = 0
    for i in range(0, len(data) - batch + 1, batch):
        blobs = fwd({"data": torch.as_tensor(data[i:i + batch]).to(dev),
                     "label": torch.as_tensor(labels[i:i + batch]).to(dev)})
        pred = blobs[head].argmax(-1).cpu().numpy()
        correct += int((pred == labels[i:i + batch]).sum())
        total += batch
    return correct / max(1, total)


def prune_params(net, params, sparsity, block):
    """Magnitude-prune conv + fc weights (block=None -> unstructured).
    Returns (params, pruned_layer_names); the leaves it does not prune are
    ``params``'s own tensors."""
    out = dict(params)
    pruned_names = []
    for layer in net.layers:
        n = layer.spec.name
        if n not in out or not isinstance(out[n], dict) or "w" not in out[n]:
            continue
        w = out[n]["w"]
        host = w.detach().cpu().numpy()
        t = layer.spec.type
        if t in ("Convolution", "ConvolutionReLU") and host.ndim == 4:
            if host.shape[2] < 16:
                continue  # input conv (1/3-channel): dense in the
                # reference's pruned models too (its conv1 stayed dense)
            pruned = prune_conv_weight(host, sparsity, block)
        elif t == "InnerProduct":
            if host.shape[1] < 32:
                continue  # classifier head: never pruned (standard practice;
                # the reference's pruned models kept fc8/classifier dense)
            pruned = (prune_magnitude(host, sparsity) if block is None
                      else prune_blocks(host, sparsity, block))
        else:
            continue
        out[n] = dict(out[n], w=torch.as_tensor(pruned).to(w.device, w.dtype))
        pruned_names.append(n)
    return out, pruned_names


def gradual_select(name, key, leaf):
    """The leaves the gradual leg prunes: the same layers ``prune_params``
    targets, conv weights with cin >= 16 and fc weights (the classifier
    head included)."""
    if key != "w":
        return False
    shp = tuple(leaf.shape)
    if len(shp) == 4:
        return shp[2] >= 16
    return len(shp) == 2


def model_specs(model, filler="", **kw):
    """The ZOO model with 10 outputs where its builder takes
    ``num_classes``; ``filler`` overrides every weight filler's type."""
    builder = ZOO[model][0]
    try:
        specs = builder(num_classes=10, **kw)
    except TypeError:
        specs = builder(**kw)
    if filler:
        specs = [dataclasses.replace(sp, params={
            **sp.params, "weight_filler": {"type": filler}})
            if "weight_filler" in sp.params else sp for sp in specs]
    return specs


def clone(tree):
    """A deep copy of a params or state tree of tensors."""
    return solvers.tree_map(lambda t: t.detach().clone(), tree)


def achieved_sparsity(params, names) -> float:
    """Zero share over the weights of ``names`` (nnz-weighted)."""
    tw = [params[n]["w"] for n in names]
    return (sum(float((w == 0).sum()) for w in tw)
            / max(1, sum(w.numel() for w in tw)))


class Experiment:
    """What the legs share: the digits, the ``.cerec`` stream, the train,
    test and sparse nets, the Solver, and the dense checkpoint (params and
    BatchNorm state) that every leg starts from a deep copy of."""

    def __init__(self, args, log=log):
        self.args, self.log = args, log
        self.device = force_platform(args.platform)
        self._tmp = None if args.workdir else tempfile.mkdtemp(
            prefix="cescoin_experiment_")
        self.workdir = args.workdir or self._tmp
        os.makedirs(self.workdir, exist_ok=True)
        self.train_db = os.path.join(self.workdir, "train.cerec")
        try:
            self._build(args, log)
        except BaseException:
            self.close()
            raise

    def _build(self, args, log):
        shapes = ZOO[args.model][1]["data"]
        size, channels = shapes[1], shapes[3]
        (trd, trl), self.test_data = load_digits_upscaled(size, channels)
        log(f"digits: train {len(trd)}, test {len(self.test_data[0])}, "
            f"input {size}x{size}x{channels}")
        # exercise the .cerec database + cursor path for the training stream
        write_cerec(self.train_db, trd, trl.astype(np.float32))
        del trd
        self.src = cerec_source(self.train_db, args.batch)
        self.block = tuple(int(v) for v in args.block.split(","))

        def specs():
            return model_specs(args.model, args.filler, include_loss=True)

        self.net = Net(specs(), phase="train")
        self.test_net = Net(specs(), phase="test")
        cfg = solvers.SolverConfig(base_lr=args.base_lr, momentum=0.9,
                                   weight_decay=5e-4, lr_policy="inv",
                                   gamma=1e-4, power=0.75)
        self.solver = Solver(self.net, cfg, test_net=self.test_net,
                             snapshot_prefix=os.path.join(self.workdir,
                                                          "snap"),
                             device=self.device)
        self.solver.init({"data": (args.batch, size, size, channels),
                          "label": (args.batch,)})
        sp_policy = ExecutionPolicy(conv_mode=ConvMode.SCONV_PAR,
                                    block_shape=self.block,
                                    sparse_threshold=0.4,
                                    sconv_threshold=0.4)
        self.sparse_net = Net(specs(), policy=sp_policy, phase="test",
                              device=self.device)
        self.base_params = self.base_state = None

    def close(self):
        """Delete the training database (and the directory, where it is a
        temporary one)."""
        if os.path.exists(self.train_db):
            os.remove(self.train_db)
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)

    def train_iter(self):
        while True:
            yield self.src()

    def score(self, net, params):
        """Accuracy of ``params`` (and the Solver's BatchNorm state) on the
        test digits through ``net``."""
        return evaluate(net, params, self.solver.net_state, *self.test_data)

    def _restart(self, params, masks):
        """The Solver on ``params`` with the checkpoint's BatchNorm state,
        a zero history and ``masks``."""
        s = self.solver
        s.params = params
        s.net_state = clone(self.base_state)
        s.state = solvers.tree_map(torch.zeros_like, s.state)
        s.set_param_masks(masks)

    def train_dense(self):
        a, s = self.args, self.solver
        s.step(self.train_iter(), a.iters, log=self.log)
        dense_acc = self.score(self.test_net, s.params)
        self.log(f"dense test accuracy after {a.iters} iters: "
                 f"{dense_acc:.4f}")
        self.base_params = clone(s.params)
        self.base_state = clone(s.net_state)
        return dense_acc

    def _sparse_row(self, names):
        s = self.solver
        acc_ft = self.score(self.test_net, s.params)
        # sparse execution parity: weight_align + sparse path scoring
        aligned = self.sparse_net.weight_align(s.params)
        acc_sparse = self.score(self.sparse_net, aligned)
        # sparsity over the layers actually targeted (nnz-weighted)
        achieved = achieved_sparsity(s.params, names)
        return acc_ft, acc_sparse, achieved

    def oneshot(self, gran, blk, sp):
        """Prune the checkpoint at ``sp`` (``blk`` None: element-wise),
        masked fine-tune, score dense and sparse."""
        s = self.solver
        pruned, names = prune_params(self.net, clone(self.base_params), sp,
                                     blk)
        acc_pruned = evaluate(self.test_net, pruned, self.base_state,
                              *self.test_data)
        self._restart(pruned, masks_of(pruned))
        s.step(self.train_iter(), self.args.finetune_iters,
               log=lambda m: None)
        acc_ft, acc_sparse, achieved = self._sparse_row(names)
        self.log(f"{gran} @ {sp:.0%}: pruned {acc_pruned:.4f} -> "
                 f"finetuned {acc_ft:.4f} -> sparse-exec {acc_sparse:.4f}")
        return dict(granularity=gran, target_sparsity=sp,
                    achieved_sparsity=round(float(achieved), 4),
                    acc_pruned=round(float(acc_pruned), 4),
                    acc_finetuned=round(float(acc_ft), 4),
                    acc_sparse_exec=round(float(acc_sparse), 4),
                    sparse_exec_delta=round(float(acc_sparse - acc_ft), 4))

    def gradual(self, sp):
        """GRADUAL (AGP) block pruning: sparsity ramped DURING training
        from the dense checkpoint, masks recomputed from live weights every
        schedule step, then frozen-mask fine-tuning. One-shot block-90%
        collapses AlexNet to chance (docs/EXPERIMENTS_alexnet.md) and
        masked fine-tuning cannot repair it; the cubic ramp
        (utils/pruning.agp_sparsity) lets surviving blocks absorb the
        pruned capacity step by step. Reference analogue: its in-training
        L1 pruning pressure (`sgd_solver.cpp:144-206`)."""
        a, s = self.args, self.solver
        ramp = a.gradual_iters or a.iters
        stab = a.finetune_iters
        self._restart(clone(self.base_params), None)
        sched = PruningSchedule(
            final_sparsity=sp, start_iter=s.iter, end_iter=s.iter + ramp,
            freq=max(10, ramp // 25), granularity="block",
            block_shape=self.block)
        s.set_pruning_schedule(sched, select=gradual_select)
        s.step(self.train_iter(), ramp + stab, log=self.log)
        s.set_pruning_schedule(None)
        names = [l.spec.name for l in self.net.layers
                 if l.spec.name in s.params
                 and isinstance(s.params[l.spec.name], dict)
                 and "w" in s.params[l.spec.name]
                 and gradual_select(l.spec.name, "w",
                                    s.params[l.spec.name]["w"])]
        acc_ft, acc_sparse, achieved = self._sparse_row(names)
        self.log(f"block_gradual @ {sp:.0%} (ramp {ramp}+{stab}): "
                 f"finetuned {acc_ft:.4f} -> sparse-exec {acc_sparse:.4f} "
                 f"(achieved {achieved:.1%})")
        return dict(granularity="block_gradual", target_sparsity=sp,
                    achieved_sparsity=round(float(achieved), 4),
                    acc_pruned=None,
                    acc_finetuned=round(float(acc_ft), 4),
                    acc_sparse_exec=round(float(acc_sparse), 4),
                    sparse_exec_delta=round(float(acc_sparse - acc_ft), 4),
                    ramp_iters=ramp, stabilize_iters=stab)

    def deploy(self, sp):
        """The unstructured-checkpoint DEPLOYMENT pipeline: greedy channel
        permutations (producer cout propagated free into the consumer's
        cin) concentrate each unstructured pattern into fewer live blocks,
        densify zeroes the sub-threshold blocks, masked fine-tuning
        recovers the loss, and the block-sparse executors score the
        result: the cost of converting the reference's unstructured
        workload into block-executable structure."""
        s, ft = self.solver, self.args.finetune_iters
        pruned, names = prune_params(self.net, clone(self.base_params), sp,
                                     None)
        self._restart(pruned, masks_of(pruned))
        s.step(self.train_iter(), ft, log=lambda m: None)
        p, dep = deploy_unstructured(
            self.net, s.params, block_shape=self.block, min_density=0.05,
            layers=names, log=self.log)
        s.params = p
        s.set_param_masks(masks_of(p))
        s.step(self.train_iter(), ft, log=lambda m: None)
        aligned = self.sparse_net.weight_align(s.params)
        acc_dep = self.score(self.sparse_net, aligned)
        blocks_before = sum(r["blocks_before"] for r in dep["permuted"])
        blocks_after = sum(r["blocks_after"] for r in dep["permuted"])
        extra_zeroed = (float(np.mean([r["extra_zeroed_frac"]
                                       for r in dep["densified"]]))
                        if dep["densified"] else 0.0)
        bd = (float(np.mean([r["block_density"] for r in dep["densified"]]))
              if dep["densified"] else 1.0)
        self.log(f"unstructured deployment @ {sp:.0%}: live blocks "
                 f"{blocks_before} -> permute {blocks_after} -> densify bd="
                 f"{bd:.2f} (+{extra_zeroed:.1%} zeroed), acc {acc_dep:.4f}")
        return dict(sparsity=sp, blocks_before=blocks_before,
                    blocks_after_permute=blocks_after,
                    block_density_after_densify=round(bd, 4),
                    extra_zeroed_frac=round(extra_zeroed, 4),
                    acc_after_pipeline=round(float(acc_dep), 4),
                    per_layer=dep)


def run(args, log=log):
    """The experiment's legs as ``args`` asks: returns (results, the
    Experiment), whose ``solver`` holds the last leg's params and BatchNorm
    state. The training database is deleted before it returns."""
    exp = Experiment(args, log)
    try:
        dense_acc = exp.train_dense()
        results = {"model": args.model,
                   "dense_acc": round(float(dense_acc), 4),
                   "train_iters": args.iters, "rows": []}
        sparsities = [float(s) for s in args.sparsities.split(",")]
        modes = set(args.modes.split(","))
        if "oneshot" in modes:
            for gran, blk in (("unstructured", None), ("block", exp.block)):
                for sp in sparsities:
                    results["rows"].append(exp.oneshot(gran, blk, sp))
        if "gradual" in modes:
            for sp in sparsities:
                results["rows"].append(exp.gradual(sp))
        if "deploy" in modes:
            results["unstructured_deployment"] = exp.deploy(max(sparsities))
    finally:
        exp.close()
    return results, exp


def markdown(results) -> str:
    """The results table (and the deployment line) as the JAX script
    prints it."""
    md = [f"## {results['model']} on digits (dense acc "
          f"{results['dense_acc']:.4f}, {results['train_iters']} iters)",
          "",
          "| granularity | target sparsity | acc pruned | acc fine-tuned | "
          "acc sparse-exec | sparse-exec delta |",
          "|---|---|---|---|---|---|"]
    for r in results["rows"]:
        ap_ = ("n/a (in-training)" if r.get("acc_pruned") is None
               else f"{r['acc_pruned']:.4f}")
        md.append(f"| {r['granularity']} | {r['target_sparsity']:.0%} "
                  f"(got {r['achieved_sparsity']:.1%}) | "
                  f"{ap_} | {r['acc_finetuned']:.4f} | "
                  f"{r['acc_sparse_exec']:.4f} | "
                  f"{r['sparse_exec_delta']:+.4f} |")
    if "unstructured_deployment" in results:
        d = results["unstructured_deployment"]
        md += ["",
               f"Unstructured-checkpoint deployment @ "
               f"{d['sparsity']:.0%} (permute → densify → masked "
               f"fine-tune → block exec): ip1 live blocks "
               f"{d['blocks_before']} → {d['blocks_after_permute']}, "
               f"densified block density "
               f"{d['block_density_after_densify']:.2f} "
               f"(+{d['extra_zeroed_frac']:.1%} weights zeroed), final "
               f"accuracy {d['acc_after_pipeline']:.4f}."]
    return "\n".join(md)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="lenet",
                    choices=["lenet", "cifar10_quick", "cifar10_bn",
                             "alexnet"])
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--finetune_iters", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--base_lr", type=float, default=0.05)
    ap.add_argument("--sparsities", default="0.7,0.9")
    ap.add_argument("--block", default="8,8",
                    help="block shape for structured pruning (bm,bk)")
    ap.add_argument("--filler", default="",
                    help="override every weight_filler type (e.g. xavier):"
                         " AlexNet's 1989 gaussian-0.01 recipe plateaus at"
                         " chance on small datasets; the experiment's"
                         " subject is the pruning pipeline, not the init")
    ap.add_argument("--modes", default="oneshot,deploy,gradual",
                    help="comma set of experiment legs: oneshot (prune + "
                         "masked fine-tune), deploy (unstructured-"
                         "checkpoint pipeline), gradual (AGP in-training "
                         "block pruning, the route to accurate block-"
                         "sparse models; one-shot block pruning collapses "
                         "at AlexNet scale, docs/EXPERIMENTS_alexnet.md)")
    ap.add_argument("--gradual_iters", type=int, default=0,
                    help="AGP ramp window (0 = same as --iters); the ramp "
                         "is followed by --finetune_iters frozen-mask "
                         "iterations")
    ap.add_argument("--report", default="",
                    help="append the table to this file and the JSON to "
                         "<report>.json (not docs/EXPERIMENTS*.md, the JAX "
                         "package's records)")
    ap.add_argument("--workdir", default="",
                    help="where the training .cerec is written (default: a "
                         "fresh temporary directory); deleted at the end")
    ap.add_argument("--platform", default="auto", choices=PLATFORMS,
                    help="auto (the default) and cuda run on the card, an "
                         "error without one; cpu on the CPU")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.report and is_jax_record(args.report):
        print(f"error: {args.report} is the JAX package's record; write "
              f"the port's report elsewhere", file=sys.stderr)
        return 2
    try:
        force_platform(args.platform)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    results, _ = run(args)
    report = markdown(results)
    if args.report:
        with open(args.report, "a") as f:
            f.write(report + "\n\n")
        with open(args.report + ".json", "a") as f:
            f.write(json.dumps(results, default=float) + "\n")
    print(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
