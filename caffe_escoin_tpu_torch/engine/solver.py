"""The training loop (port of
``caffe_escoin_tpu/engine/solver.py``).

Reference: `Solver::Solve/Step/TestAll/Snapshot/Restore`
(`src/caffe/solver.cpp:180-472`). One iteration runs iter_size
micro-batches (forward, ``torch.autograd.grad`` over the parameter leaves,
the BatchNorm state carried from one to the next), averages the gradients,
regularizes, clips, updates the parameters in place (``engine/solvers.py``,
Caffe's formulas, never ``torch.optim``) and then multiplies in the pruning
masks. The step runs eagerly; the JAX package's ``jit`` has no counterpart.

Signal handling mirrors `util/signal_handler.cpp` + `tools/caffe.cpp:236-243`:
SIGINT -> stop (snapshot_after_train honored), SIGHUP -> snapshot.

Device: ``device=None`` runs on the card (``force_platform("auto")``) and
raises where there is none; the CPU only when the caller asks for it
(``device="cpu"``). One CPU generator seeded with ``seed`` initializes the
params, one on the device draws Dropout's masks. The Solver sets the
device of its nets, so that a net with a data layer (nn/data_layers.py)
feeds itself on it; ``step`` then takes empty dicts (``{}``) as batches.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Callable, Dict, Iterator, Optional, Union

import numpy as np
import torch

from caffe_escoin_tpu_torch.engine import solvers
from caffe_escoin_tpu_torch.engine.checkpoint import (load_checkpoint_full,
                                                      save_checkpoint)
from caffe_escoin_tpu_torch.engine.lr_policies import learning_rate
from caffe_escoin_tpu_torch.nn.net import Net, params_to
from caffe_escoin_tpu_torch.utils import pruning
from caffe_escoin_tpu_torch.utils.benchmark import force_platform

RSS_LIMIT_ENV = "CESCOIN_RSS_LIMIT_GB"


def _vm_rss_gb() -> float:
    """Current process VmRSS in GB (0.0 where /proc is unavailable)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS"):
                    return float(line.split()[1]) / 1e6  # kB -> GB
    except OSError:
        pass
    return 0.0


def rss_limit_from_env() -> Optional[float]:
    """The host-RSS limit in GB from $CESCOIN_RSS_LIMIT_GB (None when unset
    or empty). A value that is not a number raises ValueError naming the
    variable (the JAX package's bare ``float()`` has no such guard)."""
    raw = os.environ.get(RSS_LIMIT_ENV)
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{RSS_LIMIT_ENV}={raw!r} is not a number (the host "
                         f"RSS limit in GB)") from None


def _resolve_device(device) -> torch.device:
    """None -> the card ("auto"); a platform name of ``force_platform``; or
    a torch.device (a CUDA one also turns TF32 off)."""
    if device is None or isinstance(device, str):
        return force_platform(device or "auto")
    device = torch.device(device)
    if device.type == "cuda":
        force_platform("cuda")
    return device


class Solver:
    def __init__(
        self,
        net: Net,
        cfg: solvers.SolverConfig,
        *,
        test_net: Optional[Net] = None,
        test_data_iter: Optional[Iterator[Dict]] = None,
        snapshot_prefix: str = "snapshot",
        snapshot_interval: int = 0,
        test_interval: int = 0,
        test_iters: int = 1,
        display: int = 20,
        average_loss: int = 1,
        seed: int = 0,
        reg_overrides: Optional[Dict[str, str]] = None,
        lr_mults=None,
        decay_mults=None,
        device: Union[None, str, torch.device] = None,
    ):
        self.device = _resolve_device(device)
        self.net = net
        self.test_net = test_net
        # the data layers of either net put their tops on this device
        for n in (net, test_net):
            if n is not None:
                n.device = self.device
        self.test_data_iter = test_data_iter
        self.cfg = cfg
        self.snapshot_prefix = snapshot_prefix
        self.snapshot_interval = snapshot_interval
        self.test_interval = test_interval
        self.test_iters = test_iters
        self.display = display
        self.average_loss = average_loss
        self.init_generator = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.iter = 0
        self.params = None
        self.state = None
        # the BatchNorm buffers: carried through the step, never given to
        # the solver update (the reference pins them with lr_mult 0)
        self.net_state = {}
        self._stop = False
        self._snapshot_requested = False
        self._losses = []
        self._test_fwd = None
        self.reg_overrides = reg_overrides
        # ParamSpec lr_mult/decay_mult trees (caffe.proto:300-310); None
        # derives them from the net's param_specs at init()
        self.lr_mults = lr_mults
        self.decay_mults = decay_mults
        self.param_masks = None
        self.pruning_schedule = None
        self._prune_select = None
        self._last_mask_sparsity = None
        # host seconds of this iteration's mask recompute (None: none)
        self.mask_update_s: Optional[float] = None
        # host-RSS guard: past the limit the loop snapshots and stops, and
        # a fresh process restore()s; None disables
        self.rss_limit_gb: Optional[float] = rss_limit_from_env()
        self.rss_check_every = 50
        self.rss_stopped = False

    # ------------------------------------------------------------------
    def set_param_masks(self, masks) -> None:
        """Pin pruned weights at zero during training (masked fine-tuning):
        ``masks`` (0/1, congruent with the params; ``utils.pruning.masks_of``
        or ``gradual_masks``) multiply the params after every update. They
        are copied to the device once."""
        if masks is not None:
            masks = params_to(solvers.tree_map(
                lambda m: torch.as_tensor(m, dtype=torch.float32), masks),
                self.device)
        self.param_masks = masks

    # ------------------------------------------------------------------
    def set_pruning_schedule(self, schedule, select=None) -> None:
        """Gradual in-training pruning (``utils.pruning.PruningSchedule``):
        every ``schedule.freq`` iterations inside [start_iter, end_iter]
        the masks are recomputed from the current weights at the AGP
        target (``utils.pruning.agp_sparsity``, ``gradual_masks``); after
        end_iter the final mask stays frozen. ``select(name, key, w)``
        picks the pruned leaves (``pruning.default_prune_select``)."""
        self.pruning_schedule = schedule
        self._prune_select = select
        self._last_mask_sparsity = None

    # ------------------------------------------------------------------
    def _maybe_update_masks(self, log=print) -> None:
        sched = self.pruning_schedule
        if sched is None or self.iter < sched.start_iter:
            return
        freq = max(1, sched.freq)
        due = (self.iter - sched.start_iter) % freq == 0
        # one final recompute at or after end_iter, then frozen
        past_end = self.iter >= sched.end_iter
        if past_end and self._last_mask_sparsity == sched.final_sparsity:
            return
        if not due and not past_end:
            return
        s = pruning.agp_sparsity(
            self.iter, start_iter=sched.start_iter,
            end_iter=sched.end_iter, freq=freq,
            final_sparsity=sched.final_sparsity,
            initial_sparsity=sched.initial_sparsity)
        if s <= 0 or s == self._last_mask_sparsity and not past_end:
            return
        t0 = time.perf_counter()
        self.set_param_masks(pruning.gradual_masks(
            self.params, s, granularity=sched.granularity,
            block_shape=sched.block_shape, select=self._prune_select))
        # applied at once, so that the sparsity the log reports is real
        self._apply_masks()
        self.mask_update_s = time.perf_counter() - t0
        self._last_mask_sparsity = sched.final_sparsity if past_end else s
        log(f"Pruning: iteration {self.iter}, target sparsity {s:.4f} "
            f"({sched.granularity})")

    @torch.no_grad()
    def _apply_masks(self):
        solvers.tree_map(lambda p, m: p.mul_(m), self.params, self.param_masks)

    # ------------------------------------------------------------------
    def init(self, input_shapes: Dict[str, tuple]):
        """Params from the net's fillers (the CPU generator), the BatchNorm
        state, the zero solver history and the ParamSpec multipliers, all
        on the device."""
        params, net_state = self.net.init_with_state(self.init_generator,
                                                     input_shapes)
        self.params = params_to(params, self.device)
        self.net_state = params_to(net_state, self.device)
        self.state = solvers.init_state(self.cfg, self.params)
        if self.lr_mults is None and self.decay_mults is None:
            self.lr_mults, self.decay_mults = solvers.param_multipliers(
                self.net, self.params)
        return self.params

    # ------------------------------------------------------------------
    def _to_device(self, batch):
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def _step(self, batches, lr: float, it: int):
        """One iteration over ``batches`` (iter_size micro-batches): returns
        the mean loss (a 0-d tensor on the device)."""
        cfg = self.cfg
        grads, total, ns = None, 0.0, self.net_state
        for batch in batches:
            live = solvers.tree_map(lambda p: p.detach().requires_grad_(),
                                    self.params)
            leaves = solvers.tree_leaves(live)
            with torch.enable_grad():
                loss, ns = self.net.loss(live, batch, train=True,
                                         generator=self.generator, state=ns,
                                         return_state=True)
                g = torch.autograd.grad(loss, leaves, allow_unused=True)
            g = [torch.zeros_like(p) if gi is None else gi
                 for gi, p in zip(g, leaves)]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            total = total + loss.detach()
        # Normalize (sgd_solver.cpp:102-118)
        if cfg.iter_size > 1:
            grads = [g / cfg.iter_size for g in grads]
        flat = iter(grads)
        grads = solvers.tree_map(lambda p: next(flat), self.params)
        grads = solvers.regularize(cfg, self.params, grads,
                                   self.reg_overrides,
                                   decay_mults=self.decay_mults)
        grads = solvers.clip_gradients(cfg, grads)
        solvers.update(cfg, self.params, grads, self.state, lr, it,
                       lr_mults=self.lr_mults)
        if self.param_masks is not None:
            self._apply_masks()
        self.net_state = ns
        return total / cfg.iter_size

    # ------------------------------------------------------------------
    def install_signal_handlers(self):
        def on_sigint(sig, frame):
            self._stop = True

        def on_sighup(sig, frame):
            self._snapshot_requested = True

        signal.signal(signal.SIGINT, on_sigint)
        if hasattr(signal, "SIGHUP"):
            signal.signal(signal.SIGHUP, on_sighup)

    # ------------------------------------------------------------------
    def step(self, data_iter: Iterator[Dict], iters: int,
             log: Callable[[str], None] = print):
        start = self.iter
        while self.iter < start + iters and not self._stop:
            self.mask_update_s = None
            self._maybe_update_masks(log=log)
            if (self.test_interval and self.test_net is not None
                    and self.iter % self.test_interval == 0):
                # TestAll every test_interval (solver.cpp:191-195)
                self.test_all(data_iter=self.test_data_iter, log=log)
            batches = [self._to_device(next(data_iter))
                       for _ in range(self.cfg.iter_size)]
            lr = learning_rate(
                self.iter, base_lr=self.cfg.base_lr, policy=self.cfg.lr_policy,
                gamma=self.cfg.gamma, step_size=self.cfg.step_size,
                stepvalues=self.cfg.stepvalues, power=self.cfg.power,
                max_iter=self.cfg.max_iter,
            )
            loss = self._step(batches, lr, self.iter + 1)
            self._losses.append(float(loss))
            if len(self._losses) > self.average_loss:
                self._losses.pop(0)
            if self.display and self.iter % self.display == 0:
                smoothed = float(np.mean(self._losses))
                log(f"Iteration {self.iter}, lr = {lr:.6g}, "
                    f"loss = {smoothed:.6g}")
            self.iter += 1
            if (self.snapshot_interval and
                    self.iter % self.snapshot_interval == 0):
                self.snapshot()
            if self._snapshot_requested:
                self.snapshot()
                self._snapshot_requested = False
            if (self.rss_limit_gb is not None
                    and self.iter % self.rss_check_every == 0
                    and _vm_rss_gb() > self.rss_limit_gb):
                path = self.snapshot()
                self.rss_stopped = True
                log(f"Iteration {self.iter}: host RSS "
                    f"{_vm_rss_gb():.1f} GB > limit {self.rss_limit_gb} GB "
                    f"({RSS_LIMIT_ENV}), snapshotted to {path}, stopping; "
                    "restore() in a fresh process to continue")
                break
        return self.params

    # ------------------------------------------------------------------
    def solve(self, data_iter, iters: int, *, snapshot_after_train=True,
              log=print):
        self.step(data_iter, iters, log=log)
        if snapshot_after_train:
            self.snapshot()
        return self.params

    # ------------------------------------------------------------------
    def test_all(self, data_iter=None, log=print):
        """The test net's scalar outputs (accuracy, loss) averaged over
        ``test_iters`` batches, on the current params and BatchNorm state,
        without gradients."""
        if data_iter is None:
            data_iter = self.test_data_iter
        if self.test_net is None or data_iter is None:
            return {}
        if self._test_fwd is None:
            def fwd(batch):
                with torch.no_grad():
                    return self.test_net.forward(self.params, batch,
                                                 state=self.net_state)
            self._test_fwd = fwd
        metrics: Dict[str, list] = {}
        for _ in range(self.test_iters):
            out = self._test_fwd(self._to_device(next(data_iter)))
            for k, v in out.items():
                if v.dim() == 0:
                    metrics.setdefault(k, []).append(float(v))
        result = {k: float(np.mean(v)) for k, v in metrics.items()}
        for k, v in result.items():
            log(f"    Test net output: {k} = {v:.4g}")
        return result

    # ------------------------------------------------------------------
    def snapshot(self):
        """Params, solver state and BatchNorm state to
        ``<prefix>_iter_<iter>.npz`` (+ ``.json``), the JAX package's
        layout; returns the path without the suffix."""
        path = f"{self.snapshot_prefix}_iter_{self.iter}"
        save_checkpoint(path, self.params, solver_state=self.state,
                        net_state=self.net_state,
                        meta={"iter": self.iter,
                              "solver_type": self.cfg.solver_type})
        return path

    def restore(self, path: str):
        """Params, and the solver and BatchNorm state where the checkpoint
        holds them, and the iteration, from a checkpoint of either
        package."""
        params, state, net_state, meta = load_checkpoint_full(path)
        self.params = params_to(params, self.device)
        if state is not None:
            self.state = params_to(state, self.device)
        if net_state is not None:
            self.net_state = params_to(net_state, self.device)
        self.iter = int(meta.get("iter", 0))
        return self.params
