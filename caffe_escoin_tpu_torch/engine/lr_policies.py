"""Learning-rate policies (port of ``caffe_escoin_tpu/engine/lr_policies.py``,
a copy; reference `SGDSolver::GetLearningRate`,
`src/caffe/solvers/sgd_solver.cpp:27-63`): fixed, step, exp, inv,
multistep, poly, sigmoid — the same formulas, as pure functions of the
iteration."""

from __future__ import annotations

import bisect
import math
from typing import Sequence


def learning_rate(iter_: int, *, base_lr: float, policy: str = "fixed",
                  gamma: float = 0.1, step_size: int = 100000,
                  stepvalues: Sequence[int] = (), power: float = 1.0,
                  max_iter: int = 100000) -> float:
    if policy == "fixed":
        return base_lr
    if policy == "step":
        return base_lr * gamma ** (iter_ // step_size)
    if policy == "exp":
        return base_lr * gamma ** iter_
    if policy == "inv":
        return base_lr * (1.0 + gamma * iter_) ** (-power)
    if policy == "multistep":
        return base_lr * gamma ** bisect.bisect_right(list(stepvalues), iter_)
    if policy == "poly":
        return base_lr * (1.0 - iter_ / max_iter) ** power
    if policy == "sigmoid":
        return base_lr * (1.0 / (1.0 + math.exp(-gamma * (iter_ - step_size))))
    raise ValueError(f"unknown lr_policy {policy!r}")
