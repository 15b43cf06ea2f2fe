"""Centered finite-difference gradient checker (port of
``caffe_escoin_tpu/utils/gradient_check.py``).

The reference's `GradientChecker`
(`include/caffe/test/test_gradient_check_util.hpp:18-60`), the utility
nearly every reference layer test uses to validate backward passes. Here the
analytic gradient is ``torch.autograd.grad``, so the checker validates the
compositions (epilogues, masks, loss_weight accumulation) against finite
differences.

Kink handling (the reference's `kink_`/`kink_range_`): a non-smooth op
(ReLU, max-eltwise, hinge) has no derivative at its kink, and a finite
difference that straddles it is meaningless. The caller gives, per element
of the checked argument, its distance to the nearest kink; elements closer
than ``kink_range`` are not compared.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _with(args, wrt, x):
    a = list(args)
    a[wrt] = x
    return a


def fd_gradients(fn: Callable, args, *, wrt: int = 0, eps: float = 1e-3):
    """Centered-difference gradient of scalar ``fn(*args)`` with respect to
    ``args[wrt]`` (float64 numpy): ``fn`` evaluated in f32 on each of the
    2n copies with one element moved by +eps or -eps, one call each."""
    x0 = np.asarray(torch.as_tensor(args[wrt]).detach().cpu(), np.float32)
    n = x0.size
    flat = x0.ravel()
    vals = np.empty(2 * n, np.float64)
    with torch.no_grad():
        for i in range(2 * n):
            x = flat.copy()
            x[i % n] += eps if i < n else -eps
            vals[i] = float(fn(*_with(args, wrt, torch.from_numpy(
                x.reshape(x0.shape)))))
    return ((vals[:n] - vals[n:]) / (2.0 * eps)).reshape(x0.shape)


def check_gradient(
    fn: Callable,
    args,
    *,
    wrt: int = 0,
    eps: float = 1e-3,
    threshold: float = 1e-2,
    kink: Optional[np.ndarray] = None,
    kink_range: float = 0.0,
) -> None:
    """Raise AssertionError unless ``torch.autograd.grad`` of ``fn`` with
    respect to ``args[wrt]`` matches centered finite differences.

    The bound is the reference's scale-aware one
    (`test_gradient_check_util.hpp:157-166`):
        |analytic - estimated| <= threshold * max(1, |analytic|, |estimated|)

    ``kink``: per-element distance of ``args[wrt]`` to the nearest
    non-smooth point (e.g. |x| for ReLU); elements with kink < kink_range
    are left out of the comparison."""
    x = torch.as_tensor(args[wrt]).detach().clone().float().requires_grad_()
    with torch.enable_grad():
        (grad,) = torch.autograd.grad(fn(*_with(args, wrt, x)), x)
    analytic = grad.detach().cpu().numpy().astype(np.float64)
    estimated = fd_gradients(fn, args, wrt=wrt, eps=eps)
    mask = np.ones(analytic.shape, bool)
    if kink is not None and kink_range > 0:
        mask &= np.asarray(kink) >= kink_range
    if not mask.any():
        raise AssertionError("kink range excluded every element")
    scale = np.maximum(1.0, np.maximum(np.abs(analytic), np.abs(estimated)))
    err = np.abs(analytic - estimated) / scale
    bad = (err > threshold) & mask
    if bad.any():
        idx = tuple(np.argwhere(bad)[0])
        raise AssertionError(
            f"gradient mismatch at {idx} ({int(bad.sum())}/{mask.sum()} "
            f"checked elements): analytic={analytic[idx]:.6g} "
            f"fd={estimated[idx]:.6g} relerr={err[idx]:.3g} "
            f"(threshold {threshold})"
        )
