"""Measured per-shape arm choice for the sparse conv dispatcher (port of
``caffe_escoin_tpu/engine/autotune.py``).

``kernels/xla_block_sparse.best_arm``'s hand rules come from profiles of
one device; the fix the JAX package made, carried over: measure each
candidate arm once per (shape, pattern) on the device, cache the winner,
and count the dense conv among the candidates, so that the sparse path
never loses to its own baseline in isolation (the never-lose floor).
``calibrate_graph`` then checks the per-layer picks on the whole net.

Measurement happens lazily, the first time a forward asks for a key: the
weights are at hand, so each candidate runs on synthetic inputs of the real
shape (``measure_arms``) before the forward goes on. Results are cached in
the process and, when the policy or ``$CESCOIN_AUTOTUNE_CACHE`` names one,
in a JSON file. The port differs from the JAX module in five ways:

* a key starts with ``"cuda:<device name>"`` (or ``"cpu"``), not JAX's
  backend name; the other elements keep their positions, which
  ``_key_traffic`` reads;
* ``code_fingerprint`` hashes the port's own ``kernels/*.py`` and
  ``csrc/*`` and the toggles;
* timing is ``utils/benchmark.device_time_arms``: on the card, CUDA-graph
  replays of each candidate (the device's time, as the JAX timer reads one
  compiled program's device span), after eager warm-up calls, the
  candidates of a key replayed in turn round by round (the JAX module
  times one after another);
* ``calibrate_graph`` times each trial between two fresh readings of the
  assignment it would replace (its docstring says why);
* an arm that raises while it is measured, or a whole-net forward that
  raises during calibration, propagates: every port arm runs every shape
  it is offered, so no arm silently drops out in favour of another (the
  JAX module skips an arm XLA cannot build).

The conventional file is ``.autotune_cuda.json`` (gitignored). A TPU table
(``.autotune_tpu.json``) named by mistake is ignored whole: its
fingerprint differs, and no key of it could match a port key.

Switches, as in the JAX module: ``CESCOIN_AUTOTUNE_CACHE`` (the file when
the policy names none), ``CESCOIN_AUTOTUNE_LOG_HITS`` (print each cached
pick served outside ``record_keys``), ``CESCOIN_AUTOTUNE_FUSED`` (let the
``sconv_fused`` kernel compete where the dispatcher would run it:
``sconv_fused.supported`` and ``fits_budget``).

Enabled by ``ExecutionPolicy(autotune=True)``; off by default.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import os
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

_CACHE: Dict[str, str] = {}
_TIMES: Dict[str, Dict[str, float]] = {}  # key -> arm -> seconds (reporting)
_LOCK = threading.RLock()
_LOADED_FILES: set = set()
_MEASURING = threading.local()
# graph-calibration overrides: consulted before _CACHE, so calibrate_graph
# can time the whole net over candidate per-key assignments without
# touching the persistent table until a winner is chosen
_OVERRIDES: Dict[str, str] = {}
_RECORDING = threading.local()
# active net scope for calibrated assignments (see net_scope): a demotion
# found on one net's composition is served only inside that net's scope,
# as "net=<tag>|<key>" entries of the same table
_NET_SCOPE: Optional[str] = None

ARMS = ("unroll", "gathered", "gathered_cols", "dense", "fused")
_TOGGLES = ("CESCOIN_XBSP_NOPAD",)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scoped_key(key: str, tag: Optional[str]) -> str:
    return f"net={tag}|{key}" if tag else key


@contextlib.contextmanager
def net_scope(tag: Optional[str]):
    """Serve the calibrated arm assignments of net ``tag`` (falling back to
    the global per-(shape, pattern) table) inside the context."""
    global _NET_SCOPE
    prev = _NET_SCOPE
    _NET_SCOPE = tag
    try:
        yield
    finally:
        _NET_SCOPE = prev


def _pattern_sig(aligned) -> Tuple[int, int, int, int]:
    """Pattern signature: an arm's cost depends on block counts, not on
    which blocks are live. Read from the host pattern, once per weight."""
    bsc = aligned.bsc
    sig = bsc.memo.get("sig")
    if sig is None:
        block_row, bcol_nnz = bsc.pattern()
        union = {int(block_row[j, s]) for j in range(block_row.shape[0])
                 for s in range(int(bcol_nnz[j]))}
        sig = bsc.memo["sig"] = (int(bcol_nnz.sum()), len(union),
                                 int(block_row.shape[0]), bsc.n_brows)
    return sig


@functools.lru_cache(maxsize=None)
def _device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


def cache_key(aligned, x_shape, stride, padding, dilation, dtype) -> str:
    """repr of (device, x_shape, dtype, kernel, stride, padding, dilation,
    cin_pad, cout, groups, block_shape, pattern signature); the device is
    the weight's: "cuda:<name>" or "cpu"."""
    parts = (_device_label(aligned.bsc.blocks.device), tuple(x_shape),
             str(dtype), tuple(aligned.kernel_shape), tuple(stride),
             tuple(padding), tuple(dilation), aligned.cin_pad, aligned.cout,
             aligned.groups, tuple(aligned.bsc.block_shape),
             _pattern_sig(aligned))
    return repr(parts)


_FINGERPRINT: Optional[str] = None


def code_fingerprint() -> str:
    """Hash of the port's kernel sources (``kernels/*.py``, ``csrc/*``) and
    of the toggles that change what an arm runs (``CESCOIN_XBSP_NOPAD``).
    A cached arm is a measurement of that code: a cache file records this
    fingerprint and is ignored whole when it differs. Cached per process,
    so set the toggles before first use."""
    global _FINGERPRINT
    if _FINGERPRINT is None:
        h = hashlib.sha256()
        for sub, suffix in (("kernels", ".py"), ("csrc", "")):
            d = os.path.join(_ROOT, sub)
            for name in sorted(os.listdir(d)):
                path = os.path.join(d, name)
                if os.path.isfile(path) and name.endswith(suffix):
                    h.update(name.encode())
                    with open(path, "rb") as fh:
                        h.update(fh.read())
        for toggle in _TOGGLES:
            h.update(f"{toggle}={os.environ.get(toggle, '')}".encode())
        _FINGERPRINT = h.hexdigest()[:16]
    return _FINGERPRINT


def _load_file(path: str) -> None:
    with _LOCK:
        if not path or path in _LOADED_FILES:
            return
        _LOADED_FILES.add(path)
        if os.path.exists(path):
            try:
                with open(path) as fh:
                    data = json.load(fh)
            except (OSError, json.JSONDecodeError):
                return
            ver = data.pop("__kernel_fingerprint__", None)
            if ver != code_fingerprint():
                print(f"[autotune] cache {path} was measured against "
                      f"different kernel code ({ver} != "
                      f"{code_fingerprint()}); ignoring it: arms will be "
                      f"re-measured", flush=True)
                return
            _CACHE.update(data)


def _save_file(path: str) -> None:
    if not path:
        return
    try:
        with open(path, "w") as fh:
            json.dump({"__kernel_fingerprint__": code_fingerprint(),
                       **_CACHE}, fh, indent=0)
    except OSError as e:
        print(f"[autotune] could not write {path}: {e}", flush=True)


def _dtype(policy) -> torch.dtype:
    return (policy.compute_dtype if policy.compute_dtype is not None
            else torch.float32)


def measure_arms(aligned, policy, x_shape, stride, padding, dilation,
                 *, iters: int = 10) -> Dict[str, float]:
    """Time each candidate arm on synthetic inputs of the real shape, on
    the weight's device. Returns arm -> seconds."""
    from caffe_escoin_tpu_torch.kernels import sconv_fused
    from caffe_escoin_tpu_torch.kernels import xla_block_sparse as xbs
    from caffe_escoin_tpu_torch.ops import conv as conv_ops
    from caffe_escoin_tpu_torch.utils.benchmark import device_time_arms

    dtype = _dtype(policy)
    dev = aligned.bsc.blocks.device
    stride, padding, dilation = tuple(stride), tuple(padding), tuple(dilation)
    # 4 distinct inputs cycled per measurement: one buffer repeated stays
    # in cache across calls and under-reports memory-bound arms
    gen = torch.Generator(device=dev).manual_seed(0)
    xsets = [(torch.randn(tuple(x_shape), generator=gen, device=dev
                          ).to(dtype),) for _ in range(4)]
    x = xsets[0][0]
    wd = aligned.dense.to(dtype)
    geo = dict(stride=stride, padding=padding, dilation=dilation)
    cands = {
        "unroll": lambda y: xbs.conv(y, aligned, **geo),
        "gathered": lambda y: xbs.conv_gathered(y, aligned, **geo),
        "gathered_cols": lambda y: xbs.conv_gathered_cols(y, aligned, **geo),
        "dense": lambda y: conv_ops.conv2d_dense(
            y, wd, aligned.bias, groups=aligned.groups, **geo),
    }
    # the hand-written direct kernel competes only when opted in, and only
    # where the dispatcher would run it: the reference's gate, size budget
    # included (as the JAX package's Pallas fused kernel)
    if (os.environ.get("CESCOIN_AUTOTUNE_FUSED")
            and sconv_fused.supported(x, aligned, stride=stride,
                                      dilation=dilation)
            and sconv_fused.fits_budget(x, aligned, padding)):
        cands["fused"] = lambda y: sconv_fused.sconv(
            y, aligned, padding=padding, relu=False,
            mxu_dtype=policy.mxu_dtype)
    # every candidate runs every shape it is offered here, so an arm that
    # raises is a fault and fails the measurement: it is never dropped in
    # favour of another arm. The arms are timed in turn, round by round, so
    # that a passing slowdown of the device cannot inflate one arm alone
    return device_time_arms(cands, xsets, iters=max(iters, 8))


def choose_arm(aligned, policy, x_shape, stride, padding, dilation,
               *, log=None) -> Optional[str]:
    """The cached measured winner for this (shape, pattern), measured now
    if absent; None when called re-entrantly from inside a measurement.
    Raises if it would measure while a CUDA graph is being captured: fill
    the cache before any capture."""
    if getattr(_MEASURING, "active", False):
        return None  # re-entrant call from inside a candidate arm
    path = (getattr(policy, "autotune_cache", "")
            or os.environ.get("CESCOIN_AUTOTUNE_CACHE", ""))
    _load_file(path)
    key = cache_key(aligned, x_shape, stride, padding, dilation,
                    _dtype(policy))
    rec = getattr(_RECORDING, "keys", None)
    with _LOCK:
        if key in _OVERRIDES:
            if rec is not None:
                rec.append((key, _OVERRIDES[key]))
            return _OVERRIDES[key]
        if _NET_SCOPE is not None:
            skey = _scoped_key(key, _NET_SCOPE)
            if skey in _CACHE:
                if rec is not None:
                    rec.append((key, _CACHE[skey]))
                return _CACHE[skey]
        if key in _CACHE:
            if rec is not None:
                rec.append((key, _CACHE[key]))
            if (os.environ.get("CESCOIN_AUTOTUNE_LOG_HITS")
                    and rec is None):
                # a served pick is not a fresh measurement: after a code
                # change, delete the cache file to re-measure
                print(f"[autotune] cached arm '{_CACHE[key]}' for "
                      f"{tuple(x_shape)} k{aligned.kernel_shape} "
                      f"cout{aligned.cout} (no re-measurement)", flush=True)
            return _CACHE[key]
    if (aligned.bsc.blocks.is_cuda
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(
            f"autotune: no cached arm for {tuple(x_shape)} "
            f"k{aligned.kernel_shape} cout{aligned.cout} during CUDA-graph "
            f"capture; run the forward once (or calibrate) before capturing")
    _MEASURING.active = True
    try:
        times = measure_arms(aligned, policy, x_shape, stride, padding,
                             dilation)
    finally:
        _MEASURING.active = False
    winner = min(times, key=times.get)
    with _LOCK:
        _CACHE[key] = winner
        _TIMES[key] = times
        _save_file(path)
    if rec is not None:
        rec.append((key, winner))
    if log is not None:
        pretty = " ".join(f"{a}={t * 1e6:.0f}us" for a, t in sorted(
            times.items()))
        log(f"autotune {tuple(x_shape)} k{aligned.kernel_shape} "
            f"cout{aligned.cout}: {pretty} -> {winner}")
    return winner


@contextlib.contextmanager
def record_keys():
    """Collect every (cache_key, arm) served to choose_arm callers inside
    the context, cache hits included, with multiplicity: the arm decisions
    a whole-net forward depends on."""
    prev = getattr(_RECORDING, "keys", None)
    _RECORDING.keys = []
    try:
        yield _RECORDING.keys
    finally:
        _RECORDING.keys = prev


def _key_traffic(key: str, mult: int = 1) -> float:
    """Rough share of the time from the key itself (x_shape, stride, cout
    at positions 1, 4, 8): input + output elements times multiplicity.
    Orders the polish trials."""
    import ast

    try:
        t = ast.literal_eval(key)
        n, h, w, c = t[1]
        sh, sw = t[4]
        cout = t[8]
        return float(mult) * (n * h * w * c
                              + n * (h // sh) * (w // sw) * cout)
    except (ValueError, SyntaxError, TypeError, IndexError):
        return 0.0


def calibrate_graph(time_fn: Callable[[], float], *,
                    margin: float = 0.02,
                    keep_margin: float = 0.005,
                    max_flips: Optional[int] = None,
                    polish: int = 0,
                    cache_path: Optional[str] = None,
                    net_tag: Optional[str] = None,
                    log=None) -> Dict:
    """Whole-graph check of the per-layer autotuned arm assignment.

    Isolated measurement keeps each layer's weights cache-warm, which
    flatters schedules of many small products; composed in a real net
    those picks can lose to the dense floor. ``time_fn`` runs and times
    the whole forward (each forward consults choose_arm per layer) and
    returns seconds. Algorithm:

    1. Run the current assignment, recording the (key, arm) decisions
       (this forward measures every key not cached yet).
    2. Time the all-dense assignment (the graph-scope dense floor).
    3. If the current assignment is within ``margin`` of the floor, keep
       it. Otherwise re-enable each key's isolated winner, highest
       estimated gain first (from the isolated times when available),
       keeping a flip only when the whole-graph time improves by
       ``keep_margin``.
    4. ``polish``: up to that many trials of another arm ("dense",
       "unroll", "gathered", "gathered_cols") on the keys with the most
       traffic, each kept only when it improves by ``keep_margin``.
    5. Persist the winners to the cache (the file ``cache_path``, else
       ``$CESCOIN_AUTOTUNE_CACHE``). With ``net_tag``, a key whose arm
       changed is stored under "net=<tag>|<key>" (served inside
       ``net_scope(tag)``), so that one net's composition does not force
       another net's identical layer; unchanged keys stay global.

    Unlike the JAX module, which compares each trial with the best time
    read so far, every comparison here (2-4) times the trial between two
    fresh readings of the assignment it would replace and takes the
    faster of those, so that a reading taken in another state of the
    device (its clocks, its caches, the host beside it) does not decide
    a trial. The rule was added when the port's readings were eager
    times, which drifted by up to 45% between calls and read high just
    after measurement; a ``time_fn`` of CUDA-graph replays
    (``utils/benchmark.device_time``) leaves the host out of the reading.
    On a deterministic ``time_fn`` both rules decide alike.

    Returns a report with the timings and the final arms.
    """
    with record_keys() as rec:
        t_first = t_cur = time_fn()
    mult: Dict[str, int] = {}
    arms: Dict[str, str] = {}
    for key, arm in rec:
        mult[key] = mult.get(key, 0) + 1
        arms[key] = arm
    sparse_keys = [k for k, a in arms.items() if a != "dense"]
    report = {"t_first": t_first, "t_isolated": t_cur, "keys": len(arms),
              "sparse_keys": len(sparse_keys)}
    path = (cache_path if cache_path is not None
            else os.environ.get("CESCOIN_AUTOTUNE_CACHE", ""))
    if not sparse_keys:
        report.update(t_final=t_cur, t_dense=None, flips=0,
                      arms=dict(arms))
        return report

    def set_overrides(d):
        with _LOCK:
            _OVERRIDES.clear()
            _OVERRIDES.update(d)

    def paired(incumbent, trial):
        """(incumbent's time, trial's time): the trial timed between two
        readings of the incumbent, of which the faster counts."""
        set_overrides(incumbent)
        t0 = time_fn()
        set_overrides(trial)
        t = time_fn()  # a forward that raises is a fault
        set_overrides(incumbent)
        return min(t0, time_fn()), t

    try:
        assign = {k: "dense" for k in sparse_keys}
        t_cur, t_dense = paired(dict(arms), assign)
        report.update(t_isolated=t_cur, t_dense=t_dense)
        flips = 0
        if t_cur <= t_dense * (1.0 + margin):
            # the isolated picks compose fine: keep them
            assign = dict(arms)
            best = t_cur
            flips = len(sparse_keys)
            if log:
                log(f"calibrate_graph: isolated assignment stands "
                    f"({t_cur * 1e3:.3f}ms vs dense floor "
                    f"{t_dense * 1e3:.3f}ms)")
        else:
            def gain(k):
                t = _TIMES.get(k, {})
                if arms[k] in t and "dense" in t:
                    return (t["dense"] - t[arms[k]]) * mult[k]
                return 0.0

            order = sorted(sparse_keys, key=gain, reverse=True)
            if max_flips is not None:
                order = order[:max_flips]
            best = t_dense
            for k in order:
                best, t = paired(assign, {**assign, k: arms[k]})
                if t < best * (1.0 - keep_margin):
                    if log:
                        log(f"calibrate_graph: keep {arms[k]} for "
                            f"{k[:72]}... ({t * 1e3:.3f}ms vs "
                            f"{best * 1e3:.3f}ms)")
                    assign[k] = arms[k]
                    best = t
                    flips += 1

        trials = 0
        if polish > 0:
            order2 = sorted(assign, key=lambda k: -_key_traffic(
                k, mult.get(k, 1)))
            for k in order2:
                if trials >= polish:
                    break
                for alt in ("dense", "unroll", "gathered", "gathered_cols"):
                    if alt == assign[k] or trials >= polish:
                        continue
                    prev = assign[k]
                    best, t = paired(assign, {**assign, k: alt})
                    trials += 1
                    if t < best * (1.0 - keep_margin):
                        if log:
                            log(f"calibrate_graph: polish {prev}->{alt} "
                                f"for {k[:64]}... ({t * 1e3:.3f}ms vs "
                                f"{best * 1e3:.3f}ms)")
                        assign[k] = alt
                        best = t
        report.update(t_final=best, flips=flips, polish_trials=trials,
                      arms=dict(assign))
        with _LOCK:
            for k, arm in assign.items():
                if net_tag and arm != arms.get(k):
                    _CACHE[_scoped_key(k, net_tag)] = arm
                else:
                    _CACHE[k] = arm
            if path:
                _save_file(path)
        if log:
            log(f"calibrate_graph: isolated {t_cur * 1e3:.3f}ms, dense floor "
                f"{t_dense * 1e3:.3f}ms, calibrated {best * 1e3:.3f}ms "
                f"({flips}/{len(sparse_keys)} sparse keys kept, "
                f"{trials} polish trials)")
        return report
    finally:
        set_overrides({})


def report() -> Dict[str, Dict[str, float]]:
    """Measured seconds per arm for every key measured in this process."""
    with _LOCK:
        return {k: dict(v) for k, v in _TIMES.items()}


def clear() -> None:
    with _LOCK:
        _CACHE.clear()
        _TIMES.clear()
        _LOADED_FILES.clear()
