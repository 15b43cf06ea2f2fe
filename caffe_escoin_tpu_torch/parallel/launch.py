"""Run one function on every rank of a process group.

The JAX package runs a mesh of devices from one program. Torch runs one
process per rank, so the entries that the JAX package runs on a mesh
(``tools/scaling.py``, ``parallel/dryrun.py``) and the parity tests start
the ranks here. ``Ranks(world)`` starts ``world`` processes with the
``spawn`` method, each joined to one group by ``mesh.multihost_init``
through a ``file://`` store in a directory of its own (no TCP port), and
keeps them: every ``run(fn, *args)`` calls ``fn(*args)`` on each rank and
returns the results in rank order. ``fn`` and its arguments are pickled
(``fn`` by its import path) and must be importable in a fresh process.
``run_ranks`` is the one-call form; a world of one runs in this process.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from caffe_escoin_tpu_torch.parallel import mesh as mesh_lib

# seconds a run waits for the ranks' results, and that close() gives each
# process to leave
RUN_TIMEOUT_S = 300.0
JOIN_TIMEOUT_S = 20.0
POLL_S = 1.0  # how often a run checks that its ranks are alive


def _serve(rank: int, world: int, init_method: str, platform: str, jobs,
           results) -> None:
    """A rank's loop: join the group, then run each job until None. On the
    CPU the ranks share the host's cores, so each takes its share of
    torch's threads."""
    if platform == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        mesh_lib.multihost_init(init_method, world, rank, platform=platform)
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, None))
    try:
        while True:
            job = jobs.get()
            if job is None:
                return
            fn, args = job
            try:
                results.put((rank, True, fn(*args)))
            except Exception:  # reported to the parent, which raises it
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankError(RuntimeError):
    """A rank raised: the message holds each failing rank's traceback."""


class Ranks:
    """``world`` processes, ranks 0..world-1 of one group: NCCL with one
    card per rank by default (``platform="auto"``, which raises without a
    card), gloo where the caller passes ``platform="cpu"``. A failed or timed
    out run closes the pool: a rank left inside a collective cannot be
    trusted with the next job."""

    def __init__(self, world: int, *, platform: str = "auto",
                 store_dir: Optional[str] = None,
                 run_timeout_s: float = RUN_TIMEOUT_S):
        self.world = world
        self.run_timeout_s = run_timeout_s
        self._own_dir = store_dir is None
        self._dir = store_dir or tempfile.mkdtemp(prefix="cet_ranks_")
        init_method = "file://" + tempfile.mktemp(prefix="store_",
                                                  dir=self._dir)
        ctx = multiprocessing.get_context("spawn")
        self._results = ctx.Queue()
        self._jobs = [ctx.Queue() for _ in range(world)]
        self._procs = [
            ctx.Process(target=_serve, daemon=True,
                        args=(r, world, init_method, platform, self._jobs[r],
                              self._results))
            for r in range(world)]
        for p in self._procs:
            p.start()
        try:
            self._collect("join the group")
        except BaseException:
            self.close()
            raise

    def _collect(self, what: str) -> List[Any]:
        """One result from each rank. A rank whose process has died
        without one (a crash, or a spawn that could not import its target)
        fails the run at once rather than at the timeout."""
        got, errors = {}, {}
        deadline = time.monotonic() + self.run_timeout_s
        dead = []
        while len(got) + len(errors) < self.world:
            try:
                rank, ok, value = self._results.get(timeout=POLL_S)
                (got if ok else errors)[rank] = value
                continue
            except queue.Empty:
                pass
            # a rank counts as dead on two polls in a row: it may have put
            # its result and exited since the last get
            now_dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive() and r not in got
                        and r not in errors]
            if now_dead and dead:
                raise RankError(
                    f"ranks {now_dead} of {self.world} exited without a "
                    f"result while asked to {what}" + "".join(
                        f"\nrank {r}:\n{tb}"
                        for r, tb in sorted(errors.items())))
            dead = now_dead
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{self.world - len(got) - len(errors)} of {self.world} "
                    f"ranks did not {what} within {self.run_timeout_s} s"
                    + "".join(f"\nrank {r}:\n{tb}"
                              for r, tb in sorted(errors.items())))
        if errors:
            raise RankError(f"{len(errors)} of {self.world} ranks failed to "
                            f"{what}:" + "".join(
                                f"\nrank {r}:\n{tb}"
                                for r, tb in sorted(errors.items())))
        return [got[r] for r in range(self.world)]

    def run(self, fn: Callable, *args) -> List[Any]:
        """``fn(*args)`` on every rank; the results in rank order."""
        if self._procs is None:
            raise RuntimeError("Ranks: closed")
        for q in self._jobs:
            q.put((fn, args))
        try:
            return self._collect(f"run {getattr(fn, '__name__', fn)}")
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Stop the processes (those that do not leave in time are
        killed) and remove the store's directory if it was made here."""
        if self._procs is None:
            return
        procs, self._procs = self._procs, None
        for q in self._jobs:
            q.put(None)
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(JOIN_TIMEOUT_S)
        for q in self._jobs + [self._results]:
            q.close()
            q.join_thread()
        if self._own_dir:
            shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "Ranks":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run_ranks(fn: Callable, world: int, *args,
              platform: str = "auto") -> List[Any]:
    """``fn(*args)`` on each of ``world`` ranks; the results in rank order.
    A world of one runs in this process, in the group that exists or in a
    new one over an in-process store (destroyed after); a larger one in
    ``Ranks`` processes."""
    if world > 1:
        with Ranks(world, platform=platform) as ranks:
            return ranks.run(fn, *args)
    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise RuntimeError("run_ranks(world=1) inside a group of "
                               f"{dist.get_world_size()}")
        return [fn(*args)]
    mesh_lib.multihost_init(platform=platform)
    try:
        return [fn(*args)]
    finally:
        dist.destroy_process_group()
