"""ctypes bindings for the repository's native host library (port of
``caffe_escoin_tpu/data/native.py``).

The library is built from the JAX package's C++ sources, ``csrc/
recordio.cc`` (the ``.cerec`` reader and its prefetching worker threads),
``csrc/csrpack.cc`` (the dense -> BSC packer) and ``csrc/sconv.cc`` (the
blocked direct sparse conv on the host, the reference's
``caffe_cpu_blocked_sconv``), with ``g++`` and the flags of
``csrc/Makefile``. It goes to ``build/native/`` at the repository root
(listed in ``.gitignore``) under a name keyed by a hash of the sources, the
flags and the host's target (``-march=native`` resolves per CPU), so an
edit rebuilds and a copy of the tree on another machine builds its own.
Nothing is written under ``csrc/``. Concurrent processes serialise on a
lock file, and the library is written to a temporary name and renamed into
place. Nothing happens at import: the first caller builds.

As in the JAX module, ``load_library`` returns None when the library
cannot be built (no compiler: ``build_error`` says why),
``NativeCerecLoader`` raises then, and ``native_bsc_sconv`` and
``native_bsc_pack`` return None.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from caffe_escoin_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "csrc"
SOURCES = ("recordio.cc", "csrpack.cc", "sconv.cc")
BUILD_DIR = ROOT / "build" / "native"
# csrc/Makefile's CXXFLAGS, and its link line's
CXXFLAGS = ["-O3", "-march=native", "-funroll-loops", "-std=c++17", "-fPIC",
            "-Wall", "-pthread"]
LDFLAGS = ["-shared", "-pthread"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
build_error: Optional[str] = None  # why the last build attempt failed

_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I64 = ctypes.c_int64


def _cxx() -> Optional[str]:
    return shutil.which(os.environ.get("CXX", "g++"))


def library_path(cxx: str) -> Path:
    """Where the library for these sources, flags and host target lives."""
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, timeout=60).stdout
    h = hashlib.sha256(" ".join([cxx, *CXXFLAGS, *LDFLAGS]).encode())
    h.update(target.encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libcescoin_{h.hexdigest()[:16]}.so"


def _compile(cxx: str, args) -> None:
    proc = subprocess.run([cxx, *args], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                           f"{proc.stderr}\n{proc.stdout}")


def build() -> Path:
    """Compile the sources unless the library for this tree and host exists:
    one ``g++ -c`` per source, all started together, then one link, in a
    private directory; the library is renamed into place under a lock.
    The compile and link are the set-up span ``setup:native_build``."""
    cxx = _cxx()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        try:
            with trace.span("setup:native_build", always=True):
                objs = [str(tmp / (Path(s).stem + ".o")) for s in SOURCES]
                with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
                    for f in [pool.submit(_compile, cxx,
                                          [*CXXFLAGS, "-c", str(CSRC / s),
                                           "-o", o])
                              for s, o in zip(SOURCES, objs)]:
                        f.result()
                _compile(cxx, [*LDFLAGS, "-o", str(tmp / out.name), *objs])
            os.replace(tmp / out.name, out)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def load_library() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None when it cannot be
    built (``build_error`` holds the reason). One attempt per process."""
    global _LIB, _TRIED, build_error
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        so = build()
    except Exception as e:  # no toolchain, or a compiler error
        build_error = f"{type(e).__name__}: {e}"
        return None
    lib = ctypes.CDLL(str(so))
    lib.cerec_open.restype = ctypes.c_void_p
    lib.cerec_open.argtypes = [ctypes.c_char_p]
    lib.cerec_num.restype = ctypes.c_uint64
    lib.cerec_num.argtypes = [ctypes.c_void_p]
    lib.cerec_sample_elems.restype = ctypes.c_uint64
    lib.cerec_sample_elems.argtypes = [ctypes.c_void_p]
    lib.cerec_close.argtypes = [ctypes.c_void_p]
    lib.cerec_close.restype = None
    lib.cerec_prefetcher_start.restype = ctypes.c_void_p
    lib.cerec_prefetcher_start.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int]
    lib.cerec_prefetcher_next.restype = ctypes.c_int
    lib.cerec_prefetcher_next.argtypes = [ctypes.c_void_p, _F32, _I32]
    lib.cerec_prefetcher_stop.argtypes = [ctypes.c_void_p]
    lib.cerec_prefetcher_stop.restype = None
    lib.bsc_scan.restype = ctypes.c_int64
    lib.bsc_scan.argtypes = [_F32, _I64, _I64, _I64, _I64, _I32,
                             ctypes.c_int]
    lib.bsc_pack.argtypes = [_F32, _I64, _I64, _I64, _I64, _I64, _F32, _I32,
                             ctypes.c_int]
    lib.bsc_pack.restype = None
    lib.bsc_sconv.restype = ctypes.c_int
    lib.bsc_sconv.argtypes = [
        _F32, _I64, _I64, _I64, _I64, _F32, _I32, _I32, *[_I64] * 12,
        ctypes.c_void_p, ctypes.c_int, _F32, ctypes.c_int]
    _LIB = lib
    return lib


def _bsc_arrays(bsc):
    """(blocks f32, block_row i32, bcol_nnz i32) of a BSC as contiguous host
    numpy arrays, converted once per BSC object."""
    if "native" not in bsc.memo:
        bsc.memo["native"] = (
            np.ascontiguousarray(bsc.blocks.detach().float().cpu().numpy()),
            np.ascontiguousarray(bsc.block_row.cpu().numpy(), np.int32),
            np.ascontiguousarray(bsc.bcol_nnz.cpu().numpy(), np.int32))
    return bsc.memo["native"]


def native_bsc_sconv(x, aligned, *, padding=(0, 0), stride=(1, 1),
                     relu=False, threads: int = 0):
    """Blocked direct sparse conv on the host (csrc/sconv.cc, the reference's
    CPU product path, `include/caffe/util/sconv.hpp:83-678`). x: [N,H,W,Cin]
    f32 numpy; ``aligned`` an AlignedConvWeight with a BSC. Returns
    [N,Ho,Wo,Cout] f32, or None when the library (or the BSC) is
    unavailable. Groups ride the block-diagonal BSC; dilation is not
    supported (the caller checks)."""
    lib = load_library()
    if lib is None:
        return None
    bsc = aligned.bsc
    if bsc is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    n, h, w, cin = x.shape
    if cin != aligned.cin:
        raise ValueError(f"x has {cin} channels, the weight {aligned.cin}")
    kh, kw = aligned.kernel_shape
    ph, pw = padding
    sh, sw = stride
    ho = (h + 2 * ph - kh) // sh + 1
    wo = (w + 2 * pw - kw) // sw + 1
    bk, bn = bsc.block_shape
    blocks, block_row, bcol_nnz = _bsc_arrays(bsc)
    bias_p = None
    if aligned.bias is not None:
        if "native_bias" not in bsc.memo:
            bsc.memo["native_bias"] = np.ascontiguousarray(
                aligned.bias.detach().float().cpu().numpy())
        bias_p = bsc.memo["native_bias"].ctypes.data_as(ctypes.c_void_p)
    out = np.empty((n, ho, wo, aligned.cout), np.float32)
    if threads <= 0:
        threads = min(8, os.cpu_count() or 1)
    rc = lib.bsc_sconv(
        x, n, h, w, cin, blocks, block_row, bcol_nnz, block_row.shape[0],
        block_row.shape[1] if block_row.ndim > 1 else 1, bk, bn,
        aligned.cin_pad, kh, kw, ph, pw, sh, sw, aligned.cout, bias_p,
        int(bool(relu)), out, threads)
    if rc != 0:
        return None
    return out


class NativeCerecLoader:
    """Batches of a .cerec file from the C++ prefetcher (``workers``
    threads filling a queue of ``capacity`` batches; shuffled draws from
    per-worker generators seeded from ``seed``). Yields {"data": [B, ...]
    f32, "label": [B] int32} numpy batches. A batch that takes longer than
    ``timeout`` seconds raises TimeoutError. Close it (``close``, or use it
    as a context manager) to stop and join its threads."""

    def __init__(self, path: str, batch: int, sample_shape, *,
                 shuffle: bool = False, seed: int = 0, workers: int = 2,
                 capacity: int = 4, timeout: float = 60.0):
        lib = load_library()
        if lib is None:
            raise RuntimeError(f"native library unavailable ({build_error})")
        self._lib = lib
        self._pf = None
        self._file = lib.cerec_open(str(path).encode())
        if not self._file:
            raise IOError(f"cannot open {path}")
        self.num = lib.cerec_num(self._file)
        self.sample_shape = tuple(sample_shape)
        elems = int(np.prod(self.sample_shape))
        held = lib.cerec_sample_elems(self._file)
        if elems != held:
            lib.cerec_close(self._file)
            self._file = None
            raise ValueError(f"{path}: samples hold {held} elements, not "
                             f"the {elems} of {self.sample_shape}")
        self.batch = batch
        self.timeout = timeout
        # the blocking C call runs on a thread of its own, so a wait can end
        # with a timeout; a call that timed out still holds the prefetcher,
        # which close() then leaves running rather than free under it
        self._caller = ThreadPoolExecutor(max_workers=1)
        self._pending = None
        self._pf = lib.cerec_prefetcher_start(
            self._file, batch, int(shuffle), seed, workers, capacity)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._pf is None:
            raise StopIteration
        data = np.empty((self.batch,) + self.sample_shape, np.float32)
        labels = np.empty((self.batch,), np.int32)
        fut = self._caller.submit(self._lib.cerec_prefetcher_next, self._pf,
                                  data.reshape(-1), labels)
        try:
            rc = fut.result(timeout=self.timeout)
        except FutureTimeout:
            self._pending = fut
            raise TimeoutError(f"NativeCerecLoader: no batch within "
                               f"{self.timeout} s") from None
        if rc != 0:
            raise StopIteration
        return {"data": data, "label": labels}

    def close(self):
        if self._pf is not None and (self._pending is None
                                     or self._pending.done()):
            self._lib.cerec_prefetcher_stop(self._pf)
            if self._file:
                self._lib.cerec_close(self._file)
        self._pf = self._file = None
        if getattr(self, "_caller", None) is not None:
            self._caller.shutdown(wait=self._pending is None)
            self._caller = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def native_bsc_pack(w: np.ndarray, block_shape, threads: int = 8):
    """Dense (K, N) -> padded BSC arrays via the native packer
    (csrc/csrpack.cc). Returns (blocks, block_row, bcol_nnz, max_bw), the
    arrays of ``sparse.dense_to_bsc``, or None when the library is
    unavailable."""
    lib = load_library()
    if lib is None:
        return None
    w = np.ascontiguousarray(w, np.float32)
    rows, cols = w.shape
    bk, bn = block_shape
    n_bcols = -(-cols // bn)
    bcol_nnz = np.zeros(n_bcols, np.int32)
    max_bw = int(lib.bsc_scan(w, rows, cols, bk, bn, bcol_nnz, threads))
    blocks = np.zeros((n_bcols, max_bw, bk, bn), np.float32)
    block_row = np.zeros((n_bcols, max_bw), np.int32)
    lib.bsc_pack(w, rows, cols, bk, bn, max_bw, blocks.reshape(-1),
                 block_row.reshape(-1), threads)
    return blocks, block_row, bcol_nnz, max_bw
