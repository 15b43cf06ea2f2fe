"""Build and load the package's CUDA kernels.

All ``csrc/*.cu`` sources compile with ``nvcc``, one process per source
in parallel, and link into one shared library with a plain C interface,
loaded with ``ctypes``; no PyTorch headers are involved, so a build takes
seconds. The library goes to ``build/kernels/``
at the repository root (listed in ``.gitignore``) under a name keyed by a
hash of the sources and flags, so an edit rebuilds and an unchanged tree
reuses it. Delete ``build/`` to force a rebuild.

Nothing happens at import: the first kernel launch calls ``load()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from caffe_escoin_tpu_torch.utils import trace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_IP = ctypes.POINTER(ctypes.c_int)
_FP = ctypes.POINTER(ctypes.c_float)
# argtypes of each C entry point: pointers and the stream as c_void_p; the
# integer arguments come as one int array (``c_ints``) and the float ones as
# one float array (``c_floats``), built once per layer shape, since ctypes
# converts each argument anew on every call. Each kernel but the stem conv
# (bf16 only) has a bf16 entry and an f32 one (``_f32``: mxu_dtype
# "float32", or an f32 map for the LRN, the max pool and the conv epilogue)
# with the same arguments.
SIGNATURES = {
    "cet_sconv_fused": [_P] * 7 + [_IP, _P],
    "cet_bsc_spmm": [_P] * 8 + [_IP, _P],
    "cet_sconv_gc": [_P] * 6 + [_IP, _P],
    "cet_lrn": [_P] * 2 + [_IP, _FP, _P],
    "cet_maxpool": [_P] * 2 + [_IP, _P],
    "cet_conv_epilogue": [_P] * 4 + [_IP, _P],
}
SIGNATURES.update({f"{k}_f32": v for k, v in list(SIGNATURES.items())})
SIGNATURES["cet_stem_conv"] = [_P] * 4 + [_IP, _P]

_lib = None
ptxas_log = ""  # nvcc's -Xptxas -v report of that build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels of caffe_escoin_tpu_torch")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcet_kernels_{h.hexdigest()[:16]}.so"


def _run_nvcc(args) -> subprocess.CompletedProcess:
    proc = subprocess.run([_nvcc(), *args], capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr}\n{proc.stdout}")
    return proc


def build() -> Path:
    """Compile the sources unless the library for this tree exists: one
    ``nvcc -c`` per source, all started together, then one link (the
    set-up span ``setup:kernel_build``, only when it compiles)."""
    global ptxas_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = sorted(CSRC.glob("*.cu"))
    # build in a private directory, then rename the library into place: a
    # concurrent build never sees a half-written one
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        with trace.span("setup:kernel_build", always=True):
            objs = [str(tmp / f"{src.stem}.o") for src in cu]
            with ThreadPoolExecutor(max_workers=len(cu)) as pool:
                futures = [pool.submit(_run_nvcc, [*NVCC_FLAGS, "-c", "-o",
                                                   obj, str(src)])
                           for src, obj in zip(cu, objs)]
                logs = [f.result().stderr for f in futures]
            _run_nvcc(["-shared", "-o", str(tmp / out.name), *objs])
        os.replace(tmp / out.name, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ptxas_log = "".join(logs)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use; its loading is the set-up
    span ``setup:kernel_load`` (the build apart)."""
    global _lib
    if _lib is None:
        path = build()
        with trace.span("setup:kernel_load", always=True):
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cet_error_string.argtypes = [ctypes.c_int]
            lib.cet_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def c_ints(*values: int) -> ctypes.Array:
    """An int array for a C entry point's integer arguments."""
    return (ctypes.c_int * len(values))(*values)


def c_floats(*values: float) -> ctypes.Array:
    """A float array for a C entry point's float arguments (each value
    rounded to f32 to nearest)."""
    return (ctypes.c_float * len(values))(*values)


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device, which must be
    the current device (the kernels launch there). Read with the raw
    accessor that Triton's launcher uses too: building the Python
    ``torch.cuda.Stream`` object costs more host time than the launch."""
    index = torch.cuda.current_device()
    if t.device.index != index:
        raise ValueError(f"tensor on {t.device}, current device is "
                         f"cuda:{index}")
    return torch._C._cuda_getCurrentRawStream(index)


def check_operand(t: torch.Tensor, name: str, device, dtypes) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned tensor of one of
    ``dtypes`` on ``device``: what the kernels' loads assume."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        text = load().cet_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({text})")
