"""Build and load the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` -- one
process per source, all started together -- and linked into one shared
library with a plain C interface, which is loaded with ``ctypes``.
The library lands in ``_build/<hash>/`` beside this file, keyed by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads straight away.  Nothing here runs at import time: a machine without a
CUDA toolkit can import this module, and fails only when it asks for the
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("fused_conv.cu", "train_conv.cu", "warp.cu", "thin_conv.cu")
HEADERS = ("conv_tile.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def nvcc_path() -> str:
    """The toolkit's ``nvcc``, found the way PyTorch finds its CUDA home
    (``CUDA_HOME``/``CUDA_PATH``, then ``nvcc`` on ``PATH``, then the
    default install location)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: building the port's CUDA kernels needs the "
            "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (unless this exact build exists) and return the
    library's path.  The compiler's report (ptxas registers, shared memory
    and spills per kernel) is kept beside it as ``nvcc.log``."""
    out = BUILD_DIR / _digest() / "libmcmda_kernels.so"
    if out.exists():
        return out
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, s + ".o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                                   str(CSRC / s)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(s, p.returncode, log) for s, p, log
                  in zip(SOURCES, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{s} ({rc}):\n{log}" for s, rc, log in failed))
        # link to a temporary name, then rename: a concurrent loader never
        # sees a half-written library
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        (out.parent / "nvcc.log").write_text("".join(logs))
        os.replace(lib, out)
    return out


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the library's entry points (undeclared,
    ctypes would pass pointers as 32-bit ints)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    signatures = {
        "mcmda_conv_bn_act": [p, i, p, p, p, p, p, p, i, p, i, i, i, i, i, i,
                              i, p],
        "mcmda_conv_plan": [i, i, i, i, i, i, i, p],
        "mcmda_conv_smem_bytes": [i, i, i],
        "mcmda_conv_stats": [p, p, p, p, p, p, p, p, i, i, i, i, i, i, p],
        "mcmda_conv_stats_partial_tiles": [i],
        "mcmda_split_weights": [p, p, p, i, i, p],
        "mcmda_warp_affine": [p, p, p, i, i, i, i, i, p],
        "mcmda_stem_conv": [p, p, p, i, i, i, i, i, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with the C
    signatures declared."""
    global _lib
    if _lib is None:
        _lib = declare(ctypes.CDLL(str(build())))
    return _lib


def check(name: str, t, shape, dtypes, device) -> None:
    """Raise unless tensor ``t`` lies on ``device``, has a dtype in
    ``dtypes``, the given shape, and is contiguous: what a kernel's pointer
    arithmetic assumes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {tuple(dtypes)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(name: str, device, *args) -> None:
    """Call the library's C entry point ``name`` with ``args`` and, as its
    last argument, the current stream of ``device``, on that device; raise
    if it reports a CUDA error (a refused launch never runs, and no later
    synchronisation would report it)."""
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
