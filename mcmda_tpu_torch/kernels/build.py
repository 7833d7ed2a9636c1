"""Build and load the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` into a
shared library with a plain C interface, which is loaded with ``ctypes``.
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

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
SOURCES = ("fused_conv.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def nvcc_path() -> str:
    """The toolkit's ``nvcc``, found the way PyTorch finds its CUDA home
    (``CUDA_HOME``/``CUDA_PATH``, then ``nvcc`` on ``PATH``, then the
    default install location)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: building the fused conv kernel needs the CUDA "
            "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
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
    # compile to a temporary name, then rename: a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp,
         *(str(CSRC / s) for s in SOURCES)], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    (out.parent / "nvcc.log").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with the C
    signatures declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mcmda_conv_bn_act.argtypes = [p, i, p, p, p, p, i, p,
                                          i, i, i, i, i, i, i, p]
        lib.mcmda_conv_bn_act.restype = i
        _lib = lib
    return _lib
