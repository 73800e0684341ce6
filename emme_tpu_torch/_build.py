"""Build the package's CUDA kernels with nvcc at first use.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, ``_build/lib<name>-<hash>.so``, loaded with ``ctypes``.
The hash covers the source, the headers in ``csrc`` and the compiler
flags, so an edited source or header builds anew and an unchanged one is
loaded from the previous build.  Only
the sources in the package are read; nothing is fetched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags one source adds to NVCC_FLAGS: the float64 adaptive engine builds
# without FMA contraction, so that its rounding follows the plain version's
# operation for operation (an accept/split decision can turn on the last bit)
EXTRA_FLAGS = {"adaptive": ("--fmad=false",)}


def flags(name: str) -> tuple:
    """nvcc's flags for ``csrc/<name>.cu``."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())

# name -> (loaded library, build record); one build per process
_LOADED: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels in emme_tpu_torch/csrc")


def library_path(name: str) -> Path:
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.h")):   # any a source may include
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its library exists; return the
    build record {"path", "seconds", "log"} (seconds 0.0, log "" when the
    library was already built)."""
    out = library_path(name)
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *flags(name), "-o", str(tmp),
           str(SRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return {"path": str(out), "seconds": seconds,
            "log": proc.stdout + proc.stderr}


def load(name: str):
    """The loaded ``ctypes`` library for ``csrc/<name>.cu``, built first if
    needed; returns (library, build record)."""
    if name not in _LOADED:
        record = build(name)
        _LOADED[name] = (ctypes.CDLL(record["path"]), record)
    return _LOADED[name]
