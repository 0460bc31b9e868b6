"""Build the package's CUDA source with ``nvcc`` at first use.

``csrc/fused_round.cu`` has a plain C interface and becomes one shared
library, loaded with :mod:`ctypes` by its wrapper module.  The library is
named by a hash of the source and the flags, so an edited source is rebuilt
and a stale library is never loaded.  It goes into ``_build/`` beside this
file, which ``.gitignore`` lists; a build writes to a temporary name and
renames it into place, so concurrent processes never load a partial file.

``nvcc -Xptxas -v`` reports each kernel's registers, shared memory and
spills; the report is kept beside the library (:func:`ptxas_report`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE / "_build"

#: the CUDA source, relative to this directory
SOURCE = "csrc/fused_round.cu"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: list[ctypes.CDLL] = []


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256((HERE / SOURCE).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfused_round-{h.hexdigest()[:16]}.so"


def ptxas_report() -> str:
    """What ``-Xptxas -v`` printed when the library was built ('' if cached)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build() -> Path:
    """Compile the library unless it is already built; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(HERE / SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE}:\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    if not _LOADED:
        _LOADED.append(ctypes.CDLL(str(build())))
    return _LOADED[0]
