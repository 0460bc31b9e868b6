"""Build the package's CUDA sources with ``nvcc`` at first use.

Every source in ``csrc/`` has a plain C interface and becomes a shared
library of its own, loaded with :mod:`ctypes` by its wrapper module.  The
first :func:`load` builds every library that is missing, one ``nvcc`` per
library, all started together.  A library is named by a hash of its source,
the shared headers and the flags, so an edited source is rebuilt and a stale
library is never loaded.  Libraries go into ``_build/`` beside this file,
which ``.gitignore`` lists; ``nvcc`` writes to a temporary name that is
renamed into place, so concurrent processes never load a partial file.

``nvcc -Xptxas -v`` reports each kernel's registers, shared memory and
spills; the report is kept beside each library (:func:`ptxas_report`).
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

#: the CUDA sources, relative to this directory, and the headers they share
SOURCES = ("csrc/fused_round.cu", "csrc/pairwise_dist.cu",
           "csrc/segment_mean.cu", "csrc/flash_attention.cu",
           "csrc/conv_pool.cu")
HEADERS = ("csrc/common.cuh", "csrc/reg_sweep.cuh")

FLAGS = ("-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
_error_string = None


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


def library_path(source: str) -> Path:
    """Where ``source``'s library lives: named by source, headers and flags."""
    h = hashlib.sha256()
    for name in (source,) + HEADERS:
        h.update(name.encode())
        h.update((HERE / name).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:16]}.so"


def ptxas_report() -> str:
    """What ``-Xptxas -v`` printed for the libraries this build compiled
    ('' for one that was cached)."""
    logs = [library_path(src).with_suffix(".log") for src in SOURCES]
    return "".join(f"== {log.read_text()}" for log in logs if log.exists())


def build() -> list[Path]:
    """Compile every library that is not built yet; returns their paths."""
    paths = [library_path(src) for src in SOURCES]
    todo = [(src, out) for src, out in zip(SOURCES, paths) if not out.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    for src, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        jobs.append((src, out, tmp, subprocess.Popen(
            [nvcc, *FLAGS, "-o", str(tmp), str(HERE / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = [proc.communicate()[0] for *_, proc in jobs]
    for (src, out, tmp, proc), log in zip(jobs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        out.with_suffix(".log").write_text(f"{src}\n{log}")
        os.replace(tmp, out)
    return paths


def load(source: str) -> ctypes.CDLL:
    """``source``'s loaded library, every missing library built first."""
    global _error_string
    if source not in _LOADED:
        lib = ctypes.CDLL(str(build()[SOURCES.index(source)]))
        lib.kernels_error_string.argtypes = [ctypes.c_int]
        lib.kernels_error_string.restype = ctypes.c_char_p
        _error_string = lib.kernels_error_string
        _LOADED[source] = lib
    return _LOADED[source]


def raise_on(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = _error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
