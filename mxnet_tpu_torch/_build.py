"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes).  All sources that lack a current build are compiled at once, one
``nvcc`` process per source.  A library is named after a hash of its source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and an unchanged one is reused.
Builds go to ``build/`` inside this package, which ``.gitignore`` lists.

Importing this module needs neither ``nvcc`` nor a GPU; only ``build`` and
``load`` do.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

from .base import MXNetError

__all__ = ["BUILD_DIR", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise MXNetError("nvcc not found: the CUDA kernels are built on a "
                     "machine with the CUDA toolkit")


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / ("lib%s_%s.so" % (src.stem, digest.hexdigest()[:16]))


def build() -> Dict[str, dict]:
    """Compile every ``csrc/*.cu`` that lacks a current library, all
    ``nvcc`` processes running together.  Returns ``{name: {"path",
    "seconds", "log", "built"}}``; ``log`` holds nvcc's output (register and
    shared-memory use from ``-Xptxas -v``)."""
    with _lock:
        return _build_locked(sorted(CSRC.glob("*.cu")))


def _build_locked(srcs) -> Dict[str, dict]:
    out, procs = {}, []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for src in srcs:
        if not src.exists():
            raise MXNetError("no kernel source %s" % src)
        target = _target(src)
        if target.exists():
            out[src.stem] = {"path": str(target), "seconds": 0.0, "log": "",
                             "built": False}
            continue
        tmp = target.with_suffix(".%d.tmp" % os.getpid())
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, target, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, target, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append("%s (exit %d):\n%s" % (src.name, proc.returncode, log))
            continue
        os.replace(tmp, target)
        out[src.stem] = {"path": str(target), "seconds": seconds, "log": log,
                         "built": True}
    if failed:
        raise MXNetError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            info = _build_locked([CSRC / (name + ".cu")])[name]
            lib = ctypes.CDLL(info["path"])
            _libs[name] = lib
    return lib
