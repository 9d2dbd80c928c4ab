"""Build and load the port's CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/repro_torch/`` in
the checkout, and loaded with ``ctypes``.  All sources build in
parallel, once, at first use; a library is named by a hash of its
source, the shared headers and the flags, so an edited source is never
served a stale build.  Nothing is built when a module is imported: the
CPU tests import every module and this machine may have no ``nvcc``.

Flags: ``--fmad=false`` keeps every ``a*b + c`` as a rounded multiply
then a rounded add, as the plain PyTorch versions compute it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_all", "function", "check"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every ``csrc/*.cu`` not yet built (one ``nvcc`` each, all
    started together) and load them; returns name -> library.  The
    compiler's register/shared-memory report lands beside each library
    as ``<name>-<hash>.log``."""
    with _LOCK:
        if _LIBS:
            return dict(_LIBS)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        targets = {src.stem: (src, BUILD_DIR / f"{src.stem}-{_digest(src)}.so")
                   for src in sorted(CSRC.glob("*.cu"))}
        procs = {}
        for name, (src, so) in targets.items():
            if so.exists():
                continue
            tmp = so.with_suffix(f".tmp{os.getpid()}.so")
            log = open(so.with_suffix(".log"), "w")
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=log, stderr=subprocess.STDOUT), tmp, so, log)
        failed = []
        for name, (proc, tmp, so, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc:
                failed.append(f"{name}: nvcc exit {rc}, see {so.with_suffix('.log')}:\n"
                              + so.with_suffix(".log").read_text()[-4000:])
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
        for name, (_, so) in targets.items():
            _LIBS[name] = ctypes.CDLL(str(so))
        return dict(_LIBS)


def function(lib: str, name: str, argtypes):
    """C function ``name`` of the library built from ``csrc/<lib>.cu``,
    with its ``argtypes`` declared; every one returns a ``cudaError_t``."""
    fn = getattr(build_all()[lib], name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")
