"""Build the port's CUDA sources at first use and load them with ctypes.

Each source under ``kernels/<name>/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface.  The
library lands in ``build/kernels/`` at the root of the checkout (listed
in ``.gitignore``), named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads at once.  Nothing here
runs at import: the CPU tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parents[2] / "build" / "kernels"

# name -> CUDA source; one nvcc process per source
SOURCES: Dict[str, Path] = {
    "weighted_agg": _HERE / "weighted_agg" / "csrc" / "weighted_agg.cu",
    "flash_attention": (_HERE / "flash_attention" / "csrc"
                        / "flash_attention.cu"),
    "flash_attention_bwd": (_HERE / "flash_attention" / "csrc"
                            / "flash_attention_bwd.cu"),
    "ssd_scan": _HERE / "ssd_scan" / "csrc" / "ssd_scan.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("the CUDA toolkit (nvcc) was not found; set "
                           "CUDA_HOME or put nvcc on PATH")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every library that is not built yet, all nvcc processes
    started together.  Returns ``{name: {"seconds", "cached", "log"}}``
    (``log`` holds nvcc's ptxas report: registers, spills)."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    out: Dict[str, dict] = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, path)      # atomic: concurrent builds agree
        out[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                     "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    path = library_path(name)
    if not path.exists():
        build_all([name])
    return ctypes.CDLL(str(path))
