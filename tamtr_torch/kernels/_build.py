"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `tamtr_torch/csrc/<name>.cu` exposes a plain C entry point and becomes
`build/lib<name>.so` at the checkout root, compiled for Hopper (`sm_90a`) on
first use. A `csrc/<name>.cpp` is host code (the PNG unfilter), compiled
the same way by the host C++ compiler, so it also builds on machines
without nvcc. One compiler process runs per source, all started together. A library
newer than its source and than every header in `csrc/` (`*.cuh`, `*.h`) is reused. Nothing here runs at import time: the CPU
tests import every module of the port on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

HOST_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def host_sources() -> List[Path]:
    return sorted(CSRC.glob("*.cpp"))


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def host_cxx_path() -> str:
    found = shutil.which("c++") or shutil.which("g++")
    if found is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) found")
    return found


def _compile_all(stale: List[Path]) -> Dict[str, object]:
    """Compile `stale` in parallel; return the wall seconds and the ptxas
    register/spill lines."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in stale:
        tmp = BUILD_DIR / f".lib{src.stem}.{os.getpid()}.so"
        if src.suffix == ".cpp":
            cmd = [host_cxx_path(), *HOST_FLAGS, "-o", str(tmp), str(src)]
        else:
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures, ptxas = [], []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        ptxas += [ln.strip() for ln in out.splitlines() if "ptxas" in ln]
        os.replace(tmp, BUILD_DIR / f"lib{src.stem}.so")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return {"seconds": time.perf_counter() - t0, "ptxas": ptxas}


def _is_fresh(src: Path) -> bool:
    """The library of `src` exists and is no older than `src` or any header
    (`*.cuh`, `*.h`) beside it (a source may include any of them)."""
    lib = BUILD_DIR / f"lib{src.stem}.so"
    if not lib.exists():
        return False
    inputs = [src, *src.parent.glob("*.cuh"), *src.parent.glob("*.h")]
    return lib.stat().st_mtime >= max(f.stat().st_mtime for f in inputs)


def build_all(host_only: bool = False) -> Dict[str, object]:
    """Compile every source (only the host sources with `host_only`) whose
    library is missing or older than it; return the build's seconds and
    ptxas lines (none when nothing was stale)."""
    with _lock:
        todo = host_sources() if host_only else sources() + host_sources()
        stale = [s for s in todo if not _is_fresh(s)]
        return _compile_all(stale) if stale else {"seconds": 0.0, "ptxas": []}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu` or `.cpp`, building stale
    sources first (a host source builds only the host sources)."""
    if name not in _libs:
        host = name in {s.stem for s in host_sources()}
        if not host and name not in {s.stem for s in sources()}:
            raise RuntimeError(f"no CUDA source {name}.cu (nor host source {name}.cpp) in {CSRC}")
        build_all(host_only=host)
        with _lock:
            _libs.setdefault(name, ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so")))
    return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise on the cudaError_t a C entry point returned after its launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
