"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `tamtr_torch/csrc/<name>.cu` exposes a plain C entry point and becomes
`build/lib<name>.so` at the checkout root, compiled for Hopper (`sm_90a`) on
first use. One nvcc process runs per source, all started together. A library
newer than its source is reused. Nothing here runs at import time: the CPU
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

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _compile_all(stale: List[Path]) -> Dict[str, object]:
    """Compile `stale` in parallel; return the wall seconds and the ptxas
    register/spill lines."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for src in stale:
        tmp = BUILD_DIR / f".lib{src.stem}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
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
    lib = BUILD_DIR / f"lib{src.stem}.so"
    return lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime


def build_all() -> Dict[str, object]:
    """Compile every source whose library is missing or older than it;
    return the build's seconds and ptxas lines (none when nothing was stale)."""
    with _lock:
        stale = [s for s in sources() if not _is_fresh(s)]
        return _compile_all(stale) if stale else {"seconds": 0.0, "ptxas": []}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building stale sources first."""
    if name not in _libs:
        if name not in {s.stem for s in sources()}:
            raise RuntimeError(f"no CUDA source {name}.cu in {CSRC}")
        build_all()
        with _lock:
            _libs.setdefault(name, ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so")))
    return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise on the cudaError_t a C entry point returned after its launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
