"""Build and load the port's hand-written CUDA kernels.

Each source under ``kernels/csrc`` compiles with ``nvcc`` into a shared
library with a plain C interface, which :func:`load` opens with ``ctypes``.
No PyTorch headers are involved, so a build takes seconds. Libraries go to
``build/repro_torch/`` at the repository root, named by a hash of the
source and the flags, and are built at first use; a failed build raises
with the compiler's output.

    lib = load("fused_update")        # builds csrc/fused_update.cu if needed
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -split-compile=0: the optimiser's passes on as many threads as there are
# cores (B9's source, two dozen kernel instantiations, 24 s on one thread and
# 10 s split on the card's 8-core host)
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-split-compile=0", "-shared", "-Xcompiler",
                           "-fPIC"]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_SECONDS: Dict[str, float] = {}   # name -> seconds nvcc took (0.0 if cached)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library for this exact source and
    flag set exists. Returns the library path."""
    out = library_path(name)
    if out.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {r.returncode}):\n"
                           f"{' '.join(cmd)}\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
        return lib
