"""Build and load the port's hand-written CUDA kernels.

``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, which is loaded with
``ctypes``. The build happens at first use, into ``build/`` beside this
file (listed in ``.gitignore``); the library's file name carries a
digest of its source, so an edited source is rebuilt. A failed build
raises: nothing falls back to a plain PyTorch version.
:func:`build_libraries` starts one ``nvcc`` per missing source, all at
once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, Hashable, Iterable, List

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

# called with (source name, seconds) after each successful build: how
# the metrics registry counts builds (metrics.install_jit_compile_listener)
BUILD_LISTENERS: List[Callable[[str, float], None]] = []


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's usual install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME)")


def library_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _build_missing(names: Iterable[str]) -> None:
    """Compile every source of ``names`` whose library is not on disk,
    one ``nvcc`` each, all started together; raises after all have
    ended if any failed."""
    jobs = []
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        jobs.append((name, out, tmp, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
             str(SRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    # each build's seconds run from the common start to the moment its
    # output was collected (the builds run in parallel)
    logs = [(job, *job[3].communicate(), time.perf_counter() - t0)
            for job in jobs]
    for (name, out, tmp, proc), stdout, stderr, _ in logs:
        if proc.returncode != 0:
            raise RuntimeError(
                f"CUDA kernel build of {name} failed (nvcc exited "
                f"{proc.returncode}):\n{stdout}{stderr}")
        os.replace(tmp, out)
    for (name, *_), _, _, seconds in logs:
        for listener in BUILD_LISTENERS:
            listener(name, seconds)


def build_libraries(names: Iterable[str]) -> None:
    """Build the libraries of ``names`` that are not on disk yet."""
    with _lock:
        _build_missing(names)


def load_kernel_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if it is not
    on disk yet."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_missing([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


class LaunchCounter:
    """How many times a wrapper launched its kernel (thread-safe), in
    all and by an optional key the wrapper gives (a route and a shape)."""

    def __init__(self) -> None:
        self._n = 0
        self._by: Counter = Counter()
        self._lock = threading.Lock()

    def add(self, key: Hashable = None) -> None:
        with self._lock:
            self._n += 1
            if key is not None:
                self._by[key] += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0
            self._by.clear()

    @property
    def value(self) -> int:
        return self._n

    def by_key(self) -> Dict[Hashable, int]:
        with self._lock:
            return dict(self._by)
