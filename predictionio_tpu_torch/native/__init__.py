"""Native (C++) host kernels of the port.

The port's copy of ``predictionio_tpu/native/__init__.py``, with one
difference: a failed build raises. ``src/<name>.cpp`` compiles with
``g++`` at first use into ``_build/`` beside this file (listed in
``.gitignore``); the library's file name carries a digest of its
source, so an edited source is rebuilt. Libraries have a plain C
interface and load with ``ctypes``.

``PIO_NATIVE_DISABLE=1`` is the one way to take the numpy paths
instead: :func:`load` then returns None and every caller uses its
byte-identical numpy version.
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
from typing import Callable, Dict, List, Optional

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

# called with (source name, seconds) after each successful build: how
# the metrics registry counts builds (metrics.install_jit_compile_listener)
BUILD_LISTENERS: List[Callable[[str, float], None]] = []


def library_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _build(name: str) -> Path:
    """Compile ``src/<name>.cpp`` unless its library is on disk; raises
    when ``g++`` is missing or fails. The library appears by an atomic
    rename, so processes building at once never load half a file."""
    out = library_path(name)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's native ingest kernels "
                           "are built with g++ (PIO_NATIVE_DISABLE=1 takes "
                           "the numpy paths)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cpp")],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(
            f"native build of {name} failed (g++ exited "
            f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    for listener in BUILD_LISTENERS:
        listener(name, time.perf_counter() - t0)
    return out


def load(name: str) -> Optional[ctypes.CDLL]:
    """The loaded library of ``src/<name>.cpp``, built first if it is not
    on disk yet; None when ``PIO_NATIVE_DISABLE=1``."""
    if os.environ.get("PIO_NATIVE_DISABLE") == "1":
        return None
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            _libs[name] = lib
        return lib
