"""The JAX package's native libraries, loaded before a port test holds
the port against them.

``predictionio_tpu.native.load`` has g++ write ``_build/lib<name>.so``
in place and caches a failed load as None for the rest of its process.
Under pytest-xdist, a worker that opens the file while another worker's
g++ is still writing it fails to load it and keeps the Python fallback
for good; a port-vs-JAX comparison in that worker then holds the port
to the fallback, which some cases do not match. :func:`require_jax_native`
runs the first loads of a test session one at a time behind a file lock,
drops a cached failure before each try, waits until each library loads,
and fails when one never does, so no comparison runs quietly against
the fallback.
"""

import fcntl
import time
from pathlib import Path

from predictionio_tpu import native as jnative

LIBRARIES = ("jsonl_codec", "ingest_kernels")


def require_jax_native(lock_dir, names=LIBRARIES,
                       timeout: float = 180.0) -> None:
    """Load each of the JAX package's native ``names``, waiting out a
    build another process is writing; ``lock_dir`` is shared by the
    session's workers (the parent of each one's pytest base temp)."""
    with open(Path(lock_dir) / "jax-native.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            deadline = time.monotonic() + timeout
            for name in names:
                while True:
                    with jnative._lock:
                        if name in jnative._cache \
                                and jnative._cache[name] is None:
                            del jnative._cache[name]
                    if jnative.load(name) is not None:
                        break
                    if time.monotonic() > deadline:
                        raise AssertionError(
                            f"the JAX package's native {name} did not load "
                            f"within {timeout} s: its comparisons would run "
                            "against the Python fallback")
                    time.sleep(0.25)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
