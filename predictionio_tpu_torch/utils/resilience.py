"""Degradation context and the env reader online fold-in needs.

The port's copy of the part of ``predictionio_tpu/utils/resilience.py``
that online fold-in uses:

- :func:`_env_float`, the tolerant reader of a numeric environment
  variable (``PIO_FOLDIN_INTERVAL``, ``PIO_FOLDIN_COUNT``);
- the degradation context, :func:`degraded_scope` /
  :func:`mark_degraded` / :func:`in_degraded_scope`: the query server
  opens a scope per query, a layer that serves from last-good state
  (a stale fold-in tail) marks it, and the server stamps ``degraded:
  true`` and ``degradedReasons`` on the response instead of failing it.

- the retry classes ``SAFE`` / ``AMBIGUOUS`` an injected fault
  (:mod:`~predictionio_tpu_torch.utils.faults`) carries.

``RetryPolicy``, the circuit breaker and the storage breaker's shell
come with the networked backends (ROADMAP A2.4 / A2.5).
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
from typing import List, Optional

logger = logging.getLogger("pio.torch.resilience")

# The retry class of a failure (``pio_retry_class``): SAFE, the request
# provably never executed; AMBIGUOUS, it may or may not have.
SAFE = "safe"
AMBIGUOUS = "ambiguous"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("%s=%r is not a number; using %s", name, raw,
                       default)
        return default


# -- degradation context ----------------------------------------------------

_degraded: contextvars.ContextVar[Optional[List[str]]] = \
    contextvars.ContextVar("pio_torch_degraded", default=None)


@contextlib.contextmanager
def degraded_scope():
    """Collect degradation marks for one served query. The serving
    layer opens the scope; any layer that serves from last-good state
    calls :func:`mark_degraded`; the server reads the list afterwards
    and stamps ``degraded: true`` on the response."""
    reasons: List[str] = []
    token = _degraded.set(reasons)
    try:
        yield reasons
    finally:
        _degraded.reset(token)


def mark_degraded(reason: str) -> None:
    """Record that the current query is being served degraded (no-op
    outside a :func:`degraded_scope`)."""
    reasons = _degraded.get()
    if reasons is not None and reason not in reasons:
        reasons.append(reason)


def in_degraded_scope() -> bool:
    """True when a :func:`degraded_scope` is collecting marks."""
    return _degraded.get() is not None


__all__ = ["degraded_scope", "in_degraded_scope", "mark_degraded"]
