"""Deterministic fault injection (``PIO_FAULTS``).

The port's copy of ``predictionio_tpu/utils/faults.py``. Chaos testing
that replays exactly: every rule carries its own seed and match
counter, so the same spec against the same call sequence fires the same
faults. Three layers consult :func:`maybe_fault` before each op: the
storage DAO wrapper (:mod:`~predictionio_tpu_torch.data.storage.observed`,
backend = the source type, ``torn`` writes half a batch and fails), the
``resthttp`` wire (backend ``resthttp``, ``torn`` = the server committed
but the response was lost) and the training checkpointer (backend
``checkpoint``, op ``save``: ``slow`` holds a save open, ``torn`` writes
half a blob and fails).

Spec grammar (README "Resilience & health checks")::

    PIO_FAULTS = rule [ ";" rule ... ]
    rule      = key "=" value [ "," key "=" value ... ]

    keys:
      backend     glob over the backend name ("resthttp", "sqlite",
                  "jsonl*", ...); default "*"
      op          glob over the DAO op ("insert_batch", "find", ...);
                  default "*"
      kind        refuse  -> ConnectionRefusedError (request provably
                             never executed: retriable for ANY op)
                  timeout -> TimeoutError (ambiguous: the op may have
                             executed)
                  error   -> server-error analog (HTTP 5xx shape;
                             "status" and "retry_after" refine it)
                  slow    -> sleep "delay" seconds, then proceed
                  torn    -> a mid-write crash: the caller executes a
                             PARTIAL write, then fails ambiguously
      rate        probability per matching call (seeded — replays
                  exactly); mutually exclusive with "every"
      every       fire on every Nth matching call (1 = always)
      times       fire at most K times, then the rule goes inert
      after       skip the first N matching calls
      seed        per-rule RNG seed (default: 1000 + rule index)
      delay       seconds for "slow" (default 0.05)
      status      HTTP-ish status for "error" (default 503)
      retry_after Retry-After hint attached to "error" failures

Example — 10% transient connection refusals on every resthttp write,
plus one torn write on sqlite's 3rd batch insert::

    PIO_FAULTS="backend=resthttp,op=insert*,kind=refuse,rate=0.1,seed=7;\\
backend=sqlite,op=insert_batch,kind=torn,after=2,times=1"
"""

from __future__ import annotations

import fnmatch
import os
import threading
import time
from typing import List, Optional

from predictionio_tpu_torch.utils import resilience


class InjectedFault(Exception):
    """Marker base: every injected failure is one of these."""

    injected = True


class InjectedConnectionRefused(InjectedFault, ConnectionRefusedError):
    """The request provably never reached the backend."""

    pio_retry_class = resilience.SAFE


class InjectedTimeout(InjectedFault, TimeoutError):
    """The op may or may not have executed."""

    pio_retry_class = resilience.AMBIGUOUS


class InjectedServerError(InjectedFault, RuntimeError):
    """HTTP-5xx-shaped backend failure."""

    pio_retry_class = resilience.AMBIGUOUS

    def __init__(self, msg: str, status: int = 503,
                 retry_after: Optional[float] = None):
        super().__init__(msg)
        self.status = int(status)
        if retry_after is not None:
            self.pio_retry_after = float(retry_after)


class InjectedTornWrite(InjectedFault, OSError):
    """Raised AFTER the partial write a ``torn`` rule asked for."""

    pio_retry_class = resilience.AMBIGUOUS


class TornWriteDirective:
    """Returned by :func:`maybe_fault` for ``kind=torn``: the caller
    must execute a partial write, then raise :meth:`error`."""

    def __init__(self, rule: "FaultRule"):
        self.rule = rule

    def error(self) -> InjectedTornWrite:
        return InjectedTornWrite(
            f"injected torn write ({self.rule.describe()})")


_KINDS = ("refuse", "timeout", "error", "slow", "torn")


class FaultSpecError(ValueError):
    pass


class FaultRule:
    """One parsed rule with its own deterministic decision stream."""

    def __init__(self, index: int, backend: str = "*", op: str = "*",
                 kind: str = "error", rate: Optional[float] = None,
                 every: Optional[int] = None, times: Optional[int] = None,
                 after: int = 0, seed: Optional[int] = None,
                 delay: float = 0.05, status: int = 503,
                 retry_after: Optional[float] = None):
        import random

        if kind not in _KINDS:
            raise FaultSpecError(
                f"unknown fault kind {kind!r}; known: {_KINDS}")
        if rate is not None and every is not None:
            raise FaultSpecError("rate and every are mutually exclusive")
        if rate is not None and not 0.0 <= rate <= 1.0:
            raise FaultSpecError(
                f"rate must be in [0, 1], got {rate!r}")
        if every is not None:
            every = int(every)
            if every < 1:
                raise FaultSpecError(
                    f"every must be >= 1 (1 = always), got {every!r}")
        if rate is None and every is None:
            every = 1  # unconditional
        self.backend = backend
        self.op = op
        self.kind = kind
        self.rate = rate
        self.every = every
        self.times = times
        self.after = max(0, int(after))
        self.seed = 1000 + index if seed is None else int(seed)
        self.delay = float(delay)
        self.status = int(status)
        self.retry_after = retry_after
        self._rng = random.Random(self.seed)
        self._matched = 0
        self._fired = 0

    @classmethod
    def parse(cls, text: str, index: int) -> "FaultRule":
        kw: dict = {}
        for field in text.split(","):
            field = field.strip()
            if not field:
                continue
            if "=" not in field:
                raise FaultSpecError(
                    f"fault rule field {field!r} is not key=value")
            k, v = (s.strip() for s in field.split("=", 1))
            if k in ("backend", "op", "kind"):
                kw[k] = v
            elif k in ("rate", "delay", "retry_after"):
                kw[k] = float(v)
            elif k in ("every", "times", "after", "seed", "status"):
                kw[k] = int(v)
            else:
                raise FaultSpecError(f"unknown fault rule key {k!r}")
        return cls(index, **kw)

    def describe(self) -> str:
        sel = f"rate={self.rate}" if self.rate is not None \
            else f"every={self.every}"
        return (f"backend={self.backend},op={self.op},kind={self.kind},"
                f"{sel},seed={self.seed}")

    def matches(self, backend: str, op: str) -> bool:
        return fnmatch.fnmatchcase(backend, self.backend) and \
            fnmatch.fnmatchcase(op, self.op)

    def decide(self) -> bool:
        """One deterministic decision for a matching call. The RNG is
        consumed on EVERY matching call (fired or not), so decision N
        is a pure function of (seed, N) and replays exactly."""
        self._matched += 1
        # consume the rng unconditionally to keep the stream aligned
        draw = self._rng.random()
        if self._matched <= self.after:
            return False
        if self.times is not None and self._fired >= self.times:
            return False
        if self.rate is not None:
            fire = draw < self.rate
        else:
            fire = (self._matched - self.after) % self.every == 0
        if fire:
            self._fired += 1
        return fire


class FaultInjector:
    """A parsed ``PIO_FAULTS`` spec; thread-safe, deterministic per
    rule (decision order across threads is the caller's concern —
    chaos suites drive deterministic call sequences)."""

    def __init__(self, rules: List[FaultRule], spec: str = ""):
        self.rules = rules
        self.spec = spec
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "FaultInjector":
        rules = [FaultRule.parse(part, i)
                 for i, part in enumerate(spec.split(";"))
                 if part.strip()]
        return cls(rules, spec)

    def maybe_fault(self, backend: str,
                    op: str) -> Optional[TornWriteDirective]:
        """Consult every rule in order for one storage call. Raises the
        injected failure, sleeps for ``slow``, or returns a
        :class:`TornWriteDirective` the caller must honor."""
        torn: Optional[TornWriteDirective] = None
        slept = 0.0
        for rule in self.rules:
            if not rule.matches(backend, op):
                continue
            with self._lock:
                fire = rule.decide()
            if not fire:
                continue
            _count_fault(backend, op, rule.kind)
            if rule.kind == "slow":
                slept += rule.delay
                continue
            if slept:
                time.sleep(slept)
                slept = 0.0  # spent: the trailing sleep must not repeat it
            if rule.kind == "refuse":
                raise InjectedConnectionRefused(
                    f"injected connection refused ({rule.describe()})")
            if rule.kind == "timeout":
                raise InjectedTimeout(
                    f"injected timeout ({rule.describe()})")
            if rule.kind == "error":
                raise InjectedServerError(
                    f"injected server error ({rule.describe()})",
                    status=rule.status, retry_after=rule.retry_after)
            torn = TornWriteDirective(rule)  # kind == "torn"
        if slept:
            time.sleep(slept)
        return torn


def _count_fault(backend: str, op: str, kind: str) -> None:
    from predictionio_tpu_torch.utils import metrics

    metrics.FAULTS_INJECTED.inc(backend=backend, op=op, kind=kind)


# -- process-wide injector --------------------------------------------------

_injector: Optional[FaultInjector] = None
_pinned = False  # install() overrides the env until clear()
_lock = threading.Lock()


def injector() -> Optional[FaultInjector]:
    """The active injector, tracking ``PIO_FAULTS`` (re-parsed when the
    env value changes, so subprocess servers and test fixtures both
    work); ``None`` when no faults are configured."""
    global _injector
    # lock-free fast path for the (production) no-faults case: one env
    # dict lookup per storage op
    if not _pinned and _injector is None \
            and not os.environ.get("PIO_FAULTS"):
        return None
    spec = os.environ.get("PIO_FAULTS", "").strip()
    with _lock:
        if _pinned:
            return _injector
        if not spec:
            _injector = None
        elif _injector is None or _injector.spec != spec:
            _injector = FaultInjector.parse(spec)
        return _injector


def install(spec: str) -> FaultInjector:
    """Pin an injector regardless of the env (tests). :func:`clear`
    releases it."""
    global _injector, _pinned
    with _lock:
        _injector = FaultInjector.parse(spec)
        _pinned = True
        return _injector


def clear() -> None:
    global _injector, _pinned
    with _lock:
        _injector = None
        _pinned = False


def maybe_fault(backend: str, op: str) -> Optional[TornWriteDirective]:
    """Fast-path entry the storage layers call: no spec, no cost beyond
    one env lookup."""
    inj = injector()
    if inj is None:
        return None
    return inj.maybe_fault(backend, op)
