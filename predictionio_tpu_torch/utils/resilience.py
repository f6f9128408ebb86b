"""Fault-tolerance primitives: retries, circuit breakers, degradation.

The port's copy of ``predictionio_tpu/utils/resilience.py``. It is the
substrate every remote hop and serving path shares:

- :class:`RetryPolicy` — exponential backoff with FULL jitter
  (``delay = uniform(0, min(cap, base * 2**attempt))``), a per-op
  deadline budget so retries never stretch an op past its latency
  contract, and retry *classification*: failures that provably happened
  before the server saw the request (connection refused) retry anything;
  ambiguous failures (timeouts, 5xx, reset mid-flight) retry reads and
  idempotent writes only — a non-idempotent write retries solely when
  the caller supplied an idempotency key (client-generated event ids on
  the storage wire).
- :class:`CircuitBreaker` — per-endpoint closed → open on
  consecutive-failure count or windowed error rate, half-open probes
  after ``reset_timeout``, close on probe success. Only
  *transient-class* failures trip it (a 400 is the caller's bug, not
  the endpoint's health). Every state transition is counted
  (``pio_circuit_transitions_total``), gauged (``pio_circuit_state``)
  and emitted as a trace span.
- :func:`breaker_for` / :func:`storage_ready`: one breaker per endpoint
  (a storage wire URL, or a local backend's name), shared by every layer
  that touches it; ``GET /healthz`` on the event server, the query
  server, the admin server and the dashboard asks it.
- Degradation context — :func:`degraded_scope` / :func:`mark_degraded`:
  a serving layer opens a scope per query; a layer that swallows a
  failure (timeout, breaker open, a dead fleet shard, a stale fold-in
  tail) marks it; the server stamps ``degraded: true`` and
  ``degradedReasons`` on the response instead of failing it.

Kill switch: ``PIO_RESILIENCE=0`` (or :func:`set_enabled`) bypasses
retry + breaker logic entirely (fault injection stays on).
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("pio.torch.resilience")

# -- retry classification ---------------------------------------------------
#
# SAFE:      the request provably never executed (TCP connect refused,
#            breaker said no before dialing) — retry ANY op.
# AMBIGUOUS: the op may or may not have executed (timeout, connection
#            reset mid-flight, HTTP 5xx) — retry reads and idempotent
#            writes; non-idempotent writes only with an idempotency key.
# PERMANENT: retrying cannot help (4xx, validation, programming errors).

SAFE = "safe"
AMBIGUOUS = "ambiguous"
PERMANENT = "permanent"

# OSError subclasses that are filesystem/programming facts, not
# transient network weather — never worth a retry
_PERMANENT_OSERRORS = (FileNotFoundError, FileExistsError,
                       PermissionError, IsADirectoryError,
                       NotADirectoryError)


def classify(exc: BaseException) -> str:
    """Retry class of one failure. An exception may pin its own class
    via a ``pio_retry_class`` attribute (the storage wire and the fault
    injector do); otherwise network-shaped ``OSError``\\ s are transient
    and everything else is permanent."""
    pinned = getattr(exc, "pio_retry_class", None)
    if pinned in (SAFE, AMBIGUOUS, PERMANENT):
        return pinned
    if isinstance(exc, ConnectionRefusedError):
        return SAFE  # TCP said no: the server never saw the request
    if isinstance(exc, _PERMANENT_OSERRORS):
        return PERMANENT
    if isinstance(exc, (TimeoutError, ConnectionError, OSError)):
        return AMBIGUOUS
    return PERMANENT


def retry_after_hint(exc: BaseException) -> Optional[float]:
    """Server-suggested backoff floor (``Retry-After``), if the failure
    carried one."""
    v = getattr(exc, "pio_retry_after", None)
    try:
        return None if v is None else max(0.0, float(v))
    except (TypeError, ValueError):
        return None


def is_transient(exc: BaseException) -> bool:
    return classify(exc) in (SAFE, AMBIGUOUS)


# -- kill switch ------------------------------------------------------------

_enabled: Optional[bool] = None
_enabled_lock = threading.Lock()


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        with _enabled_lock:
            if _enabled is None:
                _enabled = os.environ.get(
                    "PIO_RESILIENCE", "1").strip().lower() not in (
                        "0", "off", "false")
    return _enabled


def set_enabled(on: bool) -> None:
    """Process-wide retry/breaker switch (overhead and test lever)."""
    global _enabled
    with _enabled_lock:
        _enabled = bool(on)


# -- RetryPolicy ------------------------------------------------------------


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


class RetryPolicy:
    """Bounded retries with full-jitter exponential backoff.

    ``max_retries`` counts RE-tries (0 = single attempt). The deadline
    is a per-op budget from the FIRST attempt's start: a retry whose
    backoff would land past it is not taken — the op fails with the
    last error instead of silently stretching its latency contract.
    ``rng`` and ``sleep`` are injectable for deterministic tests.
    """

    def __init__(self, max_retries: int = 3, base_delay: float = 0.05,
                 max_delay: float = 2.0, deadline: Optional[float] = 30.0,
                 rng: Optional[random.Random] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        self.max_retries = max(0, int(max_retries))
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.deadline = deadline if deadline is None else float(deadline)
        self._rng = rng or random.Random()
        self._sleep = sleep
        # public: a caller running attempt 0 itself takes the start it
        # hands to run() (``first_failure``) from this clock
        self.clock = clock

    @classmethod
    def from_env(cls, default_deadline: float = 30.0) -> "RetryPolicy":
        """``PIO_STORAGE_RETRIES`` / ``PIO_STORAGE_RETRY_BASE`` /
        ``PIO_STORAGE_RETRY_MAX`` / ``PIO_STORAGE_OP_DEADLINE``
        (seconds; deadline <= 0 disables the budget).

        ``default_deadline`` applies only when ``PIO_STORAGE_OP_DEADLINE``
        is unset: a caller whose single attempt can legitimately run
        long (the wire's read timeout) must raise it, or the budget is
        spent before the first retry and the timeout-retry lane is
        dead by construction."""
        deadline: Optional[float] = _env_float("PIO_STORAGE_OP_DEADLINE",
                                               default_deadline)
        if deadline is not None and deadline <= 0:
            deadline = None
        return cls(
            max_retries=int(_env_float("PIO_STORAGE_RETRIES", 3)),
            base_delay=_env_float("PIO_STORAGE_RETRY_BASE", 0.05),
            max_delay=_env_float("PIO_STORAGE_RETRY_MAX", 2.0),
            deadline=deadline)

    # a server-sent Retry-After FLOORS the backoff past max_delay (the
    # server knows its own pacing better than our jitter curve), but a
    # buggy/hostile header must not park the client arbitrarily long
    # when no deadline budget is set
    RETRY_AFTER_CAP = 60.0

    def backoff(self, attempt: int,
                floor: Optional[float] = None) -> float:
        """Full-jitter delay before retry number ``attempt + 1``; a
        server-sent ``Retry-After`` acts as the floor (the deadline
        budget, when set, still bounds the total)."""
        cap = min(self.max_delay, self.base_delay * (2 ** attempt))
        delay = self._rng.uniform(0.0, cap)
        if floor is not None:
            delay = max(delay, min(floor, self.RETRY_AFTER_CAP))
        return delay

    def run(self, fn: Callable[[int], Any], *, idempotent: Any = True,
            on_retry: Optional[Callable[[int, BaseException, float],
                                        None]] = None,
            first_failure: Optional[Tuple[BaseException, float]] = None
            ) -> Any:
        """Run ``fn(attempt)`` under the policy. ``fn`` receives the
        attempt index (0-based) so callers can tag retried requests
        (e.g. the idempotency-retry header on the storage wire).

        ``idempotent`` may be a bool or a zero-arg callable evaluated
        LAZILY at the first retry decision (and cached) — callers whose
        idempotency check costs something (parsing a bulk payload for
        idempotency keys) pay it only when a retry is actually on the
        table, never on the success path.

        ``first_failure`` — ``(exception, start)``: attempt 0 already ran
        (started at ``start`` on this policy's clock) and failed; the
        policy continues from that failure exactly as if it had made the
        attempt itself. A caller runs attempt 0 inline this way so the
        success path pays no policy frames."""
        if first_failure is None:
            start = self.clock()
            pending: Optional[BaseException] = None
        else:
            pending, start = first_failure
        attempt = 0
        idem: Optional[bool] = idempotent if isinstance(idempotent, bool) \
            else None
        while True:
            try:
                if pending is not None:
                    failed, pending = pending, None
                    raise failed
                return fn(attempt)
            except BaseException as e:
                cls = classify(e)
                if idem is None and cls == AMBIGUOUS:
                    idem = bool(idempotent())
                retryable = cls == SAFE or (cls == AMBIGUOUS and idem)
                if not retryable or attempt >= self.max_retries:
                    raise
                delay = self.backoff(attempt, retry_after_hint(e))
                if self.deadline is not None and \
                        self.clock() - start + delay > self.deadline:
                    raise  # budget exhausted: fail with the real error
                if on_retry is not None:
                    on_retry(attempt, e, delay)
                if delay > 0:
                    self._sleep(delay)
                attempt += 1


# -- CircuitBreaker ---------------------------------------------------------


class CircuitOpenError(RuntimeError):
    """Fail-fast refusal: the endpoint's breaker is open. Carries the
    time until the next half-open probe as the retry hint; classified
    PERMANENT so retry loops don't spin against an open breaker."""

    pio_retry_class = PERMANENT

    def __init__(self, endpoint: str, retry_in: float):
        super().__init__(
            f"circuit breaker open for {endpoint} "
            f"(next probe in {retry_in:.1f}s)")
        self.endpoint = endpoint
        self.pio_retry_after = max(0.0, retry_in)


CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_CODE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}


class CircuitBreaker:
    """Per-endpoint availability guard.

    - CLOSED: calls pass; ``failure_threshold`` consecutive transient
      failures — or a windowed error rate ≥ ``error_rate`` over at
      least ``min_calls`` of the last ``window`` outcomes — opens it.
    - OPEN: ``before_call`` raises :class:`CircuitOpenError` until
      ``reset_timeout`` elapses, then exactly ONE caller is admitted
      as the half-open probe.
    - HALF_OPEN: probe success closes; probe failure re-opens (timer
      restarts).

    Only transient-class failures count (:func:`classify`): a client
    bug (400, validation) says nothing about endpoint health.
    """

    def __init__(self, endpoint: str, failure_threshold: int = 5,
                 reset_timeout: float = 5.0, window: int = 20,
                 error_rate: float = 0.5, min_calls: int = 10,
                 clock: Callable[[], float] = time.monotonic):
        self.endpoint = endpoint
        self.failure_threshold = max(1, int(failure_threshold))
        self.reset_timeout = float(reset_timeout)
        self.window = max(1, int(window))
        self.error_rate = float(error_rate)
        self.min_calls = max(1, int(min_calls))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._outcomes: List[bool] = []  # rolling ok/fail window
        self._opened_at = 0.0
        self._probe_out = False
        self._probe_at = 0.0

    @classmethod
    def from_env(cls, endpoint: str,
                 clock: Callable[[], float] = time.monotonic
                 ) -> "CircuitBreaker":
        """``PIO_BREAKER_THRESHOLD`` / ``PIO_BREAKER_RESET`` (seconds)."""
        return cls(
            endpoint,
            failure_threshold=int(_env_float("PIO_BREAKER_THRESHOLD", 5)),
            reset_timeout=_env_float("PIO_BREAKER_RESET", 5.0),
            clock=clock)

    # -- state ------------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def closed(self) -> bool:
        """True while CLOSED: an unlocked read, as :meth:`before_call`'s
        fast path makes — a call made now is admitted without the lock
        or a probe slot."""
        return self._state == CLOSED

    @property
    def is_blocking(self) -> bool:
        """True when a call made NOW would be refused (open, probe not
        yet due). Pure read: never consumes the half-open probe slot —
        health checks and predict-time fast-fails use this."""
        with self._lock:
            return self._state == OPEN and \
                self._clock() - self._opened_at < self.reset_timeout

    @property
    def retry_in(self) -> float:
        """Seconds until the next half-open probe is due (0 when not
        open) — the honest ``Retry-After`` for a fast-fail."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self.reset_timeout
                       - (self._clock() - self._opened_at))

    def _transition(self, to: str) -> None:
        """Caller holds the lock."""
        frm, self._state = self._state, to
        if to == OPEN:
            self._opened_at = self._clock()
        self._emit(frm, to)

    def _emit(self, frm: str, to: str) -> None:
        from predictionio_tpu_torch.utils import metrics, tracing

        metrics.CIRCUIT_STATE.set(_STATE_CODE[to], endpoint=self.endpoint)
        metrics.CIRCUIT_TRANSITIONS.inc(endpoint=self.endpoint, to=to)
        # a zero-length span marks the transition on any active trace
        sp, tok = tracing.begin_span(
            f"circuit.transition {frm}->{to}",
            attributes={"endpoint": self.endpoint, "from": frm, "to": to})
        tracing.finish_span(sp, tok, error=(to == OPEN))
        (logger.warning if to == OPEN else logger.info)(
            "circuit breaker %s: %s -> %s", self.endpoint, frm, to)

    # -- call protocol ----------------------------------------------------
    def before_call(self) -> None:
        """Gate one call. Raises :class:`CircuitOpenError` when open;
        when the reset timeout has elapsed, admits exactly one caller
        as the half-open probe."""
        if not enabled():
            return
        # unlocked fast path: reading the state attr is atomic, and a
        # call slipping through in the instant the breaker opens is
        # indistinguishable from one that started a moment earlier
        if self._state == CLOSED:
            return
        with self._lock:
            if self._state == CLOSED:
                return
            if self._state == OPEN:
                waited = self._clock() - self._opened_at
                if waited < self.reset_timeout:
                    raise CircuitOpenError(
                        self.endpoint, self.reset_timeout - waited)
                self._transition(HALF_OPEN)
                self._probe_out = True
                self._probe_at = self._clock()
                return
            # HALF_OPEN: one probe at a time — but a probe whose outcome
            # never lands (a deferred-success find iterator dropped
            # mid-stream records nothing) must not wedge the slot: past
            # reset_timeout it is presumed lost and the slot is reclaimed.
            if self._probe_out and \
                    self._clock() - self._probe_at < self.reset_timeout:
                raise CircuitOpenError(self.endpoint, 0.1)
            self._probe_out = True
            self._probe_at = self._clock()

    def record_success(self) -> None:
        # steady-healthy fast path, no lock: nothing to update when
        # closed with a clean window (unlocked reads are benign — a
        # racing failure's bookkeeping takes the locked path)
        if self._state == CLOSED and self._consecutive == 0 \
                and not self._outcomes:
            return
        with self._lock:
            self._consecutive = 0
            self._push_outcome(True)
            if self._state == OPEN:
                # a STRAGGLER: a call admitted before the trip, landing
                # late, says nothing about the endpoint NOW — closing
                # here would flap fast-fail off mid-blackout, and each
                # flap costs queries their full read deadline until the
                # breaker re-trips. Only the half-open probe closes.
                return
            self._probe_out = False
            if self._state == HALF_OPEN:
                self._transition(CLOSED)
                self._outcomes.clear()
            elif False not in self._outcomes:
                # a failure-free window carries no error-rate signal;
                # dropping it restores the unlocked fast path (which
                # requires an empty window) for steady-healthy traffic
                self._outcomes.clear()

    def record_failure(self, exc: Optional[BaseException] = None) -> None:
        """Count one failed call. Non-transient failures (client bugs)
        never trip the breaker — the endpoint ANSWERED, which for
        availability purposes is a success: a half-open probe that
        comes back 4xx must close the breaker (and always release the
        probe slot), not wedge it half-open forever."""
        if isinstance(exc, CircuitOpenError):
            return  # our own refusal says nothing about the endpoint
        if exc is not None and not is_transient(exc):
            self.record_success()
            return
        with self._lock:
            self._push_outcome(False)
            self._probe_out = False
            if self._state == HALF_OPEN:
                self._transition(OPEN)  # probe failed: timer restarts
                return
            if self._state == OPEN:
                return
            self._consecutive += 1
            n = len(self._outcomes)
            failed = self._outcomes.count(False)
            if self._consecutive >= self.failure_threshold or (
                    n >= self.min_calls and failed / n >= self.error_rate):
                self._transition(OPEN)

    def _push_outcome(self, ok: bool) -> None:
        self._outcomes.append(ok)
        if len(self._outcomes) > self.window:
            del self._outcomes[:len(self._outcomes) - self.window]

    def reset(self) -> None:
        """Back to pristine CLOSED (tests)."""
        with self._lock:
            if self._state != CLOSED:
                self._transition(CLOSED)
            self._consecutive = 0
            self._outcomes.clear()
            self._probe_out = False


# -- per-endpoint breaker registry -----------------------------------------

_breakers: Dict[str, CircuitBreaker] = {}
_breakers_lock = threading.Lock()


def breaker_for(endpoint: str) -> CircuitBreaker:
    """The process-wide breaker guarding one endpoint (a storage wire
    URL, or a local backend's name). Get-or-create, so every layer
    touching the endpoint shares one availability view."""
    with _breakers_lock:
        br = _breakers.get(endpoint)
        if br is None:
            br = CircuitBreaker.from_env(endpoint)
            _breakers[endpoint] = br
        return br


def reset_breakers() -> None:
    """Reset every breaker IN PLACE — instances stay registered (test
    isolation). Dropping them instead would orphan the references
    layers cache (DAO wrappers, the wire, the predict-read cache): the
    data path would keep feeding the old instance while
    ``breaker_for``/healthz minted and consulted a fresh one, and the
    two views of endpoint health would diverge forever."""
    with _breakers_lock:
        for br in _breakers.values():
            br.reset()


def endpoint_of(dao) -> Optional[str]:
    """The availability-domain name of one event-store DAO (a wire URL
    for resthttp, the backend name locally; None when unknowable)."""
    return getattr(dao, "resilience_endpoint", None) \
        or getattr(dao, "metrics_backend", None)


def storage_ready(dao) -> bool:
    """Shared readiness check for ``GET /healthz``: the DAO's breaker
    is not refusing calls. One definition for all four servers.
    ``dao`` may be the DAO itself or a zero-arg callable resolving it;
    a resolution failure (storage misconfigured or unresolvable at
    poll time) reads as not-ready, never as a 500 from /healthz."""
    try:
        if callable(dao):
            dao = dao()
        ep = endpoint_of(dao)
        return True if ep is None else not breaker_for(ep).is_blocking
    except Exception:
        return False


# -- degradation context ----------------------------------------------------

_degraded: contextvars.ContextVar[Optional[List[str]]] = \
    contextvars.ContextVar("pio_torch_degraded", default=None)


@contextlib.contextmanager
def degraded_scope():
    """Collect degradation marks for one served query. The serving
    layer opens the scope; any storage layer that swallows a failure
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
    """True when a :func:`degraded_scope` is collecting marks. Storage
    layers that can serve PARTIAL results (the fleet router with a
    dead shard) use this to choose between degrade-and-continue on the
    serving path and fail-loud everywhere else (training reads must
    never silently lose a shard's data)."""
    return _degraded.get() is not None


def degrade_reason_for(exc: BaseException) -> str:
    """Canonical degradation label for one storage failure."""
    if isinstance(exc, CircuitOpenError):
        return "circuit_open"
    if isinstance(exc, TimeoutError):
        return "timeout"
    return "storage_error"
