"""DAO instrumentation + resilience: latency/error metrics, retries,
circuit breaking, and deterministic fault injection.

The port's copy of ``predictionio_tpu/data/storage/observed.py``. It
runs an op's first attempt inline while the breaker is closed and hands
a failure to the shared shell (``run_guarded(first_failure=...)``): the
same retries and breaker outcomes, and no policy frames on the success
path. JAX's shape, every attempt through ``run_guarded``, reads 15-18%
over the kill switch in ``test_wrapper_overhead_small`` on a CPU, past
that guard's 10%; the inline attempt keeps within it.

The storage registry wraps every event-store ``LEvents`` DAO it hands
out in :class:`DAOMetricsWrapper`, so all four event backends (memory,
sqlite, jsonlfs, resthttp) report
``pio_storage_op_seconds{backend,op,shard}`` and
``pio_storage_op_errors_total{backend,op,error,shard}`` without any
code in the backends themselves (``shard`` is empty for direct DAOs;
the fleet router stamps it on per-shard legs). Slow-path attribution rides the
request-scoped tracing contextvar: with debug logging on, every storage
op logs a record tagged with the ``X-Request-ID`` of the HTTP request
that caused it.

The wrapper is also the resilience chokepoint for LOCAL backends: each
op runs under the shared :class:`~predictionio_tpu_torch.utils.resilience.
RetryPolicy` behind the backend's per-endpoint circuit breaker, with
the ``PIO_FAULTS`` injection hook (:mod:`predictionio_tpu_torch.utils.faults`)
consulted immediately before the real call — so injected transients sit
INSIDE the retry loop and are masked exactly like real ones. Insert ops
pre-assign client-generated event ids before the first attempt, making
retried inserts idempotent on backends that dedup by event id
(``idempotent_event_writes``); backends that own their resilience
(resthttp: retries live in the wire, under the wire's breaker) declare
``self_resilient`` and are passed through untouched.

The wrapper is transparent: unknown attributes delegate to the wrapped
DAO (the jsonlfs raw-partition fast lane reads ``_dir``/``_parts``
through it), and code that needs the concrete backend type unwraps via
``unwrap()`` / the ``_wrapped`` attribute — ``isinstance`` on the
wrapper itself only sees :class:`~predictionio_tpu_torch.data.storage.base.
LEvents`.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Iterable, Iterator, Optional

from predictionio_tpu_torch.data.event import new_event_id
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.utils import faults, metrics, resilience, tracing
from predictionio_tpu_torch.utils.tracing import current_request_id

logger = logging.getLogger("pio.torch.storage.ops")

# ops that mutate the store by APPENDING events — retried only when the
# events carry idempotency keys (event ids) a backend can dedup on
_WRITE_OPS = frozenset({"insert", "insert_batch", "append_raw_lines"})

# passthrough attributes that still deserve timing (optional per backend);
# the tail-read trio (find_since/tail_cursor/tail_watermark) is declared
# on base.LEvents so it never reaches __getattr__ — it gets explicit
# timed+resilient delegation below instead
_EXTRA_TIMED_OPS = ("append_raw_lines",)


def unwrap(dao: Any) -> Any:
    """The concrete DAO behind a (possibly) wrapped one."""
    return getattr(dao, "_wrapped", dao)


class _TimedIterator:
    """Wraps a lazy ``find`` result so the recorded duration covers the
    scan, not just generator creation; abandoning the iterator records
    nothing (there is no completed op to account). ``fail`` (optional)
    accounts a mid-iteration error — the scan IS the op, so a backend
    dying partway through must register as the op failing."""

    __slots__ = ("_it", "_done", "_fail")

    def __init__(self, it: Iterator, done: Callable[[], None],
                 fail: Optional[Callable[[BaseException], None]] = None):
        self._it = iter(it)
        self._done = done
        self._fail = fail

    def __iter__(self) -> "_TimedIterator":
        return self

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            done, self._done = self._done, lambda: None
            done()
            raise
        except BaseException as e:
            fail, self._fail = self._fail, None
            self._done = lambda: None
            if fail is not None:
                fail(e)
            raise


class DAOMetricsWrapper(base.LEvents):
    """Time + error-count every event-store op against the registry."""

    def __init__(self, wrapped: base.LEvents,
                 backend: Optional[str] = None, shard: str = ""):
        self._wrapped = wrapped
        self.metrics_backend = backend or getattr(
            wrapped, "metrics_backend", type(wrapped).__name__)
        # empty for direct DAOs; the fleet router sets the shard index
        # on the per-shard clients it wraps so fan-out legs are
        # attributable in pio_storage_op_seconds{shard=...}
        self.metrics_shard = shard or getattr(
            wrapped, "metrics_shard", "")
        # resilience surface: the endpoint names the availability
        # domain (a wire URL for resthttp, the backend name locally)
        self.resilience_endpoint = getattr(
            wrapped, "resilience_endpoint", None) or self.metrics_backend
        self._self_resilient = bool(
            getattr(wrapped, "self_resilient", False))
        self._idempotent_writes = bool(
            getattr(wrapped, "idempotent_event_writes", False))
        self._breaker = resilience.breaker_for(self.resilience_endpoint)
        self._policy = resilience.RetryPolicy.from_env()

    def unwrap(self) -> base.LEvents:
        return self._wrapped

    # -- resilience -------------------------------------------------------
    def _attempt(self, op: str, fn: Callable, args: tuple, kwargs: dict):
        """One attempt: consult the fault injector, honor a torn-write
        directive (execute HALF the write, then fail ambiguously —
        the mid-write-crash shape), then run the real op."""
        directive = faults.maybe_fault(self.metrics_backend, op)
        if directive is not None:
            if op in ("insert_batch", "append_raw_lines") and args:
                seq = list(args[0])
                half = seq[:len(seq) // 2]
                if half:
                    fn(half, *args[1:], **kwargs)
            raise directive.error()
        return fn(*args, **kwargs)

    def _call_resilient(self, op: str, fn: Callable,
                        args: tuple, kwargs: dict,
                        defer_success: bool = False):
        """Breaker + retry + fault hook around one DAO op. Insert ops
        get their event ids assigned BEFORE the first attempt so every
        retry replays the same ids (the idempotency keys backends
        dedup on). ``defer_success`` skips the breaker's success mark —
        for lazy ops (``find`` returns a generator whose scan has not
        run yet) the CALLER records the outcome when iteration ends, so
        generator creation cannot masquerade as a healthy read and keep
        resetting the breaker's consecutive-failure count."""
        if self._self_resilient:
            return fn(*args, **kwargs)
        if not resilience.enabled():
            # kill switch drops retries + breaker, NOT fault injection
            # (the chaos bench measures the unmasked error rate here)
            return self._attempt(op, fn, args, kwargs)
        if op in ("insert", "insert_batch") and args:
            if op == "insert":
                ev = args[0]
                if hasattr(ev, "with_id") and \
                        not getattr(ev, "event_id", None):
                    args = (ev.with_id(new_event_id()),) + args[1:]
            else:
                seq = list(args[0])
                if all(hasattr(e, "with_id") for e in seq):
                    seq = [e if getattr(e, "event_id", None)
                           else e.with_id(new_event_id()) for e in seq]
                args = (seq,) + args[1:]
        # attempt 0 runs inline while the breaker is closed (where
        # before_call() admits without a lock): the success path pays
        # no policy frames; a failure hands over to run_guarded, which
        # continues from it exactly as if it had made the attempt
        breaker, policy = self._breaker, self._policy
        first = None
        if breaker.closed:
            start = policy.clock()
            try:
                result = self._attempt(op, fn, args, kwargs)
            except BaseException as e:
                first = (e, start)
            else:
                if not defer_success:
                    breaker.record_success()
                return result

        idempotent = op not in _WRITE_OPS or self._idempotent_writes

        def on_retry(attempt: int, exc: BaseException,
                     delay: float) -> None:
            metrics.STORAGE_RETRIES.inc(backend=self.metrics_backend,
                                        op=op)
            logger.debug("storage %s.%s retry %d in %.3fs after %r",
                         self.metrics_backend, op, attempt + 1, delay,
                         exc)

        return base.run_guarded(
            breaker, policy,
            lambda attempt: self._attempt(op, fn, args, kwargs),
            idempotent=idempotent, on_retry=on_retry,
            defer_success=defer_success, first_failure=first)

    # -- accounting -------------------------------------------------------
    def _record(self, op: str, t0: float,
                error: Optional[BaseException] = None) -> None:
        took = time.perf_counter() - t0
        backend = self.metrics_backend
        shard = self.metrics_shard
        if error is not None:
            metrics.STORAGE_OP_ERRORS.inc(
                backend=backend, op=op, error=type(error).__name__,
                shard=shard)
        else:
            metrics.STORAGE_OP_LATENCY.observe(
                took, backend=backend, op=op, shard=shard)
        if logger.isEnabledFor(logging.DEBUG):
            rid = current_request_id() or "-"
            logger.debug("storage %s.%s %.6fs rid=%s%s", backend, op, took,
                         rid, f" error={error!r}" if error else "")

    def _observe(self, op: str, fn: Callable, *args, **kwargs):
        # trace spans are independent of the metrics switch: an active
        # trace records storage-op spans even with metrics off, and
        # metrics keep counting when tracing is killed
        sp, tok = tracing.begin_span(
            f"storage.{self.metrics_backend}.{op}")
        record = metrics.REGISTRY.enabled
        if not record and sp is None:
            return self._call_resilient(op, fn, args, kwargs)
        t0 = time.perf_counter()
        try:
            result = self._call_resilient(op, fn, args, kwargs)
        except BaseException as e:
            if record:
                self._record(op, t0, error=e)
            tracing.finish_span(sp, tok, error=e)
            raise
        if record:
            self._record(op, t0)
        tracing.finish_span(sp, tok)
        return result

    # -- LEvents contract -------------------------------------------------
    def init(self, app_id, channel_id=None) -> bool:
        return self._observe("init", self._wrapped.init, app_id, channel_id)

    def remove(self, app_id, channel_id=None) -> bool:
        return self._observe("remove", self._wrapped.remove, app_id,
                             channel_id)

    def close(self) -> None:
        self._wrapped.close()

    def insert(self, event, app_id, channel_id=None) -> str:
        return self._observe("insert", self._wrapped.insert, event, app_id,
                             channel_id)

    def insert_batch(self, events: Iterable, app_id, channel_id=None):
        return self._observe("insert_batch", self._wrapped.insert_batch,
                             events, app_id, channel_id)

    def get(self, event_id, app_id, channel_id=None):
        return self._observe("get", self._wrapped.get, event_id, app_id,
                             channel_id)

    def delete(self, event_id, app_id, channel_id=None) -> bool:
        return self._observe("delete", self._wrapped.delete, event_id,
                             app_id, channel_id)

    def delete_until(self, app_id, until_time, channel_id=None) -> int:
        return self._observe("delete_until", self._wrapped.delete_until,
                             app_id, until_time, channel_id)

    def find(self, app_id, channel_id=None, **kwargs):
        # the span is finished by the iterator-exhausted callback (the
        # scan IS the op), so it must not rebind the context var — the
        # consuming code in between is not "inside the scan"
        sp, _ = tracing.begin_span(
            f"storage.{self.metrics_backend}.find", set_current=False)
        record = metrics.REGISTRY.enabled
        # the retry covers find() CREATION (local backends with lazy
        # scans return a generator from it); consuming the returned
        # iterator is not replayable — a mid-iteration failure
        # propagates — but it IS the scan, so the breaker's verdict
        # (success or failure) is deferred to the iterator's end
        deferred = not self._self_resilient and resilience.enabled()
        if not record and sp is None and not deferred:
            return self._call_resilient(
                "find", self._wrapped.find, (app_id, channel_id), kwargs)
        t0 = time.perf_counter()
        try:
            it = self._call_resilient(
                "find", self._wrapped.find, (app_id, channel_id), kwargs,
                defer_success=deferred)
        except BaseException as e:
            if record:
                self._record("find", t0, error=e)
            tracing.finish_span(sp, error=e)
            raise

        def done() -> None:
            if deferred:
                self._breaker.record_success()
            if record:
                self._record("find", t0)
            tracing.finish_span(sp)

        def fail(e: BaseException) -> None:
            if deferred:
                self._breaker.record_failure(e)
            if record:
                self._record("find", t0, error=e)
            tracing.finish_span(sp, error=e)
        return _TimedIterator(it, done, fail)

    # the tail-read trio is defined on base.LEvents (so __getattr__ never
    # fires for it) — delegate explicitly, timed + resilient like any op
    def find_since(self, app_id, channel_id=None, cursor=None, limit=None):
        return self._observe("find_since", self._wrapped.find_since,
                             app_id, channel_id, cursor=cursor, limit=limit)

    def tail_cursor(self, app_id, channel_id=None):
        return self._observe("tail_cursor", self._wrapped.tail_cursor,
                             app_id, channel_id)

    def tail_watermark(self, app_id, channel_id=None):
        return self._observe("tail_watermark", self._wrapped.tail_watermark,
                             app_id, channel_id)

    def materialized_aggregate(self, app_id, entity_type, channel_id=None):
        return self._observe(
            "materialized_aggregate", self._wrapped.materialized_aggregate,
            app_id, entity_type, channel_id)

    def aggregate_properties_replay(self, app_id, entity_type,
                                    channel_id=None, start_time=None,
                                    until_time=None, required=None):
        return self._observe(
            "aggregate_replay", self._wrapped.aggregate_properties_replay,
            app_id, entity_type, channel_id=channel_id,
            start_time=start_time, until_time=until_time, required=required)

    def aggregate_properties(self, app_id, entity_type, channel_id=None,
                             start_time=None, until_time=None,
                             required=None):
        # delegate straight through: the wrapped DAO's own
        # aggregate_properties does the hit/replay accounting, and its
        # inner materialized/replay calls are the ones worth timing
        return self._observe(
            "aggregate", self._wrapped.aggregate_properties,
            app_id, entity_type, channel_id=channel_id,
            start_time=start_time, until_time=until_time, required=required)

    # -- transparency -----------------------------------------------------
    def __getattr__(self, name: str):
        # only called for attributes NOT defined above (Python attribute
        # protocol), so the LEvents surface stays timed and everything
        # else (backend internals, shutdown, _w, _dir, ...) delegates
        if name == "_wrapped":  # guard: never recurse before __init__ ran
            raise AttributeError(name)
        attr = getattr(self._wrapped, name)
        if name in _EXTRA_TIMED_OPS and callable(attr):
            def timed(*args, **kwargs):
                return self._observe(name, attr, *args, **kwargs)
            return timed
        return attr

    def __repr__(self) -> str:
        return f"DAOMetricsWrapper({self._wrapped!r})"
