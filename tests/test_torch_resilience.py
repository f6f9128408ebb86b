"""Storage resilience: the port's retries, breakers, fault injection and
DAO wrapper against the JAX package's, on the CPU.

- ``RetryPolicy`` and ``CircuitBreaker``: the same outcome sequences go
  through both packages with the clock, the sleep and the jitter RNG
  pinned; the attempts, the delays, the state transitions, the refusals
  and the ``pio_circuit_*`` metrics must be equal.
- The ``PIO_FAULTS`` grammar: the same specs parse (or fail) alike and
  fire the same faults on the same call sequences.
- ``DAOMetricsWrapper``: one op sequence under one fault schedule over a
  memory and a sqlite store in each package leaves the same events, the
  same ``pio_storage_op_*`` / ``pio_storage_retries_total`` /
  ``pio_faults_injected_total`` series (by label set), and a torn write
  leaves the same half batch when nothing retries it.
- ``run_guarded`` refuses with ``StorageCircuitOpen`` (a ``StorageError``
  and a ``CircuitOpenError``); the guarded ``LEventStore`` read marks
  ``circuit_open`` inside a ``degraded_scope`` and feeds the breaker
  from its deadline.
- ``GET /healthz`` flips with the breaker on the event server, the query
  server (the recommendation template over a ``resthttp`` event store),
  the admin server and the dashboard; the event, admin and dashboard
  bodies equal the JAX package's.
- The wrapper's overhead guard: retries + breaker on cost at most 10% of
  a memory ``get()`` against the kill switch, as in the JAX suite.

Breakers and injectors are process-global in each package: an autouse
fixture resets both packages' breakers and clears both injectors before
and after every test, and the sleeps and clocks the units need are
pinned (no test waits on a wall clock to observe a state).
"""

import datetime as dt
import http.client
import json
import os
import random
import threading
import time

import numpy as np
import pytest

from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import base as jbase
from predictionio_tpu.utils import faults as jfaults
from predictionio_tpu.utils import metrics as jmetrics
from predictionio_tpu.utils import resilience as jres
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data.api import EventServer, EventServerConfig
from predictionio_tpu_torch.data.event import Event as TEvent
from predictionio_tpu_torch.data.event import new_event_id
from predictionio_tpu_torch.data.storage import base as tbase
from predictionio_tpu_torch.data.storage.observed import (
    DAOMetricsWrapper,
    unwrap,
)
from predictionio_tpu_torch.utils import faults as tfaults
from predictionio_tpu_torch.utils import metrics as tmetrics
from predictionio_tpu_torch.utils import resilience as tres

UTC = dt.timezone.utc
T0 = dt.datetime(2022, 5, 1, tzinfo=UTC)
KEY = "torch-resilience-key"
FAST_RETRY_ENV = {
    "PIO_STORAGE_RETRIES": "3",
    "PIO_STORAGE_RETRY_BASE": "0.005",
    "PIO_STORAGE_RETRY_MAX": "0.02",
    "PIO_STORAGE_OP_DEADLINE": "20",
    "PIO_STORAGE_CONNECT_TIMEOUT": "1.0",
}


def _reset_both():
    for faults, res in ((jfaults, jres), (tfaults, tres)):
        faults.clear()
        res.reset_breakers()
        res.set_enabled(True)


@pytest.fixture(autouse=True)
def _clean_resilience():
    _reset_both()
    yield
    _reset_both()


@pytest.fixture
def fast_retries(monkeypatch):
    for k, v in FAST_RETRY_ENV.items():
        monkeypatch.setenv(k, v)


def _event(Event, i, uid=None, eid=None):
    return Event(event="rate", entity_type="user",
                 entity_id=uid or f"u{i % 7}", target_entity_type="item",
                 target_entity_id=f"i{i % 11}",
                 properties={"rating": float(i % 5 + 1)},
                 event_time=T0 + dt.timedelta(seconds=i), event_id=eid,
                 creation_time=T0)


# ---------------------------------------------------------------------------
# RetryPolicy: one outcome sequence, both packages
# ---------------------------------------------------------------------------


class Pinned(RuntimeError):
    pio_retry_class = "safe"


class Hinted(TimeoutError):
    pio_retry_after = 0.7


class HugeHint(ConnectionResetError):
    pio_retry_after = 1e6


OUTCOMES = {
    "refused-then-ok": [ConnectionRefusedError, ConnectionRefusedError,
                        None],
    "timeouts": [TimeoutError] * 9,
    "permanent": [ValueError],
    "reset-ok": [ConnectionResetError, None],
    "pinned-safe": [Pinned, Pinned, None],
    "retry-after": [Hinted, Hinted, None],
    "huge-retry-after": [HugeHint, None],
    "missing-file": [FileNotFoundError],
    "mixed": [ConnectionRefusedError, TimeoutError, Pinned,
              ConnectionResetError, TimeoutError],
}


def _drive_policy(res, outcomes, idempotent, seed, inline=False, **kw):
    """``inline``: attempt 0 runs outside the policy, which takes over
    from its failure (``first_failure``), as the DAO wrapper runs it."""
    now = [0.0]
    delays, retries, calls = [], [], []

    def sleep(d):
        delays.append(d)
        now[0] += d

    policy = res.RetryPolicy(rng=random.Random(seed), sleep=sleep,
                             clock=lambda: now[0], **kw)
    lazy_calls = []
    if idempotent == "lazy":
        idem = lambda: lazy_calls.append(1) or True  # noqa: E731
    else:
        idem = idempotent

    def fn(attempt):
        calls.append(attempt)
        now[0] += 0.25  # each attempt costs a quarter second
        exc = outcomes[min(attempt, len(outcomes) - 1)]
        if exc is None:
            return f"ok@{attempt}"
        raise exc("boom")

    first = None
    try:
        if inline:
            start = now[0]
            try:
                return_now = ("ok", fn(0))
            except Exception as e:  # noqa: BLE001 - handed to the policy
                first = (e, start)
            else:
                return calls, delays, retries, return_now, len(lazy_calls)
        handoff = {"first_failure": first} if inline else {}
        out = ("ok", policy.run(
            fn, idempotent=idem,
            on_retry=lambda a, e, d: retries.append(
                (a, type(e).__name__, d)), **handoff))
    except BaseException as e:  # noqa: BLE001 - compared below
        out = ("raised", type(e).__name__)
    return calls, delays, retries, out, len(lazy_calls)


@pytest.mark.parametrize("idempotent", [True, False, "lazy"])
@pytest.mark.parametrize("name", sorted(OUTCOMES))
def test_retry_policy_equals_jax(name, idempotent):
    for kw in ({"max_retries": 3, "base_delay": 0.05, "max_delay": 2.0,
                "deadline": 30.0},
               {"max_retries": 8, "base_delay": 1.0, "max_delay": 1.0,
                "deadline": 2.5},
               {"max_retries": 0},
               {"max_retries": 5, "deadline": None}):
        want = _drive_policy(jres, OUTCOMES[name], idempotent, 7, **kw)
        got = _drive_policy(tres, OUTCOMES[name], idempotent, 7, **kw)
        assert got == want, kw
        inline = _drive_policy(tres, OUTCOMES[name], idempotent, 7,
                               inline=True, **kw)
        assert inline == want, kw


def test_backoff_and_hints_equal_jax():
    for attempt in range(10):
        for floor in (None, 0.0, 0.5, 10.0, 1e6):
            j = jres.RetryPolicy(rng=random.Random(attempt),
                                 base_delay=0.1, max_delay=1.0)
            t = tres.RetryPolicy(rng=random.Random(attempt),
                                 base_delay=0.1, max_delay=1.0)
            assert t.backoff(attempt, floor) == j.backoff(attempt, floor)
    assert tres.RetryPolicy.RETRY_AFTER_CAP == \
        jres.RetryPolicy.RETRY_AFTER_CAP
    excs = [Pinned(), Hinted(), HugeHint(), ConnectionRefusedError(),
            TimeoutError(), ConnectionResetError(), FileNotFoundError(),
            PermissionError(), IsADirectoryError(), OSError(),
            ValueError(), KeyError(), jres.CircuitOpenError("e", 2.0),
            tres.CircuitOpenError("e", 2.0)]
    for e in excs:
        assert tres.classify(e) == jres.classify(e), e
        assert tres.is_transient(e) == jres.is_transient(e), e
        assert tres.retry_after_hint(e) == jres.retry_after_hint(e), e
    assert (tres.SAFE, tres.AMBIGUOUS, tres.PERMANENT) == \
        (jres.SAFE, jres.AMBIGUOUS, jres.PERMANENT)


@pytest.mark.parametrize("env", [
    {},
    {"PIO_STORAGE_RETRIES": "5", "PIO_STORAGE_RETRY_BASE": "0.2",
     "PIO_STORAGE_RETRY_MAX": "3", "PIO_STORAGE_OP_DEADLINE": "7"},
    {"PIO_STORAGE_OP_DEADLINE": "0", "PIO_STORAGE_RETRIES": "x"},
    {"PIO_BREAKER_THRESHOLD": "2", "PIO_BREAKER_RESET": "0.5"},
], ids=["defaults", "set", "off-and-bad", "breaker"])
def test_from_env_equals_jax(env, monkeypatch):
    for k in ("PIO_STORAGE_RETRIES", "PIO_STORAGE_RETRY_BASE",
              "PIO_STORAGE_RETRY_MAX", "PIO_STORAGE_OP_DEADLINE",
              "PIO_BREAKER_THRESHOLD", "PIO_BREAKER_RESET"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for dd in (30.0, 125.0):
        j = jres.RetryPolicy.from_env(default_deadline=dd)
        t = tres.RetryPolicy.from_env(default_deadline=dd)
        assert (t.max_retries, t.base_delay, t.max_delay, t.deadline) == \
            (j.max_retries, j.base_delay, j.max_delay, j.deadline)
    jb = jres.CircuitBreaker.from_env("ep")
    tb = tres.CircuitBreaker.from_env("ep")
    assert (tb.failure_threshold, tb.reset_timeout, tb.window,
            tb.error_rate, tb.min_calls) == \
        (jb.failure_threshold, jb.reset_timeout, jb.window,
         jb.error_rate, jb.min_calls)


def test_kill_switch_reads_env_once(monkeypatch):
    for res in (jres, tres):
        monkeypatch.setattr(res, "_enabled", None)
    monkeypatch.setenv("PIO_RESILIENCE", "off")
    assert tres.enabled() is jres.enabled() is False
    monkeypatch.setenv("PIO_RESILIENCE", "1")
    assert tres.enabled() is False  # read once, then cached
    tres.set_enabled(True)
    assert tres.enabled() is True


# ---------------------------------------------------------------------------
# CircuitBreaker: one script, both packages, pinned clock
# ---------------------------------------------------------------------------

SCRIPTS = {
    "consecutive-then-probe-closes": [
        ("before",), ("fail", TimeoutError), ("before",),
        ("fail", TimeoutError), ("before",), ("fail", TimeoutError),
        ("before",), ("advance", 10.0), ("before",), ("before",),
        ("ok",), ("before",)],
    "probe-failure-reopens": [
        ("fail", ConnectionRefusedError)] * 3 + [
        ("advance", 10.0), ("before",), ("fail", TimeoutError),
        ("before",), ("advance", 4.0), ("before",)],
    "probe-4xx-closes": [("fail", TimeoutError)] * 3 + [
        ("advance", 10.0), ("before",), ("fail", ValueError),
        ("before",)],
    "lost-probe-reclaimed": [("fail", TimeoutError)] * 3 + [
        ("advance", 10.0), ("before",), ("before",), ("advance", 10.0),
        ("before",), ("ok",)],
    "straggler-success-keeps-open": [("fail", TimeoutError)] * 3 + [
        ("ok",), ("before",), ("advance", 3.0), ("retry_in",)],
    "own-refusal-ignored": [("fail", TimeoutError)] * 3 + [
        ("fail_open",), ("advance", 10.0), ("retry_in",)],
    "client-bugs-never-trip": [("before",), ("fail", ValueError)] * 12,
    "error-rate-window": [("fail", TimeoutError), ("ok",)] * 6,
    "is-blocking-pure": [("fail", TimeoutError)] * 3 + [
        ("advance", 9.0), ("advance", 1.0), ("before",)],
    "reset": [("fail", TimeoutError)] * 3 + [("reset",), ("before",)],
}


def _drive_breaker(res, script, endpoint, **kw):
    now = [0.0]
    kw.setdefault("failure_threshold", 3)
    kw.setdefault("reset_timeout", 10.0)
    br = res.CircuitBreaker(endpoint, clock=lambda: now[0], **kw)
    seen = []
    for step in script:
        op = step[0]
        if op == "before":
            try:
                br.before_call()
                seen.append("admitted")
            except res.CircuitOpenError as e:
                seen.append(("refused", round(e.pio_retry_after, 9)))
        elif op == "fail":
            br.record_failure(step[1]())
        elif op == "fail_open":
            br.record_failure(res.CircuitOpenError(endpoint, 1.0))
        elif op == "ok":
            br.record_success()
        elif op == "advance":
            now[0] += step[1]
        elif op == "retry_in":
            seen.append(("retry_in", round(br.retry_in, 9)))
        elif op == "reset":
            br.reset()
        seen.append((br.state, br.is_blocking, br._consecutive))
    return seen


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_circuit_breaker_equals_jax(name):
    kw = {"failure_threshold": 1000, "window": 10, "error_rate": 0.5,
          "min_calls": 10} if name == "error-rate-window" else {}
    ep = f"torch-test-breaker-{name}"
    tr = [(tmetrics.CIRCUIT_TRANSITIONS.value(endpoint=ep, to=s),
           jmetrics.CIRCUIT_TRANSITIONS.value(endpoint=ep, to=s))
          for s in ("open", "half_open", "closed")]
    want = _drive_breaker(jres, SCRIPTS[name], ep, **kw)
    got = _drive_breaker(tres, SCRIPTS[name], ep, **kw)
    assert got == want
    # the same transitions counted and the same state gauged
    for (t0, j0), s in zip(tr, ("open", "half_open", "closed")):
        assert tmetrics.CIRCUIT_TRANSITIONS.value(endpoint=ep, to=s) - t0 \
            == jmetrics.CIRCUIT_TRANSITIONS.value(endpoint=ep, to=s) - j0
    assert tmetrics.CIRCUIT_STATE.value(endpoint=ep) == \
        jmetrics.CIRCUIT_STATE.value(endpoint=ep)


def test_breaker_registry_shares_instances():
    a = tres.breaker_for("torch-shared-ep")
    assert tres.breaker_for("torch-shared-ep") is a
    for _ in range(a.failure_threshold):
        a.record_failure(TimeoutError())
    assert a.state == tres.OPEN
    tres.reset_breakers()  # in place: cached references stay live
    assert tres.breaker_for("torch-shared-ep") is a
    assert a.state == tres.CLOSED

    class Dao:
        metrics_backend = "memory"

    class Remote(Dao):
        resilience_endpoint = "http://h:1"

    assert tres.endpoint_of(Dao()) == jres.endpoint_of(Dao()) == "memory"
    assert tres.endpoint_of(Remote()) == "http://h:1"
    assert tres.endpoint_of(object()) is None
    assert tres.storage_ready(object()) is True
    assert tres.storage_ready(lambda: Dao()) is True

    def boom():
        raise RuntimeError("storage not configured")

    assert tres.storage_ready(boom) is jres.storage_ready(boom) is False
    br = tres.breaker_for("memory")
    for _ in range(br.failure_threshold):
        br.record_failure(TimeoutError())
    assert tres.storage_ready(Dao()) is False
    for e in (tres.CircuitOpenError("x", 1.0),
              tbase.StorageCircuitOpen("x", 1.0), TimeoutError(),
              ConnectionRefusedError(), tbase.StorageError("x")):
        assert tres.degrade_reason_for(e) == jres.degrade_reason_for(
            jres.CircuitOpenError("x", 1.0)
            if isinstance(e, tres.CircuitOpenError) else e)


# ---------------------------------------------------------------------------
# The PIO_FAULTS grammar
# ---------------------------------------------------------------------------

BAD_SPECS = ["kind=tornado", "rate=0.5,every=2,kind=refuse", "bogus_key=1",
             "kind=refuse,every=0", "kind=refuse,every=-3",
             "kind=refuse,rate=1.5", "kind=refuse,rate=-0.1",
             "kind=slow,delay=x"]
GOOD_SPECS = [
    "backend=sqlite,kind=refuse,rate=0.3,seed=11",
    "op=insert*,kind=timeout,every=3,after=2,times=2",
    "backend=jsonl*,op=find*,kind=error,every=1,status=429,"
    "retry_after=2.5",
    "kind=torn,every=4;kind=refuse,rate=0.2,seed=5",
    "backend=resthttp,op=insert*,kind=refuse,rate=0.1,seed=7;"
    "backend=sqlite,op=insert_batch,kind=torn,after=2,times=1",
]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_fault_specs_refused_like_jax(spec):
    # a malformed number is a ValueError in both, the rest FaultSpecError
    with pytest.raises(ValueError) as je:
        jfaults.FaultInjector.parse(spec)
    with pytest.raises(ValueError) as te:
        tfaults.FaultInjector.parse(spec)
    assert (type(te.value).__name__, str(te.value)) == \
        (type(je.value).__name__, str(je.value))
    assert isinstance(te.value, tfaults.FaultSpecError) == \
        isinstance(je.value, jfaults.FaultSpecError)


def _decisions(faults, spec, calls):
    inj = faults.FaultInjector.parse(spec)
    out = []
    for backend, op in calls:
        try:
            d = inj.maybe_fault(backend, op)
            out.append("torn" if d is not None else ".")
        except faults.InjectedFault as e:
            out.append((type(e).__name__, getattr(e, "status", None),
                        getattr(e, "pio_retry_after", None),
                        getattr(e, "pio_retry_class", None)))
    return out


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_fault_decisions_equal_jax(spec, monkeypatch):
    monkeypatch.setattr(jfaults.time, "sleep", lambda d: None)
    monkeypatch.setattr(tfaults.time, "sleep", lambda d: None)
    rng = random.Random(3)
    calls = [(rng.choice(["sqlite", "jsonlfs", "resthttp", "memory"]),
              rng.choice(["insert", "insert_batch", "find", "get",
                          "find_columnar_blocks"])) for _ in range(300)]
    assert _decisions(tfaults, spec, calls) == \
        _decisions(jfaults, spec, calls)


def test_slow_sleeps_once_and_env_spec_tracks(monkeypatch):
    sleeps = []
    monkeypatch.setattr(tfaults.time, "sleep", sleeps.append)
    inj = tfaults.FaultInjector.parse(
        "kind=slow,delay=0.2,every=1;kind=torn,every=1")
    assert inj.maybe_fault("sqlite", "insert_batch") is not None
    assert sleeps == [0.2]
    monkeypatch.setenv("PIO_FAULTS", "kind=refuse,every=1")
    with pytest.raises(tfaults.InjectedConnectionRefused):
        tfaults.maybe_fault("memory", "get")
    monkeypatch.setenv("PIO_FAULTS", "")
    assert tfaults.maybe_fault("memory", "get") is None


# ---------------------------------------------------------------------------
# DAOMetricsWrapper against the JAX wrapper
# ---------------------------------------------------------------------------


def _configure(st, backend, path):
    src = {"type": "memory"} if backend == "memory" else {
        "type": "sqlite", "path": str(path)}
    st.reset(st.StorageConfig(
        sources={"TEST": src},
        repositories={"METADATA": "TEST", "EVENTDATA": "TEST",
                      "MODELDATA": "TEST"}))


def _series(metrics):
    """Every storage / resilience series as {(family, labels): count}."""
    out = {}
    for fam in (metrics.STORAGE_OP_ERRORS, metrics.STORAGE_RETRIES,
                metrics.FAULTS_INJECTED):
        for labels, child in fam._items():
            out[(fam.name, labels)] = child.value
    for labels, child in metrics.STORAGE_OP_LATENCY._items():
        out[(metrics.STORAGE_OP_LATENCY.name, labels)] = \
            child.summary()["count"]
    return out


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


SCHEDULE = ("backend={b},kind=refuse,every=4,seed=3;"
            "backend={b},op=insert_batch,kind=timeout,every=5;"
            "backend={b},op=insert_batch,kind=torn,after=2,times=1;"
            "backend={b},op=get,kind=timeout,every=2")


def _run_ops(st, faults, Event, backend, ids):
    le = st.get_levents()
    faults.install(SCHEDULE.format(b=backend))
    le.init(1)
    for b in range(6):
        le.insert_batch([_event(Event, b * 5 + j, eid=ids[b * 5 + j])
                         for j in range(5)], 1)
    got = [le.get(i, 1).to_json() for i in ids[:6]]
    found = sorted(e.to_json() for e in le.find(1))
    agg = {k: (sorted(v.fields.items()), str(v.first_updated),
               str(v.last_updated))
           for k, v in le.aggregate_properties(1, "user").items()}
    assert le.delete(ids[0], 1)
    tail, cur = le.find_since(1, limit=7)
    faults.clear()
    return got, found, agg, len(tail)


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_wrapper_equals_jax_under_faults(backend, fast_retries, tmp_path):
    _configure(jstorage, backend, tmp_path / "j.db")
    _configure(tstorage, backend, tmp_path / "t.db")
    try:
        assert isinstance(tstorage.get_levents(), DAOMetricsWrapper)
        assert type(unwrap(tstorage.get_levents())).__name__ == \
            type(unwrap(jstorage.get_levents())).__name__
        ids = [new_event_id() for _ in range(30)]
        jb, tb = _series(jmetrics), _series(tmetrics)
        want = _run_ops(jstorage, jfaults, JEvent, backend, ids)
        got = _run_ops(tstorage, tfaults, TEvent, backend, ids)
        assert got == want
        assert len(got[1]) == 30  # every transient masked, no duplicate
        dj = _delta(_series(jmetrics), jb)
        dt_ = _delta(_series(tmetrics), tb)
        assert dt_ == dj
        assert dt_[("pio_faults_injected_total",
                    (backend, "insert_batch", "torn"))] == 1
        assert dt_[("pio_storage_retries_total",
                    (backend, "insert_batch"))] > 0
    finally:
        jstorage.reset()
        tstorage.reset()


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_torn_write_leaves_half_like_jax(backend, fast_retries, tmp_path,
                                         monkeypatch):
    monkeypatch.setenv("PIO_STORAGE_RETRIES", "0")
    _configure(jstorage, backend, tmp_path / "j.db")
    _configure(tstorage, backend, tmp_path / "t.db")
    try:
        ids = [new_event_id() for _ in range(8)]
        got = {}
        for name, st, faults, Event in (
                ("jax", jstorage, jfaults, JEvent),
                ("port", tstorage, tfaults, TEvent)):
            le = st.get_levents()
            le.init(1)
            faults.install(
                f"backend={backend},op=insert_batch,kind=torn,times=1")
            with pytest.raises(faults.InjectedTornWrite):
                le.insert_batch([_event(Event, i, eid=ids[i])
                                 for i in range(8)], 1)
            got[name] = sorted(e.event_id for e in le.find(1))
            # a retried batch (same ids) completes it exactly once
            le.insert_batch([_event(Event, i, eid=ids[i])
                             for i in range(8)], 1)
            assert sorted(e.event_id for e in le.find(1)) == sorted(ids)
        assert got["port"] == got["jax"] == sorted(ids[:4])
    finally:
        jstorage.reset()
        tstorage.reset()


@pytest.fixture
def mem_port():
    _configure(tstorage, "memory", None)
    yield tstorage
    tstorage.reset()


def test_lazy_find_failure_feeds_breaker(mem_port):
    class DyingScan:
        metrics_backend = "dying"

        @staticmethod
        def find(app_id, channel_id=None, **kw):
            yield _event(TEvent, 1)
            raise TimeoutError("disk fell over mid-scan")

    dao = DAOMetricsWrapper(DyingScan(), backend="dying")
    br = tres.breaker_for("dying")
    for _ in range(3):
        dao.find(1)  # creating (and dropping) generators is neutral
    assert br.state == "closed" and br._consecutive == 0
    for _ in range(br.failure_threshold):
        with pytest.raises(TimeoutError):
            list(dao.find(1))
    assert br.state == "open"


def test_persistent_failure_opens_breaker_fast_fail(fast_retries,
                                                    monkeypatch):
    monkeypatch.setenv("PIO_STORAGE_RETRIES", "0")
    _configure(tstorage, "memory", None)
    try:
        le = tstorage.get_levents()
        le.init(1)
        tfaults.install("backend=memory,op=get,kind=refuse,every=1")
        for _ in range(5):
            with pytest.raises(ConnectionRefusedError):
                le.get("nope", 1)
        assert tres.breaker_for("memory").state == tres.OPEN
        # the refusal is a StorageError AND a CircuitOpenError, and it
        # gates every op of the endpoint, not just the failing one
        for call in (lambda: le.get("nope", 1), lambda: le.init(2)):
            with pytest.raises(tbase.StorageCircuitOpen) as ei:
                call()
            assert isinstance(ei.value, tbase.StorageError)
            assert isinstance(ei.value, tres.CircuitOpenError)
            assert ei.value.pio_retry_after > 0
    finally:
        tstorage.reset()


def test_run_guarded_matches_jax():
    def drive(base, res, outcomes):
        now = [0.0]
        br = res.CircuitBreaker("guarded", failure_threshold=2,
                                reset_timeout=5.0, clock=lambda: now[0])
        pol = res.RetryPolicy(max_retries=1, base_delay=0.0,
                              max_delay=0.0, sleep=lambda d: None,
                              rng=random.Random(0))
        seen = []
        for exc in outcomes:
            def attempt(n, exc=exc):
                if exc is None:
                    return n
                raise exc("x")
            try:
                seen.append(("ok", base.run_guarded(br, pol, attempt)))
            except base.StorageCircuitOpen as e:
                assert isinstance(e, base.StorageError)
                assert isinstance(e, res.CircuitOpenError)
                seen.append(("open", e.endpoint))
            except Exception as e:  # noqa: BLE001 - compared below
                seen.append(("raised", type(e).__name__))
            seen.append(br.state)
        return seen

    outs = [TimeoutError, None, TimeoutError, TimeoutError, None, None,
            ValueError]
    assert drive(tbase, tres, outs) == drive(jbase, jres, outs)


def test_guarded_read_marks_circuit_open(mem_port):
    from predictionio_tpu_torch.data import store as tstore
    from predictionio_tpu_torch.data.store import (
        LEventStore,
        LEventStoreTimeoutError,
    )

    tstorage.get_metadata_apps().insert(tbase.App(0, "guardapp"))
    le = tstorage.get_levents()
    le.init(1)
    br = tres.breaker_for("memory")
    with tres.degraded_scope() as marks:
        assert LEventStore.find_by_entity("guardapp", "user", "u") == []
    assert marks == []
    for _ in range(br.failure_threshold):
        br.record_failure(TimeoutError())
    with tres.degraded_scope() as marks:
        with pytest.raises(tbase.StorageCircuitOpen):
            LEventStore.find_by_entity("guardapp", "user", "u",
                                       timeout=1.0)
    assert marks == ["circuit_open"]
    # outside a scope the refusal still raises, marking nothing
    with pytest.raises(tbase.StorageCircuitOpen):
        LEventStore.find("guardapp")
    # the kill switch reads straight through the open breaker
    tres.set_enabled(False)
    assert LEventStore.find_by_entity("guardapp", "user", "u",
                                      timeout=1.0) == []
    tres.set_enabled(True)
    tres.reset_breakers()
    # a wedged store: the deadline feeds the breaker until it opens
    wedge = threading.Event()
    real_find = unwrap(le).find

    def hung_find(*a, **k):
        wedge.wait(3)
        return real_find(*a, **k)

    unwrap(le).find = hung_find
    try:
        for _ in range(br.failure_threshold):
            with tres.degraded_scope() as marks:
                with pytest.raises(LEventStoreTimeoutError):
                    LEventStore.find_by_entity("guardapp", "user", "u",
                                               timeout=0.05)
            assert marks == ["timeout"]
        assert br.state == tres.OPEN
        with pytest.raises(tres.CircuitOpenError):
            LEventStore.find_by_entity("guardapp", "user", "u",
                                       timeout=0.05)
    finally:
        wedge.set()
        del unwrap(le).find
        tstore._breaker_cache = (None, None)


def test_kill_switch_bypasses_layer(mem_port):
    tres.set_enabled(False)
    tfaults.install("backend=memory,op=get,kind=refuse,every=1")
    le = tstorage.get_levents()
    le.init(1)
    with pytest.raises(ConnectionRefusedError):
        le.get("x", 1)  # faults fire; nothing retries or trips
    assert tres.breaker_for("memory").state == tres.CLOSED


# ---------------------------------------------------------------------------
# /healthz on all four servers
# ---------------------------------------------------------------------------


def _http_get(addr, path):
    conn = http.client.HTTPConnection(*addr, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = json.loads(resp.read().decode("utf-8"))
    conn.close()
    return resp.status, body


def _trip(res, endpoint):
    br = res.breaker_for(endpoint)
    for _ in range(br.failure_threshold):
        br.record_failure(TimeoutError())


def test_event_server_healthz_flips_like_jax():
    from predictionio_tpu.data.api import EventServer as JEventServer
    from predictionio_tpu.data.api import EventServerConfig as JConfig

    _configure(jstorage, "memory", None)
    _configure(tstorage, "memory", None)
    js = JEventServer(JConfig(ip="127.0.0.1", port=0)).start()
    ts = EventServer(EventServerConfig(ip="127.0.0.1", port=0)).start()
    try:
        for res, srv in ((jres, js), (tres, ts)):
            assert _http_get(srv.address, "/healthz") == (200, {
                "alive": True, "ready": True, "checks": {"storage": True},
                "server": "event", "pid": os.getpid()})
        _trip(jres, "memory")
        _trip(tres, "memory")
        got = _http_get(ts.address, "/healthz")
        assert got == _http_get(js.address, "/healthz")
        assert got[0] == 503 and got[1]["checks"] == {"storage": False}
        tres.reset_breakers()
        assert _http_get(ts.address, "/healthz")[0] == 200
    finally:
        js.stop()
        ts.stop()
        jstorage.reset()
        tstorage.reset()


def test_admin_and_dashboard_healthz_like_jax():
    from predictionio_tpu.tools.admin_server import (
        AdminServer as JAdmin,
        AdminServerConfig as JAdminConfig,
    )
    from predictionio_tpu.tools.dashboard import (
        Dashboard as JDash,
        DashboardConfig as JDashConfig,
    )
    from predictionio_tpu_torch.tools.admin_server import (
        AdminServer,
        AdminServerConfig,
    )
    from predictionio_tpu_torch.tools.dashboard import (
        Dashboard,
        DashboardConfig,
    )

    _configure(jstorage, "memory", None)
    _configure(tstorage, "memory", None)
    servers = []
    try:
        pairs = []
        for (J, JC), (T, TC) in (((JAdmin, JAdminConfig),
                                  (AdminServer, AdminServerConfig)),
                                 ((JDash, JDashConfig),
                                  (Dashboard, DashboardConfig))):
            j = J(JC(ip="127.0.0.1", port=0)).start()
            t = T(TC(ip="127.0.0.1", port=0)).start()
            servers += [j, t]
            pairs.append(tuple(("127.0.0.1", s._httpd.server_address[1])
                               for s in (j, t)))
        for ja, ta in pairs:
            got = _http_get(ta, "/healthz")
            assert got == _http_get(ja, "/healthz")
            assert got[0] == 200 and got[1]["checks"] == {"storage": True}
        _trip(jres, "memory")
        _trip(tres, "memory")
        for ja, ta in pairs:
            got = _http_get(ta, "/healthz")
            assert got == _http_get(ja, "/healthz")
            assert got[0] == 503 and not got[1]["ready"]
    finally:
        for s in servers:
            s.stop()
        jstorage.reset()
        tstorage.reset()


@pytest.fixture
def remote_stack(fast_retries, monkeypatch):
    """The recommendation template trained on the CPU from a ``resthttp``
    event store: an in-process port event server (memory) holds the
    events; the engine reads them over the wire."""
    reg = tstorage.StorageRegistry(tstorage.StorageConfig(
        sources={"S": {"type": "memory"}},
        repositories={"EVENTDATA": "S", "METADATA": "S",
                      "MODELDATA": "S"}))
    es = EventServer(EventServerConfig(ip="127.0.0.1", port=0,
                                       service_key=KEY), reg=reg).start()
    url = f"http://{es.address[0]}:{es.address[1]}"
    tstorage.reset(tstorage.StorageConfig(
        sources={"EV": {"type": "resthttp", "url": url,
                        "service_key": KEY},
                 "LOCAL": {"type": "memory"}},
        repositories={"EVENTDATA": "EV", "METADATA": "LOCAL",
                      "MODELDATA": "LOCAL"}))
    from predictionio_tpu_torch.workflow import create_server as tserver
    from predictionio_tpu_torch.workflow import create_workflow as tcw

    aid = tstorage.get_metadata_apps().insert(tbase.App(0, "remote"))
    le = tstorage.get_levents()
    le.init(aid)
    rng = np.random.default_rng(3)
    le.insert_batch([TEvent(
        event="rate", entity_type="user", entity_id=f"u{rng.integers(0, 12)}",
        target_entity_type="item", target_entity_id=f"i{rng.integers(0, 15)}",
        properties={"rating": float(rng.integers(1, 6))},
        event_time=T0 + dt.timedelta(seconds=j)) for j in range(160)], aid)
    cpu = ComputeContext(device="cpu")
    assert tcw.create_workflow(tcw.WorkflowConfig(
        engine_factory="predictionio_tpu_torch.templates.recommendation."
                       "engine:engine_factory"),
        {"datasource": {"params": {"appName": "remote"}},
         "algorithms": [{"name": "als", "params": {
             "rank": 4, "numIterations": 2, "seed": 1}}]}, ctx=cpu)
    dep = tserver.build_deployment(tserver.resolve_engine_instance(None),
                                   cpu)
    srv = tserver.QueryServer(tserver.ServerConfig(ip="127.0.0.1", port=0),
                              dep).start()
    yield {"es": es, "srv": srv, "url": url}
    srv.stop()
    es.stop()
    tstorage.reset()


def test_query_server_healthz_flips_on_breaker(remote_stack):
    srv, url = remote_stack["srv"], remote_stack["url"]
    status, body = _http_get(srv.address, "/healthz")
    assert status == 200 and body["checks"] == {
        "deployment": True, "device": True, "storage": True}
    _trip(tres, url)
    status, body = _http_get(srv.address, "/healthz")
    assert status == 503 and body["checks"]["storage"] is False
    assert body["checks"]["deployment"] and body["checks"]["device"]
    # the template serves from the device store: queries keep answering
    status, ans = srv.handle_query(b'{"user": "u1", "num": 3}')
    assert status == 200 and len(ans["itemScores"]) == 3
    tres.reset_breakers()
    assert _http_get(srv.address, "/healthz")[0] == 200


def test_blackout_keeps_answering_and_breaker_opens(remote_stack):
    """The event server stops: the template still answers from its
    device store, the wire's breaker opens on the store's failed reads,
    and the server reports not ready until the store heals."""
    srv, es, url = (remote_stack["srv"], remote_stack["es"],
                    remote_stack["url"])
    want = srv.handle_query(b'{"user": "u2", "num": 4}')
    es.stop()
    le = tstorage.get_levents()
    br = tres.breaker_for(url)
    for _ in range(br.failure_threshold):
        with pytest.raises(tbase.StorageError, match="unreachable"):
            le.get("nope", 1)
    assert br.state == tres.OPEN
    assert srv.health_checks()["storage"] is False
    assert srv.handle_query(b'{"user": "u2", "num": 4}') == want
    with tres.degraded_scope() as marks:
        from predictionio_tpu_torch.data.store import LEventStore

        with pytest.raises(tbase.StorageCircuitOpen):
            LEventStore.find_by_entity("remote", "user", "u2")
    assert marks == ["circuit_open"]


# ---------------------------------------------------------------------------
# The wrapper's cost
# ---------------------------------------------------------------------------


def test_wrapper_overhead_small(mem_port):
    """Retries + breaker on cost at most 10% of a memory ``get()``
    against the kill switch (the JAX guard). The switch flips every 50
    gets, so a busy host slows both sides alike; each lap gives the
    ratio of its on and off time, and the median of 15 laps counts.
    JAX's shape of the wrapper (every attempt through ``run_guarded``)
    fails it on a CPU (15-18%)."""
    le = tstorage.get_levents()
    le.init(1)
    ids = le.insert_batch([_event(TEvent, i) for i in range(50)], 1)

    def lap():
        spent = {True: 0.0, False: 0.0}
        for _ in range(40):
            for flag in (True, False):
                tres.set_enabled(flag)
                t0 = time.perf_counter()
                for eid in ids:
                    le.get(eid, 1)
                spent[flag] += time.perf_counter() - t0
        tres.set_enabled(True)
        return spent[True] / spent[False]

    lap()
    ratio = float(np.median([lap() for _ in range(15)]))
    assert ratio <= 1.10, f"resilience layer overhead {ratio - 1:.1%}"
