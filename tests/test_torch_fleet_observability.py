"""The fleet observability plane: the port's ``obs/`` against the JAX
package's, on the CPU.

Each check feeds the same inputs, made from a seed with numpy, to both
packages:

- ``assemble`` / ``fold_fragment`` / ``dedupe_spans``: equal records,
  and ``load_traces_from_dir`` folds a trace directory through
  ``obs.assemble`` to the JAX package's records;
- ``merge_member_families`` + ``render_fleet_prometheus``: equal merged
  families, byte-equal exposition and the same bounds-skew problems;
- ``SLOEngine.evaluate`` over one snapshot sequence with the clock
  pinned: equal alert blocks (burn rates), ``firing()``,
  ``alerts_block()`` and ``pio_slo_*`` gauges;
- ``load_slo_config`` (defaults, inline JSON, env, a file, invalid
  windows): equal configs or equal error messages;
- ``FleetFederation`` against fake HTTP members (a dead member degrades
  and recovers, an in-process member is not double-counted, a member
  that is not ready still scrapes): equal member rows and merged series.
"""

import copy
import dataclasses
import json
import os
import threading
from http.server import BaseHTTPRequestHandler

import numpy as np
import pytest

from predictionio_tpu.obs import assemble as jassemble
from predictionio_tpu.obs import federation as jfed
from predictionio_tpu.obs import slo as jslo
from predictionio_tpu.utils import metrics as jmetrics
from predictionio_tpu.utils import resilience as jres
from predictionio_tpu.utils import tracing as jtracing
from predictionio_tpu_torch.obs import assemble as tassemble
from predictionio_tpu_torch.obs import federation as tfed
from predictionio_tpu_torch.obs import slo as tslo
from predictionio_tpu_torch.utils import metrics as tmetrics
from predictionio_tpu_torch.utils import resilience as tres
from predictionio_tpu_torch.utils import tracing as ttracing
from predictionio_tpu_torch.utils.http_instrumentation import (
    SeveringThreadingHTTPServer,
)

PKGS = {"jax": (jassemble, jfed, jslo, jmetrics),
        "port": (tassemble, tfed, tslo, tmetrics)}


@pytest.fixture(autouse=True)
def _clean_breakers():
    jres.reset_breakers()
    tres.reset_breakers()
    yield
    jres.reset_breakers()
    tres.reset_breakers()


# -- trace assembly -------------------------------------------------------------

def random_fragments(seed, n_frag=4, n_spans=5):
    """Fragments of one trace: one holds the root span (not always the
    first), span ids repeat across fragments (an in-process member's
    fragment duplicates the balancer's), some fragments are empty."""
    rng = np.random.default_rng(seed)
    ids = [f"{int(v):016x}" for v in rng.integers(1, 2 ** 62, 3 * n_spans)]
    root = int(rng.integers(0, n_frag))
    frags = []
    for f in range(n_frag):
        spans = []
        for j in range(int(rng.integers(0 if f else 1, n_spans + 1))):
            sid = ids[int(rng.integers(0, len(ids)))]
            spans.append({"name": f"span{f}.{j}", "spanId": sid,
                          "parentId": ids[0] if sid != ids[0] else None,
                          "pid": 100 + int(rng.integers(0, 3)),
                          "durationSec": float(rng.random())})
        if f == root:
            spans.insert(0, {"name": "balancer POST /queries.json",
                             "spanId": "root" + str(seed), "parentId": None,
                             "pid": 99, "durationSec": 1.0})
        else:
            spans = [dict(s, parentId=s["parentId"] or "x") for s in spans]
        if rng.random() < 0.3:
            spans.append({"name": "no-id", "parentId": "x", "pid": 7})
        frags.append({"traceId": "t" * 32, "name": f"frag{f}",
                      "durationSec": float(rng.random() * 2),
                      "error": bool(rng.random() < 0.3),
                      "slow": bool(rng.random() < 0.3), "spans": spans})
    if rng.random() < 0.5:
        frags.insert(int(rng.integers(0, len(frags))), None)
    return frags


@pytest.mark.parametrize("seed", range(8))
def test_assemble_equals_the_jax_package(seed):
    frags = random_fragments(seed)
    got = tassemble.assemble(copy.deepcopy(frags))
    want = jassemble.assemble(copy.deepcopy(frags))
    assert got == want
    assert got["spans"][0]["name"] == "balancer POST /queries.json"
    real = [f for f in frags if f]
    for a, b in zip(real, real[1:]):
        assert tassemble.fold_fragment(copy.deepcopy(a), copy.deepcopy(b)) \
            == jassemble.fold_fragment(copy.deepcopy(a), copy.deepcopy(b))
        assert tassemble.topmost(a) == jassemble.topmost(a)
    for f in real:
        assert tassemble.dedupe_spans(copy.deepcopy(f)) \
            == jassemble.dedupe_spans(copy.deepcopy(f))
    assert tassemble.assemble([None, {"spans": []}]) is None \
        and jassemble.assemble([None, {"spans": []}]) is None


def test_trace_dir_folds_through_obs_assemble(tmp_path, monkeypatch):
    """``load_traces_from_dir`` reads fragments written by several
    processes and folds them with ``obs.assemble.fold_fragment``: the
    records equal the JAX package's reader's, and the port's fold is the
    one definition in ``obs``."""
    rng = np.random.default_rng(5)
    for proc in range(3):
        with open(tmp_path / f"traces-{proc}.jsonl", "w") as f:
            for t in range(4):
                frags = random_fragments(int(rng.integers(0, 1000)),
                                         n_frag=1)
                rec = dict(frags[-1] or frags[0], traceId=f"{t:032x}")
                f.write(json.dumps(rec) + "\n")
    want = jtracing.load_traces_from_dir(str(tmp_path))
    assert ttracing.load_traces_from_dir(str(tmp_path)) == want
    assert ttracing.load_traces_from_dir(
        str(tmp_path), trace_id=f"{2:032x}") == [want[2]]
    folds = []
    real = tassemble.fold_fragment
    monkeypatch.setattr(tassemble, "fold_fragment",
                        lambda a, b: folds.append(1) or real(a, b))
    ttracing.load_traces_from_dir(str(tmp_path))
    assert len(folds) == 4 * 2


# -- merging member families ----------------------------------------------------

def member_registries(metrics_mod, seed, skew=False):
    """Three members' registries from one seed: counters, a gauge and a
    histogram; with ``skew`` the last member's histogram has other
    bounds (a version-skewed member)."""
    rng = np.random.default_rng(seed)
    regs = []
    for i in range(3):
        reg = metrics_mod.MetricsRegistry(enabled=True)
        c = reg.counter("pio_obs_events_total", "events", ("kind",))
        for kind in ("rate", "set"):
            c.inc(float(rng.integers(0, 20)), kind=kind)
        reg.gauge("pio_obs_queue", "queue", ()).set(float(rng.random()))
        buckets = (0.5, 2.0) if skew and i == 2 else None
        h = reg.histogram("pio_obs_lat_seconds", "latency", ("route",),
                          buckets=buckets)
        for v in rng.exponential(0.05, int(rng.integers(1, 30))):
            h.observe(float(v), route="/q")
        if i == 1:
            reg.counter("pio_obs_only_one_total", "one member", ()).inc(3)
        regs.append(reg)
    return regs


@pytest.mark.parametrize("skew", [False, True], ids=["aligned", "skewed"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_merge_and_render_equal_the_jax_package(seed, skew):
    snaps = {}
    for pkg, (_, _, _, metrics_mod) in PKGS.items():
        snaps[pkg] = [(f"m{i}", r.snapshot()) for i, r in enumerate(
            member_registries(metrics_mod, seed, skew))]
    assert snaps["port"] == snaps["jax"]
    named = snaps["jax"]
    got, got_problems = tfed.merge_member_families(copy.deepcopy(named))
    want, want_problems = jfed.merge_member_families(copy.deepcopy(named))
    assert got == want and got_problems == want_problems
    assert bool(got_problems) == skew
    if skew:
        assert got_problems[0]["member"] == "m2" \
            and "bounds" in got_problems[0]["problem"]
    text = tfed.render_fleet_prometheus(got, named)
    assert text == jfed.render_fleet_prometheus(want, named)
    # the exposition re-parses (the port's parser) to the merged sums
    parsed = tmetrics.parse_prometheus(text)
    merged = [e for e in parsed["pio_obs_events_total"]["series"]
              if "member" not in e["labels"]]
    assert sorted(e["value"] for e in merged) == sorted(
        e["value"] for e in got["pio_obs_events_total"]["series"])


# -- SLO burn rates -------------------------------------------------------------

def slo_snapshots(seed, n=24):
    """A cumulative snapshot sequence of balancer ``/queries.json``
    traffic with bursts of errors, slow and degraded answers."""
    rng = np.random.default_rng(seed)
    total = errors = slow = degraded = 0
    out = []
    for _ in range(n):
        step = int(rng.integers(0, 40))
        bad = rng.random() < 0.4
        total += step
        errors += int(rng.integers(0, step + 1)) if bad else 0
        slow += int(rng.integers(0, step // 2 + 1)) if bad else 0
        degraded += int(rng.integers(0, 3)) if bad else 0
        ok, fast = total - errors, total - slow
        snap = {
            "pio_http_requests_total": {"type": "counter", "help": "",
                                        "series": [
                {"labels": {"server": "balancer", "route": "/queries.json",
                            "method": "POST", "status": "200"},
                 "value": float(ok)},
                {"labels": {"server": "balancer", "route": "/queries.json",
                            "method": "POST", "status": "503"},
                 "value": float(errors)},
                {"labels": {"server": "query", "route": "/queries.json",
                            "method": "POST", "status": "500"},
                 "value": 5.0}]},
            "pio_http_request_seconds": {"type": "histogram", "help": "",
                                         "series": [
                {"labels": {"server": "balancer", "route": "/queries.json"},
                 "count": total, "sum": 0.01 * fast + slow,
                 "max": 1.0 if slow else 0.01, "last": 0.01,
                 "buckets": [{"le": "0.1", "cumulative": fast},
                             {"le": "0.5", "cumulative": fast},
                             {"le": "+Inf", "cumulative": total}]}]}}
        if degraded:
            snap["pio_degraded_queries_total"] = {
                "type": "counter", "help": "", "series": [
                    {"labels": {"reason": "replica_down"},
                     "value": float(degraded)}]}
        out.append(snap)
    return out


def slo_gauges(metrics_mod):
    snap = metrics_mod.registry().snapshot()
    return {name: sorted((tuple(sorted(e["labels"].items())), e["value"])
                         for e in snap.get(name, {}).get("series", ()))
            for name in ("pio_slo_burn_rate", "pio_slo_budget_remaining")}


@pytest.mark.parametrize("seed", [4, 9, 21])
def test_slo_engine_equals_the_jax_package(seed):
    engines = {}
    for pkg, (_, _, slo_mod, _) in PKGS.items():
        engines[pkg] = slo_mod.SLOEngine(slo_mod.SLOConfig(
            fast_window_sec=60.0, slow_window_sec=300.0,
            burn_threshold=2.0))
    assert engines["port"].alerts_block() == engines["jax"].alerts_block()
    fired = 0
    for j, snap in enumerate(slo_snapshots(seed)):
        now = 1.7e9 + 20.0 * j
        got = engines["port"].evaluate(copy.deepcopy(snap), now=now)
        want = engines["jax"].evaluate(copy.deepcopy(snap), now=now)
        assert got == want, j
        assert engines["port"].firing() == engines["jax"].firing()
        assert engines["port"].alerts_block() \
            == engines["jax"].alerts_block()
        assert slo_gauges(tmetrics) == slo_gauges(jmetrics)
        fired += bool(got["firing"])
    assert fired, "the sequence never fired an alert"
    engines["port"].reset()
    engines["jax"].reset()
    assert engines["port"].alerts_block() == engines["jax"].alerts_block()


def config_tree(cfg):
    return dataclasses.asdict(dataclasses.replace(
        cfg, objectives={}), dict_factory=dict) | {
        "objectives": [dataclasses.asdict(o)
                       for o in cfg.objectives.values()]}


SLO_CASES = {
    "defaults": (None, {}),
    "inline": (None, {"PIO_SLO_CONFIG":
                      '{"fastWindowSec": 30, "burnThreshold": 5,'
                      ' "objectives": {"error_rate": {"budget": 0.02},'
                      '  "degraded_rate": {"disabled": true},'
                      '  "p999": {"kind": "latency", "thresholdSec": 2}}}',
                      "PIO_SLO_QUERY_LATENCY_P99_TARGET_SEC": "0.25",
                      "PIO_SLO_ERROR_RATE_DISABLED": "false"}),
    "env": (None, {"PIO_SLO_FAST_WINDOW_SEC": "10",
                   "PIO_SLO_SLOW_WINDOW_SEC": "100",
                   "PIO_SLO_BURN_THRESHOLD": "3",
                   "PIO_SLO_DEGRADED_RATE_BUDGET": "0.2",
                   "PIO_SLO_ERROR_RATE_DISABLED": "1"}),
    "explicit": ('{"slowWindowSec": 600}',
                 {"PIO_SLO_CONFIG": '{"slowWindowSec": 1200}'}),
    "inverted": (None, {"PIO_SLO_FAST_WINDOW_SEC": "600",
                        "PIO_SLO_SLOW_WINDOW_SEC": "60"}),
    "zero": ('{"fastWindowSec": 0}', {}),
    "unknown": (None, {"PIO_SLO_CONFIG":
                       '{"objectives": {"mystery": {"budget": 0.1}}}'}),
    "not-object": ("[1, 2]", {}),
    "bad-objective": ('{"objectives": {"error_rate": 3}}', {}),
}


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_load_slo_config_equals_the_jax_package(case):
    explicit, env = SLO_CASES[case]
    outcomes = []
    for slo_mod in (tslo, jslo):
        try:
            outcomes.append(config_tree(
                slo_mod.load_slo_config(explicit, env=dict(env))))
        except (ValueError, OSError) as e:
            outcomes.append((type(e).__name__, str(e)))
    assert outcomes[0] == outcomes[1]


def test_load_slo_config_from_a_file_equals_the_jax_package(tmp_path):
    p = tmp_path / "slo.json"
    p.write_text('{"burnThreshold": 6, "objectives": '
                 '{"query_latency_p99": {"thresholdSec": 0.1}}}')
    got = tslo.load_slo_config(str(p), env={})
    assert config_tree(got) == config_tree(jslo.load_slo_config(str(p),
                                                                env={}))
    assert got.burn_threshold == 6.0
    bad = tmp_path / "bad.json"
    bad.write_text('{"objectives": {"x": {}}}')
    errors = []
    for slo_mod in (tslo, jslo):
        with pytest.raises(ValueError) as e:
            slo_mod.load_slo_config(str(bad), env={})
        errors.append(str(e.value))
    assert errors[0] == errors[1] and str(bad) in errors[0]


# -- federation over fake HTTP members -------------------------------------------

class FakeMember:
    """A member-shaped HTTP server: ``/metrics`` from its own registry,
    ``/healthz`` with a given pid and readiness, ``/stats.json``."""

    def __init__(self, seed, pid=None, port=0, ready=True):
        self.registry = member_registries(tmetrics, seed)[seed % 3]
        self.pid = os.getpid() + 70000 + seed if pid is None else pid
        self.ready = ready
        member = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _send(self, status, body, ctype="application/json"):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    self._send(200, member.registry.render_prometheus()
                               .encode(), "text/plain; version=0.0.4")
                elif path == "/healthz":
                    self._send(200 if member.ready else 503, json.dumps(
                        {"alive": True, "ready": member.ready,
                         "checks": {"storage": member.ready},
                         "server": "eventserver",
                         "pid": member.pid}).encode())
                elif path == "/stats.json":
                    self._send(200, json.dumps(
                        {"status": "alive", "device": {"x": 1}}).encode())
                else:
                    self._send(404, b"{}")

        self.httpd = SeveringThreadingHTTPServer(("127.0.0.1", port),
                                                 Handler)
        self.httpd.daemon_threads = True
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def url(self):
        return "http://127.0.0.1:%d" % self.httpd.server_address[1]

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=5)


@pytest.fixture
def local_registries(monkeypatch):
    """Each package's federation reads a local registry of the same
    content, in place of the process-wide one other tests fill."""
    for fed_mod, metrics_mod in ((tfed, tmetrics), (jfed, jmetrics)):
        reg = member_registries(metrics_mod, 40)[0]
        monkeypatch.setattr(fed_mod.metrics, "registry", lambda r=reg: r)


def federations(targets):
    return [fed_mod.FleetFederation(targets=lambda: list(targets))
            for fed_mod in (tfed, jfed)]


def normalised(scrape):
    rows = [{k: v for k, v in r.items() if k != "lastOkAgeSec"}
            for r in scrape.members]
    for r in rows:
        if r.get("local"):
            r["pid"] = "<pid>"
    return rows, scrape.merged, scrape.problems, scrape.prometheus()


def observe_both(feds):
    got, want = (normalised(f.observe()) for f in feds)
    assert got == want
    return got


def test_federation_equals_the_jax_package(local_registries):
    members = [FakeMember(s) for s in (1, 2)]
    feds = federations([(f"shard{i}", m.url) for i, m in
                        enumerate(members)])
    try:
        rows, merged, problems, _ = observe_both(feds)
        assert [r["ok"] for r in rows] == [True, True, True]
        assert rows[1]["stats"] == {"status": "alive", "device": {"x": 1}}
        assert problems == []
        # a dead member: member_down, its series out, the rest merged
        port = members[1].httpd.server_address[1]
        members[1].stop()
        rows, merged, _, _ = observe_both(feds)
        assert rows[2]["ok"] is False and rows[2]["reason"] == "member_down"
        assert not tres.breaker_for(members[1].url).is_blocking
        # recovery on the same port
        members[1] = FakeMember(2, port=port)
        tres.reset_breakers()
        jres.reset_breakers()
        rows, _, _, _ = observe_both(feds)
        assert all(r["ok"] for r in rows)
    finally:
        for f in feds:
            f.close()
        for m in members:
            m.stop()


def test_in_process_and_unready_members_equal_the_jax_package(
        local_registries):
    inproc = FakeMember(3, pid=os.getpid())
    sick = FakeMember(4, ready=False)
    feds = federations([("shard0", inproc.url), ("shard1", sick.url)])
    try:
        rows, merged, _, text = observe_both(feds)
        assert rows[1]["inProcess"] is True
        assert rows[2]["ok"] is True and rows[2]["ready"] is False
        # the in-process member is counted once (through the local
        # registry), the unready one is merged
        assert "member=\"shard0\"" not in text
        assert "member=\"shard1\"" in text
        local = member_registries(tmetrics, 40)[0].snapshot()
        sick_snap = sick.registry.snapshot()
        want = sum(e["value"] for s in (local, sick_snap)
                   for e in s["pio_obs_events_total"]["series"])
        assert sum(e["value"] for e in merged["pio_obs_events_total"]
                   ["series"]) == want
    finally:
        for f in feds:
            f.close()
        inproc.stop()
        sick.stop()


def test_federation_with_slo_equals_the_jax_package(local_registries):
    """With an SLO engine, each observation evaluates the merged view:
    the alerts blocks and the merged series are equal."""
    member = FakeMember(5)
    feds = [fed_mod.FleetFederation(
        targets=lambda: [("shard0", member.url)],
        slo=slo_mod.SLOEngine(slo_mod.SLOConfig()))
        for fed_mod, slo_mod in ((tfed, tslo), (jfed, jslo))]
    try:
        scrapes = [f.observe() for f in feds]
        assert scrapes[0].alerts == scrapes[1].alerts
        assert set(scrapes[0].alerts["objectives"]) == {
            "query_latency_p99", "error_rate", "degraded_rate"}
        assert normalised(scrapes[0])[1] == normalised(scrapes[1])[1]
        # a scrape younger than max_age_sec is reused
        assert feds[0].observe(max_age_sec=60.0) is scrapes[0]
        assert feds[0].last() is scrapes[0]
    finally:
        for f in feds:
            f.close()
        member.stop()
