"""The event-store fleet: the port's consistent-hash router against the
JAX package's, on the CPU.

- ``HashRing``: ``stable_hash``, ``node_for`` and ``preference`` equal the
  JAX ring's for 10,000 keys at N = 1-5.
- A port router over three port shards and a JAX router over three JAX
  shards (live in-process event servers over ``memory``, ``sqlite`` or
  ``jsonlfs``) take one event stream: every event lands on the same
  shard in both; ``find`` is time-ordered and equal in both, and equal
  as a set to one big store's (filters too); the entity fast path is
  exact; ``limit`` cuts the global order; aggregates equal the big
  store's; ``find_since`` drains each event exactly once; the columnar
  reads equal the big store's.
- The composed cursor ``{"fleetShards": {url: cursor}}``: the tail
  anchor skips history, watermarks compose, per-shard metrics carry the
  shard label.
- A dead shard: scatter reads raise outside a serving scope and answer
  partially, marked ``shard_down``, inside one; writes to it always
  raise; its cursor entry is not advanced, so its events arrive after a
  restart, never lost; an injected transient is absorbed by the wire.
- ``pio-torch status`` prints the JAX text for a ``fleet`` source, with
  every shard up and with one down.
- Online fold-in over a ``fleet`` source (``device="cpu"``) patches the
  rows a single-store fold patches, and a dead shard delays its users'
  folds until it is back.

Every server binds port 0 (a restarted shard rebinds its own port);
breakers and injectors of both packages are reset around each test.
"""

import contextlib
import datetime as dt
import importlib
import io
import random
import threading

import numpy as np
import pytest

from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.fleet import ring as jring
from predictionio_tpu.fleet import router as jrouter
from predictionio_tpu.utils import faults as jfaults
from predictionio_tpu.utils import resilience as jres
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data.event import new_event_id
from predictionio_tpu_torch.data.storage.base import App, StorageError
from predictionio_tpu_torch.fleet import ring as tring
from predictionio_tpu_torch.fleet import router as trouter
from predictionio_tpu_torch.utils import faults as tfaults
from predictionio_tpu_torch.utils import metrics as tmetrics
from predictionio_tpu_torch.utils import resilience as tres

from jax_native_ready import require_jax_native


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded(tmp_path_factory):
    """The JAX package's native libraries loaded before any comparison
    (``jax_native_ready``): a build raced by another worker is waited
    out, never compared against as the Python fallback."""
    require_jax_native(tmp_path_factory.getbasetemp().parent)

UTC = dt.timezone.utc
APP = 1
KEY = "torch-fleet-key"
PKGS = {"jax": "predictionio_tpu", "port": "predictionio_tpu_torch"}


@pytest.fixture(autouse=True)
def _clean_resilience(monkeypatch):
    monkeypatch.setenv("PIO_STORAGE_RETRY_BASE", "0.005")
    monkeypatch.setenv("PIO_STORAGE_RETRY_MAX", "0.02")
    monkeypatch.setenv("PIO_STORAGE_CONNECT_TIMEOUT", "1.0")
    for faults, res in ((jfaults, jres), (tfaults, tres)):
        faults.clear()
        res.reset_breakers()
    yield
    for faults, res in ((jfaults, jres), (tfaults, tres)):
        faults.clear()
        res.reset_breakers()


def t(i):
    return dt.datetime(2022, 3, 1, tzinfo=UTC) + dt.timedelta(seconds=int(i))


def random_stream(seed, n=48, n_users=9, n_items=6):
    """Plain dicts, turned into either package's ``Event`` (ids and
    creation times fixed, so both fleets and the big store hold the
    same events)."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        roll = rng.random()
        when = rng.randrange(n * 2)  # out of order, colliding times
        eid = f"ev{seed}-{i}"
        if roll < 0.5:
            out.append(dict(event="rate", entity_type="user",
                            entity_id=f"u{rng.randrange(n_users)}",
                            target_entity_type="item",
                            target_entity_id=f"i{rng.randrange(n_items)}",
                            properties={"rating":
                                        float(rng.randint(1, 5))},
                            event_time=t(when), event_id=eid))
        elif roll < 0.8:
            out.append(dict(event="$set",
                            entity_type=rng.choice(("user", "item")),
                            entity_id=f"e{rng.randrange(n_users)}",
                            properties={rng.choice("abc"): i},
                            event_time=t(when), event_id=eid))
        else:
            out.append(dict(event="$unset", entity_type="user",
                            entity_id=f"e{rng.randrange(n_users)}",
                            properties={rng.choice("abc"): 0},
                            event_time=t(when), event_id=eid))
    return out


def events(pkg, dicts):
    Event = importlib.import_module(f"{PKGS[pkg]}.data.event").Event
    return [Event(creation_time=t(0), **d) for d in dicts]


def rate(user, item, at, pkg="port"):
    return events(pkg, [dict(event="rate", entity_type="user",
                             entity_id=user, target_entity_type="item",
                             target_entity_id=item,
                             properties={"rating": 4.0},
                             event_time=t(at),
                             event_id=new_event_id())])[0]


def _shard_source(backend, path):
    if backend == "memory":
        return {"type": "memory"}
    if backend == "sqlite":
        return {"type": "sqlite", "path": str(path) + ".db"}
    return {"type": "jsonlfs", "path": str(path), "part_max_events": 7}


class ShardCluster:
    """N live in-process event servers of one package + its fleet DAOs."""

    def __init__(self, pkg, backend, tmp_path, n=3):
        self.pkg, self.backend, self.tmp_path = pkg, backend, tmp_path
        self.st = importlib.import_module(f"{PKGS[pkg]}.data.storage")
        api = importlib.import_module(f"{PKGS[pkg]}.data.api")
        self.Server, self.Config = api.EventServer, api.EventServerConfig
        self.router = importlib.import_module(f"{PKGS[pkg]}.fleet.router")
        self.servers, self.urls = [], []
        for i in range(n):
            self._start_shard(i)
        self.cfg = {"urls": ",".join(self.urls), "service_key": KEY}
        self.fleet = self.router.FleetLEvents(dict(self.cfg))
        self.pfleet = self.router.FleetPEvents(dict(self.cfg))

    def _start_shard(self, idx, port=0):
        reg = self.st.StorageRegistry(self.st.StorageConfig(
            sources={"EV": _shard_source(
                self.backend, self.tmp_path / f"{self.pkg}-shard{idx}"),
                "META": {"type": "memory"}},
            repositories={"EVENTDATA": "EV", "METADATA": "META",
                          "MODELDATA": "META"}))
        srv = self.Server(self.Config(ip="127.0.0.1", port=port,
                                      service_key=KEY), reg=reg).start()
        if idx < len(self.servers):
            self.servers[idx] = srv
        else:
            self.servers.append(srv)
            self.urls.append(f"http://127.0.0.1:{srv.address[1]}")

    def shard_ids(self, idx):
        le = self.servers[idx].event_client
        return sorted(e.event_id for e in le.find(APP))

    def kill_shard(self, idx):
        self.servers[idx].stop()

    def restart_shard(self, idx):
        self._start_shard(idx, port=int(self.urls[idx].rsplit(":", 1)[1]))

    def close(self):
        for dao in (self.fleet, self.pfleet):
            dao.close()
        stop_all(self.servers)


def stop_all(servers):
    """Stop servers together: each ``stop`` waits out a poll interval."""
    threads = [threading.Thread(target=s.stop) for s in servers]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)


@pytest.fixture
def clusters(tmp_path, request):
    made = {pkg: ShardCluster(pkg, request.param, tmp_path)
            for pkg in ("jax", "port")}
    yield made
    for c in made.values():
        for dao in (c.fleet, c.pfleet):
            dao.close()
    stop_all(made["jax"].servers + made["port"].servers)


@pytest.fixture
def port_cluster(tmp_path):
    c = ShardCluster("port", "memory", tmp_path)
    yield c
    c.close()


def reference():
    from predictionio_tpu_torch.data.storage.memory import MemLEvents

    ref = MemLEvents({})
    ref.init(APP)
    return ref


def ids_of(evs):
    return [e.event_id for e in evs]


def drain(le, cursor=None, limit=None, rounds=50):
    out = []
    for _ in range(rounds):
        got, cursor = le.find_since(APP, cursor=cursor, limit=limit)
        if not got:
            break
        out.extend(got)
    return out, cursor


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_ring_equals_jax(n):
    keys = [f"user/u{i}" for i in range(5000)] + \
        [f"item/i{i}" for i in range(5000)]
    jr, tr = jring.HashRing(n), tring.HashRing(n)
    assert [tr.node_for(k) for k in keys] == [jr.node_for(k) for k in keys]
    assert [list(tr.preference(k)) for k in keys[::7]] == \
        [list(jr.preference(k)) for k in keys[::7]]
    assert {tr.node_for(k) for k in keys} == set(range(n))
    for k in keys[:50]:
        assert tring.stable_hash(k) == jring.stable_hash(k)
    few = tring.HashRing(n, virtual_nodes=3)
    assert [few.node_for(k) for k in keys[:300]] == \
        [jring.HashRing(n, virtual_nodes=3).node_for(k)
         for k in keys[:300]]
    with pytest.raises(ValueError):
        tring.HashRing(0)


def test_router_helpers_equal_jax():
    for cfg in ({"urls": "http://a:1, http://b:2/"}, {"url": "http://a:1"},
                {"urls": "http://a:1\nhttp://b:2 http://c:3"}):
        assert trouter.parse_urls(cfg) == jrouter.parse_urls(cfg)
    with pytest.raises(StorageError, match="URLS"):
        trouter.parse_urls({})
    assert trouter.entity_key("user", "u1") == \
        jrouter.entity_key("user", "u1")
    assert trouter.CURSOR_KEY == jrouter.CURSOR_KEY == "fleetShards"
    for a, b in (("2022-03-01T11:00:00-02:00", "2022-03-01T12:00:00Z"),
                 ("2022-03-01T12:00:00+00:00", "2022-03-01T13:00:00+01:00"),
                 (dt.datetime(2022, 3, 1, 12, 0, 1), "2022-03-01T12:00:00Z"),
                 ("b", "a"), ("a", "b")):
        assert trouter._time_newer(a, b) == jrouter._time_newer(a, b)


# ---------------------------------------------------------------------------
# The router: port fleet == JAX fleet == one big store
# ---------------------------------------------------------------------------


def seed_all(clusters, seed=0, n=48):
    dicts = random_stream(seed, n=n)
    ref = reference()
    ref.insert_batch(events("port", dicts), APP)
    for pkg, c in clusters.items():
        c.fleet.init(APP)
        assert c.fleet.insert_batch(events(pkg, dicts), APP) == \
            [d["event_id"] for d in dicts]  # ids in input order
    return dicts, ref


BACKENDS = ["memory", "sqlite", "jsonlfs"]


@pytest.mark.parametrize("clusters", BACKENDS, indirect=True)
def test_writes_land_on_the_same_shards(clusters):
    dicts, _ = seed_all(clusters)
    port, jax = clusters["port"], clusters["jax"]
    ring = tring.HashRing(3)
    for i in range(3):
        want = sorted(d["event_id"] for d in dicts if ring.node_for(
            trouter.entity_key(d["entity_type"], d["entity_id"])) == i)
        assert port.shard_ids(i) == jax.shard_ids(i) == want


@pytest.mark.parametrize("clusters", BACKENDS, indirect=True)
def test_find_equals_jax_and_one_big_store(clusters):
    _, ref = seed_all(clusters)
    pf, jf = clusters["port"].fleet, clusters["jax"].fleet
    got = list(pf.find(APP))
    assert ids_of(got) == ids_of(jf.find(APP))
    assert set(ids_of(got)) == set(ids_of(ref.find(APP)))
    times = [e.event_time for e in got]
    assert times == sorted(times)
    for kw in ({"event_names": ("rate",)},
               {"start_time": t(10), "until_time": t(60)},
               {"entity_type": "user"}, {"reversed": True},
               {"target_entity_type": None}):
        assert ids_of(pf.find(APP, **kw)) == ids_of(jf.find(APP, **kw)), kw
        assert set(ids_of(pf.find(APP, **kw))) == \
            set(ids_of(ref.find(APP, **kw))), kw


@pytest.mark.parametrize("clusters", BACKENDS, indirect=True)
def test_entity_fast_path_exact(clusters):
    dicts, ref = seed_all(clusters)
    pf = clusters["port"].fleet
    for etype, eid in sorted({(d["entity_type"], d["entity_id"])
                              for d in dicts}):
        for rev in (False, True):
            assert ids_of(pf.find(APP, entity_type=etype, entity_id=eid,
                                  reversed=rev)) == \
                ids_of(ref.find(APP, entity_type=etype, entity_id=eid,
                                reversed=rev)), (etype, eid, rev)


@pytest.mark.parametrize("clusters", BACKENDS, indirect=True)
def test_limit_cuts_global_order(clusters):
    dicts = [dict(event="rate", entity_type="user", entity_id=f"u{i % 5}",
                  target_entity_type="item", target_entity_id=f"i{i % 3}",
                  properties={"rating": 4.0}, event_time=t(i),
                  event_id=f"lim{i}") for i in range(20)]
    ref = reference()
    ref.insert_batch(events("port", dicts), APP)
    for pkg, c in clusters.items():
        c.fleet.init(APP)
        c.fleet.insert_batch(events(pkg, dicts), APP)
    for lim in (0, 7, 19, 40):
        want = ids_of(ref.find(APP, limit=lim))
        assert ids_of(clusters["port"].fleet.find(APP, limit=lim)) == want
        assert ids_of(clusters["jax"].fleet.find(APP, limit=lim)) == want


@pytest.mark.parametrize("clusters", BACKENDS, indirect=True)
def test_aggregates_and_columnar_equal(clusters):
    _, ref = seed_all(clusters, seed=3)
    port, jax = clusters["port"], clusters["jax"]
    for etype in ("user", "item"):
        want = ref.aggregate_properties(APP, etype)
        got = port.fleet.aggregate_properties(APP, etype)
        assert got == want, etype
        assert port.fleet.aggregate_properties_replay(APP, etype) == want
        assert {k: (v.fields, v.first_updated, v.last_updated)
                for k, v in got.items()} == \
            {k: (v.fields, v.first_updated, v.last_updated)
             for k, v in jax.fleet.aggregate_properties(APP, etype).items()}
        assert port.pfleet.aggregate_properties(APP, etype) == want
    for kw in ({}, {"event_names": ["rate"], "value_property": "rating"}):
        tb = port.pfleet.find_columnar(APP, **kw)
        jb = jax.pfleet.find_columnar(APP, **kw)
        for col in ("entity_ids", "target_ids", "values", "event_times"):
            np.testing.assert_array_equal(np.asarray(getattr(tb, col)),
                                          np.asarray(getattr(jb, col)))
        assert sum(len(b) for b in port.pfleet.find_columnar_blocks(
            APP, block_size=5, **kw)) == len(tb)
    assert sorted(ids_of(port.pfleet.find(APP))) == \
        sorted(ids_of(ref.find(APP)))


@pytest.mark.parametrize("clusters", BACKENDS, indirect=True)
def test_find_since_drains_exactly_once(clusters):
    dicts, _ = seed_all(clusters, seed=5)
    pf = clusters["port"].fleet
    got, cursor = drain(pf, limit=7)
    assert sorted(ids_of(got)) == sorted(d["event_id"] for d in dicts)
    assert len(got) == len(dicts)
    jgot, jcursor = drain(clusters["jax"].fleet, limit=7)
    assert ids_of(got) == ids_of(jgot)
    assert list(cursor) == list(jcursor) == [trouter.CURSOR_KEY]
    fresh_ids = pf.insert_batch([rate("u-new", "i1", 500 + i)
                                 for i in range(5)], APP)
    got2, cursor = drain(pf, cursor=cursor)
    assert sorted(ids_of(got2)) == sorted(fresh_ids)
    assert pf.find_since(APP, cursor=cursor)[0] == []


# ---------------------------------------------------------------------------
# The composed cursor
# ---------------------------------------------------------------------------


def test_tail_cursor_skips_history(port_cluster):
    fleet = port_cluster.fleet
    fleet.init(APP)
    fleet.insert_batch([rate(f"u{i}", "i0", i) for i in range(12)], APP)
    cur = fleet.tail_cursor(APP)
    assert set(cur[trouter.CURSOR_KEY]) == set(port_cluster.urls)
    fresh = fleet.insert_batch([rate(f"u{i}", "i1", 100 + i)
                                for i in range(9)], APP)
    got, cur2 = drain(fleet, cursor=cur, limit=4)
    assert sorted(ids_of(got)) == sorted(fresh)
    assert fleet.find_since(APP, cursor=cur2)[0] == []


def test_watermark_composes_and_shards_are_labelled(port_cluster):
    fleet = port_cluster.fleet
    fleet.init(APP)
    ids = fleet.insert_batch([rate(f"u{i}", "i0", i) for i in range(6)],
                             APP)
    wm = fleet.tail_watermark(APP)
    assert set(wm["cursor"][trouter.CURSOR_KEY]) == set(port_cluster.urls)
    assert wm["lastEventId"] == ids[-1]
    list(fleet.find(APP))
    assert all(tmetrics.STORAGE_OP_LATENCY.child(
        backend="fleet", op="find", shard=str(i)).summary()["count"] > 0
        for i in range(3))
    topo = fleet.topology()
    assert topo["healthyShards"] == 3 and topo["virtualNodes"] == 128
    assert [s["breakerState"] for s in topo["shards"]] == ["closed"] * 3


# ---------------------------------------------------------------------------
# A dead shard
# ---------------------------------------------------------------------------


def entity_on(fleet, shard):
    for i in range(1000):
        if fleet._shard_for_entity("user", f"u{i}") == shard:
            return f"u{i}"
    raise AssertionError("the ring left a shard empty")


def seed_port(cluster, n=30):
    cluster.fleet.init(APP)
    return cluster.fleet.insert_batch(
        [rate(f"u{i % 10}", f"i{i % 4}", i) for i in range(n)], APP)


def test_scatter_read_degrades_inside_scope_only(port_cluster):
    fleet = port_cluster.fleet
    seed_port(port_cluster)
    before = set(ids_of(fleet.find(APP)))
    port_cluster.kill_shard(1)
    with pytest.raises(StorageError):
        list(fleet.find(APP))
    with pytest.raises(StorageError):
        port_cluster.pfleet.find_columnar(APP)  # training never degrades
    with tres.degraded_scope() as marks:
        got = set(ids_of(fleet.find(APP)))
    assert "shard_down" in marks and got and got < before
    with tres.degraded_scope() as marks:
        assert isinstance(fleet.aggregate_properties(APP, "user"), dict)
    assert {"shard_down", "partial_aggregation"} <= set(marks)
    assert fleet.topology()["partialReads"] >= 2


def test_entity_fast_path_degrades_to_empty(port_cluster):
    fleet = port_cluster.fleet
    seed_port(port_cluster)
    dead, live = entity_on(fleet, 1), entity_on(fleet, 0)
    fleet.insert(rate(dead, "i9", 900), APP)
    fleet.insert(rate(live, "i9", 901), APP)
    port_cluster.kill_shard(1)
    with tres.degraded_scope() as marks:
        dead_read = list(fleet.find(APP, entity_type="user",
                                    entity_id=dead))
        live_read = list(fleet.find(APP, entity_type="user",
                                    entity_id=live))
    assert dead_read == [] and "shard_down" in marks
    assert any(e.target_entity_id == "i9" for e in live_read)


def test_writes_fail_loud(port_cluster):
    fleet = port_cluster.fleet
    fleet.init(APP)
    dead, live = entity_on(fleet, 2), entity_on(fleet, 0)
    port_cluster.kill_shard(2)
    assert fleet.insert(rate(live, "i1", 1), APP)
    with tres.degraded_scope():  # a serving scope changes nothing
        with pytest.raises(StorageError):
            fleet.insert(rate(dead, "i1", 2), APP)
    with pytest.raises(StorageError):
        fleet.insert_batch([rate(live, "i2", 3), rate(dead, "i2", 4)], APP)


def test_cursor_survives_shard_restart(tmp_path):
    c = ShardCluster("port", "jsonlfs", tmp_path)  # disk-backed
    try:
        fleet = c.fleet
        fleet.init(APP)
        fleet.insert_batch([rate(f"u{i}", "i0", i) for i in range(12)], APP)
        _, cursor = drain(fleet)
        pre_death = fleet.insert_batch(
            [rate(f"u{i}", "i1", 50 + i) for i in range(9)], APP)
        c.kill_shard(1)
        got, cursor = drain(fleet, cursor=cursor)  # no scope: still ok
        missing = set(pre_death) - set(ids_of(got))
        assert missing
        with pytest.raises(StorageError):
            fleet.tail_cursor(APP)  # a fresh anchor needs every shard
        c.restart_shard(1)
        tres.reset_breakers()
        got2, cursor = drain(fleet, cursor=cursor)
        assert set(ids_of(got2)) == missing
    finally:
        c.close()


def test_all_shards_down_raises_even_degraded(port_cluster):
    fleet = port_cluster.fleet
    seed_port(port_cluster)
    for i in range(3):
        port_cluster.kill_shard(i)
    with tres.degraded_scope():
        with pytest.raises(StorageError):
            list(fleet.find(APP))
        with pytest.raises(StorageError):
            fleet.find_since(APP)


def test_transient_faults_absorbed_by_wire(port_cluster):
    fleet = port_cluster.fleet
    ids = seed_port(port_cluster)
    tfaults.install("backend=resthttp,kind=refuse,every=3,seed=7")
    with tres.degraded_scope() as marks:
        got = set(ids_of(fleet.find(APP)))
    assert got == set(ids) and "shard_down" not in marks


# ---------------------------------------------------------------------------
# pio status over a fleet source
# ---------------------------------------------------------------------------


def _status(cli, st):
    st.reset()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["status"])
    st.reset()
    return rc, out.getvalue(), err.getvalue()


def test_status_text_equals_jax(port_cluster, monkeypatch):
    from predictionio_tpu.tools import cli as jcli
    from predictionio_tpu_torch.tools import cli as tcli

    for k, v in {"PIO_STORAGE_SOURCES_FLEET_TYPE": "fleet",
                 "PIO_STORAGE_SOURCES_FLEET_URLS": ",".join(
                     port_cluster.urls),
                 "PIO_STORAGE_SOURCES_FLEET_SERVICE_KEY": KEY,
                 "PIO_STORAGE_SOURCES_META_TYPE": "memory",
                 "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "FLEET",
                 "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "META",
                 "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "META",
                 "PIO_STORAGE_RETRIES": "1"}.items():
        monkeypatch.setenv(k, v)
    try:
        want = _status(jcli, jstorage)
        got = _status(tcli, tstorage)
        assert got == want
        assert got[0] == 0
        assert "[INFO] Event-store fleet: 3/3 shards healthy" in got[1]
        port_cluster.kill_shard(2)
        jres.reset_breakers()
        tres.reset_breakers()
        want = _status(jcli, jstorage)
        got = _status(tcli, tstorage)
        assert got == want
        assert got[0] == 1 and "unreachable" in got[2]
    finally:
        jstorage.reset()
        tstorage.reset()


# ---------------------------------------------------------------------------
# Online fold-in over the fleet
# ---------------------------------------------------------------------------


@pytest.fixture
def foldin_env(monkeypatch):
    """A fold-in deployment's environment: PIO_FOLDIN forces the device
    store the fold patches."""
    monkeypatch.setenv("PIO_FOLDIN", "1")


def _fold_setup(source_cfg):
    """A small model (its own factors, maps, seen lists) deployed on the
    CPU over ``source_cfg``'s event store, and a fold-in consumer tailing
    it from now on."""
    from predictionio_tpu_torch.ops.als import ALSParams
    from predictionio_tpu_torch.online.foldin import (
        FoldInConfig,
        FoldInConsumer,
    )
    from predictionio_tpu_torch.weights import als_model_from_numpy

    tstorage.reset(tstorage.StorageConfig(
        sources={"EV": source_cfg, "META": {"type": "memory"}},
        repositories={"EVENTDATA": "EV", "METADATA": "META",
                      "MODELDATA": "META"}))
    aid = tstorage.get_metadata_apps().insert(App(0, "foldapp"))
    le = tstorage.get_levents()
    le.init(aid)
    rng = np.random.default_rng(4)
    X = rng.normal(size=(12, 4)).astype(np.float32)
    Y = rng.normal(size=(20, 4)).astype(np.float32)
    model = als_model_from_numpy(
        X, Y, [f"u{i}" for i in range(12)], [f"i{i}" for i in range(20)],
        {u: [u % 20] for u in range(12)}, device="cpu")
    consumer = FoldInConsumer(
        model, FoldInConfig(app_name="foldapp", interval=0.0),
        ALSParams(rank=4, num_iterations=1, lambda_=0.1))
    consumer._scope = (aid, None)
    consumer._cursor = le.tail_cursor(aid, None)
    return model, consumer, le, aid


def _fold_events(users, base):
    return events("port", [dict(
        event="rate", entity_type="user", entity_id=u,
        target_entity_type="item", target_entity_id=f"i{(j * 7 + k) % 20}",
        properties={"rating": float(1 + (j + k) % 5)},
        event_time=t(base + 10 * j + k), event_id=f"f-{u}-{k}")
        for j, u in enumerate(users) for k in range(3)])


def _rows(model):
    srv = model.device_server()
    return {u: np.asarray(srv._X[model.user_map[u]].float())
            for u in model.user_map.labels}


def test_foldin_over_fleet_equals_single_store(port_cluster, tmp_path,
                                              foldin_env):
    users = ["n1", "n2", "u3", "n3", "u7", "n4"]
    try:
        single, c1, le1, aid1 = _fold_setup({"type": "memory"})
        le1.insert_batch(_fold_events(users, 100), aid1)
        c1._cycle()
        fleet, c2, le2, aid2 = _fold_setup(dict(
            {"type": "fleet"}, **port_cluster.cfg))
        le2.insert_batch(_fold_events(users, 100), aid2)
        c2._cycle()
        assert c2.stats()["newUsers"] == c1.stats()["newUsers"] == 4
        assert list(fleet.user_map.labels) == list(single.user_map.labels)
        want, got = _rows(single), _rows(fleet)
        for u in users + ["u0", "u11"]:
            np.testing.assert_allclose(got[u], want[u], rtol=1e-6,
                                       atol=1e-6)
    finally:
        tstorage.reset()


def test_fold_gather_reads_each_user_from_its_shard(port_cluster,
                                                   foldin_env):
    """A gather of more than 4 users over a fleet is one entity read of
    each user's owner shard, never a scan of every shard."""
    from predictionio_tpu_torch.data.storage.observed import unwrap

    users = ["n1", "n2", "u3", "n3", "u7", "n4"]
    try:
        model, consumer, le, aid = _fold_setup(dict(
            {"type": "fleet"}, **port_cluster.cfg))
        le.insert_batch(_fold_events(users, 100), aid)
        fleet = unwrap(le)
        legs = []
        for i, leg in enumerate(fleet._clients):
            real = leg.find

            def find(*args, _i=i, _real=real, **kw):
                legs.append((_i, kw.get("entity_id")))
                return _real(*args, **kw)
            leg.find = find
        consumer._cycle()
        assert consumer.stats()["newUsers"] == 4
        assert sorted(legs) == sorted(
            (fleet._shard_for_entity("user", u), u) for u in users)
    finally:
        tstorage.reset()


def test_dead_shard_delays_folds_never_drops(tmp_path, foldin_env):
    c = ShardCluster("port", "jsonlfs", tmp_path)
    try:
        model, consumer, le, aid = _fold_setup(dict({"type": "fleet"},
                                                    **c.cfg))
        fleet = tstorage.get_levents()
        dead = [u for u in (f"n{i}" for i in range(60))
                if fleet._shard_for_entity("user", u) == 1][:3]
        live = [u for u in (f"n{i}" for i in range(60))
                if fleet._shard_for_entity("user", u) == 0][:3]
        le.insert_batch(_fold_events(dead + live, 200), aid)
        c.kill_shard(1)
        consumer._cycle()
        st = consumer.stats()
        assert not st["stale"]  # a partial tail is not a stale one
        assert set(live) <= set(model.user_map.labels)
        assert not set(dead) & set(model.user_map.labels)
        c.restart_shard(1)
        tres.reset_breakers()
        consumer._cycle()
        assert set(dead) <= set(model.user_map.labels)
        assert consumer.stats()["newUsers"] == 6
    finally:
        tstorage.reset()
        c.close()
