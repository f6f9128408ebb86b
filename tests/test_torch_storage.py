"""The port's storage against the JAX package's, backend by backend.

Every scenario runs the same operations on the port's backend and on
the JAX package's backend of the same type (``memory`` and ``sqlite``,
each on its own database) and requires equal results: the cases of
``tests/test_storage_conformance.py`` that apply to these two backends,
plus upserts and out-of-order ``$set`` events for the materialized
aggregate. Generated ids (event ids, access keys, instance ids) differ
between the packages, so scenarios report how ids relate, not the ids.
Then the port's own checks: the registry (``PIO_STORAGE_*`` parsing, the
types it refuses, ``localfs`` model blobs), the ``PEventStore`` /
``LEventStore`` facades, sqlite across threads and snapshot scans, and a
sqlite file written by one package and read by the other.
"""

import dataclasses
import datetime as dt
import importlib
import os
import threading
import types

import pytest

UTC = dt.timezone.utc
APP = 1
PACKAGES = ("predictionio_tpu", "predictionio_tpu_torch")


def t(i):
    return dt.datetime(2020, 1, 1, 0, 0, i, tzinfo=UTC)


def package_ns(pkg: str, backend: str, tmp_path) -> types.SimpleNamespace:
    """One package's event and record classes and a fresh set of DAOs of
    ``backend``."""
    ev = importlib.import_module(f"{pkg}.data.event")
    base = importlib.import_module(f"{pkg}.data.storage.base")
    if backend == "memory":
        mod = importlib.import_module(f"{pkg}.data.storage.memory")
        names = ("MemLEvents", "MemApps", "MemAccessKeys", "MemChannels",
                 "MemEngineInstances", "MemEvaluationInstances", "MemModels")
        cfg = {}
    else:
        mod = importlib.import_module(f"{pkg}.data.storage.sqlite")
        names = ("SqliteLEvents", "SqliteApps", "SqliteAccessKeys",
                 "SqliteChannels", "SqliteEngineInstances",
                 "SqliteEvaluationInstances", "SqliteModels")
        cfg = {"path": str(tmp_path / f"{pkg}.db")}
    daos = [getattr(mod, n)(cfg) for n in names]
    return types.SimpleNamespace(
        Event=ev.Event, EventValidationError=ev.EventValidationError,
        UNSET=base.UNSET, App=base.App, AccessKey=base.AccessKey,
        Channel=base.Channel, EngineInstance=base.EngineInstance,
        EvaluationInstance=base.EvaluationInstance, Model=base.Model,
        **dict(zip(("levents", "apps", "access_keys", "channels",
                    "engine_instances", "evaluation_instances", "models"),
                   daos)))


def mk(m, i, name="rate", etype="user", eid="u1", **kw):
    return m.Event(event=name, entity_type=etype, entity_id=eid,
                   event_time=t(i), **kw)


def ev_row(e):
    """An event without its generated id."""
    return (e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, dict(e.properties.fields), e.event_time,
            tuple(e.tags), e.pr_id)


def props(out):
    return {k: (dict(v.fields), v.first_updated, v.last_updated)
            for k, v in out.items()}


def outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the type is compared across the packages
        return ("raised", type(e).__name__)


# -- the scenarios: each returns what it observed --------------------------

def s_insert_get_delete(m):
    le = m.levents
    le.init(APP)
    eid = le.insert(mk(m, 1, properties={"rating": 5}), APP)
    got = le.get(eid, APP)
    return (ev_row(got), got.event_id == eid,
            got.properties.get("rating", int), le.delete(eid, APP),
            le.get(eid, APP), le.delete(eid, APP))


def s_insert_validates(m):
    m.levents.init(APP)
    return [outcome(lambda: m.levents.insert(mk(m, 1, name=name, **kw), APP))
            for name, kw in (("$bogus", {}), ("rate", {"properties":
                                                       {"pio_x": 1}}),
                             ("$set", {"target_entity_type": "item",
                                       "target_entity_id": "i1"}),
                             ("$unset", {}))] + [len(list(m.levents.find(APP)))]


def s_find_time_range(m):
    le = m.levents
    le.init(APP)
    for i in range(5):
        le.insert(mk(m, i), APP)
    return [ev_row(e) for e in le.find(APP, start_time=t(1),
                                       until_time=t(3))]


def s_find_filters(m):
    le = m.levents
    le.init(APP)
    le.insert(mk(m, 1, name="rate", eid="u1", target_entity_type="item",
                 target_entity_id="i1"), APP)
    le.insert(mk(m, 2, name="view", eid="u1", target_entity_type="item",
                 target_entity_id="i2"), APP)
    le.insert(mk(m, 3, name="rate", eid="u2"), APP)
    queries = [dict(event_names=["rate"]), dict(entity_id="u1"),
               dict(target_entity_id="i2"), dict(target_entity_type=None),
               dict(target_entity_type=m.UNSET), dict(entity_type="item"),
               dict(event_names=["rate", "view"], entity_id="u1")]
    return [[ev_row(e) for e in le.find(APP, **q)] for q in queries]


def s_find_limit_reversed(m):
    le = m.levents
    le.init(APP)
    for i in range(5):
        le.insert(mk(m, i), APP)
    return ([ev_row(e) for e in le.find(APP, limit=2)],
            [ev_row(e) for e in le.find(APP, limit=2, reversed=True)],
            [ev_row(e) for e in le.find(APP, limit=-1)])


def s_channel_isolation(m):
    le = m.levents
    le.init(APP)
    le.init(APP, 7)
    le.insert(mk(m, 1), APP)
    le.insert(mk(m, 2), APP, 7)
    return ([ev_row(e) for e in le.find(APP)],
            [ev_row(e) for e in le.find(APP, channel_id=7)])


def s_app_isolation_and_remove(m):
    le = m.levents
    le.init(1)
    le.init(2)
    le.insert(mk(m, 1), 1)
    le.insert(mk(m, 1), 2)
    le.remove(1)
    return len(list(le.find(1))), len(list(le.find(2)))


def s_insert_batch(m):
    le = m.levents
    le.init(APP)
    ids = le.insert_batch([mk(m, i) for i in range(3)], APP)
    return (len(ids), len(set(ids)), [ev_row(e) for e in le.find(APP)],
            ev_row(le.get(ids[0], APP)))


def s_delete_until(m):
    le = m.levents
    le.init(APP)
    le.init(APP, 0)
    le.insert_batch([mk(m, i) for i in range(6)], APP)
    le.insert(mk(m, 1), APP, 0)
    removed = le.delete_until(APP, t(3), None)
    rest = [ev_row(e) for e in le.find(APP)]
    other = len(list(le.find(APP, channel_id=0)))
    again = le.delete_until(APP, t(3), None)
    le.insert(mk(m, 9), APP)
    return removed, rest, other, again, len(list(le.find(APP)))


def s_aggregate_properties(m):
    le = m.levents
    le.init(APP)
    le.insert(m.Event(event="$set", entity_type="user", entity_id="u1",
                      properties={"a": 1, "b": 2}, event_time=t(1)), APP)
    le.insert(m.Event(event="$unset", entity_type="user", entity_id="u1",
                      properties={"b": 0}, event_time=t(2)), APP)
    le.insert(m.Event(event="$set", entity_type="item", entity_id="i1",
                      properties={"c": 3}, event_time=t(1)), APP)
    return (props(le.aggregate_properties(APP, "user")),
            props(le.aggregate_properties(APP, "user",
                                          required=["missing"])),
            props(le.aggregate_properties(APP, "item", until_time=t(1))),
            props(le.aggregate_properties(APP, "item")))


def s_aggregate_write_through(m):
    """The materialized aggregate, kept write-through after the first
    unbounded read: later, out-of-order, upserted and deleted special
    events, against the replay fold."""
    le = m.levents
    le.init(APP)
    le.insert(m.Event(event="$set", entity_type="item", entity_id="i1",
                      properties={"categories": ["a"]}, event_time=t(5)),
              APP)
    first = props(le.aggregate_properties(APP, "item"))
    le.insert(m.Event(event="$set", entity_type="item", entity_id="i1",
                      properties={"categories": ["b"], "x": 1},
                      event_time=t(3)), APP)          # out of order
    eid = le.insert(m.Event(event="$set", entity_type="item",
                            entity_id="i2", properties={"y": 2},
                            event_time=t(6)), APP)
    le.insert(m.Event(event="$set", entity_type="item", entity_id="i2",
                      properties={"y": 3}, event_time=t(7),
                      event_id=eid), APP)             # upsert by id
    gone = le.insert(m.Event(event="$delete", entity_type="item",
                             entity_id="i1", event_time=t(8)), APP)
    mid = props(le.aggregate_properties(APP, "item"))
    le.delete(gone, APP)
    last = props(le.aggregate_properties(APP, "item"))
    replay = props(le.aggregate_properties_replay(APP, "item"))
    return first, mid, last, replay, last == replay


def s_apps(m):
    apps = m.apps
    aid = apps.insert(m.App(0, "myapp", "desc"))
    return (aid == 1, apps.get(aid), apps.get_by_name("myapp"),
            apps.insert(m.App(0, "myapp")),
            apps.update(m.App(aid, "renamed", None)),
            apps.get_by_name("renamed"), apps.get_all(),
            apps.update(m.App(99, "x")), apps.delete(aid), apps.get(aid),
            apps.delete(aid))


def s_apps_explicit_id_conflict(m):
    apps = m.apps
    return (apps.insert(m.App(5, "one")), apps.insert(m.App(5, "two")),
            apps.get_by_name("two"), apps.insert(m.App(0, "three")))


def s_channels_explicit_id(m):
    ch = m.channels
    return (ch.insert(m.Channel(9, "mobile", 12)), ch.get(9),
            ch.insert(m.Channel(9, "web", 12)))


def s_access_keys(m):
    ak = m.access_keys
    key = ak.insert(m.AccessKey("", 12, ("rate",)))
    got = ak.get(key)
    mine = ak.insert(m.AccessKey("fixed-key", 13, ()))
    return (len(key) >= 48, got.appid, got.events,
            [k.key == key for k in ak.get_by_appid(12)], mine,
            ak.update(m.AccessKey(key, 12, ())), ak.get(key).events,
            sorted(k.appid for k in ak.get_all()), ak.delete(key),
            ak.get(key), ak.update(m.AccessKey("nope", 1, ())))


def s_channels(m):
    ch = m.channels
    cid = ch.insert(m.Channel(0, "mobile", 12))
    return (cid, ch.get(cid), ch.insert(m.Channel(0, "bad name!", 12)),
            ch.insert(m.Channel(0, "x" * 17, 12)), ch.get_by_appid(12),
            ch.delete(cid), ch.get(cid))


def s_engine_instances(m):
    ei = m.engine_instances
    base = m.EngineInstance(
        id="", status="INIT", start_time=t(1), end_time=t(1),
        engine_id="e", engine_version="1", engine_variant="default.json",
        engine_factory="f", env={"PIO_X": "1"},
        algorithms_params='[{"name": "als"}]')
    iid = ei.insert(base)
    status0 = ei.get(iid).status
    ei.update(dataclasses.replace(ei.get(iid), status="COMPLETED",
                                  end_time=t(2)))
    iid2 = ei.insert(dataclasses.replace(base, start_time=t(5)))
    ei.update(dataclasses.replace(ei.get(iid2), status="COMPLETED"))
    latest = ei.get_latest_completed("e", "1", "default.json")
    completed = ei.get_completed("e", "1", "default.json")

    def strip(i):
        return dataclasses.replace(i, id="")

    return (status0, latest.id == iid2, strip(latest),
            [c.id == x for c, x in zip(completed, (iid2, iid))],
            [strip(c) for c in completed],
            ei.get_latest_completed("e", "2", "default.json"),
            ei.delete(iid), ei.get(iid), len(ei.get_all()))


def s_evaluation_instances(m):
    evi = m.evaluation_instances
    iid = evi.insert(m.EvaluationInstance(
        id="", status="INIT", start_time=t(1), end_time=t(1)))
    evi.update(dataclasses.replace(
        evi.get(iid), status="EVALCOMPLETED", evaluator_results="ok"))
    done = evi.get_completed()
    return ([dataclasses.replace(d, id="") for d in done],
            evi.delete(iid), evi.get(iid))


def s_models(m):
    md = m.models
    md.insert(m.Model("m1", b"\x00\x01bytes"))
    first = md.get("m1").models
    md.insert(m.Model("m1", b"v2"))
    return (first, md.get("m1").models, md.delete("m1"), md.get("m1"),
            md.delete("m1"))


SCENARIOS = [s_insert_get_delete, s_insert_validates, s_find_time_range,
             s_find_filters, s_find_limit_reversed, s_channel_isolation,
             s_app_isolation_and_remove, s_insert_batch, s_delete_until,
             s_aggregate_properties, s_aggregate_write_through, s_apps,
             s_apps_explicit_id_conflict, s_channels_explicit_id,
             s_access_keys, s_channels, s_engine_instances,
             s_evaluation_instances, s_models]


def comparable(x):
    """Records of either package as plain tuples, so the two packages'
    (distinct) dataclasses compare by value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            comparable(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return type(x)(comparable(v) for v in x)
    if isinstance(x, dict):
        return {k: comparable(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[2:])
def test_same_results_as_the_jax_backend(tmp_path, backend, scenario):
    jax_ns, port_ns = (package_ns(p, backend, tmp_path) for p in PACKAGES)
    want = comparable(scenario(jax_ns))
    got = comparable(scenario(port_ns))
    assert got == want
    assert type(port_ns.levents).__module__.startswith(
        "predictionio_tpu_torch.")


# -- the port's own checks ----------------------------------------------------

@pytest.fixture
def port_storage(monkeypatch):
    from predictionio_tpu_torch.data import storage

    for key in list(os.environ):
        if key.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("PIO_STORAGE_SOURCES_MEM_TYPE", "memory")
    storage.reset()
    yield storage
    storage.reset()


def test_env_config_parsing_matches_the_jax_registry():
    from predictionio_tpu.data.storage import StorageConfig as JaxConfig
    from predictionio_tpu_torch.data.storage import StorageConfig

    env = {
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
        "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQL_PATH": "/tmp/x.db",
        "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_FS_PATH": "/tmp/models",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "FS",
    }
    got, want = StorageConfig.from_env(env), JaxConfig.from_env(env)
    assert got.sources == want.sources
    assert got.repositories == want.repositories
    only = StorageConfig.from_env({"PIO_STORAGE_SOURCES_ONLY_TYPE": "memory"})
    assert set(only.repositories.values()) == {"ONLY"}


@pytest.mark.parametrize("env, error, match", [
    ({"PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
      "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
      "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQL",
      "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM"},
     "StorageError", "MODELDATA"),
    ({"PIO_STORAGE_SOURCES_X_TYPE": "hbase9"}, "StorageError", "hbase9"),
    ({"PIO_STORAGE_SOURCES_X_TYPE": "memory",
      "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "Y"},
     "StorageError", "undefined source"),
    ({"PIO_STORAGE_SOURCES_J_TYPE": "jsonlfs",
      "PIO_STORAGE_SOURCES_SQL_TYPE": "sqlite",
      "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "J",
      "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "J",
      "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "SQL"},
     "StorageError", "does not support Apps"),
    ({"PIO_STORAGE_SOURCES_R_TYPE": "resthttp"}, "NotImplementedError",
     "queue A item 2"),
    ({"PIO_STORAGE_SOURCES_F_TYPE": "fleet"}, "NotImplementedError",
     "queue A item 2"),
])
def test_registry_refuses(env, error, match):
    """The parser refuses each bad config; a ``jsonlfs`` source (events
    only) bound to METADATA parses, and its metadata DAO refuses, as in
    the JAX registry."""
    from predictionio_tpu_torch.data.storage import (
        StorageConfig,
        StorageRegistry,
    )
    from predictionio_tpu_torch.data.storage.base import StorageError

    errors = {"StorageError": StorageError,
              "NotImplementedError": NotImplementedError}
    with pytest.raises(errors[error], match=match):
        StorageRegistry(StorageConfig.from_env(env)).get_metadata_apps()


def test_localfs_models_and_registry_binding(tmp_path, monkeypatch,
                                             port_storage):
    from predictionio_tpu.data.storage.localfs import (
        LocalFSModels as JaxLocalFS,
    )
    from predictionio_tpu_torch.data.storage.base import Model, StorageError
    from predictionio_tpu_torch.data.storage.localfs import LocalFSModels

    m = LocalFSModels({"path": str(tmp_path / "models")})
    m.insert(Model("m1", b"v1"))
    m.insert(Model("m1", b"v2"))
    m.insert(Model("../../evil", b"x"))
    assert m.get("m1").models == b"v2"
    assert not (tmp_path / "evil").exists()
    # one directory, one layout: the JAX store reads the port's blobs
    jm = JaxLocalFS({"path": str(tmp_path / "models")})
    assert jm.get("m1").models == b"v2"
    assert jm.get("../../evil").models == b"x"
    assert m.delete("m1") and not m.delete("m1") and m.get("m1") is None

    monkeypatch.setenv("PIO_STORAGE_SOURCES_FS_TYPE", "localfs")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_FS_PATH", str(tmp_path / "fs"))
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEM")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "MEM")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE", "FS")
    port_storage.reset()
    models = port_storage.get_model_data_models()
    models.insert(Model("mm", b"blob"))
    assert list((tmp_path / "fs").glob("pio_model_mm_*"))
    assert models.get("mm").models == b"blob"
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "FS")
    port_storage.reset()
    with pytest.raises(StorageError, match="does not support"):
        port_storage.get_levents()


def test_verify_all_data_objects_and_facades(port_storage):
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.store import (
        LEventStore,
        LEventStoreTimeoutError,
        PEventStore,
        app_name_to_id,
    )

    port_storage.verify_all_data_objects()
    aid = port_storage.get_metadata_apps().insert(App(0, "fapp"))
    assert app_name_to_id("fapp") == (aid, None)
    with pytest.raises(ValueError):
        app_name_to_id("nope")
    with pytest.raises(ValueError, match="Channel"):
        app_name_to_id("fapp", "web")
    le = port_storage.get_levents()
    le.init(aid)
    le.insert(Event(event="rate", entity_type="user", entity_id="u9",
                    target_entity_type="item", target_entity_id="i1",
                    properties={"rating": 3}, event_time=t(1)), aid)
    le.insert(Event(event="$set", entity_type="user", entity_id="u9",
                    properties={"vip": True}, event_time=t(2)), aid)
    assert len(PEventStore.find("fapp", event_names=["rate"])) == 1
    assert PEventStore.aggregate_properties("fapp", "user")["u9"].get(
        "vip", bool) is True
    batch = PEventStore.find_columnar("fapp", event_names=["rate"],
                                      value_property="rating")
    assert list(batch.target_ids) == ["i1"] and list(batch.values) == [3.0]
    assert len(LEventStore.find_by_entity("fapp", "user", "u9",
                                          limit=1)) == 1
    assert len(LEventStore.find("fapp", entity_id="u9", timeout=30)) == 2
    gate = threading.Event()
    with pytest.raises(LEventStoreTimeoutError):
        from predictionio_tpu_torch.data import store

        store._bounded(lambda: gate.wait(5), timeout=0.05)
    gate.set()


@pytest.mark.parametrize("kind", ["memory", "sqlite_file", "sqlite_memory"])
def test_scan_is_a_snapshot(tmp_path, kind):
    """Writing while a find() iterates changes neither the rows it
    yields nor its progress."""
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.memory import MemLEvents
    from predictionio_tpu_torch.data.storage.sqlite import (
        SqliteClient,
        SqliteLEvents,
    )

    if kind == "memory":
        le = MemLEvents({})
    elif kind == "sqlite_file":
        le = SqliteLEvents({"path": str(tmp_path / "snap.db")})
    else:
        SqliteClient.shutdown_all()
        le = SqliteLEvents({})
    le.init(APP)
    for i in range(20):
        le.insert(Event(event="rate", entity_type="user", entity_id=f"u{i}",
                        event_time=t(i)), APP)
    seen = []
    for ev in le.find(APP):
        seen.append(ev.entity_id)
        le.insert(Event(event="rate", entity_type="user",
                        entity_id=f"new{len(seen)}",
                        event_time=t(40) + dt.timedelta(seconds=len(seen))),
                  APP)
    assert seen == [f"u{i}" for i in range(20)]
    assert len(list(le.find(APP))) == 40
    if kind != "memory":
        SqliteClient.shutdown_all()


@pytest.mark.parametrize("path", ["file", ":memory:"])
def test_sqlite_threads_share_one_database(tmp_path, path):
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.storage.sqlite import (
        SqliteApps,
        SqliteClient,
        SqliteLEvents,
    )

    SqliteClient.shutdown_all()
    cfg = {"path": str(tmp_path / "threads.db")} if path == "file" else {}
    le, apps = SqliteLEvents(cfg), SqliteApps(cfg)
    le.init(APP)

    def worker(i):
        le.insert(Event(event="rate", entity_type="user", entity_id=f"u{i}",
                        event_time=t(i)), APP)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(list(le.find(APP))) == 8
    aid = apps.insert(App(0, "alive"))
    le.close()  # a no-op at DAO level: the sibling DAO keeps working
    assert apps.get(aid).name == "alive"
    SqliteClient.shutdown_all()


@pytest.mark.parametrize("writer", PACKAGES)
def test_a_sqlite_store_reads_in_the_other_package(tmp_path, writer):
    """One schema: events, their aggregate, apps and instances written by
    either package read back equal in the other."""
    reader = PACKAGES[1 - PACKAGES.index(writer)]
    w = package_ns(writer, "sqlite", tmp_path)
    r = package_ns(reader, "sqlite", tmp_path)
    r.levents = importlib.import_module(
        f"{reader}.data.storage.sqlite").SqliteLEvents(
        {"path": str(tmp_path / f"{writer}.db")})
    r.apps = importlib.import_module(
        f"{reader}.data.storage.sqlite").SqliteApps(
        {"path": str(tmp_path / f"{writer}.db")})
    w.levents.init(APP)
    s_find_filters(w)
    w.levents.insert(w.Event(event="$set", entity_type="user",
                             entity_id="u1", properties={"a": [1, 2]},
                             event_time=t(4)), APP)
    aid = w.apps.insert(w.App(0, "shared", "d"))

    def scans(m):
        return [[ev_row(e) for e in m.levents.find(APP, **q)] for q in (
            dict(event_names=["rate"]), dict(entity_id="u1"),
            dict(target_entity_type=None), dict(target_entity_type=m.UNSET),
            dict(start_time=t(2)))]

    written = scans(w)
    assert sum(map(len, written)) == 14
    assert scans(r) == written
    assert props(r.levents.aggregate_properties(APP, "user")) == props(
        w.levents.aggregate_properties(APP, "user"))
    assert comparable(r.apps.get(aid)) == comparable(w.apps.get(aid))
