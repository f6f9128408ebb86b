"""The port's ``jsonlfs`` event store against the JAX package's.

Every scenario runs the same operations on the port's ``JsonlFsLEvents``
and on the JAX package's, each in a directory of its own, and requires
equal results: the event scenarios of ``tests/test_torch_storage.py``
that apply to an events-only backend, then the cases of
``tests/test_jsonlfs.py`` and the JAX fold-in and snapshot tests that
concern this backend (partition rolling, torn tails, a second writer,
``delete_until``, the ``props_snapshot.json`` aggregate, the tail reads
and their replay after a rewrite) and its columnar scans. Generated event
ids differ between the packages, so scenarios report how ids relate, not
the ids. Last, a directory written by either package reads back equal in
the other, byte for byte where both write the same events.
"""

import datetime as dt
import importlib
import json
import os
import pathlib
import types

import pytest

from test_torch_storage import (  # the shared event scenarios
    SCENARIOS as STORAGE_SCENARIOS,
    comparable,
    ev_row,
    props,
)

UTC = dt.timezone.utc
APP = 1
PACKAGES = ("predictionio_tpu", "predictionio_tpu_torch")
EVENT_SCENARIOS = [s for s in STORAGE_SCENARIOS
                   if s.__name__ in {
                       "s_insert_get_delete", "s_insert_validates",
                       "s_find_time_range", "s_find_filters",
                       "s_find_limit_reversed", "s_channel_isolation",
                       "s_app_isolation_and_remove", "s_insert_batch",
                       "s_delete_until", "s_aggregate_properties",
                       "s_aggregate_write_through"}]


def t(i):
    return dt.datetime(2020, 1, 1, tzinfo=UTC) + dt.timedelta(seconds=i)


def package_ns(pkg: str, root, part_max: int = 500_000):
    """One package's event class, its ``jsonlfs`` module and a store of
    its own under ``root``."""
    mod = importlib.import_module(f"{pkg}.data.storage.jsonlfs")
    base = importlib.import_module(f"{pkg}.data.storage.base")
    cfg = {"path": str(root / pkg), "part_max_events": part_max}
    return types.SimpleNamespace(
        Event=importlib.import_module(f"{pkg}.data.event").Event,
        pkg=pkg, UNSET=base.UNSET, mod=mod, cfg=cfg,
        levents=mod.JsonlFsLEvents(cfg), pevents=mod.JsonlFsPEvents(cfg))


def rate(m, i, user, item, rating=None, at=None, **kw):
    return m.Event(event="rate", entity_type="user", entity_id=user,
                   target_entity_type="item", target_entity_id=item,
                   properties={} if rating is None else {"rating": rating},
                   event_time=t(i if at is None else at), **kw)


def seed_events(m, n=25):
    return [m.Event(event="view", entity_type="user", entity_id=f"u{i % 3}",
                    target_entity_type="item", target_entity_id=f"i{i % 7}",
                    event_time=t(i)) if i % 5 == 4
            else rate(m, i, f"u{i % 3}", f"i{i % 7}", float(1 + i % 5))
            for i in range(n)]


def parts(m):
    le = m.levents
    out = []
    for p in le._parts(le._dir(APP, None)):
        with open(p, encoding="utf-8") as f:
            out.append((os.path.basename(p), len(f.read().splitlines())))
    return out


def rows(events):
    return [ev_row(e) for e in events]


def id_positions(ids, events):
    """Where each delivered event sits in ``ids`` (-1 if it is not one)."""
    pos = {eid: j for j, eid in enumerate(ids)}
    return [pos.get(e.event_id, -1) for e in events]


# -- scenarios of this backend: each returns what it observed ---------------

def j_partitions_roll(m, root):
    m = package_ns(m.pkg, root, part_max=7)
    m.levents.init(APP)
    m.levents.insert_batch(seed_events(m), APP)
    return parts(m), len(list(m.levents.find(APP)))


def j_append_resumes_after_reopen(m, root):
    a = package_ns(m.pkg, root, part_max=3)
    a.levents.init(APP)
    a.levents.insert_batch(seed_events(a, 4), APP)
    b = package_ns(m.pkg, root, part_max=3)     # a new process's DAO
    b.levents.insert_batch(seed_events(b, 3), APP)
    return parts(b), rows(b.levents.find(APP))


def torn_store(m, root, n_good=4):
    m = package_ns(m.pkg, root, part_max=100)
    m.levents.init(APP)
    m.levents.insert_batch(seed_events(m, n_good), APP)
    part = m.levents._parts(m.levents._dir(APP, None))[-1]
    with open(part, "a", encoding="utf-8") as f:
        f.write('{"event":"rate","entityType":"user","entityId"')
    return m, part


def j_torn_tail(m, root):
    m, part = torn_store(m, root)
    readers = (len(list(m.levents.find(APP))),
               len(m.pevents.find_columnar(APP, value_property="rating")))
    fresh = package_ns(m.pkg, root, part_max=100)   # restart after a crash
    fresh.levents.insert_batch(seed_events(fresh, 3), APP)
    m.levents.insert_batch(seed_events(m, 2), APP)  # same instance
    with open(part, encoding="utf-8") as f:
        lines = f.read().splitlines()
    return (readers, len(list(fresh.levents.find(APP))),
            sum(ln.endswith('"entityId"') for ln in lines), len(lines))


def j_delete_until_drops_the_fragment(m, root):
    m, part = torn_store(m, root)
    m.levents._repair_tail(part)
    removed = m.levents.delete_until(APP, t(2))
    return removed, rows(m.levents.find(APP))


def j_second_writer(m, root):
    a = package_ns(m.pkg, root, part_max=3)
    b = package_ns(m.pkg, root, part_max=3)
    a.levents.init(APP)
    for _ in range(4):
        a.levents.insert_batch(seed_events(a, 2), APP)
        b.levents.insert_batch(seed_events(b, 2), APP)
    return parts(a), len(list(a.levents.find(APP)))


def j_delete_rewrites_a_partition(m, root):
    m = package_ns(m.pkg, root, part_max=4)
    m.levents.init(APP)
    ids = m.levents.insert_batch(seed_events(m, 10), APP)
    return (m.levents.delete(ids[5], APP), m.levents.delete(ids[5], APP),
            m.levents.get(ids[5], APP), parts(m),
            id_positions(ids, m.levents.find(APP)),
            m.levents.delete("x", 99))


def j_snapshot_aggregate(m, root):
    """The watermark snapshot: persisted, reloaded by a new instance,
    folded by delta, escaped ``$set`` lines, out-of-order entities, and
    dropped by a partition rewrite."""
    cfg_m = package_ns(m.pkg, root, part_max=5)
    le = cfg_m.levents
    le.init(APP)
    E = cfg_m.Event
    ids = [le.insert(E(event="$set", entity_type="user", entity_id=f"u{i % 3}",
                       properties={"k": i, f"p{i}": [i]}, event_time=t(i)),
                     APP) for i in range(8)]
    le.insert_batch(seed_events(cfg_m, 6), APP)
    snap = pathlib.Path(le._dir(APP, None)) / cfg_m.mod.SNAPSHOT_NAME
    first = props(le.aggregate_properties(APP, "user"))
    snap1 = json.loads(snap.read_text())
    fresh = package_ns(m.pkg, root, part_max=5).levents
    reloaded = props(fresh.aggregate_properties(APP, "user"))
    fresh.append_raw_lines(
        ['{"event":"\\u0024set","entityType":"user","entityId":"esc",'
         '"properties":{"a":1},"eventTime":"2020-01-01T00:01:00+00:00",'
         '"creationTime":"2020-01-01T00:01:00+00:00","eventId":"e1"}'], APP)
    fresh.insert(E(event="$unset", entity_type="user", entity_id="u1",
                   properties={"k": 0}, event_time=t(2)), APP)  # out of order
    delta = props(fresh.aggregate_properties(APP, "user"))
    replay = props(fresh.aggregate_properties_replay(APP, "user"))
    had = snap.exists()
    le.delete(ids[7], APP)                  # a partition rewrite
    dropped = not snap.exists()
    after = props(le.aggregate_properties(APP, "user"))
    return (first, reloaded, delta, delta == replay, had, dropped, after,
            props(le.aggregate_properties_replay(APP, "user")),
            sorted(snap1["watermark"].items()), snap1["states"])


def j_tail_reads(m, root):
    m = package_ns(m.pkg, root, part_max=4)
    le = m.levents
    le.init(APP)
    empty = (le.find_since(APP), le.tail_cursor(APP),
             le.tail_watermark(APP), le.find_since(APP, channel_id=3))
    first = le.insert_batch([rate(m, i, f"u{i}", f"i{i}", at=i)
                             for i in range(6)], APP)
    cur = le.tail_cursor(APP)
    second = le.insert_batch([rate(m, i, f"v{i}", f"j{i}", at=100 + i)
                              for i in range(7)], APP)
    got, cur2 = le.find_since(APP, cursor=cur)
    again, cur3 = le.find_since(APP, cursor=cur2)
    seen, c = [], None
    for _ in range(20):
        batch, c = le.find_since(APP, cursor=c, limit=2)
        if not batch:
            break
        seen += batch
    wm = le.tail_watermark(APP)
    ids = first + second
    return (empty, id_positions(ids, got), again, cur2 == cur3, cur3,
            id_positions(ids, seen), wm["lastEventId"] == ids[-1],
            wm["lastEventTime"], wm["cursor"] == cur3,
            le.find_since(APP, cursor=wm["cursor"])[0])


def j_tail_replays_after_a_rewrite(m, root):
    """A trim that frees the tail, then re-ingest past the old cursor:
    the stale cursor replays, never skips; the same after remove and
    re-init (the generation file outlives the directory)."""
    m = package_ns(m.pkg, root, part_max=4)
    le = m.levents
    le.init(APP)
    le.insert_batch([rate(m, 0, f"a{i}", "x", at=100 + i)
                     for i in range(4)], APP)
    le.insert_batch([rate(m, 0, f"b{i}", "x", at=i) for i in range(2)], APP)
    cur = le.tail_cursor(APP)
    removed = le.delete_until(APP, t(50))
    trimmed = le.insert_batch([rate(m, 0, f"c{i}", "x", at=200 + i)
                               for i in range(6)], APP)
    got, cur2 = le.find_since(APP, cursor=cur)
    le.remove(APP)
    le.init(APP)
    again = le.insert_batch([rate(m, 0, f"w{i}", "y", at=50 + i)
                             for i in range(7)], APP)
    replay, cur3 = le.find_since(APP, cursor=cur2)
    return (removed, id_positions(trimmed, got), cur2["gen"],
            id_positions(again, replay), cur3["gen"])


def j_columnar(m, root):
    """The columnar scans: filters, encoded blocks, strict values, a
    fallback line, prefetch, ``find_columnar``'s time order."""
    m = package_ns(m.pkg, root, part_max=7)
    m.levents.init(APP)
    m.levents.insert_batch(seed_events(m), APP)
    m.levents.insert(m.Event(event="$set", entity_type="user",
                             entity_id="u1", properties={"x": 1},
                             event_time=t(3)), APP)
    m.levents.append_raw_lines(
        ['{"event":"rate","entityType":"user","entityId":1.5,'
         '"targetEntityType":"item","targetEntityId":"i9",'
         '"properties":{"rating":4},'
         '"eventTime":"2020-01-01T00:00:09+00:00"}',
         '{"event":"rate","entityType":"user","entityId":"u9",'
         '"targetEntityType":"item","targetEntityId":"i9",'
         '"properties":{"rating":"five"},'
         '"eventTime":"2020-01-01T00:00:10+00:00"}'], APP)
    pe = m.pevents

    def flat(batch):
        return (batch.entity_ids.tolist(),
                [x for x in batch.target_ids.tolist()],
                batch.values.tolist(), batch.event_times.tolist(),
                None if batch.events is None else batch.events.tolist())

    def blocks(**kw):
        return [(b.is_encoded,) + flat(b.materialize())
                for b in pe.find_columnar_blocks(APP, **kw)]

    lenient = dict(value_property="rating", default_value=2.5, strict=False)
    out = [flat(pe.find_columnar(APP, **lenient)),
           flat(pe.find_columnar(APP, event_names=["rate"],
                                 entity_type="user",
                                 target_entity_type="item", **lenient)),
           flat(pe.find_columnar(APP, target_entity_type=None)),
           flat(pe.find_columnar(APP, start_time=t(5), until_time=t(10))),
           blocks(block_size=5, **lenient),
           blocks(block_size=3, prefetch=2, **lenient) == blocks(
               block_size=3, **lenient),
           blocks(event_names=["view"], block_size=100, prefetch=8)]
    try:
        pe.find_columnar(APP, value_property="rating")
    except ValueError as e:
        out.append(str(e).split(":")[-1])
    return out


BACKEND_SCENARIOS = [j_partitions_roll, j_append_resumes_after_reopen,
                     j_torn_tail, j_delete_until_drops_the_fragment,
                     j_second_writer, j_delete_rewrites_a_partition,
                     j_snapshot_aggregate, j_tail_reads,
                     j_tail_replays_after_a_rewrite, j_columnar]


@pytest.mark.parametrize("scenario", EVENT_SCENARIOS,
                         ids=lambda f: f.__name__[2:])
def test_event_scenarios_equal_the_jax_backend(tmp_path, scenario):
    jax_ns, port_ns = (package_ns(p, tmp_path) for p in PACKAGES)
    assert comparable(scenario(port_ns)) == comparable(scenario(jax_ns))


@pytest.mark.parametrize("scenario", BACKEND_SCENARIOS,
                         ids=lambda f: f.__name__[2:])
def test_backend_scenarios_equal_the_jax_backend(tmp_path, scenario):
    got, want = (comparable(scenario(types.SimpleNamespace(pkg=p),
                                     tmp_path / p))
                 for p in reversed(PACKAGES))
    assert got == want


# -- a directory written by one package, read by the other ------------------

def write_store(m):
    """The same events, with fixed ids and creation times, through every
    write path: ``insert_batch``, ``insert``, ``append_raw_lines``."""
    le = m.levents
    le.init(APP)
    le.init(APP, 5)
    created = dt.datetime(2021, 1, 1, tzinfo=UTC)
    evs = [rate(m, i, f"u{i % 4}", f"i{i % 6}", float(i % 5) + 0.5,
                event_id=f"e{i}", creation_time=created) for i in range(17)]
    evs += [m.Event(event="$set", entity_type="item", entity_id=f"i{i}",
                    properties={"categories": [f"c{i % 3}"]},
                    event_time=t(30 + i), event_id=f"s{i}",
                    creation_time=created) for i in range(6)]
    le.insert_batch(evs[:12], APP)
    for e in evs[12:]:
        le.insert(e, APP)
    le.insert_batch(evs[:3], APP, 5)
    le.append_raw_lines(
        ['{"event":"\\u0024set","entityType":"item","entityId":"i1",'
         '"properties":{"price":2},"eventTime":"2020-01-01T00:01:00Z",'
         '"eventId":"raw1"}'], APP)
    le.aggregate_properties(APP, "item")    # writes props_snapshot.json


def read_store(m):
    le, pe = m.levents, m.pevents
    batch = pe.find_columnar(APP, value_property="rating")
    return (rows(le.find(APP)), [e.event_id for e in le.find(APP)],
            rows(le.find(APP, channel_id=5)),
            props(le.aggregate_properties(APP, "item")),
            batch.entity_ids.tolist(), batch.target_ids.tolist(),
            batch.values.tolist(),
            [e.event_id for e in le.find_since(APP)[0]],
            le.tail_watermark(APP)["lastEventId"])


def tree_bytes(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(pathlib.Path(root).rglob("*"))
            if p.is_file() and p.name != ".lock"}


@pytest.mark.parametrize("writer", PACKAGES)
def test_a_store_reads_equal_in_the_other_package(tmp_path, writer):
    reader = PACKAGES[1 - PACKAGES.index(writer)]
    w = package_ns(writer, tmp_path, part_max=5)
    write_store(w)
    # the reader opens the writer's directory, snapshot included
    r = package_ns(reader, tmp_path, part_max=5)
    r.levents = r.mod.JsonlFsLEvents(w.cfg)
    r.pevents = r.mod.JsonlFsPEvents(w.cfg)
    got = read_store(r)
    assert comparable(got) == comparable(read_store(w))
    assert len(got[0]) == 24 and len(got[2]) == 3


def test_both_packages_write_the_same_bytes(tmp_path):
    for pkg in PACKAGES:
        write_store(package_ns(pkg, tmp_path, part_max=5))
    jax_tree = tree_bytes(tmp_path / PACKAGES[0])
    port_tree = tree_bytes(tmp_path / PACKAGES[1])
    assert sorted(jax_tree) == sorted(port_tree)
    assert "app_1_-1/props_snapshot.json" in port_tree
    assert "app_1_-1/part-00004.jsonl" in port_tree
    assert port_tree == jax_tree


def test_registry_binds_jsonlfs_for_events_only(tmp_path):
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.storage.base import App, StorageError
    from predictionio_tpu_torch.data.storage.jsonlfs import (
        JsonlFsLEvents,
        JsonlFsPEvents,
    )

    env = {"PIO_STORAGE_SOURCES_EV_TYPE": "jsonlfs",
           "PIO_STORAGE_SOURCES_EV_PATH": str(tmp_path / "events"),
           "PIO_STORAGE_SOURCES_EV_PART_MAX_EVENTS": "3",
           "PIO_STORAGE_SOURCES_META_TYPE": "memory",
           "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EV",
           "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "META",
           "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "EV"}
    registry = storage.StorageRegistry(storage.StorageConfig.from_env(env))
    le = registry.get_levents()
    assert isinstance(le, JsonlFsLEvents)
    assert isinstance(registry.get_pevents(), JsonlFsPEvents)
    assert registry.get_pevents()._l is not le   # its own reader DAO
    aid = registry.get_metadata_apps().insert(App(0, "app"))
    le.init(aid)
    from predictionio_tpu_torch.data.event import Event

    le.insert_batch([Event(event="view", entity_type="user",
                           entity_id=f"u{i}", event_time=t(i))
                     for i in range(7)], aid)
    assert len(os.listdir(tmp_path / "events" / f"app_{aid}_-1")) == 4
    with pytest.raises(StorageError, match="does not support Models"):
        registry.get_model_data_models()
