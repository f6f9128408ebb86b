"""The port's event server against the JAX package's, on the CPU.

One request sequence goes to the JAX package's ``EventServer`` and to
the port's, each over a sqlite store of its own in ``tmp_path``, bound
to port 0. Every response must be equal in status and body once event
ids (each server's n-th new id becomes ``<id n>``) and the times a
server stamps itself (``creationTime``, the stats windows) are
normalised. The sequence covers single and batch posts (a batch of 51,
per-item 400 / 403), ``Missing`` / ``Invalid accessKey``, Basic auth, a
bad channel, ``GET /events.json`` filters and limits, single-event get
and delete, the ``segmentio`` and ``mailchimp`` webhooks,
``/plugins.json``, ``/stats.json`` (with ``--stats`` and without), and
the ``/storage/*`` wire with and without a service key, with every 400
of a malformed ``appId``, ``channelId``, ``untilTime`` or ``limit``, and
a retried byte-identical append answered from the dedup cache. The
sqlite file the port's server wrote then reads back equal through both
packages' ``find``.

The sqlite and memory backends' tail reads (``find_since``,
``tail_cursor``, ``tail_watermark``) must equal the JAX package's over
inserts, deletes, limits, a scope removal and a re-ingest.
"""

import base64
import datetime as dt
import http.client
import json
import urllib.parse

import pytest

from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.data.api import EventServer as JEventServer
from predictionio_tpu.data.api import EventServerConfig as JConfig
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.data.storage import base as jbase
from predictionio_tpu.data.storage.memory import MemLEvents as JMem
from predictionio_tpu.data.storage.sqlite import SqliteLEvents as JSqlite
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data.api import EventServer as TEventServer
from predictionio_tpu_torch.data.api import EventServerConfig as TConfig
from predictionio_tpu_torch.data.event import Event as TEvent
from predictionio_tpu_torch.data.storage import base as tbase
from predictionio_tpu_torch.data.storage.memory import MemLEvents as TMem
from predictionio_tpu_torch.data.storage.sqlite import (
    SqliteLEvents as TSqlite,
)

APP_ID, KEY, RATE_ONLY, SERVICE_KEY = 7, "key-all", "key-rate", "sk-1"
UTC = dt.timezone.utc

PACKAGES = {
    "jax": (jstorage, jbase, JEventServer, JConfig),
    "port": (tstorage, tbase, TEventServer, TConfig),
}


def registry(pkg, path):
    st, base, _, _ = PACKAGES[pkg]
    reg = st.StorageRegistry(st.StorageConfig(
        sources={"S": {"type": "sqlite", "path": str(path)}},
        repositories={r: "S" for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}))
    reg.get_metadata_apps().insert(base.App(APP_ID, "shop"))
    keys = reg.get_metadata_access_keys()
    keys.insert(base.AccessKey(KEY, APP_ID, ()))
    keys.insert(base.AccessKey(RATE_ONLY, APP_ID, ("rate",)))
    reg.get_metadata_channels().insert(base.Channel(0, "mobile", APP_ID))
    reg.get_levents().init(APP_ID)
    return reg


@pytest.fixture
def servers(tmp_path):
    """Two pairs of servers: (stats, service key) and (neither)."""
    pairs = {}
    for kind, stats, sk in (("full", True, SERVICE_KEY),
                            ("bare", False, None)):
        pair = {}
        for pkg in PACKAGES:
            reg = registry(pkg, tmp_path / f"{pkg}-{kind}.db")
            _, _, Server, Config = PACKAGES[pkg]
            pair[pkg] = Server(Config(ip="127.0.0.1", port=0, stats=stats,
                                      service_key=sk), reg=reg).start()
        pairs[kind] = pair
    yield pairs
    for pair in pairs.values():
        for srv in pair.values():
            srv.stop()


def call(srv, method, path, params=None, body=None, headers=None):
    """(status, parsed body): JSON, or a list of JSON lines for the
    JSONL stream."""
    host, port = srv.address
    conn = http.client.HTTPConnection(host, port, timeout=30)
    if params:
        path += "?" + urllib.parse.urlencode(params, doseq=True)
    if body is not None and not isinstance(body, (bytes, str)):
        body = json.dumps(body)
    conn.request(method, path, body=body, headers=dict(headers or {}))
    resp = conn.getresponse()
    raw = resp.read().decode("utf-8")
    conn.close()
    if resp.getheader("Content-Type", "").startswith(
            "application/x-jsonlines"):
        return resp.status, [json.loads(ln) for ln in raw.splitlines()
                             if ln.strip()]
    return resp.status, json.loads(raw)


class Normaliser:
    """Maps each server's event ids, in order of first appearance, to
    ``<id n>``, and the times a server stamps itself to ``<time>``."""

    STAMPED = ("creationTime", "startTime", "endTime", "lastEventTime")

    def __init__(self):
        self.ids = {}

    def token(self, eid):
        return self.ids.setdefault(eid, f"<id {len(self.ids)}>")

    def __call__(self, obj, key=None):
        if isinstance(obj, dict):
            return {k: self(v, k) for k, v in obj.items()
                    if k != "metrics"}
        if isinstance(obj, list):
            return [self(v) for v in obj]
        if key in ("eventId", "lastEventId") and obj is not None:
            return self.token(obj)
        if key in self.STAMPED and obj is not None:
            return "<time>"
        return obj


RATE = {"event": "rate", "entityType": "user", "entityId": "u1",
        "targetEntityType": "item", "targetEntityId": "i1",
        "properties": {"rating": 4.5},
        "eventTime": "2024-01-02T03:04:05.000Z"}


def ev(n, **over):
    return {**RATE, "entityId": f"u{n}", "targetEntityId": f"i{n % 3}",
            "eventTime": f"2024-01-02T03:04:{n % 60:02d}.000Z", **over}


def basic(key):
    return {"Authorization": "Basic "
            + base64.b64encode(f"{key}:".encode()).decode()}


K = {"accessKey": KEY}
S = {"serviceKey": SERVICE_KEY, "appId": str(APP_ID)}
SEGMENT = {"version": "2", "type": "track", "event": "Played",
           "userId": "seg-1", "timestamp": "2024-01-03T00:00:00.000Z",
           "properties": {"song": "x"}, "context": {"ip": "1.2.3.4"}}
MAILCHIMP = urllib.parse.urlencode({
    "type": "subscribe", "fired_at": "2024-01-04 05:06:07",
    "data[id]": "mc-1", "data[list_id]": "list-1",
    "data[email]": "a@b.c", "data[email_type]": "html",
    "data[merges][EMAIL]": "a@b.c", "data[merges][FNAME]": "A",
    "data[merges][LNAME]": "B", "data[ip_opt]": "1.1.1.1",
    "data[ip_signup]": "2.2.2.2"})
APPEND = "\n".join(json.dumps(ev(40 + j, eventId=f"wire-{j}"))
                   for j in range(3)) + "\n"

# (server kind, method, path, params, body, headers); "{id0}" in a path
# is the first event id that server returned
SEQUENCE = [
    ("full", "GET", "/", None, None, None),
    ("full", "POST", "/events.json", None, RATE, None),
    ("full", "POST", "/events.json", {"accessKey": "nope"}, RATE, None),
    ("full", "POST", "/events.json", K, RATE, None),
    ("full", "POST", "/events.json", None, ev(2), basic(KEY)),
    ("full", "POST", "/events.json", None, ev(3), basic("nope")),
    ("full", "POST", "/events.json", {**K, "channel": "tv"}, ev(4), None),
    ("full", "POST", "/events.json", {**K, "channel": "mobile"}, ev(5),
     None),
    ("full", "POST", "/events.json", K, "{not json", None),
    ("full", "POST", "/events.json", K, ev(6, event="$bogus"), None),
    ("full", "POST", "/events.json", K, ev(7, entityId=""), None),
    ("full", "POST", "/events.json", {"accessKey": RATE_ONLY},
     ev(8, event="view"), None),
    ("full", "POST", "/batch/events.json", {"accessKey": RATE_ONLY},
     [ev(9), ev(10, event="view"), ev(11, entityType=""), "x", ev(12)],
     None),
    ("full", "POST", "/batch/events.json", K,
     [ev(13 + j) for j in range(51)], None),
    ("full", "POST", "/batch/events.json", K, {"not": "a list"}, None),
    ("full", "POST", "/batch/events.json", K,
     [ev(20 + j, event="buy" if j % 2 else "rate") for j in range(6)],
     None),
    ("full", "GET", "/events.json", K, None, None),
    ("full", "GET", "/events.json", {**K, "limit": "2"}, None, None),
    ("full", "GET", "/events.json", {**K, "limit": "-1", "event": "buy"},
     None, None),
    ("full", "GET", "/events.json",
     {**K, "entityType": "user", "entityId": "u21", "reversed": "true"},
     None, None),
    ("full", "GET", "/events.json", {**K, "reversed": "true"}, None, None),
    ("full", "GET", "/events.json",
     {**K, "startTime": "2024-01-02T03:04:21.000Z",
      "untilTime": "2024-01-02T03:04:24.000Z"}, None, None),
    ("full", "GET", "/events.json",
     {**K, "targetEntityType": "item", "targetEntityId": "i2"}, None,
     None),
    ("full", "GET", "/events.json", {**K, "limit": "many"}, None, None),
    ("full", "GET", "/events.json", {**K, "startTime": "yesterday"}, None,
     None),
    ("full", "GET", "/events.json", {**K, "entityId": "nobody"}, None,
     None),
    ("full", "GET", "/events.json", {**K, "channel": "mobile"}, None, None),
    ("full", "GET", "/events/{id0}.json", K, None, None),
    ("full", "DELETE", "/events/{id0}.json", K, None, None),
    ("full", "DELETE", "/events/{id0}.json", K, None, None),
    ("full", "GET", "/events/{id0}.json", K, None, None),
    ("full", "POST", "/webhooks/segmentio.json", K, SEGMENT, None),
    ("full", "POST", "/webhooks/segmentio.json", K,
     {k: v for k, v in SEGMENT.items() if k != "version"}, None),
    ("full", "GET", "/webhooks/segmentio.json", K, None, None),
    ("full", "POST", "/webhooks/mailchimp.form", K, MAILCHIMP,
     {"Content-Type": "application/x-www-form-urlencoded"}),
    ("full", "POST", "/webhooks/mailchimp.form", K, "type=subscribe",
     {"Content-Type": "application/x-www-form-urlencoded"}),
    ("full", "GET", "/webhooks/mailchimp.form", K, None, None),
    ("full", "GET", "/webhooks/nosuch.json", K, None, None),
    ("full", "GET", "/plugins.json", None, None, None),
    ("full", "GET", "/plugins/inputblocker/none", K, None, None),
    ("full", "GET", "/stats.json", K, None, None),
    ("full", "GET", "/healthz", None, None, None),
    ("full", "GET", "/nowhere", K, None, None),
    # the storage wire
    ("full", "POST", "/storage/init.json", {"appId": "7"}, None, None),
    ("full", "POST", "/storage/init.json",
     {"appId": "7", "serviceKey": "wrong"}, None, None),
    ("full", "POST", "/storage/init.json", {"serviceKey": SERVICE_KEY},
     None, None),
    ("full", "POST", "/storage/init.json", {**S, "appId": "seven"}, None,
     None),
    ("full", "POST", "/storage/init.json", {**S, "channelId": "x"}, None,
     None),
    ("full", "POST", "/storage/init.json", {**S, "channelId": "1"}, None,
     None),
    ("full", "POST", "/storage/events.jsonl", S, APPEND, None),
    ("full", "POST", "/storage/events.jsonl", S, APPEND,
     {"X-Idempotency-Retry": "1"}),
    ("full", "GET", "/storage/events.jsonl", S, None, None),
    ("full", "GET", "/storage/events.jsonl",
     {**S, "entityId": "u41", "targetEntityTypeNull": "false"}, None,
     None),
    ("full", "GET", "/storage/events.jsonl", {**S, "limit": "abc"}, None,
     None),
    ("full", "GET", "/storage/events.jsonl", {**S, "untilTime": "soon"},
     None, None),
    ("full", "GET", "/storage/events/wire-1.json", S, None, None),
    ("full", "GET", "/storage/events/absent.json", S, None, None),
    ("full", "GET", "/storage/aggregate.json", S, None, None),
    ("full", "GET", "/storage/aggregate.json", {**S, "entityType": "user"},
     None, None),
    ("full", "GET", "/storage/tail.json", {**S, "watermark": "true"}, None,
     None),
    ("full", "GET", "/storage/tail.json", {**S, "position": "end"}, None,
     None),
    ("full", "GET", "/storage/tail.json", {**S, "limit": "3"}, None, None),
    ("full", "GET", "/storage/tail.json", {**S, "limit": "x"}, None, None),
    ("full", "GET", "/storage/tail.json", {**S, "cursor": "[1]"}, None,
     None),
    ("full", "POST", "/storage/tail.json", S, {"cursor": 5}, None),
    ("full", "POST", "/storage/tail.json", S,
     {"cursor": {"kind": "sqlite", "rowid": 2}, "limit": 2}, None),
    ("full", "DELETE", "/storage/events/wire-2.json", S, None, None),
    ("full", "POST", "/storage/delete_until.json", S, None, None),
    ("full", "POST", "/storage/delete_until.json",
     {**S, "untilTime": "never"}, None, None),
    ("full", "POST", "/storage/delete_until.json",
     {**S, "untilTime": "2024-01-02T03:04:22.000Z"}, None, None),
    ("full", "GET", "/storage/events.jsonl", S, None, None),
    ("full", "POST", "/storage/remove.json", {**S, "channelId": "1"}, None,
     None),
    ("full", "GET", "/storage/nothing", S, None, None),
    ("full", "GET", "/stats.json", K, None, None),
    # the server with neither --stats nor a service key
    ("bare", "GET", "/stats.json", K, None, None),
    ("bare", "POST", "/storage/init.json", S, None, None),
    ("bare", "POST", "/events.json", K, RATE, None),
]


def run_sequence(pair):
    """Each request of SEQUENCE against both packages' servers; the
    normalised (status, body) pairs per package."""
    out = {pkg: [] for pkg in PACKAGES}
    norm = {pkg: Normaliser() for pkg in PACKAGES}
    first_id = {}
    for kind, method, path, params, body, headers in SEQUENCE:
        for pkg in PACKAGES:
            srv = pair[kind][pkg]
            p = path.replace("{id0}", first_id.get(pkg, "none"))
            status, payload = call(srv, method, p, params, body, headers)
            if status == 201 and pkg not in first_id:
                first_id[pkg] = payload["eventId"]
            out[pkg].append((method, path, status, norm[pkg](payload)))
    return out


def test_same_responses_as_the_jax_event_server(servers):
    got = run_sequence(servers)
    for j, (want, have) in enumerate(zip(got["jax"], got["port"])):
        assert have == want, (j, SEQUENCE[j][:3])
    statuses = {s for _, _, s, _ in got["port"]}
    assert {200, 201, 400, 401, 403, 404} <= statuses
    # the retried append was answered from the dedup cache, not stored
    # twice, and the batch of 51 was refused
    stream = [r for r in got["port"] if r[1] == "/storage/events.jsonl"]
    assert stream[1][3] == {"count": 3}
    assert any(r[2] == 400 and "less than or equal to 50" in
               r[3].get("message", "") for r in got["port"]
               if isinstance(r[3], dict))


def test_the_port_server_counts_ingest_per_event(servers):
    from predictionio_tpu_torch.utils import metrics as tmetrics

    srv = servers["full"]["port"]
    fam = "pio_ingest_events_total"
    # the family appears with its first sample: empty when this test
    # runs before any other has posted an event
    before = {tuple(sorted(s["labels"].items())): s["value"]
              for s in tmetrics.registry().snapshot()
              .get(fam, {"series": []})["series"]}
    assert call(srv, "POST", "/batch/events.json", K,
                [ev(1), ev(2, event="view")])[0] == 200
    after = {tuple(sorted(s["labels"].items())): s["value"]
             for s in tmetrics.registry().snapshot()[fam]["series"]}
    grown = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    assert grown == {
        (("app_id", "7"), ("event", "rate"), ("status", "201")): 1,
        (("app_id", "7"), ("event", "view"), ("status", "201")): 1}
    assert srv._event_label._cap == 100


def _read_all(LEvents, path, channel_id=None):
    le = LEvents({"path": str(path)})
    try:
        return [e.to_dict() for e in
                le.find(app_id=APP_ID, channel_id=channel_id)]
    finally:
        le.close()


def _content(d):
    """An event's fields without the ones a server assigns."""
    return json.dumps({k: v for k, v in d.items()
                       if k not in ("eventId", "creationTime")},
                      sort_keys=True)


def test_a_store_written_through_the_port_reads_back_in_both(
        servers, tmp_path):
    run_sequence(servers)
    for srv in servers["full"].values():
        call(srv, "POST", "/storage/events.jsonl",
             {**S, "channelId": "2"}, APPEND)
    port_db = tmp_path / "port-full.db"
    for ch in (None, 1, 2):
        by_port = _read_all(TSqlite, port_db, ch)
        by_jax = _read_all(JSqlite, port_db, ch)
        assert by_jax == by_port
        jax_written = _read_all(JSqlite, tmp_path / "jax-full.db", ch)
        assert sorted(map(_content, by_port)) == \
            sorted(map(_content, jax_written))
    assert len(_read_all(TSqlite, port_db)) >= 5


# -- tail reads ---------------------------------------------------------------

def _tail_events(Event, n, start=0):
    t0 = dt.datetime(2024, 3, 1, tzinfo=UTC)
    return [Event(event="rate", entity_type="user", entity_id=f"u{j % 4}",
                  target_entity_type="item", target_entity_id=f"i{j}",
                  properties={"rating": float(j % 5)},
                  event_time=t0 + dt.timedelta(seconds=(7 * j) % 11),
                  creation_time=t0, event_id=f"t{j}")
            for j in range(start, start + n)]


def _backend(pkg, kind, tmp_path):
    if kind == "memory":
        return (JMem if pkg == "jax" else TMem)()
    return (JSqlite if pkg == "jax" else TSqlite)(
        {"path": str(tmp_path / f"tail-{pkg}.db")})


def _tail_script(le, Event):
    """Every tail read's answer over a scripted history."""
    seen = []

    def since(cursor, limit=None):
        evs, cur = le.find_since(APP_ID, None, cursor=cursor, limit=limit)
        seen.append(([e.event_id for e in evs], cur))
        return cur

    le.init(APP_ID)
    seen.append(le.tail_watermark(APP_ID))
    seen.append(le.tail_cursor(APP_ID))
    cur = since(None)
    le.insert_batch(_tail_events(Event, 9), APP_ID)
    seen.append(le.tail_watermark(APP_ID))
    cur = since(cur, limit=4)
    cur = since(cur, limit=4)
    end = le.tail_cursor(APP_ID)
    cur = since(cur)
    cur = since(cur)
    le.delete("t3", APP_ID)
    le.delete("t8", APP_ID)
    le.insert_batch(_tail_events(Event, 3, start=20), APP_ID)
    since(end)
    cur = since(cur, limit=2)
    since(None)
    seen.append(le.tail_watermark(APP_ID))
    le.insert(_tail_events(Event, 1, start=4)[0], APP_ID)
    cur = since(cur)
    le.remove(APP_ID)
    le.init(APP_ID)
    le.insert_batch(_tail_events(Event, 12, start=40), APP_ID)
    since(cur)
    since(cur, limit=5)
    seen.append(le.tail_watermark(APP_ID))
    seen.append(le.tail_cursor(APP_ID))
    seen.append(le.find_since(APP_ID, 5)[0])
    return seen


@pytest.mark.parametrize("kind", ["memory", "sqlite"])
def test_tail_reads_equal_the_jax_backends(kind, tmp_path):
    answers = {}
    for pkg, Event in (("jax", JEvent), ("port", TEvent)):
        le = _backend(pkg, kind, tmp_path)
        try:
            answers[pkg] = _tail_script(le, Event)
        finally:
            le.close()
    assert answers["port"] == answers["jax"]
    delivered = [a for a in answers["port"] if isinstance(a, tuple)]
    assert any(ids for ids, _ in delivered)
