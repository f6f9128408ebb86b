"""The port's JSON lines codec against the JAX package's, on the same bytes.

``parse_jsonl`` must equal the JAX codec column by column (flags, times,
line numbers and spans, every string column, the dictionary codes and
labels, the numeric property and its status) on a corpus with escapes,
surrogate pairs, a lone surrogate, blank lines, missing targets, a
non-numeric rating, exotic timestamps and reserved property keys, and on
500 random events; ``decode_jsonl_events`` must give equal blocks under
each filter. The codec never falls back silently: without
``PIO_NATIVE_DISABLE=1`` a failed build raises, and with it the Python
oracle gives the same rows.
"""

import datetime as dt
import json
import pathlib

import numpy as np
import pytest

from predictionio_tpu.data.storage import jsonlfs as jjsonlfs
from predictionio_tpu.data.storage.base import UNSET as J_UNSET
from predictionio_tpu.native import codec as jcodec
from predictionio_tpu_torch import native as tnative
from predictionio_tpu_torch.data.storage import jsonlfs as tjsonlfs
from predictionio_tpu_torch.data.storage.base import UNSET as T_UNSET
from predictionio_tpu_torch.native import codec as tcodec

from jax_native_ready import require_jax_native


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded(tmp_path_factory):
    """The JAX package's native libraries loaded before any comparison
    (``jax_native_ready``): a build raced by another worker is waited
    out, never compared against as the Python fallback."""
    require_jax_native(tmp_path_factory.getbasetemp().parent)

UTC = dt.timezone.utc

CORPUS = [
    {"event": "rate", "entityType": "user", "entityId": "u1",
     "targetEntityType": "item", "targetEntityId": "i1",
     "properties": {"rating": 4.5}, "eventTime": "2021-06-01T12:30:45.123Z"},
    {"event": "$set", "entityType": "user", "entityId": "u2",
     "properties": {"name": "Ann \"quoted\" \\ back\t slash",
                    "nested": {"a": [1, 2, {"b": None}]},
                    "uni": "héllo ☃"},
     "eventTime": "2021-06-01T12:30:45+05:30"},
    {"event": "view", "entityType": "user", "entityId": "ué",
     "targetEntityType": "item", "targetEntityId": "i2",
     "eventTime": 1600000000000},
    {"event": "buy", "entityType": "user", "entityId": 123,
     "targetEntityType": "item", "targetEntityId": "i3",
     "tags": ["a", "b"], "prId": "pr1", "eventId": "deadbeef"},
    {"event": "$delete", "entityType": "user", "entityId": "u4"},
    {"event": "like", "entityType": "user", "entityId": "u5",
     "targetEntityType": "item", "targetEntityId": "i9",
     "eventTime": "2020-02-29T00:00:00+00:00",
     "creationTime": "2020-03-01T01:02:03.5+00:00"},
    # a missing target, a non-numeric and a null rating
    {"event": "rate", "entityType": "user", "entityId": "u6",
     "properties": {"rating": 2}, "eventTime": "2020-01-01T00:00:01Z"},
    {"event": "rate", "entityType": "user", "entityId": "u7",
     "targetEntityType": "item", "targetEntityId": "i1",
     "properties": {"rating": "five"}, "eventTime": "2020-01-01T00:00:02Z"},
    {"event": "rate", "entityType": "user", "entityId": "u8",
     "targetEntityType": "item", "targetEntityId": "i4",
     "properties": {"rating": None}, "eventTime": "2020-01-01T00:00:03Z"},
    # reserved property keys
    {"event": "$set", "entityType": "user", "entityId": "u9",
     "properties": {"pio_bad": 1}},
    {"event": "$set", "entityType": "user", "entityId": "u10",
     "properties": {"$dollar": 1}},
    {"event": "$unset", "entityType": "u", "entityId": "x",
     "properties": {}},
]

RAW_LINES = [
    # surrogate pair, lone surrogate, escaped dollar sign
    '{"event":"e","entityType":"t","entityId":"\\ud83d\\ude00"}',
    '{"event":"e","entityType":"t","entityId":"\\ud83d"}',
    '{"event":"\\u0024set","entityType":"user","entityId":"esc",'
    '"properties":{"a":1}}',
    # exotic timestamps: an invalid date, a leap second, a bare date
    '{"event":"rate","entityType":"user","entityId":"u1",'
    '"targetEntityType":"item","targetEntityId":"i2",'
    '"properties":{"rating":3},"eventTime":"2021-02-30T00:00:00Z"}',
    '{"event":"rate","entityType":"user","entityId":"u2",'
    '"targetEntityType":"item","targetEntityId":"i2",'
    '"properties":{"rating":1},"eventTime":"2021-06-01T23:59:60Z"}',
    '{"event":"rate","entityType":"user","entityId":"u3",'
    '"targetEntityType":"item","targetEntityId":"i3",'
    '"properties":{"rating":1},"eventTime":"2021-06-01"}',
    # lines the codec cannot express: truncated, not an object, a float id
    '{"event": "rate"',
    '["not", "an", "object"]',
    '{"event": "e", "entityType": "user", "entityId": 1.5}',
]


# the two rows whose eventTime the Python parser refuses (an invalid date,
# a leap second): a scan that reads their times raises in both packages
INVALID_TIMES = (3, 4)


def corpus_bytes(valid_times_only: bool = False) -> bytes:
    lines = [json.dumps(o, ensure_ascii=i % 2 == 0)
             for i, o in enumerate(CORPUS)]
    raw = [ln for j, ln in enumerate(RAW_LINES)
           if not (valid_times_only and j in INVALID_TIMES)]
    # blank lines between and around the events
    body = "\n\n".join(lines[:4]) + "\n   \n" + "\n".join(lines[4:])
    return ("\n" + body + "\n" + "\n".join(raw) + "\n").encode()


STRING_FIELDS = ("event", "entity_type", "entity_id", "target_entity_type",
                 "target_entity_id", "properties_json", "tags_json", "pr_id",
                 "event_id", "event_time_raw", "creation_time_raw",
                 "bad_prop_key")
ARRAY_FIELDS = ("event_time", "creation_time", "flags", "lineno",
                "line_start", "line_end", "prop_value", "prop_status")


def assert_parsed_equal(got, want):
    assert len(got) == len(want)
    for name in STRING_FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    for name in ARRAY_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        # bytes, so NaN times compare equal to NaN
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    if want.dict_codes is None:
        assert got.dict_codes is None and got.dict_labels is None
        return
    assert sorted(got.dict_codes) == sorted(want.dict_codes)
    for c in want.dict_codes:
        assert got.dict_codes[c].tobytes() == want.dict_codes[c].tobytes()
        assert got.dict_labels[c].tolist() == want.dict_labels[c].tolist()


OPTIONS = {
    "all columns": {},
    "numeric rating": dict(numeric_property="rating"),
    "numeric missing key": dict(numeric_property="nope"),
    "no columns": dict(columns=set()),
    "time column only": dict(columns={tcodec.COL_EVENT_TIME_RAW}),
    "encoded ids": dict(dict_encode={tcodec.COL_EVENT, tcodec.COL_ENTITY_ID,
                                     tcodec.COL_TARGET_ENTITY_ID}),
    "ingest lane": dict(numeric_property="rating",
                        columns={tcodec.COL_EVENT_TIME_RAW},
                        dict_encode={0, 1, 2, 3, 4}),
    "encoded and listed": dict(columns={tcodec.COL_ENTITY_ID},
                               dict_encode={tcodec.COL_ENTITY_ID}),
}


def test_column_ids_and_flags_match_the_jax_codec():
    names = [n for n in dir(jcodec) if n.startswith("COL_")] + [
        "FALLBACK", "PROPS_EMPTY", "BAD_PROP_KEY"]
    assert len(names) == 15
    assert {n: getattr(tcodec, n) for n in names} == {
        n: getattr(jcodec, n) for n in names}


def test_the_codec_source_is_the_jax_packages():
    """The C++ is a copy: everything below its header comment is equal."""
    from predictionio_tpu import native as jnative

    def body(path):
        text = path.read_text()
        return text[text.index("#include"):]

    jsrc = pathlib.Path(jnative.__file__).parent / "src" / "jsonl_codec.cpp"
    assert body(tnative.SRC_DIR / "jsonl_codec.cpp") == body(jsrc)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_parse_equals_the_jax_codec(name):
    data = corpus_bytes()
    before = tcodec.parse_calls.value
    got = tcodec.parse_jsonl(data, **OPTIONS[name])
    want = jcodec.parse_jsonl(data, **OPTIONS[name])
    assert tcodec.parse_calls.value == before + 1
    assert len(got) == len(CORPUS) + len(RAW_LINES)
    assert_parsed_equal(got, want)
    if name == "all columns":
        flags = got.flags
        # the lone surrogate and the three broken lines fall back, the
        # surrogate pair and the escaped dollar sign do not
        fb = [i for i in range(len(got)) if flags[i] & tcodec.FALLBACK]
        assert fb == [len(CORPUS) + j for j in (1, 6, 7, 8)]
        assert got.entity_id[len(CORPUS)] == "\U0001F600"
        assert flags[9] & tcodec.BAD_PROP_KEY and \
            got.bad_prop_key[9] == "pio_bad"
        assert flags[11] & tcodec.PROPS_EMPTY
        assert got.lineno[0] == 2   # the buffer starts with a blank line


def random_event(rng):
    def rstr(pool):
        return "".join(rng.choice(pool, size=int(rng.integers(1, 12))))

    plain = list("abcdefgh0123XYZ_-")
    spicy = list("abc\"\\\t\né☃𝄞:{}[],'/ ")
    pool = plain if rng.random() < 0.6 else spicy
    o = {"event": rstr(plain) if rng.random() < 0.9 else "$set",
         "entityType": "user", "entityId": rstr(pool)}
    if o["event"] == "$set" or rng.random() < 0.5:
        props = {}
        for _ in range(int(rng.integers(0, 4))):
            roll = rng.random()
            key = rstr(plain)
            props[key] = (float(rng.normal()) if roll < 0.3
                          else int(rng.integers(-10, 10)) if roll < 0.5
                          else rstr(pool) if roll < 0.7
                          else [1, rstr(pool), None] if roll < 0.85
                          else {"deep": {"er": rstr(pool)}})
        if rng.random() < 0.3:
            props["rating"] = float(rng.integers(1, 11)) / 2
        o["properties"] = props or ({"x": 1} if o["event"] == "$set"
                                    else props)
    if o["event"] != "$set" and rng.random() < 0.6:
        o["targetEntityType"] = "item"
        o["targetEntityId"] = rstr(pool)
    roll = rng.random()
    if roll < 0.4:
        o["eventTime"] = (
            f"20{rng.integers(10, 30):02d}-{rng.integers(1, 13):02d}-"
            f"{rng.integers(1, 29):02d}T{rng.integers(0, 24):02d}:"
            f"{rng.integers(0, 60):02d}:{rng.integers(0, 60):02d}"
            + ("Z" if rng.random() < 0.5 else "+05:30"))
    elif roll < 0.6:
        o["eventTime"] = int(rng.integers(1, 2_000_000_000_000))
    if rng.random() < 0.2:
        o["tags"] = [rstr(plain), rstr(pool)]
    if rng.random() < 0.2:
        o["prId"] = rstr(plain)
    return o


@pytest.mark.parametrize("name", ["all columns", "ingest lane"])
def test_500_random_events_equal_the_jax_codec(name):
    rng = np.random.default_rng(20261017)
    lines = [json.dumps(random_event(rng),
                        ensure_ascii=bool(rng.integers(0, 2)))
             for _ in range(500)]
    data = "\n".join(lines).encode("utf-8")
    got = tcodec.parse_jsonl(data, **OPTIONS[name])
    assert len(got) == 500
    assert_parsed_equal(got, jcodec.parse_jsonl(data, **OPTIONS[name]))
    assert int((got.flags & tcodec.FALLBACK != 0).sum()) < 250


T0 = dt.datetime(2020, 1, 1, tzinfo=UTC)
# every eventTime of the corpus lies before this
NOW_STAMPED = dt.datetime(2024, 1, 1, tzinfo=UTC).timestamp()


def decode_filters(unset):
    t0 = T0
    return {
        "none": {},
        "rate, numeric": dict(event_names=["rate"], value_property="rating",
                              strict=False),
        "rate view": dict(event_names=["rate", "view"], entity_type="user",
                          target_entity_type="item"),
        "no target": dict(target_entity_type=None),
        "any target": dict(target_entity_type=unset),
        "time window": dict(start_time=t0,
                            until_time=t0 + dt.timedelta(days=600)),
        "lenient default": dict(value_property="rating", default_value=2.5,
                                strict=False),
    }


def block_rows(block):
    """A block's content as comparable plain values (codes and labels
    for an encoded block, object columns for a fallback block)."""
    # a row without an eventTime is stamped with the time of the read
    times = np.where(block.event_times > NOW_STAMPED, -1.0,
                     block.event_times)
    out = {"values": block.values.tobytes(), "times": times.tobytes(),
           "encoded": block.is_encoded}
    for name in ("entity_codes", "target_codes", "event_codes"):
        col = getattr(block, name)
        out[name] = None if col is None else col.tobytes()
    for name in ("entity_labels", "target_labels", "event_labels",
                 "entity_ids", "target_ids", "events"):
        col = getattr(block, name)
        out[name] = None if col is None else col.tolist()
    return out


@pytest.mark.parametrize("name", sorted(decode_filters(None)))
def test_decode_gives_the_jax_blocks(name):
    data = corpus_bytes(valid_times_only=True)
    got = tjsonlfs.decode_jsonl_events(data, **decode_filters(T_UNSET)[name])
    want = jjsonlfs.decode_jsonl_events(data, **decode_filters(J_UNSET)[name])
    assert [block_rows(b) for b in got] == [block_rows(b) for b in want]
    assert got[0].is_encoded
    if name == "none":
        assert len(got) == 2     # the bulk and the re-parsed fallback rows


def test_decode_raises_like_the_jax_codec():
    """A non-numeric rating under ``strict``, and a refused time, raise
    the same error in both packages."""
    data = corpus_bytes(valid_times_only=True)
    for mod in (tjsonlfs, jjsonlfs):
        with pytest.raises(ValueError, match="corpus.jsonl:13 is non-num"):
            mod.decode_jsonl_events(data, value_property="rating",
                                    source="corpus.jsonl")
        with pytest.raises(ValueError, match="invalid time"):
            mod.decode_jsonl_events(corpus_bytes())


@pytest.fixture
def no_cached_codec(monkeypatch):
    """A fresh library cache, restored afterwards."""
    monkeypatch.setattr(tnative, "_libs", {})


def test_a_failed_build_raises_instead_of_falling_back(
        tmp_path, monkeypatch, no_cached_codec):
    monkeypatch.delenv("PIO_NATIVE_DISABLE", raising=False)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        tcodec.parse_jsonl(corpus_bytes())
    with pytest.raises(RuntimeError, match="g.. not found"):
        tjsonlfs.decode_jsonl_events(corpus_bytes())


def test_disabled_codec_takes_the_python_oracle_with_the_same_rows(
        monkeypatch, no_cached_codec):
    data = corpus_bytes(valid_times_only=True)
    native = [b.materialize() for b in tjsonlfs.decode_jsonl_events(
        data, value_property="rating", strict=False)]
    monkeypatch.setenv("PIO_NATIVE_DISABLE", "1")
    assert tcodec.parse_jsonl(data) is None
    oracle, = tjsonlfs.decode_jsonl_events(data, value_property="rating",
                                           strict=False)

    def rows(blocks):
        out = []
        for b in blocks:
            out += zip(b.entity_ids.tolist(), b.target_ids.tolist(),
                       b.events.tolist(), b.values.tolist())
        return sorted(out, key=repr)

    # the codec's bulk and fallback blocks hold the oracle's rows (times
    # differ only where no eventTime was given: both stamp "now")
    assert rows(native) == rows([oracle])
