"""Columnar reads and the streaming builder against the JAX package.

The same events go into the port's sqlite (and memory) store and into
the JAX package's. ``find_columnar`` and ``find_columnar_blocks`` must
give equal columns (entity and target ids, values, times, event names)
under every filter, and the strict value check must fail the same way.
``StreamingRatingsBuilder.finalize`` over those blocks, and over
dictionary-encoded blocks, must equal the JAX builder's bitwise, and
its ``run_offsets`` must mark where each block's triples begin.
``iter_blocks_threaded`` yields every block in order and re-raises the
producer's error.
"""

import datetime as dt
import importlib

import numpy as np
import pytest

from predictionio_tpu.data import columnar as jcol
from predictionio_tpu_torch.data import columnar as tcol

from jax_native_ready import require_jax_native


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded(tmp_path_factory):
    """The JAX package's native libraries loaded before any comparison
    (``jax_native_ready``): a build raced by another worker is waited
    out, never compared against as the Python fallback."""
    require_jax_native(tmp_path_factory.getbasetemp().parent)

UTC = dt.timezone.utc
APP = 3
PACKAGES = ("predictionio_tpu", "predictionio_tpu_torch")


def events(pkg, seed=0, n=300, bad=False):
    Event = importlib.import_module(f"{pkg}.data.event").Event
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        kind = rng.integers(0, 10)
        t = dt.datetime(2021, 1, 1, tzinfo=UTC) + dt.timedelta(
            seconds=int(rng.integers(0, 5000)))
        if kind < 6:
            props = {"rating": float(rng.integers(1, 11) * 0.5)}
            if kind == 0:
                props = {"rating": int(rng.integers(1, 6))}
            out.append(Event(event="rate", entity_type="user",
                             entity_id=f"u{rng.integers(0, 25)}",
                             target_entity_type="item",
                             target_entity_id=f"i{rng.integers(0, 40)}",
                             properties=props, event_time=t))
        elif kind < 8:
            out.append(Event(event="view", entity_type="user",
                             entity_id=f"u{rng.integers(0, 25)}",
                             target_entity_type="item",
                             target_entity_id=f"i{rng.integers(0, 40)}",
                             event_time=t))
        elif kind == 8:
            out.append(Event(event="$set", entity_type="item",
                             entity_id=f"i{rng.integers(0, 40)}",
                             properties={"categories": ["c1"]},
                             event_time=t))
        else:
            out.append(Event(event="rate", entity_type="user",
                             entity_id=f"u{rng.integers(0, 25)}",
                             target_entity_type="item",
                             target_entity_id=f"i{rng.integers(0, 40)}",
                             properties={"rating": None}, event_time=t))
    if bad:
        out.append(Event(event="rate", entity_type="user", entity_id="ux",
                         target_entity_type="item", target_entity_id="ix",
                         properties={"rating": "five"},
                         event_time=dt.datetime(2021, 1, 2, tzinfo=UTC)))
    return out


def pevents(pkg, backend, tmp_path, **kw):
    if backend == "sqlite":
        mod = importlib.import_module(f"{pkg}.data.storage.sqlite")
        pe = mod.SqlitePEvents({"path": str(tmp_path / f"{pkg}.db")})
    else:
        mod = importlib.import_module(f"{pkg}.data.storage.memory")
        base = importlib.import_module(f"{pkg}.data.storage.base")
        pe = base.LEventsBackedPEvents(mod.MemLEvents({}))
    pe.write(events(pkg, **kw), APP)
    return pe


def columns(batch):
    return [list(batch.entity_ids), list(batch.target_ids),
            batch.values.tobytes(), batch.event_times.tobytes(),
            list(batch.events)]


FILTERS = [
    dict(entity_type="user", event_names=["rate", "view"],
         target_entity_type="item", value_property="rating"),
    dict(entity_type="user", event_names=["rate"],
         target_entity_type="item", value_property="rating",
         default_value=2.5),
    dict(value_property=None),
    dict(entity_type="item", target_entity_type=None),
    dict(event_names=["view"], value_property="rating",
         start_time=dt.datetime(2021, 1, 1, 0, 30, tzinfo=UTC),
         until_time=dt.datetime(2021, 1, 1, 1, 0, tzinfo=UTC)),
]


@pytest.mark.parametrize("backend", ["sqlite", "memory"])
@pytest.mark.parametrize("f", range(len(FILTERS)))
def test_columnar_reads_equal_the_jax_package(tmp_path, backend, f):
    jpe, tpe = (pevents(p, backend, tmp_path) for p in PACKAGES)
    kw = FILTERS[f]
    want = jpe.find_columnar(APP, **kw)
    got = tpe.find_columnar(APP, **kw)
    assert isinstance(got, tcol.ColumnarEvents) and len(got) == len(want)
    assert columns(got) == columns(want)
    if backend == "sqlite":
        # sqlite streams in rowid order: blocks of 7 rows
        jb = list(jpe.find_columnar_blocks(APP, block_size=7, **kw))
        tb = list(tpe.find_columnar_blocks(APP, block_size=7, **kw))
        assert [columns(b) for b in tb] == [columns(b) for b in jb]
        assert sum(map(len, tb)) == len(got)


@pytest.mark.parametrize("backend", ["sqlite", "memory"])
def test_strict_values_fail_alike(tmp_path, backend):
    jpe, tpe = (pevents(p, backend, tmp_path, bad=True) for p in PACKAGES)
    kw = dict(event_names=["rate"], value_property="rating")
    for pe in (jpe, tpe):
        with pytest.raises(ValueError, match="non-numeric"):
            pe.find_columnar(APP, **kw)
    assert columns(tpe.find_columnar(APP, strict=False, **kw)) == columns(
        jpe.find_columnar(APP, strict=False, **kw))


def finalized(builder):
    user_map, item_map, rows, cols, vals = builder.finalize()
    return ([user_map.decode(np.arange(len(user_map))).tolist(),
             item_map.decode(np.arange(len(item_map))).tolist()],
            rows.dtype, rows.tobytes(), cols.dtype, cols.tobytes(),
            vals.dtype, vals.tobytes())


@pytest.mark.parametrize("block_size", [1, 7, 64, 10_000])
def test_streaming_builder_equals_the_jax_builder(tmp_path, block_size):
    jpe, tpe = (pevents(p, "sqlite", tmp_path, seed=4) for p in PACKAGES)
    kw = dict(entity_type="user", event_names=["rate", "view"],
              target_entity_type="item", value_property="rating",
              block_size=block_size)
    jb, tb = jcol.StreamingRatingsBuilder(), tcol.StreamingRatingsBuilder()
    sizes = []
    for block in jpe.find_columnar_blocks(APP, **kw):
        jb.add_block(block)
    for block in tcol.iter_blocks_threaded(
            tpe.find_columnar_blocks(APP, **kw), queue_size=2):
        tb.add_block(block)
        sizes.append(len(block))
    assert finalized(tb) == finalized(jb)
    assert tb.n_events == jb.n_events == sum(sizes)
    assert tb.run_offsets.tolist() == np.r_[0, np.cumsum(sizes)].tolist()


def encoded_block(mod, rng, n=60):
    """A dictionary-encoded block with absent targets (-1) and labels no
    kept row names."""
    return mod.ColumnarEvents(
        entity_ids=None, target_ids=None,
        values=rng.normal(size=n).astype(np.float32),
        event_times=np.arange(n, dtype=np.float64),
        entity_codes=rng.integers(0, 9, n).astype(np.int32),
        entity_labels=np.asarray([f"u{j}" for j in range(12)], object),
        target_codes=rng.integers(-1, 14, n).astype(np.int32),
        target_labels=np.asarray([f"i{j}" for j in range(20)], object))


def test_streaming_builder_on_encoded_blocks():
    jb, tb = jcol.StreamingRatingsBuilder(), tcol.StreamingRatingsBuilder()
    for seed in range(4):
        jb.add_block(encoded_block(jcol, np.random.default_rng(seed)))
        tb.add_block(encoded_block(tcol, np.random.default_rng(seed)))
    assert finalized(tb) == finalized(jb)
    got = encoded_block(tcol, np.random.default_rng(9)).materialize()
    want = encoded_block(jcol, np.random.default_rng(9)).materialize()
    assert [list(got.entity_ids), list(got.target_ids)] == [
        list(want.entity_ids), list(want.target_ids)]
    assert None in list(got.target_ids)


def test_events_to_columnar_equals_the_jax_conversion():
    got = tcol.events_to_columnar(events("predictionio_tpu_torch", seed=2),
                                  value_property="rating")
    want = jcol.events_to_columnar(events("predictionio_tpu", seed=2),
                                   value_property="rating")
    assert columns(got) == columns(want)
    both = tcol.ColumnarEvents.concat([got.take(slice(0, 10)),
                                       got.take(slice(10, None))])
    assert columns(both) == columns(got)


def test_iter_blocks_threaded_reraises_the_producers_error():
    def blocks():
        yield 1
        yield 2
        raise OSError("disk gone")

    seen = []
    with pytest.raises(OSError, match="disk gone"):
        for b in tcol.iter_blocks_threaded(blocks()):
            seen.append(b)
    assert seen == [1, 2]
