"""The template's ``EventDataSource`` against the JAX template's.

The same rate / view / ``$set`` events go into the port's store and the
JAX package's (each package's registry gets a config of its own:
``memory``, or ``sqlite`` in its own file). Both data sources read them
with the same params, in one scan and streamed in blocks, with the
items' categories, and must give equal training data; the preparator
then lays both out byte for byte alike (the streamed blocks reach the
dedup sort as runs, which the port merges natively). The pipelined read
without ``streamingBlockSize`` raises as the JAX one does; the default
evaluation read returns its leave-last-out set
(``tests/test_torch_evaluation.py`` holds it against the JAX one).
"""

import datetime as dt
import importlib

import numpy as np
import pytest

from predictionio_tpu.data import storage as jstorage
from predictionio_tpu.templates.recommendation import engine as jeng
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.native import codec
from predictionio_tpu_torch.templates.recommendation import engine as teng

from jax_native_ready import require_jax_native


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded(tmp_path_factory):
    """The JAX package's native libraries loaded before any comparison
    (``jax_native_ready``): a build raced by another worker is waited
    out, never compared against as the Python fallback."""
    require_jax_native(tmp_path_factory.getbasetemp().parent)

UTC = dt.timezone.utc
PACKAGES = ("predictionio_tpu", "predictionio_tpu_torch")


def configure(pkg, backend, tmp_path):
    """Point the package's storage registry at a store of its own."""
    st = jstorage if pkg == PACKAGES[0] else tstorage
    src = {"type": "memory"} if backend == "memory" else {
        "type": "sqlite", "path": str(tmp_path / f"{pkg}.db")}
    st.reset(st.StorageConfig(
        sources={"S": src},
        repositories={r: "S" for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}))
    return st


def fill_store(pkg, st, seed, n=900):
    """App ``MyApp`` (and its channel ``web``) with rate / view events,
    noise of other types, and categories ``$set`` on most items."""
    base = importlib.import_module(f"{pkg}.data.storage.base")
    Event = importlib.import_module(f"{pkg}.data.event").Event
    aid = st.get_metadata_apps().insert(base.App(0, "MyApp"))
    cid = st.get_metadata_channels().insert(base.Channel(0, "web", aid))
    rng = np.random.default_rng(seed)
    t0 = dt.datetime(2022, 3, 1, tzinfo=UTC)
    evs = []
    for j in range(n):
        name = "rate" if rng.random() < 0.7 else "view"
        props = {"rating": float(rng.integers(1, 11) * 0.5)} \
            if name == "rate" else {}
        evs.append(Event(event=name, entity_type="user",
                         entity_id=f"u{rng.integers(0, 40)}",
                         target_entity_type="item",
                         target_entity_id=f"i{rng.integers(0, 60)}",
                         properties=props,
                         event_time=t0 + dt.timedelta(seconds=j)))
    evs += [Event(event="buy", entity_type="user", entity_id="u1",
                  target_entity_type="item", target_entity_id="i999",
                  event_time=t0),
            Event(event="rate", entity_type="shop", entity_id="s1",
                  target_entity_type="item", target_entity_id="i998",
                  properties={"rating": 3.0}, event_time=t0)]
    for i in range(0, 60, 1):
        if i % 7:
            evs.append(Event(event="$set", entity_type="item",
                             entity_id=f"i{i}",
                             properties={"categories": [f"c{i % 3}",
                                                        f"c{i % 5}"]},
                             event_time=t0 + dt.timedelta(days=1)))
    levents = st.get_levents()
    levents.init(aid)
    levents.insert_batch(evs, aid)
    levents.insert_batch(evs[:50], aid, cid)
    return aid


def read(pkg, backend, tmp_path, params):
    st = configure(pkg, backend, tmp_path)
    fill_store(pkg, st, seed=11)
    mod = jeng if pkg == PACKAGES[0] else teng
    return mod.EventDataSource(mod.DataSourceParams(**params)).read_training(
        None)


def labels(bimap):
    return bimap.decode(np.arange(len(bimap))).tolist()


def side_bytes(side):
    if hasattr(side, "buckets"):
        return [(b.row_ids.tobytes(), b.cols.tobytes(), b.weights.tobytes(),
                 b.mask.tobytes()) for b in side.buckets]
    return [side.cols.tobytes(), side.weights.tobytes(), side.mask.tobytes()]


READS = {
    "scan": dict(app_name="MyApp", event_names=("rate", "view"),
                 read_item_categories=True),
    "scan rate only": dict(app_name="MyApp"),
    "scan channel": dict(app_name="MyApp", channel_name="web",
                         event_names=("rate", "view")),
    "stream": dict(app_name="MyApp", event_names=("rate", "view"),
                   read_item_categories=True, streaming_block_size=128),
    "stream one block": dict(app_name="MyApp", event_names=("rate", "view"),
                             streaming_block_size=100_000),
}


@pytest.fixture(autouse=True)
def reset_registries():
    yield
    jstorage.reset()
    tstorage.reset()


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
@pytest.mark.parametrize("name", sorted(READS))
def test_training_data_equals_the_jax_template(tmp_path, backend, name):
    params = READS[name]
    want = read(PACKAGES[0], backend, tmp_path, params)
    merges = codec.merge_calls.value
    got = read(PACKAGES[1], backend, tmp_path, params)
    assert len(got) == len(want) > 0
    if params.get("streaming_block_size"):
        assert isinstance(got, teng.IndexedTrainingData)
        assert labels(got.user_map) == labels(want.user_map)
        assert labels(got.item_map) == labels(want.item_map)
        for col in ("rows", "cols", "values"):
            a, b = getattr(got, col), getattr(want, col)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert got.runs[0] == 0 and got.runs[-1] == len(got)
    else:
        assert isinstance(got, teng.TrainingData)
        assert list(got.users) == list(want.users)
        assert list(got.items) == list(want.items)
        assert got.values.tobytes() == want.values.tobytes()
    assert got.item_categories == want.item_categories
    if params.get("read_item_categories"):
        assert len(got.item_categories) == 51

    for bucketed in (False, True):
        tpd = teng.RatingsPreparator(
            teng.PreparatorParams(bucketed=bucketed)).prepare(None, got)
        jpd = jeng.RatingsPreparator(
            jeng.PreparatorParams(bucketed=bucketed)).prepare(None, want)
        assert side_bytes(tpd.user_side) == side_bytes(jpd.user_side)
        assert side_bytes(tpd.item_side) == side_bytes(jpd.item_side)
        assert labels(tpd.item_map) == labels(jpd.item_map)
        assert {u: s.tolist() for u, s in tpd.seen.items()} == {
            u: s.tolist() for u, s in jpd.seen.items()}
        assert tpd.item_categories == jpd.item_categories
    streamed_runs = params.get("streaming_block_size") == 128
    assert (codec.merge_calls.value > merges) == streamed_runs


def test_unported_reads_raise(tmp_path):
    st = configure(PACKAGES[1], "memory", tmp_path)
    fill_store(PACKAGES[1], st, seed=1, n=20)
    piped = teng.EventDataSource(teng.DataSourceParams(
        app_name="MyApp", pipelined_ingest=True))
    with pytest.raises(ValueError, match="requires streaming_block_size"):
        piped.read_training(None)
    plain = teng.EventDataSource(teng.DataSourceParams(app_name="MyApp"))
    # read_eval, once refused, returns the leave-last-out eval set
    [(td, info, qa)] = plain.read_eval(None)
    assert type(info).__name__ == "EmptyEvalInfo"
    assert len(td) + len(qa) == len(plain.read_training(None))
    assert {q.user for q, _ in qa} <= set(td.users.tolist())
    unknown = teng.EventDataSource(teng.DataSourceParams(app_name="NoApp"))
    with pytest.raises(ValueError, match="NoApp"):
        unknown.read_training(None)


def test_template_registers_the_event_data_source():
    engine = teng.engine_factory()
    assert engine.data_source_class_map == {"": teng.EventDataSource}
    params = engine.engine_params_from_variant(
        {"datasource": {"params": {"appName": "MyApp",
                                   "streamingBlockSize": 64,
                                   "readItemCategories": True}}})
    name, ds = params.data_source_params
    assert name == "" and ds == teng.DataSourceParams(
        app_name="MyApp", streaming_block_size=64,
        read_item_categories=True)
