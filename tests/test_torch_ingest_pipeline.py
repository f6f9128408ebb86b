"""The port's pipelined ingest against its serial chain and the JAX one.

``PipelinedRatingsBuilder`` and ``ingest_ratings_pipelined`` (staging to
``device="cpu"``) must give byte-equal training inputs to the port's
serial ``StreamingRatingsBuilder`` + ``bucket_ratings_pair`` and to the
JAX ``ingest_ratings_pipelined``, on randomized power-law streams at
every block size, with missing targets, and on an empty stream; a
poisoned partition raises instead of hanging (with and without
prefetch), and prefetch gives the same blocks. The template with
``pipelinedIngest`` on a ``jsonlfs`` store gives the same prepared
layouts as without it, and the same factors from one init. Mirrors
``tests/test_ingest_pipeline.py``.
"""

import datetime as dt
import threading

import numpy as np
import pytest
import torch

from predictionio_tpu.data import columnar as jcol
from predictionio_tpu.utils import tracing as jtracing
from predictionio_tpu_torch.data import columnar as tcol
from predictionio_tpu_torch.native import codec as tcodec
from predictionio_tpu_torch.ops import als as tals
from predictionio_tpu_torch.utils import tracing as ttracing

UTC = dt.timezone.utc


def power_law_stream(n, n_users, n_items, seed, with_nones=False):
    """(entity_ids, target_ids, values) with power-law popularity and
    duplicate (user, item) pairs."""
    rng = np.random.default_rng(seed)
    user_p = 1.0 / np.arange(1, n_users + 1) ** 0.7
    item_p = 1.0 / np.arange(1, n_items + 1) ** 0.9
    users = rng.choice(n_users, size=n, p=user_p / user_p.sum())
    items = rng.choice(n_items, size=n, p=item_p / item_p.sum())
    vals = rng.integers(1, 6, size=n).astype(np.float32)
    ents = np.asarray([f"u{u}" for u in users], dtype=object)
    tgts = np.asarray([f"i{i}" for i in items], dtype=object)
    if with_nones:
        tgts[rng.random(n) < 0.05] = None
    return ents, tgts, vals


def blocks_of(mod, stream, block_size):
    ents, tgts, vals = stream
    for i in range(0, len(ents), block_size):
        j = min(i + block_size, len(ents))
        yield mod.ColumnarEvents(entity_ids=ents[i:j], target_ids=tgts[i:j],
                                 values=vals[i:j],
                                 event_times=np.zeros(j - i))


def serial_reference(stream, block_size, **bucket_kw):
    b = tcol.StreamingRatingsBuilder()
    for blk in blocks_of(tcol, stream, block_size):
        b.add_block(blk)
    um, im, rows, cols, v = b.finalize()
    us, its = tals.bucket_ratings_pair(rows, cols, v, len(um), len(im),
                                       **bucket_kw)
    return um, im, us, its


def side_bytes(side):
    return (side.n_rows, side.n_cols, [
        tuple(np.asarray(a).tobytes() for a in (b.row_ids, b.cols, b.weights,
                                                 b.mask))
        for b in side.buckets])


def labels(bimap):
    return bimap.decode(np.arange(len(bimap))).tolist()


def assert_same_ingest(res, um, im, us, its):
    assert labels(res.user_map) == labels(um)
    assert labels(res.item_map) == labels(im)
    assert side_bytes(res.user_side) == side_bytes(us)
    assert side_bytes(res.item_side) == side_bytes(its)


# block sizes: single-event blocks, tiny, uneven, one block bigger than
# the whole stream
@pytest.mark.parametrize("block_size", [1, 7, 64, 333, 10_000])
def test_pipelined_equals_serial_and_jax(block_size):
    stream = power_law_stream(1500, 80, 40, seed=3)
    ref = serial_reference(stream, block_size)
    res = tcol.ingest_ratings_pipelined(blocks_of(tcol, stream, block_size))
    assert_same_ingest(res, *ref)
    jres = jcol.ingest_ratings_pipelined(blocks_of(jcol, stream, block_size))
    assert_same_ingest(res, jres.user_map, jres.item_map, jres.user_side,
                       jres.item_side)
    assert (res.n_events, res.nnz) == (jres.n_events, jres.nnz) == (
        1500, ref[2].nnz)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_streams_with_missing_targets(seed):
    stream = power_law_stream(2000, 60, 30, seed=seed, with_nones=True)
    ref = serial_reference(stream, 170)
    res = tcol.ingest_ratings_pipelined(blocks_of(tcol, stream, 170),
                                        stage_device=True, device="cpu")
    assert_same_ingest(res.wait(), *ref)
    jres = jcol.ingest_ratings_pipelined(blocks_of(jcol, stream, 170))
    assert res.n_events == jres.n_events < 2000


def test_ladder_and_truncation_equal_serial():
    stream = power_law_stream(1800, 40, 20, seed=5)
    kw = dict(bucket_lengths=[8, 32], max_len=48)
    res = tcol.ingest_ratings_pipelined(blocks_of(tcol, stream, 200), **kw)
    assert_same_ingest(res, *serial_reference(stream, 200, **kw))


def test_empty_stream():
    res = tcol.ingest_ratings_pipelined(iter(()), stage_device=True,
                                        device="cpu").wait()
    assert (res.nnz, res.n_events) == (0, 0)
    assert len(res.user_map) == len(res.item_map) == 0
    assert res.user_side.buckets == [] and res.item_side.buckets == []


def test_finalize_and_merge_equal_the_jax_builder():
    """``finalize`` hands over merged (row, col) order, equal to the JAX
    builder's bytes; deduplicated it equals the stream-ordered serial
    read's, and the native merge ran."""
    stream = power_law_stream(900, 30, 15, seed=11)
    sb, pb, jb = (tcol.StreamingRatingsBuilder(),
                  tcol.PipelinedRatingsBuilder(),
                  jcol.PipelinedRatingsBuilder())
    for b, mod in ((sb, tcol), (pb, tcol), (jb, jcol)):
        for blk in blocks_of(mod, stream, 100):
            b.add_block(blk)
    merges = tcodec.merge_calls.value
    got, want = pb.merge_sorted(), jb.merge_sorted()
    assert tcodec.merge_calls.value == merges + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert np.all(np.diff(got[3]) >= 0)
    um_s, im_s, r_s, c_s, v_s = sb.finalize()
    um_p, im_p, r_p, c_p, v_p = pb.finalize()
    assert labels(um_p) == labels(um_s) and labels(im_p) == labels(im_s)
    for a, b in zip(tals.dedup_sum_ratings(r_s, c_s, v_s, len(im_s)),
                    tals.dedup_sum_ratings(r_p, c_p, v_p, len(im_p))):
        assert a.tobytes() == b.tobytes()


def test_final_factors_identical():
    stream = power_law_stream(1200, 50, 25, seed=9)
    _, _, us, its = serial_reference(stream, 111)
    params = tals.ALSParams(rank=8, num_iterations=3, seed=4)
    X_s, Y_s = tals.train_als_bucketed(us, its, params, device="cpu")
    res = tcol.ingest_ratings_pipelined(
        blocks_of(tcol, stream, 111), stage_device=True, device="cpu",
        warmup_params=params).wait()
    assert isinstance(res.user_side.buckets[0].cols, torch.Tensor)
    X_p, Y_p = tals.train_als_bucketed(res.user_side, res.item_side, params,
                                       device="cpu")
    assert X_s.tobytes() == X_p.tobytes() and Y_s.tobytes() == Y_p.tobytes()
    stages = res.timeline.summary()["stages"]
    for stage in ("decode", "index", "merge", "bucket.user", "bucket.item",
                  "h2d.user.dispatch", "h2d.item.dispatch", "h2d.wait",
                  "warmup_compile", "warmup_wait"):
        assert stage in stages, stages.keys()


def test_cpu_staging_is_synchronous_and_warmup_needs_nothing():
    stream = power_law_stream(300, 20, 10, seed=2)
    _, _, us, _ = serial_reference(stream, 64)
    staged = us.to_device_async("cpu")
    assert staged.staging is None and staged is not us
    assert staged.to_device_async("cpu") is staged
    assert staged.block_until_staged() is staged
    assert side_bytes(staged) == side_bytes(us)
    assert tals.warmup_train_als_bucketed(us, us, tals.ALSParams(),
                                          device="cpu") is True

    class Grid:
        configs = [tals.ALSParams()]

    # a config grid's warm-up, once refused, readies what one config needs
    assert tals.warmup_train_als_bucketed(us, us, Grid(),
                                          device="cpu") is True


def test_stage_timeline_summary_equals_the_jax_one():
    spans = [("decode", 0.0, 1.0), ("index", 0.5, 1.25), ("decode", 1.0,
                                                          2.0),
             ("merge", 2.0, 2.5), ("h2d.wait", 2.5, 2.5)]
    tl, jl = ttracing.StageTimeline(), jtracing.StageTimeline()
    for stage, a, b in spans:
        tl.add(stage, 100 + a, 100 + b)
        jl.add(stage, 100 + a, 100 + b)
    assert tl.summary() == jl.summary()
    assert tl.summary()["overlap_ratio"] == round(3.25 / 2.5, 3)

    def strip(doc):
        return {**doc, "spans": [{k: v for k, v in s.items()
                                  if k != "thread"} for s in doc["spans"]]}

    assert strip(tl.to_json()) == strip(jl.to_json())
    seen = []
    wrapped = list(tl.wrap_iter(iter("ab"), "read"))
    with tl.scope("scope"):
        seen.append(1)
    assert wrapped == ["a", "b"] and seen == [1]
    assert tl.summary()["stages"]["read"]["spans"] == 3


def test_producer_error_propagates():
    def poisoned():
        yield from blocks_of(tcol, power_law_stream(100, 10, 5, seed=1), 40)
        raise RuntimeError("decode exploded")

    with pytest.raises(RuntimeError, match="decode exploded"):
        tcol.ingest_ratings_pipelined(poisoned())


RATE = ('{"event":"rate","entityType":"user","entityId":"u%d",'
        '"targetEntityType":"item","targetEntityId":"i%d",'
        '"properties":{"rating":%s},'
        '"eventTime":"2020-01-01T00:00:00+00:00"}')


def jsonlfs_pevents(root, part_max):
    from predictionio_tpu_torch.data.storage.jsonlfs import JsonlFsPEvents

    pe = JsonlFsPEvents({"path": str(root), "part_max_events": part_max})
    pe._l.init(1)
    return pe


@pytest.mark.parametrize("prefetch", [0, 3])
def test_poisoned_partition_raises_not_hangs(tmp_path, prefetch):
    """A partition whose decode raises (a non-numeric rating under
    ``strict``) surfaces the error in the consumer, and no producer
    thread outlives the read."""
    pe = jsonlfs_pevents(tmp_path, 2)
    pe._l.append_raw_lines([RATE % (1, 1, 3)] * 4, 1)
    pe._l.append_raw_lines([RATE % (1, 1, '"BAD"')], 1)
    pe._l.append_raw_lines([RATE % (2, 1, 4)] * 2, 1)
    before = {t.ident for t in threading.enumerate()}
    with pytest.raises(ValueError, match="non-numeric"):
        tcol.ingest_ratings_pipelined(pe.find_columnar_blocks(
            1, event_names=["rate"], value_property="rating", strict=True,
            block_size=2, prefetch=prefetch), queue_size=2)
    for t in threading.enumerate():
        if t.ident not in before:
            t.join(timeout=5)
            assert not t.is_alive(), f"leaked thread {t.name}"


def test_prefetch_yields_identical_blocks(tmp_path):
    pe = jsonlfs_pevents(tmp_path, 5)
    pe._l.append_raw_lines([RATE % (i % 7, i % 4, 1 + i % 5)
                            for i in range(23)], 1)

    def collect(prefetch):
        out = []
        for b in pe.find_columnar_blocks(1, event_names=["rate"],
                                         value_property="rating",
                                         block_size=3, prefetch=prefetch):
            m = b.materialize()
            out.append((m.entity_ids.tolist(), m.target_ids.tolist(),
                        m.values.tolist()))
        return out

    assert collect(0) == collect(2) == collect(8)
    # partitions of 5, 5, 5, 5 and 3 events, each cut into blocks of 3
    assert [len(b[0]) for b in collect(0)] == [3, 2] * 4 + [3]


# -- the template on a jsonlfs store ----------------------------------------

def configure(pkg, tmp_path):
    """A ``jsonlfs`` event store (memory metadata) for one package's
    registry, filled with the same events."""
    import importlib

    st = importlib.import_module(f"{pkg}.data.storage")
    base = importlib.import_module(f"{pkg}.data.storage.base")
    Event = importlib.import_module(f"{pkg}.data.event").Event
    st.reset(st.StorageConfig(
        sources={"EV": {"type": "jsonlfs", "path": str(tmp_path / pkg),
                        "part_max_events": 97},
                 "META": {"type": "memory"}},
        repositories={"EVENTDATA": "EV", "METADATA": "META",
                      "MODELDATA": "META"}))
    aid = st.get_metadata_apps().insert(base.App(0, "pipeapp"))
    rng = np.random.default_rng(6)
    t0 = dt.datetime(2020, 1, 1, tzinfo=UTC)
    evs = [Event(event="rate" if rng.random() < 0.8 else "view",
                 entity_type="user", entity_id=f"u{int(rng.integers(0, 30))}",
                 target_entity_type="item",
                 target_entity_id=f"i{int(rng.integers(0, 20))}",
                 properties={"rating": float(rng.integers(1, 6))},
                 event_time=t0 + dt.timedelta(seconds=j))
           for j in range(600)]
    evs += [Event(event="$set", entity_type="item", entity_id=f"i{i}",
                  properties={"categories": [f"c{i % 3}"]}, event_time=t0)
            for i in range(20)]
    le = st.get_levents()
    le.init(aid)
    le.insert_batch(evs, aid)
    return st


@pytest.fixture
def stores(tmp_path):
    from predictionio_tpu.data import storage as jstorage
    from predictionio_tpu_torch.data import storage as tstorage

    configure("predictionio_tpu", tmp_path)
    configure("predictionio_tpu_torch", tmp_path)
    yield
    jstorage.reset()
    tstorage.reset()


def test_template_pipelined_read_trains_like_the_serial_read(stores):
    from predictionio_tpu.templates.recommendation import engine as jeng
    from predictionio_tpu_torch.core.context import ComputeContext
    from predictionio_tpu_torch.templates.recommendation import engine as teng

    def read(mod, pipelined):
        return mod.EventDataSource(mod.DataSourceParams(
            app_name="pipeapp", event_names=("rate", "view"),
            streaming_block_size=37, pipelined_ingest=pipelined,
            decode_prefetch=2, read_item_categories=True)).read_training(None)

    merges, parses = tcodec.merge_calls.value, tcodec.parse_calls.value
    td_p, td_s = read(teng, True), read(teng, False)
    assert tcodec.merge_calls.value == merges + 1    # the pipelined merge
    assert tcodec.parse_calls.value >= parses + 14   # 7 partitions, twice
    assert td_p.runs is None and td_s.runs is not None
    want = read(jeng, True)
    for col in ("rows", "cols", "values"):
        assert getattr(td_p, col).tobytes() == getattr(want, col).tobytes()
    assert labels(td_p.user_map) == labels(want.user_map)
    assert td_p.item_categories == want.item_categories
    assert set(td_p.timeline.summary()["stages"]) == {"decode", "index",
                                                      "merge"}
    assert set(td_s.timeline.summary()["stages"]) == {"decode", "index",
                                                      "finalize"}

    prep = teng.RatingsPreparator(teng.PreparatorParams(bucketed=True))
    pd_p, pd_s = prep.prepare(None, td_p), prep.prepare(None, td_s)
    assert side_bytes(pd_p.user_side) == side_bytes(pd_s.user_side)
    assert side_bytes(pd_p.item_side) == side_bytes(pd_s.item_side)
    jpd = jeng.RatingsPreparator(jeng.PreparatorParams(bucketed=True)) \
        .prepare(None, want)
    assert side_bytes(pd_p.user_side) == side_bytes(jpd.user_side)
    # the seen lists hold the same items; the pipelined read's in item
    # order, as the JAX package's
    assert {u: sorted(s.tolist()) for u, s in pd_p.seen.items()} == {
        u: sorted(s.tolist()) for u, s in pd_s.seen.items()}
    assert {u: s.tolist() for u, s in pd_p.seen.items()} == {
        u: s.tolist() for u, s in jpd.seen.items()}

    algo = teng.ALSAlgorithm(tals.ALSParams(rank=4, num_iterations=2,
                                            seed=3))
    ctx = ComputeContext(device="cpu")
    m_p, m_s = algo.train(ctx, pd_p), algo.train(ctx, pd_s)
    assert m_p.user_factors.tobytes() == m_s.user_factors.tobytes()
    assert m_p.item_factors.tobytes() == m_s.item_factors.tobytes()


def test_template_pipelined_without_streaming_raises_like_jax(stores):
    from predictionio_tpu.templates.recommendation import engine as jeng
    from predictionio_tpu_torch.templates.recommendation import engine as teng

    for mod in (jeng, teng):
        ds = mod.EventDataSource(mod.DataSourceParams(
            app_name="pipeapp", pipelined_ingest=True))
        with pytest.raises(ValueError, match="requires streaming_block_size"):
            ds.read_training(None)
