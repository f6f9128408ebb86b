"""The port's training ladder (``warmup_train_als_bucketed`` and the
programs it caches in ``ops/als.py``) against the JAX package's AOT
warm-up, on the CPU.

On the CPU a warmed program is its step bound to static buffers (the
capture waits for a card, where ``chip_smoke.py`` phases 5b-5d replay
the graphs), so every cache path runs here: the keys, the hits and
misses, the copies into the static carries, the eviction. Every input is
made with numpy from a seed. Tolerances, stated per test:

- a warmed training against a cold (eager) one of the port: bitwise, the
  factors and the objective samples;
- against JAX ``train_als_bucketed`` from one shared init (JAX's
  ``init_factors`` injected into the port's): 1e-3 of the largest factor
  in fp32, the JAX package's own trainer tolerance
  (``tests/test_torch_als_train.py``), and ``4 * iters * 2^-8``
  relative Frobenius in bf16 (``tests/test_torch_als_precision.py``);
- the keys' shape, dtype and statics part: equal to JAX
  ``_bucketed_aot_key`` once its device ids and its ``solver`` and
  ``num_iterations`` fields are dropped (the port has one solver, and a
  program is one iteration, replayed).
"""

import contextlib
import dataclasses
import logging
import threading
import time

import numpy as np
import pytest
import torch

from jax_native_ready import require_jax_native
from predictionio_tpu.ops import als as jals
from predictionio_tpu.ops import tuning as jt
from predictionio_tpu_torch.data import columnar as tcol
from predictionio_tpu_torch.ops import als as tals
from predictionio_tpu_torch.ops import als_cuda, aot
from predictionio_tpu_torch.ops import tuning as tt
from predictionio_tpu_torch.utils import metrics as tmetrics
from predictionio_tpu_torch.workflow import runlog
from predictionio_tpu_torch.workflow import tuning as twt

CPU = "cpu"
EPS_BF16 = 2.0 ** -8
DEAD_ALPHA = 1e38
CACHES = ("_aot_bucketed", "_aot_grid", "_aot_objective",
          "_aot_objective_grid")


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded(tmp_path_factory):
    """JAX's bucketing runs its native fill: loaded first
    (``jax_native_ready``), never compared against its fallback."""
    require_jax_native(tmp_path_factory.getbasetemp().parent)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Empty training caches, no checkpointing and telemetry on, around
    every test."""
    for name in ("PIO_CHECKPOINT_DIR", "PIO_CHECKPOINT_EVERY", "PIO_RESUME",
                 "PIO_TRAIN_TELEMETRY", "PIO_TRAIN_PRECISION"):
        monkeypatch.delenv(name, raising=False)
    for name in CACHES:
        getattr(tals, name).clear()
    yield
    for name in CACHES:
        getattr(tals, name).clear()


def triples(seed=0, n_u=70, n_i=45, nnz=700):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_u - 2, nnz)
    cols = rng.integers(0, n_i - 3, nnz)
    vals = (rng.integers(1, 11, nnz) * 0.5).astype(np.float32)
    return rows, cols, vals, n_u, n_i


def host_sides(pkg, seed=0, **kw):
    rows, cols, vals, n_u, n_i = triples(seed, **kw)
    return pkg.bucket_ratings_pair(rows, cols, vals, n_u, n_i)


def cpu_sides(seed=0, **kw):
    """The port's sides as CPU tensors: what a trainer on ``device="cpu"``
    reads, at fixed addresses."""
    us, its = host_sides(tals, seed, **kw)
    return us.to_device(CPU), its.to_device(CPU)


@contextlib.contextmanager
def counted_calls():
    """Counts of warmed-program calls and of eager iterations / objective
    packs made outside a program."""
    counts = {"program": 0, "eager_iterations": 0, "eager_objective": 0,
              "eager_grid": 0, "eager_grid_objective": 0}
    inside = threading.local()
    prog_call = tals._TrainProgram.__call__
    impls = {"eager_iterations": "_als_iterations_bucketed_impl",
             "eager_objective": "_objective_pack_impl",
             "eager_grid": "_als_iterations_grid_impl",
             "eager_grid_objective": "_objective_pack_grid_impl"}
    saved = {k: getattr(tals, v) for k, v in impls.items()}

    def call(self, *a, **k):
        counts["program"] += 1
        inside.on = True
        try:
            return prog_call(self, *a, **k)
        finally:
            inside.on = False

    def counting(name):
        fn = saved[name]

        def wrapped(*a, **k):
            if not getattr(inside, "on", False):
                counts[name] += 1
            return fn(*a, **k)
        return wrapped

    tals._TrainProgram.__call__ = call
    for name, attr in impls.items():
        setattr(tals, attr, counting(name))
    try:
        yield counts
    finally:
        tals._TrainProgram.__call__ = prog_call
        for name, attr in impls.items():
            setattr(tals, attr, saved[name])


def same_factors(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def project_port(key):
    leaves, statics = key
    return ([leaf[:2] for leaf in leaves], dict(statics))


def project_jax(key, drop=("solver", "num_iterations")):
    leaves, statics = key
    return ([leaf[:2] for leaf in leaves],
            {k: v for k, v in statics if k not in drop})


def jax_init(n_rows, n_cols, rank, seed, device=None):
    X, Y = jals.init_factors(n_rows, n_cols, rank, seed)
    return (torch.from_numpy(np.array(X)).to(device),
            torch.from_numpy(np.array(Y)).to(device))


def near(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def rel_frobenius(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


PARAM_CASES = {
    "fp32": dict(rank=6, num_iterations=3, lambda_=0.05, alpha=2.0, seed=3),
    "bf16": dict(rank=6, num_iterations=3, lambda_=0.05, alpha=2.0, seed=3,
                 precision="bf16"),
    "explicit": dict(rank=5, num_iterations=3, lambda_=0.1, seed=4,
                     implicit_prefs=False),
    "slot_budget": dict(rank=6, num_iterations=3, lambda_=0.05, seed=5,
                        bucket_slot_budget=64),
    "refine": dict(rank=6, num_iterations=3, lambda_=0.05, seed=6,
                   solve_refine=True),
}


# -- the caches ---------------------------------------------------------------

@pytest.mark.parametrize("name", CACHES)
def test_cache_names_and_sizes_equal_jax(name):
    port, ref = getattr(tals, name), getattr(jals, name)
    assert isinstance(port, aot.AOTCache)
    assert port.name == ref.name
    assert port.stats()["maxEntries"] == ref.stats()["maxEntries"] == 8


# -- the keys -----------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(PARAM_CASES))
def test_bucketed_key_equals_jax(case):
    """The warmed program's key (what the warm-up cached) against JAX
    ``_bucketed_aot_key(*_bucketed_call_args(..., abstract=True))``."""
    us, its = cpu_sides(1)
    params = tals.ALSParams(**PARAM_CASES[case])
    assert tals.warmup_train_als_bucketed(us, its, params, CPU) is True
    (key,) = tuple(tals._aot_bucketed.keys())
    jus, jits = host_sides(jals, 1)
    jparams = jals.ALSParams(**PARAM_CASES[case])
    jkey = jals._bucketed_aot_key(*jals._bucketed_call_args(
        jus, jits, jparams, jals._als_precision_mode(jparams),
        abstract=True))
    assert project_port(key) == project_jax(jkey)


def test_grid_key_equals_jax():
    us, its = cpu_sides(2)
    overrides = [{"lambda": 0.1}, {"lambda": 0.5, "rank": 3}, {"alpha": 4.0}]
    grid = tt.make_grid(tals.ALSParams(rank=5, num_iterations=2), overrides)
    jgrid = jt.make_grid(jals.ALSParams(rank=5, num_iterations=2), overrides)
    assert tals.warmup_train_als_bucketed(us, its, grid, CPU) is True
    (key,) = tuple(tals._aot_grid.keys())
    jus, jits = host_sides(jals, 2)
    jkey = jals._bucketed_aot_key(*jals._grid_call_args(
        jus, jits, jgrid.configs, "fp32", abstract=True))
    assert project_port(key) == project_jax(jkey)


@pytest.mark.parametrize("grid", [False, True])
def test_objective_keys_equal_jax(monkeypatch, tmp_path, grid):
    monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(tmp_path))
    us, its = cpu_sides(3)
    jus, jits = host_sides(jals, 3)
    if grid:
        overrides = [{"lambda": 0.1}, {"rank": 2, "alpha": 3.0}]
        params = tt.make_grid(tals.ALSParams(rank=4), overrides)
        jparams = jt.make_grid(jals.ALSParams(rank=4), overrides)
        cache = tals._aot_objective_grid
        jkey = jals._bucketed_aot_key(*jals._objective_call_args(
            jus, jits, jparams.configs[0], "fp32", configs=jparams.configs))
    else:
        params = tals.ALSParams(rank=4, lambda_=0.2, alpha=3.0)
        cache = tals._aot_objective
        jkey = jals._bucketed_aot_key(*jals._objective_call_args(
            jus, jits, jals.ALSParams(rank=4, lambda_=0.2, alpha=3.0),
            "fp32"))
    assert tals.warmup_train_als_bucketed(us, its, params, CPU) is True
    (key,) = tuple(cache.keys())
    assert project_port(key) == project_jax(jkey)


def test_key_holds_table_addresses_not_carry_addresses():
    us, its = cpu_sides(4)
    (_, _, u_t, i_t), kw = tals._bucketed_call_args(
        us, its, tals.ALSParams(rank=4), CPU)
    X, Y = torch.zeros(us.n_rows, 4), torch.zeros(its.n_rows, 4)
    key = tals._bucketed_aot_key((X, Y, u_t, i_t), kw)
    # other carries of the same shape: the same key
    assert tals._bucketed_aot_key((X.clone(), Y.clone(), u_t, i_t),
                                  kw) == key
    # the same tables copied elsewhere: another key
    moved = [tuple(t.clone() for t in b) for b in u_t]
    assert tals._bucketed_aot_key((X, Y, moved, i_t), kw) != key
    leaf = key[0][2]
    table = u_t[0][0]
    assert leaf == (tuple(table.shape), "int32", tuple(table.stride()),
                    table.device, table.data_ptr())
    assert key[0][0] == ((us.n_rows, 4), "float32", X.device)


def test_iteration_statics_name_the_precision():
    kw = dict(lam=0.1, alpha=1.0, implicit=True, slot_budget=None,
              refine=False)
    assert tals._iteration_statics(torch.zeros(2, 2), kw)["precision"] \
        == "fp32"
    assert tals._iteration_statics(
        torch.zeros(2, 2, dtype=torch.bfloat16), kw)["precision"] == "bf16"


# -- warm-up, then train ------------------------------------------------------

@pytest.mark.parametrize("case", sorted(PARAM_CASES))
def test_warmed_train_hits_and_equals_cold(case):
    us, its = cpu_sides(5)
    params = tals.ALSParams(**PARAM_CASES[case])
    cold = tals.train_als_bucketed(us, its, params, CPU)
    assert tals.warmup_train_als_bucketed(us, its, params, CPU) is True
    assert len(tals._aot_bucketed) == 1 and len(tals._aot_objective) == 0
    with counted_calls() as counts:
        warm = tals.train_als_bucketed(us, its, params, CPU)
    assert counts["program"] == 1 and counts["eager_iterations"] == 0
    assert same_factors(warm, cold)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_warmed_train_within_jax_tolerance(monkeypatch, precision):
    monkeypatch.setattr(tals, "init_factors", jax_init)
    kw = dict(rank=6, num_iterations=3, lambda_=0.05, seed=7,
              precision=precision)
    us, its = cpu_sides(6)
    params = tals.ALSParams(**kw)
    assert tals.warmup_train_als_bucketed(us, its, params, CPU)
    with counted_calls() as counts:
        got = tals.train_als_bucketed(us, its, params, CPU)
    assert counts["program"] == 1 and counts["eager_iterations"] == 0
    want = jals.train_als_bucketed(*host_sides(jals, 6),
                                   jals.ALSParams(**kw))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == np.float32 and g.shape == w.shape
        if precision == "fp32":
            near(g, w, 1e-3)
        else:
            assert rel_frobenius(g, w) <= 4 * 3 * EPS_BF16


def test_warmup_is_idempotent():
    us, its = cpu_sides(7)
    params = tals.ALSParams(rank=4)
    for _ in range(3):
        assert tals.warmup_train_als_bucketed(us, its, params, CPU)
    assert len(tals._aot_bucketed) == 1 and tals._aot_bucketed.evictions == 0


def test_host_sides_warm_on_the_cpu_at_their_own_addresses():
    """numpy sides: the CPU tensors over them share their memory, so the
    trainer's tables sit where the warm-up's did and the call hits."""
    us, its = host_sides(tals, 8)
    params = tals.ALSParams(rank=4, num_iterations=2)
    cold = tals.train_als_bucketed(us, its, params, CPU)
    assert tals.warmup_train_als_bucketed(us, its, params, CPU)
    with counted_calls() as counts:
        warm = tals.train_als_bucketed(us, its, params, CPU)
    assert counts["program"] == 1 and same_factors(warm, cold)


def test_other_tables_miss_and_still_answer_right():
    us, its = cpu_sides(9)
    params = tals.ALSParams(rank=4, num_iterations=2)
    assert tals.warmup_train_als_bucketed(us, its, params, CPU)
    # the same ratings at other addresses
    us2, its2 = (dataclasses.replace(s, buckets=[
        tals.RatingsBucket(*(t.clone() for t in (b.row_ids, b.cols,
                                                 b.weights, b.mask)))
        for b in s.buckets]) for s in (us, its))
    with counted_calls() as counts:
        got = tals.train_als_bucketed(us2, its2, params, CPU)
    assert counts["program"] == 0 and counts["eager_iterations"] == 1
    assert same_factors(got, tals.train_als_bucketed(us, its, params, CPU))
    # other ratings of the same shapes: a miss, and their own answer
    other = cpu_sides(10)
    with counted_calls() as counts:
        got = tals.train_als_bucketed(*other, params, CPU)
    assert counts["program"] == 0
    tals._aot_bucketed.clear()
    assert same_factors(got, tals.train_als_bucketed(*other, params, CPU))


def test_other_statics_miss():
    us, its = cpu_sides(11)
    assert tals.warmup_train_als_bucketed(us, its,
                                          tals.ALSParams(rank=4), CPU)
    for other in (dict(rank=4, lambda_=0.5), dict(rank=4, alpha=3.0),
                  dict(rank=3), dict(rank=4, implicit_prefs=False),
                  dict(rank=4, solve_refine=True),
                  dict(rank=4, precision="bf16")):
        with counted_calls() as counts:
            tals.train_als_bucketed(us, its, tals.ALSParams(**other), CPU)
        assert counts["program"] == 0, other


def test_ninth_signature_evicts_the_first(caplog):
    us, its = cpu_sides(12)
    before = tmetrics.AOT_CACHE_EVICTIONS.value()
    keys = []
    with caplog.at_level(logging.WARNING, logger="pio.aot"):
        for i in range(9):
            params = tals.ALSParams(rank=3, lambda_=0.01 * (i + 1))
            assert tals.warmup_train_als_bucketed(us, its, params, CPU)
            keys.append(tuple(tals._aot_bucketed.keys())[-1])
    assert len(tals._aot_bucketed) == 8
    assert tals._aot_bucketed.evictions == 1
    assert keys[0] not in tals._aot_bucketed
    assert all(k in tals._aot_bucketed for k in keys[1:])
    assert tmetrics.AOT_CACHE_EVICTIONS.value() == before + 1
    assert any("train-bucketed cache full" in r.message
               for r in caplog.records)
    # the evicted signature trains eagerly, the others hit
    with counted_calls() as counts:
        tals.train_als_bucketed(us, its, tals.ALSParams(rank=3,
                                                        lambda_=0.01), CPU)
        tals.train_als_bucketed(us, its, tals.ALSParams(rank=3,
                                                        lambda_=0.09), CPU)
    assert counts["program"] == 1 and counts["eager_iterations"] == 1


def test_memory_report_counts_the_static_buffers():
    us, its = cpu_sides(13)
    assert tals.warmup_train_als_bucketed(us, its, tals.ALSParams(rank=4),
                                          CPU)
    rep = tals._aot_bucketed.memory_report()
    assert rep["entries"] == rep["entriesAnalyzed"] == 1
    assert rep["totalBytes"] == 4 * 4 * (us.n_rows + its.n_rows)


# -- the program's carries ----------------------------------------------------

def warmed_program(seed=14, rank=4):
    us, its = cpu_sides(seed)
    params = tals.ALSParams(rank=rank, num_iterations=2)
    assert tals.warmup_train_als_bucketed(us, its, params, CPU)
    (_, _, u_t, i_t), kw = tals._bucketed_call_args(us, its, params, CPU)
    X, Y = tals.init_factors(us.n_rows, its.n_rows, rank, 1, CPU)
    (prog,) = [tals._aot_bucketed.get(k) for k in tals._aot_bucketed.keys()]
    return prog, X, Y, u_t, i_t, kw


def test_a_hit_returns_the_static_carries_and_chains_them():
    prog, X, Y, u_t, i_t, kw = warmed_program()
    X0, Y0 = X.clone(), Y.clone()
    X2, Y2 = tals.als_iterations_bucketed(X, Y, u_t, i_t, num_iterations=2,
                                          **kw)
    assert X2 is prog.carries[0] and Y2 is prog.carries[1]
    assert torch.equal(X, X0) and torch.equal(Y, Y0)    # inputs untouched
    want = tals._als_iterations_bucketed_impl(X, Y, u_t, i_t,
                                              num_iterations=3, **kw)
    # the carries handed back in: nothing copied, one more iteration
    X3, Y3 = tals.als_iterations_bucketed(X2, Y2, u_t, i_t,
                                          num_iterations=1, **kw)
    assert X3 is X2
    assert torch.equal(X3, want[0]) and torch.equal(Y3, want[1])


def test_zero_iterations_return_the_inputs():
    prog, X, Y, u_t, i_t, kw = warmed_program(15)
    got = tals.als_iterations_bucketed(X, Y, u_t, i_t, num_iterations=0,
                                       **kw)
    assert got[0] is X and got[1] is Y


def test_programs_keep_no_tables():
    prog, X, Y, u_t, i_t, kw = warmed_program(16)
    assert prog._tables == [()]
    assert all(isinstance(t, torch.Tensor) for t in prog.carries)
    assert len(prog.carries) == 2


# -- checkpoints and the objective --------------------------------------------

def run_log_samples(directory):
    (run,) = runlog.list_runs(str(directory))
    return [(s["step"], s["loss"]["fit"], s["loss"]["l2"])
            for s in runlog.read_run(run["path"])["samples"]]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_checkpointed_run_one_program_for_every_chunk(monkeypatch, tmp_path,
                                                      precision):
    """6 iterations at ``PIO_CHECKPOINT_EVERY=4``: chunks of 4 and 2, one
    program for both (JAX lowers one per trip count), the objective
    sampled from its own program; factors and samples equal a cold
    run's."""
    us, its = cpu_sides(17)
    params = tals.ALSParams(rank=4, num_iterations=6, seed=2,
                            precision=precision)
    monkeypatch.setenv("PIO_CHECKPOINT_EVERY", "4")
    monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(tmp_path / "cold"))
    cold = tals.train_als_bucketed(us, its, params, CPU)
    monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(tmp_path / "warm"))
    assert tals.warmup_train_als_bucketed(us, its, params, CPU)
    assert (len(tals._aot_bucketed), len(tals._aot_objective)) == (1, 1)
    with counted_calls() as counts:
        warm = tals.train_als_bucketed(us, its, params, CPU)
    assert counts["program"] == 4     # 2 chunks, 2 samples
    assert counts["eager_iterations"] == counts["eager_objective"] == 0
    assert same_factors(warm, cold)
    samples = run_log_samples(tmp_path / "warm")
    assert [s[0] for s in samples] == [4, 6]
    assert samples == run_log_samples(tmp_path / "cold")


@pytest.mark.parametrize("checkpoints,telemetry", [(False, True),
                                                   (True, False)])
def test_serial_objective_needs_checkpoints_and_telemetry(
        monkeypatch, tmp_path, checkpoints, telemetry):
    if checkpoints:
        monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(tmp_path))
    if not telemetry:
        monkeypatch.setenv("PIO_TRAIN_TELEMETRY", "0")
    us, its = cpu_sides(18)
    assert tals.warmup_train_als_bucketed(us, its, tals.ALSParams(rank=3),
                                          CPU)
    assert (len(tals._aot_bucketed), len(tals._aot_objective)) == (1, 0)


def test_objective_program_equals_the_eager_pack(monkeypatch, tmp_path):
    monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(tmp_path))
    us, its = cpu_sides(19)
    params = tals.ALSParams(rank=4, lambda_=0.3, alpha=2.0)
    assert tals.warmup_train_als_bucketed(us, its, params, CPU)
    (_, _, u_t), okw = tals._objective_call_args(us, its, params, CPU)
    X, Y = tals.init_factors(us.n_rows, its.n_rows, 4, 3, CPU)
    with counted_calls() as counts:
        got = tals._objective_pack(X, Y, u_t, **okw).clone()
    assert counts["program"] == 1 and counts["eager_objective"] == 0
    assert torch.equal(got, tals._objective_pack_impl(X, Y, u_t, **okw))


@pytest.mark.parametrize("implicit", [True, False])
def test_grid_objective_indexes_lam_on_the_device_bitwise(implicit):
    """Each config's pack with ``lam`` / ``alpha`` indexed as 0-d
    tensors equals the pack with them read to the host as floats (the
    objective before the ladder), bit for bit."""
    us, its = cpu_sides(20)
    u_t = tals._device_tables(us, torch.device(CPU))
    rng = np.random.default_rng(20)
    k, R = 3, 4
    X = torch.from_numpy(rng.standard_normal((k, us.n_rows, R))
                         .astype(np.float32))
    Y = torch.from_numpy(rng.standard_normal((k, its.n_rows, R))
                         .astype(np.float32))
    lam = torch.tensor([0.013, 0.7, 3.1], dtype=torch.float32)
    alpha = torch.tensor([1.0, 17.3, 0.21], dtype=torch.float32)
    got = tals._objective_pack_grid(X, Y, lam, alpha, u_t, implicit=implicit)
    want = torch.stack([tals._objective_pack_impl(
        X[z], Y[z], u_t, lam=float(lam[z]), alpha=float(alpha[z]),
        implicit=implicit) for z in range(k)])
    assert torch.equal(got, want)
    # sequences of floats take the same values
    assert torch.equal(tals._objective_pack_grid(
        X, Y, lam.tolist(), alpha.tolist(), u_t, implicit=implicit), want)


# -- the grid -----------------------------------------------------------------

def serial_run(us, its, grid, i):
    """Config ``i`` of ``grid`` trained alone: the bitwise reference of
    its lane at full rank."""
    cfg = grid.configs[i]
    return tals.train_als_bucketed(us, its, cfg, CPU)


def test_grid_batches_of_one_size_share_a_program():
    us, its = cpu_sides(21)
    base = tals.ALSParams(rank=4, num_iterations=2)
    a = tt.make_grid(base, [{"lambda": 0.1}, {"lambda": 0.2}])
    b = tt.make_grid(base, [{"lambda": 0.7}, {"lambda": 1.3}])
    c = tt.make_grid(base, [{"lambda": 0.1}, {"lambda": 0.2},
                            {"lambda": 0.3}])
    colds = {name: tt.train_als_grid_bucketed(us, its, g, CPU)
             for name, g in (("a", a), ("b", b), ("c", c))}
    assert tals.warmup_train_als_bucketed(us, its, a, CPU)
    assert tals.warmup_train_als_bucketed(us, its, b, CPU)
    assert (len(tals._aot_grid), len(tals._aot_objective_grid)) == (1, 1)
    for name, g in (("a", a), ("b", b)):
        with counted_calls() as counts:
            got = tt.train_als_grid_bucketed(us, its, g, CPU)
        assert counts["program"] == 2 and counts["eager_grid"] == 0
        assert np.array_equal(got.user_factors, colds[name].user_factors)
        assert np.array_equal(got.item_factors, colds[name].item_factors)
        assert got.loss_history == colds[name].loss_history
        for i in range(g.k):
            assert same_factors(got.factors_for(i), serial_run(us, its, g, i))
    # a batch of another size misses, and still answers right
    with counted_calls() as counts:
        got = tt.train_als_grid_bucketed(us, its, c, CPU)
    assert counts["program"] == 0 and counts["eager_grid"] == 1
    assert np.array_equal(got.user_factors, colds["c"].user_factors)


def test_grid_with_a_dead_lane_masks_into_the_next_replay(monkeypatch,
                                                          tmp_path):
    """Checkpointed every iteration, the dead config's zeroed lanes are
    copied into the program before each replay: warmed equals cold."""
    us, its = cpu_sides(22)
    grid = tt.make_grid(tals.ALSParams(rank=4, num_iterations=3),
                        [{"lambda": 0.1}, {"alpha": DEAD_ALPHA},
                         {"rank": 2}])
    monkeypatch.setenv("PIO_CHECKPOINT_EVERY", "1")
    monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(tmp_path / "cold"))
    cold = tt.train_als_grid_bucketed(us, its, grid, CPU)
    monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(tmp_path / "warm"))
    assert tals.warmup_train_als_bucketed(us, its, grid, CPU)
    with counted_calls() as counts:
        warm = tt.train_als_grid_bucketed(us, its, grid, CPU)
    assert counts["eager_grid"] == counts["eager_grid_objective"] == 0
    assert counts["program"] == 6
    assert warm.alive.tolist() == cold.alive.tolist() == [True, False, True]
    assert np.array_equal(warm.user_factors, cold.user_factors)
    assert np.array_equal(warm.item_factors, cold.item_factors)
    assert warm.loss_history == cold.loss_history
    assert not warm.user_factors[1].any()


def test_grid_objective_needs_telemetry(monkeypatch):
    monkeypatch.setenv("PIO_TRAIN_TELEMETRY", "0")
    us, its = cpu_sides(23)
    grid = tt.make_grid(tals.ALSParams(rank=3), [{"lambda": 0.1},
                                                 {"lambda": 0.2}])
    assert tals.warmup_train_als_bucketed(us, its, grid, CPU)
    assert (len(tals._aot_grid), len(tals._aot_objective_grid)) == (1, 0)


def test_run_grid_puts_the_sides_on_the_device_once(monkeypatch):
    """Three configs in batches of two and one: the tables go to the
    device once and every batch trains on that copy; the warm-up prepares
    the kernels once and captures no batch (each trains eagerly, inside
    the memory plan), and the leaderboard equals the cold sweep's."""
    rows, cols, vals, n_u, n_i = triples(24)
    us, its = tals.bucket_ratings_pair(rows, cols, vals, n_u, n_i)
    grid = tt.make_grid(tals.ALSParams(rank=3, num_iterations=2),
                        [{"lambda": 0.1}, {"lambda": 0.3}, {"lambda": 0.9}])
    held = {int(u): {int(cols[j])} for j, u in enumerate(rows[:30])}
    per = twt.grid_bytes_per_config(n_u, n_i, grid, us, its)
    kw = dict(train_rows=rows, train_cols=cols, held=held, topk=3,
              budget_bytes=2 * per, device=CPU)
    cold = twt.run_grid(us, its, grid, warmup=False, **kw)
    moves, prepared = [], []
    to_device = tals.BucketedRatings.to_device

    def counting(self, device=None):
        out = to_device(self, device)
        moves.append(out is self)
        return out

    monkeypatch.setattr(tals.BucketedRatings, "to_device", counting)
    monkeypatch.setattr(tals, "prepare_training_kernels",
                        lambda device=None: prepared.append(device))
    monkeypatch.setattr(tals, "warmup_train_als_bucketed",
                        lambda *a, **k: pytest.fail("run_grid captured"))
    with counted_calls() as counts:
        warm = twt.run_grid(us, its, grid, warmup=True, **kw)
    assert warm["batches"] == cold["batches"] == [2, 1]
    assert warm["rows"] == cold["rows"]
    assert prepared == [CPU] and len(tals._aot_grid) == 0
    assert counts["program"] == 0 and counts["eager_grid"] == 2
    # two host sides copied once each; every later move found them there
    assert moves[:2] == [False, False] and all(moves[2:])


def test_clear_training_programs_drops_every_program(monkeypatch, tmp_path):
    """``clear_training_programs`` empties the four caches, after which a
    training on the warmed sides runs eagerly."""
    monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(tmp_path))
    us, its = cpu_sides(29)
    params = tals.ALSParams(rank=3, num_iterations=2, seed=2)
    grid = tt.make_grid(params, [{"lambda": 0.1}, {"lambda": 0.2}])
    assert tals.warmup_train_als_bucketed(us, its, params, CPU)
    assert tals.warmup_train_als_bucketed(us, its, grid, CPU)
    assert [len(getattr(tals, n)) for n in CACHES] == [1, 1, 1, 1]
    tals.clear_training_programs()
    assert [len(getattr(tals, n)) for n in CACHES] == [0, 0, 0, 0]
    monkeypatch.delenv("PIO_CHECKPOINT_DIR")
    with counted_calls() as counts:
        tals.train_als_bucketed(us, its, params, CPU)
    assert counts["program"] == 0 and counts["eager_iterations"] == 1


def test_prepare_training_kernels_builds_and_captures_nothing(monkeypatch):
    """On a CUDA device it builds both libraries and sets each up, and
    caches no program; on the CPU it does nothing."""
    from predictionio_tpu_torch.ops import _build

    assert tals.prepare_training_kernels(CPU) == torch.device(CPU)
    done = []
    monkeypatch.setattr(tals, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))
    monkeypatch.setattr(_build, "build_libraries",
                        lambda names: done.append(tuple(names)))
    monkeypatch.setattr(als_cuda, "_kernel", lambda i: done.append(i))
    monkeypatch.setattr(als_cuda, "_solve_kernels", lambda i: done.append(i))
    assert tals.prepare_training_kernels(None) == torch.device("cuda", 0)
    assert done == [als_cuda.KERNEL_NAMES, 0, 0]
    assert [len(getattr(tals, n)) for n in CACHES] == [0, 0, 0, 0]


# -- the pipelined ingest's warm-up -------------------------------------------

def power_law_blocks(n=1200, n_users=60, n_items=35, seed=25, size=200):
    rng = np.random.default_rng(seed)
    users = rng.choice(n_users, size=n,
                       p=(p := 1.0 / np.arange(1, n_users + 1)) / p.sum())
    items = rng.choice(n_items, size=n,
                       p=(q := 1.0 / np.arange(1, n_items + 1)) / q.sum())
    vals = rng.integers(1, 6, size=n).astype(np.float32)
    ents = np.asarray([f"u{u}" for u in users], dtype=object)
    tgts = np.asarray([f"i{i}" for i in items], dtype=object)
    for i in range(0, n, size):
        yield tcol.ColumnarEvents(entity_ids=ents[i:i + size],
                                  target_ids=tgts[i:i + size],
                                  values=vals[i:i + size],
                                  event_times=np.zeros(len(ents[i:i + size])))


@pytest.mark.parametrize("stage_device", [True, False])
def test_pipelined_ingest_warmup_then_train_hits(stage_device):
    params = tals.ALSParams(rank=4, num_iterations=2, seed=1)
    res = tcol.ingest_ratings_pipelined(power_law_blocks(),
                                        stage_device=stage_device,
                                        device=CPU, warmup_params=params)
    res.wait()
    assert len(tals._aot_bucketed) == 1
    with counted_calls() as counts:
        warm = tals.train_als_bucketed(res.user_side, res.item_side, params,
                                       CPU)
    assert counts["program"] == 1 and counts["eager_iterations"] == 0
    tals._aot_bucketed.clear()
    cold = tals.train_als_bucketed(res.user_side, res.item_side, params, CPU)
    assert same_factors(warm, cold)
    assert "warmup_compile" in res.timeline.summary()["stages"]


@pytest.mark.parametrize("join", ["wait", "join_warmup"])
def test_pipelined_ingest_warmup_failure_raises_at_join(monkeypatch, join):
    """A warm-up that fails on the background thread (a capture the card
    refused) raises where the warm-up is joined, once; the tables stay
    usable and the training runs eagerly."""
    def refuse(*args, **kwargs):
        raise RuntimeError("capture refused")

    monkeypatch.setattr(tals, "warmup_train_als_bucketed", refuse)
    params = tals.ALSParams(rank=4, num_iterations=2, seed=1)
    res = tcol.ingest_ratings_pipelined(power_law_blocks(), device=CPU,
                                        warmup_params=params)
    with pytest.raises(RuntimeError, match="capture refused"):
        getattr(res, join)()
    res.join_warmup()
    with counted_calls() as counts:
        tals.train_als_bucketed(res.user_side, res.item_side, params, CPU)
    assert counts["program"] == 0 and counts["eager_iterations"] == 1


# -- the card's paths, as far as the CPU reaches them -------------------------

def test_host_sides_on_the_card_decline(monkeypatch, caplog):
    """On a CUDA device the warm-up builds and sets up, then, finding the
    tables on the host, captures nothing and returns False."""
    from predictionio_tpu_torch.ops import _build

    done = []
    monkeypatch.setattr(tals, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))
    monkeypatch.setattr(_build, "build_libraries",
                        lambda names: done.append(tuple(names)))
    monkeypatch.setattr(als_cuda, "_kernel", lambda i: done.append(i))
    monkeypatch.setattr(als_cuda, "_solve_kernels", lambda i: done.append(i))
    us, its = host_sides(tals, 26)
    with caplog.at_level(logging.INFO, logger="pio.als"):
        ok = tals.warmup_train_als_bucketed(us, its, tals.ALSParams(), None)
    assert ok is False and len(tals._aot_bucketed) == 0
    assert done == [als_cuda.KERNEL_NAMES, 0, 0]
    assert any("on the host" in r.message for r in caplog.records)


def test_capture_records_training_launches_and_replays_count_them():
    counters = (als_cuda.assemble_launches, als_cuda.spd_launches,
                als_cuda.launches, als_cuda.graph_launches)
    before = [c.value for c in counters]
    with als_cuda.recording_launches() as records:
        als_cuda._count("assemble_launches", ("tiles", "fp32"))
        als_cuda._count("spd_launches")
        als_cuda._count("assemble_launches", ("tiles_grid", "bf16"))
    assert [c.value for c in counters] == before      # recorded only
    assert records == [("assemble_launches", ("tiles", "fp32")),
                       ("spd_launches", None),
                       ("assemble_launches", ("tiles_grid", "bf16"))]
    route = als_cuda.last_route()
    for _ in range(3):
        als_cuda.note_replay(records)
    after = [c.value - b for c, b in zip(counters, before)]
    assert after == [6, 3, 0, 9]
    assert als_cuda.last_route() == route   # no serving launch replayed
    assert als_cuda.graph_launches.by_key()[("spd_launches", None)] >= 3
    # outside a capture the same call counts at once
    als_cuda._count("spd_launches")
    assert als_cuda.spd_launches.value - before[1] == 4


def test_replays_of_serving_launches_keep_the_route():
    with als_cuda.recording_launches() as records:
        als_cuda._count("launches", ("chunked", 16, 1))
    als_cuda.note_replay(records)
    assert als_cuda.last_route() == "chunked"


@pytest.mark.parametrize("case", ["unready", "events"])
def test_capture_refuses_what_a_graph_cannot_hold(case):
    ready = {0: (208, 0)}
    with als_cuda.recording_launches():
        if case == "unready":
            with pytest.raises(RuntimeError, match="not set up on cuda:1"):
                als_cuda._check_capture("als_solve", ready, 1, None)
        else:
            with pytest.raises(ValueError, match="no timing events"):
                als_cuda._check_capture("als_solve", ready, 0, (1, 2))
        als_cuda._check_capture("als_solve", ready, 0, None)
    # outside a capture nothing is refused
    als_cuda._check_capture("als_solve", {}, 1, (1, 2))


def test_shared_pool_runs_one_block_at_a_time():
    pool = aot.train_pool(torch.device(CPU))
    assert pool is aot.train_pool(torch.device(CPU))
    assert pool.handle is None and pool.nbytes() == 0
    inside, overlaps = [0], []

    def work():
        for _ in range(50):
            with pool.ordered():
                inside[0] += 1
                overlaps.append(inside[0])
                time.sleep(0.0002)
                inside[0] -= 1

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(overlaps) == 200 and set(overlaps) == {1}


def test_warmup_awaits_copies_in_flight_on_the_device(monkeypatch):
    """On the card, with copies still in flight, the warm-up's stream
    waits on each side's copy event (the host never waits), the sides
    keep their staging for the trainer's own wait, and the programs are
    captured on the sides' own tables."""
    waits, warmed = [], []

    class Stream:
        def wait_event(self, event):
            waits.append(event)

    class Event:
        def synchronize(self):
            raise AssertionError("the host waited on a copy")

    dev = torch.device("cuda", 0)
    monkeypatch.setattr(tals, "prepare_training_kernels",
                        lambda device=None: dev)
    monkeypatch.setattr(tals, "_device_resident", lambda side, d: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(tals, "_warm_serial",
                        lambda u, i, p, d: warmed.append((u, i, d)))
    us, its = cpu_sides(28)
    events = [Event(), Event()]
    for side, event in zip((us, its), events):
        side.staging = tals.Staging(event=event, stream=Stream(),
                                    pin_seconds=0.0, nbytes=0, tensors=[],
                                    host=[])
    assert tals.warmup_train_als_bucketed(us, its, tals.ALSParams(rank=3),
                                          None)
    assert waits == events
    assert us.staging is not None and its.staging is not None
    ((u, i, d),) = warmed
    assert d == dev and u.staging is None and i.staging is None
    for got, side in ((u, us), (i, its)):
        assert all(g.cols is w.cols and g.weights is w.weights
                   for g, w in zip(got.buckets, side.buckets))
