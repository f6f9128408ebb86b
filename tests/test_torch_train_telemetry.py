"""The port's training telemetry (the objective sample, the run log and
``pio runs``) against the JAX package, on the CPU.

- The objective pack ``[fit, l2, finite]`` of the same factors and
  tables equals JAX ``training_objective`` to rtol 1e-5 (fp32 sums in
  another order over a few hundred entries), for the implicit and the
  explicit objective; bucketed tables give the uniform tables' value to
  the same rtol; non-finite factors are flagged.
- Telemetry on or off, the trained factors are bitwise equal: the
  objective reads the carries only.
- The run log survives crashes: a resume appends to the same run, a
  torn tail and phantom samples past the resumed step are dropped.
- ``pio runs list|show|compare`` of the port prints what the JAX
  package's prints for the same run-log directory, byte for byte.
"""

import os

import numpy as np
import pytest
import torch

from predictionio_tpu.ops import als as jals
from predictionio_tpu.tools import cli as jcli
from predictionio_tpu_torch.ops import als as tals
from predictionio_tpu_torch.tools import cli as tcli
from predictionio_tpu_torch.workflow import checkpoint, runlog
from predictionio_tpu_torch.workflow.checkpoint import TrainingPreempted

CPU = "cpu"
PARAMS = dict(rank=4, num_iterations=6, seed=3)


def make_triples(seed=0, n_u=50, n_i=30, nnz=400):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_u, nnz)
    cols = rng.integers(0, n_i, nnz)
    vals = (rng.normal(size=nnz) * 1.5 + 1.0).astype(np.float32)
    return rows, cols, vals, n_u, n_i


def sides(pkg, layout, seed=0):
    rows, cols, vals, n_u, n_i = make_triples(seed)
    if layout == "uniform":
        return (pkg.pad_ratings(rows, cols, vals, n_u, n_i),
                pkg.pad_ratings(cols, rows, vals, n_i, n_u))
    return pkg.bucket_ratings_pair(rows, cols, vals, n_u, n_i)


def factors(seed=1, n_u=50, n_i=30, R=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_u, R)).astype(np.float32),
            rng.normal(size=(n_i, R)).astype(np.float32))


@pytest.fixture
def ckpt_env(tmp_path, monkeypatch):
    d = tmp_path / "ckpts"
    monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(d))
    monkeypatch.setenv("PIO_CHECKPOINT_EVERY", "2")
    for var in ("PIO_RESUME", "PIO_CHECKPOINT_KEEP", "PIO_ALS_PRECISION",
                "PIO_TRAIN_TELEMETRY"):
        monkeypatch.delenv(var, raising=False)
    checkpoint.clear_stop()
    yield d
    checkpoint.clear_stop()


def train(params=None, layout="uniform", seed=0):
    params = params or tals.ALSParams(**PARAMS)
    fn = tals.train_als if layout == "uniform" else tals.train_als_bucketed
    return fn(*sides(tals, layout, seed), params, CPU)


def one_run(d):
    runs = runlog.list_runs(str(d))
    assert len(runs) == 1, runs
    return runlog.read_run(runs[0]["path"])


class TestObjective:
    @pytest.mark.parametrize("layout", ["uniform", "bucketed"])
    @pytest.mark.parametrize("implicit", [True, False])
    def test_against_jax(self, layout, implicit):
        X, Y = factors()
        kw = dict(rank=4, lambda_=0.07, alpha=0.6, implicit_prefs=implicit)
        got = tals.training_objective(X, Y, sides(tals, layout)[0],
                                      tals.ALSParams(**kw), device=CPU)
        want = jals.training_objective(X, Y, sides(jals, layout)[0],
                                       jals.ALSParams(**kw))
        assert got["finite"] is want["finite"] is True
        for key in ("fit", "l2", "total"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5)

    @pytest.mark.parametrize("implicit", [True, False])
    def test_bucketed_equals_uniform(self, implicit):
        X, Y = factors(2)
        params = tals.ALSParams(rank=4, lambda_=0.1, implicit_prefs=implicit)
        u = tals.training_objective(X, Y, sides(tals, "uniform")[0], params,
                                    device=CPU)
        b = tals.training_objective(torch.from_numpy(X), torch.from_numpy(Y),
                                    sides(tals, "bucketed")[0], params)
        for key in ("fit", "l2", "total"):
            np.testing.assert_allclose(b[key], u[key], rtol=1e-5)

    def test_bf16_factors_widen_once(self):
        X, Y = factors(3)
        params = tals.ALSParams(rank=4)
        Xb = torch.from_numpy(X).to(torch.bfloat16)
        Yb = torch.from_numpy(Y).to(torch.bfloat16)
        got = tals.training_objective(Xb, Yb, sides(tals, "uniform")[0],
                                      params)
        want = tals.training_objective(Xb.float(), Yb.float(),
                                       sides(tals, "uniform")[0], params)
        assert got == want

    @pytest.mark.parametrize("where", ["X", "Y"])
    def test_nonfinite_flagged(self, where):
        X, Y = factors(4)
        (X if where == "X" else Y)[3, 1] = np.inf
        got = tals.training_objective(X, Y, sides(tals, "uniform")[0],
                                      tals.ALSParams(rank=4), device=CPU)
        assert got["finite"] is False

    def test_pack_reads_the_carries_only(self):
        X, Y = (torch.from_numpy(a) for a in factors(5))
        X0, Y0 = X.clone(), Y.clone()
        us = sides(tals, "bucketed")[0]
        tables = [tuple(torch.as_tensor(a) for a in
                        (b.row_ids, b.cols, b.weights, b.mask))
                  for b in us.buckets]
        tals._objective_pack(X, Y, tables, lam=0.1, alpha=1.0, implicit=True)
        assert torch.equal(X, X0) and torch.equal(Y, Y0)


class TestObserverPurity:
    @pytest.mark.parametrize("layout,precision", [
        ("uniform", "fp32"), ("bucketed", "fp32"), ("uniform", "bf16")])
    def test_on_off_bitwise(self, ckpt_env, monkeypatch, layout, precision):
        params = tals.ALSParams(**PARAMS, precision=precision)
        monkeypatch.setenv("PIO_TRAIN_TELEMETRY", "0")
        X0, Y0 = train(params, layout)
        assert runlog.list_runs(str(ckpt_env)) == []   # nothing written
        monkeypatch.setenv("PIO_TRAIN_TELEMETRY", "1")
        X1, Y1 = train(params, layout)
        assert np.array_equal(X0, X1) and np.array_equal(Y0, Y1)
        samples = one_run(ckpt_env)["samples"]
        assert [s["step"] for s in samples] == [2, 4, 6]
        assert all(s["hbmBytesInUse"] is None for s in samples)  # the CPU
        assert all(s["checkpointBytes"] > 0 for s in samples)

    def test_loss_is_non_increasing(self, ckpt_env, monkeypatch):
        monkeypatch.setenv("PIO_CHECKPOINT_EVERY", "1")
        train(seed=9)
        totals = [runlog._loss_total(s)
                  for s in one_run(ckpt_env)["samples"]]
        assert len(totals) == 6
        # each half-step minimizes its side exactly
        for a, b in zip(totals, totals[1:]):
            assert b <= a * (1 + 1e-3) + 1e-6
        assert totals[-1] < totals[0]


def preempt(params=None):
    checkpoint.request_stop()
    try:
        with pytest.raises(TrainingPreempted):
            train(params)
    finally:
        checkpoint.clear_stop()


class TestRunLogCrashSafety:
    def test_resume_continues_the_same_run(self, ckpt_env, monkeypatch):
        with runlog.run_context_scope(template="recommendation", nUsers=50):
            preempt()
        first = one_run(ckpt_env)
        assert [s["step"] for s in first["samples"]] == [2]
        assert first["header"]["context"] == {"template": "recommendation",
                                              "nUsers": 50}
        monkeypatch.setenv("PIO_RESUME", "1")
        train()
        run = one_run(ckpt_env)
        assert run["runId"] == first["runId"]
        assert [s["step"] for s in run["samples"]] == [2, 4, 6]

    def test_torn_tail_repaired_on_resume(self, ckpt_env, monkeypatch):
        preempt()
        run = one_run(ckpt_env)
        path = runlog.run_path(str(ckpt_env), run["runId"])
        with open(path, "ab") as f:
            f.write(b'{"type":"sample","runId":"x","step":99')
        monkeypatch.setenv("PIO_RESUME", "1")
        train()
        raw = open(path, "rb").read()
        assert raw.endswith(b"\n") and b'"step":99' not in raw
        assert [s["step"] for s in one_run(ckpt_env)["samples"]] == [2, 4, 6]

    def test_phantom_future_sample_dropped_on_resume(self, ckpt_env,
                                                     monkeypatch):
        preempt()
        run = one_run(ckpt_env)
        rl = runlog.RunLog(runlog.run_path(str(ckpt_env), run["runId"]),
                           run["runId"])
        rl.append({"step": 4, "totalIterations": 6,
                   "loss": {"fit": 1.0, "l2": 1.0, "total": 2.0}})
        rl.close()
        monkeypatch.setenv("PIO_RESUME", "1")
        train()
        assert [s["step"] for s in one_run(ckpt_env)["samples"]] == [2, 4, 6]

    def test_reader_tolerates_a_torn_tail(self, ckpt_env):
        train()
        run = one_run(ckpt_env)
        with open(runlog.run_path(str(ckpt_env), run["runId"]), "ab") as f:
            f.write(b'{"type":"sample","st')
        assert [s["step"] for s in one_run(ckpt_env)["samples"]] == [2, 4, 6]
        assert runlog.list_runs(str(ckpt_env))[0]["lastStep"] == 6

    def test_device_memory_reading(self):
        assert runlog.hbm_bytes_in_use(None) is None
        assert runlog.hbm_bytes_in_use(torch.device("cpu")) is None


def both(argv, capsys):
    """(rc, stdout, stderr) of the JAX console, then of the port's."""
    out = []
    for cli in (jcli, tcli):
        rc = cli.main(argv)
        o = capsys.readouterr()
        out.append((rc, o.out, o.err))
    return out


class TestRunsCli:
    @pytest.fixture
    def runs(self, ckpt_env, monkeypatch):
        """A preempted-then-resumed bf16 run and a clean run."""
        with runlog.run_context_scope(template="recommendation", nUsers=50,
                                      nItems=30):
            preempt(tals.ALSParams(**PARAMS, precision="bf16"))
            monkeypatch.setenv("PIO_RESUME", "1")
            train(tals.ALSParams(**PARAMS, precision="bf16"))
            monkeypatch.delenv("PIO_RESUME")
            train()
        ids = [r["runId"] for r in runlog.list_runs(str(ckpt_env))]
        assert len(ids) == 2
        return str(ckpt_env), ids

    def test_list_show_compare_equal_jax(self, runs, capsys):
        d, (a, b) = runs
        for argv in (["runs", "list", "--dir", d],
                     ["runs", "list", "--dir", d, "-n", "1"],
                     ["runs", "show", a, "--dir", d],
                     ["runs", "show", b[:-4], "--dir", d],
                     ["runs", "compare", a, b, "--dir", d],
                     ["runs", "list"]):
            (jrc, jout, jerr), (trc, tout, terr) = both(argv, capsys)
            assert (trc, tout, terr) == (jrc, jout, jerr), argv
            assert trc == 0 and tout
        _, show, _ = both(["runs", "show", a, "--dir", d], capsys)[1]
        assert "*" in show and "TOTAL" in show
        _, listing, _ = both(["runs", "list", "--dir", d], capsys)[1]
        assert "6/6" in listing and "template=recommendation" in listing

    def test_errors_equal_jax(self, ckpt_env, capsys):
        os.makedirs(ckpt_env, exist_ok=True)
        for argv in (["runs", "list", "--dir", str(ckpt_env / "missing")],
                     ["runs", "show", "run-nope", "--dir", str(ckpt_env)],
                     ["runs"]):
            (jrc, jout, jerr), (trc, tout, terr) = both(argv, capsys)
            assert (trc, tout, terr) == (jrc, jout, jerr), argv
            assert trc == 2
