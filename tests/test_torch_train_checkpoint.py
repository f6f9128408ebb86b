"""The port's crash-safe training (workflow/checkpoint.py, the chunked lane
of ``train_als*``) against the JAX package, on the CPU.

- ``chunk_schedule``, ``training_fingerprint`` (with the layouts of both
  packages' tables and a BiMap digest bound) and the manifest's keys
  equal the JAX package's on the same inputs.
- Chunked training is bitwise equal to the unchunked loop (uniform,
  bucketed, bf16): each iteration launches the same work on the same
  tensors, only the loop is cut. A preempted run resumed from its
  checkpoint is bitwise equal to an uninterrupted one: the checkpoint
  holds the factors as host fp32, which is lossless for bf16.
- Retention, torn blobs and manifests (and an injected torn save through
  ``PIO_FAULTS``) fall back to the previous intact checkpoint; a
  checkpoint of other inputs (params, precision, layout, entity maps,
  solver route) is refused; non-finite factors abort and are never
  checkpointed.
- The CLI flags, and a chaos pair on a ``pio-torch train --device cpu``
  child: kill -9 then ``--resume``, and SIGTERM drained at the next
  chunk, each bitwise equal to an uninterrupted child.
"""

import argparse
import dataclasses
import hashlib
import io
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from predictionio_tpu.data.bimap import StringIndexBiMap as JBiMap
from predictionio_tpu.ops import als as jals
from predictionio_tpu.workflow import checkpoint as jckpt
from predictionio_tpu_torch.data import storage as tstorage
from predictionio_tpu_torch.data.bimap import StringIndexBiMap as TBiMap
from predictionio_tpu_torch.ops import als as tals
from predictionio_tpu_torch.tools import cli as tcli
from predictionio_tpu_torch.tools import run_commands
from predictionio_tpu_torch.utils import faults, metrics
from predictionio_tpu_torch.workflow import checkpoint
from predictionio_tpu_torch.workflow.checkpoint import (
    CheckpointMismatchError,
    TrainingDivergedError,
    TrainingPreempted,
    chunk_schedule,
)
from predictionio_tpu_torch.workflow.core_workflow import deserialize_models

from test_torch_lifecycle import configure, fill

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
PARAMS = tals.ALSParams(rank=4, num_iterations=6, seed=3)


def make_triples(seed=0, n_u=50, n_i=30, nnz=400):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_u, nnz)
    cols = rng.integers(0, n_i, nnz)
    vals = (rng.random(nnz).astype(np.float32) + 0.5)
    return rows, cols, vals, n_u, n_i


def make_uniform(pkg=tals, seed=0, **kw):
    rows, cols, vals, n_u, n_i = make_triples(seed, **kw)
    return (pkg.pad_ratings(rows, cols, vals, n_u, n_i),
            pkg.pad_ratings(cols, rows, vals, n_i, n_u))


def make_bucketed(pkg=tals, seed=0, **kw):
    rows, cols, vals, n_u, n_i = make_triples(seed, **kw)
    return pkg.bucket_ratings_pair(rows, cols, vals, n_u, n_i)


def train(sides, params=PARAMS, layout="uniform"):
    fn = tals.train_als if layout == "uniform" else tals.train_als_bucketed
    return fn(*sides, params, CPU)


@pytest.fixture
def ckpt_env(tmp_path, monkeypatch):
    """Checkpointing into a fresh directory (every 2 iterations); the
    stop flag and the fault injector never leak across tests."""
    d = tmp_path / "ckpts"
    monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(d))
    monkeypatch.setenv("PIO_CHECKPOINT_EVERY", "2")
    for var in ("PIO_RESUME", "PIO_CHECKPOINT_KEEP", "PIO_ALS_PRECISION",
                "PIO_FAULTS", "PIO_TRAIN_TELEMETRY"):
        monkeypatch.delenv(var, raising=False)
    checkpoint.clear_stop()
    yield d
    checkpoint.clear_stop()
    faults.clear()


def manifests(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".json"))


def unchunked(monkeypatch, sides, params=PARAMS, layout="uniform"):
    """The uninterrupted run, checkpointing off."""
    d = os.environ.pop("PIO_CHECKPOINT_DIR")
    try:
        return train(sides, params, layout)
    finally:
        os.environ["PIO_CHECKPOINT_DIR"] = d


class TestAgainstJax:
    @pytest.mark.parametrize("total,every", [
        (6, 2), (6, 4), (6, None), (6, 0), (6, 6), (6, 99), (0, 2), (10, 3),
        (1, 1), (7, 2)])
    def test_chunk_schedule(self, total, every):
        assert chunk_schedule(total, every) == jckpt.chunk_schedule(total,
                                                                    every)

    @pytest.mark.parametrize("layout", ["uniform", "bucketed"])
    @pytest.mark.parametrize("solver,precision", [
        ("cuda", "fp32"), ("plain", "bf16"), ("cho", "fp32")])
    def test_training_fingerprint(self, layout, solver, precision):
        make = make_uniform if layout == "uniform" else make_bucketed
        lay = getattr(tals, f"checkpoint_layout_{layout}")(*make(tals))
        jlay = getattr(jals, f"checkpoint_layout_{layout}")(*make(jals))
        assert lay == jlay
        kw = dict(rank=5, lambda_=0.2, alpha=3.0, seed=9, precision=precision,
                  solve_refine=True, checkpoint_every=4)
        got = checkpoint.training_fingerprint(lay, tals.ALSParams(**kw),
                                              solver, precision)
        want = jckpt.training_fingerprint(jlay, jals.ALSParams(**kw), solver,
                                          precision)
        assert got == want
        labels = (["u1", "u2", "é"], ["i9", "i3"])
        tmaps, jmaps = ([cls(x) for x in labels] for cls in (TBiMap, JBiMap))
        assert checkpoint.bimap_digest(*tmaps) == jckpt.bimap_digest(*jmaps)
        with checkpoint.fingerprint_scope(checkpoint.bimap_digest(*tmaps)), \
                jckpt.fingerprint_scope(jckpt.bimap_digest(*jmaps)):
            scoped = checkpoint.training_fingerprint(
                lay, tals.ALSParams(**kw), solver, precision)
            assert scoped == jckpt.training_fingerprint(
                jlay, jals.ALSParams(**kw), solver, precision)
        assert scoped != got
        # chunking is an execution knob, not part of the input identity
        assert checkpoint.training_fingerprint(
            lay, tals.ALSParams(**dict(kw, checkpoint_every=1)), solver,
            precision) == got

    def test_manifest_keys_equal_jax(self, ckpt_env, monkeypatch):
        train(make_uniform(tals))
        port = ckpt_env
        jax_dir = ckpt_env.parent / "jax"
        monkeypatch.setenv("PIO_CHECKPOINT_DIR", str(jax_dir))
        jals.train_als(*make_uniform(jals), jals.ALSParams(**dataclasses.asdict(
            PARAMS)))
        assert manifests(port) == manifests(jax_dir) == [
            "ckpt-00000002.json", "ckpt-00000004.json", "ckpt-00000006.json"]
        for name in manifests(port):
            got = json.loads((port / name).read_text())
            want = json.loads((jax_dir / name).read_text())
            assert set(got) == set(want)
            for key in ("step", "totalIterations", "file", "shapes"):
                assert got[key] == want[key]
            assert set(got["extra"]) == set(want["extra"]) == {"runId"}


class TestChunkedEqualsUnchunked:
    @pytest.mark.parametrize("layout,precision,every", [
        ("uniform", "fp32", "2"), ("uniform", "fp32", "4"),
        ("bucketed", "fp32", "1"), ("uniform", "bf16", "2"),
        ("bucketed", "bf16", "3")])
    def test_bitwise(self, ckpt_env, monkeypatch, layout, precision, every):
        monkeypatch.setenv("PIO_CHECKPOINT_EVERY", every)
        sides = make_uniform() if layout == "uniform" else make_bucketed()
        params = dataclasses.replace(PARAMS, precision=precision)
        X0, Y0 = unchunked(monkeypatch, sides, params, layout)
        X1, Y1 = train(sides, params, layout)
        assert X1.dtype == np.float32
        assert np.array_equal(X0, X1) and np.array_equal(Y0, Y1)
        assert manifests(ckpt_env)[-1] == "ckpt-00000006.json"

    def test_blocked_solve(self, ckpt_env, monkeypatch):
        params = dataclasses.replace(PARAMS, solve_block_rows=16)
        sides = make_uniform()
        X0, Y0 = unchunked(monkeypatch, sides, params)
        X1, Y1 = train(sides, params)
        assert np.array_equal(X0, X1) and np.array_equal(Y0, Y1)


class TestCheckpointFiles:
    def test_manifest_contents(self, ckpt_env):
        train(make_uniform())
        names = manifests(ckpt_env)
        m = json.loads((ckpt_env / names[-1]).read_text())
        assert m["step"] == 6 and m["totalIterations"] == 6
        assert m["shapes"] == {"X": [50, 4], "Y": [30, 4]}
        blob = (ckpt_env / m["file"]).read_bytes()
        assert hashlib.sha256(blob).hexdigest() == m["sha256"]
        with np.load(io.BytesIO(blob)) as z:
            assert z["X"].dtype == np.float32

    def test_bf16_blobs_hold_fp32_of_bf16_values(self, ckpt_env):
        train(make_uniform(), dataclasses.replace(PARAMS, precision="bf16"))
        with np.load(ckpt_env / "ckpt-00000006.npz") as z:
            X = z["X"]
        assert X.dtype == np.float32
        # each value is a bf16 value: its low 16 bits are zero
        assert not (X.view(np.uint32) & 0xFFFF).any()

    def test_retention_keeps_last_n(self, ckpt_env, monkeypatch):
        monkeypatch.setenv("PIO_CHECKPOINT_EVERY", "1")
        monkeypatch.setenv("PIO_CHECKPOINT_KEEP", "2")
        train(make_uniform())
        assert manifests(ckpt_env) == ["ckpt-00000005.json",
                                       "ckpt-00000006.json"]
        assert sorted(f for f in os.listdir(ckpt_env)
                      if f.endswith(".npz")) == ["ckpt-00000005.npz",
                                                 "ckpt-00000006.npz"]

    def test_retention_sweeps_orphan_blobs(self, ckpt_env, monkeypatch):
        monkeypatch.setenv("PIO_CHECKPOINT_KEEP", "2")
        os.makedirs(ckpt_env, exist_ok=True)
        (ckpt_env / "ckpt-00000099.npz").write_bytes(b"orphan")
        train(make_uniform())
        assert not (ckpt_env / "ckpt-00000099.npz").exists()


def preempt(sides, params=PARAMS, layout="uniform"):
    checkpoint.request_stop()
    try:
        with pytest.raises(TrainingPreempted, match="--resume"):
            train(sides, params, layout)
    finally:
        checkpoint.clear_stop()


class TestPreemptResume:
    @pytest.mark.parametrize("layout,precision", [
        ("uniform", "fp32"), ("bucketed", "bf16")])
    def test_preempt_then_resume_bitwise(self, ckpt_env, monkeypatch,
                                         layout, precision):
        sides = make_uniform() if layout == "uniform" else make_bucketed()
        params = dataclasses.replace(PARAMS, precision=precision)
        X0, Y0 = unchunked(monkeypatch, sides, params, layout)
        preempt(sides, params, layout)
        assert manifests(ckpt_env) == ["ckpt-00000002.json"]
        resumed = metrics.TRAIN_CHECKPOINTS.value(status="resumed")
        monkeypatch.setenv("PIO_RESUME", "1")
        X1, Y1 = train(sides, params, layout)
        assert np.array_equal(X0, X1) and np.array_equal(Y0, Y1)
        assert metrics.TRAIN_CHECKPOINTS.value(status="resumed") == \
            resumed + 1

    def test_resume_empty_dir_is_fresh_start(self, ckpt_env, monkeypatch):
        sides = make_uniform()
        X0, _ = unchunked(monkeypatch, sides)
        monkeypatch.setenv("PIO_RESUME", "1")
        X1, _ = train(sides)
        assert np.array_equal(X0, X1)

    def test_resume_with_another_chunk_size(self, ckpt_env, monkeypatch):
        sides = make_uniform()
        X0, Y0 = unchunked(monkeypatch, sides)
        preempt(sides)
        monkeypatch.setenv("PIO_CHECKPOINT_EVERY", "3")
        monkeypatch.setenv("PIO_RESUME", "1")
        X1, Y1 = train(sides)
        assert np.array_equal(X0, X1) and np.array_equal(Y0, Y1)


class TestTornRecovery:
    def _all_kept(self, ckpt_env, monkeypatch):
        monkeypatch.setenv("PIO_CHECKPOINT_KEEP", "10")
        sides = make_uniform()
        X0, Y0 = unchunked(monkeypatch, sides)
        train(sides)
        monkeypatch.setenv("PIO_RESUME", "1")
        return sides, X0, Y0

    def test_torn_blob_falls_back(self, ckpt_env, monkeypatch):
        sides, X0, Y0 = self._all_kept(ckpt_env, monkeypatch)
        blob = (ckpt_env / "ckpt-00000006.npz").read_bytes()
        (ckpt_env / "ckpt-00000006.npz").write_bytes(blob[:len(blob) // 2])
        torn = metrics.TRAIN_CHECKPOINTS.value(status="torn_skipped")
        X1, Y1 = train(sides)
        assert np.array_equal(X0, X1) and np.array_equal(Y0, Y1)
        assert metrics.TRAIN_CHECKPOINTS.value(status="torn_skipped") == \
            torn + 1

    def test_torn_manifest_mid_multibyte(self, ckpt_env, monkeypatch):
        sides, X0, Y0 = self._all_kept(ckpt_env, monkeypatch)
        path = ckpt_env / "ckpt-00000006.json"
        m = json.loads(path.read_text(encoding="utf-8"))
        m["note"] = "préemption événement"
        raw = json.dumps(m, ensure_ascii=False).encode("utf-8")
        path.write_bytes(raw[:raw.rindex("é".encode("utf-8")) + 1])
        X1, Y1 = train(sides)
        assert np.array_equal(X0, X1) and np.array_equal(Y0, Y1)

    def test_manifest_without_blob_falls_back(self, ckpt_env, monkeypatch):
        sides, X0, Y0 = self._all_kept(ckpt_env, monkeypatch)
        os.unlink(ckpt_env / "ckpt-00000006.npz")
        X1, Y1 = train(sides)
        assert np.array_equal(X0, X1) and np.array_equal(Y0, Y1)

    def test_all_torn_is_fresh_start(self, ckpt_env, monkeypatch):
        sides, X0, Y0 = self._all_kept(ckpt_env, monkeypatch)
        for p in ckpt_env.iterdir():
            if p.is_file():
                p.write_bytes(p.read_bytes()[:10])
        X1, Y1 = train(sides)
        assert np.array_equal(X0, X1) and np.array_equal(Y0, Y1)

    @pytest.mark.parametrize("via", ["install", "env"])
    def test_injected_torn_save_then_resume(self, ckpt_env, monkeypatch,
                                            via):
        sides = make_uniform()
        X0, Y0 = unchunked(monkeypatch, sides)
        spec = "backend=checkpoint,op=save,kind=torn,after=1,times=1"
        fired = metrics.FAULTS_INJECTED.value(backend="checkpoint", op="save",
                                              kind="torn")
        if via == "install":
            faults.install(spec)
        else:
            monkeypatch.setenv("PIO_FAULTS", spec)
        try:
            with pytest.raises(faults.InjectedTornWrite):
                train(sides)
        finally:
            faults.clear()
            monkeypatch.delenv("PIO_FAULTS", raising=False)
        assert metrics.FAULTS_INJECTED.value(
            backend="checkpoint", op="save", kind="torn") == fired + 1
        assert manifests(ckpt_env) == ["ckpt-00000002.json"]
        assert (ckpt_env / "ckpt-00000004.npz").exists()    # the shear
        monkeypatch.setenv("PIO_RESUME", "1")
        X1, Y1 = train(sides)
        assert np.array_equal(X0, X1) and np.array_equal(Y0, Y1)


class TestFingerprintRefusals:
    @pytest.fixture
    def saved(self, ckpt_env, monkeypatch):
        sides = make_uniform()
        train(sides)
        assert manifests(ckpt_env)
        monkeypatch.setenv("PIO_RESUME", "1")
        return sides

    def test_params_change_refused(self, saved):
        with pytest.raises(CheckpointMismatchError, match="Refusing"):
            train(saved, dataclasses.replace(PARAMS, lambda_=0.02))

    def test_precision_change_refused(self, saved, monkeypatch):
        monkeypatch.setenv("PIO_ALS_PRECISION", "bf16")
        with pytest.raises(CheckpointMismatchError):
            train(saved)

    def test_layout_change_refused(self, saved):
        with pytest.raises(CheckpointMismatchError):
            train(make_uniform(seed=9, n_u=64, n_i=40, nnz=500))

    def test_solver_route_change_refused(self, saved, monkeypatch):
        # a checkpoint of the plain versions does not resume as the
        # kernels' (they differ in the last bits)
        monkeypatch.setattr(tals, "_solver_route", lambda dev: "cuda")
        with pytest.raises(CheckpointMismatchError):
            train(saved)

    def test_bimap_change_refused(self, ckpt_env, monkeypatch):
        sides = make_uniform()
        with checkpoint.fingerprint_scope(
                checkpoint.bimap_digest(TBiMap(["a", "b"]))):
            train(sides)
        monkeypatch.setenv("PIO_RESUME", "1")
        with checkpoint.fingerprint_scope(
                checkpoint.bimap_digest(TBiMap(["a", "c"]))):
            with pytest.raises(CheckpointMismatchError):
                train(sides)
        # the scope only binds while a checkpoint directory is set
        assert checkpoint.bimap_fingerprint_scope(TBiMap(["a"])) is not None
        monkeypatch.delenv("PIO_CHECKPOINT_DIR")
        import contextlib

        assert isinstance(checkpoint.bimap_fingerprint_scope(TBiMap(["a"])),
                          contextlib.nullcontext)


class TestDivergenceGuard:
    def _nan_sides(self):
        rows, cols, vals, n_u, n_i = make_triples()
        vals = vals.copy()
        vals[7] = np.nan
        return (tals.pad_ratings(rows, cols, vals, n_u, n_i),
                tals.pad_ratings(cols, rows, vals, n_i, n_u))

    @pytest.mark.parametrize("telemetry", ["1", "0"])
    def test_nan_aborts_with_metric(self, ckpt_env, monkeypatch, telemetry):
        monkeypatch.setenv("PIO_TRAIN_TELEMETRY", telemetry)
        before = metrics.TRAIN_DIVERGED.value()
        with pytest.raises(TrainingDivergedError, match="iteration 2/6"):
            train(self._nan_sides())
        assert metrics.TRAIN_DIVERGED.value() == before + 1
        assert manifests(ckpt_env) == []

    def test_last_good_checkpoints_retained(self, ckpt_env, monkeypatch):
        monkeypatch.setenv("PIO_CHECKPOINT_KEEP", "10")
        train(make_uniform())
        kept = {f.name: f.read_bytes() for f in ckpt_env.iterdir()
                if f.is_file()}
        with pytest.raises(TrainingDivergedError):
            train(self._nan_sides())
        assert {f.name: f.read_bytes() for f in ckpt_env.iterdir()
                if f.is_file()} == kept

    def test_no_guard_when_off(self, monkeypatch):
        monkeypatch.delenv("PIO_CHECKPOINT_DIR", raising=False)
        X, _ = train(self._nan_sides())
        assert not np.isfinite(X).all()


class TestCLIFlags:
    def _args(self, **kw):
        ns = argparse.Namespace(checkpoint_every=None, checkpoint_dir=None,
                                checkpoint_keep=None, resume=False,
                                precision=None)
        for k, v in kw.items():
            setattr(ns, k, v)
        return ns

    def test_parser_accepts_flags(self):
        args = tcli.build_parser().parse_args(
            ["train", "--device", "cpu", "--checkpoint-every", "5",
             "--checkpoint-dir", "/tmp/ck", "--checkpoint-keep", "4",
             "--resume", "--precision", "bf16"])
        assert (args.checkpoint_every, args.checkpoint_dir,
                args.checkpoint_keep, args.resume, args.precision) == \
            (5, "/tmp/ck", 4, True, "bf16")

    def test_flags_set_env(self, tmp_path, monkeypatch):
        monkeypatch.setattr(os, "environ", dict(os.environ))
        for var in ("PIO_CHECKPOINT_DIR", "PIO_CHECKPOINT_EVERY",
                    "PIO_CHECKPOINT_KEEP", "PIO_RESUME", "PIO_ALS_PRECISION"):
            os.environ.pop(var, None)
        monkeypatch.setattr(checkpoint, "install_signal_handlers",
                            lambda: True)
        args = self._args(checkpoint_every=3, checkpoint_dir=str(tmp_path),
                          checkpoint_keep=5, resume=True, precision="bf16")
        run_commands._apply_checkpoint_flags(args)
        run_commands._apply_precision_flag(args)
        assert os.environ["PIO_CHECKPOINT_EVERY"] == "3"
        assert os.environ["PIO_CHECKPOINT_DIR"] == str(tmp_path)
        assert os.environ["PIO_CHECKPOINT_KEEP"] == "5"
        assert os.environ["PIO_RESUME"] == "1"
        assert os.environ["PIO_ALS_PRECISION"] == "bf16"

    def test_every_without_dir_refused(self, monkeypatch):
        for var in ("PIO_CHECKPOINT_EVERY", "PIO_CHECKPOINT_DIR",
                    "PIO_RESUME"):
            monkeypatch.delenv(var, raising=False)
        for args in (self._args(checkpoint_every=3), self._args(resume=True),
                     self._args(checkpoint_every=0, checkpoint_dir="/tmp/x"),
                     self._args(checkpoint_keep=0, checkpoint_dir="/tmp/x")):
            with pytest.raises(SystemExit):
                run_commands._apply_checkpoint_flags(args)
        # a refused invocation sets nothing
        for var in ("PIO_CHECKPOINT_EVERY", "PIO_CHECKPOINT_DIR",
                    "PIO_RESUME"):
            assert var not in os.environ

    def test_dir_alone_installs_no_handlers(self, tmp_path, monkeypatch):
        monkeypatch.setattr(os, "environ", dict(os.environ))
        for var in ("PIO_CHECKPOINT_DIR", "PIO_CHECKPOINT_EVERY",
                    "PIO_RESUME"):
            os.environ.pop(var, None)
        calls = []
        monkeypatch.setattr(checkpoint, "install_signal_handlers",
                            lambda: calls.append(1))
        run_commands._apply_checkpoint_flags(
            self._args(checkpoint_dir=str(tmp_path)))
        assert calls == []
        run_commands._apply_checkpoint_flags(
            self._args(checkpoint_dir=str(tmp_path), checkpoint_every=2))
        assert calls == [1]


# -- chaos: a `pio-torch train --device cpu` child ----------------------------

INSTANCE_RE = re.compile(r"Engine instance ID: (\S+)")
SLOW_SAVES = "backend=checkpoint,op=save,kind=slow,delay=0.5"


@pytest.fixture
def engine(tmp_path, monkeypatch):
    """A sqlite store with ``MyApp``'s events and an engine directory
    (the recommendation template, rank 4, 6 iterations)."""
    configure(tstorage, "sqlite", tmp_path / "port.db")
    fill(tstorage, "predictionio_tpu_torch")
    eng = tmp_path / "eng"
    assert tcli.main(["template", "get", "recommendation", str(eng)]) == 0
    path = eng / "engine.json"
    variant = json.loads(path.read_text())
    variant["datasource"]["params"].update(appName="MyApp")
    variant["algorithms"][0]["params"].update(rank=4, numIterations=6)
    path.write_text(json.dumps(variant))
    env = dict(os.environ, PIO_STORAGE_SOURCES_S_TYPE="sqlite",
               PIO_STORAGE_SOURCES_S_PATH=str(tmp_path / "port.db"),
               PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "S"
    for var in ("PIO_FAULTS", "PIO_RESUME", "PIO_CHECKPOINT_DIR",
                "PIO_CHECKPOINT_EVERY", "PIO_ALS_PRECISION"):
        env.pop(var, None)
    yield {"variant": str(path), "env": env, "cwd": str(tmp_path),
           "ckpt": tmp_path / "ck"}
    tstorage.reset()


def train_argv(engine, *extra):
    return [sys.executable, "-m", "predictionio_tpu_torch.tools.console",
            "train", "--device", "cpu", "--engine-variant", engine["variant"],
            *extra]


def ckpt_argv(engine, *extra):
    return train_argv(engine, "--precision", "bf16", "--checkpoint-dir",
                      str(engine["ckpt"]), "--checkpoint-every", "1", *extra)


def trained_factors(engine, *extra, faults_spec=None):
    env = dict(engine["env"])
    if faults_spec:
        env["PIO_FAULTS"] = faults_spec
    proc = subprocess.run(train_argv(engine, *extra), env=env,
                          cwd=engine["cwd"], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    iid = INSTANCE_RE.search(proc.stdout).group(1)
    model = deserialize_models(
        tstorage.get_model_data_models().get(iid).models)[0]
    return model.user_factors, model.item_factors


def wait_for(path, proc, timeout=60.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if path.exists():
            return
        if proc.poll() is not None:
            break
        time.sleep(0.02)
    proc.kill()
    pytest.fail(f"{path.name} did not appear: {proc.communicate()}")


class TestChaosChild:
    def test_kill9_then_resume_bitwise(self, engine):
        X0, Y0 = trained_factors(engine, "--precision", "bf16")
        proc = subprocess.Popen(
            ckpt_argv(engine), env=dict(engine["env"], PIO_FAULTS=SLOW_SAVES),
            cwd=engine["cwd"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        try:
            wait_for(engine["ckpt"] / "ckpt-00000002.json", proc)
            assert proc.poll() is None, "the child ended before its kill"
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        assert proc.returncode == -signal.SIGKILL
        X1, Y1 = trained_factors(
            engine, "--precision", "bf16", "--checkpoint-dir",
            str(engine["ckpt"]), "--checkpoint-every", "1", "--resume")
        assert np.array_equal(X0, X1) and np.array_equal(Y0, Y1)

    def test_sigterm_drains_at_the_next_chunk(self, engine):
        X0, Y0 = trained_factors(engine, "--precision", "bf16")
        proc = subprocess.Popen(
            ckpt_argv(engine), env=dict(engine["env"], PIO_FAULTS=SLOW_SAVES),
            cwd=engine["cwd"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        wait_for(engine["ckpt"] / "ckpt-00000001.json", proc)
        assert proc.poll() is None, "the child ended before SIGTERM"
        t0 = time.monotonic()
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert b"[INFO] Training interrupted" in out
        assert b"Traceback" not in out
        assert time.monotonic() - t0 < 20.0
        steps = sorted(int(p.name[5:13])
                       for p in engine["ckpt"].glob("ckpt-*.json"))
        assert steps and steps[-1] < 6      # stopped before the end
        statuses = {i.status for i in
                    tstorage.get_metadata_engine_instances().get_all()}
        assert "INTERRUPTED" in statuses
        X1, Y1 = trained_factors(
            engine, "--precision", "bf16", "--checkpoint-dir",
            str(engine["ckpt"]), "--checkpoint-every", "1", "--resume")
        assert np.array_equal(X0, X1) and np.array_equal(Y0, Y1)
