"""The port's metrics registry (``predictionio_tpu_torch.utils.metrics``)
against the JAX package's, on the CPU.

One seeded sequence of ``inc`` / ``set`` / ``observe`` calls is replayed
over a fresh registry of each package with the same family declarations
(label values that need escaping, infinite gauge values, a
``BoundedLabel`` past its cap): the Prometheus text must be byte-equal,
the JSON snapshots equal, and each package's ``parse_prometheus`` must
read the other's text to the same dict. The port's global registry
declares every family of the JAX package's under the same name, labels
and buckets; the families whose help text differs are exactly those the
module docstring lists. The build counters count the port's builds at
first use, and the kill switch returns before taking a lock.
"""

import math
import os
import re
import stat

import numpy as np
import pytest

from predictionio_tpu.utils import metrics as jmetrics
from predictionio_tpu_torch import native
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.utils import metrics as tmetrics

ESCAPED = ['plain', 'back\\slash', 'quo"te', 'new\nline', 'all\\"\n', '']


def declare(mod, reg):
    """The same families in either package's registry."""
    bounded = mod.BoundedLabel(cap=3)
    return {
        "counter": reg.counter("t_requests_total", "requests by route",
                               ("route", "status")),
        "gauge": reg.gauge("t_depth", "a gauge", ("lane",)),
        "scalar": reg.gauge("t_scalar", "an unlabeled gauge"),
        "latency": reg.histogram("t_latency_seconds", "default bounds",
                                 ("route",)),
        "sizes": reg.histogram("t_batch_size", "count bounds", ("lane",),
                               buckets=mod.COUNT_BUCKETS),
        "bounded": bounded,
    }


def replay(mod, seed):
    """One seeded call sequence over a fresh registry; its registry."""
    reg = mod.MetricsRegistry(enabled=True)
    fam = declare(mod, reg)
    rng = np.random.default_rng(seed)
    for _ in range(400):
        op = int(rng.integers(0, 6))
        label = ESCAPED[int(rng.integers(0, len(ESCAPED)))]
        if op == 0:
            fam["counter"].inc(float(rng.integers(1, 4)), route=label,
                               status=str(int(rng.choice([200, 404, 500]))))
        elif op == 1:
            fam["gauge"].set(float(rng.normal()) * 10, lane=label)
        elif op == 2:
            fam["scalar"].set(float(rng.choice([math.inf, -math.inf, 3.0,
                                                0.25, 1e16])))
        elif op == 3:
            fam["latency"].observe(float(rng.exponential(0.05)),
                                   route=label)
        elif op == 4:
            fam["sizes"].observe(float(rng.integers(1, 700)),
                                 lane=fam["bounded"](f"lane{rng.integers(6)}"))
        else:
            fam["gauge"].inc(float(rng.integers(-3, 4)), lane=label)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prometheus_text_byte_equal_to_jax(seed):
    treg, jreg = replay(tmetrics, seed), replay(jmetrics, seed)
    text = treg.render_prometheus()
    assert text == jreg.render_prometheus()
    assert "+Inf" in text and '\\"' in text and "\\n" in text
    assert treg.snapshot() == jreg.snapshot()


@pytest.mark.parametrize("seed", [0, 1])
def test_each_package_parses_the_others_text(seed):
    ttext = replay(tmetrics, seed).render_prometheus()
    jtext = replay(jmetrics, seed).render_prometheus()
    assert tmetrics.parse_prometheus(jtext) == jmetrics.parse_prometheus(ttext)
    assert tmetrics.parse_prometheus(ttext) == jmetrics.parse_prometheus(jtext)
    parsed = tmetrics.parse_prometheus(ttext)
    assert parsed["t_requests_total"]["type"] == "counter"
    assert {s["labels"]["route"] for s in
            parsed["t_requests_total"]["series"]} <= set(ESCAPED)


def test_bounded_label_overflow_matches_jax():
    tb, jb = tmetrics.BoundedLabel(cap=2), jmetrics.BoundedLabel(cap=2)
    seq = ["a", "b", "c", "a", "d", "b"]
    assert [tb(v) for v in seq] == [jb(v) for v in seq] == [
        "a", "b", "<other>", "a", "<other>", "b"]


def test_histogram_snapshot_round_trip_matches_jax():
    treg, jreg = replay(tmetrics, 5), replay(jmetrics, 5)
    tser = treg.snapshot()["t_latency_seconds"]["series"][0]
    jser = jreg.snapshot()["t_latency_seconds"]["series"][0]
    th = tmetrics.histogram_from_snapshot(tser)
    jh = jmetrics.histogram_from_snapshot(jser)
    assert th.snapshot() == jh.snapshot()
    assert tmetrics.histogram_snapshot_entry(th, {"route": "x"}) == \
        jmetrics.histogram_snapshot_entry(jh, {"route": "x"})
    lines = tmetrics.render_family_lines(
        "t_latency_seconds", "histogram", [tser], extra=("member", "m1"))
    assert lines == jmetrics.render_family_lines(
        "t_latency_seconds", "histogram", [jser], extra=("member", "m1"))


def families(mod):
    """The families ``mod``'s own module declares (other modules of the
    JAX package, such as its SLO engine, declare more into the same
    registry when they are imported)."""
    return {m.name: (m.kind, m.label_names, getattr(m, "_buckets", None),
                     m.help)
            for m in vars(mod).values() if isinstance(m, mod._Metric)}


def test_global_registry_declares_every_jax_family():
    port, ref = families(tmetrics), families(jmetrics)
    assert all(tmetrics.REGISTRY.get(name) is not None for name in port)
    missing = sorted(set(ref) - set(port))
    assert missing == []
    for name, (kind, labels, buckets, _) in ref.items():
        assert port[name][:3] == (kind, labels, buckets), name
    differing = {name for name in ref if port[name][3] != ref[name][3]}
    listed = set(re.findall(r"pio_\w+", tmetrics.__doc__))
    assert differing == listed


def test_kill_switch_returns_before_taking_a_lock():
    reg = tmetrics.MetricsRegistry(enabled=False)
    fam = declare(tmetrics, reg)

    class NoLock:
        def __enter__(self):
            raise AssertionError("a disabled registry took a lock")

        def __exit__(self, *exc):
            return False

    for m in (fam["counter"], fam["gauge"], fam["latency"]):
        m._lock = NoLock()
    fam["counter"].inc(route="a", status="200")
    fam["gauge"].set(1.0, lane="a")
    fam["gauge"].inc(lane="a")
    fam["latency"].observe(0.1, route="a")
    assert all(not m._children for m in (fam["counter"], fam["gauge"],
                                         fam["latency"]))


def stand_in_compiler(path):
    """A compiler stand-in that writes its ``-o`` file: the build
    listeners see a build without compiling anything."""
    path.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return path


def test_native_build_counted(tmp_path, monkeypatch):
    """A g++ build at first use is one count and its seconds."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    stand_in_compiler(bin_dir / "g++")
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    tmetrics.install_jit_compile_listener()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tmetrics.REGISTRY, "enabled", True)
    n0 = tmetrics.JIT_COMPILES.value()
    s0 = tmetrics.JIT_COMPILE_SECONDS.value()
    assert native._build("ingest_kernels").exists()
    assert tmetrics.JIT_COMPILES.value() == n0 + 1
    assert tmetrics.JIT_COMPILE_SECONDS.value() > s0
    native._build("ingest_kernels")   # on disk now: no build, no count
    assert tmetrics.JIT_COMPILES.value() == n0 + 1


def test_nvcc_builds_counted_once_each(tmp_path, monkeypatch):
    """Each source ``_build`` compiles is one count; the stand-in takes
    nvcc's place, so the test needs no CUDA toolkit."""
    fake = stand_in_compiler(tmp_path / "nvcc")
    tmetrics.install_jit_compile_listener()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(tmetrics.REGISTRY, "enabled", True)
    n0 = tmetrics.JIT_COMPILES.value()
    _build.build_libraries(_build_names())
    assert tmetrics.JIT_COMPILES.value() == n0 + len(_build_names())
    _build.build_libraries(_build_names())
    assert tmetrics.JIT_COMPILES.value() == n0 + len(_build_names())
    monkeypatch.setattr(tmetrics.REGISTRY, "enabled", False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build2")
    _build.build_libraries(_build_names())
    assert tmetrics.JIT_COMPILES.value() == n0 + len(_build_names())


def _build_names():
    from predictionio_tpu_torch.ops import als_cuda

    return als_cuda.KERNEL_NAMES
