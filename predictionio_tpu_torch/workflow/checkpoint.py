"""Crash-safe training: chunked checkpointing, graceful preemption,
and exact resume.

The port's copy of the serial lane of
``predictionio_tpu/workflow/checkpoint.py``: the same manifests, blobs,
fingerprints and run logs, so a checkpoint directory reads in either
package (a resume still needs the same solver route: see the
fingerprint below).

Design:

- **Chunked outer loop** (:func:`run_chunked`): the caller's iteration
  loop runs ``checkpoint_every`` iterations per call instead of all of
  them; between chunks the host snapshots the factor carries, checks
  the preemption flag, and guards against divergence. Chunked training
  is bitwise equal to the unchunked loop: each iteration launches the
  same kernels on the same tensors; only the loop is cut. Default off:
  with no ``$PIO_CHECKPOINT_DIR`` the loop runs untouched.
- **Atomic checkpoints**: factors land host-side fp32 (the existing
  persistence policy — a bf16/fp32 round trip is lossless for bf16
  stores, so resume stays byte-identical under every precision lane)
  as an ``.npz`` blob + a JSON manifest carrying step, blob sha256 and
  the input fingerprint, both written through the shared
  ``atomic_write_bytes``. Keep-last-N retention; a torn blob or
  manifest is detected (sha/JSON/UTF-8) and resume falls back to the
  previous intact checkpoint.
- **Fingerprint discipline** (the batchpredict manifest rule): a
  checkpoint is only resumable into a training run with the SAME
  inputs — layout signature (table/bucket shapes), ALSParams,
  the solver route (``"cuda"`` for the kernels, ``"plain"`` for their
  plain versions on the CPU: they differ in the last bits), the
  precision, and the BiMap digest the templates bind via
  :func:`bimap_fingerprint_scope`. ``pio train --resume`` refuses
  loudly on mismatch. Training is deterministic given the fingerprint,
  so any intact checkpoint at step k IS the uninterrupted run's step-k
  state, including across chunk-size changes.
- **Graceful preemption**: SIGTERM/SIGINT set a stop flag
  (:func:`install_signal_handlers`, wired by ``pio train``) checked at
  chunk boundaries — the in-flight chunk finishes, a final checkpoint
  lands, and training exits cleanly via :class:`TrainingPreempted`
  (a ``TrainingInterruption``, so the CLI reports an interruption
  instead of a traceback and exits 0).
- **Divergence guard**: after every chunk a device-side finiteness
  reduction aborts on NaN/inf factors with
  :class:`TrainingDivergedError`; the poisoned state is never
  checkpointed (the last intact checkpoint is retained) and
  ``pio_train_diverged_total`` counts the abort.

- **The config grid** (:func:`run_chunked_grid`): the same lifecycle
  for ``k`` stacked configs, with per-config divergence: a non-finite
  config is masked out (factors zeroed, re-masked every chunk) while its
  neighbours train on, ``pio_train_diverged_total`` counts each dead
  config once, the alive mask rides the manifest's ``extra`` block, and
  only an all-dead grid aborts.

Training sharded over one process's devices checkpoints through the
same lane (the factor tables gathered to the host for a save, scattered
back over the mesh on resume); training across several processes writes
no checkpoint and warns when asked for them
(:mod:`~predictionio_tpu_torch.parallel.als_sharding`).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime as _dt
import glob
import hashlib
import io
import json
import logging
import os
import re
import threading
import time as _time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.core.base import TrainingInterruption
from predictionio_tpu_torch.data.storage.localfs import atomic_write_bytes

logger = logging.getLogger("pio.torch.checkpoint")


class CheckpointError(RuntimeError):
    """Base for checkpoint-subsystem failures."""


class CheckpointMismatchError(CheckpointError):
    """``--resume`` found an intact checkpoint whose input fingerprint
    does not match this training run — different data layout, params,
    solver/precision statics, or BiMaps. Resuming would silently train
    a different objective, so refuse loudly (the batchpredict manifest
    discipline)."""


class TrainingDivergedError(RuntimeError):
    """Non-finite factors detected by the per-chunk guard; the last
    intact checkpoint is retained for post-mortem/restart."""


class TrainingPreempted(TrainingInterruption):
    """SIGTERM/SIGINT honored at a chunk boundary after saving a final
    checkpoint — a clean, resumable exit, not a failure.

    ``resumable`` lets the workflow layer distinguish this from the
    stop-after debug interruptions WITHOUT importing this module: a
    preemption propagates to the CLI (which reports the checkpoint
    location and exits 0) instead of being swallowed as a stop-after
    flag."""

    resumable = True


# ---------------------------------------------------------------------------
# Stop flag + signal wiring (graceful preemption)
# ---------------------------------------------------------------------------

_stop_event = threading.Event()


def request_stop() -> None:
    """Ask the active training run to stop at its next chunk boundary
    (tests and embedders; the CLI wires real signals)."""
    _stop_event.set()


def clear_stop() -> None:
    _stop_event.clear()


def stop_requested() -> bool:
    return _stop_event.is_set()


def install_signal_handlers() -> bool:
    """SIGTERM/SIGINT -> stop flag. The FIRST signal requests a
    graceful drain (finish the in-flight chunk, checkpoint, exit 0);
    the handler then restores the previous disposition so a second
    signal behaves as before (e.g. Ctrl-C twice force-interrupts).
    Main-thread only (signal module contract); returns False when
    called from elsewhere."""
    import signal

    if threading.current_thread() is not threading.main_thread():
        return False

    for sig in (signal.SIGTERM, signal.SIGINT):
        prev = signal.getsignal(sig)

        def _handler(signum, frame, _prev=prev):
            request_stop()
            logger.warning(
                "signal %s received: will checkpoint and stop at the "
                "next chunk boundary (send again to force)", signum)
            try:
                signal.signal(signum, _prev if _prev is not None
                              else signal.SIG_DFL)
            except (ValueError, TypeError):  # pragma: no cover
                pass

        signal.signal(sig, _handler)
    return True


# ---------------------------------------------------------------------------
# Config + fingerprint
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Resolved knobs: ``--checkpoint-dir``/``$PIO_CHECKPOINT_DIR``,
    ``--checkpoint-every``/``$PIO_CHECKPOINT_EVERY`` (or
    ``ALSParams.checkpoint_every``), ``--checkpoint-keep``/
    ``$PIO_CHECKPOINT_KEEP`` (default 3), ``--resume``/``$PIO_RESUME``."""

    directory: str
    every: int
    keep: int = 3
    resume: bool = False


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in (
        "1", "true", "yes", "on")


def resolve_every(params: Any = None) -> int:
    """Chunk length in iterations: ``$PIO_CHECKPOINT_EVERY`` overrides
    ``ALSParams.checkpoint_every`` (the env-as-truth discipline shared
    with the precision/solver resolvers); 0 = chunking off."""
    env = os.environ.get("PIO_CHECKPOINT_EVERY", "").strip()
    if env:
        every = int(env)
    else:
        every = int(getattr(params, "checkpoint_every", None) or 0)
    if every < 0:
        raise ValueError(
            f"checkpoint_every must be >= 0, got {every}")
    return every


def resolve_config(params: Any = None) -> Optional[CheckpointConfig]:
    """The active checkpoint configuration, or None when checkpointing
    is off. Active iff a directory is set AND (a chunk length resolves
    or ``--resume`` asks for a restart — a resume with no chunk length
    runs the remainder as one chunk, still bitwise equal)."""
    directory = os.environ.get("PIO_CHECKPOINT_DIR", "").strip()
    if not directory:
        return None
    every = resolve_every(params)
    resume = _env_truthy("PIO_RESUME")
    if not every and not resume:
        return None
    keep = int(os.environ.get("PIO_CHECKPOINT_KEEP", "").strip() or 3)
    if keep < 1:
        raise ValueError(f"PIO_CHECKPOINT_KEEP must be >= 1, got {keep}")
    return CheckpointConfig(directory=directory, every=every, keep=keep,
                            resume=resume)


# extra fingerprint material bound by the caller that KNOWS the input
# identity beyond its layout — the templates bind their BiMap digests
# here so two stores with identical shapes but different entity
# universes can never resume each other's checkpoints
_fingerprint_extra: contextvars.ContextVar[str] = contextvars.ContextVar(
    "pio_checkpoint_fingerprint_extra", default="")


@contextlib.contextmanager
def fingerprint_scope(extra: str):
    token = _fingerprint_extra.set(str(extra))
    try:
        yield
    finally:
        _fingerprint_extra.reset(token)


def bimap_digest(*maps: Any) -> str:
    """Order-sensitive sha256 over the label universes of one or more
    BiMaps (``StringIndexBiMap.labels`` or the forward dict in index
    order) — the entity-identity half of the input fingerprint."""
    h = hashlib.sha256()
    for m in maps:
        labels = getattr(m, "labels", None)
        if labels is None:
            fwd = getattr(m, "to_dict", None)
            d = fwd() if callable(fwd) else dict(getattr(m, "_fwd", {}))
            labels = [k for k, _ in sorted(d.items(), key=lambda kv: kv[1])]
        for label in list(labels):
            b = str(label).encode("utf-8")
            h.update(len(b).to_bytes(4, "little"))
            h.update(b)
        h.update(b"\x00map\x00")
    return h.hexdigest()


def bimap_fingerprint_scope(*maps: Any):
    """Bind the BiMap digest into the training fingerprint for the
    enclosed ``train_als*`` call. No-cost no-op while checkpointing is
    off (the digest is O(labels))."""
    if not os.environ.get("PIO_CHECKPOINT_DIR", "").strip():
        return contextlib.nullcontext()
    return fingerprint_scope(bimap_digest(*maps))


def training_fingerprint(layout: Sequence, params: Any, solver: str,
                         precision: str, dtype: Any = None) -> str:
    """The input identity a checkpoint is valid for: layout signature
    (table/bucket shapes + row/col spaces), every ALSParams field that
    changes the math (``checkpoint_every`` is excluded — chunking is
    an execution knob, proven result-invariant), the resolved
    solver/precision statics, and any :func:`fingerprint_scope` extra
    (BiMap digests). sha256 hex."""
    pd = {}
    if dataclasses.is_dataclass(params):
        pd = dataclasses.asdict(params)
    else:  # pragma: no cover - params are dataclasses everywhere
        pd = dict(getattr(params, "__dict__", {}))
    pd.pop("checkpoint_every", None)
    material = json.dumps({
        "layout": layout,
        "params": pd,
        "solver": str(solver),
        "precision": str(precision),
        "dtype": None if dtype is None else str(dtype),
        "extra": _fingerprint_extra.get(),
    }, sort_keys=True, default=str)
    return hashlib.sha256(material.encode("utf-8")).hexdigest()


# ---------------------------------------------------------------------------
# Checkpoint store
# ---------------------------------------------------------------------------

_CKPT_RE = re.compile(r"ckpt-(\d{8})\.json$")


def _ckpt_name(step: int) -> str:
    return f"ckpt-{int(step):08d}"


class TrainCheckpointer:
    """One training run's checkpoint lane: atomic blob+manifest writes,
    sha256 torn detection, keep-last-N retention, fingerprint-gated
    resume. Factors are host fp32 (per the persistence policy)."""

    def __init__(self, cfg: CheckpointConfig, fingerprint: str,
                 total_iterations: int):
        self.cfg = cfg
        self.fingerprint = fingerprint
        self.total = int(total_iterations)
        # auxiliary manifest payload of the checkpoint most recently
        # resumed from (e.g. the grid loop's alive mask); {} otherwise
        self.resumed_extra: dict = {}
        os.makedirs(cfg.directory, exist_ok=True)

    @property
    def directory(self) -> str:
        return self.cfg.directory

    @property
    def every(self) -> int:
        return self.cfg.every

    # -- write path ------------------------------------------------------

    def save(self, step: int, X: np.ndarray, Y: np.ndarray,
             extra: Optional[dict] = None) -> str:
        """Atomically persist the factor pair at ``step``. Blob first,
        manifest second: a crash between the two leaves a blob no
        manifest commits — invisible to resume, exactly like a torn
        batchpredict shard. ``extra`` is an optional JSON-able payload
        stored in the manifest (the grid loop's per-config alive mask
        lives there) and surfaced on resume via ``resumed_extra``."""
        from predictionio_tpu_torch.utils import faults, metrics

        X = np.asarray(X, dtype=np.float32)
        Y = np.asarray(Y, dtype=np.float32)
        buf = io.BytesIO()
        np.savez(buf, X=X, Y=Y)
        blob = buf.getvalue()
        name = _ckpt_name(step)
        blob_path = os.path.join(self.cfg.directory, name + ".npz")

        torn = faults.maybe_fault("checkpoint", "save")
        if torn is not None:
            # honor the injected mid-write crash: HALF the blob lands
            # NON-atomically at the final path (the no-atomic-rename
            # world this subsystem defends against), then the ambiguous
            # failure — the manifest never commits
            with open(blob_path, "wb") as f:
                f.write(blob[:max(1, len(blob) // 2)])
            raise torn.error()

        atomic_write_bytes(blob_path, blob)
        manifest = {
            "step": int(step),
            "totalIterations": self.total,
            "file": name + ".npz",
            "sha256": hashlib.sha256(blob).hexdigest(),
            "fingerprint": self.fingerprint,
            "shapes": {"X": list(X.shape), "Y": list(Y.shape)},
            "createdAt": _dt.datetime.now(
                tz=_dt.timezone.utc).isoformat(),
        }
        if extra:
            manifest["extra"] = extra
        atomic_write_bytes(
            os.path.join(self.cfg.directory, name + ".json"),
            json.dumps(manifest, indent=1).encode("utf-8"))
        metrics.TRAIN_CHECKPOINTS.inc(status="saved")
        self._retain()
        return blob_path

    def _retain(self) -> None:
        """Keep the newest ``keep`` COMMITTED checkpoints; everything
        else goes — including blobs whose manifest never landed (a
        crash in the blob->manifest window, or a torn-injected shear):
        they are invisible to resume, and factor blobs are the bytes
        that matter at scale. Manifests drop before their blobs so a
        half-deleted pair reads as torn (-> skipped), never intact.
        Runs after a successful save, so the current pair is always in
        the kept set and no in-flight blob can be swept."""
        kept = set(sorted(self._steps(), reverse=True)[:self.cfg.keep])
        for path in glob.glob(os.path.join(self.cfg.directory,
                                           "ckpt-*.json")) + \
                glob.glob(os.path.join(self.cfg.directory,
                                       "ckpt-*.npz")):
            m = re.search(r"ckpt-(\d{8})\.(?:json|npz)$",
                          os.path.basename(path))
            if m is None or int(m.group(1)) in kept:
                continue
            try:
                os.unlink(path)
            except OSError:  # pragma: no cover - already gone
                pass

    def _steps(self) -> List[int]:
        out = []
        for p in glob.glob(os.path.join(self.cfg.directory,
                                        "ckpt-*.json")):
            m = _CKPT_RE.search(os.path.basename(p))
            if m:
                out.append(int(m.group(1)))
        return out

    # -- read path -------------------------------------------------------

    def _read_manifest(self, step: int) -> Optional[dict]:
        """Parsed manifest, or None when torn (missing/truncated JSON,
        mid-multibyte truncation included)."""
        path = os.path.join(self.cfg.directory,
                            _ckpt_name(step) + ".json")
        try:
            with open(path, "rb") as f:
                data = json.loads(f.read().decode("utf-8"))
        except (OSError, ValueError, UnicodeDecodeError):
            return None
        if not isinstance(data, dict) or "sha256" not in data \
                or "fingerprint" not in data or "file" not in data:
            return None
        return data

    def resume_state(self) -> Optional[Tuple[int, np.ndarray, np.ndarray]]:
        """The newest intact, fingerprint-matching checkpoint as
        ``(step, X, Y)``; None for a fresh start (empty/unreadable
        directory). Torn manifests/blobs fall back to the previous
        intact checkpoint (with a WARNING + metric); the first INTACT
        manifest with a foreign fingerprint refuses loudly."""
        from predictionio_tpu_torch.utils import metrics

        if not self.cfg.resume:
            return None
        for step in sorted(self._steps(), reverse=True):
            manifest = self._read_manifest(step)
            if manifest is None:
                logger.warning(
                    "checkpoint %s: torn manifest — falling back to "
                    "the previous checkpoint", _ckpt_name(step))
                metrics.TRAIN_CHECKPOINTS.inc(status="torn_skipped")
                continue
            if manifest["fingerprint"] != self.fingerprint:
                raise CheckpointMismatchError(
                    f"checkpoint {_ckpt_name(step)} in "
                    f"{self.cfg.directory} was written for a different "
                    f"training input (fingerprint "
                    f"{manifest['fingerprint'][:12]}… vs this run's "
                    f"{self.fingerprint[:12]}…): data layout, "
                    "ALSParams, solver/precision statics or entity "
                    "maps differ. Refusing to resume; point "
                    "--checkpoint-dir elsewhere or retrain from "
                    "scratch.")
            blob_path = os.path.join(self.cfg.directory,
                                     str(manifest["file"]))
            state = self._load_blob(blob_path, manifest)
            if state is None:
                logger.warning(
                    "checkpoint %s: torn blob — falling back to the "
                    "previous checkpoint", _ckpt_name(step))
                metrics.TRAIN_CHECKPOINTS.inc(status="torn_skipped")
                continue
            X, Y = state
            logger.info("resuming from checkpoint %s (iteration %d/%d)",
                        _ckpt_name(step), step, self.total)
            metrics.TRAIN_CHECKPOINTS.inc(status="resumed")
            extra = manifest.get("extra")
            self.resumed_extra = extra if isinstance(extra, dict) else {}
            return int(manifest["step"]), X, Y
        if self._steps() or glob.glob(os.path.join(
                self.cfg.directory, "ckpt-*.npz")):
            logger.warning(
                "no intact checkpoint in %s (all torn/uncommitted); "
                "starting from scratch", self.cfg.directory)
        return None

    @staticmethod
    def _load_blob(path: str, manifest: dict
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        if hashlib.sha256(blob).hexdigest() != manifest["sha256"]:
            return None
        try:
            with np.load(io.BytesIO(blob), allow_pickle=False) as z:
                return (np.asarray(z["X"], dtype=np.float32),
                        np.asarray(z["Y"], dtype=np.float32))
        except (OSError, ValueError, KeyError):  # pragma: no cover
            return None


def checkpointer_for(layout: Sequence, params: Any, solver: str,
                     precision: str, dtype: Any = None
                     ) -> Optional["TrainCheckpointer"]:
    """The active checkpointer for one ``train_als*`` call, or None when
    checkpointing is off. Callers gate on ``$PIO_CHECKPOINT_DIR`` before
    importing this module, so the inactive path costs one env lookup."""
    cfg = resolve_config(params)
    if cfg is None:
        return None
    fp = training_fingerprint(layout, params, solver, precision, dtype)
    return TrainCheckpointer(cfg, fp,
                             int(getattr(params, "num_iterations", 0)))


# ---------------------------------------------------------------------------
# The chunked outer loop
# ---------------------------------------------------------------------------

def _factors_finite(X, Y) -> bool:
    """One device reduction over both factor carries, one scalar to the
    host (a sharded carry reduces each of its blocks)."""
    import torch

    if hasattr(X, "all_finite"):
        return X.all_finite() and Y.all_finite()
    return bool((torch.isfinite(X).all() & torch.isfinite(Y).all()).item())


def _synchronize(X) -> None:
    """Wait for the work queued on ``X``'s device (a no-op on the CPU)."""
    if X.device.type == "cuda":
        import torch

        torch.cuda.synchronize(X.device)


def chunk_schedule(total: int, every: Optional[int]) -> List[int]:
    """Iterations per chunk: ``every``-sized chunks plus the remainder.
    ``every`` in (None, 0) or >= total collapses to one chunk."""
    total = int(total)
    if total <= 0:
        return []
    every = int(every or 0)
    if every <= 0 or every >= total:
        return [total]
    out = [every] * (total // every)
    if total % every:
        out.append(total % every)
    return out


# ---------------------------------------------------------------------------
# Chunk-boundary telemetry (pure observer)
#
# When the trainer hands the loop an ``objective`` closure (the
# [fit, l2, finite] pack from ops/als.py — absent under
# PIO_TRAIN_TELEMETRY=0), the per-chunk finite guard is upgraded to a
# graded loss sample: one small copy to the host per chunk, but the abort
# message can now say WHAT the loss was doing before the NaN, every
# sample lands in the append-only run log, and the operator surfaces
# (metrics gauges, train.chunk spans, the live progress meter) light up.
# The factor math is untouched either way — the purity suite gates
# byte-identity on/off.
# ---------------------------------------------------------------------------

# the `pio train` live progress meter binds its renderer here; any
# other embedder can too. Observer-only: exceptions are swallowed.
_progress_cb: contextvars.ContextVar[Optional[Callable[[dict], None]]] = \
    contextvars.ContextVar("pio_train_progress", default=None)


@contextlib.contextmanager
def progress_scope(callback: Callable[[dict], None]):
    """Bind a per-chunk progress callback (dicts with step/total/loss/
    wallSeconds/runId) for training runs inside the scope."""
    token = _progress_cb.set(callback)
    try:
        yield
    finally:
        _progress_cb.reset(token)


def _emit_progress(payload: dict) -> None:
    cb = _progress_cb.get()
    if cb is None:
        return
    try:
        cb(payload)
    except Exception:  # the meter must never kill training
        logger.debug("progress callback failed", exc_info=True)


def _loss_clause(last_loss) -> str:
    """The divergence message's loss postscript: what the objective was
    doing at the last finite sample (``(step, fit, l2, total)``)."""
    if last_loss is None:
        return "; no finite loss sample was recorded"
    s, fit, l2, tot = last_loss
    return (f"; last finite loss total={tot:.6g} (fit={fit:.6g}, "
            f"l2={l2:.6g}) at iteration {s}")


def _open_runlog(ckpt: TrainCheckpointer, step: int, total: int):
    """The run-history lane for one chunked run: a resume reuses the
    run id pinned in the manifest it restored (appending to the SAME
    history, tail-repaired to the resumed step), a fresh run mints one.
    Returns ``(run_id, RunLog-or-None)`` — telemetry survives a
    read-only runs/ directory by dropping the log, never the run."""
    from predictionio_tpu_torch.workflow import runlog as _runlog

    rid = ckpt.resumed_extra.get("runId")
    run_id = rid if isinstance(rid, str) and rid else _runlog.new_run_id()
    try:
        rl = _runlog.RunLog.open(
            ckpt.directory, run_id, resume_step=step,
            header={"totalIterations": total,
                    "checkpointEvery": int(ckpt.every)})
    except OSError as e:  # pragma: no cover - unwritable runs dir
        logger.warning("run log unavailable (%s); training continues "
                       "without run history", e)
        return run_id, None
    return run_id, rl


def _chunk_sample(rl, step: int, total: int, n: int, loss: Any,
                  wall_s: float, device_s: Optional[float],
                  blob_path: Optional[str], extra: Optional[dict] = None,
                  device: Any = None) -> None:
    """Append one run-log sample (no-op without a log); ``device`` is
    the factors' (its memory in use is recorded)."""
    if rl is None:
        return
    from predictionio_tpu_torch.workflow import runlog as _runlog

    ckpt_bytes = None
    if blob_path is not None:
        try:
            ckpt_bytes = os.path.getsize(blob_path)
        except OSError:
            pass
    sample = {
        "step": int(step), "totalIterations": int(total),
        "chunkIterations": int(n),
        "wallSeconds": round(float(wall_s), 6),
        "deviceSeconds": None if device_s is None
        else round(float(device_s), 6),
        "loss": loss,
        "hbmBytesInUse": _runlog.hbm_bytes_in_use(device),
        "checkpointBytes": ckpt_bytes,
        "at": _dt.datetime.now(tz=_dt.timezone.utc).isoformat(),
    }
    if extra:
        sample.update(extra)
    rl.append(sample)


def _observe_chunk(rl, run_id: Optional[str], step: int, total: int,
                   n: int, fit: float, l2: float, wall_s: float,
                   device_s: Optional[float], blob_path: Optional[str],
                   device: Any = None) -> Tuple[int, float, float, float]:
    """Everything the operator sees from one finite serial chunk:
    metrics, the ``train.chunk`` span, the run-log sample, the live
    progress line. Returns the ``(step, fit, l2, total)`` tuple the
    divergence message quotes as the last finite sample."""
    from predictionio_tpu_torch.utils import metrics, tracing

    total_loss = fit + l2
    metrics.TRAIN_LOSS.set(fit, component="fit")
    metrics.TRAIN_LOSS.set(l2, component="l2")
    metrics.TRAIN_LOSS.set(total_loss, component="total")
    metrics.TRAIN_CHUNK_SECONDS.observe(wall_s)
    end = tracing.span_now()
    tracing.record_completed_span(
        "train.chunk", start=end - wall_s, end=end,
        attributes={"step": int(step), "totalIterations": int(total),
                    "chunkIterations": int(n), "lossFit": fit,
                    "lossL2": l2, "lossTotal": total_loss})
    _chunk_sample(rl, step, total, n,
                  {"fit": fit, "l2": l2, "total": total_loss},
                  wall_s, device_s, blob_path, device=device)
    _emit_progress({"step": int(step), "total": int(total),
                    "loss": total_loss, "fit": fit, "l2": l2,
                    "wallSeconds": float(wall_s), "runId": run_id})
    return (int(step), fit, l2, total_loss)


def run_chunked(run_iters: Callable[[Any, Any, int], Tuple[Any, Any]],
                X: Any, Y: Any, total_iterations: int,
                ckpt: Optional[TrainCheckpointer], *,
                to_host: Callable[[Any], np.ndarray],
                from_host: Callable[[np.ndarray], Any],
                objective: Optional[Callable[[Any, Any], Any]] = None
                ) -> Tuple[Any, Any]:
    """Drive ``run_iters(X, Y, n) -> (X, Y)`` (the trainer's iteration
    loop over ``n`` iterations, on torch factor tensors) through the
    checkpoint lifecycle.

    ``ckpt=None`` is exactly the unchunked call. Otherwise: resume from
    the newest intact checkpoint (fingerprint-gated), run
    ``ckpt.every``-sized chunks, and between chunks guard finiteness on
    the device, save an atomic checkpoint, and honor the preemption
    flag. ``to_host``/``from_host`` are the caller's placement policy
    (host fp32 numpy / a put in the factor dtype on the factors'
    device), so the uniform and bucketed trainers share this loop.

    ``objective`` (when telemetry is on) returns the fused
    ``[fit, l2, finite]`` pack for the current carries; it replaces the
    boolean finite guard with a graded one and feeds the run log,
    metrics, spans and progress meter — observer-only by contract."""
    total = int(total_iterations)
    if ckpt is None:
        return run_iters(X, Y, total)
    from predictionio_tpu_torch.utils import metrics

    step = 0
    resumed = ckpt.resume_state()
    if resumed is not None:
        step, Xh, Yh = resumed
        if step > total:
            raise CheckpointMismatchError(
                f"checkpoint step {step} exceeds this run's "
                f"num_iterations={total}")
        if tuple(Xh.shape) != tuple(X.shape) \
                or tuple(Yh.shape) != tuple(Y.shape):
            # refuse a snapshot whose factor shapes do not fit this run
            # instead of failing inside the loop
            raise CheckpointMismatchError(
                f"checkpoint factor shapes X{tuple(Xh.shape)}/"
                f"Y{tuple(Yh.shape)} do not match this run's "
                f"X{tuple(X.shape)}/Y{tuple(Y.shape)} "
                "(a different padding); refusing to "
                "resume")
        X, Y = from_host(Xh), from_host(Yh)
    rl = run_id = extra = None
    last_loss = None  # (step, fit, l2, total) of the newest finite sample
    if objective is not None:
        run_id, rl = _open_runlog(ckpt, step, total)
        extra = {"runId": run_id}
    try:
        for n in chunk_schedule(total - step, ckpt.every):
            t0 = _time.perf_counter()
            X, Y = run_iters(X, Y, int(n))
            pack = device_s = None
            if objective is not None:
                # graded guard: the objective pack carries the finite
                # reduction with the loss, one copy to the host per
                # chunk. Synchronise first so deviceSeconds is the
                # chunk's compute window alone.
                _synchronize(X)
                device_s = _time.perf_counter() - t0
                pack = np.asarray(objective(X, Y).cpu(), dtype=np.float64)
                finite_ok = bool(pack[2] == 1.0)
            else:
                # on-device finite guard: one scalar reduction per chunk
                finite_ok = _factors_finite(X, Y)
            step += n
            # a diverged state is never checkpointed, so the last
            # intact checkpoint survives for post-mortem/restart
            if not finite_ok:
                metrics.TRAIN_DIVERGED.inc()
                raise TrainingDivergedError(
                    f"non-finite factors after iteration {step}/{total} "
                    f"(the chunk of {int(n)} iterations ending there); "
                    f"aborting (last intact checkpoint retained in "
                    f"{ckpt.directory})" + _loss_clause(last_loss))
            blob_path = ckpt.save(step, to_host(X), to_host(Y),
                                  extra=extra)
            if pack is not None:
                last_loss = _observe_chunk(
                    rl, run_id, step, total, int(n),
                    float(pack[0]), float(pack[1]),
                    _time.perf_counter() - t0, device_s, blob_path,
                    device=X.device)
            if step < total and stop_requested():
                raise TrainingPreempted(
                    f"stop requested: checkpoint saved at iteration "
                    f"{step}/{total} in {ckpt.directory}; resume with "
                    f"pio train --resume")
    finally:
        if rl is not None:
            rl.close()
    return X, Y


# ---------------------------------------------------------------------------
# The grid (multi-config) chunked loop
# ---------------------------------------------------------------------------

def _grid_loss_entry(step: int, pack: np.ndarray, alive: np.ndarray
                     ) -> dict:
    """One grid history / run-log sample: per-config component lists
    with ``None`` holes for dead configs."""
    fit: List[Optional[float]] = []
    l2: List[Optional[float]] = []
    tot: List[Optional[float]] = []
    for i, ok in enumerate(alive):
        if ok:
            fit.append(float(pack[i, 0]))
            l2.append(float(pack[i, 1]))
            tot.append(float(pack[i, 0] + pack[i, 1]))
        else:
            fit.append(None)
            l2.append(None)
            tot.append(None)
    return {"step": int(step), "fit": fit, "l2": l2, "total": tot}


def _observe_grid_chunk(rl, run_id: Optional[str], step: int, total: int,
                        n: int, entry: dict, alive: np.ndarray,
                        wall_s: float, device_s: Optional[float],
                        blob_path: Optional[str], device: Any = None) -> None:
    """The grid's :func:`_observe_chunk`: the gauges follow the best
    (lowest-total) alive config; the span and the run-log sample carry
    the per-config lists."""
    from predictionio_tpu_torch.utils import metrics, tracing

    best = None
    for i, t in enumerate(entry["total"]):
        if t is not None and (best is None or t < entry["total"][best]):
            best = i
    if best is not None:
        metrics.TRAIN_LOSS.set(entry["fit"][best], component="fit")
        metrics.TRAIN_LOSS.set(entry["l2"][best], component="l2")
        metrics.TRAIN_LOSS.set(entry["total"][best], component="total")
    metrics.TRAIN_CHUNK_SECONDS.observe(wall_s)
    end = tracing.span_now()
    tracing.record_completed_span(
        "train.chunk", start=end - wall_s, end=end,
        attributes={"step": int(step), "totalIterations": int(total),
                    "chunkIterations": int(n),
                    "aliveConfigs": int(np.count_nonzero(alive)),
                    "bestConfig": best,
                    "lossTotal": None if best is None
                    else entry["total"][best]})
    _chunk_sample(rl, step, total, n,
                  {"fit": entry["fit"], "l2": entry["l2"],
                   "total": entry["total"]},
                  wall_s, device_s, blob_path,
                  extra={"aliveConfigs": [bool(a) for a in alive]},
                  device=device)
    _emit_progress({"step": int(step), "total": int(total),
                    "loss": None if best is None
                    else entry["total"][best],
                    "aliveConfigs": int(np.count_nonzero(alive)),
                    "wallSeconds": float(wall_s), "runId": run_id})


def _grid_deaths(died_step: Dict[int, int]) -> str:
    """The all-dead abort's roster: which configs died, and when."""
    return ", ".join(f"config {i} at iteration {died_step[i]}"
                     for i in sorted(died_step))


def _grid_factors_finite(X, Y) -> np.ndarray:
    """Per-config finiteness of stacked ``[k, N, R]`` carries: one
    device reduction to a ``[k]`` bool vector on the host."""
    import torch

    k = X.shape[0]
    ok = torch.isfinite(X).reshape(k, -1).all(dim=1) \
        & torch.isfinite(Y).reshape(k, -1).all(dim=1)
    return ok.cpu().numpy()


def _mask_dead_configs(X, Y, alive: np.ndarray):
    """Zero the factor lanes of dead configs on the device. Zero factors
    are usually a fixed point of the half-step, but not when the cause
    is an overflowing hyperparameter (``inf * 0 = nan`` regenerates NaN
    from zeros), so the loop re-applies the mask after every chunk while
    a dead lane exists: one elementwise ``where`` each."""
    import torch

    m = torch.as_tensor(np.asarray(alive, dtype=bool),
                        device=X.device)[:, None, None]
    return (torch.where(m, X, torch.zeros((), dtype=X.dtype,
                                          device=X.device)),
            torch.where(m, Y, torch.zeros((), dtype=Y.dtype,
                                          device=Y.device)))


def run_chunked_grid(run_iters: Callable[[Any, Any, int], Tuple[Any, Any]],
                     X: Any, Y: Any, total_iterations: int,
                     ckpt: Optional[TrainCheckpointer], *,
                     to_host: Callable[[Any], np.ndarray],
                     from_host: Callable[[np.ndarray], Any],
                     objective: Optional[Callable[[Any, Any], Any]] = None,
                     history: Optional[List[dict]] = None
                     ) -> Tuple[Any, Any, np.ndarray]:
    """:func:`run_chunked` for the config grid: the carries are stacked
    ``[k, ...]`` and divergence is per config. A non-finite config is
    masked out (factors zeroed, see :func:`_mask_dead_configs`) and
    counted once in ``pio_train_diverged_total`` while its neighbours
    keep training; the run aborts (``TrainingDivergedError``) only when
    every config is dead. The alive mask rides the manifest's ``extra``
    block (``aliveConfigs``, with ``gridK``), so a resume does not bring
    a masked config back. Returns ``(X, Y, alive)``, ``alive`` a host
    ``[k]`` bool vector.

    ``objective`` returns the ``[k, 3]`` loss packs (the graded guard);
    the samples go to ``history`` (the leaderboard's loss trajectories)
    and the run log. The chunked lane samples every chunk; without a
    checkpointer one sample at the end still grades the result."""
    from predictionio_tpu_torch.utils import metrics

    total = int(total_iterations)
    k = int(X.shape[0])
    alive = np.ones(k, dtype=bool)
    died_step: Dict[int, int] = {}
    last_totals: List[Optional[float]] = [None] * k

    def guard_and_mask(X, Y, alive, step, finite=None):
        if finite is None:
            finite = _grid_factors_finite(X, Y)
        finite = np.asarray(finite, dtype=bool)
        for idx in np.flatnonzero(alive & ~finite):
            idx = int(idx)
            died_step[idx] = int(step)
            lt = last_totals[idx]
            logger.warning(
                "grid config %d diverged after iteration %d/%d%s; "
                "masking it out (factors zeroed, neighbors "
                "unaffected)", idx, step, total,
                "" if lt is None
                else f" (last finite loss total={lt:.6g})")
            metrics.TRAIN_DIVERGED.inc()
        alive = alive & finite
        if not alive.all():
            # every chunk while a dead lane exists, not just on the
            # transition: an inf hyperparameter regenerates NaN from the
            # zeroed factors (inf * 0)
            X, Y = _mask_dead_configs(X, Y, alive)
        return X, Y, alive

    if ckpt is None:
        X, Y = run_iters(X, Y, total)
        pack = None
        if objective is not None:
            pack = np.asarray(objective(X, Y).cpu(), dtype=np.float64)
            X, Y, alive = guard_and_mask(X, Y, alive, total,
                                         pack[:, 2] == 1.0)
        else:
            X, Y, alive = guard_and_mask(X, Y, alive, total)
        if not alive.any():
            raise TrainingDivergedError(
                f"every grid config diverged within {total} "
                f"iterations ({_grid_deaths(died_step)}); nothing "
                "to return")
        if pack is not None and history is not None:
            history.append(_grid_loss_entry(total, pack, alive))
        return X, Y, alive

    step = 0
    resumed = ckpt.resume_state()
    if resumed is not None:
        step, Xh, Yh = resumed
        if step > total:
            raise CheckpointMismatchError(
                f"checkpoint step {step} exceeds this run's "
                f"num_iterations={total}")
        if tuple(Xh.shape) != tuple(X.shape) \
                or tuple(Yh.shape) != tuple(Y.shape):
            raise CheckpointMismatchError(
                f"checkpoint factor shapes X{tuple(Xh.shape)}/"
                f"Y{tuple(Yh.shape)} do not match this grid's "
                f"X{tuple(X.shape)}/Y{tuple(Y.shape)}; "
                "refusing to resume")
        saved = ckpt.resumed_extra.get("aliveConfigs")
        if isinstance(saved, list) and len(saved) == k:
            alive = np.asarray(saved, dtype=bool)
        X, Y = from_host(Xh), from_host(Yh)
        if not alive.all():
            X, Y = _mask_dead_configs(X, Y, alive)
    rl = run_id = None
    if objective is not None:
        run_id, rl = _open_runlog(ckpt, step, total)
    try:
        for n in chunk_schedule(total - step, ckpt.every):
            t0 = _time.perf_counter()
            X, Y = run_iters(X, Y, int(n))
            pack = device_s = finite = None
            if objective is not None:
                _synchronize(X)
                device_s = _time.perf_counter() - t0
                pack = np.asarray(objective(X, Y).cpu(), dtype=np.float64)
                finite = pack[:, 2] == 1.0
            step += n
            X, Y, alive = guard_and_mask(X, Y, alive, step, finite)
            if not alive.any():
                raise TrainingDivergedError(
                    f"every grid config diverged by iteration {step}/"
                    f"{total} ({_grid_deaths(died_step)}); aborting "
                    f"(last intact checkpoint retained in "
                    f"{ckpt.directory})")
            extra = {"aliveConfigs": [bool(a) for a in alive],
                     "gridK": k}
            if run_id is not None:
                extra["runId"] = run_id
            blob_path = ckpt.save(step, to_host(X), to_host(Y),
                                  extra=extra)
            if pack is not None:
                entry = _grid_loss_entry(step, pack, alive)
                if history is not None:
                    history.append(entry)
                for i, t in enumerate(entry["total"]):
                    if t is not None:
                        last_totals[i] = t
                _observe_grid_chunk(rl, run_id, step, total, int(n),
                                    entry, alive,
                                    _time.perf_counter() - t0,
                                    device_s, blob_path, device=X.device)
            if step < total and stop_requested():
                raise TrainingPreempted(
                    f"stop requested: grid checkpoint saved at "
                    f"iteration {step}/{total} in {ckpt.directory}; "
                    f"rerun to resume")
    finally:
        if rl is not None:
            rl.close()
    return X, Y, alive
