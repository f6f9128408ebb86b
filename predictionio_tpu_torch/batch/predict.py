"""Batch prediction: the ``pio batchpredict`` engine.

The port's copy of ``predictionio_tpu/batch/predict.py``. A deployed
server answers one query per request; ``pio batchpredict`` scores a
whole query set offline (the nightly top-k for every user):

- **Input**: a JSONL query file (one query object per line, the wire
  format of ``POST /queries.json``), or one query per known entity
  synthesized from the event store's materialized entity properties
  (``PEventStore.aggregate_properties``).
- **Serve path**: each query runs the whole DASE serve path, typed
  extraction (``query_from_json``) -> ``supplement`` -> each
  algorithm's ``batch_predict`` -> ``serve`` with the original query,
  so a result is the one the deployed server gives for that query. The
  recommendation template's ``batch_predict`` sends each chunk's
  known-user queries of one k to ``DeviceTopK.users_topk``: one launch
  of the fused top-k kernel and one copy back.
- **Chunking**: fixed chunks, their size rounded up to the serving
  layer's power-of-two bucket (``ops.serving.bucket_size``), or
  ``--query-partitions`` balanced spans (``parallel.mesh.shard_spans``).
- **Restartability**: each chunk lands in its own shard file, written
  atomically, and ``manifest.json`` (with its append-only journal)
  records chunk -> input span -> file -> sha256 -> status. A rerun checks
  the input fingerprint, skips the chunks whose shard still matches its
  checksum and re-scores the torn or missing ones.
- **Observability**: ``pio_batchpredict_queries_total``,
  ``pio_batchpredict_chunk_seconds``, ``pio_batchpredict_queries_per_sec``;
  one trace root per run with a span per scored chunk.

The manifest and the shard files are the JAX package's formats key for
key, so each package's :func:`read_results` reads the other's output.
Output formats: ``jsonl`` (one ``{"prediction": ..., "query": ...}``
object per line) or ``npz`` (the record strings as one column, with the
span). The context is a :class:`ComputeContext` naming the device
(None = cuda). A model that lives on a device mesh (``ShardedALSModel``
under a ``PAlgorithm``, stored ``RETRAIN``) is trained again at load,
and each chunk's user queries are scored against its shards on their
devices, with no host copy of its factors. The port's model unpickler
refuses the JAX package's classes, naming them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import logging
import os
import sys
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.controller.algorithms import ordered_batch_results
from predictionio_tpu_torch.core.context import (
    ComputeContext,
    workflow_context,
)
from predictionio_tpu_torch.parallel.mesh import shard_spans
from predictionio_tpu_torch.utils import metrics
from predictionio_tpu_torch.utils.tracing import span, trace_scope
from predictionio_tpu_torch.workflow.create_server import (
    Deployment,
    build_deployment,
    query_from_json,
    resolve_engine_instance,
    serve_query,
    to_jsonable,
    warm_up,
)

logger = logging.getLogger("pio.torch.batchpredict")

MANIFEST_VERSION = 1
MANIFEST_NAME = "manifest.json"
JOURNAL_NAME = MANIFEST_NAME + ".journal"
FORMATS = ("jsonl", "npz")


@dataclasses.dataclass
class BatchPredictConfig:
    """One batch-prediction job (the ``pio batchpredict`` arguments)."""

    output_dir: str
    engine_instance_id: Optional[str] = None
    engine_id: str = "default"
    engine_version: str = "default"
    engine_variant: str = "engine.json"
    # exactly one query source: a JSONL file, or one query per known
    # entity of the given type in the event store
    input_path: Optional[str] = None
    synthesize_app: Optional[str] = None
    synthesize_entity_type: str = "user"
    synthesize_field: str = "user"
    synthesize_base: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)
    synthesize_channel: Optional[str] = None
    # fixed chunk_size (power-of-two aligned), or a partition count
    chunk_size: int = 256
    query_partitions: Optional[int] = None
    format: str = "jsonl"
    # fault injection for the crash-resume tests: raise after K chunks
    fail_after_chunks: Optional[int] = None


# -- query sources ---------------------------------------------------------

def read_queries_jsonl(path: str) -> List[Dict[str, Any]]:
    """One JSON query object per line (blank lines skipped)."""
    queries: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: invalid JSON: {e}") \
                    from e
            if not isinstance(obj, dict):
                raise ValueError(
                    f"{path}:{lineno}: query must be a JSON object")
            queries.append(obj)
    return queries


def synthesize_queries(app_name: str, entity_type: str = "user",
                       field: str = "user",
                       channel_name: Optional[str] = None,
                       base: Optional[Mapping[str, Any]] = None
                       ) -> List[Dict[str, Any]]:
    """One query per known entity, in sorted entity-id order, from the
    materialized entity-property aggregation (O(current entities))."""
    from predictionio_tpu_torch.data.store import PEventStore

    props = PEventStore.aggregate_properties(
        app_name=app_name, entity_type=entity_type,
        channel_name=channel_name)
    base = dict(base or {})
    if field in base:
        raise ValueError(
            f"synthesize_base must not set the entity field {field!r}")
    return [{**base, field: eid} for eid in sorted(props)]


# -- manifest and shard files ----------------------------------------------

def _canonical_query_lines(queries: Sequence[Mapping[str, Any]]) -> List[str]:
    return [json.dumps(q, sort_keys=True, separators=(",", ":"))
            for q in queries]


def input_fingerprint(query_lines: Sequence[str]) -> str:
    """sha256 over the canonical query stream: a resume refuses to mix
    shards scored from different inputs."""
    h = hashlib.sha256()
    for line in query_lines:
        h.update(line.encode("utf-8"))
        h.update(b"\n")
    return h.hexdigest()


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _atomic_write(path: str, data: bytes) -> None:
    from predictionio_tpu_torch.data.storage.localfs import atomic_write_bytes

    atomic_write_bytes(path, data)


def chunk_spans(n: int, chunk_size: int,
                query_partitions: Optional[int] = None
                ) -> List[Tuple[int, int]]:
    """The chunk plan: ``query_partitions`` balanced spans when given,
    else fixed chunks of ``chunk_size`` rounded up to the serving
    bucket it dispatches at."""
    if query_partitions is not None:
        return shard_spans(n, query_partitions)
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive, got {chunk_size}")
    from predictionio_tpu_torch.ops.serving import bucket_size

    c = bucket_size(min(chunk_size, max(n, 1)), lo=8)
    return [(i, min(i + c, n)) for i in range(0, n, c)]


class Manifest:
    """``manifest.json``, the restart contract: chunk id -> input span ->
    shard file -> checksum -> status, and the input fingerprint.

    Each finished chunk appends one ``{"id", "sha256"}`` line to the
    journal (``manifest.json.journal``); the manifest is rewritten once,
    at the end of a run. ``load`` replays the journal, so a killed run's
    finished chunks are visible to its resume."""

    def __init__(self, data: Dict[str, Any]):
        self.data = data

    @classmethod
    def fresh(cls, instance_id: str, fmt: str, source: str,
              fingerprint: str, count: int,
              spans: Sequence[Tuple[int, int]]) -> "Manifest":
        ext = "jsonl" if fmt == "jsonl" else "npz"
        return cls({
            "formatVersion": MANIFEST_VERSION,
            "engineInstanceId": instance_id,
            "format": fmt,
            "input": {"source": source, "sha256": fingerprint,
                      "count": count},
            "chunks": [
                {"id": i, "start": start, "count": stop - start,
                 "file": f"part-{i:05d}.{ext}", "status": "pending",
                 "sha256": None}
                for i, (start, stop) in enumerate(spans)
            ],
        })

    @classmethod
    def load(cls, path: str) -> Optional["Manifest"]:
        if not os.path.exists(path):
            return None
        try:
            with open(path, "r", encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            # a hand-edited manifest restarts the job (the atomic write
            # never leaves a torn one)
            logger.warning("unreadable manifest at %s; starting fresh",
                           path)
            return None
        if not isinstance(data, dict) \
                or data.get("formatVersion") != MANIFEST_VERSION:
            return None
        manifest = cls(data)
        manifest._apply_journal(path + ".journal")
        return manifest

    def _apply_journal(self, journal_path: str) -> None:
        """Fold the journal's completion lines into the chunk table; a
        torn last line (killed mid-append) is ignored, and its chunk
        re-scores."""
        if not os.path.exists(journal_path):
            return
        by_id = {c["id"]: c for c in self.data.get("chunks", ())}
        with open(journal_path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                    chunk = by_id.get(entry["id"])
                    sha = entry["sha256"]
                except (json.JSONDecodeError, TypeError, KeyError):
                    continue
                if chunk is not None and isinstance(sha, str):
                    chunk["status"] = "done"
                    chunk["sha256"] = sha

    def save(self, path: str) -> None:
        _atomic_write(path, json.dumps(
            self.data, sort_keys=True, indent=1).encode("utf-8"))

    def matches(self, instance_id: str, fmt: str, fingerprint: str,
                count: int) -> bool:
        inp = self.data.get("input") or {}
        return (self.data.get("engineInstanceId") == instance_id
                and self.data.get("format") == fmt
                and inp.get("sha256") == fingerprint
                and inp.get("count") == count)

    @property
    def chunks(self) -> List[Dict[str, Any]]:
        return self.data["chunks"]


# -- the predictor ---------------------------------------------------------

class BatchPredictor:
    """Score a query stream through a loaded engine instance in chunks,
    writing restartable per-chunk shards."""

    def __init__(self, config: BatchPredictConfig,
                 ctx: Optional[ComputeContext] = None):
        if config.format not in FORMATS:
            raise ValueError(
                f"unknown output format {config.format!r}; "
                f"expected one of {FORMATS}")
        sources = (config.input_path is not None,
                   config.synthesize_app is not None)
        if sum(sources) != 1:
            raise ValueError(
                "exactly one query source required: --input or "
                "--synthesize-app")
        self.config = config
        self.ctx = ctx or workflow_context(mode="serving")
        self._deployment: Optional[Deployment] = None

    def load(self) -> Deployment:
        """Resolve and load the engine instance (as ``pio deploy`` does:
        ``build_deployment``), then warm it, so the first chunk pays no
        kernel build."""
        if self._deployment is None:
            cfg = self.config
            instance = resolve_engine_instance(
                cfg.engine_instance_id, cfg.engine_id,
                cfg.engine_version, cfg.engine_variant)
            dep = build_deployment(instance, self.ctx)
            warm_up(dep)
            self._deployment = dep
            logger.info("Engine instance %s loaded for batch prediction",
                        instance.id)
        return self._deployment

    def read_queries(self) -> List[Dict[str, Any]]:
        cfg = self.config
        if cfg.input_path is not None:
            return read_queries_jsonl(cfg.input_path)
        return synthesize_queries(
            cfg.synthesize_app, entity_type=cfg.synthesize_entity_type,
            field=cfg.synthesize_field,
            channel_name=cfg.synthesize_channel,
            base=cfg.synthesize_base)

    def score_chunk(self, dep: Deployment, query_dicts: Sequence[Mapping[str, Any]]
                    ) -> List[Any]:
        """One chunk through the whole DASE serve path, batched: typed
        extraction -> supplement -> each algorithm's ``batch_predict``
        -> serve with the original query. Results in input order."""
        query_cls = dep.algorithms[0].query_class
        typed = [query_from_json(q, query_cls) for q in query_dicts]
        indexed = list(enumerate(typed))
        supplemented = [(qx, dep.serving.supplement_base(q))
                        for qx, q in indexed]
        per_algo: List[List[Any]] = []
        for algo, model in zip(dep.algorithms, dep.models):
            results = algo.batch_predict_base(self.ctx, model, supplemented)
            per_algo.append(ordered_batch_results(
                supplemented, results, who=type(algo).__name__))
        return [
            dep.serving.serve_base(q, [col[qx] for col in per_algo])
            for qx, q in indexed
        ]

    def serve_one(self, query_dict: Mapping[str, Any]) -> Any:
        """The looped single-query path (what the deployed server does
        per request): the reference a chunk's results must equal."""
        dep = self.load()
        query = query_from_json(dict(query_dict),
                                dep.algorithms[0].query_class)
        return serve_query(dep, query)

    @staticmethod
    def _render_records(query_lines: Sequence[str],
                        predictions: Sequence[Any]) -> List[str]:
        """Wire records ``{"prediction": ..., "query": ...}``, keys
        sorted: the same predictions give the same bytes."""
        out = []
        for line, p in zip(query_lines, predictions):
            rendered = json.dumps(to_jsonable(p), sort_keys=True,
                                  separators=(",", ":"))
            out.append('{"prediction":' + rendered
                       + ',"query":' + line + "}")
        return out

    def _write_shard(self, path: str, records: List[str],
                     start: int) -> str:
        """Write one shard atomically; returns the sha256 of its bytes
        (hashed in memory, not re-read)."""
        if self.config.format == "jsonl":
            data = ("\n".join(records) + "\n").encode("utf-8")
        else:
            buf = io.BytesIO()
            np.savez_compressed(
                buf, format_version=np.int64(MANIFEST_VERSION),
                start=np.int64(start), count=np.int64(len(records)),
                records=np.asarray(records, dtype=np.str_))
            data = buf.getvalue()
        _atomic_write(path, data)
        return hashlib.sha256(data).hexdigest()

    def run(self) -> Dict[str, Any]:
        """Score everything, resuming from an earlier manifest when the
        input, instance and format still match; returns the summary. The
        run is one trace root with a span per scored chunk."""
        with trace_scope("pio.batchpredict",
                         attributes={"output": self.config.output_dir},
                         slow_exempt=True):
            return self._run()

    def _run(self) -> Dict[str, Any]:
        cfg = self.config
        dep = self.load()
        queries = self.read_queries()
        if not queries:
            # a bulk job over nothing is a misconfiguration
            raise ValueError(
                "no queries to score (empty input / no known entities "
                f"of type {cfg.synthesize_entity_type!r})"
                if cfg.input_path is None else
                f"no queries to score ({cfg.input_path} is empty)")
        query_lines = _canonical_query_lines(queries)
        fingerprint = input_fingerprint(query_lines)
        source = cfg.input_path or (
            f"synthesized:{cfg.synthesize_app}/{cfg.synthesize_entity_type}")

        os.makedirs(cfg.output_dir, exist_ok=True)
        manifest_path = os.path.join(cfg.output_dir, MANIFEST_NAME)
        manifest = Manifest.load(manifest_path)
        if manifest is not None and not manifest.matches(
                dep.instance.id, cfg.format, fingerprint, len(queries)):
            raise ValueError(
                f"{cfg.output_dir} holds results for a different job "
                "(engine instance, input fingerprint or format differ); "
                "use a fresh --output directory")
        journal_path = os.path.join(cfg.output_dir, JOURNAL_NAME)
        if manifest is None:
            spans = chunk_spans(len(queries), cfg.chunk_size,
                                cfg.query_partitions)
            manifest = Manifest.fresh(dep.instance.id, cfg.format, source,
                                      fingerprint, len(queries), spans)
            # a stale journal (manifest removed by hand) must not mark
            # fresh chunks done
            if os.path.exists(journal_path):
                os.unlink(journal_path)
            manifest.save(manifest_path)
        # a resume never rechunks: the manifest's spans are the layout the
        # finished shards were scored at

        scored = skipped = scored_queries = 0
        t_run = time.perf_counter()
        scoring_sec = 0.0
        journal = open(journal_path, "a", encoding="utf-8")
        try:
            for chunk in manifest.chunks:
                path = os.path.join(cfg.output_dir, chunk["file"])
                if chunk["status"] == "done" and chunk["sha256"] \
                        and os.path.exists(path) \
                        and _file_sha256(path) == chunk["sha256"]:
                    skipped += 1
                    metrics.BATCHPREDICT_QUERIES.inc(chunk["count"],
                                                     status="skipped")
                    continue
                # pending, torn or missing: (re)score the whole span
                if cfg.fail_after_chunks is not None \
                        and scored >= cfg.fail_after_chunks:
                    raise RuntimeError(
                        f"fault injection: stopping after {scored} chunks")
                start = chunk["start"]
                stop = start + chunk["count"]
                t0 = time.perf_counter()
                with span("batchpredict.chunk",
                          attributes={"chunk": chunk["id"],
                                      "queries": stop - start}):
                    predictions = self.score_chunk(dep,
                                                   queries[start:stop])
                    records = self._render_records(
                        query_lines[start:stop], predictions)
                    chunk["sha256"] = self._write_shard(path, records,
                                                        start)
                chunk["status"] = "done"
                # one completion line; the manifest is compacted once at
                # the end (a rewrite per chunk would be O(chunks^2))
                journal.write(json.dumps(
                    {"id": chunk["id"], "sha256": chunk["sha256"]},
                    separators=(",", ":")) + "\n")
                journal.flush()
                os.fsync(journal.fileno())
                took = time.perf_counter() - t0
                scoring_sec += took
                scored += 1
                scored_queries += stop - start
                metrics.BATCHPREDICT_QUERIES.inc(stop - start,
                                                 status="scored")
                metrics.BATCHPREDICT_CHUNK_LATENCY.observe(took)
                logger.info("chunk %d: %d queries in %.3fs",
                            chunk["id"], stop - start, took)
        finally:
            journal.close()
        manifest.save(manifest_path)  # compact: every chunk now final
        os.unlink(journal_path)

        qps = scored_queries / scoring_sec if scoring_sec > 0 else 0.0
        if scored:
            metrics.BATCHPREDICT_QPS.set(round(qps, 1))
        return {
            "outputDir": cfg.output_dir,
            "engineInstanceId": dep.instance.id,
            "format": cfg.format,
            "queries": len(queries),
            "chunks": len(manifest.chunks),
            "chunksScored": scored,
            "chunksSkipped": skipped,
            "wallSec": round(time.perf_counter() - t_run, 3),
            "scoringSec": round(scoring_sec, 3),
            "queriesPerSec": round(qps, 1),
        }


def run_batch_predict(config: BatchPredictConfig,
                      ctx: Optional[ComputeContext] = None
                      ) -> Dict[str, Any]:
    """Load, score, return the summary."""
    return BatchPredictor(config, ctx=ctx).run()


def read_results(output_dir: str) -> List[Dict[str, Any]]:
    """Every prediction of a finished run, in input-query order."""
    manifest = Manifest.load(os.path.join(output_dir, MANIFEST_NAME))
    if manifest is None:
        raise ValueError(f"no readable manifest under {output_dir}")
    out: List[Dict[str, Any]] = []
    for chunk in manifest.chunks:
        if chunk["status"] != "done":
            raise ValueError(
                f"chunk {chunk['id']} is {chunk['status']}; the run has "
                "not completed")
        path = os.path.join(output_dir, chunk["file"])
        if manifest.data["format"] == "jsonl":
            with open(path, "r", encoding="utf-8") as f:
                lines = [ln for ln in f.read().splitlines() if ln]
        else:
            z = np.load(path, allow_pickle=False)
            lines = z["records"].tolist()
        if len(lines) != chunk["count"]:
            raise ValueError(
                f"shard {chunk['file']} holds {len(lines)} records, "
                f"manifest says {chunk['count']}")
        out.extend(json.loads(ln) for ln in lines)
    return out


def run_smoke(device: Any = None) -> int:
    """Self-contained smoke (``pio batchpredict --smoke``): seed a tiny
    rating store in memory, train the recommendation template on
    ``device`` (None = cuda), batch-predict synthesized queries, crash
    after one chunk, resume, and check that (a) finished chunks were not
    re-scored and (b) the output equals a clean run's and the looped
    single-query path's."""
    import datetime as _dt
    import shutil
    import tempfile

    from predictionio_tpu_torch.controller.engine import EngineParams
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import StorageConfig
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.device import resolve_device
    from predictionio_tpu_torch.ops.als import ALSParams
    from predictionio_tpu_torch.templates.recommendation.engine import (
        DataSourceParams,
        engine_factory,
    )
    from predictionio_tpu_torch.workflow.core_workflow import run_train
    from predictionio_tpu_torch.workflow.create_workflow import (
        WorkflowConfig,
        new_engine_instance,
    )

    ctx = ComputeContext(device=resolve_device(device))
    factory_path = ("predictionio_tpu_torch.templates.recommendation.engine:"
                    "engine_factory")
    tmp = tempfile.mkdtemp(prefix="pio_bp_smoke_")
    storage.reset(StorageConfig(
        sources={"SMOKE": {"type": "memory"}},
        repositories={"METADATA": "SMOKE", "EVENTDATA": "SMOKE",
                      "MODELDATA": "SMOKE"}))
    try:
        aid = storage.get_metadata_apps().insert(App(0, "bpsmoke"))
        le = storage.get_levents()
        le.init(aid)
        rng = np.random.default_rng(0)
        t0 = _dt.datetime(2021, 1, 1, tzinfo=_dt.timezone.utc)
        le.insert_batch(
            # $set entities make the users known to the aggregation the
            # synthesis enumerates; the rate events feed the training read
            [Event(event="$set", entity_type="user", entity_id=f"u{u}",
                   properties={"active": True}, event_time=t0)
             for u in range(24)]
            + [Event(event="rate", entity_type="user", entity_id=f"u{u}",
                     target_entity_type="item",
                     target_entity_id=f"i{rng.integers(0, 12)}",
                     properties={"rating": float(rng.integers(1, 6))},
                     event_time=t0)
               for u in range(24) for _ in range(6)], aid)
        params = EngineParams(
            data_source_params=("", DataSourceParams(app_name="bpsmoke")),
            algorithm_params_list=[
                ("als", ALSParams(rank=4, num_iterations=2, seed=0))])
        instance = new_engine_instance(
            WorkflowConfig(engine_factory=factory_path), params)
        iid = run_train(engine_factory(), params, instance, ctx=ctx)
        assert iid is not None

        def cfg(out, **kw):
            return BatchPredictConfig(
                output_dir=out, engine_instance_id=iid,
                synthesize_app="bpsmoke",
                synthesize_base={"num": 3}, chunk_size=8, **kw)

        clean_dir = os.path.join(tmp, "clean")
        resumed_dir = os.path.join(tmp, "resumed")
        clean = run_batch_predict(cfg(clean_dir), ctx=ctx)
        try:
            run_batch_predict(cfg(resumed_dir, fail_after_chunks=1), ctx=ctx)
        except RuntimeError:
            pass  # the injected crash
        else:
            raise AssertionError("fault injection did not fire")
        partial = Manifest.load(os.path.join(resumed_dir, MANIFEST_NAME))
        done_before = {c["id"]: c["sha256"] for c in partial.chunks
                       if c["status"] == "done"}
        assert done_before, "no chunk completed before the injected crash"
        summary = run_batch_predict(cfg(resumed_dir), ctx=ctx)
        assert summary["chunksSkipped"] == len(done_before), summary
        after = Manifest.load(os.path.join(resumed_dir, MANIFEST_NAME))
        for c in after.chunks:
            if c["id"] in done_before:
                assert c["sha256"] == done_before[c["id"]], \
                    f"chunk {c['id']} was re-scored on resume"
        resumed = read_results(resumed_dir)
        assert resumed == read_results(clean_dir), \
            "resumed output differs from the clean single-pass run"

        # the looped single-query path on a sample
        bp = BatchPredictor(cfg(os.path.join(tmp, "probe")), ctx=ctx)
        for rec in resumed[:5]:
            single = to_jsonable(bp.serve_one(rec["query"]))
            assert single == rec["prediction"], \
                f"batch != single for {rec['query']}"
        print(f"[INFO] batchpredict smoke OK: {clean['queries']} queries, "
              f"{clean['chunks']} chunks, resume verified "
              f"({summary['chunksSkipped']} skipped / "
              f"{summary['chunksScored']} re-scored), "
              f"single-query parity verified.")
        return 0
    except AssertionError as e:
        print(f"[ERROR] batchpredict smoke failed: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        storage.reset()
