"""Query server: the deployed engine behind ``POST /queries.json``.

The port's copy of ``predictionio_tpu/workflow/create_server.py``, the
part one server needs: resolving an engine instance from storage
(``resolve_engine_instance``), loading its stored models into a
:class:`Deployment` (``build_deployment``, or
``deployment_from_models`` for models already in memory);
``serve_query`` (supplement -> predict per algorithm -> serve with the
original query, each stage a trace span); the wire JSON
(``to_jsonable`` / ``query_from_json``); and a threaded HTTP server with
``POST /queries.json``, ``POST /reload`` (swap to the latest completed
instance; an older one is refused with 409), ``POST /stop``, and the
observability routes under the JAX package's route labels: ``GET /``
(status), ``/healthz`` (the deployment, its device and the event store's
breaker), ``/metrics`` (Prometheus text), ``/stats.json``,
``/dispatches.json`` (the device flight recorder), ``/plugins.json``
(the output blockers and sniffers of
:mod:`~predictionio_tpu_torch.workflow.server_plugins`, run on every
prediction), ``/traces.json`` and ``/traces/<id>`` (``?format=perfetto``
or ``html``), and the operator's
``POST /profile/start`` and ``/profile/stop`` (a ``torch.profiler``
capture, gated by the ``server.json`` access key when one is set; 409
on a second start or an idle stop). Every request runs under
:class:`~predictionio_tpu_torch.utils.http_instrumentation.
InstrumentedHandlerMixin` (request ids, ``traceparent``, per-route
metrics). A ``server.json`` with an ``ssl`` section serves HTTPS, and
``start`` first asks a stale server on the same port to stop
(:func:`undeploy`). With ``ServerConfig(foldin=True)`` (``pio deploy
--foldin on``) an online fold-in consumer
(:mod:`~predictionio_tpu_torch.online.foldin`) tails the deployment's
event stream and patches fresh user rows into the live store; while its
tail fails, answers carry ``degraded: true`` and ``degradedReasons:
["foldin_stale"]``. With ``ServerConfig(feedback=True)`` (``pio deploy
--feedback --accesskey K``) each answered query is posted to the event
server as a ``predict`` event of entity type ``pio_pr``, off the
request's thread. :mod:`~predictionio_tpu_torch.fleet.balancer` runs
several of these servers behind one balancer (``pio deploy --fleet N``).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import functools
import json
import logging
import os
import secrets
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.common import SSLConfiguration
from predictionio_tpu_torch.common.auth import (
    KeyAuthentication,
    ServerConfig as AuthServerConfig,
)
from predictionio_tpu_torch.controller.controllers import TwoStageServing
from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineParams,
    params_from_dict,
)
from predictionio_tpu_torch.core.context import (
    ComputeContext,
    workflow_context,
)
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.event import new_event_id
from predictionio_tpu_torch.data.storage.base import (
    EngineInstance,
    StorageError,
)
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops import serving as _serving
from predictionio_tpu_torch.ops.serving import QueryRejectedError
from predictionio_tpu_torch.utils import (
    device_telemetry,
    metrics,
    resilience,
    tracing,
)
from predictionio_tpu_torch.utils.http_instrumentation import (
    InstrumentedHandlerMixin,
    SeveringThreadingHTTPServer,
)
from predictionio_tpu_torch.utils.tracing import (
    LatencyHistogram,
    ProfilerBusyError,
    ProfilerNotRunningError,
    outbound_context_headers,
    span,
)
from predictionio_tpu_torch.workflow import core_workflow
from predictionio_tpu_torch.workflow.server_plugins import (
    EngineServerPluginContext,
)
from predictionio_tpu_torch.workflow.undeploy import undeploy

logger = logging.getLogger("pio.torch.queryserver")
BIND_TRIES = 3  # a stale server's port frees a moment after its /stop
UTC = _dt.timezone.utc


@dataclasses.dataclass
class ServerConfig:
    """Where the server listens, the engine coordinates ``/reload``
    resolves the latest completed instance of, an optional query it
    serves once at deploy (after each algorithm's ``warmup_base``), and
    the ``server.json`` it reads at start. ``foldin`` runs the online
    fold-in consumer (:mod:`~predictionio_tpu_torch.online.foldin`;
    cadence ``PIO_FOLDIN_INTERVAL`` / ``PIO_FOLDIN_COUNT``).
    ``feedback`` posts each answered query as a ``predict`` event to the
    event server at ``event_server_ip:event_server_port`` with
    ``access_key``."""

    engine_id: str = "default"
    engine_version: str = "default"
    engine_variant: str = "engine.json"
    ip: str = "0.0.0.0"
    port: int = 8000
    warmup_query: Optional[Mapping[str, Any]] = None
    foldin: bool = False
    feedback: bool = False
    event_server_ip: str = "0.0.0.0"
    event_server_port: int = 7070
    access_key: Optional[str] = None
    # server.json with the access key that gates /profile/* and the TLS
    # cert/key; None reads $PIO_SERVER_CONFIG or ./server.json, and a
    # file without an "ssl" section serves plain HTTP
    server_config_path: Optional[str] = None
    # SLO overrides for fleet mode (`pio deploy --fleet N --slo-config
    # ...`): inline JSON or a file path, layered over the defaults and
    # $PIO_SLO_* (predictionio_tpu_torch/obs/slo.py)
    slo_config: Optional[str] = None


class ReloadDowngradeError(RuntimeError):
    """``POST /reload`` refused (HTTP 409): the latest completed instance
    is older than the one deployed. Downgrading takes an explicit
    redeploy.

    ``swapped`` lists the replicas a fleet roll had already swapped
    before the refusal aborted it (empty for a single server): the 409
    body names them, so the operator sees how far the roll got."""

    def __init__(self, *args: Any,
                 swapped: Optional[List[Dict[str, Any]]] = None):
        super().__init__(*args)
        self.swapped: List[Dict[str, Any]] = list(swapped or [])


def engine_instance_to_engine_params(
        engine: Engine, instance: EngineInstance) -> EngineParams:
    """EngineParams from the instance's JSON snapshot of every stage."""
    def one(block: Mapping[str, Any], class_map, stage: str):
        name = block.get("name", "")
        if name not in class_map:
            raise ValueError(
                f"{stage}: controller named {name!r} from the engine "
                f"instance is not registered; known: {sorted(class_map)}")
        return name, params_from_dict(
            getattr(class_map[name], "params_class", None),
            block.get("params", {}), where=f"{stage}[{name!r}]")

    return EngineParams(
        data_source_params=one(json.loads(instance.data_source_params),
                               engine.data_source_class_map, "datasource"),
        preparator_params=one(json.loads(instance.preparator_params),
                              engine.preparator_class_map, "preparator"),
        algorithm_params_list=[
            one(block, engine.algorithm_class_map, f"algorithms[{i}]")
            for i, block in enumerate(json.loads(instance.algorithms_params))],
        serving_params=one(json.loads(instance.serving_params),
                           engine.serving_class_map, "serving"))


@functools.lru_cache(maxsize=4096)
def _camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(w.capitalize() for w in rest)


@functools.lru_cache(maxsize=4096)
def _snake(name: str) -> str:
    return "".join("_" + ch.lower() if ch.isupper() else ch for ch in name)


_FIELD_CACHE: Dict[type, List[Tuple[str, str]]] = {}


def _fields_camel(cls: type) -> List[Tuple[str, str]]:
    """(snake field name, camel wire name) pairs per dataclass, cached."""
    cached = _FIELD_CACHE.get(cls)
    if cached is None:
        cached = [(f.name, _camel(f.name)) for f in dataclasses.fields(cls)]
        _FIELD_CACHE[cls] = cached
    return cached


def to_jsonable(obj: Any) -> Any:
    """Prediction/query -> wire JSON. Dataclass fields go out camelCased
    (``itemScores``), as the reference serializes its case classes."""
    t = type(obj)
    if t is str or t is float or t is int or t is bool or obj is None:
        return obj
    if t is list or t is tuple:
        return [to_jsonable(v) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {camel: to_jsonable(getattr(obj, name))
                for name, camel in _fields_camel(t)}
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, Mapping):
        return {str(k): to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, _dt.datetime):
        return obj.isoformat()
    return obj


def query_from_json(query_dict: Mapping[str, Any],
                    query_cls: Optional[type]) -> Any:
    """Typed-query extraction: camelCase keys map onto the dataclass's
    snake_case fields, JSON arrays onto tuples; unknown or missing keys
    raise (the server answers 400)."""
    if query_cls is None or not dataclasses.is_dataclass(query_cls):
        return dict(query_dict)
    data = {_snake(k): v for k, v in query_dict.items()}
    for name, value in list(data.items()):
        if type(value) is list:
            data[name] = tuple(value)
    return params_from_dict(query_cls, data, where=query_cls.__name__)


class Deployment:
    """One deployed engine state: algorithms, their models, serving, and
    the engine instance they came from (None for models handed over in
    memory); swapped whole on reload."""

    def __init__(self, engine: Engine, engine_params: EngineParams,
                 algorithms: List[Any], models: List[Any], serving: Any,
                 instance: Optional[EngineInstance] = None,
                 ctx: Optional[ComputeContext] = None):
        self.engine = engine
        self.engine_params = engine_params
        self.algorithms = algorithms
        self.models = models
        self.serving = serving
        self.instance = instance
        self.ctx = ctx


def resolve_engine_instance(engine_instance_id: Optional[str],
                            engine_id: str = "default",
                            engine_version: str = "default",
                            engine_variant: str = "engine.json"
                            ) -> EngineInstance:
    """The given instance, or the latest ``COMPLETED`` one of the engine
    coordinates."""
    instances = storage.get_metadata_engine_instances()
    if engine_instance_id:
        instance = instances.get(engine_instance_id)
        if instance is None:
            raise StorageError(
                f"engine instance {engine_instance_id!r} not found")
        return instance
    instance = instances.get_latest_completed(engine_id, engine_version,
                                              engine_variant)
    if instance is None:
        raise StorageError(
            "No valid engine instance found for engine "
            f"{engine_id} {engine_version} {engine_variant}. "
            "Try running train first.")
    return instance


def build_deployment(instance: EngineInstance,
                     ctx: Optional[ComputeContext] = None,
                     engine: Optional[Engine] = None) -> Deployment:
    """Load one engine instance into servable state: its engine (from
    ``instance.engine_factory`` unless given), its params from the
    snapshot, its stored models (``deserialize_models``, which refuses
    the JAX package's classes, then ``prepare_deploy``). The models
    serve on the device ``ctx`` names (None = cuda), whatever device
    they trained on; a context given its devices is the plane their
    stores span (``ComputeContext.serving_plane``)."""
    ctx = ctx or workflow_context(mode="serving")
    dev = resolve_device(ctx.device)
    plane = ctx.serving_plane
    if engine is None:
        engine = core_workflow.load_engine_factory(instance.engine_factory)()
    engine_params = engine_instance_to_engine_params(engine, instance)
    blob = storage.get_model_data_models().get(instance.id)
    if blob is None:
        raise StorageError(
            f"no persisted models for engine instance {instance.id}")
    models = engine.prepare_deploy(
        ctx, engine_params, instance.id,
        core_workflow.deserialize_models(blob.models))
    for model in models:
        # a served model names its device in a dataclass field; other
        # models (a numpy coefficient vector has a read-only ``device``)
        # keep theirs
        if dataclasses.is_dataclass(model) and "device" in {
                f.name for f in dataclasses.fields(model)}:
            model.device = str(dev)
            if plane is not None and hasattr(model, "serve_plane"):
                model.serve_plane = plane
    return deployment_from_models(engine, engine_params, models,
                                  instance=instance, ctx=ctx)


def deployment_from_models(engine: Engine, engine_params: EngineParams,
                           models: List[Any],
                           instance: Optional[EngineInstance] = None,
                           ctx: Optional[ComputeContext] = None
                           ) -> Deployment:
    """Servable state from models already in memory: instantiate the
    algorithms and the serving, and check that every algorithm of the
    ensemble shares the first one's query type (queries are extracted
    with it and fed to all)."""
    algorithms = engine._algorithms(engine_params)
    if len(models) != len(algorithms):
        raise ValueError(f"{len(models)} models for "
                         f"{len(algorithms)} algorithms")
    declared = {a.query_class for a in algorithms if a.query_class is not None}
    if len(declared) > 1:
        names = sorted(c.__name__ for c in declared)
        raise ValueError(
            f"algorithms declare different query classes {names}; an "
            "ensemble must share one query type")
    if declared and algorithms[0].query_class is None:
        raise ValueError(
            f"algorithm {type(algorithms[0]).__name__} declares no query "
            f"class but a later ensemble member expects "
            f"{next(iter(declared)).__name__}")
    serving = engine._serving(engine_params)
    if isinstance(serving, TwoStageServing):
        _bind_two_stage(serving, algorithms, models, ctx)
    return Deployment(engine, engine_params, algorithms, list(models),
                      serving, instance=instance, ctx=ctx)


def _bind_two_stage(serving: Any, algorithms: List[Any],
                    models: List[Any],
                    ctx: Optional[ComputeContext] = None) -> None:
    """Put a ``TwoStageServing`` deployment on ONE device store: build a
    :class:`~predictionio_tpu_torch.ops.twostage.TwoStageTopK` over the
    retrieval model's factors and the re-ranker's tables (its checks
    refuse at load, never at query time), point each model's server at
    its facet of the store, and bind the serving's fused route, so
    ``serve_query`` dispatches retrieval and re-rank once per query
    batch. A context given its devices is the plane the store spans
    (``PIO_SERVE_SHARDS`` shards over it); else the retrieval model's
    own plane or device."""
    from predictionio_tpu_torch.ops.twostage import build_two_stage_store

    if len(models) < 2:
        raise ValueError(
            "TwoStageServing needs EngineParams.algorithms = "
            "[retrieval, reranker] (at least two algorithms); got "
            f"{len(models)} — use LFirstServing for a single-algorithm "
            "deployment")
    retrieval, rerank = models[0], models[-1]
    plane = ctx.serving_plane if ctx is not None else None
    store = build_two_stage_store(retrieval, rerank, device=plane)
    retrieval._server = store.two_facet()
    # the re-ranked scores are the encoder's logits: a user whose
    # candidates all score below zero still has a ranking, so the
    # retrieval model's implicit-ALS positive filter must not drop them
    retrieval.serve_positive_scores_only = False
    rerank._server = store.seq_facet()
    algo0 = algorithms[0]
    serving.bind_fused(lambda q: algo0.predict_base(retrieval, q))


def warm_up(dep: Deployment,
            warmup_query: Optional[Mapping[str, Any]] = None) -> None:
    """Each algorithm's ``warmup_base`` (builds the device store, whose
    ``warmup()`` captures the serving ladder), then an optional
    sacrificial query through the full path. A model with no
    ``warmup_base`` hook but a ``device_server()`` gets the ladder too:
    its first queries must not pay for it. A warm-up that fails raises
    (on the card it is the kernel or a graph that failed)."""
    for algo, model in zip(dep.algorithms, dep.models):
        warmup = getattr(algo, "warmup_base", None)
        if callable(warmup):
            warmup(model)
            continue
        device_server = getattr(model, "device_server", None)
        if callable(device_server):
            device_server().warmup()
    if warmup_query is not None:
        serve_query(dep, query_from_json(dict(warmup_query),
                                         dep.algorithms[0].query_class))


def serve_query(dep: Deployment, query: Any) -> Any:
    """Supplement -> predict per algorithm -> serve with the ORIGINAL
    query. Each stage is a trace span, so a slow query decomposes into
    the stage that cost it."""
    with span("serve.supplement"):
        supplemented = dep.serving.supplement_base(query)
    if getattr(dep.serving, "fused_bound", False):
        # a two-stage deployment serves the whole query through its one
        # store: a predict per algorithm would dispatch the stages apart
        # and bring the candidates to the host
        with span("serve.fused",
                  attributes={"serving": type(dep.serving).__name__}):
            return dep.serving.serve_fused(supplemented)
    predictions = []
    for algo, model in zip(dep.algorithms, dep.models):
        with span("serve.predict",
                  attributes={"algorithm": type(algo).__name__}):
            predictions.append(algo.predict_base(model, supplemented))
    with span("serve.serve"):
        return dep.serving.serve_base(query, predictions)


def _device_ready(dep: Optional[Deployment]) -> bool:
    """Every device the deployment's models serve on answers: a CUDA
    model needs a visible card."""
    if dep is None:
        return False
    for model in dep.models:
        device = torch.device(getattr(model, "device", None) or "cuda")
        if device.type == "cuda" and not (
                torch.cuda.is_available()
                and torch.cuda.device_count() > (device.index or 0)):
            return False
    return True


class _HTTPServer(SeveringThreadingHTTPServer):
    daemon_threads = True
    # a burst of concurrent clients must not overflow the listen queue
    # (the default holds 5): a dropped connection costs its client a 1 s
    # SYN retransmit
    request_queue_size = 128


class QueryServer:
    """The deployment daemon: one :class:`Deployment` behind a threaded
    HTTP server; ``plugin_context`` holds the output blockers and
    sniffers every prediction passes through."""

    def __init__(self, config: ServerConfig, deployment: Deployment,
                 plugin_context: Optional[EngineServerPluginContext] = None):
        self.config = config
        self._deployment = deployment
        self.plugin_context = plugin_context or EngineServerPluginContext()
        self._foldin = None  # online.foldin.FoldInConsumer when enabled
        self._foldin_env_prior: Optional[str] = None
        self._foldin_env_set = False
        self._swap_lock = threading.Lock()
        # per-server latency (the status page); every record also feeds
        # the process-wide pio_query_seconds{variant=...}
        self.latency = LatencyHistogram()
        self._httpd: Optional[_HTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.scheme = "http"  # resolved from server.json at start()
        self._profile_auth: Optional[KeyAuthentication] = None

    def handle_query(self, body: bytes) -> Tuple[int, Any]:
        dep = self._deployment
        t0 = time.perf_counter()
        query_time = _dt.datetime.now(tz=UTC)
        try:
            query_dict = json.loads(body.decode("utf-8"))
            if not isinstance(query_dict, dict):
                raise ValueError("query must be a JSON object")
        except (json.JSONDecodeError, UnicodeDecodeError, ValueError) as e:
            return 400, {"message": f"{e}"}
        # extraction errors are the client's fault (400); anything past
        # extraction is an engine failure (500)
        try:
            with span("query.extract"):
                query = query_from_json(query_dict,
                                        dep.algorithms[0].query_class)
        except (ValueError, TypeError) as e:
            return 400, {"message": str(e)}
        try:
            with resilience.degraded_scope() as degraded:
                foldin = self._foldin
                if foldin is not None and foldin.stale:
                    # the fold-in tail is failing: the answer comes from
                    # the last-good factors, and says so
                    resilience.mark_degraded("foldin_stale")
                prediction = serve_query(dep, query)
        except QueryRejectedError as e:
            return 503, {"message": str(e), "retryAfterSec": e.retry_after}
        except Exception as e:
            logger.exception("query failed")
            return 500, {"message": str(e)}
        result = to_jsonable(prediction)
        if degraded:
            # served degraded whatever the result's shape: count always;
            # the response fields need a JSON object
            for reason in degraded:
                metrics.DEGRADED_QUERIES.inc(reason=reason)
            if isinstance(result, dict):
                result["degraded"] = True
                result["degradedReasons"] = list(degraded)
        if self.config.feedback:
            result = self._feedback(dep, query_dict, query, prediction,
                                    result, query_time)
        for blocker in self.plugin_context.output_blockers.values():
            result = blocker.process(dep.instance, query_dict, result,
                                     self.plugin_context)
        for sniffer in self.plugin_context.output_sniffers.values():
            try:
                sniffer.process(dep.instance, query_dict, result,
                                self.plugin_context)
            except Exception:
                logger.exception("output sniffer failed")
        took = time.perf_counter() - t0
        self.latency.record(took)
        metrics.QUERY_LATENCY.observe(took,
                                      variant=self.config.engine_variant)
        return 200, result

    def _feedback(self, dep: Deployment, query_dict: Mapping[str, Any],
                  query: Any, prediction: Any, result: Any,
                  query_time: _dt.datetime) -> Any:
        """Post the answered query to the event server as a ``predict``
        event (entity type ``pio_pr``) on a daemon thread: one retry, a
        4xx dropped at once, every drop counted in
        ``pio_feedback_dropped_total``; the response never waits for it.
        The request's ``X-Request-ID`` / ``traceparent`` go with the
        POST, so the event server's spans join the query's trace.
        Returns the result, with ``prId`` when the prediction has one."""
        org = getattr(prediction, "pr_id", None) or query_dict.get("prId")
        pr_id = org or secrets.token_hex(32)
        data = {
            "event": "predict",
            # a client-made id: a retried POST whose first attempt was
            # stored is deduplicated by id-keyed backends
            "eventId": new_event_id(),
            "eventTime": query_time.isoformat(),
            "entityType": "pio_pr",
            "entityId": pr_id,
            "properties": {
                "engineInstanceId": dep.instance.id
                if dep.instance is not None else None,
                "query": to_jsonable(query),
                "prediction": result,
            },
        }
        if "prId" in query_dict:
            data["prId"] = query_dict["prId"]
        url = (f"http://{self.config.event_server_ip}:"
               f"{self.config.event_server_port}/events.json"
               f"?accessKey={self.config.access_key or ''}")
        # the context is read now: the POST runs after the response
        headers = {"Content-Type": "application/json",
                   **outbound_context_headers()}
        body = json.dumps(data).encode("utf-8")

        def post():
            last: Optional[Exception] = None
            for attempt in range(2):
                try:
                    req = urllib.request.Request(
                        url, data=body, headers=headers, method="POST")
                    with urllib.request.urlopen(req, timeout=5) as resp:
                        if resp.status == 201:
                            return
                        # another success code: a retry of the same
                        # payload cannot change the answer
                        logger.error(
                            "Feedback event failed. Status code: %d. "
                            "Data: %s.", resp.status, data)
                        metrics.FEEDBACK_DROPPED.inc()
                        return
                except urllib.error.HTTPError as e:
                    if e.code < 500:
                        # refused: the identical payload would be again
                        logger.error(
                            "Feedback event refused (%d). Data: %s.",
                            e.code, data)
                        metrics.FEEDBACK_DROPPED.inc()
                        return
                    last = e
                    if attempt == 0:
                        time.sleep(0.2)
                except Exception as e:
                    last = e
                    if attempt == 0:
                        time.sleep(0.2)
            metrics.FEEDBACK_DROPPED.inc()
            logger.error("Feedback event dropped after retry: %s", last)

        threading.Thread(target=post, daemon=True,
                         name="pio-feedback").start()
        if hasattr(prediction, "pr_id") and isinstance(result, dict):
            result = dict(result, prId=pr_id)
        return result

    def reload(self) -> Dict[str, Any]:
        """Swap to the latest completed instance of the configured engine
        coordinates, loaded and warmed while the current deployment
        keeps answering; an instance older than the deployed one is
        refused (:class:`ReloadDowngradeError`). Returns both ids."""
        with self._swap_lock:
            current = self._deployment
            latest = storage.get_metadata_engine_instances(
            ).get_latest_completed(self.config.engine_id,
                                   self.config.engine_version,
                                   self.config.engine_variant)
            if latest is None:
                raise StorageError(
                    "No valid engine instance found for reload")
            deployed = current.instance
            if deployed is not None and latest.id != deployed.id \
                    and latest.start_time < deployed.start_time:
                raise ReloadDowngradeError(
                    f"refusing to reload: latest completed instance "
                    f"{latest.id} (started {latest.start_time.isoformat()})"
                    f" is older than the deployed {deployed.id} (started "
                    f"{deployed.start_time.isoformat()}); undeploy and "
                    "redeploy explicitly to downgrade")
            candidate = build_deployment(latest, current.ctx,
                                         engine=current.engine)
            warm_up(candidate, self.config.warmup_query)
            if self.config.foldin:
                # the candidate's fold-in starts before the swap: a
                # candidate that cannot be tailed fails the reload with
                # the deployed engine and its consumer intact
                self._start_foldin(candidate)
            self._deployment = candidate
            return {"engineInstanceId": latest.id,
                    "swappedFrom": None if deployed is None else deployed.id,
                    "swappedTo": latest.id}

    def status(self) -> Dict[str, Any]:
        """``GET /``: the deployment, whether feedback is on, and the
        serving latency summary (the reference's request count and
        running average, derived from the histogram)."""
        dep = self._deployment
        summary = self.latency.summary()
        inst = dep.instance if dep is not None else None
        # a snapshot: a concurrent stop() clears self._foldin
        consumer = self._foldin
        return {
            "foldin": consumer.stats() if consumer is not None else None,
            "status": "alive",
            "engineInstanceId": inst.id if inst is not None else None,
            "engineFactory": inst.engine_factory if inst is not None
            else None,
            "startTime": inst.start_time.isoformat() if inst is not None
            else None,
            "algorithms": [type(a).__name__ for a in dep.algorithms]
            if dep is not None else [],
            "feedback": self.config.feedback,
            "requestCount": summary.get("count", 0),
            "avgServingSec": summary.get("meanSec", 0.0),
            "lastServingSec": summary.get("lastSec", 0.0),
            "servingLatency": summary,
        }

    def stats_json(self) -> Dict[str, Any]:
        """``GET /stats.json``: the status page, the live micro-batch
        lanes' stats, the ``device`` block (store bytes, flight-recorder
        summary), the registry snapshot (the state ``GET /metrics``
        renders as Prometheus text) and, when EVENTDATA is a ``fleet``
        source, its shard topology as ``storageFleet``."""
        from predictionio_tpu_torch.fleet.balancer import _storage_topology

        out = {**self.status(),
               "batchers": _serving.batcher_stats(),
               "device": _serving.device_report(),
               "metrics": metrics.registry().snapshot()}
        # over the sharded ``fleet`` event source, the shard topology
        # (per-shard breaker states, partial reads served)
        topo = _storage_topology()
        if topo is not None:
            out["storageFleet"] = topo
        return out

    def dispatches_json(self, limit: int = 100) -> Dict[str, Any]:
        """``GET /dispatches.json``: the device flight recorder's last
        ``limit`` dispatches and per-lane summaries."""
        return device_telemetry.recorder().report(limit=limit)

    def profile_start(self) -> Dict[str, Any]:
        """``POST /profile/start``: begin a single-flight
        ``torch.profiler`` capture on the live server; a second start
        while one runs raises :class:`ProfilerBusyError` (HTTP 409)."""
        return {"message": "profiler capture started",
                "profileDir": tracing.PROFILER.start()}

    def profile_stop(self) -> Dict[str, Any]:
        """``POST /profile/stop``: end the active capture; with none
        running it raises :class:`ProfilerNotRunningError` (HTTP 409)."""
        return {"message": "profiler capture written",
                **tracing.PROFILER.stop()}

    def health_checks(self) -> Dict[str, bool]:
        """Readiness for ``GET /healthz``: a deployment is loaded, its
        device answers, and the event-store breaker is not refusing
        calls. Liveness is the response itself; readiness going false
        tells a balancer to drain this server while it keeps serving
        (degraded) what it can."""
        return {"deployment": self._deployment is not None,
                "device": _device_ready(self._deployment),
                "storage": resilience.storage_ready(storage.get_levents)}

    def start(self) -> "QueryServer":
        """Warm the deployment, bind (port 0 picks a free port) and serve
        on a daemon thread. The build counters are live from here, so the
        kernels' builds at warm-up land in ``pio_jit_compiles_total``;
        ``$PIO_TRACE_DIR``, as for the JAX package's ``pio deploy``,
        exports every retained trace there. ``server.json`` names the
        access key of ``/profile/*`` and, in its ``ssl`` section, the TLS
        pair. A server still answering on a fixed port, in either scheme,
        is asked to stop first; a failed bind is retried a second later,
        twice. With ``foldin`` it sets ``PIO_FOLDIN`` and starts the
        fold-in consumer after the warm-up and before the bind; a failed
        start stops the consumer and restores ``PIO_FOLDIN``."""
        auth_cfg = AuthServerConfig.load(self.config.server_config_path)
        self._profile_auth = KeyAuthentication(auth_cfg)
        sslc = SSLConfiguration(auth_cfg)
        self.scheme = "https" if sslc.enabled else "http"
        metrics.install_jit_compile_listener()
        trace_dir = os.environ.get("PIO_TRACE_DIR")
        if trace_dir:
            tracing.set_trace_dir(trace_dir)
        if self.config.foldin:
            # PIO_FOLDIN (serving.foldin_enabled) is set while this server
            # runs with fold-in; stop() restores the prior value, so an
            # embedder's next deployment does not inherit the policy
            if not self._foldin_env_set:
                self._foldin_env_prior = os.environ.get("PIO_FOLDIN")
                self._foldin_env_set = True
            os.environ["PIO_FOLDIN"] = "1"
        try:
            warm_up(self._deployment, self.config.warmup_query)
            if self.config.foldin:
                self._start_foldin()
            self._bind(sslc)
        except BaseException:
            # a failed start leaks neither the policy nor a tail thread
            self._stop_foldin()
            raise
        logger.info("Query server started on %s://%s:%d", self.scheme,
                    *self.address)
        return self

    def _restore_foldin_env(self) -> None:
        if not self._foldin_env_set:
            return
        if self._foldin_env_prior is None:
            os.environ.pop("PIO_FOLDIN", None)
        else:
            os.environ["PIO_FOLDIN"] = self._foldin_env_prior
        self._foldin_env_set = False

    def _start_foldin(self, deployment: Optional[Deployment] = None) -> None:
        """(Re)start the fold-in consumer against ``deployment`` (default:
        the current one). The new consumer starts before the old one
        stops, so a refusal leaves the old consumer running: ``reload``
        validates the candidate's fold-in this way before the swap. The
        overlap is harmless: the old consumer patches the old model's
        store, which is about to be dropped."""
        from predictionio_tpu_torch.online.foldin import attach_foldin

        dep = deployment if deployment is not None else self._deployment
        new = attach_foldin(dep).start()
        if self._foldin is not None:
            self._foldin.stop()
        self._foldin = new

    def _stop_foldin(self) -> None:
        if self._foldin is not None:
            self._foldin.stop()
            self._foldin = None
        self._restore_foldin_env()

    def _bind(self, sslc: SSLConfiguration) -> None:
        """Bind the socket (asking a stale server on a fixed port to stop
        first), wrap it in TLS when ``sslc`` is enabled, and serve on a
        daemon thread."""
        if self.config.port:
            other = "http" if self.scheme == "https" else "https"
            if not undeploy(self.config.ip, self.config.port, self.scheme):
                undeploy(self.config.ip, self.config.port, other)
        server = self

        class Handler(_QueryHandler):
            query_server = server

        for attempt in range(BIND_TRIES):
            try:
                self._httpd = _HTTPServer((self.config.ip, self.config.port),
                                          Handler)
                break
            except OSError as e:
                if attempt + 1 == BIND_TRIES:
                    raise RuntimeError(
                        f"bind failed after {BIND_TRIES} tries") from e
                logger.warning("bind failed (attempt %d): %s",
                               attempt + 1, e)
                time.sleep(1.0)
        if sslc.enabled:
            sslc.wrap_server(self._httpd)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="pio-torch-queryserver",
                                        daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        """Block until the server stops (``POST /stop`` or
        :meth:`stop`), starting it first when needed."""
        if self._httpd is None:
            self.start()
        assert self._thread is not None
        self._thread.join()

    @property
    def address(self) -> Tuple[str, int]:
        if self._httpd is None:
            raise RuntimeError("server not started")
        host, port = self._httpd.server_address[:2]
        return str(host), int(port)

    def stop(self) -> None:
        """Stop the fold-in consumer (restoring ``PIO_FOLDIN``), stop
        serving, close the socket, and release the models' device
        servers (their batch dispatchers)."""
        self._stop_foldin()
        if self._httpd is not None:
            httpd, self._httpd = self._httpd, None
            httpd.shutdown()
            httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        for model in self._deployment.models:
            srv = getattr(model, "_server", None)
            if srv is not None:
                srv.close()


class _QueryHandler(InstrumentedHandlerMixin, BaseHTTPRequestHandler):
    query_server: QueryServer
    protocol_version = "HTTP/1.1"
    metrics_server_label = "query"

    # the JAX query server's route labels
    _ROUTES = ("/", "/healthz", "/metrics", "/stats.json",
               "/dispatches.json", "/plugins.json", "/queries.json",
               "/profile/start", "/profile/stop", "/reload", "/stop",
               "/traces.json")

    def log_message(self, fmt, *args):
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    def _route_label(self, path: str) -> str:
        if path.startswith("/traces/"):
            return "/traces/<id>"
        return path if path in self._ROUTES else "<other>"

    def _dispatch(self, method: str) -> None:
        parsed = urllib.parse.urlsplit(self.path)
        path = parsed.path.rstrip("/") or "/"
        query = urllib.parse.parse_qs(parsed.query)
        handle = (lambda: self._do_get(path, query)) if method == "GET" \
            else (lambda: self._do_post(path, query))
        self._dispatch_instrumented(method, path, handle)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def _do_get(self, path: str, query) -> None:
        srv = self.query_server
        self._body()
        if path == "/":
            self._respond(200, srv.status())
        elif path == "/healthz":
            self._respond_healthz(srv.health_checks())
        elif path == "/metrics":
            self._respond_prometheus()
        elif path == "/stats.json":
            self._respond(200, srv.stats_json())
        elif path == "/dispatches.json":
            try:
                limit = min(int(self._q_first(query, "limit") or 100),
                            2048)
            except ValueError:
                limit = 100
            self._respond(200, srv.dispatches_json(limit=limit))
        elif path == "/traces.json":
            self._respond_traces_index(query)
        elif path.startswith("/traces/"):
            self._respond_trace(path[len("/traces/"):], query)
        elif path == "/plugins.json":
            self._respond(200, srv.plugin_context.describe())
        else:
            self._respond(404, {"message": "Not Found"})

    def _do_post(self, path: str, query) -> None:
        body = self._body()
        try:
            if path in ("/profile/start", "/profile/stop"):
                self._handle_profile(path, query)
            else:
                self._route_post(path, body)
        except Exception as e:
            logger.exception("unhandled error on POST %s", path)
            try:
                self._respond(500, {"message": str(e)})
            except Exception:
                pass

    def _route_post(self, path: str, body: bytes) -> None:
        srv = self.query_server
        if path == "/queries.json":
            status, payload = srv.handle_query(body)
            headers = None
            if status == 503 and "retryAfterSec" in payload:
                headers = {"Retry-After":
                           str(max(1, int(payload["retryAfterSec"])))}
            self._respond_json(status, payload, headers)
        elif path == "/reload":
            try:
                info = srv.reload()
            except ReloadDowngradeError as e:
                self._respond(409, {"message": str(e)})
                return
            except StorageError as e:
                self._respond(404, {"message": str(e)})
                return
            self._respond(200, {"message": "Reloading...", **info})
        elif path == "/stop":
            self.close_connection = True
            self._respond_json(200, {"message": "Shutting down."},
                               {"Connection": "close"})
            threading.Thread(target=srv.stop, daemon=True).start()
        else:
            self._respond(404, {"message": "Not Found"})

    def _handle_profile(self, path: str, query) -> None:
        """On-demand profiler capture: gated by the ``server.json``
        access key when one is set (403 otherwise), single-flight (409
        on a second start or an idle stop)."""
        srv = self.query_server
        auth = srv._profile_auth
        if auth is not None and not auth.authenticate(query):
            self._respond(403, {"message": "invalid accessKey"})
            return
        try:
            if path == "/profile/start":
                self._respond(200, srv.profile_start())
            else:
                self._respond(200, srv.profile_stop())
        except (ProfilerBusyError, ProfilerNotRunningError) as e:
            self._respond(409, {"message": str(e)})

    def _respond_json(self, status: int, payload: Any,
                      headers: Optional[Dict[str, str]] = None) -> None:
        self._respond_bytes(status, json.dumps(payload).encode("utf-8"),
                            "application/json; charset=UTF-8",
                            extra_headers=headers)
