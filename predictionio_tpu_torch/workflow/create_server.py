"""Query server: the deployed engine behind ``POST /queries.json``.

The port's copy of ``predictionio_tpu/workflow/create_server.py``, the
part one server needs: resolving an engine instance from storage
(``resolve_engine_instance``), loading its stored models into a
:class:`Deployment` (``build_deployment``, or
``deployment_from_models`` for models already in memory);
``serve_query`` (supplement -> predict per algorithm -> serve with the
original query); the wire JSON (``to_jsonable`` / ``query_from_json``);
and a threaded HTTP server with ``POST /queries.json``, ``POST
/reload`` (swap to the latest completed instance; an older one is
refused with 409), ``GET /healthz`` and ``POST /stop``. Feedback, the
observability routes, fleets and TLS come with later slices; fold-in
on deploy raises (ROADMAP queue A item 3).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import functools
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineParams,
    params_from_dict,
)
from predictionio_tpu_torch.core.context import ComputeContext
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.storage.base import (
    EngineInstance,
    StorageError,
)
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.serving import QueryRejectedError
from predictionio_tpu_torch.workflow import core_workflow

logger = logging.getLogger("pio.torch.queryserver")


@dataclasses.dataclass
class ServerConfig:
    """Where the server listens, the engine coordinates ``/reload``
    resolves the latest completed instance of, and an optional query it
    serves once at deploy (after each algorithm's ``warmup_base``).
    ``foldin`` is not ported yet and raises."""

    engine_id: str = "default"
    engine_version: str = "default"
    engine_variant: str = "engine.json"
    ip: str = "0.0.0.0"
    port: int = 8000
    warmup_query: Optional[Mapping[str, Any]] = None
    foldin: bool = False


class ReloadDowngradeError(RuntimeError):
    """``POST /reload`` refused (HTTP 409): the latest completed instance
    is older than the one deployed. Downgrading takes an explicit
    redeploy."""


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
    they trained on."""
    ctx = ctx or ComputeContext()
    dev = resolve_device(ctx.device)
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
        if hasattr(model, "device"):
            model.device = str(dev)
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
    return Deployment(engine, engine_params, algorithms, list(models),
                      engine._serving(engine_params), instance=instance,
                      ctx=ctx)


def warm_up(dep: Deployment,
            warmup_query: Optional[Mapping[str, Any]] = None) -> None:
    """Each algorithm's ``warmup_base`` (builds the device store and the
    kernel), then an optional sacrificial query through the full path."""
    for algo, model in zip(dep.algorithms, dep.models):
        warmup = getattr(algo, "warmup_base", None)
        if callable(warmup):
            warmup(model)
    if warmup_query is not None:
        serve_query(dep, query_from_json(dict(warmup_query),
                                         dep.algorithms[0].query_class))


def serve_query(dep: Deployment, query: Any) -> Any:
    """Supplement -> predict per algorithm -> serve with the ORIGINAL
    query."""
    supplemented = dep.serving.supplement_base(query)
    predictions = [algo.predict_base(model, supplemented)
                   for algo, model in zip(dep.algorithms, dep.models)]
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


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # a burst of concurrent clients must not overflow the listen queue
    # (the default holds 5): a dropped connection costs its client a 1 s
    # SYN retransmit
    request_queue_size = 128


class QueryServer:
    """The deployment daemon: one :class:`Deployment` behind a threaded
    HTTP server."""

    def __init__(self, config: ServerConfig, deployment: Deployment):
        if config.foldin:
            raise NotImplementedError(
                "fold-in on deploy is not ported yet (ROADMAP queue A "
                "item 3)")
        self.config = config
        self._deployment = deployment
        self._swap_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def handle_query(self, body: bytes) -> Tuple[int, Any]:
        dep = self._deployment
        try:
            query_dict = json.loads(body.decode("utf-8"))
            if not isinstance(query_dict, dict):
                raise ValueError("query must be a JSON object")
        except (json.JSONDecodeError, UnicodeDecodeError, ValueError) as e:
            return 400, {"message": f"{e}"}
        # extraction errors are the client's fault (400); anything past
        # extraction is an engine failure (500)
        try:
            query = query_from_json(query_dict, dep.algorithms[0].query_class)
        except (ValueError, TypeError) as e:
            return 400, {"message": str(e)}
        try:
            prediction = serve_query(dep, query)
        except QueryRejectedError as e:
            return 503, {"message": str(e), "retryAfterSec": e.retry_after}
        except Exception as e:
            logger.exception("query failed")
            return 500, {"message": str(e)}
        return 200, to_jsonable(prediction)

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
            self._deployment = candidate
            return {"engineInstanceId": latest.id,
                    "swappedFrom": None if deployed is None else deployed.id,
                    "swappedTo": latest.id}

    def health_checks(self) -> Dict[str, bool]:
        """Readiness for ``GET /healthz``: a deployment is loaded and its
        device answers."""
        return {"deployment": self._deployment is not None,
                "device": _device_ready(self._deployment)}

    def start(self) -> "QueryServer":
        """Warm the deployment, bind (port 0 picks a free port) and serve
        on a daemon thread."""
        warm_up(self._deployment, self.config.warmup_query)
        server = self

        class Handler(_QueryHandler):
            query_server = server

        self._httpd = _HTTPServer((self.config.ip, self.config.port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="pio-torch-queryserver",
                                        daemon=True)
        self._thread.start()
        logger.info("Query server started on %s:%d", *self.address)
        return self

    @property
    def address(self) -> Tuple[str, int]:
        if self._httpd is None:
            raise RuntimeError("server not started")
        host, port = self._httpd.server_address[:2]
        return str(host), int(port)

    def stop(self) -> None:
        """Stop serving, close the socket, and release the models'
        device servers (their batch dispatchers)."""
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


class _QueryHandler(BaseHTTPRequestHandler):
    query_server: QueryServer
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _respond(self, status: int, payload: Any,
                 headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=UTF-8")
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    def do_GET(self):
        self._body()
        if self.path.split("?", 1)[0].rstrip("/") == "/healthz":
            checks = self.query_server.health_checks()
            ready = all(checks.values())
            self._respond(200 if ready else 503,
                          {"alive": True, "ready": ready, "checks": checks})
        else:
            self._respond(404, {"message": "Not Found"})

    def do_POST(self):
        body = self._body()
        path = self.path.split("?", 1)[0].rstrip("/")
        if path == "/queries.json":
            status, payload = self.query_server.handle_query(body)
            headers = None
            if status == 503 and "retryAfterSec" in payload:
                headers = {"Retry-After":
                           str(max(1, int(payload["retryAfterSec"])))}
            self._respond(status, payload, headers)
        elif path == "/reload":
            try:
                info = self.query_server.reload()
            except ReloadDowngradeError as e:
                self._respond(409, {"message": str(e)})
                return
            except StorageError as e:
                self._respond(404, {"message": str(e)})
                return
            self._respond(200, {"message": "Reloading...", **info})
        elif path == "/stop":
            self.close_connection = True
            self._respond(200, {"message": "Shutting down."},
                          {"Connection": "close"})
            threading.Thread(target=self.query_server.stop,
                             daemon=True).start()
        else:
            self._respond(404, {"message": "Not Found"})
