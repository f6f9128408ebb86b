"""Storage registry: env-var-driven backend discovery.

Parity target: reference ``Storage.scala`` —

- sources from ``PIO_STORAGE_SOURCES_<NAME>_TYPE`` (+ per-type config keys,
  Storage.scala:124-137); our types: ``memory``, ``sqlite`` (config key
  ``PATH``), ``localfs`` for model blobs, and ``jsonlfs`` for events
  (``PATH``, ``PART_MAX_EVENTS``).
- repositories from ``PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,
  MODELDATA}_{NAME,SOURCE}`` (Storage.scala:144-193).
- accessors ``get_levents`` / ``get_pevents`` / ``get_metadata_*`` /
  ``get_model_data_models`` (Storage.scala:360-402).
- ``verify_all_data_objects`` for ``pio status`` (Storage.scala:335-358).

Unlike the reference there is no classpath reflection: backends register in
``BACKENDS`` and unknown types raise ``StorageError`` with the known set.

Defaults (no env set): a single sqlite source at ``$PIO_STORAGE_PATH`` or
``./.pio_store/pio.db`` serving all three repositories — the zero-service
bring-up the reference never had.

The port's copy of ``predictionio_tpu/data/storage/__init__.py``: its own
registry, read from the same ``PIO_STORAGE_*`` variables, with every
backend type of the JAX package: ``memory``, ``sqlite``, ``localfs``,
``jsonlfs``, and the networked event stores ``resthttp`` (``URL``,
``SERVICE_KEY``, ``TIMEOUT``, ``CA_FILE``, ``INSECURE_SKIP_VERIFY``) and
``fleet`` (``URLS``, ``SERVICE_KEY``, ``VIRTUAL_NODES``, plus the
``resthttp`` keys applied per shard). Every ``LEvents`` the registry
hands out is wrapped in
:class:`~predictionio_tpu_torch.data.storage.observed.DAOMetricsWrapper`
(metrics, retries, the breaker, fault injection); code that checks the
concrete backend type goes through ``observed.unwrap``.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import StorageError

REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")

# backend type -> DAO kind -> "module:Class"
BACKENDS: Dict[str, Dict[str, str]] = {
    "memory": {
        "LEvents": "predictionio_tpu_torch.data.storage.memory:MemLEvents",
        "PEvents": "predictionio_tpu_torch.data.storage.memory:MemLEvents",  # wrapped
        "Apps": "predictionio_tpu_torch.data.storage.memory:MemApps",
        "AccessKeys": "predictionio_tpu_torch.data.storage.memory:MemAccessKeys",
        "Channels": "predictionio_tpu_torch.data.storage.memory:MemChannels",
        "EngineInstances": "predictionio_tpu_torch.data.storage.memory:MemEngineInstances",
        "EvaluationInstances": "predictionio_tpu_torch.data.storage.memory:MemEvaluationInstances",
        "Models": "predictionio_tpu_torch.data.storage.memory:MemModels",
    },
    "sqlite": {
        "LEvents": "predictionio_tpu_torch.data.storage.sqlite:SqliteLEvents",
        "PEvents": "predictionio_tpu_torch.data.storage.sqlite:SqlitePEvents",
        "Apps": "predictionio_tpu_torch.data.storage.sqlite:SqliteApps",
        "AccessKeys": "predictionio_tpu_torch.data.storage.sqlite:SqliteAccessKeys",
        "Channels": "predictionio_tpu_torch.data.storage.sqlite:SqliteChannels",
        "EngineInstances": "predictionio_tpu_torch.data.storage.sqlite:SqliteEngineInstances",
        "EvaluationInstances": "predictionio_tpu_torch.data.storage.sqlite:SqliteEvaluationInstances",
        "Models": "predictionio_tpu_torch.data.storage.sqlite:SqliteModels",
    },
    # MODELDATA-only filesystem blob store (LocalFSModels.scala analog)
    "localfs": {
        "Models": "predictionio_tpu_torch.data.storage.localfs:LocalFSModels",
    },
    # EVENTDATA-only partitioned JSONL store — the scale-ingest backend
    # (JDBCPEvents.scala:31-100 / HBPEvents.scala:83-89 analog); config
    # keys: PATH, PART_MAX_EVENTS
    "jsonlfs": {
        "LEvents": "predictionio_tpu_torch.data.storage.jsonlfs:JsonlFsLEvents",
        "PEvents": "predictionio_tpu_torch.data.storage.jsonlfs:JsonlFsPEvents",
    },
    # EVENTDATA-only networked backend: DAOs speak HTTP to a remote
    # event server's /storage wire (the Storage.scala:360-391 remote-DAO
    # architecture — train on one machine, store on another); config
    # keys: URL, SERVICE_KEY, TIMEOUT
    "resthttp": {
        "LEvents": "predictionio_tpu_torch.data.storage.resthttp:RestLEvents",
        "PEvents": "predictionio_tpu_torch.data.storage.resthttp:RestPEvents",
    },
    # EVENTDATA-only consistent-hash router over N event-server shards:
    # writes fan out by entity key, reads scatter-gather and merge;
    # config keys: URLS (comma-separated shard URLs), SERVICE_KEY,
    # VIRTUAL_NODES, plus resthttp wire keys applied per shard
    "fleet": {
        "LEvents": "predictionio_tpu_torch.fleet.router:FleetLEvents",
        "PEvents": "predictionio_tpu_torch.fleet.router:FleetPEvents",
    },
}


def _load(spec: str):
    mod_name, cls_name = spec.split(":")
    import importlib
    return getattr(importlib.import_module(mod_name), cls_name)


def default_storage_path() -> str:
    p = os.environ.get("PIO_STORAGE_PATH")
    if p:
        return p
    d = os.path.join(os.getcwd(), ".pio_store")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, "pio.db")


class StorageConfig:
    """Parsed source/repository configuration."""

    def __init__(self, sources: Dict[str, Dict[str, Any]],
                 repositories: Dict[str, str]):
        self.sources = sources          # name -> {"type": ..., **config}
        self.repositories = repositories  # repo -> source name

    @classmethod
    def from_env(cls, env: Optional[Dict[str, str]] = None) -> "StorageConfig":
        env = dict(os.environ if env is None else env)
        sources: Dict[str, Dict[str, Any]] = {}
        prefix = "PIO_STORAGE_SOURCES_"
        for key, val in env.items():
            if key.startswith(prefix) and key.endswith("_TYPE"):
                name = key[len(prefix):-len("_TYPE")]
                cfg: Dict[str, Any] = {"type": val.lower()}
                srcpfx = f"{prefix}{name}_"
                for k2, v2 in env.items():
                    if k2.startswith(srcpfx) and k2 != key:
                        cfg[k2[len(srcpfx):].lower()] = v2
                sources[name] = cfg
        repositories: Dict[str, str] = {}
        for repo in REPOSITORIES:
            src = env.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE")
            if src:
                repositories[repo] = src
        if not sources:
            sources["DEFAULT"] = {"type": "sqlite",
                                  "path": default_storage_path()}
        unbound = [r for r in REPOSITORIES if r not in repositories]
        if unbound:
            if len(sources) == 1:
                only = next(iter(sources))
                for repo in unbound:
                    repositories[repo] = only
            else:
                # Never guess among multiple sources — data could silently
                # land in the wrong backend (cf. Storage.scala:144-193,
                # which requires explicit repository bindings).
                raise StorageError(
                    f"Repositories {unbound} have no "
                    f"PIO_STORAGE_REPOSITORIES_<REPO>_SOURCE set and more "
                    f"than one source is defined ({sorted(sources)}); bind "
                    f"them explicitly.")
        for repo, src in repositories.items():
            if src not in sources:
                raise StorageError(
                    f"Repository {repo} references undefined source {src}. "
                    f"Defined sources: {sorted(sources)}")
        for name, cfg in sources.items():
            if cfg["type"] not in BACKENDS:
                raise StorageError(
                    f"Storage source {name} has unknown type {cfg['type']!r}. "
                    f"Known types: {sorted(BACKENDS)}")
        return cls(sources, repositories)


class StorageRegistry:
    """Instantiates and caches DAOs per (source, kind)."""

    def __init__(self, config: Optional[StorageConfig] = None):
        self._config = config
        self._cache: Dict[tuple, Any] = {}
        self._lock = threading.RLock()

    @property
    def config(self) -> StorageConfig:
        if self._config is None:
            self._config = StorageConfig.from_env()
        return self._config

    def reset(self, config: Optional[StorageConfig] = None) -> None:
        """Swap config and tear down DAOs this registry created.

        Teardown is backend-agnostic: any cached DAO exposing ``shutdown()``
        (e.g. the sqlite DAOs' client teardown) is shut down; DAOs created
        outside this registry are untouched.
        """
        with self._lock:
            old = list(self._cache.values())
            self._config = config
            self._cache = {}
            for dao in old:
                shutdown = getattr(dao, "shutdown", None)
                if callable(shutdown):
                    shutdown()

    def _dao(self, repo: str, kind: str):
        source = self.config.repositories[repo]
        cfg = self.config.sources[source]
        key = (source, kind)
        with self._lock:
            if key not in self._cache:
                kinds = BACKENDS[cfg["type"]]
                if kind not in kinds:
                    raise StorageError(
                        f"Storage source {source} (type {cfg['type']}) does "
                        f"not support {kind}; it provides {sorted(kinds)}. "
                        f"Bind repository {repo} to a different source.")
                spec = kinds[kind]
                if kind == "PEvents" and spec == BACKENDS[cfg["type"]]["LEvents"]:
                    # Backend has no dedicated PEvents: wrap the SHARED
                    # LEvents DAO so both views see the same state.
                    inst = base.LEventsBackedPEvents(self._dao(repo, "LEvents"))
                else:
                    inst = _load(spec)(cfg)
                    if isinstance(inst, base.LEvents) and kind == "PEvents":
                        inst = base.LEventsBackedPEvents(inst)
                if kind == "LEvents" and isinstance(inst, base.LEvents):
                    # every event-store DAO the registry hands out reports
                    # pio_storage_op_* metrics; code needing the concrete
                    # backend type unwraps via observed.unwrap()
                    from predictionio_tpu_torch.data.storage.observed import (
                        DAOMetricsWrapper,
                    )
                    inst = DAOMetricsWrapper(inst, backend=cfg["type"])
                self._cache[key] = inst
            return self._cache[key]

    # -- accessors (Storage.scala:360-402) --------------------------------
    def get_levents(self) -> base.LEvents:
        return self._dao("EVENTDATA", "LEvents")

    def get_pevents(self) -> base.PEvents:
        return self._dao("EVENTDATA", "PEvents")

    def get_metadata_apps(self) -> base.Apps:
        return self._dao("METADATA", "Apps")

    def get_metadata_access_keys(self) -> base.AccessKeys:
        return self._dao("METADATA", "AccessKeys")

    def get_metadata_channels(self) -> base.Channels:
        return self._dao("METADATA", "Channels")

    def get_metadata_engine_instances(self) -> base.EngineInstances:
        return self._dao("METADATA", "EngineInstances")

    def get_metadata_evaluation_instances(self) -> base.EvaluationInstances:
        return self._dao("METADATA", "EvaluationInstances")

    def get_model_data_models(self) -> base.Models:
        return self._dao("MODELDATA", "Models")

    def verify_all_data_objects(self) -> None:
        """pio-status storage check (Storage.scala:335-358): touch every
        DAO, then run an insert/get/delete round-trip on the event store."""
        self.get_metadata_apps().get_all()
        self.get_metadata_access_keys().get_all()
        self.get_metadata_channels().get_by_appid(0)
        self.get_metadata_engine_instances().get_all()
        self.get_metadata_evaluation_instances().get_all()
        self.get_model_data_models().get("__status_check__")
        levents = self.get_levents()
        levents.init(0)
        from predictionio_tpu_torch.data.event import Event
        eid = levents.insert(
            Event(event="$set", entity_type="status_check", entity_id="check",
                  properties={"ok": True}), 0)
        if levents.get(eid, 0) is None:
            raise StorageError(
                "Event store round-trip failed: inserted test event "
                "could not be read back")
        levents.delete(eid, 0)
        levents.remove(0)


_registry = StorageRegistry()


def registry() -> StorageRegistry:
    return _registry


def reset(config: Optional[StorageConfig] = None) -> None:
    """Reset the process-global registry (tests / config reload)."""
    _registry.reset(config)


def get_levents() -> base.LEvents:
    return _registry.get_levents()


def get_pevents() -> base.PEvents:
    return _registry.get_pevents()


def get_metadata_apps() -> base.Apps:
    return _registry.get_metadata_apps()


def get_metadata_access_keys() -> base.AccessKeys:
    return _registry.get_metadata_access_keys()


def get_metadata_channels() -> base.Channels:
    return _registry.get_metadata_channels()


def get_metadata_engine_instances() -> base.EngineInstances:
    return _registry.get_metadata_engine_instances()


def get_metadata_evaluation_instances() -> base.EvaluationInstances:
    return _registry.get_metadata_evaluation_instances()


def get_model_data_models() -> base.Models:
    return _registry.get_model_data_models()


def verify_all_data_objects() -> None:
    _registry.verify_all_data_objects()
