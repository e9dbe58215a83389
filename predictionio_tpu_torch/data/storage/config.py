"""Env-var driven storage configuration and the process-wide storage runtime.

The same variables as the JAX package (Storage.scala:158-223): sources from
``PIO_STORAGE_SOURCES_<NAME>_*``, repositories from
``PIO_STORAGE_REPOSITORIES_<REPO>_{NAME,SOURCE}``; with no configuration at
all, everything lives in ``$PIO_HOME/pio.sqlite`` (default
``~/.predictionio_tpu``).  The port supports the ``sqlite`` source type
(events, metadata and models) and ``localfs`` (models only); any other
type raises.
"""

from __future__ import annotations

import os
import re
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Mapping

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.localfs_models import LocalFSModels
from predictionio_tpu_torch.data.storage.sqlite_backend import (
    SQLiteAccessKeys,
    SQLiteApps,
    SQLiteChannels,
    SQLiteClient,
    SQLiteEngineInstances,
    SQLiteEvaluationInstances,
    SQLiteLEvents,
    SQLiteModels,
    SQLitePEvents,
    create_tables,
)

REPOSITORIES = ("METADATA", "EVENTDATA", "MODELDATA")

_SOURCE_RE = re.compile(r"^PIO_STORAGE_SOURCES_([^_]+)_(.+)$")
_REPO_RE = re.compile(r"^PIO_STORAGE_REPOSITORIES_([^_]+)_(NAME|SOURCE)$")


class StorageError(Exception):
    pass


@dataclass
class StorageConfig:
    """Parsed storage topology: named sources + repo bindings."""

    sources: dict[str, dict[str, str]] = field(default_factory=dict)
    repositories: dict[str, dict[str, str]] = field(default_factory=dict)
    home: Path = field(
        default_factory=lambda: Path(
            os.environ.get("PIO_HOME", str(Path.home() / ".predictionio_tpu"))
        )
    )

    @classmethod
    def from_env(cls, env: Mapping[str, str] | None = None) -> "StorageConfig":
        env = dict(env if env is not None else os.environ)
        cfg = cls()
        if "PIO_HOME" in env:
            cfg.home = Path(env["PIO_HOME"])
        for key, value in env.items():
            m = _SOURCE_RE.match(key)
            if m:
                cfg.sources.setdefault(m.group(1), {})[m.group(2)] = value
                continue
            m = _REPO_RE.match(key)
            if m and m.group(1) in REPOSITORIES:
                cfg.repositories.setdefault(m.group(1), {})[m.group(2)] = value
        for repo in REPOSITORIES:
            if "SOURCE" not in cfg.repositories.get(repo, {}):
                cfg.repositories.setdefault(repo, {})["SOURCE"] = "PIO_DEFAULT"
        if any(
            r["SOURCE"] == "PIO_DEFAULT" for r in cfg.repositories.values()
        ) and "PIO_DEFAULT" not in cfg.sources:
            cfg.sources["PIO_DEFAULT"] = {
                "TYPE": "sqlite",
                "PATH": str(cfg.home / "pio.sqlite"),
            }
        return cfg

    def source_for(self, repo: str) -> tuple[str, dict[str, str]]:
        binding = self.repositories.get(repo, {})
        name = binding.get("SOURCE", "PIO_DEFAULT")
        if name not in self.sources:
            raise StorageError(
                f"repository {repo} is bound to undefined source {name!r}; "
                f"defined sources: {sorted(self.sources)}"
            )
        return name, self.sources[name]


class StorageRuntime:
    """Lazily-instantiated DAOs resolved through the config, one sqlite
    client per source (Storage.scala:239-293)."""

    def __init__(self, config: StorageConfig | None = None):
        self.config = config or StorageConfig.from_env()
        self._clients: dict[str, SQLiteClient] = {}
        #: the event DAOs, kept: the row DAO remembers the tables it made
        self._events: dict[str, object] = {}
        self._lock = threading.RLock()

    def _sql_client(self, name: str, props: dict[str, str]) -> SQLiteClient:
        with self._lock:
            if name not in self._clients:
                typ = props.get("TYPE", "sqlite")
                if typ != "sqlite":
                    raise StorageError(
                        f"source {name} has TYPE {typ!r}; this port supports "
                        "sqlite (events, metadata, models) and localfs (models)"
                    )
                path = props.get("PATH") or props.get("URL") or ":memory:"
                client = SQLiteClient(path)
                create_tables(client)
                self._clients[name] = client
            return self._clients[name]

    def _meta_client(self) -> SQLiteClient:
        name, props = self.config.source_for("METADATA")
        return self._sql_client(name, props)

    def apps(self) -> base.Apps:
        return SQLiteApps(self._meta_client())

    def access_keys(self) -> base.AccessKeys:
        return SQLiteAccessKeys(self._meta_client())

    def channels(self) -> base.Channels:
        return SQLiteChannels(self._meta_client())

    def engine_instances(self) -> base.EngineInstances:
        return SQLiteEngineInstances(self._meta_client())

    def evaluation_instances(self) -> base.EvaluationInstances:
        return SQLiteEvaluationInstances(self._meta_client())

    def l_events(self) -> base.LEvents:
        with self._lock:
            if "l" not in self._events:
                name, props = self.config.source_for("EVENTDATA")
                self._events["l"] = SQLiteLEvents(self._sql_client(name, props))
            return self._events["l"]

    def p_events(self) -> base.PEvents:
        with self._lock:
            if "p" not in self._events:
                name, props = self.config.source_for("EVENTDATA")
                self._events["p"] = SQLitePEvents(
                    self._sql_client(name, props), self.l_events()
                )
            return self._events["p"]

    def models(self) -> base.Models:
        name, props = self.config.source_for("MODELDATA")
        if props.get("TYPE", "sqlite") == "localfs":
            return LocalFSModels(
                props.get("PATH", str(self.config.home / "models"))
            )
        return SQLiteModels(self._sql_client(name, props))

    def close(self) -> None:
        with self._lock:
            for c in self._clients.values():
                c.close()
            self._clients.clear()
            self._events.clear()


_runtime: StorageRuntime | None = None
_runtime_lock = threading.Lock()


def get_storage() -> StorageRuntime:
    global _runtime
    with _runtime_lock:
        if _runtime is None:
            _runtime = StorageRuntime()
        return _runtime


def reset_storage(config: StorageConfig | None = None) -> StorageRuntime:
    """Swap the process-wide runtime (tests point it at temp dirs)."""
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            _runtime.close()
        _runtime = StorageRuntime(config)
        return _runtime
