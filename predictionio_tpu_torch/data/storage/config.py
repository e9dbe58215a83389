"""Env-var driven storage configuration and the process-wide storage runtime.

The same variables as the JAX package (Storage.scala:158-223): sources from
``PIO_STORAGE_SOURCES_<NAME>_*``, repositories from
``PIO_STORAGE_REPOSITORIES_<REPO>_{NAME,SOURCE}``; with no configuration at
all, everything lives in ``$PIO_HOME/pio.sqlite`` (default
``~/.predictionio_tpu``).  Source types: ``sqlite`` (events, metadata and
models), ``remote`` (all three over the storage daemon,
``server/storage_server.py``: the Elasticsearch server-fleet role; a
comma-separated URL names a fleet the event DAOs fan out over),
``parquet`` (events only: the entity-hash-sharded columnar log),
``localfs`` and ``hdfs`` (models only; ``hdfs`` is any fsspec URL),
``postgres`` / ``jdbc`` (events, metadata and models on a PostgreSQL
server: the sqlite DAOs over a dialect-translating client,
``postgres_backend.py``).
"""

from __future__ import annotations

import os
import re
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping

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
    """Lazily-instantiated DAOs resolved through the config, one client per
    source (Storage.scala:239-293), keyed by source name."""

    def __init__(self, config: StorageConfig | None = None):
        self.config = config or StorageConfig.from_env()
        self._clients: dict[str, Any] = {}
        self._lock = threading.RLock()
        # Import the pyarrow-backed module here when any source uses it.
        # The first import of pyarrow-touching code must not happen inside
        # a short-lived worker thread (an HTTP handler serving the first
        # bulk write): arrow state initialized on a thread that then dies
        # leaves later pa.array calls segfaulting.  Importing here pins it
        # to the thread that builds the runtime (process startup).
        if any(
            s.get("TYPE") == "parquet" for s in self.config.sources.values()
        ):
            from predictionio_tpu_torch.data.storage import parquet_backend  # noqa: F401

    def _sql_client(self, name: str, props: dict[str, str]):
        """A SQL client for a source: sqlite (embedded) or postgres (the
        same DAOs over a dialect-translating client)."""
        with self._lock:
            if name not in self._clients:
                typ = props.get("TYPE", "sqlite")
                if typ == "sqlite":
                    path = props.get("PATH") or props.get("URL") or ":memory:"
                    client = SQLiteClient(path)
                    create_tables(client)
                elif typ in ("postgres", "jdbc"):
                    from predictionio_tpu_torch.data.storage.postgres_backend import (
                        make_client,
                    )

                    client = make_client(props.get("URL", ""))
                else:
                    raise StorageError(
                        f"source {name} has unsupported SQL TYPE {typ!r}"
                    )
                self._clients[name] = client
            return self._clients[name]

    def _remote_client(self, name: str, props: dict[str, str]):
        """The keep-alive HTTP client of a storage-daemon source (the first
        of a fleet: metadata and models stay on one daemon).

        Resilience knobs (all optional): ``RETRIES`` total attempts
        (default 2 = one retry), ``RETRY_BACKOFF_S`` base decorrelated-
        jitter backoff, ``BREAKER`` off|on, ``BREAKER_THRESHOLD``
        consecutive transport failures before the circuit opens,
        ``BREAKER_RESET_S`` open to half-open delay; ``TIMEOUT`` (default
        30 s, sized to the largest bulk scan), ``VERIFY`` (TLS) and
        ``AUTHKEY``."""
        return self._remote_clients(name, props)[0]

    def _remote_clients(self, name: str, props: dict[str, str]) -> list:
        """All clients of a remote source.  A comma-separated URL names a
        storage fleet: the event DAOs fan writes and scans out across the
        daemons by entity-hash shard (shard k on daemon k % D)."""
        from predictionio_tpu_torch.data.storage.remote_backend import (
            RemoteClient,
        )
        from predictionio_tpu_torch.resilience.retry import RetryPolicy

        with self._lock:
            key = f"__remote_{name}__"
            if key not in self._clients:
                url = props.get("URL") or props.get("HOSTS", "")
                if not url:
                    raise StorageError(
                        f"remote source {name} needs PIO_STORAGE_SOURCES_"
                        f"{name}_URL (e.g. http://host:7072)"
                    )
                urls = [u.strip() for u in url.split(",") if u.strip()]
                breaker_off = props.get("BREAKER", "on").lower() in (
                    "off",
                    "false",
                    "0",
                    "no",
                )
                self._clients[key] = [
                    RemoteClient(
                        u,
                        auth_key=props.get("AUTHKEY"),
                        timeout=float(props.get("TIMEOUT", 30.0)),
                        verify=props.get("VERIFY", "true").lower()
                        not in ("false", "0", "no"),
                        retry=RetryPolicy(
                            max_attempts=max(int(props.get("RETRIES", 2)), 1),
                            base_backoff_s=float(
                                props.get("RETRY_BACKOFF_S", 0.05)
                            ),
                        ),
                        breaker=None if breaker_off else "auto",
                        breaker_threshold=int(
                            props.get("BREAKER_THRESHOLD", 5)
                        ),
                        breaker_reset_s=float(
                            props.get("BREAKER_RESET_S", 5.0)
                        ),
                    )
                    for u in urls
                ]
            return self._clients[key]

    def _parquet_client(self, name: str, props: dict[str, str]):
        from predictionio_tpu_torch.data.storage.parquet_backend import (
            DEFAULT_N_SHARDS,
            ParquetClient,
        )

        with self._lock:
            key = f"__parquet_{name}__"
            if key not in self._clients:
                self._clients[key] = ParquetClient(
                    props.get("PATH", str(self.config.home / "events_parquet")),
                    n_shards=int(props.get("NSHARDS", DEFAULT_N_SHARDS)),
                )
            return self._clients[key]

    def _meta_dao(self, sqlite_cls, remote_name: str):
        name, props = self.config.source_for("METADATA")
        if props.get("TYPE") == "remote":
            from predictionio_tpu_torch.data.storage import remote_backend

            return getattr(remote_backend, remote_name)(
                self._remote_client(name, props)
            )
        return sqlite_cls(self._sql_client(name, props))

    # -- metadata DAOs -------------------------------------------------------
    def apps(self) -> base.Apps:
        return self._meta_dao(SQLiteApps, "RemoteApps")

    def access_keys(self) -> base.AccessKeys:
        return self._meta_dao(SQLiteAccessKeys, "RemoteAccessKeys")

    def channels(self) -> base.Channels:
        return self._meta_dao(SQLiteChannels, "RemoteChannels")

    def engine_instances(self) -> base.EngineInstances:
        return self._meta_dao(SQLiteEngineInstances, "RemoteEngineInstances")

    def evaluation_instances(self) -> base.EvaluationInstances:
        return self._meta_dao(
            SQLiteEvaluationInstances, "RemoteEvaluationInstances"
        )

    def models(self) -> base.Models:
        name, props = self.config.source_for("MODELDATA")
        typ = props.get("TYPE", "sqlite")
        if typ == "remote":
            from predictionio_tpu_torch.data.storage.remote_backend import (
                RemoteModels,
            )

            return RemoteModels(self._remote_client(name, props))
        if typ == "localfs":
            return LocalFSModels(
                props.get("PATH", str(self.config.home / "models"))
            )
        if typ == "s3":
            from predictionio_tpu_torch.data.storage.s3_models import S3Models

            return S3Models(
                bucket=props.get("BUCKET", ""),
                prefix=props.get("PREFIX", ""),
                region=props.get("REGION"),
                endpoint=props.get("ENDPOINT"),
            )
        if typ == "hdfs":
            from predictionio_tpu_torch.data.storage.fsspec_models import (
                FsspecModels,
            )

            return FsspecModels(
                props.get("PATH", str(self.config.home / "models"))
            )
        if typ in ("sqlite", "postgres", "jdbc"):
            return SQLiteModels(self._sql_client(name, props))
        raise StorageError(f"unsupported MODELDATA source type {typ!r}")

    # -- event DAOs (cached: the row DAO remembers the tables it made) -------
    def l_events(self) -> base.LEvents:
        with self._lock:
            if "__levents__" not in self._clients:
                name, props = self.config.source_for("EVENTDATA")
                typ = props.get("TYPE", "sqlite")
                if typ == "parquet":
                    from predictionio_tpu_torch.data.storage.parquet_backend import (
                        ParquetLEvents,
                    )

                    dao = ParquetLEvents(self._parquet_client(name, props))
                elif typ == "remote":
                    from predictionio_tpu_torch.data.storage.remote_backend import (
                        FanoutLEvents,
                        RemoteLEvents,
                    )

                    clients = self._remote_clients(name, props)
                    dao = (
                        RemoteLEvents(clients[0])
                        if len(clients) == 1
                        else FanoutLEvents(clients)
                    )
                else:
                    dao = SQLiteLEvents(self._sql_client(name, props))
                self._clients["__levents__"] = dao
            return self._clients["__levents__"]

    def p_events(self) -> base.PEvents:
        with self._lock:
            if "__pevents__" not in self._clients:
                name, props = self.config.source_for("EVENTDATA")
                typ = props.get("TYPE", "sqlite")
                if typ == "parquet":
                    from predictionio_tpu_torch.data.storage.parquet_backend import (
                        ParquetPEvents,
                    )

                    dao = ParquetPEvents(self._parquet_client(name, props))
                elif typ == "remote":
                    from predictionio_tpu_torch.data.storage.remote_backend import (
                        FanoutPEvents,
                        RemotePEvents,
                    )

                    clients = self._remote_clients(name, props)
                    dao = (
                        RemotePEvents(clients[0])
                        if len(clients) == 1
                        else FanoutPEvents(clients)
                    )
                elif typ in ("postgres", "jdbc"):
                    from predictionio_tpu_torch.data.storage.postgres_backend import (
                        PGPEvents,
                    )

                    # the server hashes entities: iter_shards moves only
                    # the asked-for shards
                    dao = PGPEvents(
                        self._sql_client(name, props), self.l_events()
                    )
                else:
                    dao = SQLitePEvents(
                        self._sql_client(name, props), self.l_events()
                    )
                self._clients["__pevents__"] = dao
            return self._clients["__pevents__"]

    def breakers(self) -> list:
        """Circuit breakers of every instantiated remote client in this
        runtime: what ``/readyz`` folds in (this runtime's endpoints, not
        every breaker in the process)."""
        with self._lock:
            clients = []
            for c in self._clients.values():
                clients.extend(c if isinstance(c, list) else [c])
        out = []
        for c in clients:
            br = getattr(c, "breaker", None)
            if br is not None and br not in out:
                out.append(br)
        return out

    def verify_all_data_objects(self) -> dict[str, bool]:
        """Connectivity check per repository (the `pio status` probe,
        Storage.verifyAllDataObjects)."""
        out = {}
        for repo, probe in (
            ("METADATA", lambda: self.apps().get_all()),
            ("EVENTDATA", lambda: self.l_events().init(0) and self.l_events().remove(0)),
            ("MODELDATA", lambda: self.models().get("__probe__")),
        ):
            try:
                probe()
                out[repo] = True
            except Exception:
                out[repo] = False
        return out

    def close(self) -> None:
        with self._lock:
            flat = []
            for c in self._clients.values():
                flat.extend(c if isinstance(c, list) else [c])
            for c in flat:
                try:
                    c.close()
                except Exception:
                    pass
            self._clients.clear()


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
