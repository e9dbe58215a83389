"""Remote storage daemon: the networked storage backend.

The JAX package's ``server/storage_server.py``, ported whole: the same 43
routes, wire formats and root ownership, so either package's clients use
either package's daemon.  The reference's production deployments point
all three repositories at networked stores: Elasticsearch serves metadata
and events (storage/elasticsearch/.../ESLEvents.scala:41,
ESPEvents.scala:42), HBase serves events, HDFS serves models.  This daemon
is that role: one process owns the storage root (sqlite metadata and
models, the entity-hash-sharded parquet event log or sqlite events) and
exposes every DAO contract of ``data/storage/base.py`` over HTTP, so any
number of trainer, event-server and prediction-server processes share one
storage service.

Wire protocol: JSON for metadata and row-at-a-time events (the LEvents
side), the PIOF1 binary columnar codec (``data/storage/frame_codec.py``)
for bulk EventFrame scans (the PEvents side), shard-addressable so
multi-host trainers can each pull their entity-hash range as
``ParquetPEvents.iter_shards`` does locally.

Auth mirrors the dashboard/admin model (KeyAuthentication.scala:33): one
access key gates every route when configured.  TLS comes from
``AppServer``'s ``PIO_SSL_CERTFILE`` / ``PIO_SSL_KEYFILE`` support.

Start with ``python -m predictionio_tpu_torch.tools.cli storageserver
--port 7072 --root /data/pio`` or embed with ``create_storage_app`` /
``StorageServer`` (tests run it in-process).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from predictionio_tpu_torch.data.event import Event, EventValidationError
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.data.storage.base import concat_frames as _concat_frames
from predictionio_tpu_torch.data.storage.frame_codec import decode_frame, encode_frame
from predictionio_tpu_torch.data.storage.remote_backend import (
    engine_instance_from_dict,
    engine_instance_to_dict,
    evaluation_instance_from_dict,
    evaluation_instance_to_dict,
    filter_from_dict,
)
from predictionio_tpu_torch.server.httpd import (
    AppServer,
    HTTPApp,
    Request,
    Response,
    error_response,
    json_response,
)


def _req_filter(req: Request) -> base.EventFilter | None:
    raw = req.query.get("filter")
    return filter_from_dict(json.loads(raw)) if raw else None


def _chan(req: Request) -> int | None:
    c = req.query.get("channel")
    return int(c) if c else None


# ---------------------------------------------------------------------------
# The app
# ---------------------------------------------------------------------------


def create_storage_app(
    runtime: StorageRuntime, access_key: str | None = None
) -> HTTPApp:
    from predictionio_tpu_torch.obs.http import add_observability_routes

    app = HTTPApp("storage-server", access_key=access_key)
    rt = runtime

    def _metadata_ready() -> bool:
        rt.access_keys().get("__readyz_probe__")
        return True

    add_observability_routes(app, readiness={"metadata_store": _metadata_ready})

    @app.route("GET", r"/v1/ping")
    def ping(req: Request) -> Response:
        return json_response(200, {"status": "alive", "service": "storage"})

    # -- apps ----------------------------------------------------------------
    @app.route("POST", r"/v1/apps")
    def apps_insert(req: Request) -> Response:
        d = req.json()
        new_id = rt.apps().insert(
            base.App(
                id=int(d.get("id", 0)),
                name=d["name"],
                description=d.get("description"),
            )
        )
        return json_response(200, {"id": new_id})

    @app.route("GET", r"/v1/apps")
    def apps_all(req: Request) -> Response:
        return json_response(
            200, [dataclasses.asdict(a) for a in rt.apps().get_all()]
        )

    @app.route("GET", r"/v1/apps/id/(?P<id>\d+)")
    def apps_get(req: Request) -> Response:
        a = rt.apps().get(int(req.params["id"]))
        if a is None:
            return error_response(404, "app not found")
        return json_response(200, dataclasses.asdict(a))

    @app.route("GET", r"/v1/apps/name/(?P<name>[^/]+)")
    def apps_get_by_name(req: Request) -> Response:
        a = rt.apps().get_by_name(req.params["name"])
        if a is None:
            return error_response(404, "app not found")
        return json_response(200, dataclasses.asdict(a))

    @app.route("PUT", r"/v1/apps/id/(?P<id>\d+)")
    def apps_update(req: Request) -> Response:
        d = req.json()
        ok = rt.apps().update(
            base.App(
                id=int(req.params["id"]),
                name=d["name"],
                description=d.get("description"),
            )
        )
        return json_response(200, {"ok": ok})

    @app.route("DELETE", r"/v1/apps/id/(?P<id>\d+)")
    def apps_delete(req: Request) -> Response:
        return json_response(200, {"ok": rt.apps().delete(int(req.params["id"]))})

    # -- access keys ---------------------------------------------------------
    @app.route("POST", r"/v1/accesskeys")
    def keys_insert(req: Request) -> Response:
        d = req.json()
        key = rt.access_keys().insert(
            base.AccessKey(
                key=d.get("key", ""),
                appid=int(d["appid"]),
                events=tuple(d.get("events", ())),
            )
        )
        return json_response(200, {"key": key})

    @app.route("GET", r"/v1/accesskeys")
    def keys_all(req: Request) -> Response:
        appid = req.query.get("appid")
        keys = (
            rt.access_keys().get_by_appid(int(appid))
            if appid
            else rt.access_keys().get_all()
        )
        return json_response(
            200,
            [
                {"key": k.key, "appid": k.appid, "events": list(k.events)}
                for k in keys
            ],
        )

    @app.route("GET", r"/v1/accesskeys/(?P<key>[^/]+)")
    def keys_get(req: Request) -> Response:
        k = rt.access_keys().get(req.params["key"])
        if k is None:
            return error_response(404, "access key not found")
        return json_response(
            200, {"key": k.key, "appid": k.appid, "events": list(k.events)}
        )

    @app.route("PUT", r"/v1/accesskeys/(?P<key>[^/]+)")
    def keys_update(req: Request) -> Response:
        d = req.json()
        ok = rt.access_keys().update(
            base.AccessKey(
                key=req.params["key"],
                appid=int(d["appid"]),
                events=tuple(d.get("events", ())),
            )
        )
        return json_response(200, {"ok": ok})

    @app.route("DELETE", r"/v1/accesskeys/(?P<key>[^/]+)")
    def keys_delete(req: Request) -> Response:
        return json_response(200, {"ok": rt.access_keys().delete(req.params["key"])})

    # -- channels ------------------------------------------------------------
    @app.route("POST", r"/v1/channels")
    def chan_insert(req: Request) -> Response:
        d = req.json()
        try:
            ch = base.Channel(
                id=int(d.get("id", 0)), name=d["name"], appid=int(d["appid"])
            )
        except ValueError as e:
            return error_response(400, str(e))
        return json_response(200, {"id": rt.channels().insert(ch)})

    @app.route("GET", r"/v1/channels")
    def chan_by_app(req: Request) -> Response:
        chans = rt.channels().get_by_appid(int(req.query.get("appid", 0)))
        return json_response(200, [dataclasses.asdict(c) for c in chans])

    @app.route("GET", r"/v1/channels/(?P<id>\d+)")
    def chan_get(req: Request) -> Response:
        c = rt.channels().get(int(req.params["id"]))
        if c is None:
            return error_response(404, "channel not found")
        return json_response(200, dataclasses.asdict(c))

    @app.route("DELETE", r"/v1/channels/(?P<id>\d+)")
    def chan_delete(req: Request) -> Response:
        return json_response(
            200, {"ok": rt.channels().delete(int(req.params["id"]))}
        )

    # -- engine / evaluation instances --------------------------------------
    @app.route("POST", r"/v1/engine_instances")
    def ei_insert(req: Request) -> Response:
        i = engine_instance_from_dict(req.json())
        return json_response(200, {"id": rt.engine_instances().insert(i)})

    @app.route("GET", r"/v1/engine_instances")
    def ei_query(req: Request) -> Response:
        q = req.query
        dao = rt.engine_instances()
        if "engine_id" in q:
            args = (q["engine_id"], q.get("engine_version", ""), q.get("engine_variant", ""))
            if q.get("latest"):
                i = dao.get_latest_completed(*args)
                return json_response(
                    200, [engine_instance_to_dict(i)] if i else []
                )
            rows = dao.get_completed(*args)
        else:
            rows = dao.get_all()
        return json_response(200, [engine_instance_to_dict(i) for i in rows])

    @app.route("GET", r"/v1/engine_instances/(?P<id>[^/]+)")
    def ei_get(req: Request) -> Response:
        i = rt.engine_instances().get(req.params["id"])
        if i is None:
            return error_response(404, "engine instance not found")
        return json_response(200, engine_instance_to_dict(i))

    @app.route("PUT", r"/v1/engine_instances/(?P<id>[^/]+)")
    def ei_update(req: Request) -> Response:
        i = engine_instance_from_dict(req.json())
        return json_response(200, {"ok": rt.engine_instances().update(i)})

    @app.route("DELETE", r"/v1/engine_instances/(?P<id>[^/]+)")
    def ei_delete(req: Request) -> Response:
        return json_response(
            200, {"ok": rt.engine_instances().delete(req.params["id"])}
        )

    @app.route("POST", r"/v1/evaluation_instances")
    def vi_insert(req: Request) -> Response:
        i = evaluation_instance_from_dict(req.json())
        return json_response(200, {"id": rt.evaluation_instances().insert(i)})

    @app.route("GET", r"/v1/evaluation_instances")
    def vi_query(req: Request) -> Response:
        dao = rt.evaluation_instances()
        rows = dao.get_completed() if req.query.get("completed") else dao.get_all()
        return json_response(200, [evaluation_instance_to_dict(i) for i in rows])

    @app.route("GET", r"/v1/evaluation_instances/(?P<id>[^/]+)")
    def vi_get(req: Request) -> Response:
        i = rt.evaluation_instances().get(req.params["id"])
        if i is None:
            return error_response(404, "evaluation instance not found")
        return json_response(200, evaluation_instance_to_dict(i))

    @app.route("PUT", r"/v1/evaluation_instances/(?P<id>[^/]+)")
    def vi_update(req: Request) -> Response:
        i = evaluation_instance_from_dict(req.json())
        return json_response(200, {"ok": rt.evaluation_instances().update(i)})

    @app.route("DELETE", r"/v1/evaluation_instances/(?P<id>[^/]+)")
    def vi_delete(req: Request) -> Response:
        return json_response(
            200, {"ok": rt.evaluation_instances().delete(req.params["id"])}
        )

    # -- models (blob store; multipart maps onto keyed blobs client-side) ----
    @app.route("PUT", r"/v1/models/(?P<id>.+)")
    def models_put(req: Request) -> Response:
        rt.models().insert(req.params["id"], req.body)
        return json_response(200, {"ok": True})

    @app.route("GET", r"/v1/models/(?P<id>.+)")
    def models_get(req: Request) -> Response:
        blob = rt.models().get(req.params["id"])
        if blob is None:
            return error_response(404, "model not found")
        return Response(200, blob, content_type="application/octet-stream")

    @app.route("DELETE", r"/v1/models/(?P<id>.+)")
    def models_delete(req: Request) -> Response:
        return json_response(200, {"ok": rt.models().delete(req.params["id"])})

    # -- LEvents -------------------------------------------------------------
    @app.route("POST", r"/v1/apps/(?P<app>\d+)/init")
    def ev_init(req: Request) -> Response:
        ok = rt.l_events().init(int(req.params["app"]), _chan(req))
        return json_response(200, {"ok": ok})

    @app.route("POST", r"/v1/apps/(?P<app>\d+)/remove")
    def ev_remove(req: Request) -> Response:
        ok = rt.l_events().remove(int(req.params["app"]), _chan(req))
        return json_response(200, {"ok": ok})

    @app.route("POST", r"/v1/apps/(?P<app>\d+)/events")
    def ev_insert(req: Request) -> Response:
        try:
            events = [Event.from_api_dict(d) for d in req.json()]
        except (EventValidationError, TypeError, KeyError) as e:
            return error_response(400, f"invalid event: {e}")
        ids = rt.l_events().insert_batch(
            events, int(req.params["app"]), _chan(req)
        )
        return json_response(200, {"ids": ids})

    @app.route("GET", r"/v1/apps/(?P<app>\d+)/events")
    def ev_find(req: Request) -> Response:
        events = rt.l_events().find(
            int(req.params["app"]), _chan(req), _req_filter(req)
        )
        return json_response(200, [e.to_api_dict() for e in events])

    @app.route("GET", r"/v1/apps/(?P<app>\d+)/events/(?P<eid>[^/]+)")
    def ev_get(req: Request) -> Response:
        e = rt.l_events().get(req.params["eid"], int(req.params["app"]), _chan(req))
        if e is None:
            return error_response(404, "event not found")
        return json_response(200, e.to_api_dict())

    @app.route("DELETE", r"/v1/apps/(?P<app>\d+)/events/(?P<eid>[^/]+)")
    def ev_delete(req: Request) -> Response:
        ok = rt.l_events().delete(
            req.params["eid"], int(req.params["app"]), _chan(req)
        )
        return json_response(200, {"ok": ok})

    # -- PEvents (bulk columnar, shard-addressable) --------------------------
    @app.route("GET", r"/v1/apps/(?P<app>\d+)/shards")
    def fr_shards(req: Request) -> Response:
        """The shard count the scan protocol is keyed on — the APP's actual
        layout via the PEvents.n_shards contract (a parquet app dir records
        its n_shards at creation, which may differ from the daemon's
        default)."""
        n = rt.p_events().n_shards(int(req.params["app"]), _chan(req))
        return json_response(200, {"n_shards": n})

    @app.route("GET", r"/v1/apps/(?P<app>\d+)/frame")
    def fr_scan(req: Request) -> Response:
        """Bulk scan; ``shards`` (CSV of shard indices) restricts to those
        entity-hash shards in ONE request/scan — SQL-backed stores split a
        single table scan on the host, so a grouped fetch costs one scan
        instead of one per shard."""
        app_id, chan, flt = int(req.params["app"]), _chan(req), _req_filter(req)
        pe = rt.p_events()
        csv = req.query.get("shards")
        if csv is not None:
            want = [int(x) for x in csv.split(",") if x != ""]
            if hasattr(pe, "iter_shards"):
                frames = [
                    f for _, f in pe.iter_shards(app_id, chan, flt, shards=want)
                ]
                frame = _concat_frames(frames)
            else:
                # The base PEvents contract doesn't require iter_shards.
                # Clients (RemotePEvents' singleton fast path) trust that a
                # shard-restricted response IS the requested shards, so a
                # full-scan answer here would hand every worker the whole
                # event log — silent row duplication in multi-process
                # training.  Re-split server-side with the shared hash.
                from predictionio_tpu_torch.data.storage.base import frame_shard_of

                frame = pe.find(app_id, chan, flt)
                shard_of = frame_shard_of(
                    frame.entity_type, frame.entity_id,
                    pe.n_shards(app_id, chan),
                )
                frame = frame.take(np.isin(shard_of, want))
        else:
            frame = pe.find(app_id, chan, flt)
        return Response(
            200, encode_frame(frame), content_type="application/x-pio-frame"
        )

    @app.route("POST", r"/v1/apps/(?P<app>\d+)/frame")
    def fr_write(req: Request) -> Response:
        frame = decode_frame(req.body)
        rt.p_events().write(frame, int(req.params["app"]), _chan(req))
        return json_response(200, {"ok": True, "rows": len(frame)})

    @app.route("POST", r"/v1/apps/(?P<app>\d+)/compact")
    def fr_compact(req: Request) -> Response:
        pe = rt.p_events()
        fn = getattr(pe, "compact", None)
        if fn is None:  # SQL stores rewrite in place; nothing to fold
            return json_response(200, {"supported": False, "rows": 0})
        rows = fn(int(req.params["app"]), _chan(req))
        return json_response(200, {"supported": True, "rows": rows})

    @app.route("GET", r"/v1/apps/(?P<app>\d+)/eventstore_status")
    def fr_status(req: Request) -> Response:
        pe = rt.p_events()
        fn = getattr(pe, "status", None)
        if fn is None:  # SQL stores have no segment layout to report
            return json_response(200, {"supported": False})
        return json_response(200, fn(int(req.params["app"]), _chan(req)))

    @app.route("POST", r"/eventstore/compact")
    def eventstore_compact(req: Request) -> Response:
        """Fold every app on this daemon now (idempotent; the background
        compactor also runs on its own cadence)."""
        pe = rt.p_events()
        fn = getattr(pe, "compact", None)
        if fn is None:
            return json_response(200, {"supported": False, "apps": 0, "rows": 0})
        client = getattr(getattr(pe, "store", None), "client", None)
        from predictionio_tpu_torch.data.storage.compactor import Compactor

        comp = getattr(app, "compactor", None) or (
            Compactor(client) if client is not None else None
        )
        if comp is None:
            return json_response(200, {"supported": False, "apps": 0, "rows": 0})
        apps = 0
        rows = 0
        for app_id, channel_id in comp.app_keys():
            rows += comp.store.compact(app_id, channel_id)
            apps += 1
        return json_response(
            200, {"supported": True, "apps": apps, "rows": rows}
        )

    @app.route("GET", r"/eventstore\.json")
    def eventstore_status(req: Request) -> Response:
        """Aggregate segment/compaction status across every app on this
        daemon — what ``pio eventstore status --url`` and the ``pio
        status`` backlog WARNING read."""
        comp = getattr(app, "compactor", None)
        if comp is not None:
            return json_response(200, comp.status())
        # no background compactor: synthesize the same shape on demand
        pe = rt.p_events()
        client = getattr(getattr(pe, "store", None), "client", None)
        if client is None:
            return json_response(200, {"supported": False, "apps": []})
        from predictionio_tpu_torch.data.storage.compactor import (
            CompactionPolicy,
            Compactor,
        )

        return json_response(
            200, Compactor(client, CompactionPolicy.from_env()).status()
        )

    @app.route("POST", r"/v1/apps/(?P<app>\d+)/frame_delete")
    def fr_delete(req: Request) -> Response:
        ids = req.json().get("ids", [])
        rt.p_events().delete(ids, int(req.params["app"]), _chan(req))
        return json_response(200, {"ok": True})

    return app


def runtime_for_root(root: str | Path, events: str = "parquet") -> StorageRuntime:
    """Self-contained storage topology under one root directory: sqlite
    metadata + models, parquet (default) or sqlite events."""
    root = Path(root)
    env = {"PIO_HOME": str(root)}
    if events == "parquet":
        env |= {
            "PIO_STORAGE_SOURCES_PQ_TYPE": "parquet",
            "PIO_STORAGE_SOURCES_PQ_PATH": str(root / "events_parquet"),
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "PQ",
        }
    return StorageRuntime(StorageConfig.from_env(env))


class StorageServer:
    """Bind-and-serve wrapper (the daemon entry).

    With ``compaction=True`` (the default for parquet event stores) the
    daemon owns a background :class:`Compactor` that folds the write-hot
    head into sorted compacted segments on a watermark cadence — the
    HBase major-compaction role, continuous instead of operator-driven.
    """

    def __init__(
        self,
        root: str | Path,
        host: str = "0.0.0.0",
        port: int = 7072,
        access_key: str | None = None,
        events: str = "parquet",
        compaction: bool = True,
        compact_interval_s: float | None = None,
    ):
        self.runtime = runtime_for_root(root, events=events)
        self.app = create_storage_app(self.runtime, access_key=access_key)
        self.compactor = None
        self._owner_lock = None
        if events == "parquet":
            # advisory ownership of the parquet root for the daemon's
            # lifetime: other processes (CLI local compact) refuse to
            # fold a root whose in-flight-write bookkeeping lives here
            from predictionio_tpu_torch.data.storage.parquet_backend import (
                acquire_root_ownership,
            )

            pe0 = self.runtime.p_events()
            client0 = getattr(getattr(pe0, "store", None), "client", None)
            if client0 is not None:
                self._owner_lock = acquire_root_ownership(client0.root)
                if self._owner_lock is None:
                    import logging

                    logging.getLogger(
                        "predictionio_tpu_torch.server.storage"
                    ).warning(
                        "another process already owns storage root %s; "
                        "two daemons on one root will corrupt compaction",
                        client0.root,
                    )
        if compaction and events == "parquet":
            from predictionio_tpu_torch.data.storage.compactor import (
                CompactionPolicy,
                Compactor,
            )

            pe = self.runtime.p_events()
            client = getattr(getattr(pe, "store", None), "client", None)
            if client is not None:
                policy = CompactionPolicy.from_env()
                if compact_interval_s is not None:
                    import dataclasses

                    policy = dataclasses.replace(
                        policy, interval_s=compact_interval_s
                    )
                self.compactor = Compactor(client, policy)
                self.app.compactor = self.compactor
        self.server = AppServer(self.app, host=host, port=port)
        self.host, self.port = self.server.host, self.server.port

    def start_background(self) -> "StorageServer":
        if self.compactor is not None:
            self.compactor.start()
        self.server.start_background()
        return self

    def serve_forever(self) -> None:
        if self.compactor is not None:
            self.compactor.start()
        self.server.serve_forever()

    def shutdown(self) -> None:
        if self.compactor is not None:
            self.compactor.stop()
        self.server.shutdown()
        self.runtime.close()
        if self._owner_lock is not None:
            try:
                self._owner_lock.close()  # releases the flock
            except OSError:
                pass
            self._owner_lock = None
