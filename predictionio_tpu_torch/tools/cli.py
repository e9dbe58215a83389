"""``python -m predictionio_tpu_torch.tools.cli <verb>``.

The verbs of the JAX package's ``pio`` console (``tools/cli.py``) that the
port runs, with the flags that apply to them: ``version``, ``status``
(the storage checks and torch's devices, or with ``--url`` a running
server's health routes), ``app``
(``new|list|show|delete|data-delete|channel-new|channel-delete``),
``accesskey`` (``new|list|delete``), ``import``, ``export``,
``eventserver``, ``build`` (validates an engine.json), ``train``, ``eval``
(an ``Evaluation`` by import path, ``--params`` for a factory's keyword
arguments), ``deploy`` (``--event-port`` serves the event server beside
it, on the same storage, and joins its feedback events to the deploy's
answers; ``--feedback`` writes each answer back as an event; a server
already on the port is stopped first; ``--lifecycle`` runs the lifecycle
controller; ``--app SPEC`` (repeatable) serves several engines as tenants,
admitted against ``--hbm-budget-bytes``), ``undeploy``,
``batchpredict``, ``run`` (a user script), ``upgrade``, ``metrics``,
``storageserver`` (the remote storage daemon over a root: sqlite
metadata and models, ``--events parquet|sqlite``), ``eventstore``
(``status|compact``, local or ``--url`` of a daemon), ``app compact``,
``template`` (``list|get``: the bundled engines, and a starter
``engine.json``), ``lifecycle`` (the generation manifest, canary and
controller, from a running deploy's ``/lifecycle.json`` with ``--url`` or
from the model store; ``--watch``), ``quality`` (``/quality.json``'s
online metrics and drift; ``--watch``), ``tenants`` (``/tenants.json``)
``replay-request`` (re-answer a recorded request from its
checksum-verified generation and diff it), and the watch loop's verbs:
``alerts``, ``costs``, ``top`` and ``capacity`` (a running server's
``/alerts.json``, ``/costs.json``, ``/capacity.json``; ``--watch``),
``incident`` (``list|show|export`` of the forensic bundles, local or
``--url``), ``trace`` (one cross-process trace assembled from
``--from`` URLs and ``--file`` sets), ``explain`` (one answer's
provenance joined with its flight entry, logs and trace) and ``profile``
(the server's ``torch.profiler`` capture, or host stacks with
``--stacks``); the fleet: ``fleet`` (``deploy|status|scale|watch``: a
consistent-hash router in front of N ``deploy`` replica daemons, each on
``--device``), ``adminserver``, ``dashboard``, ``daemon``, ``start-all``,
``stop-all``, ``stop`` and ``undeploy --pidfile``; ``day`` (a scripted
production day over the fleet, judged by the verdict engine: exit 0 PASS,
1 FAIL, 2 a malformed scenario); ``check`` (the static analyzer, PIO-TORCH
rules in place of PIO-JAX, and the DASE contract checks with ``--engine``;
``train`` and ``deploy`` run the DASE pre-flight unless ``--no-check``);
``bench --compare`` (the perf-regression gate over two BENCH JSON lines:
exit 0 within ``--tolerance``, 1 on a regression, 2 on a usage error or an
old ``schema_version``; it runs nothing and touches no device);
plus ``--device`` on the verbs
that compute (default ``cuda``;
``cpu`` runs the plain versions on the host).  ``train``, ``deploy`` and
``batchpredict`` name an engine by ``--engine-id`` / ``--engine-version``
/ ``--variant``, each overridden by the engine.json's ``id`` /
``version`` / ``variant``.  Storage is configured by the same
``PIO_HOME`` / ``PIO_STORAGE_*`` variables; TLS by ``PIO_SSL_CERTFILE`` /
``PIO_SSL_KEYFILE``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import Any

from predictionio_tpu_torch.data.storage.config import get_storage
from predictionio_tpu_torch.tools import commands as cmd
from predictionio_tpu_torch.version import __version__


def _print(obj: Any) -> None:
    print(json.dumps(obj, indent=2, default=str))


def do_version(args) -> int:
    print(__version__)
    return 0


def do_status(args) -> int:
    """`pio status` (commands/Management.scala): the storage checks, with
    the devices and backend as torch sees them (``cpu`` on a host without
    a card), or with ``--url`` the health routes of a running server.  The
    exit code is the storage checks' alone."""
    if args.url:
        return _status_remote(args.url, args.access_key, args.no_quality)
    import torch

    checks = get_storage().verify_all_data_objects()
    cuda = torch.cuda.is_available()
    _print(
        {
            "version": __version__,
            "storage": checks,
            "devices": [
                f"cuda:{i} ({torch.cuda.get_device_name(i)})"
                for i in range(torch.cuda.device_count())
            ]
            if cuda
            else ["cpu"],
            "backend": "cuda" if cuda else "cpu",
        }
    )
    return 0 if all(checks.values()) else 1


def _status_remote(
    url: str, access_key: str | None = None, no_quality: bool = False
) -> int:
    """A running server's ``/healthz``, ``/readyz`` and ``/slo.json``,
    ``/quality.json``'s drift state unless ``no_quality``, and
    ``/lifecycle.json`` (with a sharded generation's plan axes),
    ``/efficiency.json`` (with a sharded model's slots), ``/eventstore.json``,
    ``/tenants.json``, ``/alerts.json`` and a router's ``/fleet.json`` when
    they answer.  Exit
    0 only when the server is alive and ready, not drifting, no critical
    alert fires, and (for a router) at least one replica is healthy; a readiness
    503 still prints its body, so the operator sees which check fails.  ``access_key`` rides as
    a Bearer header (a key-gated server answers 401 on every route but
    ``/healthz`` without it).  A server without a quality route (404/401)
    is not degraded by it."""
    import urllib.error
    import urllib.request

    base = url.rstrip("/")
    headers = (
        {"Authorization": f"Bearer {access_key}"} if access_key else {}
    )

    def fetch(path: str) -> tuple[int, Any]:
        try:
            req = urllib.request.Request(base + path, headers=headers)
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read().decode("utf-8"))
            except Exception:
                return e.code, {"message": str(e)}
        except Exception as e:  # down, refused or timed out: what the
            return 0, {"message": f"unreachable: {e}"}  # probe is for

    health_status, health = fetch("/healthz")
    ready_status, ready = fetch("/readyz")
    _slo_status, slo = fetch("/slo.json")
    report = {"url": base, "healthz": health, "readyz": ready, "slo": slo}
    drifting = False
    if not no_quality:
        q_status, quality = fetch("/quality.json")
        report["quality"] = quality
        drifting = (
            q_status == 200
            and quality.get("drift", {}).get("state") == "drifting"
        )
    lc_status, lifecycle = fetch("/lifecycle.json")
    if lc_status == 200:
        manifest = lifecycle.get("manifest") or {}
        report["lifecycle"] = {
            "live": manifest.get("live"),
            "canary_in_progress": lifecycle.get("canary_in_progress"),
            "rolled_back": manifest.get("rolled_back"),
        }
        plan = manifest.get("shard_plan")
        if plan:
            # the live generation serves sharded: show the recorded layout
            report["lifecycle"]["shard_plan_axes"] = plan.get("axes")
    # device-efficiency surface (404/401-tolerant like quality): an ACTIVE
    # recompile storm is an operator-actionable warning (traffic is
    # churning launch shapes) but does not change the exit code
    eff_status, efficiency = fetch("/efficiency.json")
    if eff_status == 200:
        storms = efficiency.get("recompiles", {}).get("active_storms", {})
        report["efficiency"] = {
            "active_recompile_storms": storms,
            "peaks": efficiency.get("peaks"),
        }
        shards = efficiency.get("shards") or {}
        if shards.get("devices"):
            # sharded serving has run: the mesh's slots and the per-slot
            # byte/wave attribution
            report["efficiency"]["mesh_devices"] = shards["devices"]
            report["efficiency"]["shards"] = shards.get("functions")
        for fn, storm in storms.items():
            print(
                f"WARNING: recompile storm active for {fn} "
                f"({storm.get('signatures', '?')} distinct shape "
                "signatures)",
                file=sys.stderr,
            )
    # event-store surface (404/401-tolerant): a compaction backlog over
    # the watermark budget means scans are paying the write-hot head, an
    # operator-actionable WARNING; the exit code is unchanged (ingest
    # still works)
    es_status, es_body = fetch("/eventstore.json")
    if es_status == 200 and "backlog_segments" in es_body:
        report["eventstore"] = {
            "backlog_segments": es_body.get("backlog_segments"),
            "watermark_lag_s": es_body.get("watermark_lag_s"),
            "compactor_running": es_body.get("running"),
        }
        if es_body.get("over_budget"):
            budget = (es_body.get("policy") or {}).get(
                "backlog_budget_segments"
            )
            print(
                "WARNING: event-store compaction backlog "
                f"{es_body.get('backlog_segments')} segments exceeds the "
                f"watermark budget ({budget}); scans are paying the "
                "write-hot head",
                file=sys.stderr,
            )
    # one row per resident tenant, so the operator sees which app is
    # unhealthy; a degraded tenant is a warning, the exit code stays the
    # replica's own
    tn_status, tn_body = fetch("/tenants.json")
    if tn_status == 200 and isinstance(tn_body.get("tenants"), list):
        report["tenants"] = {
            "count": tn_body.get("count"),
            "hbm_resident_bytes": tn_body.get("hbm_resident_bytes"),
            "hbm_budget_bytes": tn_body.get("hbm_budget_bytes"),
            "rows": [
                {
                    "app": t.get("app"),
                    "slo": (t.get("slo") or {}).get("status"),
                    "availability": (t.get("slo") or {}).get("availability"),
                    "quota_denied": (t.get("quota") or {}).get("denied"),
                    "hbm_bytes": t.get("hbm_bytes"),
                    "inflight": t.get("inflight"),
                    "degraded": t.get("degraded") or [],
                }
                for t in tn_body["tenants"]
            ],
        }
        for t in tn_body["tenants"]:
            slo_state = (t.get("slo") or {}).get("status")
            degraded = t.get("degraded") or []
            if slo_state == "degraded" or degraded:
                print(
                    f"WARNING: tenant {t.get('app')} slo={slo_state}"
                    + (f" degraded={','.join(degraded)}" if degraded else ""),
                    file=sys.stderr,
                )
    # alert surface (404/401-tolerant like quality): every FIRING alert is
    # an operator-actionable WARNING line, and a firing alert of severity
    # "critical" flips the exit code: the watch loop's verdict outranks a
    # process that merely answers its probes
    critical_firing = False
    al_status, alerts_body = fetch("/alerts.json")
    if al_status == 200 and isinstance(alerts_body.get("alerts"), list):
        report["alerts"] = {
            "firing": alerts_body.get("firing", 0),
            "pending": alerts_body.get("pending", 0),
        }
        for a in alerts_body["alerts"]:
            if a.get("state") != "firing":
                continue
            print(
                f"WARNING: alert {a.get('rule')}"
                + (f"{{{a['key']}}}" if a.get("key") else "")
                + f" firing (value={a.get('value')}, "
                f"severity={a.get('severity')})",
                file=sys.stderr,
            )
            if a.get("severity") == "critical":
                critical_firing = True
        for err in alerts_body.get("source_errors", []):
            print(
                f"note: alert federation source error: {err}",
                file=sys.stderr,
            )
    # fleet surface (404/401-tolerant): when the probed server is a fleet
    # router, fold the membership registry: an ejected replica is a
    # WARNING, and a fleet with no healthy replica cannot serve at all
    # (exit 1 even though the router process is alive)
    fleet_dead = False
    fl_status, fleet_body = fetch("/fleet.json")
    if fl_status == 200 and isinstance(fleet_body.get("replicas"), list):
        report["fleet"] = {
            "total": fleet_body.get("total"),
            "healthy": fleet_body.get("healthy"),
            "routable": fleet_body.get("routable"),
        }
        for r in fleet_body["replicas"]:
            if r.get("draining"):
                continue
            if not r.get("healthy") or r.get("breaker") == "open":
                why = r.get("last_probe_error") or f"breaker {r.get('breaker')}"
                print(
                    f"WARNING: replica {r.get('replica')} ejected from "
                    f"routing ({why})",
                    file=sys.stderr,
                )
        if not fleet_body.get("healthy"):
            fleet_dead = True
    _print(report)
    alive = health_status == 200 and health.get("status") == "alive"
    return (
        0
        if alive and ready_status == 200 and not drifting
        and not fleet_dead and not critical_firing
        else 1
    )


def _key(k) -> dict:
    return {"key": k.key, "appid": k.appid, "events": list(k.events)}


def do_app(args) -> int:
    storage = get_storage()
    if args.app_command == "new":
        d = cmd.app_new(
            storage, args.name, description=args.description or "",
            access_key=args.access_key,
        )
        _print(d.to_json_dict())
    elif args.app_command == "list":
        _print([d.to_json_dict() for d in cmd.app_list(storage)])
    elif args.app_command == "show":
        _print(cmd.app_show(storage, args.name).to_json_dict())
    elif args.app_command == "delete":
        cmd.app_delete(storage, args.name)
        print(f"App {args.name} deleted.")
    elif args.app_command == "data-delete":
        cmd.app_data_delete(storage, args.name, channel=args.channel)
        print(f"Data of app {args.name} deleted.")
    elif args.app_command == "compact":
        rows = cmd.app_compact(storage, args.name, channel=args.channel)
        if rows is None:
            print("Event store rewrites in place; nothing to compact.")
        else:
            print(f"Compacted app {args.name}: {rows} live events.")
    elif args.app_command == "channel-new":
        ch = cmd.channel_new(storage, args.name, args.channel)
        _print({"id": ch.id, "name": ch.name, "appid": ch.appid})
    elif args.app_command == "channel-delete":
        cmd.channel_delete(storage, args.name, args.channel)
        print(f"Channel {args.channel} deleted.")
    return 0


def _local_compactor():
    """A Compactor over the locally configured parquet event store, or
    None when the event backend has no segment layout (SQL stores)."""
    pe = get_storage().p_events()
    client = getattr(getattr(pe, "store", None), "client", None)
    if client is None:
        return None
    from predictionio_tpu_torch.data.storage.compactor import (
        CompactionPolicy,
        Compactor,
    )

    return Compactor(client, CompactionPolicy.from_env())


def _render_eventstore_status(st: dict) -> None:
    """Human rendering of the /eventstore.json shape."""
    pol = st.get("policy") or {}
    print(
        f"compactor: {'running' if st.get('running') else 'idle'}  "
        f"backlog={st.get('backlog_segments')} segments"
        + (
            f" (budget {pol.get('backlog_budget_segments')})"
            if pol
            else ""
        )
    )
    lag = st.get("watermark_lag_s")
    if lag is not None:
        print(f"watermark lag: {lag:.1f}s")
    vis = st.get("visibility") or {}
    if vis.get("rows_observed"):
        print(
            f"visibility lag: p50={vis.get('lag_p50_s', 0):.1f}s "
            f"p99={vis.get('lag_p99_s', 0):.1f}s "
            f"(rows observed {vis['rows_observed']:,})"
        )
    for a in st.get("apps", []):
        if a.get("error"):
            print(f"  app {a.get('app_id')}: ERROR {a['error']}")
            continue
        chan = (
            f" channel {a['channel_id']}"
            if a.get("channel_id") is not None
            else ""
        )
        print(
            f"  app {a.get('app_id')}{chan}: shards={a.get('n_shards')} "
            f"hot={a.get('segments_hot')} "
            f"compacted={a.get('segments_compacted')} "
            f"bytes={a.get('bytes', 0):,} "
            f"byte_skew={a.get('byte_skew_frac', 0):.2f} "
            f"rows~{a.get('rows_hint', 0):,}"
        )
    if st.get("over_budget"):
        print(
            "WARNING: backlog exceeds the watermark budget; scans are "
            "paying the write-hot head"
        )


def do_eventstore(args) -> int:
    """`pio eventstore status|compact`: segment counts, compaction backlog,
    watermark lag and per-shard byte skew; ``compact`` folds the
    write-hot head now.  With ``--url``, through a running storage daemon
    (which owns its root's in-flight write bookkeeping); locally, a root
    that a daemon owns is refused."""
    if args.url:
        import urllib.request

        base = args.url.rstrip("/")
        headers = (
            {"Authorization": f"Bearer {args.access_key}"}
            if args.access_key
            else {}
        )

        def call(method: str, path: str):
            req = urllib.request.Request(
                base + path, headers=headers, method=method
            )
            with urllib.request.urlopen(req, timeout=args.timeout) as r:
                return json.loads(r.read().decode("utf-8"))

        try:
            if args.es_command == "compact":
                out = call("POST", "/eventstore/compact")
            else:
                out = call("GET", "/eventstore.json")
        except Exception as e:
            print(f"eventstore: {base} unreachable: {e}", file=sys.stderr)
            return 1
    else:
        comp = _local_compactor()
        if comp is None:
            print(
                "eventstore: the configured event backend has no segment "
                "layout (SQL stores rewrite in place); nothing to report."
            )
            return 0
        if args.es_command == "compact":
            from predictionio_tpu_torch.data.storage.parquet_backend import (
                acquire_root_ownership,
            )

            owner = acquire_root_ownership(comp.client.root)
            if owner is None:
                print(
                    "eventstore: another process (a storage daemon?) owns "
                    f"root {comp.client.root}; folding from here could "
                    "race its in-flight writes; compact through it with "
                    "--url instead.",
                    file=sys.stderr,
                )
                return 1
            try:
                apps = rows = 0
                for app_id, channel_id in comp.app_keys():
                    rows += comp.store.compact(app_id, channel_id)
                    apps += 1
                out = {"supported": True, "apps": apps, "rows": rows}
            finally:
                owner.close()
        else:
            out = comp.status()
    if args.json:
        _print(out)
    elif args.es_command == "compact":
        print(
            f"Compacted {out.get('apps', 0)} app(s): "
            f"{out.get('rows', 0):,} live rows."
            if out.get("supported", True)
            else "Event store rewrites in place; nothing to compact."
        )
    else:
        _render_eventstore_status(out)
    if args.es_command == "status" and out.get("over_budget"):
        return 1
    return 0


def do_storageserver(args) -> int:
    """`pio storageserver`: run the remote storage daemon, the networked
    storage role the reference fills with Elasticsearch/HBase servers
    (ESLEvents.scala:41); clients point ``PIO_STORAGE_SOURCES_*_TYPE=
    remote`` at it.  It prints its bound line once serving (``--port 0``
    binds a free port) and shuts down on SIGINT or SIGTERM."""
    import signal
    import threading

    from predictionio_tpu_torch.server.storage_server import StorageServer

    if (
        args.ip not in ("127.0.0.1", "localhost", "::1")
        and not args.access_key
        and not os.environ.get("PIO_STORAGE_SERVER_ALLOW_OPEN")
    ):
        print(
            f"storageserver: refusing to bind {args.ip} without --access-key "
            "(the daemon exposes raw model-blob writes; a remote pickle "
            "write is code execution on the next train/deploy host). Pass "
            "--access-key, bind 127.0.0.1, or set "
            "PIO_STORAGE_SERVER_ALLOW_OPEN=1 to override.",
            file=sys.stderr,
        )
        return 1
    server = StorageServer(
        root=args.root,
        host=args.ip,
        port=args.port,
        access_key=args.access_key,
        events=args.events,
        compaction=not args.no_compact,
        compact_interval_s=args.compact_interval,
    )
    stop = threading.Event()
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    server.start_background()
    print(
        f"Storage daemon on http://{args.ip}:{server.port} (root={args.root})",
        flush=True,
    )
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return 0


def do_accesskey(args) -> int:
    storage = get_storage()
    if args.ak_command == "new":
        _print(_key(cmd.accesskey_new(
            storage, args.app, key=args.key, events=args.event or []
        )))
    elif args.ak_command == "list":
        _print([_key(k) for k in cmd.accesskey_list(storage, args.app)])
    elif args.ak_command == "delete":
        cmd.accesskey_delete(storage, args.key)
        print(f"Access key {args.key} deleted.")
    return 0


def do_import(args) -> int:
    n = cmd.import_events(get_storage(), args.app, args.input, channel=args.channel)
    print(f"Imported {n} events.")
    return 0


def do_export(args) -> int:
    n = cmd.export_events(
        get_storage(), args.app, args.output, channel=args.channel,
        format=args.format,
    )
    print(f"Exported {n} events.")
    return 0


def do_eventserver(args) -> int:
    from predictionio_tpu_torch.server.event_server import create_event_server

    server = create_event_server(
        host=args.ip, port=args.port, storage=get_storage(), stats=args.stats
    )
    return _serve_until_interrupted(
        server, f"Event server on http://{args.ip}:{server.port}")


def _serve_until_interrupted(server, banner: str) -> int:
    """Print ``banner`` once bound, serve in the foreground until an
    interrupt, then shut the server down."""
    print(banner, flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return 0


def do_adminserver(args) -> int:
    """`pio adminserver`: the admin REST API (app and access-key verbs
    over HTTP); it never touches the card."""
    from predictionio_tpu_torch.server.admin import create_admin_server

    server = create_admin_server(
        host=args.ip, port=args.port, storage=get_storage(),
        access_key=args.access_key,
    )
    return _serve_until_interrupted(
        server, f"Admin server on http://{args.ip}:{server.port}")


def do_dashboard(args) -> int:
    """`pio dashboard`: completed evaluations, traces and the watch
    panels; it never touches the card."""
    from predictionio_tpu_torch.server.dashboard import create_dashboard_server

    server = create_dashboard_server(
        host=args.ip, port=args.port, storage=get_storage(),
        access_key=args.access_key,
    )
    return _serve_until_interrupted(
        server, f"Dashboard on http://{args.ip}:{server.port}")


def do_daemon(args) -> int:
    """`pio daemon <pidfile> <verb...>`: detach any verb with a pidfile."""
    from predictionio_tpu_torch.tools import daemon

    cli_args = list(args.command)
    if cli_args and cli_args[0] == "--":
        cli_args = cli_args[1:]
    if not cli_args:
        print("daemon requires a command, e.g. pio daemon es.pid eventserver",
              file=sys.stderr)
        return 1
    pid = daemon.spawn_daemon(cli_args, args.pidfile)
    print(f"Started '{' '.join(cli_args)}' (pid {pid}, pidfile {args.pidfile})")
    return 0


def do_start_all(args) -> int:
    """`pio start-all`: the event server, the admin API and the dashboard
    as pidfile-tracked daemons, after the storage daemon when a repository
    is bound to a loopback ``remote`` source."""
    from predictionio_tpu_torch.tools import daemon

    try:
        pids = daemon.start_all(
            ip=args.ip,
            ports={
                "eventserver": str(args.event_port),
                "adminserver": str(args.admin_port),
                "dashboard": str(args.dashboard_port),
            },
        )
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    for name, pid in pids.items():
        print(f"{name}: pid {pid}")
    return 0


def _report_stop(name: str, won: str | None) -> None:
    """One line per daemon naming WHICH signal won: a daemon that needed
    SIGKILL was wedged, and the operator should know."""
    if won == "TERM":
        print(f"{name}: stopped (SIGTERM)")
    elif won == "KILL":
        print(f"{name}: ignored SIGTERM past the deadline; killed (SIGKILL)")
    else:
        print(f"{name}: was not running")


def do_stop_all(args) -> int:
    """`pio stop-all`: stop every pidfile-tracked daemon."""
    from predictionio_tpu_torch.tools import daemon

    stopped = daemon.stop_all()
    if not stopped:
        print("Nothing to stop.")
    for name, won in stopped.items():
        _report_stop(name, won)
    return 0


def do_stop(args) -> int:
    """`pio stop <name-or-pidfile>`: stop ONE pidfile-tracked daemon,
    escalating SIGTERM -> SIGKILL past ``--timeout``."""
    from predictionio_tpu_torch.tools import daemon

    # only an EXPLICIT pidfile spelling (.pid suffix or a path separator)
    # is a path; bare names map to $PIO_HOME/pids/, so a stray file named
    # `eventserver` in the cwd is never unlinked
    if args.name.endswith(".pid") or os.sep in args.name:
        target = Path(args.name)
    else:
        target = daemon.pio_home() / "pids" / f"{args.name}.pid"
    if not target.is_file():
        print(f"no pidfile at {target}", file=sys.stderr)
        return 1
    won = daemon.stop_pidfile(target, timeout=args.timeout)
    _report_stop(target.stem, won)
    return 0


def _resolve_engine(args):
    """(factory name, Engine, variant JSON) from --engine / --engine-json."""
    from predictionio_tpu_torch.core.engine import resolve_engine_factory

    variant: dict = {}
    if args.engine_json:
        variant = json.loads(Path(args.engine_json).read_text())
    factory_name = args.engine or variant.get("engineFactory")
    if not factory_name:
        raise cmd.CommandError(
            "no engine specified: pass --engine NAME or an engine.json with "
            "an 'engineFactory' field"
        )
    return factory_name, resolve_engine_factory(factory_name)(), variant


def _engine_coords(args) -> tuple[str, str, str, str]:
    """(factory, engine id, version, variant): a key in the --engine-json
    file wins over its flag (the JAX package's rule)."""
    variant: dict = {}
    if args.engine_json and Path(args.engine_json).exists():
        variant = json.loads(Path(args.engine_json).read_text())
    return (
        args.engine or variant.get("engineFactory") or "",
        variant.get("id", args.engine_id),
        variant.get("version", args.engine_version),
        variant.get("variant", args.variant),
    )


def do_build(args) -> int:
    """`pio build`: engines are plain Python and the CUDA kernels build at
    first use, so there is nothing to compile; validates the engine.json
    instead."""
    try:
        if args.engine_json and not Path(args.engine_json).exists():
            raise cmd.CommandError(
                f"engine variant file {args.engine_json!r} not found"
            )
        factory_name, engine, variant = _resolve_engine(args)
        engine.params_from_json(variant)
    except Exception as e:
        print(f"engine variant is invalid: {e}", file=sys.stderr)
        return 1
    print(f"Engine {factory_name!r} OK (no build step needed; the CUDA "
          "kernels build at first use and are cached).")
    return 0


def _dase_preflight(factory_name: str, engine=None, skip: bool = False) -> int:
    """Static DASE contract check before any device work (the scalac role).

    Returns 0 when clean/skipped, 1 when the wiring is broken — the caller
    aborts before touching storage or devices.  ``--no-check`` skips.

    With ``PIO_PREFLIGHT_LINT=1`` a full-package `pio check` scan rides
    along as an advisory (never blocks the launch) — cheap to leave on
    because it runs through the check-result cache: an unchanged package
    is a pure cache hit, no re-parsing per launch.
    """
    if skip or not factory_name:
        return 0
    _preflight_lint_advisory()
    from predictionio_tpu_torch.analysis.contract import (
        check_engine,
        check_engine_contract,
    )

    root = Path.cwd()  # repo-relative paths in the printed findings
    findings = (
        check_engine(engine, factory_name, root=root)
        if engine is not None
        else check_engine_contract(factory_name, root=root)
    )
    if not findings:
        return 0
    for f in findings:
        print(f.text(), file=sys.stderr)
    print(
        f"DASE pre-flight failed for engine {factory_name!r}: "
        f"{len(findings)} contract violation(s) — fix the wiring or pass "
        "--no-check to skip",
        file=sys.stderr,
    )
    return 1


def _preflight_lint_advisory() -> None:
    """Cached advisory lint of the deployed package (PIO_PREFLIGHT_LINT=1)."""
    if os.environ.get("PIO_PREFLIGHT_LINT") != "1":
        return
    try:
        from predictionio_tpu_torch.analysis import analyze_paths
        from predictionio_tpu_torch.analysis.cache import (
            DEFAULT_CACHE_NAME,
            CheckCache,
        )
        from predictionio_tpu_torch.tools.daemon import pio_home

        import predictionio_tpu_torch as _pkg

        pkg_root = Path(_pkg.__file__).parent
        cache = CheckCache(Path(pio_home()) / DEFAULT_CACHE_NAME)
        report = analyze_paths(
            [pkg_root], root=pkg_root.parent, cache=cache
        )
        if report.findings:
            print(
                f"pre-flight lint (advisory): {len(report.findings)} "
                f"finding(s) in {report.files_scanned} file(s); run "
                "`pio check` for details "
                f"[{cache.stats_line()}]",
                file=sys.stderr,
            )
    except Exception as e:  # advisory: a lint crash must not block launch
        print(f"pre-flight lint skipped: {e}", file=sys.stderr)


def do_train(args) -> int:
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.workflow import WorkflowParams, run_train
    from predictionio_tpu_torch.parallel.mesh import (
        MeshConfig,
        initialize_distributed,
    )

    # join the process group (under PIO_COORDINATOR_ADDRESS) before
    # anything else, as the JAX package's train does
    initialize_distributed(device=args.device)
    factory_name, engine, variant = _resolve_engine(args)
    # before EngineContext resolves the device: a miswired engine exits 1
    # on a host with or without a card, and no CUDA context is made
    if _dase_preflight(factory_name, engine, skip=args.no_check):
        return 1
    params = engine.params_from_json(variant)
    storage = get_storage()
    ctx = EngineContext(
        mesh_config=MeshConfig.from_dict(variant.get("mesh")),
        storage=storage,
        mode="train",
        device=args.device,
    )
    instance = run_train(
        engine,
        params,
        ctx=ctx,
        workflow_params=WorkflowParams(
            batch=args.batch,
            skip_sanity_check=args.skip_sanity_check,
            stop_after_read=args.stop_after_read,
            stop_after_prepare=args.stop_after_prepare,
        ),
        engine_id=variant.get("id", args.engine_id),
        engine_version=variant.get("version", args.engine_version),
        engine_variant=variant.get("variant", args.variant),
        engine_factory=factory_name,
        storage=storage,
    )
    if instance is not None:
        print(f"Training completed. Engine instance: {instance.id}")
    return 0


def do_eval(args) -> int:
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.workflow import run_evaluation
    from predictionio_tpu_torch.eval.evaluation import resolve_evaluation
    from predictionio_tpu_torch.eval.evaluator import MetricEvaluator

    import predictionio_tpu_torch.models  # noqa: F401  (bundled factories)

    evaluation = resolve_evaluation(
        args.evaluation, json.loads(args.params) if args.params else None
    )
    storage = get_storage()
    result = run_evaluation(
        evaluation.engine_factory(),
        evaluation.params_list(),
        MetricEvaluator(evaluation.metric, evaluation.other_metrics),
        ctx=EngineContext(storage=storage, mode="eval", device=args.device),
        evaluation_class=args.evaluation,
        storage=storage,
    )
    print(result.one_liner())
    print(f"Best score: {result.best.score}")
    return 0


def _parse_tenant_spec(raw: str) -> dict:
    """One ``--app`` value -> a ``deploy_tenant_engines`` spec dict."""
    kv: dict[str, str] = {}
    for part in raw.split(","):
        if not part.strip():
            continue
        k, sep, v = part.partition("=")
        if not sep:
            raise cmd.CommandError(
                f"bad --app spec part {part!r}: expected key=value"
            )
        kv[k.strip()] = v.strip()
    if "name" not in kv or "engine" not in kv:
        raise cmd.CommandError(
            "--app spec needs at least name=<app>,engine=<factory>"
        )
    spec: dict[str, Any] = {
        "app": kv["name"],
        "engine_factory": kv["engine"],
        "engine_id": kv.get("engine_id", "default"),
        "engine_version": kv.get("engine_version", "default"),
        "engine_variant": kv.get("variant", "default"),
        "engine_instance_id": kv.get("engine_instance_id"),
        "access_key": kv.get("access_key"),
    }
    if kv.get("quota_rps"):
        spec["quota_rps"] = float(kv["quota_rps"])
    if kv.get("quota_burst"):
        spec["quota_burst"] = float(kv["quota_burst"])
    if kv.get("max_inflight"):
        spec["max_inflight"] = int(kv["max_inflight"])
    if kv.get("deadline_s"):
        spec["default_deadline_s"] = float(kv["deadline_s"])
    return spec


def _deploy_multi_tenant(args) -> int:
    """``deploy --app ... --app ...``: several engines as tenants of one
    deploy, each admitted against ``--hbm-budget-bytes``.  A refusal prints
    the bin-packer's structured reason and exits 1."""
    from predictionio_tpu_torch.server.aio import AsyncAppServer
    from predictionio_tpu_torch.server.prediction_server import (
        create_multi_tenant_server_app,
        deploy_tenant_engines,
        undeploy_stale,
    )
    from predictionio_tpu_torch.tenancy import TenantAdmissionError

    specs = [_parse_tenant_spec(s) for s in args.app_specs]
    if args.port and undeploy_stale(args.ip, args.port, args.accesskey or None):
        print(f"undeployed stale server on port {args.port}")
    try:
        tenants = deploy_tenant_engines(
            specs,
            storage=get_storage(),
            hbm_budget_bytes=args.hbm_budget_bytes,
            device=args.device,
        )
    except TenantAdmissionError as e:
        print(json.dumps(e.to_dict(), indent=2), file=sys.stderr)
        return 1
    server_ref: list[Any] = []

    def on_stop():
        if server_ref:
            server_ref[0].shutdown()

    app = create_multi_tenant_server_app(
        tenants,
        on_stop=on_stop,
        access_key=args.accesskey or None,
        use_microbatch=True,
        max_queue=args.max_queue,
        max_inflight=args.max_inflight,
        default_deadline_s=args.deadline_s,
    )
    server = AsyncAppServer(app, args.ip, args.port)
    server_ref.append(server)
    server.start_background()
    print(
        f"Serving {len(tenants)} tenants ({', '.join(tenants.apps())}) on "
        f"http://{args.ip}:{server.port} ({args.device}; the X-Pio-App "
        "header or ?app= selects the tenant)",
        flush=True,
    )
    try:
        server.join()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return 0


def do_deploy(args) -> int:
    from predictionio_tpu_torch.server.prediction_server import (
        FeedbackConfig,
        create_prediction_server,
    )

    if args.app_specs:
        return _deploy_multi_tenant(args)
    factory, engine_id, engine_version, engine_variant = _engine_coords(args)
    if _dase_preflight(factory, skip=args.no_check):
        return 1
    server = create_prediction_server(
        factory,
        host=args.ip,
        port=args.port,
        storage=get_storage(),
        engine_instance_id=args.engine_instance_id,
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
        feedback=FeedbackConfig(
            enabled=args.feedback, access_key=args.accesskey or None
        ),
        access_key=args.accesskey or None,
        max_queue=args.max_queue,
        max_inflight=args.max_inflight,
        default_deadline_s=args.deadline_s,
        device=args.device,
        enable_lifecycle=True if args.lifecycle else None,
    )
    event_server = None
    if args.event_port is not None:
        # the speed layer in one process: events POSTed here land in the
        # storage whose live reads (the ecommerce engine's) serve the
        # next query, and its feedback events join this deploy's answers
        # in the process-default quality monitor
        from predictionio_tpu_torch.server.event_server import create_event_server

        event_server = create_event_server(
            host=args.ip, port=args.event_port, storage=get_storage()
        ).start_background()
        print(f"Event server (embedded) on http://{args.ip}:{event_server.port}",
              flush=True)
    # serving from the start: the line names the port bound, also for
    # --port 0
    server.start_background()
    print(f"Engine deployed on http://{args.ip}:{server.port} ({args.device})",
          flush=True)
    try:
        server.join()  # until POST /stop or an interrupt
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        if event_server is not None:
            event_server.shutdown()
    return 0


def do_undeploy(args) -> int:
    """`pio undeploy`: ``POST /stop`` to the deploy on ``--ip:--port``;
    when that fails and ``--pidfile`` names the deploy's pidfile, SIGTERM
    escalating to SIGKILL through it."""
    import urllib.request

    url = f"http://{args.ip}:{args.port}/stop"
    if args.accesskey:
        url += f"?accessKey={args.accesskey}"
    try:
        with urllib.request.urlopen(
            urllib.request.Request(url, method="POST"), timeout=10
        ) as r:
            print(r.read().decode())
        print("undeployed via POST /stop")
        return 0
    except Exception as e:
        print(f"undeploy via POST /stop failed: {e}", file=sys.stderr)
        if args.pidfile:
            # the HTTP surface is wedged but we own a pidfile: escalate
            # through signals and report which one won
            from predictionio_tpu_torch.tools import daemon

            won = daemon.stop_pidfile(args.pidfile)
            _report_stop(Path(args.pidfile).stem, won)
            # None = nothing was running: the desired end state (daemon
            # down, pidfile gone) holds either way, as `stop` reports it
            return 0
        return 1


def do_batchpredict(args) -> int:
    from predictionio_tpu_torch.core.batch_predict import run_batch_predict

    factory, engine_id, engine_version, engine_variant = _engine_coords(args)
    n = run_batch_predict(
        factory,
        args.input,
        args.output,
        storage=get_storage(),
        engine_instance_id=args.engine_instance_id,
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
        device=args.device,
    )
    print(f"Wrote {n} predictions to {args.output}")
    return 0


def do_run(args) -> int:
    """`pio run`: a user script run as ``__main__`` with the port
    importable (Console.scala:333's main-class run)."""
    import runpy

    sys.argv = [args.script] + (args.script_args or [])
    runpy.run_path(args.script, run_name="__main__")
    return 0


def do_upgrade(args) -> int:
    """`pio upgrade`: upgrades are the package manager's job; prints
    where the next version comes from."""
    print(
        f"predictionio_tpu_torch {__version__}: upgrade by installing a "
        "newer predictionio-tpu package (pip install -U predictionio-tpu), "
        "which ships the port; engine data and models are stored under "
        "PIO_HOME and carry forward."
    )
    return 0


#: starter engine.json written by `template get <name> <dir>` (the JAX
#: package's ``_TEMPLATE_VARIANTS``)
_TEMPLATE_VARIANTS = {
    "recommendation": {
        "engineFactory": "recommendation",
        "datasource": {"params": {"appName": "MyApp"}},
        "algorithms": [
            {
                "name": "als",
                "params": {"rank": 10, "numIterations": 20, "lambda": 0.01,
                           "seed": 3},
            }
        ],
    },
    "similarproduct": {
        "engineFactory": "similarproduct",
        "datasource": {"params": {"appName": "MyApp", "eventNames": ["view"]}},
        "algorithms": [
            {"name": "als",
             "params": {"rank": 10, "numIterations": 20, "lambda": 0.01}}
        ],
    },
    "recommendeduser": {
        "engineFactory": "recommendeduser",
        "datasource": {"params": {"appName": "MyApp", "eventNames": ["view"],
                                  "targetEntityType": "user"}},
        "algorithms": [
            {"name": "als",
             "params": {"rank": 10, "numIterations": 20, "lambda": 0.01}}
        ],
    },
    "classification": {
        "engineFactory": "classification",
        "datasource": {"params": {"appName": "MyApp"}},
        "algorithms": [{"name": "naive", "params": {"lambda": 1.0}}],
    },
    "ecommerce": {
        "engineFactory": "ecommerce",
        "datasource": {"params": {"appName": "MyApp"}},
        "algorithms": [
            {"name": "ecomm",
             "params": {"appName": "MyApp", "rank": 10, "numIterations": 20}}
        ],
    },
    "ncf": {
        "engineFactory": "ncf",
        "datasource": {"params": {"appName": "MyApp"}},
        "algorithms": [
            {"name": "ncf",
             "params": {"embedDim": 32, "mlpLayers": [64, 32, 16],
                        "numEpochs": 5}}
        ],
    },
}


def do_template(args) -> int:
    """`template list|get` (Template.scala:35): list the bundled engines or
    write a starter engine.json for one; never overwrites."""
    from predictionio_tpu_torch.core.engine import engine_registry

    import predictionio_tpu_torch.models  # noqa: F401  (bundled factories)

    if args.template_command == "get":
        if not args.name or args.name not in _TEMPLATE_VARIANTS:
            raise cmd.CommandError(
                f"unknown template {args.name!r}; have "
                f"{sorted(_TEMPLATE_VARIANTS)}"
            )
        target = Path(args.directory or args.name)
        out_file = target / "engine.json"
        if out_file.exists():
            raise cmd.CommandError(
                f"{out_file} already exists — refusing to overwrite"
            )
        target.mkdir(parents=True, exist_ok=True)
        out_file.write_text(
            json.dumps(_TEMPLATE_VARIANTS[args.name], indent=2) + "\n"
        )
        print(f"Wrote {out_file}")
        return 0
    _print(
        {
            "bundled": engine_registry.names(),
            "note": "use --engine <name> with train/deploy, or an import "
            "path 'pkg.module:factory' for custom engines",
        }
    )
    return 0


def _fetch_url(url: str, access_key: str | None = None) -> str:
    import urllib.request

    headers = (
        {"Authorization": f"Bearer {access_key}"} if access_key else {}
    )
    req = urllib.request.Request(url, headers=headers)
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read().decode("utf-8")


def _run_watched(label: str, render_once, watch, watch_count) -> int:
    """One shot or the ``--watch`` loop of the scrape verbs: one shot exits 1
    on a failed scrape; a watch prints the error and goes on (it must
    outlive a server restart), re-rendering every ``watch`` seconds until
    interrupted or ``watch_count`` renders are done."""
    import datetime as _dt
    import threading

    if not watch:
        try:
            render_once()
        except Exception as e:  # a dead server: the message, exit 1
            print(f"scrape failed: {e}", file=sys.stderr)
            return 1
        return 0
    if watch < 0:
        print("usage error: --watch must be positive", file=sys.stderr)
        return 2
    # Event.wait as the timer: interruptible, and nothing busy-waits
    pacer = threading.Event()
    remaining = watch_count  # None = until interrupted
    try:
        while remaining is None or remaining > 0:
            print(f"--- {label} @ {_dt.datetime.now().isoformat()} ---")
            try:
                render_once()
            except Exception as e:
                print(f"scrape failed: {e}", file=sys.stderr)
            sys.stdout.flush()
            if remaining is not None:
                remaining -= 1
                if remaining == 0:
                    break
            pacer.wait(watch)
    except KeyboardInterrupt:
        pass
    return 0


def do_metrics(args) -> int:
    """`pio metrics`: with ``--url``, a running server's ``/metrics`` (or
    ``/metrics.json`` with ``--json``); without it, this process's
    registry.  ``--watch SECONDS`` re-renders until interrupted."""

    def render_once() -> None:
        from predictionio_tpu_torch.obs.metrics import REGISTRY

        if args.url:
            path = "/metrics.json" if args.json else "/metrics"
            body = _fetch_url(args.url.rstrip("/") + path, args.access_key)
            print(body if not args.json else json.dumps(json.loads(body), indent=2))
        elif args.json:
            _print(REGISTRY.render_json())
        else:
            print(REGISTRY.render_prometheus(), end="")

    return _run_watched("pio metrics", render_once, args.watch, args.watch_count)


def _render_lifecycle_text(body: dict) -> str:
    """Human one-screen rendering of a /lifecycle.json body (the JAX
    package's text, line for line)."""
    manifest = body.get("manifest") or {}
    lines = [
        f"engine: {manifest.get('engine', body.get('variant', '?'))}",
        f"live generation: {manifest.get('live') or body.get('engineInstanceId', '-')}",
    ]
    if body.get("canary_in_progress"):
        lines.append(
            f"canary: {body.get('canary_instance')} "
            f"({body.get('canary_fraction', 0):.0%} of traffic)"
        )
    else:
        lines.append("canary: none")
    controller = body.get("controller") or {}
    lines.append(f"controller: {'enabled' if controller.get('enabled') else 'disabled'}")
    last = controller.get("last_event")
    if last:
        lines.append(
            f"last event: {last.get('event')} "
            + " ".join(
                f"{k}={v}" for k, v in sorted(last.items())
                if k not in ("event", "at")
            )
        )
    gens = manifest.get("generations") or []
    if gens:
        lines.append("generations (oldest first):")
        for g in gens:
            mark = {"live": "*", "canary": "~"}.get(g.get("status"), " ")
            lines.append(
                f" {mark} {g.get('instance_id')} {g.get('status'):<11} "
                f"checksum {str(g.get('checksum'))[:12]}…"
            )
    return "\n".join(lines)


def do_lifecycle(args) -> int:
    """`lifecycle`: the generation manifest, the canary and the controller.
    With ``--url``, a running deploy's ``/lifecycle.json``; without it, the
    manifest straight from the configured model store for the given engine
    coordinates.  Either way it reads JSON and computes nothing on a
    device.  A failed scrape prints the error and exits 1; ``--watch
    SECONDS`` re-renders until interrupted."""

    def render_once() -> None:
        if args.url:
            body = json.loads(
                _fetch_url(
                    args.url.rstrip("/") + "/lifecycle.json", args.access_key
                )
            )
        else:
            from predictionio_tpu_torch.lifecycle.generations import (
                GenerationStore,
            )

            store = GenerationStore(
                get_storage().models(),
                args.engine_id,
                args.engine_version,
                args.variant,
            )
            body = {
                "manifest": store.snapshot(),
                "controller": {"enabled": False},
                "canary_in_progress": store.canary() is not None,
            }
        print(
            json.dumps(body, indent=2)
            if args.json
            else _render_lifecycle_text(body)
        )

    return _run_watched(
        "pio lifecycle", render_once, args.watch, args.watch_count
    )


def do_quality(args) -> int:
    """`quality`: the online model-quality report.  With ``--url``, a
    running server's ``/quality.json`` (per-variant online metrics and
    drift); without it, this process's monitor.  ``--watch SECONDS``
    re-renders until interrupted."""

    def render_once() -> None:
        from predictionio_tpu_torch.obs.quality import (
            default_quality,
            render_quality_text,
        )

        if args.url:
            snap = json.loads(
                _fetch_url(
                    args.url.rstrip("/") + "/quality.json", args.access_key
                )
            )
        else:
            snap = default_quality().snapshot()
        print(
            json.dumps(snap, indent=2) if args.json
            else render_quality_text(snap)
        )

    return _run_watched("pio quality", render_once, args.watch, args.watch_count)


def do_tenants(args) -> int:
    """`tenants`: a running deploy's ``/tenants.json``: per-tenant SLO
    state, quota, stored bytes, in-flight count and degraded reasons."""

    def render_once() -> None:
        from predictionio_tpu_torch.tenancy import render_tenants_text

        doc = json.loads(
            _fetch_url(args.url.rstrip("/") + "/tenants.json", args.access_key)
        )
        print(json.dumps(doc, indent=2) if args.json else render_tenants_text(doc))

    return _run_watched("pio tenants", render_once, args.watch, args.watch_count)


def _load_provenance_record(args) -> dict | None:
    """The provenance record to replay: a recorded file (``--record``) or
    a running server's ``/explain.json?request_id=``.  Prints the reason to
    stderr and returns None when no record can be had."""
    from urllib.parse import quote

    rid = args.request_id
    if args.record:
        try:
            body = json.loads(Path(args.record).read_text())
        except (OSError, ValueError) as e:
            print(f"record unreadable: {e}", file=sys.stderr)
            return None
        if isinstance(body, dict) and isinstance(body.get("record"), dict):
            body = body["record"]
        if isinstance(body, dict) and isinstance(body.get("records"), list):
            records = [r for r in body["records"] if isinstance(r, dict)]
            if rid:
                records = [r for r in records if r.get("request_id") == rid]
            if not records:
                print(
                    f"no record for request {rid!r} in {args.record}",
                    file=sys.stderr,
                )
                return None
            return records[0]
        if not isinstance(body, dict):
            print(f"{args.record} holds no provenance record", file=sys.stderr)
            return None
        if rid and body.get("request_id") not in (None, rid):
            print(
                f"{args.record} records request "
                f"{body.get('request_id')!r}, not {rid!r}",
                file=sys.stderr,
            )
            return None
        return body
    if not args.url:
        print("need --url (a running server) or --record FILE", file=sys.stderr)
        return None
    try:
        body = json.loads(
            _fetch_url(
                args.url.rstrip("/") + "/explain.json?request_id=" + quote(rid),
                args.access_key,
            )
        )
    except Exception as e:
        print(f"fetch failed: {e}", file=sys.stderr)
        return None
    rec = body.get("record")
    if not isinstance(rec, dict):
        print(f"server returned no record for {rid!r}", file=sys.stderr)
        return None
    return rec


def do_replay_request(args) -> int:
    """`replay-request <request_id> --url URL | --record FILE`: re-execute
    a recorded decision from its manifest-named, checksum-verified
    generation in local storage, on ``--device``, and diff the item ids and
    raw scores.  Scores compare by ``repr`` unless ``--tolerance`` is
    given.  Exit 0 = matched, 1 = divergence (each one named), 2 = record
    unavailable or not replayable."""
    from predictionio_tpu_torch.obs.provenance import ReplayError, replay_request

    record = _load_provenance_record(args)
    if record is None:
        return 2
    try:
        report = replay_request(
            record, score_tolerance=args.tolerance or 0.0, device=args.device
        )
    except ReplayError as e:
        print(f"not replayable: {e}", file=sys.stderr)
        return 2
    if args.json:
        _print(report)
    if report["matched"]:
        n = len(record.get("items") or [])
        print(
            f"replay MATCHED bit-exactly: request {report['request_id']} "
            f"on generation {report['instance_id']}"
            + (f" ({n} item(s))" if n else "")
        )
        return 0
    print(
        f"replay DIVERGED for request {report['request_id']} "
        f"(generation {report['instance_id']}):",
        file=sys.stderr,
    )
    for d in report["divergences"]:
        print(
            f"  {d['field']}: recorded={d.get('recorded')!r} "
            f"replayed={d.get('replayed')!r}"
            + (f"  ({d['detail']})" if d.get("detail") else ""),
            file=sys.stderr,
        )
    return 1


# ---------------------------------------------------------------------------
# the watch loop's verbs: capacity, alerts, costs, top, incident, profile,
# trace, explain (the JAX package's, printing what it prints)


def do_capacity(args) -> int:
    """`capacity`: the headroom model, from a running server's
    ``/capacity.json`` with ``--url`` or over this process's registry;
    ``--watch SECONDS`` re-renders."""

    def render_once() -> None:
        from predictionio_tpu_torch.obs.capacity import (
            capacity_snapshot,
            render_capacity_text,
        )

        if args.url:
            snap = json.loads(
                _fetch_url(
                    args.url.rstrip("/") + "/capacity.json", args.access_key
                )
            )
        else:
            snap = capacity_snapshot(None)
        print(json.dumps(snap, indent=2) if args.json else render_capacity_text(snap))

    return _run_watched("pio capacity", render_once, args.watch, args.watch_count)


def do_alerts(args) -> int:
    """`alerts`: the watch loop's live state (firing/pending instances,
    recent transitions, the rule set) from a running server's
    ``/alerts.json``; without ``--url``, this process's (empty) state.
    One shot exits 1 on any firing alert, so scripts can gate on it."""
    firing_seen: list = []

    def render_once() -> None:
        from predictionio_tpu_torch.obs.alerts import render_alerts_text

        if args.url:
            snap = json.loads(
                _fetch_url(args.url.rstrip("/") + "/alerts.json", args.access_key)
            )
        else:
            snap = {"alerts": [], "firing": 0, "pending": 0, "rules": []}
        firing_seen[:] = [snap.get("firing", 0)]
        print(json.dumps(snap, indent=2) if args.json else render_alerts_text(snap))

    rc = _run_watched("pio alerts", render_once, args.watch, args.watch_count)
    if rc != 0:
        return rc
    if not args.watch and firing_seen and firing_seen[0]:
        return 1
    return 0


def do_costs(args) -> int:
    """`costs`: the per-app cost ledger, from a running server's
    ``/costs.json`` with ``--url`` or this process's default ledger;
    ``--window N`` keeps the last N closed windows."""

    def render_once() -> None:
        from predictionio_tpu_torch.obs.costs import (
            default_ledger,
            render_costs_text,
        )

        if args.url:
            path = "/costs.json"
            if args.window is not None:
                path += f"?windows={int(args.window)}"
            doc = json.loads(
                _fetch_url(args.url.rstrip("/") + path, args.access_key)
            )
        else:
            doc = default_ledger().snapshot(windows=args.window)
        print(json.dumps(doc, indent=2) if args.json else render_costs_text(doc))

    return _run_watched("pio costs", render_once, args.watch, args.watch_count)


def _render_top(
    costs_doc: dict, alerts_doc: dict, metrics_doc: dict | None
) -> str:
    """One `top` frame: the replica header, request latency, alerts, and
    the top apps by attributed device time."""
    lines: list[str] = []
    replicas = costs_doc.get("replicas")
    lines.append(
        f"fleet: {len(replicas)} replica(s) — " + ", ".join(replicas)
        if replicas
        else "single replica"
    )
    for rid, err in sorted((costs_doc.get("source_errors") or {}).items()):
        lines.append(f"  ! {rid}: {err}")
    if metrics_doc:
        fam = metrics_doc.get("pio_request_latency_seconds")
        if isinstance(fam, dict):
            total = p50 = p99 = 0.0
            for s in fam.get("series") or ():
                c = float(s.get("count") or 0.0)
                if c <= 0:
                    continue
                total += c
                p50 = max(p50, float(s.get("p50") or 0.0))
                p99 = max(p99, float(s.get("p99") or 0.0))
            if total:
                lines.append(
                    f"requests: {int(total)} total   "
                    f"p50 {p50 * 1e3:.2f} ms   p99 {p99 * 1e3:.2f} ms"
                )
        util = metrics_doc.get("pio_device_duty_cycle") or {}
        for s in util.get("series") or ():
            lines.append(f"device duty cycle: {float(s.get('value', 0)):.1%}")
    firing = int(alerts_doc.get("firing") or 0)
    pending = int(alerts_doc.get("pending") or 0)
    lines.append(f"alerts: {firing} firing, {pending} pending")
    for a in alerts_doc.get("alerts") or ():
        if a.get("state") == "firing":
            tag = f"@{a['replica']}" if a.get("replica") else ""
            lines.append(
                f"  ▲ {a.get('rule')}{tag} {a.get('key', '')} "
                f"value={a.get('value')}"
            )
    lines.append("")
    lines.append(
        f"{'APP':<20} {'ROUTE':<18} {'REQS':>8} {'DEVICE_S':>10} "
        f"{'STORAGE':>10} {'QUEUE_S':>8} {'SHEDS':>6}"
    )
    rows = (costs_doc.get("totals") or [])[:15]
    if not rows:
        lines.append("(no attributed cost yet)")
    for row in rows:
        app = str(row.get("app", "?"))
        if row.get("replica"):
            app = f"{app}@{row['replica']}"
        storage = float(row.get("storage_bytes", 0.0))
        for unit in ("B", "KiB", "MiB", "GiB"):
            if storage < 1024 or unit == "GiB":
                break
            storage /= 1024.0
        lines.append(
            f"{app:<20.20} {str(row.get('route', '')):<18.18} "
            f"{int(row.get('requests', 0)):>8} "
            f"{float(row.get('device_s', 0.0)):>10.4f} "
            f"{storage:>9.1f}{unit} "
            f"{float(row.get('queue_s', 0.0)):>8.3f} "
            f"{int(row.get('sheds', 0)):>6}"
        )
    return "\n".join(lines)


def do_top(args) -> int:
    """`top`: a live view of who costs what: fleet-federated when ``--url``
    points at a router (its ``/costs.json`` and ``/alerts.json`` carry
    replica-tagged rows), one server's with ``--url`` of a deploy, and
    this process's ledger without one; refreshes every ``--watch`` seconds
    (default 2), ``--once`` renders one frame."""

    def render_once() -> None:
        if args.url:
            base = args.url.rstrip("/")
            costs_doc = json.loads(_fetch_url(base + "/costs.json", args.access_key))
            try:
                alerts_doc = json.loads(
                    _fetch_url(base + "/alerts.json", args.access_key)
                )
            except Exception:
                alerts_doc = {}  # no evaluator on this server
            try:
                metrics_doc = json.loads(
                    _fetch_url(base + "/metrics.json", args.access_key)
                )
            except Exception:
                metrics_doc = None
        else:
            from predictionio_tpu_torch.obs.costs import default_ledger
            from predictionio_tpu_torch.obs.metrics import REGISTRY

            costs_doc = default_ledger().snapshot()
            alerts_doc = {}
            metrics_doc = REGISTRY.render_json()
        if args.json:
            print(json.dumps({"costs": costs_doc, "alerts": alerts_doc}, indent=2))
        else:
            if sys.stdout.isatty() and args.watch:
                sys.stdout.write("\x1b[2J\x1b[H")  # clear between frames
            print(_render_top(costs_doc, alerts_doc, metrics_doc))

    watch = args.watch if args.watch is not None else 2.0
    if args.once:
        watch = None
    return _run_watched("pio top", render_once, watch, args.watch_count)


def do_incident(args) -> int:
    """`incident list|show ID|export ID`: the forensic bundles, from
    ``--dir`` (default ``PIO_INCIDENT_DIR`` or ``$PIO_HOME/incidents``) or
    a running server's ``/incidents.json`` with ``--url``.  ``show``
    renders one offline (with the exemplar request's waterfall);
    ``export`` writes the raw bundle, or with ``--perfetto`` the exemplar
    trace as Chrome trace-event JSON.  Either package's bundles read."""
    from predictionio_tpu_torch.obs.incident import (
        bundle_timeline,
        default_incident_dir,
        find_bundle,
        list_incidents,
        load_bundle,
        render_incident_text,
    )

    directory = args.dir or default_incident_dir()
    url = args.url

    def load_by_id(incident_id: str) -> dict | None:
        if url:
            try:
                return json.loads(
                    _fetch_url(
                        url.rstrip("/") + f"/incidents/{incident_id}.json",
                        args.access_key,
                    )
                )
            except Exception as e:
                print(f"fetch failed: {e}", file=sys.stderr)
                return None
        path = find_bundle(directory, incident_id)
        if path is None:
            print(
                f"no incident {incident_id!r} under {directory} "
                "(try `pio incident list`)",
                file=sys.stderr,
            )
            return None
        try:
            return load_bundle(path)
        except (OSError, ValueError) as e:
            print(f"bundle unreadable: {e}", file=sys.stderr)
            return None

    if args.incident_command == "list":
        if url:
            try:
                body = json.loads(
                    _fetch_url(url.rstrip("/") + "/incidents.json", args.access_key)
                )
            except Exception as e:
                print(f"fetch failed: {e}", file=sys.stderr)
                return 1
            incidents = body.get("incidents", [])
        else:
            incidents = list_incidents(directory)
        if args.json:
            _print(incidents)
            return 0
        if not incidents:
            print(f"no incident bundles ({url or directory})")
            return 0
        print(f"{len(incidents)} incident bundle(s), newest first:")
        for i in incidents:
            print(
                f"  {i.get('id')}  rule={i.get('rule')}"
                + (f"{{{i['key']}}}" if i.get("key") else "")
                + f"  severity={i.get('severity')}  spans={i.get('spans', 0)}"
                + (f"  ERROR: {i['error']}" if i.get("error") else "")
            )
        return 0

    bundle = load_by_id(args.incident_id)
    if bundle is None:
        return 1
    if args.incident_command == "show":
        if args.json:
            _print(bundle)
        else:
            print(render_incident_text(bundle))
        return 0
    out = getattr(args, "out", None) or "-"
    if getattr(args, "perfetto", None):
        tl = bundle_timeline(bundle, trace_id=args.trace_id)
        if tl is None:
            print(
                "bundle holds no fragments for that trace "
                f"(recorded: {bundle.get('trace_ids')})",
                file=sys.stderr,
            )
            return 1
        body = json.dumps(tl.to_chrome_trace())
        if args.perfetto == "-":
            print(body)
        else:
            Path(args.perfetto).write_text(body)
            print(
                f"wrote {tl.span_count} span(s) to {args.perfetto} "
                "(open in https://ui.perfetto.dev)"
            )
        return 0
    body = json.dumps(bundle, indent=2, sort_keys=True)
    if out == "-":
        print(body)
    else:
        Path(out).write_text(body)
        print(f"wrote {bundle.get('id')} to {out}")
    return 0


def _render_fleet_text(body: dict) -> str:
    """Human one-screen rendering of a /fleet.json body."""
    lines = [
        f"fleet: {body.get('name', 'fleet')} — "
        f"{body.get('total', 0)} replicas, "
        f"{body.get('healthy', 0)} healthy, "
        f"{body.get('routable', 0)} routable",
    ]
    for r in body.get("replicas", []):
        state = "ok"
        if r.get("draining"):
            state = "draining"
        elif not r.get("healthy"):
            state = "EJECTED"
        elif r.get("breaker") == "open":
            state = "BREAKER-OPEN"
        cap = r.get("capacity") or {}
        headroom = cap.get("headroom_frac")
        lines.append(
            f"  {r.get('replica'):<22} {state:<13} "
            f"breaker={r.get('breaker', '?'):<9} "
            f"inflight={r.get('inflight', 0):<3} "
            f"headroom="
            + (f"{headroom:.0%}" if isinstance(headroom, (int, float)) else "n/a")
            + (
                f"  ({r['last_probe_error']})"
                if r.get("last_probe_error") and not r.get("healthy")
                else ""
            )
        )
    auto = body.get("autoscaler")
    if auto:
        pol = auto.get("policy", {})
        lines.append(
            "autoscaler: enabled "
            f"[{pol.get('min_replicas')}..{pol.get('max_replicas')}] "
            + (
                f"pinned at {auto['target_override']}"
                if auto.get("target_override") is not None
                else "capacity-driven"
            )
        )
        last = auto.get("last_event")
        if last:
            lines.append(
                f"  last event: {last.get('event')} "
                + " ".join(
                    f"{k}={v}" for k, v in sorted(last.items())
                    if k not in ("event", "at")
                )
            )
    return "\n".join(lines)


def _fleet_deploy(args) -> int:
    """`pio fleet deploy`: spawn N replica daemons through `pio deploy`
    (each on ``--device``, one CUDA context per replica), then run the
    router in the foreground (an interrupt or ``POST /stop`` tears the
    whole stack down).  The router holds no CUDA context."""
    import dataclasses

    from predictionio_tpu_torch.fleet.autoscaler import (
        Autoscaler,
        AutoscalerPolicy,
        LocalProcessSpawner,
    )
    from predictionio_tpu_torch.fleet.membership import FleetState
    from predictionio_tpu_torch.fleet.router import create_router_app
    from predictionio_tpu_torch.obs.alerts import AlertEvaluator
    from predictionio_tpu_torch.obs.incident import IncidentRecorder
    from predictionio_tpu_torch.server.httpd import AppServer

    if args.replicas < 1:
        print("usage error: --replicas must be >= 1", file=sys.stderr)
        return 2
    deploy_args: list[str] = []
    if args.engine:
        deploy_args += ["--engine", args.engine]
    if args.engine_json:
        deploy_args += ["--engine-json", args.engine_json]
    if args.accesskey:
        deploy_args += ["--accesskey", args.accesskey]
    if args.deadline_s is not None:
        deploy_args += ["--deadline-s", str(args.deadline_s)]
    spawner = LocalProcessSpawner(
        deploy_args,
        host=args.replica_ip,
        base_port=args.replica_base_port,
        device=args.device,
    )
    # no source_file: the spawner owns this fleet's membership, and an
    # inherited PIO_FLEET_FILE would replace the spawned replicas
    fleet = FleetState(name=args.name, access_key=args.accesskey or None)
    # the router's own watch loop: its default breaker rule watches the
    # per-replica breakers, and autoscaler actions land in the event ring
    incidents = IncidentRecorder()
    alerts = AlertEvaluator(incidents=incidents)
    server = None
    autoscaler = None
    try:
        for i in range(args.replicas):
            url = spawner.spawn()
            fleet.add(url)
            print(f"replica {i + 1}/{args.replicas} ready at {url} "
                  f"({spawner.ready_s[url]:.2f} s)", flush=True)
        fleet.probe_once()
        fleet.start()
        if args.autoscale:
            policy = AutoscalerPolicy.from_env()
            if args.min_replicas is not None or args.max_replicas is not None:
                policy = dataclasses.replace(
                    policy,
                    min_replicas=args.min_replicas or policy.min_replicas,
                    max_replicas=args.max_replicas or policy.max_replicas,
                )
            autoscaler = Autoscaler(fleet, spawner, policy=policy, alerts=alerts)
            autoscaler.start()
        server_ref: list = []

        def on_stop():
            if server_ref:
                server_ref[0].shutdown()

        app = create_router_app(
            fleet,
            access_key=args.accesskey or None,
            default_deadline_s=args.deadline_s,
            max_inflight=args.max_inflight,
            autoscaler=autoscaler,
            on_stop=on_stop,
            alerts=alerts,
            incidents=incidents,
        )
        alerts.app = app
        incidents.app = app
        alerts.start()
        server = AppServer(app, args.ip, args.port)
        server_ref.append(server)
        print(
            f"Router on http://{args.ip}:{server.port} "
            "(POST /queries.json; GET /fleet.json)",
            flush=True,
        )
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        alerts.stop()
        if autoscaler is not None:
            autoscaler.stop()
        fleet.stop()
        if server is not None:
            server.shutdown()
        spawner.stop_all()
        print("fleet stopped", flush=True)
    return 0


def do_fleet(args) -> int:
    """`pio fleet`: deploy/status/scale/watch a router + replica fleet."""
    if args.fleet_command == "deploy":
        return _fleet_deploy(args)

    if args.fleet_command == "scale":
        import urllib.error
        import urllib.request

        url = args.url.rstrip("/") + f"/fleet/scale?replicas={args.replicas}"
        headers = {}
        if args.access_key:
            headers["Authorization"] = f"Bearer {args.access_key}"
        try:
            req = urllib.request.Request(url, headers=headers, method="POST")
            with urllib.request.urlopen(req, timeout=10) as r:
                body = json.loads(r.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            print(
                f"scale refused ({e.code}): {e.read().decode('utf-8', 'replace')}",
                file=sys.stderr,
            )
            return 1
        except Exception as e:
            print(f"router unreachable: {e}", file=sys.stderr)
            return 1
        mode = body.get("mode", "?")
        print(
            f"fleet target: {body.get('target') if mode == 'pinned' else 'auto'} "
            f"({mode})"
        )
        return 0

    # status / watch: read /fleet.json
    last_body: dict = {}

    def render_once() -> None:
        body = json.loads(
            _fetch_url(args.url.rstrip("/") + "/fleet.json", args.access_key)
        )
        last_body.clear()
        last_body.update(body)
        print(json.dumps(body, indent=2) if args.json else _render_fleet_text(body))

    watch = args.watch if args.fleet_command == "watch" else None
    rc = _run_watched(
        "pio fleet", render_once, watch, getattr(args, "watch_count", None)
    )
    if rc != 0:
        return rc
    # one-shot status: exit 1 when the fleet cannot serve at all
    if args.fleet_command == "status" and last_body.get("routable", 0) == 0:
        print("error: zero routable replicas", file=sys.stderr)
        return 1
    return 0


def do_day(args) -> int:
    """`pio day --scenario FILE [--replicas N] [--report OUT.json]
    [--seed S] [--device D]`: run one scripted production day against the
    real fleet topology (router + N ``deploy`` replica subprocesses on
    ``--device`` + event ingest) and print the evidence-backed SLO verdict.

    Exit contract: 0 = verdict PASS, 1 = verdict FAIL, 2 = malformed
    scenario (the message names the offending field; checked before the
    device is resolved, so on any host).  ``PIO_HOME`` must already hold
    a trained engine (``train`` or ``replay.day.seed_demo_home``).  A
    device that is not there raises ``DeviceUnavailable`` before any
    replica spawns."""
    from predictionio_tpu_torch.device import DeviceUnavailable
    from predictionio_tpu_torch.replay.day import run_day
    from predictionio_tpu_torch.replay.scenario import Scenario, ScenarioError

    try:
        scenario = Scenario.load_arg(args.scenario)
    except ScenarioError as e:
        print(f"malformed scenario: {e}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"malformed scenario: cannot read file: {e}", file=sys.stderr)
        return 2
    try:
        code, _report = run_day(
            scenario,
            replicas=args.replicas,
            seed=args.seed,
            engine=args.engine,
            report_path=args.report,
            incident_dir=args.incident_dir,
            disable_incidents=args.no_incidents,
            device=args.device,
        )
    except (cmd.CommandError, DeviceUnavailable):
        raise
    except RuntimeError as e:
        raise cmd.CommandError(str(e)) from e
    return code


def do_profile(args) -> int:
    """`profile`: a profile of a running server (or this process).

    The default arms the server's ``torch.profiler`` capture (``POST
    /debug/profile``, key-gated; CUDA activity when the deploy's model is
    on the card), waits for it to finish and prints its status: the trace
    file and the device operations by device time.  ``--stacks`` captures
    HOST stacks instead through the server's continuous sampler (``GET
    /debug/stacks.json?reset=1``, then the fresh window after
    ``--seconds``), printed as a summary and collapsed stacks, or written
    to ``--speedscope OUT.json``.  A server that answers 501 (the profiler
    refused) gets the host stack capture instead.  Without ``--url`` the
    stack capture samples this process."""
    import threading
    import time
    import urllib.error
    import urllib.request

    seconds = args.seconds
    if seconds <= 0:
        print("usage error: --seconds must be positive", file=sys.stderr)
        return 2
    pacer = threading.Event()

    def _request(url: str, method: str = "GET") -> tuple[int, str]:
        headers = (
            {"Authorization": f"Bearer {args.access_key}"}
            if args.access_key
            else {}
        )
        req = urllib.request.Request(url, headers=headers, method=method)
        try:
            with urllib.request.urlopen(
                req, timeout=max(seconds + 10.0, 15.0)
            ) as r:
                return r.status, r.read().decode("utf-8")
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode("utf-8", "replace")

    def _write_speedscope(doc: dict) -> None:
        Path(args.speedscope).write_text(json.dumps(doc))
        print(
            f"wrote speedscope profile to {args.speedscope} "
            "(open at https://www.speedscope.app)"
        )

    def _remote_stacks() -> int:
        base = args.url.rstrip("/")
        # the first request arms the server's sampler AND resets its
        # aggregation, so the window holds only the next --seconds
        status, body = _request(base + "/debug/stacks.json?reset=1")
        if status != 200:
            print(f"stack capture failed: HTTP {status}: {body[:200]}",
                  file=sys.stderr)
            return 1
        pacer.wait(seconds)
        status, body = _request(base + "/debug/stacks.json")
        if status != 200:
            print(f"stack capture failed: HTTP {status}: {body[:200]}",
                  file=sys.stderr)
            return 1
        snap = json.loads(body)
        collapsed = snap.pop("collapsed", "")
        print(json.dumps(snap, indent=2))
        if args.speedscope:
            status, body = _request(base + "/debug/stacks.json?format=speedscope")
            if status != 200:
                print(f"speedscope export failed: HTTP {status}", file=sys.stderr)
                return 1
            _write_speedscope(json.loads(body))
        elif collapsed:
            print(collapsed, end="")
        return 0

    def _local_stacks() -> int:
        from predictionio_tpu_torch.obs.sampling import StackSampler

        sampler = StackSampler()
        sampler.start()
        pacer.wait(seconds)
        sampler.stop()
        print(json.dumps(sampler.snapshot(), indent=2))
        if args.speedscope:
            _write_speedscope(sampler.speedscope())
        else:
            print(sampler.collapsed(), end="")
        return 0

    try:
        if not args.url:
            return _local_stacks()
        if args.stacks or args.speedscope:
            # --speedscope IS a stack capture (the device profiler writes
            # a chrome trace, not speedscope JSON)
            return _remote_stacks()
        base = args.url.rstrip("/")
        status, body = _request(
            f"{base}/debug/profile?seconds={seconds:g}", method="POST"
        )
        if status == 202:
            started = json.loads(body)
            print(
                f"torch profiler capturing {seconds:g}s "
                f"({'+'.join(started.get('activities') or ['cpu'])}) into "
                f"{started.get('dir')} (server-side)"
            )
            pacer.wait(seconds + 0.5)
            # the capture's stop writes the chrome trace and the
            # key_averages table; wait for it (bounded) before reporting
            deadline = time.monotonic() + seconds + 60.0
            while True:
                status, body = _request(base + "/debug/profile")
                if status != 200:
                    break
                doc = json.loads(body)
                if not doc.get("running") or time.monotonic() > deadline:
                    print(json.dumps(doc, indent=2))
                    last = doc.get("last") or {}
                    if last.get("error"):
                        print(f"profile failed: {last['error']}", file=sys.stderr)
                        return 1
                    return 0
                pacer.wait(0.25)
            print(f"profile status failed: HTTP {status}", file=sys.stderr)
            return 1
        if status == 501:
            # the verb still delivers: host-only stack capture
            print(
                "torch profiler unsupported on this server; capturing host "
                "stacks instead",
                file=sys.stderr,
            )
            return _remote_stacks()
        print(f"profile failed: HTTP {status}: {body[:300]}", file=sys.stderr)
        return 1
    except Exception as e:  # a dead server: the message, exit 1
        print(f"profile failed: {e}", file=sys.stderr)
        return 1


def do_trace(args) -> int:
    """`trace <id> --from URL,URL`: assemble one cross-process trace from
    every named process's ``/spans.json?trace_id=`` (clock-aligned),
    recorded ``--file`` sets (a ``/spans.json`` body, a fragment list, an
    incident bundle) and/or this process's own store, rendered as a text
    waterfall, ``--json`` or Chrome trace-event JSON (``--perfetto OUT``).
    Exit 1 when no fragment of the trace is found."""
    from predictionio_tpu_torch.obs.timeline import (
        TraceAssemblyError,
        collect_trace,
    )

    urls = [
        u.strip()
        for part in (args.from_urls or [])
        for u in part.split(",")
        if u.strip()
    ]
    files = list(args.file or [])
    try:
        tl = collect_trace(
            args.trace_id,
            urls=urls,
            files=files,
            include_local=args.local or not (urls or files),
            access_key=args.access_key,
        )
    except TraceAssemblyError as e:
        print(f"trace assembly failed: {e}", file=sys.stderr)
        return 1
    if args.perfetto:
        body = json.dumps(tl.to_chrome_trace())
        if args.perfetto == "-":
            print(body)
        else:
            Path(args.perfetto).write_text(body)
            print(
                f"wrote {tl.span_count} span(s) across "
                f"{len(tl.processes)} process(es) to {args.perfetto} "
                "(open in https://ui.perfetto.dev or chrome://tracing)"
            )
    elif args.json:
        _print(tl.to_dict())
    else:
        print(tl.render_text())
    return 0


def _render_explain(report: dict) -> str:
    """The explain report as an indented text card."""
    rec = report.get("record") or {}
    lines = [
        f"request {rec.get('request_id')}  "
        f"{rec.get('server')}{rec.get('path')}  status={rec.get('status')}  "
        f"{rec.get('duration_s', 0) * 1000:.2f} ms  "
        f"capture={rec.get('capture')}"
    ]
    gen = rec.get("generation") or {}
    lines.append(
        f"  answered by: instance={rec.get('instance_id')}  "
        f"variant={rec.get('variant')}  role={rec.get('role')}"
    )
    if gen:
        axes = gen.get("shard_axes")
        lines.append(
            f"  generation: checksum={gen.get('checksum')}  "
            f"status={gen.get('status')}"
            + (f"  shard_axes={axes}" if axes else "")
        )
    if rec.get("engine_path"):
        lines.append(f"  engine path: {rec['engine_path']}")
    cache = rec.get("cache")
    if cache:
        lines.append(
            f"  factor cache: {cache.get('hits', 0)} hit(s) / "
            f"{cache.get('misses', 0)} miss(es)  "
            f"generation={cache.get('generation')}"
        )
    wave = rec.get("wave")
    if wave:
        lines.append(
            f"  wave: id={wave.get('id')}  size={wave.get('size')}  "
            f"seq={wave.get('seq')}"
        )
    filters = rec.get("filters")
    if filters:
        lines.append(
            "  filters: "
            + "  ".join(f"{k}={v}" for k, v in sorted(filters.items()))
        )
    if rec.get("event_watermark"):
        lines.append(f"  event watermark: {rec['event_watermark']}")
    if rec.get("degraded"):
        lines.append(f"  degraded: {', '.join(rec['degraded'])}")
    items = rec.get("items")
    if items is not None:
        lines.append(f"  items ({len(items)}):")
        for it in items[:10]:
            lines.append(f"    {it.get('item')}  score={it.get('score')!r}")
        if len(items) > 10:
            lines.append(f"    ... {len(items) - 10} more")
    elif rec.get("answer") is not None:
        lines.append(f"  answer: {json.dumps(rec['answer'], default=str)}")
    if rec.get("deep"):
        lines.append(f"  deep: {json.dumps(rec['deep'], default=str)}")
    flight = report.get("flight")
    if flight:
        lines.append(
            f"  flight: {len(flight)} entr{'y' if len(flight) == 1 else 'ies'}"
        )
        for e in flight[:2]:
            stages = e.get("stages") or {}
            lines.append(
                f"    {e.get('route', e.get('path'))}  "
                f"{e.get('duration_s', 0) * 1000:.2f} ms"
                + (
                    "  stages: "
                    + " ".join(
                        f"{k}={v * 1000:.2f}ms"
                        for k, v in stages.items()
                        if isinstance(v, (int, float))
                    )
                    if stages
                    else ""
                )
            )
    logs = report.get("logs")
    if logs:
        lines.append(f"  logs ({len(logs)}):")
        for r in logs[:8]:
            lines.append(f"    [{r.get('level')}] {r.get('message', r.get('msg'))}")
    trace = report.get("trace")
    if trace:
        lines.append(f"  trace: {trace.get('span_count', '?')} span(s)")
    return "\n".join(lines)


def do_explain(args) -> int:
    """`explain <request_id> --url URL | --record FILE`: one answer's
    decision report: the provenance record (``/explain.json``) joined with
    its flight-recorder entry, its log lines and, when span fragments
    exist, its assembled trace (``--no-trace`` skips it); ``--record``
    renders a recorded record offline.  Exit 1 when no record is found."""
    from urllib.parse import quote

    record = _load_provenance_record(args)
    if record is None:
        return 1
    report: dict = {"record": record}
    if args.url:
        base = args.url.rstrip("/")
        key = args.access_key
        rid = args.request_id
        # the joins are best-effort: a missing surface costs its section
        try:
            snap = json.loads(
                _fetch_url(base + "/debug/flight.json?request_id=" + quote(rid), key)
            )
            report["flight"] = snap.get("slowest", []) + snap.get("errors", [])
        except Exception:
            pass
        try:
            body = json.loads(
                _fetch_url(base + "/logs.json?request_id=" + quote(rid), key)
            )
            report["logs"] = body.get("logs", [])
        except Exception:
            pass
        trace_id = record.get("trace_id")
        if trace_id and not args.no_trace:
            from predictionio_tpu_torch.obs.timeline import (
                TraceAssemblyError,
                collect_trace,
            )

            try:
                tl = collect_trace(
                    trace_id, urls=[base], include_local=False, access_key=key
                )
                report["trace"] = tl.to_dict()
            except TraceAssemblyError:
                pass
    if args.json:
        _print(report)
    else:
        print(_render_explain(report))
    return 0


def do_bench(args) -> int:
    """`pio bench --compare PREV.json [CURRENT.json]`: the perf-regression
    gate over two BENCH json lines (bench.py output).

    Exit contract: 0 = every gateable metric within --tolerance, 1 = a
    regression beyond tolerance (the CI gate trips), 2 = usage error or a
    file missing/old ``schema_version``.  CURRENT defaults to stdin so the
    gate pipelines directly: ``python bench.py | pio bench --compare
    BENCH_prev.json``.  It reads two JSON lines and runs nothing: no
    benchmark, no ``BENCHMARK.json``, no device.
    """
    from predictionio_tpu_torch.obs.device import compare_bench

    def load(path: str, label: str) -> dict | None:
        try:
            text = Path(path).read_text()
        except OSError as e:
            print(f"usage error: cannot read {label}: {e}", file=sys.stderr)
            return None
        return parse(text, label)

    def parse(text: str, label: str) -> dict | None:
        # bench.py logs to stderr and prints ONE json line to stdout, but a
        # captured file may carry stray lines: the LAST parseable json
        # object wins
        for line in reversed([l for l in text.splitlines() if l.strip()]):
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict):
                return obj
        print(f"usage error: no JSON object in {label}", file=sys.stderr)
        return None

    previous = load(args.compare, "--compare file")
    if previous is None:
        return 2
    if args.current:
        current = load(args.current, "current file")
    else:
        current = parse(sys.stdin.read(), "stdin")
    if current is None:
        return 2
    code, report = compare_bench(
        current, previous, tolerance_pct=args.tolerance
    )
    _print(report)
    if "error" in report:
        print(f"usage error: {report['error']}", file=sys.stderr)
    elif report["regressions"]:
        names = ", ".join(r["metric"] for r in report["regressions"])
        print(
            f"PERF REGRESSION beyond {args.tolerance:g}%: {names}",
            file=sys.stderr,
        )
    else:
        print(
            f"bench within tolerance ({report['checked']} metrics checked, "
            f"{len(report['improvements'])} improved)",
            file=sys.stderr,
        )
    return code


def do_check(args) -> int:
    """`pio check`: PyTorch-aware static analysis + DASE contract pre-flight.

    Exit-code contract (same in text and --format json): 0 = clean,
    1 = findings at/above --severity, 2 = usage or parse error.
    """
    from predictionio_tpu_torch.analysis import (
        DEFAULT_BASELINE_NAME,
        Baseline,
        BaselineError,
        Severity,
        analyze_paths,
        filter_severity,
        render_json,
        render_sarif,
        render_text,
    )

    try:
        threshold = Severity.parse(args.severity)
    except ValueError as e:
        print(f"usage error: {e}", file=sys.stderr)
        return 2

    engines = list(args.engine or [])
    paths = list(args.paths)
    if not paths and not engines:
        paths = ["."]

    if args.graph:
        return _check_graph_dump(paths)

    cache = None
    if not args.no_cache:
        from predictionio_tpu_torch.analysis.cache import (
            DEFAULT_CACHE_NAME,
            CheckCache,
        )
        from predictionio_tpu_torch.tools.daemon import pio_home

        cache = CheckCache(Path(pio_home()) / DEFAULT_CACHE_NAME)

    try:
        # [] (engine-only run) => empty report
        report = analyze_paths(paths, cache=cache)
    except FileNotFoundError as e:
        print(f"usage error: {e}", file=sys.stderr)
        return 2
    if args.stats:
        stats = (
            cache.stats_line() if cache is not None else "cache: disabled"
        )
        print(stats, file=sys.stderr)

    # DASE contract checks (import the named engine factories)
    if engines:
        from predictionio_tpu_torch.analysis.contract import (
            check_engine_contract,
        )
        from predictionio_tpu_torch.core.engine import engine_registry

        import predictionio_tpu_torch.models  # noqa: F401  (registers them)

        if "all" in engines:
            bundled = engine_registry.names()
            extra = [e for e in engines if e != "all" and e not in bundled]
            engines = bundled + extra
        for name in engines:
            report.findings.extend(check_engine_contract(name, root=Path.cwd()))
        # keep the file:line ordering contract across both finding sources
        report.findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))

    if args.write_baseline:
        # the baseline must be complete: unfiltered by --severity, and
        # refused outright when a file failed to parse (its findings would
        # be silently missing from the snapshot)
        if report.errors:
            for e in report.errors:
                print(f"error: {e}", file=sys.stderr)
            print(
                "refusing to write a baseline while files fail to parse",
                file=sys.stderr,
            )
            return 2
        target = args.baseline or DEFAULT_BASELINE_NAME
        n = Baseline.write(target, report.findings)
        print(f"Wrote {n} baseline entr{'y' if n == 1 else 'ies'} to {target}")
        # a fresh snapshot is not yet an acceptable baseline: placeholder
        # justifications fail the self-gate, so exit 1 naming every entry
        # still to edit (an operator cannot silently ship TODOs)
        todo = [
            e
            for e in Baseline.load(target).entries
            if e.justification.strip().lower().startswith("todo")
        ]
        if todo:
            print(
                f"{len(todo)} entr{'y' if len(todo) == 1 else 'ies'} still "
                "need a justification (the self-gate rejects TODO "
                "placeholders):",
                file=sys.stderr,
            )
            for e in todo:
                print(f"  {e.rule}  {e.file}:{e.line}", file=sys.stderr)
            return 1
        return 0

    report.findings = filter_severity(report.findings, threshold)

    baseline_path = args.baseline
    if baseline_path is None and Path(DEFAULT_BASELINE_NAME).exists():
        baseline_path = DEFAULT_BASELINE_NAME
    if baseline_path is not None:
        try:
            baseline = Baseline.load(baseline_path)
        except BaselineError as e:
            print(f"usage error: {e}", file=sys.stderr)
            return 2
        report.findings, report.baseline_suppressed = baseline.filter(
            report.findings
        )

    if args.format == "json":
        _print(render_json(report))
    elif args.format == "sarif":
        _print(render_sarif(report))
    else:
        print(render_text(report))
    if report.errors:
        return 2
    return 1 if report.findings else 0


def _check_graph_dump(paths) -> int:
    """`pio check --graph`: whole-program call/lock graphs as JSON."""
    from predictionio_tpu_torch.analysis.analyzer import (
        _relpath,
        iter_python_files,
    )
    from predictionio_tpu_torch.analysis.callgraph import build_program
    from predictionio_tpu_torch.analysis.rules import parse_module

    root = Path.cwd()
    mods = []
    errors = []
    try:
        files = iter_python_files(paths)
    except FileNotFoundError as e:
        print(f"usage error: {e}", file=sys.stderr)
        return 2
    for path in files:
        rel = _relpath(path, root)
        try:
            mods.append(parse_module(path, rel, path.read_text("utf-8")))
        except (OSError, SyntaxError, ValueError) as e:
            errors.append(f"{rel}: {type(e).__name__}: {e}")
    _print(build_program(mods).to_json())
    for e in errors:
        print(f"error: {e}", file=sys.stderr)
    return 2 if errors else 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m predictionio_tpu_torch.tools.cli",
        description="PredictionIO on PyTorch + CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    def device_flag(sp):
        sp.add_argument(
            "--device",
            default="cuda",
            help="cuda (default; fails without a card) or cpu",
        )

    def no_check_flag(sp):
        sp.add_argument(
            "--no-check",
            action="store_true",
            help="skip the static DASE contract pre-flight",
        )

    def watch_flags(sp):
        sp.add_argument(
            "--watch",
            type=float,
            default=None,
            metavar="SECONDS",
            help="re-render every SECONDS until interrupted",
        )
        sp.add_argument(
            "--watch-count",
            type=int,
            default=None,
            help=argparse.SUPPRESS,  # bounded --watch renders (tests)
        )

    def engine_flags(sp):
        sp.add_argument(
            "--engine", default="",
            help="factory name or pkg.module:factory (default: the engine "
            "JSON's engineFactory, or the instance's own factory)",
        )
        sp.add_argument("--engine-id", default="default")
        sp.add_argument("--engine-version", default="default")
        sp.add_argument("--variant", default="default")
        sp.add_argument(
            "--engine-json", default=None,
            help="engine variant JSON file; its id, version and variant "
            "win over the flags",
        )

    sub.add_parser("version").set_defaults(fn=do_version)
    stt = sub.add_parser("status")
    stt.add_argument(
        "--url",
        default=None,
        help="probe a running server's /healthz, /readyz and /slo.json "
        "(e.g. http://127.0.0.1:8000) instead of local storage",
    )
    stt.add_argument(
        "--access-key",
        default=None,
        help="access key for key-gated servers (sent as a Bearer header; "
        "/healthz alone answers without it)",
    )
    stt.add_argument(
        "--no-quality",
        action="store_true",
        help="do not fold /quality.json's drift state into the exit code",
    )
    stt.set_defaults(fn=do_status)

    ap = sub.add_parser("app")
    asub = ap.add_subparsers(dest="app_command", required=True)
    new = asub.add_parser("new")
    new.add_argument("name")
    new.add_argument("--description")
    new.add_argument("--access-key")
    asub.add_parser("list")
    for verb in ("show", "delete"):
        asub.add_parser(verb).add_argument("name")
    dd = asub.add_parser("data-delete")
    dd.add_argument("name")
    dd.add_argument("--channel")
    ac = asub.add_parser("compact")
    ac.add_argument("name")
    ac.add_argument("--channel", default=None)
    for verb in ("channel-new", "channel-delete"):
        ch = asub.add_parser(verb)
        ch.add_argument("name")
        ch.add_argument("channel")
    ap.set_defaults(fn=do_app)

    ss = sub.add_parser("storageserver")
    # loopback by default: the daemon serves unauthenticated reads and
    # writes of events, metadata and pickled model blobs, so an open bind
    # without an access key is code execution on the next host that loads
    # a model; non-loopback binds demand a key (or an explicit override)
    ss.add_argument("--ip", default="127.0.0.1")
    ss.add_argument("--port", type=int, default=7072)
    ss.add_argument(
        "--root",
        default=os.environ.get(
            "PIO_HOME", str(Path.home() / ".predictionio_tpu")
        ),
    )
    ss.add_argument("--access-key", default=None)
    ss.add_argument(
        "--events", choices=("parquet", "sqlite"), default="parquet"
    )
    ss.add_argument(
        "--no-compact",
        action="store_true",
        help="disable the background segment compactor (on by default for "
        "parquet stores)",
    )
    ss.add_argument(
        "--compact-interval",
        type=float,
        default=None,
        metavar="SECONDS",
        help="compactor tick cadence (default PIO_COMPACT_INTERVAL_S or 30)",
    )
    ss.set_defaults(fn=do_storageserver)

    est = sub.add_parser(
        "eventstore",
        help="event-store data plane: segment/compaction status and "
        "on-demand compaction",
    )
    essub = est.add_subparsers(dest="es_command", required=True)
    for name, hlp in (
        ("status", "segment counts, compaction backlog, watermark lag, "
         "per-shard byte skew (exit 1 when backlog exceeds the budget)"),
        ("compact", "fold the write-hot head into compacted segments now"),
    ):
        sp_es = essub.add_parser(name, help=hlp)
        sp_es.add_argument(
            "--url",
            default=None,
            help="a running storage daemon (default: the locally "
            "configured store; when a daemon serves this root, compact "
            "through it with --url)",
        )
        sp_es.add_argument("--access-key", default=None)
        sp_es.add_argument(
            "--timeout",
            type=float,
            default=30.0,
            help="seconds to wait for the daemon's answer (a fold of a "
            "large log takes longer than the default)",
        )
        sp_es.add_argument(
            "--json", action="store_true", help="machine-readable output"
        )
    est.set_defaults(fn=do_eventstore)

    ak = sub.add_parser("accesskey")
    aksub = ak.add_subparsers(dest="ak_command", required=True)
    akn = aksub.add_parser("new")
    akn.add_argument("app")
    akn.add_argument("--key")
    akn.add_argument("--event", action="append")
    aksub.add_parser("list").add_argument("app", nargs="?")
    aksub.add_parser("delete").add_argument("key")
    ak.set_defaults(fn=do_accesskey)

    imp = sub.add_parser("import")
    imp.add_argument("--app", required=True)
    imp.add_argument("--input", required=True)
    imp.add_argument("--channel")
    imp.set_defaults(fn=do_import)

    exp = sub.add_parser("export")
    exp.add_argument("--app", required=True)
    exp.add_argument("--output", required=True)
    exp.add_argument("--channel")
    exp.add_argument("--format", choices=["json", "parquet"], default="json")
    exp.set_defaults(fn=do_export)

    es = sub.add_parser("eventserver")
    es.add_argument("--ip", default="0.0.0.0")
    es.add_argument("--port", type=int, default=7070)
    es.add_argument("--stats", action="store_true")
    es.set_defaults(fn=do_eventserver)

    ads = sub.add_parser("adminserver")
    ads.add_argument("--ip", default="0.0.0.0")
    ads.add_argument("--port", type=int, default=7071)
    ads.add_argument("--access-key", default=None)
    ads.set_defaults(fn=do_adminserver)

    db = sub.add_parser("dashboard")
    db.add_argument("--ip", default="0.0.0.0")
    db.add_argument("--port", type=int, default=9000)
    db.add_argument("--access-key", default=None)
    db.set_defaults(fn=do_dashboard)

    dm = sub.add_parser("daemon")
    dm.add_argument("pidfile")
    dm.add_argument("command", nargs=argparse.REMAINDER)
    dm.set_defaults(fn=do_daemon)

    sa = sub.add_parser("start-all")
    sa.add_argument("--ip", default="0.0.0.0")
    sa.add_argument("--event-port", type=int, default=7070)
    sa.add_argument("--admin-port", type=int, default=7071)
    sa.add_argument("--dashboard-port", type=int, default=9000)
    sa.set_defaults(fn=do_start_all)

    sub.add_parser("stop-all").set_defaults(fn=do_stop_all)

    sp = sub.add_parser("stop")
    sp.add_argument(
        "name",
        help="daemon name (eventserver, adminserver, dashboard, "
        "storageserver) or a pidfile path",
    )
    sp.add_argument(
        "--timeout",
        type=float,
        default=10.0,
        help="seconds to wait for SIGTERM before escalating to SIGKILL",
    )
    sp.set_defaults(fn=do_stop)

    fl = sub.add_parser(
        "fleet",
        help="router + replica fleet: deploy/status/scale/watch",
        description="Deploy a consistent-hash router in front of N "
        "prediction-server replica daemons, read the membership registry, "
        "or pin the autoscaler target.",
    )
    flsub = fl.add_subparsers(dest="fleet_command", required=True)
    fld = flsub.add_parser(
        "deploy",
        help="spawn N replica daemons and run the router in the foreground",
    )
    fld.add_argument("--engine")
    fld.add_argument("--engine-json", default=None)
    fld.add_argument("--replicas", type=int, default=2)
    fld.add_argument("--ip", default="0.0.0.0", help="router bind address")
    fld.add_argument("--port", type=int, default=8000, help="router port")
    fld.add_argument(
        "--replica-ip",
        default="127.0.0.1",
        help="address replicas bind (the internal tier; default loopback)",
    )
    fld.add_argument(
        "--replica-base-port",
        type=int,
        default=None,
        help="first replica port (consecutive from here; default ephemeral)",
    )
    fld.add_argument("--accesskey", default="")
    fld.add_argument("--name", default="fleet", help="fleet label in /fleet.json")
    fld.add_argument("--deadline-s", type=float, default=None)
    fld.add_argument("--max-inflight", type=int, default=None)
    fld.add_argument(
        "--autoscale",
        action="store_true",
        help="run the capacity-driven autoscaler loop (PIO_FLEET_* knobs)",
    )
    fld.add_argument("--min-replicas", type=int, default=None)
    fld.add_argument("--max-replicas", type=int, default=None)
    device_flag(fld)
    fls = flsub.add_parser("status", help="read a running router's /fleet.json")
    fls.add_argument("--url", required=True)
    fls.add_argument("--access-key", default=None)
    fls.add_argument("--json", action="store_true")
    flc = flsub.add_parser("scale", help="pin the autoscaler target (N or 'auto')")
    flc.add_argument("replicas", help="replica count to pin, or 'auto'")
    flc.add_argument("--url", required=True)
    flc.add_argument("--access-key", default=None)
    flw = flsub.add_parser("watch", help="re-render /fleet.json periodically")
    flw.add_argument("--url", required=True)
    flw.add_argument("--access-key", default=None)
    flw.add_argument("--json", action="store_true")
    flw.add_argument("--watch", type=float, default=2.0)
    flw.add_argument("--watch-count", type=int, default=None, help=argparse.SUPPRESS)
    fl.set_defaults(fn=do_fleet)

    dy = sub.add_parser(
        "day",
        help="run a scripted production day and print the SLO verdict",
        description="Drive the real fleet topology (router + N replica "
        "subprocesses + event ingest) through a declarative scripted day "
        "of traffic phases and timed faults, then join the generator's "
        "outcome log, scraped telemetry and the incident-bundle "
        "directory into an evidence-backed verdict.  Exit 0 PASS / "
        "1 FAIL / 2 malformed scenario.",
    )
    dy.add_argument(
        "--scenario",
        required=True,
        metavar="JSON|@FILE",
        help="scenario document: inline JSON or @path",
    )
    dy.add_argument(
        "--replicas", type=int, default=2, help="replica subprocesses (default 2)"
    )
    dy.add_argument(
        "--seed", type=int, default=None,
        help="override the scenario's schedule seed",
    )
    dy.add_argument(
        "--engine", default="recommendation",
        help="registered engine factory the replicas deploy (default "
        "recommendation)",
    )
    dy.add_argument(
        "--report", metavar="OUT.json", default=None,
        help="write the machine-readable verdict report here",
    )
    dy.add_argument(
        "--incident-dir", default=None,
        help="incident-bundle directory for the run (default: fresh temp dir)",
    )
    dy.add_argument(
        "--no-incidents", action="store_true",
        help="disable the incident recorder (falsification runs: the "
        "verdict must FAIL its fault-reconciliation clause)",
    )
    device_flag(dy)
    dy.set_defaults(fn=do_day)

    tr = sub.add_parser("train")
    engine_flags(tr)
    tr.add_argument("--batch", default="")
    tr.add_argument("--skip-sanity-check", action="store_true")
    tr.add_argument("--stop-after-read", action="store_true")
    tr.add_argument("--stop-after-prepare", action="store_true")
    no_check_flag(tr)
    device_flag(tr)
    tr.set_defaults(fn=do_train)

    ev = sub.add_parser("eval")
    ev.add_argument("evaluation", help="import path pkg.module:evaluation")
    ev.add_argument(
        "--params", default=None, help="JSON kwargs for a callable evaluation"
    )
    device_flag(ev)
    ev.set_defaults(fn=do_eval)

    def instance_flags(sp):
        engine_flags(sp)
        sp.add_argument(
            "--engine-instance-id",
            help="default: the engine's live generation, else its latest "
            "COMPLETED instance",
        )
        device_flag(sp)

    dp = sub.add_parser("deploy")
    instance_flags(dp)
    no_check_flag(dp)
    dp.add_argument("--ip", default="0.0.0.0")
    dp.add_argument("--port", type=int, default=8000)
    dp.add_argument(
        "--feedback",
        action="store_true",
        help="write each query and its answer back as a 'predict' event "
        "of the app that --accesskey belongs to",
    )
    dp.add_argument(
        "--event-port",
        type=int,
        default=None,
        help="also serve the event server on this port, on the same "
        "storage (0 = a free port)",
    )
    dp.add_argument("--accesskey", default="")
    dp.add_argument(
        "--deadline-s",
        type=float,
        default=None,
        help="default per-request time budget in seconds (clients override "
        "per request with the X-Pio-Deadline header); expired work is "
        "answered 504 instead of computed (PIO_DEFAULT_DEADLINE_S)",
    )
    dp.add_argument(
        "--max-inflight",
        type=int,
        default=None,
        help="in-flight request cap; excess requests shed with 503 + "
        "Retry-After at admission (PIO_MAX_INFLIGHT)",
    )
    dp.add_argument(
        "--max-queue",
        type=int,
        default=None,
        help="micro-batch queue bound; excess queries shed with 503 + "
        "Retry-After (PIO_MAX_QUEUE; default 1024, 0 = unbounded)",
    )
    dp.add_argument(
        "--app",
        action="append",
        dest="app_specs",
        metavar="SPEC",
        default=None,
        help="serve several engines as tenants of one deploy (repeatable). "
        "SPEC is comma-separated key=value pairs: name=<app>,engine="
        "<factory> required; optional engine_id=, engine_version=, "
        "variant=, engine_instance_id=, quota_rps=, quota_burst=, "
        "max_inflight=, deadline_s=, access_key=.  A request picks its "
        "tenant by the X-Pio-App header or ?app=",
    )
    dp.add_argument(
        "--hbm-budget-bytes",
        type=int,
        default=None,
        help="the device-memory budget tenants are admitted against, in "
        "stored model bytes; a tenant that does not fit is refused at "
        "deploy",
    )
    dp.add_argument(
        "--lifecycle",
        action="store_true",
        help="run the lifecycle controller: drift or staleness triggers a "
        "warm-start retrain, the result canaries on an entity-hash "
        "fraction of the traffic, and guardrails promote or roll it back "
        "(PIO_LIFECYCLE=1; knobs PIO_CANARY_* and PIO_LIFECYCLE_*)",
    )
    dp.set_defaults(fn=do_deploy)

    ud = sub.add_parser("undeploy")
    ud.add_argument("--ip", default="127.0.0.1")
    ud.add_argument("--port", type=int, default=8000)
    ud.add_argument("--accesskey", default="")
    ud.add_argument(
        "--pidfile",
        default=None,
        help="fall back to SIGTERM->SIGKILL via this pidfile when the HTTP "
        "/stop surface is wedged (reports which signal won)",
    )
    ud.set_defaults(fn=do_undeploy)

    bp = sub.add_parser("batchpredict")
    instance_flags(bp)
    bp.add_argument("--input", required=True)
    bp.add_argument("--output", required=True)
    bp.set_defaults(fn=do_batchpredict)

    bd = sub.add_parser("build")
    bd.add_argument("--engine")
    bd.add_argument("--engine-json", default="engine.json")
    bd.set_defaults(fn=do_build)

    sub.add_parser("upgrade").set_defaults(fn=do_upgrade)

    rn = sub.add_parser("run")
    rn.add_argument("script")
    rn.add_argument("script_args", nargs="*")
    rn.set_defaults(fn=do_run)

    mt = sub.add_parser("metrics")
    mt.add_argument(
        "--url", help="scrape a running server (e.g. http://127.0.0.1:8000)"
    )
    mt.add_argument(
        "--json", action="store_true",
        help="JSON exposition instead of Prometheus text",
    )
    mt.add_argument(
        "--access-key",
        default=None,
        help="access key for key-gated servers (sent as a Bearer header)",
    )
    mt.add_argument(
        "--watch",
        type=float,
        default=None,
        metavar="SECONDS",
        help="re-render every SECONDS until interrupted",
    )
    mt.add_argument(
        "--watch-count",
        type=int,
        default=None,
        help=argparse.SUPPRESS,  # bounded --watch renders (tests)
    )
    mt.set_defaults(fn=do_metrics)

    tp = sub.add_parser("template")
    tp.add_argument(
        "template_command", choices=["list", "get"], nargs="?", default="list"
    )
    tp.add_argument("name", nargs="?")
    tp.add_argument("directory", nargs="?")
    tp.set_defaults(fn=do_template)

    lcp = sub.add_parser(
        "lifecycle",
        description="The generation manifest (staged/live/retired/"
        "rolled_back with blob checksums), from a running deploy's "
        "/lifecycle.json or the model store.",
    )
    lcp.add_argument(
        "--url", help="read a running deploy (e.g. http://127.0.0.1:8000)"
    )
    lcp.add_argument("--engine-id", default="default")
    lcp.add_argument("--engine-version", default="default")
    lcp.add_argument("--variant", default="default")
    lcp.add_argument(
        "--json", action="store_true",
        help="raw /lifecycle.json instead of the text summary",
    )
    lcp.add_argument(
        "--access-key",
        default=None,
        help="access key for key-gated deploys (sent as a Bearer header)",
    )
    watch_flags(lcp)
    lcp.set_defaults(fn=do_lifecycle)

    ql = sub.add_parser(
        "quality",
        description="Online model quality: per-variant rolling metrics "
        "(CTR, hit rate, precision@k, rating MAE) and drift (PSI/KS against "
        "the reference window), from a running server's /quality.json or "
        "this process's monitor.",
    )
    ql.add_argument("--url", help="read a running server (e.g. http://127.0.0.1:8000)")
    ql.add_argument(
        "--json", action="store_true",
        help="raw /quality.json instead of the text summary",
    )
    ql.add_argument(
        "--access-key", default=None,
        help="access key for key-gated servers (sent as a Bearer header)",
    )
    watch_flags(ql)
    ql.set_defaults(fn=do_quality)

    tn = sub.add_parser(
        "tenants",
        description="The resident tenants of a running deploy: SLO state, "
        "quota, stored bytes, in-flight count and degraded reasons, from "
        "its /tenants.json.",
    )
    tn.add_argument(
        "--url", required=True,
        help="read a running server (e.g. http://127.0.0.1:8000)",
    )
    tn.add_argument(
        "--json", action="store_true",
        help="raw /tenants.json instead of the text table",
    )
    tn.add_argument(
        "--access-key", default=None,
        help="access key for key-gated servers (sent as a Bearer header)",
    )
    watch_flags(tn)
    tn.set_defaults(fn=do_tenants)

    rr = sub.add_parser(
        "replay-request",
        description="Re-answer a recorded request from the record's "
        "manifest-named, checksum-verified generation in local storage and "
        "diff item ids and raw scores.  Exit 0 = identical; 1 = divergence "
        "(each named); 2 = record unavailable or not replayable.",
    )
    rr.add_argument("request_id", help="the X-Pio-Request-Id to replay")
    rr.add_argument(
        "--url", default=None,
        help="fetch the record from a running server's /explain.json",
    )
    rr.add_argument(
        "--record", default=None, metavar="FILE",
        help="a recorded provenance record to replay instead of fetching",
    )
    rr.add_argument("--access-key", default=None)
    rr.add_argument(
        "--tolerance", type=float, default=0.0, metavar="EPS",
        help="absolute score tolerance (default 0: scores compare by repr)",
    )
    rr.add_argument("--json", action="store_true")
    device_flag(rr)
    rr.set_defaults(fn=do_replay_request)

    def scrape_flags(sp, url_help: str = "read a running server "
                     "(e.g. http://127.0.0.1:8000)") -> None:
        """--url, --json, --access-key, --watch and --watch-count: the
        flags every scrape verb shares."""
        sp.add_argument("--url", help=url_help)
        sp.add_argument(
            "--json", action="store_true",
            help="the raw JSON body instead of the text rendering",
        )
        sp.add_argument(
            "--access-key",
            default=None,
            help="access key for key-gated servers (sent as a Bearer header)",
        )
        sp.add_argument(
            "--watch",
            type=float,
            default=None,
            metavar="SECONDS",
            help="re-render every SECONDS until interrupted",
        )
        sp.add_argument(
            "--watch-count",
            type=int,
            default=None,
            help=argparse.SUPPRESS,  # bounded --watch renders (tests)
        )

    cp = sub.add_parser(
        "capacity",
        description="Capacity / headroom model: observed load vs the "
        "device and admission ceilings, joined with SLO burn into "
        "max-sustainable-QPS, headroom and a recommended replica count, "
        "from a running server's /capacity.json or this process.",
    )
    scrape_flags(cp)
    cp.set_defaults(fn=do_capacity)

    al = sub.add_parser(
        "alerts",
        description="Alert rules engine state: firing/pending instances, "
        "recent transitions and the rule set, from a running server's "
        "/alerts.json.  One shot exits 1 when anything is firing.",
    )
    scrape_flags(al)
    al.set_defaults(fn=do_alerts)

    co = sub.add_parser(
        "costs",
        description="Per-app cost ledger: attributed device-seconds, "
        "least-work flops and bytes, storage bytes, queue-seconds and "
        "sheds by (app, route, variant), from a running server's "
        "/costs.json or this process's ledger.",
    )
    scrape_flags(co)
    co.add_argument(
        "--window", type=int, default=None, metavar="N",
        help="include only the last N closed accounting windows",
    )
    co.set_defaults(fn=do_costs)

    tpv = sub.add_parser(
        "top",
        description="Live view: request latency, firing alerts and the top "
        "apps by attributed device time.  Refreshes every --watch seconds "
        "(default 2); --once renders one frame.",
    )
    scrape_flags(tpv)
    tpv.add_argument(
        "--once", action="store_true", help="render one frame and exit",
    )
    tpv.set_defaults(fn=do_top)

    ic = sub.add_parser(
        "incident",
        description="Forensic incident bundles recorded by the alert "
        "engine: list them, render one offline (the SLO and breaker state "
        "and the exemplar request's waterfall), or export the raw bundle "
        "or its trace as Chrome trace-event JSON.",
    )
    icsub = ic.add_subparsers(dest="incident_command", required=True)
    icl = icsub.add_parser("list", help="list recorded bundles")
    ics = icsub.add_parser("show", help="render one bundle")
    ics.add_argument("incident_id", help="bundle id (or unique prefix)")
    ice = icsub.add_parser("export", help="dump one bundle (or --perfetto)")
    ice.add_argument("incident_id", help="bundle id (or unique prefix)")
    ice.add_argument("--out", default=None, help="output path (default: stdout)")
    ice.add_argument(
        "--perfetto", metavar="OUT.json", default=None,
        help="write the exemplar trace as Chrome trace-event JSON "
        "('-' for stdout)",
    )
    ice.add_argument(
        "--trace-id", default=None,
        help="which recorded trace to export (default: the exemplar)",
    )
    for sp_ in (icl, ics, ice):
        sp_.add_argument(
            "--dir", default=None,
            help="bundle directory (default: PIO_INCIDENT_DIR or "
            "$PIO_HOME/incidents)",
        )
        sp_.add_argument(
            "--url", default=None,
            help="read a running server's /incidents.json instead",
        )
        sp_.add_argument("--access-key", default=None)
        sp_.add_argument("--json", action="store_true")
    ic.set_defaults(fn=do_incident)

    tc = sub.add_parser(
        "trace",
        description="Assemble one cross-process trace: fetch span "
        "fragments from every named process's /spans.json?trace_id=, "
        "clock-align them and merge them into one host+device timeline "
        "(text waterfall, JSON, or Chrome trace-event JSON).",
    )
    tc.add_argument("trace_id", help="the X-Pio-Trace-Id to assemble")
    tc.add_argument(
        "--from", dest="from_urls", action="append", default=None,
        metavar="URL[,URL]",
        help="server base URLs to fetch /spans.json from (repeatable, "
        "comma-separable); a dead process costs its fragments only",
    )
    tc.add_argument(
        "--file", action="append", default=None, metavar="PATH",
        help="a recorded /spans.json body, fragment list or incident "
        "bundle to fold in (repeatable)",
    )
    tc.add_argument(
        "--local", action="store_true",
        help="include this process's own fragment store (the default "
        "without --from/--file)",
    )
    tc.add_argument("--json", action="store_true", help="the tree as JSON")
    tc.add_argument(
        "--perfetto", metavar="OUT", default=None,
        help="write Chrome trace-event JSON to OUT ('-' for stdout)",
    )
    tc.add_argument(
        "--access-key", default=None,
        help="access key for key-gated servers (sent as a Bearer header)",
    )
    tc.set_defaults(fn=do_trace)

    ex = sub.add_parser(
        "explain",
        description="One answer's decision provenance (/explain.json) "
        "joined with its flight-recorder entry, its log lines and its "
        "assembled trace, or a recorded record rendered offline "
        "(--record).",
    )
    ex.add_argument("request_id", help="the X-Pio-Request-Id to explain")
    ex.add_argument("--url", default=None, help="running server to read")
    ex.add_argument(
        "--record", default=None, metavar="FILE",
        help="a recorded provenance record to render instead of fetching",
    )
    ex.add_argument("--access-key", default=None)
    ex.add_argument("--json", action="store_true")
    ex.add_argument(
        "--no-trace", action="store_true",
        help="skip the cross-process trace join",
    )
    ex.set_defaults(fn=do_explain)

    ck = sub.add_parser(
        "check",
        description=(
            "PyTorch-aware static analysis: hot-path device-sync lints "
            "(PIO-TORCH*), concurrency lints (PIO-CONC*), and DASE contract "
            "checks (PIO-DASE*, via --engine).  Exit codes: 0 = clean, "
            "1 = findings at/above --severity, 2 = usage or parse error.  "
            "Suppress inline with '# pio: ignore[RULE]' or via a baseline "
            "file (.pio-check-baseline.json is auto-discovered in the "
            "working directory)."
        ),
    )
    ck.add_argument(
        "paths",
        nargs="*",
        help="files/directories to analyze (default: current directory)",
    )
    ck.add_argument(
        "--engine",
        action="append",
        help="also run DASE contract checks for this engine factory "
        "(repeatable; 'all' = every bundled engine)",
    )
    ck.add_argument(
        "--format", choices=["text", "json", "sarif"], default="text"
    )
    ck.add_argument(
        "--graph",
        action="store_true",
        help="dump the whole-program call graph + lock acquisition graph "
        "as JSON and exit (0, or 2 on parse errors)",
    )
    ck.add_argument(
        "--no-cache",
        action="store_true",
        help="bypass the check-result cache ($PIO_HOME/check-cache.json)",
    )
    ck.add_argument(
        "--stats",
        action="store_true",
        help="print cache hit/miss counts to stderr",
    )
    ck.add_argument(
        "--severity",
        default="low",
        help="minimum severity reported and counted toward the exit code "
        "(low/medium/high; default low)",
    )
    ck.add_argument(
        "--baseline",
        default=None,
        help="baseline file of suppressed findings (default: "
        ".pio-check-baseline.json if present)",
    )
    ck.add_argument(
        "--write-baseline",
        action="store_true",
        help="write the current findings to the baseline file and exit 0",
    )
    ck.set_defaults(fn=do_check)

    bn = sub.add_parser(
        "bench",
        help="perf-regression gate over two bench.py JSON lines",
        description="Compare a current BENCH json against a previous one "
        "and exit 1 on regression beyond tolerance (2 on missing/old "
        "schema_version) — the CI gate for perf work.",
    )
    bn.add_argument(
        "--compare",
        required=True,
        metavar="PREV.json",
        help="previous BENCH json line/file to gate against",
    )
    bn.add_argument(
        "current",
        nargs="?",
        default=None,
        help="current BENCH json file (default: read stdin, so "
        "`python bench.py | pio bench --compare PREV.json` works)",
    )
    bn.add_argument(
        "--tolerance",
        type=float,
        default=10.0,
        metavar="PCT",
        help="allowed regression per metric in percent (default 10)",
    )
    bn.set_defaults(fn=do_bench)

    pf = sub.add_parser(
        "profile",
        description="Profile a running server: arm its torch.profiler "
        "capture (default; key-gated POST /debug/profile; CUDA activity "
        "when its model is on the card) or capture host stacks through "
        "its continuous sampler (--stacks).  A server whose profiler "
        "answers 501 gets the host stack capture.  Without --url, samples "
        "this process's threads.",
    )
    pf.add_argument("--url", help="target server (e.g. http://127.0.0.1:8000)")
    pf.add_argument(
        "--seconds", type=float, default=5.0, help="capture window (default 5)",
    )
    pf.add_argument(
        "--stacks", action="store_true",
        help="capture host stacks instead of the device profile",
    )
    pf.add_argument(
        "--speedscope", metavar="OUT.json", default=None,
        help="write the stack capture as speedscope JSON",
    )
    pf.add_argument(
        "--access-key", default=None,
        help="access key for key-gated servers (sent as a Bearer header)",
    )
    pf.set_defaults(fn=do_profile)
    return parser


def main(argv: list[str] | None = None) -> int:
    # as the JAX package's CLI: JSON lines (request-id correlated) to
    # stderr, PIO_LOG_FORMAT=text for humans, PIO_LOG_LEVEL for verbosity,
    # and the package logger open to the /logs.json ring
    from predictionio_tpu_torch.obs.logging import configure_logging

    configure_logging()
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except cmd.CommandError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
