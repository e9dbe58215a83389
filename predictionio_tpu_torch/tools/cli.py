"""``python -m predictionio_tpu_torch.tools.cli <verb>``.

The verbs of the JAX package's ``pio`` console (``tools/cli.py``) that the
port runs, with the flags that apply to them: ``app``
(``new|list|show|delete|data-delete|channel-new|channel-delete``),
``accesskey`` (``new|list|delete``), ``import``, ``export``,
``eventserver``, ``train``, ``eval`` (an ``Evaluation`` by import path,
``--params`` for a factory's keyword arguments), ``deploy``
(``--event-port`` serves the event server beside it, on the same storage),
``batchpredict``, ``template`` (``list|get``: the bundled engines, and a
starter ``engine.json``) and ``lifecycle`` (the generation manifest, from
a running deploy's ``/lifecycle.json`` with ``--url`` or from the model
store), plus ``--device`` on the verbs that compute (default ``cuda``;
``cpu`` runs the plain versions on the host).  Storage is configured by
the same ``PIO_HOME`` / ``PIO_STORAGE_*`` variables.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any

from predictionio_tpu_torch.data.storage.config import get_storage
from predictionio_tpu_torch.tools import commands as cmd


def _print(obj: Any) -> None:
    print(json.dumps(obj, indent=2, default=str))


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
    elif args.app_command == "channel-new":
        ch = cmd.channel_new(storage, args.name, args.channel)
        _print({"id": ch.id, "name": ch.name, "appid": ch.appid})
    elif args.app_command == "channel-delete":
        cmd.channel_delete(storage, args.name, args.channel)
        print(f"Channel {args.channel} deleted.")
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
    print(f"Event server on http://{args.ip}:{server.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
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


def do_train(args) -> int:
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.workflow import WorkflowParams, run_train

    factory_name, engine, variant = _resolve_engine(args)
    params = engine.params_from_json(variant)
    storage = get_storage()
    ctx = EngineContext(storage=storage, mode="train", device=args.device)
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
        engine_id=variant.get("id", "default"),
        engine_version=variant.get("version", "default"),
        engine_variant=variant.get("variant", "default"),
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


def do_deploy(args) -> int:
    from predictionio_tpu_torch.server.prediction_server import (
        create_prediction_server,
    )

    server = create_prediction_server(
        args.engine,
        host=args.ip,
        port=args.port,
        storage=get_storage(),
        engine_instance_id=args.engine_instance_id,
        access_key=args.accesskey or None,
        max_queue=args.max_queue,
        max_inflight=args.max_inflight,
        default_deadline_s=args.deadline_s,
        device=args.device,
    )
    event_server = None
    if args.event_port is not None:
        # the speed layer in one process: events POSTed here land in the
        # storage whose live reads (the ecommerce engine's) serve the
        # next query
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


def do_batchpredict(args) -> int:
    from predictionio_tpu_torch.core.batch_predict import run_batch_predict

    n = run_batch_predict(
        args.engine,
        args.input,
        args.output,
        storage=get_storage(),
        engine_instance_id=args.engine_instance_id,
        device=args.device,
    )
    print(f"Wrote {n} predictions to {args.output}")
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
    """`lifecycle`: the generation manifest.  With ``--url``, a running
    deploy's ``/lifecycle.json``; without it, the manifest straight from
    the configured model store for the given engine coordinates.  Either
    way it reads JSON and computes nothing on a device.  A failed scrape
    prints the error and exits 1."""
    try:
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
    except Exception as e:
        print(f"scrape failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps(body, indent=2) if args.json else _render_lifecycle_text(body))
    return 0


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
    for verb in ("channel-new", "channel-delete"):
        ch = asub.add_parser(verb)
        ch.add_argument("name")
        ch.add_argument("channel")
    ap.set_defaults(fn=do_app)

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

    tr = sub.add_parser("train")
    tr.add_argument("--engine", help="factory name or pkg.module:factory")
    tr.add_argument("--engine-json", help="engine variant JSON file")
    tr.add_argument("--batch", default="")
    tr.add_argument("--skip-sanity-check", action="store_true")
    tr.add_argument("--stop-after-read", action="store_true")
    tr.add_argument("--stop-after-prepare", action="store_true")
    device_flag(tr)
    tr.set_defaults(fn=do_train)

    ev = sub.add_parser("eval")
    ev.add_argument("evaluation", help="import path pkg.module:evaluation")
    ev.add_argument(
        "--params", default=None, help="JSON kwargs for a callable evaluation"
    )
    device_flag(ev)
    ev.set_defaults(fn=do_eval)

    def engine_flags(sp):
        sp.add_argument(
            "--engine", default="",
            help="factory name or pkg.module:factory (default: the "
            "instance's own factory)",
        )
        sp.add_argument(
            "--engine-instance-id",
            help="default: the latest COMPLETED instance",
        )
        device_flag(sp)

    dp = sub.add_parser("deploy")
    engine_flags(dp)
    dp.add_argument("--ip", default="0.0.0.0")
    dp.add_argument("--port", type=int, default=8000)
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
    dp.set_defaults(fn=do_deploy)

    bp = sub.add_parser("batchpredict")
    engine_flags(bp)
    bp.add_argument("--input", required=True)
    bp.add_argument("--output", required=True)
    bp.set_defaults(fn=do_batchpredict)

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
    lcp.set_defaults(fn=do_lifecycle)
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
