"""``python -m predictionio_tpu_torch.tools.cli app new|import|train|deploy|batchpredict``.

The verbs of the JAX package's ``pio`` console (``tools/cli.py``) that the
port runs, from a new app to a deployed engine, with the flags that apply
to them, plus ``--device`` on the verbs that compute (default ``cuda``;
``cpu`` runs the plain versions on the host).  Storage is configured by the
same ``PIO_HOME`` / ``PIO_STORAGE_*`` variables.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from predictionio_tpu_torch.data.storage.config import get_storage
from predictionio_tpu_torch.tools import commands as cmd


def do_app_new(args) -> int:
    d = cmd.app_new(
        get_storage(), args.name, description=args.description or "",
        access_key=args.access_key,
    )
    print(json.dumps(d.to_json_dict(), indent=2))
    return 0


def do_import(args) -> int:
    n = cmd.import_events(get_storage(), args.app, args.input, channel=args.channel)
    print(f"Imported {n} events.")
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
    print(f"Engine deployed on http://{args.ip}:{server.port} ({args.device})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
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
    new.set_defaults(fn=do_app_new)

    imp = sub.add_parser("import")
    imp.add_argument("--app", required=True)
    imp.add_argument("--input", required=True)
    imp.add_argument("--channel")
    imp.set_defaults(fn=do_import)

    tr = sub.add_parser("train")
    tr.add_argument("--engine", help="factory name or pkg.module:factory")
    tr.add_argument("--engine-json", help="engine variant JSON file")
    tr.add_argument("--batch", default="")
    tr.add_argument("--skip-sanity-check", action="store_true")
    tr.add_argument("--stop-after-read", action="store_true")
    tr.add_argument("--stop-after-prepare", action="store_true")
    device_flag(tr)
    tr.set_defaults(fn=do_train)

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
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
