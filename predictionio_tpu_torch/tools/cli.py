"""``python -m predictionio_tpu_torch.tools.cli deploy|batchpredict``.

The two verbs of the JAX package's ``pio`` console (``tools/cli.py``) that
this slice serves, with the flags that apply to them, plus ``--device``
(default ``cuda``; ``cpu`` runs the plain versions on the host).  Storage is
configured by the same ``PIO_HOME`` / ``PIO_STORAGE_*`` variables.
"""

from __future__ import annotations

import argparse
import sys

from predictionio_tpu_torch.data.storage.config import get_storage


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
        description="PredictionIO serving on PyTorch + CUDA",
    )
    sub = parser.add_subparsers(dest="command", required=True)

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
        sp.add_argument(
            "--device",
            default="cuda",
            help="cuda (default; fails without a card) or cpu",
        )

    dp = sub.add_parser("deploy")
    engine_flags(dp)
    dp.add_argument("--ip", default="0.0.0.0")
    dp.add_argument("--port", type=int, default=8000)
    dp.add_argument("--accesskey", default="")
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
