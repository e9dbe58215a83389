"""Device resolution for the port's entry points.

Every entry point (``deploy_engine``, ``create_prediction_server``,
``run_batch_predict``, the CLI and ``EngineContext``) takes ``device=None``,
which means CUDA.  Without a card the call raises, unless the caller asked
for the CPU with ``device="cpu"``: nothing on the serving path quietly
carries on on the CPU when the GPU is missing.
"""

from __future__ import annotations

import torch


class DeviceUnavailable(RuntimeError):
    """The requested device does not exist on this host."""


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"``/``"cuda"``/``"cuda:N"`` as given.

    Raises :class:`DeviceUnavailable` for CUDA on a host without a card and
    ``ValueError`` for any other device type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(
            f"unsupported device {dev}: the port runs on 'cuda' or 'cpu'"
        )
    if not torch.cuda.is_available():
        raise DeviceUnavailable(
            f"device {dev} requested but CUDA is not available on this "
            "host; pass device='cpu' to run on the CPU"
        )
    return dev
