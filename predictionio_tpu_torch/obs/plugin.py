"""MetricsSnifferPlugin — the registry consumed through the plugin seams.

The JAX package's ``obs/plugin.py``.

Proof that the existing ``EventServerPlugin`` / ``EngineServerPlugin`` hooks
(server/plugins.py) compose with the observability subsystem: one sniffer
class serves both seams (ingest observations and serving observations have
the same 3-arg ``process`` shape), counts what flows past it into the shared
registry, and answers its ``/plugins/<type>/<name>/...`` REST surface with a
JSON snapshot of its own counters.

Register programmatically::

    ctx = PluginContext()
    ctx.register(MetricsSnifferPlugin(kind="input"))    # event server
    ctx.register(MetricsSnifferPlugin(kind="output"))   # prediction server

or via the env seam: ``PIO_PLUGINS=predictionio_tpu_torch.obs.plugin:input_sniffer``
(and/or ``:output_sniffer``).
"""

from __future__ import annotations

from typing import Any

from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry
from predictionio_tpu_torch.server.plugins import INPUT_SNIFFER, OUTPUT_SNIFFER


class MetricsSnifferPlugin:
    """Counts sniffed events/predictions into the metrics registry.

    ``kind="input"`` observes event ingest (args: app_id, channel_id, event)
    and increments ``pio_sniffed_events_total{event=...}``; ``kind="output"``
    observes served predictions (args: engine_instance_id, query, prediction)
    and increments ``pio_sniffed_predictions_total{engine_instance=...}``.
    """

    def __init__(
        self, kind: str = "input", registry: MetricsRegistry | None = None
    ):
        if kind not in ("input", "output"):
            raise ValueError(f"kind must be 'input' or 'output', got {kind!r}")
        self.kind = kind
        self.plugin_type = INPUT_SNIFFER if kind == "input" else OUTPUT_SNIFFER
        self.plugin_name = f"metrics-sniffer-{kind}"
        self._registry = registry or REGISTRY
        self._seen: set[str] = set()
        if kind == "input":
            self._counter = self._registry.counter(
                "pio_sniffed_events_total",
                "Events observed by the metrics sniffer plugin",
                labelnames=("event",),
            )
        else:
            self._counter = self._registry.counter(
                "pio_sniffed_predictions_total",
                "Predictions observed by the metrics sniffer plugin",
                labelnames=("engine_instance",),
            )

    #: label-cardinality cap: event names are client-supplied; past the cap
    #: new names collapse into one overflow series
    _MAX_LABELS = 100

    def process(self, a: Any, b: Any, c: Any) -> None:
        if self.kind == "input":
            # (app_id, channel_id, event)
            label = getattr(c, "event", "?")
        else:
            # (engine_instance_id, query, prediction)
            label = str(a)
        if label not in self._seen:
            if len(self._seen) >= self._MAX_LABELS:
                label = "_other"
            else:
                self._seen.add(label)
        self._counter.labels(label).inc()

    def handle_rest(self, path: str, query: dict) -> Any:
        fam = self._counter  # a MetricFamily (labeled)
        return {
            "plugin": self.plugin_name,
            "counts": {
                ",".join(lv) or "_": child.value
                for lv, child in fam.series()
            },
        }


def input_sniffer() -> MetricsSnifferPlugin:
    """PIO_PLUGINS factory: event-ingest metrics sniffer."""
    return MetricsSnifferPlugin(kind="input")


def output_sniffer() -> MetricsSnifferPlugin:
    """PIO_PLUGINS factory: serving-output metrics sniffer."""
    return MetricsSnifferPlugin(kind="output")
