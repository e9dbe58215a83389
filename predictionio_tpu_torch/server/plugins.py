"""Server plugin hooks: input blockers, output blockers, sniffers.

The port's copy of the JAX package's ``server/plugins.py``.  The event
server runs the input half; the prediction server does not run the output
half yet.

Parity with the reference plugin seams (workflow/EngineServerPlugin.scala:24
— outputblocker/outputsniffer; data/api/EventServerPlugin.scala:22 — input
blocker/sniffer; loaded from a classpath scan in
EngineServerPluginContext.scala:49).  Here plugins are plain objects
registered programmatically or resolved from the ``PIO_PLUGINS`` env var
(comma-separated ``pkg.module:attr`` import paths — the Python analog of
dropping jars into plugins/).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Any, Callable

log = logging.getLogger("predictionio_tpu_torch.plugins")

INPUT_BLOCKER = "inputblocker"
INPUT_SNIFFER = "inputsniffer"
OUTPUT_BLOCKER = "outputblocker"
OUTPUT_SNIFFER = "outputsniffer"


class EventServerPlugin:
    """Event-ingest hook: ``process`` may mutate-or-raise (blocker) or just
    observe (sniffer).  ``handle_rest`` (optional) answers the server's
    ``/plugins/<type>/<name>/...`` routes (EventServer.scala:154-206)."""

    plugin_name = "event-plugin"
    plugin_type = INPUT_SNIFFER

    def process(self, app_id: int, channel_id: int | None, event) -> None:
        raise NotImplementedError

    def handle_rest(self, path: str, query: dict) -> Any:
        """Plugin-specific HTTP endpoint; return a JSON-able value."""
        return {"message": f"{self.plugin_name} has no REST handler"}


class EngineServerPlugin:
    """Serving hook: blockers transform (or veto, by raising) the rendered
    prediction; sniffers observe asynchronously.  ``handle_rest`` (optional)
    answers ``/plugins/<type>/<name>/...`` (CreateServer.scala:656-702)."""

    plugin_name = "engine-plugin"
    plugin_type = OUTPUT_SNIFFER

    def process(
        self, engine_instance_id: str, query: Any, prediction: Any
    ) -> Any:
        raise NotImplementedError

    def handle_rest(self, path: str, query: dict) -> Any:
        """Plugin-specific HTTP endpoint; return a JSON-able value."""
        return {"message": f"{self.plugin_name} has no REST handler"}


class PluginContext:
    """Holds registered plugins, split by type.

    Sniffers run on ONE long-lived worker thread draining a queue (the
    plugins-actor analog) so the ingest/serving hot paths never pay
    thread-creation cost and observations stay ordered.
    """

    def __init__(self):
        self._plugins: list[Any] = []
        self._queue: queue.Queue | None = None

    def register(self, plugin: Any) -> None:
        if not isinstance(getattr(plugin, "plugin_type", None), str):
            raise TypeError(
                f"plugin {plugin!r} has no plugin_type attribute"
            )
        self._plugins.append(plugin)

    def of_type(self, plugin_type: str) -> list[Any]:
        return [p for p in self._plugins if p.plugin_type == plugin_type]

    # -- hook runners --------------------------------------------------------
    def process_input(self, app_id: int, channel_id: int | None, event) -> None:
        """Blockers run inline (exception rejects the event); sniffers are
        queued to the worker."""
        for p in self.of_type(INPUT_BLOCKER):
            p.process(app_id, channel_id, event)
        sniffers = self.of_type(INPUT_SNIFFER)
        if sniffers:
            self._enqueue(sniffers, (app_id, channel_id, event))

    def process_output(
        self, engine_instance_id: str, query: Any, prediction: Any
    ) -> Any:
        for p in self.of_type(OUTPUT_BLOCKER):
            prediction = p.process(engine_instance_id, query, prediction)
        sniffers = self.of_type(OUTPUT_SNIFFER)
        if sniffers:
            self._enqueue(sniffers, (engine_instance_id, query, prediction))
        return prediction

    def _enqueue(self, sniffers, args) -> None:
        if self._queue is None:
            self._queue = queue.Queue()
            threading.Thread(
                target=self._drain, name="plugin-sniffers", daemon=True
            ).start()
        self._queue.put((sniffers, args))

    def _drain(self) -> None:
        while True:
            sniffers, args = self._queue.get()
            for p in sniffers:
                try:
                    p.process(*args)
                except Exception:
                    log.exception("sniffer plugin %s failed", p.plugin_name)
            self._queue.task_done()

    def drain_pending(self) -> None:
        """Block until queued sniffer work is processed (tests/shutdown)."""
        if self._queue is not None:
            self._queue.join()

    # -- HTTP introspection (the /plugins* route surface) --------------------
    def descriptions(self) -> dict[str, dict[str, dict]]:
        """{plugin_type: {plugin_name: {class}}} for GET /plugins.json
        (EventServer.scala:154-165, CreateServer.scala:656-668)."""
        out: dict[str, dict[str, dict]] = {}
        for p in self._plugins:
            out.setdefault(p.plugin_type, {})[p.plugin_name] = {
                "class": type(p).__qualname__
            }
        return out

    def find(self, plugin_type: str, plugin_name: str):
        for p in self.of_type(plugin_type):
            if p.plugin_name == plugin_name:
                return p
        return None

    def rest_response(self, plugin_type: str, plugin_name: str,
                      path: str, query: dict):
        """Dispatch a /plugins/<type>/<name>/<path> request to the plugin's
        ``handle_rest``, wrapping the result as an HTTP Response."""
        from predictionio_tpu_torch.server.httpd import (
            Response,
            error_response,
            json_response,
        )

        p = self.find(plugin_type, plugin_name)
        if p is None:
            return error_response(
                404, f"no {plugin_type} plugin named {plugin_name!r}"
            )
        handler = getattr(p, "handle_rest", None)
        if handler is None:
            return error_response(
                404, f"plugin {plugin_name!r} has no REST handler"
            )
        out = handler(path or "/", query)
        return out if isinstance(out, Response) else json_response(200, out)

    @classmethod
    def from_env(cls, env_var: str = "PIO_PLUGINS") -> "PluginContext":
        """Resolve plugin instances/classes/factories from import paths.

        A bad entry is logged and skipped — one misconfigured plugin must
        not poison every request.
        """
        from predictionio_tpu_torch.utils.registry import resolve_import_path

        ctx = cls()
        spec = os.environ.get(env_var, "")
        for path in filter(None, (s.strip() for s in spec.split(","))):
            try:
                obj = resolve_import_path(path)
                if obj is None:
                    raise KeyError(f"import path {path!r} not found")
                if callable(obj) and not isinstance(
                    getattr(obj, "plugin_type", None), str
                ):
                    obj = obj()  # class or factory function
                ctx.register(obj)
            except Exception:
                log.exception("skipping plugin %s", path)
        return ctx
