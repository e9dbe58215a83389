"""Observability lints (rule family PIO-OBS*).

Motivating case: every request that reaches an engine must pass through
the request-lifecycle middleware (``httpd.observe_request`` on the
threaded front end, ``record_request_outcome`` in the async one) — that
is where the latency histogram, the SLO tracker, the flight recorder and
per-request cost attribution all hook in.  A handler that dispatches
``app.handle(req)`` directly creates a dark route: it serves traffic
that never shows up in ``pio_request_latency_seconds``, never trips the
latency alert rules, and bills no cost ledger row — invisible exactly
when it misbehaves.
"""

from __future__ import annotations

import ast
from typing import Iterable

from predictionio_tpu_torch.analysis.findings import Finding, Severity
from predictionio_tpu_torch.analysis.rules import (
    ModuleInfo,
    Rule,
    enclosing_function,
    resolve_call,
    rule,
)

#: middleware entry points; a dispatch inside a function that calls either
#: one is the instrumented path itself, not a bypass of it
_MIDDLEWARE_CALLS = ("observe_request", "record_request_outcome")


def _calls_middleware(fn: ast.AST, mod: ModuleInfo) -> bool:
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        callee = resolve_call(mod, node)
        if callee.rpartition(".")[2] in _MIDDLEWARE_CALLS:
            return True
    return False


@rule
class HandlerBypassesRequestMiddleware(Rule):
    """PIO-OBS005: direct ``.handle(req)`` dispatch outside the
    request-latency middleware."""

    id = "PIO-OBS005"
    severity = Severity.MEDIUM
    summary = (
        "route dispatch bypasses the request-latency middleware; requests "
        "served this way are invisible to metrics, SLO burn, alerts, and "
        "cost attribution"
    )

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        # server modules only: that is where HTTP dispatch lives; a
        # .handle() helper on a batch job or CLI tool is not a request path
        if "server" not in mod.rel.replace("\\", "/"):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            # the dispatch spelling is a *call* of someone's .handle;
            # passing the bound method as a reference
            # (``observe_request(app, req, app.handle)``) is the
            # middleware doing its job and never matches here
            if not resolve_call(mod, node).endswith(".handle"):
                continue
            fn = enclosing_function(node)
            wrapped = (
                _calls_middleware(fn, mod)
                if fn is not None
                else _calls_middleware(mod.tree, mod)
            )
            if wrapped:
                continue
            where = f"function {fn.name!r}" if fn is not None else "module level"
            yield self.finding(
                mod,
                node,
                f".handle(...) dispatched directly at {where} without the "
                "request-lifecycle middleware: responses served here skip "
                "the latency histogram, SLO tracking, the flight recorder, "
                "and per-request cost attribution — route through "
                "observe_request(app, req, app.handle) (or call "
                "record_request_outcome after timing the dispatch)",
            )
