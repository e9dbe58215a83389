"""Per-request resource attribution and the per-app cost ledger.

The JAX package's ``obs/costs.py``, with the same fields, windows, file
layout and ``/costs.json`` body.  Two layers:

- :class:`RequestCost` — a contextvar-scoped accumulator bound by the HTTP
  request handlers (the twin of ``obs.device.wave_timeline`` one level up):
  storage reads note bytes into it when they run on the request's own
  thread, and MicroBatcher waves hand their measured ``device_s`` and
  their flops and bytes back through per-item meta, split across the
  wave's members (:func:`prorated_from_meta`).
- :class:`CostLedger` — thread-safe time-windowed rollups keyed by
  ``(app, route, variant)``: device-seconds, flops, device-memory bytes,
  storage bytes, queue-seconds, cache hits/misses, shed counts.  Closed
  windows persist with the tmp + fsync + ``os.replace`` discipline, so a
  SIGKILL loses at most the open window.  The ledger feeds ``/costs.json``
  (obs/http.py), ``pio costs`` / ``pio top``, and the ``cost_burn`` /
  ``cost_skew`` alert rules (obs/alerts.py ``costs.*`` selectors).

What the numbers are on this package:

- ``device_s`` is exactly what a wave's meta says: the dispatch window on
  the plain route, ``dispatch_s + finalize_s`` on the pipelined one (the
  MicroBatcher's own bracket).  The ledger times nothing itself, so its
  per-app sums equal the batcher's ``pio_microbatch_device_seconds``.
- ``flops`` and ``hbm_bytes`` are the engines' least-work counts
  (``source="least_work"`` on ``/efficiency.json``): there is no compiler
  cost model here.  ``hbm_bytes`` keeps the JAX package's field name; on a
  card it counts device-memory bytes.
- ``storage_bytes`` is billed by the parquet log once per scan, on the
  thread that asked for the scan (never from its pool's threads, which see
  no request context).

Import-light by design (metrics + device only, neither touches torch at
module scope): the storage tier calls :func:`note_storage_read` without
dragging torch into the event server.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Iterator, Mapping

from predictionio_tpu_torch.obs import device as device_obs
from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

log = logging.getLogger("predictionio_tpu_torch.costs")

#: bump when the persisted ledger layout changes (loads refuse a mismatch
#: rather than guessing — same contract as the BENCH schema)
COST_SCHEMA_VERSION = 1

#: the numeric fields one cost row accumulates; RequestCost carries the
#: same names so billing a record into the ledger is one loop
COST_FIELDS: tuple[str, ...] = (
    "requests",
    "device_s",
    "flops",
    "hbm_bytes",
    "storage_bytes",
    "queue_s",
    "cache_hits",
    "cache_misses",
    "sheds",
)


class RequestCost:
    """One request's attributed resource record (contextvar-scoped)."""

    __slots__ = ("app", "route", "variant") + COST_FIELDS

    def __init__(
        self,
        app: str = "unknown",
        route: str = "",
        variant: str = "default",
    ):
        self.app = app
        self.route = route
        self.variant = variant
        for f in COST_FIELDS:
            setattr(self, f, 0.0)
        self.requests = 1.0

    def add(self, **fields: float) -> None:
        for name, amount in fields.items():
            if name not in COST_FIELDS:
                raise ValueError(f"unknown cost field {name!r}")
            setattr(self, name, getattr(self, name) + float(amount))

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "app": self.app,
            "route": self.route,
            "variant": self.variant,
        }
        for f in COST_FIELDS:
            d[f] = getattr(self, f)
        return d


_cost_var: contextvars.ContextVar[RequestCost | None] = (
    contextvars.ContextVar("pio_request_cost", default=None)
)


def current_cost() -> RequestCost | None:
    return _cost_var.get()


@contextlib.contextmanager
def request_cost(
    app: str,
    route: str,
    variant: str = "default",
    ledger: "CostLedger | None" = None,
) -> Iterator[RequestCost]:
    """Bind a fresh :class:`RequestCost` for the duration of one request;
    when ``ledger`` is given the record is billed on exit (accounting must
    never fail the request, so billing errors are logged, not raised)."""
    rec = RequestCost(app, route, variant)
    token = _cost_var.set(rec)
    try:
        yield rec
    finally:
        _cost_var.reset(token)
        if ledger is not None:
            try:
                ledger.bill(rec)
            except Exception:
                log.exception("cost billing failed (app=%s)", rec.app)


def note_storage_read(nbytes: float) -> None:
    """Bill ``nbytes`` of storage reads to whoever is asking: the bound
    request record when the read runs on a request thread, else the open
    wave timeline (MicroBatcher worker/finalizer — the wave total is
    prorated back to members through per-item meta).  No-op outside both
    scopes (training scans, tooling), and deliberately allocation-free:
    this sits on the per-row-group read path."""
    if nbytes <= 0:
        return
    rec = _cost_var.get()
    if rec is not None:
        rec.storage_bytes += nbytes
        return
    tl = device_obs.current_timeline()
    if tl is not None:
        tl.storage_bytes += nbytes


def prorated_from_meta(meta: Mapping[str, Any]) -> dict[str, float]:
    """A wave member's share of its wave's measured cost: the wave-level
    ``device_s`` / flops / bytes in per-item meta (microbatch._fill_meta)
    split evenly across the ``wave_size`` members that rode it.  Queue wait
    is per-item already and passes through unsplit."""
    n = max(int(meta.get("wave_size") or 1), 1)
    return {
        "device_s": float(meta.get("device_s") or 0.0) / n,
        "flops": float(meta.get("wave_flops") or 0.0) / n,
        "hbm_bytes": float(meta.get("wave_bytes") or 0.0) / n,
        "storage_bytes": float(meta.get("wave_storage_bytes") or 0.0) / n,
        "queue_s": float(meta.get("queue_wait_s") or 0.0),
        "cache_hits": float(meta.get("cache_hits") or 0.0) / n,
        "cache_misses": float(meta.get("cache_misses") or 0.0) / n,
    }


def budgets_from_env(
    env: Mapping[str, str] | None = None,
) -> tuple[dict[str, float], float | None]:
    """(per-app device-s/min budgets, default budget) from
    ``PIO_COST_BUDGETS`` (JSON object app -> budget) and
    ``PIO_COST_BUDGET_DEVICE_S_PER_MIN`` (fallback for any app).  A
    malformed budget map raises — silently dropping an operator's budget
    would fake an unlimited fleet."""
    e = env if env is not None else os.environ
    budgets: dict[str, float] = {}
    raw = e.get("PIO_COST_BUDGETS")
    if raw:
        plan = json.loads(raw)
        if not isinstance(plan, dict):
            raise ValueError("PIO_COST_BUDGETS must be a JSON object")
        budgets = {str(k): float(v) for k, v in plan.items()}
    default = None
    raw_default = e.get("PIO_COST_BUDGET_DEVICE_S_PER_MIN")
    if raw_default:
        default = float(raw_default)
    return budgets, default


class CostLedger:
    """Thread-safe windowed per-(app, route, variant) cost rollups.

    One open window accumulates live; on roll it closes into a bounded
    deque of historical windows and — when a ``path`` is configured — the
    closed set persists crash-safe (unique tmp + fsync + ``os.replace``),
    so a SIGKILL loses at most the open window.  Aggregate mirrors go to
    the metrics registry (``pio_cost_*_total{app,route,variant}``) so the
    conservation property is checkable: per-app attributed sums equal the
    registry counters exactly (both are fed by the same ``bill`` call
    under the same lock).
    """

    def __init__(
        self,
        window_s: float = 60.0,
        retention: int = 60,
        path: str | None = None,
        budgets: dict[str, float] | None = None,
        default_budget: float | None = None,
        registry: MetricsRegistry | None = None,
        clock: Callable[[], float] = time.time,
    ):
        self.window_s = float(window_s)
        self.retention = max(int(retention), 1)
        self.path = path
        if budgets is None and default_budget is None:
            budgets, default_budget = budgets_from_env()
        self.budgets = dict(budgets or {})
        self.default_budget = default_budget
        self._clock = clock
        # reentrant: _roll_locked re-acquires under billing/snapshot callers
        self._lock = threading.RLock()
        self._open: dict[tuple[str, str, str], dict[str, float]] = {}
        self._open_start = clock()
        self._closed: deque[dict[str, Any]] = deque(maxlen=self.retention)
        reg = registry or REGISTRY
        labels = ("app", "route", "variant")
        self._m = {
            "requests": reg.counter(
                "pio_cost_requests_total",
                "Requests billed to the cost ledger",
                labelnames=labels,
            ),
            "device_s": reg.counter(
                "pio_cost_device_seconds_total",
                "Attributed device-seconds by app/route/variant",
                labelnames=labels,
            ),
            "flops": reg.counter(
                "pio_cost_flops_total",
                "Attributed least-work flops by app/route/variant",
                labelnames=labels,
            ),
            "hbm_bytes": reg.counter(
                "pio_cost_hbm_bytes_total",
                "Attributed least-work device-memory bytes by app/route/variant",
                labelnames=labels,
            ),
            "storage_bytes": reg.counter(
                "pio_cost_storage_bytes_total",
                "Attributed event-store bytes read by app/route/variant",
                labelnames=labels,
            ),
            "queue_s": reg.counter(
                "pio_cost_queue_seconds_total",
                "Attributed micro-batch queue wait by app/route/variant",
                labelnames=labels,
            ),
            "sheds": reg.counter(
                "pio_cost_sheds_total",
                "Shed requests billed by app/route/variant",
                labelnames=labels,
            ),
        }
        if self.path:
            self._load()

    # -- billing -------------------------------------------------------------

    def bill(self, cost: RequestCost) -> None:
        self.bill_values(
            cost.app,
            cost.route,
            cost.variant,
            **{f: getattr(cost, f) for f in COST_FIELDS},
        )

    def bill_values(
        self, app: str, route: str, variant: str = "default", **fields: float
    ) -> None:
        """Accumulate one attribution into the open window (rolling it
        first if its end has passed) and mirror to the registry counters."""
        now = self._clock()
        key = (str(app), str(route), str(variant))
        with self._lock:
            self._roll_locked(now)
            row = self._open.get(key)
            if row is None:
                row = dict.fromkeys(COST_FIELDS, 0.0)
                self._open[key] = row
            for name, amount in fields.items():
                if name not in COST_FIELDS:
                    raise ValueError(f"unknown cost field {name!r}")
                row[name] += float(amount)
        for name, counter in self._m.items():
            amount = float(fields.get(name, 0.0))
            if amount > 0:
                counter.labels(*key).inc(amount)

    def bill_meta(
        self,
        app: str,
        route: str,
        variant: str,
        meta: Mapping[str, Any],
        queue_only: bool = False,
    ) -> None:
        """Bill one served request from its wave meta (the prorated share),
        or just its queue wait when the wave never computed for it."""
        shares = prorated_from_meta(meta)
        if queue_only:
            shares = {"queue_s": shares["queue_s"]}
        self.bill_values(app, route, variant, requests=1.0, **shares)

    def note_shed(
        self, app: str, route: str, variant: str = "default"
    ) -> None:
        self.bill_values(app, route, variant, sheds=1.0)

    # -- windowing -----------------------------------------------------------

    def _roll_locked(self, now: float) -> None:
        # the RLock makes the re-acquire free for callers already holding it
        with self._lock:
            rolled = False
            while now >= self._open_start + self.window_s:
                end = self._open_start + self.window_s
                if self._open:
                    self._closed.append(
                        {
                            "start": self._open_start,
                            "end": end,
                            "rows": [
                                {
                                    "app": k[0],
                                    "route": k[1],
                                    "variant": k[2],
                                    **row,
                                }
                                for k, row in sorted(self._open.items())
                            ],
                        }
                    )
                    self._open = {}
                    rolled = True
                self._open_start = end
                # a long-idle ledger fast-forwards: nothing accrued, so the
                # open window simply re-anchors at the current period
                if now - self._open_start > self.retention * self.window_s:
                    self._open_start = now
                    break
            if rolled and self.path:
                try:
                    self._persist_locked()
                except Exception:
                    log.exception("cost ledger persist failed (%s)", self.path)

    def roll(self, now: float | None = None) -> None:
        """Close any elapsed window (tests and the snapshot path drive
        this; billing rolls implicitly)."""
        with self._lock:
            self._roll_locked(self._clock() if now is None else now)

    # -- persistence (the RES003 tmp+fsync+replace idiom) --------------------

    def _persist_locked(self) -> None:
        final = self.path
        assert final is not None
        os.makedirs(os.path.dirname(final) or ".", exist_ok=True)
        doc = {
            "schema": COST_SCHEMA_VERSION,
            "window_s": self.window_s,
            "closed": list(self._closed),
        }
        data = json.dumps(doc, sort_keys=True)
        tmp = f"{final}.tmp-{os.getpid()}-{threading.get_ident()}"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        os.replace(tmp, final)

    def _load(self) -> None:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except FileNotFoundError:
            return
        except Exception:
            log.exception("cost ledger load failed (%s); starting empty",
                          self.path)
            return
        if doc.get("schema") != COST_SCHEMA_VERSION:
            log.warning(
                "cost ledger %s has schema %s (want %s); starting empty",
                self.path, doc.get("schema"), COST_SCHEMA_VERSION,
            )
            return
        with self._lock:
            for w in doc.get("closed") or []:
                self._closed.append(w)

    # -- read side -----------------------------------------------------------

    def snapshot(self, windows: int | None = None) -> dict[str, Any]:
        """The ``/costs.json`` body: the open window, the last ``windows``
        closed windows (default all retained), and per-key totals across
        both — rows sorted by attributed device-seconds, heaviest first."""
        now = self._clock()
        with self._lock:
            self._roll_locked(now)
            open_rows = [
                {"app": k[0], "route": k[1], "variant": k[2], **row}
                for k, row in sorted(self._open.items())
            ]
            closed = list(self._closed)
            open_start = self._open_start
        if windows is not None:
            closed = closed[-max(int(windows), 0):]
        totals: dict[tuple[str, str, str], dict[str, float]] = {}
        for row in open_rows + [
            r for w in closed for r in w.get("rows", [])
        ]:
            key = (row["app"], row["route"], row["variant"])
            agg = totals.setdefault(key, dict.fromkeys(COST_FIELDS, 0.0))
            for f in COST_FIELDS:
                agg[f] += float(row.get(f, 0.0))
        total_rows = [
            {"app": k[0], "route": k[1], "variant": k[2], **agg}
            for k, agg in sorted(
                totals.items(),
                key=lambda kv: -kv[1]["device_s"],
            )
        ]
        return {
            "generated_at": now,
            "schema": COST_SCHEMA_VERSION,
            "window_s": self.window_s,
            "open": {"start": open_start, "rows": open_rows},
            "windows": closed,
            "totals": total_rows,
            "budgets": {
                "per_app": dict(self.budgets),
                "default_device_s_per_min": self.default_budget,
            },
        }

    # -- alert signals (obs/alerts.py ``costs.*`` selectors) -----------------

    def _per_app_device_s(self, now: float) -> tuple[dict[str, float], float]:
        """(per-app device-seconds over the current accounting window,
        seconds the window has covered).  Uses the open window; when it is
        empty (a roll just happened) the last closed window stands in, so
        a skew signal never flaps to silence at each window boundary."""
        with self._lock:
            self._roll_locked(now)
            if self._open:
                per_app: dict[str, float] = {}
                for (app, _r, _v), row in self._open.items():
                    per_app[app] = per_app.get(app, 0.0) + row["device_s"]
                return per_app, max(now - self._open_start, 1.0)
            if self._closed:
                last = self._closed[-1]
                per_app = {}
                for row in last.get("rows", []):
                    per_app[row["app"]] = (
                        per_app.get(row["app"], 0.0)
                        + float(row.get("device_s", 0.0))
                    )
                return per_app, self.window_s
        return {}, self.window_s

    def signal(self, name: str) -> dict[str, float]:
        """Per-app values for one ``costs.*`` alert selector.

        - ``burn_vs_budget``: (device-seconds/min) / budget, only for apps
          with a configured (or default) budget — 1.0 means burning the
          budget exactly;
        - ``device_share``: each app's fraction of total attributed device
          time; silent until at least two apps have device time, so a
          single-tenant deploy can't page itself for "consuming" 100 %.
        """
        now = self._clock()
        per_app, covered_s = self._per_app_device_s(now)
        if name == "burn_vs_budget":
            out: dict[str, float] = {}
            for app, dev_s in per_app.items():
                budget = self.budgets.get(app, self.default_budget)
                if budget is None or budget <= 0:
                    continue
                out[app] = (dev_s / covered_s * 60.0) / budget
            return out
        if name == "device_share":
            spenders = {a: v for a, v in per_app.items() if v > 0}
            total = sum(spenders.values())
            if len(spenders) < 2 or total <= 0:
                return {}
            return {a: v / total for a, v in spenders.items()}
        log.warning("cost ledger: unknown signal %s", name)
        return {}


# ---------------------------------------------------------------------------
# the process-default ledger (the default_quality idiom): single-VM deploys
# run the event server and prediction server in one process, and both must
# bill into the same rollup for /costs.json to answer "who costs what"

_default_lock = threading.Lock()
_DEFAULT: CostLedger | None = None


def default_ledger() -> CostLedger:
    global _DEFAULT
    if _DEFAULT is None:
        with _default_lock:
            if _DEFAULT is None:
                cost_dir = os.environ.get("PIO_COST_DIR")
                path = (
                    os.path.join(cost_dir, "costs.json") if cost_dir else None
                )
                try:
                    window_s = float(
                        os.environ.get("PIO_COST_WINDOW_S", "60")
                    )
                except ValueError:
                    window_s = 60.0
                _DEFAULT = CostLedger(window_s=window_s, path=path)
    return _DEFAULT


def reset_default_ledger() -> None:
    """Drop the process-default ledger (tests re-read the env)."""
    global _DEFAULT
    with _default_lock:
        _DEFAULT = None


# ---------------------------------------------------------------------------
# text rendering (pio costs)


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}TiB"


def render_costs_text(doc: Mapping[str, Any]) -> str:
    """Human table over a /costs.json body — local or federated (the
    federated shape carries ``replicas`` and replica-tagged rows)."""
    lines: list[str] = []
    replicas = doc.get("replicas")
    if replicas:
        lines.append(
            f"fleet costs across {len(replicas)} replica(s): "
            + ", ".join(replicas)
        )
        errors = doc.get("source_errors") or {}
        for name, err in sorted(errors.items()):
            lines.append(f"  ! {name}: {err}")
    header = (
        f"{'APP':<16} {'ROUTE':<18} {'VARIANT':<10} {'REQS':>8} "
        f"{'DEVICE_S':>10} {'FLOPS':>12} {'STORAGE':>10} {'QUEUE_S':>8} "
        f"{'SHEDS':>6}"
    )
    lines.append(header)
    rows = doc.get("totals") or []
    if not rows:
        lines.append("(no attributed cost yet)")
    for row in rows:
        app = str(row.get("app", "?"))
        if row.get("replica"):
            app = f"{app}@{row['replica']}"
        lines.append(
            f"{app:<16.16} {str(row.get('route', '')):<18.18} "
            f"{str(row.get('variant', '')):<10.10} "
            f"{int(row.get('requests', 0)):>8} "
            f"{float(row.get('device_s', 0.0)):>10.4f} "
            f"{float(row.get('flops', 0.0)):>12.3e} "
            f"{_fmt_bytes(float(row.get('storage_bytes', 0.0))):>10} "
            f"{float(row.get('queue_s', 0.0)):>8.3f} "
            f"{int(row.get('sheds', 0)):>6}"
        )
    budgets = doc.get("budgets") or {}
    per_app = budgets.get("per_app") or {}
    if per_app or budgets.get("default_device_s_per_min"):
        lines.append("")
        lines.append(
            "budgets (device-s/min): "
            + ", ".join(f"{a}={b}" for a, b in sorted(per_app.items()))
            + (
                f" default={budgets['default_device_s_per_min']}"
                if budgets.get("default_device_s_per_min")
                else ""
            )
        )
    return "\n".join(lines) + "\n"
