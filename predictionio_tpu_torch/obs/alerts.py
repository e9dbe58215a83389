"""Alert rules engine: the watch loop over everything the package meters.

The JAX package's ``obs/alerts.py``, with the same rules, selectors,
transitions and ``/alerts.json`` body.  The metrics families, SLO burn
rates, breaker states, drift detectors and capacity headroom are all
measurable, but every signal is pull-only: an operator must be scraping the right endpoint
at the right moment to see an SLO burn or an open breaker.  This module
turns that instrumentation into autonomous detection:

- :class:`AlertRule` — a declarative condition over one *signal selector*
  (a metric family, an SLO burn rate, a breaker state, the capacity
  headroom), with a threshold + direction, a ``for_s`` duration the
  condition must hold before firing (one noisy tick must not page), and a
  ``clear_band`` hysteresis so a value oscillating around the threshold
  doesn't flap fire/resolve;
- :class:`AlertEvaluator` — a clock-injectable daemon (the
  LifecycleController idiom: a thread around a test-drivable
  :meth:`~AlertEvaluator.tick`) running every rule against the current
  signals; each distinct label set of a selector gets its OWN
  ok → pending → firing → resolved state machine, so "breaker open" names
  *which* breaker;
- **sinks** — every firing/resolved transition goes to the structured log
  (always), plus optional webhook POSTs (bounded retry) and a file sink
  (JSON lines; what tests assert against), and to the
  :class:`~predictionio_tpu_torch.obs.incident.IncidentRecorder` which snapshots
  a forensic bundle to disk *before* the bounded rings rotate the evidence
  away;
- a built-in :func:`default_rule_pack` covering the failure modes the
  package makes detectable, extendable/replaceable via
  ``PIO_ALERT_RULES`` (inline JSON or ``@file``).

The evaluator runs entirely on the host — one pass of dict arithmetic per
tick, self-metered in ``pio_alert_eval_seconds`` — and never touches a
CUDA stream or synchronizes the device: rules read *already-collected*
state, a tick takes microseconds, and a raising sink is swallowed
(alerting must never break serving).

``GET /alerts.json`` (obs/http.py, debug-gated) serves the live state.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Mapping

from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

log = logging.getLogger("predictionio_tpu_torch.obs.alerts")

#: alert severities, mild to pager-worthy ("critical" flips `pio status`
#: --url to exit 1 when firing)
SEVERITIES = ("info", "warning", "critical")

#: instance states (the transitions counter's ``to`` label values)
OK, PENDING, FIRING = "ok", "pending", "firing"

#: numeric breaker states for threshold rules (closed < half_open < open)
_BREAKER_LEVELS = {"closed": 0.0, "half_open": 1.0, "open": 2.0}


@dataclass
class AlertRule:
    """One declarative alert condition.

    ``selector`` names the signal:

    - ``metric:<family>`` — every series of a registry family (counters and
      gauges; each label set is evaluated independently and keys its own
      alert instance).  ``rate=True`` evaluates the per-second delta
      between ticks instead of the raw value — the only useful shape for
      monotonic counters;
    - ``slo.error_burn_rate`` / ``slo.latency_burn_rate`` /
      ``slo.max_burn_rate`` — the app's SLO tracker;
    - ``breaker.state`` — every registered circuit breaker
      (closed=0, half-open=1, open=2), keyed by endpoint;
    - ``capacity.headroom_frac`` — the capacity model's headroom (absent
      until the model has a computable ceiling, so a cold process can't
      false-fire a "no headroom" alert);
    - ``costs.burn_vs_budget`` / ``costs.device_share`` — the app's cost
      ledger (obs/costs.py), keyed per app: device-seconds/min over the
      configured budget, and each app's fraction of attributed device
      time (silent below two active apps).

    ``labels`` filters metric selectors to series whose labels contain the
    given items.  The condition is ``value > threshold`` (direction
    "above") or ``value < threshold`` ("below"); once firing, it resolves
    only when the value crosses back past ``threshold ∓ clear_band`` — the
    hysteresis half of the flap protection (``for_s`` is the other half).
    """

    name: str
    selector: str
    threshold: float
    direction: str = "above"
    for_s: float = 0.0
    clear_band: float = 0.0
    severity: str = "warning"
    rate: bool = False
    labels: dict[str, str] = field(default_factory=dict)
    description: str = ""

    def __post_init__(self):
        if self.direction not in ("above", "below"):
            raise ValueError(
                f"rule {self.name!r}: direction must be above|below"
            )
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"rule {self.name!r}: severity must be one of {SEVERITIES}"
            )
        if self.clear_band < 0 or self.for_s < 0:
            raise ValueError(
                f"rule {self.name!r}: for_s/clear_band must be >= 0"
            )

    def breached(self, value: float) -> bool:
        if self.direction == "above":
            return value > self.threshold
        return value < self.threshold

    def cleared(self, value: float) -> bool:
        """The hysteresis exit: the value must cross the clear band, not
        merely dip back across the threshold."""
        if self.direction == "above":
            return value <= self.threshold - self.clear_band
        return value >= self.threshold + self.clear_band

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "selector": self.selector,
            "threshold": self.threshold,
            "direction": self.direction,
            "for_s": self.for_s,
            "clear_band": self.clear_band,
            "severity": self.severity,
            "rate": self.rate,
            "labels": dict(self.labels),
            "description": self.description,
        }


def default_rule_pack() -> list[AlertRule]:
    """The built-in pack: one rule per failure mode the package makes
    detectable.  Thresholds follow each subsystem's own semantics (burn
    rate 1.0 = budget burning exactly as fast as it accrues, drift state
    2 = 'drifting' past patience + hysteresis, headroom 0.1 = the capacity
    model's last 10%); ``for_s`` defaults lean conservative — two default
    ticks — because a page that resolves itself before a human looks is
    pure alarm fatigue."""
    return [
        AlertRule(
            "slo_burn", "slo.max_burn_rate", 1.0, for_s=10.0,
            clear_band=0.2, severity="critical",
            description="SLO error budget burning faster than it accrues",
        ),
        AlertRule(
            "breaker_open", "breaker.state", 1.5, for_s=0.0,
            severity="critical",
            description="a circuit breaker is OPEN: a dependency is being "
            "routed around",
        ),
        AlertRule(
            "model_drift", "metric:pio_drift_state", 1.5, for_s=0.0,
            severity="warning",
            description="a feature distribution is 'drifting' past the "
            "detector's patience",
        ),
        AlertRule(
            "recompile_storm", "metric:pio_recompile_storm_total", 0.0,
            rate=True, for_s=0.0, severity="warning",
            description="traffic is churning launch shapes; waves are "
            "paying new launch signatures",
        ),
        AlertRule(
            "shard_straggler", "metric:pio_shard_straggler_total", 0.0,
            rate=True, for_s=0.0, severity="warning",
            description="one device is persistently slowest past the skew "
            "threshold",
        ),
        AlertRule(
            "low_headroom", "capacity.headroom_frac", 0.1,
            direction="below", for_s=10.0, clear_band=0.05,
            severity="warning",
            description="capacity model reports <10% headroom to the "
            "binding ceiling",
        ),
        AlertRule(
            "factor_cache_collapse", "metric:pio_factor_cache_hit_rate",
            0.1, direction="below", for_s=30.0, clear_band=0.05,
            severity="warning",
            description="device factor-cache hit rate collapsed: repeat "
            "users are paying the host gather again",
        ),
        AlertRule(
            "queue_shed", "metric:pio_shed_total", 1.0, rate=True,
            for_s=10.0, clear_band=0.5, severity="warning",
            description="sustained load shedding: requests are being "
            "rejected at admission",
        ),
        AlertRule(
            "ingest_shed", "metric:pio_shed_total", 0.5, rate=True,
            for_s=10.0, clear_band=0.3, severity="warning",
            labels={"reason": "eventstore"},
            description="event ingest is shedding 503s: the event-store "
            "write queue is saturated (compaction backlog or a slow/"
            "degraded storage daemon)",
        ),
        AlertRule(
            "cost_burn", "costs.burn_vs_budget", 1.0, for_s=10.0,
            clear_band=0.2, severity="warning",
            description="an app is burning device-seconds faster than its "
            "configured budget (PIO_COST_BUDGETS) accrues",
        ),
        AlertRule(
            "cost_skew", "costs.device_share", 0.75, for_s=10.0,
            clear_band=0.1, severity="warning",
            description="one app is consuming >75% of this process's "
            "attributed device time: a noisy tenant is starving the rest",
        ),
        AlertRule(
            "freshness_lag",
            "metric:pio_event_visibility_lag_p99_seconds", 60.0,
            for_s=15.0, clear_band=10.0, severity="warning",
            description="event-ack to scan-visible (compaction fold) p99 "
            "lag is over a minute: the freshness SLO input is degrading "
            "(compaction stalled or backlogged)",
        ),
        AlertRule(
            "tenant_quota_shed_rate", "metric:pio_tenant_shed_total", 1.0,
            rate=True, for_s=10.0, clear_band=0.5, severity="warning",
            labels={"reason": "tenant_quota"},
            description="a tenant is being shed at its quota gate faster "
            "than 1 req/s sustained: a noisy neighbor is flooding (each "
            "firing instance carries the offending app label)",
        ),
        AlertRule(
            "tenant_hbm_overcommit",
            "metric:pio_tenant_hbm_refused_total", 0.0, rate=True,
            for_s=0.0, severity="warning",
            description="the device-memory bin-packer refused a tenant "
            "residency "
            "admission: the replica's device-memory budget is overcommitted "
            "(the firing instance's app label names the refused tenant)",
        ),
    ]


def rules_from_env(
    env: Mapping[str, str] | None = None,
) -> list[AlertRule] | None:
    """Custom rules from ``PIO_ALERT_RULES`` (inline JSON array or
    ``@/path/to/rules.json``); None when unset.  A malformed plan raises —
    silently dropping an operator's alert rules would fake a quiet fleet.
    ``PIO_ALERT_DEFAULT_PACK=0`` drops the built-in pack (custom rules
    otherwise extend it)."""
    e = env if env is not None else os.environ
    raw = e.get("PIO_ALERT_RULES")
    if not raw:
        return None
    if raw.startswith("@"):
        with open(raw[1:], "r", encoding="utf-8") as f:
            raw = f.read()
    plan = json.loads(raw)
    if not isinstance(plan, list):
        raise ValueError("PIO_ALERT_RULES must be a JSON array of rules")
    return [AlertRule(**r) for r in plan]


def resolve_rules(env: Mapping[str, str] | None = None) -> list[AlertRule]:
    """The rule set a server starts with: the default pack (unless
    ``PIO_ALERT_DEFAULT_PACK`` disables it) plus any env/file rules."""
    e = env if env is not None else os.environ
    rules: list[AlertRule] = []
    if e.get("PIO_ALERT_DEFAULT_PACK", "1").lower() not in (
        "0", "off", "false", "no",
    ):
        rules.extend(default_rule_pack())
    extra = rules_from_env(e)
    if extra:
        have = {r.name for r in rules}
        for r in extra:
            if r.name in have:  # same-named env rule overrides the pack's
                rules = [p for p in rules if p.name != r.name]
            rules.append(r)
    return rules


# ---------------------------------------------------------------------------
# sinks


def log_sink(event: Mapping[str, Any]) -> None:
    """The always-on sink: one structured log line per transition."""
    level = (
        logging.WARNING if event.get("event") == FIRING else logging.INFO
    )
    log.log(
        level,
        "alert %s %s (rule=%s key=%s value=%s severity=%s)",
        event.get("event"),
        event.get("rule"),
        event.get("rule"),
        event.get("key"),
        event.get("value"),
        event.get("severity"),
        extra={"alert": dict(event)},
    )


class FileSink:
    """Append transitions as JSON lines — the test-friendly sink, and a
    poor-man's durable alert log for air-gapped deploys."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def __call__(self, event: Mapping[str, Any]) -> None:
        line = json.dumps(dict(event), sort_keys=True, default=str)
        with self._lock:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(line + "\n")


class WebhookSink:
    """POST each transition to a webhook URL with bounded retry.  Failures
    are counted and logged, never raised — a dead webhook endpoint must not
    take the evaluator (or worse, a request thread) down with it."""

    def __init__(
        self,
        url: str,
        retries: int = 2,
        timeout_s: float = 3.0,
        backoff_s: float = 0.2,
        registry: MetricsRegistry | None = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.url = url
        self.retries = max(int(retries), 0)
        self.timeout_s = timeout_s
        self.backoff_s = backoff_s
        self._sleep = sleep
        reg = registry or REGISTRY
        self._m_errors = reg.counter(
            "pio_alerts_sink_errors_total",
            "Alert sink deliveries that exhausted their retries",
            labelnames=("sink",),
        )

    def __call__(self, event: Mapping[str, Any]) -> None:
        import urllib.request

        body = json.dumps(dict(event), default=str).encode("utf-8")
        req = urllib.request.Request(
            self.url,
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        last: Exception | None = None
        for attempt in range(self.retries + 1):
            try:
                with urllib.request.urlopen(
                    req, timeout=self.timeout_s
                ) as r:
                    r.read()
                return
            except Exception as e:  # refused / timeout / HTTP error
                last = e
                if attempt < self.retries:
                    self._sleep(self.backoff_s * (attempt + 1))
        self._m_errors.labels("webhook").inc()
        log.warning("alert webhook %s failed: %s", self.url, last)


# ---------------------------------------------------------------------------
# the evaluator


class _Instance:
    """Per-(rule, key) state-machine record; guarded by the evaluator's
    lock."""

    __slots__ = ("state", "since", "fired_at", "value", "seen_tick")

    def __init__(self):
        self.state = OK
        self.since: float | None = None  # condition first true (monotonic)
        self.fired_at: float | None = None  # wall clock, for display
        self.value: float | None = None
        self.seen_tick = 0


class AlertEvaluator:
    """Evaluate :class:`AlertRule` s on a clock-injectable cadence.

    ``app`` (optional) supplies the non-registry signals the same way the
    capacity model reads them: ``app.slo``, ``app.quality`` (its drift
    gauges are refreshed at tick start so ``metric:pio_drift_state`` is
    current), ``app.admission`` / ``app.microbatcher`` for the capacity
    join.  ``incidents`` (an
    :class:`~predictionio_tpu_torch.obs.incident.IncidentRecorder`) gets a
    forensic-bundle callback on every firing transition.

    ``start()`` runs the daemon thread; tests drive :meth:`tick` with a
    frozen clock (the LifecycleController idiom).
    """

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        rules: Iterable[AlertRule] | None = None,
        app: Any = None,
        interval_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        sinks: Iterable[Callable[[Mapping[str, Any]], None]] | None = None,
        incidents: Any = None,
        max_events: int = 256,
    ):
        self.registry = registry or REGISTRY
        self.rules = list(rules) if rules is not None else resolve_rules()
        self.app = app
        self.interval_s = float(interval_s)
        self._clock = clock
        self.sinks: list[Callable[[Mapping[str, Any]], None]] = [log_sink]
        if sinks:
            self.sinks.extend(sinks)
        self.incidents = incidents
        self._lock = threading.Lock()
        self._instances: dict[tuple[str, str], _Instance] = {}
        #: previous counter sightings for rate selectors, keyed PER RULE:
        #: (rule, family, labelvalues) -> (value, monotonic_ts) — two rate
        #: rules watching the same family must not share bookkeeping (the
        #: first would zero the second's delta every tick)
        self._prev_counts: dict[
            tuple[str, str, tuple[str, ...]], tuple[float, float]
        ] = {}
        self._events: deque[dict[str, Any]] = deque(maxlen=max_events)
        self._ticks = 0
        self._tick_seconds = 0.0
        self._last_tick_wall: float | None = None
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()
        self._stopping = False
        reg = self.registry
        self._m_firing = reg.gauge(
            "pio_alerts_firing",
            "Currently-firing alert instances per rule",
            labelnames=("rule",),
        )
        self._m_transitions = reg.counter(
            "pio_alerts_transitions_total",
            "Alert state transitions, by rule and destination state",
            labelnames=("rule", "to"),
        )
        self._m_eval = reg.histogram(
            "pio_alert_eval_seconds",
            "Wall time of one evaluator tick (the watch loop's own cost)",
        )

    # -- signal resolution ---------------------------------------------------

    def _metric_values(
        self, rule: AlertRule, now: float
    ) -> dict[str, float]:
        fam = self.registry.get(rule.selector[len("metric:"):])
        if fam is None or fam.kind == "histogram":
            return {}
        want = rule.labels
        out: dict[str, float] = {}
        for lv, child in fam.series():
            if want:
                have = dict(zip(fam.labelnames, lv))
                if any(have.get(k) != v for k, v in want.items()):
                    continue
            key = ",".join(
                f"{n}={v}" for n, v in zip(fam.labelnames, lv)
            )
            value = float(child.value)
            if rule.rate:
                pkey = (rule.name, fam.name, lv)
                prev = self._prev_counts.get(pkey)
                self._prev_counts[pkey] = (value, now)
                if prev is None or now <= prev[1]:
                    continue  # first sighting: no rate yet
                out[key] = max(value - prev[0], 0.0) / (now - prev[1])
            else:
                out[key] = value
        return out

    def _signal_values(
        self, rule: AlertRule, now: float, slo_snap: dict | None
    ) -> dict[str, float]:
        """(instance key -> current value) for one rule; an empty dict
        means the signal has nothing to say (no series yet, no SLO
        tracker), which reads as condition-false."""
        sel = rule.selector
        if sel.startswith("metric:"):
            return self._metric_values(rule, now)
        if sel.startswith("slo."):
            if not slo_snap:
                return {}
            if sel == "slo.max_burn_rate":
                return {
                    "": max(
                        slo_snap.get("error_burn_rate", 0.0),
                        slo_snap.get("latency_burn_rate", 0.0),
                    )
                }
            field_name = sel[len("slo."):]
            v = slo_snap.get(field_name)
            return {"": float(v)} if isinstance(v, (int, float)) else {}
        if sel == "breaker.state":
            from predictionio_tpu_torch.resilience.breaker import breaker_states

            return {
                name: _BREAKER_LEVELS.get(snap.get("state"), 0.0)
                for name, snap in breaker_states().items()
            }
        if sel == "capacity.headroom_frac":
            from predictionio_tpu_torch.obs.capacity import capacity_snapshot

            v = capacity_snapshot(self.app, self.registry).get(
                "headroom_frac"
            )
            return {"": float(v)} if isinstance(v, (int, float)) else {}
        if sel.startswith("costs."):
            # per-app signals from the cost ledger: each app keys its own
            # alert instance, so "cost_skew" names WHICH tenant is noisy
            ledger = getattr(self.app, "costs", None)
            if ledger is None:
                return {}
            try:
                return {
                    f"app={a}": float(v)
                    for a, v in ledger.signal(sel[len("costs."):]).items()
                }
            except Exception:
                log.exception(
                    "alert rule %s: cost signal %s failed", rule.name, sel
                )
                return {}
        log.warning("alert rule %s: unknown selector %s", rule.name, sel)
        return {}

    # -- the state machine ---------------------------------------------------

    def _emit(self, event: dict[str, Any]) -> None:
        with self._lock:
            self._events.append(event)
        for sink in self.sinks:
            try:
                sink(event)
            except Exception:
                log.exception("alert sink failed")
        if event.get("event") == FIRING and self.incidents is not None:
            try:
                self.incidents.record(event, app=self.app)
            except Exception:
                log.exception("incident recording failed")

    def _transition(
        self,
        rule: AlertRule,
        key: str,
        to: str,
        value: float | None,
        now_wall: float,
        loud: bool = True,
    ) -> None:
        """Count + record one transition.  ``loud`` transitions (firing,
        and resolving FROM firing) go to every sink; quiet ones (pending,
        and a pending that clears without ever firing) stay in the event
        ring + debug log — webhook noise for a blip that never paged is
        exactly the alarm fatigue for_s exists to prevent."""
        self._m_transitions.labels(rule.name, to).inc()
        event = {
            "event": to if to != OK else "resolved",
            "rule": rule.name,
            "key": key,
            "value": value,
            "threshold": rule.threshold,
            "direction": rule.direction,
            "severity": rule.severity,
            "description": rule.description,
            "at": round(now_wall, 3),
        }
        if loud and to == FIRING or (loud and event["event"] == "resolved"):
            self._emit(event)
        else:
            with self._lock:
                self._events.append(event)
            log.info(
                "alert %s: %s %s value=%s",
                event["event"], rule.name, key, value,
            )

    def _freeze_rule(self, rule: AlertRule, tick_n: int) -> None:
        """Mark a rule's instances seen-this-tick without evaluating them:
        a transient signal-read failure keeps every state exactly where it
        was (no spurious resolves, no re-fires, no duplicate bundles)."""
        with self._lock:
            for (rname, _key), inst in self._instances.items():
                if rname == rule.name:
                    inst.seen_tick = tick_n

    def tick(self) -> dict[str, int]:
        """One evaluation pass; returns {state: count} over all instances.
        Never raises — the watch loop must outlive any one bad signal."""
        t0 = time.perf_counter()
        now = self._clock()
        now_wall = time.time()
        q = getattr(self.app, "quality", None) if self.app is not None else None
        if q is not None:
            try:
                # freshen pio_drift_state{...} so the metric selector reads
                # current detector states, not the last scrape's
                q.refresh_gauges()
            except Exception:
                pass
        slo = getattr(self.app, "slo", None) if self.app is not None else None
        slo_snap = None
        slo_failed = False
        if slo is not None:
            try:
                slo_snap = slo.snapshot()
            except Exception:
                # a tracker that EXISTS but failed to read is a transient,
                # not a missing signal: its rules must freeze, not resolve
                slo_failed = True
        firing_per_rule: dict[str, int] = {}
        counts = {OK: 0, PENDING: 0, FIRING: 0}
        with self._lock:
            self._ticks += 1
            tick_n = self._ticks
        for rule in self.rules:
            if slo_failed and rule.selector.startswith("slo."):
                self._freeze_rule(rule, tick_n)
                continue
            try:
                values = self._signal_values(rule, now, slo_snap)
            except Exception:
                # a transient read failure must FREEZE the rule's
                # instances for this tick — treating it as "signal
                # vanished" would loudly resolve a firing alert only to
                # re-fire (and re-bundle) it next tick
                log.exception("alert rule %s evaluation failed", rule.name)
                self._freeze_rule(rule, tick_n)
                continue
            for key, value in values.items():
                ikey = (rule.name, key)
                with self._lock:
                    inst = self._instances.get(ikey)
                    if inst is None:
                        inst = self._instances[ikey] = _Instance()
                inst.seen_tick = tick_n
                inst.value = value
                breached = rule.breached(value)
                if inst.state == OK:
                    if breached:
                        inst.state = PENDING
                        inst.since = now
                        self._transition(
                            rule, key, PENDING, value, now_wall, loud=False
                        )
                if inst.state == PENDING:
                    if not breached:
                        inst.state = OK
                        inst.since = None
                        self._transition(
                            rule, key, OK, value, now_wall, loud=False
                        )
                    elif now - (inst.since or now) >= rule.for_s:
                        inst.state = FIRING
                        inst.fired_at = now_wall
                        self._transition(rule, key, FIRING, value, now_wall)
                elif inst.state == FIRING and rule.cleared(value):
                    inst.state = OK
                    inst.since = None
                    inst.fired_at = None
                    self._transition(rule, key, OK, value, now_wall)
            # instances whose signal vanished (breaker registry reset, a
            # series gone): a firing alert with no evidence left resolves,
            # and the instance record is DELETED — parking it would grow
            # the table without bound under label churn (a fleet's
            # replica:<host:port> breakers over weeks of autoscaling)
            with self._lock:
                stale = [
                    (k, i)
                    for k, i in self._instances.items()
                    if k[0] == rule.name and i.seen_tick != tick_n
                ]
            for (rname, key), inst in stale:
                if inst.state == FIRING:
                    self._transition(rule, key, OK, None, now_wall)
                with self._lock:
                    self._instances.pop((rname, key), None)
        # rate bookkeeping for series not seen this tick ages out with
        # them (tick-thread-only state, like the writes in
        # _metric_values; a pruned live series costs one first-sighting
        # skip on recovery)
        self._prev_counts = {
            k: v for k, v in self._prev_counts.items() if v[1] == now
        }
        with self._lock:
            for (rname, _key), inst in self._instances.items():
                counts[inst.state] = counts.get(inst.state, 0) + 1
                if inst.state == FIRING:
                    firing_per_rule[rname] = firing_per_rule.get(rname, 0) + 1
        for rule in self.rules:
            self._m_firing.labels(rule.name).set(
                firing_per_rule.get(rule.name, 0)
            )
        dt = time.perf_counter() - t0
        self._m_eval.observe(dt)
        with self._lock:
            self._tick_seconds += dt
            self._last_tick_wall = now_wall
        return counts

    # -- synthetic events ----------------------------------------------------

    def note_event(
        self,
        name: str,
        message: str,
        severity: str = "info",
        key: str = "",
        **detail: Any,
    ) -> None:
        """Record an out-of-band event as a synthetic already-resolved
        alert (the autoscaler's scale actions use this): it lands in the
        event ring, the transitions counter, and every sink, so incident
        timelines explain capacity changes — but it never fires, never
        snapshots an incident, and holds no instance state."""
        self._m_transitions.labels(name, "resolved").inc()
        event = {
            "event": "resolved",
            "synthetic": True,
            "rule": name,
            "key": key,
            "severity": severity,
            "description": message,
            "at": round(time.time(), 3),
            **detail,
        }
        with self._lock:
            self._events.append(event)
        for sink in self.sinks:
            try:
                sink(event)
            except Exception:
                log.exception("alert sink failed")

    # -- exposition ----------------------------------------------------------

    def firing(self) -> list[dict[str, Any]]:
        return [a for a in self.active() if a["state"] == FIRING]

    def active(self) -> list[dict[str, Any]]:
        """Every non-ok instance, firing first, oldest first within state."""
        by_rule = {r.name: r for r in self.rules}
        now = self._clock()
        rows: list[dict[str, Any]] = []
        with self._lock:
            items = list(self._instances.items())
        for (rname, key), inst in items:
            if inst.state == OK:
                continue
            rule = by_rule.get(rname)
            rows.append(
                {
                    "rule": rname,
                    "key": key,
                    "state": inst.state,
                    "severity": rule.severity if rule else "warning",
                    "value": inst.value,
                    "threshold": rule.threshold if rule else None,
                    "for_s": rule.for_s if rule else None,
                    "age_s": round(
                        max(now - inst.since, 0.0), 3
                    ) if inst.since is not None else None,
                    "fired_at": inst.fired_at,
                    "description": rule.description if rule else "",
                }
            )
        rows.sort(
            key=lambda a: (
                0 if a["state"] == FIRING else 1,
                -(a["age_s"] or 0.0),
            )
        )
        return rows

    def recent_events(self, limit: int = 50) -> list[dict[str, Any]]:
        with self._lock:
            events = list(self._events)
        return events[::-1][: max(limit, 0)]

    def snapshot(self) -> dict[str, Any]:
        """The ``/alerts.json`` body."""
        active = self.active()
        with self._lock:
            ticks = self._ticks
            tick_seconds = self._tick_seconds
            last = self._last_tick_wall
        return {
            "alerts": active,
            "firing": sum(1 for a in active if a["state"] == FIRING),
            "pending": sum(1 for a in active if a["state"] == PENDING),
            "recent": self.recent_events(),
            "rules": [r.to_dict() for r in self.rules],
            "ticks": ticks,
            "eval_seconds_total": round(tick_seconds, 6),
            "interval_s": self.interval_s,
            "last_tick_at": last,
            "running": self._thread is not None,
        }

    # -- the loop ------------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._stopping = False
            self._thread = threading.Thread(
                target=self._run, name="pio-alert-evaluator", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        with self._lock:
            self._stopping = True
            thread = self._thread
            self._thread = None
        self._wake.set()
        if thread is not None:
            thread.join(timeout=5.0)

    def _run(self) -> None:
        while True:
            with self._lock:
                if self._stopping:
                    return
            try:
                self.tick()
            except Exception:
                log.exception("alert evaluator tick failed")
            self._wake.wait(self.interval_s)
            self._wake.clear()


def render_alerts_text(snap: Mapping[str, Any]) -> str:
    """Human one-screen rendering of an /alerts.json body (pio alerts)."""
    lines = [
        f"alerts: {snap.get('firing', 0)} firing, "
        f"{snap.get('pending', 0)} pending "
        f"({len(snap.get('rules', []))} rules, "
        f"{snap.get('ticks', 0)} ticks)"
    ]
    for a in snap.get("alerts", []):
        age = a.get("age_s")
        lines.append(
            f"  [{a.get('state', '?').upper():>7}] {a.get('rule')}"
            + (f"{{{a['key']}}}" if a.get("key") else "")
            + f" value={a.get('value')} threshold={a.get('threshold')}"
            + (f" age={age:.0f}s" if isinstance(age, (int, float)) else "")
            + f" severity={a.get('severity')}"
        )
    recent = snap.get("recent", [])[:8]
    if recent:
        lines.append("recent transitions (newest first):")
        for e in recent:
            lines.append(
                f"  {e.get('event'):>8} {e.get('rule')}"
                + (f"{{{e['key']}}}" if e.get("key") else "")
                + (" [synthetic]" if e.get("synthetic") else "")
            )
    # a federated body (a fleet router's) rides per-replica rows along
    for rid, info in sorted((snap.get("replicas") or {}).items()):
        if info is None:
            lines.append(f"replica {rid}: (no alerts scrape)")
        else:
            lines.append(
                f"replica {rid}: {info.get('firing', 0)} firing, "
                f"{info.get('pending', 0)} pending"
            )
    for err in snap.get("source_errors", []):
        lines.append(f"source error: {err}")
    return "\n".join(lines)
