"""Online model-quality observability: prediction logging, feedback joins,
and drift detection.

The JAX package's ``obs/quality.py``, whole: the same sketches, statistics,
state machine, joins, metric names and ``/quality.json`` body, so the same
prediction and feedback stream gives the same snapshot in either package.

The infrastructure half of observability (metrics, spans, flight recorder,
SLO) can say *p99 moved* and *which request moved it* — this module answers
whether the **model** is still any good, online, without waiting for the
offline ``pio eval`` loop:

- :class:`PredictionLog` — a bounded, O(1)-append ring the prediction
  server feeds per request/wave with ``(request_id, engine variant,
  query-feature summary, prediction summary: top-k ids + scores,
  timestamp)``; safe under heavy traffic because memory is capped and the
  hot-path cost is a few dict writes under one lock.
- :class:`QualityMonitor` (the feedback-joiner role) — the event server
  recognizes feedback events (configurable names) and joins them back to
  logged predictions on the ``X-Pio-Request-Id`` echoed by clients (or the
  ``prId`` API field, or entity id within a join window), producing rolling
  **online metrics per engine variant** — CTR, hit rate, precision@k,
  rating MAE — computed through the same :mod:`predictionio_tpu_torch.core.metric`
  reducers the offline evaluator uses, so online and offline numbers are
  comparable.
- :class:`DriftDetector` — rolling reference-vs-current windows over
  query-feature and prediction-score distributions using fixed-bin
  :class:`HistogramSketch` histograms compared with PSI and KS statistics,
  exported as ``pio_drift_*`` gauges and an alert state machine
  (ok → warning → drifting) with hysteresis + patience so the state cannot
  flap on a single noisy window (and never flaps per scrape — evaluation
  happens only when a window completes).

Surfaces: ``GET /quality.json`` (obs/http.py, gated like the other debug
routes) and ``quality [--url]`` of the port's CLI.
Everything is stdlib-only and never touches a device.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from collections import deque
from typing import Any, Mapping

from predictionio_tpu_torch.core.metric import OptionAverageMetric
from predictionio_tpu_torch.obs.contention import ContendedLock
from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

log = logging.getLogger("predictionio_tpu_torch.quality")

#: drift alert states (gauge values for ``pio_drift_state``)
OK, WARNING, DRIFTING = 0, 1, 2
STATE_NAMES = ("ok", "warning", "drifting")

#: PSI thresholds (industry convention: <0.1 stable, 0.1–0.25 shifting,
#: >0.25 drifted) and KS-statistic thresholds for binned distributions
PSI_WARN, PSI_DRIFT = 0.10, 0.25
KS_WARN, KS_DRIFT = 0.15, 0.30

#: hysteresis: leaving an elevated state requires the statistic to fall
#: below ``enter_threshold * EXIT_RATIO``, so values straddling a threshold
#: cannot flap the state every window
EXIT_RATIO = 0.8

#: event names treated as feedback when not configured explicitly
DEFAULT_FEEDBACK_EVENTS = ("rate", "buy", "click", "like", "view", "conversion")

#: query payload fields probed (in order) for the joinable entity id
DEFAULT_ENTITY_FIELDS = ("user", "userId", "user_id", "entityId")

#: cap on numeric query features sketched per request (cardinality guard)
_MAX_QUERY_FEATURES = 8

#: minimum seconds between per-variant online-metric gauge recomputations:
#: recomputing on EVERY feedback event would scan the whole join window
#: (metrics_window records x all reducers) under the monitor lock the
#: serving hot path contends on — at high ingest rates that stalls
#: observe_prediction (and, under the asyncio front end, the event loop)
_GAUGE_INTERVAL_S = 1.0


def _now() -> float:
    """Wall clock for record/join timestamps — module-level so tests can
    freeze it."""
    return time.time()


# ---------------------------------------------------------------------------
# histogram sketch + divergence statistics
# ---------------------------------------------------------------------------


class HistogramSketch:
    """Fixed-bin histogram over ``[lo, hi)`` with underflow/overflow slots.

    ``update`` is O(1) — one multiply and one list increment, no bisect —
    which is what lets the serving hot path sketch every query feature and
    prediction score.  Two sketches with identical bounds compare bin-wise
    (:func:`psi_statistic` / :func:`ks_statistic`); out-of-range values land
    in the under/overflow slots, which is exactly what catches a covariate
    shift that leaves the reference range entirely.
    """

    __slots__ = ("lo", "hi", "n_bins", "_inv_width", "counts", "total")

    def __init__(self, lo: float, hi: float, n_bins: int = 32):
        if not hi > lo:
            raise ValueError(f"sketch range must be non-empty: [{lo}, {hi})")
        if n_bins < 1:
            raise ValueError("n_bins must be >= 1")
        self.lo = float(lo)
        self.hi = float(hi)
        self.n_bins = n_bins
        self._inv_width = n_bins / (self.hi - self.lo)
        #: counts[0] = underflow, counts[1..n_bins] = bins, counts[-1] = overflow
        self.counts = [0] * (n_bins + 2)
        self.total = 0

    def update(self, value: float) -> None:
        if value < self.lo:
            idx = 0
        elif value >= self.hi:
            idx = self.n_bins + 1
        else:
            # min() guards the float-rounding edge where (value - lo) *
            # inv_width lands exactly on n_bins despite value < hi
            idx = 1 + min(int((value - self.lo) * self._inv_width), self.n_bins - 1)
        self.counts[idx] += 1
        self.total += 1

    def probabilities(self, alpha: float = 0.0) -> list[float]:
        """Bin probabilities; ``alpha`` applies Laplace (add-alpha)
        smoothing, which bounds the log-ratio an empty bin can contribute
        to PSI — an epsilon floor instead lets one unlucky empty bin
        contribute ~``p*ln(p/eps)`` and makes small windows false-alert."""
        t = self.total + alpha * len(self.counts)
        if t <= 0:
            t = 1.0
        return [(c + alpha) / t for c in self.counts]


def psi_statistic(
    ref: HistogramSketch, cur: HistogramSketch, alpha: float = 0.5
) -> float:
    """Population Stability Index between two same-bounds sketches:
    ``sum((q_i - p_i) * ln(q_i / p_i))`` over Laplace-smoothed bin
    probabilities.  With the default 10 bins and 256-observation windows,
    sampling noise on identical distributions stays under ~0.1 (the warning
    threshold) at the 99th percentile, while a 1.5-sigma mean shift scores
    ~2 — a 20x separation."""
    total = 0.0
    for p, q in zip(ref.probabilities(alpha), cur.probabilities(alpha)):
        total += (q - p) * math.log(q / p)
    return total


def ks_statistic(ref: HistogramSketch, cur: HistogramSketch) -> float:
    """Kolmogorov–Smirnov statistic over the binned CDFs: the maximum
    absolute CDF gap, in [0, 1]."""
    cp = cq = 0.0
    d = 0.0
    for p, q in zip(ref.probabilities(), cur.probabilities()):
        cp += p
        cq += q
        gap = abs(cp - cq)
        if gap > d:
            d = gap
    return d


# ---------------------------------------------------------------------------
# drift detection
# ---------------------------------------------------------------------------


class DriftDetector:
    """Reference-vs-current drift watch for ONE distribution.

    The first ``window`` observations seed the frozen **reference** sketch
    (bin bounds derived from their min/max with 25% headroom so legitimate
    wobble stays in-range).  Every subsequent observation feeds the
    **current** sketch; when it holds ``window`` observations it is compared
    to the reference (PSI + KS), the alert state machine steps, and the
    current sketch resets — so evaluation happens once per completed window,
    never per scrape.

    State machine: ok → warning → drifting.  A state change requires the
    classified level to persist for ``patience`` consecutive windows, and
    leaving an elevated state additionally requires the statistic to drop
    below ``threshold * EXIT_RATIO`` (hysteresis) — one noisy window can
    never flip the state, and a value straddling a threshold cannot flap it.

    Not thread-safe on its own; :class:`QualityMonitor` serializes access.
    """

    __slots__ = (
        "name", "window", "n_bins", "psi_warn", "psi_drift", "ks_warn",
        "ks_drift", "patience", "psi_floor", "ks_floor", "state", "windows",
        "transitions", "last_psi", "last_ks", "reference", "current",
        "_seed", "_pending_level", "_pending_count",
    )

    def __init__(
        self,
        name: str,
        window: int = 256,
        n_bins: int = 10,
        psi_warn: float = PSI_WARN,
        psi_drift: float = PSI_DRIFT,
        ks_warn: float = KS_WARN,
        ks_drift: float = KS_DRIFT,
        patience: int = 2,
    ):
        if window < 2:
            raise ValueError("window must be >= 2")
        self.name = name
        self.window = window
        self.n_bins = n_bins
        self.psi_warn, self.psi_drift = psi_warn, psi_drift
        self.ks_warn, self.ks_drift = ks_warn, ks_drift
        self.patience = max(patience, 1)
        # Sampling-noise floors, added to every threshold: ~99th percentile
        # of PSI/KS between two SAME-distribution windows of this size
        # (PSI noise is chi-square-like, ~2.5(K-1)/N over K-1 bin degrees of
        # freedom; KS noise ~sqrt(2/N), damped by binning).  Without the
        # floor a small window false-alerts on multinomial noise alone; a
        # real shift scores an order of magnitude above the floor, so
        # sensitivity survives.  The failure mode for very small windows is
        # the right one: not enough data -> no alert.
        self.psi_floor = 2.5 * (n_bins + 1) / window
        self.ks_floor = 1.1 * math.sqrt(2.0 / window)
        self.state = OK
        self.windows = 0          # completed comparison windows
        self.transitions = 0      # state changes since creation
        self.last_psi = 0.0
        self.last_ks = 0.0
        self.reference: HistogramSketch | None = None
        self.current: HistogramSketch | None = None
        self._seed: list[float] | None = []
        self._pending_level: int | None = None
        self._pending_count = 0

    def update(self, value: float) -> dict[str, Any] | None:
        """Feed one observation; returns the evaluation dict when this
        observation completed a comparison window, else None."""
        value = float(value)
        if not math.isfinite(value):
            # json.loads accepts NaN/Infinity literals, so one hostile query
            # could otherwise poison the seed window (NaN min/max -> sketch
            # construction raises forever, the seed list grows per request)
            # or crash the binning arithmetic post-reference
            return None
        if self.reference is None:
            self._seed.append(value)
            if len(self._seed) < self.window:
                return None
            lo, hi = min(self._seed), max(self._seed)
            pad = (hi - lo) * 0.25 or max(abs(lo), 1.0) * 0.25
            self.reference = HistogramSketch(lo - pad, hi + pad, self.n_bins)
            for v in self._seed:
                self.reference.update(v)
            self.current = HistogramSketch(lo - pad, hi + pad, self.n_bins)
            self._seed = None
            return None
        self.current.update(value)
        if self.current.total < self.window:
            return None
        return self._evaluate()

    def _level(self, psi_v: float, ks_v: float, ratio: float = 1.0) -> int:
        if (
            psi_v >= (self.psi_drift + self.psi_floor) * ratio
            or ks_v >= (self.ks_drift + self.ks_floor) * ratio
        ):
            return DRIFTING
        if (
            psi_v >= (self.psi_warn + self.psi_floor) * ratio
            or ks_v >= (self.ks_warn + self.ks_floor) * ratio
        ):
            return WARNING
        return OK

    def classify(self, psi_v: float, ks_v: float) -> int:
        """The level this window argues for, hysteresis applied: moving DOWN
        from the present state requires clearing the EXIT_RATIO band too."""
        raw = self._level(psi_v, ks_v)
        if raw < self.state and self._level(psi_v, ks_v, EXIT_RATIO) >= self.state:
            return self.state
        return raw

    def _evaluate(self) -> dict[str, Any]:
        psi_v = psi_statistic(self.reference, self.current)
        ks_v = ks_statistic(self.reference, self.current)
        self.windows += 1
        self.last_psi, self.last_ks = psi_v, ks_v
        level = self.classify(psi_v, ks_v)
        changed: tuple[int, int] | None = None
        if level == self.state:
            self._pending_level, self._pending_count = None, 0
        else:
            if level == self._pending_level:
                self._pending_count += 1
            else:
                self._pending_level, self._pending_count = level, 1
            if self._pending_count >= self.patience:
                changed = (self.state, level)
                self.state = level
                self.transitions += 1
                self._pending_level, self._pending_count = None, 0
        self.current = HistogramSketch(
            self.current.lo, self.current.hi, self.n_bins
        )
        return {
            "psi": psi_v,
            "ks": ks_v,
            "state": self.state,
            "changed": changed,
        }

    def to_dict(self) -> dict[str, Any]:
        return {
            "state": STATE_NAMES[self.state],
            "psi": round(self.last_psi, 6),
            "ks": round(self.last_ks, 6),
            "windows": self.windows,
            "transitions": self.transitions,
            "window_size": self.window,
            "ready": self.reference is not None,
            "thresholds": {
                "psi_warn": round(self.psi_warn + self.psi_floor, 6),
                "psi_drift": round(self.psi_drift + self.psi_floor, 6),
                "ks_warn": round(self.ks_warn + self.ks_floor, 6),
                "ks_drift": round(self.ks_drift + self.ks_floor, 6),
                "psi_floor": round(self.psi_floor, 6),
                "ks_floor": round(self.ks_floor, 6),
                "patience": self.patience,
                "exit_ratio": EXIT_RATIO,
            },
        }


# ---------------------------------------------------------------------------
# online metrics — the offline reducers from core.metric, fed rolling
# (query, prediction-record, actual) triples so online and offline numbers
# share calculate()/fold-data semantics
# ---------------------------------------------------------------------------


class OnlineHitRate(OptionAverageMetric):
    """Fraction of joined predictions where ANY feedback item was
    recommended in the top-k (None when the join carried no item)."""

    def __init__(self, k: int = 10):
        self.k = k

    def header(self) -> str:
        return f"OnlineHitRate@{self.k}"

    def calculate_one(self, q, p, a) -> float | None:
        if not a:
            return None
        top = p["top"][: self.k]
        return 1.0 if any(item in a for item in top) else 0.0


class OnlinePrecisionAtK(OptionAverageMetric):
    """Fraction of the top-k recommended items that received feedback —
    the same score/denominator convention as the offline ``PrecisionAtK``
    (``min(k, |relevant|)``), so the two are directly comparable."""

    def __init__(self, k: int = 10):
        self.k = k

    def header(self) -> str:
        return f"OnlinePrecision@{self.k}"

    def calculate_one(self, q, p, a) -> float | None:
        if not a:
            return None
        top = p["top"][: self.k]
        return sum(1 for item in top if item in a) / min(self.k, len(a))


class OnlineRatingMAE(OptionAverageMetric):
    """Mean absolute error between the predicted score and the feedback
    rating, over joins that carry both (None otherwise).  Smaller is
    better, so ``comparison`` is inverted like an error metric."""

    def header(self) -> str:
        return "OnlineRatingMAE"

    def calculate_one(self, q, p, a) -> float | None:
        scores: Mapping[str, float] = p["scores"]
        errs = [
            abs(scores[item] - rating)
            for item, rating in a.items()
            if rating is not None and item in scores
        ]
        return sum(errs) / len(errs) if errs else None

    def comparison(self, a: float, b: float) -> int:
        return (a < b) - (a > b)


# ---------------------------------------------------------------------------
# payload summarization (hot path — keep it allocation-light)
# ---------------------------------------------------------------------------


def summarize_query(
    payload: Any, entity_fields: tuple[str, ...] = DEFAULT_ENTITY_FIELDS
) -> tuple[dict[str, float], str | None]:
    """``(numeric feature dict, joinable entity id)`` from a query payload.

    Only numeric (non-bool) top-level fields become drift features, capped
    at ``_MAX_QUERY_FEATURES`` in sorted-key order so the tracked
    distribution set is bounded and deterministic.
    """
    features: dict[str, float] = {}
    entity: str | None = None
    # plain dict check, not typing.Mapping: JSON parsing always hands us
    # dicts, and typing's __instancecheck__ costs microseconds per call on
    # a path with a 50 µs/request budget
    if isinstance(payload, dict):
        for key in sorted(payload, key=str):
            v = payload[key]
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            features[str(key)] = float(v)
            if len(features) >= _MAX_QUERY_FEATURES:
                break
        for field in entity_fields:
            v = payload.get(field)
            if v is not None:
                entity = str(v)
                break
    return features, entity


def summarize_prediction(
    rendered: Any, k: int = 10
) -> tuple[tuple[str, ...], dict[str, float], list[float]]:
    """``(top-k item ids, item -> score, score list)`` from a rendered
    prediction.  Understands the bundled engines' shapes — ranked
    ``itemScores``/``item_scores`` lists, classification ``label`` +
    ``score``/``probability`` — and degrades to an empty summary for
    anything else (quality telemetry must never fail serving)."""
    items: list[tuple[str, float]] = []
    scores: list[float] = []
    if isinstance(rendered, dict):  # see summarize_query: dict, not Mapping
        ranked = rendered.get("itemScores")
        if ranked is None:
            ranked = rendered.get("item_scores")
        if isinstance(ranked, (list, tuple)):
            for e in ranked[:k]:
                if isinstance(e, dict) and "item" in e:
                    s = e.get("score", 0.0)
                    s = float(s) if isinstance(s, (int, float)) else 0.0
                    items.append((str(e["item"]), s))
                    scores.append(s)
        else:
            for key in ("score", "probability", "prediction", "rating"):
                v = rendered.get(key)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    scores.append(float(v))
            label = rendered.get("label")
            if label is not None:
                items.append((str(label), scores[0] if scores else 0.0))
    top = tuple(item for item, _ in items)
    return top, dict(items), scores[:k]


# ---------------------------------------------------------------------------
# the monitor: prediction log + feedback joiner + drift + online metrics
# ---------------------------------------------------------------------------


class QualityMonitor:
    """One per serving process: PredictionLog ring, feedback joiner, drift
    detectors, and the online-metric gauges.

    Thread-safe: every mutation happens under one lock; the hot-path
    ``observe_prediction`` does a few dict writes plus O(1) sketch updates
    (tests bound it at 50 µs/request).  Memory is bounded everywhere — the
    ring by ``capacity``, per-variant join windows by ``metrics_window``,
    drift distributions by ``max_distributions``, sketches by their bins.
    """

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        capacity: int = 4096,
        top_k: int = 10,
        join_window_s: float = 600.0,
        metrics_window: int = 512,
        feedback_events: tuple[str, ...] | None = None,
        entity_fields: tuple[str, ...] = DEFAULT_ENTITY_FIELDS,
        drift_window: int = 256,
        drift_patience: int = 2,
        max_distributions: int = 16,
    ):
        if feedback_events is None:
            env = os.environ.get("PIO_FEEDBACK_EVENTS", "")
            feedback_events = (
                tuple(e.strip() for e in env.split(",") if e.strip())
                if env
                else DEFAULT_FEEDBACK_EVENTS
            )
        self.capacity = max(capacity, 1)
        self.top_k = top_k
        self.join_window_s = join_window_s
        self.metrics_window = metrics_window
        self.feedback_events = frozenset(feedback_events)
        self.entity_fields = tuple(entity_fields)
        self.drift_window = drift_window
        self.drift_patience = drift_patience
        self.max_distributions = max_distributions
        reg = registry or REGISTRY
        # the serving hot path (observe_prediction, per request) and the
        # ingest path (observe_feedback, per event) contend here — metered
        # so gauge-recompute stalls become pio_lock_wait_seconds mass
        self._lock = ContendedLock("quality_monitor", registry=reg)
        self._ring: deque[dict[str, Any]] = deque()
        self._by_rid: dict[str, dict[str, Any]] = {}
        self._by_entity: dict[str, dict[str, Any]] = {}
        self._variants: dict[str, dict[str, Any]] = {}
        self._detectors: dict[str, DriftDetector] = {}
        self._m_logged = reg.counter(
            "pio_quality_predictions_total",
            "Predictions logged for online quality monitoring, by variant",
            labelnames=("variant",),
        )
        self._m_joined = reg.counter(
            "pio_quality_feedback_joined_total",
            "Feedback events joined back to a logged prediction",
            labelnames=("variant", "join"),
        )
        self._m_unjoined = reg.counter(
            "pio_quality_feedback_unjoined_total",
            "Feedback events that matched no logged prediction",
        )
        self._m_online = reg.gauge(
            "pio_online_metric",
            "Rolling online quality metrics per engine variant",
            labelnames=("variant", "metric"),
        )
        self._m_psi = reg.gauge(
            "pio_drift_psi",
            "PSI of the current window vs the reference, per distribution",
            labelnames=("distribution",),
        )
        self._m_ks = reg.gauge(
            "pio_drift_ks",
            "KS statistic of the current window vs the reference",
            labelnames=("distribution",),
        )
        self._m_state = reg.gauge(
            "pio_drift_state",
            "Drift alert state per distribution: 0 ok, 1 warning, 2 drifting",
            labelnames=("distribution",),
        )
        self._m_transitions = reg.counter(
            "pio_drift_transitions_total",
            "Drift state-machine transitions, by distribution and new state",
            labelnames=("distribution", "to"),
        )
        #: online metrics via the offline reducers (core.metric)
        self.metrics = {
            "hit_rate": OnlineHitRate(k=top_k),
            "precision_at_k": OnlinePrecisionAtK(k=top_k),
            "rating_mae": OnlineRatingMAE(),
        }

    # -- prediction side (serving hot path) ----------------------------------

    def is_feedback(self, event_name: str) -> bool:
        return event_name in self.feedback_events

    def observe_prediction(
        self,
        request_id: str | None,
        query: Any,
        prediction: Any,
        variant: str = "default",
        wave_size: int | None = None,
        wave_seq: int | None = None,
        ts: float | None = None,
    ) -> None:
        """Log one served prediction.  Never raises — quality telemetry
        must not be able to fail a query."""
        try:
            self._observe_prediction(
                request_id, query, prediction, variant, wave_size, wave_seq, ts
            )
        except Exception:  # pragma: no cover - defensive
            log.debug("observe_prediction failed", exc_info=True)

    def _observe_prediction(
        self, request_id, query, prediction, variant, wave_size, wave_seq, ts
    ) -> None:
        ts = ts if ts is not None else _now()
        features, entity = summarize_query(query, self.entity_fields)
        top, scores, score_list = summarize_prediction(prediction, self.top_k)
        rec: dict[str, Any] = {
            "request_id": request_id,
            "variant": variant,
            "ts": ts,
            "entity": entity,
            "features": features,
            "top": top,
            "scores": scores,
            "actual": {},
            "joined": False,
        }
        if wave_size is not None:
            rec["wave_size"] = wave_size
        if wave_seq is not None:
            rec["wave_seq"] = wave_seq
        with self._lock:
            self._ring.append(rec)
            if request_id:
                self._by_rid[request_id] = rec
            if entity:
                self._by_entity[entity] = rec
            while len(self._ring) > self.capacity:
                old = self._ring.popleft()
                rid = old.get("request_id")
                if rid and self._by_rid.get(rid) is old:
                    del self._by_rid[rid]
                ent = old.get("entity")
                if ent and self._by_entity.get(ent) is old:
                    del self._by_entity[ent]
            vstats = self._vstats(variant)
            vstats["predictions"] += 1
            vstats["pred_ts"].append(ts)
            for name, value in features.items():
                self._drift_update(f"feature:{name}", value)
            for s in score_list:
                self._drift_update("prediction_score", s)
        self._m_logged.labels(variant).inc()

    def _vstats(self, variant: str) -> dict[str, Any]:
        vstats = self._variants.get(variant)
        if vstats is None:
            vstats = self._variants[variant] = {
                "predictions": 0,
                "feedback": 0,
                "pred_ts": deque(maxlen=max(self.capacity, 1)),
                "joined": deque(maxlen=self.metrics_window),
                "gauges_ts": 0.0,
            }
        return vstats

    def _drift_update(self, name: str, value: float) -> None:
        det = self._detectors.get(name)
        if det is None:
            if len(self._detectors) >= self.max_distributions:
                return  # cardinality guard: ignore new distributions
            det = self._detectors[name] = DriftDetector(
                name, window=self.drift_window, patience=self.drift_patience
            )
        out = det.update(value)
        if out is None:
            return
        self._m_psi.labels(name).set(out["psi"])
        self._m_ks.labels(name).set(out["ks"])
        self._m_state.labels(name).set(out["state"])
        if out["changed"] is not None:
            old, new = out["changed"]
            self._m_transitions.labels(name, STATE_NAMES[new]).inc()
            log.warning(
                "drift state changed",
                extra={
                    "distribution": name,
                    "from": STATE_NAMES[old],
                    "to": STATE_NAMES[new],
                    "psi": round(out["psi"], 6),
                    "ks": round(out["ks"], 6),
                },
            )

    # -- feedback side (event-server ingest) ---------------------------------

    def observe_feedback(
        self,
        event: Any,
        request_id: str | None = None,
        ts: float | None = None,
        app: Any = None,
    ) -> bool:
        """Join one ingested event back to a logged prediction.  Returns
        True when joined.  Never raises.  ``app`` (the ingest call's
        authenticated app id/name) is stamped on the joined record so a
        multi-tenant quality surface can attribute — and audit — which
        tenant's feedback joined which prediction."""
        try:
            return self._observe_feedback(event, request_id, ts, app)
        except Exception:  # pragma: no cover - defensive
            log.debug("observe_feedback failed", exc_info=True)
            return False

    def _observe_feedback(self, event, request_id, ts, app=None) -> bool:
        if event.event not in self.feedback_events:
            return False
        ts = ts if ts is not None else _now()
        # candidate correlation ids, most explicit first: the header id the
        # client echoed on the ingest call (the front end MINTS one when the
        # client sent none, so a miss must fall through to the next key),
        # then the event's prId API field, then a pioRequestId property
        rids = [request_id, getattr(event, "pr_id", None)]
        props = getattr(event, "properties", None)
        if props is not None and "pioRequestId" in props:
            rids.append(str(props["pioRequestId"]))
        item = event.target_entity_id
        rating = None
        if props is not None and "rating" in props:
            raw = props["rating"]
            if isinstance(raw, (int, float)) and not isinstance(raw, bool):
                rating = float(raw)
        with self._lock:
            rec = next(
                (r for rid in rids if rid and (r := self._by_rid.get(rid))),
                None,
            )
            how = "request_id"
            if rec is None and event.entity_id:
                cand = self._by_entity.get(str(event.entity_id))
                if cand is not None and ts - cand["ts"] <= self.join_window_s:
                    rec, how = cand, "entity"
            if rec is None:
                self._m_unjoined.inc()
                return False
            if item is not None:
                rec["actual"][str(item)] = rating
            if app is not None:
                rec["app"] = app
            vstats = self._vstats(rec["variant"])
            vstats["feedback"] += 1
            if not rec["joined"]:
                rec["joined"] = True
                vstats["joined"].append(rec)
            self._m_joined.labels(rec["variant"], how).inc()
            if ts - vstats["gauges_ts"] >= _GAUGE_INTERVAL_S:
                self._set_metric_gauges(rec["variant"], vstats, ts)
        return True

    # -- metrics + snapshot --------------------------------------------------

    def _compute_metrics(
        self, vstats: dict[str, Any], now: float
    ) -> dict[str, float | None]:
        """Rolling online metrics over the joins inside the window, via the
        core.metric reducers (fold-data shaped exactly like offline eval)."""
        cutoff = now - self.join_window_s
        pred_ts = vstats["pred_ts"]
        while pred_ts and pred_ts[0] < cutoff:
            pred_ts.popleft()
        recent = [rec for rec in vstats["joined"] if rec["ts"] >= cutoff]
        out: dict[str, float | None] = {
            # never None: 0 is the freshness signal that the feedback
            # pipeline stopped delivering joins (the ratio metrics below
            # keep their last value when no joins remain to score)
            "joined_in_window": float(len(recent)),
            "ctr": len(recent) / len(pred_ts) if pred_ts else None,
        }
        fold_data = [(None, [(rec["features"], rec, rec["actual"]) for rec in recent])]
        for name, metric in self.metrics.items():
            value = metric.calculate(fold_data) if recent else float("nan")
            out[name] = None if math.isnan(value) else value
        return out

    def _set_metric_gauges(
        self, variant: str, vstats: dict[str, Any], now: float
    ) -> dict[str, float | None]:
        """Recompute + export the variant's online metrics, at most once per
        ``_GAUGE_INTERVAL_S`` (except when forced by snapshot()) — the scan
        over the join window is O(metrics_window) and runs under the lock."""
        metrics = self._compute_metrics(vstats, now)
        vstats["gauges_ts"] = now
        for name, value in metrics.items():
            if value is not None:
                self._m_online.labels(variant, name).set(value)
        return metrics

    def refresh_gauges(self) -> None:
        """Rate-limited recomputation of every variant's online-metric
        gauges — called on each /metrics scrape, so the gauges keep moving
        when feedback STOPS arriving (a decaying CTR and a zero
        joined_in_window are exactly what a feedback-pipeline outage looks
        like; without this the gauges freeze at their last joined value)."""
        now = _now()
        with self._lock:
            for variant, vstats in self._variants.items():
                if now - vstats["gauges_ts"] >= _GAUGE_INTERVAL_S:
                    self._set_metric_gauges(variant, vstats, now)

    def variant_metrics(self, variant: str) -> dict[str, float | None] | None:
        """Force-computed rolling metrics for ONE variant (None when the
        variant has logged nothing) — the lifecycle controller's read."""
        now = _now()
        with self._lock:
            vstats = self._variants.get(variant)
            if vstats is None:
                return None
            return self._compute_metrics(vstats, now)

    def compare_variants(
        self, live: str, canary: str, metric: str = "hit_rate"
    ) -> dict[str, Any]:
        """Canary-vs-live comparison on one online metric — what gates a
        canary promotion: the values, and the joined-sample counts that
        say how much evidence backs them."""
        now = _now()
        with self._lock:
            out: dict[str, Any] = {"metric": metric}
            for label, key in ((live, "live"), (canary, "canary")):
                vstats = self._variants.get(label)
                if vstats is None:
                    out[f"{key}_value"] = None
                    out[f"{key}_joined"] = 0
                    continue
                metrics = self._compute_metrics(vstats, now)
                out[f"{key}_value"] = metrics.get(metric)
                out[f"{key}_joined"] = int(
                    metrics.get("joined_in_window") or 0
                )
        return out

    def record_for(self, request_id: str) -> dict[str, Any] | None:
        """Copy of the logged prediction record for one request id (swap-
        atomicity tests assert the logged variant matches the answer)."""
        with self._lock:
            rec = self._by_rid.get(request_id)
            return dict(rec) if rec is not None else None

    def drift_state(self) -> str:
        """Worst alert state across every tracked distribution."""
        with self._lock:
            worst = max(
                (det.state for det in self._detectors.values()), default=OK
            )
        return STATE_NAMES[worst]

    def snapshot(self) -> dict[str, Any]:
        """The /quality.json body: per-variant online metrics + drift."""
        now = _now()
        with self._lock:
            variants = {}
            for variant, vstats in sorted(self._variants.items()):
                # snapshot is the forced refresh path: /quality.json (and a
                # following /metrics scrape) always see current numbers
                metrics = self._set_metric_gauges(variant, vstats, now)
                variants[variant] = {
                    "predictions": vstats["predictions"],
                    "feedback_events": vstats["feedback"],
                    "joined": len(vstats["joined"]),
                    "metrics": metrics,
                }
            worst = max(
                (det.state for det in self._detectors.values()), default=OK
            )
            drift = {
                "state": STATE_NAMES[worst],
                "distributions": {
                    name: det.to_dict()
                    for name, det in sorted(self._detectors.items())
                },
            }
            log_info = {"size": len(self._ring), "capacity": self.capacity}
        return {
            "variants": variants,
            "drift": drift,
            "log": log_info,
            "join_window_s": self.join_window_s,
            "feedback_events": sorted(self.feedback_events),
            "top_k": self.top_k,
        }


#: alias documenting the ring role the monitor plays for the serving path
PredictionLog = QualityMonitor


_default_lock = threading.Lock()
_default_monitor: QualityMonitor | None = None


def default_quality() -> QualityMonitor:
    """The process-default monitor (bound to the global REGISTRY) — what the
    prediction and event servers share in the single-VM deployment so the
    feedback loop closes in-process."""
    global _default_monitor
    with _default_lock:
        if _default_monitor is None:
            _default_monitor = QualityMonitor()
        return _default_monitor


def render_quality_text(snapshot: Mapping[str, Any]) -> str:
    """Human one-screen rendering of a /quality.json snapshot (pio quality)."""
    lines = [f"drift: {snapshot.get('drift', {}).get('state', 'ok')}"]
    for name, d in snapshot.get("drift", {}).get("distributions", {}).items():
        lines.append(
            f"  {name}: state={d['state']} psi={d['psi']} ks={d['ks']} "
            f"windows={d['windows']} transitions={d['transitions']}"
        )
    for variant, v in snapshot.get("variants", {}).items():
        metrics = " ".join(
            f"{k}={v2:.4f}" if isinstance(v2, float) else f"{k}=n/a"
            for k, v2 in v.get("metrics", {}).items()
        )
        lines.append(
            f"variant {variant}: predictions={v['predictions']} "
            f"joined={v['joined']} feedback={v['feedback_events']} {metrics}"
        )
    log_info = snapshot.get("log", {})
    lines.append(
        f"log: {log_info.get('size', 0)}/{log_info.get('capacity', 0)} "
        f"records, join window {snapshot.get('join_window_s', 0)}s"
    )
    return "\n".join(lines)
