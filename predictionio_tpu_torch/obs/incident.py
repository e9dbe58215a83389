"""Black-box incident recorder: preserve the evidence before it rotates.

The JAX package's ``obs/incident.py``.

Every debugging surface of the package is a *bounded ring* — the
flight recorder keeps 32 slow + 64 errored requests, the FragmentStore 256
traces, the MetricsHistory 60 samples per series, the SLO window 10
minutes.  By the time an operator reads an alert, the requests that caused
it have usually rotated out.  This module is the flight-data-recorder fix:
on every firing alert transition (obs/alerts.py), snapshot one **forensic
bundle** to disk — metrics + per-series history sparklines, the SLO window,
recent flight entries, the trace-fragment store, a host stack capture,
/hotpath + /capacity + breaker/lifecycle state — *at the moment of the
incident*, crash-safe (unique tmp + ``os.replace``, the RES003 idiom), and
bounded by count/age retention with per-rule rate limiting so an alert
storm cannot fill the disk.

The bundle is ONE JSON file that doubles as a disttrace fragment body
(top-level ``process``/``now``/``spans`` keys), so
``pio trace <id> --file <bundle.json>`` replays the degraded request's
cross-process waterfall offline, long after every involved daemon is gone.
``pio incident list|show|export`` (tools/cli.py) and ``GET
/incidents.json`` / ``GET /incidents/<id>.json`` (obs/http.py) are the
operator surfaces.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Callable, Mapping

from predictionio_tpu_torch.obs.disttrace import FRAGMENTS, process_label
from predictionio_tpu_torch.obs.metrics import REGISTRY, MetricsRegistry

log = logging.getLogger("predictionio_tpu_torch.obs.incident")

#: bundle schema tag (readers refuse unknown majors)
BUNDLE_FORMAT = "pio-incident-bundle/1"

#: default retention: most-recent bundles kept, older ones unlinked
DEFAULT_MAX_COUNT = 32
DEFAULT_MAX_AGE_S = 7 * 86400.0

#: default per-rule floor between bundles (an alert storm must not write
#: one bundle per tick)
DEFAULT_MIN_INTERVAL_S = 60.0


def min_interval_from_env(default: float = DEFAULT_MIN_INTERVAL_S) -> float:
    """``PIO_INCIDENT_MIN_INTERVAL_S`` — per-rule bundle cooldown in
    seconds (default 60).  A rule flapping at evaluator frequency writes at
    most one bundle per cooldown window; the rest only increment
    ``pio_incidents_suppressed_total{rule}``.  Malformed values fall back
    to the default rather than killing server startup."""
    raw = os.environ.get("PIO_INCIDENT_MIN_INTERVAL_S")
    if not raw:
        return default
    try:
        return max(float(raw), 0.0)
    except ValueError:
        return default


def default_incident_dir() -> str:
    """``PIO_INCIDENT_DIR`` or ``$PIO_HOME/incidents`` — shared by the
    serving process (writer) and a co-located dashboard (reader)."""
    explicit = os.environ.get("PIO_INCIDENT_DIR")
    if explicit:
        return explicit
    home = os.environ.get(
        "PIO_HOME", os.path.join(os.path.expanduser("~"), ".predictionio_tpu")
    )
    return os.path.join(home, "incidents")


class IncidentRecorder:
    """Write, retain, and list forensic bundles under one directory.

    ``app`` hands over the per-server state (slo / flight / hotpath /
    quality / lifecycle / admission) exactly like the capacity model reads
    it; everything is optional — a bundle records whatever exists and
    names what didn't in ``missing``.
    """

    def __init__(
        self,
        directory: str | None = None,
        registry: MetricsRegistry | None = None,
        app: Any = None,
        max_count: int = DEFAULT_MAX_COUNT,
        max_age_s: float = DEFAULT_MAX_AGE_S,
        min_interval_s: float | None = None,
        clock: Callable[[], float] = time.monotonic,
        fragments: Any = None,
        max_traces: int = 16,
        #: burst-capture window for the host-stack section when no
        #: continuous sampler is armed (seconds of evaluator-thread time
        #: per recorded incident)
        stack_burst_s: float = 0.25,
    ):
        self.directory = directory or default_incident_dir()
        self.registry = registry or REGISTRY
        self.app = app
        self.max_count = max(int(max_count), 1)
        self.max_age_s = float(max_age_s)
        self.min_interval_s = (
            min_interval_from_env()
            if min_interval_s is None
            else float(min_interval_s)
        )
        self.max_traces = max_traces
        self.stack_burst_s = float(stack_burst_s)
        self._clock = clock
        self._fragments = fragments if fragments is not None else FRAGMENTS
        self._lock = threading.Lock()
        self._last_by_rule: dict[str, float] = {}
        self._seq = 0
        self._m_recorded = self.registry.counter(
            "pio_incidents_recorded_total",
            "Incident bundles written to disk, by rule",
            labelnames=("rule",),
        )
        self._m_suppressed = self.registry.counter(
            "pio_incidents_suppressed_total",
            "Incident bundles skipped by the per-rule rate limit",
            labelnames=("rule",),
        )

    # -- capture -------------------------------------------------------------

    def _section(
        self,
        bundle: dict[str, Any],
        missing: list[str],
        name: str,
        fn: Callable[[], Any],
    ) -> None:
        """One best-effort bundle section: a failing snapshot names itself
        in ``missing`` instead of losing the whole bundle — partial
        evidence beats none at the exact moment things are broken."""
        try:
            value = fn()
        except Exception as e:
            missing.append(f"{name}: {type(e).__name__}: {e}")
            return
        if value is None:
            missing.append(name)
        else:
            bundle[name] = value

    def capture(
        self, event: Mapping[str, Any], app: Any = None
    ) -> dict[str, Any]:
        """Build one bundle dict (no disk I/O) for an alert event."""
        app = app if app is not None else self.app
        with self._lock:
            self._seq += 1
            seq = self._seq
        rule = str(event.get("rule") or "manual")
        stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        incident_id = f"inc-{stamp}-{_slug(rule)}-{seq:03d}-{os.getpid()}"
        missing: list[str] = []
        # the fragment store FIRST: it is the fastest-rotating ring, and
        # the trace of the triggering request is the bundle's whole point
        trace_ids = list(self._fragments.trace_ids())[: self.max_traces]
        spans: list[dict[str, Any]] = []
        for tid in trace_ids:
            spans.extend(self._fragments.fragments(tid))
        # a per-tenant alert instance keys as "app=name[,...]": surface the
        # offending tenant as a first-class field so incident triage (and
        # `pio incidents`) names the neighbor without parsing keys
        tenant = None
        key = event.get("key")
        if isinstance(key, str):
            for part in key.split(","):
                if part.startswith("app="):
                    tenant = part[len("app="):]
                    break
        bundle: dict[str, Any] = {
            "format": BUNDLE_FORMAT,
            "id": incident_id,
            "rule": rule,
            "key": event.get("key"),
            "tenant": tenant,
            "severity": event.get("severity"),
            "value": event.get("value"),
            "at": event.get("at") or round(time.time(), 3),
            "event": dict(event),
            # fragment-body superset: `pio trace <id> --file bundle.json`
            # loads this file directly (obs/timeline.load_fragment_file)
            "process": process_label(),
            "pid": os.getpid(),
            "now": round(time.time(), 6),
            "trace_ids": trace_ids,
            "spans": spans,
        }
        self._section(
            bundle, missing, "metrics", self.registry.render_json
        )
        self._section(
            bundle,
            missing,
            "history",
            lambda: self.registry.history.snapshot(),
        )
        slo = getattr(app, "slo", None)
        self._section(
            bundle, missing, "slo",
            (lambda: slo.snapshot()) if slo is not None else lambda: None,
        )
        flight = getattr(app, "flight", None)
        self._section(
            bundle, missing, "flight",
            (lambda: flight.snapshot(limit=16))
            if flight is not None
            else lambda: None,
        )
        hotpath = getattr(app, "hotpath", None)
        self._section(
            bundle, missing, "hotpath",
            (lambda: hotpath.snapshot())
            if hotpath is not None
            else lambda: None,
        )

        def _capacity() -> Any:
            from predictionio_tpu_torch.obs.capacity import capacity_snapshot

            return capacity_snapshot(app, self.registry)

        self._section(bundle, missing, "capacity", _capacity)

        def _breakers() -> Any:
            from predictionio_tpu_torch.resilience.breaker import breaker_states

            return breaker_states() or None

        self._section(bundle, missing, "breakers", _breakers)

        def _stacks() -> Any:
            from predictionio_tpu_torch.obs.sampling import SAMPLER, StackSampler

            # an operator-armed continuous sampler has the richer
            # aggregation: snapshot it.  Otherwise take a bounded BURST
            # with a private sampler and stop it — recording one incident
            # must not leave a permanent 100 Hz profiler running in the
            # serving process (the burst blocks only the evaluator's tick
            # thread, never a request)
            if SAMPLER.running:
                return {
                    "source": "continuous",
                    "summary": SAMPLER.snapshot(),
                    "collapsed": SAMPLER.collapsed(),
                }
            burst = StackSampler(registry=self.registry)
            burst.start()
            try:
                threading.Event().wait(self.stack_burst_s)
            finally:
                burst.stop()
            return {
                "source": f"burst:{self.stack_burst_s}s",
                "summary": burst.snapshot(),
                "collapsed": burst.collapsed(),
            }

        self._section(bundle, missing, "stacks", _stacks)

        def _provenance() -> Any:
            # the breaching answers' decision records: the SLO exemplars'
            # request ids joined against the provenance ring, so the
            # bundle can say WHY those requests answered what they did
            # (and `pio replay-request --record` can re-execute them)
            prov = getattr(app, "provenance", None)
            if prov is None:
                return None
            records = []
            for ex in (bundle.get("slo") or {}).get("exemplars") or []:
                rid = ex.get("request_id")
                rec = prov.get(rid) if rid else None
                if rec is not None:
                    records.append(rec)
            return {"records": records} if records else None

        self._section(bundle, missing, "provenance", _provenance)
        lifecycle = getattr(app, "lifecycle", None)
        self._section(
            bundle, missing, "lifecycle",
            (lambda: lifecycle.snapshot())
            if lifecycle is not None
            else lambda: None,
        )
        # the exemplar: which trace `pio incident show` renders. Breach
        # exemplars first (they point AT the breaching request), then the
        # newest errored flight entry, then the newest trace at all.
        exemplar = None
        for ex in (bundle.get("slo") or {}).get("exemplars") or []:
            if ex.get("trace_id") in trace_ids:
                exemplar = ex["trace_id"]
                break
        if exemplar is None:
            for entry in (bundle.get("flight") or {}).get("errors") or []:
                if entry.get("trace_id") in trace_ids:
                    exemplar = entry["trace_id"]
                    break
        if exemplar is None and trace_ids:
            exemplar = trace_ids[0]
        bundle["exemplar_trace_id"] = exemplar
        bundle["missing"] = missing
        return bundle

    # -- persistence ---------------------------------------------------------

    def record(
        self, event: Mapping[str, Any], app: Any = None
    ) -> str | None:
        """Capture + write one bundle; returns its path, or None when the
        per-rule rate limit suppressed it.  Never raises (the evaluator
        calls this from its tick)."""
        rule = str(event.get("rule") or "manual")
        now = self._clock()
        with self._lock:
            last = self._last_by_rule.get(rule)
            if last is not None and now - last < self.min_interval_s:
                suppress = True
            else:
                self._last_by_rule[rule] = now
                suppress = False
        if suppress:
            self._m_suppressed.labels(rule).inc()
            return None
        try:
            bundle = self.capture(event, app=app)
            path = self._write(bundle)
        except Exception:
            log.exception("incident bundle write failed (rule=%s)", rule)
            return None
        self._m_recorded.labels(rule).inc()
        log.warning(
            "incident bundle recorded: %s (rule=%s, %d spans, %d traces)",
            path,
            rule,
            len(bundle.get("spans") or ()),
            len(bundle.get("trace_ids") or ()),
            extra={"incident_id": bundle["id"], "rule": rule},
        )
        self.prune()
        return path

    def _write(self, bundle: Mapping[str, Any]) -> str:
        """Crash-safe publish: serialize, write to a per-writer unique tmp
        name, fsync, ``os.replace`` — a SIGKILL mid-write leaves no
        half-bundle under the published name."""
        os.makedirs(self.directory, exist_ok=True)
        final = os.path.join(self.directory, f"{bundle['id']}.json")
        tmp = f"{final}.tmp-{os.getpid()}-{threading.get_ident()}"
        data = json.dumps(bundle, sort_keys=True, default=str)
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
        return final

    def prune(self) -> int:
        """Apply count/age retention over the directory; returns bundles
        removed.  Retention is by the published files, not in-memory state,
        so multiple writers (or a restart) converge on the same bound."""
        try:
            entries = _bundle_files(self.directory)
        except OSError:
            return 0
        removed = 0
        now = time.time()
        keep = entries[: self.max_count]
        drop = entries[self.max_count:]
        for path, mtime in keep:
            if self.max_age_s > 0 and now - mtime > self.max_age_s:
                drop.append((path, mtime))
        for path, _ in drop:
            try:
                os.unlink(path)
                removed += 1
            except OSError:
                pass
        return removed

    # -- reads ---------------------------------------------------------------

    def list(self) -> list[dict[str, Any]]:
        return list_incidents(self.directory)

    def get_path(self, incident_id: str) -> str | None:
        return find_bundle(self.directory, incident_id)

    def snapshot(self) -> dict[str, Any]:
        """The ``/incidents.json`` body."""
        incidents = self.list()
        return {
            "dir": self.directory,
            "count": len(incidents),
            "max_count": self.max_count,
            "max_age_s": self.max_age_s,
            "min_interval_s": self.min_interval_s,
            "incidents": incidents,
        }


def _slug(name: str) -> str:
    return "".join(c if c.isalnum() else "-" for c in name)[:40] or "alert"


def _bundle_files(directory: str) -> list[tuple[str, float]]:
    """(path, mtime) of every published bundle, newest first."""
    out = []
    for name in os.listdir(directory):
        if not (name.startswith("inc-") and name.endswith(".json")):
            continue
        path = os.path.join(directory, name)
        try:
            out.append((path, os.stat(path).st_mtime))
        except OSError:
            continue
    out.sort(key=lambda e: e[1], reverse=True)
    return out


def list_incidents(directory: str) -> list[dict[str, Any]]:
    """Summaries of every bundle in a directory, newest first — shared by
    the recorder, ``/incidents.json``, and ``pio incident list`` reading a
    directory with no server running."""
    try:
        files = _bundle_files(directory)
    except OSError:
        return []
    out = []
    for path, mtime in files:
        row: dict[str, Any] = {
            "path": path,
            "bytes": 0,
            "mtime": round(mtime, 3),
        }
        try:
            row["bytes"] = os.stat(path).st_size
            with open(path, "r", encoding="utf-8") as f:
                bundle = json.load(f)
            row.update(
                {
                    "id": bundle.get("id"),
                    "rule": bundle.get("rule"),
                    "key": bundle.get("key"),
                    "severity": bundle.get("severity"),
                    "value": bundle.get("value"),
                    "at": bundle.get("at"),
                    "exemplar_trace_id": bundle.get("exemplar_trace_id"),
                    "spans": len(bundle.get("spans") or ()),
                    "missing": bundle.get("missing") or [],
                }
            )
        except (OSError, ValueError) as e:
            row["error"] = f"{type(e).__name__}: {e}"
            row.setdefault(
                "id", os.path.splitext(os.path.basename(path))[0]
            )
        out.append(row)
    return out


def find_bundle(directory: str, incident_id: str) -> str | None:
    """Resolve an id (or unique prefix) to a bundle path."""
    try:
        files = _bundle_files(directory)
    except OSError:
        return None
    exact = os.path.join(directory, f"{incident_id}.json")
    for path, _ in files:
        if path == exact:
            return path
    matches = [
        p
        for p, _ in files
        if os.path.basename(p).startswith(incident_id)
    ]
    return matches[0] if len(matches) == 1 else None


def load_bundle(path: str) -> dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        bundle = json.load(f)
    if not isinstance(bundle, dict) or not str(
        bundle.get("format", "")
    ).startswith("pio-incident-bundle/"):
        raise ValueError(f"{path}: not an incident bundle")
    return bundle


def bundle_timeline(bundle: Mapping[str, Any], trace_id: str | None = None):
    """Assemble the bundle's recorded fragments into a Timeline for one
    trace (default: the exemplar).  Returns None when the bundle holds no
    fragments for it."""
    from predictionio_tpu_torch.obs.timeline import TraceAssemblyError, assemble

    tid = trace_id or bundle.get("exemplar_trace_id")
    if not tid:
        return None
    body = {
        "process": bundle.get("process"),
        "spans": bundle.get("spans") or [],
        "_source": str(bundle.get("id") or "bundle"),
        "_offset_s": 0.0,
    }
    try:
        return assemble([body], str(tid))
    except TraceAssemblyError:
        return None


def render_incident_text(bundle: Mapping[str, Any]) -> str:
    """`pio incident show`: the bundle's story on one screen — what fired,
    what the SLO window looked like, which breakers were open, what was
    missing, then the exemplar request's waterfall rendered OFFLINE from
    the recorded fragments."""
    lines = [
        f"incident {bundle.get('id')}",
        f"rule:      {bundle.get('rule')}"
        + (f"{{{bundle['key']}}}" if bundle.get("key") else "")
        + f"  severity={bundle.get('severity')}  value={bundle.get('value')}",
        f"at:        {_fmt_wall(bundle.get('at'))}",
    ]
    ev = bundle.get("event") or {}
    if ev.get("description"):
        lines.append(f"why:       {ev['description']}")
    slo = bundle.get("slo")
    if slo:
        lines.append(
            f"slo:       {slo.get('status')} — availability "
            f"{slo.get('availability')}, error burn "
            f"{slo.get('error_burn_rate')}, latency burn "
            f"{slo.get('latency_burn_rate')} over {slo.get('requests')} "
            "requests"
        )
    for name, br in sorted((bundle.get("breakers") or {}).items()):
        if br.get("state") != "closed":
            lines.append(
                f"breaker:   {name} {br.get('state').upper()} "
                f"({br.get('failures')} failures)"
            )
    cap = bundle.get("capacity")
    if cap and cap.get("headroom_frac") is not None:
        lines.append(
            f"capacity:  headroom {cap['headroom_frac']:.1%}, "
            f"scale hint {cap.get('scale_hint')}"
        )
    flight = bundle.get("flight") or {}
    errors = flight.get("errors") or []
    if errors:
        lines.append(f"flight:    {len(errors)} errored request(s) recorded:")
        for entry in errors[:5]:
            err = entry.get("error") or entry.get("degraded") or ""
            lines.append(
                f"  {entry.get('status')} {entry.get('method')} "
                f"{entry.get('path')} rid={entry.get('request_id')}"
                + (f" err={str(err)[:80]}" if err else "")
            )
    stacks = (bundle.get("stacks") or {}).get("summary") or {}
    if stacks:
        lines.append(
            f"stacks:    {stacks.get('samples', 0)} samples across "
            f"{len(stacks.get('threads') or {})} thread role(s)"
        )
    prov = (bundle.get("provenance") or {}).get("records") or []
    if prov:
        lines.append(
            f"decisions: {len(prov)} breaching answer(s) with provenance "
            "(replay offline: pio replay-request <rid> --record "
            "<bundle.json> after exporting)"
        )
        for rec in prov[:5]:
            lines.append(
                f"  rid={rec.get('request_id')} "
                f"generation={rec.get('instance_id')} "
                f"variant={rec.get('variant')}"
                + (
                    f" degraded={','.join(rec['degraded'])}"
                    if rec.get("degraded")
                    else ""
                )
            )
    lines.append(
        f"traces:    {len(bundle.get('trace_ids') or ())} trace(s), "
        f"{len(bundle.get('spans') or ())} recorded fragment(s)"
    )
    missing = bundle.get("missing") or []
    if missing:
        lines.append("missing:   " + ", ".join(str(m) for m in missing))
    tl = bundle_timeline(bundle)
    if tl is not None:
        lines.append("")
        lines.append(
            f"exemplar waterfall ({bundle.get('exemplar_trace_id')}) — "
            "replay any recorded trace with: pio trace <id> --file "
            "<bundle.json>"
        )
        lines.append(tl.render_text())
    return "\n".join(lines)


def _fmt_wall(ts: Any) -> str:
    if not isinstance(ts, (int, float)):
        return str(ts)
    return time.strftime("%Y-%m-%d %H:%M:%SZ", time.gmtime(ts)) + f" ({ts})"
