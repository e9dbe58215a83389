"""Cross-process trace assembly: one merged host+device timeline per trace.

The JAX package's ``obs/timeline.py``.

``obs/disttrace.py`` is the propagation half — every process accumulates
span *fragments* (flat parent-linked records) in a bounded store served at
``GET /spans.json?trace_id=``.  This module is the collection half:

- :func:`fetch_spans` pulls one process's fragment set over HTTP and
  estimates its clock offset from the request/response timestamps (the
  NTP-style midpoint estimate: the server's ``now`` is compared against the
  midpoint of the client's send/receive clock, so a daemon whose wall clock
  drifts still lands on one shared timeline to within ~RTT/2);
- :func:`assemble` merges any number of fragment sets — HTTP bodies,
  recorded files, the local in-process store — into a single
  :class:`Timeline`: spans linked across process boundaries through the
  ``X-Pio-Parent-Span`` ids the front ends adopted, device-stage and
  per-shard events from the MicroBatcher wave timeline riding as their own
  tracks, orphans (a parent that died before exporting, e.g. a SIGKILLed
  daemon) kept as extra roots rather than dropped;
- the three renders: an indented text waterfall (:meth:`Timeline.render_text`),
  plain JSON (:meth:`Timeline.to_dict`), and **Chrome trace-event JSON**
  (:meth:`Timeline.to_chrome_trace`) loadable by Perfetto / chrome://tracing
  — one ``pid`` lane per process, one ``tid`` per track (the span lane plus
  a ``device:<label>`` lane per participating device/shard).

``pio trace <id> --from URL,URL`` (tools/cli.py) is the operator entry
point.
Everything is stdlib-only and read-only: assembling a trace never touches
the serving path.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterable, Mapping

from predictionio_tpu_torch.obs.disttrace import FRAGMENTS, FragmentStore

#: chrome trace-event timestamps are integer-ish microseconds
_US = 1e6


class TraceAssemblyError(Exception):
    """No usable fragments for the requested trace."""


def estimate_offset(
    server_now: float, t_sent: float, t_recv: float
) -> float:
    """Seconds to SUBTRACT from the server's wall-clock timestamps to land
    them on the collector's clock: ``server_now`` was sampled somewhere
    between the collector's ``t_sent`` and ``t_recv``, so the midpoint is
    the best single-sample estimate (error bounded by half the RTT)."""
    return float(server_now) - (float(t_sent) + float(t_recv)) / 2.0


def fetch_spans(
    url: str,
    trace_id: str,
    access_key: str | None = None,
    timeout: float = 10.0,
) -> dict[str, Any]:
    """GET ``{url}/spans.json?trace_id=`` and return the body with an
    ``_offset_s`` clock-alignment estimate and ``_source`` attached."""
    import urllib.parse
    import urllib.request

    base = url.rstrip("/")
    full = f"{base}/spans.json?trace_id={urllib.parse.quote(trace_id)}"
    headers = {"Authorization": f"Bearer {access_key}"} if access_key else {}
    req = urllib.request.Request(full, headers=headers)
    t_sent = time.time()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read()
    t_recv = time.time()
    body = json.loads(raw.decode("utf-8"))
    if not isinstance(body, dict):
        raise TraceAssemblyError(f"{full} returned a non-object body")
    now = body.get("now")
    body["_offset_s"] = (
        estimate_offset(now, t_sent, t_recv) if isinstance(now, (int, float))
        else 0.0
    )
    body["_source"] = base
    return body


def load_fragment_file(path: str) -> list[dict[str, Any]]:
    """Load a recorded fragment set from disk: a ``/spans.json`` body, a
    list of such bodies, or a bare fragment list (wrapped into one body).
    File-loaded sets get no clock offset — they were recorded, not live."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, dict):
        bodies = [data]
    elif isinstance(data, list) and data and all(
        isinstance(d, dict) and "spans" in d for d in data
    ):
        bodies = data
    elif isinstance(data, list):
        bodies = [{"process": path, "spans": data}]
    else:
        raise TraceAssemblyError(f"{path}: not a fragment set")
    for b in bodies:
        b.setdefault("_source", path)
        b.setdefault("_offset_s", 0.0)
    return bodies


def local_spans(
    trace_id: str, store: FragmentStore | None = None
) -> dict[str, Any]:
    """This process's own fragment set, shaped like a ``/spans.json`` body
    (the collector is often also a participant: a test client's root span,
    a training run's iteration track)."""
    body = (store or FRAGMENTS).snapshot(trace_id=trace_id)
    body["_offset_s"] = 0.0
    body["_source"] = "local"
    return body


class TraceNode:
    """One assembled span with aligned timing and its children."""

    __slots__ = ("fragment", "start_s", "children", "process", "orphan")

    def __init__(self, fragment: dict[str, Any], start_s: float):
        self.fragment = fragment
        #: collector-clock wall start (offset-aligned)
        self.start_s = start_s
        self.children: list["TraceNode"] = []
        self.process = str(fragment.get("process") or "?")
        #: True when the fragment names a parent span that was never
        #: exported (its process died, or the store evicted the trace)
        self.orphan = False

    @property
    def name(self) -> str:
        return str(self.fragment.get("name") or "?")

    @property
    def duration_s(self) -> float:
        return float(self.fragment.get("duration_s") or 0.0)

    @property
    def track(self) -> str:
        return str(self.fragment.get("track") or "spans")

    def to_dict(self, t0: float) -> dict[str, Any]:
        d: dict[str, Any] = {
            "name": self.name,
            "process": self.process,
            "start_s": round(self.start_s - t0, 6),
            "duration_s": round(self.duration_s, 9),
            "span_id": self.fragment.get("span_id"),
        }
        for key in ("parent_id", "request_id", "tags", "error", "track"):
            if self.fragment.get(key):
                d[key] = self.fragment[key]
        if self.orphan:
            d["orphan"] = True
        if self.children:
            d["children"] = [c.to_dict(t0) for c in self.children]
        return d


class Timeline:
    """One assembled cross-process trace (see module docstring)."""

    def __init__(
        self,
        trace_id: str,
        roots: list[TraceNode],
        nodes: Mapping[str, TraceNode],
        processes: list[str],
        offsets: Mapping[str, float],
        source_errors: list[str] | None = None,
    ):
        self.trace_id = trace_id
        self.roots = roots
        self.nodes = dict(nodes)
        #: participating process labels, in first-seen order
        self.processes = processes
        #: applied clock offset per source (seconds subtracted)
        self.offsets = dict(offsets)
        #: fetch/load failures the collector tolerated (dead daemons)
        self.source_errors = list(source_errors or [])

    @property
    def t0(self) -> float:
        return min((n.start_s for n in self.nodes.values()), default=0.0)

    @property
    def span_count(self) -> int:
        return len(self.nodes)

    def device_events(self) -> list[TraceNode]:
        """The device-track events (wave stages, per-shard settles,
        training iterations) inside this trace."""
        return [n for n in self.nodes.values() if n.track != "spans"]

    def to_dict(self) -> dict[str, Any]:
        t0 = self.t0
        return {
            "trace_id": self.trace_id,
            "processes": list(self.processes),
            "span_count": self.span_count,
            "clock_offsets_s": {
                k: round(v, 6) for k, v in self.offsets.items()
            },
            "source_errors": list(self.source_errors),
            "spans": [r.to_dict(t0) for r in self.roots],
        }

    # -- text render ---------------------------------------------------------

    def render_text(self) -> str:
        t0 = self.t0
        end = max(
            (n.start_s + n.duration_s for n in self.nodes.values()),
            default=t0,
        )
        lines = [
            f"trace {self.trace_id} — {len(self.processes)} process(es), "
            f"{self.span_count} span(s), {(end - t0) * 1e3:.1f} ms"
        ]
        for err in self.source_errors:
            lines.append(f"  ! {err}")

        def walk(node: TraceNode, depth: int) -> None:
            rel = (node.start_s - t0) * 1e3
            mark = "~" if node.track != "spans" else ""
            orphan = " (orphaned: parent span not exported)" if node.orphan else ""
            err = (
                f" ERROR: {node.fragment['error']}"
                if node.fragment.get("error")
                else ""
            )
            lines.append(
                f"{'  ' * depth}{mark}{node.name} [{node.process}"
                f"{'' if node.track == 'spans' else ' ' + node.track}] "
                f"+{rel:.2f}ms {node.duration_s * 1e3:.3f}ms{orphan}{err}"
            )
            for c in node.children:
                walk(c, depth + 1)

        for root in self.roots:
            walk(root, 1)
        return "\n".join(lines)

    # -- Chrome trace-event / Perfetto render --------------------------------

    def to_chrome_trace(self) -> dict[str, Any]:
        """The ``chrome://tracing`` / Perfetto JSON object format: complete
        ("X") events with microsecond timestamps relative to the trace
        start, one ``pid`` per process and one ``tid`` per track, named
        through metadata events."""
        t0 = self.t0
        pids = {p: i + 1 for i, p in enumerate(self.processes)}
        events: list[dict[str, Any]] = []
        tids: dict[tuple[str, str], int] = {}
        for proc, pid in pids.items():
            events.append(
                {
                    "ph": "M",
                    "name": "process_name",
                    "pid": pid,
                    "tid": 0,
                    "args": {"name": proc},
                }
            )

        def tid_for(proc: str, track: str) -> int:
            key = (proc, track)
            tid = tids.get(key)
            if tid is None:
                # spans lane first (tid 1), device tracks after, per process
                tid = tids[key] = (
                    1
                    if track == "spans"
                    else 2 + sum(1 for p, _ in tids if p == proc)
                )
                events.append(
                    {
                        "ph": "M",
                        "name": "thread_name",
                        "pid": pids[proc],
                        "tid": tid,
                        "args": {"name": track},
                    }
                )
            return tid

        for node in sorted(self.nodes.values(), key=lambda n: n.start_s):
            frag = node.fragment
            args: dict[str, Any] = {}
            if frag.get("tags"):
                args.update(frag["tags"])
            for key in ("request_id", "span_id", "parent_id", "error"):
                if frag.get(key):
                    args[key] = frag[key]
            events.append(
                {
                    "ph": "X",
                    "name": node.name,
                    "cat": "device" if node.track != "spans" else "span",
                    "pid": pids[node.process],
                    "tid": tid_for(node.process, node.track),
                    "ts": round((node.start_s - t0) * _US, 3),
                    "dur": round(max(node.duration_s, 0.0) * _US, 3),
                    "args": args,
                }
            )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"trace_id": self.trace_id},
        }


def assemble(
    sources: Iterable[Mapping[str, Any]],
    trace_id: str,
    source_errors: list[str] | None = None,
) -> Timeline:
    """Merge fragment sets (``/spans.json``-shaped bodies) into one
    :class:`Timeline`.  Duplicate span ids (a fragment fetched twice, or the
    local store shadowing an HTTP fetch of the same process) keep the first
    copy; fragments whose parent never arrived become extra roots flagged
    ``orphan`` — a dead process must not hide its callees' spans."""
    nodes: dict[str, TraceNode] = {}
    processes: list[str] = []
    offsets: dict[str, float] = {}
    for body in sources:
        offset = float(body.get("_offset_s") or 0.0)
        source = str(body.get("_source") or body.get("process") or "?")
        offsets[source] = offset
        proc_default = body.get("process")
        for frag in body.get("spans") or ():
            if frag.get("trace_id") not in (None, trace_id):
                continue
            sid = frag.get("span_id")
            if not sid or sid in nodes:
                continue
            start = float(frag.get("start_ts") or 0.0) - offset
            frag = dict(frag)
            if proc_default and not frag.get("process"):
                # recorded bodies carry the process label once, at the top
                frag["process"] = proc_default
            node = TraceNode(frag, start)
            nodes[sid] = node
            if node.process not in processes:
                processes.append(node.process)
    if not nodes:
        raise TraceAssemblyError(
            f"no fragments found for trace {trace_id!r} "
            f"(sources: {sorted(offsets)})"
        )
    roots: list[TraceNode] = []
    for node in nodes.values():
        parent_id = node.fragment.get("parent_id")
        parent = nodes.get(parent_id) if parent_id else None
        if parent is not None and parent is not node:
            parent.children.append(node)
        else:
            node.orphan = bool(parent_id)
            roots.append(node)
    for node in nodes.values():
        node.children.sort(key=lambda n: n.start_s)
    roots.sort(key=lambda n: n.start_s)
    return Timeline(
        trace_id, roots, nodes, processes, offsets, source_errors
    )


def collect_trace(
    trace_id: str,
    urls: Iterable[str] = (),
    files: Iterable[str] = (),
    include_local: bool = False,
    store: FragmentStore | None = None,
    access_key: str | None = None,
    timeout: float = 10.0,
) -> Timeline:
    """The one-call collector: fetch every URL's ``/spans.json`` (tolerating
    dead daemons — a SIGKILLed process costs its fragments, not the whole
    assembly), load recorded files, optionally fold in this process's own
    store, and assemble.

    URL fetches run concurrently so the wait is bounded by the slowest
    single source, not the sum — a caller blocking a request thread (the
    dashboard waterfall) pays one timeout even when several daemons in
    ``urls`` are dead."""
    bodies: list[Mapping[str, Any]] = []
    errors: list[str] = []
    url_list = list(urls)
    if url_list:
        with ThreadPoolExecutor(
            max_workers=min(len(url_list), 8),
            thread_name_prefix="pio-trace-fetch",
        ) as pool:
            fetches = [
                pool.submit(
                    fetch_spans,
                    url,
                    trace_id,
                    access_key=access_key,
                    timeout=timeout,
                )
                for url in url_list
            ]
            for url, fut in zip(url_list, fetches):
                try:
                    bodies.append(fut.result())
                except Exception as e:
                    errors.append(f"{url}: {type(e).__name__}: {e}")
    for path in files:
        try:
            bodies.extend(load_fragment_file(path))
        except Exception as e:
            errors.append(f"{path}: {type(e).__name__}: {e}")
    if include_local:
        bodies.append(local_spans(trace_id, store=store))
    return assemble(bodies, trace_id, source_errors=errors)
