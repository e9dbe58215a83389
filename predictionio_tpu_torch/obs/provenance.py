"""Decision provenance: explain any answer the server gave, and replay it.

The JAX package's ``obs/provenance.py``.  Metrics say p99 moved, traces say where the time went — neither says
*why* an answer came out as it did: which generation, which route through
the engine, which factor-cache rows, which filters, which wave.  The
:class:`ProvenanceStore` keeps a bounded ring of per-answer
**ProvenanceRecord** dicts — engine instance, variant/role, the engine
path, factor-cache hit/miss counts, degraded fallbacks, filters applied,
wave id/size/seq, the event-history watermark consulted, and the returned
item ids with raw scores — captured on every answered request by both HTTP
front ends and served at ``GET /explain.json``.

Two capture levels:

- **cheap** (always on): bounded dicts and counts, no per-item filter
  contents;
- **deep** (opt-in per request via the ``X-Pio-Explain: 1`` header): adds
  filter item lists and wave-mate request ids.

Handlers and engines attach detail through :func:`note` / :func:`note_deep`
— contextvar scopes exactly like ``obs.flight.annotate``: a request scope
the front ends open, plus a wave scope ``_serve_wave`` binds on the
MicroBatcher's worker/finalizer threads (where the request scope is not
visible).  The record is assembled once, at request finish, by
:func:`finalize_record` (called from ``record_request_outcome``).

Each record carries the generation manifest's identity of the binding
that answered (:func:`generation_info`: checksum, status, engine
coordinates), so :func:`replay_request` (the CLI's ``replay-request``)
can rebind exactly those bytes, checksum-verified, re-answer the recorded
query through the host replica (``DeployedEngine.predict``) and diff the
item ids and raw scores.  Scores compare by ``repr`` unless a tolerance
is given: an answer a device wave computed (kernel 3 on a card) may differ
from the host replica's in the last bit of a score.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from typing import Any, Mapping

#: per-request opt-in for deep capture
EXPLAIN_HEADER = "X-Pio-Explain"

#: answers retained by the always-on ring (newest evict oldest)
RECORD_CAPACITY = 1024

#: deep-capture list fields are clipped to this many entries
DEEP_LIST_CAP = 64

#: request-scoped capture state: {"deep": bool, "notes": {}, "deep_notes": {}}
_scope_var: contextvars.ContextVar[dict[str, Any] | None] = (
    contextvars.ContextVar("pio_provenance_scope", default=None)
)

#: wave-scoped collector bound by the MicroBatcher wave (worker/finalizer
#: threads, where the request scope is invisible); takes precedence
_wave_var: contextvars.ContextVar[dict[str, Any] | None] = (
    contextvars.ContextVar("pio_provenance_wave", default=None)
)


def wants_deep(headers: Mapping[str, str] | None) -> bool:
    """Did the request opt into deep capture?  Case-tolerant header lookup
    (the threaded server hands an email.Message, aio a lower-cased dict)."""
    if not headers:
        return False
    v = headers.get(EXPLAIN_HEADER) or headers.get(EXPLAIN_HEADER.lower()) or ""
    return v in ("1", "true", "yes")


def begin_capture(deep: bool = False) -> contextvars.Token:
    """Open a fresh provenance scope for the current request."""
    return _scope_var.set({"deep": deep, "notes": {}, "deep_notes": {}})


def end_capture(token: contextvars.Token) -> None:
    _scope_var.reset(token)


def deep_active() -> bool:
    s = _scope_var.get()
    return bool(s is not None and s["deep"])


def note(**fields: Any) -> None:
    """Attach cheap (always-retained) fields to the in-flight answer's
    provenance record.  Inside a wave scope the fields collect wave-side
    and reach each member through the wave's per-item result; otherwise
    they land on the open request scope (no-op when neither is open)."""
    w = _wave_var.get()
    if w is not None:
        w.update(fields)
        return
    s = _scope_var.get()
    if s is not None:
        s["notes"].update(fields)


def note_deep(**fields: Any) -> None:
    """Attach deep-capture fields: kept only for requests that presented
    ``X-Pio-Explain``.  Wave scopes collect them unconditionally (the wave
    cannot see which members opted in); the request scope filters."""
    w = _wave_var.get()
    if w is not None:
        w.setdefault("_deep", {}).update(fields)
        return
    s = _scope_var.get()
    if s is not None and s["deep"]:
        s["deep_notes"].update(fields)


def begin_wave() -> contextvars.Token:
    """Bind a wave collector (MicroBatcher worker/finalizer threads)."""
    return _wave_var.set({})


def end_wave(token: contextvars.Token) -> dict[str, Any]:
    """Close the wave collector and return what it gathered."""
    collected = _wave_var.get() or {}
    _wave_var.reset(token)
    return collected


def clip(items: Any, cap: int = DEEP_LIST_CAP) -> list:
    """Bound a deep-capture list field (sets/tuples accepted)."""
    return list(items)[:cap]


def item_scores(rendered: Any) -> list[dict[str, Any]] | None:
    """The (item id, raw score) pairs of a rendered prediction, or None
    when the answer has no ``itemScores`` shape (marker/test engines)."""
    if not isinstance(rendered, dict):
        return None
    scores = rendered.get("itemScores")
    if not isinstance(scores, list):
        return None
    return [
        {"item": d.get("item"), "score": d.get("score")}
        for d in scores
        if isinstance(d, dict)
    ]


def note_answer(rendered: Any) -> None:
    """Record what was returned: ``items`` (ids + raw scores) for
    itemScores-shaped answers; the whole rendered body otherwise (those
    engines' answers are small — the ring stays bounded either way)."""
    items = item_scores(rendered)
    if items is not None:
        note(items=items)
    else:
        note(answer=rendered)


#: per instance id, so one manifest read per generation per process
_GEN_MEMO: dict[tuple[str, str], dict[str, Any]] = {}
_GEN_MEMO_CAP = 128
_gen_memo_lock = threading.Lock()


def generation_info(gen_store: Any, instance_id: str) -> dict[str, Any] | None:
    """The manifest's identity of one generation: checksum, status, shard
    axes, and the engine coordinates replay needs to rebuild the store.
    Memoized; None when the engine has no generation store."""
    if gen_store is None or instance_id is None:
        return None
    memo_key = (
        f"{gen_store.engine_id}/{gen_store.engine_version}/"
        f"{gen_store.engine_variant}",
        instance_id,
    )
    with _gen_memo_lock:
        hit = _GEN_MEMO.get(memo_key)
    if hit is not None:
        return hit
    from predictionio_tpu_torch.lifecycle.generations import shard_axes

    try:
        gen = gen_store.get(instance_id)
    except Exception:
        return None
    if gen is None:
        return None
    info = {
        "instance": instance_id,
        "checksum": gen.checksum,
        "status": gen.status,
        "shard_axes": shard_axes(gen.shard_plan),
        "engine": {
            "id": gen_store.engine_id,
            "version": gen_store.engine_version,
            "variant": gen_store.engine_variant,
        },
    }
    with _gen_memo_lock:
        if len(_GEN_MEMO) >= _GEN_MEMO_CAP:
            _GEN_MEMO.clear()
        _GEN_MEMO[memo_key] = info
    return info


def binding_fields(deployed: Any, binding: Any) -> dict[str, Any]:
    """The cheap per-answer binding identity: which generation, which
    hash-side, and (memoized) what the manifest says about its bytes.  A
    deployed engine without ``binding_label`` (a bare test stub) labels
    the binding with its instance's engine variant, as a live binding is
    labelled."""
    instance = binding.instance
    label = getattr(deployed, "binding_label", None)
    fields: dict[str, Any] = {
        "instance_id": instance.id,
        "variant": (
            label(binding) if label is not None
            else getattr(instance, "engine_variant", None) or "default"
        ),
        "role": getattr(binding, "role", "live"),
    }
    factory = getattr(instance, "engine_factory", None)
    if factory:
        fields["engine_factory"] = factory
    gen = generation_info(
        getattr(deployed, "generation_store", None), instance.id
    )
    if gen is not None:
        fields["generation"] = gen
    return fields


def note_binding(deployed: Any, binding: Any) -> None:
    note(**binding_fields(deployed, binding))


# -- the bounded record store ------------------------------------------------


class ProvenanceStore:
    """Bounded ring of per-answer provenance records, indexed by request
    id.  Crash-tolerant by construction: capture never raises into the
    request path (the front ends guard the finalize call) and the ring
    evicts oldest-first, so a hot server holds the last N decisions and
    nothing more."""

    def __init__(self, capacity: int = RECORD_CAPACITY):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: deque[dict[str, Any]] = deque(maxlen=capacity)
        self._by_rid: dict[str, dict[str, Any]] = {}
        self._total = 0

    def record(self, entry: dict[str, Any]) -> None:
        rid = entry.get("request_id")
        with self._lock:
            self._total += 1
            if len(self._ring) == self.capacity:
                evicted = self._ring[0]
                old_rid = evicted.get("request_id")
                if old_rid is not None and (
                    self._by_rid.get(old_rid) is evicted
                ):
                    del self._by_rid[old_rid]
            self._ring.append(entry)
            if rid is not None:
                self._by_rid[rid] = entry

    def get(self, request_id: str) -> dict[str, Any] | None:
        with self._lock:
            return self._by_rid.get(request_id)

    def snapshot(self, limit: int = 50) -> dict[str, Any]:
        with self._lock:
            records = list(self._ring)[-limit:][::-1]
            total = self._total
        return {
            "recorded_total": total,
            "capacity": self.capacity,
            "records": records,
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._by_rid.clear()
            self._total = 0


def finalize_record(
    store: ProvenanceStore,
    server_name: str,
    req: Any,
    resp: Any,
    duration_s: float,
    span: Any,
) -> None:
    """Assemble + store the answer's record from the open capture scope.
    Requests where nothing noted provenance (status pages, admin verbs)
    leave no record; called from ``record_request_outcome`` under the
    front ends' telemetry guard, so a capture bug can't fail a request."""
    scope = _scope_var.get()
    if scope is None or not scope["notes"]:
        return
    entry: dict[str, Any] = {
        "request_id": getattr(span, "request_id", None),
        "trace_id": getattr(span, "trace_id", None),
        "ts": round(time.time(), 3),
        "server": server_name,
        "path": req.path,
        "status": resp.status,
        "duration_s": round(duration_s, 6),
        "capture": "deep" if scope["deep"] else "cheap",
    }
    entry.update(scope["notes"])
    if scope["deep"] and scope["deep_notes"]:
        entry["deep"] = dict(scope["deep_notes"])
    store.record(entry)


# -- offline replay ----------------------------------------------------------


class ReplayError(RuntimeError):
    """The record cannot be replayed at all (no payload, unknown engine)."""


def _diff_items(
    recorded: list[dict[str, Any]],
    replayed: list[dict[str, Any]],
    score_tolerance: float,
) -> list[dict[str, Any]]:
    """Name every divergent field between the recorded and replayed item
    lists.  Scores compare bit-exactly by default (``repr`` equality, so
    NaN == NaN and -0.0 != 0.0); ``score_tolerance`` relaxes that for
    replays of answers another route computed (a device wave's kernel 3
    against the host replica)."""
    divergences: list[dict[str, Any]] = []
    if len(recorded) != len(replayed):
        divergences.append(
            {
                "field": "items.length",
                "recorded": len(recorded),
                "replayed": len(replayed),
            }
        )
    for i, (a, b) in enumerate(zip(recorded, replayed)):
        if a.get("item") != b.get("item"):
            divergences.append(
                {
                    "field": f"items[{i}].item",
                    "recorded": a.get("item"),
                    "replayed": b.get("item"),
                }
            )
            continue
        sa, sb = a.get("score"), b.get("score")
        if score_tolerance > 0 and sa is not None and sb is not None:
            if abs(float(sa) - float(sb)) <= score_tolerance:
                continue
        elif repr(sa) == repr(sb):
            continue
        divergences.append(
            {
                "field": f"items[{i}].score",
                "recorded": sa,
                "replayed": sb,
            }
        )
    return divergences


def replay_request(
    record: Mapping[str, Any],
    storage: Any = None,
    score_tolerance: float = 0.0,
    device: Any = None,
) -> dict[str, Any]:
    """Re-execute a recorded decision offline and diff it bit-exactly.

    Rebinds the record's manifest-named generation from the
    :class:`~predictionio_tpu_torch.lifecycle.generations.GenerationStore`
    (checksum-verified: corrupt or swapped bytes are a named divergence,
    not a silent re-bless) onto ``device`` (default CUDA; raises without a
    card unless ``device="cpu"``), re-runs the recorded query through the
    same engine factory, and compares returned item ids + raw scores.

    Returns ``{"matched": bool, "divergences": [...], "replayed": ...,
    "instance_id": ...}``; ``matched`` is True only when every field is
    bit-identical (or within ``score_tolerance``).  Divergences name what
    moved:

    - ``generation``          — instance absent from the manifest
    - ``generation.checksum`` — manifest names DIFFERENT bytes now
    - ``generation.bytes``    — stored bytes fail checksum (corrupt/torn)
    - ``items[i].item``       — a different item id at rank i
    - ``items[i].score``      — same item, another score
    - ``answer``              — non-itemScores answers compare whole
    """
    from predictionio_tpu_torch.data.storage.config import get_storage
    from predictionio_tpu_torch.device import resolve_device
    from predictionio_tpu_torch.lifecycle.generations import (
        CorruptModelError,
        GenerationStore,
    )

    instance_id = record.get("instance_id")
    payload = record.get("payload")
    gen = record.get("generation") or {}
    engine_coords = gen.get("engine") or {}
    factory_name = record.get("engine_factory")
    if instance_id is None or payload is None:
        raise ReplayError(
            "record is not replayable: missing instance_id or payload "
            "(was it captured by an answered /queries.json request?)"
        )
    device = resolve_device(device)
    storage = storage or get_storage()
    divergences: list[dict[str, Any]] = []

    gen_store = GenerationStore(
        storage.models(),
        engine_coords.get("id", "default"),
        engine_coords.get("version", "default"),
        engine_coords.get("variant", "default"),
    )
    manifest_gen = gen_store.get(instance_id)
    if manifest_gen is None:
        divergences.append(
            {
                "field": "generation",
                "recorded": instance_id,
                "replayed": None,
                "detail": "instance is not in the generation manifest",
            }
        )
        return _replay_report(record, divergences, None)
    recorded_checksum = gen.get("checksum")
    if recorded_checksum and manifest_gen.checksum != recorded_checksum:
        divergences.append(
            {
                "field": "generation.checksum",
                "recorded": recorded_checksum,
                "replayed": manifest_gen.checksum,
                "detail": "manifest now names a different generation's bytes",
            }
        )
        return _replay_report(record, divergences, None)
    try:
        gen_store.verify(manifest_gen)
    except CorruptModelError as e:
        divergences.append(
            {
                "field": "generation.bytes",
                "recorded": recorded_checksum,
                "replayed": None,
                "detail": str(e),
            }
        )
        return _replay_report(record, divergences, None)

    from predictionio_tpu_torch.core.engine import resolve_engine_factory
    from predictionio_tpu_torch.server.prediction_server import (
        DeployedEngine,
        _render_prediction,
    )

    instance = storage.engine_instances().get(instance_id)
    if instance is None:
        raise ReplayError(
            f"engine instance {instance_id!r} is not in the instance store"
        )
    factory = resolve_engine_factory(factory_name or instance.engine_factory)
    deployed = DeployedEngine(
        factory(), instance, storage, gen_store, device=device
    )
    query = deployed.extract_query(dict(payload))
    _, prediction = deployed.predict(query)
    rendered = _render_prediction(prediction)
    replayed = item_scores(rendered)

    recorded_items = record.get("items")
    if recorded_items is not None and replayed is not None:
        divergences.extend(
            _diff_items(recorded_items, replayed, score_tolerance)
        )
    elif record.get("answer") is not None:
        if record["answer"] != rendered:
            divergences.append(
                {
                    "field": "answer",
                    "recorded": record["answer"],
                    "replayed": rendered,
                }
            )
    else:
        raise ReplayError(
            "record holds neither items nor an answer body to diff"
        )
    return _replay_report(record, divergences, replayed or rendered)


def _replay_report(
    record: Mapping[str, Any],
    divergences: list[dict[str, Any]],
    replayed: Any,
) -> dict[str, Any]:
    return {
        "matched": not divergences,
        "request_id": record.get("request_id"),
        "instance_id": record.get("instance_id"),
        "divergences": divergences,
        "replayed": replayed,
    }
