"""The port's event-store reads of the ALS family against the JAX package's,
on the CPU.

The same events (explicit ids and times, so both tables hold the same
rows in the same order) are written through each package's sqlite storage
into a home of its own.  Over them:

- ``aggregate_properties`` (``$set``/``$unset``/``$delete``, re-creation,
  ``required``), through ``LEvents``, ``PEvents`` and ``PEventStore``;
- ``find_by_entity`` and ``LEventStore.find_by_entity`` (``limit``,
  ``latest``, ``event_names``, target filters), ``LEventStore.find``;
- ``EventFrame.to_events``, lazy JSON rows decoded;

must be equal field for field.  The port also reads the JAX package's home
(the same sqlite file layout).  ``DataMap``'s typed accessors and
operators behave as the JAX package's on the same values, errors included.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime, timedelta, timezone

import pytest

from predictionio_tpu.data import datamap as jax_dm
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import StorageRuntime as JaxStorageRuntime
from predictionio_tpu.data.store import LEventStore as JaxLEventStore
from predictionio_tpu.data.store import PEventStore as JaxPEventStore
from predictionio_tpu.tools import commands as jax_cmd
from predictionio_tpu_torch.core.base import EngineContext
from predictionio_tpu_torch.data import datamap as pt_dm
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.config import StorageConfig, StorageRuntime
from predictionio_tpu_torch.data.store import LEventStore, PEventStore
from predictionio_tpu_torch.tools import commands as pt_cmd

T0 = datetime(2026, 3, 1, tzinfo=timezone.utc)


def _spec():
    """(event, entity type, id, target type, target id, properties, minutes)."""
    out = [
        ("$set", "item", "i1", None, None, {"categories": ["a", "b"], "price": 3}, 0),
        ("$set", "item", "i2", None, None, {"categories": ["b"]}, 1),
        ("$set", "item", "i1", None, None, {"price": 4.5, "color": "red"}, 2),
        ("$unset", "item", "i1", None, None, {"color": None}, 3),
        ("$set", "item", "i3", None, None, {"categories": []}, 4),
        ("$delete", "item", "i3", None, None, {}, 5),
        ("$set", "item", "i4", None, None, {"x": 1}, 6),
        ("$delete", "item", "i4", None, None, {}, 7),
        ("$set", "item", "i4", None, None, {"y": [1, 2]}, 8),  # re-created
        ("$unset", "item", "i5", None, None, {"z": None}, 9),  # never set
        ("$set", "user", "u1", None, None, {}, 10),
        ("$set", "user", "u2", None, None, {"age": 30}, 10),  # a time tie
        ("$set", "constraint", "unavailableItems", None, None, {"items": ["i1"]}, 11),
        ("$set", "constraint", "unavailableItems", None, None, {"items": ["i2", "i4"]}, 14),
    ]
    for n in range(24):
        u = f"u{n % 3}"
        name = ("view", "buy", "view", "rate")[n % 4]
        props = {"rating": (n % 5) + 0.5} if name == "rate" else {}
        target = ("user", "u2") if n % 11 == 5 else ("item", f"i{n % 5}")
        out.append(("view" if target[0] == "user" else name, "user", u,
                    *target, props, 20 + n // 2))  # pairs share a time
    out.append(("note", "user", "u1", None, None, {"text": "no target"}, 40))
    return out


def _events(cls, dm_cls):
    return [
        cls(event=e, entity_type=et, entity_id=eid, target_entity_type=tt,
            target_entity_id=tid, properties=dm_cls(p),
            event_time=T0 + timedelta(minutes=m), event_id=f"ev{n:03d}",
            tags=("t1",) if n % 7 == 0 else (), pr_id=f"pr{n}" if n % 9 == 0 else None,
            creation_time=T0 + timedelta(hours=1, seconds=n))
        for n, (e, et, eid, tt, tid, p, m) in enumerate(_spec())
    ]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """(jax storage, port storage, port storage over the JAX home)."""
    jhome = tmp_path_factory.mktemp("jax_events") / "pio_home"
    phome = tmp_path_factory.mktemp("port_events") / "pio_home"
    jax_storage = JaxStorageRuntime(JaxStorageConfig.from_env({"PIO_HOME": str(jhome)}))
    storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(phome)}))
    cross = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(jhome)}))
    japp = jax_cmd.app_new(jax_storage, "shop").app
    papp = pt_cmd.app_new(storage, "shop").app
    jax_storage.l_events().insert_batch(_events(JaxEvent, jax_dm.DataMap), japp.id)
    storage.l_events().insert_batch(_events(Event, pt_dm.DataMap), papp.id)
    yield jax_storage, storage, cross, japp.id, papp.id
    cross.close()
    storage.close()
    jax_storage.close()


def _row(e):
    return (e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, e.properties.fields, e.event_time, e.tags,
            e.pr_id, e.event_id, e.creation_time)


def _props(result):
    return {k: (v.fields, v.first_updated, v.last_updated) for k, v in result.items()}


AGGREGATE_CASES = [
    ("item", None), ("item", ("categories",)), ("item", ("price", "categories")),
    ("user", None), ("constraint", None), ("nobody", None),
]


@pytest.mark.parametrize("entity_type,required", AGGREGATE_CASES)
def test_aggregate_properties_equal(stores, entity_type, required):
    jax_storage, storage, cross, jid, pid = stores
    want = _props(jax_storage.l_events().aggregate_properties(
        jid, entity_type, required=required))
    assert want or entity_type == "nobody"
    for st, app in ((storage, pid), (cross, jid)):
        assert _props(st.l_events().aggregate_properties(
            app, entity_type, required=required)) == want
        assert _props(st.p_events().aggregate_properties(
            app, entity_type, required=required)) == want
    assert _props(PEventStore(storage).aggregate_properties(
        "shop", entity_type, required=required)) == want
    assert _props(JaxPEventStore(jax_storage).aggregate_properties(
        "shop", entity_type, required=required)) == want


def test_aggregate_properties_time_window_and_errors(stores):
    jax_storage, storage, _, jid, pid = stores
    window = dict(start_time=T0 + timedelta(minutes=2),
                  until_time=T0 + timedelta(minutes=8))
    assert _props(storage.p_events().aggregate_properties(pid, "item", **window)) \
        == _props(jax_storage.p_events().aggregate_properties(jid, "item", **window))
    with pytest.raises(ValueError, match="non-empty entity_type"):
        storage.l_events().aggregate_properties(pid, "")
    assert EngineContext(storage=storage, device="cpu").l_event_store.storage is storage


FIND_CASES = {
    "all_of_u1": dict(entity_type="user", entity_id="u1"),
    "views_latest_3": dict(entity_type="user", entity_id="u0", event_names=["view"],
                           limit=3, latest=True),
    "oldest_first": dict(entity_type="user", entity_id="u2", latest=False),
    "seen_items": dict(entity_type="user", entity_id="u1",
                       event_names=["buy", "view"], target_entity_type="item"),
    "target_user": dict(entity_type="user", entity_id="u2", target_entity_type="user"),
    "no_target": dict(entity_type="user", entity_id="u1", target_entity_type=""),
    "one_target": dict(entity_type="user", entity_id="u2", target_entity_id="i2"),
    "constraint_latest": dict(entity_type="constraint", entity_id="unavailableItems",
                              event_names=["$set"], limit=1, latest=True),
    "window": dict(entity_type="user", entity_id="u0",
                   start_time=T0 + timedelta(minutes=22),
                   until_time=T0 + timedelta(minutes=28)),
    "limit_0": dict(entity_type="user", entity_id="u0", limit=0),
    "unknown": dict(entity_type="user", entity_id="nobody"),
}


@pytest.mark.parametrize("case", sorted(FIND_CASES))
def test_find_by_entity_equal(stores, case):
    jax_storage, storage, cross, jid, pid = stores
    kw = FIND_CASES[case]
    want = [_row(e) for e in JaxLEventStore(jax_storage).find_by_entity("shop", **kw)]
    assert want or case in ("unknown", "limit_0")
    assert [_row(e) for e in LEventStore(storage).find_by_entity("shop", **kw)] == want
    assert [_row(e) for e in LEventStore(cross).find_by_entity("shop", **kw)] == want
    dao = dict(kw)
    dao["reversed"] = dao.pop("latest", False)
    got = storage.l_events().find_by_entity(pid, **dao)
    assert [_row(e) for e in got] == [
        _row(e) for e in jax_storage.l_events().find_by_entity(jid, **dao)
    ]


@pytest.mark.parametrize("kw", [
    {}, {"entity_type": "item"}, {"event_names": ["rate", "buy"]},
    {"entity_type": "user", "target_entity_type": "item", "limit": 5, "reversed": True},
], ids=["all", "items", "names", "targets_limit_reversed"])
def test_levent_store_find_and_frame_to_events_equal(stores, kw):
    jax_storage, storage, _, jid, pid = stores
    want = [_row(e) for e in JaxLEventStore(jax_storage).find("shop", **kw)]
    assert want
    assert [_row(e) for e in LEventStore(storage).find("shop", **kw)] == want
    names = kw.get("event_names")
    frame_kw = {k: v for k, v in kw.items() if k in ("entity_type", "target_entity_type")}
    got = PEventStore(storage).find("shop", event_names=names, **frame_kw)
    assert any(isinstance(p, str) and p for p in got.properties)  # lazy rows
    jax_frame = JaxPEventStore(jax_storage).find("shop", event_names=names, **frame_kw)
    assert [_row(e) for e in got.to_events()] == [_row(e) for e in jax_frame.to_events()]


# -- DataMap ----------------------------------------------------------------------

FIELDS = {"s": "x", "i": 3, "f": 2.5, "b": True, "l": [1, 2], "d": {"k": "v"},
          "n": None, "t": "2026-03-01T00:00:00.000Z", "ls": ["a", "b"]}


@dataclass
class _Shape:
    s: str
    i: int
    f: float = 0.0
    ls: list[str] | None = None


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the same error class name and message
        return ("err", type(e).__name__, str(e))


DATAMAP_CALLS = {
    "getitem": lambda m: m["i"],
    "contains": lambda m: ("s" in m, "zz" in m),
    "len_iter": lambda m: (len(m), sorted(m)),
    "require_missing": lambda m: m.require("zz"),
    "get_typed": lambda m: (m.get("f", float), m.get("i", int), m.get("s", str),
                            m.get("b", bool), m.get("l", list[int])),
    "get_int_as_float": lambda m: m.get("i", float),
    "get_wrong_type": lambda m: m.get("s", int),
    "get_null": lambda m: m.get("n"),
    "get_missing": lambda m: m.get("zz"),
    "get_time": lambda m: m.get("t", datetime),
    "get_opt": lambda m: (m.get_opt("n"), m.get_opt("zz"), m.get_opt("i", int)),
    "get_or_else": lambda m: (m.get_or_else("ls", []), m.get_or_else("zz", ["d"]),
                              m.get_or_else("n", 7)),
    "extract": lambda m: m.extract(_Shape),
    "extract_missing": lambda m: type(m)({"i": 1}).extract(_Shape),
    "add_sub": lambda m: ((m + {"s": "y", "new": 1}).fields,
                          (m - ["s", "l", "zz"]).fields),
    "json": lambda m: (m.to_json(), type(m).from_json(m.to_json()).fields,
                       m == type(m).from_json(m.to_json())),
}


@pytest.mark.parametrize("call", sorted(DATAMAP_CALLS))
def test_datamap_accessors_match_jax(call):
    fn = DATAMAP_CALLS[call]
    assert _outcome(lambda: fn(pt_dm.DataMap(FIELDS))) == \
        _outcome(lambda: fn(jax_dm.DataMap(FIELDS)))


def test_property_map_matches_jax():
    t1, t2 = T0, T0 + timedelta(days=1)
    p = pt_dm.PropertyMap({"a": 1, "b": [2]}, t1, t2)
    j = jax_dm.PropertyMap({"a": 1, "b": [2]}, t1, t2)
    for fn in (lambda m: (m + {"c": 3}).fields, lambda m: (m - ["a"]).fields,
               lambda m: ((m + {"c": 3}).first_updated, (m - ["a"]).last_updated),
               lambda m: m.get_or_else("b", []), lambda m: m.to_json()):
        assert fn(p) == fn(j)
    assert p == pt_dm.PropertyMap({"a": 1, "b": [2]}, t1, t2)
    assert p != pt_dm.PropertyMap({"a": 1, "b": [2]}, t1, t1)
    assert hash(p) == hash(pt_dm.PropertyMap({"a": 1, "b": [2]}, t1, t2))


def test_find_by_entity_is_safe_from_many_threads(tmp_path):
    """The deploy reads live events from the micro-batcher's worker and the
    threaded server's request threads at once, while events arrive: every
    read returns whole rows, newest first, never fewer than before."""
    import sys
    import threading

    storage = StorageRuntime(StorageConfig.from_env({"PIO_HOME": str(tmp_path / "h")}))
    app_id = pt_cmd.app_new(storage, "live").app.id
    dao = storage.l_events()

    def view(n):
        return Event(event="view", entity_type="user", entity_id=f"u{n % 4}",
                     target_entity_type="item", target_entity_id=f"i{n}",
                     event_time=T0 + timedelta(seconds=n), event_id=f"e{n}")

    dao.insert_batch([view(n) for n in range(40)], app_id)
    errors, done = [], threading.Event()

    def reader(user):
        last = 0
        try:
            while not done.is_set():
                got = list(LEventStore(storage).find_by_entity(
                    "live", "user", user, event_names=["view"]))
                times = [e.event_time for e in got]
                assert times == sorted(times, reverse=True)
                assert all(e.entity_id == user for e in got)
                assert len(got) >= last
                last = len(got)
        except Exception as e:  # surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=reader, args=(f"u{n % 4}",), daemon=True)
               for n in range(8)]
    try:
        for t in threads:
            t.start()
        for n in range(40, 240, 10):
            dao.insert_batch([view(m) for m in range(n, n + 10)], app_id)
    finally:
        done.set()
        for t in threads:
            t.join(timeout=30)
        sys.setswitchinterval(old)
        storage.close()
    assert not any(t.is_alive() for t in threads)
    assert errors == []
