"""The port's ingest verbs against the JAX package's ``pio``, on the CPU.

- The same ``app`` (``new|list|show|delete|data-delete|channel-new|
  channel-delete``), ``accesskey`` (``new|list|delete``), ``import`` and
  ``export`` command lines, errors included, run through both CLIs, each
  on a home of its own: exit codes, stdout and stderr must be equal, and
  the exported JSON lines equal without ``eventId`` and ``creationTime``.
  Parquet export writes the same table, and without ``pyarrow`` both
  refuse with the same message.
- ``eventserver`` and ``deploy --event-port`` bind what they print.
- A REST ingest through the port's event server (concurrent batches, one
  webhook event, single events), then ``train --device cpu``, gives the
  factors of ``import`` then ``train`` of the same events, both from the
  engine's one seeded start.  Where event times tie, both trains started
  from one model's factors (mapped by entity id) agree within 2e-3.
"""

from __future__ import annotations

import http.client
import json
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import reset_storage as jax_reset_storage
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu_torch.core.persistence import load_models
from predictionio_tpu_torch.data.storage.config import StorageConfig, reset_storage
from predictionio_tpu_torch.server.event_server import create_event_server
from predictionio_tpu_torch.tools import cli as pt_cli

torch.set_num_threads(2)

TIMEOUT = 10


def _events(n: int, seed: int, per_second: int = 1) -> list[dict]:
    """``n`` rate events over a few users and items, ``per_second`` of
    them to each second: with 1, every read returns them in one order."""
    rng = np.random.default_rng(seed)
    return [
        {"event": "rate", "entityType": "user", "entityId": f"u{rng.integers(12)}",
         "targetEntityType": "item", "targetEntityId": f"i{rng.integers(20)}",
         "properties": {"rating": int(rng.integers(1, 6))},
         "eventTime": time.strftime("%Y-%m-%dT%H:%M:%S.000Z",
                                    time.gmtime(1_700_000_000 + j // per_second))}
        for j in range(n)
    ]


def _strip(lines: list[str]) -> list[dict]:
    out = []
    for line in lines:
        d = json.loads(line)
        d.pop("eventId")
        d.pop("creationTime")
        out.append(d)
    return out


def _session(tmp_path, events_file, name):
    """The command lines, with this package's own output paths."""
    out = tmp_path / f"{name}_out"
    out.mkdir()
    ev = str(events_file)
    return out, [
        ["app", "new", "shop", "--access-key", "K1", "--description", "the shop"],
        ["app", "new", "other", "--access-key", "K2"],
        ["app", "new", "shop"],
        ["app", "list"],
        ["app", "show", "shop"],
        ["app", "show", "nope"],
        ["accesskey", "new", "shop", "--key", "K3", "--event", "rate", "--event", "buy"],
        ["accesskey", "new", "shop", "--key", "K3"],
        ["accesskey", "new", "nope"],
        ["accesskey", "list", "shop"],
        ["accesskey", "list"],
        ["accesskey", "delete", "K3"],
        ["accesskey", "delete", "K3"],
        ["app", "channel-new", "shop", "mobile"],
        ["app", "channel-new", "shop", "mobile"],
        ["app", "channel-new", "shop", "bad_name!"],
        ["app", "channel-new", "nope", "web"],
        ["app", "show", "shop"],
        ["import", "--app", "shop", "--input", ev],
        ["import", "--app", "shop", "--input", ev, "--channel", "mobile"],
        ["import", "--app", "shop", "--input", ev, "--channel", "nope"],
        ["export", "--app", "shop", "--output", str(out / "all.jsonl")],
        ["export", "--app", "shop", "--output", str(out / "mobile.jsonl"),
         "--channel", "mobile"],
        ["export", "--app", "nope", "--output", str(out / "x.jsonl")],
        ["export", "--app", "shop", "--output", str(out / "all.parquet"),
         "--format", "parquet"],
        ["app", "data-delete", "shop", "--channel", "mobile"],
        ["export", "--app", "shop", "--output", str(out / "mobile2.jsonl"),
         "--channel", "mobile"],
        ["export", "--app", "shop", "--output", str(out / "all2.jsonl")],
        ["app", "channel-delete", "shop", "mobile"],
        ["app", "channel-delete", "shop", "mobile"],
        ["app", "data-delete", "shop"],
        ["export", "--app", "shop", "--output", str(out / "all3.jsonl")],
        ["app", "delete", "other"],
        ["app", "delete", "other"],
        ["app", "list"],
    ]


def _run_session(capsys, main, argvs) -> list:
    got = []
    for argv in argvs:
        rc = main(argv)
        cap = capsys.readouterr()
        got.append((argv[:2], rc, cap.out, cap.err))
    return got


def test_verbs_print_as_jax(tmp_path, capsys):
    events_file = tmp_path / "events.jsonl"
    events_file.write_text("".join(json.dumps(e) + "\n" for e in _events(60, 1)))
    runs, outs = {}, {}
    for name, reset, config, main in (
        ("jax", jax_reset_storage, JaxStorageConfig, jax_cli.main),
        ("port", reset_storage, StorageConfig, pt_cli.main),
    ):
        storage = reset(config.from_env({"PIO_HOME": str(tmp_path / name / "home")}))
        out, argvs = _session(tmp_path, events_file, name)
        try:
            runs[name] = _run_session(capsys, main, argvs)
        finally:
            storage.close()
        outs[name] = out
    for n, (got, want) in enumerate(zip(runs["port"], runs["jax"])):
        assert got == want, n
    assert [rc for _, rc, _, _ in runs["port"]].count(1) == 12
    for f in ("all", "mobile", "mobile2", "all2", "all3"):
        got = (outs["port"] / f"{f}.jsonl").read_text().splitlines()
        want = (outs["jax"] / f"{f}.jsonl").read_text().splitlines()
        assert _strip(got) == _strip(want), f
    pq = pytest.importorskip("pyarrow.parquet")
    tables = [pq.read_table(outs[n] / "all.parquet").to_pylist() for n in ("port", "jax")]
    for t in tables:
        for row in t:
            row.pop("eventId")
            row.pop("creationTime")
    assert tables[0] == tables[1] and len(tables[0]) == 60


def test_exported_events_are_the_imported_ones(tmp_path, capsys):
    events = _events(40, 2)
    (tmp_path / "in.jsonl").write_text("".join(json.dumps(e) + "\n" for e in events))
    storage = reset_storage(StorageConfig.from_env({"PIO_HOME": str(tmp_path / "home")}))
    try:
        assert pt_cli.main(["app", "new", "a", "--access-key", "K"]) == 0
        assert pt_cli.main(["import", "--app", "a", "--input", str(tmp_path / "in.jsonl")]) == 0
        assert pt_cli.main(["export", "--app", "a", "--output", str(tmp_path / "o.jsonl")]) == 0
    finally:
        storage.close()
    capsys.readouterr()
    assert _strip((tmp_path / "o.jsonl").read_text().splitlines()) == events


def test_parquet_export_without_pyarrow_refuses_as_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    got = []
    for name, reset, config, main in (
        ("jax", jax_reset_storage, JaxStorageConfig, jax_cli.main),
        ("port", reset_storage, StorageConfig, pt_cli.main),
    ):
        storage = reset(config.from_env({"PIO_HOME": str(tmp_path / name)}))
        try:
            assert main(["app", "new", "a", "--access-key", "K"]) == 0
            capsys.readouterr()
            rc = main(["export", "--app", "a", "--output", str(tmp_path / f"{name}.parquet"),
                       "--format", "parquet"])
            got.append((rc, capsys.readouterr().err))
        finally:
            storage.close()
    assert got[0] == got[1] == (
        1, "error: parquet export requires pyarrow; use --format json\n")


# -- the servers a verb starts --------------------------------------------------


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _spawn(home, argv, lines: int):
    """Start ``python -m predictionio_tpu_torch.tools.cli argv`` and read
    the ``lines`` lines it prints once its servers are bound."""
    import os

    env = dict(os.environ, PIO_HOME=str(home))
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
    )
    printed = []
    reader = threading.Thread(
        target=lambda: printed.extend(proc.stdout.readline() for _ in range(lines)),
        daemon=True,
    )
    reader.start()
    reader.join(timeout=120)
    return proc, printed


def _stop(proc):
    import signal

    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=TIMEOUT)
    return proc.returncode


def test_eventserver_verb_serves_on_the_port_it_prints(tmp_path, capsys):
    home = tmp_path / "home"
    storage = reset_storage(StorageConfig.from_env({"PIO_HOME": str(home)}))
    try:
        assert pt_cli.main(["app", "new", "a", "--access-key", "K"]) == 0
    finally:
        storage.close()
    proc, printed = _spawn(home, ["eventserver", "--ip", "127.0.0.1", "--port", "0",
                                  "--stats"], 1)
    try:
        assert printed and printed[0].startswith("Event server on http://127.0.0.1:"), printed
        port = int(printed[0].rsplit(":", 1)[1])
        assert _http(port, "GET", "/") == (200, {"status": "alive"})
        status, body = _http(port, "POST", "/events.json?accessKey=K",
                             json.dumps(_events(1, 3)[0]))
        assert status == 201 and body["eventId"]
        status, stats = _http(port, "GET", "/stats.json?accessKey=K")
        assert stats["currentHour"]["statusCode"] == [{"status": 201, "count": 1}]
    finally:
        assert _stop(proc) == 0, proc.stderr.read()


def _shop_events(seed: int) -> list[dict]:
    """An ecommerce app's events: users and items with categories, views."""
    rng = np.random.default_rng(seed)
    t = "2023-11-14T00:00:00.000Z"
    out = [{"event": "$set", "entityType": "user", "entityId": f"u{n}", "eventTime": t}
           for n in range(8)]
    out += [{"event": "$set", "entityType": "item", "entityId": f"i{n}",
             "properties": {"categories": [f"c{n % 3}"]}, "eventTime": t}
            for n in range(16)]
    out += [{"event": "view", "entityType": "user", "entityId": f"u{rng.integers(8)}",
             "targetEntityType": "item", "targetEntityId": f"i{rng.integers(16)}",
             "eventTime": time.strftime("%Y-%m-%dT%H:%M:%S.000Z",
                                        time.gmtime(1_700_000_000 + j))}
            for j in range(160)]
    return out


def _query(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/queries.json", body=json.dumps(body))
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), json.loads(resp.read())
    finally:
        conn.close()


def test_deploy_event_port_feeds_the_next_answer(tmp_path, capsys):
    """``deploy --event-port`` of an ecommerce engine on the CPU: a ``view``
    POSTed to the event port removes that item from the user's next
    ``unseenOnly`` answer, which is not degraded."""
    home = tmp_path / "home"
    (tmp_path / "shop.jsonl").write_text(
        "".join(json.dumps(e) + "\n" for e in _shop_events(5)))
    (tmp_path / "engine.json").write_text(json.dumps({
        "id": "shop", "engineFactory": "ecommerce",
        "datasource": {"params": {"appName": "shop"}},
        "algorithms": [{"name": "ecomm", "params": {
            "appName": "shop", "rank": 4, "numIterations": 5}}],
    }))
    storage = reset_storage(StorageConfig.from_env({"PIO_HOME": str(home)}))
    try:
        assert pt_cli.main(["app", "new", "shop", "--access-key", "S"]) == 0
        assert pt_cli.main(["import", "--app", "shop", "--input",
                            str(tmp_path / "shop.jsonl")]) == 0
        capsys.readouterr()
        assert pt_cli.main(["train", "--engine-json", str(tmp_path / "engine.json"),
                            "--device", "cpu"]) == 0
    finally:
        storage.close()
    instance = capsys.readouterr().out.split("Engine instance: ")[1].split()[0]
    proc, printed = _spawn(home, ["deploy", "--engine-instance-id", instance,
                                  "--ip", "127.0.0.1",
                                  "--port", "0", "--event-port", "0",
                                  "--device", "cpu"], 2)
    try:
        assert len(printed) == 2 and printed[0].startswith(
            "Event server (embedded) on http://127.0.0.1:"), printed
        event_port = int(printed[0].rsplit(":", 1)[1])
        port = int(printed[1].split("http://127.0.0.1:")[1].split()[0])
        status, headers, before = _query(port, {"user": "u1", "num": 4})
        assert status == 200 and "X-Pio-Degraded" not in headers
        top = before["itemScores"][0]["item"]
        status, _ = _http(event_port, "POST", "/events.json?accessKey=S", json.dumps(
            {"event": "view", "entityType": "user", "entityId": "u1",
             "targetEntityType": "item", "targetEntityId": top}))
        assert status == 201
        status, headers, after = _query(port, {"user": "u1", "num": 4})
        assert status == 200 and "X-Pio-Degraded" not in headers
        items = [x["item"] for x in after["itemScores"]]
        assert top not in items
        assert items[:3] == [x["item"] for x in before["itemScores"][1:]]
    finally:
        assert _stop(proc) == 0, proc.stderr.read()


# -- REST ingest, then train, equals import, then train -----------------------


ENGINE = {
    "engineFactory": "recommendation",
    "algorithms": [{"name": "als", "params": {"rank": 4, "numIterations": 5,
                                              "lambda": 0.01, "seed": 3}}],
}


def _train(tmp_path, app: str, capsys):
    path = tmp_path / f"{app}.json"
    path.write_text(json.dumps({**ENGINE, "id": app,
                                "datasource": {"params": {"appName": app}}}))
    assert pt_cli.main(["train", "--engine-json", str(path), "--device", "cpu"]) == 0
    return capsys.readouterr().out.split("Engine instance: ")[1].split()[0]


def test_rest_ingest_trains_as_import(tmp_path, capsys):
    """400 rate events: 350 in batches of 50 from 4 threads at once, 49 as
    single POSTs and one through the segmentio webhook (a ``track`` the
    train does not read, so one more event) into app ``rest``; the same
    400 by ``pio import`` into app ``file``.  Both trains read the same
    ratings in the same order and give the same factors."""
    events = _events(400, 4)
    (tmp_path / "in.jsonl").write_text("".join(json.dumps(e) + "\n" for e in events))
    storage = reset_storage(StorageConfig.from_env({"PIO_HOME": str(tmp_path / "home")}))
    server = create_event_server(host="127.0.0.1", port=0, storage=storage)
    server.start_background()
    try:
        assert pt_cli.main(["app", "new", "rest", "--access-key", "R"]) == 0
        assert pt_cli.main(["app", "new", "file", "--access-key", "F"]) == 0
        assert pt_cli.main(["import", "--app", "file", "--input",
                            str(tmp_path / "in.jsonl")]) == 0
        batches = [events[lo:lo + 50] for lo in range(0, 350, 50)]
        statuses, errors, lock = [], [], threading.Lock()

        def client(mine):
            try:
                for batch in mine:
                    status, body = _http(server.port, "POST",
                                         "/batch/events.json?accessKey=R",
                                         json.dumps(batch))
                    with lock:
                        statuses.extend([status] + [x["status"] for x in body])
            except Exception as e:  # reported below
                with lock:
                    errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(batches[c::4],), daemon=True)
                   for c in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads) and errors == []
        for e in events[350:]:
            statuses.append(_http(server.port, "POST", "/events.json?accessKey=R",
                                  json.dumps(e))[0])
        statuses.append(_http(server.port, "POST", "/webhooks/segmentio.json?accessKey=R",
                              json.dumps({"version": "2", "type": "track",
                                          "userId": "u1", "event": "Opened",
                                          "timestamp": "2023-11-14T22:13:20.000Z"}))[0])
        assert statuses.count(200) == 7 and statuses.count(201) == 401, statuses
        capsys.readouterr()
        rest, file = _train(tmp_path, "rest", capsys), _train(tmp_path, "file", capsys)
        (a,), (b,) = (load_models(storage.models(), i) for i in (rest, file))
        assert list(a["user_vocab"]) == list(b["user_vocab"])
        assert list(a["item_vocab"]) == list(b["item_vocab"])
        np.testing.assert_array_equal(a["user_factors"], b["user_factors"])
        np.testing.assert_array_equal(a["item_factors"], b["item_factors"])
        assert np.isfinite(a["user_factors"]).all()
    finally:
        server.shutdown()
        storage.close()


def _train_from(storage, app: str, start: str) -> str:
    """``app``'s train started from the factors of instance ``start``,
    mapped by entity id (``run_train(warm_start_from=...)``)."""
    from predictionio_tpu_torch.core.base import EngineContext
    from predictionio_tpu_torch.core.engine import resolve_engine_factory
    from predictionio_tpu_torch.core.workflow import run_train

    engine = resolve_engine_factory("recommendation")()
    params = engine.params_from_json({**ENGINE, "datasource": {"params": {"appName": app}}})
    instance = run_train(engine, params, ctx=EngineContext(storage=storage, device="cpu"),
                         engine_id=f"{app}-warm", engine_factory="recommendation",
                         storage=storage, warm_start_from=start)
    return instance.id


def _by_entity(blob: dict, users: list, items: list) -> tuple:
    """A model's factor rows in the order of the given entity ids."""
    u = {k: n for n, k in enumerate(blob["user_vocab"])}
    i = {k: n for n, k in enumerate(blob["item_vocab"])}
    return (blob["user_factors"][[u[k] for k in users]],
            blob["item_factors"][[i[k] for k in items]])


def test_tied_event_times_train_as_import_from_one_start(tmp_path, capsys):
    """400 rate events, 100 to a second, POSTed in batches of 50 by 4
    clients at once (each second's events come from two clients) into app
    ``rest``; the same 400 by ``pio import`` into app ``file``.  ``find``
    orders by ``eventTime`` alone, so a second's events come back in the
    order they were stored, which the clients decide; the vocabularies
    follow first appearance, so a cold train of each may draw its start
    rows in another order.  Both apps hold the same events and entities,
    and trained from one start (the import-fed cold train's factors,
    mapped by entity id) they agree within the port's train tolerance,
    2e-3: only the order of each entity's sum differs."""
    events = _events(400, 5, per_second=100)
    (tmp_path / "in.jsonl").write_text("".join(json.dumps(e) + "\n" for e in events))
    storage = reset_storage(StorageConfig.from_env({"PIO_HOME": str(tmp_path / "home")}))
    server = create_event_server(host="127.0.0.1", port=0, storage=storage)
    server.start_background()
    try:
        assert pt_cli.main(["app", "new", "rest", "--access-key", "R"]) == 0
        assert pt_cli.main(["app", "new", "file", "--access-key", "F"]) == 0
        assert pt_cli.main(["import", "--app", "file", "--input",
                            str(tmp_path / "in.jsonl")]) == 0
        batches = [events[lo:lo + 50] for lo in range(0, 400, 50)]
        statuses, errors, lock = [], [], threading.Lock()

        def client(mine):
            try:
                for batch in mine:
                    status, body = _http(server.port, "POST",
                                         "/batch/events.json?accessKey=R",
                                         json.dumps(batch))
                    with lock:
                        statuses.extend([status] + [x["status"] for x in body])
            except Exception as e:  # reported below
                with lock:
                    errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(batches[c::4],), daemon=True)
                   for c in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads) and errors == []
        assert statuses.count(200) == 8 and statuses.count(201) == 400, statuses
        capsys.readouterr()
        cold = {app: _train(tmp_path, app, capsys) for app in ("rest", "file")}
        (a,), (b,) = (load_models(storage.models(), cold[x]) for x in ("rest", "file"))
        users, items = list(b["user_vocab"]), list(b["item_vocab"])
        assert sorted(a["user_vocab"]) == sorted(users)
        assert sorted(a["item_vocab"]) == sorted(items)
        (a,), (b,) = (load_models(storage.models(), _train_from(storage, x, cold["file"]))
                      for x in ("rest", "file"))
        (ua, va), (ub, vb) = _by_entity(a, users, items), _by_entity(b, users, items)
        assert np.isfinite(ua).all() and np.isfinite(va).all()
        np.testing.assert_allclose(ua, ub, rtol=0, atol=2e-3)
        np.testing.assert_allclose(va, vb, rtol=0, atol=2e-3)
    finally:
        server.shutdown()
        storage.close()
