"""The port's operator verbs against the JAX package's ``pio``, on the CPU.

- Engine coordinates: an instance the JAX package trained under
  ``"id": "foo"`` is deployed and batch-predicted by the port through
  ``--engine-json`` (and the ``--engine-id`` / ``--engine-version`` /
  ``--variant`` flags, a key of the JSON winning over its flag), with the
  JAX package's answers and lines.
- Undeploy-then-bind: a second ``deploy`` on an occupied port stops the
  first (``undeploy_stale``, ported with both of its JAX test cases), and
  ``undeploy`` stops the second.
- ``version``, ``status`` (local keys; ``--url`` exit codes), ``build``,
  ``run``, ``upgrade`` and ``metrics`` (``--url``, ``--json``,
  ``--watch``).

Batch lines are compared exactly: both packages answer these small waves
from the host replica's numpy product and top-k.
"""

from __future__ import annotations

import json
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.data.storage.config import StorageConfig as JaxStorageConfig
from predictionio_tpu.data.storage.config import reset_storage as jax_reset_storage
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu_torch.data.storage.config import (
    StorageConfig,
    StorageRuntime,
    reset_storage,
)
from predictionio_tpu_torch.server import prediction_server as pt_server
from predictionio_tpu_torch.server.httpd import AppServer, HTTPApp, Response
from predictionio_tpu_torch.tools import cli as pt_cli

torch.set_num_threads(2)

TIMEOUT = 10
N_USERS, N_ITEMS = 12, 20

FOO_JSON = {
    "id": "foo",
    "version": "2",
    "variant": "v",
    "engineFactory": "recommendation",
    "datasource": {"params": {"appName": "shop"}},
    "algorithms": [
        {"name": "als", "params": {"rank": 4, "numIterations": 3, "lambda": 0.01}}
    ],
}


def _write_events(path, seed: int, n: int = 600) -> None:
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for j in range(n):
            f.write(json.dumps({
                "event": "rate", "entityType": "user",
                "entityId": f"u{rng.integers(N_USERS)}",
                "targetEntityType": "item",
                "targetEntityId": f"i{rng.integers(N_ITEMS)}",
                "properties": {"rating": int(rng.integers(1, 6))},
                "eventTime": time.strftime(
                    "%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(1_700_000_000 + j)),
            }) + "\n")


@pytest.fixture(scope="module")
def foo_home(tmp_path_factory):
    """A home where the JAX package's CLI trained ``engine.json`` under
    id ``foo``, version ``2``, variant ``v``; no ``default`` engine."""
    tmp = tmp_path_factory.mktemp("foo")
    home = tmp / "home"
    _write_events(tmp / "events.jsonl", 5)
    (tmp / "engine.json").write_text(json.dumps(FOO_JSON))
    (tmp / "q.jsonl").write_text("".join(
        json.dumps({"user": f"u{u}", "num": 4}) + "\n" for u in range(N_USERS)))
    storage = jax_reset_storage(JaxStorageConfig.from_env({"PIO_HOME": str(home)}))
    try:
        assert jax_cli.main(["app", "new", "shop", "--access-key", "K"]) == 0
        assert jax_cli.main(["import", "--app", "shop", "--input",
                             str(tmp / "events.jsonl")]) == 0
        assert jax_cli.main(["train", "--engine-json", str(tmp / "engine.json")]) == 0
        assert jax_cli.main(["batchpredict", "--engine-json", str(tmp / "engine.json"),
                             "--input", str(tmp / "q.jsonl"),
                             "--output", str(tmp / "jax.jsonl")]) == 0
        (inst,) = storage.engine_instances().get_completed("foo", "2", "v")
    finally:
        storage.close()
    return tmp, home, inst.id


@pytest.fixture()
def port_storage(foo_home):
    storage = reset_storage(StorageConfig.from_env({"PIO_HOME": str(foo_home[1])}))
    yield storage
    storage.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url: str, key: str | None = None) -> tuple[int, dict]:
    headers = {"Authorization": f"Bearer {key}"} if key else {}
    try:
        with urllib.request.urlopen(
            urllib.request.Request(url, headers=headers), timeout=TIMEOUT
        ) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, {}


def _query(port: int, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/queries.json", data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _wait_up(port: int) -> None:
    t0 = time.monotonic()
    while _get_or_none(f"http://127.0.0.1:{port}/healthz") is None:
        assert time.monotonic() - t0 < 60, f"nothing answered on {port}"
        time.sleep(0.05)


def _get_or_none(url: str):
    try:
        return _get(url)
    except OSError:
        return None


def _cli_in_thread(argv: list) -> tuple[threading.Thread, list]:
    """``pt_cli.main(argv)`` on a thread (a deploy serves until stopped);
    its exit code lands in the returned list."""
    rc: list = []
    t = threading.Thread(target=lambda: rc.append(pt_cli.main(argv)), daemon=True)
    t.start()
    return t, rc


# -- engine coordinates ------------------------------------------------------


def test_batchpredict_by_engine_json_writes_the_jax_lines(foo_home, port_storage, capsys):
    tmp, _, _ = foo_home
    argv = ["batchpredict", "--engine-json", str(tmp / "engine.json"),
            "--input", str(tmp / "q.jsonl"), "--device", "cpu"]
    assert pt_cli.main(argv + ["--output", str(tmp / "port.jsonl")]) == 0
    want = (tmp / "jax.jsonl").read_text().splitlines()
    assert (tmp / "port.jsonl").read_text().splitlines() == want
    # the JSON's id, version and variant win over the flags
    assert pt_cli.main(argv + ["--output", str(tmp / "port2.jsonl"), "--engine-id",
                               "bar", "--variant", "w"]) == 0
    assert (tmp / "port2.jsonl").read_text().splitlines() == want
    # the flags alone name the same instance
    assert pt_cli.main(["batchpredict", "--engine", "recommendation", "--engine-id",
                        "foo", "--engine-version", "2", "--variant", "v",
                        "--input", str(tmp / "q.jsonl"), "--output",
                        str(tmp / "port3.jsonl"), "--device", "cpu"]) == 0
    assert (tmp / "port3.jsonl").read_text().splitlines() == want
    # and without them the port looks up `default`, which holds nothing
    with pytest.raises(RuntimeError, match="no COMPLETED engine instance"):
        pt_cli.main(["batchpredict", "--engine", "recommendation", "--input",
                     str(tmp / "q.jsonl"), "--output", str(tmp / "x.jsonl"),
                     "--device", "cpu"])


def test_deploy_by_engine_json_binds_the_named_instance(foo_home, port_storage):
    tmp, _, instance_id = foo_home
    want = [json.loads(x)["prediction"]
            for x in (tmp / "jax.jsonl").read_text().splitlines()]
    port = _free_port()
    t, rc = _cli_in_thread(["deploy", "--engine-json", str(tmp / "engine.json"),
                            "--ip", "127.0.0.1", "--port", str(port),
                            "--device", "cpu"])
    try:
        _wait_up(port)
        status, body = _get(f"http://127.0.0.1:{port}/status.json")
        assert status == 200 and body["engineInstanceId"] == instance_id
        got = [_query(port, {"user": f"u{u}", "num": 4}) for u in range(N_USERS)]
    finally:
        assert pt_cli.main(["undeploy", "--port", str(port)]) == 0
        t.join(timeout=30)
    assert not t.is_alive() and rc == [0]
    # a solo query's one-row product sums in another order than the batch
    # job's twelve-row product: ids equal, scores within 1e-6
    for g, w in zip(got, want, strict=True):
        assert [x["item"] for x in g["itemScores"]] == [x["item"] for x in w["itemScores"]]
        np.testing.assert_allclose([x["score"] for x in g["itemScores"]],
                                   [x["score"] for x in w["itemScores"]], rtol=1e-6)


def test_train_flags_name_the_instance_unless_the_json_does(foo_home, port_storage, capsys):
    tmp, _, _ = foo_home
    anon = {k: v for k, v in FOO_JSON.items() if k not in ("id", "version", "variant")}
    (tmp / "anon.json").write_text(json.dumps(anon))
    for engine_json, want in (("anon.json", ("x", "3", "w")),
                              ("engine.json", ("foo", "2", "v"))):
        assert pt_cli.main(["train", "--engine-json", str(tmp / engine_json),
                            "--engine-id", "x", "--engine-version", "3",
                            "--variant", "w", "--device", "cpu"]) == 0
        iid = capsys.readouterr().out.split("Engine instance: ")[1].split()[0]
        inst = port_storage.engine_instances().get(iid)
        assert (inst.engine_id, inst.engine_version, inst.engine_variant) == want
        port_storage.engine_instances().delete(iid)


# -- undeploy-then-bind -------------------------------------------------------


class TestUndeployStale:
    def test_stops_existing_server(self):
        app = HTTPApp("stale")
        stopped = []

        @app.route("POST", "/stop")
        def stop(req):
            stopped.append(True)
            return Response(200, {"message": "Shutting down."})

        server = AppServer(app, host="127.0.0.1", port=0).start_background()
        try:
            assert pt_server.undeploy_stale("127.0.0.1", server.port) is True
            assert stopped == [True]
        finally:
            server.shutdown()

    def test_no_server_is_fine(self):
        assert pt_server.undeploy_stale("127.0.0.1", 1) is False


def test_a_second_deploy_stops_the_first(foo_home, port_storage):
    tmp, _, _ = foo_home
    port = _free_port()
    argv = ["deploy", "--engine-json", str(tmp / "engine.json"), "--ip", "127.0.0.1",
            "--port", str(port), "--device", "cpu", "--accesskey", "K"]
    first, rc1 = _cli_in_thread(argv)
    second = None
    try:
        _wait_up(port)
        answer = _query(port, {"user": "u1", "num": 3})
        second, rc2 = _cli_in_thread(argv)
        first.join(timeout=60)
        assert not first.is_alive() and rc1 == [0]
        _wait_up(port)
        assert _query(port, {"user": "u1", "num": 3}) == answer
        # undeploy needs the deploy's key
        assert pt_cli.main(["undeploy", "--port", str(port)]) == 1
    finally:
        assert pt_cli.main(["undeploy", "--port", str(port), "--accesskey", "K"]) == 0
    second.join(timeout=30)
    assert not second.is_alive() and rc2 == [0]
    assert _get_or_none(f"http://127.0.0.1:{port}/healthz") is None
    assert pt_cli.main(["undeploy", "--port", str(port)]) == 1


def test_port_zero_never_probes(port_storage, monkeypatch):
    probes = []
    monkeypatch.setattr(pt_server, "undeploy_stale", lambda *a: probes.append(a))
    server = pt_server.create_prediction_server(
        "", engine_id="foo", engine_version="2", engine_variant="v",
        host="127.0.0.1", port=0, storage=port_storage, device="cpu")
    server.shutdown()
    assert probes == []


# -- the basic verbs ------------------------------------------------------------


def test_version_is_the_jax_packages(capsys):
    assert jax_cli.main(["version"]) == 0
    want = capsys.readouterr().out
    assert pt_cli.main(["version"]) == 0
    assert capsys.readouterr().out == want == "0.1.0\n"


def test_status_local(foo_home, port_storage, capsys, monkeypatch):
    jax_storage = jax_reset_storage(
        JaxStorageConfig.from_env({"PIO_HOME": str(foo_home[1])}))
    try:
        assert jax_cli.main(["status"]) == 0
    finally:
        jax_storage.close()
    want = json.loads(capsys.readouterr().out)
    assert pt_cli.main(["status"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(want) == {"version", "storage", "devices", "backend"}
    assert got["storage"] == want["storage"] == {
        "METADATA": True, "EVENTDATA": True, "MODELDATA": True}
    assert got["version"] == want["version"]
    # devices as torch sees them: this host has no card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pt_cli.main(["status"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert (got["devices"], got["backend"]) == (["cpu"], "cpu")
    # the exit code is the storage checks'
    monkeypatch.setattr(StorageRuntime, "verify_all_data_objects",
                        lambda self: {"METADATA": True, "EVENTDATA": False,
                                      "MODELDATA": True})
    assert pt_cli.main(["status"]) == 1


def test_status_url_exit_codes(foo_home, port_storage, capsys):
    dead = _free_port()
    assert pt_cli.main(["status", "--url", f"http://127.0.0.1:{dead}"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["healthz"]["message"].startswith("unreachable")
    for key in (None, "K"):
        server = pt_server.create_prediction_server(
            "", engine_id="foo", engine_version="2", engine_variant="v",
            host="127.0.0.1", port=0, storage=port_storage, access_key=key,
            device="cpu").start_background()
        url = f"http://127.0.0.1:{server.port}"
        try:
            got = []
            for extra in ([], ["--access-key", "K"], ["--no-quality"]):
                got.append(pt_cli.main(["status", "--url", url, *extra]))
                report = json.loads(capsys.readouterr().out)
                assert report["healthz"]["status"] == "alive"
            # the JAX package's reading of the same server
            want = [jax_cli.main(["status", "--url", url, *extra])
                    for extra in ([], ["--access-key", "K"], ["--no-quality"])]
            capsys.readouterr()
        finally:
            server.shutdown()
        # a keyed server answers /readyz only with its key
        assert got == want == ([0, 0, 0] if key is None else [1, 0, 1])
        if key is None:
            assert report["lifecycle"]["live"] == foo_home[2]


def test_build(tmp_path, capsys):
    good = tmp_path / "good.json"
    good.write_text(json.dumps(FOO_JSON))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({
        "engineFactory": "recommendation",
        "algorithms": [{"name": "als", "params": {"nope": 1}}],
    }))
    for main in (jax_cli.main, pt_cli.main):
        assert main(["build", "--engine-json", str(good)]) == 0
        assert "OK" in capsys.readouterr().out
        assert main(["build", "--engine-json", str(bad)]) == 1
        assert "engine variant is invalid" in capsys.readouterr().err
        assert main(["build", "--engine-json", str(tmp_path / "none.json")]) == 1
        assert "not found" in capsys.readouterr().err
    assert pt_cli.main(["build", "--engine-json", str(good)]) == 0
    assert "XLA" not in capsys.readouterr().out


def test_run_executes_a_script_with_its_arguments(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    script = tmp_path / "job.py"
    script.write_text(
        "import sys\n"
        "import predictionio_tpu_torch\n"
        "if __name__ == '__main__':\n"
        "    print(predictionio_tpu_torch.__version__, sys.argv[1:])\n")
    assert pt_cli.main(["run", str(script), "a", "b"]) == 0
    assert capsys.readouterr().out == "0.1.0 ['a', 'b']\n"


def test_upgrade_names_the_port(capsys):
    assert pt_cli.main(["upgrade"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("predictionio_tpu_torch 0.1.0:") and "PIO_HOME" in out


def test_metrics(foo_home, port_storage, capsys):
    server = pt_server.create_prediction_server(
        "", engine_id="foo", engine_version="2", engine_variant="v",
        host="127.0.0.1", port=0, storage=port_storage, access_key="K",
        device="cpu").start_background()
    url = f"http://127.0.0.1:{server.port}"
    try:
        _query(server.port, {"user": "u1", "num": 2})
        assert pt_cli.main(["metrics", "--url", url]) == 1  # keyed
        assert "401" in capsys.readouterr().err
        assert pt_cli.main(["metrics", "--url", url, "--access-key", "K"]) == 0
        text = capsys.readouterr().out
        assert "pio_request_latency_seconds" in text
        assert pt_cli.main(["metrics", "--url", url, "--access-key", "K",
                            "--json"]) == 0
        body = json.loads(capsys.readouterr().out)
        assert any(name.startswith("pio_") for name in json.dumps(body).split('"'))
        assert pt_cli.main(["metrics", "--url", url, "--access-key", "K",
                            "--watch", "0.01", "--watch-count", "2"]) == 0
        assert capsys.readouterr().out.count("--- pio metrics @") == 2
    finally:
        server.shutdown()
    # a dead server: one shot fails, a watch carries on
    assert pt_cli.main(["metrics", "--url", url]) == 1
    assert pt_cli.main(["metrics", "--url", url, "--watch", "0.01",
                        "--watch-count", "2"]) == 0
    assert capsys.readouterr().err.count("scrape failed") == 3
    assert pt_cli.main(["metrics", "--watch", "-1"]) == 2
    # this process's own registry
    assert pt_cli.main(["metrics"]) == 0
    assert "pio_request_latency_seconds" in capsys.readouterr().out

