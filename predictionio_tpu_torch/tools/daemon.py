"""Daemonized server management: ``pio daemon``, ``pio start-all``,
``pio stop-all`` and ``pio stop``, as the JAX package's ``tools/daemon.py``
runs them.

Each daemon is a detached ``python -m predictionio_tpu_torch.tools.cli
<verb>`` process whose pid lands in ``$PIO_HOME/pids/<name>.pid`` and whose
output goes to ``$PIO_HOME/logs/<name>.log``.  The stack is the event
server (:7070), the admin API (:7071) and the dashboard (:9000), with the
storage daemon booted first when a repository is bound to a loopback
``remote`` source.  None of these verbs touches the card.  The pidfiles
are the JAX package's (a bare pid; a process counts as ours when its
command line names ``predictionio_tpu``), so either package's ``stop``
stops either package's daemon.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from pathlib import Path


def pio_home() -> Path:
    return Path(
        os.environ.get("PIO_HOME", str(Path.home() / ".predictionio_tpu"))
    )


def _pid_dir() -> Path:
    d = pio_home() / "pids"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _log_dir() -> Path:
    d = pio_home() / "logs"
    d.mkdir(parents=True, exist_ok=True)
    return d


def spawn_daemon(
    cli_args: list[str],
    pidfile: Path | str,
    log_path: Path | str | None = None,
) -> int:
    """Detach ``python -m predictionio_tpu_torch.tools.cli <cli_args>`` and
    record its pid (nohup + pidfile)."""
    pidfile = Path(pidfile)
    if pid_alive(read_pidfile(pidfile)):
        raise RuntimeError(
            f"{pidfile} already points at a running process; "
            "stop it first (pio stop-all)"
        )
    log_path = Path(log_path) if log_path else _log_dir() / (
        pidfile.stem + ".log"
    )
    log_f = open(log_path, "ab")
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", *cli_args],
            stdout=log_f,
            stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL,
            start_new_session=True,  # survive the parent shell (nohup role)
        )
    finally:
        log_f.close()
    pidfile.parent.mkdir(parents=True, exist_ok=True)
    pidfile.write_text(str(proc.pid))
    return proc.pid


def read_pidfile(pidfile: Path | str) -> int | None:
    try:
        return int(Path(pidfile).read_text().strip())
    except (OSError, ValueError):
        return None


def pid_alive(pid: int | None) -> bool:
    """True only when ``pid`` is a live process AND still one of ours.

    Pids recycle: after a reboot or daemon crash, a stale pidfile may point
    at an unrelated process — signalling it would kill an innocent victim,
    and treating it as "already running" would wedge start-all until the
    user hand-deletes the file.  On Linux the /proc cmdline check
    disambiguates; elsewhere we fall back to liveness only.
    """
    if pid is None:
        return False
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, PermissionError):
        return False
    try:
        cmdline = Path(f"/proc/{pid}/cmdline").read_bytes()
    except OSError:
        return True  # no procfs: can't disambiguate, assume it's ours
    if not cmdline:
        # /proc cmdline is EMPTY both for a zombie (dead, unreaped —
        # forever) and for a live process mid-execve (a few ms window).
        # Conflating them made spawn() declare a booting replica "died at
        # boot"; the stat state field tells them apart.
        try:
            stat = Path(f"/proc/{pid}/stat").read_text()
            return stat.rsplit(")", 1)[1].split()[0] != "Z"
        except (OSError, IndexError):
            return True
    return b"predictionio_tpu" in cmdline


def _wait_exit(pid: int, timeout: float) -> bool:
    """Poll (cross-process: nothing to wait on) until pid dies or timeout."""
    deadline = time.monotonic() + timeout
    while pid_alive(pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    return not pid_alive(pid)


def stop_pidfile(pidfile: Path | str, timeout: float = 10.0) -> str | None:
    """Stop the recorded pid (if still ours) and remove the pidfile.

    SIGTERM first; a daemon that ignores it past ``timeout`` (wedged device
    dispatch, stuck shutdown hook) is escalated to SIGKILL instead of being
    left running behind a deleted pidfile.  Returns which signal won —
    ``"TERM"`` (clean exit), ``"KILL"`` (escalated) — or None when nothing
    was running, so ``pio stop``/``pio stop-all`` can report it.
    """
    pidfile = Path(pidfile)
    pid = read_pidfile(pidfile)
    won: str | None = None
    if pid_alive(pid):
        os.kill(pid, signal.SIGTERM)
        if _wait_exit(pid, timeout):
            won = "TERM"
        else:
            os.kill(pid, signal.SIGKILL)
            _wait_exit(pid, 2.0)  # reap window; SIGKILL cannot be ignored
            won = "KILL"
    pidfile.unlink(missing_ok=True)
    return won


#: the single-node service stack and its default ports (start-all)
STACK = (
    ("eventserver", "7070"),
    ("adminserver", "7071"),
    ("dashboard", "9000"),
)


def _local_storage_daemon_source() -> tuple[int, str | None] | None:
    """(port, auth_key) of a loopback-addressed ``remote`` storage source,
    if any of the three repositories resolves to one: the storage service
    a single-node configuration points at, which start-all boots first."""
    from urllib.parse import urlsplit

    from predictionio_tpu_torch.data.storage.config import StorageConfig

    cfg = StorageConfig.from_env()
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        try:
            _, props = cfg.source_for(repo)
        except Exception:
            continue
        if props.get("TYPE") != "remote":
            continue
        # config.py accepts URL or HOSTS for remote sources — honor both
        parts = urlsplit(props.get("URL") or props.get("HOSTS", ""))
        if parts.hostname in ("127.0.0.1", "localhost"):
            return parts.port or 7072, props.get("AUTHKEY")
    return None


def _wait_for_storage_daemon(port: int, timeout_s: float = 90.0) -> bool:
    """Block until the daemon answers /v1/ping, before the rest of the
    stack boots.  A 401 means the daemon is up with key auth on: that
    counts as ready."""
    import time
    import urllib.error
    import urllib.request

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/ping", timeout=2
            ).read()
            return True
        except urllib.error.HTTPError:
            return True  # listening; auth/4xx is still "up"
        except Exception:
            time.sleep(0.5)
    return False


def start_all(
    ip: str = "0.0.0.0",
    ports: dict[str, str] | None = None,
    extra_args: dict[str, list[str]] | None = None,
) -> dict[str, int]:
    """Start the full stack; returns {name: pid}.  When the storage
    topology binds a repository to a loopback ``remote`` source, the
    storage daemon boots FIRST and start_all waits for it to answer
    before the dependent services spawn, so the event/admin/dashboard
    servers never race their own storage."""
    ports = ports or {}
    extra_args = extra_args or {}
    pids = {}
    daemon = _local_storage_daemon_source()
    if daemon is not None:
        daemon_port, auth_key = daemon
        args = [
            "storageserver",
            "--ip", "127.0.0.1",
            "--port", str(ports.get("storageserver", daemon_port)),
            *(["--access-key", auth_key] if auth_key else []),
            *extra_args.get("storageserver", []),
        ]
        pids["storageserver"] = spawn_daemon(
            args, _pid_dir() / "storageserver.pid"
        )
        if not _wait_for_storage_daemon(int(ports.get("storageserver", daemon_port))):
            raise RuntimeError(
                "storage daemon did not answer /v1/ping in time; check "
                f"{_log_dir() / 'storageserver.log'}"
            )
    for name, default_port in STACK:
        pidfile = _pid_dir() / f"{name}.pid"
        args = [
            name,
            "--ip", ip,
            "--port", str(ports.get(name, default_port)),
            *extra_args.get(name, []),
        ]
        pids[name] = spawn_daemon(args, pidfile)
    return pids


def stop_all() -> dict[str, str | None]:
    """Stop every pidfile under $PIO_HOME/pids (not just the stack names,
    so `pio daemon` one-offs are reaped too).  Values are the winning
    signal per daemon ("TERM"/"KILL") or None for not-running."""
    out = {}
    for pidfile in sorted(_pid_dir().glob("*.pid")):
        out[pidfile.stem] = stop_pidfile(pidfile)
    return out
