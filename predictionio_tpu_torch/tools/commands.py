"""App, access-key, channel and event import/export commands: the JAX
package's ``tools/commands.py`` (tools/commands/App.scala:31-340,
AccessKey.scala:30, imprt/FileToEvents.scala:44, export/EventsToFile.scala:42)
but ``app_compact``, which needs a segment-layout event store.  Creating an
app provisions a default access key and the app's event table; deleting it
removes its keys, channels and events.
"""

from __future__ import annotations

import json
import secrets
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import (
    AccessKey,
    App,
    Channel,
    channel_name_is_valid,
)
from predictionio_tpu_torch.data.storage.config import StorageRuntime


class CommandError(Exception):
    """A management command failed (bad name, missing app, ...)."""


@dataclass
class AppDescription:
    app: App
    keys: list[AccessKey] = field(default_factory=list)
    channels: list[Channel] = field(default_factory=list)

    def to_json_dict(self) -> dict:
        """The CLI wire shape for an app."""
        return {
            "id": self.app.id,
            "name": self.app.name,
            "description": self.app.description,
            "accessKeys": [
                {"key": k.key, "events": list(k.events)} for k in self.keys
            ],
            "channels": [{"id": c.id, "name": c.name} for c in self.channels],
        }


def _generate_key() -> str:
    return secrets.token_urlsafe(48)


def app_new(
    storage: StorageRuntime,
    name: str,
    description: str = "",
    access_key: str | None = None,
) -> AppDescription:
    """Create an app + default access key + event namespace."""
    apps = storage.apps()
    if apps.get_by_name(name) is not None:
        raise CommandError(f"App {name} already exists. Aborting.")
    app_id = apps.insert(App(id=0, name=name, description=description))
    if app_id is None:
        raise CommandError(f"Unable to create app {name}.")
    key = AccessKey(key=access_key or _generate_key(), appid=app_id, events=())
    stored = storage.access_keys().insert(key)
    if stored is None:
        raise CommandError("Unable to create default access key.")
    storage.l_events().init(app_id)
    return AppDescription(
        app=App(id=app_id, name=name, description=description),
        keys=[AccessKey(key=stored, appid=app_id, events=())],
    )


def app_list(storage: StorageRuntime) -> list[AppDescription]:
    keys = storage.access_keys()
    channels = storage.channels()
    return [
        AppDescription(
            app=a, keys=keys.get_by_appid(a.id), channels=channels.get_by_appid(a.id)
        )
        for a in sorted(storage.apps().get_all(), key=lambda a: a.name)
    ]


def _require_app(storage: StorageRuntime, name: str) -> App:
    app = storage.apps().get_by_name(name)
    if app is None:
        raise CommandError(f"App {name} does not exist. Aborting.")
    return app


def app_show(storage: StorageRuntime, name: str) -> AppDescription:
    app = _require_app(storage, name)
    return AppDescription(
        app=app,
        keys=storage.access_keys().get_by_appid(app.id),
        channels=storage.channels().get_by_appid(app.id),
    )


def app_delete(storage: StorageRuntime, name: str) -> None:
    """Delete the app with all its channels, keys and events."""
    app = _require_app(storage, name)
    levents = storage.l_events()
    for ch in storage.channels().get_by_appid(app.id):
        levents.remove(app.id, ch.id)
        storage.channels().delete(ch.id)
    levents.remove(app.id)
    for k in storage.access_keys().get_by_appid(app.id):
        storage.access_keys().delete(k.key)
    storage.apps().delete(app.id)


def app_data_delete(
    storage: StorageRuntime,
    name: str,
    channel: str | None = None,
) -> None:
    """Wipe events (of one channel, or of the app and every channel) but
    keep the app."""
    app = _require_app(storage, name)
    levents = storage.l_events()
    if channel is not None:
        ch = _require_channel(storage, app, channel)
        levents.remove(app.id, ch.id)
        levents.init(app.id, ch.id)
        return
    for ch in storage.channels().get_by_appid(app.id):
        levents.remove(app.id, ch.id)
        levents.init(app.id, ch.id)
    levents.remove(app.id)
    levents.init(app.id)


# -- channels ---------------------------------------------------------------


def _require_channel(storage: StorageRuntime, app: App, channel: str) -> Channel:
    for ch in storage.channels().get_by_appid(app.id):
        if ch.name == channel:
            return ch
    raise CommandError(f"Channel {channel} does not exist.")


def channel_new(storage: StorageRuntime, app_name: str, channel: str) -> Channel:
    app = _require_app(storage, app_name)
    if not channel_name_is_valid(channel):
        raise CommandError(
            f"Channel name {channel} is invalid (alphanumeric, '-' and '_' only)."
        )
    for ch in storage.channels().get_by_appid(app.id):
        if ch.name == channel:
            raise CommandError(f"Channel {channel} already exists.")
    channel_id = storage.channels().insert(
        Channel(id=0, name=channel, appid=app.id)
    )
    if channel_id is None:
        raise CommandError(f"Unable to create channel {channel}.")
    storage.l_events().init(app.id, channel_id)
    return Channel(id=channel_id, name=channel, appid=app.id)


def channel_delete(storage: StorageRuntime, app_name: str, channel: str) -> None:
    app = _require_app(storage, app_name)
    ch = _require_channel(storage, app, channel)
    storage.l_events().remove(app.id, ch.id)
    storage.channels().delete(ch.id)


# -- access keys ------------------------------------------------------------


def accesskey_new(
    storage: StorageRuntime,
    app_name: str,
    key: str | None = None,
    events: Iterable[str] = (),
) -> AccessKey:
    app = _require_app(storage, app_name)
    events = tuple(events)
    k = AccessKey(key=key or _generate_key(), appid=app.id, events=events)
    stored = storage.access_keys().insert(k)
    if stored is None:
        raise CommandError("Unable to create access key.")
    return AccessKey(key=stored, appid=app.id, events=events)


def accesskey_list(
    storage: StorageRuntime, app_name: str | None = None
) -> list[AccessKey]:
    if app_name is None:
        return storage.access_keys().get_all()
    app = _require_app(storage, app_name)
    return storage.access_keys().get_by_appid(app.id)


def accesskey_delete(storage: StorageRuntime, key: str) -> None:
    if not storage.access_keys().delete(key):
        raise CommandError(f"Access key {key} does not exist.")


# -- import / export --------------------------------------------------------


def import_events(
    storage: StorageRuntime,
    app_name: str,
    input_path: str | Path,
    channel: str | None = None,
) -> int:
    """JSON-lines events file -> event store.  Returns the number of events
    imported; inserts in batches of 1,000, so big files stream."""
    app = _require_app(storage, app_name)
    channel_id = (
        _require_channel(storage, app, channel).id if channel is not None else None
    )
    levents = storage.l_events()
    levents.init(app.id, channel_id)
    n = 0
    batch: list[Event] = []
    with open(input_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            batch.append(Event.from_api_dict(json.loads(line)))
            if len(batch) >= 1000:
                levents.insert_batch(batch, app.id, channel_id)
                n += len(batch)
                batch = []
    if batch:
        levents.insert_batch(batch, app.id, channel_id)
        n += len(batch)
    return n


def export_events(
    storage: StorageRuntime,
    app_name: str,
    output_path: str | Path,
    channel: str | None = None,
    format: str = "json",
) -> int:
    """Event store -> JSON-lines or parquet file, in the store's
    ``eventTime`` order.  Returns the number of events written."""
    app = _require_app(storage, app_name)
    channel_id = (
        _require_channel(storage, app, channel).id if channel is not None else None
    )
    rows = [
        e.to_api_dict() for e in storage.l_events().find(app.id, channel_id)
    ]
    if format == "parquet":
        try:
            import pyarrow as pa
            import pyarrow.parquet as pq
        except ImportError:
            raise CommandError(
                "parquet export requires pyarrow; use --format json"
            ) from None

        # properties nest arbitrarily: a JSON string column
        flat = [
            {**r, "properties": json.dumps(r.get("properties", {}))} for r in rows
        ]
        pq.write_table(pa.Table.from_pylist(flat), str(output_path))
        return len(flat)
    if format != "json":
        raise CommandError(f"unsupported export format {format!r}")
    with open(output_path, "w") as out:
        for r in rows:
            out.write(json.dumps(r) + "\n")
    return len(rows)
