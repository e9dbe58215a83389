"""App and event-import commands (tools/commands/App.scala:31-90,
imprt/FileToEvents.scala:44): the part of the JAX package's
``tools/commands.py`` that the train path needs.  Creating an app provisions
a default access key and the app's event table.
"""

from __future__ import annotations

import json
import secrets
from dataclasses import dataclass, field
from pathlib import Path

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import AccessKey, App, Channel
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


def _require_app(storage: StorageRuntime, name: str) -> App:
    app = storage.apps().get_by_name(name)
    if app is None:
        raise CommandError(f"App {name} does not exist. Aborting.")
    return app


def _require_channel(storage: StorageRuntime, app: App, channel: str) -> Channel:
    for ch in storage.channels().get_by_appid(app.id):
        if ch.name == channel:
            return ch
    raise CommandError(f"Channel {channel} does not exist.")


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
