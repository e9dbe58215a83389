"""Event store facade for engine components.

The training half of the JAX package's ``data/store.py``
(store/{PEventStore,Common}.scala): components refer to apps by *name*; the
facade resolves name -> (appId, channelId) through the metadata store and
returns columnar EventFrames from the bulk DAO.
"""

from __future__ import annotations

from datetime import datetime
from typing import Sequence

from predictionio_tpu_torch.data.storage.base import EventFilter, EventFrame
from predictionio_tpu_torch.data.storage.config import StorageRuntime, get_storage


class AppNotFoundError(KeyError):
    pass


class ChannelNotFoundError(KeyError):
    pass


def resolve_app(
    app_name: str, channel_name: str | None = None, storage: StorageRuntime | None = None
) -> tuple[int, int | None]:
    """Resolve app/channel names to ids (store/Common.scala)."""
    storage = storage or get_storage()
    app = storage.apps().get_by_name(app_name)
    if app is None:
        raise AppNotFoundError(f"Invalid app name {app_name!r}")
    if channel_name is None:
        return app.id, None
    for ch in storage.channels().get_by_appid(app.id):
        if ch.name == channel_name:
            return app.id, ch.id
    raise ChannelNotFoundError(
        f"Invalid channel name {channel_name!r} for app {app_name!r}"
    )


class PEventStore:
    """Bulk columnar reads for DataSources (store/PEventStore.scala:40,75)."""

    def __init__(self, storage: StorageRuntime | None = None):
        self.storage = storage or get_storage()

    def find(
        self,
        app_name: str,
        channel_name: str | None = None,
        start_time: datetime | None = None,
        until_time: datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: Sequence[str] | None = None,
        target_entity_type: str | None = None,
        target_entity_id: str | None = None,
    ) -> EventFrame:
        app_id, channel_id = resolve_app(app_name, channel_name, self.storage)
        return self.storage.p_events().find(
            app_id,
            channel_id,
            EventFilter(
                start_time=start_time,
                until_time=until_time,
                entity_type=entity_type,
                entity_id=entity_id,
                event_names=tuple(event_names) if event_names else None,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id,
            ),
        )
