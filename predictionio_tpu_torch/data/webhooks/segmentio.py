"""segment.com webhook connector (the port's copy of the JAX package's
``data/webhooks/segmentio.py``).

Behavior parity with webhooks/segmentio/SegmentIOConnector.scala: the six
Segment spec message types (identify / track / alias / page / screen / group)
become user-entity events named after the message type, with type-specific
fields plus the optional ``context`` object folded into ``properties``.
The entity id is ``userId``, falling back to ``anonymousId``.
"""

from __future__ import annotations

from typing import Any, Mapping

from predictionio_tpu_torch.data.webhooks import ConnectorException, JsonConnector

#: type -> fields lifted into properties (name -> payload key)
_TYPE_FIELDS: dict[str, dict[str, str]] = {
    "identify": {"traits": "traits"},
    "track": {"properties": "properties", "event": "event"},
    "alias": {"previous_id": "previousId"},
    "page": {"name": "name", "properties": "properties"},
    "screen": {"name": "name", "properties": "properties"},
    "group": {"group_id": "groupId", "traits": "traits"},
}


class SegmentIOConnector(JsonConnector):
    def to_event_json(self, data: Mapping[str, Any]) -> dict[str, Any]:
        if "version" not in data:
            raise ConnectorException("Failed to get segment.io API version.")
        typ = data.get("type")
        if typ not in _TYPE_FIELDS:
            raise ConnectorException(
                f"Cannot convert unknown type {typ} to event JSON."
            )
        user_id = data.get("userId") or data.get("anonymousId")
        if not user_id:
            raise ConnectorException(
                "there was no `userId` or `anonymousId` in the common fields."
            )

        properties: dict[str, Any] = {}
        for prop_name, key in _TYPE_FIELDS[typ].items():
            # Segment payloads may use either snake_case (reference fixtures)
            # or the spec's camelCase — accept both.
            snake = _snake(key)
            value = data.get(key, data.get(snake))
            if value is not None:
                properties[prop_name] = value
        context = data.get("context")
        if context is not None:
            properties["context"] = context

        event_json: dict[str, Any] = {
            "event": typ,
            "entityType": "user",
            "entityId": str(user_id),
            "properties": properties,
        }
        if data.get("timestamp"):
            event_json["eventTime"] = data["timestamp"]
        return event_json


def _snake(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)
