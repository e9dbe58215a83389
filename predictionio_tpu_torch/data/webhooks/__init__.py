"""Webhook connectors: transform third-party payloads into Event JSON.

The port's copy of the JAX package's ``data/webhooks/__init__.py``.

Mirrors data/.../webhooks/{JsonConnector,FormConnector}.scala:26 and the
connector registry (data/api/WebhooksConnectors.scala): a JSON connector maps
a JSON object to Event-API JSON; a form connector maps urlencoded form fields
the same way.  The produced dict is then parsed/validated through
``Event.from_api_dict`` (ConnectorUtil.toEvent's role).
"""

from __future__ import annotations

import abc
from typing import Any, Mapping

from predictionio_tpu_torch.data.event import Event


class ConnectorException(Exception):
    """Payload cannot be transformed (webhooks/ConnectorException.scala)."""


class JsonConnector(abc.ABC):
    @abc.abstractmethod
    def to_event_json(self, data: Mapping[str, Any]) -> dict[str, Any]: ...


class FormConnector(abc.ABC):
    @abc.abstractmethod
    def to_event_json(self, data: Mapping[str, str]) -> dict[str, Any]: ...


def to_event(connector, data) -> Event:
    """ConnectorUtil.toEvent: transform then parse as API event JSON."""
    from predictionio_tpu_torch.data.event import EventValidationError

    event_json = connector.to_event_json(data)
    try:
        return Event.from_api_dict(event_json)
    except EventValidationError as e:
        raise ConnectorException(
            f"connector produced invalid event JSON: {e}"
        ) from e


def json_connectors() -> dict[str, JsonConnector]:
    """Shipped JSON connectors (WebhooksConnectors.json)."""
    from predictionio_tpu_torch.data.webhooks.segmentio import SegmentIOConnector

    return {"segmentio": SegmentIOConnector()}


def form_connectors() -> dict[str, FormConnector]:
    """Shipped form connectors (WebhooksConnectors.form)."""
    from predictionio_tpu_torch.data.webhooks.mailchimp import MailChimpConnector

    return {"mailchimp": MailChimpConnector()}
