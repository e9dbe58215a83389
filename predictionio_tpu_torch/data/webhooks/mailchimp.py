"""MailChimp webhook connector (form-encoded payloads); the port's copy of
the JAX package's ``data/webhooks/mailchimp.py``.

Behavior parity with webhooks/mailchimp/MailChimpConnector.scala:35-300: the
six MailChimp webhook types map to events as

  subscribe / unsubscribe / profile  — user -> list
  upemail (email update)             — user (new_id) -> list
  cleaned                            — list entity
  campaign (sending status)          — campaign -> list

``fired_at`` ("yyyy-MM-dd HH:mm:ss", UTC) becomes eventTime; the flattened
``data[...]`` form fields (incl. ``data[merges][...]``) become properties.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Any, Mapping

from predictionio_tpu_torch.data.webhooks import ConnectorException, FormConnector


def parse_mailchimp_datetime(s: str) -> str:
    t = datetime.strptime(s, "%Y-%m-%d %H:%M:%S").replace(tzinfo=timezone.utc)
    return t.isoformat(timespec="milliseconds").replace("+00:00", "Z")


def _props(
    data: Mapping[str, str], names: list[str], merges: bool = False
) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for n in names:
        key = f"data[{n}]"
        if key in data:
            out[n] = data[key]
    if merges:
        m = {
            k[len("data[merges]["):-1]: v
            for k, v in data.items()
            if k.startswith("data[merges][") and k.endswith("]")
        }
        if m:
            out["merges"] = m
    return out


class MailChimpConnector(FormConnector):
    def to_event_json(self, data: Mapping[str, str]) -> dict[str, Any]:
        typ = data.get("type")
        if typ is None:
            raise ConnectorException(
                "The field 'type' is required for MailChimp data."
            )
        try:
            builder = {
                "subscribe": self._user_list_event,
                "unsubscribe": self._user_list_event,
                "profile": self._user_list_event,
                "upemail": self._upemail,
                "cleaned": self._cleaned,
                "campaign": self._campaign,
            }[typ]
        except KeyError:
            raise ConnectorException(
                f"Cannot convert unknown MailChimp data type {typ} to event JSON"
            ) from None
        try:
            return builder(typ, data)
        except KeyError as e:
            raise ConnectorException(
                f"missing MailChimp field {e.args[0]!r} for type {typ}"
            ) from None

    def _base(self, data: Mapping[str, str]) -> dict[str, Any]:
        if "fired_at" not in data:
            raise ConnectorException("The field 'fired_at' is required.")
        try:
            return {"eventTime": parse_mailchimp_datetime(data["fired_at"])}
        except ValueError as e:
            raise ConnectorException(f"bad fired_at timestamp: {e}") from None

    def _user_list_event(self, typ: str, data: Mapping[str, str]) -> dict[str, Any]:
        prop_names = ["email", "email_type", "ip_opt"]
        if typ == "subscribe":
            prop_names.append("ip_signup")
        if typ == "unsubscribe":
            prop_names += ["action", "reason", "campaign_id"]
        return {
            **self._base(data),
            "event": typ,
            "entityType": "user",
            "entityId": data["data[id]"],
            "targetEntityType": "list",
            "targetEntityId": data["data[list_id]"],
            "properties": _props(data, prop_names, merges=True),
        }

    def _upemail(self, typ: str, data: Mapping[str, str]) -> dict[str, Any]:
        return {
            **self._base(data),
            "event": "upemail",
            "entityType": "user",
            "entityId": data["data[new_id]"],
            "targetEntityType": "list",
            "targetEntityId": data["data[list_id]"],
            "properties": _props(
                data, ["new_email", "old_email"]
            ),
        }

    def _cleaned(self, typ: str, data: Mapping[str, str]) -> dict[str, Any]:
        return {
            **self._base(data),
            "event": "cleaned",
            "entityType": "list",
            "entityId": data["data[list_id]"],
            "properties": _props(data, ["campaign_id", "reason", "email"]),
        }

    def _campaign(self, typ: str, data: Mapping[str, str]) -> dict[str, Any]:
        return {
            **self._base(data),
            "event": "campaign",
            "entityType": "campaign",
            "entityId": data["data[id]"],
            "targetEntityType": "list",
            "targetEntityId": data["data[list_id]"],
            "properties": _props(
                data, ["subject", "status", "reason"]
            ),
        }
