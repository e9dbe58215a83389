"""The port's webhook connectors against the JAX package's, on the CPU.

The payloads of ``tests/test_event_server.py`` (a segment.com ``track``,
an unknown type, a MailChimp ``subscribe`` form, a ``fired_at`` in ISO
form) and one of every message type either connector knows, with the bad
ones (no version, no user id, an unknown type, missing fields, a bad
time), go through both packages' ``to_event``: each must give the same
event (API JSON, ``creationTime`` aside) or the same error message.
"""

from __future__ import annotations

import pytest

from predictionio_tpu.data import webhooks as jax_wh
from predictionio_tpu_torch.data import webhooks as pt_wh

SEGMENT = [
    # tests/test_event_server.py
    {"version": "2", "type": "track", "userId": "user42", "event": "Signed Up",
     "properties": {"plan": "Pro"}, "timestamp": "2026-01-05T10:00:00.000Z"},
    {"version": "2", "type": "frobnicate", "userId": "u"},
    # every type, camelCase and snake_case fields, context, anonymousId
    {"version": "2", "type": "identify", "userId": "u1",
     "traits": {"name": "Ada", "age": 36}, "timestamp": "2026-01-05T10:00:00Z",
     "context": {"ip": "8.8.8.8"}},
    {"version": "2", "type": "alias", "anonymousId": "anon-7",
     "previousId": "old-7", "timestamp": "2026-01-05T10:00:01.250+01:00"},
    {"version": "2", "type": "alias", "userId": "u2", "previous_id": "old-2",
     "timestamp": "2026-01-05T10:00:02.000Z"},
    {"version": "2", "type": "page", "userId": "u3", "name": "Home",
     "properties": {"path": "/"}, "timestamp": "2026-01-05T10:00:03.000Z"},
    {"version": "2", "type": "screen", "userId": "u4", "name": "Cart",
     "timestamp": "2026-01-05T10:00:04.000Z"},
    {"version": "2", "type": "group", "userId": "u5", "groupId": "g1",
     "traits": {"size": 3}, "timestamp": "2026-01-05T10:00:05.000Z"},
    {"version": "2", "type": "group", "userId": "u6", "group_id": "g2",
     "timestamp": "2026-01-05T10:00:06.000Z"},
    {"version": 1, "type": "track", "userId": 17, "event": "Bought",
     "timestamp": "2026-01-05T10:00:07.000Z"},
    # bad ones
    {"type": "track", "userId": "u1"},
    {"version": "2", "type": "track"},
    {"version": "2", "type": "track", "userId": "", "anonymousId": ""},
    {"version": "2", "userId": "u1"},
    {"version": "2", "type": "track", "userId": "u1", "timestamp": "not a time"},
    {"version": "2", "type": "track", "userId": "u1", "properties": "not a map",
     "timestamp": "2026-01-05T10:00:08.000Z"},
]

_SUB = {
    "type": "subscribe",
    "fired_at": "2026-03-26 21:35:57",
    "data[id]": "8a25ff1d98",
    "data[list_id]": "a6b5da1054",
    "data[email]": "api@example.com",
    "data[email_type]": "html",
    "data[merges][EMAIL]": "api@example.com",
    "data[merges][FNAME]": "Mail",
    "data[ip_opt]": "10.20.10.30",
    "data[ip_signup]": "10.20.10.30",
}

MAILCHIMP = [
    # tests/test_event_server.py
    _SUB,
    {"type": "subscribe", "fired_at": "2026-03-26T21:35:57",
     "data[id]": "x", "data[list_id]": "y"},
    # every type
    {**_SUB, "type": "unsubscribe", "data[action]": "unsub",
     "data[reason]": "manual", "data[campaign_id]": "cb398d21d2"},
    {**_SUB, "type": "profile"},
    {"type": "upemail", "fired_at": "2026-03-26 22:15:09",
     "data[list_id]": "a6b5da1054", "data[new_id]": "51da8c3259",
     "data[new_email]": "new@example.com", "data[old_email]": "old@example.com"},
    {"type": "cleaned", "fired_at": "2026-03-26 22:01:00",
     "data[list_id]": "a6b5da1054", "data[campaign_id]": "4fjk2ma9xd",
     "data[reason]": "hard", "data[email]": "gone@example.com"},
    {"type": "campaign", "fired_at": "2026-03-26 21:31:21", "data[id]": "5aa2102003",
     "data[subject]": "Test Campaign Subject", "data[status]": "sent",
     "data[reason]": "", "data[list_id]": "a6b5da1054"},
    {"type": "subscribe", "fired_at": "2026-03-26 21:35:57",
     "data[id]": "bare", "data[list_id]": "l"},
    # bad ones
    {"fired_at": "2026-03-26 21:35:57", "data[id]": "x", "data[list_id]": "y"},
    {"type": "frobnicate", "fired_at": "2026-03-26 21:35:57"},
    {"type": "subscribe", "data[id]": "x", "data[list_id]": "y"},
    {"type": "subscribe", "fired_at": "2026-03-26 21:35:57", "data[list_id]": "y"},
    {"type": "upemail", "fired_at": "2026-03-26 21:35:57", "data[list_id]": "y"},
    {"type": "cleaned", "fired_at": "yesterday", "data[list_id]": "y"},
    {"type": "campaign", "fired_at": "2026-13-26 21:35:57", "data[id]": "c",
     "data[list_id]": "y"},
]


def _convert(wh, connectors, name, payload):
    """("event", API JSON without creationTime) or ("error", type, message)."""
    try:
        event = wh.to_event(connectors()[name], payload)
    except Exception as e:
        return ("error", type(e).__name__, str(e))
    d = event.to_api_dict()
    d.pop("creationTime")
    d.pop("eventId", None)
    return ("event", d)


@pytest.mark.parametrize("payload", SEGMENT, ids=range(len(SEGMENT)))
def test_segmentio_converts_as_jax(payload):
    want = _convert(jax_wh, jax_wh.json_connectors, "segmentio", payload)
    got = _convert(pt_wh, pt_wh.json_connectors, "segmentio", payload)
    assert got == want


@pytest.mark.parametrize("payload", MAILCHIMP, ids=range(len(MAILCHIMP)))
def test_mailchimp_converts_as_jax(payload):
    want = _convert(jax_wh, jax_wh.form_connectors, "mailchimp", payload)
    got = _convert(pt_wh, pt_wh.form_connectors, "mailchimp", payload)
    assert got == want


def test_registries_name_the_same_connectors():
    assert set(pt_wh.json_connectors()) == set(jax_wh.json_connectors()) == {"segmentio"}
    assert set(pt_wh.form_connectors()) == set(jax_wh.form_connectors()) == {"mailchimp"}


def test_the_reference_payloads_give_events():
    """The JAX package's test payloads: a track becomes a ``track`` event of
    its user, the subscribe form a user -> list event with its merges."""
    _, track = _convert(pt_wh, pt_wh.json_connectors, "segmentio", SEGMENT[0])
    assert (track["event"], track["entityId"], track["properties"]["event"]) == (
        "track", "user42", "Signed Up")
    _, sub = _convert(pt_wh, pt_wh.form_connectors, "mailchimp", MAILCHIMP[0])
    assert (sub["event"], sub["entityId"], sub["targetEntityId"]) == (
        "subscribe", "8a25ff1d98", "a6b5da1054")
    assert sub["properties"]["merges"]["FNAME"] == "Mail"
    assert sub["eventTime"] == "2026-03-26T21:35:57.000Z"
    for bad in (SEGMENT[1], *SEGMENT[10:14]):
        assert _convert(pt_wh, pt_wh.json_connectors, "segmentio", bad)[1] == (
            "ConnectorException")
