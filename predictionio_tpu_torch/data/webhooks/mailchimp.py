"""MailChimp form-encoded webhook → event JSON.

Parity target: ``data/.../webhooks/mailchimp/MailChimpConnector.scala`` —
the six types (subscribe/unsubscribe/profile/upemail/cleaned/campaign)
with the same entity/target mapping and property layout; ``fired_at``
("yyyy-MM-dd HH:mm:ss", UTC) becomes ISO-8601 eventTime.

The port's copy of ``predictionio_tpu/data/webhooks/mailchimp.py``.
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict

from predictionio_tpu_torch.data import webhooks

UTC = _dt.timezone.utc


def parse_mailchimp_datetime(s: str) -> str:
    try:
        t = _dt.datetime.strptime(s, "%Y-%m-%d %H:%M:%S").replace(tzinfo=UTC)
    except ValueError as e:
        raise webhooks.ConnectorException(f"invalid fired_at: {s!r} ({e})")
    return t.isoformat()


class MailChimpConnector(webhooks.FormConnector):

    def to_event_json(self, data: Dict[str, str]) -> dict:
        typ = data.get("type")
        handler = {
            "subscribe": self._subscribe,
            "unsubscribe": self._unsubscribe,
            "profile": self._profile,
            "upemail": self._upemail,
            "cleaned": self._cleaned,
            "campaign": self._campaign,
        }.get(typ or "")
        if typ is None:
            raise webhooks.ConnectorException(
                "The field 'type' is required for MailChimp data.")
        if handler is None:
            raise webhooks.ConnectorException(
                f"Cannot convert unknown MailChimp data type {typ} "
                "to event JSON")
        try:
            return handler(data)
        except KeyError as e:
            raise webhooks.ConnectorException(
                f"MailChimp {typ} data is missing field {e}")

    def _merges(self, data: Dict[str, str]) -> dict:
        merges = {
            "EMAIL": data["data[merges][EMAIL]"],
            "FNAME": data["data[merges][FNAME]"],
            "LNAME": data["data[merges][LNAME]"],
        }
        if "data[merges][INTERESTS]" in data:
            merges["INTERESTS"] = data["data[merges][INTERESTS]"]
        return merges

    def _subscribe(self, data: Dict[str, str]) -> dict:
        return {
            "event": "subscribe",
            "entityType": "user",
            "entityId": data["data[id]"],
            "targetEntityType": "list",
            "targetEntityId": data["data[list_id]"],
            "eventTime": parse_mailchimp_datetime(data["fired_at"]),
            "properties": {
                "email": data["data[email]"],
                "email_type": data["data[email_type]"],
                "merges": self._merges(data),
                "ip_opt": data["data[ip_opt]"],
                "ip_signup": data["data[ip_signup]"],
            },
        }

    def _unsubscribe(self, data: Dict[str, str]) -> dict:
        return {
            "event": "unsubscribe",
            "entityType": "user",
            "entityId": data["data[id]"],
            "targetEntityType": "list",
            "targetEntityId": data["data[list_id]"],
            "eventTime": parse_mailchimp_datetime(data["fired_at"]),
            "properties": {
                "action": data["data[action]"],
                "reason": data["data[reason]"],
                "email": data["data[email]"],
                "email_type": data["data[email_type]"],
                "merges": self._merges(data),
                "ip_opt": data["data[ip_opt]"],
                "campaign_id": data["data[campaign_id]"],
            },
        }

    def _profile(self, data: Dict[str, str]) -> dict:
        return {
            "event": "profile",
            "entityType": "user",
            "entityId": data["data[id]"],
            "targetEntityType": "list",
            "targetEntityId": data["data[list_id]"],
            "eventTime": parse_mailchimp_datetime(data["fired_at"]),
            "properties": {
                "email": data["data[email]"],
                "email_type": data["data[email_type]"],
                "merges": self._merges(data),
                "ip_opt": data["data[ip_opt]"],
            },
        }

    def _upemail(self, data: Dict[str, str]) -> dict:
        return {
            "event": "upemail",
            "entityType": "user",
            "entityId": data["data[new_id]"],
            "targetEntityType": "list",
            "targetEntityId": data["data[list_id]"],
            "eventTime": parse_mailchimp_datetime(data["fired_at"]),
            "properties": {
                "new_email": data["data[new_email]"],
                "old_email": data["data[old_email]"],
            },
        }

    def _cleaned(self, data: Dict[str, str]) -> dict:
        return {
            "event": "cleaned",
            "entityType": "list",
            "entityId": data["data[list_id]"],
            "eventTime": parse_mailchimp_datetime(data["fired_at"]),
            "properties": {
                "campaignId": data["data[campaign_id]"],
                "reason": data["data[reason]"],
                "email": data["data[email]"],
            },
        }

    def _campaign(self, data: Dict[str, str]) -> dict:
        return {
            "event": "campaign",
            "entityType": "campaign",
            "entityId": data["data[id]"],
            "targetEntityType": "list",
            "targetEntityId": data["data[list_id]"],
            "eventTime": parse_mailchimp_datetime(data["fired_at"]),
            "properties": {
                "subject": data["data[subject]"],
                "status": data["data[status]"],
                "reason": data["data[reason]"],
            },
        }
