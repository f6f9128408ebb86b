"""segment.io spec-v2 webhook → event JSON.

Parity target: ``data/.../webhooks/segmentio/SegmentIOConnector.scala``:
the six message types (identify/track/alias/page/screen/group) map to an
event named after the type, entityType ``user``, entityId from
``userId``/``anonymousId``, eventTime from ``timestamp``, and
type-specific properties (plus the ``context`` object when present).

The port's copy of ``predictionio_tpu/data/webhooks/segmentio.py``.
"""

from __future__ import annotations

from typing import Optional

from predictionio_tpu_torch.data import webhooks


class SegmentIOConnector(webhooks.JsonConnector):

    def to_event_json(self, data: dict) -> dict:
        if "version" not in data:
            raise webhooks.ConnectorException(
                "Failed to get segment.io API version.")
        typ = data.get("type")
        extractor = {
            "identify": self._identify,
            "track": self._track,
            "alias": self._alias,
            "page": self._page,
            "screen": self._screen,
            "group": self._group,
        }.get(typ or "")
        if extractor is None:
            raise webhooks.ConnectorException(
                f"Cannot convert unknown type {typ} to event JSON.")
        try:
            props = extractor(data)
        except KeyError as e:
            raise webhooks.ConnectorException(
                f"Cannot convert {data} to event JSON. missing field {e}")
        return self._to_json(data, typ, props)

    # -- per-type event properties (SegmentIOConnector.scala:103-146) ------
    def _identify(self, data: dict) -> dict:
        return {"traits": data.get("traits")}

    def _track(self, data: dict) -> dict:
        return {"properties": data.get("properties"),
                "event": data["event"]}

    def _alias(self, data: dict) -> dict:
        return {"previous_id": data["previousId"]
                if "previousId" in data else data["previous_id"]}

    def _page(self, data: dict) -> dict:
        return {"name": data.get("name"),
                "properties": data.get("properties")}

    def _screen(self, data: dict) -> dict:
        return {"name": data.get("name"),
                "properties": data.get("properties")}

    def _group(self, data: dict) -> dict:
        return {"group_id": data.get("groupId", data.get("group_id")),
                "traits": data.get("traits")}

    def _to_json(self, data: dict, typ: str, event_props: dict) -> dict:
        user_id: Optional[str] = (
            data.get("user_id") or data.get("userId")
            or data.get("anonymous_id") or data.get("anonymousId"))
        if user_id is None:
            raise webhooks.ConnectorException(
                "there was no `userId` or `anonymousId` in the common fields.")
        properties = {k: v for k, v in event_props.items() if v is not None}
        context = data.get("context")
        if context is not None:
            properties["context"] = context
        return {
            "event": typ,
            "entityType": "user",
            "entityId": str(user_id),
            "eventTime": data.get("timestamp"),
            "properties": properties,
        }
