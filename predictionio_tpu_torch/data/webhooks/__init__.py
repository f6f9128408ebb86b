"""Third-party event ingestion connectors.

Parity target: ``data/.../webhooks/`` — ``JsonConnector``/``FormConnector``
traits, the segment.io JSON connector and the MailChimp form connector,
and the registry consulted by the event server's ``/webhooks/<name>``
routes (``api/WebhooksConnectors.scala:26-32``).

Connectors emit event JSON (a plain dict), never ``Event`` objects — the
server parses the JSON through the one canonical path so validation is
uniform (``ConnectorUtil.scala:33-45``).

The port's copy of ``predictionio_tpu/data/webhooks/__init__.py``.
"""

from __future__ import annotations

import abc
from typing import Dict


class ConnectorException(ValueError):
    """Malformed/unsupported third-party payload (ConnectorException.scala)."""


class JsonConnector(abc.ABC):
    @abc.abstractmethod
    def to_event_json(self, data: dict) -> dict: ...


class FormConnector(abc.ABC):
    @abc.abstractmethod
    def to_event_json(self, data: Dict[str, str]) -> dict: ...


from predictionio_tpu_torch.data.webhooks.mailchimp import MailChimpConnector  # noqa: E402
from predictionio_tpu_torch.data.webhooks.segmentio import SegmentIOConnector  # noqa: E402

JSON_CONNECTORS: Dict[str, JsonConnector] = {
    "segmentio": SegmentIOConnector(),
}

FORM_CONNECTORS: Dict[str, FormConnector] = {
    "mailchimp": MailChimpConnector(),
}
