"""Event-server plugin SPI — input blockers and sniffers.

Parity target: ``data/.../api/EventServerPlugin.scala`` +
``EventServerPluginContext.scala``. The JVM ``ServiceLoader`` discovery is
replaced by an explicit registry; the sniffer actor mailbox by
direct calls — sniffers must be cheap/non-blocking by contract.

The port's copy of ``predictionio_tpu/data/api/plugins.py``.
"""

from __future__ import annotations

import abc
import logging
from typing import Dict, List, Optional

from predictionio_tpu_torch.data.event import Event

INPUT_BLOCKER = "inputblocker"
INPUT_SNIFFER = "inputsniffer"


class EventInfo:
    """What a plugin sees per event (EventServerPlugin.scala:21-27)."""

    def __init__(self, app_id: int, channel_id: Optional[int], event: Event):
        self.app_id = app_id
        self.channel_id = channel_id
        self.event = event


class EventServerPlugin(abc.ABC):
    """An input blocker (may veto by raising) or sniffer (observe only)."""

    plugin_name: str = ""
    plugin_description: str = ""
    plugin_type: str = INPUT_SNIFFER

    @abc.abstractmethod
    def process(self, event_info: EventInfo,
                context: "EventServerPluginContext") -> None:
        """Blockers raise ValueError to reject the event; sniffers observe."""

    def handle_rest(self, app_id: int, channel_id: Optional[int],
                    args: List[str]) -> str:
        """GET /plugins/<type>/<name>/... hook (EventServerPlugin.scala:36-39)."""
        return "{}"


class EventServerPluginContext:
    """Registry of active plugins, split by type
    (EventServerPluginContext.scala:36-58)."""

    def __init__(self, plugins: Optional[List[EventServerPlugin]] = None,
                 logger: Optional[logging.Logger] = None):
        self.logger = logger or logging.getLogger("pio.eventserver.plugins")
        self.input_blockers: Dict[str, EventServerPlugin] = {}
        self.input_sniffers: Dict[str, EventServerPlugin] = {}
        for p in plugins or []:
            self.register(p)

    def register(self, plugin: EventServerPlugin) -> None:
        target = (self.input_blockers
                  if plugin.plugin_type == INPUT_BLOCKER
                  else self.input_sniffers)
        target[plugin.plugin_name] = plugin

    def describe(self) -> Dict[str, Dict[str, Dict[str, str]]]:
        """Wire shape of GET /plugins.json (EventServer.scala:155-174)."""
        def block(ps: Dict[str, EventServerPlugin]):
            return {
                n: {
                    "name": p.plugin_name,
                    "description": p.plugin_description,
                    "class": type(p).__module__ + "." + type(p).__qualname__,
                }
                for n, p in ps.items()
            }
        return {"plugins": {
            "inputblockers": block(self.input_blockers),
            "inputsniffers": block(self.input_sniffers),
        }}
