"""Engine-server plugins: output blockers and sniffers.

The port's copy of ``predictionio_tpu/workflow/server_plugins.py``
(after ``EngineServerPlugin.scala`` and
``EngineServerPluginContext.scala``): an explicit registry in place of
ServiceLoader discovery, and direct calls in place of the plugins
actor. A blocker may rewrite each prediction's JSON; a sniffer sees it.
"""

from __future__ import annotations

import abc
import logging
from typing import Any, Dict, List, Optional

OUTPUT_BLOCKER = "outputblocker"
OUTPUT_SNIFFER = "outputsniffer"


class EngineServerPlugin(abc.ABC):
    """Transforms (blocker) or observes (sniffer) query-server output."""

    plugin_name: str = ""
    plugin_description: str = ""
    plugin_type: str = OUTPUT_SNIFFER

    @abc.abstractmethod
    def process(self, engine_instance, query: Any, prediction: Any,
                context: "EngineServerPluginContext") -> Any:
        """Blockers return the (possibly rewritten) prediction JSON;
        sniffers' return value is ignored."""

    def handle_rest(self, args: List[str]) -> str:
        return "{}"


class EngineServerPluginContext:
    """The active plugins, split by type."""

    def __init__(self, plugins: Optional[List[EngineServerPlugin]] = None,
                 logger: Optional[logging.Logger] = None):
        self.logger = logger or logging.getLogger(
            "pio.torch.queryserver.plugins")
        self.output_blockers: Dict[str, EngineServerPlugin] = {}
        self.output_sniffers: Dict[str, EngineServerPlugin] = {}
        for p in plugins or []:
            self.register(p)

    def register(self, plugin: EngineServerPlugin) -> None:
        target = (self.output_blockers
                  if plugin.plugin_type == OUTPUT_BLOCKER
                  else self.output_sniffers)
        target[plugin.plugin_name] = plugin

    def describe(self) -> Dict[str, Any]:
        """The body of ``GET /plugins.json``."""
        def block(ps: Dict[str, EngineServerPlugin]):
            return {
                n: {
                    "name": p.plugin_name,
                    "description": p.plugin_description,
                    "class": type(p).__module__ + "." + type(p).__qualname__,
                }
                for n, p in ps.items()
            }
        return {"plugins": {
            "outputblockers": block(self.output_blockers),
            "outputsniffers": block(self.output_sniffers),
        }}
