"""Event-collection REST layer (reference ``data/.../api/``)."""

from predictionio_tpu_torch.data.api.event_server import (  # noqa: F401
    EventServer,
    EventServerConfig,
    create_event_server,
)
from predictionio_tpu_torch.data.api.plugins import (  # noqa: F401
    EventServerPlugin,
    EventServerPluginContext,
)
from predictionio_tpu_torch.data.api.stats import Stats, StatsKeeper  # noqa: F401
