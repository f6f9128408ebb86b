"""Online fold-in: fresh user factors inside the deployed server.

The port's copy of ``predictionio_tpu/online``. Everything upstream is
batch: a new user, or a just-ingested event, is invisible to serving
until the next ``pio train`` and redeploy. A background consumer tails
the event stream of the deployment's (app, channel) through the store's
cursor reads (``LEvents.tail_cursor`` / ``find_since``: memory, sqlite
and ``jsonlfs``), marks the users its rating events touch, and on a
cadence solves those users' rows against the FIXED item factors
(:func:`predictionio_tpu_torch.ops.als.fold_in_users`, the training
half-step through the two training kernels) and patches them into the
live :class:`~predictionio_tpu_torch.ops.serving.DeviceTopK` store. New
users are servable within seconds of their first events, with no
``/reload`` and no retrain.
"""

from predictionio_tpu_torch.online.foldin import (  # noqa: F401
    CompositeFoldInConsumer,
    FoldInConfig,
    FoldInConsumer,
    attach_foldin,
)
