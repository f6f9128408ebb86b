"""Shared server infrastructure: access-key auth + TLS configuration.

Parity targets: ``common/.../authentication/KeyAuthentication.scala:33-56``
(server access key loaded from ``server.conf``, checked against the
``accessKey`` query parameter) and
``common/.../configuration/SSLConfiguration.scala:28-72`` (JKS keystore ->
TLS context for the spray servers). The JVM pieces map to their Python
equivalents: typesafe-config ``server.conf`` becomes a JSON ``server.json``,
the JKS keystore becomes PEM cert/key files loaded into ``ssl.SSLContext``.

The port's copy of ``predictionio_tpu/common/__init__.py``.
"""

from predictionio_tpu_torch.common.auth import KeyAuthentication, ServerConfig
from predictionio_tpu_torch.common.ssl_config import SSLConfiguration

__all__ = ["KeyAuthentication", "ServerConfig", "SSLConfiguration"]
