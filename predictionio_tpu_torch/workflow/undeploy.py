"""``POST /stop`` to a running query server (``pio undeploy``).

Kept apart from :mod:`~predictionio_tpu_torch.workflow.create_server`,
which imports torch, so that ``pio undeploy`` starts without it;
``create_server`` re-exports :func:`undeploy`.
"""

from __future__ import annotations

import logging
import ssl
import urllib.error
import urllib.request

logger = logging.getLogger("pio.torch.queryserver")


def undeploy(ip: str, port: int, scheme: str = "http") -> bool:
    """``POST /stop`` to the server at ``ip:port``; True when something
    answered. With ``scheme="https"`` the certificate is not verified:
    the probe talks to a local (commonly self-signed) server, and its
    only action is asking it to stop."""
    host = "127.0.0.1" if ip == "0.0.0.0" else ip
    kwargs = {}
    if scheme == "https":
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        kwargs["context"] = ctx
    try:
        req = urllib.request.Request(f"{scheme}://{host}:{port}/stop",
                                     data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=3, **kwargs) as resp:
            logger.info("Undeployed the server at %s:%d (%d)", host, port,
                        resp.status)
            return True
    except (urllib.error.URLError, OSError):
        return False
