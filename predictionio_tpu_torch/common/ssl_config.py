"""TLS context construction for the HTTP daemons.

Parity: ``SSLConfiguration.scala:28-72`` — the reference loads a JKS
keystore named in ``server.conf`` and builds a TLS context for spray's
HTTPS binding. Here the PEM cert/key files named in ``server.json``
build an ``ssl.SSLContext``; any server's listening socket can be wrapped
with it (``wrap_server``).

The port's copy of ``predictionio_tpu/common/ssl_config.py``.
"""

from __future__ import annotations

import ssl
from typing import Optional

from predictionio_tpu_torch.common.auth import ServerConfig


class SSLConfiguration:
    def __init__(self, config: Optional[ServerConfig] = None):
        self.config = config or ServerConfig()

    @property
    def enabled(self) -> bool:
        return bool(self.config.ssl_certfile)

    def ssl_context(self) -> ssl.SSLContext:
        """Server-side TLS context (SSLConfiguration.scala:50-61). Modern
        defaults (TLS 1.2+) replace the reference's 2015-era cipher list."""
        if not self.enabled:
            raise ValueError("ssl.certfile is not configured in server.json")
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
        ctx.load_cert_chain(
            certfile=self.config.ssl_certfile,
            keyfile=self.config.ssl_keyfile,
            password=self.config.ssl_password,
        )
        return ctx

    def wrap_server(self, httpd, handshake_timeout: float = 10.0) -> None:
        """Wrap an ``http.server`` instance's listening socket in TLS.

        The handshake is deferred off the accept loop
        (``do_handshake_on_connect=False``) and performed — with a
        timeout — where the connection is handled (the worker thread
        under ThreadingMixIn). Otherwise a single client that connects
        and sends nothing would pin ``accept()`` inside the handshake
        and block every other connection."""
        httpd.socket = self.ssl_context().wrap_socket(
            httpd.socket, server_side=True, do_handshake_on_connect=False)
        orig_finish = httpd.finish_request

        def finish_request(request, client_address):
            request.settimeout(handshake_timeout)
            try:
                request.do_handshake()
            except (OSError, ssl.SSLError):
                httpd.shutdown_request(request)
                return
            request.settimeout(None)
            orig_finish(request, client_address)

        httpd.finish_request = finish_request
