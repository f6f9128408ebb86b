"""Server access-key authentication.

Parity: ``KeyAuthentication.scala:33-56`` — the dashboard (and optionally
other daemons) require a server-level access key configured in a file,
matched against the ``accessKey`` query parameter of every request. An
empty/absent configured key means auth is disabled (open server), which is
the behavior the reference gets from a blank ``server.conf`` template.

The port's copy of ``predictionio_tpu/common/auth.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Optional, Sequence

DEFAULT_CONFIG_FILE = "server.json"
ACCESS_KEY_PARAM = "accessKey"  # ServerKey.param


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """The ``server.conf`` analog (io.prediction.server.* keys).

    JSON file shape::

        {"accessKey": "...",
         "ssl": {"certfile": "server.pem", "keyfile": "key.pem",
                 "password": null}}
    """

    access_key: str = ""
    ssl_certfile: Optional[str] = None
    ssl_keyfile: Optional[str] = None
    ssl_password: Optional[str] = None

    @classmethod
    def load(cls, path: Optional[str] = None) -> "ServerConfig":
        """Load from ``path`` (or ``$PIO_SERVER_CONFIG`` or ./server.json);
        missing file -> defaults (open server, no TLS)."""
        path = path or os.environ.get("PIO_SERVER_CONFIG",
                                      DEFAULT_CONFIG_FILE)
        if not os.path.exists(path):
            return cls()
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
        ssl_cfg = raw.get("ssl") or {}
        return cls(
            access_key=str(raw.get("accessKey", "") or ""),
            ssl_certfile=ssl_cfg.get("certfile"),
            ssl_keyfile=ssl_cfg.get("keyfile"),
            ssl_password=ssl_cfg.get("password"),
        )


class KeyAuthentication:
    """Request authentication against the configured server key."""

    def __init__(self, config: Optional[ServerConfig] = None):
        self.config = config or ServerConfig()

    @property
    def enabled(self) -> bool:
        return bool(self.config.access_key)

    def authenticate(self, params: Mapping[str, Sequence[str]]) -> bool:
        """True iff auth is disabled or the ``accessKey`` query parameter
        matches (KeyAuthentication.scala:40-55)."""
        if not self.enabled:
            return True
        passed = params.get(ACCESS_KEY_PARAM, [])
        return bool(passed) and passed[0] == self.config.access_key
