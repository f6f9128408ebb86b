"""Version compatibility shims.

``parse_iso8601`` — one ISO-8601 parsing path for the whole codebase.
Python 3.11+ ``datetime.fromisoformat`` accepts most ISO-8601 variants,
but 3.10 only parses exactly what ``isoformat()`` emits: no ``Z``
suffix, fractional seconds must be exactly 3 or 6 digits, and the UTC
offset needs a colon. Event producers (and the reference's Joda-based
wire format) routinely emit ``...T12:00:00Z`` or ``.1``/``.1234567``
fractions, so every caller that parsed timestamps directly hit
``ValueError`` on 3.10. All ISO parsing routes through here instead.

The port's copy of ``predictionio_tpu/utils/compat.py``,
unchanged but for its imports.
"""

from __future__ import annotations

import datetime as _dt
import re

# a fraction is only legal after explicit seconds: ISO-8601 fractional
# MINUTES ("12:30.5" = 12:30:30) must be rejected like fromisoformat
# does, not silently mis-read as fractional seconds
_ISO_RE = re.compile(
    r"^(?P<date>\d{4}-\d{2}-\d{2})"
    r"(?:[T ](?P<hm>\d{2}:\d{2})"
    r"(?::(?P<sec>\d{2})(?P<frac>\.\d+)?)?"
    r"(?P<tz>[Zz]|[+-]\d{2}:?\d{2}(?::\d{2})?)?)?$")


def parse_iso8601(s: str) -> _dt.datetime:
    """``datetime.fromisoformat`` accepting ``Z``-suffixed timestamps,
    any fractional-second width (truncated to microseconds), and
    colon-less UTC offsets — identically on every supported Python.

    Raises ``ValueError`` on unparseable input, like ``fromisoformat``.
    """
    try:
        return _dt.datetime.fromisoformat(s)
    except ValueError:
        pass
    m = _ISO_RE.match(s)
    if m is None:
        raise ValueError(f"Invalid isoformat string: {s!r}")
    out = m.group("date")
    if m.group("hm") is not None:
        out += "T" + m.group("hm") + ":" + (m.group("sec") or "00")
        frac = m.group("frac")
        if frac:
            out += "." + (frac[1:] + "000000")[:6]
        tz = m.group("tz")
        if tz:
            if tz in ("Z", "z"):
                tz = "+00:00"
            elif ":" not in tz:
                tz = tz[:3] + ":" + tz[3:]
            out += tz
    return _dt.datetime.fromisoformat(out)
