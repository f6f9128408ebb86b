"""``pio trace`` — inspect the structured-tracing subsystem.

Three verbs against either a LIVE server's trace endpoints
(``--url``, default the query server at ``http://127.0.0.1:8000``) or a
``--trace-dir`` JSONL export directory (``$PIO_TRACE_DIR``):

- ``pio trace list``          — recent retained traces (id, root,
  duration, span count, slow/error flags)
- ``pio trace dump <id>``     — one trace's span tree as JSON;
  ``--perfetto FILE`` writes the Chrome-trace-event export instead
  (open it at ui.perfetto.dev)
- ``pio trace tail``          — the slow-query log (slow or errored
  trace summaries, newest first)

A dir merges fragments of the same trace across processes (query server
+ event server exporting into a shared directory show as ONE timeline);
a URL shows the one process's fragment.

The port's copy of ``predictionio_tpu/tools/trace_commands.py``.
"""

from __future__ import annotations

import json
import os
import sys
import urllib.error
import urllib.request
from typing import Any, Dict, Optional

from predictionio_tpu_torch.utils import tracing


def _http_json(url: str) -> Any:
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return None
        raise
    except OSError as e:
        raise RuntimeError(f"no server answered at {url}: {e}") from e


DEFAULT_URL = "http://127.0.0.1:8000"


def _source(args) -> Dict[str, Optional[str]]:
    """Where to read from: an explicit ``--url`` wins; else an explicit
    ``--dir`` or ``$PIO_TRACE_DIR``; else the default query-server URL."""
    url = getattr(args, "url", None)
    d = getattr(args, "dir", None) or os.environ.get("PIO_TRACE_DIR") or None
    if url:
        return {"url": url, "dir": None}
    if d:
        return {"url": None, "dir": d}
    return {"url": DEFAULT_URL, "dir": None}


def _fmt_row(summary: Dict[str, Any]) -> str:
    flags = "".join(("S" if summary.get("slow") else "-",
                     "E" if summary.get("error") else "-"))
    dur_ms = float(summary.get("durationSec", 0.0)) * 1000.0
    return (f"{summary.get('traceId', '?'):34s} {dur_ms:10.2f}ms "
            f"{summary.get('spans', 0):5d} {flags}  "
            f"{summary.get('root', '')}")


def cmd_list(args) -> int:
    src = _source(args)
    if src["dir"]:
        records = tracing.load_traces_from_dir(src["dir"], limit=args.n)
        summaries = [{
            "traceId": r.get("traceId"),
            "durationSec": r.get("durationSec", 0.0),
            "spans": len(r.get("spans", ())),
            "slow": r.get("slow", False),
            "error": r.get("error", False),
            "root": r.get("root", ""),
        } for r in reversed(records)]
    else:
        payload = _http_json(f"{src['url']}/traces.json?limit={args.n}")
        if payload is None:
            print(f"[ERROR] {src['url']} has no /traces.json endpoint.",
                  file=sys.stderr)
            return 1
        if not payload.get("enabled", True):
            print("[WARN] tracing is disabled on the server "
                  "(PIO_TRACING / --tracing off)", file=sys.stderr)
        summaries = payload.get("traces", ())
    if not summaries:
        print("[INFO] no retained traces.")
        return 0
    print(f"{'TRACE ID':34s} {'DURATION':12s} SPANS SE ROOT")
    for s in summaries:
        print(_fmt_row(s))
    return 0


def _find_trace(args, trace_id: str) -> Optional[Dict[str, Any]]:
    src = _source(args)
    if src["dir"]:
        records = tracing.load_traces_from_dir(src["dir"],
                                               trace_id=trace_id)
        return records[0] if records else None
    return _http_json(f"{src['url']}/traces/{trace_id}")


def cmd_dump(args) -> int:
    record = _find_trace(args, args.trace_id)
    if record is None:
        print(f"[ERROR] trace {args.trace_id} not found.", file=sys.stderr)
        return 1
    if args.perfetto:
        chrome = tracing.trace_to_chrome(record)
        with open(args.perfetto, "w", encoding="utf-8") as f:
            json.dump(chrome, f)
        print(f"[INFO] wrote {len(chrome['traceEvents'])} events to "
              f"{args.perfetto} — open it at https://ui.perfetto.dev")
        return 0
    json.dump(record, sys.stdout, indent=2)
    print()
    return 0


def cmd_tail(args) -> int:
    src = _source(args)
    if src["dir"]:
        entries = tracing.load_slow_log_from_dir(src["dir"], limit=args.n)
    else:
        payload = _http_json(f"{src['url']}/traces.json?limit={args.n}")
        if payload is None:
            print(f"[ERROR] {src['url']} has no /traces.json endpoint.",
                  file=sys.stderr)
            return 1
        entries = payload.get("slowLog", ())
    if not entries:
        print("[INFO] slow-query log is empty.")
        return 0
    for e in entries:
        kind = "ERROR" if e.get("error") else "SLOW "
        print(f"{e.get('time', '?'):32s} {kind} "
              f"{float(e.get('durationSec', 0.0)) * 1000.0:10.2f}ms "
              f"{e.get('traceId', '?')}  {e.get('name', '')}")
    return 0


def dispatch(args) -> int:
    cmd = getattr(args, "trace_command", None)
    try:
        if cmd == "list":
            return cmd_list(args)
        if cmd == "dump":
            return cmd_dump(args)
        if cmd == "tail":
            return cmd_tail(args)
    except BrokenPipeError:
        # `pio trace list | head` closing the pipe is normal UNIX use
        sys.stderr.close()
        return 0
    print("usage: pio trace {list|dump|tail} [--url URL | --dir DIR]",
          file=sys.stderr)
    return 2
