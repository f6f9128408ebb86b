"""``pio accesskey`` subcommands: new/list/delete.

Parity: ``tools/.../console/AccessKey.scala`` — create a key for an app
(optionally restricted to an event whitelist), list keys, delete by key.

The port's copy of ``predictionio_tpu/tools/accesskey_commands.py``.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.storage.base import AccessKey


def dispatch(args) -> int:
    cmd = getattr(args, "accesskey_command", None)
    if cmd == "new":
        return accesskey_new(args.app_name, args.key, args.events or [])
    if cmd == "list":
        return accesskey_list(getattr(args, "app_name", None))
    if cmd == "delete":
        return accesskey_delete(args.key)
    print("usage: pio accesskey {new,list,delete} ...", file=sys.stderr)
    return 2


def accesskey_new(app_name: str, key: Optional[str],
                  events: Sequence[str]) -> int:
    app = storage.get_metadata_apps().get_by_name(app_name)
    if app is None:
        print(f"[ERROR] App {app_name} does not exist. Aborting.",
              file=sys.stderr)
        return 1
    created = storage.get_metadata_access_keys().insert(
        AccessKey(key=key or "", appid=app.id, events=tuple(events)))
    if created is None:
        print("[ERROR] Unable to create access key.", file=sys.stderr)
        return 1
    print(f"[INFO] Created new access key: {created}")
    return 0


def accesskey_list(app_name: Optional[str]) -> int:
    keys = storage.get_metadata_access_keys()
    if app_name:
        app = storage.get_metadata_apps().get_by_name(app_name)
        if app is None:
            print(f"[ERROR] App {app_name} does not exist. Aborting.",
                  file=sys.stderr)
            return 1
        rows = keys.get_by_appid(app.id)
    else:
        rows = keys.get_all()
    print(f"[INFO] {'Access Key':<64} | {'App ID':>6} | Allowed Event(s)")
    for k in sorted(rows, key=lambda k: (k.appid, k.key)):
        events = ",".join(k.events) if k.events else "(all)"
        print(f"[INFO] {k.key:<64} | {k.appid:>6} | {events}")
    print(f"[INFO] Finished listing {len(rows)} access key(s).")
    return 0


def accesskey_delete(key: str) -> int:
    if storage.get_metadata_access_keys().delete(key):
        print(f"[INFO] Deleted access key {key}.")
        return 0
    print(f"[ERROR] Error deleting access key {key}.", file=sys.stderr)
    return 1
