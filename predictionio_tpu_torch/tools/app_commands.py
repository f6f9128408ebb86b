"""``pio app`` subcommands: new/list/show/delete/data-delete.

Parity: ``tools/.../console/App.scala`` — creates the app with a default
access key, lists with keys, data-delete wipes one channel or the whole
event store for the app.

The port's copy of ``predictionio_tpu/tools/app_commands.py``.
"""

from __future__ import annotations

import sys

from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.storage.base import AccessKey, App


def dispatch(args) -> int:
    cmd = getattr(args, "app_command", None)
    if cmd == "new":
        return app_new(args.name, args.description, args.access_key)
    if cmd == "list":
        return app_list()
    if cmd == "show":
        return app_show(args.name)
    if cmd == "delete":
        return app_delete(args.name, args.force)
    if cmd == "data-delete":
        return app_data_delete(args.name, args.channel, args.force)
    if cmd == "data-cleanup":
        return app_data_cleanup(args.name, args.before, args.channel,
                                args.force)
    if cmd == "data-trim":
        return app_data_trim(args.name, args.dst, args.start, args.until,
                             args.channel, args.dst_channel)
    if cmd == "channel-new":
        return app_channel_new(args.name, args.channel)
    if cmd == "channel-delete":
        return app_channel_delete(args.name, args.channel, args.force)
    print("usage: pio app {new,list,show,delete,data-delete,data-cleanup,"
          "data-trim,channel-new,channel-delete} ...", file=sys.stderr)
    return 2


def app_new(name: str, description=None, access_key=None) -> int:
    apps = storage.get_metadata_apps()
    if apps.get_by_name(name) is not None:
        print(f"[ERROR] App {name} already exists. Aborting.",
              file=sys.stderr)
        return 1
    app_id = apps.insert(App(0, name, description))
    if app_id is None:
        print(f"[ERROR] Unable to create app {name}.", file=sys.stderr)
        return 1
    storage.get_levents().init(app_id)
    key = storage.get_metadata_access_keys().insert(
        AccessKey(access_key or "", app_id, ()))
    print("[INFO] Created a new app:")
    print(f"[INFO]         Name: {name}")
    print(f"[INFO]           ID: {app_id}")
    print(f"[INFO]   Access Key: {key}")
    return 0


def app_list() -> int:
    apps = sorted(storage.get_metadata_apps().get_all(), key=lambda a: a.name)
    keys = storage.get_metadata_access_keys()
    print(f"[INFO] {'Name':<20} | {'ID':>4} | Access Key")
    for a in apps:
        aks = keys.get_by_appid(a.id)
        first = aks[0].key if aks else ""
        print(f"[INFO] {a.name:<20} | {a.id:>4} | {first}")
    print(f"[INFO] Finished listing {len(apps)} app(s).")
    return 0


def app_show(name: str) -> int:
    app = storage.get_metadata_apps().get_by_name(name)
    if app is None:
        print(f"[ERROR] App {name} does not exist. Aborting.",
              file=sys.stderr)
        return 1
    print(f"[INFO]       App Name: {app.name}")
    print(f"[INFO]         App ID: {app.id}")
    print(f"[INFO]    Description: {app.description or ''}")
    for k in storage.get_metadata_access_keys().get_by_appid(app.id):
        events = ",".join(k.events) if k.events else "(all)"
        print(f"[INFO]     Access Key: {k.key} | {events}")
    for c in storage.get_metadata_channels().get_by_appid(app.id):
        print(f"[INFO]        Channel: {c.name} ({c.id})")
    return 0


def delete_app_cascade(app_id: int, reg=None) -> None:
    """Remove an app and everything attached to it: per-channel event
    stores, channel rows, the default event store, access keys, and the
    app row (Console `app delete` semantics; shared by the admin REST
    server so the two paths cannot diverge)."""
    reg = reg or storage.registry()
    channels = reg.get_metadata_channels()
    levents = reg.get_levents()
    for c in channels.get_by_appid(app_id):
        levents.remove(app_id, c.id)
        channels.delete(c.id)
    levents.remove(app_id)
    keys = reg.get_metadata_access_keys()
    for k in keys.get_by_appid(app_id):
        keys.delete(k.key)
    reg.get_metadata_apps().delete(app_id)


def app_delete(name: str, force: bool = False) -> int:
    apps = storage.get_metadata_apps()
    app = apps.get_by_name(name)
    if app is None:
        print(f"[ERROR] App {name} does not exist. Aborting.",
              file=sys.stderr)
        return 1
    if not force and not _confirm(f"Delete app {name} and ALL its data?"):
        print("[INFO] Aborted.")
        return 0
    delete_app_cascade(app.id)
    print(f"[INFO] App successfully deleted: {name}")
    return 0


def app_data_delete(name: str, channel=None, force: bool = False) -> int:
    apps = storage.get_metadata_apps()
    app = apps.get_by_name(name)
    if app is None:
        print(f"[ERROR] App {name} does not exist. Aborting.",
              file=sys.stderr)
        return 1
    channel_id, rc = _resolve_channel(app, channel)
    if rc:
        return rc
    if not force and not _confirm(
            f"Delete all event data of app {name}"
            + (f" channel {channel}" if channel else "") + "?"):
        print("[INFO] Aborted.")
        return 0
    levents = storage.get_levents()
    levents.remove(app.id, channel_id)
    levents.init(app.id, channel_id)  # wipe + reinit (App.scala data-delete)
    print(f"[INFO] Removed event data of app: {name}")
    return 0


def _resolve_channel(app, channel):
    """(channel_id, error_rc): None channel -> default channel."""
    if channel is None:
        return None, None
    match = next((c for c in storage.get_metadata_channels()
                  .get_by_appid(app.id) if c.name == channel), None)
    if match is None:
        print(f"[ERROR] Channel {channel} does not exist. Aborting.",
              file=sys.stderr)
        return None, 1
    return match.id, None


def app_data_cleanup(name: str, before: str, channel=None,
                     force: bool = False) -> int:
    """Delete events older than a cutoff time — the experimental
    cleanup-app capability (``examples/experimental/scala-cleanup-app/
    .../DataSource.scala``) as a first-class verb instead of a fake
    engine run."""
    from predictionio_tpu_torch.data.event import _parse_time

    apps = storage.get_metadata_apps()
    app = apps.get_by_name(name)
    if app is None:
        print(f"[ERROR] App {name} does not exist. Aborting.",
              file=sys.stderr)
        return 1
    channel_id, rc = _resolve_channel(app, channel)
    if rc:
        return rc
    try:
        cutoff = _parse_time(before)
    except Exception as e:
        print(f"[ERROR] Bad --before time {before!r}: {e}", file=sys.stderr)
        return 1
    if cutoff is None:
        print("[ERROR] --before time is required.", file=sys.stderr)
        return 1
    if not force and not _confirm(
            f"Delete all events of app {name} before {cutoff.isoformat()}?"):
        print("[INFO] Aborted.")
        return 0
    # no pre-count scan: at 10M+ events a typed full scan would cost more
    # than the cleanup itself; delete_until reports what it removed
    removed = storage.get_levents().delete_until(app.id, cutoff, channel_id)
    print(f"[INFO] Removed {removed} events before {cutoff.isoformat()}.")
    return 0


def app_data_trim(src: str, dst: str, start=None, until=None,
                  src_channel=None, dst_channel=None) -> int:
    """Copy a time window of events from one app to another — the
    experimental trim-app capability (``examples/experimental/
    scala-parallel-trim-app/.../DataSource.scala``: src window ->
    dst app, event IDs preserved)."""
    from predictionio_tpu_torch.data.event import _parse_time

    apps = storage.get_metadata_apps()
    src_app = apps.get_by_name(src)
    dst_app = apps.get_by_name(dst)
    for label, app in (("Source", src_app), ("Destination", dst_app)):
        if app is None:
            print(f"[ERROR] {label} app does not exist. Aborting.",
                  file=sys.stderr)
            return 1
    src_cid, rc = _resolve_channel(src_app, src_channel)
    if rc:
        return rc
    dst_cid, rc = _resolve_channel(dst_app, dst_channel)
    if rc:
        return rc
    try:
        start_t = _parse_time(start) if start else None
        until_t = _parse_time(until) if until else None
    except Exception as e:
        print(f"[ERROR] Bad time bound: {e}", file=sys.stderr)
        return 1
    from itertools import islice

    levents = storage.get_levents()
    levents.init(dst_app.id, dst_cid)
    # idempotent re-runs: events keep their IDs, and append-only backends
    # (jsonlfs) would otherwise duplicate them on a retry
    existing = {e.event_id for e in levents.find(app_id=dst_app.id,
                                                 channel_id=dst_cid)}
    # insert in bounded chunks (read-side memory depends on the
    # backend's find(): sqlite streams, jsonlfs materializes the
    # time-ordered window)
    it = iter(levents.find(app_id=src_app.id, channel_id=src_cid,
                           start_time=start_t, until_time=until_t))
    BATCH = 5000
    copied = skipped = 0
    while True:
        chunk = [e for e in islice(it, BATCH)]
        if not chunk:
            break
        fresh = []
        for e in chunk:
            # `existing` also absorbs ids copied THIS run, so duplicate
            # ids inside the source window copy exactly once
            if e.event_id not in existing:
                existing.add(e.event_id)
                fresh.append(e)
        skipped += len(chunk) - len(fresh)
        if fresh:
            levents.insert_batch(fresh, dst_app.id, dst_cid)
            copied += len(fresh)
    msg = f"[INFO] Copied {copied} events from app {src} to {dst}."
    if skipped:
        msg += f" ({skipped} already present, skipped)"
    print(msg)
    return 0


def app_channel_new(name: str, channel: str) -> int:
    """App.scala channelNew: validate name, create channel, init its event
    store; roll back the channel row if init fails."""
    from predictionio_tpu_torch.data.storage.base import Channel

    app = storage.get_metadata_apps().get_by_name(name)
    if app is None:
        print(f"[ERROR] App {name} does not exist. Aborting.",
              file=sys.stderr)
        return 1
    channels = storage.get_metadata_channels()
    if any(c.name == channel for c in channels.get_by_appid(app.id)):
        print(f"[ERROR] Channel {channel} already exists. Aborting.",
              file=sys.stderr)
        return 1
    if not Channel.is_valid_name(channel):
        print(f"[ERROR] Channel name {channel} is invalid (1-16 "
              "alphanumeric/dash characters). Aborting.", file=sys.stderr)
        return 1
    channel_id = channels.insert(Channel(id=0, name=channel, appid=app.id))
    if channel_id is None:
        print("[ERROR] Unable to create channel.", file=sys.stderr)
        return 1
    if not storage.get_levents().init(app.id, channel_id):
        channels.delete(channel_id)
        print("[ERROR] Unable to initialize the channel's event store.",
              file=sys.stderr)
        return 1
    print(f"[INFO] Channel {channel} created for app {name}.")
    return 0


def app_channel_delete(name: str, channel: str, force: bool = False) -> int:
    app = storage.get_metadata_apps().get_by_name(name)
    if app is None:
        print(f"[ERROR] App {name} does not exist. Aborting.",
              file=sys.stderr)
        return 1
    channel_id, rc = _resolve_channel(app, channel)
    if rc or channel_id is None:
        return rc or 1
    if not force and not _confirm(
            f"Delete channel {channel} of app {name} and ALL its data?"):
        print("[INFO] Aborted.")
        return 0
    storage.get_levents().remove(app.id, channel_id)
    storage.get_metadata_channels().delete(channel_id)
    print(f"[INFO] Channel {channel} deleted.")
    return 0


def _confirm(prompt: str) -> bool:
    try:
        return input(f"{prompt} (y/N) ").strip().lower() == "y"
    except EOFError:
        return False
