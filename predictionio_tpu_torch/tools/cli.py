"""``pio`` console — operator CLI.

Parity target: ``tools/.../console/Console.scala:133-769``. Verbs:
version, status, build, train, eval, deploy, undeploy, eventserver,
adminserver, dashboard, app (incl. channels), accesskey, template,
export, import, trace, runs, top.

The port's copy of ``predictionio_tpu/tools/cli.py``: the same verbs
and options, and ``--device`` (default ``cuda``) on ``train``, ``eval``,
``deploy`` and ``batchpredict``. ``status`` prints each shard's health
when EVENTDATA is a ``fleet`` source, and with ``--fleet URL`` a query
fleet balancer's federated summary and firing SLO alerts.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from predictionio_tpu_torch import __version__


def cmd_version(args) -> int:
    print(__version__)
    return 0


def cmd_status(args) -> int:
    """Verify storage wiring (Console status -> Storage.verifyAllDataObjects,
    Storage.scala:335-358), then, for a ``fleet`` event store, each
    shard's health. With ``--fleet URL``, also scrape a running
    balancer's federated ``/stats.json`` and print member health and
    SLO alerts."""
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.storage.base import StorageError

    try:
        cfg = storage.registry().config
        print("[INFO] Storage sources:")
        for name, src in cfg.sources.items():
            shown = {k: v for k, v in src.items()}
            print(f"[INFO]   {name}: {shown}")
        print("[INFO] Repository bindings:")
        for repo, src in cfg.repositories.items():
            print(f"[INFO]   {repo} -> {src}")
        storage.verify_all_data_objects()
        _print_fleet_health(storage)
    except StorageError as e:
        print(f"[ERROR] Storage check failed: {e}", file=sys.stderr)
        return 1
    fleet_url = getattr(args, "fleet", None)
    if fleet_url:
        if _print_balancer_status(fleet_url) != 0:
            return 1
    print("[INFO] Your system is all ready to go.")
    return 0


def _print_balancer_status(url: str) -> int:
    """Federated fleet summary off a balancer's ``/stats.json``
    (``pio status --fleet URL``)."""
    from predictionio_tpu_torch.tools import top_command

    try:
        stats = top_command._fetch(url.rstrip("/") + "/stats.json")
    except Exception as e:
        print(f"[ERROR] Fleet balancer {url} unreachable: {e}",
              file=sys.stderr)
        return 1
    fleet = stats.get("fleet") or {}
    members = fleet.get("members") or []
    scrape = fleet.get("scrape") or {}
    print(f"[INFO] Query fleet: {fleet.get('readyReplicas', 0)}/"
          f"{len(fleet.get('replicas') or [])} replicas ready, "
          f"{len(members)} observability members "
          f"(scrape {float(scrape.get('durationSec') or 0) * 1e3:.1f}ms, "
          f"{len(scrape.get('problems') or [])} problems)")
    for m in members:
        state = "ok" if m.get("ok") else (m.get("reason") or "down")
        if m.get("inProcess"):
            state += ", in-process"
        print(f"[INFO]   member {m.get('member', '?')}: "
              f"{m.get('url') or 'local'} [{state}]")
    alerts = stats.get("alerts") or {}
    firing = alerts.get("firing") or []
    if firing:
        print(f"[WARN] SLO alerts FIRING: {', '.join(firing)}")
        for name in firing:
            obj = (alerts.get("objectives") or {}).get(name) or {}
            burn = obj.get("burn") or {}
            print(f"[WARN]   {name}: burn fast {burn.get('fast')} / "
                  f"slow {burn.get('slow')} (threshold "
                  f"{alerts.get('burnThreshold')}), since "
                  f"{obj.get('since', '?')}")
    else:
        print("[INFO] SLO alerts: none firing")
    return 0


def _print_fleet_health(storage) -> None:
    """When EVENTDATA is the sharded ``fleet`` source, print per-shard
    health (the same per-URL breaker states the wire feeds)."""
    try:
        dao = storage.get_levents()
    except Exception:
        return
    topo = getattr(dao, "topology", None)
    if not callable(topo):
        return
    t = topo()
    healthy = t.get("healthyShards", 0)
    shards = t.get("shards", [])
    print(f"[INFO] Event-store fleet: {healthy}/{len(shards)} shards "
          f"healthy ({t.get('virtualNodes')} virtual nodes/shard, "
          f"{t.get('partialReads', 0)} partial reads served)")
    for s in shards:
        state = "ok" if s.get("healthy") else "DOWN"
        print(f"[INFO]   shard {s['index']}: {s['url']} "
              f"[{state}, breaker {s.get('breakerState')}]")


def cmd_app(args) -> int:
    from predictionio_tpu_torch.tools import app_commands

    return app_commands.dispatch(args)


def cmd_accesskey(args) -> int:
    from predictionio_tpu_torch.tools import accesskey_commands

    return accesskey_commands.dispatch(args)


def cmd_template(args) -> int:
    from predictionio_tpu_torch.tools import template_commands

    return template_commands.dispatch(args)


def _add_engine_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--engine-variant", default="engine.json",
                   help="path to the engine variant JSON")
    p.add_argument("--engine-factory", default=None,
                   help="module:callable (overrides engine.json)")
    p.add_argument("--engine-id", default=None)
    p.add_argument("--engine-version", default=None)


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="the torch device to run on (default cuda; it "
                        "raises when CUDA is absent: pass cpu to run on "
                        "the CPU)")


def _add_metrics_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--metrics", choices=("on", "off"), default=None,
                   help="process-wide metrics instrumentation (default on; "
                        "env PIO_METRICS=0 also disables). GET /metrics "
                        "serves the Prometheus exposition either way — "
                        "off just freezes the counters")


def _add_tracing_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--tracing", choices=("on", "off"), default=None,
                   help="structured span tracing (default on; env "
                        "PIO_TRACING=0 also disables). Traces surface at "
                        "GET /traces.json and via `pio trace`")
    p.add_argument("--trace-dir", default=None, metavar="DIR",
                   help="additionally export every retained trace as "
                        "JSONL (+ slow-queries.log) under DIR; defaults "
                        "to $PIO_TRACE_DIR when set")


def _add_serve_precision_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--serve-precision", choices=("fp32", "bf16", "int8"),
                   default=None,
                   help="serving factor-store precision (env "
                        "PIO_SERVE_PRECISION; device stores default to "
                        "bf16 on the GPU, fp32 on the CPU). bf16 "
                        "halves the model's device memory and scoring "
                        "traffic; int8 (per-row fp32 scales) quarters "
                        "it. Scores always accumulate fp32")
    p.add_argument("--serve-kernel", choices=("auto", "fused", "xla"),
                   default=None,
                   help="device top-k program: auto (default) and "
                        "fused both serve through the port's CUDA "
                        "gather+score+mask+top-k kernel; xla raises "
                        "(the port has no XLA program)")


def _add_distributed_args(p: argparse.ArgumentParser) -> None:
    """Multi-host topology flags (the spark-submit cluster plane analog,
    Runner.scala:92-210; see parallel/distributed.py for the launch
    recipe). Defaults = single-host degenerate case."""
    p.add_argument("--num-hosts", type=int, default=None,
                   help="total host processes in the job (default 1; "
                        "env PIO_NUM_HOSTS)")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="coordinator address (host 0); "
                        "required when --num-hosts > 1 "
                        "(env PIO_COORDINATOR)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this host's index, 0..num-hosts-1 "
                        "(env PIO_PROCESS_ID)")


def build_parser() -> argparse.ArgumentParser:
    from predictionio_tpu_torch.tools import run_commands

    parser = argparse.ArgumentParser(
        prog="pio",
        description="predictionio-tpu PyTorch/CUDA port console "
                    "(reference: pio CLI)")
    sub = parser.add_subparsers(dest="command")

    sub.add_parser("version", help="print version").set_defaults(
        func=cmd_version)
    st = sub.add_parser("status", help="verify storage configuration")
    st.add_argument("--fleet", default=None, metavar="URL",
                    help="also scrape a running fleet balancer's "
                         "federated /stats.json at URL and print "
                         "member health + SLO alert state")
    st.set_defaults(func=cmd_status)

    app = sub.add_parser("app", help="manage apps")
    app_sub = app.add_subparsers(dest="app_command")
    new = app_sub.add_parser("new", help="create an app")
    new.add_argument("name")
    new.add_argument("--description", default=None)
    new.add_argument("--access-key", default=None)
    app_sub.add_parser("list", help="list apps")
    show = app_sub.add_parser("show", help="show an app")
    show.add_argument("name")
    delete = app_sub.add_parser("delete", help="delete an app")
    delete.add_argument("name")
    delete.add_argument("-f", "--force", action="store_true")
    dd = app_sub.add_parser("data-delete", help="delete an app's event data")
    dd.add_argument("name")
    dd.add_argument("--channel", default=None)
    dd.add_argument("-f", "--force", action="store_true")
    dc = app_sub.add_parser("data-cleanup",
                            help="delete events older than a cutoff time")
    dc.add_argument("name")
    dc.add_argument("--before", required=True,
                    help="ISO-8601 cutoff; events before it are deleted")
    dc.add_argument("--channel", default=None)
    dc.add_argument("-f", "--force", action="store_true")
    dtr = app_sub.add_parser("data-trim",
                             help="copy a time window of events to "
                                  "another app")
    dtr.add_argument("name", help="source app")
    dtr.add_argument("--dst", required=True, help="destination app")
    dtr.add_argument("--start", default=None, help="ISO-8601 window start")
    dtr.add_argument("--until", default=None, help="ISO-8601 window end")
    dtr.add_argument("--channel", default=None, help="source channel")
    dtr.add_argument("--dst-channel", default=None)
    cn = app_sub.add_parser("channel-new", help="create a channel")
    cn.add_argument("name")
    cn.add_argument("channel")
    cd = app_sub.add_parser("channel-delete", help="delete a channel")
    cd.add_argument("name")
    cd.add_argument("channel")
    cd.add_argument("-f", "--force", action="store_true")
    app.set_defaults(func=cmd_app)

    ak = sub.add_parser("accesskey", help="manage access keys")
    ak_sub = ak.add_subparsers(dest="accesskey_command")
    akn = ak_sub.add_parser("new", help="create an access key")
    akn.add_argument("app_name")
    akn.add_argument("key", nargs="?", default=None)
    akn.add_argument("--events", nargs="*", default=None,
                     help="allowed event names (default: all)")
    akl = ak_sub.add_parser("list", help="list access keys")
    akl.add_argument("app_name", nargs="?", default=None)
    akd = ak_sub.add_parser("delete", help="delete an access key")
    akd.add_argument("key")
    ak.set_defaults(func=cmd_accesskey)

    build = sub.add_parser("build", help="verify the engine directory")
    _add_engine_args(build)
    build.set_defaults(func=run_commands.cmd_build)

    train = sub.add_parser("train", help="train an engine instance")
    train.add_argument("--profile-dir", default=None,
                       help="write a torch.profiler trace of the train "
                            "pass here (Chrome trace, Perfetto); defaults "
                            "to $PIO_PROFILE_DIR when set")
    train.add_argument("--precision", choices=("fp32", "bf16"),
                       default=None,
                       help="ALS training precision policy (default "
                            "fp32 — bit-stable historical path; env "
                            "PIO_ALS_PRECISION). bf16 stores/gathers "
                            "factors as bfloat16 with fp32 "
                            "normal-equation accumulation and solve")
    train.add_argument("--checkpoint-every", type=int, default=None,
                       metavar="N",
                       help="crash-safe training: run the ALS iteration "
                            "scan in chunks of N iterations and write an "
                            "atomic checkpoint between chunks (env "
                            "PIO_CHECKPOINT_EVERY; byte-identical to the "
                            "default single-scan path). Requires "
                            "--checkpoint-dir")
    train.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                       help="directory for training checkpoints "
                            "(npz blob + sha256/fingerprint manifest per "
                            "step; defaults to $PIO_CHECKPOINT_DIR). "
                            "SIGTERM/SIGINT then drain within one chunk: "
                            "final checkpoint + clean exit")
    train.add_argument("--checkpoint-keep", type=int, default=None,
                       metavar="N",
                       help="checkpoints retained, oldest dropped first "
                            "(default 3; env PIO_CHECKPOINT_KEEP)")
    train.add_argument("--resume", action="store_true",
                       help="continue from the newest intact checkpoint "
                            "in --checkpoint-dir whose input fingerprint "
                            "(data layout + BiMaps + ALSParams + "
                            "solver/precision statics) matches this run "
                            "— final factors are byte-identical to an "
                            "uninterrupted run; a mismatched checkpoint "
                            "is refused loudly, torn files fall back to "
                            "the previous intact one")
    _add_engine_args(train)
    train.add_argument("--batch", default="")
    train.add_argument("--skip-sanity-check", action="store_true")
    train.add_argument("--stop-after-read", action="store_true")
    train.add_argument("--stop-after-prepare", action="store_true")
    _add_distributed_args(train)
    _add_tracing_args(train)
    _add_device_arg(train)
    train.set_defaults(func=run_commands.cmd_train)

    ev = sub.add_parser("eval", help="run an evaluation / tuning sweep")
    ev.add_argument("evaluation", nargs="?", default=None,
                    help="module:callable -> Evaluation (omit with --grid)")
    ev.add_argument("engine_params_generator", nargs="?", default=None,
                    help="module:callable -> EngineParamsGenerator")
    ev.add_argument("--batch", default="")
    ev.add_argument("--grid", default=None, metavar="GRID_JSON",
                    help="hyperparameter grid file ({base, configs, "
                         "data}): every ALSParams config trains in ONE "
                         "vmapped device program against shared "
                         "bucketed tables (sweepable: rank, lambda, "
                         "alpha; sized to the HBM budget, diverged "
                         "configs masked out) and a leaderboard "
                         "artifact is written with the winner's full "
                         "engine params")
    ev.add_argument("--grid-out", default="leaderboard.json",
                    help="leaderboard artifact path (with --grid)")
    ev.add_argument("--topk", type=int, default=10,
                    help="leaderboard metric cutoff (precision@k / "
                         "ndcg@k, with --grid)")
    _add_device_arg(ev)
    ev.set_defaults(func=run_commands.cmd_eval)

    dep = sub.add_parser("deploy", help="serve a trained engine instance")
    _add_engine_args(dep)
    dep.add_argument("--engine-instance-id", default=None)
    dep.add_argument("--ip", default="0.0.0.0")
    dep.add_argument("--port", type=int, default=8000)
    dep.add_argument("--feedback", action="store_true")
    dep.add_argument("--event-server-ip", default="0.0.0.0")
    dep.add_argument("--event-server-port", type=int, default=7070)
    dep.add_argument("--accesskey", default=None)
    dep.add_argument("--server-config", default=None,
                     help="server.json with ssl cert/key for HTTPS "
                          "serving (default: $PIO_SERVER_CONFIG or "
                          "./server.json)")
    dep.add_argument("--foldin", choices=("on", "off"), default="off",
                     help="online fold-in: a background consumer tails "
                          "the event stream and patches fresh user "
                          "factors into the live device store — new "
                          "users servable in seconds, no /reload, no "
                          "retrain (forces the DeviceTopK backend; "
                          "cadence via PIO_FOLDIN_INTERVAL / "
                          "PIO_FOLDIN_COUNT)")
    dep.add_argument("--fleet", type=int, default=1, metavar="N",
                     help="query-server fleet mode: run N replicas "
                          "behind one keep-alive balancer on --port "
                          "(user-sticky hash-ring routing, rolling "
                          "warm /reload — the fleet is never cold; "
                          "replicas bind ephemeral loopback ports)")
    dep.add_argument("--slo-config", default=None, metavar="JSON|PATH",
                     help="fleet-mode SLO objectives: inline JSON or a "
                          "file path layered over the defaults and "
                          "$PIO_SLO_* env (windows, burn threshold, "
                          "per-objective budget/thresholdSec/disabled "
                          "— see README 'Fleet observability')")
    dep.add_argument("--batch-window", type=float, default=None,
                     metavar="SEC",
                     help="micro-batch budget in seconds (default "
                          "0.002; env PIO_BATCH_WINDOW): how long the "
                          "dispatcher holds a lone query hoping more "
                          "arrive to share its device dispatch; 0 "
                          "dispatches as soon as the dispatcher is "
                          "free")
    _add_metrics_arg(dep)
    _add_tracing_args(dep)
    _add_serve_precision_arg(dep)
    _add_device_arg(dep)
    dep.set_defaults(func=run_commands.cmd_deploy)

    bp = sub.add_parser(
        "batchpredict",
        help="bulk offline scoring: run a query file (or every known "
             "entity) through a trained engine instance in restartable "
             "device-shaped chunks")
    _add_engine_args(bp)
    bp.add_argument("--engine-instance-id", default=None)
    bp.add_argument("--input", default=None,
                    help="JSONL query file (one query object per line, "
                         "the /queries.json wire format)")
    bp.add_argument("--output", default=None,
                    help="output directory: per-chunk shard files + "
                         "manifest.json (reruns resume from it)")
    bp.add_argument("--query-partitions", type=int, default=None,
                    help="split the queries into N balanced partitions "
                         "(default: fixed --chunk-size chunks)")
    bp.add_argument("--chunk-size", type=int, default=256,
                    help="queries per chunk (power-of-two aligned to the "
                         "serving buckets; default 256)")
    bp.add_argument("--format", choices=("jsonl", "npz"), default="jsonl",
                    help="shard format: jsonl (default) or columnar npz")
    bp.add_argument("--synthesize-app", default=None, metavar="APP",
                    help="instead of --input: one query per known entity "
                         "of APP (via the materialized aggregation)")
    bp.add_argument("--synthesize-entity-type", default="user")
    bp.add_argument("--synthesize-field", default="user",
                    help="query field receiving the entity id "
                         "(default 'user')")
    bp.add_argument("--synthesize-base", default="{}", metavar="JSON",
                    help="JSON object merged into every synthesized "
                         "query (e.g. '{\"num\": 10}')")
    bp.add_argument("--channel", default=None,
                    help="channel for --synthesize-app")
    bp.add_argument("--batch", default="")
    bp.add_argument("--smoke", action="store_true",
                    help="self-contained CPU smoke: seed + train a tiny "
                         "engine in memory, batch-predict, crash, resume "
                         "and verify — ignores the other flags")
    _add_metrics_arg(bp)
    _add_tracing_args(bp)
    _add_serve_precision_arg(bp)
    _add_device_arg(bp)
    bp.set_defaults(func=run_commands.cmd_batchpredict)

    undep = sub.add_parser("undeploy", help="stop a deployed engine server")
    undep.add_argument("--ip", default="0.0.0.0")
    undep.add_argument("--port", type=int, default=8000)
    undep.set_defaults(func=run_commands.cmd_undeploy)

    es = sub.add_parser("eventserver", help="start the event server")
    es.add_argument("--ip", default="0.0.0.0")
    es.add_argument("--port", type=int, default=7070)
    es.add_argument("--stats", action="store_true")
    es.add_argument(
        "--service-key", default=None, metavar="KEY",
        help="enable the /storage wire for remote resthttp storage "
             "clients (a storage credential, like a DB password; env "
             "PIO_EVENTSERVER_SERVICE_KEY)")
    es.add_argument(
        "--server-config", default=None, metavar="JSON",
        help="server.json with an ssl section (certfile/keyfile) to "
             "serve the whole event API over TLS")
    _add_metrics_arg(es)
    es.set_defaults(func=run_commands.cmd_eventserver)

    adm = sub.add_parser("adminserver", help="start the admin REST server")
    adm.add_argument("--ip", default="localhost")
    adm.add_argument("--port", type=int, default=7071)
    adm.set_defaults(func=run_commands.cmd_adminserver)

    dash = sub.add_parser("dashboard", help="start the evaluation dashboard")
    dash.add_argument("--ip", default="localhost")
    dash.add_argument("--port", type=int, default=9000)
    dash.add_argument("--server-config", default=None,
                      help="server.json with accessKey/ssl settings")
    dash.set_defaults(func=run_commands.cmd_dashboard)

    from predictionio_tpu_torch.tools import trace_commands

    tr = sub.add_parser(
        "trace",
        help="inspect structured traces: list recent, dump one "
             "(optionally as Perfetto JSON), tail the slow-query log")
    tr_sub = tr.add_subparsers(dest="trace_command")

    def _add_trace_source(p):
        p.add_argument("--url", default=None, metavar="URL",
                       help="a live server's base URL (default "
                            f"{trace_commands.DEFAULT_URL} unless a "
                            "--trace-dir/$PIO_TRACE_DIR is available)")
        p.add_argument("--dir", default=None, metavar="DIR",
                       help="read from a --trace-dir JSONL export "
                            "instead of a live server (merges "
                            "per-process fragments; default "
                            "$PIO_TRACE_DIR)")
        p.add_argument("-n", type=int, default=20,
                       help="max entries to show (default 20)")

    trl = tr_sub.add_parser("list", help="recent retained traces")
    _add_trace_source(trl)
    trd = tr_sub.add_parser("dump", help="print one trace's span tree")
    trd.add_argument("trace_id")
    trd.add_argument("--perfetto", default=None, metavar="FILE",
                     help="write Chrome-trace-event JSON to FILE "
                          "(open at ui.perfetto.dev) instead of "
                          "printing the tree")
    _add_trace_source(trd)
    trt = tr_sub.add_parser("tail", help="the slow-query log")
    _add_trace_source(trt)
    tr.set_defaults(func=trace_commands.dispatch)

    from predictionio_tpu_torch.tools import runs_command

    rn = sub.add_parser(
        "runs",
        help="training run histories: list recorded runs, render one "
             "run's loss curve, diff two runs (reads the append-only "
             "run logs under <checkpoint-dir>/runs/)")
    rn_sub = rn.add_subparsers(dest="runs_command")

    def _add_runs_dir(p):
        p.add_argument("--dir", default=None, metavar="DIR",
                       help="checkpoint directory holding runs/ "
                            "(default $PIO_CHECKPOINT_DIR)")

    rnl = rn_sub.add_parser("list", help="summarize recorded runs")
    _add_runs_dir(rnl)
    rnl.add_argument("-n", type=int, default=20,
                     help="max runs to show (default 20)")
    rns = rn_sub.add_parser(
        "show", help="one run's ASCII loss curve + sample table")
    rns.add_argument("run_id", help="run id (unique prefixes accepted)")
    _add_runs_dir(rns)
    rnc = rn_sub.add_parser(
        "compare", help="align two runs by step and diff their losses")
    rnc.add_argument("run_a")
    rnc.add_argument("run_b")
    _add_runs_dir(rnc)
    rn.set_defaults(func=runs_command.dispatch)

    from predictionio_tpu_torch.tools import top_command

    top = sub.add_parser(
        "top",
        help="live terminal view of a deployed query server: QPS, "
             "p50/p99, batch fill, device-vs-host time split, HBM, "
             "breaker/degraded/fold-in state (polls /stats.json + "
             "/dispatches.json)")
    top.add_argument("--url", default=None, metavar="URL",
                     help="the query server's base URL (default "
                          f"{top_command.DEFAULT_URL})")
    top.add_argument("--interval", type=float, default=2.0, metavar="SEC",
                     help="refresh cadence in seconds (default 2)")
    top.add_argument("--once", action="store_true",
                     help="print one plain snapshot and exit "
                          "(scripts/CI; no ANSI)")
    top.add_argument("--fleet", action="store_true",
                     help="point --url at a fleet balancer: renders "
                          "the federated member table + SLO burn-rate "
                          "lines (and warns if the target serves no "
                          "fleet block)")
    top.set_defaults(func=top_command.cmd_top)

    tpl = sub.add_parser("template", help="engine template scaffolds")
    tpl_sub = tpl.add_subparsers(dest="template_command")
    tpl_sub.add_parser("list", help="list built-in templates")
    tg = tpl_sub.add_parser("get", help="scaffold an engine directory")
    tg.add_argument("name")
    tg.add_argument("directory")
    tpl.set_defaults(func=cmd_template)

    from predictionio_tpu_torch.tools import export_import

    exp = sub.add_parser(
        "export", help="export events to a JSON-lines or columnar file")
    exp.add_argument("--output", required=True)
    exp.add_argument("--app-name", default=None)
    exp.add_argument("--appid", type=int, default=None)
    exp.add_argument("--channel", default=None)
    exp.add_argument(
        "--format", choices=("jsonl", "columnar"), default="jsonl",
        help="jsonl (wire-format interchange, default) or columnar "
             "(dictionary-encoded npz — the Parquet analog, "
             "EventsToFile.scala:35,94; import sniffs the format)")
    exp.set_defaults(func=export_import.dispatch_export)

    imp = sub.add_parser(
        "import", help="import events from a JSON-lines or columnar file")
    imp.add_argument("--input", required=True)
    imp.add_argument("--app-name", default=None)
    imp.add_argument("--appid", type=int, default=None)
    imp.add_argument("--channel", default=None)
    imp.set_defaults(func=export_import.dispatch_import)

    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "func", None):
        parser.print_help()
        return 2
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
