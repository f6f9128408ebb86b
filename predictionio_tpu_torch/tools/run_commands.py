"""``pio`` lifecycle verbs: build, train, eval, deploy, batchpredict,
undeploy, eventserver, adminserver, dashboard.

Parity: ``tools/.../console/Console.scala`` dispatch (:698-769) with the
spark-submit/Runner layer removed — train and deploy run in this
process, on the device ``--device`` names (default ``cuda``; a missing
GPU raises, and the CPU runs only when asked for).

Engine location: a directory with an ``engine.json`` variant whose
``engineFactory`` names a ``module:callable``.

The port's copy of ``predictionio_tpu/tools/run_commands.py``. ``train``
takes the training options: ``--precision bf16`` and crash-safe
checkpointed training (``--checkpoint-dir/-every/-keep``, ``--resume``;
SIGTERM/SIGINT drain at the next chunk boundary). ``eval`` runs an
``Evaluation`` (``best.json``, an ``EVALCOMPLETED`` instance) or, with
``--grid``, the config grid's leaderboard, on ``--device`` too.
``batchpredict`` scores a query file (or every known entity) through
a stored instance in restartable chunks on ``--device``. ``train
--num-hosts K --coordinator HOST:PORT --process-id i`` joins a process
group, trains on this host's cards in one collective run, and leaves
persistence to host 0. ``deploy --foldin on`` runs the online fold-in
consumer, ``deploy --feedback --accesskey K`` posts each answered query
to the event server, and ``deploy --fleet N`` serves N replicas behind
one balancer (``--slo-config`` sets its SLO objectives).
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import sys
from typing import Any, Dict

# the workflow (and with it torch) is imported by the verbs that train or
# serve, so the console's other verbs start without it


def _load_variant(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def _workflow_config(args, variant: Dict[str, Any]) -> "WorkflowConfig":
    from predictionio_tpu_torch.workflow.create_workflow import WorkflowConfig

    factory = getattr(args, "engine_factory", None) or variant.get(
        "engineFactory", "")
    if not factory:
        raise ValueError(
            "no engine factory: set \"engineFactory\": \"module:callable\" "
            "in engine.json or pass --engine-factory")
    return WorkflowConfig(
        engine_id=getattr(args, "engine_id", None) or variant.get(
            "id", "default"),
        engine_version=getattr(args, "engine_version", None) or variant.get(
            "version", "default"),
        engine_variant=args.engine_variant,
        engine_factory=factory,
        batch=getattr(args, "batch", "") or "",
        skip_sanity_check=getattr(args, "skip_sanity_check", False),
        stop_after_read=getattr(args, "stop_after_read", False),
        stop_after_prepare=getattr(args, "stop_after_prepare", False),
    )


def cmd_build(args) -> int:
    """Sanity-check the engine dir: variant parses, factory imports, params
    typecheck (the sbt build + RegisterEngine analog, Console.scala:812-828)."""
    from predictionio_tpu_torch.workflow import core_workflow

    try:
        variant = _load_variant(args.engine_variant)
        config = _workflow_config(args, variant)
        engine = core_workflow.load_engine_factory(config.engine_factory)()
        engine.engine_params_from_variant(variant)
    except Exception as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1
    print("[INFO] Engine is ready for training.")
    return 0


def _apply_metrics_flag(args) -> None:
    """--metrics on|off -> the process-wide registry switch (None leaves
    the PIO_METRICS env default in place)."""
    flag = getattr(args, "metrics", None)
    if flag is not None:
        from predictionio_tpu_torch.utils import metrics
        metrics.set_enabled(flag == "on")


def _apply_tracing_flags(args) -> None:
    """--tracing on|off + --trace-dir/$PIO_TRACE_DIR -> the tracing
    switch and the JSONL trace export (None leaves PIO_TRACING alone)."""
    from predictionio_tpu_torch.utils import tracing

    flag = getattr(args, "tracing", None)
    if flag is not None:
        tracing.set_tracing_enabled(flag == "on")
    trace_dir = getattr(args, "trace_dir", None) \
        or os.environ.get("PIO_TRACE_DIR") or None
    if trace_dir:
        tracing.set_trace_dir(trace_dir)


def _apply_precision_flag(args) -> None:
    """--precision -> $PIO_ALS_PRECISION, which the trainers resolve per
    call (it overrides the variant's ``precision``)."""
    precision = getattr(args, "precision", None)
    if precision:
        os.environ["PIO_ALS_PRECISION"] = precision


def _apply_checkpoint_flags(args) -> None:
    """--checkpoint-every/-dir/-keep + --resume -> the PIO_CHECKPOINT_*
    env vars the per-call resolver (workflow/checkpoint.py) reads. When
    a chunk cadence is set here (or in the env, or by --resume),
    SIGTERM/SIGINT become graceful preemption: finish the in-flight
    chunk, write a final checkpoint, exit 0."""
    every = getattr(args, "checkpoint_every", None)
    if every is not None and every < 1:
        raise SystemExit("--checkpoint-every must be >= 1")
    keep = getattr(args, "checkpoint_keep", None)
    if keep is not None and keep < 1:
        raise SystemExit("--checkpoint-keep must be >= 1")
    cdir = getattr(args, "checkpoint_dir", None)
    resume = bool(getattr(args, "resume", False))
    active_dir = (cdir or os.environ.get("PIO_CHECKPOINT_DIR", "")).strip()
    if (every is not None or resume) and not active_dir:
        raise SystemExit(
            "--checkpoint-every/--resume require --checkpoint-dir "
            "(or $PIO_CHECKPOINT_DIR)")
    # validated: only now touch the env, so a refused invocation leaves
    # no knob set behind it
    if every is not None:
        os.environ["PIO_CHECKPOINT_EVERY"] = str(every)
    if cdir:
        os.environ["PIO_CHECKPOINT_DIR"] = cdir
    if keep is not None:
        os.environ["PIO_CHECKPOINT_KEEP"] = str(keep)
    if resume:
        os.environ["PIO_RESUME"] = "1"
    # the drain handlers only when a chunk boundary will honor the stop
    # flag: a directory alone runs one chunk, and a swallowed SIGTERM
    # that promises a checkpoint it will not write is worse than the
    # default kill
    if active_dir and (
            every is not None or resume
            or os.environ.get("PIO_CHECKPOINT_EVERY", "").strip()):
        from predictionio_tpu_torch.workflow import checkpoint

        checkpoint.clear_stop()
        checkpoint.install_signal_handlers()


def _train_progress_scope():
    """The `pio train` live meter: each chunk's telemetry sample as one
    ``\\r``-rewritten progress line on stderr. On when stderr is a TTY,
    forced on/off with $PIO_TRAIN_PROGRESS; a nullcontext under
    PIO_TRAIN_TELEMETRY=0 (no samples would arrive)."""
    import contextlib

    from predictionio_tpu_torch.workflow import checkpoint, runlog

    forced = os.environ.get("PIO_TRAIN_PROGRESS", "").strip().lower()
    if forced in ("0", "false", "no", "off") \
            or not runlog.telemetry_enabled() \
            or not (forced in ("1", "true", "yes", "on")
                    or sys.stderr.isatty()):
        return contextlib.nullcontext()

    state = {"width": 0}

    def render(p):
        total = int(p.get("total") or 0)
        step = int(p.get("step") or 0)
        bar_w = 24
        fill = min(bar_w, int(bar_w * step / total)) if total else 0
        loss = p.get("loss")
        msg = (f"[{'#' * fill}{'-' * (bar_w - fill)}] "
               f"iter {step}/{total} "
               f"loss {'-' if loss is None else f'{loss:.6g}'} "
               f"({float(p.get('wallSeconds') or 0):.2f}s/chunk)")
        sys.stderr.write("\r" + msg.ljust(state["width"]))
        state["width"] = len(msg)
        if total and step >= total:
            sys.stderr.write("\n")
            state["width"] = 0
        sys.stderr.flush()

    return checkpoint.progress_scope(render)


def cmd_train(args) -> int:
    """Console train (Console.scala:834-842) -> create_workflow on the
    ``--device`` (default cuda). A profile dir (--profile-dir /
    $PIO_PROFILE_DIR) captures a ``torch.profiler`` trace of the whole
    train pass; the trace root ``pio.train`` holds the ``dase.*`` stage
    spans."""
    from predictionio_tpu_torch.core.base import TrainingInterruption
    from predictionio_tpu_torch.core.context import ComputeContext
    from predictionio_tpu_torch.device import resolve_device
    from predictionio_tpu_torch.parallel import distributed
    from predictionio_tpu_torch.utils import metrics
    from predictionio_tpu_torch.utils.tracing import (
        profile_trace,
        trace_scope,
    )
    from predictionio_tpu_torch.workflow.create_workflow import (
        create_workflow,
    )

    ctx = ComputeContext(device=resolve_device(args.device))
    _apply_tracing_flags(args)
    _apply_precision_flag(args)
    _apply_checkpoint_flags(args)
    try:
        # the process group (nothing to do on one host): every host runs
        # this command, each training on its own cards
        if distributed.initialize(distributed.DistributedConfig.from_args(
                args)):
            print(f"[INFO] Joined distributed runtime: host "
                  f"{distributed.process_index()}/"
                  f"{distributed.process_count()}")
        variant = _load_variant(args.engine_variant)
        config = _workflow_config(args, variant)
        profile_dir = getattr(args, "profile_dir", None) \
            or os.environ.get("PIO_PROFILE_DIR") or None
        metrics.install_jit_compile_listener()
        with profile_trace(profile_dir), \
                trace_scope("pio.train",
                            attributes={"variant": args.engine_variant},
                            slow_exempt=True), \
                _train_progress_scope():
            instance_id = create_workflow(config, variant=variant, ctx=ctx)
        primary = distributed.is_primary_host()
    except TrainingInterruption as e:
        print(f"[INFO] Training interrupted: {e}")
        return 0
    except Exception as e:
        print(f"[ERROR] Training failed: {e}", file=sys.stderr)
        return 1
    finally:
        distributed.shutdown()
    if instance_id is None:
        if not primary:
            print("[INFO] Secondary host: training complete; persistence "
                  "done by host 0.")
            _print_launches("assemble_normal_equations", "spd_solve")
        else:
            print("[INFO] Training interrupted by a stop-after flag.")
        return 0
    print(f"[INFO] Training completed. Engine instance ID: {instance_id}")
    _print_launches("assemble_normal_equations", "spd_solve")
    return 0


def _print_launches(*kernels: str) -> None:
    """This process's launches of each named kernel (their wrappers'
    counts; the plain versions on the CPU count none)."""
    from predictionio_tpu_torch.ops import als_cuda

    counters = {"fused_gather_score_topk": als_cuda.launches,
                "assemble_normal_equations": als_cuda.assemble_launches,
                "spd_solve": als_cuda.spd_launches}
    print("[INFO] Kernel launches: " + json.dumps(
        {name: counters[name].value for name in kernels}), flush=True)


def _cmd_eval_grid(args) -> int:
    """``pio eval --grid grid.json``: the config grid's tuning lane. The
    grid file's ALSParams configs are checked first (every unknown or
    non-sweepable field named, before any device work); the app's rate
    events are read once and split leave-last-out in stream order; every
    config trains together against one copy of the bucketed tables on
    ``--device`` (sized to the free memory, diverged configs masked
    out); every held-out user is ranked under every config through B1.
    Writes the leaderboard (a metric per config; the winner with its
    full EngineParams) to ``--grid-out``."""
    import numpy as np

    from predictionio_tpu_torch.device import resolve_device
    from predictionio_tpu_torch.ops import als as _als
    from predictionio_tpu_torch.ops import tuning as ops_tuning
    from predictionio_tpu_torch.workflow import tuning as wf_tuning

    try:
        with open(args.grid, "r", encoding="utf-8") as f:
            spec = json.load(f)
    except (OSError, ValueError) as e:
        print(f"[ERROR] cannot read grid file {args.grid}: {e}",
              file=sys.stderr)
        return 1
    if not isinstance(spec, dict):
        print(f"[ERROR] {args.grid}: grid file must be a JSON object",
              file=sys.stderr)
        return 1
    unknown = sorted(set(spec) - {"base", "configs", "data"})
    if unknown:
        for key in unknown:
            print(f"[ERROR] {args.grid}: unknown section {key!r} "
                  "(expected: base, configs, data)", file=sys.stderr)
        return 1
    try:
        grid = ops_tuning.grid_from_spec(
            {k: spec[k] for k in ("base", "configs") if k in spec})
    except ops_tuning.GridConfigError as e:
        # one [ERROR] line per problem
        for line in str(e).splitlines():
            print(f"[ERROR] {args.grid}: {line.strip()}", file=sys.stderr)
        return 1
    data_spec = spec.get("data") or {}
    app_name = data_spec.get("appName") or data_spec.get("app_name")
    if not app_name:
        print(f"[ERROR] {args.grid}: missing data.appName (the event "
              "app to tune against)", file=sys.stderr)
        return 1
    event_names = list(data_spec.get("eventNames", ["rate"]))
    dev = resolve_device(args.device)

    from predictionio_tpu_torch.data.store import PEventStore

    try:
        batch = PEventStore.find_columnar(
            app_name=app_name, channel_name=data_spec.get("channelName"),
            entity_type="user", event_names=event_names,
            target_entity_type="item", value_property="rating",
            default_value=1.0)
    except Exception as e:
        print(f"[ERROR] cannot read events for app {app_name!r}: {e}",
              file=sys.stderr)
        return 1
    if len(batch.entity_ids) == 0:
        print(f"[ERROR] app {app_name!r} has no "
              f"{'/'.join(event_names)} events to tune on",
              file=sys.stderr)
        return 1
    users, rows = np.unique(np.asarray(batch.entity_ids),
                            return_inverse=True)
    items, cols = np.unique(np.asarray(batch.target_ids),
                            return_inverse=True)
    vals = np.asarray(batch.values, dtype=np.float32)
    tr, tc, tv, held = leave_last_out_split(rows, cols, vals)
    if not len(tr):
        print(f"[ERROR] app {app_name!r}: no training interactions "
              "left after the leave-last-out split", file=sys.stderr)
        return 1
    user_side, item_side = _als.bucket_ratings_pair(
        tr, tc, tv, len(users), len(items))
    user_side, item_side = user_side.to_device(dev), item_side.to_device(dev)

    from predictionio_tpu_torch.controller.engine import EngineParams
    from predictionio_tpu_torch.data.storage.localfs import (
        atomic_write_bytes,
    )
    from predictionio_tpu_torch.templates.recommendation.engine import (
        DataSourceParams,
    )

    ep_base = EngineParams(data_source_params=("", DataSourceParams(
        app_name=str(app_name), event_names=tuple(event_names))))
    print(f"[INFO] grid eval: {grid.k} configs x "
          f"{int(grid.base.num_iterations)} iterations on "
          f"{len(tr)} train / {len(held)} held-out interactions "
          f"({len(users)} users, {len(items)} items)")
    out = args.grid_out

    def stream_partial(partial_board) -> None:
        # a killed sweep leaves the latest finished sub-batch's board on
        # disk, written atomically
        atomic_write_bytes(
            out, json.dumps(partial_board, indent=2).encode("utf-8"))
        print(f"[INFO] partial leaderboard "
              f"({partial_board.get('batchesCompleted')}/"
              f"{len(partial_board.get('batches') or [])} "
              f"sub-batches) -> {out}")

    board = wf_tuning.run_grid(
        user_side, item_side, grid, train_rows=tr, train_cols=tc,
        held=held, topk=int(getattr(args, "topk", 10) or 10),
        engine_params_base=ep_base, on_partial=stream_partial, device=dev)
    atomic_write_bytes(out, json.dumps(board, indent=2).encode("utf-8"))
    diverged = [r["config"] for r in board["rows"] if r["diverged"]]
    if diverged:
        print(f"[WARN] diverged configs masked out: {diverged}")
    _print_launches("assemble_normal_equations", "spd_solve",
                    "fused_gather_score_topk")
    w = board["winner"]
    if w is None:
        print("[ERROR] every config diverged — no winner", file=sys.stderr)
        return 1
    print(f"[INFO] winner: config {w['config']} {w['params']} "
          f"{board['metricName']}={w['metric']:.4f} "
          f"(ndcg@{board['k']}={w['ndcgAtK']:.4f}); leaderboard -> {out}")
    return 0


def leave_last_out_split(rows, cols, vals):
    """``pio eval --grid``'s holdout: each user's last interaction in
    stream order is its test target (users with one interaction train
    on it). Returns ``(train rows, train cols, train values, held)``,
    ``held`` mapping a user index to its set of held-out item indices."""
    import numpy as np

    held: Dict[int, set] = {}
    train_mask = np.ones(len(rows), dtype=bool)
    order = np.argsort(rows, kind="stable")
    bounds = np.flatnonzero(np.r_[True, rows[order][1:] != rows[order][:-1],
                                  True]) if len(rows) else np.zeros(1, int)
    for a, b in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        if b - a >= 2:
            last = order[b - 1]
            train_mask[last] = False
            held[int(rows[last])] = {int(cols[last])}
    return rows[train_mask], cols[train_mask], vals[train_mask], held


def cmd_eval(args) -> int:
    """Console eval (Console.scala:750-757): an Evaluation class and an
    optional params-generator class -> ``run_evaluation`` on
    ``--device`` (default cuda); the evaluator's result is stored in an
    ``EVALCOMPLETED`` EvaluationInstance (and ``best.json`` written when
    the Evaluation set ``engine_metric``). With ``--grid``, the config
    grid's lane instead (:func:`_cmd_eval_grid`)."""
    if getattr(args, "grid", None):
        return _cmd_eval_grid(args)
    if not args.evaluation:
        print("[ERROR] eval needs an Evaluation class "
              "(module:callable) or --grid grid.json", file=sys.stderr)
        return 1
    from predictionio_tpu_torch.controller.evaluation import (
        EngineParamsGenerator,
        Evaluation,
    )
    from predictionio_tpu_torch.core.base import WorkflowParams
    from predictionio_tpu_torch.core.context import ComputeContext
    from predictionio_tpu_torch.data.storage.base import EvaluationInstance
    from predictionio_tpu_torch.device import resolve_device
    from predictionio_tpu_torch.workflow import core_workflow
    from predictionio_tpu_torch.workflow.create_workflow import pio_env_vars

    ctx = ComputeContext(device=resolve_device(args.device))
    try:
        evaluation = core_workflow.load_engine_factory(args.evaluation)()
        if not isinstance(evaluation, Evaluation):
            raise TypeError(f"{args.evaluation} is not an Evaluation")
        if args.engine_params_generator:
            generator = core_workflow.load_engine_factory(
                args.engine_params_generator)()
            if not isinstance(generator, EngineParamsGenerator):
                raise TypeError(f"{args.engine_params_generator} is not an "
                                "EngineParamsGenerator")
            params_list = generator.engine_params_list
        elif isinstance(evaluation, EngineParamsGenerator):
            params_list = evaluation.engine_params_list
        else:
            raise ValueError(
                "no engine params: pass an EngineParamsGenerator class or "
                "make the Evaluation also an EngineParamsGenerator")
    except Exception as e:
        print(f"[ERROR] {e}", file=sys.stderr)
        return 1
    now = _dt.datetime.now(tz=_dt.timezone.utc)
    batch = getattr(args, "batch", "") or ""
    instance = EvaluationInstance(
        id="", status="INIT", start_time=now, end_time=now,
        evaluation_class=args.evaluation,
        engine_params_generator_class=args.engine_params_generator or "",
        batch=batch, env=pio_env_vars())
    try:
        result = core_workflow.run_evaluation(
            evaluation.engine, params_list, instance, evaluation.evaluator,
            evaluation=evaluation, params=WorkflowParams(batch=batch),
            ctx=ctx)
    except Exception as e:
        print(f"[ERROR] Evaluation failed: {e}", file=sys.stderr)
        return 1
    print(f"[INFO] {result.to_one_liner()}")
    _print_launches("assemble_normal_equations", "spd_solve",
                    "fused_gather_score_topk")
    return 0


def _apply_serving_flags(args) -> None:
    """--serve-precision -> $PIO_SERVE_PRECISION, --batch-window ->
    $PIO_BATCH_WINDOW: the env vars the serving code reads. The port
    serves through its one CUDA kernel, so --serve-kernel accepts only
    auto and fused."""
    if getattr(args, "serve_kernel", None) == "xla":
        raise ValueError(
            "--serve-kernel xla: the port has no XLA program; it serves "
            "through its CUDA top-k kernel (auto or fused)")
    serve_precision = getattr(args, "serve_precision", None)
    if serve_precision:
        os.environ["PIO_SERVE_PRECISION"] = serve_precision
    batch_window = getattr(args, "batch_window", None)
    if batch_window is not None:
        if batch_window < 0:
            raise SystemExit("--batch-window must be >= 0")
        os.environ["PIO_BATCH_WINDOW"] = repr(float(batch_window))


def cmd_deploy(args) -> int:
    """Console deploy (Console.scala:844-878): serve the given or latest
    COMPLETED engine instance on the ``--device`` (default cuda) until
    ``POST /stop`` or an interrupt; with ``--fleet N`` (N > 1), N
    replicas, each with its own device store, behind one balancer."""
    from predictionio_tpu_torch.core.context import ComputeContext
    from predictionio_tpu_torch.device import resolve_device
    from predictionio_tpu_torch.workflow.create_server import (
        QueryServer,
        ServerConfig,
        build_deployment,
        resolve_engine_instance,
    )

    # no env write here: QueryServer.start() sets PIO_FOLDIN from
    # ServerConfig(foldin=True), and setting it earlier would make start()
    # keep "1" as the prior value it restores at stop
    foldin = getattr(args, "foldin", "off") == "on"
    if args.feedback and not args.accesskey:
        # the reference refuses feedback without an access key
        print("[ERROR] Feedback loop cannot be enabled because accessKey "
              "is empty. Pass --accesskey.", file=sys.stderr)
        return 1
    ctx = ComputeContext(device=resolve_device(args.device))
    _apply_metrics_flag(args)
    _apply_tracing_flags(args)
    _apply_serving_flags(args)
    variant_id, variant_version = "default", "default"
    if os.path.exists(args.engine_variant):
        variant = _load_variant(args.engine_variant)
        variant_id = variant.get("id", "default")
        variant_version = variant.get("version", "default")
    config = ServerConfig(
        engine_id=getattr(args, "engine_id", None) or variant_id,
        engine_version=(getattr(args, "engine_version", None)
                        or variant_version),
        engine_variant=args.engine_variant,
        ip=args.ip,
        port=args.port,
        server_config_path=getattr(args, "server_config", None),
        foldin=foldin,
        feedback=args.feedback,
        event_server_ip=args.event_server_ip,
        event_server_port=args.event_server_port,
        access_key=args.accesskey,
        slo_config=getattr(args, "slo_config", None),
    )
    fleet_n = int(getattr(args, "fleet", 1) or 1)
    try:
        instance = resolve_engine_instance(
            args.engine_instance_id, config.engine_id,
            config.engine_version, config.engine_variant)
        if fleet_n > 1:
            from predictionio_tpu_torch.fleet.balancer import QueryFleet

            server = QueryFleet(config, replicas=fleet_n, instance=instance,
                                ctx=ctx).start()
        else:
            server = QueryServer(config,
                                 build_deployment(instance, ctx)).start()
    except Exception as e:
        print(f"[ERROR] Deploy failed: {e}", file=sys.stderr)
        return 1
    host, port = server.address
    if fleet_n > 1:
        print(f"[INFO] Engine is deployed on a {fleet_n}-replica fleet. "
              f"Engine API is live at {server.scheme}://{host}:{port}.",
              flush=True)
    else:
        print(f"[INFO] Engine is deployed and running. Engine API is live "
              f"at {server.scheme}://{host}:{port}.", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    # fold-in (--foldin on) assembles and solves each fold's users
    _print_launches("fused_gather_score_topk", "assemble_normal_equations",
                    "spd_solve")
    return 0


def cmd_batchpredict(args) -> int:
    """Bulk offline scoring (``pio batchpredict``): queries from a JSONL
    file or synthesized from the event store, run through the whole DASE
    serve path in restartable chunks on the ``--device`` (default
    cuda). See :mod:`predictionio_tpu_torch.batch.predict`."""
    from predictionio_tpu_torch.batch import (
        BatchPredictConfig,
        run_batch_predict,
        run_smoke,
    )
    from predictionio_tpu_torch.core.context import ComputeContext
    from predictionio_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    _apply_metrics_flag(args)
    _apply_tracing_flags(args)
    _apply_serving_flags(args)
    if args.smoke:
        return run_smoke(dev)
    if not args.output:
        print("[ERROR] --output is required (the shard/manifest "
              "directory).", file=sys.stderr)
        return 1
    try:
        base = json.loads(args.synthesize_base or "{}")
        if not isinstance(base, dict):
            raise ValueError("--synthesize-base must be a JSON object")
        variant_id, variant_version = "default", "default"
        if os.path.exists(args.engine_variant):
            variant = _load_variant(args.engine_variant)
            variant_id = variant.get("id", "default")
            variant_version = variant.get("version", "default")
        config = BatchPredictConfig(
            output_dir=args.output,
            engine_instance_id=args.engine_instance_id,
            engine_id=getattr(args, "engine_id", None) or variant_id,
            engine_version=(getattr(args, "engine_version", None)
                            or variant_version),
            engine_variant=args.engine_variant,
            input_path=args.input,
            synthesize_app=args.synthesize_app,
            synthesize_entity_type=args.synthesize_entity_type,
            synthesize_field=args.synthesize_field,
            synthesize_base=base,
            synthesize_channel=args.channel,
            chunk_size=args.chunk_size,
            query_partitions=args.query_partitions,
            format=args.format,
        )
        # --batch is parsed for parity with the JAX verb, where it labels
        # a compute context that nothing reads; the port's context has no
        # label, so it has no effect here either.
        summary = run_batch_predict(config, ctx=ComputeContext(device=dev))
    except Exception as e:
        print(f"[ERROR] Batch predict failed: {e}", file=sys.stderr)
        return 1
    print(f"[INFO] Batch predict completed: {summary['queries']} queries "
          f"in {summary['chunks']} chunks "
          f"({summary['chunksScored']} scored, "
          f"{summary['chunksSkipped']} resumed) -> "
          f"{summary['outputDir']} "
          f"[{summary['queriesPerSec']} q/s scoring]")
    _print_launches("fused_gather_score_topk")
    return 0


def cmd_undeploy(args) -> int:
    """Console undeploy (Console.scala:880-890): stop a running server.
    Probes HTTP first, then HTTPS, so it stops servers deployed with a
    TLS server.json without needing to know which scheme is live."""
    from predictionio_tpu_torch.workflow.undeploy import undeploy

    if undeploy(args.ip, args.port) \
            or undeploy(args.ip, args.port, scheme="https"):
        print("[INFO] Undeployed.")
        return 0
    print(f"[ERROR] Nothing at {args.ip}:{args.port} responded to /stop.",
          file=sys.stderr)
    return 1


def cmd_eventserver(args) -> int:
    """Console eventserver (Console.scala:741-745)."""
    from predictionio_tpu_torch.data.api import (
        EventServer,
        EventServerConfig,
    )

    _apply_metrics_flag(args)
    _apply_tracing_flags(args)  # $PIO_TRACE_DIR exports this side too
    service_key = getattr(args, "service_key", None) \
        or os.environ.get("PIO_EVENTSERVER_SERVICE_KEY") or None
    server = EventServer(EventServerConfig(
        ip=args.ip, port=args.port, stats=args.stats,
        service_key=service_key,
        server_config_path=getattr(args, "server_config", None))).start()
    host, port = server.address
    print(f"[INFO] Event Server is ready at {server.scheme}://{host}:{port}.",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    return 0


def cmd_adminserver(args) -> int:
    """Console adminserver (Console.scala:747-751). Prints the address
    it bound (``--port 0`` picks a free port)."""
    from predictionio_tpu_torch.tools.admin_server import (
        AdminServer,
        AdminServerConfig,
    )

    server = AdminServer(AdminServerConfig(ip=args.ip,
                                           port=args.port)).start()
    print(f"[INFO] Admin Server is ready at http://{args.ip}:{server.port}.",
          flush=True)
    server.serve_forever()
    return 0


def cmd_dashboard(args) -> int:
    """Console dashboard (Console.scala:753-757). Prints the address it
    bound (``--port 0`` picks a free port)."""
    from predictionio_tpu_torch.common import ServerConfig
    from predictionio_tpu_torch.tools.dashboard import (
        Dashboard,
        DashboardConfig,
    )

    server_config = ServerConfig.load(args.server_config) \
        if args.server_config else ServerConfig.load()
    server = Dashboard(DashboardConfig(ip=args.ip, port=args.port,
                                       server_config=server_config)).start()
    scheme = "https" if server_config.ssl_certfile else "http"
    print(f"[INFO] Dashboard is ready at {scheme}://{args.ip}:{server.port}.",
          flush=True)
    server.serve_forever()
    return 0
