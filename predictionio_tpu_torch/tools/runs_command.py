"""``pio runs list|show|compare`` — render training run histories.

The port's copy of ``predictionio_tpu/tools/runs_command.py``: the same
text for the same run-log directory.

The offline reader for the append-only run logs training writes under
``<checkpoint_dir>/runs/`` (workflow/runlog.py): ``list`` summarizes
every run, ``show`` renders one run's loss curve as an ASCII chart plus
its per-chunk sample table, ``compare`` aligns two runs by step and
diffs their objectives. Pure host-side file reading — no torch import, no
live server needed, works on a directory long after the training
process is gone (the ``pio trace`` offline-dir idiom).
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence, Tuple

from predictionio_tpu_torch.workflow import runlog


def _resolve_dir(args) -> Optional[str]:
    d = (getattr(args, "dir", None)
         or os.environ.get("PIO_CHECKPOINT_DIR", "").strip())
    if not d:
        print("runs: no directory — pass --dir or set "
              "$PIO_CHECKPOINT_DIR", file=sys.stderr)
        return None
    if not os.path.isdir(d):
        print(f"runs: directory not found: {d}", file=sys.stderr)
        return None
    return d


def _fmt_loss(v: Optional[float]) -> str:
    return "-" if v is None else f"{v:.6g}"


def _fmt_when(ts: Optional[float]) -> str:
    if not ts:
        return "-"
    import datetime as _dt

    return _dt.datetime.fromtimestamp(ts).strftime("%Y-%m-%d %H:%M:%S")


def ascii_chart(points: Sequence[Tuple[int, float]], width: int = 60,
                height: int = 12) -> List[str]:
    """Plot (step, value) points on a ``width x height`` character
    grid: ``*`` marks samples, ``·`` fills the line between adjacent
    samples, a left gutter labels the y-extremes. Degenerates politely
    for 1 sample or a flat curve."""
    points = [(int(s), float(v)) for s, v in points]
    if not points:
        return ["(no finite loss samples)"]
    points.sort(key=lambda p: p[0])
    steps = [p[0] for p in points]
    vals = [p[1] for p in points]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or abs(hi) or 1.0
    s_lo, s_hi = steps[0], steps[-1]
    s_span = (s_hi - s_lo) or 1
    grid = [[" "] * width for _ in range(height)]

    def cell(step: int, val: float) -> Tuple[int, int]:
        x = int(round((step - s_lo) / s_span * (width - 1)))
        y = int(round((val - lo) / span * (height - 1)))
        return height - 1 - y, x

    # connect adjacent samples so sparse runs still read as a curve
    for (s0, v0), (s1, v1) in zip(points, points[1:]):
        r0, c0 = cell(s0, v0)
        r1, c1 = cell(s1, v1)
        n = max(abs(c1 - c0), abs(r1 - r0), 1)
        for t in range(n + 1):
            r = r0 + (r1 - r0) * t // n
            c = c0 + (c1 - c0) * t // n
            grid[r][c] = "·"
    for s, v in points:
        r, c = cell(s, v)
        grid[r][c] = "*"

    top, bottom = f"{hi:.5g}", f"{lo:.5g}"
    gutter = max(len(top), len(bottom))
    lines = []
    for r, row in enumerate(grid):
        label = top if r == 0 else bottom if r == height - 1 else ""
        lines.append(f"{label:>{gutter}} |" + "".join(row))
    lines.append(" " * gutter + " +" + "-" * width)
    foot = f"step {s_lo}"
    tail = f"{s_hi}"
    pad = width - len(foot) - len(tail)
    lines.append(" " * gutter + "  " + foot + " " * max(1, pad) + tail)
    return lines


def _curve_points(samples: Sequence[dict]) -> List[Tuple[int, float]]:
    out = []
    for s in samples:
        total = runlog._loss_total(s)
        if total is not None:
            out.append((int(s.get("step", 0)), total))
    return out


def cmd_list(args) -> int:
    d = _resolve_dir(args)
    if d is None:
        return 2
    runs = runlog.list_runs(d)
    if not runs:
        print(f"no training runs under {d} (run `pio train` with "
              "checkpointing + telemetry on to record one)")
        return 0
    print(f"{'RUN ID':<34} {'SAMPLES':>7} {'STEP':>9} "
          f"{'LAST LOSS':>12}  {'UPDATED':<19} CONTEXT")
    for r in runs[:int(getattr(args, "n", 20) or 20)]:
        step = "-" if r["lastStep"] is None else (
            f"{r['lastStep']}/{r['totalIterations']}"
            if r["totalIterations"] else str(r["lastStep"]))
        ctx = r.get("context") or {}
        ctx_s = " ".join(f"{k}={v}" for k, v in sorted(ctx.items()))
        print(f"{r['runId']:<34} {r['samples']:>7} {step:>9} "
              f"{_fmt_loss(r['lastLoss']):>12}  "
              f"{_fmt_when(r['updatedAt']):<19} {ctx_s}")
    return 0


def _load(d: str, run_id: str) -> Optional[dict]:
    path = runlog.find_run(d, run_id)
    if path is None:
        known = ", ".join(r["runId"] for r in runlog.list_runs(d)) \
            or "(none)"
        print(f"runs: no run matching {run_id!r} under {d} "
              f"(known: {known})", file=sys.stderr)
        return None
    return runlog.read_run(path)


def cmd_show(args) -> int:
    d = _resolve_dir(args)
    if d is None:
        return 2
    run = _load(d, args.run_id)
    if run is None:
        return 2
    header = run["header"]
    samples = run["samples"]
    print(f"run {run['runId']}")
    if header.get("createdAt"):
        print(f"  created      {header['createdAt']}")
    if header.get("totalIterations") is not None:
        print(f"  iterations   {header['totalIterations']} "
              f"(checkpoint every {header.get('checkpointEvery', '?')})")
    ctx = header.get("context") or {}
    if ctx:
        print("  context      "
              + " ".join(f"{k}={v}" for k, v in sorted(ctx.items())))
    print(f"  samples      {len(samples)}")
    print()
    for line in ascii_chart(_curve_points(samples)):
        print(line)
    print()
    print(f"{'STEP':>7} {'FIT':>12} {'L2':>12} {'TOTAL':>12} "
          f"{'WALL s':>8} {'HBM MB':>8}")
    for s in samples:
        loss = s.get("loss") or {}
        fit, l2 = loss.get("fit"), loss.get("l2")
        if isinstance(fit, list):
            # grid run: show the best alive config's decomposition
            total_v = loss.get("total") or []
            best = min((t for t in total_v
                        if isinstance(t, (int, float))), default=None)
            i = total_v.index(best) if best is not None else None
            fit = None if i is None else fit[i]
            l2 = None if i is None else (loss.get("l2") or [])[i]
        hbm = s.get("hbmBytesInUse")
        print(f"{s.get('step', 0):>7} {_fmt_loss(fit):>12} "
              f"{_fmt_loss(l2):>12} "
              f"{_fmt_loss(runlog._loss_total(s)):>12} "
              f"{s.get('wallSeconds', 0):>8.3f} "
              f"{'-' if hbm is None else f'{hbm / 1e6:.1f}':>8}")
    return 0


def cmd_compare(args) -> int:
    d = _resolve_dir(args)
    if d is None:
        return 2
    run_a = _load(d, args.run_a)
    run_b = _load(d, args.run_b)
    if run_a is None or run_b is None:
        return 2
    a = dict(_curve_points(run_a["samples"]))
    b = dict(_curve_points(run_b["samples"]))
    steps = sorted(set(a) | set(b))
    if not steps:
        print("neither run has finite loss samples")
        return 0
    na, nb = run_a["runId"], run_b["runId"]
    print(f"A = {na}")
    print(f"B = {nb}")
    print()
    print(f"{'STEP':>7} {'A total':>14} {'B total':>14} "
          f"{'B - A':>14}")
    for s in steps:
        va, vb = a.get(s), b.get(s)
        delta = None if va is None or vb is None else vb - va
        print(f"{s:>7} {_fmt_loss(va):>14} {_fmt_loss(vb):>14} "
              f"{_fmt_loss(delta):>14}")
    both = [s for s in steps if s in a and s in b]
    if both:
        last = both[-1]
        d_last = b[last] - a[last]
        better = "B" if d_last < 0 else "A" if d_last > 0 else "tie"
        print()
        print(f"at step {last}: {better} "
              f"{'is lower by ' + _fmt_loss(abs(d_last)) if better != 'tie' else ''}")
    return 0


def dispatch(args) -> int:
    cmd = getattr(args, "runs_command", None)
    if cmd == "list":
        return cmd_list(args)
    if cmd == "show":
        return cmd_show(args)
    if cmd == "compare":
        return cmd_compare(args)
    print("usage: pio runs {list|show|compare} [--dir DIR]",
          file=sys.stderr)
    return 2
