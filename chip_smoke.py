#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's training and query paths once on one GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --serving-times   # phases 1 and 4 only
    python3 chip_smoke.py --prepare-times   # phase 5's prepare step only

Phases (any failure raises and the script exits non-zero):

1. Print the card (``nvidia-smi``), build every kernel source with
   ``nvcc`` from this checkout (one ``nvcc`` per source, started
   together) and the native ingest kernels and JSON lines codec with
   ``g++`` beside them, and print the build times.
2. Hold the serving kernel against its plain PyTorch version on the card
   at the serving path's shapes (M=26,744 items, R=64; B in {1, 8, 256};
   k in {16, 128, 129, 2,048, 2,049, 6,000, 26,741}: both sides of the
   chunked route's limit and of the threshold between the bitonic sort
   of the k winners and the cluster sort of the whole row, and k ending
   inside the row; fp32, bf16 and int8 stores), on random data with the
   seen mask on and on integer data with ties across tiles with it on
   and off; then k = M = 26,744 at B in {1, 256} on the integer fixture
   and with 20,000 of each query's items seen-masked, and stores of
   60,000 and 120,000 items (wide cluster shares, and one block sorting a
   row too wide for the cluster), exactly. Then the chunked route's
   edges, exactly: a store of 2,048 * 13 + 100 items (a last chunk
   shorter than k), top scores tied across chunk boundaries, and rows
   with all but 0, 5, 300 or 6,744 items seen. Prints the launches by
   route.
5. Train the recommendation template at MovieLens-20M width from the
   event store: about 20M synthetic ratings of 138,493 users x 26,744
   items from ``--seed`` (lognormal row lengths of mean ~140 capped at
   2,048, power-law item popularity, 0.5-5.0 stars) are written as
   ``rate`` events in a seeded random order, with one ``$set`` of genres
   per item, to a ``jsonlfs`` store in a temporary directory (1,000,000
   events a partition, through ``append_raw_lines``; the script checks
   the free space first and removes the store after phase 5b).
   ``create_workflow`` reads them through ``EventDataSource`` with
   ``pipelinedIngest`` (1,000,000-event blocks, 4 partitions decoded
   ahead by the native JSON lines codec, each block sorted as it
   arrives, the runs merged natively) and the categories, prepares them
   with ``RatingsPreparator(bucketed=True)`` and trains
   ``ALSParams(rank=64, num_iterations=3)``, implicit. Both training
   kernels' launch counts must rise, and the native ``parse_jsonl``,
   ``merge_sorted_runs``, ``bucket_fill`` and ``segment_starts`` must
   run; the write seconds, the read's stages (decode, index, merge) and
   events/s, and the prepare step's split (the dedup's sort and sum,
   each side's fill, the column re-sort, the seen lists, the
   categories) are printed. One more iteration runs under the profiler
   (time and device busy share), and the plain trainer runs the same 3
   iterations from the same init on the card for comparison. With
   ``--prepare-times`` the script runs only the prepare step, on these
   ratings made in memory: copied to the root of another checkout, it
   times that checkout's prepare step the same way.
5b. The scale ingest over the same store: ``ingest_ratings_pipelined``
   (decode, index and per-block sort overlapped; merge, dedup and both
   sides' bucket fill, each side copied to the card from pinned memory
   on a copy stream while the host fills the other; the trainer's
   warm-up beside them), with each stage's busy seconds, the wall time,
   the overlap ratio (busy / wall) and the pinning's seconds printed.
   Every staged table, copied back, must be byte-equal to the table phase
   5's preparator built, and ``train_als_bucketed`` on the staged sides
   must give factors bitwise equal to phase 5's model (the same kernels
   on the same inputs from the same init).
2b. Hold the two training kernels against their plain versions: the
   assembly on every row of every bucket of both sides (trained and
   integer factors, implicit and explicit weights, the layout's own
   zero-weight padding), on synthetic rows the kernel splits across
   blocks (8 of 100,000 slots, 64 of 5,000 ending mid-span), at ranks
   1, 10, 30, 128 and 208 on rows it groups and rows it splits, and its
   large-rank route at 209, 256 and 320; the solve, which must be
   bitwise equal to plain, on B in {1, 127, 4,096, 138,493} random SPD
   systems, an ill-scaled family and real training systems at rank 64,
   and at ranks 1-320 on small batches (both workspace routes, the
   256-column chunk boundary). Both kernels also at the fold-in solve's
   shapes: B in {8, 64, 256} with all but 1, 5 and 200 rows padding, L
   in {8, 256, 2,048, 4,096} (past one assembly span). The assembly's
   bf16 route (a bf16 factor store, the bf16 training precision) the
   same way on every bucket of both sides at rank 64, at ranks 1-320
   (odd ranks, whose bf16 rows are not 4-byte aligned, and both routes)
   and at the fold-in shapes, each case also bitwise equal to the fp32
   route on the store widened to fp32. Then train at rank 256 (2,000
   users x 1,000 items, 2 iterations, through the large-rank assembly
   and the device-memory solve) and hold it against the plain trainer
   from one init.
5c. The training options at ML-20M width on phase 5's tables and
   params: (a) ``precision="bf16"`` through ``train_als_bucketed`` (every
   assembly launch on the bf16 route), within ``EPS_BF16`` of the plain
   bf16 trainer on the card and within ``4 * 3 * EPS_BF16`` of phase 5's
   fp32 factors (relative Frobenius), and one profiled iteration of each
   lane (wall, device, B3 / B2 ms); (b) ``checkpoint_every=1`` in fp32
   and bf16: bitwise equal to the unchunked runs, a preemption after
   step 1 (``request_stop`` from the progress callback) raises
   ``TrainingPreempted``, the resume is bitwise equal, the run log holds
   one run with steps 1-3 and their fit / l2; each save's blob MB and
   ms, and the median wall with checkpoints over without (printed beside
   the JAX package's 3% gate, not asserted).
5d. The tuning grid at ML-20M width on phase 5's ratings, from memory
   (no second read): each user's last rating in stream order held out,
   as ``pio eval --grid`` splits them, the rest bucketed and staged once;
   8 configs (rank 32 / 64 x lambda 0.01 / 0.1 x alpha 1 / 40) and a
   ninth with alpha = 1e38, 10 iterations, implicit, fp32, through
   ``train_als_grid_bucketed`` (every assembly launch on B3's config-axis
   route, one a bucket for all configs; B2 over ``k * B`` systems), and
   the leaderboard of 4,096 held-out users through ``grid_topk`` (B1, one
   launch per config per 512 users). Checks: (a) the alive mask is 8 x
   True then False, the dead lane all zeros, every factor finite; (b)
   each config against its serial ``train_als_bucketed`` run from the
   same init: bitwise at rank 64, within 1e-4 / 1e-5 at rank 32, pad
   columns exactly zero; (c) B3's grid route at the largest bucket's
   shape bitwise equal to k single launches (fp32, and a bf16 store,
   which must also equal the fp32 route on the widened store), within
   the reordering bound of its plain version, and bitwise plain on an
   integer fixture; (d) ``grid_topk`` through B1 equal to its plain
   version wherever the scores are finite, and every config's
   Precision@10 / NDCG@10 equal to the plain pipeline's; (e) with
   ``PIO_TUNING_HBM_BUDGET`` forcing 3 sub-batches, the factors bitwise
   the full grid's and the leaderboard equal. Prints the grid's wall and
   per-iteration time beside the 8 serial trainings', B3's grid route
   over one grid iteration against k single launches, plain, the library
   call and its bound, B1 at ``grid_topk``'s shape, the leaderboard's
   host time, and the peak device memory against
   ``grid_bytes_per_config * k`` plus the tables.
3. Serve the model phase 5 trained: start the port's QueryServer, send
   user, blacklist, category, item-similarity and unknown-user queries,
   some from 8 concurrent clients, and check every answer against the
   same pipeline with the plain version in place of the serving kernel.
   Its launch count must rise, and every launch at k <= 128 (in batches
   below ``CHUNKED_MAX_B``) must take the chunked route; the launches are
   printed by (route, k, B). The sequential queries are sent again from
   a client process, each with a ``traceparent`` of its own; its trace,
   read back from ``/traces/<id>``, splits its latency into parts that
   sum to the client's (the median of each part per query kind is
   printed); every span's children must sum to no more than the span,
   and the server span must be no longer than the client's latency. A
   burst is captured
   with ``tracing.profile_trace``: the device busy share, and the
   ``device.execute`` spans' CUDA-event time, which must lie between
   0.98 times the profiler's time of the serving kernel's kernels and
   the burst's wall time. ``/metrics``, parsed with the port's
   ``parse_prometheus``, must count the requests sent, the users lane's
   dispatches and one ``pio_dispatch_device_seconds`` observation per
   launch of the phase; ``/dispatches.json``'s lane summaries are
   printed. Last, the sequential queries run from a client process in 10
   rounds of 5 runs: metrics, tracing and device telemetry on, all
   killed, and each alone on; each mode's percentiles, and the user
   queries' split with all on against tracing alone.
3b. Online fold-in at ML-20M width: a sqlite event store in a
   temporary directory holds the full histories of 512 of phase 5's
   users in phase 5's event order (the heaviest, at the 2,048 cap,
   among them); ``QueryServer(ServerConfig(foldin=True))`` serves a
   model built from phase 5's factors, maps and seen lists (bf16 store,
   seen ``[138,493, 2,048]``; phase 3's store freed first) with
   ``PIO_FOLDIN_INTERVAL=0.5``, and the port's event server (``pio
   eventserver``, a process of its own) writes to the same store.
   Through ``POST /batch/events.json``, 50 events a request from 8
   threads of a client process: 1-3 new ratings for 256 of the 512 (the
   heaviest passes the seen table's width), 256 new users with 5-200
   ratings each (the store grows along the ladder, ``_bucket(needed,
   lo=capacity)``, to 276,986 rows), and events the
   consumer must ignore (``view``, ratings of unknown items, item
   ``$set``). Checks: (a) every new user answers non-empty within 30 s,
   with no ``/reload``, and a known user's new items are masked; (b)
   the store's rows of the 512 folded users equal ``fold_in_users`` with
   the plain versions of both training kernels on their histories read
   back from the store, cast to bf16 (within ``FOLDIN_ROW_TOL`` of each
   row's largest entry); (c) 1,024 users' HTTP answers equal the plain
   pipeline over the patched store; (d) while the events are folded,
   untouched users' answers do not move and no query fails, and, on a
   store of its own, 8 threads' ``users_topk`` for 256 users never see
   a mix of two row sets another thread alternates (one patch growing
   the store); (e) each fold launches both training kernels once, the
   serving kernel launches, ``/metrics`` counts the new and known users
   and the folds, and ``/dispatches.json`` holds ``foldin`` records
   with CUDA-event time. Prints each fold's gather / solve / patch ms
   (from its ``pio.foldin`` trace) and the solve's device us, the
   growing patches' time under the store lock, the seen tables' bytes,
   event -> servable p50 / p99 (first post to first non-empty answer,
   and ``pio_foldin_freshness_seconds``), and query p50 / p99 during
   the folds beside phase 3's.
4. Time the serving kernel at every (store, B, k) against its bound, its
   plain version and one library call, and at k <= 128 (bf16, and every
   store at B = 8) split its device time by kernel name under the
   profiler; print the HTTP p50/p99. With ``--serving-times`` the script
   builds and runs this phase alone: copied to the root of another
   checkout, it times that checkout's kernel the same way.
4c. At k in {16, 128} on the bf16 store, run the chunked and the bitonic
   route on the same inputs at B from 1 to 256: their answers must be
   bitwise equal; print each route's device and event-timed ms and the
   batch from which the bitonic route is as fast, beside the plan's
   ``CHUNKED_MAX_B``.
4b. Time the training kernels at the full-width shapes (the assembly on
   every bucket of both sides, the solve on each side's whole batch)
   against their bounds, plain versions and one library call each; at
   the fold-in shapes (B, L) = (8, 256), (64, 256), (256, 2,048); the
   assembly's bf16 route on every bucket of both sides (its bound reads
   the store at 2 bytes a value; its library call is ``torch.einsum``
   over the bf16 gather widened to fp32); and, off the main path, the
   device-memory solve at rank 320 and the large-rank assembly at rank
   256.
6. The lifecycle at MovieLens-1M's size (6,040 users x 3,706 items,
   1,000,209 ratings, rank 64): a sqlite event store in a temporary
   directory (``PIO_STORAGE_*`` set before the registry's first use),
   an app and its access key, the ratings as ``rate`` events (100,000-row
   ``insert_raw_batch`` chunks, 1,000 more through ``insert_batch``) and
   one ``$set`` of categories per item; ``create_workflow`` reads them
   through ``EventDataSource`` in 250,000-event blocks, trains and
   stores a ``COMPLETED`` engine instance (both training kernels and the
   native merge must run). A second process deploys it from the sqlite
   file (``resolve_engine_instance`` -> ``build_deployment`` ->
   ``QueryServer``) and answers 50 queries over HTTP, each equal to
   ``serve_query`` on the model training returned; a second instance
   (the next seed) is trained and ``POST /reload`` swaps to it while 8
   clients query (no query may fail; the answers then equal the second
   model's), and a reload to the older instance must answer 409. The
   second process must have launched the top-k kernel. Each step's
   seconds are printed.
6b. The quick start through the port's console, at phase 6's size and
   with its events and variant: every step is a subprocess of
   ``python -m predictionio_tpu_torch.tools.console`` over a sqlite
   store of its own. ``pio app new ML1M``, ``pio accesskey list``;
   ``pio import`` loads the 1,000,209 ratings from a JSONL file in the
   export format (events/s); ``pio eventserver --port 0`` takes the
   1,000 extra ``rate`` and the 3,706 item ``$set`` events through
   ``POST /batch/events.json`` (50 a request, 8 client threads) and 100
   ``view`` events one ``POST /events.json`` each (events/s, a batch
   request's p50 and p99), so the store holds phase 6's events in phase
   6's order; ``pio template get recommendation``, ``pio
   build`` and ``pio train --trace-dir`` on the card (read, prepare and
   train seconds from the exported ``dase.*`` spans; both training
   kernels must launch; the largest factor distance to phase 6's first
   instance); ``pio deploy`` as a child answers phase 6's queries equal
   to the model loaded in-process from its own instance, and its
   ``/dispatches.json`` holds flight records with CUDA-event time;
   ``POST /profile/start``, ``/profile/stop`` and a second stop (409);
   ``pio undeploy`` (the child must have launched the top-k kernel, and
   the port answer nothing after); ``pio export`` writes one line per
   event written. Then the crash pair: ``pio train --precision bf16
   --checkpoint-dir D --checkpoint-every 1``, each save held 2 s by
   ``PIO_FAULTS`` (slow), is killed with SIGKILL once its second
   checkpoint lands; ``pio train ... --resume`` must give factors bitwise
   equal to an uninterrupted ``pio train --precision bf16``, and ``pio
   runs list`` / ``show`` one run whose steps rise to 3.
6c. ``pio eval`` through the console at ML-1M, on phase 6b's store: a
   ``pio-torch eval --grid`` child (rank 32 / 64 x lambda 0.01 / 0.1, 10
   iterations) exits 0 and writes the leaderboard, whose winner carries
   full ``engineParams``; a ``pio-torch eval chip_smoke:ml1m_evaluation``
   child (the template's ``RecommendationEvaluation`` over the app, on a
   ``FastEvalEngine``) exits 0, writes ``best.json`` and stores an
   ``EVALCOMPLETED`` evaluation instance, its batch prediction launching
   B1's batched route; each param set's Precision@10 equals the one
   scored in this process on the same trained factors with B1 and with
   its plain version.
7. Model quality on ``bench_quality.run``'s protocol at its shape
   (943 x 1,682 x 100,000, leave-last-2-out, rank 32, 10 iterations):
   Precision@10 and NDCG@10 of the port's trainer at seeds 3, 17 and
   42, its ratio to the plain trainer from seed 3's init (must be
   0.99-1.01) and the seed band's lift over popularity (must exceed 1);
   the bf16 lane's Precision@10 from seed 3 must be at least fp32's
   minus 0.02 (the JAX package's gate).

It prints a ``{"kernels": [...]}`` line (the training kernels' ``routes``
hold the main path's, the large-rank one and ``foldin``, with phase 3b's
launches, the config grid's, with phase 5d's, and the assembly's
``tiles_bf16``, with phase 5c's; the serving kernel's ``eval_routes``
hold ``grid_topk`` and ``batch_predict``, with phases 5d's and 6c's),
the card's name and power limit, and last ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

H100_BYTES_PER_S = 3.35e12    # HBM3 rate of an H100 SXM
H100_FP32_FLOPS = 67e12       # fp32 outside the tensor cores
M_ITEMS, N_USERS, RANK = 26_744, 138_493, 64
BATCHES = (1, 8, 256)
# phase 4's k: the main path's two small k (the chunked route), the
# widest bitonic sort and the whole row (category queries)
TIME_KS = (16, 128, 2048, M_ITEMS)
# phase 2's k: both sides of the chunked route's limit (128) and of the
# threshold between the bitonic sort of the winners and the sort of the
# whole row (sort width 2,048), a k that ends inside the row (6,000), and
# the whole row (category queries)
CHECK_KS = (16, 128, 129, 2048, 2049, 6000, M_ITEMS)
RTOL = 1e-5
ITERATIONS, LAMBDA, ALPHA = 3, 0.01, 1.0
# phase 2b's other assembly ranks: one warp a block at 1 and 10, up to
# the kernel's limit on an H100 (208)
OTHER_RANKS = (1, 10, 30, 128, 208)
# the assembly's large-rank route (above 208), and the solve's ranks
# besides 64: the shared-memory route up to 239, device memory above,
# and both sides of the 256-column chunk
LARGE_RANKS = (209, 256, 320)
SOLVE_RANKS = (1, 31, 32, 33, 65, 239, 240, 241, 256, 320)
# phase 2b's large-rank training run
LARGE_TRAIN = dict(users=2_000, items=1_000, rank=256, iterations=2)
# the fold-in solve's shapes (phase 3b): a user batch B on the
# power-of-two ladder from 8, all but a few of its rows padding, and a
# history length L from 8 to past one assembly span (2,048); phase 2b
# checks every pair, phase 4b times three
FOLD_BATCHES = ((8, 1), (64, 5), (256, 200))      # (B, real rows)
FOLD_LENGTHS = (8, 256, 2048, 4096)
FOLD_TIMED = ((8, 1, 256), (64, 5, 256), (256, 200, 2048))
# relative Frobenius distance allowed between the kernel-trained and the
# plain-trained factors after ITERATIONS iterations from one init: both
# sum in fp32 in different orders (about 1e-7 relative per normal
# equation), which the solves amplify by the systems' condition numbers
# and the iterations carry on; the JAX package holds its own trainers to
# 1e-3 after 3 implicit iterations
TRAIN_RTOL = 1e-3
# one bf16 rounding (8-bit mantissa). The bf16 lane is held to the JAX
# package's own bound against fp32, 4 * iterations * EPS_BF16
# (tests/test_als_precision.py); the bf16 kernel-trained factors to
# EPS_BF16 against the plain bf16 trainer's: the two sum A and b in
# other orders, so a factor that lies at a bf16 rounding boundary may
# take its other neighbour, and the next iterations carry that on
EPS_BF16 = 2.0 ** -8
# phase 2b's ranks for B3's bf16 route: odd ranks (a bf16 row of 2R bytes
# is then not 4-byte aligned), both sides of multiples of 8 (a 16-byte
# copy of 8 values), the tile route's limit (208) and the large-rank
# route above it
BF16_RANKS = (1, 7, 10, 30, 33, 63, 64, 65, 127, 128, 208, 209, 256, 320)
# phase 5c: trainings timed with and without checkpoints (the median is
# printed) and the JAX package's gate on the ratio, which is printed and
# never asserted here (tests/test_train_checkpoint.py:829-843)
CKPT_REPEATS = 3
CKPT_OVERHEAD_GATE = 1.03
# phase 6b: the delay each checkpoint save of the child to be killed
# takes (PIO_FAULTS slow), so it is still alive when its second
# checkpoint lands
KILL_SAVE_DELAY_S = 2.0


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


# -- phase 1 ----------------------------------------------------------------

HOST_SOURCES = ("ingest_kernels", "jsonl_codec")


def build_kernels() -> float:
    """Build every source at once: one nvcc per CUDA source, and g++ for
    the native host kernels (the ingest kernels, the JSON lines codec) on
    a thread beside them."""
    from predictionio_tpu_torch import native
    from predictionio_tpu_torch.ops import _build, als_cuda

    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    shutil.rmtree(native.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    host = {}

    def build_host():
        try:
            for name in HOST_SOURCES:
                native.load(name)
            host["seconds"] = time.perf_counter() - t0
        except BaseException as e:  # raised below, after nvcc ends
            host["error"] = e

    gxx = threading.Thread(target=build_host)
    gxx.start()
    _build.build_libraries(als_cuda.KERNEL_NAMES)
    seconds = time.perf_counter() - t0
    gxx.join()
    if "error" in host:
        raise host["error"]
    print(f"[build] {', '.join(n + '.cu' for n in als_cuda.KERNEL_NAMES)}: "
          f"nvcc sm_90a, started together, {seconds:.1f} s -> "
          + ", ".join(_build.library_path(n).name
                      for n in als_cuda.KERNEL_NAMES))
    print(f"[build] {', '.join(f'native/src/{n}.cpp' for n in HOST_SOURCES)}"
          f": g++ -O3, beside them, {host['seconds']:.1f} s -> "
          + ", ".join(native.library_path(n).name for n in HOST_SOURCES))
    return seconds


# -- phase 2 ----------------------------------------------------------------

def make_store(Yf: np.ndarray, dtype: str, dev):
    """The item table as the serving store holds it, and its fp32 view."""
    import torch

    from predictionio_tpu_torch.ops.quantize import (
        dequantize_rows,
        quantize_rows_int8,
    )

    t = torch.from_numpy(Yf).to(dev)
    if dtype == "int8":
        store = quantize_rows_int8(t)
        return store, dequantize_rows(store)
    store = t.to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    return store, store.float()


def check_topk(kv, ki, pv, pi, tol, exact: bool) -> float:
    """Kernel (kv, ki) [B, k] against plain (pv, pi) [B, k+1] (one extra
    column of context, -inf past M). Returns the largest |value error|.

    Exact fixtures: finite values and ids equal. Otherwise values agree
    within RTOL*|v| + tol[b], where tol[b] = RTOL*|q_b|*max|y| covers the
    reduction-order error of an fp32 dot product (at most R*2^-24 times
    sum|q_r*y_r| <= |q||y|) for scores that cancel to near zero; ids are
    equal wherever the plain neighbours on both sides differ by more
    than twice the allowance (only such a near tie can swap)."""
    B, k = kv.shape
    fin = np.isfinite(pv[:, :k])
    with np.errstate(invalid="ignore"):  # -inf - -inf past the candidates
        return _check_topk(kv, ki, pv, pi, tol, exact, B, k, fin)


def _check_topk(kv, ki, pv, pi, tol, exact, B, k, fin) -> float:
    if not (np.isfinite(kv) == fin).all():
        raise AssertionError("-inf slots differ between kernel and plain")
    # each row's ids, sorted (a sort per row: np.unique per row is a
    # hash per call on newer numpy, many times slower at B = 256)
    ids = np.sort(np.where(fin, ki, -1), axis=1)
    bad = (ki < 0) & fin
    bad[:, 1:] |= (ids[:, 1:] == ids[:, :-1]) & (ids[:, 1:] >= 0)
    if bad.any():
        raise AssertionError(f"row {np.argwhere(bad)[0][0]}: negative or "
                             "repeated ids")
    err = np.abs(kv - pv[:, :k], where=fin, out=np.zeros_like(kv))
    if exact:
        if not ((kv[fin] == pv[:, :k][fin]).all()
                and (ki[fin] == pi[:, :k][fin]).all()):
            raise AssertionError("exact fixture: kernel differs from plain")
        return float(err.max(initial=0.0))
    allow = RTOL * np.abs(np.where(fin, pv[:, :k], 0)) + tol[:, None]
    if (err > allow).any():
        b, j = np.argwhere(err > allow)[0]
        raise AssertionError(f"value [{b},{j}]: kernel {kv[b, j]!r} plain "
                             f"{pv[b, j]!r} beyond {allow[b, j]!r}")
    v = np.where(np.isfinite(pv), pv, -np.inf)
    gap = 2 * (RTOL * np.abs(np.where(np.isfinite(v), v, 0)) + tol[:, None])
    sep_prev = np.ones((B, k), dtype=bool)
    sep_prev[:, 1:] = (v[:, :k - 1] - v[:, 1:k]) > gap[:, 1:k]
    sep_next = (v[:, :k] - v[:, 1:k + 1]) > gap[:, :k]
    sep = sep_prev & sep_next & fin
    if not (ki[sep] == pi[:, :k][sep]).all():
        raise AssertionError("ids differ at separated scores")
    return float(err.max(initial=0.0))


def fixture(kind: str, B: int, rng):
    """Queries, item table, seen [L, B] tables for one phase-2 case."""
    L = 64
    if kind == "random":
        Q = rng.normal(size=(B, RANK)).astype(np.float32)
        Y = rng.normal(size=(M_ITEMS, RANK)).astype(np.float32)
    else:
        # small integers: every score is an exact integer, ties abound;
        # rows 120..219 are one row that wins every query, so the top
        # ties straddle the 128-row tile boundary
        Q = rng.integers(1, 4, (B, RANK)).astype(np.float32)
        Y = rng.integers(-3, 4, (M_ITEMS, RANK)).astype(np.float32)
        Y[120:220] = 5.0
        Y[:, 0] = 127.0 * np.sign(Y[:, 0] + 0.5)  # int8 scale 1: exact
    cols = rng.integers(0, M_ITEMS, (L, B)).astype(np.int32)
    cols[:4] = np.asarray([121, 127, 128, 150])[:, None]
    mask = (rng.random((L, B)) < 0.7).astype(np.float32)
    return Q, Y, cols, mask


def topk_case(Qt, store, ct, mt, *, k, n_items, mask_seen=True,
              row_valid=None, tol=None, m=M_ITEMS) -> float:
    """One kernel call held against plain (exact when ``tol`` is None)."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    B = Qt.shape[0]
    kw = dict(n_items=n_items, mask_seen=mask_seen, row_valid=row_valid)
    kv, ki = als_cuda.fused_gather_score_topk(Qt, store, ct, mt, k=k, **kw)
    torch.cuda.synchronize()
    pv, pi = als_cuda.fused_gather_score_topk_plain(
        Qt, store, ct, mt, k=min(k + 1, m), **kw)
    pv, pi = pv.cpu().numpy(), pi.cpu().numpy()
    if pv.shape[1] == k:
        pv = np.pad(pv, ((0, 0), (0, 1)), constant_values=-np.inf)
        pi = np.pad(pi, ((0, 0), (0, 1)))
    exact = tol is None
    return check_topk(kv.cpu().numpy(), ki.cpu().numpy(), pv, pi,
                      np.zeros(B, np.float32) if exact else tol, exact=exact)


def routes_of(by_key: dict) -> dict:
    """Launches by route, from the wrapper's counts by (route, k, B)."""
    out: dict = {}
    for (route, _, _), n in sorted(by_key.items()):
        out[route] = out.get(route, 0) + n
    return out


def kernel_checks(dev, seed: int) -> tuple:
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    als_cuda.launches.reset()
    rng = np.random.default_rng(seed)
    worst, cases = 0.0, 0
    for kind in ("random", "integer"):
        for B in BATCHES:
            Q, Yf, cols, mask = fixture(kind, B, rng)
            for dtype in ("fp32", "bf16", "int8"):
                store, Ydq = make_store(Yf, dtype, dev)
                Qt = torch.from_numpy(Q).to(dev)
                ct = torch.from_numpy(cols).to(dev)
                mt = torch.from_numpy(mask).to(dev)
                tol = (RTOL * torch.linalg.vector_norm(Qt, dim=1)
                       * torch.linalg.vector_norm(Ydq, dim=1).max()
                       ).cpu().numpy()
                for k in CHECK_KS:
                    for mask_seen in (True, False)[:2 if kind == "integer"
                                                  else 1]:
                        n_items = M_ITEMS - 3
                        worst = max(worst, topk_case(
                            Qt, store, ct, mt, k=min(k, n_items),
                            n_items=n_items, mask_seen=mask_seen,
                            tol=None if kind == "integer" else tol))
                        cases += 1
    # the whole row, k = M: the integer fixture (ties across tiles), and
    # a seen mask over most of the row (many -inf keys)
    for B in (1, 256):
        Q, Yf, cols, mask = fixture("integer", B, rng)
        L = 20_000
        many = np.stack([rng.permutation(M_ITEMS)[:L] for _ in range(B)],
                        axis=1).astype(np.int32)
        for ct_np, mt_np in ((cols, mask), (many, np.ones((L, B), np.float32))):
            for dtype in ("fp32", "int8"):
                store, _ = make_store(Yf, dtype, dev)
                Qt, ct, mt = (torch.from_numpy(a).to(dev)
                              for a in (Q, ct_np, mt_np))
                topk_case(Qt, store, ct, mt, k=M_ITEMS, n_items=M_ITEMS)
                cases += 1
    # wider stores: the cluster sort with shares of 7,500 pairs (60,000
    # items, k = 30,000 and k = M), and rows too wide for the cluster,
    # sorted by one block through device memory (120,000 items)
    Qt = torch.from_numpy(Q).to(dev)
    ct, mt = (torch.from_numpy(a).to(dev) for a in (cols, mask))
    for wide, k in ((60_000, 30_000), (60_000, 60_000), (120_000, 3000),
                    (120_000, 120_000)):
        Yw = torch.from_numpy(np.concatenate([Yf] * 5)[:wide]).to(dev)
        topk_case(Qt, Yw, ct, mt, k=k, n_items=wide, m=wide)
        cases += 1
    # the optional per-row validity vector (sharded stores use it)
    Q, Yf, cols, mask = fixture("integer", 8, rng)
    store, _ = make_store(Yf, "fp32", dev)
    rv = torch.from_numpy((rng.random(M_ITEMS) < 0.9).astype(np.float32)
                          ).to(dev)
    Qt, ct, mt = (torch.from_numpy(a).to(dev) for a in (Q, cols, mask))
    for k in (128, 4096):
        topk_case(Qt, store, ct, mt, k=k, n_items=M_ITEMS, row_valid=rv)
        cases += 1
    cases += chunked_route_checks(dev, rng)
    routes = routes_of(als_cuda.launches.by_key())
    print(f"[kernel] fused_gather_score_topk == plain in {cases} cases "
          f"(k in {CHECK_KS} and k = M; integer fixtures exact; max |value "
          f"err| {worst!r}); launches by route {routes}")
    return worst, routes


def chunked_route_checks(dev, rng) -> int:
    """The chunked route's edges, each exact on integer data: a last chunk
    shorter than k (2,048 * 13 + 100 rows holding the top scores in their
    last 100), top scores tied across chunk boundaries, and rows with all
    but 0, 5, 300 or 6,744 items seen (whole chunks -inf)."""
    import torch

    cases = 0
    Q, Yf, cols, mask = fixture("integer", 8, rng)
    Qt, ct, mt = (torch.from_numpy(a).to(dev) for a in (Q, cols, mask))
    short = 2048 * 13 + 100
    Ys = Yf[:short].copy()
    Ys[-100:] = 5.0
    cs = torch.from_numpy(cols % short).to(dev)
    for dtype in ("fp32", "int8"):
        store, _ = make_store(Ys, dtype, dev)
        for k in (16, 100, 128, 129):
            topk_case(Qt, store, cs, mt, k=k, n_items=short, m=short)
            cases += 1
    # the fixture's tied top rows 120..219, plus rows 2,040..2,059 and
    # 4,090..4,099 (each across a chunk boundary) and the last 50
    Yt = Yf.copy()
    for lo, hi in ((2040, 2060), (4090, 4100), (M_ITEMS - 50, M_ITEMS)):
        Yt[lo:hi] = 5.0
    for B in BATCHES:
        Q, _, cols, mask = fixture("integer", B, rng)
        cols[4:8] = np.asarray([2045, 2050, 4095, 4096])[:, None]
        Qt, ct, mt = (torch.from_numpy(a).to(dev) for a in (Q, cols, mask))
        for dtype in ("fp32", "bf16", "int8"):
            store, _ = make_store(Yt, dtype, dev)
            for k in (1, 16, 128):
                topk_case(Qt, store, ct, mt, k=k, n_items=M_ITEMS)
                cases += 1
    # all but `left` items of each query seen (L = 20,000 at 6,744 left),
    # with the bitonic route's k = 129 beside the chunked route's k
    for B in (1, 256):
        Q, Yf, _, _ = fixture("integer", B, rng)
        Qt = torch.from_numpy(Q).to(dev)
        store, _ = make_store(Yf, "fp32", dev)
        for left in (0, 5, 300, M_ITEMS - 20_000):
            L = M_ITEMS - left
            many = np.stack([rng.permutation(M_ITEMS)[:L] for _ in range(B)],
                            axis=1).astype(np.int32)
            ct = torch.from_numpy(many).to(dev)
            mt = torch.ones((L, B), device=dev)
            for k in (16, 128, 129):
                topk_case(Qt, store, ct, mt, k=k, n_items=M_ITEMS)
                cases += 1
    return cases


# -- phase 5: training -----------------------------------------------------

def ml20m_ratings(seed: int):
    """About 20M ratings at MovieLens-20M width: lognormal row lengths
    (mean ~140 = 20M / 138,493 users) capped at 2,048 (the heaviest user
    reaches the cap), each user's distinct items drawn by a power-law
    popularity (twice over, first occurrences kept, cut to length), 0.5
    to 5.0 stars; and 1-3 of 20 genres per item."""
    rng = np.random.default_rng(seed)
    lens = np.clip(rng.lognormal(4.25, 1.2, N_USERS).astype(np.int64), 1,
                   2048)
    lens[np.argmax(lens)] = 2048
    return power_law_ratings(rng, lens, M_ITEMS)


def power_law_ratings(rng, lens, n_items: int):
    """Each user's ``lens[u]`` distinct items, drawn by a power-law
    popularity (twice over, first occurrences kept, cut to length), 0.5
    to 5.0 stars, and 1-3 of 20 genres per item."""
    n_users = len(lens)
    pop = 1.0 / (np.arange(n_items) + 10.0) ** 0.8
    draws = rng.choice(n_items, size=int(2 * lens.sum()), p=pop / pop.sum())
    user_of = np.repeat(np.arange(n_users), 2 * lens)
    key = user_of * n_items + draws
    order = np.argsort(key, kind="stable")
    first = np.ones(len(key), dtype=bool)
    first[1:] = key[order][1:] != key[order][:-1]
    kept = np.sort(order[first])            # first draws, in draw order
    users = user_of[kept]
    rank = np.arange(len(kept)) - np.searchsorted(users, users)
    sel = rank < lens[users]
    rows, cols = users[sel], draws[kept][sel]
    return (rows, cols) + stars_and_genres(rng, len(rows), n_items)


def stars_and_genres(rng, n_ratings: int, n_items: int) -> tuple:
    """0.5-5.0 stars per rating, and 1-3 of 20 genres per item."""
    values = (rng.integers(1, 11, n_ratings) * 0.5).astype(np.float32)
    genres = [f"g{g}" for g in range(20)]
    cats = {f"i{i}": tuple(rng.choice(genres, size=rng.integers(1, 4),
                                      replace=False))
            for i in range(n_items)}
    return values, cats


class PrepareSplit:
    """Times the parts of the preparator's step by wrapping, while it is
    entered, the functions the step calls through module attributes:
    the dedup (its sort, then its sum), each side's bucket fill, the
    column re-sort between them (the layout's remainder), the seen lists
    and the categories. Functions a tree lacks are left out (the parent
    of the native fill has no ``seen_lists`` / ``index_categories``:
    their time stays in ``rest``)."""

    def __init__(self):
        self.calls: dict = {}
        self._saved: list = []

    def _wrap(self, mod, name: str, label: str) -> None:
        fn = getattr(mod, name, None)
        if fn is None:
            return

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.calls.setdefault(label, []).append(
                    time.perf_counter() - t0)

        self._saved.append((mod, name, fn))
        setattr(mod, name, timed)

    def __enter__(self) -> "PrepareSplit":
        from predictionio_tpu_torch.ops import als
        from predictionio_tpu_torch.templates.recommendation import engine

        self._wrap(als, "dedup_sum_ratings", "dedup")
        self._wrap(als, "dedup_sum_sorted", "dedup sum")
        self._wrap(als, "_bucket_grouped", "fill")
        self._wrap(engine, "bucket_ratings_pair", "layout")
        self._wrap(engine, "seen_lists", "seen lists")
        self._wrap(engine, "index_categories", "categories")
        return self

    def __exit__(self, *exc) -> None:
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []

    def split(self, total: float) -> dict:
        """Seconds per part of a prepare step that took ``total``."""
        def s(label):
            return sum(self.calls.get(label, []))

        fills = self.calls.get("fill", [])
        if len(fills) != 2 or len(self.calls.get("layout", [])) != 1:
            raise AssertionError(f"not one bucketed layout: {self.calls}")
        out = {"dedup sort": s("dedup") - s("dedup sum"),
               "dedup sum": s("dedup sum"),
               "user fill": fills[0], "column re-sort":
               s("layout") - s("dedup") - fills[0] - fills[1],
               "item fill": fills[1]}
        for label in ("seen lists", "categories"):
            out[label] = s(label) if label in self.calls else None
        out["rest"] = (total - s("layout") - s("seen lists")
                       - s("categories"))
        out["total"] = total
        return out


# the store's line of one rating, as ``bench.py``'s scale store writes it
RATE_LINE = ('{{"event":"rate","entityType":"user","entityId":"u{}",'
             '"targetEntityType":"item","targetEntityId":"i{}",'
             '"properties":{{"rating":{}}},'
             '"eventTime":"2020-01-01T00:00:00+00:00"}}')
SET_LINE = ('{{"event":"$set","entityType":"item","entityId":"i{}",'
            '"properties":{{"categories":{}}},'
            '"eventTime":"2020-01-01T00:00:00+00:00"}}')
ML20M_APP = "MovieLens20M"
ML20M_PART = 1_000_000      # events per partition file, and per read block
ML20M_PREFETCH = 4          # partitions decoded ahead
LINE_BYTES = 200            # room for one rate line (they take ~177)


def ml20m_store(seed: int) -> dict:
    """Phase 5's event store: the ML-20M-width ratings as ``rate`` events
    in a seeded random order (a live stream interleaves its users) and
    one ``$set`` of genres per item, appended with ``append_raw_lines``
    to a ``jsonlfs`` store in a temporary directory (1,000,000 events a
    partition; metadata and models in memory). Fails before writing when
    the directory's disk lacks room; the caller removes it."""
    import os
    import tempfile

    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.storage.base import App

    rows, cols, values, cats = ml20m_ratings(seed)
    work = tempfile.mkdtemp(prefix="pio-ml20m-")
    need = LINE_BYTES * (len(rows) + len(cats))
    free = shutil.disk_usage(work).free
    if free < 2 * need:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"phase 5's event store needs about {need / 1e9:.1f}"
                           f" GB (and as much again for the page cache's "
                           f"sake) in {work}, which has {free / 1e9:.1f} GB "
                           f"free; point TMPDIR elsewhere")
    storage.reset(storage.StorageConfig(
        sources={"EV": {"type": "jsonlfs", "path": os.path.join(work, "ev"),
                        "part_max_events": ML20M_PART},
                 "META": {"type": "memory"}},
        repositories={"EVENTDATA": "EV", "METADATA": "META",
                      "MODELDATA": "META"}))
    t0 = time.perf_counter()
    app_id = storage.get_metadata_apps().insert(App(0, ML20M_APP))
    levents = storage.get_levents()
    levents.init(app_id)
    order = np.random.default_rng(seed + 11).permutation(len(rows))
    stars = [repr(k / 2) for k in range(11)]
    for a in range(0, len(order), ML20M_PART):
        pick = order[a:a + ML20M_PART]
        levents.append_raw_lines([
            RATE_LINE.format(u, i, stars[s]) for u, i, s in zip(
                rows[pick].tolist(), cols[pick].tolist(),
                np.rint(values[pick] * 2).astype(np.int64).tolist())],
            app_id)
    levents.append_raw_lines([SET_LINE.format(iid[1:], json.dumps(list(c)))
                              for iid, c in cats.items()], app_id)
    write_s = time.perf_counter() - t0
    root = levents._dir(app_id, None)
    nbytes = sum(os.path.getsize(os.path.join(root, f))
                 for f in os.listdir(root))
    print(f"[store] {len(rows)} rate events in a seeded random order and "
          f"{len(cats)} $set events written to a jsonlfs store in "
          f"{write_s:.2f} s: {len(os.listdir(root)) - 1} partitions, "
          f"{nbytes} bytes ({nbytes / (len(rows) + len(cats)):.1f} a line), "
          f"{free / 1e9:.1f} GB were free")
    return {"work": work, "app_id": app_id, "n_ratings": len(rows),
            "write_s": write_s, "bytes": nbytes,
            # phase 3b writes some users' histories in this event order
            "ratings": (rows, cols, values, order)}


def remove_store(store: dict) -> None:
    from predictionio_tpu_torch.data import storage

    storage.reset()
    shutil.rmtree(store["work"], ignore_errors=True)


def ml20m_variant(seed: int) -> dict:
    return {"id": "ml20m", "engineFactory": PORT_FACTORY,
            "datasource": {"params": {
                "appName": ML20M_APP, "streamingBlockSize": ML20M_PART,
                "pipelinedIngest": True, "decodePrefetch": ML20M_PREFETCH,
                "readItemCategories": True}},
            "preparator": {"params": {"bucketed": True}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "numIterations": ITERATIONS,
                "lambda": LAMBDA, "alpha": ALPHA, "seed": seed}}]}


def stage_busy(summary: dict) -> dict:
    return {k: v["busy_sec"] for k, v in summary["stages"].items()}


def bucket_tables(side, dev):
    return [(b.row_ids, b.cols, b.weights, b.mask)
            for b in side.to_device(dev).buckets]


def train_full_width(dev, seed: int, store: dict) -> dict:
    """Phase 5: ``create_workflow`` over the ML-20M-width store, read with
    ``pipelinedIngest``; then one profiled iteration and the plain
    trainer from the same init."""
    import torch

    from predictionio_tpu_torch.core.context import ComputeContext
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.native import codec
    from predictionio_tpu_torch.ops import als as als_mod
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.workflow.create_workflow import (
        WorkflowConfig,
        create_workflow,
    )

    engine, record = lifecycle_engine()
    als_cuda.assemble_launches.reset()
    als_cuda.spd_launches.reset()
    for counter in (codec.parse_calls, codec.fill_calls, codec.segment_calls,
                    codec.merge_calls):
        counter.reset()
    t0 = time.perf_counter()
    with PrepareSplit() as split:
        iid = create_workflow(
            WorkflowConfig(engine_id="ml20m", engine_factory=PORT_FACTORY,
                           engine_variant="ml20m.json"),
            ml20m_variant(seed), engine=engine, ctx=ComputeContext())
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"assemble_normal_equations": als_cuda.assemble_launches.value,
                "spd_solve": als_cuda.spd_launches.value}
    native_calls = {"parse_jsonl": codec.parse_calls.value,
                    "merge_sorted_runs": codec.merge_calls.value,
                    "bucket_fill": codec.fill_calls.value,
                    "segment_starts": codec.segment_calls.value}
    instance = storage.get_metadata_engine_instances().get(iid)
    if instance is None or instance.status != "COMPLETED":
        raise AssertionError(f"engine instance {iid}: {instance}")
    model, td = record["model"], record["read_out"]
    pd, prep_s = record["prepare_out"], record["prepare"]
    for name, n in {**launches, **native_calls}.items():
        if n == 0:
            raise AssertionError(f"{name} was never called on the training "
                                 "path")
    if len(td) != store["n_ratings"] or td.runs is not None:
        raise AssertionError(f"the pipelined read gave {len(td)} ratings "
                             f"(runs {td.runs}), not {store['n_ratings']} "
                             f"merged")
    read = td.timeline.summary()
    print(f"[train] read {len(td)} ratings in {record['read']!r} s "
          f"({len(td) / record['read']!r} events/s): stage busy s "
          f"{json.dumps(stage_busy(read))}, wall {read['wall_sec']!r} s, "
          f"overlap {read['overlap_ratio']!r}; the categories "
          f"{record['read'] - read['wall_sec']!r} s")
    prepare_split = split.split(prep_s)
    print(f"[train] prepare step split (s): {json.dumps(prepare_split)}; "
          f"native calls {native_calls}")
    if not (np.isfinite(model.user_factors).all()
            and np.isfinite(model.item_factors).all()):
        raise AssertionError("non-finite trained factors")
    print(f"[train] create_workflow {total:.1f} s (read "
          f"{record['read']:.2f}, prepare {prep_s:.2f} on the host, train "
          f"{record['train']:.2f}); instance {iid} COMPLETED; model "
          f"{model.user_factors.shape} x {model.item_factors.shape} on "
          f"{model.device}")
    for name, side in (("user", pd.user_side), ("item", pd.item_side)):
        print(f"[train] {name} side: {len(side.buckets)} buckets, L "
              f"{[b.max_len for b in side.buckets]}, {side.nnz} ratings in "
              f"{side.padded_slots} padded slots, occupancy "
              f"{side.occupancy!r}")
    print(f"[train] launches on the training path: {launches} "
          f"({ITERATIONS} iterations)")

    # one more iteration, profiled: its time and the device's busy share
    u_t, i_t = bucket_tables(pd.user_side, dev), bucket_tables(pd.item_side,
                                                               dev)
    kw = dict(lam=LAMBDA, alpha=ALPHA, implicit=True, slot_budget=None)
    X0, Y0 = als_mod.init_factors(pd.user_side.n_rows, pd.item_side.n_rows,
                                  RANK, seed, dev)
    als_mod.als_iterations_bucketed(X0, Y0, u_t, i_t, num_iterations=1, **kw)
    wall, busy, kernels, _ = device_busy(lambda: als_mod.als_iterations_bucketed(
        X0, Y0, u_t, i_t, num_iterations=1, **kw))
    print(f"[train] one iteration: wall {wall!r} ms, device busy {busy!r} ms "
          f"({100 * busy / wall:.2f}%); kernels "
          f"{dict(kernels.most_common(8))}")

    # the plain trainer from the same init, on the card
    saved = (als_cuda.assemble_normal_equations, als_cuda.spd_solve)
    als_cuda.assemble_normal_equations = \
        als_cuda.assemble_normal_equations_plain
    als_cuda.spd_solve = als_cuda.spd_solve_plain
    try:
        t1 = time.perf_counter()
        Xp, Yp = als_mod.als_iterations_bucketed(
            X0, Y0, u_t, i_t, num_iterations=ITERATIONS, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
    finally:
        als_cuda.assemble_normal_equations, als_cuda.spd_solve = saved
    errs = {}
    for name, got, want in (("user", model.user_factors, Xp),
                            ("item", model.item_factors, Yp)):
        want = want.cpu().numpy()
        errs[name] = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    print(f"[train] kernel vs plain trainer after {ITERATIONS} iterations "
          f"(plain {plain_s:.1f} s): relative Frobenius error {errs} "
          f"(allowed {TRAIN_RTOL})")
    if max(errs.values()) > TRAIN_RTOL:
        raise AssertionError(f"trained factors differ from the plain "
                             f"trainer's: {errs}")
    del u_t, i_t, X0, Y0, Xp, Yp
    return {"model": model, "pd": pd, "launches": launches,
            "iteration_ms": wall, "busy_ms": busy, "prepare_s": prep_s,
            "prepare_split": prepare_split, "native_calls": native_calls,
            "train_errs": errs, "read_s": record["read"],
            "read_stages": stage_busy(read)}


def scale_ingest(dev, seed: int, store: dict, trained: dict) -> dict:
    """Phase 5b: ``ingest_ratings_pipelined`` over phase 5's store, staging
    both sides to the card while the host works on (and warming the
    trainer up beside it); the staged tables must be byte-equal to the
    preparator's, and training on them bitwise equal to phase 5's
    model."""
    import torch

    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.columnar import ingest_ratings_pipelined
    from predictionio_tpu_torch.native import codec
    from predictionio_tpu_torch.ops import als as als_mod
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.utils.tracing import StageTimeline

    params = als_mod.ALSParams(rank=RANK, num_iterations=ITERATIONS,
                               lambda_=LAMBDA, alpha=ALPHA, seed=seed)
    for counter in (codec.parse_calls, als_cuda.assemble_launches,
                    als_cuda.spd_launches):
        counter.reset()
    timeline = StageTimeline()
    t0 = time.perf_counter()
    res = ingest_ratings_pipelined(
        storage.get_pevents().find_columnar_blocks(
            store["app_id"], entity_type="user", event_names=["rate"],
            target_entity_type="item", value_property="rating",
            default_value=1.0, block_size=ML20M_PART,
            prefetch=ML20M_PREFETCH),
        stage_device=True, warmup_params=params, timeline=timeline)
    staging = [(side.staging.pin_seconds, side.staging.nbytes)
               if side.staging is not None else None
               for side in (res.user_side, res.item_side)]
    if dev.type == "cuda" and None in staging:
        raise AssertionError(f"a side was not staged asynchronously: "
                             f"{staging}")
    res.wait(warmup=False)   # the warm-up's tail belongs to training
    ingest_s = time.perf_counter() - t0
    summary = timeline.summary()
    # the ingest stages proper: waits are idle time, the warm-up training's
    busy = sum(v for k, v in stage_busy(summary).items()
               if k not in ("warmup_compile", "warmup_wait", "h2d.wait"))
    print(f"[ingest] {res.n_events} events, {res.nnz} unique pairs in "
          f"{ingest_s!r} s ({res.n_events / ingest_s!r} events/s); stage "
          f"busy s {json.dumps(stage_busy(summary))}; ingest busy {busy!r} "
          f"s over wall {ingest_s!r} s: overlap {busy / ingest_s!r}")
    print(f"[ingest] pinning before the copies (s, bytes): user "
          f"{staging[0]}, item {staging[1]}")
    pd = trained["pd"]
    for name, got, want in (("user map", res.user_map, pd.user_map),
                            ("item map", res.item_map, pd.item_map)):
        if got.to_dict() != want.to_dict():
            raise AssertionError(f"the staged {name} differs from phase 5's")
    for name, got, want in (("user", res.user_side, pd.user_side),
                            ("item", res.item_side, pd.item_side)):
        if len(got.buckets) != len(want.buckets):
            raise AssertionError(f"{name} side: {len(got.buckets)} buckets "
                                 f"staged, {len(want.buckets)} prepared")
        for j, (g, w) in enumerate(zip(got.buckets, want.buckets)):
            for field in ("row_ids", "cols", "weights", "mask"):
                table = getattr(g, field)
                if table.device.type != dev.type or (
                        table.cpu().numpy().tobytes()
                        != getattr(w, field).tobytes()):
                    raise AssertionError(f"{name} side bucket {j}: the "
                                         f"staged {field} differs from the "
                                         f"preparator's")
    res.join_warmup()
    t1 = time.perf_counter()
    X, Y = als_mod.train_als_bucketed(res.user_side, res.item_side, params,
                                      dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    model = trained["model"]
    if X.tobytes() != model.user_factors.tobytes() or \
            Y.tobytes() != model.item_factors.tobytes():
        raise AssertionError("factors trained on the staged tables differ "
                             "from phase 5's")
    calls = {"parse_jsonl": codec.parse_calls.value,
             "assemble_normal_equations": als_cuda.assemble_launches.value,
             "spd_solve": als_cuda.spd_launches.value}
    for name, n in calls.items():
        if n == 0:
            raise AssertionError(f"{name} was never called in phase 5b")
    print(f"[ingest] staged tables byte-equal to the preparator's; "
          f"train_als_bucketed on them {train_s:.2f} s, factors bitwise "
          f"equal to phase 5's; calls {calls}")
    return {"ingest_s": ingest_s, "events": res.n_events,
            "stages": stage_busy(summary), "overlap": busy / ingest_s,
            "staging": staging}


def prepare_times(seed: int) -> dict:
    """``--prepare-times``: the phase-5 ratings through the preparator
    alone (bucketed), with its split. Copied to the root of another
    checkout (e.g. the parent, from ``git archive``), it times that
    checkout's prepare step the same way."""
    from predictionio_tpu_torch.data.bimap import StringIndexBiMap
    from predictionio_tpu_torch.templates.recommendation.engine import (
        IndexedTrainingData,
        PreparatorParams,
        RatingsPreparator,
    )

    rows, cols, values, cats = ml20m_ratings(seed)
    td = IndexedTrainingData(
        StringIndexBiMap.from_distinct([f"u{u}" for u in range(N_USERS)]),
        StringIndexBiMap.from_distinct([f"i{i}" for i in range(M_ITEMS)]),
        rows, cols, values)
    td.item_categories = cats
    try:
        from predictionio_tpu_torch import native
        from predictionio_tpu_torch.native import codec
    except ImportError:  # a tree without the native fill
        codec = None
    else:
        native.load("ingest_kernels")   # built before the clock starts
        for counter in (codec.fill_calls, codec.segment_calls):
            counter.reset()
    preparator = RatingsPreparator(PreparatorParams(bucketed=True))
    with PrepareSplit() as split:
        t0 = time.perf_counter()
        preparator.prepare(None, td)
        total = time.perf_counter() - t0
    return {"ratings": int(len(rows)), "split": split.split(total),
            "native_calls": None if codec is None else {
                "bucket_fill": codec.fill_calls.value,
                "segment_starts": codec.segment_calls.value}}


# -- phase 2b: training kernels against their plain versions -------------------

def side_factors(model, side: str):
    """The fixed factors a side's solve reads."""
    return model.item_factors if side == "user" else model.user_factors


def assembly_weights(bucket, explicit: bool, dev):
    import torch

    from predictionio_tpu_torch.ops.als import implicit_weights

    m = torch.as_tensor(bucket.mask, device=dev)
    w = torch.as_tensor(bucket.weights, device=dev) * m
    return (m, w) if explicit else implicit_weights(w, ALPHA)


def assembly_tolerance(Y, cols, aw, bw, gram, L: int):
    """Elementwise allowance for two fp32 sums of the same terms in
    different orders: each lies within (L+3) * 2^-24 of the sum of the
    terms' magnitudes (the products' own roundings add two units), so
    they differ by at most twice that."""
    from predictionio_tpu_torch.ops import als_cuda

    Aa, ba = als_cuda.assemble_normal_equations_plain(
        Y.abs(), cols, aw.abs(), bw.abs(), gram.abs())
    u = 2.0 * (L + 3) * 2.0 ** -24
    return u * Aa, u * ba


def check_assembly(Y, cols, aw, bw, gram, exact: bool, label: str) -> float:
    """The kernel on the whole batch, held against plain in row slices of
    at most 2^22 slots: equal on integer fixtures, else within the
    reordering bound. Returns the largest |error|."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    A, b = als_cuda.assemble_normal_equations(Y, cols, aw, bw, gram)
    torch.cuda.synchronize()
    B, L = cols.shape
    n = max(1, (1 << 22) // max(L, 1))    # rows per plain [n, L, R] gather
    worst = 0.0
    for s in range(0, B, n):
        r = slice(s, s + n)
        Ap, bp = als_cuda.assemble_normal_equations_plain(
            Y, cols[r], aw[r], bw[r], gram)
        eA, eb = (A[r] - Ap).abs(), (b[r] - bp).abs()
        if exact:
            if not (torch.equal(A[r], Ap) and torch.equal(b[r], bp)):
                raise AssertionError(f"assembly {label} rows {s}+: integer "
                                     "fixture differs from plain")
        else:
            tA, tb = assembly_tolerance(Y, cols[r], aw[r], bw[r], gram, L)
            if (eA > tA).any() or (eb > tb).any():
                raise AssertionError(f"assembly {label} rows {s}+: beyond "
                                     "the reordering bound")
        worst = max(worst, float(eA.max()), float(eb.max()))
    return worst


def check_assembly_bf16(Y, cols, aw, bw, gram, exact: bool,
                        label: str) -> float:
    """B3's bf16 route on a bf16 store ``Y``: held against the plain
    version on the same tensor as :func:`check_assembly` holds the fp32
    route (the plain version widens ``Y`` exactly), and bitwise equal to
    the fp32 route on ``Y.float()``: the route only converts each row as
    it gathers it, and sums as the fp32 route does. Returns the largest
    |error| against plain."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    worst = check_assembly(Y, cols, aw, bw, gram, exact, label)
    A, b = als_cuda.assemble_normal_equations(Y, cols, aw, bw, gram)
    A32, b32 = als_cuda.assemble_normal_equations(Y.float(), cols, aw, bw,
                                                  gram)
    torch.cuda.synchronize()
    if not (torch.equal(A, A32) and torch.equal(b, b32)):
        raise AssertionError(f"assembly {label}: the bf16 route differs from "
                             f"the fp32 route on the widened store")
    return worst


def synthetic_rows(dev, rng, shapes=((8, 100_000), (64, 5_000))) -> list:
    """Synthetic rows of ``B x L`` slots, each real up to a random length
    from L/2 (implicit weights, padding last). The default shapes are
    longer than the assembly's span, so the kernel splits them: 8 rows of
    100,000 slots, and 64 rows of 5,000 whose real slots end in the
    middle of a span."""
    import torch

    from predictionio_tpu_torch.ops.als import implicit_weights

    out = []
    for B, L in shapes:
        lens = rng.integers(L // 2, L + 1, B)
        lens[0] = L
        mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
        cols = np.where(mask > 0, rng.integers(0, M_ITEMS, (B, L)), 0)
        w = (rng.integers(1, 11, (B, L)) * 0.5).astype(np.float32) * mask
        aw, bw = implicit_weights(torch.from_numpy(w).to(dev), ALPHA)
        out.append((torch.from_numpy(cols.astype(np.int32)).to(dev), aw, bw,
                    f"synthetic {B} x {L}"))
    return out


def fold_rows(dev, rng, B: int, real: int, L: int) -> tuple:
    """A fold-in solve table as ``pad_fold_in_batch`` lays it out: the
    first ``real`` of ``B`` rows hold 1 to ``L`` ratings (the first
    exactly ``L``) of items drawn at random, 0.5 to 5.0 stars; the other
    rows and slots are padding (weight 0). Returns ``(cols, aw, bw)``
    with the implicit weights."""
    import torch

    from predictionio_tpu_torch.ops.als import implicit_weights

    lens = np.zeros(B, dtype=np.int64)
    lens[:real] = rng.integers(1, L + 1, real)
    lens[0] = L
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    cols = np.where(mask > 0, rng.integers(0, M_ITEMS, (B, L)), 0)
    w = (rng.integers(1, 11, (B, L)) * 0.5).astype(np.float32) * mask
    aw, bw = implicit_weights(torch.from_numpy(w).to(dev), ALPHA)
    return torch.from_numpy(cols.astype(np.int32)).to(dev), aw, bw


def training_kernel_checks(dev, trained: dict, seed: int) -> dict:
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    from predictionio_tpu_torch.ops.als import _round_bf16

    model, pd = trained["model"], trained["pd"]
    rng = np.random.default_rng(seed + 3)
    worst = {"assemble": 0.0, "spd": 0.0}
    cases = rows_checked = bf16_cases = 0

    def both_kinds(Yt, Yi, cols, aw, bw, explicit, label, bf16=False):
        nonlocal cases, bf16_cases
        if bf16:    # B3's bf16 route, on the weights the bf16 lane gives it
            Yt, Yi = Yt.to(torch.bfloat16), Yi.to(torch.bfloat16)
            aw, bw = _round_bf16(aw), _round_bf16(bw)
        for kind, Y in (("trained", Yt), ("integer", Yi)):
            R = Y.shape[1]
            if kind == "integer":
                gram = torch.from_numpy(rng.integers(
                    -4, 5, (R, R)).astype(np.float32)).to(dev)
            elif explicit:
                gram = torch.zeros((R, R), device=dev)
            else:
                gram = Y.float().T @ Y.float() + LAMBDA * torch.eye(
                    R, device=dev)
            check = check_assembly_bf16 if bf16 else check_assembly
            worst["assemble"] = max(worst["assemble"], check(
                Y, cols, aw, bw, gram, kind == "integer",
                f"{label} explicit={explicit} {kind}"
                + (" bf16" if bf16 else "")))
            cases += 1
            bf16_cases += bf16

    for side_name, side in (("user", pd.user_side), ("item", pd.item_side)):
        Yt = torch.from_numpy(side_factors(model, side_name)).to(dev)
        Yi = torch.from_numpy(rng.integers(-3, 4, tuple(Yt.shape)).astype(
            np.float32)).to(dev)
        for bucket in side.buckets:
            B, L = bucket.cols.shape
            cols = torch.as_tensor(bucket.cols, device=dev)
            for explicit in (False, True):
                aw, bw = assembly_weights(bucket, explicit, dev)
                both_kinds(Yt, Yi, cols, aw, bw, explicit, f"{side_name} L={L}")
            both_kinds(Yt, Yi, cols, aw, bw, True, f"{side_name} L={L}",
                       bf16=True)
            aw, bw = assembly_weights(bucket, False, dev)
            both_kinds(Yt, Yi, cols, aw, bw, False, f"{side_name} L={L}",
                       bf16=True)
            rows_checked += B
        if side_name == "item":
            for cols, aw, bw, label in synthetic_rows(dev, rng):
                both_kinds(Yt, Yi, cols, aw, bw, False, label)
    # other ranks, from blocks of one warp up to the kernel's limit: rows
    # a block groups and rows it splits, random and integer factors
    for R in OTHER_RANKS + LARGE_RANKS:
        Yr = torch.from_numpy(0.3 * rng.standard_normal(
            (M_ITEMS, R)).astype(np.float32)).to(dev)
        Yi = torch.from_numpy(rng.integers(-3, 4, (M_ITEMS, R)).astype(
            np.float32)).to(dev)
        for cols, aw, bw, label in synthetic_rows(dev, rng,
                                                  ((300, 40), (9, 5_000))):
            both_kinds(Yr, Yi, cols, aw, bw, False, f"R={R} {label}")
    for R in BF16_RANKS:
        Yr = torch.from_numpy(0.3 * rng.standard_normal(
            (M_ITEMS, R)).astype(np.float32)).to(dev)
        Yi = torch.from_numpy(rng.integers(-3, 4, (M_ITEMS, R)).astype(
            np.float32)).to(dev)
        for cols, aw, bw, label in synthetic_rows(dev, rng,
                                                  ((300, 40), (9, 5_000))):
            both_kinds(Yr, Yi, cols, aw, bw, False, f"R={R} {label}",
                       bf16=True)
    # the fold-in solve's shapes: mostly padding rows, up to two spans
    Yt = torch.from_numpy(model.item_factors).to(dev)
    Yi = torch.from_numpy(rng.integers(-3, 4, tuple(Yt.shape)).astype(
        np.float32)).to(dev)
    fold_tables = []
    for (B, real) in FOLD_BATCHES:
        for L in FOLD_LENGTHS:
            cols, aw, bw = fold_rows(dev, rng, B, real, L)
            for bf16 in (False, True):
                both_kinds(Yt, Yi, cols, aw, bw, False,
                           f"fold B={B} ({real} real) L={L}", bf16=bf16)
            fold_tables.append((B, L, cols, aw, bw))
    print(f"[kernel] assemble_normal_equations == plain in {cases} cases "
          f"(every row of every bucket of both sides, {rows_checked} rows, "
          f"in 4 kinds each; 8 x 100,000 and 64 x 5,000 synthetic split "
          f"rows; R in {OTHER_RANKS + LARGE_RANKS} on 300 x 40 and 9 x "
          f"5,000 rows, the large-rank route from 209; the fold-in shapes "
          f"B x L in {[b for b, _ in FOLD_BATCHES]} x {list(FOLD_LENGTHS)} "
          f"with all but {[r for _, r in FOLD_BATCHES]} rows padding; "
          f"integer fixtures exact; max |err| {worst['assemble']!r}); "
          f"{bf16_cases} of them the bf16 route on a bf16 store (every "
          f"bucket of both sides at R={RANK}, implicit and explicit; R in "
          f"{BF16_RANKS}; the fold-in shapes), each also bitwise equal to "
          f"the fp32 route on its fp32 widening")

    # solve: random SPD systems, an ill-scaled family, real systems at
    # rank 64, then other ranks; the kernel repeats the plain version's
    # operations entry by entry, so it must be bitwise equal to it
    def systems(B, R=RANK, ill=False):
        G = torch.randn((B, R, R), device=dev,
                        generator=torch.Generator(dev).manual_seed(B + R))
        A = G @ G.transpose(1, 2)
        if ill:
            A = A * 10.0 ** (torch.rand((B, 1, 1), device=dev) * 4 - 2) \
                + 0.01 * torch.eye(R, device=dev)
        else:
            A = A / R + torch.eye(R, device=dev)
        return A, torch.randn((B, R), device=dev)

    real_bucket = pd.user_side.buckets[len(pd.user_side.buckets) // 2]
    aw, bw = assembly_weights(real_bucket, False, dev)
    gram = Yt.T @ Yt + LAMBDA * torch.eye(RANK, device=dev)
    real = als_cuda.assemble_normal_equations(
        Yt, torch.as_tensor(real_bucket.cols, device=dev), aw, bw, gram)
    folds = [(f"fold B={B} L={L}",
              als_cuda.assemble_normal_equations(Yt, cols, aw, bw, gram))
             for B, L, cols, aw, bw in fold_tables]
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    results = []
    for label, (A, b) in [(f"B={B}", systems(B))
                          for B in (1, 127, 4096, N_USERS)] + [
            ("ill-scaled B=4096", systems(4096, ill=True)),
            (f"training B={real[1].shape[0]}", real)] + folds + [
            (f"R={R} B={64 if R <= 65 else 16}",
             systems(64 if R <= 65 else 16, R)) for R in SOLVE_RANKS]:
        R = b.shape[1]
        x = als_cuda.spd_solve(A, b)
        torch.cuda.synchronize()
        xp = als_cuda.spd_solve_plain(A, b)
        res = float(torch.linalg.vector_norm(
            (A @ x[:, :, None])[:, :, 0] - b) / torch.linalg.vector_norm(b))
        route = als_cuda.spd_solve_plan(R, optin).route
        if not torch.equal(x, xp):
            raise AssertionError(
                f"spd_solve {label} ({route} route): not bitwise equal to "
                f"plain, max |err| {float((x - xp).abs().max())!r}")
        if not res < 1e-2:
            raise AssertionError(f"spd_solve {label}: residual {res!r}")
        results.append((label, route, res))
    print(f"[kernel] spd_solve bitwise equal to spd_solve_plain: "
          + "; ".join(f"{lab} ({route}): bitwise True, relative residual "
                      f"{r:.3g}" for lab, route, r in results))
    worst["large_rank_training"] = train_large_rank(dev, seed)
    return worst


def train_large_rank(dev, seed: int) -> dict:
    """Train at rank 256 on the card through ``train_als_bucketed``: the
    large-rank assembly and the device-memory solve. Both must launch,
    and the factors stay within TRAIN_RTOL of the plain trainer's from
    the same init."""
    import torch

    from predictionio_tpu_torch.ops import als as als_mod
    from predictionio_tpu_torch.ops import als_cuda

    n_u, n_i = LARGE_TRAIN["users"], LARGE_TRAIN["items"]
    R, iters = LARGE_TRAIN["rank"], LARGE_TRAIN["iterations"]
    rng = np.random.default_rng(seed + 5)
    lens = np.clip(rng.lognormal(3.5, 0.8, n_u).astype(np.int64), 1, n_i)
    pop = 1.0 / (np.arange(n_i) + 10.0) ** 0.8
    rows = np.repeat(np.arange(n_u), lens)
    cols = np.concatenate([rng.choice(n_i, n, replace=False, p=pop / pop.sum())
                           for n in lens])
    vals = (rng.integers(1, 11, len(rows)) * 0.5).astype(np.float32)
    user_side, item_side = als_mod.bucket_ratings_pair(rows, cols, vals,
                                                       n_u, n_i)
    params = als_mod.ALSParams(rank=R, num_iterations=iters, lambda_=LAMBDA,
                               alpha=ALPHA, seed=seed)
    als_cuda.assemble_launches.reset()
    als_cuda.spd_launches.reset()
    X, Y = als_mod.train_als_bucketed(user_side, item_side, params, dev)
    launches = {"assemble_normal_equations": als_cuda.assemble_launches.value,
                "spd_solve": als_cuda.spd_launches.value}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched at rank {R}")
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    routes = (als_cuda.assembly_route(R, OTHER_RANKS[-1]),
              als_cuda.spd_solve_plan(R, optin).route)
    X0, Y0 = als_mod.init_factors(user_side.n_rows, item_side.n_rows, R,
                                  seed, dev)
    saved = (als_cuda.assemble_normal_equations, als_cuda.spd_solve)
    als_cuda.assemble_normal_equations = \
        als_cuda.assemble_normal_equations_plain
    als_cuda.spd_solve = als_cuda.spd_solve_plain
    try:
        Xp, Yp = als_mod.als_iterations_bucketed(
            X0, Y0, bucket_tables(user_side, dev), bucket_tables(item_side, dev),
            lam=LAMBDA, alpha=ALPHA, implicit=True, num_iterations=iters)
    finally:
        als_cuda.assemble_normal_equations, als_cuda.spd_solve = saved
    if not (np.isfinite(X).all() and np.isfinite(Y).all()):
        raise AssertionError(f"non-finite factors at rank {R}")
    errs = {name: float(np.linalg.norm(got - want.cpu().numpy())
                        / np.linalg.norm(want.cpu().numpy()))
            for name, got, want in (("user", X, Xp), ("item", Y, Yp))}
    print(f"[train] rank {R}: {n_u} users x {n_i} items, {len(rows)} "
          f"ratings, {iters} iterations through the {routes[0]} assembly and "
          f"the {routes[1]}-memory solve; launches {launches}; kernel vs "
          f"plain trainer relative Frobenius error {errs} (allowed "
          f"{TRAIN_RTOL})")
    if max(errs.values()) > TRAIN_RTOL:
        raise AssertionError(f"rank-{R} factors differ from the plain "
                             f"trainer's: {errs}")
    return {"launches": launches, "errs": errs}


# -- phase 3: serving the trained model ----------------------------------------

def rel_err(got, want) -> float:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def iteration_split(ms: dict) -> dict:
    """B3's and B2's device ms of a profiled iteration, from the profiler's
    ms by kernel name (B3: the assembly kernels and the spans' reduce)."""
    return {"B3": sum(v for k, v in ms.items() if k.startswith("assemble")),
            "B2": sum(v for k, v in ms.items() if k.startswith("spd_solve"))}


def training_options(dev, trained: dict, seed: int) -> dict:
    """Phase 5c: the training options at ML-20M width on phase 5's
    prepared tables (rank 64, ``ITERATIONS`` iterations, phase 5's
    params and seed). (a) bf16 through ``train_als_bucketed``: the
    launches by route (every assembly must take B3's bf16 route), the
    factors against the plain bf16 trainer on the card from the same
    init (``EPS_BF16``) and against phase 5's fp32 factors (``4 *
    ITERATIONS * EPS_BF16``), one profiled iteration of each lane. (b)
    checkpointed training (``checkpoint_every=1``) in fp32 and bf16:
    bitwise equal to the unchunked runs, a preemption after step 1
    (``request_stop`` from the progress callback) raises
    ``TrainingPreempted`` and the resumed run is bitwise equal too, and
    the run log holds one run with steps 1..ITERATIONS; each save's blob
    MB and ms, and the wall with checkpoints over the wall without."""
    import dataclasses
    import os
    import statistics
    import tempfile

    import torch

    from predictionio_tpu_torch.ops import als as als_mod
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.workflow import checkpoint, runlog

    model, pd = trained["model"], trained["pd"]
    us, its = pd.user_side.to_device(dev), pd.item_side.to_device(dev)
    base = als_mod.ALSParams(rank=RANK, num_iterations=ITERATIONS,
                             lambda_=LAMBDA, alpha=ALPHA, seed=seed)
    bf16 = dataclasses.replace(base, precision="bf16")
    out: dict = {}

    # (a) the bf16 lane: the main path of this phase
    als_cuda.assemble_launches.reset()
    als_cuda.spd_launches.reset()
    t0 = time.perf_counter()
    Xb, Yb = als_mod.train_als_bucketed(us, its, bf16, dev)
    train_s = time.perf_counter() - t0
    launches = {"assemble_normal_equations": als_cuda.assemble_launches.value,
                "spd_solve": als_cuda.spd_launches.value}
    routes = {"/".join(k): n
              for k, n in als_cuda.assemble_launches.by_key().items()}
    if not routes.get("tiles/bf16") or set(routes) != {"tiles/bf16"} \
            or not launches["spd_solve"]:
        raise AssertionError(f"the bf16 lane launched {launches}, assembly "
                             f"routes {routes}")
    vs_fp32 = {"user": rel_err(Xb, model.user_factors),
               "item": rel_err(Yb, model.item_factors)}
    u_t, i_t = bucket_tables(us, dev), bucket_tables(its, dev)
    kw = dict(lam=LAMBDA, alpha=ALPHA, implicit=True, slot_budget=None)
    X0, Y0 = als_mod.init_policy_factors(us.n_rows, its.n_rows, RANK, seed,
                                         "bf16", dev)
    saved = (als_cuda.assemble_normal_equations, als_cuda.spd_solve)
    als_cuda.assemble_normal_equations = \
        als_cuda.assemble_normal_equations_plain
    als_cuda.spd_solve = als_cuda.spd_solve_plain
    try:
        Xp, Yp = als_mod.als_iterations_bucketed(
            X0, Y0, u_t, i_t, num_iterations=ITERATIONS, **kw)
    finally:
        als_cuda.assemble_normal_equations, als_cuda.spd_solve = saved
    vs_plain = {"user": rel_err(Xb, Xp.float().cpu().numpy()),
                "item": rel_err(Yb, Yp.float().cpu().numpy())}
    del Xp, Yp
    lanes = {}
    X32, Y32 = als_mod.init_factors(us.n_rows, its.n_rows, RANK, seed, dev)
    for lane, (Xi, Yi) in (("fp32", (X32, Y32)), ("bf16", (X0, Y0))):
        als_mod.als_iterations_bucketed(Xi, Yi, u_t, i_t, num_iterations=1,
                                        **kw)
        wall, busy, _, ms = device_busy(
            lambda: als_mod.als_iterations_bucketed(
                Xi, Yi, u_t, i_t, num_iterations=1, **kw))
        lanes[lane] = {"wall_ms": wall, "device_ms": busy,
                       **iteration_split(ms)}
    out["bf16"] = {"launches": launches, "routes": routes,
                   "train_s": train_s, "vs_fp32": vs_fp32,
                   "vs_plain": vs_plain, "iteration": lanes}
    print(f"[options] bf16 train_als_bucketed at ML-20M width: {train_s!r} s "
          f"(tables on the card); launches {launches}, assembly routes "
          f"{routes}; relative Frobenius error against the plain bf16 "
          f"trainer {vs_plain} (allowed {EPS_BF16!r}), against phase 5's "
          f"fp32 factors {vs_fp32} (allowed {4 * ITERATIONS * EPS_BF16!r})")
    print(f"[options] one profiled iteration: " + "; ".join(
        f"{lane} wall {v['wall_ms']!r} ms, device {v['device_ms']!r} ms "
        f"(B3 {v['B3']!r} ms, B2 {v['B2']!r} ms)"
        for lane, v in lanes.items()))
    if max(vs_plain.values()) > EPS_BF16:
        raise AssertionError(f"bf16 factors differ from the plain bf16 "
                             f"trainer's: {vs_plain}")
    if max(vs_fp32.values()) > 4 * ITERATIONS * EPS_BF16:
        raise AssertionError(f"bf16 factors are {vs_fp32} from fp32")
    del X0, Y0, X32, Y32, u_t, i_t

    # (b) checkpointed training
    saves = []
    save = checkpoint.TrainCheckpointer.save

    def timed_save(self, step, X, Y, extra=None):
        t = time.perf_counter()
        path = save(self, step, X, Y, extra)
        saves.append({"dir": os.path.basename(self.directory),
                      "step": int(step),
                      "mb": os.path.getsize(path) / 1e6,
                      "ms": (time.perf_counter() - t) * 1e3})
        return path

    env_keys = ("PIO_CHECKPOINT_DIR", "PIO_CHECKPOINT_EVERY", "PIO_RESUME")
    env_before = {k: os.environ.get(k) for k in env_keys}
    work = tempfile.mkdtemp(prefix="pio-ckpt-")
    checkpoint.TrainCheckpointer.save = timed_save
    checkpoint.clear_stop()

    def run(params, directory=None, resume=False):
        for k in env_keys:
            os.environ.pop(k, None)
        if directory:
            os.environ.update(PIO_CHECKPOINT_DIR=directory,
                              PIO_CHECKPOINT_EVERY="1")
        if resume:
            os.environ["PIO_RESUME"] = "1"
        t = time.perf_counter()
        X, Y = als_mod.train_als_bucketed(us, its, params, dev)
        return X, Y, time.perf_counter() - t

    def same(got, want, what):
        if not (np.array_equal(got[0], want[0])
                and np.array_equal(got[1], want[1])):
            raise AssertionError(f"{what}: not bitwise equal to the "
                                 "unchunked run")

    try:
        for params in (base, bf16):
            prec = params.precision
            ref = run(params)
            if prec == "fp32":
                same(ref, (model.user_factors, model.item_factors),
                     "phase 5c's unchunked fp32 run against phase 5's model")
            walls = {"off": [], "on": []}
            for r in range(CKPT_REPEATS):
                X, Y, w_off = run(params)
                same((X, Y), ref, f"{prec} unchunked rerun")
                X, Y, w_on = run(params, os.path.join(work, f"{prec}-{r}"))
                same((X, Y), ref, f"{prec} checkpoint_every=1")
                walls["off"].append(w_off)
                walls["on"].append(w_on)
            d = os.path.join(work, f"{prec}-preempt")

            def stop_after_step_1(sample):
                if sample["step"] == 1:
                    checkpoint.request_stop()

            try:
                with checkpoint.progress_scope(stop_after_step_1):
                    run(params, d)
                raise AssertionError(f"{prec}: no TrainingPreempted")
            except checkpoint.TrainingPreempted as e:
                preempted = str(e)
            finally:
                checkpoint.clear_stop()
            X, Y, _ = run(params, d, resume=True)
            same((X, Y), ref, f"{prec} preempted then resumed")
            runs = runlog.list_runs(d)
            samples = runlog.read_run(runs[0]["path"])["samples"] \
                if len(runs) == 1 else []
            steps = [s["step"] for s in samples]
            if steps != list(range(1, ITERATIONS + 1)) or not all(
                    np.isfinite([s["loss"]["fit"], s["loss"]["l2"]]).all()
                    for s in samples):
                raise AssertionError(f"{prec}: run log {runs} holds steps "
                                     f"{steps}")
            off, on = (statistics.median(walls[k]) for k in ("off", "on"))
            out[f"checkpoint_{prec}"] = {
                "wall_off_s": walls["off"], "wall_on_s": walls["on"],
                "overhead": on / off, "preempted": preempted,
                "run": runs[0]["runId"],
                "loss": [(s["step"], s["loss"]["fit"], s["loss"]["l2"])
                         for s in samples],
                "saves": [v for v in saves if v["dir"].startswith(prec)]}
            print(f"[options] {prec} checkpoint_every=1: bitwise equal to "
                  f"the unchunked run ({CKPT_REPEATS} runs); preempted after "
                  f"step 1 ({preempted!r}), resumed bitwise equal; run log "
                  f"{runs[0]['runId']} steps {steps}, (step, fit, l2) "
                  f"{out[f'checkpoint_{prec}']['loss']}")
            print(f"[options] {prec} wall with checkpoints {walls['on']} s, "
                  f"without {walls['off']} s: median ratio {on / off!r} "
                  f"(the JAX package's gate {CKPT_OVERHEAD_GATE}, printed "
                  f"only); saves (step, blob MB, ms): " + ", ".join(
                      f"({v['step']}, {v['mb']:.1f}, {v['ms']:.1f})"
                      for v in out[f"checkpoint_{prec}"]["saves"]))
    finally:
        checkpoint.TrainCheckpointer.save = save
        checkpoint.clear_stop()
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(work, ignore_errors=True)
    return out


# -- phase 5d: the tuning grid at ML-20M width -------------------------------------

# the grid: rank x lambda x alpha, and one config whose alpha overflows
# the fp32 confidence weights to inf in one half-step (the JAX suite's
# DEAD_ALPHA), masked out while the others train
GRID_RANKS, GRID_LAMBDAS, GRID_ALPHAS = (32, 64), (0.01, 0.1), (1.0, 40.0)
GRID_DEAD_ALPHA = 1e38
GRID_ITERATIONS = 10
GRID_TOPK = 10
GRID_USERS = 4_096      # held-out users ranked for the leaderboard
GRID_SUB_BATCHES = 3    # PIO_TUNING_HBM_BUDGET forces this many
# a rank-32 config against its serial run: the JAX suite's grid gate (its
# Gram is a [64, 64] product with zero pad columns, which cuBLAS may sum
# in another order than the serial [32, 32] one)
GRID_RTOL, GRID_ATOL = 1e-4, 1e-5


def grid_assembly_inputs(res, side, side_name: str, bucket, dev):
    """One bucket's config-axis assembly inputs from the grid's factors:
    ``Y [k, M, R]`` (the fixed side), ``cols``, per-config implicit
    weights ``aw``/``bw [k, B, L]`` and ``gram [k, R, R]`` (each config's
    Gram, ``lam I`` and ridge folded in), as the grid half-step builds
    them."""
    import torch

    from predictionio_tpu_torch.ops import als as als_mod

    grid = res.grid
    fixed = res.item_factors if side_name == "user" else res.user_factors
    Y = torch.from_numpy(fixed).to(dev)
    lam = torch.tensor([c.lambda_ for c in grid.configs],
                       dtype=torch.float32, device=dev)
    alpha = torch.tensor([c.alpha for c in grid.configs],
                         dtype=torch.float32, device=dev)
    ridge = torch.as_tensor((np.arange(grid.max_rank)[None, :] >= np.asarray(
        grid.ranks)[:, None]).astype(np.float32), device=dev)
    grams = als_mod._grid_grams(Y, lam, True, ridge)
    cols = torch.as_tensor(bucket.cols, device=dev)
    m = torch.as_tensor(bucket.mask, device=dev)
    w = torch.as_tensor(bucket.weights, device=dev) * m
    aw = (alpha[:, None, None] * w.abs()[None]).contiguous()
    bw = ((w > 0).float()[None] * (1.0 + aw)).contiguous()
    return Y, cols, aw, bw, grams


def grid_assembly_timings(dev, res, sides) -> dict:
    """B3's config-axis route over one grid iteration's work (every
    bucket of both sides, all k configs): its time, k single launches of
    the serial route on the same inputs, the plain version (a loop of the
    plain assembly), and the library call, ``torch.bmm`` of the weighted
    gathered rows batched over configs (in row chunks of at most 2^24
    config-slots, so the gather fits beside the grid). The bound: the
    configs' bytes (each config's Y, weights, gram, A and b; the shared
    cols once) and operations (each config's real slots at R_max). And B2
    over each bucket's ``k * B`` systems: its time, plain, the library
    call (``cholesky_ex`` + ``cholesky_solve``) and its bound
    (``solve_head``)."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    rows = []
    for side_name, side in (("user", sides[0]), ("item", sides[1])):
        for bucket in side.buckets:
            Y, cols, aw, bw, grams = grid_assembly_inputs(
                res, side, side_name, bucket, dev)
            k, M, R = Y.shape
            B, L = cols.shape
            Ys = [Y[z].contiguous() for z in range(k)]
            aws = [aw[z].contiguous() for z in range(k)]
            bws = [bw[z].contiguous() for z in range(k)]
            t_g = time_ms(lambda: als_cuda.assemble_normal_equations_grid(
                Y, cols, aw, bw, grams), 3)
            t_s = time_ms(lambda: [als_cuda.assemble_normal_equations(
                Ys[z], cols, aws[z], bws[z], grams[z]) for z in range(k)], 3)
            t_p = time_ms(lambda: als_cuda.assemble_normal_equations_grid_plain(
                Y, cols, aw, bw, grams), 1)
            step = max(1, (1 << 24) // max(1, k * L))

            def library():
                for s0 in range(0, B, step):
                    Yg = Y[:, cols[s0:s0 + step].long()]     # [k, b, L, R]
                    awYg = (aw[:, s0:s0 + step, :, None] * Yg)
                    torch.bmm(awYg.reshape(-1, L, R).transpose(1, 2),
                              Yg.reshape(-1, L, R))

            t_l = time_ms(library, 2)
            # B2 over the grid's k * B systems of this bucket
            A, b = als_cuda.assemble_normal_equations_grid(Y, cols, aw, bw,
                                                           grams)
            A, b = A.reshape(k * B, R, R), b.reshape(k * B, R)
            solve = {
                "ms": time_ms(lambda: als_cuda.spd_solve(A, b), 3),
                "plain_ms": time_ms(lambda: als_cuda.spd_solve_plain(A, b),
                                    1),
                "library_ms": time_ms(lambda: torch.cholesky_solve(
                    b[:, :, None], torch.linalg.cholesky_ex(A)[0]), 3),
                "work": solve_work(k * B, R)}
            del A, b
            nnz = int(((aw[0] != 0) | (bw[0] != 0)).sum())
            nbytes = k * M * R * 4 + B * L * 4 + k * B * L * 8 \
                + k * R * R * 4 + k * B * (R * R + R) * 4
            ops = k * 2.0 * nnz * (R * (R + 1) / 2 + R)
            rows.append({"side": side_name, "B": B, "L": L, "slots": nnz,
                         "work": (nbytes, ops), "ms": t_g,
                         "single_launches_ms": t_s, "plain_ms": t_p,
                         "library_ms": t_l, "solve": solve})
            del Y, cols, aw, bw, grams, Ys, aws, bws
    nbytes = sum(r["work"][0] for r in rows)
    ops = sum(r["work"][1] for r in rows)
    b_ms, b_by = bound_of(nbytes, ops)
    head = {key: sum(r[key] for r in rows)
            for key in ("ms", "single_launches_ms", "plain_ms",
                        "library_ms")}
    head.update(bound_ms=b_ms, bound_by=b_by,
                launches_per_iteration=len(rows))
    s_ms, s_by = bound_of(sum(r["solve"]["work"][0] for r in rows),
                          sum(r["solve"]["work"][1] for r in rows))
    solve_head = {key: sum(r["solve"][key] for r in rows)
                  for key in ("ms", "plain_ms", "library_ms")}
    solve_head.update(bound_ms=s_ms, bound_by=s_by,
                      launches_per_iteration=len(rows))
    return {"rows": rows, "head": head, "solve_head": solve_head}


def grid_assembly_checks(dev, res, sides) -> dict:
    """(c): at the largest bucket's shape (the most slots), B3's grid
    route on all k configs bitwise equal to k single launches, fp32 and
    on a bf16 store (which must also equal the fp32 grid route on the
    widened store); each live config's fp32 sums within the reordering
    bound of the plain version; and, on an integer fixture at that
    shape, bitwise equal to plain."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    name, side, bucket = max(
        ((n, s, b) for n, s in (("user", sides[0]), ("item", sides[1]))
         for b in s.buckets), key=lambda t: t[2].cols.numel())
    Y, cols, aw, bw, grams = grid_assembly_inputs(res, side, name, bucket,
                                                  dev)
    k = Y.shape[0]
    B, L = cols.shape

    def same(*pairs):
        # bitwise, NaN equal to NaN (the dead config's inf weights meet
        # its zero factors)
        return all(torch.equal(x.isnan(), y.isnan()) and torch.equal(
            x.nan_to_num(nan=0.0), y.nan_to_num(nan=0.0)) for x, y in pairs)

    worst = 0.0
    for label, Yk in (("fp32", Y), ("bf16", Y.to(torch.bfloat16))):
        A, b = als_cuda.assemble_normal_equations_grid(Yk, cols, aw, bw,
                                                       grams)
        for z in range(k):
            As, bs = als_cuda.assemble_normal_equations(
                Yk[z].contiguous(), cols, aw[z].contiguous(),
                bw[z].contiguous(), grams[z].contiguous())
            if not same((A[z], As), (b[z], bs)):
                raise AssertionError(f"grid assembly {label} config {z}: "
                                     "not bitwise its single launch")
            # the bf16 route is bitwise the fp32 one on the widened
            # store (below), so the plain version's bound is held once
            if res.alive[z] and label == "fp32":
                worst = max(worst, check_assembly(
                    Yk[z].contiguous(), cols, aw[z].contiguous(),
                    bw[z].contiguous(), grams[z].contiguous(), False,
                    f"grid {label} config {z}"))
        if label == "bf16":
            A32, b32 = als_cuda.assemble_normal_equations_grid(
                Yk.float(), cols, aw, bw, grams)
            if not same((A, A32), (b, b32)):
                raise AssertionError("grid assembly: the bf16 route differs "
                                     "from the fp32 route on the widened "
                                     "store")
        del A, b
    rng = np.random.default_rng(5)
    Yi = torch.as_tensor(rng.integers(-3, 4, tuple(Y.shape)).astype(
        np.float32), device=dev)
    awi = torch.as_tensor((rng.integers(0, 5, (k, B, L)) * 0.5).astype(
        np.float32), device=dev) * (aw != 0)
    bwi = torch.as_tensor((rng.integers(0, 5, (k, B, L)) * 0.5).astype(
        np.float32), device=dev) * (bw != 0)
    gi = torch.as_tensor(rng.integers(-4, 5, (k,) + tuple(grams.shape[1:]))
                         .astype(np.float32), device=dev)
    A, b = als_cuda.assemble_normal_equations_grid(Yi, cols, awi, bwi, gi)
    n = max(1, (1 << 22) // max(L, 1))
    for s0 in range(0, B, n):
        Ap, bp = als_cuda.assemble_normal_equations_grid_plain(
            Yi, cols[s0:s0 + n], awi[:, s0:s0 + n], bwi[:, s0:s0 + n], gi)
        if not (torch.equal(A[:, s0:s0 + n], Ap)
                and torch.equal(b[:, s0:s0 + n], bp)):
            raise AssertionError("grid assembly on the integer fixture "
                                 "differs from plain")
    return {"side": name, "B": B, "L": L, "k": k, "max_abs_err": worst}


def grid_topk_timings(dev, res, users, tr, tc) -> dict:
    """B1 at ``grid_topk``'s shape: one 512-user chunk (the one with the
    longest training history, so the widest seen list) of config 0,
    against its plain version, the library call (``torch.topk`` of the
    masked product) and its bound (the item table read once, the queries
    and seen lists read once, the winners written; 2*B*M*R
    operations)."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    order = np.argsort(tr, kind="stable")
    counts = np.bincount(tr, minlength=res.user_factors.shape[1])
    chunks = [users[s:s + 512] for s in range(0, len(users), 512)]
    u = max(chunks, key=lambda c: int(counts[c].max()))
    B, L = len(u), int(counts[u].max())
    scols = np.asarray(tc)[order]
    starts = np.searchsorted(np.asarray(tr)[order], u)
    sc = np.zeros((L, B), np.int32)
    sm = np.zeros((L, B), np.float32)
    for j in range(B):
        n = int(counts[u[j]])
        sc[:n, j] = scols[starts[j]:starts[j] + n]
        sm[:n, j] = 1.0
    sc, sm = torch.from_numpy(sc).to(dev), torch.from_numpy(sm).to(dev)
    Q = torch.from_numpy(np.ascontiguousarray(res.user_factors[0][u])).to(dev)
    Y = torch.from_numpy(np.ascontiguousarray(res.item_factors[0])).to(dev)
    M, R = Y.shape
    kw = dict(k=GRID_TOPK, n_items=M, mask_seen=True)
    t_k = time_ms(lambda: als_cuda.fused_gather_score_topk(Q, Y, sc, sm,
                                                           **kw), 10)
    t_p = time_ms(lambda: als_cuda.fused_gather_score_topk_plain(
        Q, Y, sc, sm, **kw), 3)
    t_l = time_ms(lambda: torch.topk(als_cuda.masked_scores_plain(
        Q, Y, sc, sm, n_items=M), GRID_TOPK), 5)
    nbytes = M * R * 4 + B * R * 4 + L * B * 8 + B * GRID_TOPK * 8
    b_ms, b_by = bound_of(nbytes, 2.0 * B * M * R)
    return {"B": B, "k": GRID_TOPK, "L": L, "ms": t_k, "plain_ms": t_p,
            "library_ms": t_l, "bound_ms": b_ms, "bound_by": b_by}


def tuning_grid(dev, trained: dict, ratings: tuple, seed: int,
                card: str) -> dict:
    """Phase 5d: the tuning grid at ML-20M width on phase 5's ratings (in
    memory, no second read): leave-last-out in stream order as ``pio
    eval --grid`` splits them, the train part bucketed and staged once,
    then the grid of ``GRID_RANKS x GRID_LAMBDAS x GRID_ALPHAS`` plus a
    config with ``alpha = GRID_DEAD_ALPHA``, ``GRID_ITERATIONS``
    iterations, implicit, fp32, through ``train_als_grid_bucketed`` (B3's
    config-axis route, one launch per bucket for every config; B2 over
    ``k * B`` systems) and the leaderboard of ``GRID_USERS`` held-out
    users through ``grid_topk`` (B1). Checks (a)-(e) of the module
    docstring; times the grid, the serial trainings, B3's grid route and
    B1 at ``grid_topk``'s shape."""
    import os

    import torch

    from predictionio_tpu_torch.ops import als as als_mod
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops import tuning as ops_tuning
    from predictionio_tpu_torch.tools.run_commands import leave_last_out_split
    from predictionio_tpu_torch.workflow import tuning as wf_tuning

    rows, cols, values, order = ratings
    t = time.perf_counter()
    tr, tc, tv, held = leave_last_out_split(rows[order], cols[order],
                                            values[order])
    us, its = als_mod.bucket_ratings_pair(tr, tc, tv, N_USERS, M_ITEMS)
    split_s = time.perf_counter() - t
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_alloc = torch.cuda.memory_allocated(dev)
    us, its = us.to_device(dev), its.to_device(dev)
    table_bytes = sum(a.nbytes for s in (us, its) for b in s.buckets
                      for a in (b.row_ids, b.cols, b.weights, b.mask))
    base = als_mod.ALSParams(rank=max(GRID_RANKS),
                             num_iterations=GRID_ITERATIONS, seed=seed)
    overrides = [{"rank": r, "lambda": lam, "alpha": a}
                 for r in GRID_RANKS for lam in GRID_LAMBDAS
                 for a in GRID_ALPHAS]
    overrides.append({"rank": max(GRID_RANKS), "alpha": GRID_DEAD_ALPHA})
    grid = ops_tuning.make_grid(base, overrides)
    rng = np.random.default_rng(seed + 5)
    test_users = np.sort(rng.choice(np.asarray(sorted(held)), GRID_USERS,
                                    replace=False))
    held_s = {int(u): held[int(u)] for u in test_users}
    print(f"[grid] {len(tr)} train / {len(held)} held-out ratings "
          f"(leave-last-out in stream order), split and bucketed in "
          f"{split_s!r} s; tables {table_bytes / 1e9!r} GB on the card; "
          f"{grid.k} configs x {GRID_ITERATIONS} iterations")

    # the main path: the grid's training and its leaderboard, counted
    for counter in (als_cuda.assemble_launches, als_cuda.spd_launches,
                    als_cuda.launches):
        counter.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = ops_tuning.train_als_grid_bucketed(us, its, grid)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated(dev) - base_alloc
    t = time.perf_counter()
    board = ops_tuning.grid_leaderboard(res, tr, tc, held_s,
                                        topk=GRID_TOPK)
    board_s = time.perf_counter() - t
    launches = {"assemble": als_cuda.assemble_launches.by_key(),
                "spd_solve": als_cuda.spd_launches.value,
                "topk": als_cuda.launches.by_key()}
    n_buckets = len(us.buckets) + len(its.buckets)
    tiles_grid = launches["assemble"].get(("tiles_grid", "fp32"), 0)
    if tiles_grid != GRID_ITERATIONS * n_buckets \
            or set(launches["assemble"]) != {("tiles_grid", "fp32")}:
        raise AssertionError(f"the grid's assembly launches "
                             f"{launches['assemble']}, want "
                             f"{GRID_ITERATIONS * n_buckets} on tiles_grid")
    if launches["spd_solve"] != GRID_ITERATIONS * n_buckets:
        raise AssertionError(f"the grid's solves {launches['spd_solve']}")
    b1 = sum(launches["topk"].values())
    if b1 != grid.k * -(-GRID_USERS // 512):
        raise AssertionError(f"grid_topk launched B1 {launches['topk']}")
    per_config = wf_tuning.grid_bytes_per_config(N_USERS, M_ITEMS, grid, us,
                                                 its)
    # (a) the alive mask, the dead lane, finiteness
    want_alive = [True] * (grid.k - 1) + [False]
    if res.alive.tolist() != want_alive:
        raise AssertionError(f"alive {res.alive.tolist()}")
    if res.user_factors[-1].any() or res.item_factors[-1].any():
        raise AssertionError("the dead lane is not all zeros")
    if not (np.isfinite(res.user_factors).all()
            and np.isfinite(res.item_factors).all()):
        raise AssertionError("non-finite grid factors")
    print(f"[grid] trained in {grid_s!r} s ({1e3 * grid_s / GRID_ITERATIONS!r}"
          f" ms an iteration, the init and host copies included); alive "
          f"{res.alive.tolist()}; launches B3 {launches['assemble']} "
          f"({n_buckets} buckets an iteration), B2 {launches['spd_solve']}, "
          f"B1 {launches['topk']}; leaderboard of {len(held_s)} users in "
          f"{board_s!r} s on the host; peak memory {peak / 1e9!r} GB against "
          f"{per_config * grid.k / 1e9!r} GB (grid_bytes_per_config x k) + "
          f"{table_bytes / 1e9!r} GB of tables ({card})")

    # (b) each config against its serial run from the same init
    dists, serial_s = [], 0.0
    for i, cfg in enumerate(grid.configs[:-1]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        Xs, Ys = als_mod.train_als_bucketed(us, its, cfg)
        serial_s += time.perf_counter() - t
        Xg, Yg = res.factors_for(i)
        d = max(float(np.abs(Xg - Xs).max()), float(np.abs(Yg - Ys).max()))
        dists.append(d)
        if res.user_factors[i][:, cfg.rank:].any() \
                or res.item_factors[i][:, cfg.rank:].any():
            raise AssertionError(f"config {i}: pad columns not zero")
        if cfg.rank == max(GRID_RANKS):
            if not (np.array_equal(Xg, Xs) and np.array_equal(Yg, Ys)):
                raise AssertionError(f"config {i} (rank {cfg.rank}) is not "
                                     f"bitwise its serial run: {d}")
        else:
            for got, want in ((Xg, Xs), (Yg, Ys)):
                np.testing.assert_allclose(got, want, rtol=GRID_RTOL,
                                           atol=GRID_ATOL)
    print(f"[grid] each config against its serial train_als_bucketed run "
          f"from the same init, largest |difference|: {dists} (rank "
          f"{max(GRID_RANKS)} bitwise, rank {min(GRID_RANKS)} within "
          f"{GRID_RTOL}/{GRID_ATOL}); the {grid.k - 1} serial trainings "
          f"{serial_s!r} s, the grid {grid_s!r} s ({card})")

    # (c) B3's grid route against plain and single launches
    checked = grid_assembly_checks(dev, res, (us, its))
    print(f"[grid] B3 config-axis route at the largest bucket ({checked}): "
          f"bitwise k single launches (fp32 and a bf16 store), within the "
          f"reordering bound of plain, bitwise plain on an integer fixture")

    # (d) grid_topk through B1 against plain; the metrics against plain
    users = np.asarray(sorted(held_s))
    idx, vals = ops_tuning.grid_topk(res, users, tr, tc, GRID_TOPK,
                                     with_scores=True)
    pidx, pvals = ops_tuning.grid_topk_plain(res, users, tr, tc, GRID_TOPK,
                                             with_scores=True)
    fin = np.isfinite(pvals)
    if not (np.array_equal(np.isfinite(vals), fin)
            and np.array_equal(idx[fin], pidx[fin])):
        raise AssertionError("grid_topk through B1 differs from plain")
    plain_board = ops_tuning.grid_leaderboard(
        res, tr, tc, held_s, topk=GRID_TOPK,
        topk_fn=ops_tuning.grid_topk_plain)
    for got, want in zip(board["rows"], plain_board["rows"]):
        if (got["config"], got["precisionAtK"], got["ndcgAtK"]) != (
                want["config"], want["precisionAtK"], want["ndcgAtK"]):
            raise AssertionError(f"leaderboard row {got} differs from the "
                                 f"plain pipeline's {want}")
    print(f"[grid] grid_topk: B1 equals plain on {len(users)} users x "
          f"{grid.k} configs where the scores are finite; leaderboard "
          f"(precision@{GRID_TOPK}, ndcg) equal to plain's: "
          + ", ".join(f"{r['config']}:{r['params']} {r['precisionAtK']!r}/"
                      f"{r['ndcgAtK']!r}" for r in board["rows"]))

    # (e) sub-batches forced through the memory budget
    budget = per_config * (-(-grid.k // GRID_SUB_BATCHES))
    prior = os.environ.get("PIO_TUNING_HBM_BUDGET")
    os.environ["PIO_TUNING_HBM_BUDGET"] = str(budget)
    try:
        batches = wf_tuning.plan_grid_batches(grid, N_USERS, M_ITEMS, us,
                                              its)
        if len(batches) != GRID_SUB_BATCHES:
            raise AssertionError(f"the budget gave batches {batches}")
        for batch in batches:
            sub = ops_tuning.train_als_grid_bucketed(us, its,
                                                     grid.subset(batch))
            for j, i in enumerate(batch):
                if not (np.array_equal(sub.user_factors[j],
                                       res.user_factors[i])
                        and np.array_equal(sub.item_factors[j],
                                           res.item_factors[i])
                        and sub.alive[j] == res.alive[i]):
                    raise AssertionError(f"sub-batch {batch}: config {i} "
                                         "differs from the full grid")
        split = wf_tuning.run_grid(us, its, grid, train_rows=tr,
                                   train_cols=tc, held=held_s,
                                   topk=GRID_TOPK, warmup=False)
    finally:
        if prior is None:
            os.environ.pop("PIO_TUNING_HBM_BUDGET", None)
        else:
            os.environ["PIO_TUNING_HBM_BUDGET"] = prior
    if split["batches"] != [len(b) for b in batches] \
            or split["rows"] != board["rows"] \
            or split["winner"]["config"] != board["winner"]["config"]:
        raise AssertionError(f"the sub-batched leaderboard differs: "
                             f"{split['batches']}")
    print(f"[grid] {GRID_SUB_BATCHES} sub-batches {split['batches']} under "
          f"PIO_TUNING_HBM_BUDGET={budget}: factors bitwise the full grid's, "
          f"leaderboard equal; winner config {board['winner']['config']} "
          f"{board['winner']['params']}")

    asm = grid_assembly_timings(dev, res, (us, its))
    h = asm["head"]
    print(f"[time] B3 config-axis route over one grid iteration (k="
          f"{grid.k}, R_max={grid.max_rank}, {h['launches_per_iteration']} "
          f"launches): {h['ms']!r} ms; k single launches "
          f"{h['single_launches_ms']!r} ms; plain {h['plain_ms']!r} ms; "
          f"library (bmm over configs) {h['library_ms']!r} ms; bound "
          f"{h['bound_ms']!r} ms ({h['bound_by']}) ({card})")
    sh = asm["solve_head"]
    print(f"[time] B2 over the grid's k * B systems (one grid iteration, "
          f"{sh['launches_per_iteration']} launches): {sh['ms']!r} ms; plain "
          f"{sh['plain_ms']!r} ms; library {sh['library_ms']!r} ms; bound "
          f"{sh['bound_ms']!r} ms ({sh['bound_by']}) ({card})")
    topk_t = grid_topk_timings(dev, res, users, tr, tc)
    print(f"[time] B1 at grid_topk's shape {topk_t} ({card})")
    # one grid iteration under the profiler: where its time goes beside B3
    (_, _, lam, alpha, ridge, u_t, i_t), kw = als_mod._grid_call_args(
        us, its, grid.configs, "fp32", dev, num_iterations=1)
    X0, Y0 = ops_tuning.init_grid_factors(N_USERS, M_ITEMS, grid, "fp32",
                                          dev)

    def one_iteration():
        als_mod._als_iterations_grid(X0, Y0, lam, alpha, ridge, u_t, i_t,
                                     **kw)

    one_iteration()
    wall, busy, _, kernel_ms = device_busy(one_iteration)
    profiled = {"wall_ms": wall, "busy_ms": busy,
                "kernel_ms": dict(kernel_ms.most_common(8))}
    print(f"[grid] one grid iteration profiled: wall {wall!r} ms, device "
          f"busy {busy!r} ms ({100 * busy / wall:.2f}%); device ms by kernel "
          f"{profiled['kernel_ms']} ({card})")
    del us, its, res, X0, Y0, u_t, i_t
    torch.cuda.empty_cache()
    return {"launches": {"tiles_grid": tiles_grid,
                         "spd_solve": launches["spd_solve"], "topk": b1},
            "grid_s": grid_s, "iteration_ms": 1e3 * grid_s / GRID_ITERATIONS,
            "serial_s": serial_s, "board_s": board_s, "peak_bytes": peak,
            "per_config_bytes": per_config, "table_bytes": table_bytes,
            "distances": dists, "assembly": asm, "topk": topk_t,
            "checked": checked, "winner": board["winner"],
            "profiled": profiled}


def post(url: str, payload) -> tuple:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as resp:
        body = json.loads(resp.read())
        return resp.status, body, time.perf_counter() - t0


def burst(base: str, queries: list, clients: int = 8) -> list:
    """Send ``queries`` from ``clients`` threads started together (closed
    loop); returns [(query, status, body, seconds)]."""
    barrier = threading.Barrier(clients)
    lock = threading.Lock()
    out, errors = [], []

    def client(chunk):
        try:
            barrier.wait(timeout=60)
            for q in chunk:
                res = (q, *post(base + "/queries.json", q))
                with lock:
                    out.append(res)
        except Exception as e:  # reported below; the phase then fails
            errors.append(e)

    threads = [threading.Thread(target=client, args=(queries[i::clients],))
               for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent clients failed: {errors}")
    return out


def get_json(url: str):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return json.loads(resp.read())


def fetch_trace(base: str, trace_id: str) -> dict:
    """``GET /traces/<id>``. The server retires a trace when its handler
    returns, just after the response went out, so a 404 is retried for
    up to a second."""
    for _ in range(500):
        try:
            return get_json(f"{base}/traces/{trace_id}")
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise
        time.sleep(0.002)
    raise AssertionError(f"trace {trace_id} was never retained")


def scrape(base: str) -> dict:
    """``GET /metrics`` parsed with the port's own ``parse_prometheus``."""
    from predictionio_tpu_torch.utils.metrics import parse_prometheus

    with urllib.request.urlopen(base + "/metrics", timeout=60) as resp:
        return parse_prometheus(resp.read().decode())


def scraped(families: dict, name: str, part: str = "value",
            **labels) -> float:
    """One series of a parsed scrape: a counter's value, or a histogram's
    ``count``; 0 when the series is absent. Labels not given match any."""
    total = 0.0
    for series in families.get(name, {}).get("series", ()):
        if all(series["labels"].get(k) == v for k, v in labels.items()):
            total += series[part]
    return total


def b1_kernel_names() -> set:
    """The ``__global__`` functions of the serving kernel's source."""
    import re

    from predictionio_tpu_torch.ops import _build

    src = (_build.SRC_DIR / "fused_topk.cu").read_text()
    return set(re.findall(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s*)*"
                          r"(\w+)\s*\(", src))


def kernel_name(event_name: str) -> str:
    name = event_name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].replace("void ", "").split("<")[0]


def device_busy(fn) -> tuple:
    """(wall ms, device-busy ms, launches by kernel name, device ms by
    kernel name) of ``fn()`` captured by the port's
    ``tracing.profile_trace`` (``torch.profiler``, CPU and CUDA); busy
    time is the union of the CUDA kernel intervals the profiler
    recorded."""
    import collections
    import tempfile

    import torch

    from predictionio_tpu_torch.utils.tracing import profile_trace

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as capture_dir:
        with profile_trace(capture_dir) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    names = collections.Counter(kernel_name(e.name) for e in events)
    ms = collections.Counter()
    for e in events:
        ms[kernel_name(e.name)] += (e.time_range.end - e.time_range.start) / 1e3
    return wall, busy / 1e3, names, ms


def query_kind(q: dict) -> str:
    if "items" in q:
        return "item-similarity"
    if q["user"] == "no-such-user":
        return "unknown user"
    if "categories" in q:
        return "category"
    return "blacklist" if "blacklist" in q else "user"


# the parts of a request's latency, in the order printed; they sum to
# the client's latency
SPLIT_PARTS = ("client", "server", "http+json", "query.extract",
               "serve.supplement", "serve.predict", "predict.host",
               "device.*", "queue_wait", "device_us", "launch+copy",
               "device.other", "serve.serve", "handler.rest")


def span_tree(record: dict) -> tuple:
    """(server span, children by parent id) of one query's trace."""
    spans = record["spans"]
    by_id = {sp["spanId"]: sp for sp in spans}
    children: dict = {}
    for sp in spans:
        children.setdefault(sp["parentId"], []).append(sp)
    roots = [sp for sp in spans if sp["parentId"] not in by_id]
    if len(roots) != 1 or not roots[0]["name"].startswith("query POST"):
        raise AssertionError(f"no single server span: {roots}")
    return roots[0], children


def span_seconds(sp) -> float:
    return sp["end"] - sp["start"]


class CollectorPauses:
    """The cyclic garbage collector's passes in this process, on the span
    clock (``gc.callbacks``): (start, end, generation). A pass holds the
    interpreter lock, so every server thread stalls for it."""

    def __init__(self):
        from predictionio_tpu_torch.utils.tracing import span_now

        self._now = span_now
        self.passes: list = []
        self._started: dict = {}

    def __enter__(self) -> "CollectorPauses":
        import gc

        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc) -> None:
        import gc

        gc.callbacks.remove(self._callback)

    def _callback(self, phase: str, info: dict) -> None:
        now, thread = self._now(), threading.get_ident()
        if phase == "start":
            self._started[thread] = now
        elif thread in self._started:
            self.passes.append((self._started.pop(thread), now,
                                info["generation"]))

    def summary(self) -> str:
        ms = [(b - a) * 1e3 for a, b, _ in self.passes]
        return (f"{len(ms)} collector passes "
                f"({sum(g == 2 for _, _, g in self.passes)} of generation 2), "
                f"{sum(ms):.3f} ms in all, longest {max(ms, default=0.0):.3f}")


def check_spans(record: dict, client_s: float) -> None:
    """Every span's children sum to no more than the span, and the
    server span is no longer than the client's latency. A span's times
    are epoch seconds in doubles (about 0.25 us apart), so each sum may
    exceed its parent by that rounding: 1 us per child is allowed."""
    root, children = span_tree(record)
    for sp in record["spans"]:
        kids = children.get(sp["spanId"], [])
        if sum(map(span_seconds, kids)) > span_seconds(sp) + 1e-6 * len(kids):
            raise AssertionError(
                f"span {sp['name']} ({span_seconds(sp)!r} s) is shorter than "
                f"its children {[(k['name'], span_seconds(k)) for k in kids]}")
    if span_seconds(root) > client_s:
        raise AssertionError(
            f"server span {span_seconds(root)!r} s is longer than the "
            f"client's latency {client_s!r} s")


def span_split(record: dict, client_s: float, telemetry: bool = True) -> dict:
    """One query's trace as the parts of its latency (ms). With device
    telemetry off there is no ``device.execute``, and its parts read 0."""
    root, children = span_tree(record)
    dur = span_seconds

    def child(parent, prefix):
        found = [sp for sp in children.get(parent["spanId"], [])
                 if sp["name"].startswith(prefix)]
        return found[0] if found else None

    ms = {"client": client_s * 1e3, "server": dur(root) * 1e3}
    ms["http+json"] = ms["client"] - ms["server"]
    for name in ("query.extract", "serve.supplement", "serve.predict",
                 "serve.serve"):
        sp = child(root, name)
        ms[name] = dur(sp) * 1e3 if sp is not None else 0.0
    ms["handler.rest"] = ms["server"] - sum(
        ms[n] for n in ("query.extract", "serve.supplement",
                        "serve.predict", "serve.serve"))
    predict = child(root, "serve.predict")
    device = child(predict, "device.") if predict is not None else None
    ms["device.*"] = dur(device) * 1e3 if device is not None else 0.0
    ms["predict.host"] = ms["serve.predict"] - ms["device.*"]
    execute = child(device, "device.execute") if device is not None else None
    for name in ("queue_wait", "device_us", "launch+copy", "device.other"):
        ms[name] = 0.0
    if execute is not None:
        attrs = execute["attributes"]
        if attrs.get("deviceUs") is None:
            raise AssertionError(f"device.execute has no device time: "
                                 f"{attrs}")
        ms["queue_wait"] = (attrs.get("queueWaitUs") or 0.0) / 1e3
        ms["device_us"] = attrs["deviceUs"] / 1e3
        ms["launch+copy"] = (attrs["hostUs"] - attrs["deviceUs"]) / 1e3
        ms["device.other"] = (ms["device.*"] - ms["queue_wait"]
                              - attrs["hostUs"] / 1e3)
    elif device is not None and telemetry:
        raise AssertionError(f"{device['name']} has no device.execute child")
    return ms


def print_split(splits: dict) -> None:
    """The median of each part per query kind."""
    print("[serve] span split, median ms per query kind (client = "
          "http+json + server; server = query.extract + serve.supplement "
          "+ serve.predict + serve.serve + handler.rest; serve.predict = "
          "predict.host + device.*; device.* = queue_wait + device_us + "
          "launch+copy + device.other):")
    for kind, rows in splits.items():
        med = {part: float(np.median([r[part] for r in rows]))
               for part in SPLIT_PARTS}
        print(f"[serve]   {kind} ({len(rows)}): "
              + ", ".join(f"{part} {med[part]:.4f}" for part in SPLIT_PARTS))


# the client of the sequential runs, in a process of its own so that it
# never holds the server's interpreter lock: one JSON line in per query
# ({"query", "headers"}), one out ({"status", "body", "seconds"}); an
# optional pause (seconds) before each query and after the last
CLIENT = r"""
import json, sys, time, urllib.request
base, pause = sys.argv[1], float(sys.argv[2])
opener = urllib.request.build_opener()   # built before the first timing
for line in sys.stdin:
    time.sleep(pause)
    job = json.loads(line)
    req = urllib.request.Request(base + "/queries.json", method="POST",
                                 data=json.dumps(job["query"]).encode(),
                                 headers=job["headers"])
    t0 = time.perf_counter()
    with opener.open(req, timeout=120) as resp:
        body = json.loads(resp.read())
        seconds = time.perf_counter() - t0
        print(json.dumps({"status": resp.status, "body": body,
                          "seconds": seconds}), flush=True)
time.sleep(pause)   # the server finishes the last query before we exit
"""


def client_run(base: str, queries: list, headers=None,
               pause: float = 0.0) -> list:
    """Send ``queries`` one after another from a client process;
    [(query, status, body, seconds)]. ``headers[i]`` go with query i.
    Back to back (``pause`` 0), a query meets the server still finishing
    the one before (its trace flush and metrics, after the response went
    out) on the interpreter lock, as a closed-loop client does; a pause
    lets each query run alone."""
    jobs = "".join(json.dumps({"query": q, "headers": (headers or {})
                               .get(i, {})}) + "\n"
                   for i, q in enumerate(queries))
    proc = subprocess.run([sys.executable, "-c", CLIENT, base, str(pause)],
                          input=jobs, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"client process failed: {proc.stderr}")
    out = [json.loads(line) for line in proc.stdout.splitlines()]
    return [(q, r["status"], r["body"], r["seconds"])
            for q, r in zip(queries, out)]


def sequential_latency(base: str, queries: list) -> np.ndarray:
    """Client ms of ``queries`` sent one after another from a client
    process."""
    out = []
    for q, status, _, seconds in client_run(base, queries):
        if status != 200:
            raise AssertionError(f"{q}: HTTP {status}")
        out.append(seconds * 1e3)
    return np.asarray(out)


OBSERVABILITY_MODES = ("on", "off", "metrics", "tracing", "telemetry")


def observability_overhead(base: str, queries: list, rounds: int = 10) -> dict:
    """The sequential queries from a client process in ``rounds`` rounds,
    each round one run per mode in turn: metrics, tracing and device
    telemetry all on, all killed, and each of the three alone on, so the
    host's drift over the phase falls on every mode alike. Prints each
    mode's p25 / p50 / p75 / p99 ms over its runs and its runs' p50s;
    with tracing on, the queries carry a ``traceparent`` each, and the
    median user-query split of the "on" runs against the tracing-alone
    runs says where metrics and telemetry add time."""
    import secrets

    from predictionio_tpu_torch.utils import device_telemetry, metrics, tracing

    switches = {"metrics": metrics.set_enabled,
                "tracing": tracing.set_tracing_enabled,
                "telemetry": device_telemetry.set_enabled}
    lats: dict = {mode: [] for mode in OBSERVABILITY_MODES}
    splits: dict = {"on": [], "tracing": []}
    with CollectorPauses() as collector:
        try:
            for _ in range(rounds):
                for mode in OBSERVABILITY_MODES:
                    for name, switch in switches.items():
                        switch(mode in ("on", name))
                    ids = [secrets.token_hex(16) for _ in queries]
                    headers = {i: {"traceparent":
                                   f"00-{tid}-{secrets.token_hex(8)}-01"}
                               for i, tid in enumerate(ids)} \
                        if mode in splits else None
                    run = client_run(base, queries, headers)
                    if any(status != 200 for _, status, _, _ in run):
                        raise AssertionError(f"a query failed in mode {mode}")
                    lats[mode].append(np.asarray([r[3] for r in run]) * 1e3)
                    if mode in splits:
                        splits[mode] += [
                            span_split(fetch_trace(base, tid), seconds,
                                       telemetry=mode == "on")
                            for (q, _, _, seconds), tid in zip(run, ids)
                            if query_kind(q) == "user"]
        finally:
            for switch in switches.values():
                switch(True)
    print(f"[serve] over the on/off runs: {collector.summary()}")
    out = {}
    for mode, runs in lats.items():
        lat = np.concatenate(runs)
        out[mode] = {f"p{q}_ms": float(np.percentile(lat, q))
                     for q in (25, 50, 75, 99)}
        print(f"[serve] observability {mode}"
              f"{' alone' if mode in switches else ''}: "
              + ", ".join(f"p{q} {out[mode][f'p{q}_ms']!r}"
                          for q in (25, 50, 75, 99))
              + f" ms; runs' p50 "
              f"{[round(float(np.percentile(r, 50)), 4) for r in runs]}")
    out["p50_ratio"] = out["on"]["p50_ms"] / out["off"]["p50_ms"]
    # each round's on run over the same round's killed run: the spread
    # of these ratios says how far one pair of runs can be trusted
    paired = sorted(float(np.percentile(a, 50) / np.percentile(b, 50))
                    for a, b in zip(lats["on"], lats["off"]))
    out["paired_p50_ratios"] = paired
    print(f"[serve] observability on / off over {rounds * len(queries)} "
          f"queries each: p50 {out['on']['p50_ms']!r} / "
          f"{out['off']['p50_ms']!r} ms (ratio {out['p50_ratio']!r}; the "
          f"JAX package's gate is 1.05); by round, median "
          f"{float(np.median(paired))!r}, from {paired[0]!r} to "
          f"{paired[-1]!r}; alone, p50 over killed: "
          + ", ".join(f"{name} {out[name]['p50_ms'] / out['off']['p50_ms']!r}"
                      for name in switches))
    print("[serve] user-query split, median ms, all on against tracing "
          "alone: " + ", ".join(
              f"{part} {float(np.median([r[part] for r in splits['on']])):.4f}"
              f" / {float(np.median([r[part] for r in splits['tracing']])):.4f}"
              for part in SPLIT_PARTS))
    return out


def check_against_plain(model, answers: list) -> int:
    """Each ``(query, status, body, seconds)`` must be a 200 whose items
    and scores are the same pipeline's with the plain version in place of
    the serving kernel (one extra result of context for near-tie checks),
    scores within ``RTOL`` of the largest score the query can reach.
    Returns the number checked."""
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops import serving as serving_mod
    from predictionio_tpu_torch.templates.recommendation.engine import (
        ALSAlgorithm,
        Query,
    )

    algo = ALSAlgorithm()
    server = model.device_server()
    # a model whose store was patched (fold-in) serves rows beyond its
    # host factors: the norms come from the store itself
    X = server._X
    x_norm = (X.float() if not hasattr(X, "scale") else
              X.data.float() * X.scale[:, None]).norm(dim=1).cpu().numpy()
    y_norm = float(np.linalg.norm(model.item_factors, axis=1).max())
    serving_mod.fused_gather_score_topk = \
        als_cuda.fused_gather_score_topk_plain
    try:
        checked = 0
        for q, status, body, _ in answers:
            if status != 200:
                raise AssertionError(f"{q}: HTTP {status} {body}")
            wide = dict(q, num=q["num"] + 1)
            want = algo.predict(model, Query(**{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in wide.items()}))
            got = body["itemScores"]
            exp_items = [s.item for s in want.item_scores]
            exp_scores = np.asarray([s.score for s in want.item_scores] +
                                    [-np.inf], dtype=np.float32)
            if "items" in q:
                bound = 1.01 * len(q["items"])
            elif q["user"] in model.user_map:
                bound = 1.01 * x_norm[model.user_map[q["user"]]] * y_norm
            else:
                bound = 0.0
            n = min(q["num"], len(exp_items))
            if len(got) != n:
                raise AssertionError(f"{q}: {len(got)} results, want {n}")
            kv = np.asarray([[g["score"] for g in got]], dtype=np.float32)
            item_ids = {it: j for j, it in enumerate(exp_items)}
            ki = np.asarray([[item_ids.get(g["item"], n + 1 + j)
                              for j, g in enumerate(got)]])
            if n:
                check_topk(kv, ki, exp_scores[None, :n + 1],
                           np.arange(n + 1)[None, :],
                           np.asarray([RTOL * bound], np.float32),
                           exact=False)
            checked += 1
    finally:
        serving_mod.fused_gather_score_topk = als_cuda.fused_gather_score_topk
    return checked


def serve_full_width(model, seed: int) -> dict:
    import secrets

    import torch

    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops import serving as serving_mod
    from predictionio_tpu_torch.templates.recommendation.engine import (
        engine_factory,
    )
    from predictionio_tpu_torch.utils import device_telemetry
    from predictionio_tpu_torch.workflow.create_server import (
        QueryServer,
        ServerConfig,
        deployment_from_models,
    )

    t0 = time.perf_counter()
    sizes = np.asarray([len(v) for v in model.seen.values()])
    print(f"[serve] the trained model; seen lists: mean {sizes.mean():.1f}, "
          f"max {sizes.max()}")
    engine = engine_factory()
    params = engine.engine_params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": RANK}}]})
    dep = deployment_from_models(engine, params, [model])
    server = QueryServer(ServerConfig(ip="127.0.0.1", port=0), dep).start()
    print(f"[serve] store and warm-up: "
          f"{time.perf_counter() - t0:.1f} s")
    srv = model.device_server()
    if not isinstance(srv, serving_mod.DeviceTopK):
        raise AssertionError(f"expected the device store, got {type(srv)}")
    seen_bytes = srv._seen_cols.nbytes + srv._seen_mask.nbytes
    print(f"[serve] device store: {srv.precision}, seen tables "
          f"{tuple(srv._seen_cols.shape)} = {seen_bytes} bytes on the card")
    host, port = server.address
    base = f"http://{host}:{port}"
    rng = np.random.default_rng(seed + 1)
    users = [f"u{u}" for u in rng.integers(0, N_USERS, 68)]
    queries = [{"user": u, "num": 10} for u in users[:24]]
    queries += [{"user": u, "num": 10,
                 "blacklist": [f"i{i}" for i in rng.integers(0, 500, 3)]}
                for u in users[24:32]]
    queries += [{"items": [f"i{i}" for i in rng.integers(0, M_ITEMS, n)],
                 "num": 10} for n in (1, 1, 2, 2, 3, 3, 5, 9)]
    queries += [{"user": users[32], "num": 10, "categories": ["g3"]},
                {"user": users[33], "num": 5, "categories": ["g7", "g11"]},
                {"user": "no-such-user", "num": 10}]
    # two wide (category) queries among the narrow ones: the users lane
    # splits each batch by k bucket, so the narrow rows keep k = 16
    concurrent = [{"user": u, "num": 10} for u in users[34:66]]
    concurrent[5:5] = [{"user": users[66], "num": 10, "categories": ["g5"]}]
    concurrent[21:21] = [{"user": users[67], "num": 10,
                          "categories": ["g9", "g2"]}]

    health = get_json(base + "/healthz")
    if not health["ready"]:
        raise AssertionError(f"server not ready: {health}")

    before, lanes_before = scrape(base), srv.stats()
    als_cuda.launches.reset()
    with CollectorPauses() as collector:
        answers = [(q, *post(base + "/queries.json", q)) for q in queries]
        in_burst = burst(base, concurrent)
    print(f"[serve] over the 77 in-process requests: {collector.summary()}")
    # the same queries from a client process, each under a trace of its
    # own and alone on the server (a 5 ms pause before each), read back
    # from /traces/<id>: the split of its latency
    def traceparent(trace_id: str) -> dict:
        return {"traceparent": f"00-{trace_id}-{secrets.token_hex(8)}-01"}

    trace_ids = [secrets.token_hex(16) for _ in queries]
    with CollectorPauses() as collector:
        traced = client_run(base, queries, {
            i: traceparent(tid) for i, tid in enumerate(trace_ids)},
            pause=0.005)
    splits: dict = {}
    resent = []
    for (q, _, _, seconds), trace_id in zip(traced, trace_ids):
        record = fetch_trace(base, trace_id)
        # the server span ends after the answer went out: a stall of the
        # handler thread just then (a collector pass, the scheduler) ends
        # it after the client has read the answer. Such a query is sent
        # again, twice at most; a span that outlasts its client every
        # time fails below.
        for _ in range(2):
            if span_seconds(span_tree(record)[0]) <= seconds:
                break
            resent.append((query_kind(q), span_seconds(span_tree(record)[0]),
                           seconds))
            trace_id = secrets.token_hex(16)
            (_, _, _, seconds), = client_run(
                base, [q], {0: traceparent(trace_id)}, pause=0.005)
            record = fetch_trace(base, trace_id)
        check_spans(record, seconds)
        splits.setdefault(query_kind(q), []).append(
            span_split(record, seconds))
    print(f"[serve] traced queries: {collector.summary()}; sent again "
          f"after their server span outlasted the client's latency (kind, "
          f"server s, client s): {resent}")
    answers += traced + in_burst
    launches = als_cuda.launches.value
    if launches == 0:
        raise AssertionError("the kernel was never launched on the main path")
    by_key = als_cuda.launches.by_key()
    small = [route for route, k, b in by_key
             if k <= als_cuda.CHUNK_K_MAX and b < als_cuda.CHUNKED_MAX_B]
    if not small or any(route != "chunked" for route in small):
        raise AssertionError(f"the main path's launches at k <= 128 did not "
                             f"all take the chunked route: {by_key}")
    stats = srv.stats()
    print_split(splits)

    # the profiled burst: the flight recorder's device time against the
    # profiler's time of the serving kernel's own kernels
    recorder = device_telemetry.recorder()
    recorder.reset()
    wall, busy, kernels, kernel_ms = device_busy(
        lambda: burst(base, concurrent))
    records = recorder.snapshot(recorder.capacity)
    event_ms = sum(r["deviceUs"] for r in records) / 1e3
    b1_ms = sum(kernel_ms[name] for name in b1_kernel_names())
    if kernels:
        print(f"[serve] profiled burst of {len(concurrent)} queries: wall "
              f"{wall!r} ms, device busy {busy!r} ms "
              f"({100 * busy / wall:.2f}%); kernels {dict(kernels)}")
        print(f"[serve] device.execute over the burst: {len(records)} "
              f"launches, CUDA events {event_ms!r} ms against the "
              f"profiler's {b1_ms!r} ms of the serving kernel's kernels "
              f"(ratio {event_ms / b1_ms if b1_ms else float('nan')!r}) and "
              f"the burst's wall {wall!r} ms")
        if b1_ms and not 0.98 * b1_ms <= event_ms <= wall:
            raise AssertionError(
                f"device.execute's device time {event_ms!r} ms lies outside "
                f"[0.98 x {b1_ms!r}, {wall!r}] ms")
    else:
        print("[serve] device busy share not measured: the profiler "
              "recorded no CUDA kernels")

    # the scrape: the registry's counts against the phase's own
    after, lanes_after = scrape(base), srv.stats()
    sent = 2 * len(queries) + 2 * len(concurrent) + len(resent)
    all_launches = als_cuda.launches.value
    counts = {
        "http_requests": scraped(after, "pio_http_requests_total",
                                 route="/queries.json")
        - scraped(before, "pio_http_requests_total", route="/queries.json"),
        "microbatch_dispatches": scraped(
            after, "pio_microbatch_dispatches_total", batcher="pio-microbatch")
        - scraped(before, "pio_microbatch_dispatches_total",
                  batcher="pio-microbatch"),
        "dispatch_device_seconds": scraped(
            after, "pio_dispatch_device_seconds", "count")
        - scraped(before, "pio_dispatch_device_seconds", "count")}
    want = {"http_requests": sent,
            "microbatch_dispatches": lanes_after["users"]["dispatches"]
            - lanes_before["users"]["dispatches"],
            "dispatch_device_seconds": all_launches}
    print(f"[serve] scrape of /metrics: {counts}; the phase's own counts "
          f"{want}")
    if counts != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"/metrics counts {counts} != {want}")
    report = get_json(base + "/dispatches.json?limit=0")
    for lane, summary in report["summary"].items():
        print(f"[serve] /dispatches.json lane {lane}: {json.dumps(summary)}")

    overhead = observability_overhead(base, queries)

    checked = check_against_plain(model, answers)
    torch.cuda.synchronize()
    # the in-process requests only, as the earlier phase 3 measured them
    timed = answers[:len(queries)] + in_burst
    lat = np.asarray([a[3] for a in timed]) * 1e3
    print(f"[serve] {checked} answers match the plain pipeline; kernel "
          f"launches {launches}; users lane {stats['users']['dispatches']} "
          f"dispatches for {stats['users']['batchedQueries']} queries")
    print("[serve] kernel launches by (route, k, B): "
          + ", ".join(f"{r} k={k} B={b}: {n}"
                      for (r, k, b), n in sorted(by_key.items())))
    print(f"[serve] HTTP latency over {len(lat)} in-process requests: p50 "
          f"{float(np.percentile(lat, 50))!r} ms, p99 "
          f"{float(np.percentile(lat, 99))!r} ms")
    for j in np.argsort(lat)[::-1][:3]:
        print(f"[serve]   slow: {float(lat[j])!r} ms for "
              f"{json.dumps(timed[j][0])}")
    narrow = [a[3] * 1e3 for a in in_burst if "categories" not in a[0]]
    print(f"[serve] concurrent burst: {len(narrow)} narrow queries p50 "
          f"{float(np.percentile(narrow, 50))!r} ms, max "
          f"{max(narrow)!r} ms; category queries "
          f"{[a[3] * 1e3 for a in in_burst if 'categories' in a[0]]!r} ms")
    server.stop()
    return {"launches": launches, "routes": routes_of(by_key),
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "overhead": overhead}


# -- phase 3b: online fold-in at ML-20M width ---------------------------------

FOLDIN_APP = "FoldIn20M"
FOLDIN_KNOWN = 512        # users whose full histories the store holds
FOLDIN_TOUCHED = 256      # of them, given 1-3 new ratings after deploy
FOLDIN_NEW = 256          # brand-new users, 5-200 ratings each
FOLDIN_INTERVAL = 0.5     # PIO_FOLDIN_INTERVAL, seconds
FOLDIN_DEADLINE = 30.0    # event -> servable, seconds
FOLDIN_HAMMER_S = 3.0     # the hammer's query threads run this long
# a folded row in the bf16 store against the plain fold cast to bf16,
# relative to the row's largest entry: one bf16 step (2^-7) where the
# two fp32 rows round to neighbouring bf16 values, plus the assembly's
# fp32 reordering carried through the solve (1e-3, the bound phase 5
# holds the trained factors to)
FOLDIN_ROW_TOL = 2.0 ** -7 + 1e-3


# phase 3b's poster, in a process of its own: the batches of a JSON file
# (a list of event lists) posted to a URL from N threads, batch b by
# thread b % N; one line out per batch ({"b", "sent" (epoch seconds),
# "bad": refused items or the error})
POSTER = r"""
import json, sys, threading, time, urllib.request
url, path, clients = sys.argv[1], sys.argv[2], int(sys.argv[3])
with open(path) as f:
    batches = json.load(f)
lock = threading.Lock()

def client(c):
    opener = urllib.request.build_opener()
    for b in range(c, len(batches), clients):
        req = urllib.request.Request(
            url, method="POST", data=json.dumps(batches[b]).encode(),
            headers={"Content-Type": "application/json"})
        sent = time.time()
        try:
            with opener.open(req, timeout=120) as resp:
                items = json.loads(resp.read())
                bad = int(resp.status != 200) + sum(
                    x.get("status") != 201 for x in items)
        except Exception as e:
            bad = repr(e)
        with lock:
            print(json.dumps({"b": b, "sent": sent, "bad": bad}), flush=True)

threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
for t in threads:
    t.start()
for t in threads:
    t.join()
"""


def foldin_events(rng, model, known: np.ndarray, touched: np.ndarray):
    """The post-deploy events, in the event server's JSON: 1-3 new
    ratings for each touched known user (on items not in its seen list),
    256 new users with 5-200 ratings each, and what the consumer must
    ignore: ``view`` events of untouched known users, ratings of items
    the model does not know (by touched users, and by users who rate
    nothing else), and item ``$set`` events. Each user's ratings come
    together, as a session does, the sessions and the other events in a
    seeded random order. Returns (events, {user: new item labels}, new
    user names)."""
    labels = model.item_map.labels

    def rate(user, item, value=None):
        return {"event": "rate", "entityType": "user", "entityId": user,
                "targetEntityType": "item", "targetEntityId": item,
                "properties": {"rating": float(
                    value if value is not None
                    else rng.integers(1, 11) * 0.5)}}

    sessions, added = [], {}
    for u in touched.tolist():
        name = f"u{u}"
        have = set(model.seen[model.user_map[name]].tolist())
        fresh = [i for i in rng.choice(M_ITEMS, 8, replace=False).tolist()
                 if i not in have][:int(rng.integers(1, 4))]
        added[name] = [labels[i] for i in fresh]
        sessions.append([rate(name, labels[i]) for i in fresh])
    new_users = [f"new{j}" for j in range(FOLDIN_NEW)]
    for name in new_users:
        n = int(rng.integers(5, 201))
        sessions.append([rate(name, labels[i]) for i in
                         rng.choice(M_ITEMS, n, replace=False).tolist()])
    untouched = np.setdiff1d(known, touched)
    sessions += [[{"event": "view", "entityType": "user",
                   "entityId": f"u{int(rng.choice(untouched))}",
                   "targetEntityType": "item",
                   "targetEntityId": labels[int(rng.integers(0, M_ITEMS))]}]
                 for _ in range(200)]
    sessions += [[rate(f"u{int(rng.choice(touched))}", f"unknown{j}")]
                 for j in range(50)]
    sessions += [[rate(f"ghost{j}", f"unknown{j}")] for j in range(50)]
    sessions += [[{"event": "$set", "entityType": "item",
                   "entityId": labels[int(rng.integers(0, M_ITEMS))],
                   "properties": {"categories": ["g0"]}}]
                 for _ in range(100)]
    events = [e for j in rng.permutation(len(sessions)) for e in sessions[j]]
    return events, added, new_users


def foldin_hammer(dev, trained: dict, seed: int) -> dict:
    """Check (d) on the card: a store of its own (phase 5's factors and
    seen lists, bf16), 8 threads sending ``users_topk`` for 256 users
    while another alternates those users' rows and seen lists between
    sets A and B, its third patch also growing the store. Every answer
    must be set A's answer or set B's."""
    import torch

    from predictionio_tpu_torch.ops.serving import DeviceTopK, bucket_size

    model = trained["model"]
    rng = np.random.default_rng(seed + 17)
    srv = DeviceTopK(model.user_factors, model.item_factors, model.seen,
                     microbatch=False, device=dev)
    users = np.arange(N_USERS - 256, N_USERS)
    donors = rng.choice(N_USERS - 256, 512, replace=False)
    sets = []
    for d in (donors[:256], donors[256:]):
        seen = {int(u): model.seen.get(int(v), np.zeros(0, np.int64))
                for u, v in zip(users, d)}
        sets.append((model.user_factors[d], seen))
    answers = []
    for rows, seen in sets:
        srv.patch_users(users, rows, seen_items=seen)
        answers.append(tuple(a.tobytes() for a in srv.users_topk(users, 16)))
    if answers[0] == answers[1]:
        raise AssertionError("the hammer's two sets answer alike")
    got, errors = [], []
    stop = threading.Event()

    def query():
        while not stop.is_set():
            try:
                got.append(tuple(a.tobytes()
                                 for a in srv.users_topk(users, 16)))
            except Exception as e:  # reported below; the phase then fails
                errors.append(repr(e))
                return

    threads = [threading.Thread(target=query) for _ in range(8)]
    for t in threads:
        t.start()
    patches, t0 = 0, time.perf_counter()
    try:
        while time.perf_counter() - t0 < FOLDIN_HAMMER_S:
            rows, seen = sets[patches % 2]
            uids, rows = users, rows
            if patches == 2:    # also grows the store (to 276,986 rows)
                uids = np.append(users, N_USERS)
                rows = np.concatenate([rows, rows[:1]])
            srv.patch_users(uids, rows, seen_items=seen)
            patches += 1
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    torch.cuda.synchronize()
    torn = sum(a not in answers for a in got)
    if errors or torn or not got or srv.user_capacity != bucket_size(
            N_USERS + 1, lo=N_USERS):
        raise AssertionError(f"hammer: {len(got)} answers, {torn} torn, "
                             f"errors {errors[:3]}, capacity "
                             f"{srv.user_capacity}")
    out = {"answers": len(got), "patches": patches, "torn": 0,
           "growth": srv.growths[-1]}
    print(f"[foldin] hammer: {len(got)} answers of users_topk for 256 users "
          f"from 8 threads across {patches} patches alternating two row "
          f"and seen sets (one growing the store to {srv.user_capacity} "
          f"rows, lock held {srv.growths[-1]['lockSec']!r} s, stream "
          f"{srv.growths[-1]['deviceSec']!r} s): every "
          f"answer set A's or set B's")
    del srv
    torch.cuda.empty_cache()
    return out


def foldin_full_width(dev, trained: dict, ratings: tuple, seed: int,
                      served: dict) -> dict:
    """Phase 3b: fold-in through the deployed server at ML-20M width.

    A sqlite event store holds the full histories of 512 of phase 5's
    users, in phase 5's event order (the heaviest user, at the 2,048
    cap, among them); ``QueryServer(ServerConfig(foldin=True))`` serves
    a model built from phase 5's factors, maps and seen lists, and the
    port's event server, a ``pio eventserver`` process, writes to the
    same store. The events of :func:`foldin_events` go through ``POST
    /batch/events.json`` in 50-event batches from 8 threads of a client
    process (``POSTER``) while queries run; then checks (a) to (e) of
    the module docstring. Both processes keep their request handling off
    this interpreter's lock, as a deployment's would."""
    import contextlib
    import os
    import tempfile

    import torch

    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.bimap import StringIndexBiMap
    from predictionio_tpu_torch.data.storage.base import AccessKey, App
    from predictionio_tpu_torch.online import foldin as foldin_mod
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops.als import fold_in_users
    from predictionio_tpu_torch.templates.recommendation.engine import (
        ALSModel,
        engine_factory,
    )
    from predictionio_tpu_torch.utils import metrics, tracing
    from predictionio_tpu_torch.workflow.create_server import (
        QueryServer,
        ServerConfig,
        deployment_from_models,
    )

    base_model = trained["model"]
    base_model._server = None          # phase 3's store, freed
    torch.cuda.empty_cache()
    rows, cols, values, order = ratings
    rng = np.random.default_rng(seed + 13)
    lens = np.bincount(rows, minlength=N_USERS)
    heavy = int(np.argmax(lens))
    others = np.flatnonzero(lens > 0)
    others = rng.choice(others[others != heavy], FOLDIN_KNOWN - 1,
                        replace=False)
    known = np.concatenate([[heavy], others])
    touched = known[:FOLDIN_TOUCHED]
    hist = order[np.isin(rows[order], known)]
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="pio-foldin-")
    db = os.path.join(work, "pio.db")
    storage.reset(storage.StorageConfig(
        sources={"S": {"type": "sqlite", "path": db}},
        repositories={r: "S" for r in storage.REPOSITORIES}))
    app_id = storage.get_metadata_apps().insert(App(0, FOLDIN_APP))
    key = storage.get_metadata_access_keys().insert(AccessKey("", app_id, ()))
    levents = storage.get_levents()
    levents.init(app_id)
    base = 1.5e9
    users_h, items_h = rows[hist].tolist(), cols[hist].tolist()
    stars = values[hist].tolist()
    levents.insert_raw_batch([
        (f"h{j}", "rate", "user", f"u{users_h[j]}", "item", f"i{items_h[j]}",
         f'{{"rating": {stars[j]!r}}}', base + j, "[]", None, base + j)
        for j in range(len(hist))], app_id)
    write_s = time.perf_counter() - t0
    # the deployed model: phase 5's factors, maps and seen lists; the
    # user map and seen dict are copies (fold-in grows them)
    model = ALSModel(
        base_model.user_factors, base_model.item_factors,
        StringIndexBiMap.from_distinct(list(base_model.user_map.labels)),
        base_model.item_map, dict(base_model.seen),
        item_categories=base_model.item_categories, device=str(dev))
    engine = engine_factory()
    params = engine.engine_params_from_variant({
        "datasource": {"params": {"appName": FOLDIN_APP}},
        "algorithms": [{"name": "als", "params": {
            "rank": RANK, "numIterations": ITERATIONS, "lambda": LAMBDA,
            "alpha": ALPHA, "seed": seed}}]})
    als_params = params.algorithm_params_list[0][1]
    prior_interval = os.environ.get("PIO_FOLDIN_INTERVAL")
    os.environ["PIO_FOLDIN_INTERVAL"] = repr(FOLDIN_INTERVAL)
    captured, fold_log = [], []
    real_scope = foldin_mod.trace_scope

    @contextlib.contextmanager
    def capturing_scope(name, **kwargs):
        # each fold's pio.foldin trace, read back as soon as it retires
        with real_scope(name, **kwargs) as root:
            yield root
        if root is not None:
            record = tracing.trace_buffer().get(root.trace_id)
            if record is not None:
                captured.append(record)

    foldin_mod.trace_scope = capturing_scope
    server = events = None
    try:
        t1 = time.perf_counter()
        server = QueryServer(ServerConfig(ip="127.0.0.1", port=0,
                                          foldin=True),
                             deployment_from_models(engine, params,
                                                    [model])).start()
        # the event server in a process of its own (``pio eventserver``
        # over the same sqlite file), as a deployment runs it: its
        # request handling never holds the query server's interpreter lock
        events, es_base, _ = pio_child(
            ["eventserver", "--ip", "127.0.0.1", "--port", "0"],
            console_env(db), work, "Event Server is ready at")
        deploy_s = time.perf_counter() - t1
        srv = model.device_server()
        consumer = server._foldin
        print(f"[foldin] {len(hist)} ratings of {FOLDIN_KNOWN} users (the "
              f"heaviest with {lens[heavy]}) written to a sqlite store in "
              f"{write_s!r} s; deploy with fold-in and the event server "
              f"{deploy_s!r} s; cadence PIO_FOLDIN_INTERVAL="
              f"{consumer._cfg.interval!r} s, PIO_FOLDIN_COUNT="
              f"{consumer._cfg.count_threshold}")
        seen_before = (tuple(srv._seen_cols.shape),
                       srv._seen_cols.nbytes + srv._seen_mask.nbytes)
        state = {"in_fold": 0}
        real_fold = consumer._fold

        def timed_fold():
            state["in_fold"] += 1
            t = time.perf_counter()
            patched = consumer.users_patched
            try:
                real_fold()
            finally:
                state["in_fold"] -= 1
                fold_log.append({"s": time.perf_counter() - t,
                                 "users": consumer.users_patched - patched})

        consumer._fold = timed_fold
        qbase = "http://{}:{}".format(*server.address)
        ev_url = f"{es_base}/batch/events.json?accessKey={key}"

        # the answers of untouched users before any fold
        untouched = np.setdiff1d(known, touched)
        strangers = rng.choice(np.setdiff1d(np.arange(N_USERS), known), 256,
                               replace=False)
        steady = [f"u{u}" for u in np.concatenate([untouched, strangers])]
        steady_idx = np.asarray([model.user_map[u] for u in steady])
        halves = (steady_idx[:256], steady_idx[256:])   # a full batch each

        def steady_answers():
            return [tuple(a.tobytes() for a in srv.users_topk(h, 16))
                    for h in halves]

        steady_want = steady_answers()
        steady_http = {u: post(qbase + "/queries.json",
                               {"user": u, "num": 10})[1]["itemScores"]
                       for u in steady[:64]}

        evs, added, new_users = foldin_events(rng, model, known, touched)
        batches = [evs[a:a + QS_BATCH] for a in range(0, len(evs), QS_BATCH)]
        sent_at = [None] * len(batches)
        first_batch = {}
        for b, chunk in enumerate(batches):
            for e in chunk:
                first_batch.setdefault(e["entityId"], b)
        before = scrape(qbase)
        launch0 = (als_cuda.assemble_launches.value,
                   als_cuda.spd_launches.value, als_cuda.launches.value)
        bad, lat, served_at = [], [], {}
        stop_http, stop = threading.Event(), threading.Event()
        batches_file = os.path.join(work, "batches.json")
        with open(batches_file, "w") as f:
            json.dump(batches, f)

        def steady_http_client():
            j = 0
            while not stop_http.is_set():
                u = steady[j % 64]
                status, body, took = post(qbase + "/queries.json",
                                          {"user": u, "num": 10})
                lat.append(took)
                # the same items; the scores to RTOL (a batch's other rows
                # may take another sort route, bitwise equal on the card)
                want = steady_http[u]
                if status != 200 or [x["item"] for x in body["itemScores"]] \
                        != [x["item"] for x in want] or not np.allclose(
                            [x["score"] for x in body["itemScores"]],
                            [x["score"] for x in want], rtol=RTOL, atol=0):
                    bad.append(("steady http", u, status, body, want))
                j += 1
                time.sleep(0.005)   # a light load: each query alone

        def steady_direct():
            while not stop.is_set():
                if steady_answers() != steady_want:
                    bad.append("an untouched user's answer moved")
                time.sleep(0.02)

        def poll_new():
            pending = set(new_users)
            while pending and not stop.is_set():
                for name in list(pending):
                    if name not in model.user_map:
                        continue
                    status, body, _ = post(qbase + "/queries.json",
                                           {"user": name, "num": 10})
                    if status == 200 and body["itemScores"]:
                        served_at[name] = time.time()
                        pending.discard(name)
                time.sleep(0.001)

        readers = [threading.Thread(target=f) for f in
                   (steady_http_client, steady_direct, poll_new)]
        t_post = time.perf_counter()
        for t in readers:
            t.start()
        proc = subprocess.run(
            [sys.executable, "-c", POSTER, ev_url, batches_file,
             str(QS_CLIENTS)], capture_output=True, text=True, timeout=600)
        posted = time.perf_counter()
        post_s = posted - t_post
        for line in proc.stdout.splitlines():
            rec = json.loads(line)
            sent_at[rec["b"]] = rec["sent"]
            if rec["bad"]:
                bad.append(("post", rec))
        if proc.returncode != 0 or None in sent_at:
            bad.append(("poster", proc.returncode, proc.stderr[-2000:]))
        # the HTTP reader stops with the posts, so the last folds' flight
        # records stay in the recorder's ring; the direct reader and the
        # new users' poller run on until the folds are done
        stop_http.set()
        readers[0].join(timeout=60)

        def quiet() -> bool:
            return (consumer._cursor.get("rowid")
                    == levents.tail_cursor(app_id, None)["rowid"]
                    and not consumer._pending and state["in_fold"] == 0)

        calm = 0
        while calm < 2 and time.perf_counter() - posted < FOLDIN_DEADLINE:
            calm = calm + 1 if quiet() else 0
            time.sleep(0.3)
        readers[2].join(timeout=max(0.0, FOLDIN_DEADLINE
                                    - (time.perf_counter() - posted)))
        stop.set()
        readers[1].join(timeout=60)
        if bad or calm < 2 or len(served_at) != FOLDIN_NEW:
            raise AssertionError(
                f"fold-in: {len(bad)} failures ({bad[:3]}), quiet {calm}, "
                f"{len(served_at)}/{FOLDIN_NEW} new users served within "
                f"{FOLDIN_DEADLINE} s")
        torch.cuda.synchronize()
        launches = (als_cuda.assemble_launches.value - launch0[0],
                    als_cuda.spd_launches.value - launch0[1],
                    als_cuda.launches.value - launch0[2])
        st = consumer.stats()
        if st["foldErrors"] or st["tailErrors"] or st["newUsers"] \
                != FOLDIN_NEW:
            raise AssertionError(f"fold-in stats {st}")
        # (e) each fold launched B3 once and B2 once; B1 served throughout
        if launches[:2] != (st["folds"], st["folds"]) or not launches[2]:
            raise AssertionError(f"launches (B3, B2, B1) {launches} for "
                                 f"{st['folds']} folds")
        after = scrape(qbase)

        def delta(name, **labels):
            return scraped(after, name, **labels) \
                - scraped(before, name, **labels)

        counts = {"new": delta("pio_foldin_users_total", kind="new"),
                  "known": delta("pio_foldin_users_total", kind="known"),
                  "folds": delta("pio_foldin_folds_total", status="ok")}
        want = {"new": float(FOLDIN_NEW),
                "known": float(st["usersPatched"] - FOLDIN_NEW),
                "folds": float(st["folds"])}
        if counts != want or st["usersPatched"] != sum(
                f["users"] for f in fold_log):
            raise AssertionError(f"/metrics {counts} != {want}")
        report = get_json(qbase + "/dispatches.json?limit=2048")
        fold_records = [r for r in report["dispatches"]
                        if r["lane"] == "foldin"]
        # the kernels' CUDA-event windows lie inside the host's wait for
        # the rows
        if not fold_records or any(r["deviceUs"] is None
                                   or r["deviceUs"] > r["hostUs"]
                                   for r in fold_records):
            raise AssertionError(f"/dispatches.json fold records "
                                 f"{fold_records[:3]}")

        # (a) the touched known users: their new items are in their seen
        # rows on the card, and out of their answers
        for name, items in added.items():
            uidx = model.user_map[name]
            row = set(srv._seen_cols[uidx][srv._seen_mask[uidx] > 0]
                      .tolist())
            if not {model.item_map[i] for i in items} <= row:
                raise AssertionError(f"{name}'s new items are not masked")
        heavy_len = int((srv._seen_mask[model.user_map[f"u{heavy}"]] > 0)
                        .sum())

        # (b) the store's rows of the touched users against the plain fold
        # of their full histories read back from the store
        folded = [f"u{u}" for u in touched] + new_users
        cl, vl = [], []
        for name in folded:
            c, v = [], []
            for e in levents.find(app_id, entity_type="user", entity_id=name,
                                  event_names=["rate"],
                                  target_entity_type="item"):
                idx = model.item_map.get(e.target_entity_id)
                if idx is not None:
                    c.append(idx)
                    v.append(float(e.properties.fields["rating"]))
            cl.append(np.asarray(c, np.int64))
            vl.append(np.asarray(v, np.float32))
        saved = (als_cuda.assemble_normal_equations, als_cuda.spd_solve)
        als_cuda.assemble_normal_equations = \
            als_cuda.assemble_normal_equations_plain
        als_cuda.spd_solve = als_cuda.spd_solve_plain
        try:
            plain = fold_in_users(srv.item_factors, cl, vl, als_params)
        finally:
            als_cuda.assemble_normal_equations, als_cuda.spd_solve = saved
        uidx = torch.as_tensor([model.user_map[n] for n in folded],
                               device=dev)
        stored = srv._X[uidx].float().cpu().numpy()
        want_rows = torch.from_numpy(plain).to(torch.bfloat16).float().numpy()
        scale = np.maximum(np.abs(want_rows).max(axis=1, keepdims=True),
                           1e-30)
        rel = float((np.abs(stored - want_rows) / scale).max())
        if not rel <= FOLDIN_ROW_TOL:
            raise AssertionError(f"folded rows differ from the plain fold "
                                 f"by {rel!r} of their largest entry")

        # (c) every touched and untouched user's HTTP answer against the
        # plain pipeline over the patched store
        queries = [{"user": f"u{u}", "num": 10} for u in known] \
            + [{"user": n, "num": 10} for n in new_users] \
            + [{"user": f"u{u}", "num": 10} for u in strangers]
        checked = check_against_plain(model, burst(qbase, queries))

        # what the phase prints
        growth = list(srv.growths)
        seen_after = (tuple(srv._seen_cols.shape),
                      srv._seen_cols.nbytes + srv._seen_mask.nbytes)
        splits = []
        for record in captured:
            spans = {s["name"]: s for s in record["spans"]}
            if "foldin.solve" not in spans:
                continue
            part = {name: spans[name]["durationSec"] * 1e3
                    for name in ("foldin.gather", "foldin.solve",
                                 "foldin.patch")}
            ex = spans.get("device.execute", {}).get("attributes", {})
            part.update(users=spans["foldin.solve"]["attributes"]["users"],
                        B=ex.get("bucket"), L=ex.get("kBucket"),
                        device_us=ex.get("deviceUs"))
            splits.append(part)
        fresh = np.asarray([served_at[n] - sent_at[first_batch[n]]
                            for n in new_users])
        hist_fresh = metrics.FOLDIN_FRESHNESS.child().summary()
        lat_ms = np.asarray(lat) * 1e3
        users_per_fold = [f["users"] for f in fold_log if f["users"]]
        print(f"[foldin] {len(evs)} events in {len(batches)} batches of "
              f"{QS_BATCH} from {QS_CLIENTS} threads in {post_s!r} s; "
              f"{st['folds']} folds, users per fold {users_per_fold}; "
              f"launches B3 {launches[0]}, B2 {launches[1]}, B1 "
              f"{launches[2]}; /metrics {counts}; "
              f"{len(fold_records)} foldin flight records with deviceUs")
        for j, p in enumerate(splits):
            print(f"[foldin] fold {j}: {p['users']} users, B={p['B']} "
                  f"L={p['L']}: gather {p['foldin.gather']!r} ms, solve "
                  f"{p['foldin.solve']!r} ms (device {p['device_us']!r} us), "
                  f"patch {p['foldin.patch']!r} ms")
        for g in growth:
            print(f"[foldin] a growing patch held the store lock "
                  f"{g['lockSec']!r} s (host) and the stream "
                  f"{g['deviceSec']!r} s (CUDA events): rows {g['rows']}, "
                  f"seen tables {g['seenShape']}")
        print(f"[foldin] seen tables {seen_before[0]} = {seen_before[1]} "
              f"bytes before, {seen_after[0]} = {seen_after[1]} after (the "
              f"heaviest user's list {heavy_len} long)")
        print(f"[foldin] event -> servable: first post to first non-empty "
              f"answer of the {FOLDIN_NEW} new users p50 "
              f"{float(np.percentile(fresh, 50))!r} s, p99 "
              f"{float(np.percentile(fresh, 99))!r} s, max "
              f"{float(fresh.max())!r} s; pio_foldin_freshness_seconds "
              f"(per folded event, bucket estimate) p50 "
              f"{hist_fresh.get('p50Sec')!r} s, p99 "
              f"{hist_fresh.get('p99Sec')!r} s over {hist_fresh['count']}")
        print(f"[foldin] query latency during the folds ({len(lat)} "
              f"sequential queries of untouched users): p50 "
              f"{float(np.percentile(lat_ms, 50))!r} ms, p99 "
              f"{float(np.percentile(lat_ms, 99))!r} ms; phase 3's p50 "
              f"{served['p50_ms']!r} ms, p99 {served['p99_ms']!r} ms")
        print(f"[foldin] {len(folded)} folded rows equal the plain fold "
              f"(max {rel!r} of a row's largest entry, tolerance "
              f"{FOLDIN_ROW_TOL!r}); {checked} answers match the plain "
              f"pipeline; {len(steady)} untouched users' answers unmoved")
        out = {"folds": st["folds"], "users_per_fold": users_per_fold,
               "launches": {"assemble_normal_equations": launches[0],
                            "spd_solve": launches[1],
                            "fused_gather_score_topk": launches[2]},
               "splits": splits, "growth": growth,
               "seen_bytes": [seen_before[1], seen_after[1]],
               "servable_p50_s": float(np.percentile(fresh, 50)),
               "servable_p99_s": float(np.percentile(fresh, 99)),
               "freshness_hist": hist_fresh,
               "query_p50_ms": float(np.percentile(lat_ms, 50)),
               "query_p99_ms": float(np.percentile(lat_ms, 99)),
               "row_err": rel}
    finally:
        foldin_mod.trace_scope = real_scope
        if prior_interval is None:
            os.environ.pop("PIO_FOLDIN_INTERVAL", None)
        else:
            os.environ["PIO_FOLDIN_INTERVAL"] = prior_interval
        if events is not None:
            events.terminate()
            events.wait(timeout=60)
        if server is not None:
            server.stop()
        model._server = None
        storage.reset()
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    out["hammer"] = foldin_hammer(dev, trained, seed)
    return out


# -- phase 4 ----------------------------------------------------------------

def time_ms(fn, iters: int) -> float:
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(B: int, k: int, L: int, dtype: str) -> tuple:
    """Least time for the work on an H100: the item table read once, the
    queries and seen rows read once, the winners written once, over the
    memory rate; 2*B*M*R fp32 operations over the fp32 rate."""
    per = {"fp32": 4, "bf16": 2, "int8": 1}[dtype]
    nbytes = M_ITEMS * RANK * per + (4 * M_ITEMS if dtype == "int8" else 0)
    nbytes += B * RANK * 4 + L * B * 8 + B * k * 8
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 2.0 * B * M_ITEMS * RANK / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_split(fn, iters: int) -> dict:
    """Device ms per launch of each kernel ``fn`` launches (once a call),
    by name, over two ``torch.profiler`` sessions of ``iters`` calls: the
    mean of the CUDA kernel intervals recorded. The profiler on the card
    machine sometimes records fewer launches of a kernel than ran, or
    none of a session; a kernel counts if either session recorded it."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    total: collections.Counter = collections.Counter()
    count: collections.Counter = collections.Counter()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = kernel_name(e.name)
                total[name] += (e.time_range.end - e.time_range.start) / 1e3
                count[name] += 1
    if any(n != 2 * iters for n in count.values()):
        print(f"[time]   the profiler recorded {dict(count)} launches of "
              f"{2 * iters} calls")
    return {name: total[name] / count[name] for name in total}


def timings(dev, seed: int) -> list:
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    rng = np.random.default_rng(seed + 2)
    rows = []
    for dtype in ("bf16", "fp32", "int8"):
        for B in BATCHES:
            Q, Yf, cols, mask = fixture("random", B, rng)
            store, Ydq = make_store(Yf, dtype, dev)
            Qt, ct, mt = (torch.from_numpy(a).to(dev) for a in (Q, cols, mask))
            hit = (mt > 0).nonzero(as_tuple=True)
            hit_b, hit_c = hit[1], ct[hit].long()

            for k in TIME_KS:
                iters = 3 if k == M_ITEMS else 20

                def kernel():
                    als_cuda.fused_gather_score_topk(
                        Qt, store, ct, mt, k=k, n_items=M_ITEMS)

                def plain():
                    als_cuda.fused_gather_score_topk_plain(
                        Qt, store, ct, mt, k=k, n_items=M_ITEMS)

                def library():
                    s = torch.matmul(Qt, Ydq.T)
                    s[hit_b, hit_c] = float("-inf")
                    torch.topk(s, k, dim=1)

                t_k, t_p, t_l = (time_ms(f, iters)
                                 for f in (kernel, plain, library))
                b_ms, b_by = bound_ms(B, k, cols.shape[0], dtype)
                row = {"store": dtype, "B": B, "k": k, "ms": t_k,
                       "plain_ms": t_p, "library_ms": t_l,
                       "bound_ms": b_ms, "bound_by": b_by}
                split = ""
                if k <= 128 and (dtype == "bf16" or B == 8):
                    row["device_ms"] = kernel_split(kernel, 20)
                    split = (f"  device {sum(row['device_ms'].values())!r} "
                             f"ms {row['device_ms']}")
                rows.append(row)
                print(f"[time] {dtype:>4} B={B:<3} k={k:<5} kernel "
                      f"{t_k!r} ms  plain {t_p!r} ms  library {t_l!r} ms  "
                      f"bound {b_ms!r} ms ({b_by}){split}")
    return rows


# phase 4c's batches: the chunked route against the bitonic route
CROSSOVER_BATCHES = (1, 8, 16, 32, 64, 96, 128, 192, 256)


def route_crossover(dev, seed: int) -> dict:
    """The chunked and the bitonic route on the same bf16 inputs at k in
    {16, 128} and each batch of ``CROSSOVER_BATCHES``: their answers
    bitwise equal, and each route's device ms per call (profiler, summed
    over its kernels) and event-timed ms. Returns, per k, the smallest
    batch from which the bitonic route's device time is at most the
    chunked route's (None if it never is)."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    rng = np.random.default_rng(seed + 4)
    first: dict = {}
    for k in (16, 128):
        first[k] = None
        for B in CROSSOVER_BATCHES:
            Q, Yf, cols, mask = fixture("random", B, rng)
            store, _ = make_store(Yf, "bf16", dev)
            Qt, ct, mt = (torch.from_numpy(a).to(dev) for a in (Q, cols, mask))
            out, ev, devt = {}, {}, {}
            for route in ("chunked", "bitonic"):
                def call(route=route):
                    return als_cuda._launch(Qt, store, ct, mt, k=k,
                                            n_items=M_ITEMS, mask_seen=True,
                                            row_valid=None, route=route)
                out[route] = call()
                ev[route] = time_ms(call, 20)
                devt[route] = sum(kernel_split(call, 20).values())
            (cv, ci), (bv, bi) = out["chunked"], out["bitonic"]
            fin = torch.isfinite(bv)
            if not (torch.equal(cv.view(torch.int32), bv.view(torch.int32))
                    and torch.equal(ci[fin], bi[fin])):
                raise AssertionError(f"the chunked and bitonic routes differ "
                                     f"at B={B}, k={k}")
            if first[k] is None and devt["bitonic"] <= devt["chunked"]:
                first[k] = B
            print(f"[time] bf16 B={B:<3} k={k:<3} chunked device "
                  f"{devt['chunked']!r} ms, event {ev['chunked']!r} ms; "
                  f"bitonic device {devt['bitonic']!r} ms, event "
                  f"{ev['bitonic']!r} ms")
    print(f"[time] the bitonic route is as fast from B = {first} on (the "
          f"plan takes the chunked route below CHUNKED_MAX_B = "
          f"{als_cuda.CHUNKED_MAX_B}); both routes equal in "
          f"{2 * len(CROSSOVER_BATCHES)} cases")
    return first


# -- phase 4b: training kernel times ------------------------------------------

def bound_of(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def assembly_work(B: int, L: int, nnz: int, M: int, R: int = RANK,
                  y_bytes: int = 4) -> tuple:
    """(bytes, operations) of one assembly: the ``M`` rows of the fixed
    factors ``Y`` that it gathers read once, ``M * R * bytes(Y)`` (they
    fit in L2, so the gather re-reads no device memory), the cols/aw/bw
    tables read once, gram read once, A and b written once; per real
    slot, one FMA for each entry of A's upper triangle (A is symmetric)
    and R for b."""
    nbytes = M * R * y_bytes + B * L * 12 + R * R * 4 + B * (R * R + R) * 4
    return nbytes, 2.0 * nnz * (R * (R + 1) / 2 + R)


def solve_work(B: int, R: int = RANK) -> tuple:
    """(bytes, operations) of one batched solve: the upper triangle of A
    and b read once, x written once; R^3/3 + 2R^2 operations per
    system."""
    return B * (R * (R + 1) // 2 + 2 * R) * 4, \
        B * (R ** 3 / 3.0 + 2.0 * R * R)


def training_timings(dev, trained: dict) -> dict:
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    model, pd = trained["model"], trained["pd"]
    eye = torch.eye(RANK, device=dev)
    out = {"assemble_normal_equations": [], "spd_solve": []}
    for side_name, side in (("user", pd.user_side), ("item", pd.item_side)):
        Y = torch.from_numpy(side_factors(model, side_name)).to(dev)
        gram = Y.T @ Y + LAMBDA * eye
        A_parts, b_parts = [], []
        for bucket in side.buckets:
            B, L = bucket.cols.shape
            cols = torch.as_tensor(bucket.cols, device=dev)
            aw, bw = assembly_weights(bucket, False, dev)
            nnz = int(((aw != 0) | (bw != 0)).sum())
            Yg = Y[cols.long()]
            awYg = (aw[:, :, None] * Yg).transpose(1, 2)

            def kernel():
                return als_cuda.assemble_normal_equations(Y, cols, aw, bw,
                                                          gram)

            t_k = time_ms(kernel, 5)
            t_p = time_ms(lambda: als_cuda.assemble_normal_equations_plain(
                Y, cols, aw, bw, gram), 2)
            t_l = time_ms(lambda: torch.bmm(awYg, Yg), 3)
            del Yg, awYg
            work = assembly_work(B, L, nnz, Y.shape[0])
            b_ms, b_by = bound_of(*work)
            out["assemble_normal_equations"].append({
                "side": side_name, "B": B, "L": L, "slots": nnz,
                "work": work, "ms": t_k, "plain_ms": t_p,
                "library_ms": t_l, "bound_ms": b_ms, "bound_by": b_by})
            print(f"[time] assemble {side_name:>4} B={B:<6} L={L:<6} kernel "
                  f"{t_k!r} ms  plain {t_p!r} ms  library {t_l!r} ms  bound "
                  f"{b_ms!r} ms ({b_by})")
            A, b = kernel()
            A_parts.append(A)
            b_parts.append(b)
        A, b = torch.cat(A_parts), torch.cat(b_parts)
        del A_parts, b_parts
        B = b.shape[0]

        def library():
            torch.cholesky_solve(b[:, :, None], torch.linalg.cholesky(A))

        t_k = time_ms(lambda: als_cuda.spd_solve(A, b), 3)
        t_p = time_ms(lambda: als_cuda.spd_solve_plain(A, b), 1)
        t_l = time_ms(library, 3)
        b_ms, b_by = bound_of(*solve_work(B))
        out["spd_solve"].append({
            "side": side_name, "B": B, "work": solve_work(B), "ms": t_k,
            "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
            "bound_by": b_by})
        print(f"[time] spd_solve {side_name:>4} B={B:<6} kernel {t_k!r} ms  "
              f"plain {t_p!r} ms  library {t_l!r} ms  bound {b_ms!r} ms "
              f"({b_by})")
        del A, b
    heads = {}
    for name, rows in out.items():
        b_ms, b_by = bound_of(sum(r["work"][0] for r in rows),
                              sum(r["work"][1] for r in rows))
        heads[name] = {key: sum(r[key] for r in rows)
                       for key in ("ms", "plain_ms", "library_ms")}
        heads[name].update(bound_ms=b_ms, bound_by=b_by)
        print(f"[time] {name} over one iteration's work: kernel "
              f"{heads[name]['ms']!r} ms, bound {b_ms!r} ms ({b_by})")
    return {"rows": out, "heads": heads, "large": large_rank_timings(dev),
            "foldin": foldin_timings(dev, trained),
            "bf16": bf16_assembly_timings(dev, trained)}


def bf16_assembly_timings(dev, trained: dict) -> dict:
    """B3's bf16 route at the main path's shapes: every bucket of both
    sides, R=64, on phase 5's factors cast to bf16 and the implicit
    weights rounded to bf16 (what the bf16 lane hands it), against its
    bound (``Y`` read at 2 bytes a value), its plain version and one
    library call, ``torch.einsum`` over the bf16 gather widened to fp32
    (gathered beforehand, as phase 4b's fp32 rows gather theirs)."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops.als import _round_bf16

    model, pd = trained["model"], trained["pd"]
    rows = []
    for side_name, side in (("user", pd.user_side), ("item", pd.item_side)):
        Y = torch.from_numpy(side_factors(model, side_name)).to(dev).to(
            torch.bfloat16)
        gram = Y.float().T @ Y.float() + LAMBDA * torch.eye(RANK, device=dev)
        for bucket in side.buckets:
            B, L = bucket.cols.shape
            cols = torch.as_tensor(bucket.cols, device=dev)
            aw, bw = (_round_bf16(t) for t in assembly_weights(bucket, False,
                                                               dev))
            nnz = int(((aw != 0) | (bw != 0)).sum())
            Yg = Y[cols.long()].float()
            t_k = time_ms(lambda: als_cuda.assemble_normal_equations(
                Y, cols, aw, bw, gram), 3)
            t_p = time_ms(lambda: als_cuda.assemble_normal_equations_plain(
                Y, cols, aw, bw, gram), 1)
            t_l = time_ms(lambda: torch.einsum("bl,blr,bls->brs", aw, Yg,
                                               Yg), 1)
            del Yg
            work = assembly_work(B, L, nnz, Y.shape[0], y_bytes=2)
            b_ms, b_by = bound_of(*work)
            rows.append({"side": side_name, "B": B, "L": L, "slots": nnz,
                         "work": work, "ms": t_k, "plain_ms": t_p,
                         "library_ms": t_l, "bound_ms": b_ms,
                         "bound_by": b_by})
            print(f"[time] assemble bf16 {side_name:>4} B={B:<6} L={L:<6} "
                  f"kernel {t_k!r} ms  plain {t_p!r} ms  library {t_l!r} ms "
                  f" bound {b_ms!r} ms ({b_by})")
    b_ms, b_by = bound_of(sum(r["work"][0] for r in rows),
                          sum(r["work"][1] for r in rows))
    head = {key: sum(r[key] for r in rows)
            for key in ("ms", "plain_ms", "library_ms")}
    head.update(bound_ms=b_ms, bound_by=b_by)
    print(f"[time] assemble_normal_equations bf16 route over one "
          f"iteration's work: kernel {head['ms']!r} ms, plain "
          f"{head['plain_ms']!r} ms, library {head['library_ms']!r} ms, "
          f"bound {b_ms!r} ms ({b_by})")
    return {"rows": rows, "head": head}


def foldin_timings(dev, trained: dict) -> dict:
    """The two training kernels at the fold-in solve's shapes (B, L) in
    ``FOLD_TIMED``, R=64, against the trained item factors: each against
    its bound, its plain version and one library call (``torch.einsum``
    over the pre-gathered rows for the assembly; ``torch.linalg.
    cholesky`` then ``cholesky_solve`` for the solve). The assembly's
    bound counts the item rows the fold gathers, the distinct items of
    the real slots (padding slots carry weight 0), not the whole table."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    rng = np.random.default_rng(FOLD_TIMED[-1][2])
    Y = torch.from_numpy(trained["model"].item_factors).to(dev)
    M, R = Y.shape
    gram = Y.T @ Y + LAMBDA * torch.eye(R, device=dev)
    out = {"assemble_normal_equations": [], "spd_solve": []}
    for B, real, L in FOLD_TIMED:
        cols, aw, bw = fold_rows(dev, rng, B, real, L)
        real_slots = (aw != 0) | (bw != 0)
        nnz = int(real_slots.sum())
        gathered = min(M, int(cols[real_slots].unique().numel()))
        Yg = Y[cols.long()]

        def kernel():
            return als_cuda.assemble_normal_equations(Y, cols, aw, bw, gram)

        t_k = time_ms(kernel, 20)
        t_p = time_ms(lambda: als_cuda.assemble_normal_equations_plain(
            Y, cols, aw, bw, gram), 5)
        t_l = time_ms(lambda: torch.einsum("bl,blr,bls->brs", aw, Yg, Yg),
                      5)
        nbytes, ops = assembly_work(B, L, nnz, gathered, R)
        b_ms, b_by = bound_of(nbytes, ops)
        out["assemble_normal_equations"].append({
            "B": B, "real_rows": real, "L": L, "slots": nnz,
            "rows_gathered": gathered, "ms": t_k,
            "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
            "bound_by": b_by})
        A, b = kernel()
        s_k = time_ms(lambda: als_cuda.spd_solve(A, b), 20)
        s_p = time_ms(lambda: als_cuda.spd_solve_plain(A, b), 3)
        s_l = time_ms(lambda: torch.cholesky_solve(
            b[:, :, None], torch.linalg.cholesky(A)), 5)
        sb_ms, sb_by = bound_of(*solve_work(B, R))
        out["spd_solve"].append({
            "B": B, "real_rows": real, "ms": s_k, "plain_ms": s_p,
            "library_ms": s_l, "bound_ms": sb_ms, "bound_by": sb_by})
        print(f"[time] fold B={B:<4} ({real} real, {gathered} rows) "
              f"L={L:<5}: assemble kernel "
              f"{t_k!r} ms  plain {t_p!r} ms  library {t_l!r} ms  bound "
              f"{b_ms!r} ms ({b_by}); spd_solve kernel {s_k!r} ms  plain "
              f"{s_p!r} ms  library {s_l!r} ms  bound {sb_ms!r} ms "
              f"({sb_by})")
        del Yg, A, b
    return out


def large_rank_timings(dev) -> dict:
    """Off the main path, recorded and not judged: the device-memory
    solve at rank 320 (4,096 systems) and the large-rank assembly at rank
    256 (4,096 synthetic rows of 128 slots)."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    out = {}
    R, B = 320, 4096
    G = torch.randn((B, R, R), device=dev,
                    generator=torch.Generator(dev).manual_seed(R))
    A = G @ G.transpose(1, 2) / R + torch.eye(R, device=dev)
    b = torch.randn((B, R), device=dev)
    del G
    t_k = time_ms(lambda: als_cuda.spd_solve(A, b), 3)
    t_p = time_ms(lambda: als_cuda.spd_solve_plain(A, b), 1)
    t_l = time_ms(lambda: torch.cholesky_solve(
        b[:, :, None], torch.linalg.cholesky(A)), 3)
    b_ms, b_by = bound_of(*solve_work(B, R))
    out["spd_solve"] = {"route": "device", "R": R, "B": B, "ms": t_k,
                        "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
                        "bound_by": b_by}
    print(f"[time] spd_solve device route R={R} B={B}: kernel {t_k!r} ms  "
          f"plain {t_p!r} ms  library {t_l!r} ms  bound {b_ms!r} ms ({b_by})")
    del A, b

    R, B, L = 256, 4096, 128
    rng = np.random.default_rng(R)
    Y = torch.from_numpy(0.3 * rng.standard_normal((M_ITEMS, R)).astype(
        np.float32)).to(dev)
    gram = Y.T @ Y + LAMBDA * torch.eye(R, device=dev)
    (cols, aw, bw, _), = synthetic_rows(dev, rng, ((B, L),))
    nnz = int(((aw != 0) | (bw != 0)).sum())
    Yg = Y[cols.long()]
    awYg = (aw[:, :, None] * Yg).transpose(1, 2)
    t_k = time_ms(lambda: als_cuda.assemble_normal_equations(
        Y, cols, aw, bw, gram), 3)
    t_p = time_ms(lambda: als_cuda.assemble_normal_equations_plain(
        Y, cols, aw, bw, gram), 1)
    t_l = time_ms(lambda: torch.bmm(awYg, Yg), 3)
    b_ms, b_by = bound_of(*assembly_work(B, L, nnz, M_ITEMS, R))
    out["assemble_normal_equations"] = {
        "route": "large_rank", "R": R, "B": B, "L": L, "slots": nnz,
        "ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
        "bound_by": b_by}
    print(f"[time] assemble large-rank route R={R} B={B} L={L}: kernel "
          f"{t_k!r} ms  plain {t_p!r} ms  library {t_l!r} ms  bound "
          f"{b_ms!r} ms ({b_by})")
    return out


# -- phase 6: the lifecycle from the event store ---------------------------------

# MovieLens-1M's published size
ML1M_USERS, ML1M_ITEMS, ML1M_RATINGS = 6_040, 3_706, 1_000_209
ML1M_BLOCK = 250_000    # the streaming read's block: 5 blocks, 5 runs
PORT_FACTORY = ("predictionio_tpu_torch.templates.recommendation.engine:"
                "engine_factory")


def ml1m_ratings(seed: int):
    """1,000,209 ratings of 6,040 users x 3,706 items, built like
    ``ml20m_ratings``: lognormal row lengths (mean ~165.6) clipped to
    MovieLens-1M's 20-2,314 ratings per user and scaled to the exact
    total; each user's distinct items by the same power-law popularity,
    drawn without replacement (a Gumbel top-k, so even the heaviest
    user gets all 2,314 from 3,706 items); 0.5-5.0 stars; 1-3 genres per
    item."""
    rng = np.random.default_rng(seed)
    raw = rng.lognormal(4.6, 0.95, ML1M_USERS)
    lens = np.clip(np.round(raw * ML1M_RATINGS / raw.sum()), 20,
                   2_314).astype(np.int64)
    step = 1 if lens.sum() < ML1M_RATINGS else -1
    order = np.argsort(lens, kind="stable")[::-1]
    j = 0
    while lens.sum() != ML1M_RATINGS:   # spread the rounding's remainder
        u = order[j % len(order)]
        if 20 <= lens[u] + step <= 2_314:
            lens[u] += step
        j += 1
    log_pop = -0.8 * np.log(np.arange(ML1M_ITEMS) + 10.0)
    keys = log_pop + rng.gumbel(size=(len(lens), ML1M_ITEMS))
    ranked = np.argsort(-keys, axis=1, kind="stable")
    take = np.arange(ML1M_ITEMS)[None, :] < lens[:, None]
    rows = np.repeat(np.arange(len(lens)), lens)
    cols = ranked[take]
    return (rows, cols) + stars_and_genres(rng, len(rows), ML1M_ITEMS)


def write_events(seed: int, app_id: int) -> dict:
    """The ratings as ``rate`` events: 1,000,209 rows through
    ``insert_raw_batch`` in 100,000-row chunks, 1,000 more through
    ``insert_batch``, and one ``$set`` of categories per item."""
    import datetime as dt

    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.event import Event

    rows, cols, values, cats = ml1m_ratings(seed)
    levents = storage.get_levents()
    levents.init(app_id)
    t0 = time.perf_counter()
    base = dt.datetime(2003, 2, 28, tzinfo=dt.timezone.utc).timestamp()
    users, items, stars = rows.tolist(), cols.tolist(), values.tolist()
    for a in range(0, len(users), 100_000):
        b = min(a + 100_000, len(users))
        levents.insert_raw_batch([
            (f"ev{j}", "rate", "user", f"u{users[j]}", "item",
             f"i{items[j]}", f'{{"rating": {stars[j]!r}}}', base + j, "[]",
             None, base + j) for j in range(a, b)], app_id)
    raw_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 7)
    when = dt.datetime(2003, 3, 1, tzinfo=dt.timezone.utc)
    extra = [Event(event="rate", entity_type="user",
                   entity_id=f"u{rng.integers(0, ML1M_USERS)}",
                   target_entity_type="item",
                   target_entity_id=f"i{rng.integers(0, ML1M_ITEMS)}",
                   properties={"rating": float(rng.integers(1, 11) * 0.5)},
                   event_time=when) for _ in range(1_000)]
    levents.insert_batch(extra, app_id)
    levents.insert_batch([
        Event(event="$set", entity_type="item", entity_id=iid,
              properties={"categories": list(c)}, event_time=when)
        for iid, c in cats.items()], app_id)
    return {"ratings": len(rows) + len(extra), "raw_s": raw_s,
            "write_s": time.perf_counter() - t0}


def lifecycle_engine():
    """The template's engine with each stage timed, and each stage's
    output kept: the training data, the prepared layouts, and the
    trained model for the comparison with the deployed one."""
    from predictionio_tpu_torch.controller import Engine
    from predictionio_tpu_torch.templates.recommendation import engine as eng

    record: dict = {}

    def timed(cls, method, label):
        def run(self, *args):
            t0 = time.perf_counter()
            out = getattr(cls, method)(self, *args)
            record[label] = time.perf_counter() - t0
            record["model" if label == "train" else label + "_out"] = out
            return out
        return type(cls.__name__, (cls,), {method: run})

    base = eng.engine_factory()
    return Engine(timed(eng.EventDataSource, "read_training", "read"),
                  timed(eng.RatingsPreparator, "prepare", "prepare"),
                  {"als": timed(eng.ALSAlgorithm, "train", "train")},
                  base.serving_class_map), record


def lifecycle_variant(seed: int) -> dict:
    return {"id": "ml1m", "engineFactory": PORT_FACTORY,
            "datasource": {"params": {"appName": "MovieLens1M",
                                      "streamingBlockSize": ML1M_BLOCK,
                                      "readItemCategories": True}},
            "preparator": {"params": {"bucketed": True}},
            "algorithms": [{"name": "als", "params": {
                "rank": RANK, "numIterations": ITERATIONS,
                "lambda": LAMBDA, "alpha": ALPHA, "seed": seed}}]}


def train_instance(seed: int) -> dict:
    """``create_workflow`` over the store; the instance must complete,
    its blob be stored, and both training kernels and the native merge
    run."""
    import torch

    from predictionio_tpu_torch.core.context import ComputeContext
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.native import codec
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.workflow import core_workflow
    from predictionio_tpu_torch.workflow.create_workflow import (
        WorkflowConfig,
        create_workflow,
    )

    engine, record = lifecycle_engine()
    models = storage.get_model_data_models()
    persist = {"s": 0.0}

    def timed(fn):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                persist["s"] += time.perf_counter() - t0
        return run

    saved = (core_workflow.serialize_models, models.insert)
    core_workflow.serialize_models = timed(saved[0])
    models.insert = timed(saved[1])
    for counter in (als_cuda.assemble_launches, als_cuda.spd_launches,
                    codec.merge_calls, codec.fill_calls):
        counter.reset()
    t0 = time.perf_counter()
    try:
        iid = create_workflow(
            WorkflowConfig(engine_id="ml1m", engine_factory=PORT_FACTORY,
                           engine_variant="ml1m.json"),
            lifecycle_variant(seed), engine=engine, ctx=ComputeContext())
    finally:
        core_workflow.serialize_models, models.insert = saved
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"assemble_normal_equations": als_cuda.assemble_launches.value,
                "spd_solve": als_cuda.spd_launches.value,
                "merge_sorted_runs": codec.merge_calls.value,
                "bucket_fill": codec.fill_calls.value}
    instance = storage.get_metadata_engine_instances().get(iid)
    if instance is None or instance.status != "COMPLETED":
        raise AssertionError(f"engine instance {iid}: {instance}")
    if models.get(iid) is None:
        raise AssertionError(f"no model blob stored for {iid}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was never called training {iid}")
    return {"id": iid, "instance": instance, "model": record["model"],
            "launches": launches, "seconds": {
                "read": record["read"], "prepare": record["prepare"],
                "train": record["train"], "persist": persist["s"],
                "create_workflow": total}}


def lifecycle_queries(seed: int) -> list:
    """40 user, 4 item-similarity, 4 category and 2 unknown-user
    queries."""
    rng = np.random.default_rng(seed + 5)
    users = [f"u{u}" for u in rng.integers(0, ML1M_USERS, 44)]
    queries = [{"user": u, "num": 10} for u in users[:40]]
    queries += [{"items": [f"i{i}" for i in rng.integers(0, ML1M_ITEMS, n)],
                 "num": 10} for n in (1, 2, 3, 5)]
    queries += [{"user": users[40], "num": 10, "categories": ["g3"]},
                {"user": users[41], "num": 5, "categories": ["g7", "g11"]},
                {"user": users[42], "num": 10, "categories": ["g0"],
                 "blacklist": ["i1", "i2"]},
                {"user": users[43], "num": 20, "categories": ["g19"]}]
    queries += [{"user": "no-such-user", "num": 10},
                {"user": "nobody-either", "num": 3}]
    return queries


def in_process_answers(model, queries: list) -> list:
    from predictionio_tpu_torch.templates.recommendation.engine import (
        engine_factory,
    )
    from predictionio_tpu_torch.workflow.create_server import (
        deployment_from_models,
        query_from_json,
        serve_query,
        to_jsonable,
    )

    engine = engine_factory()
    params = engine.engine_params_from_variant(lifecycle_variant(0))
    dep = deployment_from_models(engine, params, [model])
    qc = dep.algorithms[0].query_class
    return [to_jsonable(serve_query(dep, query_from_json(q, qc)))
            for q in queries]


def serve_child(store: str) -> int:
    """``--serve-store``: the second process of phase 6. Deploy the latest
    completed ``ml1m`` instance from the sqlite file (a fresh process:
    nothing of the trainer's state), print the address, serve until
    ``POST /stop``, then print the top-k kernel's launches."""
    import os

    os.environ["PIO_STORAGE_SOURCES_LC_TYPE"] = "sqlite"
    os.environ["PIO_STORAGE_SOURCES_LC_PATH"] = store
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.workflow.create_server import (
        QueryServer,
        ServerConfig,
        build_deployment,
        resolve_engine_instance,
    )

    storage.reset()
    als_cuda.launches.reset()
    t0 = time.perf_counter()
    config = ServerConfig(ip="127.0.0.1", port=0, engine_id="ml1m",
                          engine_variant="ml1m.json")
    instance = resolve_engine_instance(None, config.engine_id,
                                       config.engine_version,
                                       config.engine_variant)
    server = QueryServer(config, build_deployment(instance)).start()
    print(json.dumps({"address": server.address, "instance": instance.id,
                      "deploy_s": time.perf_counter() - t0}), flush=True)
    while server._httpd is not None:
        time.sleep(0.05)
    print(json.dumps({"launches": als_cuda.launches.value,
                      "by_key": [[list(k), n] for k, n in
                                 sorted(als_cuda.launches.by_key().items())]}),
          flush=True)
    return 0


def lifecycle(seed: int) -> dict:
    """Phase 6: events -> engine instance -> stored model -> deploy in a
    second process -> ``/reload``, at MovieLens-1M's size."""
    import os
    import tempfile

    work = tempfile.mkdtemp(prefix="pio-lifecycle-")
    store = os.path.join(work, "pio.db")
    # the port's registry reads PIO_STORAGE_* once, at its first use
    os.environ["PIO_STORAGE_SOURCES_LC_TYPE"] = "sqlite"
    os.environ["PIO_STORAGE_SOURCES_LC_PATH"] = store
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.storage.base import AccessKey, App

    storage.reset()
    child = None
    try:
        app_id = storage.get_metadata_apps().insert(App(0, "MovieLens1M"))
        key = storage.get_metadata_access_keys().insert(
            AccessKey("", app_id, ()))
        wrote = write_events(seed, app_id)
        print(f"[lifecycle] app {app_id} (key {key[:6]}...), "
              f"{wrote['ratings']} rate events and {ML1M_ITEMS} $set events "
              f"written in {wrote['write_s']:.2f} s "
              f"({wrote['raw_s']:.2f} s through insert_raw_batch)")
        first = train_instance(seed)
        print(f"[lifecycle] instance {first['id']} COMPLETED: "
              f"{json.dumps(first['seconds'])} s; calls "
              f"{first['launches']}")
        queries = lifecycle_queries(seed)
        want = in_process_answers(first["model"], queries)

        child = subprocess.Popen(
            [sys.executable, __file__, "--serve-store", store],
            stdout=subprocess.PIPE, text=True)
        hello = read_line(child, timeout=300)
        if hello.get("instance") != first["id"]:
            raise AssertionError(f"second process deployed {hello}")
        base = "http://{}:{}".format(*hello["address"])
        t0 = time.perf_counter()
        got = [post(base + "/queries.json", q) for q in queries]
        first_answer = got[0][2]
        bad = [(q, g[:2]) for q, g, w in zip(queries, got, want)
               if g[0] != 200 or g[1] != w]
        if bad:
            raise AssertionError(f"{len(bad)} answers of the second process "
                                 f"differ from the trained model's: "
                                 f"{bad[:3]}")
        print(f"[lifecycle] second process deployed {first['id']} in "
              f"{hello['deploy_s']:.2f} s; first answer {first_answer!r} s; "
              f"{len(got)} answers equal the in-process model's in "
              f"{time.perf_counter() - t0:.2f} s")

        second = train_instance(seed + 1)
        print(f"[lifecycle] instance {second['id']} COMPLETED: "
              f"{json.dumps(second['seconds'])} s")
        want2 = in_process_answers(second["model"], queries)
        statuses, stop = [], threading.Event()

        def client():
            j = 0
            while not stop.is_set():
                try:
                    statuses.append(post(base + "/queries.json",
                                         queries[j % 40])[0])
                except Exception as e:  # counted as a failed query
                    statuses.append(repr(e))
                j += 1

        clients = [threading.Thread(target=client) for _ in range(8)]
        for c in clients:
            c.start()
        time.sleep(0.5)
        t1 = time.perf_counter()
        status, reply, _ = post(base + "/reload", {})
        reload_s = time.perf_counter() - t1
        time.sleep(0.5)
        stop.set()
        for c in clients:
            c.join(timeout=120)
        failed = [x for x in statuses if x != 200]
        if status != 200 or (reply.get("swappedFrom"),
                             reply.get("swappedTo")) != (first["id"],
                                                         second["id"]):
            raise AssertionError(f"reload answered {status} {reply}")
        if failed or not statuses:
            raise AssertionError(f"{len(failed)} of {len(statuses)} queries "
                                 f"failed during the reload: {failed[:3]}")
        after = [post(base + "/queries.json", q) for q in queries]
        bad = [q for q, g, w in zip(queries, after, want2)
               if g[0] != 200 or g[1] != w]
        if bad or want2 == want:
            raise AssertionError(f"after the reload {len(bad)} answers "
                                 f"differ from the second model's: {bad[:3]}")
        storage.get_metadata_engine_instances().delete(second["id"])
        down = post_status(base + "/reload")
        if down != 409:
            raise AssertionError(f"a reload to the older instance answered "
                                 f"{down}, not 409")
        post(base + "/stop", {})
        counts = read_line(child, timeout=120)
        child.wait(timeout=60)
        if counts["launches"] == 0:
            raise AssertionError("the second process never launched the "
                                 "top-k kernel")
        print(f"[lifecycle] reload {first['id']} -> {second['id']} in "
              f"{reload_s:.2f} s under 8 clients ({len(statuses)} queries, "
              f"none failed); {len(after)} answers equal the second model's;"
              f" the older instance refused with 409; top-k launches in the "
              f"second process {counts['launches']}: {counts['by_key']}")
        return {"instances": [first["id"], second["id"]],
                "write_s": wrote["write_s"],
                "train_s": [first["seconds"], second["seconds"]],
                "deploy_s": hello["deploy_s"], "first_answer_s": first_answer,
                "reload_s": reload_s, "queries_during_reload": len(statuses),
                "child_launches": counts["launches"],
                "first_factors": factors_by_id(first["model"])}
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait(timeout=60)
        storage.reset()
        shutil.rmtree(work, ignore_errors=True)


def read_line(proc, timeout: float, raw: bool = False):
    """The next line ``proc`` prints (parsed as JSON unless ``raw``),
    waiting at most ``timeout`` seconds."""
    import queue

    box: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: box.put(proc.stdout.readline()),
                     daemon=True).start()
    try:
        line = box.get(timeout=timeout)
    except queue.Empty:
        raise AssertionError(f"no line from the second process in "
                             f"{timeout} s") from None
    if not line:
        raise AssertionError(f"the second process ended (exit "
                             f"{proc.wait(timeout=60)}) without a line")
    return line if raw else json.loads(line)


def post_status(url: str) -> int:
    try:
        return post(url, {})[0]
    except urllib.error.HTTPError as e:
        return e.code


# -- phase 6b: the quick start through the console --------------------------------

QS_APP = "ML1M"
QS_SINGLES = 100        # view events, one POST /events.json each
QS_BATCH = 50           # events per POST /batch/events.json (the cap)
QS_CLIENTS = 8
CONSOLE = [sys.executable, "-m", "predictionio_tpu_torch.tools.console"]


def factors_by_id(model) -> dict:
    """Each side's factors keyed by entity id: side -> (sorted ids,
    rows in that order)."""
    out = {}
    for side, bimap, X in (("user", model.user_map, model.user_factors),
                           ("item", model.item_map, model.item_factors)):
        labels = np.asarray(bimap.labels)
        order = np.argsort(labels)
        out[side] = (labels[order], np.asarray(X, dtype=np.float32)[order])
    return out


def console_env(store: str) -> dict:
    """The children's environment: the checkout importable, and one
    sqlite source for every repository (no other PIO_STORAGE_*)."""
    import os

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    env["PIO_STORAGE_SOURCES_QS_TYPE"] = "sqlite"
    env["PIO_STORAGE_SOURCES_QS_PATH"] = store
    return env


def pio(args: list, env: dict, cwd: str, timeout: float = 600) -> tuple:
    """One ``pio`` verb as a subprocess; (stdout, seconds). A non-zero
    exit raises with the verb's stderr."""
    t0 = time.perf_counter()
    proc = subprocess.run(CONSOLE + args, env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)
    took = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"pio {' '.join(args)} exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout, took


def pio_child(args: list, env: dict, cwd: str, ready: str,
              timeout: float = 300) -> tuple:
    """A long-running ``pio`` verb; (process, base URL, seconds until it
    printed ``<ready> <its address>``)."""
    import re

    t0 = time.perf_counter()
    proc = subprocess.Popen(CONSOLE + args, env=env, cwd=cwd,
                            stdout=subprocess.PIPE, text=True)
    line = read_line(proc, timeout, raw=True)
    found = re.search(ready + r" (http://[0-9.]+:\d+)", line)
    if found is None:
        proc.kill()
        raise AssertionError(f"pio {args[0]} printed {line!r}")
    return proc, found.group(1), time.perf_counter() - t0


def qs_ratings_jsonl(path: str, ratings: tuple) -> int:
    """Phase 6's 1,000,209 ratings as a JSONL file in ``pio export``'s
    format (``Event.to_json``: sorted keys, ids ``ev<j>``, event and
    creation time ``base + j`` seconds)."""
    import datetime as dt

    from predictionio_tpu_torch.data.event import Event

    rows, cols, values, _ = ratings
    base = int(dt.datetime(2003, 2, 28, tzinfo=dt.timezone.utc).timestamp())
    times = np.datetime_as_string(
        (base + np.arange(len(rows))).astype("datetime64[s]")).tolist()
    line = ('{"creationTime": "%s+00:00", "entityId": "u%d", '
            '"entityType": "user", "event": "rate", "eventId": "ev%d", '
            '"eventTime": "%s+00:00", "properties": {"rating": %r}, '
            '"targetEntityId": "i%d", "targetEntityType": "item"}\n')
    users = rows.tolist()
    with open(path, "w", encoding="utf-8") as f:
        f.writelines(line % (t, u, j, t, r, i) for j, (t, u, r, i) in
                     enumerate(zip(times, users, values.tolist(),
                                   cols.tolist())))
    with open(path, encoding="utf-8") as f:
        head = [f.readline() for _ in range(3)]
    for text in head:   # the template is the export format, byte for byte
        if Event.from_json(text).to_json() + "\n" != text:
            raise AssertionError(f"not the export format: {text!r}")
    return len(users)


def qs_front_door_events(seed: int, ratings: tuple) -> tuple:
    """Phase 6's 1,000 extra ``rate`` and 3,706 ``$set`` events as event
    JSON, and 100 ``view`` events (read by no training: the template
    reads ``rate``)."""
    import datetime as dt

    cats = ratings[3]
    rng = np.random.default_rng(seed + 7)   # phase 6's draws, in order
    when = dt.datetime(2003, 3, 1, tzinfo=dt.timezone.utc).isoformat()
    extra = [{"event": "rate", "entityType": "user",
              "entityId": f"u{rng.integers(0, ML1M_USERS)}",
              "targetEntityType": "item",
              "targetEntityId": f"i{rng.integers(0, ML1M_ITEMS)}",
              "properties": {"rating": float(rng.integers(1, 11) * 0.5)},
              "eventTime": when} for _ in range(1_000)]
    sets = [{"event": "$set", "entityType": "item", "entityId": iid,
             "properties": {"categories": list(c)}, "eventTime": when}
            for iid, c in cats.items()]
    views = [{"event": "view", "entityType": "user", "entityId": f"u{j}",
              "targetEntityType": "item", "targetEntityId": f"i{j}",
              "eventTime": when} for j in range(QS_SINGLES)]
    return extra + sets, views


def qs_event_server(base: str, key: str, batch_events: list,
                    singles: list) -> dict:
    """The batch events, 50 a request from 8 client threads, then the
    singles one request each; every item must answer 201."""
    url = f"{base}/batch/events.json?accessKey={key}"
    chunks = [batch_events[a:a + QS_BATCH]
              for a in range(0, len(batch_events), QS_BATCH)]
    latencies, bad = [], []

    def client(mine):
        for chunk in mine:
            t = time.perf_counter()
            try:
                status, items, _ = post(url, chunk)
            except Exception as e:  # reported below; the phase then fails
                bad.append(repr(e))
                continue
            latencies.append(time.perf_counter() - t)
            if status != 200:
                bad.append(status)
            bad.extend(x for x in items if x.get("status") != 201)

    threads = [threading.Thread(target=client,
                                args=(chunks[c::QS_CLIENTS],))
               for c in range(QS_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    batch_s = time.perf_counter() - t0
    if bad or len(latencies) != len(chunks):
        raise AssertionError(f"{len(bad)} batch items refused, "
                             f"{len(latencies)}/{len(chunks)} requests "
                             f"answered: {bad[:3]}")
    t1 = time.perf_counter()
    for ev in singles:
        status, reply, _ = post(f"{base}/events.json?accessKey={key}", ev)
        if status != 201:
            raise AssertionError(f"POST /events.json answered {status} "
                                 f"{reply}")
    singles_s = time.perf_counter() - t1
    ms = np.asarray(latencies) * 1e3
    return {"batch_events": len(batch_events), "requests": len(chunks),
            "batch_s": batch_s,
            "batch_events_per_s": len(batch_events) / batch_s,
            "batch_p50_ms": float(np.percentile(ms, 50)),
            "batch_p99_ms": float(np.percentile(ms, 99)),
            "singles": len(singles), "singles_s": singles_s,
            "singles_events_per_s": len(singles) / singles_s}


def dase_seconds(trace_dir: str) -> dict:
    """Read, prepare and train seconds of the ``pio.train`` trace the
    child exported."""
    from predictionio_tpu_torch.utils import tracing

    roots = [r for r in tracing.load_traces_from_dir(trace_dir)
             if r.get("root") == "pio.train"]
    if len(roots) != 1:
        raise AssertionError(f"{len(roots)} pio.train traces in "
                             f"{trace_dir}")
    out = {sp["name"][len("dase."):]: sp["durationSec"]
           for sp in roots[0]["spans"]
           if sp["name"] in ("dase.read", "dase.prepare", "dase.train")}
    if len(out) != 3:
        raise AssertionError(f"the trace holds dase spans {sorted(out)}")
    return out


def launches_line(stdout: str) -> dict:
    """The kernel launches a ``pio train`` or ``pio deploy`` child
    printed (its wrappers' counts)."""
    head = "[INFO] Kernel launches: "
    for line in stdout.splitlines():
        if line.startswith(head):
            return json.loads(line[len(head):])
    raise AssertionError(f"no kernel launch line in {stdout[-500:]!r}")


def qs_engine(work: str, env: dict, key: str, seed: int) -> dict:
    """``pio accesskey list``, ``pio template get recommendation`` with
    phase 6's variant written into its ``engine.json``, then ``pio
    build``; the seconds of each verb's process."""
    import os

    took = {}
    listed, took["accesskey list"] = pio(["accesskey", "list"], env, work)
    if key not in listed:
        raise AssertionError(f"pio accesskey list: {listed!r}")
    eng = os.path.join(work, "eng")
    _, took["template get"] = pio(["template", "get", "recommendation", eng],
                                  env, work)
    variant_path = os.path.join(eng, "engine.json")
    with open(variant_path, encoding="utf-8") as f:
        variant = json.load(f)
    want = lifecycle_variant(seed)
    want["datasource"]["params"]["appName"] = QS_APP
    for stage in ("datasource", "preparator", "algorithms"):
        variant[stage] = want[stage]
    with open(variant_path, "w", encoding="utf-8") as f:
        json.dump(variant, f)
    _, took["build"] = pio(["build"], env, eng)
    return took


def instance_factors(iid: str) -> tuple:
    """The factors of engine instance ``iid``'s stored model (the
    registry already points at the quick start's store)."""
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.workflow.core_workflow import (
        deserialize_models,
    )

    model = deserialize_models(
        storage.get_model_data_models().get(iid).models)[0]
    return model.user_factors, model.item_factors


def qs_kill_and_resume(work: str, eng: str, env: dict, steps: dict) -> dict:
    """Phase 6b's crash pair through the console: ``pio train --precision
    bf16 --checkpoint-dir D --checkpoint-every 1`` with each save held
    ``KILL_SAVE_DELAY_S`` (``PIO_FAULTS`` slow), killed with SIGKILL once
    its second checkpoint lands, then the same with ``--resume``: its
    factors must be bitwise equal to an uninterrupted ``pio train
    --precision bf16`` of the same store and variant, and ``pio runs
    list`` / ``show`` must print one run whose steps rise to
    ``ITERATIONS``."""
    import os
    import re
    import signal

    from predictionio_tpu_torch.workflow import runlog

    ck = os.path.join(work, "ckpt")
    opts = ["--precision", "bf16", "--checkpoint-dir", ck,
            "--checkpoint-every", "1"]
    said, steps["train bf16"] = pio(["train", "--precision", "bf16"], env,
                                    eng)
    ref = instance_factors(re.search(r"Engine instance ID: (\S+)",
                                     said).group(1))
    t = time.perf_counter()
    child = subprocess.Popen(
        CONSOLE + ["train"] + opts, cwd=eng, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True, env=dict(
            env, PIO_FAULTS=f"backend=checkpoint,op=save,kind=slow,"
                            f"delay={KILL_SAVE_DELAY_S}"))
    try:
        second = os.path.join(ck, "ckpt-00000002.json")
        while not os.path.exists(second):
            if child.poll() is not None or time.perf_counter() - t > 300:
                raise AssertionError(f"the checkpointed train ended "
                                     f"({child.poll()}) before its second "
                                     f"checkpoint: {child.stderr.read()}")
            time.sleep(0.02)
        if child.poll() is not None:
            raise AssertionError("the checkpointed train ended before its "
                                 "kill")
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60)
    steps["train killed after 2 checkpoints"] = time.perf_counter() - t
    said, steps["train --resume"] = pio(["train"] + opts + ["--resume"], env,
                                        eng)
    got = instance_factors(re.search(r"Engine instance ID: (\S+)",
                                     said).group(1))
    if not (np.array_equal(got[0], ref[0])
            and np.array_equal(got[1], ref[1])):
        raise AssertionError("the resumed instance's factors differ from the "
                             "uninterrupted bf16 training's")
    listed, _ = pio(["runs", "list", "--dir", ck], env, work)
    runs = runlog.list_runs(ck)
    if len(runs) != 1 or runs[0]["runId"] not in listed:
        raise AssertionError(f"pio runs list: {listed!r}")
    shown, _ = pio(["runs", "show", runs[0]["runId"], "--dir", ck], env, work)
    # monotone, ending at the last iteration: the kill may land between
    # a checkpoint's manifest and its run-log sample, so a step the
    # killed child checkpointed can lack its sample
    table = [int(line.split()[0]) for line in shown.splitlines()
             if re.match(r"\s+\d+\s+[-0-9.e+]+\s", line)]
    if not table or table != sorted(set(table)) or table[-1] != ITERATIONS:
        raise AssertionError(f"pio runs show: steps {table}: {shown!r}")
    print(f"[quickstart] pio train --precision bf16 --checkpoint-every 1 "
          f"killed (SIGKILL) after its 2nd checkpoint, resumed with "
          f"--resume: factors bitwise equal to an uninterrupted bf16 "
          f"training; pio runs list / show: one run "
          f"{runs[0]['runId']}, steps {table}")
    return {"run": runs[0]["runId"], "steps": table}


def quick_start(seed: int, cycle: dict, card: str,
                keep_store: bool = False) -> dict:
    """Phase 6b: PredictionIO's quick start through the port's console,
    each verb a subprocess, at phase 6's size, events and variant. The
    short verbs run beside the writing of the import file, and ``pio
    export`` (the store takes no more writes after the event server)
    beside the deployment's checks; every step's seconds are printed.
    With ``keep_store`` a run that passes leaves its directory and store
    for phase 6c (``out["kept"]``), which removes them."""
    import os
    import re
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.workflow.create_server import (
        build_deployment,
        resolve_engine_instance,
    )

    work = tempfile.mkdtemp(prefix="pio-quickstart-")
    store = os.path.join(work, "pio.db")
    eng = os.path.join(work, "eng")
    env = console_env(store)
    env["PIO_PROFILE_DIR"] = os.path.join(work, "profiles")
    children = []
    steps: dict = {}    # step -> seconds, printed at the end
    out: dict = {"steps": steps}
    try:
        said, steps["app new"] = pio(["app", "new", QS_APP], env, work)
        key = re.search(r"Access Key: (\S+)", said).group(1)

        # the ratings go in first, as in phase 6: the streaming read takes
        # the store in its storage order, which fixes the index each id
        # gets, and so each factor's initial value
        with ThreadPoolExecutor(1) as pool:
            verbs = pool.submit(qs_engine, work, env, key, seed)
            t = time.perf_counter()
            ratings = ml1m_ratings(seed)
            steps["ratings draw"] = time.perf_counter() - t
            jsonl = os.path.join(work, "ratings.jsonl")
            t = time.perf_counter()
            n_import = qs_ratings_jsonl(jsonl, ratings)
            steps["JSONL write"] = time.perf_counter() - t
            t = time.perf_counter()
            steps.update(verbs.result())
            steps["short verbs' wait"] = time.perf_counter() - t
        said, import_s = pio(["import", "--app-name", QS_APP, "--input",
                              jsonl], env, work)
        steps["import"] = import_s
        if f"({n_import} events)" not in said:
            raise AssertionError(f"pio import said {said!r}")
        out["import"] = {"events": n_import, "s": import_s,
                         "events_per_s": n_import / import_s}
        print(f"[quickstart] pio import: {n_import} events in "
              f"{import_s!r} s, {n_import / import_s!r} events/s "
              f"(the process's start included; {card})")

        es, es_base, steps["eventserver ready"] = pio_child(
            ["eventserver", "--ip", "127.0.0.1", "--port", "0"], env, work,
            "Event Server is ready at")
        children.append(es)
        batch_events, singles = qs_front_door_events(seed, ratings)
        e = out["event_server"] = qs_event_server(es_base, key,
                                                  batch_events, singles)
        steps["event server batches"] = e["batch_s"]
        steps["event server singles"] = e["singles_s"]
        t = time.perf_counter()
        es.terminate()
        es.wait(timeout=60)
        steps["eventserver stop"] = time.perf_counter() - t
        print(f"[quickstart] event server: {e['batch_events']} events in "
              f"{e['requests']} batch requests from {QS_CLIENTS} clients, "
              f"{e['batch_events_per_s']!r} events/s, batch request p50 "
              f"{e['batch_p50_ms']!r} ms p99 {e['batch_p99_ms']!r} ms; "
              f"{e['singles']} single posts at "
              f"{e['singles_events_per_s']!r} events/s ({card})")

        trace_dir = os.path.join(work, "traces")
        said, train_s = pio(["train", "--trace-dir", trace_dir], env, eng)
        steps["train"] = train_s
        iid = re.search(r"Engine instance ID: (\S+)", said).group(1)
        launched = launches_line(said)
        if not all(launched.values()):
            raise AssertionError(f"pio train launched {launched}")
        stages = dase_seconds(trace_dir)
        out["train"] = {"instance": iid, "s": train_s, **stages,
                        "launches": launched}

        # the model from its own instance, loaded in this process
        t = time.perf_counter()
        storage.reset(storage.StorageConfig(
            {"QS": {"type": "sqlite", "path": store}},
            {r: "QS" for r in storage.REPOSITORIES}))
        instance = resolve_engine_instance(None, "default", "default",
                                           "engine.json")
        if instance.id != iid:
            raise AssertionError(f"latest instance {instance.id}, "
                                 f"trained {iid}")
        model = build_deployment(instance).models[0]
        steps["in-process load"] = time.perf_counter() - t
        mine, first = factors_by_id(model), cycle["first_factors"]
        dist = 0.0
        for side in ("user", "item"):
            if mine[side][0].tolist() != first[side][0].tolist():
                raise AssertionError(f"the {side} ids differ from phase 6's")
            dist = max(dist, float(np.abs(mine[side][1]
                                          - first[side][1]).max()))
        out["train"]["factor_distance"] = dist
        print(f"[quickstart] pio train {iid}: {train_s!r} s (process), "
              f"read {stages['read']!r} s, prepare {stages['prepare']!r} "
              f"s, train {stages['train']!r} s (dase spans); launches "
              f"{launched}; largest factor distance to phase 6's first "
              f"instance {dist!r} ({card})")
        if not dist <= 1e-3:
            raise AssertionError(f"the factors are {dist} from phase 6's")

        queries = lifecycle_queries(seed)
        t = time.perf_counter()
        want_answers = in_process_answers(model, queries)
        steps["in-process answers"] = time.perf_counter() - t
        dep, base, deploy_s = pio_child(
            ["deploy", "--ip", "127.0.0.1", "--port", "0"], env, eng,
            "Engine API is live at")
        children.append(dep)
        steps["deploy ready"] = deploy_s
        exported = os.path.join(work, "export.jsonl")
        t_export = time.perf_counter()
        export = subprocess.Popen(
            CONSOLE + ["export", "--app-name", QS_APP, "--output", exported],
            env=env, cwd=work, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        children.append(export)
        t = time.perf_counter()
        got = [post(base + "/queries.json", q) for q in queries]
        bad = [(q, g[:2]) for q, g, w in zip(queries, got, want_answers)
               if g[0] != 200 or g[1] != w]
        if bad:
            raise AssertionError(f"{len(bad)} deployed answers differ from "
                                 f"the instance's in-process answers: "
                                 f"{bad[:3]}")
        records = get_json(base + "/dispatches.json?limit=2048")
        timed = [r for r in records["dispatches"]
                 if r.get("deviceUs") is not None]
        if not timed:
            raise AssertionError(f"/dispatches.json holds no record with "
                                 f"CUDA-event time: {records['summary']}")
        steps["deployed queries"] = time.perf_counter() - t
        t = time.perf_counter()
        codes = [post_status(base + path) for path in
                 ("/profile/start", "/profile/stop", "/profile/stop")]
        if codes != [200, 200, 409]:
            raise AssertionError(f"/profile/start, stop, stop answered "
                                 f"{codes}")
        steps["profile start, stop, stop"] = time.perf_counter() - t
        port = base.rsplit(":", 1)[1]
        _, steps["undeploy"] = pio(["undeploy", "--ip", "127.0.0.1",
                                    "--port", port], env, eng)
        t = time.perf_counter()
        tail = dep.stdout.read()
        if dep.wait(timeout=60) != 0:
            raise AssertionError(f"pio deploy exited {dep.returncode}")
        steps["deploy exit"] = time.perf_counter() - t
        served = launches_line(tail)
        if not served["fused_gather_score_topk"]:
            raise AssertionError(f"pio deploy launched {served}")
        try:
            urllib.request.urlopen(base + "/", timeout=5)
        except urllib.error.URLError:
            pass
        else:
            raise AssertionError("the port still answers after undeploy")
        out["deploy"] = {"s": deploy_s, "queries": len(got),
                         "timed_records": len(timed), "launches": served}
        print(f"[quickstart] pio deploy ready in {deploy_s!r} s; "
              f"{len(got)} answers equal the instance's in-process "
              f"answers; {len(timed)} flight records with CUDA-event "
              f"time; /profile/start, stop, stop: {codes}; undeployed; "
              f"launches {served} ({card})")

        t = time.perf_counter()
        _, err = export.communicate(timeout=600)
        steps["export wait"] = time.perf_counter() - t
        export_s = time.perf_counter() - t_export
        if export.returncode != 0:
            raise AssertionError(f"pio export exited {export.returncode}: "
                                 f"{err[-2000:]}")
        with open(exported, "rb") as f:
            lines = sum(block.count(b"\n")
                        for block in iter(lambda: f.read(1 << 24), b""))
        written = n_import + len(batch_events) + len(singles)
        if lines != written:
            raise AssertionError(f"pio export wrote {lines} lines, "
                                 f"{written} events were written")
        out["export"] = {"lines": lines, "s": export_s}
        print(f"[quickstart] pio export: {lines} lines (the events "
              f"written) in {export_s!r} s, beside the deployment's "
              f"checks and undeploy")

        out["resume"] = qs_kill_and_resume(work, eng, env, steps)
        print("[quickstart] step seconds: " + ", ".join(
            f"{k} {v!r}" for k, v in steps.items()) + "; the short verbs "
            "ran beside the ratings draw and JSONL write, and export "
            "beside the deployed queries, profile, undeploy and deploy "
            "exit")
        if keep_store:
            out["kept"] = {"work": work, "store": store, "env": env}
        return out
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=60)
        storage.reset()
        if "kept" not in out:
            shutil.rmtree(work, ignore_errors=True)


# -- phase 6c: pio eval through the console at ML-1M ---------------------------------

# the grid the `pio eval --grid` child tunes: rank x lambda, GRID_ITERATIONS
# iterations, implicit, fp32
EVAL_GRID_RANKS, EVAL_GRID_LAMBDAS = (32, 64), (0.01, 0.1)


def ml1m_evaluation():
    """The Evaluation phase 6c's ``pio eval`` child loads
    (``chip_smoke:ml1m_evaluation``): the template's
    ``RecommendationEvaluation`` over phase 6b's app (its four param sets,
    Precision@10, ``best.json``), its engine swapped for a
    ``FastEvalEngine`` of the same classes, so the four param sets share
    one read of the sqlite store and one prepare."""
    from predictionio_tpu_torch.controller import FastEvalEngine
    from predictionio_tpu_torch.templates.recommendation.engine import (
        RecommendationEvaluation,
    )

    ev = RecommendationEvaluation(app_name=QS_APP, k=GRID_TOPK)
    e = ev.engine
    ev._engine = FastEvalEngine(e.data_source_class_map,
                                e.preparator_class_map,
                                e.algorithm_class_map, e.serving_class_map)
    return ev


def eval_scores_in_process(store: str) -> list:
    """Each param set of :func:`ml1m_evaluation`, trained in this process
    on the same read and prepare as the child's (the same factors, bit
    for bit), then scored by Precision@10 twice: with B1 serving the
    batch (the child's pipeline) and with its plain version in B1's
    place. Returns ``[(B1 score, plain score), ...]``."""
    from predictionio_tpu_torch.core.context import ComputeContext
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops import serving as serving_mod

    storage.reset(storage.StorageConfig(
        {"QS": {"type": "sqlite", "path": store}},
        {r: "QS" for r in storage.REPOSITORIES}))
    try:
        ev = ml1m_evaluation()
        engine, metric = ev.engine, ev.evaluator.metric
        ctx = ComputeContext()
        ep0 = ev.engine_params_list[0]
        ds = engine._make(engine.data_source_class_map,
                          *ep0.data_source_params, "datasource")
        prep = engine._make(engine.preparator_class_map,
                            *ep0.preparator_params, "preparator")
        [(td, ei, qa)] = ds.read_eval_base(ctx)
        pd = prep.prepare_base(ctx, td)
        queries = [(qx, q) for qx, (q, _a) in enumerate(qa)]
        out = []
        for ep in ev.engine_params_list:
            algo = engine._algorithms(ep)[0]
            model = algo.train_base(ctx, pd)
            scores = []
            for fn in (als_cuda.fused_gather_score_topk,
                       als_cuda.fused_gather_score_topk_plain):
                serving_mod.fused_gather_score_topk = fn
                try:
                    preds = dict(algo.batch_predict_base(ctx, model,
                                                         queries))
                finally:
                    serving_mod.fused_gather_score_topk = \
                        als_cuda.fused_gather_score_topk
                scores.append(metric.calculate(ctx, [(ei, [
                    (q, preds[qx], a) for qx, (q, a) in enumerate(qa)])]))
            out.append(tuple(scores))
        return out
    finally:
        storage.reset()


def console_eval(seed: int, kept: dict, card: str) -> dict:
    """Phase 6c: ``pio eval`` in both lanes through the console at ML-1M,
    on phase 6b's store (which it removes after). (1) A ``pio-torch eval
    --grid`` child (``EVAL_GRID_RANKS x EVAL_GRID_LAMBDAS``,
    ``GRID_ITERATIONS`` iterations) exits 0 and writes the leaderboard;
    its winner carries full ``engineParams``; it must launch B3's
    config-axis route, B2 and B1. (2) A ``pio-torch eval
    chip_smoke:ml1m_evaluation`` child exits 0, writes ``best.json`` and
    stores an ``EVALCOMPLETED`` evaluation instance, having launched B1
    (the batched route: one launch per param set for every held-out
    user). Each param set's Precision@10 must equal the one scored in
    this process on the same trained factors by the same pipeline with
    B1 and with B1's plain version."""
    import os

    from predictionio_tpu_torch.data import storage

    work, store, env = kept["work"], kept["store"], kept["env"]
    out: dict = {}
    try:
        grid_path = os.path.join(work, "grid.json")
        with open(grid_path, "w") as f:
            json.dump({"base": {"rank": max(EVAL_GRID_RANKS),
                                "numIterations": GRID_ITERATIONS,
                                "seed": seed},
                       "configs": [{"rank": r, "lambda": lam}
                                   for r in EVAL_GRID_RANKS
                                   for lam in EVAL_GRID_LAMBDAS],
                       "data": {"appName": QS_APP}}, f)
        board_path = os.path.join(work, "leaderboard.json")
        said, grid_s = pio(["eval", "--grid", grid_path, "--grid-out",
                            board_path, "--topk", str(GRID_TOPK)], env, work)
        launched = launches_line(said)
        with open(board_path) as f:
            board = json.load(f)
        winner = board["winner"]
        ep = winner["engineParams"]
        if len(board["rows"]) != len(EVAL_GRID_RANKS) * len(
                EVAL_GRID_LAMBDAS) or any(r["diverged"]
                                          for r in board["rows"]):
            raise AssertionError(f"leaderboard rows {board['rows']}")
        if sorted(ep) != ["algorithms", "datasource", "preparator",
                          "serving"] \
                or ep["algorithms"][0]["params"]["rank"] \
                != winner["params"]["rank"] \
                or ep["datasource"]["params"]["app_name"] != QS_APP:
            raise AssertionError(f"the winner's engineParams {ep}")
        if not all(launched.values()):
            raise AssertionError(f"pio eval --grid launched {launched}")
        out["grid"] = {"s": grid_s, "launches": launched,
                       "winner": winner["params"],
                       "metric": winner["metric"],
                       "n_test_users": board["nTestUsers"]}
        print(f"[eval] pio eval --grid: {len(board['rows'])} configs x "
              f"{GRID_ITERATIONS} iterations in {grid_s!r} s (the process); "
              f"{board['nTestUsers']} held-out users; winner "
              f"{winner['params']} precision@{GRID_TOPK} "
              f"{winner['metric']!r}; launches {launched} ({card})")

        said, eval_s = pio(["eval", f"chip_smoke:ml1m_evaluation"], env,
                           work)
        launched = launches_line(said)
        if not launched["fused_gather_score_topk"] \
                or not launched["assemble_normal_equations"]:
            raise AssertionError(f"pio eval launched {launched}")
        with open(os.path.join(work, "best.json")) as f:
            best = json.load(f)
        storage.reset(storage.StorageConfig(
            {"QS": {"type": "sqlite", "path": store}},
            {r: "QS" for r in storage.REPOSITORIES}))
        try:
            instances = storage.get_metadata_evaluation_instances().get_all()
        finally:
            storage.reset()
        if [i.status for i in instances] != ["EVALCOMPLETED"]:
            raise AssertionError(f"evaluation instances {instances}")
        result = json.loads(instances[0].evaluator_results_json)
        child = [s["score"] for s in result["engineParamsScores"]]
        mine = eval_scores_in_process(store)
        if [m[0] for m in mine] != child or [m[1] for m in mine] != child:
            raise AssertionError(f"Precision@{GRID_TOPK} of the child "
                                 f"{child}, in process (B1, plain) {mine}")
        if best["algorithms"] != result["bestEngineParams"]["algorithms"]:
            raise AssertionError("best.json is not the best params")
        out["evaluation"] = {"s": eval_s, "launches": launched,
                             "scores": child, "best_idx": result["bestIdx"]}
        print(f"[eval] pio eval chip_smoke:ml1m_evaluation in {eval_s!r} s "
              f"(the process): Precision@{GRID_TOPK} per param set {child} "
              f"(each equal to this process's on the same factors, with B1 "
              f"and with plain), best {result['bestIdx']}; best.json and an "
              f"EVALCOMPLETED instance; launches {launched} ({card})")
        return out
    finally:
        storage.reset()
        shutil.rmtree(work, ignore_errors=True)


# -- phase 7: model quality --------------------------------------------------------

QUALITY_SHAPE = (943, 1_682, 100_000)   # MovieLens-100K, bench_quality's
QUALITY_RANK, QUALITY_ITERATIONS, QUALITY_SPLIT_SEED = 32, 10, 7
QUALITY_SEEDS = (3, 17, 42)
K_EVAL = 10


def structured_ratings(n_users: int, n_items: int, nnz: int, seed: int,
                       latent_rank: int = 8):
    """``bench_quality.structured_ratings``: each user's items drawn from
    softmax(U_u . V_i * 6 + log popularity), so taste clusters exist for
    a factor model to recover; ratings 1-5 by affinity quintile."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, latent_rank)) / np.sqrt(latent_rank)
    V = rng.normal(size=(n_items, latent_rank)) / np.sqrt(latent_rank)
    log_pop = -0.5 * np.log(np.arange(1, n_items + 1))
    user_p = 1.0 / np.arange(1, n_users + 1) ** 0.6
    user_p /= user_p.sum()
    counts = np.bincount(rng.choice(n_users, size=nnz, p=user_p),
                         minlength=n_users)
    rows = np.empty(nnz, dtype=np.int64)
    cols = np.empty(nnz, dtype=np.int64)
    vals = np.empty(nnz, dtype=np.float32)
    pos = 0
    affinity_all = U @ V.T * 6.0 + log_pop[None, :]
    for u in range(n_users):
        c = int(counts[u])
        if c == 0:
            continue
        logits = affinity_all[u]
        p = np.exp(logits - logits.max())
        p /= p.sum()
        picked = rng.choice(n_items, size=c, p=p)
        rows[pos:pos + c] = u
        cols[pos:pos + c] = picked
        aff = affinity_all[u][picked]
        qs = np.quantile(affinity_all[u], [0.2, 0.4, 0.6, 0.8])
        vals[pos:pos + c] = 1.0 + np.searchsorted(qs, aff)
        pos += c
    return rows[:pos], cols[:pos], vals[:pos]


def build_split(n_users: int, n_items: int, nnz: int, seed: int,
                holdout_per_user: int = 2, min_ratings: int = 5):
    """``bench_quality.build_split``: first occurrence of each pair kept,
    the last 2 drawn items of every user with >= 5 held out."""
    rows, cols, vals = structured_ratings(n_users, n_items, nnz, seed)
    key = rows.astype(np.int64) * n_items + cols
    _, first_idx = np.unique(key, return_index=True)
    first_idx.sort()
    rows, cols, vals = rows[first_idx], cols[first_idx], vals[first_idx]
    held: dict = {}
    held_mask = np.zeros(len(rows), dtype=bool)
    for u in range(n_users):
        idx = np.flatnonzero(rows == u)
        if len(idx) >= min_ratings:
            out = idx[-holdout_per_user:]
            held[u] = set(cols[out].tolist())
            held_mask[out] = True
    keep = ~held_mask
    return rows[keep], cols[keep], vals[keep], held


def masked_scores(X, Y, train_rows, train_cols):
    scores = X @ Y.T
    scores[train_rows, train_cols] = -np.inf
    return scores


def precision_at_k(scores, held: dict, k: int = K_EVAL) -> float:
    """``bench_quality.precision_at_k`` on precomputed masked scores."""
    users = np.fromiter(held.keys(), dtype=np.int64, count=len(held))
    top = np.argpartition(-scores[users], k, axis=1)[:, :k]
    hits = np.fromiter(
        (len(set(top[i].tolist()) & held[u]) for i, u in enumerate(users)),
        dtype=np.float64, count=len(users))
    return float(hits.mean() / k)


def ndcg_at_k(scores, held: dict, k: int = K_EVAL) -> float:
    """``bench_quality.ndcg_at_k_factors``: binary-relevance NDCG@k with
    the 1/log2(rank+1) gain, averaged over the holdout users."""
    total = 0.0
    for u, rel in held.items():
        row = scores[u]
        top = np.argpartition(-row, k)[:k]
        top = top[np.argsort(-row[top], kind="stable")]
        dcg = sum(1.0 / np.log2(pos + 2.0)
                  for pos, item in enumerate(top.tolist()[:k])
                  if item in rel)
        ideal = sum(1.0 / np.log2(pos + 2.0)
                    for pos in range(min(k, len(rel))))
        total += float(dcg / ideal)
    return float(total / len(held))


def popularity_precision(train_rows, train_cols, held: dict, n_items: int,
                         k: int = K_EVAL) -> float:
    """``bench_quality.popularity_precision``: the most-rated unseen
    items for everyone, the floor a personal model must beat."""
    from itertools import islice

    pop_list = np.argsort(
        -np.bincount(train_cols, minlength=n_items)).tolist()
    seen: dict = {}
    for u, i in zip(train_rows.tolist(), train_cols.tolist()):
        seen.setdefault(u, set()).add(i)
    hits = 0
    for u, h in held.items():
        s = seen.get(u, set())
        recs = islice((i for i in pop_list if i not in s), k)
        hits += len(set(recs) & h)
    return hits / (k * len(held))


def quality(dev, shape=QUALITY_SHAPE, rank: int = QUALITY_RANK,
            iterations: int = QUALITY_ITERATIONS) -> dict:
    """Phase 7: ``bench_quality.run``'s protocol on the card. The port's
    ``train_als`` (the two training kernels) at seeds 3 / 17 / 42; the
    plain trainer from seed 3's init; Precision@10 and NDCG@10 of seed
    3, its ratio to the plain trainer's (0.99-1.01), and the seed band's
    lift over popularity (> 1); the bf16 lane's Precision@10 from seed
    3, at least fp32's minus 0.02."""
    import dataclasses

    from predictionio_tpu_torch.ops import als as als_mod
    from predictionio_tpu_torch.ops import als_cuda

    n_users, n_items, nnz = shape
    rows, cols, vals, held = build_split(n_users, n_items, nnz,
                                         QUALITY_SPLIT_SEED)
    user_side = als_mod.pad_ratings(rows, cols, vals, n_users, n_items)
    item_side = als_mod.pad_ratings(cols, rows, vals, n_items, n_users)

    def params(seed):
        return als_mod.ALSParams(rank=rank, num_iterations=iterations,
                                 lambda_=LAMBDA, alpha=ALPHA, seed=seed)

    band, ndcg = [], None
    for seed in QUALITY_SEEDS:
        X, Y = als_mod.train_als(user_side, item_side, params(seed), dev)
        scores = masked_scores(X, Y, rows, cols)
        band.append(precision_at_k(scores, held))
        if ndcg is None:
            ndcg = ndcg_at_k(scores, held)
    saved = (als_cuda.assemble_normal_equations, als_cuda.spd_solve)
    als_cuda.assemble_normal_equations = \
        als_cuda.assemble_normal_equations_plain
    als_cuda.spd_solve = als_cuda.spd_solve_plain
    try:
        Xp, Yp = als_mod.train_als(user_side, item_side,
                                   params(QUALITY_SEEDS[0]), dev)
    finally:
        als_cuda.assemble_normal_equations, als_cuda.spd_solve = saved
    plain_scores = masked_scores(Xp, Yp, rows, cols)
    plain = precision_at_k(plain_scores, held)
    pop = popularity_precision(rows, cols, held, n_items)
    # the bf16 lane on the same protocol from seed 3
    Xb, Yb = als_mod.train_als(
        user_side, item_side,
        dataclasses.replace(params(QUALITY_SEEDS[0]), precision="bf16"), dev)
    bf16 = precision_at_k(masked_scores(Xb, Yb, rows, cols), held)
    out = {"precision_at_10": band[0], "ndcg_at_10": ndcg,
           "bf16_precision_at_10": bf16,
           "plain_precision_at_10": plain,
           "plain_ndcg_at_10": ndcg_at_k(plain_scores, held),
           "ratio_vs_plain": band[0] / plain,
           "seed_band": band, "popularity_precision_at_10": pop,
           "lift_vs_popularity": float(np.mean(band)) / pop,
           "holdout_users": len(held), "shape": list(shape), "rank": rank,
           "iterations": iterations}
    print(f"[quality] {json.dumps(out)}")
    if not 0.99 <= out["ratio_vs_plain"] <= 1.01:
        raise AssertionError(f"Precision@10 {band[0]} is not within 1% of "
                             f"the plain trainer's {plain}")
    if not out["lift_vs_popularity"] > 1.0:
        raise AssertionError(f"the seed band {band} does not beat "
                             f"popularity ({pop})")
    # the JAX package's gate on the bf16 lane (tests/test_als_precision.py)
    if not bf16 >= band[0] - 0.02:
        raise AssertionError(f"bf16 Precision@10 {bf16} is more than 0.02 "
                             f"below fp32's {band[0]}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--serving-times", action="store_true",
        help="build, then only time the serving kernel (phase 4) and print "
             "its rows; with a copy of this script at another checkout's "
             "root, times that checkout's package")
    parser.add_argument(
        "--prepare-times", action="store_true",
        help="only run phase 5's ratings through the preparator and print "
             "its split; with a copy of this script at another checkout's "
             "root, times that checkout's prepare step")
    parser.add_argument("--serve-store", metavar="SQLITE_FILE",
                        help=argparse.SUPPRESS)  # phase 6's second process
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if args.serve_store:
        return serve_child(args.serve_store)
    from predictionio_tpu_torch.device import resolve_device

    dev = resolve_device(None)
    card = nvidia_smi()
    print(f"[card] {card}")
    t0 = time.perf_counter()

    def phase(name, fn, *fn_args):
        t = time.perf_counter()
        out = fn(*fn_args)
        print(f"[phase] {name}: {time.perf_counter() - t:.1f} s")
        return out

    if args.prepare_times:
        out = phase("5 prepare step", prepare_times, args.seed)
        print(json.dumps({"prepare_times": out}))
        print(nvidia_smi())
        return 0
    phase("1 build", build_kernels)
    if args.serving_times:
        rows = phase("4 serving kernel times", timings, dev, args.seed)
        print(json.dumps({"serving_times": rows}))
        print(nvidia_smi())
        return 0
    max_err, checked_routes = phase("2 serving kernel checks", kernel_checks,
                                    dev, args.seed)
    store = phase("5 event store", ml20m_store, args.seed)
    try:
        trained = phase("5 training", train_full_width, dev, args.seed,
                        store)
        ingest = phase("5b scale ingest", scale_ingest, dev, args.seed,
                       store, trained)
    finally:
        remove_store(store)
    train_err = phase("2b training kernel checks", training_kernel_checks,
                      dev, trained, args.seed)
    options = phase("5c training options", training_options, dev, trained,
                    args.seed)
    grid = phase("5d tuning grid", tuning_grid, dev, trained,
                 store["ratings"], args.seed, card)
    served = phase("3 serving", serve_full_width, trained["model"],
                   args.seed)
    folded = phase("3b fold-in", foldin_full_width, dev, trained,
                   store["ratings"], args.seed, served)
    rows = phase("4 serving kernel times", timings, dev, args.seed)
    crossover = phase("4c route crossover", route_crossover, dev, args.seed)
    train_times = phase("4b training kernel times", training_timings, dev,
                        trained)
    cycle = phase("6 lifecycle", lifecycle, args.seed)
    started = phase("6b quick start", quick_start, args.seed, cycle, card,
                    True)
    evaluated = phase("6c pio eval", console_eval, args.seed,
                      started["kept"], card)
    scored = phase("7 quality", quality, dev)
    # the line's headline shape: a full micro-batch (B=256) at the
    # default k bucket (16) on the default GPU store (bf16)
    head = next(r for r in rows
                if (r["store"], r["B"], r["k"]) == ("bf16", 256, 16))
    kernels = [{
        "name": "fused_gather_score_topk", "route": "cuda",
        "source": "predictionio_tpu_torch/ops/csrc/fused_topk.cu",
        "replaces": "predictionio_tpu/ops/als_pallas.py:453",
        "launches": served["launches"], "max_abs_err": max_err,
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shape": "bf16 store, B=256, k=16",
        # launches by route on the main path (phase 3) and in phase 2
        "routes": served["routes"], "checked_routes": checked_routes,
        # the batch from which the bitonic route is as fast, per k
        "crossover_batch": crossover,
        # the category queries' shape: the whole row sorted
        "large_k": [{key: r[key] for key in ("store", "B", "k", "ms",
                                             "plain_ms", "library_ms",
                                             "bound_ms", "bound_by")}
                    for r in rows if r["store"] == "bf16"
                    and r["B"] in (1, 256) and r["k"] == M_ITEMS],
        # the evaluation lanes: grid_topk (phase 5d's leaderboard, timed
        # at its shape; the launches of 6c's `pio eval --grid` child
        # beside), and batch_predict in 6c's `pio eval` child
        "eval_routes": [
            {"route": "grid_topk", "launches": grid["launches"]["topk"],
             "console_launches": evaluated["grid"]["launches"][
                 "fused_gather_score_topk"], **grid["topk"],
             "shape": f"fp32 store, B={grid['topk']['B']}, "
                      f"k={GRID_TOPK}, L={grid['topk']['L']}"},
            {"route": "batch_predict", "console_launches":
                evaluated["evaluation"]["launches"][
                    "fused_gather_score_topk"]}],
        "timings": rows}]
    for name, replaces, err, shape, main_route in (
            ("assemble_normal_equations", 141, train_err["assemble"],
             "every bucket of both sides (one iteration), R=64", "tiles"),
            ("spd_solve", 277, train_err["spd"],
             "each side's whole batch (one iteration), R=64", "shared")):
        # the main path's route, and the large-rank route off it (its
        # launches from phase 2b's rank-256 training)
        # the fold-in solve's shapes: launches from phase 3b, the times of
        # its largest shape (B=256, L=2,048), every timed shape listed
        fold_rows_t = train_times["foldin"][name]
        routes = [{"route": main_route, "R": RANK,
                   "launches": trained["launches"][name],
                   **train_times["heads"][name]},
                  {**train_times["large"][name],
                   "launches": train_err["large_rank_training"]["launches"][name]},
                  {"route": "foldin", "R": RANK,
                   "launches": folded["launches"][name],
                   **{k: fold_rows_t[-1][k] for k in (
                       "ms", "plain_ms", "library_ms", "bound_ms",
                       "bound_by")},
                   "shape": "B=256 (200 real rows), L=2,048",
                   "timings": fold_rows_t}]
        if name == "assemble_normal_equations":
            # B3's config-axis route: launches from phase 5d's grid
            # training (and 6c's `pio eval --grid` child beside), its time
            # over one grid iteration's work (k configs, R_max)
            g = grid["assembly"]["head"]
            routes.append({
                "route": "tiles_grid", "R": RANK, "k": len(GRID_RANKS)
                * len(GRID_LAMBDAS) * len(GRID_ALPHAS) + 1,
                "launches": grid["launches"]["tiles_grid"],
                "console_launches": evaluated["grid"]["launches"][name],
                **{key: g[key] for key in (
                    "ms", "single_launches_ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by", "launches_per_iteration")},
                "max_abs_err": grid["checked"]["max_abs_err"],
                "shape": "every bucket of both sides (one grid iteration), "
                         "k=9, R_max=64",
                "timings": grid["assembly"]["rows"]})
        else:
            sh = grid["assembly"]["solve_head"]
            routes.append({"route": "grid", "R": RANK,
                           "launches": grid["launches"]["spd_solve"],
                           "console_launches":
                               evaluated["grid"]["launches"][name],
                           **{key: sh[key] for key in (
                               "ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by", "launches_per_iteration")},
                           "shape": "k * B systems of every bucket of both "
                                    "sides (one grid iteration), k=9, "
                                    "R_max=64"})
        if name == "assemble_normal_equations":
            # B3's bf16 route: launches from phase 5c's bf16 training
            routes.append({
                "route": "tiles_bf16", "R": RANK,
                "launches": options["bf16"]["routes"]["tiles/bf16"],
                **train_times["bf16"]["head"],
                "shape": "every bucket of both sides (one iteration), R=64, "
                         "bf16 store",
                "timings": train_times["bf16"]["rows"]})
        kernels.append({
            "name": name, "route": "cuda",
            "source": "predictionio_tpu_torch/ops/csrc/als_solve.cu",
            "replaces": f"predictionio_tpu/ops/als_pallas.py:{replaces}",
            "launches": trained["launches"][name], "max_abs_err": err,
            **train_times["heads"][name], "shape": shape,
            "routes": routes, "timings": train_times["rows"][name]})
    print(f"[done] {time.perf_counter() - t0:.1f} s; HTTP p50 "
          f"{served['p50_ms']!r} ms p99 {served['p99_ms']!r} ms "
          f"(observability on / off p50 "
          f"{served['overhead']['on']['p50_ms']!r} / "
          f"{served['overhead']['off']['p50_ms']!r} ms); training "
          f"iteration {trained['iteration_ms']!r} ms (bf16 lane "
          f"{options['bf16']['iteration']['bf16']['wall_ms']!r} ms; "
          f"checkpoint_every=1 wall ratio fp32 "
          f"{options['checkpoint_fp32']['overhead']!r}, bf16 "
          f"{options['checkpoint_bf16']['overhead']!r}); tuning grid "
          f"{grid['grid_s']!r} s ({grid['iteration_ms']!r} ms an iteration, "
          f"the serial trainings {grid['serial_s']!r} s); pio eval --grid "
          f"{evaluated['grid']['s']!r} s, pio eval "
          f"{evaluated['evaluation']['s']!r} s; fold-in event -> "
          f"servable p50 {folded['servable_p50_s']!r} s p99 "
          f"{folded['servable_p99_s']!r} s over {folded['folds']} folds; "
          f"store write "
          f"{store['write_s']!r} s, read {trained['read_s']!r} s, prepare "
          f"{trained['prepare_s']!r} s; scale ingest {ingest['ingest_s']!r} "
          f"s (overlap {ingest['overlap']!r}); lifecycle deploy "
          f"{cycle['deploy_s']!r} s, reload {cycle['reload_s']!r} s; "
          f"quick start import "
          f"{started['import']['events_per_s']!r} events/s, event server "
          f"{started['event_server']['batch_events_per_s']!r} events/s; "
          f"Precision@10 {scored['precision_at_10']!r} (bf16 "
          f"{scored['bf16_precision_at_10']!r}; "
          f"{scored['ratio_vs_plain']!r} of plain, lift "
          f"{scored['lift_vs_popularity']!r})")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
