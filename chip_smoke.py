#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's query path once on one GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and the script exits non-zero):

1. Print the card (``nvidia-smi``), build every kernel of the path with
   ``nvcc`` from this checkout's sources and print the build time.
2. Hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes (M=26,744 items, R=64; B in {1, 8, 256}; k in
   {16, 128, 26,744}; fp32, bf16 and int8 stores; seen mask on and off),
   on random data and on integer data with ties across tiles.
3. Serve the recommendation template at MovieLens-20M width (138,493
   users x 26,744 items x rank 64, random factors from ``--seed``,
   heavy-tailed seen lists of mean ~144): start the port's QueryServer,
   send user, blacklist, category, item-similarity and unknown-user
   queries, some from 8 concurrent clients, and check every answer
   against the same pipeline with the plain version in place of the
   kernel. The kernel's launch count must rise.
4. Time each kernel at every (store, B, k) against its bound, its plain
   version and one library call; print the HTTP p50/p99.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

H100_BYTES_PER_S = 3.35e12    # HBM3 rate of an H100 SXM
H100_FP32_FLOPS = 67e12       # fp32 outside the tensor cores
M_ITEMS, N_USERS, RANK = 26_744, 138_493, 64
BATCHES, KS = (1, 8, 256), (16, 128, M_ITEMS)
RTOL = 1e-5


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


# -- phase 1 ----------------------------------------------------------------

def build_kernels() -> float:
    from predictionio_tpu_torch.ops import _build, als_cuda

    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    _build.load_kernel_library(als_cuda.KERNEL_NAME)
    seconds = time.perf_counter() - t0
    print(f"[build] {als_cuda.KERNEL_NAME}: nvcc sm_90a {seconds:.1f} s -> "
          f"{_build.library_path(als_cuda.KERNEL_NAME).name}")
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
    for b in range(B):
        ids = ki[b][fin[b]]
        if (ids < 0).any() or len(np.unique(ids)) != len(ids):
            raise AssertionError(f"row {b}: negative or repeated ids")
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


def kernel_checks(dev, seed: int) -> float:
    import torch

    from predictionio_tpu_torch.ops import als_cuda

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
                for k in KS:
                    for mask_seen in (True, False):
                        n_items = M_ITEMS - 3
                        kk = min(k, n_items)
                        kv, ki = als_cuda.fused_gather_score_topk(
                            Qt, store, ct, mt, k=kk, n_items=n_items,
                            mask_seen=mask_seen)
                        torch.cuda.synchronize()
                        pv, pi = als_cuda.fused_gather_score_topk_plain(
                            Qt, store, ct, mt, k=min(kk + 1, M_ITEMS),
                            n_items=n_items, mask_seen=mask_seen)
                        pv, pi = pv.cpu().numpy(), pi.cpu().numpy()
                        if pv.shape[1] == kk:
                            pv = np.pad(pv, ((0, 0), (0, 1)),
                                        constant_values=-np.inf)
                            pi = np.pad(pi, ((0, 0), (0, 1)))
                        worst = max(worst, check_topk(
                            kv.cpu().numpy(), ki.cpu().numpy(), pv, pi,
                            tol, exact=kind == "integer"))
                        cases += 1
    # the optional per-row validity vector (sharded stores use it)
    Q, Yf, cols, mask = fixture("integer", 8, rng)
    store, _ = make_store(Yf, "fp32", dev)
    rv = torch.from_numpy((rng.random(M_ITEMS) < 0.9).astype(np.float32)
                          ).to(dev)
    Qt, ct, mt = (torch.from_numpy(a).to(dev) for a in (Q, cols, mask))
    kv, ki = als_cuda.fused_gather_score_topk(
        Qt, store, ct, mt, k=128, n_items=M_ITEMS, row_valid=rv)
    torch.cuda.synchronize()
    pv, pi = als_cuda.fused_gather_score_topk_plain(
        Qt, store, ct, mt, k=129, n_items=M_ITEMS, row_valid=rv)
    check_topk(kv.cpu().numpy(), ki.cpu().numpy(), pv.cpu().numpy(),
               pi.cpu().numpy(), np.zeros(8, np.float32), exact=True)
    print(f"[kernel] fused_gather_score_topk == plain in {cases + 1} cases "
          f"(max |value err| {worst!r})")
    return worst


# -- phase 3 ----------------------------------------------------------------

def ml20m_model(seed: int):
    """Random factors and heavy-tailed seen lists at MovieLens-20M width,
    wrapped as the port's ALSModel (served as a deployment would be:
    the default device store on the default card)."""
    from predictionio_tpu_torch.weights import als_model_from_numpy

    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(N_USERS, RANK)) * 0.3).astype(np.float32)
    Y = (rng.normal(size=(M_ITEMS, RANK)) * 0.3).astype(np.float32)
    # lognormal lengths (mean ~144 = 20M ratings / 138,493 users), capped
    # at 2,048 (the heaviest user reaches the cap); distinct items drawn
    # by a power-law popularity, twice over and cut to length
    lens = np.clip(rng.lognormal(4.25, 1.2, N_USERS).astype(np.int64), 1,
                   2048)
    lens[np.argmax(lens)] = 2048
    pop = 1.0 / (np.arange(M_ITEMS) + 10.0) ** 0.8
    draws = rng.choice(M_ITEMS, size=int(2 * lens.sum()), p=pop / pop.sum())
    bounds = np.concatenate([[0], np.cumsum(2 * lens)])
    seen = {}
    for u in range(N_USERS):
        items, first = np.unique(draws[bounds[u]:bounds[u + 1]],
                                 return_index=True)
        seen[u] = items[np.argsort(first)][:lens[u]]
    genres = [f"g{g}" for g in range(20)]
    cats = {i: tuple(rng.choice(genres, size=rng.integers(1, 4),
                                replace=False)) for i in range(M_ITEMS)}
    model = als_model_from_numpy(
        X, Y, [f"u{u}" for u in range(N_USERS)],
        [f"i{i}" for i in range(M_ITEMS)], seen, item_categories=cats)
    sizes = np.asarray([len(v) for v in seen.values()])
    print(f"[serve] seen lists: mean {sizes.mean():.1f}, max {sizes.max()}")
    return model


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


def device_busy(fn) -> tuple:
    """(wall ms, device-busy ms, launches by kernel name) of ``fn()``
    under ``torch.profiler``; busy time is the union of the CUDA kernel
    intervals the profiler recorded."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
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
    names = collections.Counter(
        e.name.replace("(anonymous namespace)::", "").split("(")[0]
        for e in events)
    return wall, busy / 1e3, names


def serve_full_width(seed: int) -> dict:
    import torch

    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops import serving as serving_mod
    from predictionio_tpu_torch.templates.recommendation.engine import (
        ALSAlgorithm,
        Query,
        engine_factory,
    )
    from predictionio_tpu_torch.workflow.create_server import (
        QueryServer,
        ServerConfig,
        build_deployment,
    )

    t0 = time.perf_counter()
    model = ml20m_model(seed)
    engine = engine_factory()
    params = engine.engine_params_from_variant(
        {"algorithms": [{"name": "als", "params": {"rank": RANK}}]})
    dep = build_deployment(engine, params, [model])
    server = QueryServer(ServerConfig(ip="127.0.0.1", port=0), dep).start()
    print(f"[serve] model, store and warm-up: "
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

    with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
        health = json.loads(resp.read())
    if not health["ready"]:
        raise AssertionError(f"server not ready: {health}")

    als_cuda.launches.reset()
    answers = [(q, *post(base + "/queries.json", q)) for q in queries]
    in_burst = burst(base, concurrent)
    answers += in_burst
    launches = als_cuda.launches.value
    if launches == 0:
        raise AssertionError("the kernel was never launched on the main path")
    stats = srv.stats()

    # expected answers: the same pipeline with the plain version in place
    # of the kernel (one extra result of context for near-tie checks)
    algo = ALSAlgorithm()
    x_norm = np.linalg.norm(model.user_factors, axis=1)
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
    torch.cuda.synchronize()
    lat = np.asarray([a[3] for a in answers]) * 1e3
    print(f"[serve] {checked} answers match the plain pipeline; kernel "
          f"launches {launches}; users lane {stats['users']['dispatches']} "
          f"dispatches for {stats['users']['batchedQueries']} queries")
    print(f"[serve] HTTP latency over {len(lat)} requests: p50 "
          f"{float(np.percentile(lat, 50))!r} ms, p99 "
          f"{float(np.percentile(lat, 99))!r} ms")
    for j in np.argsort(lat)[::-1][:3]:
        print(f"[serve]   slow: {float(lat[j])!r} ms for "
              f"{json.dumps(answers[j][0])}")
    narrow = [a[3] * 1e3 for a in in_burst if "categories" not in a[0]]
    print(f"[serve] concurrent burst: {len(narrow)} narrow queries p50 "
          f"{float(np.percentile(narrow, 50))!r} ms, max "
          f"{max(narrow)!r} ms; category queries "
          f"{[a[3] * 1e3 for a in in_burst if 'categories' in a[0]]!r} ms")
    wall, busy, kernels = device_busy(lambda: burst(base, concurrent))
    if kernels:
        print(f"[serve] profiled burst of {len(concurrent)} queries: wall "
              f"{wall!r} ms, device busy {busy!r} ms "
              f"({100 * busy / wall:.2f}%); kernels {dict(kernels)}")
    else:
        print("[serve] device busy share not measured: the profiler "
              "recorded no CUDA kernels")
    server.stop()
    return {"launches": launches, "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


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

            for k in KS:
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
                rows.append({"store": dtype, "B": B, "k": k, "ms": t_k,
                             "plain_ms": t_p, "library_ms": t_l,
                             "bound_ms": b_ms, "bound_by": b_by})
                print(f"[time] {dtype:>4} B={B:<3} k={k:<5} kernel "
                      f"{t_k!r} ms  plain {t_p!r} ms  library {t_l!r} ms  "
                      f"bound {b_ms!r} ms ({b_by})")
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from predictionio_tpu_torch.device import resolve_device

    dev = resolve_device(None)
    card = nvidia_smi()
    print(f"[card] {card}")
    t0 = time.perf_counter()
    build_kernels()
    max_err = kernel_checks(dev, args.seed)
    served = serve_full_width(args.seed)
    rows = timings(dev, args.seed)
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
        "timings": rows}]
    print(f"[done] {time.perf_counter() - t0:.1f} s; HTTP p50 "
          f"{served['p50_ms']!r} ms p99 {served['p99_ms']!r} ms")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
