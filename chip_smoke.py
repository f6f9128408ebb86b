#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's training and query paths once on one GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --serving-times   # phases 1 and 4 only
    python3 chip_smoke.py --topk-routes     # phases 1, 2 and 4c only
    python3 chip_smoke.py --prepare-times   # phase 5's prepare step only
    python3 chip_smoke.py --query-fleet     # phases 1, 5 and 3d only
    python3 chip_smoke.py --seqrec          # 1, 5's store, 3e, 3f, 7's half
    python3 chip_smoke.py --templates       # phases 1 and 6e only
    python3 chip_smoke.py --sharded         # phases 1, 8a, 5, 8b and 8c only
    python3 chip_smoke.py --sequence-parallel  # 1, 5's store, 3e/3f training, 8d
    python3 chip_smoke.py --crossover       # phases 1 and 8a only
    python3 chip_smoke.py --training-ladder # 1, 5's store, 5, 5b, 5c, 5d
    python3 chip_smoke.py --large-rank      # 1, 2b's and 4b's large ranks

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
   with all but 0, 5, 300 or 6,744 items seen; and the tiled route's
   (k <= 128 from ``CHUNKED_MAX_B`` queries on), exactly, at B = 100:
   ties across its 1,024-item chunk edges and in its last chunk of
   120 items, a store of 1,024 * 26 + 1 items (a last chunk of one),
   ``n_items`` cut inside a chunk with ``row_valid``, rows with all but 5
   items seen, every launch on the tiled route. Prints the launches by
   route.
5. Train the recommendation template at MovieLens-20M width from the
   event store: about 20M synthetic ratings of 138,493 users x 26,744
   items from ``--seed`` (lognormal row lengths of mean ~140 capped at
   2,048, power-law item popularity, 0.5-5.0 stars) are written as
   ``rate`` events in a seeded random order, with one ``$set`` of genres
   per item, to a ``jsonlfs`` store in a temporary directory (1,000,000
   events a partition, through ``append_raw_lines``; the lines built by
   numpy, no Python call a line, timed apart from the appends, and a
   CRC-32 of the partitions printed;
   the script checks the free space first and removes the store after
   phase 5b).
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
   warm-up beside them, capturing one iteration as a CUDA graph on the
   staged tables once their copies land), with each stage's busy
   seconds, the wall time, the overlap ratio (busy / wall) and the
   pinning's seconds printed. Every staged table, copied back, must be
   byte-equal to the table phase 5's preparator built, and
   ``train_als_bucketed`` on the staged sides must hit the warmed
   program (B3 and B2 each once a bucket an iteration, every launch by
   a replay) and give factors bitwise equal to phase 5's model (trained
   eagerly: the same kernels on the same inputs from the same init). The
   capture's seconds and the training pool's bytes are printed, and one
   iteration as a replay against one eager (CUDA-event windows and
   wall, medians of 20 in 4 alternating rounds; the device's busy share
   under the profiler).
2b. Hold the two training kernels against their plain versions: the
   assembly on every row of every bucket of both sides (trained and
   integer factors, implicit and explicit weights, the layout's own
   zero-weight padding), on synthetic rows the kernel splits across
   blocks (8 of 100,000 slots, 64 of 5,000 ending mid-span), at ranks
   1, 10, 30, 128 and 208 on rows it groups and rows it splits, and its
   tile-group route at 209, 256, 320 and 385 (four bands, the last of
   one column); the solve, which must be bitwise equal to plain, on B
   in {1, 127, 4,096, 138,493} random SPD systems, an ill-scaled family
   and real training systems at rank 64, and at ranks 1-384 on small
   batches (one warp a system to 239, one block from 240 to 339 in
   shared memory, from 340 in device memory; the 256-column chunk
   boundary). Both kernels also at the fold-in solve's
   shapes: B in {8, 64, 256} with all but 1, 5 and 200 rows padding, L
   in {8, 256, 2,048, 4,096} (past one assembly span). The assembly's
   bf16 route (a bf16 factor store, the bf16 training precision) the
   same way on every bucket of both sides at rank 64, at ranks 1-385
   (odd ranks, whose bf16 rows are not 4-byte aligned, and both routes)
   and at the fold-in shapes, each case also bitwise equal to the fp32
   route on the store widened to fp32. Then train at rank 256 (2,000
   users x 1,000 items, 2 iterations, through the tile-group assembly
   and the block solve, no other route) and hold it against the plain
   trainer from one init. The seconds of the ranks from 339 are
   printed after phase 6b (``[budget]``). With ``--large-rank`` the
   script runs only the build, these checks above the tiles route's and
   the warp solve's ranks, and phase 4b's large-rank timings.
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
   the JAX package's 3% gate, not asserted); (c) the fp32
   ``checkpoint_every=1`` run warmed first (the iteration and the
   objective sample captured): every iteration and sample a cache hit,
   B3 and B2 by replays, the factors and the run log's samples bitwise
   the eager run's.
5d. The tuning grid at ML-20M width on phase 5's ratings, from memory
   (no second read): each user's last rating in stream order held out,
   as ``pio eval --grid`` splits them, the rest bucketed and staged once;
   8 configs (rank 32 / 64 x lambda 0.01 / 0.1 x alpha 1 / 40) and a
   ninth with alpha = 1e38, 10 iterations, implicit, fp32, through
   ``train_als_grid_bucketed`` warmed first (the grid's iteration and
   objective captured; every assembly launch on B3's config-axis route,
   one a bucket for all configs, B2 over ``k * B`` systems, all by
   replays), and the leaderboard of 4,096 held-out users through
   ``grid_topk`` (B1, one launch per config per 512 users). Checks: (a)
   the alive mask is 8 x True then False, the dead lane all zeros, every
   factor finite; (b) each config against its serial
   ``train_als_bucketed`` run (each warmed, by replays) from the same
   init: bitwise at rank 64, within 1e-4 / 1e-5 at rank 32, pad columns
   exactly zero; (c) B3's grid route at the largest bucket's
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
   host time, the peak device memory against
   ``grid_bytes_per_config * k`` plus the tables, the warm-up's seconds,
   the training pool's bytes and ``run_grid``'s memory plan before and
   after the capture, and a grid iteration as a replay against eager.
3. Serve the model phase 5 trained: start the port's QueryServer, send
   user, blacklist, category, item-similarity and unknown-user queries,
   some from 8 concurrent clients, and check every answer against the
   same pipeline with the plain version in place of the serving kernel.
   Its launch count must rise, and every launch at k <= 128 must take
   the chunked route in batches below ``CHUNKED_MAX_B`` and the tiled
   route from it; the launches are
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
   printed. Last, the sequential queries run from a client process in 6
   rounds of 5 runs: metrics, tracing and device telemetry on, all
   killed, and each alone on; each mode's percentiles, and the user
   queries' split with all on against tracing alone.
3c. ``pio batchpredict``'s engine at ML-20M width on phase 5's stored
   engine instance (put back into a memory store) at phase 3's serving
   precision: a JSONL file of every known user (``num`` 10), 16 unknown
   users, 64 known users with a five-item blacklist and 16
   item-similarity queries; chunks of 256, ``jsonl``. Checks: (a) the
   summary counts every query and every chunk was scored; (b) the first,
   the last and random chunks (1,024 queries or more) equal byte for
   byte the records of ``serve_one`` (the looped single-query path, B1
   at B = 1) over the same queries; (c) B1's launches by (route, k, B)
   equal the chunk plan's (one ``users_topk`` launch per chunk and k,
   tiled at B >= ``CHUNKED_MAX_B``; one per similarity query); (d) a
   run over the first 64 chunks' queries stopped after 48 chunks
   resumes, skips them, scores the rest, and its shards are byte-equal
   to the clean run's. Prints the wall and
   scoring seconds, queries/s, B1's device ms over the run (CUDA
   events), one median chunk's split (extraction and supplement,
   ``users_topk`` launch and copy, results, render, write and fsync) and
   the looped path's queries/s.
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
   heaviest passes the seen table's width), 96 new users with 5-200
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
3d. The query fleet (``pio deploy --fleet 3``) at ML-20M width on phase
   5's stored engine instance (put back into a memory store), bf16
   store: ``QueryFleet(ServerConfig(ip="127.0.0.1", port=0, <the
   instance's engine coordinates>), replicas=3)``, each replica loading
   the instance on its own. (a) Each replica's ``DeviceTopK`` is a store
   of its own on the card; ``/healthz`` is ready and ``/stats.json``
   reads 3/3 replicas ready; the replicas' ``memory_report`` bytes fit
   in ``torch.cuda.memory_allocated``'s growth and in
   ``device_report()``. (b) Phase 3's five query kinds (sequential) and
   1,024 user queries from 8 clients through the balancer: every answer
   equals the plain pipeline's; every user query lands on
   ``ring.preference(user)[0]`` (each replica's own users lane counts
   it), and B1 dispatches in every replica. (c) A second instance,
   trained on phase 5's tables from the next seed (3 iterations, B3 and
   B2 on the card) and stored; ``POST /reload`` to the balancer while 4
   clients query 16 users each: no query fails, every answer equals one
   of the two instances' plain answers, no user gets the old instance's
   after the new one's, every answer after the roll equals the new
   instance's, and a reload to the older instance answers 409 with the
   ``replicas`` list. (d) One replica stopped: its users are answered by
   the next replica of their ring preference, marked
   ``degradedReasons: ["replica_down"]``, equal to the plain answers;
   ``/healthz`` stays ready. (e) The balancer's federated ``/metrics``,
   parsed with ``parse_prometheus``, counts the balancer's queries as
   sent, and the replicas' as the registry does (the in-process member
   counted once); ``/stats.json`` carries ``fleet.members``, ``scrape``
   and ``alerts``; ``/traces/<id>`` of a query sent with its own
   ``traceparent`` holds the balancer's span (the client's child) over
   the replica's; ``/traces.json`` answers. (f) ``pio-torch status
   --fleet URL`` and ``pio-torch top --fleet --once`` (children) print
   the fleet line. Printed, not asserted: sequential user-query p50 /
   p99 straight to a replica and through the balancer, burst queries/s
   from 8 and 32 clients through a 3-replica and a 1-replica fleet, B1
   dispatches per replica, the card's busy share over the 32-client
   burst (profiled) and the ``device.execute`` spans' CUDA-event time
   against the profiler's B1 time and the burst's wall for each fleet
   (asserted: within them), device memory
   per replica and in total.
3e. Sequential recommendation at ML-20M width (its training runs after
   5b, on phase 5's store; its serving after phase 7): the store read
   through ``SequenceDataSource`` (``rate`` events, 1,000,000-event
   blocks, indexed block by block), ``SequencePreparator`` (the last 64
   items a user) and ``SeqRecAlgorithm.train`` at ``SEQ_PARAMS`` (rank
   64, 2 layers, 4 heads, 1,000 Adam steps of 256 rows and 128 shared
   negatives): the loss must fall, and 256 sampled users' card vectors
   must equal the port's CPU encode within 1e-4. The read, prepare,
   train and encode seconds, tokens/s (``training_tokens``) and the peak
   device memory are printed. The model is deployed (bf16 store) behind
   a ``QueryServer``: 43 sequential queries and 512 from 8 clients,
   every answer equal to the plain pipeline (B1's plain version); B1's
   launches are printed. Then 8 users' histories (phase 5's events, in
   its order) in a memory store, the model deployed with fold-in, 3 new
   ratings each: each stored row must equal the re-encode of its user's
   history on the CPU (within ``FOLDIN_ROW_TOL``), each answer must
   change and equal plain.
3f. Two-stage serving at ML-20M width: the ``twostage`` engine's
   preparator on 3e's read (``max_len`` 2,048), its ALS half (rank 64,
   3 iterations, B3 and B2) and its seqrec half at ``SEQ_PARAMS``;
   deployed through ``deployment_from_models`` (``TwoStageServing``
   bound to one ``TwoStageTopK``, N = 128, bf16): 43 sequential and
   512 burst queries, every answer equal to the plain pipeline (plain
   stage 1, then the same re-rank), each batch one ``two``-lane dispatch
   with one B1 launch at k = N, mask off; the median CUDA-event time of
   B1's kernels and of stage 2 a dispatch; B1's unmasked route at k =
   128, B in {1, 256} against plain (within the reordering allowance),
   timed beside plain, ``torch.topk`` and its bound. Then a composite
   fold-in of 8 users: the ALS rows equal the plain fold, the stage-2
   rows the CPU re-encode, every answer changes and equals plain.
4. Time the serving kernel at every (store, B, k) against its bound, its
   plain version and one library call, and at k <= 128 (bf16, and every
   store at B = 8 and 256, the tiled route) split its device time by
   kernel name under the profiler; print the HTTP p50/p99. With ``--serving-times`` the script
   builds and runs this phase alone: copied to the root of another
   checkout, it times that checkout's kernel the same way.
4c. At k in {16, 128} on the bf16 store, run the chunked, tiled and
   bitonic routes on the same inputs at B from 1 to 256, and the tiled
   and bitonic routes at ``grid_topk``'s shape (fp32, B = 512, k = 10,
   2,047 seen a query): their answers must be bitwise equal; print each
   route's device and event-timed ms, the tiled route's split by kernel
   name, the fastest route and the plan's at each batch, and the batch
   from which the tiled route is as fast as the chunked one, beside the
   plan's ``CHUNKED_MAX_B``. ``--topk-routes`` builds and runs phases 2
   and 4c alone.
4b. Time the training kernels at the full-width shapes (the assembly on
   every bucket of both sides, the solve on each side's whole batch)
   against their bounds, plain versions and one library call each; at
   the fold-in shapes (B, L) = (8, 256), (64, 256), (256, 2,048); the
   assembly's bf16 route on every bucket of both sides (its bound reads
   the store at 2 bytes a value; its library call is ``torch.einsum``
   over the bf16 gather widened to fp32); the library calls at the
   sharded trainer's block shapes (each bucket padded to a multiple of
   32 rows and cut in 4, ``bmm`` and ``cholesky_ex`` +
   ``cholesky_solve`` on each block that holds a real row: phase 8c's
   library column, beside the plain versions there); the block solve
   at ranks 256 and 320 and its device-memory route at 384 (4,096
   systems), and the tile-group assembly at ranks 256 and 320 (4,096
   rows of 128 slots), each with its plain time, library call
   (``cholesky`` + ``cholesky_solve``; ``bmm``) and bound; and one ALS
   iteration at rank 256 on phase 5's tables (random factors from the
   seed, one iteration warm, three event-timed, one profiled for the B3
   / B2 split; every launch on the tile-group and block routes, the
   factors finite, and one item bucket's A and b within the reordering
   bound and x bitwise plain on its first 256 rows). After phase 6b a
   ``[budget]`` line prints these seconds beside those that 6b's
   overlap of ``pio batchpredict`` with its deploys hides.
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
   ``POST /profile/start``, 20 queries, ``/profile/stop`` and a second
   stop (409), whose ``trace.json`` must hold a ``score_tile_kernel``
   event (one per B1 launch) for every dispatch of the window, and names
   the host threads that launched them; ``pio undeploy`` (the child must have launched the top-k kernel, and
   the port answer nothing after); ``pio export`` writes one line per
   event written. ``pio eventserver`` and ``pio deploy --feedback
   --accesskey K`` as children: 24 queries, and the store then holds 24
   ``predict`` events of entity type ``pio_pr``; ``pio top --once``
   against that deploy prints the store line (precision, users, items,
   bytes)
   and lane lines with dispatches. ``pio deploy --fleet 2 --foldin on``
   beside a ``pio eventserver`` child answers phase 6's queries through
   its balancer equal to the instance loaded in-process; a new user's
   ratings posted through the event server are servable through the
   balancer within 30 s; ``pio undeploy`` stops the balancer and both
   replicas (none answers after) and the child exits, having launched B1,
   B3 and B2. Beside those two deploys, ``pio batchpredict`` over every
   user (``--input``, chunks of 16): a clean run, a run killed with
   SIGKILL once its journal holds a chunk, and its rerun, which must
   resume at least one chunk and give shards equal to the clean run's;
   the seconds the overlap hides are printed. Then the
   crash trio starts, and runs beside phases 6c and 6d (their checks
   wait for it after 6d): ``pio train --precision bf16 --checkpoint-dir
   D --checkpoint-every 1``, each save held 2 s by ``PIO_FAULTS``
   (slow), is killed with SIGKILL once its second checkpoint lands;
   ``pio train ... --resume`` must give factors bitwise equal to an
   uninterrupted ``pio train --precision bf16`` (the third process, run
   beside the pair), and ``pio runs list`` / ``show`` one run whose
   steps rise to 3.
6c. ``pio eval`` through the console at ML-1M, on phase 6b's store: a
   ``pio-torch eval --grid`` child (rank 32 / 64 x lambda 0.01 / 0.1, 10
   iterations) exits 0 and writes the leaderboard, whose winner carries
   full ``engineParams``; a ``pio-torch eval chip_smoke:ml1m_evaluation``
   child (the template's ``RecommendationEvaluation`` over the app, on a
   ``FastEvalEngine``) exits 0, writes ``best.json`` and stores an
   ``EVALCOMPLETED`` evaluation instance, its batch prediction launching
   B1's batched route; each param set's Precision@10 equals the one
   scored in this process on the same trained factors with B1 and with
   its plain version. ``pio dashboard`` (a child) lists the
   ``EVALCOMPLETED`` instance, and ``pio adminserver`` creates, lists
   and deletes an app.
6d. The networked event store at ML-1M (phase 6's ratings, rank 64, 3
   iterations): three ``pio-torch eventserver`` children, each over a
   ``jsonlfs`` directory of its own with the storage wire on, are the
   shards of a ``fleet`` source (the consistent-hash ring routes each
   user's events to one); a fourth is a ``resthttp`` source. The
   ratings are filled straight into the shards along the ring, into the
   fourth server's store and into a local ``jsonlfs`` store, but for the
   last 100,000, which go through ``FleetLEvents.insert_batch`` and
   ``RestLEvents.insert_batch`` (events/s and each shard's share against
   the ring's are printed). ``create_workflow`` trains in process from
   the local, the ``resthttp`` and the ``fleet`` source from one
   injected init (B3 and B2 launch; the dase spans' read, prepare and
   train seconds and the bytes each shard shipped are printed); the
   networked factors must be bitwise the local ones when the training
   data read back byte-equal, else within 1e-4 of the largest entry.
   The fleet-trained instance is deployed with fold-in over the
   ``fleet`` source: 30 new users' events, posted through the fleet in
   one write, must be servable within 30 s p99 (the fold reads each
   user from the user's shard). Then one shard is killed with SIGKILL:
   queries keep answering (their ``degradedReasons`` printed), a write
   to its users fails loud, a child posting 4 of its users' events
   retries across the outage, and a gateway event server over that
   shard reads ``/healthz`` storage: false once the breaker opens. The
   shard restarts on its directory: the breaker closes, ``/healthz``
   reads true, the 4 users are folded with no event lost (the delay is
   printed). Every folded row must equal the plain fold's (within
   ``FOLDIN_ROW_TOL``) and the answers the plain top-k of the patched
   store. Last, an entity read of one shard's store, by the byte search
   and by the whole parse it replaced, is timed on the same user; and
   the registry's wrapped DAO over the local store, its entity reads and
   50-event ``insert_batch`` writes, with ``PIO_RESILIENCE`` on and off
   in turns.
6e. The other templates at ML-1M on a fresh sqlite store: one ``view``
   per rating of ``ml1m_ratings`` plus 1% viewed twice, a ``buy`` per
   rating of 4.5 stars or more, a ``$set`` per user and per item (its
   categories and a year) and a ``constraint/unavailableItems`` ``$set``
   of 50 items. ``create_workflow`` trains, at the published engine.json
   parameters (rank 10, 20 iterations, lambda 0.01), similarproduct's
   ALS and ecommercerecommendation's (``unseenOnly``) on the uniform
   tables: each must launch B3 and B2 20 x 2 times (one launch a side an
   iteration), and its factors must be within 1e-4 of the largest entry
   of the plain trainer's on the card from the same init; B3 and B2 are
   timed at those tables' shapes (kernel, plain, library, bound). DIMSUM
   on the same views (a dense [6,040, 3,706] fp32 product on the card)
   must be within 1e-5 of a float64 oracle on 64 sampled columns.
   textclassification trains on a synthetic corpus at 20 Newsgroups'
   size (18,846 documents, 20 classes with overlapping vocabularies) at
   the template's defaults: its loss must fall and its held-out accuracy
   beat the majority class, and one epoch on the card must be within
   1e-5 of each tensor's largest entry of the same epoch on the CPU from
   one init and one set of permutations. classification, regression,
   friendrecommendation and helloworld train on small fixtures. Each
   template is deployed through ``QueryServer`` and answers 50
   sequential HTTP queries equal to its in-process answers (ids equal,
   scores within 1e-5 relative; p50 / p99 printed); after deploy a new
   ``unavailableItems`` ``$set`` must drop those items from ecommerce's
   next answer. Each training's read, prepare and train seconds and
   launches and the device memory peak are printed.
7. Model quality on ``bench_quality.run``'s protocol at its shape
   (943 x 1,682 x 100,000, leave-last-2-out, rank 32, 10 iterations):
   Precision@10 and NDCG@10 of the port's trainer at seeds 3, 17 and
   42, its ratio to the plain trainer from seed 3's init (must be
   0.99-1.01) and the seed band's lift over popularity (must exceed 1);
   the bf16 lane's Precision@10 from seed 3 must be at least fp32's
   minus 0.02 (the JAX package's gate). Its sequence half copies
   ``bench_quality.run_seqrec_check`` and ``run_twostage_check`` (200
   Markov walks over 100 items): the seqrec loss must fall, its P@10
   must beat popularity's, and two-stage NDCG@10 through
   ``TwoStageTopK`` at N = the catalog (fp32 store) must reach max(ALS
   alone, seqrec alone). Before it, 48 steps of the walks' training on
   the card are held to the CPU's on one θ and one set of draws: one
   step's loss and gradients, the loss traces and the users' encodes,
   each limit checked against the CPU's fp32 run beside an fp64 replay
   (inside) and a bf16-rounded control (outside).
8a. The host/device crossover (after 4b): ``HostTopK.user_topk`` and
   ``DeviceTopK.user_topk`` (an fp32 store, micro-batched with its
   window) on synthetic rank-64 factors at 3,706 (ML-1M), 4,096, 8,192,
   16,384, 26,744 (ML-20M width), 32,768, 65,536 and 262,144 items:
   100 sequential queries (p50 / p99) and 320 from 8 threads (q/s) on
   each lane, twice with the lanes in turns (the readings are the two
   rounds' means), every sequential answer equal between the lanes (ids, and
   scores within 1e-5 relative). It prints the table and the largest
   power of two of item-factor elements up to which the host lane was
   no slower in both readings, beside ``HOST_SERVE_MAX_ELEMS``; it does
   not fail on timing. At 3,706 and 16,384 items it also times the
   batch lane, one ``users_topk`` of 6,040 uids on each lane (answers
   equal). Every serving phase forces
   ``PIO_SERVING_BACKEND=device`` (set once at the start, inherited by
   the children), so the ``auto`` rule never moves them off B1.
8b. Sharded serving: phase 5's model in a 4-shard density-aware layout
   on ``[cuda:0] * 4`` (bf16; each logical shard is the card and
   launches B1 on its own 6,688-position block). Phase 3's 43 sequential
   queries and 256 user queries from 8 threads through the template's
   predict must agree with the plain sharded lane on the CPU (the same
   store on ``["cpu"] * 4``) and, as score sets, with the unsharded
   store; B1 must launch 4 times a dispatch. 8 new users are folded (B3
   and B2 on each store's item view: equal rows) and patched into both
   stores, the sharded one growing by a reshard; their answers agree as
   score sets. A one-rank NCCL process group joins, all-reduces and
   leaves. B1's sharded route is timed at k = 16, B = 1 and 256: one
   shard's launch, a dispatch with the merge (event-timed, and the
   card's busy and B1 time under the profiler), plain, the library's
   (each shard's seen hits, its block widened to fp32, the masked
   product and ``torch.topk``, then ``torch.topk`` of the joined lists,
   all inside the timed call) and the bound.
8c. Sharded training (after 8b) on ``[cuda:0] * 4``, each logical shard
   the card launching B3 and B2 on its own row block: (a)
   ``train_als_bucketed_sharded`` on phase 5's bucketed sides at rank 64,
   3 iterations, phase 5's seed: the factors must equal phase 5's
   (relative Frobenius error at most 1e-6; the largest difference is
   printed), B3's and B2's launches must equal the plan (per bucket, one
   per shard whose block holds a real row), and one sharded iteration is
   event-timed and profiled (the card's busy share) beside phase 5's
   single-device one, timed in the same way here. (b)
   ``train_als_sharded_2d`` on ``mesh_2d(2, 2)`` at ML-1M width (the
   uniform tables of ``ml1m_ratings``: 6,040 and 3,706 rows) against
   ``train_als`` on the card under the same limit, and
   ``train_als_device`` on that mesh: each device holds half of each
   padded factor table. (c) ``sharded_engine_factory``'s
   ``ALSShardedAlgorithm.train`` on phase 5's prepared data over a
   context of ``[cuda:0] * 4``: a ``ShardedALSModel`` whose factor
   tables are on the card; phase 3's 43 sequential queries through the
   template's predict agree as score sets with phase 5's model, B1
   launches 4 times a dispatch, and one ``batch_predict`` of 256 known
   users gives the looped path's records. (d) A one-rank NCCL process
   group: (b)'s problem trains through the collective merge (the
   uniform all-gather) and must equal (b)'s single-device factors
   bitwise. ``--sharded`` runs phases 1, 8a, 5, 8b and 8c alone,
   ``--crossover`` phases 1 and 8a.
8d. Sequence parallelism and two-stage serving over shards (after 3f's
   serving), on ``[cuda:0] * 4``. (a) Phase 3e's θ and buckets encoded
   with ``sp_mode`` ring, ulysses and auto over that mesh (each layer's
   attention sequence-parallel, the rest on the card once), beside the
   dense encode: each within rtol 2e-4 / atol 1e-5 (JAX's
   ``TestMeshLane.TOL``) of 3e's encode; seconds, the largest score
   block and the peak device memory of each. (b) Phase 3f's models
   deployed over a context of the 4 devices with ``PIO_SERVE_SHARDS=4``
   (bf16, N = 128): 43 sequential queries and 256 from 8 threads, each
   answer equal to the plain pipeline (B1's plain version on each
   shard, then the same re-rank); B1 must launch 4 times a two-lane
   dispatch at k = N; ``stage_times``' B1 (all shards) and stage-2 µs,
   a lone dispatch event-timed and profiled; B1 unmasked at k = 128 on
   each shard against its plain version, the whole stage 1 at B = 8
   timed against plain, the library's and its bound; a composite fold
   of 4 new users growing the store by a reshard, their answers equal
   to the plain pipeline's. (c) Ulysses' collectives
   (``all_to_all_single``, ``all_gather``) through a one-rank NCCL
   group on 1,024 users of the longest class, within (a)'s tolerance.
   ``--sequence-parallel`` runs phases 1, 5's store, 3e's and 3f's
   training and 8d alone.

It prints a ``{"kernels": [...]}`` line (the training kernels' ``routes``
hold the main path's, the large-rank one and ``foldin``, with phase 3b's
launches, the config grid's, with phase 5d's, and the assembly's
``tiles_bf16``, with phase 5c's; the serving kernel's ``eval_routes``
hold ``grid_topk`` and ``batch_predict``, with phases 5d's and 6c's,
and its ``batch_routes`` phase 3c's and 6b's ``pio batchpredict``;
every kernel's ``networked_launches`` phase 6d's, and its
``fleet_launches`` phase 3d's and 6b's fleet child's; the training
kernels' ``fleet_roll_training`` phase 3d's training of the instance
the roll swaps to; the serving kernel's ``sequence_launches`` and
``unmasked_k128`` phases 3e's and 3f's, the training kernels'
``twostage_launches`` phase 3f's; the serving kernel's
``sharded_route`` phase 8b's launches and times and its
``twostage_sharded_route`` phase 8d's, the training kernels'
``sharded_training`` phase 8c's launches, ms per iteration and busy
share; the serving kernel's tiled route, ``score_select_tile_kernel``,
an entry of its own: its launches in phase 3c, by phase with 3's and
5d's, its times at the headline shape beside the bitonic route's in 4c,
and at ``grid_topk``'s shape), the card's name
and power limit, and last ``{"ok": true, "device": {...}}``. With
``--query-fleet`` the script builds and runs phases 5 and 3d alone;
with ``--seqrec`` phase 5's store, 3e, 3f and phase 7's sequence half;
with ``--read-paths`` phase 5's store and 3e's read and prepare two
ways.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
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
# phase 2's store for the tiled route's last chunk of one item
TILED_ONE_ITEM = 1024 * 26 + 1
# phase 2's other ranks for the tiled route: 10 (per-value loads on every
# store) and 40 (vectorised; the last of three bf16 rank blocks partial)
TILED_RANKS = (10, 40)
ITERATIONS, LAMBDA, ALPHA = 3, 0.01, 1.0
# phase 2b's other assembly ranks: one warp a block at 1 and 10, up to
# the kernel's limit on an H100 (208)
OTHER_RANKS = (1, 10, 30, 128, 208)
# the assembly's tile-group route (above 208; 385: four bands, the last
# of one column), and the solve's ranks besides 64: one warp a system up
# to 239, one block from 240 (both sides of the 256-column chunk) to 339,
# the block route in device memory from 340
LARGE_RANKS = (209, 256, 320, 385)
SOLVE_RANKS = (1, 31, 32, 33, 65, 239, 240, 241, 256, 320, 339, 340, 384)
# of them, the edges of the block route's shared memory and the ranks
# beyond (phase 2b prints their seconds)
EDGE_RANKS = (339, 340, 384, 385)
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
# copy of 8 values), the tile route's limit (208) and the tile-group
# route above it
BF16_RANKS = (1, 7, 10, 30, 33, 63, 64, 65, 127, 128, 208, 209, 256, 320,
              385)
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


def fixture(kind: str, B: int, rng, rank: int = RANK):
    """Queries, item table, seen [L, B] tables for one phase-2 case."""
    L = 64
    if kind == "random":
        Q = rng.normal(size=(B, rank)).astype(np.float32)
        Y = rng.normal(size=(M_ITEMS, rank)).astype(np.float32)
    else:
        # small integers: every score is an exact integer, ties abound;
        # rows 120..219 are one row that wins every query, so the top
        # ties straddle the 128-row tile boundary
        Q = rng.integers(1, 4, (B, rank)).astype(np.float32)
        Y = rng.integers(-3, 4, (M_ITEMS, rank)).astype(np.float32)
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
                    # mask off: every case on the integer fixture, and
                    # two-stage serving's stage 1 (bf16, k = 128) on both
                    both = kind == "integer" or (dtype == "bf16"
                                                 and k == 128)
                    for mask_seen in (True, False)[:2 if both else 1]:
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
    t = time.perf_counter()
    tiled_cases = tiled_route_checks(dev, rng)
    print(f"[phase] 2 of it, the tiled route's checks ({tiled_cases} "
          f"cases): {time.perf_counter() - t:.1f} s")
    cases += tiled_cases
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


def tiled_route_checks(dev, rng) -> int:
    """The tiled route's edges, each exact on integer data at B = 100
    (the last tile of 16 queries holds 4; kernel_checks and
    chunked_route_checks cover B = 256), every launch on the tiled route:
    top scores tied across the 1,024-item chunk edges
    and in the last chunk (120 items: shorter than k = 128), seen ids on
    both sides of an edge, on fp32, bf16 and int8 stores; a store of
    1,024 * 26 + 1 items (a last chunk of one item, which wins); n_items
    cut inside a chunk with row_valid; rows with all but 5 items seen;
    and ranks off the staging's 16-byte pieces and whole rank blocks
    (``TILED_RANKS``): R = 10 (the templates' rank: per-value loads on
    every store, a partial last rank block) and R = 40 (vectorised
    loads, a partial last bf16 block of 16 ranks)."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    before = als_cuda.launches.by_key()
    cases = 0
    one, B = TILED_ONE_ITEM, 100
    Q, Yf, cols, mask = fixture("integer", B, rng)
    for lo, hi in ((1020, 1030), (5110, 5125), (M_ITEMS - 50, M_ITEMS)):
        Yf[lo:hi] = 5.0
    cols[4:8] = np.asarray([1022, 1024, 5119, 5120])[:, None]
    Qt, ct, mt = (torch.from_numpy(a).to(dev) for a in (Q, cols, mask))
    for dtype in ("fp32", "bf16", "int8"):
        store, _ = make_store(Yf, dtype, dev)
        for k in (1, 16, 128):
            topk_case(Qt, store, ct, mt, k=k, n_items=M_ITEMS)
            cases += 1
    Y1 = Yf[:one].copy()
    Y1[-1] = 9.0
    store, _ = make_store(Y1, "int8", dev)
    cs = torch.from_numpy(cols % one).to(dev)
    rv = torch.from_numpy((rng.random(one) < 0.8).astype(np.float32)
                          ).to(dev)
    for k in (16, 128):
        topk_case(Qt, store, cs, mt, k=k, n_items=one, m=one)
        topk_case(Qt, store, cs, mt, k=k, n_items=20_000, m=one,
                  row_valid=rv)
        cases += 2
    store, _ = make_store(Yf, "fp32", dev)
    L = M_ITEMS - 5
    many = np.stack([rng.permutation(M_ITEMS)[:L] for _ in range(B)],
                    axis=1).astype(np.int32)
    ct = torch.from_numpy(many).to(dev)
    for k in (16, 128):
        topk_case(Qt, store, ct, torch.ones((L, B), device=dev), k=k,
                  n_items=M_ITEMS)
        cases += 1
    for rank in TILED_RANKS:
        Q, Yf, cols, mask = fixture("integer", B, rng, rank=rank)
        Yf[1020:1030] = 5.0
        Qt, ct, mt = (torch.from_numpy(a).to(dev) for a in (Q, cols, mask))
        for dtype in ("fp32", "bf16", "int8"):
            store, _ = make_store(Yf, dtype, dev)
            for k in (16, 128):
                topk_case(Qt, store, ct, mt, k=k, n_items=M_ITEMS)
                cases += 1
    after = als_cuda.launches.by_key()
    routes = {key[0] for key in after if after[key] != before.get(key, 0)}
    if routes != {"tiled"}:
        raise AssertionError(f"the tiled route's checks launched {routes}")
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


def power_law_draws(rng, n_items: int, size: int) -> np.ndarray:
    """``rng.choice(n_items, size, p=pop / pop.sum())`` for the power-law
    popularity ``pop``, by numpy's own steps (the cumulative sum of p,
    normalised by its last entry, and the count of its entries <= each of
    ``size`` uniform samples from ``rng.random``), the count taken from a
    table of 2^20 equal buckets of [0, 1) instead of a binary search: the
    same draws, from the same random numbers, several times faster."""
    pop = 1.0 / (np.arange(n_items) + 10.0) ** 0.8
    cdf = (pop / pop.sum()).cumsum()
    cdf /= cdf[-1]
    u = rng.random(size)
    K = 1 << 20
    # bucket b = floor(u K) holds b / K <= u < (b + 1) / K exactly (K is a
    # power of two): the entries below b / K count, those from (b + 1) / K
    # do not, and the few between are compared one by one
    edges = np.searchsorted(cdf, np.arange(K + 1) / K, side="left")
    b = (u * K).astype(np.int64)
    idx = edges[b]
    width = edges[b + 1] - idx
    for t in range(int(width.max())):
        idx += (t < width) & (cdf[np.minimum(idx, n_items - 1)] <= u)
    return idx


def power_law_pairs(rng, lens, n_items: int) -> tuple:
    """(rows, cols): each user's ``lens[u]`` distinct items, drawn by a
    power-law popularity twice over (:func:`power_law_draws`), first
    occurrences kept in draw order and cut to length."""
    n_users = len(lens)
    draws = power_law_draws(rng, n_items, int(2 * lens.sum()))
    user_of = np.repeat(np.arange(n_users), 2 * lens)
    key = user_of * n_items + draws
    order = np.argsort(key, kind="stable")
    first = np.ones(len(key), dtype=bool)
    sorted_key = key[order]
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    del sorted_key
    kept = np.zeros(len(key), dtype=bool)
    kept[order[first]] = True
    kept = np.flatnonzero(kept)             # first draws, in draw order
    users = user_of[kept]
    starts = np.flatnonzero(np.r_[True, users[1:] != users[:-1]])
    rank = np.arange(len(kept)) - np.repeat(starts, np.diff(np.r_[
        starts, len(kept)]))                # a user's earlier draws
    sel = rank < lens[users]
    return users[sel], draws[kept][sel]


def power_law_ratings(rng, lens, n_items: int):
    """:func:`power_law_pairs`, 0.5 to 5.0 stars, and 1-3 of 20 genres
    per item."""
    rows, cols = power_law_pairs(rng, lens, n_items)
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


# RATE_LINE around its three fields (user, item, stars), and the stars'
# text ("0.0" ... "5.0")
RATE_PIECES = RATE_LINE.format("\0", "\0", "\0").split("\0")
STAR_TEXT = [repr(k / 2) for k in range(11)]


def decimal_table(n: int) -> np.ndarray:
    """``[n, w]`` uint8: the decimal digits of 0..n-1, each row
    left-padded with zero bytes (dropped from the lines afterwards)."""
    w = len(str(n - 1))
    v = np.arange(n)
    ndig = 1 + sum((v >= 10 ** k).astype(np.int64) for k in range(1, w))
    out = np.zeros((n, w), np.uint8)
    for k in range(w):
        out[:, k] = np.where(k >= w - ndig, 48 + (v // 10 ** (w - 1 - k)) % 10,
                             0)
    return out


def rate_lines(users: np.ndarray, items: np.ndarray, stars: np.ndarray,
               tables: tuple) -> list:
    """``RATE_LINE.format(u, i, STAR_TEXT[s])`` for every rating, built
    by numpy with no Python call a line: each line is a row of bytes, a
    copy of one template (the fixed pieces and a newline) into which the
    user's and item's digits and the stars from ``tables`` are written,
    whose zero pad bytes are then dropped; the lines come from one
    decode and one split."""
    fields = [t[v] for t, v in zip(tables, (users, items, stars))]
    parts, at = [], []
    for piece, field in zip(RATE_PIECES, fields + [None]):
        parts.append(np.frombuffer(piece.encode(), np.uint8))
        if field is not None:
            at.append(sum(len(q) for q in parts))
            parts.append(np.zeros(field.shape[1], np.uint8))
    template = np.concatenate(parts + [np.frombuffer(b"\n", np.uint8)])
    rows = np.broadcast_to(template, (len(users), len(template))).copy()
    for a, field in zip(at, fields):
        rows[:, a:a + field.shape[1]] = field
    lines = rows.tobytes().replace(b"\0", b"").decode().split("\n")
    lines.pop()    # after the last newline
    return lines


def ml20m_store(seed: int) -> dict:
    """Phase 5's event store: the ML-20M-width ratings as ``rate`` events
    in a seeded random order (a live stream interleaves its users) and
    one ``$set`` of genres per item, appended with ``append_raw_lines``
    to a ``jsonlfs`` store in a temporary directory (1,000,000 events a
    partition; metadata and models in memory). The rate lines are built
    by :func:`rate_lines`, timed apart from the appends, and a CRC-32 of
    the partitions' bytes, in order, is printed. Fails before writing when the directory's disk
    lacks room; the caller removes it."""
    import os
    import tempfile
    import zlib

    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.storage.base import App

    t0 = time.perf_counter()
    rows, cols, values, cats = ml20m_ratings(seed)
    ratings_s = time.perf_counter() - t0
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
    root = levents._dir(app_id, None)
    order = np.random.default_rng(seed + 11).permutation(len(rows))
    stars = np.rint(values * 2).astype(np.int64)
    t1 = time.perf_counter()
    tables = (decimal_table(int(rows.max()) + 1),
              decimal_table(int(cols.max()) + 1),
              np.array([list(t.encode()) for t in STAR_TEXT], np.uint8))
    build_s, crc, summed = time.perf_counter() - t1, [0], []

    def add_crc(path: str) -> None:     # the partitions' bytes, in order
        with open(path, "rb") as f:
            for block in iter(lambda: f.read(1 << 24), b""):
                crc[0] = zlib.crc32(block, crc[0])

    def sum_parts(last: bool) -> None:  # the partitions no append will grow
        parts = levents._parts(root)
        for path in parts[len(summed):None if last else -1]:
            summed.append(path)
            crc_thread.submit(add_crc, path)

    # the CRC reads each finished partition back on a thread of its own
    # (reads and zlib let go of the interpreter lock) while the next one
    # is built
    with concurrent.futures.ThreadPoolExecutor(1) as crc_thread:
        for a in range(0, len(order), ML20M_PART):
            pick = order[a:a + ML20M_PART]
            t1 = time.perf_counter()
            lines = rate_lines(rows[pick], cols[pick], stars[pick], tables)
            build_s += time.perf_counter() - t1
            levents.append_raw_lines(lines, app_id)
            sum_parts(False)
        levents.append_raw_lines([SET_LINE.format(iid[1:], json.dumps(list(c)))
                                  for iid, c in cats.items()], app_id)
        sum_parts(True)
    write_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(path) for path in summed)
    print(f"[store] {len(rows)} ratings drawn in {ratings_s:.2f} s; "
          f"{len(rows)} rate events in a seeded random order and "
          f"{len(cats)} $set events written to a jsonlfs store in "
          f"{write_s:.2f} s (the rate lines built in {build_s:.2f} s): "
          f"{len(summed)} partitions, "
          f"{nbytes} bytes ({nbytes / (len(rows) + len(cats)):.1f} a line), "
          f"CRC-32 {crc[0]:08x}; {free / 1e9:.1f} GB were free")
    return {"work": work, "app_id": app_id, "n_ratings": len(rows),
            "write_s": write_s, "build_s": build_s,
            "ratings_s": ratings_s, "crc32": f"{crc[0]:08x}",
            "bytes": nbytes,
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
    # the stored instance outlives the store: phase 3c deploys it again
    models_blob = storage.get_model_data_models().get(iid)
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
            "instance": instance, "models_blob": models_blob,
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
    from predictionio_tpu_torch.ops import als_cuda, aot
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
    # the warm-up captured the iteration on the staged tables (the
    # timeline's warmup_compile: the libraries are built already)
    pool = aot.train_pool(dev)
    stages = timeline.summary()["stages"]
    warm = {"capture_s": stages["warmup_compile"]["busy_sec"],
            "wait_s": stages["warmup_wait"]["busy_sec"],
            "programs": len(als_mod._aot_bucketed),
            "pool_bytes": pool.nbytes()}
    if warm["programs"] != 1:
        raise AssertionError(f"the ingest's warm-up cached "
                             f"{warm['programs']} iteration programs")
    n_buckets = len(res.user_side.buckets) + len(res.item_side.buckets)
    calls = {"parse_jsonl": codec.parse_calls.value}
    for counter in (als_cuda.assemble_launches, als_cuda.spd_launches,
                    als_cuda.graph_launches):
        counter.reset()
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
    calls.update(replayed_launches(n_buckets * ITERATIONS, "phase 5b"))
    if calls["parse_jsonl"] == 0:
        raise AssertionError("parse_jsonl was never called in phase 5b")
    print(f"[ingest] staged tables byte-equal to the preparator's; warm-up "
          f"{warm['capture_s']!r} s (the capture; joined after "
          f"{warm['wait_s']!r} s), {warm['programs']} "
          f"program, training pool {warm['pool_bytes']} bytes; "
          f"train_als_bucketed on them {train_s:.2f} s, a cache hit: B3 and "
          f"B2 {n_buckets} times an iteration each, all by replays; factors "
          f"bitwise equal to phase 5's (eager); calls {calls}")
    u_t = bucket_tables(res.user_side, dev)
    i_t = bucket_tables(res.item_side, dev)
    X0, Y0 = als_mod.init_factors(N_USERS, M_ITEMS, RANK, seed, dev)
    kw = dict(lam=LAMBDA, alpha=ALPHA, implicit=True, slot_budget=None)
    ladder = replay_against_eager(
        lambda: als_mod.als_iterations_bucketed(X0, Y0, u_t, i_t,
                                                num_iterations=1, **kw),
        lambda: als_mod._als_iterations_bucketed_impl(
            X0, Y0, u_t, i_t, num_iterations=1, **kw),
        n_buckets, "an iteration at ML-20M width")
    del u_t, i_t, X0, Y0
    clear_training_programs()
    return {"ingest_s": ingest_s, "events": res.n_events,
            "stages": stage_busy(summary), "overlap": busy / ingest_s,
            "staging": staging, "warm": warm, "train_s": train_s,
            "launches": calls, "ladder": ladder}


LADDER_ITERATIONS = 20     # iterations timed a mode, in LADDER_ROUNDS rounds
GRID_LADDER_ITERATIONS = 4  # the same for the grid (~170 ms an iteration)


def replayed_launches(want: int, label: str) -> dict:
    """B3's and B2's launches since their counters were reset, each
    ``want`` and every one by a replay of a training program (a cache
    hit: ``graph_launches`` holds them too)."""
    from predictionio_tpu_torch.ops import als_cuda

    by_replay = {"assemble_launches": 0, "spd_launches": 0}
    for (counter, _), n in als_cuda.graph_launches.by_key().items():
        if counter in by_replay:
            by_replay[counter] += n
    out = {"assemble_normal_equations": als_cuda.assemble_launches.value,
           "spd_solve": als_cuda.spd_launches.value,
           "assemble_by_replay": by_replay["assemble_launches"],
           "spd_by_replay": by_replay["spd_launches"]}
    if not (out["assemble_normal_equations"] == out["assemble_by_replay"]
            == out["spd_solve"] == out["spd_by_replay"] == want):
        raise AssertionError(f"{label}: launches {out}, want {want} of each, "
                             "all by replays")
    return out


def clear_training_programs() -> None:
    """Drop every warmed training program (their graphs and the pool's
    scratch go with them) before the next phase."""
    import torch

    from predictionio_tpu_torch.ops import als as als_mod

    als_mod.clear_training_programs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def replay_against_eager(replay, eager, per_iteration: int, label: str,
                         iterations: int = LADDER_ITERATIONS) -> dict:
    """One training iteration as a replay of its warmed program against
    the same iteration run eagerly, ``iterations`` of each in
    ``LADDER_ROUNDS`` alternating rounds: the median of each iteration's
    CUDA-event window (events around the call on its stream, so host
    gaps between eager launches count) and of its wall (host clock to a
    synchronize); then one of each under the profiler, the device's busy
    share. ``replay`` must launch B3 and B2 ``per_iteration`` times each
    by replay, ``eager`` none, and the first call of each must give
    bitwise the same factors (both start from the same carries)."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    got = {m: {"event": [], "wall": []} for m in ("replay", "eager")}
    calls = {"replay": replay, "eager": eager}
    # the replay's outputs are its static carries: copied out before the
    # eager call, which the graph's next replay would overwrite
    replayed = [t.clone() for t in replay()]
    for name, r, e in zip(("user", "item"), replayed, eager()):
        if r.shape != e.shape or r.dtype != e.dtype or not torch.equal(
                r.contiguous().view(torch.uint8),
                e.contiguous().view(torch.uint8)):
            raise AssertionError(f"{label}: the replay's {name} factors "
                                 "differ from the eager iteration's")
    per = iterations // LADDER_ROUNDS
    for _ in range(LADDER_ROUNDS):
        for mode, fn in calls.items():
            for _ in range(per):
                torch.cuda.synchronize()
                g0 = als_cuda.graph_launches.value
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t = time.perf_counter()
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                got[mode]["wall"].append((time.perf_counter() - t) * 1e3)
                got[mode]["event"].append(start.elapsed_time(end))
                n = als_cuda.graph_launches.value - g0
                if n != (2 * per_iteration if mode == "replay" else 0):
                    raise AssertionError(f"{label}: {mode} made {n} "
                                         "launches by replay")
    out = {}
    for mode, fn in calls.items():
        wall, busy, kernels, kernel_ms = device_busy(fn)
        out[mode] = {"event_ms": float(np.median(got[mode]["event"])),
                     "wall_ms": float(np.median(got[mode]["wall"])),
                     "profiled_wall_ms": wall, "busy_ms": busy,
                     "busy_share": busy / wall,
                     "kernels": sum(kernels.values()),
                     "kernel_ms": dict(kernel_ms.most_common(8)),
                     **b3_b2_ms(kernel_ms),
                     "n": len(got[mode]["wall"])}
    r, e = out["replay"], out["eager"]
    print(f"[ladder-train] {label}, replay against eager (factors "
          f"bitwise equal; medians of "
          f"{r['n']}): event {r['event_ms']!r} / {e['event_ms']!r} ms, wall "
          f"{r['wall_ms']!r} / {e['wall_ms']!r} ms; profiled: busy "
          f"{r['busy_ms']!r} of {r['profiled_wall_ms']!r} ms "
          f"({100 * r['busy_share']:.2f}%) against {e['busy_ms']!r} of "
          f"{e['profiled_wall_ms']!r} ms ({100 * e['busy_share']:.2f}%), "
          f"{r['kernels']} / {e['kernels']} kernels, B3 {r['B3']!r} / "
          f"{e['B3']!r} ms, B2 {r['B2']!r} / {e['B2']!r} ms")
    return out


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


def assembly_kinds(dev, rng, Yt, Yi, cols, aw, bw, explicit: bool, label: str,
                   bf16: bool = False) -> float:
    """B3 against plain on one table in two kinds: trained (or random)
    factors ``Yt`` with the training's Gram term, and integer factors
    ``Yi`` with an integer one (exact); with ``bf16`` both as a bf16
    store on the bf16 lane's rounded weights (B3's bf16 route). Returns
    the largest |error|."""
    import torch

    from predictionio_tpu_torch.ops.als import _round_bf16

    if bf16:    # B3's bf16 route, on the weights the bf16 lane gives it
        Yt, Yi = Yt.to(torch.bfloat16), Yi.to(torch.bfloat16)
        aw, bw = _round_bf16(aw), _round_bf16(bw)
    worst = 0.0
    for kind, Y in (("trained", Yt), ("integer", Yi)):
        R = Y.shape[1]
        if kind == "integer":
            gram = torch.from_numpy(rng.integers(
                -4, 5, (R, R)).astype(np.float32)).to(dev)
        elif explicit:
            gram = torch.zeros((R, R), device=dev)
        else:
            gram = Y.float().T @ Y.float() + LAMBDA * torch.eye(R, device=dev)
        check = check_assembly_bf16 if bf16 else check_assembly
        worst = max(worst, check(
            Y, cols, aw, bw, gram, kind == "integer",
            f"{label} explicit={explicit} {kind}" + (" bf16" if bf16 else "")))
    return worst


def rank_assembly_checks(dev, rng, ranks, bf16_ranks) -> tuple:
    """B3 at other ranks than the main path's, random and integer
    factors, on 300 x 40 rows (grouped) and 9 x 5,000 (split into
    spans): fp32 at ``ranks``, the bf16 route at ``bf16_ranks``. Returns
    (largest |error|, cases, bf16 cases, seconds by rank)."""
    import torch

    worst, cases, seconds = 0.0, {False: 0, True: 0}, {}
    for bf16, rs in ((False, ranks), (True, bf16_ranks)):
        for R in rs:
            t = time.perf_counter()
            # the factors drawn on the device (from a seed off rng)
            g = torch.Generator(dev).manual_seed(int(rng.integers(1 << 31)))
            Yr = 0.3 * torch.randn((M_ITEMS, R), device=dev, generator=g)
            Yi = torch.randint(-3, 4, (M_ITEMS, R), device=dev,
                               generator=g).float()
            for cols, aw, bw, label in synthetic_rows(dev, rng,
                                                      ((300, 40), (9, 5_000))):
                worst = max(worst, assembly_kinds(
                    dev, rng, Yr, Yi, cols, aw, bw, False, f"R={R} {label}",
                    bf16=bf16))
                cases[bf16] += 2
            del Yr, Yi
            seconds[R] = seconds.get(R, 0.0) + time.perf_counter() - t
    return worst, cases[False] + cases[True], cases[True], seconds


def grid_tile_group_check(dev, rng, R: int = 256, k: int = 2) -> int:
    """The config grid's assembly above the tiles route's rank: one
    launch of the tile-group route for ``k`` configs (the config in
    blockIdx.y), each config bitwise its own single-config launch, on
    grouped rows (300 x 40) and split rows (9 x 5,000). Returns the
    cases."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    cases = 0
    for cols, aw, bw, label in synthetic_rows(dev, rng,
                                              ((300, 40), (9, 5_000))):
        g = torch.Generator(dev).manual_seed(int(rng.integers(1 << 31)))
        Y = 0.3 * torch.randn((k, M_ITEMS, R), device=dev, generator=g)
        gram = torch.stack([Y[z].T @ Y[z] for z in range(k)])
        aws = torch.stack([aw * (z + 1) for z in range(k)])
        bws = torch.stack([bw * (z + 1) for z in range(k)])
        before = als_cuda.assemble_launches.by_key().get(
            ("tile_groups_grid", "fp32"), 0)
        A, b = als_cuda.assemble_normal_equations_grid(Y, cols, aws, bws, gram)
        if als_cuda.assemble_launches.by_key().get(
                ("tile_groups_grid", "fp32"), 0) != before + 1:
            raise AssertionError(f"grid R={R} {label}: not one tile-group "
                                 f"grid launch")
        for z in range(k):
            Az, bz = als_cuda.assemble_normal_equations(Y[z], cols, aws[z],
                                                        bws[z], gram[z])
            if not (torch.equal(A[z], Az) and torch.equal(b[z], bz)):
                raise AssertionError(f"grid R={R} {label} config {z}: not "
                                     f"bitwise its single launch")
        cases += 1
    return cases


def spd_systems(dev, B: int, R: int = RANK, ill: bool = False) -> tuple:
    """B random SPD systems of rank R on the card (seeded), or an
    ill-scaled family."""
    import torch

    G = torch.randn((B, R, R), device=dev,
                    generator=torch.Generator(dev).manual_seed(B + R))
    A = G @ G.transpose(1, 2)
    if ill:
        A = A * 10.0 ** (torch.rand((B, 1, 1), device=dev) * 4 - 2) \
            + 0.01 * torch.eye(R, device=dev)
    else:
        A = A / R + torch.eye(R, device=dev)
    return A, torch.randn((B, R), device=dev)


def solve_plan_of(dev, R: int):
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    props = torch.cuda.get_device_properties(dev)
    return als_cuda.spd_solve_plan(R, props.shared_memory_per_block_optin,
                                   props.multi_processor_count)


def solve_checks(dev, cases: list) -> list:
    """B2 on each ``(label, (A, b))``: bitwise equal to the plain version
    (the kernels repeat its operations entry by entry) and a small
    residual. Returns (label, route, residual, rank, seconds) of each."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    results = []
    for label, (A, b) in cases:
        t = time.perf_counter()
        R = b.shape[1]
        x = als_cuda.spd_solve(A, b)
        torch.cuda.synchronize()
        xp = als_cuda.spd_solve_plain(A, b)
        res = float(torch.linalg.vector_norm(
            (A @ x[:, :, None])[:, :, 0] - b) / torch.linalg.vector_norm(b))
        route = solve_plan_of(dev, R).route
        if not torch.equal(x, xp):
            raise AssertionError(
                f"spd_solve {label} ({route} route): not bitwise equal to "
                f"plain, max |err| {float((x - xp).abs().max())!r}")
        if not res < 1e-2:
            raise AssertionError(f"spd_solve {label}: residual {res!r}")
        results.append((label, route, res, R, time.perf_counter() - t))
    return results


def solve_report(results: list) -> str:
    return "; ".join(f"{lab} ({route}): bitwise True, relative residual "
                     f"{r:.3g}" for lab, route, r, _, _ in results)


def rank_solve_cases(dev, ranks) -> list:
    return [(f"R={R} B={64 if R <= 65 else 16}",
             spd_systems(dev, 64 if R <= 65 else 16, R)) for R in ranks]


def training_kernel_checks(dev, trained: dict, seed: int) -> dict:
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    model, pd = trained["model"], trained["pd"]
    rng = np.random.default_rng(seed + 3)
    worst = {"assemble": 0.0, "spd": 0.0}
    cases = rows_checked = bf16_cases = 0

    def both_kinds(Yt, Yi, cols, aw, bw, explicit, label, bf16=False):
        nonlocal cases, bf16_cases
        worst["assemble"] = max(worst["assemble"], assembly_kinds(
            dev, rng, Yt, Yi, cols, aw, bw, explicit, label, bf16))
        cases += 2
        bf16_cases += 2 * bf16

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
    # other ranks, from blocks of one warp up to the tiles route's limit,
    # then the tile-group route: rows a block groups and rows it splits,
    # random and integer factors
    err, n, n_bf16, rank_s = rank_assembly_checks(
        dev, rng, OTHER_RANKS + LARGE_RANKS, BF16_RANKS)
    worst["assemble"] = max(worst["assemble"], err)
    cases += n
    bf16_cases += n_bf16
    t = time.perf_counter()
    grid_cases = grid_tile_group_check(dev, rng)
    worst["grid_s"] = time.perf_counter() - t
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
          f"5,000 rows, the tile-group route from 209; the fold-in shapes "
          f"B x L in {[b for b, _ in FOLD_BATCHES]} x {list(FOLD_LENGTHS)} "
          f"with all but {[r for _, r in FOLD_BATCHES]} rows padding; "
          f"integer fixtures exact; max |err| {worst['assemble']!r}); "
          f"{bf16_cases} of them the bf16 route on a bf16 store (every "
          f"bucket of both sides at R={RANK}, implicit and explicit; R in "
          f"{BF16_RANKS}; the fold-in shapes), each also bitwise equal to "
          f"the fp32 route on its fp32 widening; the config grid at R=256 "
          f"(2 configs, one tile-group launch) bitwise each config's own "
          f"launch in {grid_cases} cases")

    # solve: random SPD systems, an ill-scaled family, real systems at
    # rank 64, then other ranks; the kernel repeats the plain version's
    # operations entry by entry, so it must be bitwise equal to it
    real_bucket = pd.user_side.buckets[len(pd.user_side.buckets) // 2]
    aw, bw = assembly_weights(real_bucket, False, dev)
    gram = Yt.T @ Yt + LAMBDA * torch.eye(RANK, device=dev)
    real = als_cuda.assemble_normal_equations(
        Yt, torch.as_tensor(real_bucket.cols, device=dev), aw, bw, gram)
    folds = [(f"fold B={B} L={L}",
              als_cuda.assemble_normal_equations(Yt, cols, aw, bw, gram))
             for B, L, cols, aw, bw in fold_tables]
    results = solve_checks(dev, [(f"B={B}", spd_systems(dev, B))
                                 for B in (1, 127, 4096, N_USERS)] + [
        ("ill-scaled B=4096", spd_systems(dev, 4096, ill=True)),
        (f"training B={real[1].shape[0]}", real)] + folds
        + rank_solve_cases(dev, SOLVE_RANKS))
    print(f"[kernel] spd_solve bitwise equal to spd_solve_plain: "
          + solve_report(results))
    worst["large_rank_training"] = train_large_rank(dev, seed)
    # the seconds of the ranks at the edges of the block route's shared
    # memory and beyond (EDGE_RANKS)
    worst["edge_s"] = sum(v for R, v in rank_s.items() if R in EDGE_RANKS) \
        + sum(s for _, _, _, R, s in results if R in EDGE_RANKS)
    return worst


def large_rank_only(dev, seed: int, card: str) -> dict:
    """``--large-rank``: phase 2b's checks above the tiles route's and
    the warp solve's ranks (B3 at ``LARGE_RANKS`` in fp32 and
    ``BF16_RANKS`` above 208 in bf16, B2 at ``SOLVE_RANKS`` from 240,
    the rank-256 training) and phase 4b's large-rank timings, alone."""
    rng = np.random.default_rng(seed + 3)
    err, cases, bf16_cases, _ = rank_assembly_checks(
        dev, rng, LARGE_RANKS, [R for R in BF16_RANKS if R > OTHER_RANKS[-1]])
    grid_cases = grid_tile_group_check(dev, rng)
    print(f"[kernel] assemble_normal_equations tile-group route == plain in "
          f"{cases} cases (R in {LARGE_RANKS}, bf16 at "
          f"{[R for R in BF16_RANKS if R > OTHER_RANKS[-1]]}, {bf16_cases} "
          f"of them, each bitwise the fp32 route on its widening); max |err| "
          f"{err!r}; the config grid at R=256 (2 configs, one launch) "
          f"bitwise each config's launch in {grid_cases} cases")
    results = solve_checks(dev, rank_solve_cases(
        dev, [R for R in SOLVE_RANKS if R >= 240]))
    print(f"[kernel] spd_solve bitwise equal to spd_solve_plain: "
          + solve_report(results))
    return {"assemble_max_abs_err": err, "assemble_cases": cases,
            "solve": [{"label": lab, "route": route, "residual": r}
                      for lab, route, r, _, _ in results],
            "training": train_large_rank(dev, seed),
            "timings": large_rank_timings(dev), "card": card}


def train_large_rank(dev, seed: int) -> dict:
    """Train at rank 256 on the card through ``train_als_bucketed``: the
    tile-group assembly and the block solve. Both must launch, on those
    routes alone, and the factors stay within TRAIN_RTOL of the plain
    trainer's from the same init."""
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
    routes = (als_cuda.assembly_route(R, OTHER_RANKS[-1]),
              solve_plan_of(dev, R).route)
    by_route = {"assemble_normal_equations":
                {k[0] for k in als_cuda.assemble_launches.by_key()},
                "spd_solve": set(als_cuda.spd_launches.by_key())}
    if by_route != {"assemble_normal_equations": {routes[0]},
                    "spd_solve": {routes[1]}}:
        raise AssertionError(f"rank {R}: launches by route {by_route}, "
                             f"want {routes}")
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
          f"the {routes[1]} solve; launches {launches}; kernel vs "
          f"plain trainer relative Frobenius error {errs} (allowed "
          f"{TRAIN_RTOL})")
    if max(errs.values()) > TRAIN_RTOL:
        raise AssertionError(f"rank-{R} factors differ from the plain "
                             f"trainer's: {errs}")
    return {"launches": launches, "routes": routes, "errs": errs}


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
        out["warmed"] = warmed_checkpoint_run(
            dev, us, its, base, work, run, env_keys,
            lambda got, what: same(got, (model.user_factors,
                                         model.item_factors), what))
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


def warmed_checkpoint_run(dev, us, its, base, work: str, run, env_keys,
                          same_as_eager) -> dict:
    """(c) of phase 5c: ``warmup_train_als_bucketed`` with
    ``checkpoint_every=1`` and telemetry on captures the iteration and
    the objective sample; the fp32 run that follows takes every
    iteration and every sample from a cache hit (B3 and B2 by replays),
    and its factors (``same_as_eager``: phase 5's, which (b)'s eager
    runs equal) and run-log samples (``fp32-0`` of (b)) equal the eager
    run's bitwise."""
    import os

    from predictionio_tpu_torch.ops import als as als_mod
    from predictionio_tpu_torch.ops import als_cuda, aot
    from predictionio_tpu_torch.workflow import runlog

    clear_training_programs()
    d = os.path.join(work, "fp32-warm")
    for k in env_keys:
        os.environ.pop(k, None)
    os.environ.update(PIO_CHECKPOINT_DIR=d, PIO_CHECKPOINT_EVERY="1")
    t = time.perf_counter()
    if not als_mod.warmup_train_als_bucketed(us, its, base, dev):
        raise AssertionError("phase 5c: the warm-up declined")
    warm_s = time.perf_counter() - t
    programs = (len(als_mod._aot_bucketed), len(als_mod._aot_objective))
    if programs != (1, 1):
        raise AssertionError(f"phase 5c: the warm-up cached {programs} "
                             "(iteration, objective) programs")
    pool_bytes = aot.train_pool(dev).nbytes()
    hits = {"iteration": [], "objective": []}
    caches = {"iteration": als_mod._aot_bucketed,
              "objective": als_mod._aot_objective}

    def counting(name, cache):
        get = type(cache).get

        def counted(key):
            prog = get(cache, key)
            hits[name].append(prog is not None)
            return prog
        return counted

    for name, cache in caches.items():
        cache.get = counting(name, cache)
    for counter in (als_cuda.assemble_launches, als_cuda.spd_launches,
                    als_cuda.graph_launches):
        counter.reset()
    try:
        X, Y, wall = run(base, d)
    finally:
        for cache in caches.values():
            del cache.get
    n_buckets = len(us.buckets) + len(its.buckets)
    launches = replayed_launches(n_buckets * ITERATIONS, "phase 5c (c)")
    if hits != {"iteration": [True] * ITERATIONS,
                "objective": [True] * ITERATIONS}:
        raise AssertionError(f"phase 5c (c): cache lookups {hits}")
    eager = runlog.read_run(runlog.list_runs(os.path.join(
        work, "fp32-0"))[0]["path"])["samples"]
    got = runlog.read_run(runlog.list_runs(d)[0]["path"])["samples"]
    loss = [[(s["step"], s["loss"]["fit"], s["loss"]["l2"]) for s in run_]
            for run_ in (got, eager)]
    if loss[0] != loss[1] or len(loss[0]) != ITERATIONS:
        raise AssertionError(f"phase 5c (c): the warmed run's samples "
                             f"{loss[0]} differ from the eager run's "
                             f"{loss[1]}")
    same_as_eager((X, Y), "fp32 warmed checkpoint_every=1")
    clear_training_programs()
    print(f"[options] fp32 checkpoint_every=1 warmed ({warm_s!r} s to "
          f"capture the iteration and the objective; training pool "
          f"{pool_bytes} bytes): every iteration and sample a cache hit, "
          f"launches {launches}; factors and the samples (step, fit, l2) "
          f"{loss[0]} bitwise the eager run's; wall {wall!r} s")
    return {"warm_s": warm_s, "pool_bytes": pool_bytes, "wall_s": wall,
            "launches": launches, "loss": loss[0]}


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
    from predictionio_tpu_torch.ops import als_cuda, aot
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

    # the main path: the grid's training, warmed (its iteration and
    # objective captured), and its leaderboard, counted
    plan_before = wf_tuning.plan_grid_batches(grid, N_USERS, M_ITEMS, us, its,
                                              device=dev)
    t = time.perf_counter()
    if not als_mod.warmup_train_als_bucketed(us, its, grid, dev):
        raise AssertionError("phase 5d: the grid's warm-up declined")
    warm = {"capture_s": time.perf_counter() - t,
            "pool_bytes": aot.train_pool(dev).nbytes(),
            "programs": (len(als_mod._aot_grid),
                         len(als_mod._aot_objective_grid)),
            "batches_before": [len(b) for b in plan_before],
            "batches_after": [len(b) for b in wf_tuning.plan_grid_batches(
                grid, N_USERS, M_ITEMS, us, its, device=dev)]}
    if warm["programs"] != (1, 1):
        raise AssertionError(f"phase 5d: the warm-up cached {warm['programs']}"
                             " (iteration, objective) grid programs")
    print(f"[grid] warm-up {warm['capture_s']!r} s (the grid's iteration and "
          f"objective captured), training pool {warm['pool_bytes']} bytes; "
          f"run_grid's memory plan {warm['batches_before']} before the "
          f"capture, {warm['batches_after']} after ({card})")
    for counter in (als_cuda.assemble_launches, als_cuda.spd_launches,
                    als_cuda.launches, als_cuda.graph_launches):
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
    replayed = replayed_launches(GRID_ITERATIONS * n_buckets, "phase 5d")
    b1 = sum(launches["topk"].values())
    if b1 != grid.k * -(-GRID_USERS // 512):
        raise AssertionError(f"grid_topk launched B1 {launches['topk']}")
    topk_routes = routes_of(launches["topk"])
    want_route = als_cuda.topk_sort_plan(GRID_TOPK, M_ITEMS, 512, 1 << 30).route
    if set(topk_routes) != {want_route}:
        raise AssertionError(f"grid_topk's launches by route {topk_routes}, "
                             f"want {want_route}")
    print(f"[grid] grid_topk's B1 launches by route {topk_routes}")
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
          f"B1 {launches['topk']} (B3 and B2 all by replays: {replayed}); "
          f"leaderboard of {len(held_s)} users in "
          f"{board_s!r} s on the host; peak memory {peak / 1e9!r} GB against "
          f"{per_config * grid.k / 1e9!r} GB (grid_bytes_per_config x k) + "
          f"{table_bytes / 1e9!r} GB of tables ({card})")

    # (b) each config against its serial run from the same init, each
    # serial run warmed first (its capture outside the timed window)
    dists, serial_s = [], 0.0
    for i, cfg in enumerate(grid.configs[:-1]):
        if not als_mod.warmup_train_als_bucketed(us, its, cfg, dev):
            raise AssertionError(f"phase 5d: config {i}'s warm-up declined")
        for counter in (als_cuda.assemble_launches, als_cuda.spd_launches,
                        als_cuda.graph_launches):
            counter.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        Xs, Ys = als_mod.train_als_bucketed(us, its, cfg)
        serial_s += time.perf_counter() - t
        replayed_launches(GRID_ITERATIONS * n_buckets,
                          f"phase 5d config {i}'s serial run")
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
          f"(warmed, by replays) from the same init, largest |difference|: "
          f"{dists} (rank "
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

    ladder = replay_against_eager(
        lambda: als_mod._als_iterations_grid(X0, Y0, lam, alpha, ridge, u_t,
                                             i_t, **kw),
        lambda: als_mod._als_iterations_grid_impl(X0, Y0, lam, alpha, ridge,
                                                  u_t, i_t, **kw),
        n_buckets, f"a grid iteration (k={grid.k}, R_max={grid.max_rank})",
        iterations=GRID_LADDER_ITERATIONS)
    eager = ladder["eager"]
    profiled = {"wall_ms": eager["profiled_wall_ms"],
                "busy_ms": eager["busy_ms"],
                "kernel_ms": eager["kernel_ms"]}
    print(f"[grid] one grid iteration profiled (eager): wall "
          f"{profiled['wall_ms']!r} ms, device busy {profiled['busy_ms']!r} "
          f"ms ({100 * eager['busy_share']:.2f}%); device ms by kernel "
          f"{profiled['kernel_ms']} ({card})")
    del us, its, res, X0, Y0, u_t, i_t
    clear_training_programs()
    return {"launches": {"tiles_grid": tiles_grid,
                         "spd_solve": launches["spd_solve"], "topk": b1,
                         "topk_routes": topk_routes},
            "grid_s": grid_s, "iteration_ms": 1e3 * grid_s / GRID_ITERATIONS,
            "serial_s": serial_s, "board_s": board_s, "peak_bytes": peak,
            "per_config_bytes": per_config, "table_bytes": table_bytes,
            "distances": dists, "assembly": asm, "topk": topk_t,
            "checked": checked, "winner": board["winner"],
            "profiled": profiled, "warm": warm, "ladder": ladder,
            "replayed": replayed}


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


def observability_overhead(base: str, queries: list, rounds: int = 4) -> dict:
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


def plain_references(model, queries: list) -> list:
    """For each query, the same pipeline's answer with the plain version
    in place of the serving kernel (one extra result of context for
    near-tie checks) and the largest score the query can reach:
    ``(items, scores, bound)``. An ALS, a sequentialrec or a two-stage
    retrieval model (whose store's stage 1 then runs plain)."""
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops import serving as serving_mod
    from predictionio_tpu_torch.templates.recommendation.engine import (
        ALSAlgorithm,
        Query,
    )

    algo = ALSAlgorithm()
    server = model.device_server()
    # a two-stage facet's answers are stage 2's: the bound reads the
    # stage-2 tables, and stage 1 runs plain too
    store = getattr(server, "store", server)
    two = hasattr(store, "seq_item_factors")
    # a model whose store was patched (fold-in) serves rows beyond its
    # host factors: the norms come from the store itself
    X = store._U if two else store._X
    x_norm = (X.float() if not hasattr(X, "scale") else
              X.data.float() * X.scale[:, None]).norm(dim=1).cpu().numpy()
    Y = (store.seq_item_factors.cpu().numpy() if two else
         getattr(model, "item_factors", None))
    if Y is None:       # a sequentialrec model: the tied item table
        Y = model.item_vectors
    y_norm = float(np.linalg.norm(Y, axis=1).max())
    from predictionio_tpu_torch.ops import twostage as twostage_mod

    # the ladder's graphs would replay the kernel: set them aside
    aside = ladder_set_aside(store)
    aside.__enter__()
    serving_mod.fused_gather_score_topk = \
        als_cuda.fused_gather_score_topk_plain
    twostage_mod.fused_gather_score_topk = \
        als_cuda.fused_gather_score_topk_plain
    try:
        refs = []
        for q in queries:
            wide = dict(q, num=q["num"] + 1)
            want = algo.predict(model, Query(**{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in wide.items()}))
            exp_items = [s.item for s in want.item_scores]
            exp_scores = np.asarray([s.score for s in want.item_scores] +
                                    [-np.inf], dtype=np.float32)
            if "items" in q:
                bound = 1.01 * len(q["items"])
            elif q["user"] in model.user_map:
                bound = 1.01 * x_norm[model.user_map[q["user"]]] * y_norm
            else:
                bound = 0.0
            refs.append((exp_items, exp_scores, bound))
    finally:
        serving_mod.fused_gather_score_topk = als_cuda.fused_gather_score_topk
        twostage_mod.fused_gather_score_topk = \
            als_cuda.fused_gather_score_topk
        aside.__exit__(None, None, None)
    return refs


def check_answer(q: dict, status: int, body, ref: tuple) -> None:
    """One answer must be a 200 whose items and scores are ``ref``'s
    (:func:`plain_references`), scores within ``RTOL`` of the bound."""
    exp_items, exp_scores, bound = ref
    if status != 200:
        raise AssertionError(f"{q}: HTTP {status} {body}")
    got = body["itemScores"]
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
                   np.asarray([RTOL * bound], np.float32), exact=False)


def check_against_plain(model, answers: list) -> int:
    """Each ``(query, status, body, seconds)`` must be a 200 whose items
    and scores are the same pipeline's with the plain version in place of
    the serving kernel (one extra result of context for near-tie checks),
    scores within ``RTOL`` of the largest score the query can reach.
    Returns the number checked."""
    refs = plain_references(model, [a[0] for a in answers])
    for (q, status, body, _), ref in zip(answers, refs):
        check_answer(q, status, body, ref)
    return len(answers)


def phase3_queries(seed: int) -> tuple:
    """Phase 3's 43 sequential queries of five kinds (user, blacklist,
    item similarity, category, unknown user) and its 34 concurrent
    ones."""
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
    return queries, concurrent


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
    queries, concurrent = phase3_queries(seed)

    health = get_json(base + "/healthz")
    if not health["ready"]:
        raise AssertionError(f"server not ready: {health}")

    before, lanes_before = scrape(base), srv.stats()
    als_cuda.launches.reset()
    als_cuda.graph_launches.reset()
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
    graph_launches = als_cuda.graph_launches.value
    if launches == 0:
        raise AssertionError("the kernel was never launched on the main path")
    by_key = als_cuda.launches.by_key()
    small = [route for route, k, b in by_key
             if k <= als_cuda.CHUNK_K_MAX and b < als_cuda.CHUNKED_MAX_B]
    if not small or any(route != "chunked" for route in small):
        raise AssertionError(f"the main path's launches at k <= 128 did not "
                             f"all take the chunked route: {by_key}")
    large = [route for route, k, b in by_key
             if k <= als_cuda.CHUNK_K_MAX and b >= als_cuda.CHUNKED_MAX_B]
    if any(route != "tiled" for route in large):
        raise AssertionError(f"the main path's launches at k <= 128 in "
                             f"batches of {als_cuda.CHUNKED_MAX_B} or more "
                             f"did not all take the tiled route: {by_key}")
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
          f"launches {launches} ({graph_launches} by replays of the "
          f"ladder's graphs); users lane {stats['users']['dispatches']} "
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
    # the server stays up for phase 3g, which stops it
    return {"launches": launches, "graph_launches": graph_launches,
            "routes": routes_of(by_key),
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "overhead": overhead,
            "live": {"server": server, "base": base, "model": model,
                     "queries": queries, "concurrent": concurrent}}


def ladder_phase3(served: dict) -> dict:
    """Phase 3g on phase 3's store (bf16, deployed and warmed to k = 128
    by its ``QueryServer``): warmed to the whole catalog (the category
    queries ask k = M), then phase 3's 43 sequential and 34 concurrent
    queries over HTTP, every dispatch a hit, each answer equal to the
    plain pipeline; the server stops after."""
    live = served.pop("live")
    server, base, model = live["server"], live["base"], live["model"]
    store = model.device_server()

    def serve():
        got = [(q, *post(base + "/queries.json", q))
               for q in live["queries"]]
        got += burst(base, live["concurrent"])
        return len(got), lambda: check_against_plain(model, got)

    # an item query of more than 8 items pads its list to 16
    extra = tuple(("items", min(16, store.n_items), 16, gg)
                  for gg in (8, 16, 32, 64))
    try:
        return ladder_serving(store, "phase 3's store", serve, max_k=M_ITEMS,
                              extra=extra)
    finally:
        server.stop()


# -- phase 3g: the serving ladder (CUDA graphs) --------------------------------

LADDER_TIMED = 200         # dispatches a timed median, graph and eager each
LADDER_ROUNDS = 4          # which alternate in this many rounds
LADDER_SAMPLE_BB = (8, 256)  # the uid buckets replayed against eager


@contextlib.contextmanager
def ladder_set_aside(store):
    """``store``'s ladder set aside for the block (an empty program
    cache): its dispatches run eagerly, through whatever
    ``fused_gather_score_topk`` the modules hold then (the plain
    references swap the plain version in). The lookups the block makes
    are taken back out of the store's counts. A store without a ladder
    (the host lane) passes through."""
    from predictionio_tpu_torch.ops.aot import AOTCache

    store = getattr(store, "store", store)      # a two-stage facet
    if not hasattr(store, "_aot_programs"):
        yield store
        return
    with store._store_lock:
        saved = (store._aot_programs, store._aot_hits, store._aot_misses)
        store._aot_programs = AOTCache(max_entries=512, name="set-aside")
    try:
        yield store
    finally:
        with store._store_lock:
            (store._aot_programs, store._aot_hits,
             store._aot_misses) = saved


def ladder_warm(store, label: str, max_k: int = 128) -> dict:
    """(a) ``store.warmup(max_k)``; every planned entry must be captured:
    ``planned`` = ``compiled``, no ``fallback``, none ``warmed``. Prints
    the seconds and the graphs' device bytes (measured pool growth)."""
    t = time.perf_counter()
    store.warmup(max_k=max_k)
    warm_s = time.perf_counter() - t
    rep = store.ladder_report()
    cov = rep["coverage"]
    if not (cov["planned"] == cov["compiled"] and cov["fallback"] == 0
            and cov["warmed"] == 0 and rep["cache"]["entries"]
            >= cov["planned"]):
        raise AssertionError(f"{label}: ladder coverage {cov}, cache "
                             f"{rep['cache']}")
    print(f"[ladder] {label}: warmed in {warm_s:.2f} s (max_k {max_k}): "
          f"{cov['compiled']} of {cov['planned']} entries captured; cache "
          f"{rep['cache']}; graph pool {rep['memory']['totalBytes']} bytes")
    return {"warm_s": warm_s, "coverage": cov,
            "entries": rep["cache"]["entries"],
            "bytes": rep["memory"]["totalBytes"]}


def entry_inputs(store, entry: tuple, rng) -> tuple:
    """Host inputs of a ladder entry's program: random uids (``user`` /
    ``users`` / ``two``) or random query positions and masks
    (``items``, the first slot of each row set)."""
    if entry[0] == "items":
        _, _, B, gg = entry
        idx = rng.integers(0, store.n_items, (gg, B)).astype(np.int32)
        mask = (rng.random((gg, B)) < 0.5).astype(np.float32)
        mask[:, 0] = 1.0
        return (store._items_to_positions(idx).astype(np.int32), mask)
    bb = 1 if entry[0] == "user" else entry[-1]
    return (rng.integers(0, store.n_users, bb).astype(np.int64),)


def replays_equal_eager(store, entries: list, rng) -> dict:
    """(b) each entry's replay bitwise equal, index and score bytes, to
    an eager run of its program on the same inputs (the same kernels
    launched one by one). Returns the count and B1's launches a
    replay by entry kind (the replays' count over the replays)."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    per_replay: dict = {}
    for entry in entries:
        inputs = entry_inputs(store, entry, rng)
        with store._store_lock:
            prog = store._aot_get_locked(entry)
            if prog is None:
                raise AssertionError(f"{entry} is not in the ladder")
            g0 = als_cuda.graph_launches.value
            got = prog(*inputs).clone()
            per_replay.setdefault(entry[0], set()).add(
                als_cuda.graph_launches.value - g0)
            fn, _ = store._entry_program(entry)
            want = fn(*(store._host_to_device(x) for x in inputs))
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            bad = (got.view(torch.int32) != want.view(torch.int32)).sum()
            raise AssertionError(f"{entry}: the replay differs from the "
                                 f"eager run in {int(bad)} words")
    return {"entries": len(entries),
            "b1_per_replay": {k: sorted(v) for k, v in per_replay.items()}}


def replay_against_plain(store, entry: tuple, rng, row_norms) -> float:
    """B1 inside the replayed graph against its plain version: the
    entry's replay (k = its bucket less one) held to the same program run
    eagerly with the plain version swapped in (k + 1 columns), within
    ``check_topk``'s tolerance; ``row_norms(inputs)`` gives each row's
    RTOL allowance scale. Returns the largest value error."""
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops import serving as serving_mod
    from predictionio_tpu_torch.ops import twostage as twostage_mod

    kb = entry[1]
    inputs = entry_inputs(store, entry, rng)
    with store._store_lock:
        got = store._aot_get_locked(entry)(*inputs).cpu().numpy()
        fn, _ = store._entry_program(entry)
        serving_mod.fused_gather_score_topk = \
            twostage_mod.fused_gather_score_topk = \
            als_cuda.fused_gather_score_topk_plain
        try:
            want = fn(*(store._host_to_device(x)
                        for x in inputs)).cpu().numpy()
        finally:
            serving_mod.fused_gather_score_topk = \
                twostage_mod.fused_gather_score_topk = \
                als_cuda.fused_gather_score_topk
    kv, ki = got[:, :kb - 1], got[:, kb:2 * kb - 1].view(np.int32)
    pv, pi = want[:, :kb], want[:, kb:].view(np.int32)
    tol = (RTOL * 1.01 * row_norms(inputs)).astype(np.float32)
    return check_topk(kv, ki, pv, pi, tol, exact=False)


def ladder_entries(store, two: bool = False) -> list:
    """(b)'s entries: every ``user`` entry, each k bucket's ``users`` at
    ``LADDER_SAMPLE_BB``, every ``items`` entry, and (``two``) every
    ``two`` entry of the store's plan."""
    with store._store_lock:
        sig = store._store_sig_locked()
    plan = [e for s, e in store._aot_programs.keys() if s == sig]
    entries = [e for e in plan if e[0] in ("user", "items")
               or (e[0] == "users" and e[2] in LADDER_SAMPLE_BB)
               or (two and e[0] == "two")]
    return sorted(set(entries), key=str)


def graph_against_eager(store, call, label: str) -> dict:
    """(e) ``call()`` (one dispatch) with the store's ladder (a replay) and
    with it set aside (eager), ``LADDER_TIMED`` times each in
    ``LADDER_ROUNDS`` alternating rounds: medians of the host window (the
    call's wall, its copy back included) and of the event window (the
    dispatch's CUDA events around the program, from the flight
    recorder). Every graph dispatch must be a hit, every eager one a
    miss."""
    import contextlib as _ctx

    from predictionio_tpu_torch.utils import device_telemetry

    got = {m: {"host": [], "event": [], "aot": set()}
           for m in ("graph", "eager")}
    per = LADDER_TIMED // LADDER_ROUNDS
    call()
    with ladder_set_aside(store):
        call()
    for _ in range(LADDER_ROUNDS):
        for mode in ("graph", "eager"):
            with (ladder_set_aside(store) if mode == "eager"
                  else _ctx.nullcontext()):
                for _ in range(per):
                    t = time.perf_counter()
                    call()
                    got[mode]["host"].append((time.perf_counter() - t) * 1e3)
                    rec = device_telemetry.last_record() or {}
                    got[mode]["aot"].add(rec.get("aot"))
                    if rec.get("deviceUs") is not None:
                        got[mode]["event"].append(rec["deviceUs"] / 1e3)
    if got["graph"]["aot"] != {"hit"} or got["eager"]["aot"] != {"miss_jit"}:
        raise AssertionError(f"{label}: graph dispatches {got['graph']['aot']}"
                             f", eager {got['eager']['aot']}")
    out = {m: {"host_ms": float(np.median(v["host"])),
               "event_ms": float(np.median(v["event"])) if v["event"]
               else None, "n": len(v["host"])} for m, v in got.items()}
    print(f"[ladder] {label}: graph host {out['graph']['host_ms']!r} ms, "
          f"event {out['graph']['event_ms']!r} ms; eager host "
          f"{out['eager']['host_ms']!r} ms, event "
          f"{out['eager']['event_ms']!r} ms (medians of {per * LADDER_ROUNDS}"
          f" each)")
    return out


def user_row_norms(store):
    """Per query row, |x_u| * max |y| on the store's own tables (the
    allowance scale of a user dispatch)."""
    import torch

    from predictionio_tpu_torch.ops import serving as serving_mod

    with store._store_lock:
        X = store._X
        Y = store.item_factors
    y_norm = float(Y.norm(dim=1).max())

    def norms(inputs):
        u = torch.from_numpy(inputs[0]).to(store.device)
        x = serving_mod._gather_rows_f32(X, u).norm(dim=1)
        return x.cpu().numpy() * y_norm
    return norms


def ladder_serving(store, label: str, serve, max_k: int,
                   extra: tuple = ()) -> dict:
    """Phase 3g on a single-device store: (a) warm to ``max_k``; (b) the
    sampled entries' replays bitwise their eager runs and B1 in the
    graphs against plain (k 16, B 8 and 256); (c) ``serve()`` (the
    phase's queries; it returns the request count and a check of the
    answers against the plain pipeline, run after the counts are read)
    must hit the ladder on every dispatch, B1 counted once a replay;
    (e) graph against eager: a lone dispatch at B = 1 and at B = 8; (d)
    a growing patch clears the ladder, the next answer equals plain, a
    warm-up restores it. ``extra`` entries (shapes the phase's queries
    dispatch beyond the plan) are captured after the warm-up through
    ``precompile``."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops import serving as serving_mod

    rng = np.random.default_rng(31)
    out = {"warm": ladder_warm(store, label, max_k)}
    if extra:
        got = store.precompile(list(extra))
        if got != {"compiled": len(extra), "fallback": 0}:
            raise AssertionError(f"{label}: precompile of {extra}: {got}")
        print(f"[ladder] {label}: {len(extra)} entries beyond the plan "
              f"captured: {sorted(extra)}")
    entries = ladder_entries(store)
    t = time.perf_counter()
    out["replays"] = replays_equal_eager(store, entries, rng)
    norms = user_row_norms(store)
    out["plain_err"] = max(
        replay_against_plain(store, ("users", min(16, store.n_items), bb),
                             rng, norms) for bb in LADDER_SAMPLE_BB)
    print(f"[ladder] {label}: {len(entries)} entries' replays bitwise equal "
          f"to their eager runs ({time.perf_counter() - t:.2f} s); B1 "
          f"launches a replay {out['replays']['b1_per_replay']}; B1 in the "
          f"graph against plain (k 16, B {LADDER_SAMPLE_BB}) max error "
          f"{out['plain_err']!r}")
    lanes0, rep0 = store.stats(), store.ladder_report()["requests"]
    als_cuda.launches.reset()
    als_cuda.graph_launches.reset()
    served, check = serve()
    lanes1, rep1 = store.stats(), store.ladder_report()["requests"]
    # a lane's dispatch splits by k bucket: the device dispatches are the
    # lookups
    batches = sum(lanes1[n]["dispatches"] - lanes0[n]["dispatches"]
                  for n in lanes1)
    hits, misses = rep1["hit"] - rep0["hit"], rep1["missJit"] - rep0["missJit"]
    launches = als_cuda.launches.value
    if not (batches and hits >= batches and misses == 0
            and launches == hits
            and als_cuda.graph_launches.value == hits):
        raise AssertionError(
            f"{label}: {batches} micro-batches, {hits} hits, {misses} misses"
            f", B1 {launches} launches ({als_cuda.graph_launches.value} by "
            "replays)")
    check()
    print(f"[ladder] {label}: {served} requests served and equal to plain; "
          f"{batches} micro-batches, {hits} dispatches, every one a hit "
          f"(missJit 0); B1 {launches} launches, all by replays")
    out["served"] = {"requests": served, "batches": batches, "hits": hits,
                     "launches": launches}
    u1 = rng.integers(0, store.n_users, 1)
    u8 = rng.integers(0, store.n_users, 8)
    out["lone_b1"] = graph_against_eager(
        store, lambda: store._user_topk_direct(int(u1[0]), 10),
        f"{label}, a lone dispatch at B = 1")
    out["lone_b8"] = graph_against_eager(
        store, lambda: store.users_topk(u8, 10),
        f"{label}, a lone dispatch at B = 8")
    # under the profiler: do the replayed graphs' kernels show?
    _, busy, kernels, _ = device_busy(
        lambda: [store.users_topk(u8, 10) for _ in range(20)])
    out["profiled"] = {"busy_ms": busy / 20, "kernels": dict(kernels)}
    print(f"[ladder] {label}: 20 replays at B = 8 under the profiler: the "
          f"card busy {busy / 20!r} ms a dispatch; kernels {dict(kernels)}")
    # (d) a growing patch
    cap = store.user_capacity
    rank = int((store._X.data if hasattr(store._X, "scale")
                else store._X).shape[1])
    row = (rng.standard_normal((1, rank)) * 0.1).astype(np.float32)
    store.patch_users(np.asarray([cap]), row)
    if len(store._aot_programs) or store.user_capacity <= cap:
        raise AssertionError(f"{label}: the growth {cap} -> "
                             f"{store.user_capacity} left "
                             f"{len(store._aot_programs)} programs")
    rep_g = store.ladder_report()["requests"]
    gi, gv = store.users_topk(np.asarray([cap]), 10)
    if store.ladder_report()["requests"]["missJit"] != rep_g["missJit"] + 1:
        raise AssertionError(f"{label}: the grown store's dispatch was not "
                             "a miss")
    with ladder_set_aside(store):
        serving_mod.fused_gather_score_topk = \
            als_cuda.fused_gather_score_topk_plain
        try:
            wi, wv = store.users_topk(np.asarray([cap]), 11)
        finally:
            serving_mod.fused_gather_score_topk = \
                als_cuda.fused_gather_score_topk
    norms = user_row_norms(store)       # the grown table's
    check_topk(gv, gi, wv, wi, (RTOL * 1.01 * norms((np.asarray([cap]),))
                                ).astype(np.float32), exact=False)
    out["regrown"] = ladder_warm(store, f"{label} after the growth "
                                        f"({cap} -> {store.user_capacity} "
                                        "rows)")
    torch.cuda.synchronize()
    return out


def ladder_two(store, label: str) -> dict:
    """Phase 3g on the two-stage store: (a) warm; (b) every ``two``
    entry's replay (B1 at k = N and stage 2, one graph) bitwise its eager
    run, the sampled parent entries too, and one against the plain
    stage 1; (e) a two-stage dispatch at B = 8, graph against eager, the
    eager dispatches' B1 / stage-2 split beside."""
    import torch

    from predictionio_tpu_torch.ops import serving as serving_mod

    rng = np.random.default_rng(37)
    out = {"warm": ladder_warm(store, label)}
    entries = ladder_entries(store, two=True)
    t = time.perf_counter()
    out["replays"] = replays_equal_eager(store, entries, rng)
    with store._store_lock:
        U = store._U
        E = store._E
    e_norm = float(serving_mod._gather_rows_f32(
        E, torch.arange(int((E.data if hasattr(E, "scale") else E).shape[0]),
                        device=store.device)).norm(dim=1).max())

    def norms(inputs):
        u = torch.from_numpy(inputs[0]).to(store.device)
        return serving_mod._gather_rows_f32(U, u).norm(dim=1).cpu().numpy() \
            * e_norm
    two = min(e for e in entries if e[0] == "two" and e[-1] == 8)
    out["plain_err"] = replay_against_plain(store, two, rng, norms)
    print(f"[ladder] {label}: {len(entries)} entries' replays bitwise equal "
          f"to their eager runs ({time.perf_counter() - t:.2f} s); B1 "
          f"launches a replay {out['replays']['b1_per_replay']}; {two} "
          f"against the plain stage 1: max error {out['plain_err']!r}")
    u8 = rng.integers(0, store.n_users, 8)
    store.stage_times.clear()
    out["two_b8"] = graph_against_eager(
        store, lambda: store.twos_topk(u8, 10),
        f"{label}, a two-stage dispatch at B = 8")
    split = np.asarray(list(store.stage_times))
    if len(split):
        out["two_b8"]["eager"]["b1_us"] = float(np.median(split[:, 0]))
        out["two_b8"]["eager"]["stage2_us"] = float(np.median(split[:, 1]))
        print(f"[ladder] {label}: the eager dispatches' split (median of "
              f"{len(split)}): B1 {out['two_b8']['eager']['b1_us']!r} us, "
              f"stage 2 {out['two_b8']['eager']['stage2_us']!r} us")
    return out


def ladder_sharded(store, label: str) -> dict:
    """Phase 3g on a sharded store over logical shards of one card: one
    graph a dispatch (every shard's B1, the seen translation, the merge),
    its replays bitwise the eager runs with B1 counted once a shard, and
    a lone B = 1 dispatch graph against eager."""
    rng = np.random.default_rng(41)
    out = {"warm": ladder_warm(store, label)}
    entries = [e for e in ladder_entries(store)
               if e[0] != "items" or e[-1] == 8]
    out["replays"] = replays_equal_eager(store, entries, rng)
    per = out["replays"]["b1_per_replay"]
    if any(v != [store.shard_count] for v in per.values()):
        raise AssertionError(f"{label}: B1 launches a replay {per}")
    print(f"[ladder] {label}: {len(entries)} entries' replays bitwise equal "
          f"to their eager runs; B1 launches a replay {per}")
    u1 = int(rng.integers(0, store.n_users))
    out["lone_b1"] = graph_against_eager(
        store, lambda: store._user_topk_direct(u1, 10),
        f"{label}, a lone dispatch at B = 1")
    return out


def ladder_only(dev, seed: int, card: str) -> dict:
    """``--ladder``: phase 3g alone on synthetic stores at ML-20M width
    (factors from ``seed``, rank 64, bf16, seen lists of lognormal
    lengths up to 256): the user store served in process (64 users from
    8 threads through the micro-batcher, 16 item queries, one query over
    the whole catalog), a two-stage store (N 128) and a 4-shard store on
    ``[dev] * SHARDS``."""
    import concurrent.futures

    import torch

    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops import serving as serving_mod
    from predictionio_tpu_torch.ops.twostage import TwoStageTopK

    rng = np.random.default_rng(seed + 91)
    X = (rng.standard_normal((N_USERS, RANK)) * 0.1).astype(np.float32)
    Y = (rng.standard_normal((M_ITEMS, RANK)) * 0.1).astype(np.float32)
    lens = np.minimum(rng.lognormal(3.0, 1.0, N_USERS).astype(np.int64) + 1,
                      256)
    flat = rng.integers(0, M_ITEMS, int(lens.sum()))
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    seen = {u: flat[s:s + n] for u, (s, n) in enumerate(zip(starts, lens))}
    t = time.perf_counter()
    store = serving_mod.DeviceTopK(X, Y, seen, device=dev)
    print(f"[ladder] synthetic store {store.precision}, seen "
          f"{tuple(store._seen_cols.shape)}, built in "
          f"{time.perf_counter() - t:.1f} s")
    users = rng.integers(0, N_USERS, 64)
    items = rng.integers(0, M_ITEMS, 16)

    def serve():
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            got = list(pool.map(lambda u: store.user_topk(int(u), 10),
                                users))
            got_items = list(pool.map(
                lambda i: store.items_topk([int(i)], 10), items))
        wide = store.user_topk(int(users[0]), M_ITEMS)

        def check():
            with ladder_set_aside(store):
                serving_mod.fused_gather_score_topk = \
                    als_cuda.fused_gather_score_topk_plain
                try:
                    wi, wv = store.users_topk(users, 11)
                    want_items = [store.items_topk([int(i)], 10)
                                  for i in items]
                    want_wide = store.user_topk(int(users[0]), M_ITEMS)
                finally:
                    serving_mod.fused_gather_score_topk = \
                        als_cuda.fused_gather_score_topk
            gi = np.stack([g[0] for g in got])
            gv = np.stack([g[1] for g in got])
            tol = (RTOL * 1.01 * user_row_norms(store)((users,))
                   ).astype(np.float32)
            check_topk(gv, gi, wv, wi, tol, exact=False)
            for (a, b), (c, d) in zip(got_items, want_items):
                if len(a) != len(c) or np.abs(b - d).max(initial=0) > 1e-4:
                    raise AssertionError("an item query differs from plain")
            if len(wide[0]) != len(want_wide[0]) or np.abs(
                    wide[1] - want_wide[1]).max() > 1e-3:
                raise AssertionError("the wide query differs from plain")
        return len(users) + len(items) + 1, check

    out = {"store": ladder_serving(store, "the synthetic store", serve,
                                   max_k=M_ITEMS)}
    store.close()
    del store
    torch.cuda.empty_cache()
    U = (rng.standard_normal((N_USERS, RANK)) * 0.1).astype(np.float32)
    E = (rng.standard_normal((M_ITEMS, RANK)) * 0.1).astype(np.float32)
    two = TwoStageTopK(X, Y, U, E, seen=seen, device=dev)
    out["two"] = ladder_two(two, "the synthetic two-stage store")
    two.close()
    del two
    sharded = serving_mod.DeviceTopK(X, Y, seen, device=[dev] * SHARDS,
                                     shards=SHARDS)
    out["sharded"] = ladder_sharded(sharded, "the synthetic 4-shard store")
    sharded.close()
    return out


# -- phase 3c: pio batchpredict at ML-20M width --------------------------------

BP_CHUNK = 256          # queries per chunk (the B1 bitonic route's B)
BP_UNKNOWN, BP_BLACKLISTED, BP_SIMILAR = 16, 64, 16
BP_RESUME_CHUNKS = 64   # the interrupted run's input: this many chunks
BP_FAIL_AFTER = 48      # chunks the interrupted run scores
BP_SAMPLE = 1_024       # queries held byte for byte against serve_one


def bp_queries(model, seed: int) -> list:
    """Phase 3c's query file: every known user ``{"user", "num": 10}`` in
    index order, with unknown users, known users with a five-item
    blacklist and item-similarity queries at seeded random places."""
    rng = np.random.default_rng(seed + 31)
    users, items = model.user_map.labels, model.item_map.labels
    queries = [{"user": u, "num": 10} for u in users]
    extra = [{"user": f"ghost{j}", "num": 10} for j in range(BP_UNKNOWN)]
    extra += [{"user": users[u], "num": 10, "blacklist": [
        items[i] for i in rng.choice(len(items), 5, replace=False)]}
        for u in rng.integers(0, len(users), BP_BLACKLISTED)]
    extra += [{"items": [items[i] for i in rng.choice(len(items), n,
                                                      replace=False)],
               "num": 10} for n in rng.integers(1, 4, BP_SIMILAR)]
    for q in extra:
        queries.insert(int(rng.integers(0, len(queries) + 1)), q)
    return queries


def bp_plan(model, srv, queries: list, spans: list) -> "collections.Counter":
    """The B1 launches by (route, k, B) the chunk plan implies: per chunk,
    one ``users_topk`` launch per k of its known-user queries (the
    template's ``batch_predict`` groups them by ``num + |blacklist|``),
    the group padded to its uid bucket (at least 8), and one launch per
    item-similarity query (its micro-batch padded to 8 rows)."""
    import collections

    from predictionio_tpu_torch.ops import als_cuda, serving

    rows = int(srv._Y.shape[0])
    plan: collections.Counter = collections.Counter()

    def add(k: int, B: int) -> None:
        kb = min(serving.bucket_size(k), srv.n_items)
        route = als_cuda.topk_sort_plan(kb, rows, B, 1 << 30).route
        plan[(route, kb, B)] += 1

    for start, stop in spans:
        groups: collections.Counter = collections.Counter()
        for q in queries[start:stop]:
            if q.get("items"):
                add(q["num"], 8)
            elif model.user_map.get(q["user"]) is not None:
                black = {i for i in q.get("blacklist", ())
                         if model.item_map.get(i) is not None}
                groups[q["num"] + len(black)] += 1
        for k, B in groups.items():
            add(k, serving.bucket_size(B, lo=8))
    return plan


class ChunkClock:
    """Per-chunk seconds of a batch-prediction run, from wrappers around
    the predictor's steps: the chunk (``took``, as the run observes it),
    ``score_chunk``, each algorithm's ``batch_predict``, the device
    store's ``users_topk``, the serving's ``serve``, the rendering and
    the shard write. ``split()`` gives one chunk's parts."""

    def __init__(self, bp, dep):
        from predictionio_tpu_torch.utils import device_telemetry, metrics

        self.chunks: list = []
        self.device_us = 0.0
        self._cur: dict = {}
        self._undo: list = []
        algo, model = dep.algorithms[0], dep.models[0]
        self._wrap(bp, "score_chunk", "score", opens=True)
        self._wrap(bp, "_render_records", "render")
        self._wrap(bp, "_write_shard", "write")
        self._wrap(algo, "batch_predict_base", "predict")
        self._wrap(model.device_server(), "users_topk", "topk")
        self._wrap(dep.serving, "serve_base", "serve")
        hist = metrics.BATCHPREDICT_CHUNK_LATENCY
        observe = hist.observe

        def observed(took, **labels):
            self._cur["took"] = took
            self.chunks.append(self._cur)
            return observe(took, **labels)
        hist.observe = observed
        self._undo.append(lambda: vars(hist).pop("observe"))
        record = device_telemetry.record_dispatch

        def recorded(**kw):
            if kw.get("device_us") is not None:
                self.device_us += kw["device_us"]
            return record(**kw)
        device_telemetry.record_dispatch = recorded
        self._undo.append(lambda: setattr(device_telemetry,
                                          "record_dispatch", record))

    def _wrap(self, obj, name: str, part: str, opens: bool = False) -> None:
        fn = getattr(obj, name)

        def timed(*args, **kw):
            if opens:
                self._cur = {}
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self._cur[part] = self._cur.get(part, 0.0) \
                    + time.perf_counter() - t
        setattr(obj, name, timed)
        self._undo.append(lambda: vars(obj).pop(name))

    def close(self) -> None:
        for undo in reversed(self._undo):
            undo()

    @staticmethod
    def split(c: dict) -> dict:
        """One chunk's ms: extraction + supplement, the launches and
        copies of ``users_topk``, the result objects and serving, the
        rendering, the shard write with the journal's fsync."""
        ms = {k: v * 1e3 for k, v in c.items()}
        g = lambda k: ms.get(k, 0.0)
        return {"extract+supplement": g("score") - g("predict") - g("serve"),
                "users_topk launch+copy": g("topk"),
                "results": g("predict") - g("topk") + g("serve"),
                "render": g("render"),
                "write+fsync": g("took") - g("score") - g("render"),
                "chunk": g("took")}


def batch_predict_full_width(trained: dict, seed: int, card: str) -> dict:
    """Phase 3c: ``pio batchpredict``'s engine at ML-20M width, on phase
    5's stored engine instance (its instance and model blob put back
    into a memory store) at phase 3's serving precision, with the query
    file of :func:`bp_queries` (138,589 queries), chunks of 256, jsonl.
    Checks: (a) the summary counts every query and every chunk was
    scored; (b) the records of the first, the last and random chunks,
    ``BP_SAMPLE`` queries or more, equal byte for byte the records of
    ``serve_one`` (the looped path: the micro-batcher, B1 at B = 1) over
    the same queries; (c) B1's launches by (route, k, B) equal the chunk
    plan's; (d) a run over the first ``BP_RESUME_CHUNKS`` chunks'
    queries stopped after ``BP_FAIL_AFTER`` chunks
    (``fail_after_chunks``) resumes, skips them, scores the rest, and
    its shards are byte-equal to the clean run's. Prints the run's wall
    and scoring seconds, queries/s, B1's device ms (CUDA events) over
    the run, one median chunk's split and the looped path's queries/s."""
    import dataclasses
    import os
    import tempfile

    import torch

    from predictionio_tpu_torch.batch import predict as bp_mod
    from predictionio_tpu_torch.core.context import ComputeContext
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.ops import als_cuda

    model = trained["model"]
    work = tempfile.mkdtemp(prefix="pio-batchpredict-")
    storage.reset(storage.StorageConfig(
        {"M": {"type": "memory"}}, {r: "M" for r in storage.REPOSITORIES}))
    bp = None
    try:
        storage.get_metadata_engine_instances().insert(trained["instance"])
        storage.get_model_data_models().insert(trained["models_blob"])
        t = time.perf_counter()
        queries = bp_queries(model, seed)
        qfile = os.path.join(work, "queries.jsonl")
        with open(qfile, "w", encoding="utf-8") as f:
            f.writelines(json.dumps(q) + "\n" for q in queries)
        write_s = time.perf_counter() - t
        config = bp_mod.BatchPredictConfig(
            output_dir=os.path.join(work, "clean"),
            engine_instance_id=trained["instance"].id, input_path=qfile,
            chunk_size=BP_CHUNK)
        ctx = ComputeContext()
        t = time.perf_counter()
        bp = bp_mod.BatchPredictor(config, ctx=ctx)
        dep = bp.load()
        load_s = time.perf_counter() - t
        srv = dep.models[0].device_server()
        print(f"[batch] {len(queries)} queries written in {write_s:.2f} s; "
              f"instance {trained['instance'].id} loaded and warmed in "
              f"{load_s:.2f} s ({srv.precision} store, "
              f"{srv.store_bytes()} bytes)")

        als_cuda.launches.reset()
        clock = ChunkClock(bp, dep)
        try:
            summary = bp.run()
            torch.cuda.synchronize()
        finally:
            clock.close()
        launches = als_cuda.launches.by_key()
        spans = [(c["start"], c["start"] + c["count"])
                 for c in bp_mod.Manifest.load(os.path.join(
                     config.output_dir, bp_mod.MANIFEST_NAME)).chunks]
        # (a): every query counted, every chunk of the plan scored, and
        # the chunks tile the input
        tiled = ([s for s, _ in spans] == [0] + [e for _, e in spans[:-1]]
                 and spans[-1][1] == len(queries))
        if (summary["queries"] != len(queries)
                or summary["chunks"] != len(spans)
                or summary["chunksScored"] != len(spans)
                or summary["chunksSkipped"] != 0 or not tiled):
            raise AssertionError(f"batch predict summary {summary}, "
                                 f"{len(spans)} chunks, tiled={tiled}")
        # (c)
        plan = bp_plan(model, srv, queries, spans)
        by_route: dict = {}
        for (route, _, _), n in launches.items():
            by_route[route] = by_route.get(route, 0) + n
        print(f"[batch] B1 launches by route: {by_route}; by (route, k, B): "
              + ", ".join(f"{r} k={k} B={b}: {n}"
                          for (r, k, b), n in sorted(launches.items())))
        if launches != dict(plan):
            raise AssertionError(f"B1 launches {launches} != the chunk "
                                 f"plan's {dict(plan)}")
        # the run's numbers and one median chunk's split
        took = [c["took"] for c in clock.chunks]
        median = clock.chunks[int(np.argsort(took)[len(took) // 2])]
        split = ChunkClock.split(median)
        mean_split = {k: float(np.mean([ChunkClock.split(c)[k]
                                        for c in clock.chunks]))
                      for k in split}
        qps = summary["queries"] / summary["wallSec"]
        print(f"[batch] {summary['queries']} queries in {summary['chunks']} "
              f"chunks: wall {summary['wallSec']!r} s, scoring "
              f"{summary['scoringSec']!r} s, {summary['queriesPerSec']!r} "
              f"queries/s scoring, {qps!r} queries/s wall; B1 device "
              f"{clock.device_us / 1e3!r} ms over the run "
              f"({clock.device_us / 1e4 / summary['scoringSec']!r}% of the "
              f"scoring time) ({card})")
        print(f"[batch] median chunk split (ms): {json.dumps(split)}; mean "
              f"over the chunks: {json.dumps(mean_split)}")

        # (b) the looped path over sampled chunks, byte for byte
        rng = np.random.default_rng(seed + 32)
        picks = [0, len(spans) - 1]
        while sum(spans[i][1] - spans[i][0] for i in picks) < BP_SAMPLE:
            j = int(rng.integers(1, len(spans) - 1))
            if j not in picks:
                picks.append(j)
        lines = bp_mod._canonical_query_lines(queries)
        sampled = 0
        t = time.perf_counter()
        for i in picks:
            start, stop = spans[i]
            looped = [bp.serve_one(q) for q in queries[start:stop]]
            want = "".join(r + "\n" for r in bp.__class__._render_records(
                lines[start:stop], looped)).encode("utf-8")
            with open(os.path.join(config.output_dir,
                                   f"part-{i:05d}.jsonl"), "rb") as f:
                if f.read() != want:
                    raise AssertionError(f"chunk {i}'s shard differs from "
                                         "the looped serve_one records")
            sampled += stop - start
        loop_s = time.perf_counter() - t
        print(f"[batch] chunks {sorted(picks)} ({sampled} queries) equal "
              f"the looped serve_one records byte for byte; the looped path "
              f"{sampled / loop_s!r} queries/s ({card})")

        # (d) an interrupted run, then its resume, over the first
        # BP_RESUME_CHUNKS chunks' queries
        prefix = os.path.join(work, "prefix.jsonl")
        n_prefix = spans[BP_RESUME_CHUNKS - 1][1]
        with open(qfile, "rb") as f, open(prefix, "wb") as g:
            g.writelines(f.readline() for _ in range(n_prefix))
        resumed = dataclasses.replace(config, input_path=prefix,
                                      output_dir=os.path.join(work, "resumed"))
        als_cuda.launches.reset()

        def run(cfg):
            # a predictor of its own over the deployment already loaded
            other = bp_mod.BatchPredictor(cfg, ctx=ctx)
            other._deployment = dep
            return other.run()

        try:
            run(dataclasses.replace(resumed, fail_after_chunks=BP_FAIL_AFTER))
        except RuntimeError as e:
            if "fault injection" not in str(e):
                raise
        else:
            raise AssertionError("fail_after_chunks did not stop the run")
        again = run(resumed)
        if (again["chunksSkipped"], again["chunksScored"]) != (
                BP_FAIL_AFTER, BP_RESUME_CHUNKS - BP_FAIL_AFTER):
            raise AssertionError(f"the resume: {again}")
        for c in range(BP_RESUME_CHUNKS):
            name = f"part-{c:05d}.jsonl"
            with open(os.path.join(config.output_dir, name), "rb") as a, \
                    open(os.path.join(resumed.output_dir, name), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"resumed shard {name} differs")
        print(f"[batch] the first {BP_RESUME_CHUNKS} chunks' queries "
              f"stopped after {BP_FAIL_AFTER} chunks, resumed: "
              f"{again['chunksSkipped']} skipped, {again['chunksScored']} "
              f"scored in {again['wallSec']!r} s; every shard byte-equal to "
              f"the clean run's ({als_cuda.launches.value} B1 launches over "
              f"both)")
        return {"launches": sum(launches.values()), "by_route": by_route,
                "queries": len(queries), "chunks": len(spans),
                "wall_s": summary["wallSec"],
                "scoring_s": summary["scoringSec"],
                "queries_per_s": summary["queriesPerSec"],
                "b1_device_ms": clock.device_us / 1e3,
                "median_split_ms": split, "mean_split_ms": mean_split,
                "looped_queries_per_s": sampled / loop_s}
    finally:
        if bp is not None and bp._deployment is not None:
            for m in bp._deployment.models:
                if getattr(m, "_server", None) is not None:
                    m._server.close()
                    m._server = None
        storage.reset()
        shutil.rmtree(work, ignore_errors=True)


# -- phase 3b: online fold-in at ML-20M width ---------------------------------

FOLDIN_APP = "FoldIn20M"
FOLDIN_KNOWN = 512        # users whose full histories the store holds
FOLDIN_TOUCHED = 256      # of them, given 1-3 new ratings after deploy
FOLDIN_NEW = 96           # brand-new users, 5-200 ratings each
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


# -- phase 3d: the query fleet at ML-20M width ----------------------------------

FLEET_REPLICAS = 3
FLEET_USERS = 1_024       # user queries from FLEET_CLIENTS threads in (b)
FLEET_CLIENTS = 8
FLEET_SEQ = 100           # sequential user queries, direct and through the balancer
FLEET_BURST = 384         # user queries in each throughput burst
FLEET_BURST_CLIENTS = (8, 32)
FLEET_ROLL_USERS = 16     # users each reload client asks for, in turn
FLEET_FAILOVER = 16       # the stopped replica's users asked in (d)


def lane_counts(fleet) -> list:
    """Each replica's ``{lane: (batched queries, dispatches)}``, read from
    its own device store (not from the registry the replicas share)."""
    out = []
    for rep in fleet.replicas:
        stats = rep.server._deployment.models[0].device_server().stats()
        out.append({lane: (st["batchedQueries"], st["dispatches"])
                    for lane, st in stats.items()})
    return out


def served_by(before: list, after: list, lane: str = "users") -> list:
    """The replicas whose ``lane`` took queries between two reads."""
    return [i for i, (b, a) in enumerate(zip(before, after))
            if a.get(lane, (0, 0))[0] > b.get(lane, (0, 0))[0]]


def post_any(url: str, payload, headers=None) -> tuple:
    """``post`` that returns an HTTP error's status and JSON body."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers=headers or {}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read()), \
                time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t0


def agrees(q: dict, status: int, body, ref: tuple) -> bool:
    try:
        check_answer(q, status, body, ref)
        return True
    except AssertionError:
        return False


# a client process of closed-loop threads, each on one keep-alive
# connection: the clients do not share the servers' interpreter lock
BURSTER = r"""
import http.client, json, sys, threading, time
host, port, clients = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
users = json.loads(sys.stdin.read())
bad, lock = [], threading.Lock()
barrier = threading.Barrier(clients + 1)

def client(c):
    conn = http.client.HTTPConnection(host, port, timeout=120)
    barrier.wait()
    for u in users[c::clients]:
        conn.request("POST", "/queries.json",
                     body=json.dumps({"user": f"u{u}", "num": 10}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        if resp.status != 200 or not body["itemScores"]:
            with lock:
                bad.append((u, resp.status))

threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
for t in threads:
    t.start()
barrier.wait()
t0 = time.perf_counter()
for t in threads:
    t.join()
print(json.dumps({"seconds": time.perf_counter() - t0, "bad": bad}))
"""


# the roll's clients: a process of threads, each asking for its users in
# turn on one keep-alive connection until the stop file appears; the
# answers are printed in each thread's order
ROLLER = r"""
import http.client, json, os, sys, threading
host, port, stop_file = sys.argv[1], int(sys.argv[2]), sys.argv[3]
users = json.loads(sys.argv[4])
seen = [[] for _ in users]
barrier = threading.Barrier(len(users) + 1)

def client(c):
    conn = http.client.HTTPConnection(host, port, timeout=120)
    barrier.wait()
    j = 0
    while not os.path.exists(stop_file):
        u = users[c][j % len(users[c])]
        try:
            conn.request("POST", "/queries.json",
                         body=json.dumps({"user": u, "num": 10}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            seen[c].append([u, resp.status, json.loads(resp.read())])
        except Exception as e:
            seen[c].append([u, 0, repr(e)])
            conn = http.client.HTTPConnection(host, port, timeout=120)
        j += 1

threads = [threading.Thread(target=client, args=(c,))
           for c in range(len(users))]
for t in threads:
    t.start()
barrier.wait()
print("started", flush=True)
for t in threads:
    t.join()
print(json.dumps(seen))
"""


def client_burst(base: str, users, clients: int) -> float:
    """Queries/s of one user query per entry of ``users`` from a
    ``BURSTER`` process of ``clients`` threads."""
    host, port = base.rsplit("//", 1)[1].split(":")
    proc = subprocess.run(
        [sys.executable, "-c", BURSTER, host, port, str(clients)],
        input=json.dumps([int(u) for u in users]), capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"burst client failed: {proc.stderr[-2000:]}")
    res = json.loads(proc.stdout.splitlines()[-1])
    if res["bad"]:
        raise AssertionError(f"burst answers failed: {res['bad'][:5]}")
    return len(users) / res["seconds"]


def fleet_bursts(base: str, users) -> tuple:
    """Queries/s of ``FLEET_BURST`` user queries from each number of
    closed-loop clients (a client process each), and the last burst's
    profile: the card's busy share, and the flight recorder's
    ``device.execute`` CUDA-event time against the profiler's time of
    B1's kernels and the burst's wall."""
    from predictionio_tpu_torch.utils import device_telemetry

    *plain, profiled = FLEET_BURST_CLIENTS
    qps = {clients: client_burst(base, users, clients) for clients in plain}
    recorder = device_telemetry.recorder()
    recorder.reset()
    rate = []
    wall, busy, kernels, kernel_ms = device_busy(
        lambda: rate.append(client_burst(base, users, profiled)))
    qps[profiled] = rate[0]
    records = recorder.snapshot(recorder.capacity)
    event_ms = sum(r["deviceUs"] for r in records
                   if r.get("deviceUs") is not None) / 1e3
    b1_ms = sum(kernel_ms[name] for name in b1_kernel_names())
    return qps, {
        "wall_ms": wall, "busy_ms": busy,
        "busy_share": busy / wall if wall else None,
        "records": len(records), "event_ms": event_ms, "b1_ms": b1_ms,
        "event_over_b1": event_ms / b1_ms if b1_ms else None,
        "within": bool(b1_ms) and 0.98 * b1_ms <= event_ms <= wall,
        "profiled": bool(kernels)}


def query_fleet_full_width(dev, trained: dict, seed: int, card: str) -> dict:
    """Phase 3d: ``QueryFleet`` (``pio deploy --fleet 3``) at ML-20M
    width on phase 5's stored engine instance (put back into a memory
    store), at phase 3's serving precision; checks (a)-(f) of the module
    docstring, then the printed timings."""
    import collections
    import dataclasses
    import datetime
    import gc
    import os
    import secrets
    import tempfile
    import uuid
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.storage.base import Model
    from predictionio_tpu_torch.fleet.balancer import QueryFleet
    from predictionio_tpu_torch.ops import als as als_mod
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops import serving as serving_mod
    from predictionio_tpu_torch.templates.recommendation.engine import (
        ALSModel,
    )
    from predictionio_tpu_torch.utils import metrics
    from predictionio_tpu_torch.workflow import core_workflow
    from predictionio_tpu_torch.workflow.create_server import ServerConfig

    base_model = trained["model"]
    base_model._server = None
    gc.collect()
    torch.cuda.empty_cache()
    inst = trained["instance"]
    storage.reset(storage.StorageConfig(
        {"M": {"type": "memory"}}, {r: "M" for r in storage.REPOSITORIES}))
    storage.get_metadata_engine_instances().insert(inst)
    storage.get_model_data_models().insert(trained["models_blob"])
    config = ServerConfig(ip="127.0.0.1", port=0, engine_id=inst.engine_id,
                          engine_version=inst.engine_version,
                          engine_variant=inst.engine_variant)
    R = FLEET_REPLICAS
    rng = np.random.default_rng(seed + 17)
    out: dict = {}
    launches = collections.Counter()
    fleet = None
    work = tempfile.mkdtemp(prefix="pio-fleet-")
    try:
        # (a) three replicas, each with its own device store on the card
        als_cuda.launches.reset()
        allocated0 = torch.cuda.memory_allocated()
        t = time.perf_counter()
        fleet = QueryFleet(config, replicas=R).start()
        start_s = time.perf_counter() - t
        base = "http://%s:%d" % fleet.address
        models = [rep.server._deployment.models[0] for rep in fleet.replicas]
        stores = [m.device_server() for m in models]
        for store in stores:
            if not isinstance(store, serving_mod.DeviceTopK) \
                    or store.device.type != dev.type \
                    or store.precision != "bf16":
                raise AssertionError(f"a replica serves from {store!r}")
        if len({id(s) for s in stores}) != R:
            raise AssertionError("the replicas share a device store")
        health = get_json(base + "/healthz")
        stats = get_json(base + "/stats.json")
        if not health["ready"] or stats["fleet"]["readyReplicas"] != R:
            raise AssertionError(f"fleet not ready: {health}, "
                                 f"{stats['fleet']}")
        per_replica = [s.memory_report()["totalBytes"] for s in stores]
        report = serving_mod.device_report()
        allocated = torch.cuda.memory_allocated()
        if sum(per_replica) > allocated - allocated0 \
                or report["storeBytes"] < sum(per_replica):
            raise AssertionError(
                f"the replicas' stores {per_replica} against device_report "
                f"{report['storeBytes']} and memory_allocated growth "
                f"{allocated - allocated0}")
        print(f"[fleet] {R} replicas started in {start_s!r} s behind "
              f"{base}: each a bf16 DeviceTopK on {stores[0].device}; "
              f"store bytes per replica {per_replica}, device_report "
              f"{report['storeBytes']} over {len(report['stores'])} live "
              f"stores, torch.cuda.memory_allocated {allocated} ({allocated - allocated0} "
              f"more than before the fleet) ({card})")
        out["start_s"] = start_s
        out["memory"] = {"per_replica": per_replica, "allocated": allocated,
                         "device_report": report["storeBytes"]}

        # (b) phase 3's five kinds, sequential, and FLEET_USERS user
        # queries from FLEET_CLIENTS threads: answers equal the plain
        # pipeline's, every user on its ring owner
        users = [f"u{u}" for u in rng.integers(0, N_USERS, 68)]
        queries = [{"user": u, "num": 10} for u in users[:24]]
        queries += [{"user": u, "num": 10,
                     "blacklist": [f"i{i}" for i in rng.integers(0, 500, 3)]}
                    for u in users[24:32]]
        queries += [{"items": [f"i{i}" for i in rng.integers(0, M_ITEMS, n)],
                     "num": 10} for n in (1, 1, 2, 2, 3, 3, 5, 9)]
        queries += [{"user": users[32], "num": 10, "categories": ["g3"]},
                    {"user": users[33], "num": 5,
                     "categories": ["g7", "g11"]},
                    {"user": "no-such-user", "num": 10}]
        start_counts = lane_counts(fleet)
        answers, sticky = [], 0
        for q in queries:
            before = lane_counts(fleet)
            answers.append((q, *post(base + "/queries.json", q)))
            if q.get("user") in base_model.user_map:
                got = served_by(before, lane_counts(fleet))
                if got != [fleet.ring.preference(q["user"])[0]]:
                    raise AssertionError(f"{q['user']} landed on {got}, its "
                                         f"ring owner is "
                                         f"{fleet.ring.preference(q['user'])[0]}")
                sticky += 1
        concurrent = [{"user": f"u{u}", "num": 10}
                      for u in rng.integers(0, N_USERS, FLEET_USERS)]
        before = lane_counts(fleet)
        in_burst = burst(base, concurrent, FLEET_CLIENTS)
        after = lane_counts(fleet)
        owners = collections.Counter(fleet.ring.preference(q["user"])[0]
                                     for q in concurrent)
        took = [a["users"][0] - b["users"][0] for b, a in zip(before, after)]
        if took != [owners[i] for i in range(R)]:
            raise AssertionError(f"the replicas took {took} of the "
                                 f"concurrent user queries, their ring "
                                 f"owners {dict(owners)}")
        dispatches = [sum(a[lane][1] - b.get(lane, (0, 0))[1] for lane in a)
                      for b, a in zip(start_counts, after)]
        if min(dispatches) <= 0:
            raise AssertionError(f"B1 dispatches per replica {dispatches}")
        checked = check_against_plain(models[0], answers + in_burst)
        print(f"[fleet] (b) {checked} answers ({len(queries)} sequential of "
              f"phase 3's kinds, {len(concurrent)} from {FLEET_CLIENTS} "
              f"clients) equal the plain pipeline; {sticky} sequential "
              f"user queries each on its ring owner, the concurrent ones "
              f"split {took} as the ring; B1 dispatches per replica "
              f"{dispatches}")
        out["dispatches_per_replica"] = dispatches
        out["split"] = took

        # the hop's cost: sequential user queries straight to the ring
        # owner and through the balancer, alternating
        direct, hop = [], []
        for u in rng.integers(0, N_USERS, FLEET_SEQ):
            q = {"user": f"u{u}", "num": 10}
            owner = fleet.replicas[fleet.ring.preference(q["user"])[0]]
            host, port = owner.address
            direct.append(post(f"http://{host}:{port}/queries.json", q)[2])
            hop.append(post(base + "/queries.json", q)[2])
        seq = {name: {"p50_ms": float(np.percentile(v, 50)) * 1e3,
                      "p99_ms": float(np.percentile(v, 99)) * 1e3}
               for name, v in (("direct", direct), ("balancer", hop))}
        print(f"[fleet] sequential user queries ({FLEET_SEQ} each): "
              f"straight to the replica {json.dumps(seq['direct'])}, "
              f"through the balancer {json.dumps(seq['balancer'])} ({card})")
        out["sequential"] = seq
        burst_users = rng.integers(0, N_USERS, FLEET_BURST)
        out["burst_qps"], brackets = {}, {}
        out["burst_qps"][R], brackets[R] = fleet_bursts(base, burst_users)

        # (e) observability: the federated /metrics counts the balancer's
        # queries once, /stats.json's fleet block, a traced query's tree
        trace_id = secrets.token_hex(16)
        client_span = secrets.token_hex(8)
        status, _, _ = post_any(
            base + "/queries.json", {"user": users[0], "num": 10},
            {"traceparent": f"00-{trace_id}-{client_span}-01"})
        sent = len(queries) + len(concurrent) + FLEET_SEQ \
            + len(burst_users) * len(FLEET_BURST_CLIENTS) + 1
        time.sleep(0.2)   # a request is counted just after its answer
        t = time.perf_counter()
        fams = scrape(base)
        scrape_s = time.perf_counter() - t
        series = fams["pio_http_requests_total"]["series"]

        def counted(server: str, member=None) -> float:
            return sum(e["value"] for e in series
                       if e["labels"].get("server") == server
                       and e["labels"].get("route") == "/queries.json"
                       and e["labels"].get("member") == member)

        local = {server: sum(
            e["value"] for e in metrics.registry().snapshot()[
                "pio_http_requests_total"]["series"]
            if e["labels"].get("server") == server
            and e["labels"].get("route") == "/queries.json")
            for server in ("balancer", "query")}
        if not (counted("balancer") == counted("balancer", "balancer")
                == local["balancer"] == sent) \
                or counted("query") != local["query"]:
            raise AssertionError(
                f"federated /metrics counts the balancer's queries "
                f"{counted('balancer')} (member drill-down "
                f"{counted('balancer', 'balancer')}), the registry "
                f"{local}, sent {sent}; replicas' {counted('query')}")
        stats = get_json(base + "/stats.json")
        fleet_block = stats["fleet"]
        if not fleet_block["members"] or "durationSec" not in \
                fleet_block["scrape"] or "firing" not in stats["alerts"]:
            raise AssertionError(f"/stats.json: {list(fleet_block)}, "
                                 f"{stats.get('alerts')}")
        record = fetch_trace(base, trace_id)
        spans = {s["name"]: s for s in record["spans"]}
        root = spans.get("balancer POST /queries.json")
        replica = spans.get("query POST /queries.json")
        if status != 200 or root is None or replica is None \
                or root["parentId"] != client_span \
                or replica["parentId"] != root["spanId"]:
            raise AssertionError(f"the assembled trace: "
                                 f"{sorted(spans)} {record.get('processes')}")
        index = get_json(base + "/traces.json?limit=5")
        print(f"[fleet] (e) federated /metrics ({scrape_s!r} s to scrape "
              f"and parse): the balancer's /queries.json counted "
              f"{counted('balancer')!r} = sent {sent}, the replicas' "
              f"{counted('query')!r} = the registry's (the in-process "
              f"member counted once); /stats.json members "
              f"{[m['member'] for m in fleet_block['members']]}, scrape "
              f"{fleet_block['scrape']['durationSec']!r} s, alerts firing "
              f"{stats['alerts']['firing']}; /traces/{trace_id}: "
              f"{len(record['spans'])} spans, balancer span at the root "
              f"over the replica's; /traces.json {len(index['traces'])} "
              f"traces")
        out["scrape_s"] = fleet_block["scrape"]["durationSec"]

        # (c) a rolling reload to a second instance under load
        pd = trained["pd"]
        us, its = pd.user_side.to_device(dev), pd.item_side.to_device(dev)
        als_cuda.assemble_launches.reset()
        als_cuda.spd_launches.reset()
        t = time.perf_counter()
        X2, Y2 = als_mod.train_als_bucketed(us, its, als_mod.ALSParams(
            rank=RANK, num_iterations=ITERATIONS, lambda_=LAMBDA,
            alpha=ALPHA, seed=seed + 1), dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        # the smoke's own training, not the fleet's: kept apart
        out["roll_training"] = {
            "assemble_normal_equations": als_cuda.assemble_launches.value,
            "spd_solve": als_cuda.spd_launches.value}
        del us, its
        second = ALSModel(np.asarray(X2), np.asarray(Y2),
                          base_model.user_map, base_model.item_map,
                          base_model.seen,
                          item_categories=base_model.item_categories)
        del X2, Y2
        now = datetime.datetime.now(tz=datetime.timezone.utc)
        inst2 = dataclasses.replace(inst, id="ei_" + uuid.uuid4().hex,
                                    start_time=now, end_time=now)
        t = time.perf_counter()
        storage.get_model_data_models().insert(Model(
            id=inst2.id, models=core_workflow.serialize_models([second])))
        storage.get_metadata_engine_instances().insert(inst2)
        store_s = time.perf_counter() - t
        roll_users = [[f"u{u}" for u in rng.integers(0, N_USERS,
                                                      FLEET_ROLL_USERS)]
                      for _ in range(FLEET_CLIENTS)]
        roll_queries = [{"user": u, "num": 10}
                        for users_c in roll_users for u in users_c]
        old_refs = dict(zip(map(json.dumps, roll_queries),
                            plain_references(models[0], roll_queries)))
        stop_file = os.path.join(work, "stop-roll")
        host, port = fleet.address
        roller = subprocess.Popen(
            [sys.executable, "-c", ROLLER, host, str(port), stop_file,
             json.dumps(roll_users)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            if read_line(roller, 60, raw=True).strip() != "started":
                raise AssertionError("the roll's clients did not start")
            time.sleep(0.5)
            t = time.perf_counter()
            status, body, _ = post_any(base + "/reload", {})
            reload_s = time.perf_counter() - t
            time.sleep(0.5)
        finally:
            open(stop_file, "w").close()
            rolled, err = roller.communicate(timeout=120)
        if roller.returncode != 0:
            raise AssertionError(f"the roll's clients failed: {err[-2000:]}")
        seen_by = [[({"user": u, "num": 10}, st, b, 0.0) for u, st, b in c]
                   for c in json.loads(rolled.splitlines()[-1])]
        errors = [b for c in seen_by for _, st, b, _ in c if st == 0]
        if status != 200 or [r["replica"] for r in body["replicas"]] != \
                list(range(R)) or any(r["swappedTo"] != inst2.id
                                      for r in body["replicas"]):
            raise AssertionError(f"/reload answered {status} {body}")
        new_models = [rep.server._deployment.models[0]
                      for rep in fleet.replicas]
        if any(m is old for m, old in zip(new_models, models)):
            raise AssertionError("a replica kept its deployment")
        del models, stores, store
        new_refs = dict(zip(map(json.dumps, roll_queries),
                            plain_references(new_models[0], roll_queries)))
        n_answers = sum(len(s) for s in seen_by)
        failed = [a for s in seen_by for a in s if a[1] != 200]
        mixed, both = [], 0
        for c, answers_c in enumerate(seen_by):
            switched = set()
            for q, status, body, _ in answers_c:
                key = json.dumps(q)
                is_old = agrees(q, status, body, old_refs[key])
                is_new = agrees(q, status, body, new_refs[key])
                both += is_old and is_new
                if not (is_old or is_new):
                    mixed.append((q, "neither"))
                elif is_new and not is_old:
                    switched.add(q["user"])
                elif q["user"] in switched:
                    mixed.append((q, "old after new"))
        if errors or failed or mixed or not n_answers:
            raise AssertionError(
                f"during the roll: {len(errors)} errors {errors[:3]}, "
                f"{len(failed)} failed {failed[:3]}, {len(mixed)} answers "
                f"out of order or of neither instance {mixed[:3]}")
        after_roll = [(q, *post(base + "/queries.json", q))
                      for q in roll_queries]
        check_against_plain(new_models[0], after_roll)
        storage.get_metadata_engine_instances().delete(inst2.id)
        status, refused, _ = post_any(base + "/reload", {})
        if status != 409 or refused.get("replicas") != [] \
                or "older" not in refused.get("message", ""):
            raise AssertionError(f"a reload to the older instance answered "
                                 f"{status} {refused}")
        gc.collect()
        per_replica = [m.device_server().memory_report()["totalBytes"]
                       for m in new_models]
        print(f"[fleet] (c) second instance trained in {train_s!r} s (B3 "
              f"{out['roll_training']['assemble_normal_equations']}, B2 "
              f"{out['roll_training']['spd_solve']} launches) and stored in "
              f"{store_s!r} s; /reload rolled {R} replicas in {reload_s!r} s "
              f"under {FLEET_CLIENTS} clients: {n_answers} answers, none "
              f"failed, each the old or the new instance's ({both} equal "
              f"both), no user back to the old after the new; "
              f"{len(after_roll)} answers after the roll equal the new "
              f"instance's; a reload to the older one answered 409 with "
              f"replicas {refused['replicas']}; store bytes per replica "
              f"{per_replica}, memory_allocated "
              f"{torch.cuda.memory_allocated()}, device_report "
              f"{serving_mod.device_report()['storeBytes']} ({card})")
        out["reload"] = {"s": reload_s, "answers": n_answers,
                         "train_s": train_s}

        # (d) a stopped replica: its users go to the next in their ring
        # preference, marked replica_down, and equal the plain answers
        down = 1
        fleet.replicas[down].server.stop()
        moved = []
        for u in rng.permutation(N_USERS):
            if fleet.ring.preference(f"u{u}")[0] == down:
                moved.append({"user": f"u{u}", "num": 10})
            if len(moved) == FLEET_FAILOVER:
                break
        failover = []
        for q in moved:
            before = lane_counts(fleet)
            failover.append((q, *post(base + "/queries.json", q)))
            got = served_by(before, lane_counts(fleet))
            want = [fleet.ring.preference(q["user"])[1]]
            body = failover[-1][2]
            if got != want or body.get("degradedReasons") != \
                    ["replica_down"] or body.get("degraded") is not True:
                raise AssertionError(f"{q['user']} of the stopped replica: "
                                     f"served by {got} (want {want}), "
                                     f"{body.get('degradedReasons')}")
        check_against_plain(new_models[0], failover)
        health = get_json(base + "/healthz")
        if not health["ready"]:
            raise AssertionError(f"/healthz with a replica down: {health}")
        print(f"[fleet] (d) replica {down} stopped: {len(failover)} of its "
              f"users answered by their next replica, each marked "
              f"degradedReasons ['replica_down'], equal the plain pipeline; "
              f"/healthz ready")

        # (f) the operator commands against the balancer, side by side,
        # each over a sqlite file of its own
        t = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            verbs = [pool.submit(pio, verb, console_env(
                os.path.join(work, f"{verb[0]}.db")), work) for verb in (
                ["status", "--fleet", base],
                ["top", "--once", "--fleet", "--url", base])]
            (said_status, status_s), (said_top, top_s) = \
                [v.result() for v in verbs]
        verbs_s = time.perf_counter() - t
        fleet_line = [ln for ln in said_status.splitlines()
                      if ln.startswith("[INFO] Query fleet: ")]
        members = [ln for ln in said_top.splitlines()
                   if ln.startswith("member   balancer")]
        if not fleet_line or f"/{R} replicas ready" not in fleet_line[0] \
                or not members or "no federated fleet block" in said_top:
            raise AssertionError(f"pio status --fleet: {said_status!r}; "
                                 f"pio top --fleet: {said_top!r}")
        print(f"[fleet] (f) pio-torch status --fleet: {fleet_line[0]!r}; "
              f"pio-torch top --fleet --once: {members[0]!r}; the two "
              f"processes {status_s!r} s and {top_s!r} s, side by side "
              f"{verbs_s!r} s")
        out["operator_s"] = {"status": status_s, "top": top_s,
                             "both": verbs_s}
        fleet.stop()
        launches["fused_gather_score_topk"] += als_cuda.launches.value
        fleet = None
        del new_models
        gc.collect()
        torch.cuda.empty_cache()

        # a one-replica fleet, for the burst rates beside the three's
        als_cuda.launches.reset()
        fleet = QueryFleet(config, replicas=1, instance=inst).start()
        base = "http://%s:%d" % fleet.address
        out["burst_qps"][1], brackets[1] = fleet_bursts(base, burst_users)
        fleet.stop()
        launches["fused_gather_score_topk"] += als_cuda.launches.value
        fleet = None
        for n, b in sorted(brackets.items()):
            if not b["profiled"]:
                print(f"[fleet] {n}-replica burst: the profiler recorded no "
                      f"CUDA kernels")
                continue
            print(f"[fleet] profiled burst of {FLEET_BURST} queries from "
                  f"{FLEET_BURST_CLIENTS[-1]} clients through a {n}-replica "
                  f"fleet: wall {b['wall_ms']!r} ms, card busy "
                  f"{b['busy_ms']!r} ms ({100 * b['busy_share']:.2f}%); "
                  f"device.execute CUDA events {b['event_ms']!r} ms over "
                  f"{b['records']} dispatches against the profiler's "
                  f"{b['b1_ms']!r} ms of B1's kernels (ratio "
                  f"{b['event_over_b1']!r}); within [0.98 x B1, wall]: "
                  f"{b['within']}")
            # each dispatch's bracket may hold another replica's kernels
            # and the host's gaps between its own launches, so the sum
            # is bounded below by B1's kernels and above by the wall
            if b["b1_ms"] and not b["within"]:
                raise AssertionError(
                    f"device.execute's device time {b['event_ms']!r} ms "
                    f"lies outside [0.98 x {b['b1_ms']!r}, "
                    f"{b['wall_ms']!r}] ms with {n} replicas")
        print(f"[fleet] burst queries/s by replicas and clients: "
              f"{json.dumps(out['burst_qps'])} ({card})")
        out["brackets"] = brackets
        out["launches"] = dict(launches)
        print(f"[fleet] launches of the phase: {dict(launches)}")
        if not launches["fused_gather_score_topk"]:
            raise AssertionError("the fleet never launched B1")
        return out
    finally:
        if fleet is not None:
            fleet.stop()
        storage.reset()
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# -- phase 4 ----------------------------------------------------------------

def time_ms(fn, iters: int, warmups: int = 2) -> float:
    import torch

    for _ in range(warmups):
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

    from predictionio_tpu_torch.ops import als_cuda, aot

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
                if k <= 128 and (dtype == "bf16" or B in (8, 256)):
                    row["device_ms"] = kernel_split(kernel, 20)
                    split = (f"  device {sum(row['device_ms'].values())!r} "
                             f"ms {row['device_ms']}")
                if dtype == "bf16":
                    # the same launch captured alone in a CUDA graph (as
                    # the serving ladder replays it), its replays timed
                    prog = aot.capture(
                        lambda q: als_cuda.fused_gather_score_topk(
                            q, store, ct, mt, k=k, n_items=M_ITEMS), (Qt,))
                    row["graph_ms"] = time_ms(prog.graph.replay, iters)
                    split += f"  in a graph {row['graph_ms']!r} ms"
                    del prog
                rows.append(row)
                print(f"[time] {dtype:>4} B={B:<3} k={k:<5} kernel "
                      f"{t_k!r} ms  plain {t_p!r} ms  library {t_l!r} ms  "
                      f"bound {b_ms!r} ms ({b_by}){split}")
    return rows


# phase 4c's batches and routes: the chunked, tiled and bitonic routes
# of k <= 128 on the same inputs
CROSSOVER_BATCHES = (1, 8, 16, 32, 64, 96, 128, 256)
CROSSOVER_ROUTES = ("chunked", "tiled", "bitonic")
# grid_topk's shape (phase 5d): the held-out users of one grid batch,
# GRID_TOPK, and each user's training items masked (the longest row)
GRID_TOPK_SHAPE = dict(B=512, k=10, L=2_047)


def route_times(call) -> tuple:
    """One route's device ms per call (profiler, summed over its
    kernels), the split by kernel name and the event-timed ms."""
    split = kernel_split(call, 20)
    return sum(split.values()), split, time_ms(call, 20)


def routes_equal(out: dict, label: str) -> None:
    """Every route's answer bitwise the first's: value bits everywhere,
    ids wherever the value is finite."""
    import torch

    rv, ri = next(iter(out.values()))
    fin = torch.isfinite(rv)
    for name, (v, i) in list(out.items())[1:]:
        if not (torch.equal(v.view(torch.int32), rv.view(torch.int32))
                and torch.equal(i[fin], ri[fin])):
            raise AssertionError(f"{label}: the {name} route differs from "
                                 f"the {next(iter(out))} route")


def route_crossover(dev, seed: int) -> dict:
    """The chunked, tiled and bitonic routes on the same bf16 inputs at k
    in {16, 128} and each batch of ``CROSSOVER_BATCHES``, and the tiled
    and bitonic routes at ``grid_topk``'s shape (fp32): their answers
    bitwise equal; each route's device ms per call (profiler, summed
    over its kernels), split by kernel name, and event-timed ms. Returns
    per k the fastest route by device time at each batch, the plan's
    route, and the smallest batch from which the tiled route's device
    time is at most the chunked route's (None if it never is)."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    rng = np.random.default_rng(seed + 4)
    out: dict = {"first_tiled": {}, "by_batch": {}, "grid": None}
    tiled_s = 0.0    # the seconds of the tiled route's calls and timings
    for k in (16, 128):
        out["first_tiled"][k] = None
        for B in CROSSOVER_BATCHES:
            Q, Yf, cols, mask = fixture("random", B, rng)
            store, _ = make_store(Yf, "bf16", dev)
            Qt, ct, mt = (torch.from_numpy(a).to(dev) for a in (Q, cols, mask))
            answers, devt, ev = {}, {}, {}
            for route in CROSSOVER_ROUTES:
                def call(route=route):
                    return als_cuda._launch(Qt, store, ct, mt, k=k,
                                            n_items=M_ITEMS, mask_seen=True,
                                            row_valid=None, route=route)
                t = time.perf_counter()
                answers[route] = call()
                devt[route], split, ev[route] = route_times(call)
                if route == "tiled":
                    tiled_split = split
                    tiled_s += time.perf_counter() - t
            routes_equal(answers, f"B={B}, k={k}")
            if (out["first_tiled"][k] is None
                    and devt["tiled"] <= devt["chunked"]):
                out["first_tiled"][k] = B
            plan = als_cuda.topk_sort_plan(k, M_ITEMS, B, 1 << 30).route
            fastest = min(devt, key=devt.get)
            out["by_batch"][f"k={k} B={B}"] = {
                "plan": plan, "fastest": fastest, "device_ms": devt,
                "event_ms": ev, "tiled_split": tiled_split}
            print(f"[time] bf16 B={B:<3} k={k:<3} device ms "
                  + ", ".join(f"{r} {devt[r]!r}" for r in CROSSOVER_ROUTES)
                  + "; event ms "
                  + ", ".join(f"{r} {ev[r]!r}" for r in CROSSOVER_ROUTES)
                  + f"; tiled split {tiled_split}; plan {plan}, fastest "
                  f"{fastest}")
    g = GRID_TOPK_SHAPE
    Q = rng.normal(size=(g["B"], RANK)).astype(np.float32)
    Yf = rng.normal(size=(M_ITEMS, RANK)).astype(np.float32)
    cols = np.stack([rng.permutation(M_ITEMS)[:g["L"]]
                     for _ in range(g["B"])], axis=1).astype(np.int32)
    Qt, Yt, ct = (torch.from_numpy(a).to(dev) for a in (Q, Yf, cols))
    mt = torch.ones((g["L"], g["B"]), device=dev)
    answers, grid = {}, {}
    for route in ("tiled", "bitonic"):
        def call(route=route):
            return als_cuda._launch(Qt, Yt, ct, mt, k=g["k"], n_items=M_ITEMS,
                                    mask_seen=True, row_valid=None,
                                    route=route)
        t = time.perf_counter()
        answers[route] = call()
        dev_ms, split, ev_ms = route_times(call)
        if route == "tiled":
            tiled_s += time.perf_counter() - t
        grid[route] = {"device_ms": dev_ms, "event_ms": ev_ms,
                       "split": split}
    routes_equal(answers, "grid_topk's shape")
    out["grid"] = grid
    print(f"[time] grid_topk's shape (fp32, B={g['B']}, k={g['k']}, "
          f"L={g['L']}): " + "; ".join(
              f"{r} device {v['device_ms']!r} ms, event {v['event_ms']!r} "
              f"ms, split {v['split']}" for r, v in grid.items()))
    disagree = {key: (r["plan"], r["fastest"])
                for key, r in out["by_batch"].items()
                if r["plan"] != r["fastest"]}
    print(f"[time] the tiled route's device time is at most the chunked "
          f"route's from B = {out['first_tiled']} on (the plan: chunked "
          f"below CHUNKED_MAX_B = {als_cuda.CHUNKED_MAX_B}, tiled from "
          f"it); (plan, fastest) where they differ: {disagree}; the three "
          f"routes equal in {2 * len(CROSSOVER_BATCHES)} cases and two at "
          f"grid_topk's shape")
    print(f"[phase] 4c of it, the tiled column: {tiled_s:.1f} s")
    out["tiled_s"] = tiled_s
    return out


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


def training_timings(dev, trained: dict, seed: int) -> dict:
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    model, pd = trained["model"], trained["pd"]
    eye = torch.eye(RANK, device=dev)
    out = {"assemble_normal_equations": [], "spd_solve": []}
    # the plain versions and library calls at the sharded trainer's block
    # shapes (phase 8c): each bucket padded to a multiple of
    # 8 * TRAIN_SHARDS rows, one block a shard, timed for each block that
    # holds a real row
    sharded = {"assemble_normal_equations": 0.0, "spd_solve": 0.0,
               "plain": {"assemble_normal_equations": 0.0,
                         "spd_solve": 0.0}, "blocks": 0}
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
            A, b = kernel()
            for lo, hi in shard_blocks(bucket, side.n_rows):
                aw_s, Y_s = (padded_rows(t, lo, hi) for t in (awYg, Yg))
                A_s, b_s = padded_rows(A, lo, hi, eye), padded_rows(b, lo, hi)
                blk = [padded_rows(t, lo, hi) for t in (cols, aw, bw)]
                sharded["assemble_normal_equations"] += time_ms(
                    lambda: torch.bmm(aw_s, Y_s), 3)
                sharded["spd_solve"] += time_ms(
                    lambda: torch.cholesky_solve(
                        b_s[:, :, None], torch.linalg.cholesky_ex(A_s)[0]), 3)
                sharded["plain"]["assemble_normal_equations"] += time_ms(
                    lambda: als_cuda.assemble_normal_equations_plain(
                        Y, *blk, gram), 1)
                sharded["plain"]["spd_solve"] += time_ms(
                    lambda: als_cuda.spd_solve_plain(A_s, b_s), 1)
                sharded["blocks"] += 1
            del Yg, awYg, A, b, aw_s, Y_s, A_s, b_s, blk
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
    print(f"[time] at the sharded trainer's block shapes ({TRAIN_SHARDS} "
          f"shards, {sharded['blocks']} blocks with a real row, one "
          f"iteration): library bmm {sharded['assemble_normal_equations']!r}"
          f" ms, cholesky_ex + cholesky_solve {sharded['spd_solve']!r} ms; "
          f"plain assembly {sharded['plain']['assemble_normal_equations']!r}"
          f" ms, plain solve {sharded['plain']['spd_solve']!r} ms")
    return {"rows": out, "heads": heads, "sharded_library": sharded,
            "large": large_rank_timings(dev),
            "large_iteration": large_rank_iteration(dev, trained, seed),
            "foldin": foldin_timings(dev, trained),
            "bf16": bf16_assembly_timings(dev, trained)}


# phase 4b's rank-256 iteration at ML-20M width: its rank, the
# iterations timed, and the rows of the bucket held against plain
LARGE_ITER_RANK = 256
LARGE_ITER_TIMED = 3
LARGE_ITER_ROWS = 256


def large_rank_iteration(dev, trained: dict, seed: int) -> dict:
    """One ALS iteration at rank 256 on phase 5's tables (ML-20M width,
    both sides' buckets on the card): random factors from ``seed``, one
    iteration warm, then LARGE_ITER_TIMED event-timed, the last also
    under the profiler for the B3 / B2 split. Every launch must take the
    tile-group assembly and the block solve, the factors stay finite,
    and one bucket's A, b and x (the item bucket of the longest rows up
    to 8,192 slots, its first LARGE_ITER_ROWS rows) are held against the
    plain versions: A and b within the reordering bound, x bitwise."""
    import torch

    from predictionio_tpu_torch.ops import als as als_mod
    from predictionio_tpu_torch.ops import als_cuda

    t_all = time.perf_counter()
    pd = trained["pd"]
    R = LARGE_ITER_RANK
    u_t, i_t = bucket_tables(pd.user_side, dev), bucket_tables(pd.item_side,
                                                               dev)
    kw = dict(lam=LAMBDA, alpha=ALPHA, implicit=True, slot_budget=None)
    X, Y = als_mod.init_factors(pd.user_side.n_rows, pd.item_side.n_rows,
                                R, seed + 7, dev)
    als_cuda.assemble_launches.reset()
    als_cuda.spd_launches.reset()
    t0 = time.perf_counter()
    X1, Y1 = als_mod.als_iterations_bucketed(X, Y, u_t, i_t,
                                             num_iterations=1, **kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    events = []

    def timed_iteration():
        nonlocal X1, Y1
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        X1, Y1 = als_mod.als_iterations_bucketed(X1, Y1, u_t, i_t,
                                                 num_iterations=1, **kw)
        ev[1].record()
        events.append(ev)

    for _ in range(LARGE_ITER_TIMED - 1):
        timed_iteration()
    # the last one under the profiler as well, for the B3 / B2 split
    wall, busy, _, ms = device_busy(timed_iteration)
    iteration_ms = [a.elapsed_time(b) for a, b in events]
    split = iteration_split(ms)
    n_buckets = len(u_t) + len(i_t)
    by_route = {"assemble_normal_equations": als_cuda.assemble_launches.by_key(),
                "spd_solve": als_cuda.spd_launches.by_key()}
    want = {"assemble_normal_equations": {("tile_groups", "fp32"):
                                          (LARGE_ITER_TIMED + 1) * n_buckets},
            "spd_solve": {"block": (LARGE_ITER_TIMED + 1) * n_buckets}}
    if by_route != want:
        raise AssertionError(f"rank-{R} iteration: launches by route "
                             f"{by_route}, want {want}")
    if not (torch.isfinite(X1).all() and torch.isfinite(Y1).all()):
        raise AssertionError(f"non-finite factors at rank {R}")
    # one bucket held against the plain versions, on a slice of its rows
    bucket = max((b for b in pd.item_side.buckets
                  if b.cols.shape[1] <= 8192), key=lambda b: b.cols.shape[1])
    n = min(LARGE_ITER_ROWS, bucket.cols.shape[0])
    L = bucket.cols.shape[1]
    cols = torch.as_tensor(bucket.cols[:n], device=dev)
    aw, bw = assembly_weights(bucket, False, dev)
    aw, bw = aw[:n].contiguous(), bw[:n].contiguous()
    gram = X1.T @ X1 + LAMBDA * torch.eye(R, device=dev)
    err = check_assembly(X1, cols, aw, bw, gram, False,
                         f"rank {R} item bucket L={L} rows 0-{n}")
    A, b = als_cuda.assemble_normal_equations(X1, cols, aw, bw, gram)
    (_, route, res, _, _), = solve_checks(
        dev, [(f"rank {R} item bucket L={L}", (A, b))])
    out = {"R": R, "warm_s": warm_s, "iteration_ms": iteration_ms,
           "profiled": {"wall_ms": wall, "busy_ms": busy, **split},
           "launches": {name: {"/".join(k) if isinstance(k, tuple) else k: v
                               for k, v in d.items()}
                        for name, d in by_route.items()},
           "checked": {"bucket_L": L, "rows": n, "assemble_max_abs_err": err,
                       "solve_route": route, "solve_residual": res}}
    print(f"[large-iteration] rank {R} at ML-20M width on phase 5's tables "
          f"({n_buckets} buckets): warm {warm_s!r} s, event-timed ms "
          f"{iteration_ms}; profiled wall {wall!r} ms, busy {busy!r} ms, "
          f"B3 {split['B3']!r} ms, B2 {split['B2']!r} ms; launches "
          f"{out['launches']}; item bucket L={L} rows 0-{n}: A, b within "
          f"the reordering bound (max |err| {err!r}), x bitwise plain "
          f"({route}, residual {res:.3g})")
    del u_t, i_t, X, Y, X1, Y1, A, b, cols, aw, bw, gram
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_all
    return out


def shard_blocks(bucket, n_rows: int) -> list:
    """``(lo, hi)`` row spans of the sharded trainer's blocks of one
    bucket that hold a real row: the bucket padded with sentinel rows to
    a multiple of ``8 * TRAIN_SHARDS``, one block a shard (``hi`` may
    pass the bucket's rows: the sentinel padding)."""
    real = np.asarray(bucket.row_ids) < n_rows
    step = (len(real) + (-len(real)) % (8 * TRAIN_SHARDS)) // TRAIN_SHARDS
    return [(lo, lo + step) for lo in range(0, step * TRAIN_SHARDS, step)
            if real[lo:lo + step].any()]


def padded_rows(t, lo: int, hi: int, fill=None):
    """Rows ``lo:hi`` of ``t`` along its first axis, rows past its end
    zeros (or ``fill``, repeated): a shard block's shape."""
    import torch

    part = t[lo:hi]
    short = (hi - lo) - part.shape[0]
    if short <= 0:
        return part
    pad = (fill.expand(short, *fill.shape) if fill is not None
           else part.new_zeros((short,) + tuple(t.shape[1:])))
    return torch.cat([part, pad])


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


# phase 4b's large-rank shapes: both routes at these ranks, B3 on
# LARGE_TIMED_ROWS rows of LARGE_TIMED_SLOTS slots, B2 on
# LARGE_TIMED_SYSTEMS systems, and B2 above the block route's shared
# memory (R = 384, the device-memory route)
LARGE_TIMED_RANKS = (256, 320)
LARGE_TIMED_DEVICE_RANK = 384
LARGE_TIMED_ROWS, LARGE_TIMED_SLOTS, LARGE_TIMED_SYSTEMS = 4096, 128, 4096


def large_rank_timings(dev) -> dict:
    """The large-rank routes at their shapes: the block solve at ranks
    256 and 320 and its device-memory route at 384 (4,096 systems each),
    and the tile-group assembly at ranks 256 and 320 (4,096 synthetic
    rows of 128 slots), each with its plain version, one library call
    (``cholesky`` + ``cholesky_solve``; ``bmm`` over the weighted
    gather) and its bound. Returns {"spd_solve": [...],
    "assemble_normal_equations": [...]}, a row per rank."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda

    out = {"spd_solve": [], "assemble_normal_equations": []}
    B = LARGE_TIMED_SYSTEMS
    for R in LARGE_TIMED_RANKS + (LARGE_TIMED_DEVICE_RANK,):
        t0 = time.perf_counter()
        A, b = spd_systems(dev, B, R)
        t_k = time_ms(lambda: als_cuda.spd_solve(A, b), 3)
        # the plain version, one call (R launches of [B, R, R] updates,
        # 0.2-0.8 s a call)
        t_p = time_ms(lambda: als_cuda.spd_solve_plain(A, b), 1, warmups=0)
        t_l = time_ms(lambda: torch.cholesky_solve(
            b[:, :, None], torch.linalg.cholesky(A)), 3)
        b_ms, b_by = bound_of(*solve_work(B, R))
        route = solve_plan_of(dev, R).route
        out["spd_solve"].append({
            "route": route, "R": R, "B": B, "ms": t_k, "plain_ms": t_p,
            "library_ms": t_l, "bound_ms": b_ms, "bound_by": b_by,
            "s": time.perf_counter() - t0})
        print(f"[time] spd_solve {route} route R={R} B={B}: kernel {t_k!r} "
              f"ms  plain {t_p!r} ms  library {t_l!r} ms  bound {b_ms!r} ms "
              f"({b_by})")
        del A, b
        torch.cuda.empty_cache()

    B, L = LARGE_TIMED_ROWS, LARGE_TIMED_SLOTS
    for R in LARGE_TIMED_RANKS:
        t0 = time.perf_counter()
        rng = np.random.default_rng(R)
        Y = torch.from_numpy(0.3 * rng.standard_normal(
            (M_ITEMS, R)).astype(np.float32)).to(dev)
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
        out["assemble_normal_equations"].append({
            "route": "tile_groups", "R": R, "B": B, "L": L, "slots": nnz,
            "ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
            "bound_by": b_by, "s": time.perf_counter() - t0})
        print(f"[time] assemble tile-group route R={R} B={B} L={L}: kernel "
              f"{t_k!r} ms  plain {t_p!r} ms  library {t_l!r} ms  bound "
              f"{b_ms!r} ms ({b_by})")
        del Y, gram, cols, aw, bw, Yg, awYg
        torch.cuda.empty_cache()
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


def ingest_times(seed: int, rounds: int) -> dict:
    """Phase 6b's event-server ingest alone (``pio app new``, then per
    run a ``pio eventserver`` child over one sqlite store taking the
    batch and single posts), ``rounds`` times with ``PIO_RESILIENCE=1``
    and ``=0`` in turns; events/s and batch request p50 of each run. With
    a copy of this script at another checkout's root, times that
    checkout's event server (where it reads no ``PIO_RESILIENCE``, both
    runs of a round are the same code)."""
    import os
    import re
    import tempfile

    work = tempfile.mkdtemp(prefix="pio-ingest-")
    env = console_env(os.path.join(work, "pio.db"))
    runs = {"1": [], "0": []}
    try:
        said, _ = pio(["app", "new", QS_APP], env, work)
        key = re.search(r"Access Key: (\S+)", said).group(1)
        batch_events, singles = qs_front_door_events(seed,
                                                     ml1m_ratings(seed))
        for _ in range(rounds):
            for flag in ("1", "0"):
                es, base, _ = pio_child(
                    ["eventserver", "--ip", "127.0.0.1", "--port", "0"],
                    dict(env, PIO_RESILIENCE=flag), work,
                    "Event Server is ready at")
                try:
                    e = qs_event_server(base, key, batch_events, singles)
                finally:
                    es.terminate()
                    es.wait(timeout=60)
                runs[flag].append((e["batch_events_per_s"],
                                   e["batch_p50_ms"]))
                print(f"[ingest] PIO_RESILIENCE={flag}: "
                      f"{e['batch_events_per_s']!r} events/s, batch "
                      f"request p50 {e['batch_p50_ms']!r} ms")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return runs


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


class KillResume:
    """Phase 6b's crash trio, started at the end of 6b and run beside 6c
    and 6d (it waits on its processes): ``pio train --precision bf16
    --checkpoint-dir D --checkpoint-every 1`` with each save held
    ``KILL_SAVE_DELAY_S`` (``PIO_FAULTS`` slow), killed with SIGKILL once
    its second checkpoint lands, then the same with ``--resume``, beside
    an uninterrupted ``pio train --precision bf16`` of the same store and
    variant. :meth:`result` waits for them: the resumed instance's
    factors must be bitwise equal to the reference's, and ``pio runs
    list`` / ``show`` must print one run whose steps rise to
    ``ITERATIONS``; then it removes 6b's store, which it holds from 6b's
    end (6c reads it meanwhile). :meth:`stop` kills what still runs and
    removes the store."""

    def __init__(self, work: str, store: str, eng: str, env: dict):
        import os

        self.work, self.store, self.eng, self.env = work, store, eng, env
        self.ck = os.path.join(work, "ckpt")
        self.opts = ["--precision", "bf16", "--checkpoint-dir", self.ck,
                     "--checkpoint-every", "1"]
        self.steps: dict = {}
        self.children: list = []
        self.resumed = self.error = None
        self.t0 = time.perf_counter()
        self.reference = self._start(["train", "--precision", "bf16"])
        self.thread = threading.Thread(target=self._pair, daemon=True,
                                       name="chip-smoke-kill-resume")
        self.thread.start()

    def _start(self, args: list, stdout=subprocess.PIPE,
               **env) -> "subprocess.Popen":
        child = subprocess.Popen(
            CONSOLE + args, cwd=self.eng, stdout=stdout,
            stderr=subprocess.PIPE, text=True, env=dict(self.env, **env))
        self.children.append(child)
        return child

    def _pair(self) -> None:
        import os
        import signal

        try:
            t = time.perf_counter()
            child = self._start(["train"] + self.opts,
                                stdout=subprocess.DEVNULL, PIO_FAULTS=(
                                    f"backend=checkpoint,op=save,kind=slow,"
                                    f"delay={KILL_SAVE_DELAY_S}"))
            second = os.path.join(self.ck, "ckpt-00000002.json")
            while not os.path.exists(second):
                if child.poll() is not None or time.perf_counter() - t > 300:
                    raise AssertionError(
                        f"the checkpointed train ended ({child.poll()}) "
                        f"before its second checkpoint: "
                        f"{child.stderr.read()}")
                time.sleep(0.02)
            if child.poll() is not None:
                raise AssertionError("the checkpointed train ended before "
                                     "its kill")
            child.send_signal(signal.SIGKILL)
            child.wait(timeout=60)
            self.steps["train killed after 2 checkpoints"] = \
                time.perf_counter() - t
            t = time.perf_counter()
            resume = self._start(["train"] + self.opts + ["--resume"])
            said, err = resume.communicate(timeout=600)
            if resume.returncode != 0:
                raise AssertionError(f"pio train --resume exited "
                                     f"{resume.returncode}: {err[-2000:]}")
            self.steps["train --resume"] = time.perf_counter() - t
            self.resumed = said
        except BaseException as e:  # re-raised by result()
            self.error = e

    def result(self) -> dict:
        import re

        from predictionio_tpu_torch.data import storage
        from predictionio_tpu_torch.workflow import runlog

        t = time.perf_counter()
        try:
            self.thread.join(timeout=900)
            if self.thread.is_alive():
                raise AssertionError("the killed / resumed pair did not end")
            if self.error is not None:
                raise self.error
            ref_said, ref_err = self.reference.communicate(timeout=600)
            self.steps["train bf16"] = time.perf_counter() - self.t0
            if self.reference.returncode != 0:
                raise AssertionError(
                    f"pio train --precision bf16 exited "
                    f"{self.reference.returncode}: {ref_err[-2000:]}")
            waited = time.perf_counter() - t
            storage.reset(storage.StorageConfig(
                {"QS": {"type": "sqlite", "path": self.store}},
                {r: "QS" for r in storage.REPOSITORIES}))
            try:
                got, ref = (instance_factors(re.search(
                    r"Engine instance ID: (\S+)", said).group(1))
                    for said in (self.resumed, ref_said))
            finally:
                storage.reset()
            if not (np.array_equal(got[0], ref[0])
                    and np.array_equal(got[1], ref[1])):
                raise AssertionError("the resumed instance's factors differ "
                                     "from the uninterrupted bf16 "
                                     "training's")
            listed, _ = pio(["runs", "list", "--dir", self.ck], self.env,
                            self.work)
            runs = runlog.list_runs(self.ck)
            if len(runs) != 1 or runs[0]["runId"] not in listed:
                raise AssertionError(f"pio runs list: {listed!r}")
            shown, _ = pio(["runs", "show", runs[0]["runId"], "--dir",
                            self.ck], self.env, self.work)
            # monotone, ending at the last iteration: the kill may land
            # between a checkpoint's manifest and its run-log sample, so a
            # step the killed child checkpointed can lack its sample
            table = [int(line.split()[0]) for line in shown.splitlines()
                     if re.match(r"\s+\d+\s+[-0-9.e+]+\s", line)]
            if not table or table != sorted(set(table)) \
                    or table[-1] != ITERATIONS:
                raise AssertionError(f"pio runs show: steps {table}: "
                                     f"{shown!r}")
            print(f"[quickstart] pio train --precision bf16 "
                  f"--checkpoint-every 1 killed (SIGKILL) after its 2nd "
                  f"checkpoint, resumed with --resume: factors bitwise equal "
                  f"to an uninterrupted bf16 training; pio runs list / show: "
                  f"one run {runs[0]['runId']}, steps {table}; step seconds "
                  + ", ".join(f"{k} {v!r}" for k, v in self.steps.items())
                  + f" (the reference beside the pair, all three beside 6c "
                  f"and 6d, which waited {waited!r} s more for them)")
            return {"run": runs[0]["runId"], "steps": table,
                    "step_s": dict(self.steps), "waited_s": waited}
        finally:
            self.stop()

    def stop(self) -> None:
        for child in self.children:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=60)
        self.thread.join(timeout=60)
        shutil.rmtree(self.work, ignore_errors=True)


QS_PROFILE_QUERIES = 20   # user queries inside the /profile window
QS_FEEDBACK = 24          # queries to the feedback deploy
QS_BP_CHUNK = 16          # pio batchpredict's chunk size in phase 6b


def qs_profile_window(base: str, queries: list) -> dict:
    """``POST /profile/start``, ``queries`` (known users), ``/profile/stop``
    twice (200, 200, 409), then the written ``trace.json``: B1's kernel
    events in it, which host threads launched them (the runtime calls
    that share their correlation ids), and the dispatches the flight
    recorder counted in the window. The trace must hold at least one
    ``score_tile_kernel`` event (one per B1 launch) per dispatch."""
    import collections
    import os

    before = get_json(base + "/dispatches.json?limit=0")["recorded"]
    codes = [post_status(base + "/profile/start")]
    for q in queries:
        status, _, _ = post(base + "/queries.json", q)
        if status != 200:
            raise AssertionError(f"{q} answered {status} in the window")
    status, stopped, _ = post(base + "/profile/stop", {})
    codes += [status, post_status(base + "/profile/stop")]
    if codes != [200, 200, 409]:
        raise AssertionError(f"/profile/start, stop, stop answered {codes}")
    dispatched = get_json(base + "/dispatches.json?limit=0")["recorded"] \
        - before
    with open(os.path.join(stopped["profileDir"], "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = b1_kernel_names()
    kernels = [e for e in events if e.get("cat") == "kernel"
               and kernel_name(e.get("name", "")) in names]
    by_name = collections.Counter(kernel_name(e["name"]) for e in kernels)
    wanted = {(e.get("args") or {}).get("correlation") for e in kernels}
    threads = collections.Counter(
        e.get("tid") for e in events if e.get("cat") == "cuda_runtime"
        and (e.get("args") or {}).get("correlation") in wanted)
    print(f"[quickstart] /profile window: {len(queries)} queries, "
          f"{dispatched} dispatches; trace.json holds {len(kernels)} B1 "
          f"kernel events {dict(by_name)}, launched from host threads "
          f"{dict(threads)}")
    if by_name["score_tile_kernel"] < dispatched or not dispatched:
        raise AssertionError(
            f"the /profile capture holds {by_name['score_tile_kernel']} "
            f"score_tile_kernel events for {dispatched} dispatches")
    return {"codes": codes, "dispatches": dispatched,
            "b1_events": dict(by_name), "threads": len(threads)}


def qs_feedback_and_top(work: str, eng: str, env: dict, key: str,
                        queries: list, steps: dict, card: str) -> dict:
    """``pio-torch deploy --feedback --accesskey K`` against a ``pio
    eventserver`` child on the quick start's store: ``QS_FEEDBACK``
    queries, then (a bounded drain) the store must hold one ``predict``
    event of entity type ``pio_pr`` per query, and no answer carries a
    ``prId`` (the template's prediction has none); then ``pio-torch top
    --once`` against the deploy: its store line names the precision,
    users, items and bytes, and its lane lines count B1 dispatches."""
    import re

    from predictionio_tpu_torch.data import storage

    children = []
    try:
        es, es_base, _ = pio_child(["eventserver", "--ip", "127.0.0.1",
                                    "--port", "0"], env, work,
                                   "Event Server is ready at")
        children.append(es)
        dep, base, steps["deploy --feedback ready"] = pio_child(
            # "--accesskey=K": a key may begin with "-" (URL-safe base64)
            ["deploy", "--ip", "127.0.0.1", "--port", "0", "--feedback",
             f"--accesskey={key}", "--event-server-ip", "127.0.0.1",
             "--event-server-port", es_base.rsplit(":", 1)[1]], env, eng,
            "Engine API is live at")
        children.append(dep)
        sent = queries[:QS_FEEDBACK]
        t = time.perf_counter()
        for q in sent:
            status, body, _ = post(base + "/queries.json", q)
            if status != 200 or "prId" in body:
                raise AssertionError(f"feedback deploy answered {status} "
                                     f"{body} to {q}")
        app = storage.get_metadata_apps().get_by_name(QS_APP)
        stored = []
        while time.perf_counter() - t < 30:
            stored = list(storage.get_levents().find(
                app.id, entity_type="pio_pr", event_names=["predict"]))
            if len(stored) >= len(sent):
                break
            time.sleep(0.1)
        drain = time.perf_counter() - t
        steps["feedback queries and drain"] = drain
        if len(stored) != len(sent):
            raise AssertionError(f"{len(stored)} predict events stored for "
                                 f"{len(sent)} feedback queries")
        said, steps["top --once"] = pio(["top", "--once", "--url", base],
                                        env, work)
        store = [ln for ln in said.splitlines() if ln.startswith("store ")]
        lanes = [ln for ln in said.splitlines() if ln.startswith("lane ")]
        if len(store) != 1 or not re.match(
                r"store    (fp32|bf16|int8)/fused · \d+u × \d+i · "
                r"[0-9.]+[KMG]iB", 
                store[0]) or not lanes or any(
                int(ln.split()[2]) <= 0 for ln in lanes):
            raise AssertionError(f"pio top --once printed {said!r}")
        port = base.rsplit(":", 1)[1]
        pio(["undeploy", "--ip", "127.0.0.1", "--port", port], env, eng)
        tail = dep.stdout.read()
        if dep.wait(timeout=60) != 0:
            raise AssertionError(f"the feedback deploy exited "
                                 f"{dep.returncode}")
        print(f"[quickstart] pio deploy --feedback: {len(sent)} queries, "
              f"{len(stored)} predict events (pio_pr) stored within "
              f"{drain!r} s of the first; launches "
              f"{launches_line(tail)}; pio top --once: {store[0]!r}, "
              f"{lanes!r} ({card})")
        return {"events": len(stored), "drain_s": drain, "top": said}
    finally:
        for child in children:
            if child.poll() is None:
                child.terminate()
                child.wait(timeout=60)


QS_FLEET = 2              # replicas of 6b's `pio deploy --fleet` child
QS_FLEET_NEW = 5          # the new user's ratings, through the event server


def qs_fleet(work: str, eng: str, env: dict, key: str, queries: list,
             want_answers: list, steps: dict, card: str) -> dict:
    """``pio-torch deploy --fleet 2 --foldin on`` over the quick start's
    store, beside a ``pio eventserver`` child: phase 6's queries through
    the balancer equal the instance's in-process answers; a new user's
    ratings, posted through the event server, are servable through the
    balancer within ``FOLDIN_DEADLINE`` seconds (every replica folds
    them; the user's ring owner answers); ``pio undeploy`` stops the
    balancer and both replicas (none answers after) and the child exits
    with its launches."""
    children = []
    fenv = dict(env, PIO_FOLDIN_INTERVAL=str(FOLDIN_INTERVAL))
    try:
        es, es_base, _ = pio_child(["eventserver", "--ip", "127.0.0.1",
                                    "--port", "0"], env, work,
                                   "Event Server is ready at")
        children.append(es)
        dep, base, ready_s = pio_child(
            ["deploy", "--ip", "127.0.0.1", "--port", "0", "--fleet",
             str(QS_FLEET), "--foldin", "on"], fenv, eng,
            "Engine API is live at")
        children.append(dep)
        steps["deploy --fleet ready"] = ready_s
        fleet = get_json(base + "/stats.json")["fleet"]
        replicas = [r["address"] for r in fleet["replicas"]]
        if fleet["readyReplicas"] != QS_FLEET or None in replicas:
            raise AssertionError(f"the fleet child's /stats.json: {fleet}")
        got = [post(base + "/queries.json", q) for q in queries]
        bad = [(q, g[:2]) for q, g, w in zip(queries, got, want_answers)
               if g[0] != 200 or g[1] != w]
        if bad:
            raise AssertionError(f"{len(bad)} answers of the fleet differ "
                                 f"from the instance's in-process answers: "
                                 f"{bad[:3]}")
        user = "fleet-new-user"
        rated = [f"i{i}" for i in range(1, QS_FLEET_NEW + 1)]
        t0 = time.perf_counter()
        status, items, _ = post(
            f"{es_base}/batch/events.json?accessKey={key}",
            [{"event": "rate", "entityType": "user", "entityId": user,
              "targetEntityType": "item", "targetEntityId": it,
              "properties": {"rating": 5.0}} for it in rated])
        if status != 200 or any(x.get("status") != 201 for x in items):
            raise AssertionError(f"the new user's events: {status} {items}")
        body = {}
        while time.perf_counter() - t0 < FOLDIN_DEADLINE:
            status, body, _ = post(base + "/queries.json",
                                   {"user": user, "num": 10})
            if status == 200 and body["itemScores"]:
                break
            time.sleep(0.1)
        servable_s = time.perf_counter() - t0
        if not body.get("itemScores") or any(
                s["item"] in rated for s in body["itemScores"]):
            raise AssertionError(f"the new user after {servable_s} s: "
                                 f"{body}")
        steps["fleet: new user servable"] = servable_s
        port = base.rsplit(":", 1)[1]
        _, steps["undeploy --fleet"] = pio(
            ["undeploy", "--ip", "127.0.0.1", "--port", port], env, eng)
        tail = dep.stdout.read()
        if dep.wait(timeout=60) != 0:
            raise AssertionError(f"the fleet deploy exited {dep.returncode}")
        launched = launches_line(tail)
        for url in [base] + [f"http://{a}" for a in replicas]:
            try:
                urllib.request.urlopen(url + "/", timeout=5)
            except urllib.error.URLError:
                continue
            raise AssertionError(f"{url} still answers after undeploy")
        if not all(launched.get(name) for name in (
                "fused_gather_score_topk", "assemble_normal_equations",
                "spd_solve")):
            raise AssertionError(f"the fleet deploy launched {launched}")
        print(f"[quickstart] pio deploy --fleet {QS_FLEET} --foldin on ready "
              f"in {ready_s!r} s; {len(got)} answers through the balancer "
              f"equal the instance's in-process answers; a new user's "
              f"{QS_FLEET_NEW} ratings posted through the event server "
              f"servable through the balancer in {servable_s!r} s; "
              f"undeployed (balancer and replicas {replicas} answer "
              f"nothing); launches {launched} ({card})")
        return {"ready_s": ready_s, "servable_s": servable_s,
                "launches": launched}
    finally:
        for child in children:
            if child.poll() is None:
                child.terminate()
                child.wait(timeout=60)


def qs_batchpredict(work: str, eng: str, env: dict, iid: str, model,
                    steps: dict, card: str) -> dict:
    """``pio-torch batchpredict`` over every quick-start user (the events
    give no ``$set`` user entities, so ``--input`` holds the queries),
    chunks of ``QS_BP_CHUNK``: a clean run, and beside it a second run
    killed with SIGKILL once its journal holds a finished chunk, then
    rerun: the rerun skips at least one chunk and its results, shard for
    shard, equal the clean run's."""
    import os
    import re
    import signal

    from predictionio_tpu_torch.batch import predict as bp_mod

    qfile = os.path.join(work, "bp_queries.jsonl")
    with open(qfile, "w") as f:
        f.writelines(json.dumps({"user": u, "num": 10}) + "\n"
                     for u in model.user_map.labels)
    args = ["batchpredict", "--engine-instance-id", iid, "--input", qfile,
            "--chunk-size", str(QS_BP_CHUNK)]
    clean, killed = (os.path.join(work, d) for d in ("bp_clean", "bp_kill"))
    # the clean run beside the killed one and its rerun
    t_clean = time.perf_counter()
    clean_run = subprocess.Popen(
        CONSOLE + args + ["--output", clean], cwd=eng, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        journal = os.path.join(killed, bp_mod.JOURNAL_NAME)
        t = time.perf_counter()
        child = subprocess.Popen(CONSOLE + args + ["--output", killed],
                                 cwd=eng, env=env, stdout=subprocess.DEVNULL,
                                 stderr=subprocess.PIPE, text=True)
        try:
            while not (os.path.exists(journal) and os.path.getsize(journal)):
                if child.poll() is not None or time.perf_counter() - t > 300:
                    break
                time.sleep(0.002)
            mid_run = child.poll() is None
            child.send_signal(signal.SIGKILL)
            child.wait(timeout=60)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=60)
        steps["batchpredict killed"] = time.perf_counter() - t
        said, steps["batchpredict rerun"] = pio(args + ["--output", killed],
                                                env, eng)
        clean_said, clean_err = clean_run.communicate(timeout=600)
    finally:
        if clean_run.poll() is None:
            clean_run.kill()
            clean_run.wait(timeout=60)
    steps["batchpredict"] = time.perf_counter() - t_clean
    if clean_run.returncode != 0:
        raise AssertionError(f"pio batchpredict exited "
                             f"{clean_run.returncode}: {clean_err[-2000:]}")
    launched = launches_line(clean_said)
    if not launched["fused_gather_score_topk"]:
        raise AssertionError(f"pio batchpredict launched {launched}")
    found = re.search(r"\((\d+) scored, (\d+) resumed\)", said)
    scored, resumed = int(found.group(1)), int(found.group(2))
    if resumed < 1:
        raise AssertionError(f"the rerun resumed no chunk: {said!r}")
    manifest = bp_mod.Manifest.load(os.path.join(clean,
                                                 bp_mod.MANIFEST_NAME))
    for c in manifest.chunks:
        with open(os.path.join(clean, c["file"]), "rb") as a, \
                open(os.path.join(killed, c["file"]), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{c['file']} of the rerun differs")
    if bp_mod.read_results(killed) != bp_mod.read_results(clean):
        raise AssertionError("the rerun's results differ")
    print(f"[quickstart] pio batchpredict: {len(model.user_map)} queries in "
          f"{len(manifest.chunks)} chunks, {steps['batchpredict']!r} s "
          f"(the process), launches {launched}; killed (SIGKILL) "
          f"{'mid-run' if mid_run else 'after its end'}, rerun: {scored} "
          f"scored, {resumed} resumed, every shard equal to the clean "
          f"run's ({card})")
    return {"chunks": len(manifest.chunks), "launches": launched,
            "scored": scored, "resumed": resumed, "mid_run": mid_run,
            "s": steps["batchpredict"]}


def quick_start(seed: int, cycle: dict, card: str,
                keep_store: bool = False) -> dict:
    """Phase 6b: PredictionIO's quick start through the port's console,
    each verb a subprocess, at phase 6's size, events and variant. The
    short verbs run beside the writing of the import file, and ``pio
    export`` (the store takes no more writes after the event server)
    beside the deployment's checks; every step's seconds are printed.
    The crash trio (:class:`KillResume`, ``out["resume"]``) starts last
    and holds the directory and store until its ``result`` or ``stop``
    removes them; with ``keep_store`` phase 6c reads the store meanwhile
    (``out["kept"]``)."""
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

        # the store takes no more events: export it beside train and
        # deploy
        exported = os.path.join(work, "export.jsonl")
        t_export = time.perf_counter()
        export = subprocess.Popen(
            CONSOLE + ["export", "--app-name", QS_APP, "--output", exported],
            env=env, cwd=work, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        children.append(export)
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
        profiled = qs_profile_window(base, queries[:QS_PROFILE_QUERIES])
        codes = profiled["codes"]
        steps["profile start, queries, stop, stop"] = time.perf_counter() - t
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
                         "timed_records": len(timed), "launches": served,
                         "profile": profiled}
        print(f"[quickstart] pio deploy ready in {deploy_s!r} s; "
              f"{len(got)} answers equal the instance's in-process "
              f"answers; {len(timed)} flight records with CUDA-event "
              f"time; /profile/start, {QS_PROFILE_QUERIES} queries, stop, "
              f"stop: {codes}; undeployed; launches {served} ({card})")

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
              f"written) in {export_s!r} s, beside pio train, the "
              f"deployment's checks and undeploy")

        # pio batchpredict (its clean run, and the killed run and its
        # rerun) reads only the instance: it runs beside the feedback and
        # fleet deploys, and the seconds the overlap hides are printed
        t = time.perf_counter()
        with ThreadPoolExecutor(1) as pool:
            batch = pool.submit(qs_batchpredict, work, eng, env, iid, model,
                                steps, card)
            out["feedback"] = qs_feedback_and_top(work, eng, env, key,
                                                  queries, steps, card)
            out["fleet"] = qs_fleet(work, eng, env, key, queries,
                                    want_answers, steps, card)
            deploys_s = time.perf_counter() - t
            out["batchpredict"] = batch.result()
        wall_s = time.perf_counter() - t
        out["overlap"] = {
            "deploys_s": deploys_s, "batchpredict_s": steps["batchpredict"],
            "wall_s": wall_s,
            "hidden_s": deploys_s + steps["batchpredict"] - wall_s}
        print(f"[quickstart] the feedback and fleet deploys {deploys_s!r} s "
              f"beside pio batchpredict {steps['batchpredict']!r} s: "
              f"{wall_s!r} s of wall, {out['overlap']['hidden_s']!r} s "
              f"hidden")
        print("[quickstart] step seconds: " + ", ".join(
            f"{k} {v!r}" for k, v in steps.items()) + "; the short verbs "
            "ran beside the ratings draw and JSONL write, export beside "
            "train, the deployed queries, profile, undeploy and deploy "
            "exit, pio batchpredict beside the feedback and fleet deploys; "
            "the crash trio follows, beside 6c and 6d")
        out["resume"] = KillResume(work, store, eng, env)
        if keep_store:
            out["kept"] = {"work": work, "store": store, "env": env}
        return out
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=60)
        storage.reset()
        if "resume" not in out:
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


def console_operator(work: str, env: dict, evaluation_id: str,
                     card: str) -> dict:
    """Phase 6c's operator verbs on the quick start's store, each a
    process: ``pio-torch dashboard`` must list the ``EVALCOMPLETED``
    instance (its index and its JSON results), and ``pio-torch
    adminserver`` creates, lists and deletes an app once."""
    children, took = [], {}
    try:
        dash, dash_base, took["dashboard ready"] = pio_child(
            ["dashboard", "--ip", "127.0.0.1", "--port", "0"], env, work,
            "Dashboard is ready at")
        children.append(dash)
        with urllib.request.urlopen(dash_base + "/", timeout=60) as resp:
            index = resp.read().decode()
        results = get_json(f"{dash_base}/engine_instances/{evaluation_id}/"
                           "evaluator_results.json")
        if evaluation_id not in index or "engineParamsScores" not in results:
            raise AssertionError(f"the dashboard lists {index[:500]!r}")
        adm, adm_base, took["adminserver ready"] = pio_child(
            ["adminserver", "--ip", "127.0.0.1", "--port", "0"], env, work,
            "Admin Server is ready at")
        children.append(adm)
        status, made, _ = post(adm_base + "/cmd/app", {"name": "AdminApp"})
        listed = [a["name"] for a in get_json(adm_base + "/cmd/app")["apps"]]
        req = urllib.request.Request(adm_base + "/cmd/app/AdminApp",
                                     method="DELETE")
        with urllib.request.urlopen(req, timeout=60) as resp:
            deleted = json.loads(resp.read())
        after = [a["name"] for a in get_json(adm_base + "/cmd/app")["apps"]]
        if status != 200 or made["status"] != 1 or len(made["key"]) != 64 \
                or "AdminApp" not in listed or deleted["status"] != 1 \
                or "AdminApp" in after or QS_APP not in after:
            raise AssertionError(f"adminserver: {made}, {listed}, {deleted}, "
                                 f"{after}")
        print(f"[eval] pio dashboard lists the EVALCOMPLETED instance "
              f"{evaluation_id}; pio adminserver created, listed and "
              f"deleted AdminApp (apps before {listed}, after {after}); "
              f"ready in {took} s ({card})")
        return took
    finally:
        for child in children:
            if child.poll() is None:
                child.terminate()
                child.wait(timeout=60)


def eval_routes(n_users: int, n_sets: int, batch: int) -> dict:
    """B1's launches by route for ``n_sets`` top-``GRID_TOPK`` passes
    over ``n_users`` users at ML-1M width, ``batch`` users a launch: the
    routes ``topk_sort_plan`` gives each batch."""
    from predictionio_tpu_torch.ops import als_cuda

    out: dict = {}
    for start in range(0, n_users, batch):
        b = min(batch, n_users - start)
        route = als_cuda.topk_sort_plan(GRID_TOPK, ML1M_ITEMS, b,
                                        1 << 30).route
        out[route] = out.get(route, 0) + n_sets
    return out


def console_eval(seed: int, kept: dict, card: str) -> dict:
    """Phase 6c: ``pio eval`` in both lanes through the console at ML-1M,
    on phase 6b's store (6b's crash trio, running beside, removes it
    after). (1) A ``pio-torch eval
    --grid`` child (``EVAL_GRID_RANKS x EVAL_GRID_LAMBDAS``,
    ``GRID_ITERATIONS`` iterations) exits 0 and writes the leaderboard;
    its winner carries full ``engineParams``; it must launch B3's
    config-axis route, B2 and B1. (2) A ``pio-torch eval
    chip_smoke:ml1m_evaluation`` child, run beside the first, exits 0,
    writes ``best.json`` and stores an ``EVALCOMPLETED`` evaluation
    instance, having launched B1
    (the batched route: one launch per param set for every held-out
    user). Each param set's Precision@10 must equal the one scored in
    this process on the same trained factors by the same pipeline with
    B1 and with B1's plain version."""
    import os

    from predictionio_tpu_torch.data import storage

    work, store, env = kept["work"], kept["store"], kept["env"]
    out: dict = {}
    evaluation = None
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
        # the Evaluation lane's child runs beside the grid's
        t_eval = time.perf_counter()
        evaluation = subprocess.Popen(
            CONSOLE + ["eval", "chip_smoke:ml1m_evaluation"], env=env,
            cwd=work, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
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
        # grid_topk: one B1 launch per config per 512 held-out users
        want = eval_routes(board["nTestUsers"], len(board["rows"]), 512)
        if launched["fused_gather_score_topk_routes"] != want:
            raise AssertionError(f"pio eval --grid's B1 launches by route "
                                 f"{launched['fused_gather_score_topk_routes']}"
                                 f", want {want}")
        out["grid"] = {"s": grid_s, "launches": launched,
                       "winner": winner["params"],
                       "metric": winner["metric"],
                       "n_test_users": board["nTestUsers"]}
        print(f"[eval] pio eval --grid: {len(board['rows'])} configs x "
              f"{GRID_ITERATIONS} iterations in {grid_s!r} s (the process); "
              f"{board['nTestUsers']} held-out users; winner "
              f"{winner['params']} precision@{GRID_TOPK} "
              f"{winner['metric']!r}; launches {launched} ({card})")

        said, err = evaluation.communicate(timeout=600)
        eval_s = time.perf_counter() - t_eval
        if evaluation.returncode != 0:
            raise AssertionError(f"pio eval chip_smoke:ml1m_evaluation "
                                 f"exited {evaluation.returncode}: "
                                 f"{err[-2000:]}")
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
        # batch_predict: one B1 launch per param set, its batch every
        # held-out user (thousands)
        want = eval_routes(ML1M_USERS, len(child), ML1M_USERS)
        if launched["fused_gather_score_topk_routes"] != want:
            raise AssertionError(f"pio eval's B1 launches by route "
                                 f"{launched['fused_gather_score_topk_routes']}"
                                 f", want {want}")
        mine = eval_scores_in_process(store)
        if [m[0] for m in mine] != child or [m[1] for m in mine] != child:
            raise AssertionError(f"Precision@{GRID_TOPK} of the child "
                                 f"{child}, in process (B1, plain) {mine}")
        if best["algorithms"] != result["bestEngineParams"]["algorithms"]:
            raise AssertionError("best.json is not the best params")
        out["evaluation"] = {"s": eval_s, "launches": launched,
                             "scores": child, "best_idx": result["bestIdx"]}
        out["operator"] = console_operator(work, env, instances[0].id, card)
        print(f"[eval] pio eval chip_smoke:ml1m_evaluation in {eval_s!r} s "
              f"(the process): Precision@{GRID_TOPK} per param set {child} "
              f"(each equal to this process's on the same factors, with B1 "
              f"and with plain), best {result['bestIdx']}; best.json and an "
              f"EVALCOMPLETED instance; launches {launched} ({card})")
        return out
    finally:
        if evaluation is not None and evaluation.poll() is None:
            evaluation.kill()
            evaluation.wait(timeout=60)
        storage.reset()


# -- phase 6d: the networked event store ----------------------------------------------

NET_APP = "ML1MNet"
NET_KEY = "chip-smoke-storage-key"
NET_SHARDS = 3
NET_WIRE_PART = 100_000   # events written through the wire; the rest filled
NET_BATCH = 5_000         # events per insert_batch on the wire
NET_NEW_USERS = 30        # folded through the fleet cursor
NET_DOWN_USERS = 4        # posted to the killed shard while it is down
NET_DOWN_SHARD = 1
NET_ENTITY_USERS = 1      # users read by the byte search and the parse
NET_LAPS = 2              # the wrapper's on / off laps, each
NET_LAP_READS = 5         # entity reads in a lap
NET_LAP_WRITES = 40       # 50-event insert_batch writes in a lap
NET_DEADLINE = 60.0       # restart -> the killed shard's users servable
NET_LATER = "2004-01-01T00:00:00"   # the post-deploy events' first time
NET_POSTER = r"""
import json, sys, time
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.fleet.router import FleetLEvents
cfg, path = json.loads(sys.argv[1]), sys.argv[2]
with open(path) as f:
    events = [Event.from_dict(d) for d in json.load(f)]
fleet = FleetLEvents(cfg)
sent = time.time()
ids = fleet.insert_batch(events, 1)
print(json.dumps({"ids": ids, "sent": sent, "acked": time.time()}),
      flush=True)
fleet.close()
"""


def net_config(source: dict):
    from predictionio_tpu_torch.data import storage

    return storage.StorageConfig(
        sources={"EV": source, "META": {"type": "memory"}},
        repositories={"EVENTDATA": "EV", "METADATA": "META",
                      "MODELDATA": "META"})


def net_lines(rows, cols, values) -> list:
    """The ratings as event JSON lines with their ids (``ev<j>``) and
    distinct event times (one second apart, in order)."""
    times = np.datetime_as_string(
        np.datetime64("2003-02-28T00:00:00", "s")
        + np.arange(len(rows)), unit="s").tolist()
    users, items, stars = rows.tolist(), cols.tolist(), values.tolist()
    return ['{"eventId":"ev%d","event":"rate","entityType":"user",'
            '"entityId":"u%d","targetEntityType":"item","targetEntityId":'
            '"i%d","properties":{"rating":%r},"eventTime":"%sZ",'
            '"creationTime":"%sZ"}' % (j, users[j], items[j], stars[j],
                                       times[j], times[j])
            for j in range(len(rows))]


def net_events(lines: list) -> list:
    from predictionio_tpu_torch.data.event import Event

    return [Event.from_json(line) for line in lines]


def net_server(path: str, work: str, port: int = 0) -> tuple:
    """A ``pio-torch eventserver`` child over a ``jsonlfs`` directory
    with the storage wire on; its output goes to a log file. Returns
    (process, URL)."""
    import os
    import re

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    env.update({"PIO_STORAGE_SOURCES_EV_TYPE": "jsonlfs",
                "PIO_STORAGE_SOURCES_EV_PATH": path,
                "PIO_STORAGE_SOURCES_META_TYPE": "memory",
                "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "EV",
                "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "META",
                "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "META"})
    log = os.path.join(work, f"{os.path.basename(path)}-{port}-"
                             f"{time.time_ns()}.log")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            CONSOLE + ["eventserver", "--ip", "127.0.0.1", "--port",
                       str(port), "--service-key", NET_KEY],
            env=env, cwd=work, stdout=out, stderr=subprocess.STDOUT)
    deadline = time.time() + 60
    while time.time() < deadline:
        with open(log) as f:
            found = re.search(r"ready at (http://[0-9.]+:\d+)\.", f.read())
        if found:
            return proc, found.group(1)
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    proc.kill()
    with open(log) as f:
        raise AssertionError(f"eventserver over {path} did not start: "
                             f"{f.read()[-2000:]}")


def healthz(url: str) -> tuple:
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def wait_for(check, timeout: float, what: str, step: float = 0.05) -> float:
    """Poll ``check()`` until true; the seconds it took."""
    t0 = time.perf_counter()
    while not check():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(step)
    return time.perf_counter() - t0


def dase_split(record: dict) -> dict:
    out = {sp["name"][len("dase."):]: sp["durationSec"]
           for sp in record["spans"]
           if sp["name"] in ("dase.read", "dase.prepare", "dase.train")}
    if len(out) != 3:
        raise AssertionError(f"the trace holds dase spans {sorted(out)}")
    return out


def net_train(label: str, source: dict, seed: int, init) -> dict:
    """``create_workflow`` over one event source (its own metadata and
    model stores in memory), from the injected init, as a ``pio.train``
    trace; returns its dase split, its launches, its training data and
    its model."""
    import torch

    from predictionio_tpu_torch.core.context import ComputeContext
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.ops import als as tals
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.utils import tracing
    from predictionio_tpu_torch.workflow.create_workflow import (
        WorkflowConfig,
        create_workflow,
    )

    storage.reset(net_config(source))
    if storage.get_metadata_apps().insert(App(0, NET_APP)) != 1:
        raise AssertionError("the app id must be 1 in every store")
    engine, record = lifecycle_engine()
    variant = {"id": "ml1mnet", "engineFactory": PORT_FACTORY,
               "datasource": {"params": {"appName": NET_APP}},
               "preparator": {"params": {"bucketed": True}},
               "algorithms": [{"name": "als", "params": {
                   "rank": RANK, "numIterations": ITERATIONS,
                   "lambda": LAMBDA, "alpha": ALPHA, "seed": seed}}]}
    a0, s0 = als_cuda.assemble_launches.value, als_cuda.spd_launches.value
    saved = tals.init_factors
    tals.init_factors = init
    parent = tracing.SpanContext(tracing.new_trace_id(),
                                 tracing.new_span_id(), sampled=True)
    t0 = time.perf_counter()
    try:
        with tracing.trace_scope("pio.train", parent=parent,
                                 slow_exempt=True):
            iid = create_workflow(
                WorkflowConfig(engine_id="ml1mnet",
                               engine_factory=PORT_FACTORY,
                               engine_variant="ml1mnet.json"),
                variant, engine=engine, ctx=ComputeContext())
        torch.cuda.synchronize()
    finally:
        tals.init_factors = saved
    total = time.perf_counter() - t0
    trace = tracing.trace_buffer().get(parent.trace_id)
    if trace is None:
        raise AssertionError(f"{label}: no pio.train trace kept")
    launches = {"assemble_normal_equations":
                als_cuda.assemble_launches.value - a0,
                "spd_solve": als_cuda.spd_launches.value - s0}
    if not all(launches.values()):
        raise AssertionError(f"{label}: training launches {launches}")
    instance = storage.get_metadata_engine_instances().get(iid)
    if instance is None or instance.status != "COMPLETED":
        raise AssertionError(f"{label}: engine instance {instance}")
    return {"id": iid, "model": record["model"], "data": record["read_out"],
            "dase": dase_split(trace), "launches": launches, "s": total}


def networked_store(seed: int, card: str) -> dict:
    """Phase 6d: the networked event store at ML-1M (module docstring)."""
    import collections
    import datetime as dt
    import os
    import signal
    import statistics
    import tempfile

    import torch

    from predictionio_tpu_torch.core.context import ComputeContext
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.api import EventServer, EventServerConfig
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage import observed, resthttp
    from predictionio_tpu_torch.data.storage.base import StorageError
    from predictionio_tpu_torch.data.storage.jsonlfs import JsonlFsLEvents
    from predictionio_tpu_torch.fleet.ring import HashRing
    from predictionio_tpu_torch.fleet.router import entity_key
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops.als import fold_in_users
    from predictionio_tpu_torch.utils import resilience
    from predictionio_tpu_torch.workflow.create_server import (
        QueryServer,
        ServerConfig,
        build_deployment,
        resolve_engine_instance,
    )

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="pio-net-")
    procs: list = []
    server = gateway = None
    prior_interval = os.environ.get("PIO_FOLDIN_INTERVAL")
    try:
        rows, cols, values, _ = ml1m_ratings(seed)
        n = len(rows)
        wire_from = n - NET_WIRE_PART
        t0 = time.perf_counter()
        lines = net_lines(rows, cols, values)
        ring = HashRing(NET_SHARDS)
        user_shard = np.asarray([ring.node_for(entity_key("user", f"u{u}"))
                                 for u in range(ML1M_USERS)])
        ev_shard = user_shard[rows]
        dirs = {name: os.path.join(work, name) for name in
                [f"shard{i}" for i in range(NET_SHARDS)] + ["rest", "local"]}

        def fill(name, picks):
            le = JsonlFsLEvents({"path": dirs[name]})
            le.init(1)
            for a in range(0, len(picks), 200_000):
                le.append_raw_lines([lines[j] for j in picks[a:a + 200_000]],
                                    1)
            le.close()

        for i in range(NET_SHARDS):
            fill(f"shard{i}", np.flatnonzero(ev_shard[:wire_from] == i))
        fill("rest", np.arange(wire_from))
        fill("local", np.arange(n))
        fill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(NET_SHARDS):
            procs.append(net_server(dirs[f"shard{i}"], work))
        procs.append(net_server(dirs["rest"], work))
        start_s = time.perf_counter() - t0
        shard_urls = [url for _, url in procs[:NET_SHARDS]]
        rest_url = procs[NET_SHARDS][1]
        fleet_src = {"type": "fleet", "urls": ",".join(shard_urls),
                     "service_key": NET_KEY}
        rest_src = {"type": "resthttp", "url": rest_url,
                    "service_key": NET_KEY}
        local_src = {"type": "jsonlfs", "path": dirs["local"]}

        # -- the wire part of the write --------------------------------
        wire_events = net_events(lines[wire_from:])
        storage.reset(net_config(fleet_src))
        fleet = storage.get_levents()
        t0 = time.perf_counter()
        for a in range(0, NET_WIRE_PART, NET_BATCH):
            fleet.insert_batch(wire_events[a:a + NET_BATCH], 1)
        fleet_write_s = time.perf_counter() - t0
        rest = resthttp.RestLEvents({"url": rest_url,
                                     "service_key": NET_KEY})
        t0 = time.perf_counter()
        for a in range(0, NET_WIRE_PART, NET_BATCH):
            rest.insert_batch(wire_events[a:a + NET_BATCH], 1)
        rest_write_s = time.perf_counter() - t0
        rest.close()
        counts = np.bincount(ev_shard, minlength=NET_SHARDS)
        user_counts = np.bincount(user_shard, minlength=NET_SHARDS)
        print(f"[net] {n} events at ML-1M width; {wire_from} filled "
              f"straight into the stores along the ring ({fill_s!r} s, "
              f"the local store too), {NET_WIRE_PART} through the wire: "
              f"FleetLEvents.insert_batch {fleet_write_s!r} s "
              f"({NET_WIRE_PART / fleet_write_s!r} events/s), "
              f"RestLEvents.insert_batch {rest_write_s!r} s "
              f"({NET_WIRE_PART / rest_write_s!r} events/s); "
              f"{NET_SHARDS + 1} eventserver children up in {start_s!r} s")
        for i in range(NET_SHARDS):
            print(f"[net] shard {i} ({shard_urls[i]}): {int(counts[i])} "
                  f"events, {float(counts[i] / n)!r} of them; the ring "
                  f"gives it {float(user_counts[i] / ML1M_USERS)!r} of the "
                  f"users (1/{NET_SHARDS} = {1 / NET_SHARDS!r})")

        # -- training from each source ---------------------------------
        g = torch.Generator().manual_seed(seed)
        init_draw = {}

        def init(n_rows, n_cols, rank, s, device=None):
            key = (n_rows, n_cols, rank)
            if key not in init_draw:
                scale = 1.0 / np.sqrt(rank)
                init_draw[key] = (torch.randn((n_rows, rank), generator=g)
                                  * scale,
                                  torch.randn((n_cols, rank), generator=g)
                                  * scale)
            X, Y = init_draw[key]
            return X.clone().to(device), Y.clone().to(device)

        shipped = collections.Counter()
        real_stream = resthttp._Wire.stream

        def counting_stream(self, params, op="find"):
            for chunk in real_stream(self, params, op=op):
                shipped[self.url] += len(chunk)
                yield chunk

        resthttp._Wire.stream = counting_stream
        try:
            trained = {label: net_train(label, src, seed, init)
                       for label, src in (("local", local_src),
                                          ("resthttp", rest_src),
                                          ("fleet", fleet_src))}
        finally:
            resthttp._Wire.stream = real_stream
        for label, res in trained.items():
            print(f"[net] train from {label}: {res['s']!r} s; dase read "
                  f"{res['dase']['read']!r} s, prepare "
                  f"{res['dase']['prepare']!r} s, train "
                  f"{res['dase']['train']!r} s; launches {res['launches']}")
        for i, url in enumerate(shard_urls):
            print(f"[net] the fleet's training read: shard {i} shipped "
                  f"{shipped[url]} bytes")
        print(f"[net] the resthttp training read shipped "
              f"{shipped[rest_url]} bytes")
        local = trained["local"]
        tables_equal = True
        for label in ("resthttp", "fleet"):
            other = trained[label]
            for col in ("users", "items", "values"):
                tables_equal &= np.array_equal(
                    np.asarray(getattr(local["data"], col)),
                    np.asarray(getattr(other["data"], col)))
        for label in ("resthttp", "fleet"):
            m, ref = trained[label]["model"], local["model"]
            if list(m.user_map.labels) != list(ref.user_map.labels) or \
                    list(m.item_map.labels) != list(ref.item_map.labels):
                raise AssertionError(f"{label}: entity maps differ")
            for side in ("user_factors", "item_factors"):
                a = np.asarray(getattr(m, side))
                b = np.asarray(getattr(ref, side))
                if tables_equal:
                    if not np.array_equal(a, b):
                        raise AssertionError(
                            f"{label} {side}: not bitwise the local "
                            f"training's on byte-equal tables")
                else:
                    scale = float(np.abs(b).max())
                    if not float(np.abs(a - b).max()) <= 1e-4 * scale:
                        raise AssertionError(f"{label} {side} differ")
        print(f"[net] factors from resthttp and fleet: "
              f"{'bitwise equal to' if tables_equal else 'within 1e-4 of'}"
              f" the local training's (training data "
              f"{'byte-equal' if tables_equal else 'reordered'})")

        # -- deploy over the fleet and fold through its cursor ---------
        # (the last training's registry: the fleet, its instance in the
        # metadata store, a fleet DAO of its own)
        fleet = storage.get_levents()
        os.environ["PIO_FOLDIN_INTERVAL"] = repr(FOLDIN_INTERVAL)
        dep = build_deployment(resolve_engine_instance(
            trained["fleet"]["id"]), ComputeContext())
        model = dep.models[0]
        b1_0 = als_cuda.launches.value
        server = QueryServer(ServerConfig(ip="127.0.0.1", port=0,
                                          foldin=True), dep).start()
        qbase = "http://{}:{}".format(*server.address)
        consumer = server._foldin
        srv = model.device_server()
        rng = np.random.default_rng(seed + 29)
        known_items = np.asarray(model.item_map.labels)
        later = dt.datetime.fromisoformat(NET_LATER).replace(
            tzinfo=dt.timezone.utc)
        clock = iter(range(10 ** 9))

        def ratings_of(name):
            k = int(rng.integers(5, 40))
            picks = rng.choice(len(known_items), k, replace=False)
            return [Event(event="rate", entity_type="user", entity_id=name,
                          target_entity_type="item",
                          target_entity_id=str(known_items[p]),
                          properties={"rating": float(
                              rng.integers(1, 11) * 0.5)},
                          event_time=later + dt.timedelta(
                              seconds=next(clock)),
                          event_id=f"{name}-{j}")
                    for j, p in enumerate(picks)]

        new_users = [f"net-new-{j}" for j in range(NET_NEW_USERS)]
        posted = {u: ratings_of(u) for u in new_users}
        served_at: dict = {}

        def servable(names):
            for name in names:
                if name in served_at or name not in model.user_map:
                    continue
                status, body, _ = post(qbase + "/queries.json",
                                       {"user": name, "num": 10})
                if status == 200 and body["itemScores"]:
                    served_at[name] = time.time()
            return all(name in served_at for name in names)

        a0, s0 = als_cuda.assemble_launches.value, als_cuda.spd_launches.value
        folds0 = consumer.stats()["folds"]
        # the new users' events in one write: the next fold gathers all
        # of them, one entity read of the owner shard each
        stop_poll = threading.Event()

        def poll():
            while not stop_poll.is_set():
                servable(new_users)
                time.sleep(0.01)

        poller = threading.Thread(target=poll, daemon=True)
        poller.start()
        try:
            t_sent = time.time()
            fleet.insert_batch([e for u in new_users for e in posted[u]], 1)
            wait_for(lambda: len(served_at) >= NET_NEW_USERS,
                     FOLDIN_DEADLINE + 30,
                     "the new users servable through the fleet cursor")
        finally:
            stop_poll.set()
            poller.join(timeout=30)
        fresh = np.asarray([served_at[u] - t_sent for u in new_users])
        st = consumer.stats()
        fold_launches = (als_cuda.assemble_launches.value - a0,
                         als_cuda.spd_launches.value - s0)
        if st["foldErrors"] or st["tailErrors"] or \
                fold_launches != (st["folds"] - folds0,) * 2:
            raise AssertionError(f"fold-in over the fleet: stats {st}, "
                                 f"launches (B3, B2) {fold_launches}")
        if float(np.percentile(fresh, 99)) > FOLDIN_DEADLINE:
            raise AssertionError(f"event -> servable p99 "
                                 f"{np.percentile(fresh, 99)!r} s")
        print(f"[net] fold-in over the fleet cursor: {NET_NEW_USERS} new "
              f"users ({sum(len(v) for v in posted.values())} events in "
              f"one write) servable p50 "
              f"{float(np.percentile(fresh, 50))!r} s, p99 "
              f"{float(np.percentile(fresh, 99))!r} s (limit "
              f"{FOLDIN_DEADLINE} s); {st['folds'] - folds0} folds, "
              f"launches B3 {fold_launches[0]}, B2 {fold_launches[1]}")

        # -- kill a shard ----------------------------------------------
        k = NET_DOWN_SHARD
        gateway = EventServer(
            EventServerConfig(ip="127.0.0.1", port=0),
            reg=storage.StorageRegistry(net_config(
                {"type": "resthttp", "url": shard_urls[k],
                 "service_key": NET_KEY}))).start()
        gw = "http://{}:{}".format(*gateway.address)
        if healthz(gw)[0] != 200:
            raise AssertionError(f"the gateway to shard {k} is not ready")
        down_users = []
        for u in (f"net-down-{j}" for j in range(10 ** 6)):
            if ring.node_for(entity_key("user", u)) == k:
                down_users.append(u)
                if len(down_users) == NET_DOWN_USERS:
                    break
        posted.update({u: ratings_of(u) for u in down_users})
        batch_file = os.path.join(work, "down-events.json")
        with open(batch_file, "w") as f:
            json.dump([e.to_dict() for u in down_users for e in posted[u]],
                      f)
        known_on_k = [u for u in model.user_map.labels[:2_000]
                      if ring.node_for(entity_key("user", u)) == k][:40]
        kill_proc = procs[k][0]
        kill_proc.send_signal(signal.SIGKILL)
        kill_proc.wait(timeout=30)
        t_kill = time.perf_counter()
        env = {k_: v for k_, v in os.environ.items()
               if not k_.startswith("PIO_")}
        env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
        env.update({"PIO_STORAGE_RETRIES": "600",
                    "PIO_STORAGE_RETRY_BASE": "0.05",
                    "PIO_STORAGE_RETRY_MAX": "0.25",
                    "PIO_STORAGE_OP_DEADLINE": "120",
                    "PIO_STORAGE_CONNECT_TIMEOUT": "1.0"})
        poster = subprocess.Popen(
            [sys.executable, "-c", NET_POSTER, json.dumps(
                {"urls": ",".join(shard_urls), "service_key": NET_KEY}),
             batch_file], env=env, cwd=work, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs.append((poster, None))
        loud_event = Event(event="rate", entity_type="user",
                           entity_id=down_users[0],
                           target_entity_type="item",
                           target_entity_id=str(known_items[0]),
                           properties={"rating": 1.0}, event_time=later,
                           event_id="net-loud-0")
        try:
            fleet.insert(loud_event, 1)
        except StorageError as e:
            loud = f"{type(e).__name__}: {e}"
        else:
            raise AssertionError("a write to the dead shard was acked")
        answers = burst(qbase, [{"user": u, "num": 10}
                                for u in known_on_k + new_users[:10]])
        if any(status != 200 for _, status, _, _ in answers):
            raise AssertionError("a query failed while a shard was down")
        reasons = collections.Counter(
            r for _, _, body, _ in answers
            for r in body.get("degradedReasons", []))
        unready_s = wait_for(lambda: healthz(gw)[0] == 503, 30,
                             "the gateway's /healthz storage: false")
        topo = fleet.topology()
        print(f"[net] shard {k} killed (SIGKILL): {len(answers)} queries "
              f"answered 200, degradedReasons {dict(reasons)}; a write to "
              f"it failed loud ({loud[:160]}); the gateway's /healthz "
              f"{healthz(gw)} {unready_s!r} s after the kill; topology "
              f"{[(s['index'], s['breakerState']) for s in topo['shards']]}"
              f" ({topo['healthyShards']}/{NET_SHARDS} healthy)")
        time.sleep(1.0)
        port_k = int(shard_urls[k].rsplit(":", 1)[1])
        procs[k] = net_server(dirs[f"shard{k}"], work, port_k)
        t_restart = time.time()
        out, err = poster.communicate(timeout=120)
        if poster.returncode != 0:
            raise AssertionError(f"the poster failed: {err[-2000:]}")
        acked = json.loads(out.strip().splitlines()[-1])
        ready_s = wait_for(
            lambda: resilience.breaker_for(shard_urls[k]).state
            == resilience.CLOSED and healthz(gw)[0] == 200, 60,
            "the breaker closing after the restart")
        wait_for(lambda: servable(down_users), NET_DEADLINE,
                 "the killed shard's users servable after the restart",
                 0.01)
        delay = [served_at[u] - t_restart for u in down_users]
        back = [served_at[u] - acked["acked"] for u in down_users]
        # none lost: every event posted after deploy is in the fleet
        stored = {e.event_id for e in fleet.find(1, start_time=later)}
        want_ids = {e.event_id for evs in posted.values() for e in evs}
        if stored != want_ids or sorted(acked["ids"]) != sorted(
                e.event_id for u in down_users for e in posted[u]):
            raise AssertionError(f"events lost: {len(want_ids - stored)} "
                                 f"of {len(want_ids)} missing")
        print(f"[net] shard {k} restarted on its directory: the poster's "
              f"{len(acked['ids'])} events acked "
              f"{acked['acked'] - acked['sent']!r} s after sending; the "
              f"breaker closed and /healthz read storage: true "
              f"{ready_s!r} s after the restart; the {NET_DOWN_USERS} users "
              f"servable {min(delay)!r}-{max(delay)!r} s after the restart "
              f"({min(back)!r}-{max(back)!r} s after the ack); none lost "
              f"({len(stored)} post-deploy events stored)")

        # -- every folded row against the plain fold; the answers -------
        folded = new_users + down_users
        cl = [np.asarray([model.item_map[e.target_entity_id]
                          for e in posted[u]], np.int64) for u in folded]
        vl = [np.asarray([e.properties.fields["rating"] for e in posted[u]],
                         np.float32) for u in folded]
        als_params = dep.engine_params.algorithm_params_list[0][1]
        # no fold may run while the kernels are swapped for plain
        consumer.stop()
        saved = (als_cuda.assemble_normal_equations, als_cuda.spd_solve)
        als_cuda.assemble_normal_equations = \
            als_cuda.assemble_normal_equations_plain
        als_cuda.spd_solve = als_cuda.spd_solve_plain
        try:
            plain = fold_in_users(srv.item_factors, cl, vl, als_params)
        finally:
            als_cuda.assemble_normal_equations, als_cuda.spd_solve = saved
        uidx = torch.as_tensor([model.user_map[u] for u in folded],
                               device=srv._X.device)
        stored_rows = srv._X[uidx].float().cpu().numpy()
        want_rows = torch.from_numpy(plain).to(srv._X.dtype).float().numpy()
        scale = np.maximum(np.abs(want_rows).max(axis=1, keepdims=True),
                           1e-30)
        rel = float((np.abs(stored_rows - want_rows) / scale).max())
        if not rel <= FOLDIN_ROW_TOL:
            raise AssertionError(f"folded rows differ from the plain fold "
                                 f"by {rel!r} of their largest entry")
        checked = check_against_plain(model, burst(qbase, [
            {"user": u, "num": 10}
            for u in folded + list(model.user_map.labels[:50])]))
        b1 = als_cuda.launches.value - b1_0
        print(f"[net] {len(folded)} folded rows within {rel!r} of the plain "
              f"fold's largest entry (limit {FOLDIN_ROW_TOL!r}); {checked} "
              f"answers equal the plain top-k of the patched store; B1 "
              f"launched {b1} times in this phase")
        server.stop()
        server = None

        # -- an entity read: the byte search against the whole parse ---
        shard0 = JsonlFsLEvents({"path": dirs["shard0"]})
        on_0 = [u for u in model.user_map.labels[:500]
                if ring.node_for(entity_key("user", u)) == 0]
        entity_kw = dict(entity_type="user", event_names=["rate"],
                         target_entity_type="item")
        whole = JsonlFsLEvents({"path": dirs["shard0"]})
        whole._iter_entity_candidates = lambda d, uid: whole._iter_events(d)
        search_s, parse_s = [], []
        for u in on_0[:NET_ENTITY_USERS]:
            t = time.perf_counter()
            got = [e.to_json() for e in shard0.find(1, entity_id=u,
                                                    **entity_kw)]
            search_s.append(time.perf_counter() - t)
            t = time.perf_counter()
            want = [e.to_json() for e in whole.find(1, entity_id=u,
                                                    **entity_kw)]
            parse_s.append(time.perf_counter() - t)
            if not got or got != want:
                raise AssertionError(f"entity read of {u}: the byte search "
                                     f"found {len(got)} events, the whole "
                                     f"parse {len(want)}")
        print(f"[net] an entity read of shard 0's store "
              f"({int(counts[0])} events): the byte search {search_s!r} s, "
              f"the whole parse it replaced {parse_s!r} s, on the same "
              f"{len(search_s)} users, equal answers ({card})")

        # -- the wrapper's cost: the registry's DAO, on and off --------
        storage.reset(net_config(local_src))
        le = storage.get_levents()
        if observed.unwrap(le) is le:
            raise AssertionError("the registry handed out an unwrapped DAO")
        lap_users = list(model.user_map.labels[:NET_LAP_READS])
        # without ids, as a client posts them: each write stores new events
        lap_events = [e.with_id(None)
                      for e in wire_events[:50 * NET_LAP_WRITES]]

        def read_lap():
            t = time.perf_counter()
            for u in lap_users:
                if not list(le.find(1, entity_id=u, **entity_kw)):
                    raise AssertionError(f"no events of {u} in the "
                                         "local store")
            return time.perf_counter() - t

        def write_lap():
            t = time.perf_counter()
            for a in range(0, len(lap_events), 50):
                le.insert_batch(lap_events[a:a + 50], 2)
            return time.perf_counter() - t

        le.init(2)
        laps = {(kind, flag): [] for kind in ("read", "write")
                for flag in (True, False)}
        for _ in range(NET_LAPS):
            for flag in (True, False):
                resilience.set_enabled(flag)
                laps["read", flag].append(read_lap())
                laps["write", flag].append(write_lap())
        resilience.set_enabled(True)
        wrapper = {f"{kind}_{'on' if flag else 'off'}_s": statistics.median(v)
                   for (kind, flag), v in laps.items()}
        print(f"[net] the registry's wrapped jsonlfs DAO, PIO_RESILIENCE on "
              f"/ off in turns ({NET_LAPS} laps each): {NET_LAP_READS} "
              f"entity reads {laps['read', True]!r} / "
              f"{laps['read', False]!r} s, {NET_LAP_WRITES} insert_batch "
              f"writes of 50 events {laps['write', True]!r} / "
              f"{laps['write', False]!r} s; medians {wrapper} ({card})")
        out = {"write": {"fleet_events_per_s": NET_WIRE_PART / fleet_write_s,
                         "rest_events_per_s": NET_WIRE_PART / rest_write_s,
                         "shard_events": counts.tolist()},
               "train": {label: {"dase": r["dase"], "launches": r["launches"]}
                         for label, r in trained.items()},
               "shipped": {"fleet": [shipped[u] for u in shard_urls],
                           "resthttp": shipped[rest_url]},
               "bitwise": tables_equal,
               "servable_p50_s": float(np.percentile(fresh, 50)),
               "servable_p99_s": float(np.percentile(fresh, 99)),
               "restart_delay_s": max(delay),
               "fold_launches": {"assemble_normal_equations":
                                 fold_launches[0],
                                 "spd_solve": fold_launches[1]},
               "b1_launches": b1,
               "entity_search_s": statistics.median(search_s),
               "entity_parse_s": statistics.median(parse_s),
               "wrapper": wrapper}
        print(f"[net] phase 6d took {time.perf_counter() - t_phase!r} s "
              f"({card})")
        return out
    finally:
        if prior_interval is None:
            os.environ.pop("PIO_FOLDIN_INTERVAL", None)
        else:
            os.environ["PIO_FOLDIN_INTERVAL"] = prior_interval
        for thing in (server, gateway):
            if thing is not None:
                thing.stop()
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
        resilience.set_enabled(True)
        resilience.reset_breakers()
        storage.reset()
        shutil.rmtree(work, ignore_errors=True)


# -- phase 6e: the other templates -------------------------------------------------

OT_APP = "ML1MShop"
OT_REPEAT = 0.01          # share of ratings viewed a second time
OT_BUY_STARS = 4.5        # a rating at or above this is also a buy
OT_UNAVAILABLE = 50       # items of each constraint/unavailableItems $set
OT_QUERIES = 50           # sequential HTTP queries per template
OT_DIMSUM_COLUMNS = 64    # columns held to the float64 oracle
OT_FACTOR_TOL = 1e-4      # ALS factors vs the plain trainer, of the largest
OT_DIMSUM_TOL = 1e-5      # DIMSUM vs the float64 oracle, absolute
OT_ANSWER_RTOL = 1e-5     # HTTP vs in-process scores, relative
OT_TEXT_TOL = 1e-5        # one epoch card vs CPU, of each tensor's largest
# the published engine.json parameters (PredictionIO's similarproduct and
# ecommercerecommendation templates: rank 10, 20 iterations, lambda 0.01)
OT_ALS = {"rank": 10, "numIterations": 20, "lambda": 0.01, "seed": 3}
# a corpus at 20 Newsgroups' size (18,846 documents, 20 classes); the
# template's defaults (vocab 4,096, 64 tokens, D 64, 30 epochs, batch 128)
TEXT_DOCS, TEXT_CLASSES, TEXT_HELD = 18_846, 20, 2_000
TEXT_OWN, TEXT_SHARED, TEXT_COMMON = 300, 100, 2_000   # words per class
OT_FACTORY = "predictionio_tpu_torch.templates.{}:{}"
OT_ALS_TEMPLATES = ("similarproduct", "ecommercerecommendation")


def ot_views(seed: int) -> tuple:
    """ML-1M's ratings as the shop's events: ``(rows, cols, stars, cats,
    years, repeats)``, ``repeats`` the rating indices viewed again."""
    rows, cols, stars, cats = ml1m_ratings(seed)
    rng = np.random.default_rng(seed + 11)
    repeats = np.sort(rng.choice(len(rows), int(OT_REPEAT * len(rows)),
                                 replace=False))
    years = rng.integers(1919, 2001, ML1M_ITEMS)
    return rows, cols, stars, cats, years, repeats


def ot_store(seed: int, app_id: int) -> dict:
    """One ``view`` per rating plus the repeats, a ``buy`` per rating of
    ``OT_BUY_STARS`` or more (``insert_raw_batch``, 100,000 rows a call),
    a ``$set`` per user and per item (categories, year), and one
    ``constraint/unavailableItems`` ``$set`` of ``OT_UNAVAILABLE``
    items."""
    import datetime as dt

    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.event import Event

    rows, cols, stars, cats, years, repeats = ot_views(seed)
    levents = storage.get_levents()
    levents.init(app_id)
    t0 = time.perf_counter()
    base = dt.datetime(2003, 2, 28, tzinfo=dt.timezone.utc).timestamp()
    idx = np.concatenate([np.arange(len(rows)), repeats])
    buys = np.nonzero(stars >= OT_BUY_STARS)[0]
    raw = [("view", j) for j in idx.tolist()] + \
        [("buy", j) for j in buys.tolist()]
    users, items = rows.tolist(), cols.tolist()
    for a in range(0, len(raw), 100_000):
        levents.insert_raw_batch([
            (f"ot{k}", name, "user", f"u{users[j]}", "item", f"i{items[j]}",
             "{}", base + k, "[]", None, base + k)
            for k, (name, j) in enumerate(raw[a:a + 100_000], start=a)],
            app_id)
    when = dt.datetime(2003, 3, 1, tzinfo=dt.timezone.utc)
    levents.insert_batch([Event(event="$set", entity_type="user",
                                entity_id=f"u{u}", event_time=when)
                          for u in range(ML1M_USERS)], app_id)
    levents.insert_batch([
        Event(event="$set", entity_type="item", entity_id=f"i{i}",
              properties={"categories": list(cats[f"i{i}"]),
                          "year": int(years[i])}, event_time=when)
        for i in range(ML1M_ITEMS)], app_id)
    rng = np.random.default_rng(seed + 13)
    gone = [f"i{i}" for i in rng.choice(ML1M_ITEMS, OT_UNAVAILABLE,
                                        replace=False)]
    levents.insert(Event(event="$set", entity_type="constraint",
                         entity_id="unavailableItems",
                         properties={"items": gone}, event_time=when),
                   app_id)
    return {"views": len(idx), "buys": len(buys), "unavailable": gone,
            "years": years, "cats": cats, "rows": rows, "cols": cols,
            "write_s": time.perf_counter() - t0}


def timed_engine(factory: str) -> tuple:
    """``factory``'s engine with the read, the prepare and each train
    timed (summed seconds, the card synchronised), and the prepared data
    kept: ``(engine, record)``."""
    import torch

    from predictionio_tpu_torch.controller import Engine
    from predictionio_tpu_torch.workflow import core_workflow

    base = core_workflow.load_engine_factory(factory)()
    record = {"read": 0.0, "prepare": 0.0, "train": 0.0}

    def timed(cls, method, label):
        def run(self, *args):
            t = time.perf_counter()
            try:
                out = getattr(cls, method)(self, *args)
            finally:
                torch.cuda.synchronize()
                record[label] += time.perf_counter() - t
            if label == "prepare":
                record["pd"] = out
            return out
        return type(cls.__name__, (cls,), {method: run})

    def each(class_map, method, label):
        return {name: timed(cls, method, label)
                for name, cls in class_map.items()}

    return Engine(each(base.data_source_class_map, "read_training_base",
                       "read"),
                  each(base.preparator_class_map, "prepare_base", "prepare"),
                  each(base.algorithm_class_map, "train_base", "train"),
                  base.serving_class_map), record


def ot_train(name: str, factory: str, variant: dict,
             keep_pd: bool = False) -> dict:
    """``create_workflow`` of ``variant`` on the card, the training
    kernels' launches counted: the instance, the stage seconds and the
    launches (and the prepared data with ``keep_pd``)."""
    from predictionio_tpu_torch.core.context import ComputeContext
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.workflow.create_workflow import (
        WorkflowConfig,
        create_workflow,
    )

    engine, record = timed_engine(factory)
    for counter in (als_cuda.assemble_launches, als_cuda.spd_launches):
        counter.reset()
    t = time.perf_counter()
    iid = create_workflow(
        WorkflowConfig(engine_id=name, engine_factory=factory),
        {"id": name, "engineFactory": factory, **variant}, engine=engine,
        ctx=ComputeContext())
    total = time.perf_counter() - t
    launches = {"assemble_normal_equations": als_cuda.assemble_launches.value,
                "spd_solve": als_cuda.spd_launches.value}
    print(f"[templates] {name}: instance {iid} in {total:.2f} s; read "
          f"{record['read']!r} s, prepare {record['prepare']!r} s, train "
          f"{record['train']!r} s; launches {launches}")
    return {"id": iid, "s": total, "read_s": record["read"],
            "prepare_s": record["prepare"], "train_s": record["train"],
            "launches": launches,
            **({"pd": record.get("pd")} if keep_pd else {})}


class ALSCapture:
    """Records the uniform tables each ALS template hands the trainer
    (its module's ``_train_als_auto``), and the factors it returns."""

    def __init__(self):
        self.calls: list = []
        self._saved: list = []

    def __enter__(self) -> "ALSCapture":
        from predictionio_tpu_torch.templates.ecommercerecommendation import (
            engine as ecomm,
        )
        from predictionio_tpu_torch.templates.similarproduct import (
            engine as similar,
        )

        for mod in (similar, ecomm):
            fn = mod._train_als_auto

            def wrapped(us, its, params, device=None, _fn=fn):
                out = _fn(us, its, params, device)
                self.calls.append((us, its, params, out))
                return out

            self._saved.append((mod, fn))
            mod._train_als_auto = wrapped
        return self

    def __exit__(self, *exc) -> None:
        for mod, fn in self._saved:
            mod._train_als_auto = fn
        self._saved = []


def plain_als_check(dev, call: tuple, label: str) -> dict:
    """The plain trainer (both kernels' plain versions) on the card from
    the same init and tables: each factor matrix within
    ``OT_FACTOR_TOL`` of its largest entry."""
    from predictionio_tpu_torch.ops import als as als_mod
    from predictionio_tpu_torch.ops import als_cuda

    us, its, params, (X, Y) = call
    saved = (als_cuda.assemble_normal_equations, als_cuda.spd_solve)
    als_cuda.assemble_normal_equations = \
        als_cuda.assemble_normal_equations_plain
    als_cuda.spd_solve = als_cuda.spd_solve_plain
    try:
        Xp, Yp = als_mod.train_als(us, its, params, dev)
    finally:
        als_cuda.assemble_normal_equations, als_cuda.spd_solve = saved
    errs = {side: float(np.abs(got - want).max() / np.abs(want).max())
            for side, got, want in (("user", X, Xp), ("item", Y, Yp))}
    print(f"[templates] {label}: factors vs the plain trainer on the card "
          f"from the same init, largest |difference| over the largest "
          f"entry {errs} (limit {OT_FACTOR_TOL}); tables user "
          f"{list(us.cols.shape)}, item {list(its.cols.shape)}")
    if max(errs.values()) > OT_FACTOR_TOL:
        raise AssertionError(f"{label}: factors differ from the plain "
                             f"trainer's: {errs}")
    return errs


def uniform_timings(dev, call: tuple) -> dict:
    """B3 and B2 on the uniform route at R = 10, one iteration's work of
    each side of ``call``'s tables against its trained factors: kernel,
    plain, library (``torch.bmm`` over the gathered rows; batched
    Cholesky) and bound."""
    import torch

    from predictionio_tpu_torch.ops import als as als_mod
    from predictionio_tpu_torch.ops import als_cuda

    us, its, params, (X, Y) = call
    R = params.rank
    eye = torch.eye(R, device=dev)
    rows = {"assemble_normal_equations": [], "spd_solve": []}
    for side_name, side, fixed in (("user", us, Y), ("item", its, X)):
        F = torch.as_tensor(fixed, device=dev)
        cols = torch.as_tensor(side.cols, device=dev)
        m = torch.as_tensor(side.mask, device=dev)
        aw, bw = als_mod.implicit_weights(
            torch.as_tensor(side.weights, device=dev) * m, params.alpha)
        gram = F.T @ F + params.lambda_ * eye
        B, L = side.cols.shape
        nnz = int(side.mask.sum())
        Fg = F[cols.long()]
        awFg = (aw[:, :, None] * Fg).transpose(1, 2)

        def kernel():
            return als_cuda.assemble_normal_equations(F, cols, aw, bw, gram)

        t_k = time_ms(kernel, 5)
        t_p = time_ms(lambda: als_cuda.assemble_normal_equations_plain(
            F, cols, aw, bw, gram), 2)
        t_l = time_ms(lambda: torch.bmm(awFg, Fg), 3)
        del Fg, awFg
        work = assembly_work(B, L, nnz, F.shape[0], R)
        b_ms, b_by = bound_of(*work)
        rows["assemble_normal_equations"].append({
            "side": side_name, "B": B, "L": L, "R": R, "slots": nnz,
            "work": work, "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
            "bound_ms": b_ms, "bound_by": b_by})
        print(f"[templates] uniform assemble {side_name:>4} B={B} L={L} "
              f"R={R}: kernel {t_k!r} ms  plain {t_p!r} ms  library {t_l!r} "
              f"ms  bound {b_ms!r} ms ({b_by})")
        A, b = kernel()

        def library():
            torch.cholesky_solve(b[:, :, None], torch.linalg.cholesky(A))

        t_k = time_ms(lambda: als_cuda.spd_solve(A, b), 5)
        t_p = time_ms(lambda: als_cuda.spd_solve_plain(A, b), 2)
        t_l = time_ms(library, 3)
        work = solve_work(B, R)
        b_ms, b_by = bound_of(*work)
        rows["spd_solve"].append({
            "side": side_name, "B": B, "R": R, "work": work, "ms": t_k,
            "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
            "bound_by": b_by})
        print(f"[templates] uniform spd_solve {side_name:>4} B={B} R={R}: "
              f"kernel {t_k!r} ms  plain {t_p!r} ms  library {t_l!r} ms  "
              f"bound {b_ms!r} ms ({b_by})")
        del A, b
    heads = {}
    for name, parts in rows.items():
        b_ms, b_by = bound_of(sum(r["work"][0] for r in parts),
                              sum(r["work"][1] for r in parts))
        heads[name] = {key: sum(r[key] for r in parts)
                       for key in ("ms", "plain_ms", "library_ms")}
        heads[name].update(bound_ms=b_ms, bound_by=b_by)
    return {"rows": rows, "heads": heads}


def dimsum_oracle_check(model, store: dict, seed: int) -> float:
    """DIMSUM's similarities of ``OT_DIMSUM_COLUMNS`` sampled columns
    against a float64 numpy oracle over the de-duplicated binary view
    matrix; returns the largest |difference|."""
    users = sorted({f"u{u}" for u in store["rows"].tolist()})
    uix = {u: i for i, u in enumerate(users)}
    A = np.zeros((len(users), len(model.item_map)), dtype=np.float64)
    A[[uix[f"u{u}"] for u in store["rows"].tolist()],
      [model.item_map[f"i{i}"] for i in store["cols"].tolist()]] = 1.0
    An = A / np.maximum(np.linalg.norm(A, axis=0), 1e-12)
    rng = np.random.default_rng(seed + 17)
    picked = np.sort(rng.choice(A.shape[1], OT_DIMSUM_COLUMNS,
                                replace=False))
    S = An.T @ An[:, picked]
    S[picked, np.arange(len(picked))] = 0.0
    err = float(np.abs(model.similarities[:, picked] - S).max())
    print(f"[templates] DIMSUM [{A.shape[0]:,} x {A.shape[1]:,}] similarities "
          f"of {len(picked)} sampled columns vs a float64 oracle: largest "
          f"|difference| {err!r} (limit {OT_DIMSUM_TOL})")
    if err > OT_DIMSUM_TOL:
        raise AssertionError(f"DIMSUM similarities differ from the oracle "
                             f"by {err}")
    return err


def close_answers(got, want, path: str = "") -> list:
    """Where two answers differ: floats beyond ``OT_ANSWER_RTOL``
    relative, anything else unequal."""
    if isinstance(want, float) and isinstance(got, (float, int)):
        scale = max(abs(want), abs(got), 1e-30)
        return [] if abs(got - want) <= OT_ANSWER_RTOL * scale else [path]
    if isinstance(want, dict) and isinstance(got, dict):
        if sorted(want) != sorted(got):
            return [path]
        return [p for k in want for p in close_answers(got[k], want[k],
                                                       f"{path}.{k}")]
    if isinstance(want, list) and isinstance(got, list):
        if len(want) != len(got):
            return [path]
        return [p for j, (g, w) in enumerate(zip(got, want))
                for p in close_answers(g, w, f"{path}[{j}]")]
    return [] if got == want else [path]


def ot_serve(name: str, iid: str, queries: list, after=None) -> dict:
    """Deploy ``iid`` through ``QueryServer`` and send ``queries`` over
    HTTP one after another: each answer must equal the deployment's
    in-process answer (ids equal, scores within ``OT_ANSWER_RTOL``).
    ``after(base, dep)`` runs against the live server before it stops."""
    from predictionio_tpu_torch.core.context import ComputeContext
    from predictionio_tpu_torch.workflow.create_server import (
        QueryServer,
        ServerConfig,
        build_deployment,
        query_from_json,
        resolve_engine_instance,
        serve_query,
        to_jsonable,
    )

    dep = build_deployment(resolve_engine_instance(iid), ComputeContext())
    qcls = dep.algorithms[0].query_class
    srv = QueryServer(ServerConfig(ip="127.0.0.1", port=0), dep).start()
    base = "http://{}:{}".format(*srv.address)
    try:
        seconds, bad, nonempty = [], [], 0
        for q in queries:
            status, body, s = post(base + "/queries.json", q)
            want = to_jsonable(serve_query(dep, query_from_json(q, qcls)))
            seconds.append(s)
            where = close_answers(body, want)
            if status != 200 or where:
                bad.append((q, status, where[:3]))
            nonempty += body not in ([], {}, None) and not (
                isinstance(body, dict) and any(
                    v == [] for v in body.values()))
        if bad:
            raise AssertionError(f"{name}: {len(bad)} HTTP answers differ "
                                 f"from the in-process ones: {bad[:3]}")
        extra = after(base, dep) if after is not None else {}
    finally:
        srv.stop()
    ms = np.asarray(seconds) * 1e3
    out = {"p50_ms": float(np.percentile(ms, 50)),
           "p99_ms": float(np.percentile(ms, 99)), "queries": len(queries),
           "nonempty": nonempty, **extra}
    print(f"[templates] {name}: {len(queries)} HTTP answers equal the "
          f"in-process ones ({nonempty} non-empty); sequential p50 "
          f"{out['p50_ms']!r} ms p99 {out['p99_ms']!r} ms")
    return out


def text_corpus(seed: int, n_docs: int) -> tuple:
    """``n_docs`` documents of ``TEXT_CLASSES`` labels: each class draws
    from its own ``TEXT_OWN`` words, ``TEXT_SHARED`` words it shares with
    the next class, and ``TEXT_COMMON`` words every class uses; 40-200
    tokens a document (the template reads the first 64)."""
    rng = np.random.default_rng(seed)
    words = []
    for c in range(TEXT_CLASSES):
        words.append([f"c{c}w{j}" for j in range(TEXT_OWN)]
                     + [f"s{c}w{j}" for j in range(TEXT_SHARED)]
                     + [f"s{(c - 1) % TEXT_CLASSES}w{j}"
                        for j in range(TEXT_SHARED)])
    common = [f"common{j}" for j in range(TEXT_COMMON)]
    labels = rng.integers(0, TEXT_CLASSES, n_docs)
    texts = []
    for lab in labels.tolist():
        n = int(rng.integers(40, 201))
        own = rng.random(n) < 0.3
        toks = np.where(own, rng.choice(words[lab], n),
                        rng.choice(common, n))
        texts.append(" ".join(toks.tolist()))
    return texts, [f"group{lab}" for lab in labels.tolist()]


def ot_text(dev, seed: int, app_id: int) -> dict:
    """textclassification at 20 Newsgroups' size: the corpus as ``doc``
    ``$set`` events, ``create_workflow`` with the template's defaults (the
    loss must fall), held-out accuracy above the majority class, and one
    epoch on the card against the CPU from one init and one set of
    permutations."""
    import dataclasses
    import datetime as dt

    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.templates.textclassification import (
        engine as teng,
    )

    texts, labels = text_corpus(seed, TEXT_DOCS)
    when = dt.datetime(2003, 3, 1, tzinfo=dt.timezone.utc)
    t = time.perf_counter()
    storage.get_levents().insert_batch([
        Event(event="$set", entity_type="doc", entity_id=f"d{j}",
              properties={"text": x, "label": lb}, event_time=when)
        for j, (x, lb) in enumerate(zip(texts, labels))], app_id)
    write_s = time.perf_counter() - t
    losses: list = []
    trainer = teng._train_embedding_lr

    def logged(*args, **kwargs):
        return trainer(*args, losses=losses, **kwargs)

    teng._train_embedding_lr = logged
    try:
        trained = ot_train("textclassification", OT_FACTORY.format(
            "textclassification", "engine_factory"), {
            "datasource": {"params": {"appName": OT_APP + "Text"}},
            "preparator": {"params": {"vocabSize": 4096, "maxTokens": 64}},
            "algorithms": [{"name": "lr", "params": {
                "embeddingDim": 64, "epochs": 30, "batchSize": 128,
                "seed": seed}}]}, keep_pd=True)
    finally:
        teng._train_embedding_lr = trainer
    if not losses or losses[-1] >= losses[0]:
        raise AssertionError(f"the text trainer's loss did not fall: "
                             f"{losses}")
    from predictionio_tpu_torch.workflow import core_workflow
    from predictionio_tpu_torch.data.storage import get_model_data_models

    model = core_workflow.deserialize_models(
        get_model_data_models().get(trained["id"]).models)[0]
    held, held_labels = text_corpus(seed + 1, TEXT_HELD)
    ids, mask = teng.encode_texts(held, model.vocab_size, model.max_tokens)
    pred = np.asarray(model.labels)[model.predict_scores(ids, mask)
                                     .argmax(axis=1)]
    accuracy = float((pred == np.asarray(held_labels)).mean())
    _, counts = np.unique(held_labels, return_counts=True)
    majority = float(counts.max() / len(held_labels))
    print(f"[templates] textclassification: {TEXT_DOCS:,} documents "
          f"written in {write_s:.2f} s; loss by epoch {losses[0]!r} -> "
          f"{losses[-1]!r} over {len(losses)} epochs; held-out accuracy "
          f"{accuracy!r} on {TEXT_HELD:,} documents (majority class "
          f"{majority!r})")
    if accuracy <= majority:
        raise AssertionError(f"held-out accuracy {accuracy} does not beat "
                             f"the majority class {majority}")
    # one epoch on the card and on the CPU from one init and permutations
    pd = trained.pop("pd")
    params = teng.TextLRParams(embedding_dim=64, epochs=1, batch_size=128,
                               seed=seed)
    n = len(pd.label_codes)
    _, pad, _ = teng.lr_batch_layout(n, params.batch_size)
    init = teng.lr_init(pd.vocab_size, len(pd.labels), params)
    perms = teng.lr_permutations(n + pad, params)
    runs = {}
    for where in ("cuda", "cpu"):
        t = time.perf_counter()
        runs[where] = teng._train_embedding_lr(
            pd.token_ids, pd.mask, pd.label_codes, len(pd.labels),
            pd.vocab_size, params, device=where, init=init, perms=perms)
        runs[where + "_s"] = time.perf_counter() - t
    gaps = {name: float(np.abs(g - c).max() / np.abs(c).max())
            for name, g, c in zip(("E", "W", "b"), runs["cuda"],
                                  runs["cpu"])}
    whole = float(max(np.abs(a - b).max() for a, b in zip(
        runs["cuda"], runs["cpu"])))
    print(f"[templates] one epoch of the text trainer, card "
          f"({runs['cuda_s']:.2f} s) vs CPU ({runs['cpu_s']:.2f} s) from one "
          f"init and one permutation: largest |difference| over each "
          f"tensor's largest entry {gaps} (limit {OT_TEXT_TOL}); the run's "
          f"largest |difference| {whole!r}")
    if max(gaps.values()) > OT_TEXT_TOL:
        raise AssertionError(f"the text trainer's epoch on the card differs "
                             f"from the CPU's: {gaps}")
    held_queries = [{"text": x} for x in held[:OT_QUERIES]]
    return {"training": trained, "losses": [losses[0], losses[-1]],
            "accuracy": accuracy, "majority": majority, "epoch_gap": gaps,
            "epoch_gap_abs": whole, "queries": held_queries,
            "write_s": write_s}


def ot_small_fixtures(work: str, seed: int, app_id: int) -> dict:
    """classification, regression, friendrecommendation and helloworld,
    each on a small fixture: ``{template: (variant, factory, queries)}``."""
    import datetime as dt
    import os

    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.event import Event

    rng = np.random.default_rng(seed + 19)
    when = dt.datetime(2003, 3, 1, tzinfo=dt.timezone.utc)
    events = []
    for u in range(300):
        label = u % 3
        feats = rng.integers(0, 5, 3) + 6 * (np.arange(3) == label)
        events.append(Event(event="$set", entity_type="user",
                            entity_id=f"p{u}", properties={
                                "plan": float(label),
                                **{f"attr{a}": float(feats[a])
                                   for a in range(3)}}, event_time=when))
    storage.get_levents().insert_batch(events, app_id)
    X = rng.normal(size=(500, 4))
    y = X @ np.asarray([1.5, -2.0, 0.5, 3.0]) + rng.normal(0, 0.01, 500)
    lr_path = os.path.join(work, "lr_data.txt")
    with open(lr_path, "w") as f:
        f.write("\n".join(f"{yi!r} " + " ".join(repr(v) for v in row)
                          for yi, row in zip(y.tolist(), X.tolist())))
    days = ["Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun"]
    hello = os.path.join(work, "data.csv")
    with open(hello, "w") as f:
        f.write("".join(f"{days[j % 7]},{60 + int(rng.integers(0, 30))}\n"
                        for j in range(700)))
    paths = {n: os.path.join(work, n) for n in ("item.txt", "user.txt",
                                                "act.txt")}
    with open(paths["item.txt"], "w") as f:
        f.write("".join(f"{100 + i} c{i % 5} " + ";".join(
            str(k) for k in rng.choice(50, 4, replace=False)) + "\n"
            for i in range(200)))
    with open(paths["user.txt"], "w") as f:
        f.write("".join(f"{u} " + ";".join(
            f"{k}:{rng.random():.3f}" for k in rng.choice(50, 5,
                                                          replace=False))
            + "\n" for u in range(300)))
    with open(paths["act.txt"], "w") as f:
        f.write("".join(f"{int(rng.integers(0, 300))} "
                        f"{int(rng.integers(0, 300))} 1 2 3\n"
                        for _ in range(1_000)))
    return {
        "classification": ({
            "datasource": {"params": {"appName": OT_APP + "Text"}},
            "algorithms": [{"name": "naive", "params": {"lambda": 1.0}}]},
            OT_FACTORY.format("classification", "engine_factory"),
            [{"features": [float(v) for v in rng.integers(0, 11, 3)]}
             for _ in range(OT_QUERIES)]),
        "regression": ({
            "datasource": {"params": {"filepath": lr_path}},
            "preparator": {"params": {"n": 5, "k": 1}}},
            OT_FACTORY.format("regression", "engine_factory"),
            [{"features": rng.normal(size=4).tolist()}
             for _ in range(OT_QUERIES)]),
        "friendrecommendation": ({
            "datasource": {"params": {
                "itemFilePath": paths["item.txt"],
                "userKeywordFilePath": paths["user.txt"],
                "userActionFilePath": paths["act.txt"]}}},
            OT_FACTORY.format("friendrecommendation", "engine_factory"),
            [{"user": int(rng.integers(0, 310)),
              "item": int(rng.integers(100, 300))}
             for _ in range(OT_QUERIES)]),
        "helloworld": ({"datasource": {"params": {"dataPath": hello}}},
                       OT_FACTORY.format("helloworld", "engine_factory"),
                       [{"day": days[j % 7]} for j in range(OT_QUERIES)]),
    }


def ot_queries(store: dict, seed: int) -> dict:
    """The ALS templates' 50 queries each: similarproduct's plain, category,
    year-floor, white- and black-list item queries; DIMSUM's item and
    category queries; ecommerce's user queries (5 of unknown users)."""
    rng = np.random.default_rng(seed + 23)
    genres = sorted({g for c in store["cats"].values() for g in c})

    def items(n):
        return [f"i{i}" for i in rng.choice(ML1M_ITEMS, n, replace=False)]

    similar = []
    for j in range(OT_QUERIES):
        q = {"items": items(1 + j % 3), "num": 10}
        kind = j % 5
        if kind == 1:
            q["categories"] = [str(rng.choice(genres))]
        elif kind == 2:
            q["recommendFromYear"] = int(rng.integers(1960, 1995))
        elif kind == 3:
            q["whiteList"] = items(200)
        elif kind == 4:
            q["blackList"] = items(20)
        similar.append(q)
    dimsum = [{"items": items(1 + j % 2), "num": 10,
               **({"categories": [str(rng.choice(genres))]} if j % 2 else {})}
              for j in range(OT_QUERIES)]
    ecomm = [{"user": f"u{int(rng.integers(0, ML1M_USERS))}", "num": 10,
              **({"categories": [str(rng.choice(genres))]} if j % 4 == 1
                 else {})} for j in range(OT_QUERIES - 5)]
    ecomm += [{"user": f"stranger{j}", "num": 10} for j in range(5)]
    return {"similarproduct": similar, "similarproduct-dimsum": dimsum,
            "ecommercerecommendation": ecomm}


def unavailable_check(app_id: int, user: str, seed: int):
    """After deploy: a new ``constraint/unavailableItems`` ``$set`` (the
    user's current top 10 among its 50 items) must drop those items
    from the user's next answer."""
    def check(base: str, dep) -> dict:
        import datetime as dt

        from predictionio_tpu_torch.data import storage
        from predictionio_tpu_torch.data.event import Event

        q = {"user": user, "num": 10}
        _, before, _ = post(base + "/queries.json", q)
        top = [s["item"] for s in before["itemScores"]]
        rng = np.random.default_rng(seed + 29)
        gone = top + [f"i{i}" for i in rng.choice(
            ML1M_ITEMS, OT_UNAVAILABLE - len(top), replace=False)]
        storage.get_levents().insert(Event(
            event="$set", entity_type="constraint",
            entity_id="unavailableItems", properties={"items": gone},
            event_time=dt.datetime.now(tz=dt.timezone.utc)), app_id)
        _, after, _ = post(base + "/queries.json", q)
        kept = {s["item"] for s in after["itemScores"]} & set(gone)
        print(f"[templates] ecommercerecommendation: a new unavailableItems "
              f"$set of {len(gone)} items (the top {len(top)} of {user}'s "
              f"answer among them) posted after deploy: the next answer "
              f"holds {len(after['itemScores'])} items, {len(kept)} of them "
              f"unavailable")
        if not top or kept or not after["itemScores"]:
            raise AssertionError(f"unavailable items still served: {kept} "
                                 f"(before {top})")
        return {"unavailable_after_deploy": len(gone)}
    return check


def resolve_device_cuda():
    from predictionio_tpu_torch.device import resolve_device

    return resolve_device(None)


class TemplatesChild:
    """Phase 6e as ``chip_smoke.py --templates-child``, a process started
    beside phases 6b-6d: its output goes to a file (a pipe could fill and
    block it) and is printed, with the phase's own seconds, when
    :meth:`result` has waited for it."""

    def __init__(self, seed: int):
        import tempfile

        self.log = tempfile.NamedTemporaryFile(
            "w+", prefix="pio-templates-", suffix=".log")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, __file__, "--templates-child", "--seed",
             str(seed)], stdout=self.log, stderr=subprocess.STDOUT,
            text=True)

    def result(self) -> dict:
        t = time.perf_counter()
        code = self.proc.wait(timeout=900)
        waited = time.perf_counter() - t
        self.log.seek(0)
        lines = self.log.read().splitlines()
        for line in lines[:-1]:
            print(line)
        if code != 0 or not lines or not lines[-1].startswith(
                '{"templates"'):
            raise AssertionError(f"phase 6e's process exited {code}: "
                                 + "\n".join(lines[-30:]))
        out = json.loads(lines[-1])["templates"]
        print(f"[templates] phase 6e took {out['phase_s']:.1f} s in a "
              f"process of its own beside phases 6b-6d, which waited "
              f"{waited:.1f} s more for it")
        return out

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self.log.close()


def other_templates(dev, seed: int, card: str) -> dict:
    """Phase 6e: the other templates at ML-1M on the card (see the
    module docstring)."""
    import os
    import tempfile

    import torch

    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.storage.base import App

    work = tempfile.mkdtemp(prefix="pio-templates-")
    storage.reset(storage.StorageConfig(
        sources={"S": {"type": "sqlite",
                       "path": os.path.join(work, "pio.db")}},
        repositories={r: "S" for r in storage.REPOSITORIES}))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        app_id = storage.get_metadata_apps().insert(App(0, OT_APP))
        text_app = storage.get_metadata_apps().insert(App(0, OT_APP + "Text"))
        storage.get_levents().init(text_app)
        shop = ot_store(seed, app_id)
        print(f"[templates] store: {shop['views']:,} views "
              f"({len(shop['rows']):,} ratings, 1% viewed twice), "
              f"{shop['buys']:,} buys, {ML1M_USERS:,} user and "
              f"{ML1M_ITEMS:,} item $set events, an unavailableItems $set of "
              f"{OT_UNAVAILABLE} items, written in {shop['write_s']:.2f} s")
        ds = {"appName": OT_APP}
        trained, errs = {}, {}
        with ALSCapture() as cap:
            trained["similarproduct"] = ot_train(
                "similarproduct", OT_FACTORY.format("similarproduct",
                                                    "engine_factory"),
                {"datasource": {"params": ds},
                 "algorithms": [{"name": "als", "params": OT_ALS}]})
            trained["ecommercerecommendation"] = ot_train(
                "ecommercerecommendation", OT_FACTORY.format(
                    "ecommercerecommendation", "engine_factory"),
                {"datasource": {"params": ds},
                 "algorithms": [{"name": "als", "params": {
                     "appName": OT_APP, "unseenOnly": True, **OT_ALS}}]})
        if len(cap.calls) != 2:
            raise AssertionError(f"{len(cap.calls)} ALS trainings captured")
        planned = 2 * OT_ALS["numIterations"]
        for (name, res), call in zip(list(trained.items()), cap.calls):
            for kernel, n in res["launches"].items():
                if n != planned:
                    raise AssertionError(
                        f"{name}: {kernel} launched {n} times, the uniform "
                        f"route plans {planned}")
            errs[name] = plain_als_check(dev, call, name)
        uniform = uniform_timings(dev, cap.calls[0])
        trained["similarproduct-dimsum"] = ot_train(
            "similarproduct-dimsum", OT_FACTORY.format(
                "similarproduct", "engine_factory_dimsum"),
            {"datasource": {"params": ds},
             "algorithms": [{"name": "dimsum", "params": {"threshold": 0.0}}]})
        from predictionio_tpu_torch.workflow import core_workflow

        dimsum_model = core_workflow.deserialize_models(
            storage.get_model_data_models().get(
                trained["similarproduct-dimsum"]["id"]).models)[0]
        dimsum_err = dimsum_oracle_check(dimsum_model, shop, seed)
        del dimsum_model
        text = ot_text(dev, seed, text_app)
        trained["textclassification"] = text["training"]
        small = ot_small_fixtures(work, seed, text_app)
        for name, (variant, factory, _) in small.items():
            trained[name] = ot_train(name, factory, variant)
        queries = ot_queries(shop, seed)
        queries["textclassification"] = text["queries"]
        queries.update({k: v[2] for k, v in small.items()})
        served = {}
        for name, res in trained.items():
            after = unavailable_check(app_id, queries[name][0]["user"], seed) \
                if name == "ecommercerecommendation" else None
            served[name] = ot_serve(name, res["id"], queries[name], after)
        peak = torch.cuda.max_memory_allocated()
        phase_s = time.perf_counter() - t0
        print(f"[templates] device memory peak {peak / 2**20:.1f} MiB; phase "
              f"6e took {phase_s:.1f} s ({card})")
        return {"trainings": {k: {key: v[key] for key in (
                    "read_s", "prepare_s", "train_s", "s", "launches")}
                    for k, v in trained.items()},
                "served": served, "als_vs_plain": errs,
                "dimsum_err": dimsum_err, "uniform": uniform,
                "text": {k: text[k] for k in (
                    "losses", "accuracy", "majority", "epoch_gap",
                    "epoch_gap_abs", "write_s")},
                "write_s": shop["write_s"], "peak_bytes": peak,
                "planned_launches": planned, "phase_s": phase_s}
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


# -- phases 3e and 3f: sequential recommendation and two-stage serving -------

# the widths of bench.py's seqrec training lane (seqrec_train_bench)
SEQ_PARAMS = dict(rank=64, n_layers=2, n_heads=4, max_seq_len=64,
                  num_steps=1000, batch_size=256, n_negatives=128)
SEQ_CHECK_USERS = 256     # users whose card encode is held to the CPU's
SEQ_ENCODE_TOL = 1e-4     # of the largest entry of a user's vector
SEQ_BURST = 512           # user queries from SEQ_CLIENTS threads
SEQ_CLIENTS = 8
SEQ_FOLD_USERS = 8        # users given new events under fold-in
SEQ_FOLD_NEW = 3          # new events each
SEQ_FOLD_DEADLINE = 60.0  # seconds for every fold to land
TWO_MAX_LEN = 2_048       # the rating tables' padding cap (PERF.md §4)
TWO_CANDIDATES = 128      # TwoStageTopK's default N
# B = 8: the uid bucket each two-lane dispatch of phase 3f runs at
TWO_ROUTE_BATCHES = (1, 8, 256)
SEQ_FOLD_APP = "SeqFold"


def seqrec_params(seed: int):
    from predictionio_tpu_torch.ops.seqrec import SeqRecParams

    return SeqRecParams(**SEQ_PARAMS, seed=seed)


class SeqrecTrainProbe:
    """While entered, times the trainer and the encode that
    ``SeqRecAlgorithm.train`` calls (through the template module's
    names) and keeps the trainer's loss trace."""

    def __enter__(self) -> "SeqrecTrainProbe":
        from predictionio_tpu_torch.templates.sequentialrec import (
            engine as seng,
        )

        self.spans: dict = {}
        self.losses = None
        self._mod = seng
        self._saved = (seng.train_seqrec, seng.encode_users)
        seng.train_seqrec = self._timed("train", self._saved[0])
        seng.encode_users = self._timed("encode", self._saved[1])
        return self

    def _timed(self, name: str, fn):
        import torch

        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.spans[name] = time.perf_counter() - t
            if name == "train":
                self.losses = out[1]
            return out
        return run

    def __exit__(self, *exc) -> None:
        self._mod.train_seqrec, self._mod.encode_users = self._saved


def sequence_read_train(dev, seed: int) -> dict:
    """Phase 3e's training: phase 5's store through ``SequenceDataSource``
    (``rate`` events, 1,000,000-event blocks), ``SequencePreparator``
    (``max_seq_len`` 64) and ``SeqRecAlgorithm.train`` at
    ``SEQ_PARAMS``; the loss must fall and 256 users' card vectors must
    equal the port's CPU encode."""
    import torch

    from predictionio_tpu_torch.core.context import ComputeContext
    from predictionio_tpu_torch.ops import seqrec
    from predictionio_tpu_torch.templates.sequentialrec import (
        engine as seng,
    )

    ctx = ComputeContext()
    t0 = time.perf_counter()
    td = seng.SequenceDataSource(seng.DataSourceParams(
        app_name=ML20M_APP, event_names=("rate",),
        streaming_block_size=ML20M_PART,
        decode_prefetch=ML20M_PREFETCH)).read_training(ctx)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pd = seng.SequencePreparator(seng.SeqPreparatorParams(
        max_seq_len=SEQ_PARAMS["max_seq_len"])).prepare(ctx, td)
    prepare_s = time.perf_counter() - t0
    params = seqrec_params(seed)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    with SeqrecTrainProbe() as probe:
        model = seng.SeqRecAlgorithm(params).train(ctx, pd)
    spans, losses = probe.spans, probe.losses
    peak = torch.cuda.max_memory_allocated() - base_mem
    tokens = seqrec.training_tokens(pd.buckets, params)
    head, tail = float(losses[:20].mean()), float(losses[-20:].mean())
    lens = np.asarray([len(s) for s in pd.seen.values()])
    print(f"[seqrec] read {len(td)} events in {read_s:.2f} s, prepared "
          f"{len(pd.user_map)} users x {len(pd.item_map)} items in "
          f"{prepare_s:.2f} s (buckets {[b.ids.shape for b in pd.buckets]}, "
          f"seen mean {lens.mean():.1f})")
    print(f"[seqrec] train {spans['train']:.2f} s ({len(losses)} steps, "
          f"{tokens} tokens: {tokens / spans['train']:.0f} tokens/s), "
          f"encode {spans['encode']:.2f} s; loss first {losses[0]!r} last "
          f"{losses[-1]!r} (first 20 {head!r}, last 20 {tail!r}); peak "
          f"device memory {peak} bytes")
    if not (losses[-1] < losses[0] and tail < head):
        raise AssertionError(f"the seqrec loss did not fall: {losses[:3]} "
                             f"... {losses[-3:]}")
    if not np.isfinite(model.user_vectors).all():
        raise AssertionError("non-finite user vectors")
    # (check) sampled users' card vectors against the CPU encode
    rng = np.random.default_rng(seed + 31)
    worst = 0.0
    for bucket in pd.buckets:
        take = np.sort(rng.choice(len(bucket), size=min(
            len(bucket), max(1, SEQ_CHECK_USERS * len(bucket)
                             // len(pd.user_map) + 1)), replace=False))
        sub = seqrec.SequenceBucket(bucket.rows[take], bucket.ids[take],
                                    bucket.mask[take])
        cpu = seqrec.encode_bucket(model.theta, sub, params, device="cpu")
        card = model.user_vectors[sub.rows]
        scale = np.maximum(np.abs(cpu).max(axis=1, keepdims=True), 1.0)
        worst = max(worst, float((np.abs(card - cpu) / scale).max()))
    print(f"[seqrec] card encode == CPU encode within {worst!r} of the "
          f"largest entry (limit {SEQ_ENCODE_TOL})")
    if not worst <= SEQ_ENCODE_TOL:
        raise AssertionError(f"card encode differs by {worst!r}")
    return {"td": td, "pd": pd, "model": model, "read_s": read_s,
            "prepare_s": prepare_s, "train_s": spans["train"],
            "encode_s": spans["encode"], "tokens": tokens,
            "tokens_per_s": tokens / spans["train"],
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "peak_bytes": int(peak), "encode_err": worst}


def sequence_read_paths(seed: int) -> dict:
    """Phase 3e's read of phase 5's store two ways, each followed by
    ``SequencePreparator``: ``SequenceDataSource``'s streamed read, which
    indexes block by block, and the same blocks materialized into label
    columns, which the preparator indexes by ``np.unique`` of the whole
    columns as strings (the JAX package's read). Prints the read and
    prepare seconds of each; the two preparations must be equal (maps,
    buckets and seen lists)."""
    from predictionio_tpu_torch.core.context import ComputeContext
    from predictionio_tpu_torch.data.store import PEventStore
    from predictionio_tpu_torch.templates.sequentialrec import (
        engine as seng,
    )

    ctx = ComputeContext()
    prep = seng.SequencePreparator(seng.SeqPreparatorParams(
        max_seq_len=SEQ_PARAMS["max_seq_len"]))
    out, pds = {}, {}
    t0 = time.perf_counter()
    td = seng.SequenceDataSource(seng.DataSourceParams(
        app_name=ML20M_APP, event_names=("rate",),
        streaming_block_size=ML20M_PART,
        decode_prefetch=ML20M_PREFETCH)).read_training(ctx)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pds["blocks"] = prep.prepare(ctx, td)
    out["blocks"] = {"read_s": read_s,
                     "prepare_s": time.perf_counter() - t0}
    del td
    t0 = time.perf_counter()
    cols = ([], [], [])
    for block in PEventStore.find_columnar_blocks(
            block_size=ML20M_PART, prefetch=ML20M_PREFETCH,
            app_name=ML20M_APP, channel_name=None, entity_type="user",
            event_names=["rate"], target_entity_type="item",
            value_property=None, default_value=1.0, until_time=None):
        block = block.materialize()
        for col, x in zip(cols, (block.entity_ids, block.target_ids,
                                 block.event_times)):
            col.append(x)
    users, items, times = (np.concatenate(c) for c in cols)
    keep = np.fromiter((x is not None for x in items), dtype=bool,
                       count=len(items))
    td = seng.SequenceTrainingData(users[keep], items[keep], times[keep])
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pds["columns"] = prep.prepare(ctx, td)
    out["columns"] = {"read_s": read_s,
                      "prepare_s": time.perf_counter() - t0}
    a, b = pds["blocks"], pds["columns"]
    same = (np.array_equal(a.user_map.labels, b.user_map.labels)
            and np.array_equal(a.item_map.labels, b.item_map.labels)
            and len(a.buckets) == len(b.buckets)
            and all(np.array_equal(getattr(x, f), getattr(y, f))
                    for x, y in zip(a.buckets, b.buckets)
                    for f in ("rows", "ids", "mask"))
            and a.seen.keys() == b.seen.keys()
            and all(np.array_equal(a.seen[u], b.seen[u]) for u in a.seen))
    print(f"[seqrec] read paths of {len(td)} events: indexed block by "
          f"block {out['blocks']}, label columns and np.unique "
          f"{out['columns']}; preparations equal: {same}")
    if not same:
        raise AssertionError("the two read paths prepare differently")
    return out


def twostage_train(dev, seed: int, seq: dict) -> dict:
    """Phase 3f's training: the ``twostage`` engine's preparator
    (``max_seq_len`` 64, ``max_len`` 2,048) on phase 3e's read, then its
    ALS half (rank 64, 3 iterations: B3 and B2) and its seqrec half at
    ``SEQ_PARAMS``."""
    from predictionio_tpu_torch.core.context import ComputeContext
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops.als import ALSParams
    from predictionio_tpu_torch.templates.twostage import engine as teng

    ctx = ComputeContext()
    t0 = time.perf_counter()
    pd = teng.TwoStagePreparator(teng.TwoStagePreparatorParams(
        max_seq_len=SEQ_PARAMS["max_seq_len"],
        max_len=TWO_MAX_LEN)).prepare(ctx, seq["td"])
    prepare_s = time.perf_counter() - t0
    als_params = ALSParams(rank=RANK, num_iterations=ITERATIONS,
                           lambda_=LAMBDA, alpha=ALPHA, seed=seed)
    als_cuda.assemble_launches.reset()
    als_cuda.spd_launches.reset()
    t0 = time.perf_counter()
    als = teng.TwoStageALSAlgorithm(als_params).train(ctx, pd)
    als_s = time.perf_counter() - t0
    launches = {"assemble_normal_equations": als_cuda.assemble_launches.value,
                "spd_solve": als_cuda.spd_launches.value}
    if not all(launches.values()):
        raise AssertionError(f"the ALS half launched {launches}")
    t0 = time.perf_counter()
    with SeqrecTrainProbe() as probe:
        rerank = teng.TwoStageSeqRecAlgorithm(seqrec_params(seed)).train(
            ctx, pd)
    seq_s = time.perf_counter() - t0
    losses = probe.losses
    if not losses[-20:].mean() < losses[:20].mean():
        raise AssertionError("the re-ranker's loss did not fall")
    if als.user_map is not rerank.user_map:
        raise AssertionError("the two halves do not share one user map")
    u = pd.ratings.user_side
    print(f"[twostage] prepare {prepare_s:.2f} s (user side "
          f"{tuple(u.cols.shape)}, item side "
          f"{tuple(pd.ratings.item_side.cols.shape)}); ALS {als_s:.2f} s "
          f"({launches}); seqrec {seq_s:.2f} s (loss {losses[0]!r} -> "
          f"{losses[-1]!r})")
    return {"pd": pd, "als": als, "rerank": rerank, "als_params": als_params,
            "prepare_s": prepare_s, "als_s": als_s, "seq_s": seq_s,
            "launches": launches}


def fold_histories(ratings: tuple, users: np.ndarray) -> dict:
    """``users``' ratings in phase 5's event order (the order the
    training read saw them): ``{user: [(item, stars), ...]}``."""
    rows, cols, values, order = ratings
    pos = np.empty(len(order), dtype=np.int64)
    pos[order] = np.arange(len(order))
    out = {}
    for u in users:
        idx = np.flatnonzero(rows == u)
        idx = idx[np.argsort(pos[idx])]
        out[int(u)] = list(zip(cols[idx].tolist(), values[idx].tolist()))
    return out


def fold_store(histories: dict) -> int:
    """A memory event store holding ``histories`` as ``rate`` events, one
    second apart in order (the fold-in gather reads them in event-time
    order); returns the app id."""
    import datetime as dt

    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.event import Event
    from predictionio_tpu_torch.data.storage.base import App

    storage.reset(storage.StorageConfig(
        sources={"M": {"type": "memory"}},
        repositories={r: "M" for r in ("METADATA", "EVENTDATA",
                                       "MODELDATA")}))
    app_id = storage.get_metadata_apps().insert(App(0, SEQ_FOLD_APP))
    t0 = dt.datetime(2020, 1, 1, tzinfo=dt.timezone.utc)
    events = [Event(event="rate", entity_type="user", entity_id=f"u{u}",
                    target_entity_type="item", target_entity_id=f"i{c}",
                    properties={"rating": float(v)},
                    event_time=t0 + dt.timedelta(seconds=j))
              for u, hist in histories.items()
              for j, (c, v) in enumerate(hist)]
    storage.get_levents().init(app_id)
    storage.get_levents().insert_batch(events, app_id)
    return app_id


def post_fold_events(app_id: int, histories: dict, rng) -> dict:
    """``SEQ_FOLD_NEW`` new ratings for each user (items it never rated),
    later than its history; returns each user's new items."""
    import datetime as dt

    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.event import Event

    t0 = dt.datetime(2021, 1, 1, tzinfo=dt.timezone.utc)
    new, events = {}, []
    for u, hist in histories.items():
        had = {c for c, _ in hist}
        items = [int(i) for i in rng.permutation(M_ITEMS)
                 if int(i) not in had][:SEQ_FOLD_NEW]
        new[u] = items
        events += [Event(event="rate", entity_type="user", entity_id=f"u{u}",
                         target_entity_type="item", target_entity_id=f"i{i}",
                         properties={"rating": 4.0},
                         event_time=t0 + dt.timedelta(seconds=j))
                   for j, i in enumerate(items)]
    storage.get_levents().insert_batch(events, app_id)
    return new


def wait_folds(consumer, users: int) -> float:
    """Seconds until every target of ``consumer`` patched ``users``
    users with nothing pending."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < SEQ_FOLD_DEADLINE:
        st = consumer.stats()
        targets = st.get("targets", [st])
        if all(t["usersPatched"] >= users and t["pendingEvents"] == 0
               for t in targets):
            return time.perf_counter() - t0
        time.sleep(0.05)
    raise AssertionError(f"the folds did not land in {SEQ_FOLD_DEADLINE} "
                         f"s: {consumer.stats()}")


def reencode_rows(model, consumer, names: list) -> tuple:
    """The re-encode the fold should have written, on the CPU: the
    consumer's own gather of ``names`` through the model's fold hook on a
    CPU copy of θ; and the rows' indices."""
    import dataclasses

    kept, cols_list, vals_list = consumer._gather(names)
    if kept != names:
        raise AssertionError(f"gathered {kept}, expected {names}")
    cpu = dataclasses.replace(model, device="cpu", _server=None)
    return (cpu.fold_in_rows(cols_list, vals_list),
            [model.user_map[n] for n in names])


def rows_within(stored: np.ndarray, want: np.ndarray, what: str) -> float:
    """Stored (bf16) rows against fp32 ``want`` rows: within
    ``FOLDIN_ROW_TOL`` of each row's largest entry."""
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1e-30)
    rel = float((np.abs(stored - want) / scale).max())
    if not rel <= FOLDIN_ROW_TOL:
        raise AssertionError(f"{what}: stored rows differ from the plain "
                             f"ones by {rel!r} of their largest entry")
    return rel


def sequence_queries(rng, n_users: int) -> tuple:
    """43 sequential queries (30 users, 5 with a blacklist, 4 by items,
    2 deep, 2 unknown users) and ``SEQ_BURST`` user queries."""
    users = [f"u{u}" for u in rng.integers(0, n_users, 41)]
    seq = [{"user": u, "num": 10} for u in users[:30]]
    seq += [{"user": u, "num": 10,
             "blacklist": [f"i{i}" for i in rng.integers(0, 500, 3)]}
            for u in users[30:35]]
    seq += [{"items": [f"i{i}" for i in rng.integers(0, M_ITEMS, n)],
             "num": 10} for n in (1, 2, 3, 5)]
    seq += [{"user": u, "num": 50} for u in users[35:37]]
    seq += [{"user": "no-such-user", "num": 10},
            {"user": "nobody-either", "num": 10}]
    many = [{"user": f"u{u}", "num": 10}
            for u in rng.integers(0, n_users, SEQ_BURST)]
    return seq, many


def serve_and_check(dep, model, queries: list, many: list,
                    store=None, after=None) -> dict:
    """A ``QueryServer`` over ``dep``: the sequential queries, then the
    burst from ``SEQ_CLIENTS`` threads; every answer against the plain
    pipeline. Returns the latencies, B1's launches by (route, k, B) and
    ``store``'s lane counters read just before and just after the
    queries (after the deploy's warm-up, before the plain pipeline's own
    dispatches), and what ``after()`` returns, called while the server
    still serves (its stop closes the store's micro-batcher)."""
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.workflow.create_server import (
        QueryServer,
        ServerConfig,
    )

    server = QueryServer(ServerConfig(ip="127.0.0.1", port=0), dep).start()
    try:
        host, port = server.address
        base = f"http://{host}:{port}"
        # after the deploy's warm-up, whose sacrificial queries ride the
        # store's lanes too
        lanes0 = store.stats() if store is not None else None
        als_cuda.launches.reset()
        answers = [(q, *post(base + "/queries.json", q)) for q in queries]
        t0 = time.perf_counter()
        in_burst = burst(base, many, SEQ_CLIENTS)
        burst_s = time.perf_counter() - t0
        launches = dict(als_cuda.launches.by_key())
        lanes = store.stats() if store is not None else None
        stages = list(getattr(store, "stage_times", ()))
        if not launches:
            raise AssertionError("the serving kernel never launched")
        checked = check_against_plain(model, answers + in_burst)
        done = after() if after is not None else None
    finally:
        server.stop()
    lat = np.asarray([a[3] for a in answers]) * 1e3
    return {"checked": checked, "launches": launches, "lanes": lanes,
            "lanes0": lanes0, "stage_times": stages, "after": done,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "burst_qps": len(many) / burst_s}


def seqrec_serve(dev, seq: dict, ratings: tuple, seed: int) -> dict:
    """Phase 3e's serving: the trained model deployed (bf16 store) behind
    a ``QueryServer``; 43 sequential queries and a 512-query burst, each
    answer equal to the plain pipeline's (B1's plain version). Then
    fold-in: ``SEQ_FOLD_USERS`` users' histories (phase 5's events) in a
    memory store, the model deployed with fold-in on, ``SEQ_FOLD_NEW`` new
    ratings each: every stored row must equal the plain re-encode of its
    user's history on the CPU, and every user's answer must change."""
    import os

    import torch

    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.templates.sequentialrec import (
        engine as seng,
    )
    from predictionio_tpu_torch.workflow.create_server import (
        QueryServer,
        ServerConfig,
        deployment_from_models,
    )

    model = seq["model"]
    engine = seng.engine_factory()
    variant = {"datasource": {"params": {"appName": SEQ_FOLD_APP,
                                         "eventNames": ["rate"]}},
               "preparator": {"params": {"maxSeqLen":
                                         SEQ_PARAMS["max_seq_len"]}},
               "algorithms": [{"name": "seqrec", "params": {}}]}
    params = engine.engine_params_from_variant(variant)
    t0 = time.perf_counter()
    dep = deployment_from_models(engine, params, [model])
    srv = model.device_server()
    srv.warmup()
    if srv.precision != "bf16":
        raise AssertionError(f"expected the bf16 store, got {srv.precision}")
    deploy_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 41)
    queries, many = sequence_queries(rng, len(model.user_map))
    served = serve_and_check(dep, model, queries, many)
    served.pop("lanes")
    served.pop("lanes0")
    served.pop("after")
    served.pop("stage_times")
    print(f"[seqrec] served {served['checked']} answers equal to plain "
          f"(store and warm-up {deploy_s:.2f} s; sequential p50 "
          f"{served['p50_ms']!r} ms p99 {served['p99_ms']!r} ms; burst "
          f"{served['burst_qps']!r} queries/s); B1 launches "
          f"{served['launches']}")
    # fold-in over a memory store of SEQ_FOLD_USERS users' histories
    srv.close()
    model._server = None
    torch.cuda.empty_cache()
    rows = ratings[0]
    lens = np.bincount(rows, minlength=N_USERS)
    users = rng.choice(np.flatnonzero(lens >= 12), size=SEQ_FOLD_USERS,
                       replace=False)
    hist = fold_histories(ratings, users)
    app_id = fold_store(hist)
    os.environ["PIO_FOLDIN_INTERVAL"] = "0.5"
    names = [f"u{u}" for u in hist]
    try:
        dep = deployment_from_models(engine, params, [model])
        server = QueryServer(ServerConfig(ip="127.0.0.1", port=0,
                                          foldin=True), dep).start()
        try:
            host, port = server.address
            base = f"http://{host}:{port}"
            before = {n: post(base + "/queries.json",
                              {"user": n, "num": 10})[1] for n in names}
            als_cuda.launches.reset()
            new = post_fold_events(app_id, hist, rng)
            fold_s = wait_folds(server._foldin, SEQ_FOLD_USERS)
            after = [({"user": n, "num": 10},
                      *post(base + "/queries.json", {"user": n, "num": 10}))
                     for n in names]
            fold_launches = dict(als_cuda.launches.by_key())
            want, uidx = reencode_rows(model, server._foldin, names)
            store = model.device_server()
            stored = store._X[torch.as_tensor(uidx, device=dev)
                              ].float().cpu().numpy()
            check_against_plain(model, after)
            folds = server._foldin.stats()["folds"]
        finally:
            server.stop()
    finally:
        os.environ.pop("PIO_FOLDIN_INTERVAL", None)
    rel = rows_within(stored, want, "seqrec fold-in")
    unchanged = [q["user"] for (q, _, body, _) in after
                 if body == before[q["user"]]]
    if unchanged:
        raise AssertionError(f"fold-in left {unchanged}'s answers as they "
                             "were")
    for (q, _, body, _) in after:
        u = int(q["user"][1:])
        got = {s["item"] for s in body["itemScores"]}
        if got & {f"i{i}" for i in new[u]}:
            raise AssertionError(f"{q['user']}'s new items are not masked")
    print(f"[seqrec] fold-in: {SEQ_FOLD_USERS} users x {SEQ_FOLD_NEW} new "
          f"events folded in {fold_s:.2f} s; rows == CPU re-encode within "
          f"{rel!r} of the largest entry; every answer changed and equals "
          f"plain; {folds} folds")
    model._server = None
    return {**served, "deploy_s": deploy_s, "fold_s": fold_s,
            "fold_rel": rel, "fold_launches": fold_launches}


def unmasked_route(dev, store) -> list:
    """B1's two-stage route on the store phase 3f deployed (its bf16 ALS
    item table): unmasked, k = ``TWO_CANDIDATES``, at B in
    ``TWO_ROUTE_BATCHES``; each against its plain version (values within
    the fp32 reordering allowance, ids at separated scores), then timed
    against plain, ``torch.topk`` of the product and its bound."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops.quantize import is_quantized

    Y, n = store._Y, store.n_items
    Ydq = Y.float()[:n] if not is_quantized(Y) else None
    per = Y.element_size()
    rng = np.random.default_rng(7)
    k = min(TWO_CANDIDATES, n)
    rows, worst = [], 0.0
    for B in TWO_ROUTE_BATCHES:
        uids = torch.as_tensor(rng.integers(0, store.n_users, B), device=dev)
        Q = store._X[uids].float()
        kv, ki = als_cuda.fused_gather_score_topk(Q, Y, None, None, k=k,
                                                  n_items=n, mask_seen=False)
        pv, pi = als_cuda.fused_gather_score_topk_plain(
            Q, Y, None, None, k=k + 1, n_items=n, mask_seen=False)
        tol = (RTOL * torch.linalg.vector_norm(Q, dim=1)
               * torch.linalg.vector_norm(Ydq, dim=1).max()).cpu().numpy()
        worst = max(worst, check_topk(kv.cpu().numpy(), ki.cpu().numpy(),
                                      pv.cpu().numpy(), pi.cpu().numpy(),
                                      tol, exact=False))

        def kernel():
            als_cuda.fused_gather_score_topk(Q, Y, None, None, k=k,
                                             n_items=n, mask_seen=False)

        def plain():
            als_cuda.fused_gather_score_topk_plain(
                Q, Y, None, None, k=k, n_items=n, mask_seen=False)

        def library():
            torch.topk(Q @ Ydq.T, k, dim=1)

        t_k, t_p, t_l = (time_ms(f, 20) for f in (kernel, plain, library))
        b_ms, b_by = bound_of(n * Q.shape[1] * per + B * Q.shape[1] * 4
                              + B * k * 8, 2.0 * B * n * Q.shape[1])
        rows.append({"store": "bf16", "B": B, "k": k, "mask_seen": False,
                     "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                     "bound_ms": b_ms, "bound_by": b_by})
        print(f"[twostage] B1 unmasked bf16 B={B} k={k}: kernel {t_k!r} ms "
              f"plain {t_p!r} ms torch.topk {t_l!r} ms bound {b_ms!r} ms "
              f"({b_by})")
    return rows, worst


def twostage_serve(dev, seq: dict, two: dict, ratings: tuple,
                   seed: int) -> dict:
    """Phase 3f's serving: the ``twostage`` engine's models deployed
    (``TwoStageServing`` bound to one ``TwoStageTopK``, N = 128, bf16);
    43 sequential queries and a 512-query burst, each answer equal to
    the plain pipeline (B1's plain version for stage 1, then the same
    re-rank); each batch one ``two``-lane dispatch (one B1 launch at k =
    N). Prints stage 2's CUDA-event time per dispatch beside B1's, and
    times B1's unmasked route. Then a composite fold-in of
    ``SEQ_FOLD_USERS`` users: the ALS rows equal the plain fold (both
    training kernels' plain versions), the stage-2 rows the CPU
    re-encode, and every answer changes."""
    import os

    import torch

    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops.als import fold_in_users
    from predictionio_tpu_torch.ops.twostage import TwoStageTopK
    from predictionio_tpu_torch.templates.twostage import engine as teng
    from predictionio_tpu_torch.workflow.create_server import (
        QueryServer,
        ServerConfig,
        deployment_from_models,
    )

    als, rerank = two["als"], two["rerank"]
    engine = teng.engine_factory()
    variant = {"datasource": {"params": {"appName": SEQ_FOLD_APP,
                                         "eventNames": ["rate"]}},
               "preparator": {"params": {
                   "maxSeqLen": SEQ_PARAMS["max_seq_len"],
                   "maxLen": TWO_MAX_LEN}},
               "algorithms": [{"name": "als", "params": {
                   "rank": RANK, "numIterations": ITERATIONS,
                   "lambda": LAMBDA, "alpha": ALPHA}},
                   {"name": "seqrec", "params": {}}]}
    params = engine.engine_params_from_variant(variant)
    t0 = time.perf_counter()
    dep = deployment_from_models(engine, params, [als, rerank])
    store = als.device_server().store
    if not (isinstance(store, TwoStageTopK) and dep.serving.fused_bound):
        raise AssertionError("the two-stage route was not bound")
    store.warmup()
    deploy_s = time.perf_counter() - t0
    if store.precision != "bf16" or store._n_bucket != TWO_CANDIDATES:
        raise AssertionError(f"store {store.precision}, N bucket "
                             f"{store._n_bucket}")
    rng = np.random.default_rng(seed + 43)
    queries, many = sequence_queries(rng, len(als.user_map))
    store.stage_times.clear()
    req0 = store.ladder_report()["requests"]
    served = serve_and_check(
        dep, als, queries, many, store=store,
        after=lambda: (store.ladder_report()["requests"],
                       ladder_two(store, "3f's two-stage store")))
    req1, ladder = served.pop("after")
    if req1["missJit"] != req0["missJit"] or req1["hit"] == req0["hit"]:
        raise AssertionError(f"3f's dispatches missed the ladder: {req0} -> "
                             f"{req1}")
    lanes, lanes0 = served.pop("lanes"), served.pop("lanes0")
    split = np.asarray(served.pop("stage_times"))
    two_dispatches = lanes["two"]["dispatches"] - lanes0["two"]["dispatches"]
    at_n = sum(c for (r, k, b), c in served["launches"].items()
               if k == TWO_CANDIDATES)
    users_lane = lanes["users"]["dispatches"] - lanes0["users"]["dispatches"]
    if at_n != two_dispatches or users_lane:
        raise AssertionError(f"{two_dispatches} two-lane dispatches, "
                             f"{at_n} B1 launches at k = N, {users_lane} "
                             "users-lane dispatches")
    b1_us, s2_us = (float(np.median(split[:, 0])),
                    float(np.median(split[:, 1]))) if len(split) else (
                        None, None)
    print(f"[twostage] served {served['checked']} answers equal to plain "
          f"(store and warm-up {deploy_s:.2f} s; sequential p50 "
          f"{served['p50_ms']!r} ms p99 {served['p99_ms']!r} ms; burst "
          f"{served['burst_qps']!r} queries/s); {two_dispatches} two-lane "
          f"dispatches, one B1 launch at k = {TWO_CANDIDATES} unmasked each; "
          f"launches {served['launches']}; per dispatch (median of "
          f"{len(split)}, CUDA events) B1's kernels {b1_us!r} us, stage 2 "
          f"{s2_us!r} us")
    route_rows, route_err = unmasked_route(dev, store)
    mem = store.memory_report()
    # the composite fold-in of both stages
    store.close()
    als._server = rerank._server = None
    torch.cuda.empty_cache()
    rows = ratings[0]
    lens = np.bincount(rows, minlength=N_USERS)
    users = rng.choice(np.flatnonzero(lens >= 12), size=SEQ_FOLD_USERS,
                       replace=False)
    hist = fold_histories(ratings, users)
    app_id = fold_store(hist)
    os.environ["PIO_FOLDIN_INTERVAL"] = "0.5"
    names = [f"u{u}" for u in hist]
    try:
        dep = deployment_from_models(engine, params, [als, rerank])
        server = QueryServer(ServerConfig(ip="127.0.0.1", port=0,
                                          foldin=True), dep).start()
        try:
            host, port = server.address
            base = f"http://{host}:{port}"
            before = {n: post(base + "/queries.json",
                              {"user": n, "num": 10})[1] for n in names}
            als_cuda.launches.reset()
            als_cuda.assemble_launches.reset()
            als_cuda.spd_launches.reset()
            post_fold_events(app_id, hist, rng)
            fold_s = wait_folds(server._foldin, SEQ_FOLD_USERS)
            after = [({"user": n, "num": 10},
                      *post(base + "/queries.json", {"user": n, "num": 10}))
                     for n in names]
            fold_launches = {
                "assemble_normal_equations":
                    als_cuda.assemble_launches.value,
                "spd_solve": als_cuda.spd_launches.value,
                "fused_gather_score_topk": als_cuda.launches.value}
            c_als, c_seq = server._foldin.consumers
            store = als.device_server().store
            uidx = torch.as_tensor([als.user_map[n] for n in names],
                                   device=dev)
            kept, cl, vl = c_als._gather(names)
            saved = (als_cuda.assemble_normal_equations, als_cuda.spd_solve)
            als_cuda.assemble_normal_equations = \
                als_cuda.assemble_normal_equations_plain
            als_cuda.spd_solve = als_cuda.spd_solve_plain
            try:
                plain = fold_in_users(store.item_factors, cl, vl,
                                      two["als_params"], max_len=TWO_MAX_LEN)
            finally:
                als_cuda.assemble_normal_equations, als_cuda.spd_solve = saved
            want_x = torch.from_numpy(plain).to(torch.bfloat16).float().numpy()
            stored_x = store._X[uidx].float().cpu().numpy()
            want_u, _ = reencode_rows(rerank, c_seq, names)
            stored_u = store._U[uidx].float().cpu().numpy()
            check_against_plain(als, after)
        finally:
            server.stop()
    finally:
        os.environ.pop("PIO_FOLDIN_INTERVAL", None)
    rel_x = rows_within(stored_x, want_x, "two-stage ALS fold")
    rel_u = rows_within(stored_u, want_u, "two-stage re-encode")
    unchanged = [q["user"] for (q, _, body, _) in after
                 if body == before[q["user"]]]
    if unchanged:
        raise AssertionError(f"fold-in left {unchanged}'s answers as they "
                             "were")
    if not (fold_launches["assemble_normal_equations"]
            and fold_launches["spd_solve"]):
        raise AssertionError(f"the ALS fold launched {fold_launches}")
    print(f"[twostage] composite fold-in: {SEQ_FOLD_USERS} users in "
          f"{fold_s:.2f} s; ALS rows == plain fold within {rel_x!r}, "
          f"stage-2 rows == CPU re-encode within {rel_u!r}; every answer "
          f"changed and equals plain; launches {fold_launches}")
    als._server = rerank._server = None
    return {**served, "deploy_s": deploy_s,
            "two_dispatches": two_dispatches, "b1_us": b1_us,
            "stage2_us": s2_us, "route": route_rows, "ladder": ladder,
            "ladder_hits": req1["hit"] - req0["hit"],
            "route_err": route_err, "store_bytes": mem["totalBytes"],
            "fold_s": fold_s, "fold_rel": [rel_x, rel_u],
            "fold_launches": fold_launches}


# -- phase 7's sequence half --------------------------------------------------

SEQ_Q_SHAPE = (200, 100, 4, 24)    # users, items, lengths (bench_quality)
SEQ_Q_STEPS, SEQ_Q_RANK, SEQ_Q_SEED = 400, 32, 11
SEQ_Q_ALS_ITERATIONS = 10          # bench_quality's ITERATIONS


def markov_walks(seed: int) -> tuple:
    """``bench_quality.run_seqrec_check``'s stream: per-user walks item ->
    (item + stride) % M with a stride of 1, 3 or 7; the held-out item is
    each walk's next."""
    n_users, n_items, min_len, max_len = SEQ_Q_SHAPE
    rng = np.random.default_rng(seed)
    seqs, nxt = [], []
    for _ in range(n_users):
        start = int(rng.integers(0, n_items))
        stride = int((1, 3, 7)[rng.integers(0, 3)])
        n = int(rng.integers(min_len, max_len))
        walk = (start + stride * np.arange(n + 1)) % n_items
        seqs.append(walk[:-1].astype(np.int64))
        nxt.append(int(walk[-1]))
    return seqs, nxt


SEQ_REPLAY_STEPS = 48      # steps of the card-against-CPU replay
# Limits of the card's training against the CPU's on one θ and one set of
# draws, each set between readings (PERF.md §6; NVIDIA H100 80GB HBM3):
# above the largest sound gap (the card's against the CPU's: loss 1.8e-4,
# encodes 0.013; the CPU's fp32 run against an fp64 replay of it: 4.6e-4,
# 0.028-0.0375), below a control whose θ is rounded to bf16 before each
# step (2.3e-3, 0.093). Adam's m/√v turns gradients that are rounding
# noise into lr-sized steps, so 48 steps amplify any rounding; one step
# from one θ does not, and its limits sit far from both (sound: loss
# 8.6e-8, gradients 9.5e-7; bf16: 9.7e-6, 0.059).
SEQ_TRAJ_LOSS_REL = 1e-3   # the loss traces, relative, step by step
SEQ_TRAJ_ENCODE_REL = 0.06  # the users' encodes, of the largest entry
SEQ_STEP_LOSS_REL = 1e-6   # one step's loss, relative
SEQ_STEP_GRAD_REL = 1e-5   # one step's gradients, of each tensor's largest


def replay_training(buckets, plan, draws, theta0: dict, p, dev, dtype,
                    bf16: bool = False) -> tuple:
    """``train_seqrec``'s steps written out in ``dtype`` on ``dev``, on
    the given draws: ``loss_and_grads`` and ``adam_update_``, per bucket
    Adam afresh. ``bf16`` rounds θ to bf16 before each step's loss (the
    control a limit must catch). Returns (θ as fp32 numpy, losses)."""
    import torch

    from predictionio_tpu_torch.ops import seqrec

    keys = list(theta0)
    vals = [torch.tensor(theta0[k], dtype=dtype, device=dev) for k in keys]
    losses = []
    for (b, (steps, _)), (sels, negss) in zip(zip(buckets, plan), draws):
        ids = torch.from_numpy(b.ids).to(dev)
        mask = torch.from_numpy(b.mask).to(device=dev, dtype=dtype)
        m = [torch.zeros_like(x) for x in vals]
        v = [torch.zeros_like(x) for x in vals]
        t = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(steps):
            sel = torch.as_tensor(sels[s], device=dev)
            th = dict(zip(keys, vals))
            if bf16:
                th = {k: x.to(torch.bfloat16).to(dtype) for k, x in th.items()}
            value, g = seqrec.loss_and_grads(
                th, ids[sel], mask[sel], torch.as_tensor(negss[s], device=dev),
                n_layers=p.n_layers, n_heads=p.n_heads, l2=p.l2)
            seqrec.adam_update_(vals, m, v, t, [g[k] for k in keys],
                                p.learning_rate)
            losses.append(float(value))
    return ({k: x.float().cpu().numpy() for k, x in zip(keys, vals)},
            np.asarray(losses))


def card_training_check(dev, buckets, n_items: int, params) -> dict:
    """``train_seqrec`` on the card against the CPU, on one θ and one set
    of row and negative draws (``SEQ_REPLAY_STEPS`` steps):

    (a) one step from one θ (the start and the CPU's trained θ, the last
        bucket's first draw): the card's loss and gradients against the
        CPU's within ``SEQ_STEP_*``, and a step on θ rounded to bf16
        outside them;
    (b) the whole run, CUDA-graph steps after the first
        ``GRAPH_WARMUP_STEPS`` of each bucket: the loss traces and the
        users' encodes (all encoded on the CPU) within ``SEQ_TRAJ_*`` of
        the CPU's; the CPU's own fp32 run against an fp64 replay inside
        them and the bf16 control outside them, so each run shows the
        limits between what rounding does and what a fault does;
    (c) the same run with every step eager on the card: the loss traces
        within 1e-5 relative and the encodes within 1e-4 of the graphed.

    θ's largest differences are printed, not held: Adam turns a gradient
    that is zero but for rounding (the key projection along the LayerNorm
    bias, which the softmax cancels) into lr-sized steps whose sign the
    rounding picks, so θ can differ where the model's function does not;
    the loss and the encodes are what it computes."""
    import dataclasses

    import torch

    from predictionio_tpu_torch.ops import seqrec

    cpu = torch.device("cpu")
    p = dataclasses.replace(params, num_steps=SEQ_REPLAY_STEPS)
    plan = seqrec.plan_steps(buckets, p)
    if min(steps for steps, _ in plan) <= seqrec.GRAPH_WARMUP_STEPS + 1:
        raise AssertionError(f"a bucket too short to capture: {plan}")
    rng = np.random.default_rng(5)
    draws = [(rng.integers(0, len(b), (steps, bs)),
              rng.integers(0, n_items, (steps, p.n_negatives)))
             for b, (steps, bs) in zip(buckets, plan)]
    theta0 = seqrec.init_theta(n_items, p)
    runs = {"card": seqrec.train_seqrec(buckets, n_items, p, theta=theta0,
                                        device=dev, draws=draws),
            "cpu": seqrec.train_seqrec(buckets, n_items, p, theta=theta0,
                                       device=cpu, draws=draws)}
    saved = seqrec.GRAPH_WARMUP_STEPS
    seqrec.GRAPH_WARMUP_STEPS = SEQ_REPLAY_STEPS
    try:
        runs["card eager"] = seqrec.train_seqrec(
            buckets, n_items, p, theta=theta0, device=dev, draws=draws)
    finally:
        seqrec.GRAPH_WARMUP_STEPS = saved
    runs["fp64"] = replay_training(buckets, plan, draws, theta0, p, cpu,
                                   torch.float64)
    runs["bf16"] = replay_training(buckets, plan, draws, theta0, p, dev,
                                   torch.float32, bf16=True)
    n_users = max(int(b.rows.max()) for b in buckets) + 1
    enc = {name: seqrec.encode_users(th, buckets, n_users, p, device=cpu)
           for name, (th, _) in runs.items()}

    def gap(a: str, b: str) -> dict:
        (tha, la), (thb, lb) = runs[a], runs[b]
        return {"loss_rel": float(np.max(np.abs(la - lb) / np.abs(lb))),
                "encode_rel": float(np.abs(enc[a] - enc[b]).max()
                                    / max(np.abs(enc[b]).max(), 1e-30)),
                "theta_rel": max(float(np.abs(tha[k] - thb[k]).max()
                                       / max(np.abs(thb[k]).max(), 1e-30))
                                 for k in thb)}

    traj = {"card_vs_cpu": gap("card", "cpu"),
            "card_eager_vs_cpu": gap("card eager", "cpu"),
            "cpu_vs_fp64": gap("cpu", "fp64"),
            "bf16_vs_cpu": gap("bf16", "cpu"),
            "graphed_vs_eager": gap("card", "card eager")}
    # (a) one step from one θ, card against CPU
    b, (sels, negss) = buckets[-1], draws[-1]
    sel = torch.as_tensor(sels[0])

    def one_step(theta, device, bf16=False):
        th = seqrec.theta_to_device(theta, device)
        if bf16:
            th = {k: x.to(torch.bfloat16).float() for k, x in th.items()}
        value, g = seqrec.loss_and_grads(
            th, torch.from_numpy(b.ids)[sel].to(device),
            torch.from_numpy(b.mask)[sel].to(device),
            torch.as_tensor(negss[0], device=device),
            n_layers=p.n_layers, n_heads=p.n_heads, l2=p.l2)
        return float(value), {k: x.cpu().numpy() for k, x in g.items()}

    def step_gap(theta, bf16=False) -> dict:
        lc, gc = one_step(theta, cpu)
        ld, gd = one_step(theta, dev, bf16)
        return {"loss_rel": abs(ld - lc) / abs(lc),
                "grad_rel": max(float(np.abs(gd[k] - gc[k]).max()
                                      / max(np.abs(gc[k]).max(), 1e-30))
                                for k in gc)}

    step = {"start": step_gap(theta0), "trained": step_gap(runs["cpu"][0]),
            "bf16_start": step_gap(theta0, True),
            "bf16_trained": step_gap(runs["cpu"][0], True)}
    print(f"[quality] seqrec training on the card against the CPU, "
          f"{SEQ_REPLAY_STEPS} steps on one θ and one set of draws (plan "
          f"{plan}; CUDA-graph steps after {saved} a bucket): "
          f"{json.dumps(traj)}; one step from one θ: {json.dumps(step)}")
    lim = {"loss_rel": SEQ_TRAJ_LOSS_REL, "encode_rel": SEQ_TRAJ_ENCODE_REL}
    for name in ("card_vs_cpu", "card_eager_vs_cpu", "cpu_vs_fp64"):
        if not all(traj[name][k] <= lim[k] for k in lim):
            raise AssertionError(f"seqrec training {name} outside {lim}: "
                                 f"{traj[name]}")
    if not all(traj["bf16_vs_cpu"][k] > lim[k] for k in lim):
        raise AssertionError(f"the bf16 control is inside {lim}: "
                             f"{traj['bf16_vs_cpu']}")
    slim = {"loss_rel": SEQ_STEP_LOSS_REL, "grad_rel": SEQ_STEP_GRAD_REL}
    for name in ("start", "trained"):
        if not all(step[name][k] <= slim[k] for k in slim):
            raise AssertionError(f"one seqrec step from the {name} θ on the "
                                 f"card outside {slim}: {step[name]}")
        if not all(step["bf16_" + name][k] > slim[k] for k in slim):
            raise AssertionError(f"the bf16 step control is inside {slim}: "
                                 f"{step['bf16_' + name]}")
    gve = traj["graphed_vs_eager"]
    if not (gve["loss_rel"] <= 1e-5 and gve["encode_rel"] <= 1e-4):
        raise AssertionError(f"the graphed training differs from the eager: "
                             f"{gve}")
    return {"trajectory": traj, "step": step}


def sequence_quality(dev) -> dict:
    """Phase 7's sequence half, the protocols of
    ``bench_quality.run_seqrec_check`` and ``run_twostage_check`` on the
    card: the seqrec encoder trained on the Markov walks (the loss must
    fall; its Precision@10 of the held-out next item among unseen items
    must beat popularity's), and ALS (rank 32, 10 iterations) retrieving
    for it through ``TwoStageTopK`` at N = the catalog on an fp32 store:
    the two-stage NDCG@10 must reach max(ALS alone, seqrec alone)."""
    import os

    from predictionio_tpu_torch.data.sliding import ndcg_at_k as ndcg
    from predictionio_tpu_torch.ops import als as als_mod
    from predictionio_tpu_torch.ops import seqrec
    from predictionio_tpu_torch.ops.twostage import TwoStageTopK

    n_users, n_items, _, max_len = SEQ_Q_SHAPE
    k = K_EVAL
    seqs, nxt = markov_walks(SEQ_Q_SEED)
    params = seqrec.SeqRecParams(
        rank=SEQ_Q_RANK, n_layers=2, n_heads=2, max_seq_len=max_len,
        num_steps=SEQ_Q_STEPS, batch_size=64, n_negatives=64,
        learning_rate=0.005, seed=SEQ_Q_SEED)
    buckets = seqrec.bucket_sequences(seqs, max_len=max_len)
    replay = card_training_check(dev, buckets, n_items, params)
    theta, losses = seqrec.train_seqrec(buckets, n_items, params, device=dev)
    U = seqrec.encode_users(theta, buckets, n_users, params, device=dev)
    E = theta["item_emb"]
    head, tail = float(losses[:20].mean()), float(losses[-20:].mean())
    seen = {u: np.unique(seqs[u]) for u in range(n_users)}
    pop = np.bincount(np.concatenate(seqs), minlength=n_items)
    pop_order = np.argsort(-pop).tolist()

    def single(Uf, Ef):
        hits, total = 0, 0.0
        for u in range(n_users):
            s = Ef @ Uf[u]
            s[seen[u]] = -np.inf
            top = np.argpartition(-s, k)[:k]
            top = top[np.argsort(-s[top], kind="stable")]
            hits += nxt[u] in set(top.tolist())
            total += ndcg(top.tolist(), {nxt[u]}, k)
        return hits / (k * n_users), total / n_users

    p_seq, ndcg_seq = single(U, E)
    pop_hits = 0
    for u in range(n_users):
        top = [i for i in pop_order if i not in set(seen[u].tolist())][:k]
        pop_hits += nxt[u] in top
    p_pop = pop_hits / (k * n_users)
    # ALS on the walks' (user, item) set
    rows = np.concatenate([np.full(len(s), u) for u, s in enumerate(seqs)])
    cols = np.concatenate(seqs)
    uniq = np.unique(rows * n_items + cols)
    rows, cols = uniq // n_items, uniq % n_items
    vals = np.ones(len(rows), dtype=np.float32)
    X, Y = als_mod.train_als(
        als_mod.pad_ratings(rows, cols, vals, n_users, n_items),
        als_mod.pad_ratings(cols, rows, vals, n_items, n_users),
        als_mod.ALSParams(rank=SEQ_Q_RANK, num_iterations=SEQ_Q_ALS_ITERATIONS,
                          lambda_=LAMBDA, alpha=ALPHA, seed=3), dev)
    _, ndcg_als = single(X, Y)
    out_two = {}
    for mode in ("fp32", "bf16"):
        os.environ["PIO_SERVE_PRECISION"] = mode
        try:
            store = TwoStageTopK(X, Y, U, E, seen=seen, candidates=n_items,
                                 microbatch=False)
            ids, _ = store.twos_topk(np.arange(n_users), k)
            store.close()
        finally:
            os.environ.pop("PIO_SERVE_PRECISION", None)
        out_two[mode] = sum(ndcg(ids[u].tolist(), {nxt[u]}, k)
                            for u in range(n_users)) / n_users
    out = {"loss_first20_mean": head, "loss_last20_mean": tail,
           "seqrec_precision_at_10": p_seq, "seqrec_ndcg_at_10": ndcg_seq,
           "popularity_precision_at_10": p_pop,
           "ndcg_two_stage": out_two["fp32"],
           "ndcg_two_stage_bf16": out_two["bf16"],
           "ndcg_als_alone": ndcg_als, "ndcg_seqrec_alone": ndcg_seq,
           "card_vs_cpu": replay}
    print(f"[quality] sequences: {json.dumps(out)}")
    if not tail < head:
        raise AssertionError(f"the seqrec loss did not fall: {head} -> {tail}")
    if not p_seq > p_pop:
        raise AssertionError(f"seqrec P@10 {p_seq} does not beat popularity "
                             f"{p_pop}")
    if not out_two["fp32"] >= max(ndcg_als, ndcg_seq) - 1e-9:
        raise AssertionError(f"two-stage NDCG@10 {out_two['fp32']} is below "
                             f"max(ALS {ndcg_als}, seqrec {ndcg_seq})")
    return out


def sequence_summary(seq: dict, two: dict, seq_served: dict,
                     two_served: dict, seq_quality: dict) -> dict:
    """Phases 3e, 3f and 7's sequence half in one JSON-able dict."""
    def launches(served):
        return {"total": sum(served["launches"].values()),
                "by_route": routes_of(served["launches"]),
                "by_k": {str(k): sum(c for (_, kk, _), c
                                     in served["launches"].items() if kk == k)
                         for k in sorted({kk for _, kk, _
                                          in served["launches"]})}}

    keep = ("read_s", "prepare_s", "train_s", "encode_s", "tokens",
            "tokens_per_s", "loss_first", "loss_last", "peak_bytes",
            "encode_err")
    return {
        "seqrec": {**{k: seq[k] for k in keep},
                   **{k: seq_served[k] for k in (
                       "p50_ms", "p99_ms", "burst_qps", "deploy_s",
                       "fold_s", "fold_rel")}},
        "twostage": {**{k: two[k] for k in ("prepare_s", "als_s", "seq_s")},
                     **{k: two_served[k] for k in (
                         "p50_ms", "p99_ms", "burst_qps", "deploy_s",
                         "two_dispatches", "b1_us", "stage2_us",
                         "store_bytes", "fold_s", "fold_rel", "route_err")},
                     "training_launches": two["launches"],
                     "fold_launches": two_served["fold_launches"]},
        "b1_launches": {"3e": launches(seq_served),
                        "3f": launches(two_served),
                        "3e_fold": sum(seq_served["fold_launches"].values())},
        "unmasked_k128": two_served["route"],
        "quality": seq_quality}


# phase 8a: where the host lane and the device store cross over
CROSS_ITEMS = (3_706, 4_096, 8_192, 16_384, 26_744, 32_768, 65_536, 262_144)
CROSS_USERS = 2_048       # users of each synthetic fp32 model
CROSS_SEEN = 20           # seen items each
CROSS_SEQ = 100           # sequential user queries, each lane and round
CROSS_BURST = 320         # user queries from CROSS_CLIENTS threads, each lane
                          # and round (two rounds, the lanes in turns)
CROSS_CLIENTS = 8
CROSS_K = 10
CROSS_RTOL = 1e-5         # host scores against the device store's, relative
CROSS_BATCH_ITEMS = (3_706, 16_384)  # ML-1M width and the limit's own size
CROSS_BATCH_USERS = 6_040  # uids of one users_topk call (ML-1M's users)


def lane_readings(lane, users: np.ndarray, burst_users: np.ndarray) -> tuple:
    """``lane.user_topk`` for each user in turn (p50 / p99 ms), then
    ``burst_users`` from ``CROSS_CLIENTS`` threads (queries/s). Returns
    ``(reading, answers of the sequential queries)``."""
    import concurrent.futures

    lane.user_topk(int(users[0]), CROSS_K)
    lat, answers = [], []
    for u in users:
        t = time.perf_counter()
        answers.append(lane.user_topk(int(u), CROSS_K))
        lat.append((time.perf_counter() - t) * 1e3)
    chunks = np.array_split(burst_users, CROSS_CLIENTS)

    def client(part):
        for u in part:
            lane.user_topk(int(u), CROSS_K)

    with concurrent.futures.ThreadPoolExecutor(CROSS_CLIENTS) as pool:
        t = time.perf_counter()
        list(pool.map(client, chunks))
        wall = time.perf_counter() - t
    return ({"p50_ms": float(np.percentile(lat, 50)),
             "p99_ms": float(np.percentile(lat, 99)),
             "qps": len(burst_users) / wall}, answers)


def batch_lane_reading(host, device, rng, m: int) -> dict:
    """One ``users_topk`` call of ``CROSS_BATCH_USERS`` uids on each
    lane (the device store warmed at that batch first), wall ms; the
    two answers must agree as the sequential ones do."""
    from predictionio_tpu_torch.ops.serving import HOST_SERVE_MAX_ELEMS

    uids = rng.integers(0, CROSS_USERS, CROSS_BATCH_USERS)
    device.users_topk(uids, CROSS_K)
    t = time.perf_counter()
    hi, hs = host.users_topk(uids, CROSS_K)
    host_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    di, ds = device.users_topk(uids, CROSS_K)
    device_ms = (time.perf_counter() - t) * 1e3
    if not (np.array_equal(hi, di) and np.allclose(
            hs, ds, rtol=CROSS_RTOL, atol=0)):
        raise AssertionError(f"{m} items: the batch lanes disagree")
    auto = "host" if m * RANK <= HOST_SERVE_MAX_ELEMS else "device"
    print(f"[crossover] batch lane, users_topk of {CROSS_BATCH_USERS} "
          f"uids at {m} items ({m * RANK} elements; auto serves it from "
          f"the {auto} lane): host {host_ms!r} ms, device {device_ms!r} ms")
    return {"users": CROSS_BATCH_USERS, "host_ms": host_ms,
            "device_ms": device_ms, "auto": auto}


def host_crossover(dev, seed: int, card: str) -> dict:
    """Phase 8a: ``HostTopK.user_topk`` against ``DeviceTopK.user_topk``
    (the deploy defaults: micro-batched, its 2 ms window) on synthetic
    fp32 factors at rank 64 and each of ``CROSS_ITEMS`` items, read two
    ways: ``CROSS_SEQ`` sequential queries (p50 / p99) and
    ``CROSS_BURST`` from ``CROSS_CLIENTS`` threads (queries/s), two
    rounds with the lanes in turns, each reading the rounds' mean. Every
    sequential answer must agree between the lanes (same ids, scores
    within ``CROSS_RTOL``; normal draws have no exact ties). Prints the
    table and the largest power of two of item-factor elements up to
    which the host lane was no slower in both readings, beside
    ``HOST_SERVE_MAX_ELEMS``. At ``CROSS_BATCH_ITEMS`` it also times the
    batch lane (``users_topk`` of ``CROSS_BATCH_USERS`` uids, what
    ``pio batchpredict`` hands the store a chunk at a time), once a
    lane, the answers held equal. Does not fail on timing."""
    import os

    from predictionio_tpu_torch.ops import serving as serving_mod

    rng = np.random.default_rng(seed + 80)
    X = rng.normal(size=(CROSS_USERS, RANK)).astype(np.float32)
    prior = os.environ.get("PIO_SERVE_PRECISION")
    # an fp32 store, so the device lane's scores are the host lane's
    os.environ["PIO_SERVE_PRECISION"] = "fp32"
    rows = []
    try:
        for m in CROSS_ITEMS:
            Y = rng.normal(size=(m, RANK)).astype(np.float32)
            seen = {u: rng.choice(m, CROSS_SEEN, replace=False)
                    for u in range(CROSS_USERS)}
            users = rng.integers(0, CROSS_USERS, CROSS_SEQ)
            burst_users = rng.integers(0, CROSS_USERS, CROSS_BURST)
            host = serving_mod.HostTopK(X, Y, seen)
            device = serving_mod.DeviceTopK(X, Y, seen, device=dev)
            device.warmup()
            try:
                # two rounds, the lanes in turns, averaged: a reading
                # taken while the host is busy elsewhere hits both lanes
                rounds = [lane_readings(lane, users, burst_users)
                          for _ in range(2) for lane in (host, device)]
            finally:
                device.close()
            h, d = ({key: float(np.mean([r[0][key] for r in rounds[i::2]]))
                     for key in rounds[0][0]} for i in (0, 1))
            h_ans, d_ans = rounds[0][1], rounds[1][1]
            for u, (hi, hs), (di, ds) in zip(users, h_ans, d_ans):
                if not (np.array_equal(hi, di) and np.allclose(
                        hs, ds, rtol=CROSS_RTOL, atol=0)):
                    raise AssertionError(
                        f"{m} items, user {u}: host {hi} {hs} against "
                        f"device {di} {ds}")
            row = {"items": m, "elems": m * RANK, "host": h, "device": d,
                   "host_no_slower": bool(h["p50_ms"] <= d["p50_ms"]
                                          and h["qps"] >= d["qps"])}
            rows.append(row)
            print(f"[crossover] {m:>7} items ({m * RANK:>10} elements): "
                  f"host p50 {h['p50_ms']!r} p99 {h['p99_ms']!r} ms "
                  f"{h['qps']!r} q/s; device p50 {d['p50_ms']!r} p99 "
                  f"{d['p99_ms']!r} ms {d['qps']!r} q/s; host no slower: "
                  f"{row['host_no_slower']}")
            if m in CROSS_BATCH_ITEMS:
                row["batch"] = batch_lane_reading(host, device, rng, m)
            del host, device, Y, seen
    finally:
        if prior is None:
            os.environ.pop("PIO_SERVE_PRECISION", None)
        else:
            os.environ["PIO_SERVE_PRECISION"] = prior
    # the host lane's run from the smallest size on, and the largest
    # power of two of elements inside it
    ok = 0
    for row in rows:
        if not row["host_no_slower"]:
            break
        ok = row["elems"]
    supported = 1 << (ok.bit_length() - 1) if ok else 0
    print(f"[crossover] the host lane is no slower up to {ok} elements: "
          f"the reading supports HOST_SERVE_MAX_ELEMS = {supported}; the "
          f"port's is {serving_mod.HOST_SERVE_MAX_ELEMS} ({card})")
    return {"rows": rows, "supported_limit": supported,
            "limit": serving_mod.HOST_SERVE_MAX_ELEMS}


# phase 8b: sharded serving on the card
SHARDS = 4
SHARD_BURST = 256         # user queries from SHARD_CLIENTS threads
SHARD_CLIENTS = 8
SHARD_FOLD_USERS = 8      # new users folded into both stores
SHARD_TIME_BATCHES = (1, 256)


def results_agree(got, want, q: dict, bound: float,
                  by_set: bool = False) -> None:
    """Two answers (``PredictedResult``) to ``q``: the same items with
    scores within ``RTOL`` of the query's largest reachable score (an id
    may differ only inside a near tie); with ``by_set`` only the sorted
    scores are held (tie order follows store positions)."""
    gv = np.asarray([s.score for s in got.item_scores], np.float32)
    wv = np.asarray([s.score for s in want.item_scores], np.float32)
    if len(gv) != len(wv):
        raise AssertionError(f"{q}: {len(gv)} results against {len(wv)}")
    if not len(gv):
        return
    tol = np.asarray([RTOL * bound], np.float32)
    if by_set:
        gv, wv = np.sort(gv)[::-1], np.sort(wv)[::-1]
        if (np.abs(gv - wv) > RTOL * np.abs(wv) + tol[0]).any():
            raise AssertionError(f"{q}: scores {gv} against {wv}")
        return
    ids = {s.item: j for j, s in enumerate(want.item_scores)}
    ki = np.asarray([[ids.get(s.item, len(wv) + 1 + j)
                      for j, s in enumerate(got.item_scores)]])
    check_topk(gv[None, :], ki, np.append(wv, -np.inf)[None, :],
               np.arange(len(wv) + 1)[None, :], tol, exact=False)


def query_bound(model, q: dict, x_norm: np.ndarray, y_norm: float) -> float:
    if "items" in q:
        return 1.01 * len(q["items"])
    if q.get("user") in model.user_map:
        return 1.01 * x_norm[model.user_map[q["user"]]] * y_norm
    return 0.0


def sharded_timings(dev, srv, model) -> list:
    """B1's sharded route at k=16 on the sharded store's blocks, B = 1
    and 256 users: one shard's launch, a whole dispatch (every shard's
    launch and the merge), its plain version, and the library's (each
    shard's seen hits, its block widened to fp32, the masked product and
    ``torch.topk``, then ``torch.topk`` of the joined lists); the bound
    of the dispatch's work."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops import serving as serving_mod

    rows = []
    b1 = b1_kernel_names()
    shards = srv._shards
    m = int(shards[0].valid.shape[0])
    n_pos = m * len(shards)
    rng = np.random.default_rng(7)
    for B in SHARD_TIME_BATCHES:
        u = torch.from_numpy(rng.integers(0, srv.n_users, B)).to(dev)
        Q = serving_mod._gather_rows_f32(srv._X, u)
        scq, smq = srv._seen_cols[u], srv._seen_mask[u]
        sh0 = shards[0]
        inside = (scq >= 0) & (scq < m) & (smq > 0)
        lc = torch.where(inside, scq, torch.full_like(scq, -1)).T
        lm = inside.T.float()

        def one_shard():
            als_cuda.fused_gather_score_topk(
                Q, sh0.Y, lc, lm, k=16, n_items=m, row_valid=sh0.valid)

        def dispatch():
            serving_mod._sharded_score_topk(shards, Q, scq, smq, k=16,
                                            mask_seen=True)

        def plain():
            serving_mod.fused_gather_score_topk = \
                als_cuda.fused_gather_score_topk_plain
            try:
                dispatch()
            finally:
                serving_mod.fused_gather_score_topk = \
                    als_cuda.fused_gather_score_topk

        def library():
            # the same work as a dispatch: each shard's seen hits and
            # its widened block are found inside the timed call
            vals, idx = [], []
            for sh in shards:
                hb, hc = ((smq > 0) & (scq >= sh.offset)
                          & (scq < sh.offset + m)).nonzero(as_tuple=True)
                s = torch.matmul(Q, sh.Y.float().T)
                s[:, sh.valid <= 0] = float("-inf")
                s[hb, scq[hb, hc].long() - sh.offset] = float("-inf")
                v, i = torch.topk(s, 16, dim=1)
                vals.append(v)
                idx.append(i + sh.offset)
            v, sel = torch.topk(torch.cat(vals, 1), 16, dim=1)
            torch.gather(torch.cat(idx, 1), 1, sel)

        t_one, t_k, t_p, t_l = (time_ms(f, 20) for f in
                                (one_shard, dispatch, plain, library))
        # the card's share of an event-timed call: the profiler's busy
        # time a call, and B1's kernels' time in it
        device = {}
        for label, fn in (("shard", one_shard), ("dispatch", dispatch)):
            _, busy, _, by_name = device_busy(
                lambda: [fn() for _ in range(20)])
            device[label] = {"busy_ms": busy / 20, "b1_ms": sum(
                ms for name, ms in by_name.items() if name in b1) / 20}
        L = int(scq.shape[1])
        nbytes = (n_pos * RANK * 2 + n_pos * 4 + B * RANK * 4 + L * B * 8
                  + B * 16 * 8 * (len(shards) + 1))
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = 2.0 * B * n_pos * RANK / H100_FP32_FLOPS * 1e3
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops \
            else (t_ops, "operations")
        row = {"store": "bf16", "B": B, "k": 16, "shards": len(shards),
               "positions_per_shard": m, "shard_ms": t_one, "ms": t_k,
               "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
               "bound_by": b_by, "device": device}
        rows.append(row)
        print(f"[sharded] B={B:<3} k=16: one shard's launch {t_one!r} ms "
              f"(card busy {device['shard']['busy_ms']!r}, B1 "
              f"{device['shard']['b1_ms']!r}), dispatch ({len(shards)} "
              f"launches + merge) {t_k!r} ms (card busy "
              f"{device['dispatch']['busy_ms']!r}, B1 "
              f"{device['dispatch']['b1_ms']!r}), plain {t_p!r} ms, library "
              f"{t_l!r} ms, bound {b_ms!r} ms ({b_by})")
    return rows


def sharded_serving(dev, trained: dict, seed: int, card: str) -> dict:
    """Phase 8b: phase 5's model served through a ``SHARDS``-shard
    density-aware layout on ``[dev] * SHARDS`` (bf16, the card's
    default store): every shard is the card and launches B1 on its own
    block. (a) Phase 3's 43 sequential queries and ``SHARD_BURST`` user
    queries from ``SHARD_CLIENTS`` threads, through the template's
    predict, agree with the plain sharded lane on the CPU (same store,
    ``["cpu"] * SHARDS``: the same items; positions follow from the one
    layout) and, as score sets, with the unsharded device store; B1
    launches ``SHARDS`` times a dispatch. (b) ``SHARD_FOLD_USERS`` new
    users folded (B3 + B2 against each store's item view) and patched
    into the sharded and the unsharded store, the sharded one growing by
    a reshard: the folded rows equal, their answers equal as score sets.
    (c) A one-rank NCCL process group (``initialize`` with a 127.0.0.1
    coordinator, an all-reduce, ``shutdown``). Then B1's sharded route is
    timed. Any disagreement raises."""
    import concurrent.futures
    import dataclasses
    import os
    import socket

    import torch

    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops import serving as serving_mod
    from predictionio_tpu_torch.ops.als import ALSParams, fold_in_users
    from predictionio_tpu_torch.parallel import distributed
    from predictionio_tpu_torch.templates.recommendation.engine import (
        ALSAlgorithm,
        Query,
    )

    model = trained["model"]
    X, Y, seen = model.user_factors, model.item_factors, model.seen
    t0 = time.perf_counter()
    sharded = serving_mod.DeviceTopK(X, Y, seen, device=[dev] * SHARDS,
                                     shards=SHARDS)
    single = serving_mod.DeviceTopK(X, Y, seen, device=dev)
    prior = os.environ.get("PIO_SERVE_PRECISION")
    os.environ["PIO_SERVE_PRECISION"] = "bf16"
    try:
        cpu = serving_mod.DeviceTopK(X, Y, seen, device=["cpu"] * SHARDS,
                                     shards=SHARDS, microbatch=False)
    finally:
        if prior is None:
            os.environ.pop("PIO_SERVE_PRECISION", None)
        else:
            os.environ["PIO_SERVE_PRECISION"] = prior
    build_s = time.perf_counter() - t0
    if sharded.shard_count != SHARDS or sharded.precision != "bf16":
        raise AssertionError(f"sharded store: {sharded.shard_count} shards, "
                             f"{sharded.precision}")
    if not np.array_equal(sharded.item_layout.perm, cpu.item_layout.perm):
        raise AssertionError("the card's and the CPU's layouts differ")
    balance = sharded.item_layout.balance_report()
    print(f"[sharded] stores built in {build_s:.1f} s; layout {balance}; "
          f"{sharded.memory_report()['shards']}")
    views = {name: dataclasses.replace(model, _server=srv) for name, srv in
             (("sharded", sharded), ("single", single), ("cpu", cpu))}
    algo = ALSAlgorithm()
    queries, _ = phase3_queries(seed)
    rng = np.random.default_rng(seed + 81)
    burst = [{"user": f"u{u}", "num": 10}
             for u in rng.integers(0, N_USERS, SHARD_BURST)]

    def ask(view, q):
        return algo.predict(view, Query(**{
            k: tuple(v) if isinstance(v, list) else v for k, v in q.items()}))

    calls = []
    launch = sharded._sharded_launch

    def counted(*args):
        calls.append(1)
        return launch(*args)

    sharded._sharded_launch = counted
    als_cuda.launches.reset()
    t = time.perf_counter()
    got_seq = [ask(views["sharded"], q) for q in queries]
    seq_s = time.perf_counter() - t
    with concurrent.futures.ThreadPoolExecutor(SHARD_CLIENTS) as pool:
        t = time.perf_counter()
        got_burst = list(pool.map(lambda q: ask(views["sharded"], q), burst))
        burst_s = time.perf_counter() - t
    launches = als_cuda.launches.value
    by_key = als_cuda.launches.by_key()
    dispatches = len(calls)
    del sharded._sharded_launch
    if not dispatches or launches != SHARDS * dispatches:
        raise AssertionError(f"B1 launched {launches} times over "
                             f"{dispatches} sharded dispatches")
    print(f"[sharded] {len(queries)} sequential queries {seq_s:.3f} s, "
          f"{SHARD_BURST} from {SHARD_CLIENTS} threads {burst_s:.3f} s "
          f"({SHARD_BURST / burst_s!r} q/s); B1 launched {launches} times "
          f"over {dispatches} dispatches ({by_key})")
    x_norm = np.linalg.norm(X, axis=1)
    y_norm = float(np.linalg.norm(Y, axis=1).max())
    checked = 0
    for q, got in zip(queries + burst, got_seq + got_burst):
        bound = query_bound(model, q, x_norm, y_norm)
        results_agree(got, ask(views["cpu"], q), q, bound)
        results_agree(got, ask(views["single"], q), q, bound, by_set=True)
        checked += 1
    print(f"[sharded] {checked} answers agree with the CPU's plain sharded "
          f"lane and, as score sets, with the unsharded store")

    # (b) fold new users into both stores; the sharded one reshards
    frng = np.random.default_rng(seed + 82)
    n0 = sharded.n_users
    uids = np.arange(n0, n0 + SHARD_FOLD_USERS)
    cols = [frng.choice(M_ITEMS, int(n), replace=False)
            for n in frng.integers(5, 60, SHARD_FOLD_USERS)]
    vals = [frng.integers(1, 6, len(c)).astype(np.float32) for c in cols]
    params = ALSParams(rank=RANK, num_iterations=ITERATIONS, lambda_=LAMBDA,
                       alpha=ALPHA)
    spd_before = als_cuda.spd_launches.value
    rows = {name: fold_in_users(srv.item_factors, cols, vals, params,
                                device=dev)
            for name, srv in (("sharded", sharded), ("single", single))}
    if not np.array_equal(rows["sharded"], rows["single"]):
        raise AssertionError("the folded rows differ between the stores")
    cap_before = sharded.user_capacity
    for srv in (sharded, single):
        srv.patch_users(uids, rows["sharded"],
                        seen_items={int(u): c for u, c in zip(uids, cols)})
    if sharded.user_capacity <= cap_before \
            or sharded.user_capacity % SHARDS:
        raise AssertionError(f"no reshard: {cap_before} -> "
                             f"{sharded.user_capacity}")
    x_rows = np.linalg.norm(rows["sharded"], axis=1)
    for u, xn in zip(uids, x_rows):
        gi, gs = sharded.user_topk(int(u), 10)
        wi, ws = single.user_topk(int(u), 10)
        tol = RTOL * 1.01 * xn * y_norm
        if len(gs) != len(ws) or (np.abs(np.sort(gs) - np.sort(ws))
                                  > RTOL * np.abs(np.sort(ws)) + tol).any():
            raise AssertionError(f"folded user {u}: {gs} against {ws}")
        if set(gi.tolist()) & set(cols[int(u - n0)].tolist()):
            raise AssertionError(f"folded user {u}: a seen item served")
    print(f"[sharded] {SHARD_FOLD_USERS} folded users (B2 launches "
          f"{als_cuda.spd_launches.value - spd_before}) agree; the sharded "
          f"store grew {cap_before} -> {sharded.user_capacity} rows "
          f"({sharded.growths[-1]})")

    # (c) a one-rank NCCL process group
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t = time.perf_counter()
    joined = distributed.initialize(distributed.DistributedConfig(
        coordinator=f"127.0.0.1:{port}", num_hosts=1, process_id=0))
    try:
        import torch.distributed as dist

        ones = torch.ones(4, device=dev)
        dist.all_reduce(ones)
        torch.cuda.synchronize()
        group = {"joined": joined, "backend": str(dist.get_backend()),
                 "process_count": distributed.process_count(),
                 "process_index": distributed.process_index(),
                 "primary": distributed.is_primary_host(),
                 "all_reduce": ones.cpu().tolist()}
    finally:
        distributed.shutdown()
    group["s"] = time.perf_counter() - t
    want = "nccl" if torch.device(dev).type == "cuda" else "gloo"
    if not (joined and group["backend"] == want
            and group["process_count"] == 1 and group["primary"]
            and group["all_reduce"] == [1.0] * 4):
        raise AssertionError(f"process group: {group}")
    print(f"[sharded] process group: {group}")

    timed = sharded_timings(dev, sharded, model)
    ladder = ladder_sharded(sharded, "8b's 4-shard store")
    for srv in (sharded, single, cpu):
        srv.close()
    return {"launches": launches, "dispatches": dispatches,
            "by_key": {str(k): v for k, v in by_key.items()},
            "checked": checked, "burst_qps": SHARD_BURST / burst_s,
            "balance": balance, "build_s": build_s,
            "grown": [cap_before, sharded.user_capacity],
            "process_group": group, "timings": timed, "ladder": ladder}


# phase 8c: sharded training on the card
TRAIN_SHARDS = 4
SHARD_RTOL = 1e-6           # sharded against single-device training
SHARD_BATCH_USERS = 256     # 8c's batch_predict against the looped path


def frobenius(got, want) -> tuple:
    """(relative Frobenius error, largest absolute difference)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return (float(np.linalg.norm(got - want) / np.linalg.norm(want)),
            float(np.abs(got - want).max()))


def bucket_launch_plan(side, n_shards: int) -> int:
    """B3's (and B2's) launches for one half-step of the sharded bucketed
    trainer: per bucket, padded with sentinel rows to a multiple of
    ``8 * n_shards``, one per shard whose block holds a real row."""
    plan = 0
    for b in side.buckets:
        real = np.asarray(b.row_ids) < side.n_rows
        pad = (-len(real)) % (8 * n_shards)
        real = np.concatenate([real, np.zeros(pad, bool)])
        plan += sum(bool(x.any()) for x in np.split(real, n_shards))
    return plan


def b3_b2_ms(by_name) -> dict:
    """B3's (the assembly and its span reduction) and B2's device ms in a
    profile's kernel times."""
    return {"B3": sum(ms for name, ms in by_name.items()
                      if name.startswith("assemble")),
            "B2": by_name.get("spd_solve_warp_kernel", 0.0)}


def sharded_training(dev, trained: dict, seed: int, card: str) -> dict:
    """Phase 8c: sharded training on ``[dev] * TRAIN_SHARDS`` (each logical
    shard the card, launching B3 and B2 on its own row block): (a) the
    bucketed data-parallel trainer on phase 5's sides against phase 5's
    factors, its launches against the plan, one iteration event-timed
    and profiled beside the single-device one; (b) the 2-D uniform
    trainer at ML-1M width against ``train_als``, and each device's
    factor bytes; (c) the PAlgorithm flavor on phase 5's prepared data,
    answering like phase 5's model; (d) (b) again through the
    collective merge of a one-rank NCCL group. Any disagreement
    raises."""
    import dataclasses
    import socket

    import torch

    from predictionio_tpu_torch.core.context import workflow_context
    from predictionio_tpu_torch.ops import als as als_mod
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.parallel import als_sharding, distributed
    from predictionio_tpu_torch.parallel.mesh import (
        P,
        data_parallel_mesh,
        mesh_2d,
    )
    from predictionio_tpu_torch.templates.recommendation.engine import (
        ALSAlgorithm,
        Query,
        ShardedALSModel,
        sharded_engine_factory,
    )

    pd, model = trained["pd"], trained["model"]
    plane = [dev] * TRAIN_SHARDS
    params = als_mod.ALSParams(rank=RANK, num_iterations=ITERATIONS,
                               lambda_=LAMBDA, alpha=ALPHA, seed=seed)
    counters = (als_cuda.assemble_launches, als_cuda.spd_launches)

    # (a) data-parallel, bucketed, at ML-20M width
    mesh = data_parallel_mesh(devices=plane)
    for c in counters:
        c.reset()
    t = time.perf_counter()
    X, Y = als_sharding.train_als_bucketed_sharded(
        pd.user_side, pd.item_side, params, mesh)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    launches = {"assemble_normal_equations":
                als_cuda.assemble_launches.value,
                "spd_solve": als_cuda.spd_launches.value}
    plan = sum(bucket_launch_plan(side, TRAIN_SHARDS)
               for side in (pd.user_side, pd.item_side))
    if any(n != plan * ITERATIONS for n in launches.values()):
        raise AssertionError(f"sharded training launched {launches}, the "
                             f"plan is {plan} an iteration")
    errs = {name: frobenius(got, want) for name, got, want in (
        ("user", X, model.user_factors), ("item", Y, model.item_factors))}
    if max(e for e, _ in errs.values()) > SHARD_RTOL:
        raise AssertionError(f"sharded factors differ from phase 5's: "
                             f"{errs}")
    print(f"[train-sharded] (a) {TRAIN_SHARDS} shards, bucketed: "
          f"{train_s:.2f} s; against phase 5's factors relative Frobenius "
          f"/ largest difference {errs} (limit {SHARD_RTOL}); launches "
          f"{launches}, {plan} an iteration (the plan) against phase 5's "
          f"{trained['launches']['spd_solve'] // ITERATIONS}")

    # one iteration each way, from the same init: event-timed, profiled
    n_u, n_i = pd.user_side.n_rows, pd.item_side.n_rows
    X0, Y0 = als_mod.init_policy_factors(n_u, n_i, RANK, seed, "fp32",
                                         "cpu")
    spec = P(None, None)
    Xs = als_sharding._place_factor(X0, mesh, spec, n_u)
    Ys = als_sharding._place_factor(Y0, mesh, spec, n_i)
    u_t = als_sharding._bucket_tables(pd.user_side, mesh)
    i_t = als_sharding._bucket_tables(pd.item_side, mesh)
    solver = als_sharding._Solver(mesh, spec,
                                  als_sharding._solve_kwargs(params))

    def sharded_iteration():
        Xc = solver.bucketed(Ys, n_i, u_t, n_u, n_u)
        solver.bucketed(Xc, n_u, i_t, n_i, n_i)

    su, si = bucket_tables(pd.user_side, dev), bucket_tables(pd.item_side,
                                                             dev)
    Xd, Yd = X0.to(dev), Y0.to(dev)
    kw = dict(lam=LAMBDA, alpha=ALPHA, implicit=True, slot_budget=None)

    def single_iteration():
        als_mod.als_iterations_bucketed(Xd, Yd, su, si, num_iterations=1,
                                        **kw)

    sharded_ms, single_ms, sharded_ms2, single_ms2 = (
        time_ms(f, 5) for f in (sharded_iteration, single_iteration,
                                sharded_iteration, single_iteration))
    for c in counters:
        c.reset()
    wall, busy, kernels, by_name = device_busy(sharded_iteration)
    per_iteration = {"assemble_normal_equations":
                     als_cuda.assemble_launches.value,
                     "spd_solve": als_cuda.spd_launches.value}
    swall, sbusy, _, sby_name = device_busy(single_iteration)
    del su, si, Xd, Yd, u_t, i_t, Xs, Ys
    timing = {
        "ms_per_iteration": [sharded_ms, sharded_ms2],
        "single_ms_per_iteration": [single_ms, single_ms2],
        "profiled_wall_ms": wall, "busy_ms": busy,
        "busy_share": busy / wall, "single_profiled_wall_ms": swall,
        "single_busy_ms": sbusy, "single_busy_share": sbusy / swall,
        "kernel_ms": b3_b2_ms(by_name),
        "single_kernel_ms": b3_b2_ms(sby_name),
        "launches_per_iteration": per_iteration,
        "kernel_launches": dict(kernels.most_common(6))}
    print(f"[train-sharded] one iteration, event-timed (turns): sharded "
          f"{sharded_ms!r} / {sharded_ms2!r} ms, single-device "
          f"{single_ms!r} / {single_ms2!r} ms (phase 5 profiled "
          f"{trained['iteration_ms']!r}); profiled: sharded wall {wall!r} "
          f"ms, the card busy {busy!r} ({100 * busy / wall:.2f}%), "
          f"B3 / B2 {timing['kernel_ms']}; single wall {swall!r}, busy "
          f"{sbusy!r} ({100 * sbusy / swall:.2f}%), B3 / B2 "
          f"{timing['single_kernel_ms']}; launches an iteration "
          f"{per_iteration}; kernels {timing['kernel_launches']}")

    # (b) 2-D, uniform, at ML-1M width
    rows, cols, values, _ = ml1m_ratings(seed)
    us = als_mod.pad_ratings(rows, cols, values, ML1M_USERS, ML1M_ITEMS)
    is_ = als_mod.pad_ratings(cols, rows, values, ML1M_ITEMS, ML1M_USERS)
    mesh2 = mesh_2d(2, 2, devices=plane)
    t = time.perf_counter()
    X2, Y2 = als_sharding.train_als_sharded_2d(us, is_, params, mesh2)
    torch.cuda.synchronize()
    two_d_s = time.perf_counter() - t
    X1, Y1 = als_mod.train_als(us, is_, params, dev)
    errs_2d = {name: frobenius(got, want) for name, got, want in (
        ("user", X2, X1), ("item", Y2, Y1))}
    if max(e for e, _ in errs_2d.values()) > SHARD_RTOL:
        raise AssertionError(f"2-D factors differ from train_als: "
                             f"{errs_2d}")
    Xm, Ym = als_sharding.train_als_device(us, is_, params, mesh2)
    factor_bytes = {}
    for name, tab in (("user", Xm), ("item", Ym)):
        whole = tab.shape[0] * tab.shape[1] * 4
        got = tab.block_bytes()
        if any(b * 2 != whole for b in got) or any(
                blk.device.type != torch.device(dev).type
                for blk in tab.blocks):
            raise AssertionError(f"{name} factor bytes a device {got}, the "
                                 f"padded table {whole}")
        factor_bytes[name] = {"per_device": got, "padded_table": whole}
    del Xm, Ym
    print(f"[train-sharded] (b) mesh_2d(2, 2), uniform at ML-1M width "
          f"(user {us.cols.shape}, item {is_.cols.shape} slots): "
          f"{two_d_s:.2f} s; against train_als {errs_2d}; factor bytes a "
          f"device {factor_bytes}")

    # (c) the PAlgorithm flavor over a context of the logical shards
    engine = sharded_engine_factory()
    algo = engine.algorithm_class_map["als"](params)
    ctx = workflow_context(devices=plane, device=dev)
    for c in counters:
        c.reset()
    t = time.perf_counter()
    sharded_model = algo.train(ctx, pd)
    torch.cuda.synchronize()
    flavor_s = time.perf_counter() - t
    flavor_launches = {"assemble_normal_equations":
                       als_cuda.assemble_launches.value,
                       "spd_solve": als_cuda.spd_launches.value}
    if not isinstance(sharded_model, ShardedALSModel) or any(
            blk.device.type != torch.device(dev).type for tab in (
                sharded_model.user_factors, sharded_model.item_factors)
            for blk in tab.blocks):
        raise AssertionError(f"the flavor's model: {sharded_model!r}")
    sharded_model.sanity_check()
    srv = sharded_model.device_server()
    calls = []
    launch = srv._sharded_launch

    def counted(*args):
        calls.append(1)
        return launch(*args)

    srv._sharded_launch = counted
    ref = ALSAlgorithm()
    queries, _ = phase3_queries(seed)

    def query(q):
        return Query(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in q.items()})

    als_cuda.launches.reset()
    got = [algo.predict(sharded_model, query(q)) for q in queries]
    b1 = als_cuda.launches.value
    dispatches = len(calls)
    del srv._sharded_launch
    if not dispatches or b1 != TRAIN_SHARDS * dispatches:
        raise AssertionError(f"B1 launched {b1} times over {dispatches} "
                             f"sharded dispatches")
    x_norm = np.linalg.norm(model.user_factors, axis=1)
    y_norm = float(np.linalg.norm(model.item_factors, axis=1).max())
    for q, answer in zip(queries, got):
        results_agree(answer, ref.predict(model, query(q)), q,
                      query_bound(model, q, x_norm, y_norm), by_set=True)
    rng = np.random.default_rng(seed + 83)
    users = [(j, Query(user=f"u{u}", num=10))
             for j, u in enumerate(rng.integers(0, N_USERS,
                                                SHARD_BATCH_USERS))]
    t = time.perf_counter()
    batched = dict(algo.batch_predict(ctx, sharded_model, users))
    batch_s = time.perf_counter() - t
    looped = {j: algo.predict(sharded_model, q) for j, q in users}
    if batched != looped:
        raise AssertionError("batch_predict differs from the looped path")
    srv.close()
    flavor = {"train_s": flavor_s, "launches": flavor_launches,
              "b1_launches": b1, "dispatches": dispatches,
              "checked": len(queries), "batch_users": len(users),
              "batch_s": batch_s,
              "layout": sharded_model.item_layout.balance_report()}
    print(f"[train-sharded] (c) ALSShardedAlgorithm.train over {plane}: "
          f"{flavor_s:.2f} s, launches {flavor_launches}; "
          f"{len(queries)} queries agree with phase 5's model as score "
          f"sets, B1 {b1} launches over {dispatches} dispatches; "
          f"batch_predict of {len(users)} users {batch_s:.3f} s equals the "
          f"looped path")
    del sharded_model, srv

    # (d) a one-rank NCCL world: (b)'s problem through the collective merge
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t = time.perf_counter()
    joined = distributed.initialize(distributed.DistributedConfig(
        coordinator=f"127.0.0.1:{port}", num_hosts=1, process_id=0))
    gathers = []
    all_gather = distributed.all_gather_rows

    def counted_gather(tensor):
        gathers.append(tuple(tensor.shape))
        return all_gather(tensor)

    distributed.all_gather_rows = counted_gather
    try:
        import torch.distributed as dist

        backend = str(dist.get_backend())
        Xc, Yc = als_sharding.train_als_sharded_2d(us, is_, params, mesh2)
        torch.cuda.synchronize()
    finally:
        distributed.all_gather_rows = all_gather
        distributed.shutdown()
    collective_s = time.perf_counter() - t
    want = "nccl" if torch.device(dev).type == "cuda" else "gloo"
    if not (joined and backend == want
            and len(gathers) == 2 * ITERATIONS):
        raise AssertionError(f"the NCCL world: joined {joined}, {backend}, "
                             f"{len(gathers)} all-gathers")
    if not (np.array_equal(Xc, X1) and np.array_equal(Yc, Y1)):
        raise AssertionError(
            f"factors through the collective merge differ from train_als: "
            f"{frobenius(Xc, X1)}, {frobenius(Yc, Y1)}")
    print(f"[train-sharded] (d) one NCCL rank ({backend}): "
          f"{len(gathers)} all-gathers, factors bitwise equal to "
          f"train_als; {collective_s:.2f} s with the join")
    return {"launches": launches, "plan_per_iteration": plan,
            "train_s": train_s, "errs": errs, "timing": timing,
            "two_d": {"s": two_d_s, "errs": errs_2d,
                      "factor_bytes": factor_bytes},
            "flavor": flavor,
            "collective": {"backend": backend, "all_gathers": len(gathers),
                           "s": collective_s}}


# phase 8d: sequence-parallel attention and two-stage serving over shards

SP_SHARDS = 4
SP_MODES = ("ring", "ulysses", "auto")
SP_TOL = dict(rtol=2e-4, atol=1e-5)   # JAX TestMeshLane.TOL
SP_COLLECTIVE_USERS = 1_024           # (c)'s users of the longest class
TWO_SHARD_BURST = 256                 # (b)'s user queries from 8 threads
TWO_SHARD_FOLD_USERS = 4              # (b)'s new users folded in
TWO_SHARD_B = 8                       # the uid bucket of a lone dispatch


class ScoreBlocks:
    """While entered, records the score blocks ``ops/attention.py``
    forms (its ``_scores`` wrapped): the largest one's shape."""

    def __enter__(self) -> "ScoreBlocks":
        from predictionio_tpu_torch.ops import attention

        self.largest: tuple = ()
        self._mod, self._saved = attention, attention._scores

        def recorded(q, k, scale):
            out = self._saved(q, k, scale)
            if out.numel() > int(np.prod(self.largest or (0,))):
                self.largest = tuple(out.shape)
            return out

        attention._scores = recorded
        return self

    def __exit__(self, *exc) -> None:
        self._mod._scores = self._saved


def within_sp_tol(got: np.ndarray, want: np.ndarray) -> tuple:
    """(every entry within ``SP_TOL``, the largest absolute difference)."""
    diff = np.abs(got - want)
    ok = bool((diff <= SP_TOL["atol"] + SP_TOL["rtol"] * np.abs(want)).all())
    return ok, float(diff.max())


def sp_encodes(dev, seq: dict) -> dict:
    """8d (a): phase 3e's θ and buckets encoded over ``[dev] * 4`` with
    ``sp_mode`` ring, ulysses and auto, beside the dense encode; each
    held to 3e's dense encode within ``SP_TOL``. One chunk of the longest
    class is profiled per scheme: wall, the card's busy ms, kernels."""
    import dataclasses

    import torch

    from predictionio_tpu_torch.ops import seqrec
    from predictionio_tpu_torch.parallel.mesh import data_parallel_mesh

    model, pd = seq["model"], seq["pd"]
    mesh = data_parallel_mesh(devices=[dev] * SP_SHARDS)
    n_users = len(pd.user_map)
    rows = {}
    for mode in ("dense",) + SP_MODES:
        p = dataclasses.replace(model.enc_params,
                                sp_mode="off" if mode == "dense" else mode)
        schemes = sorted({str(seqrec.select_sp_kernel(
            mesh, "data", int(p.n_heads), b.seq_len, p.sp_mode))
            for b in pd.buckets})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with ScoreBlocks() as blocks:
            t = time.perf_counter()
            U = seqrec.encode_users(
                model.theta, pd.buckets, n_users, p, device=dev,
                mesh=None if mode == "dense" else mesh)
            torch.cuda.synchronize()
            s = time.perf_counter() - t
        ok, diff = within_sp_tol(U, model.user_vectors)
        rows[mode] = {"s": s, "schemes": schemes,
                      "largest_score_block": list(blocks.largest),
                      "peak_bytes": int(torch.cuda.max_memory_allocated()
                                        - base),
                      "max_abs_diff": diff, "within_tol": ok}
        print(f"[sp-encode] {mode}: {n_users} users in {s:.3f} s "
              f"(schemes {schemes}); largest score block {blocks.largest}; "
              f"peak {rows[mode]['peak_bytes']} bytes; against 3e's dense "
              f"encode max |diff| {diff!r} (within rtol 2e-4 / atol 1e-5: "
              f"{ok})")
        if not ok:
            raise AssertionError(f"the {mode} encode differs from the "
                                 f"dense one by {diff!r}")
    # one chunk of the longest class under the profiler, each scheme
    th = seqrec.theta_to_device(model.theta, dev)
    bucket = max(pd.buckets, key=lambda b: (b.seq_len, len(b)))
    step = seqrec.encode_chunk_rows(bucket.seq_len,
                                    int(th["item_emb"].shape[1]),
                                    int(model.enc_params.n_heads))
    sub = seqrec.SequenceBucket(bucket.rows[:step], bucket.ids[:step],
                                bucket.mask[:step])
    for mode in ("dense", "ring", "ulysses"):
        p = dataclasses.replace(model.enc_params, sp_mode=mode)
        if mode == "dense":
            run = lambda: seqrec.encode_bucket(th, sub, p, dev)  # noqa
        else:
            run = lambda: seqrec.encode_bucket_mesh(th, sub, p, mesh)  # noqa
        run()
        wall, busy, names, _ = device_busy(run)
        rows[mode]["chunk"] = {"rows": len(sub), "wall_ms": wall,
                               "busy_ms": busy,
                               "kernels": int(sum(names.values()))}
        print(f"[sp-encode] {mode}, one chunk of {len(sub)} users of the "
              f"{sub.seq_len}-long class under the profiler: {wall:.3f} ms "
              f"wall, the card busy {busy:.3f} ms, "
              f"{rows[mode]['chunk']['kernels']} kernels")
    return rows


def sharded_stage_one(dev, store) -> dict:
    """8d (b)'s kernel checks and times on the sharded two-stage store's
    blocks: B1 unmasked at k = N on each shard against its plain version
    (B = ``TWO_SHARD_B``), then the whole stage 1 (4 launches and the
    merge) timed against its plain version, the library's (each shard's
    block widened, the product, invalid rows -inf, ``torch.topk``, then
    ``torch.topk`` of the joined lists) and its bound."""
    import torch

    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops import serving as serving_mod

    shards = store._shards
    m = int(shards[0].valid.shape[0])
    n_pos = m * len(shards)
    k = min(store._n_bucket, m)
    rng = np.random.default_rng(17)
    uids = torch.as_tensor(rng.integers(0, store.n_users, TWO_SHARD_B),
                           device=dev)
    Q = serving_mod._gather_rows_f32(store._X, uids)
    worst = 0.0
    for sh in shards:
        kv, ki = als_cuda.fused_gather_score_topk(
            Q, sh.Y, None, None, k=k, n_items=m, mask_seen=False,
            row_valid=sh.valid)
        pv, pi = als_cuda.fused_gather_score_topk_plain(
            Q, sh.Y, None, None, k=k + 1, n_items=m, mask_seen=False,
            row_valid=sh.valid)
        tol = (RTOL * torch.linalg.vector_norm(Q, dim=1)
               * torch.linalg.vector_norm(sh.Y.float(), dim=1).max()
               ).cpu().numpy()
        worst = max(worst, check_topk(kv.cpu().numpy(), ki.cpu().numpy(),
                                      pv.cpu().numpy(), pi.cpu().numpy(),
                                      tol, exact=False))

    def stage_one():
        serving_mod._sharded_score_topk(shards, Q, None, None, k=k,
                                        mask_seen=False)

    def plain():
        serving_mod.fused_gather_score_topk = \
            als_cuda.fused_gather_score_topk_plain
        try:
            stage_one()
        finally:
            serving_mod.fused_gather_score_topk = \
                als_cuda.fused_gather_score_topk

    def library():
        vals, idx = [], []
        for sh in shards:
            s = torch.matmul(Q, sh.Y.float().T)
            s[:, sh.valid <= 0] = float("-inf")
            v, i = torch.topk(s, k, dim=1)
            vals.append(v)
            idx.append(i + sh.offset)
        v, sel = torch.topk(torch.cat(vals, 1), k, dim=1)
        torch.gather(torch.cat(idx, 1), 1, sel)

    t_k, t_p, t_l = (time_ms(f, 20) for f in (stage_one, plain, library))
    _, busy, _, by_name = device_busy(lambda: [stage_one()
                                               for _ in range(20)])
    b1 = b1_kernel_names()
    b_ms, b_by = bound_of(
        n_pos * RANK * 2 + n_pos * 4 + TWO_SHARD_B * RANK * 4
        + TWO_SHARD_B * k * 8 * (len(shards) + 1),
        2.0 * TWO_SHARD_B * n_pos * RANK)
    row = {"store": "bf16", "B": TWO_SHARD_B, "k": k, "mask_seen": False,
           "shards": len(shards), "positions_per_shard": m, "ms": t_k,
           "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
           "bound_by": b_by, "busy_ms": busy / 20,
           "b1_ms": sum(v for name, v in by_name.items() if name in b1) / 20,
           "max_abs_err": worst}
    print(f"[sp-two] B1 unmasked k={k} on each of {len(shards)} shards == "
          f"plain (largest |err| {worst!r}); stage 1 at B={TWO_SHARD_B} "
          f"({len(shards)} launches + merge) {t_k!r} ms (card busy "
          f"{row['busy_ms']!r}, B1 {row['b1_ms']!r}), plain {t_p!r} ms, "
          f"library {t_l!r} ms, bound {b_ms!r} ms ({b_by})")
    return row


def sharded_twostage(dev, two: dict, seed: int) -> dict:
    """8d (b): phase 3f's models deployed through ``TwoStageServing`` over
    a context of ``[dev] * 4`` with ``PIO_SERVE_SHARDS=4`` (bf16, N =
    128): 43 sequential queries and ``TWO_SHARD_BURST`` from 8 threads,
    every answer equal to the plain pipeline (B1's plain version on each
    shard, then the same re-rank); B1 launches 4 times a two-lane
    dispatch, at k = N, unmasked. Then a lone dispatch event-timed and
    profiled (busy, B1 ms), ``stage_times``' B1 / stage-2 µs, B1 held to
    plain on each shard and stage 1 timed; last a composite fold of
    ``TWO_SHARD_FOLD_USERS`` new users (B3 + B2 rows, a re-encode, the
    store growing by a reshard), their answers equal to the plain
    pipeline's on the same store."""
    import concurrent.futures
    import dataclasses
    import os

    import torch

    from predictionio_tpu_torch.core.context import workflow_context
    from predictionio_tpu_torch.ops import als_cuda
    from predictionio_tpu_torch.ops import serving as serving_mod
    from predictionio_tpu_torch.ops import twostage as twostage_mod
    from predictionio_tpu_torch.ops.als import fold_in_users
    from predictionio_tpu_torch.templates.twostage import engine as teng
    from predictionio_tpu_torch.workflow.create_server import (
        deployment_from_models,
        query_from_json,
        serve_query,
        to_jsonable,
    )

    als = dataclasses.replace(two["als"], _server=None)
    rerank = dataclasses.replace(two["rerank"], _server=None)
    engine = teng.engine_factory()
    params = engine.engine_params_from_variant({
        "algorithms": [{"name": "als", "params": {"rank": RANK}},
                       {"name": "seqrec", "params": {}}]})
    ctx = workflow_context(mode="serving", devices=[dev] * SP_SHARDS)
    prior = os.environ.get("PIO_SERVE_SHARDS")
    os.environ["PIO_SERVE_SHARDS"] = str(SP_SHARDS)
    try:
        t0 = time.perf_counter()
        dep = deployment_from_models(engine, params, [als, rerank], ctx=ctx)
        store = als.device_server().store
        store.warmup()
        build_s = time.perf_counter() - t0
    finally:
        if prior is None:
            os.environ.pop("PIO_SERVE_SHARDS", None)
        else:
            os.environ["PIO_SERVE_SHARDS"] = prior
    if not (dep.serving.fused_bound and store.shard_count == SP_SHARDS
            and store.precision == "bf16"
            and store._n_bucket == TWO_CANDIDATES):
        raise AssertionError(f"store: {store.shard_count} shards, "
                             f"{store.precision}, N {store._n_bucket}")
    print(f"[sp-two] store built and warmed in {build_s:.2f} s: "
          f"{store.item_layout.balance_report()}; "
          f"{store.memory_report()['totalBytes']} bytes")
    rng = np.random.default_rng(seed + 87)
    queries, many = sequence_queries(rng, len(als.user_map))
    many = many[:TWO_SHARD_BURST]

    def ask(q):
        t = time.perf_counter()
        res = serve_query(dep, query_from_json(
            q, dep.algorithms[0].query_class))
        return q, 200, to_jsonable(res), time.perf_counter() - t

    lanes0 = store.stats()
    store.stage_times.clear()
    als_cuda.launches.reset()
    t = time.perf_counter()
    answers = [ask(q) for q in queries]
    seq_s = time.perf_counter() - t
    with concurrent.futures.ThreadPoolExecutor(SEQ_CLIENTS) as pool:
        t = time.perf_counter()
        answers += list(pool.map(ask, many))
        burst_s = time.perf_counter() - t
    launches = als_cuda.launches.value
    by_key = dict(als_cuda.launches.by_key())
    lanes = store.stats()
    split = np.asarray(list(store.stage_times))
    dispatches = lanes["two"]["dispatches"] - lanes0["two"]["dispatches"]
    # each shard's list: k = N, or its block when that is shorter
    k_shard = min(TWO_CANDIDATES, store.item_layout.cap)
    at_n = sum(c for (r, k, b), c in by_key.items() if k == k_shard)
    if not dispatches or at_n != SP_SHARDS * dispatches:
        raise AssertionError(f"{dispatches} two-lane dispatches, {at_n} B1 "
                             f"launches at k = {k_shard} ({by_key})")
    checked = check_against_plain(als, answers)
    b1_us, s2_us = (float(np.median(split[:, 0])),
                    float(np.median(split[:, 1]))) if len(split) else (
                        None, None)
    print(f"[sp-two] {checked} answers equal to plain ({len(queries)} "
          f"sequential in {seq_s:.3f} s, {len(many)} from {SEQ_CLIENTS} "
          f"threads in {burst_s:.3f} s: {len(many) / burst_s!r} q/s); "
          f"{dispatches} two-lane dispatches, B1 {at_n} launches at k = "
          f"{k_shard} ({at_n / dispatches!r} a dispatch; all {launches}:"
          f" {by_key}); per dispatch (median of {len(split)}, CUDA events) "
          f"B1's kernels on {SP_SHARDS} shards {b1_us!r} us, stage 2 "
          f"{s2_us!r} us")
    lone = np.arange(TWO_SHARD_B, dtype=np.int64)
    dispatch_ms = time_ms(lambda: store.twos_topk(lone, 10), 20)
    _, busy, _, by_name = device_busy(
        lambda: [store.twos_topk(lone, 10) for _ in range(20)])
    b1 = b1_kernel_names()
    lone_row = {"ms": dispatch_ms, "busy_ms": busy / 20,
                "b1_ms": sum(v for n, v in by_name.items() if n in b1) / 20}
    print(f"[sp-two] a lone dispatch (B={TWO_SHARD_B}, k=10): "
          f"{dispatch_ms!r} ms event-timed, the card busy "
          f"{lone_row['busy_ms']!r} ms, B1 {lone_row['b1_ms']!r} ms")
    route = sharded_stage_one(dev, store)

    # a composite fold of new users, growing the store by a reshard
    frng = np.random.default_rng(seed + 88)
    n0, cap0 = store.n_users, store.user_capacity
    uids = np.arange(cap0, cap0 + TWO_SHARD_FOLD_USERS)
    cols = [frng.choice(store.n_items, int(n), replace=False)
            for n in frng.integers(5, 40, TWO_SHARD_FOLD_USERS)]
    vals = [np.ones(len(c), np.float32) for c in cols]
    als_cuda.assemble_launches.reset()
    als_cuda.spd_launches.reset()
    x_rows = fold_in_users(store.item_factors, cols, vals,
                           two["als_params"], max_len=TWO_MAX_LEN,
                           device=dev)
    u_rows = rerank.fold_in_rows(cols, vals)
    fold_launches = {"assemble_normal_equations":
                     als_cuda.assemble_launches.value,
                     "spd_solve": als_cuda.spd_launches.value}
    seen = {int(u): c for u, c in zip(uids, cols)}
    store.patch_users(uids, x_rows, seen_items=seen)
    store.patch_seq_users(uids, u_rows, seen_items=seen)
    if not (store.user_capacity > cap0
            and store.user_capacity % SP_SHARDS == 0
            and int(store._U.shape[0]) == store.user_capacity):
        raise AssertionError(f"no reshard: {cap0} -> {store.user_capacity}")
    gi, gv = store.twos_topk(uids, 10)
    saved = (serving_mod.fused_gather_score_topk,
             twostage_mod.fused_gather_score_topk)
    serving_mod.fused_gather_score_topk = \
        twostage_mod.fused_gather_score_topk = \
        als_cuda.fused_gather_score_topk_plain
    try:
        wi, wv = store.twos_topk(uids, 11)
    finally:
        (serving_mod.fused_gather_score_topk,
         twostage_mod.fused_gather_score_topk) = saved
    u_norm = np.linalg.norm(u_rows, axis=1)
    e_norm = float(store.seq_item_factors.norm(dim=1).max())
    check_topk(gv, gi, wv, wi, (RTOL * 1.01 * u_norm * e_norm).astype(
        np.float32), exact=False)
    for i, u in enumerate(uids):
        if set(gi[i][np.isfinite(gv[i])].tolist()) & set(seen[int(u)]
                                                         .tolist()):
            raise AssertionError(f"folded user {u}: a seen item served")
    print(f"[sp-two] composite fold of {TWO_SHARD_FOLD_USERS} new users "
          f"(launches {fold_launches}): the store grew {cap0} -> "
          f"{store.user_capacity} rows ({n0} users before); their answers "
          f"equal the plain pipeline's, seen items masked")
    store.close()
    als._server = rerank._server = None
    return {"launches": at_n, "dispatches": dispatches,
            "launches_per_dispatch": at_n / dispatches,
            "by_key": {str(k): v for k, v in by_key.items()},
            "checked": checked, "burst_qps": len(many) / burst_s,
            "b1_us": b1_us, "stage2_us": s2_us, "lone": lone_row,
            "route": route, "build_s": build_s,
            "grown": [cap0, store.user_capacity],
            "fold_launches": fold_launches}


def sp_collectives(dev, seq: dict) -> dict:
    """8d (c): Ulysses through a one-rank NCCL process group (its swaps
    ``all_to_all_single``, its mask ``all_gather``): the longest class's
    first ``SP_COLLECTIVE_USERS`` users encoded over ``[dev] * 4``,
    held to 3e's dense encode within ``SP_TOL``."""
    import dataclasses
    import socket

    import torch

    from predictionio_tpu_torch.ops import seqrec
    from predictionio_tpu_torch.parallel import distributed
    from predictionio_tpu_torch.parallel.mesh import data_parallel_mesh

    model, pd = seq["model"], seq["pd"]
    bucket = max(pd.buckets, key=lambda b: (b.seq_len, len(b)))
    take = slice(0, SP_COLLECTIVE_USERS)
    sub = seqrec.SequenceBucket(bucket.rows[take], bucket.ids[take],
                                bucket.mask[take])
    p = dataclasses.replace(model.enc_params, sp_mode="ulysses")
    mesh = data_parallel_mesh(devices=[dev] * SP_SHARDS)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    import torch.distributed as dist

    calls = {"all_to_all_single": 0, "all_gather": 0}
    saved = {name: getattr(dist, name) for name in calls}

    def counted(name):
        def run(*a, **kw):
            calls[name] += 1
            return saved[name](*a, **kw)
        return run

    t = time.perf_counter()
    joined = distributed.initialize(distributed.DistributedConfig(
        coordinator=f"127.0.0.1:{port}", num_hosts=1, process_id=0))
    for name in calls:
        setattr(dist, name, counted(name))
    try:
        backend = str(dist.get_backend())
        got = seqrec.encode_bucket_mesh(model.theta, sub, p, mesh)
        torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
        distributed.shutdown()
    s = time.perf_counter() - t
    ok, diff = within_sp_tol(got, model.user_vectors[sub.rows])
    want = "nccl" if torch.device(dev).type == "cuda" else "gloo"
    if not (joined and backend == want and ok
            and calls["all_to_all_single"] and calls["all_gather"]):
        raise AssertionError(f"the NCCL world: joined {joined}, {backend}, "
                             f"{calls}, max |diff| {diff!r}")
    print(f"[sp-collective] one NCCL rank ({backend}): {len(sub)} users of "
          f"the {sub.seq_len}-long class through Ulysses' collectives "
          f"{calls}; against 3e's dense encode max |diff| {diff!r}; "
          f"{s:.2f} s with the join")
    return {"backend": backend, "calls": calls, "max_abs_diff": diff,
            "s": s}


def sequence_parallel(dev, seq: dict, two: dict, seed: int) -> dict:
    """Phase 8d: (a) the sequence-parallel encodes, (b) two-stage serving
    over four shards, (c) Ulysses through one NCCL rank."""
    return {"encode": sp_encodes(dev, seq),
            "twostage": sharded_twostage(dev, two, seed),
            "collective": sp_collectives(dev, seq)}


def fleet_launches(name: str, fleet: dict, started: dict) -> dict:
    """A kernel's launches in the query fleet: phase 3d's and 6b's
    ``pio deploy --fleet`` child's, summed and by phase; for the training
    kernels also phase 3d's training of the instance the roll swaps to
    (the script's own, not the fleet's)."""
    by_phase = {"3d": fleet["launches"].get(name, 0),
                "6b": started["fleet"]["launches"].get(name, 0)}
    out = {"fleet_launches": sum(by_phase.values()),
           "fleet_launches_by_phase": by_phase}
    if name in fleet["roll_training"]:
        out["fleet_roll_training"] = fleet["roll_training"][name]
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
        "--topk-routes", action="store_true",
        help="build, then only hold the serving kernel against its plain "
             "version (phase 2) and run its routes of k <= 128 side by "
             "side (phase 4c)")
    parser.add_argument(
        "--prepare-times", action="store_true",
        help="only run phase 5's ratings through the preparator and print "
             "its split; with a copy of this script at another checkout's "
             "root, times that checkout's prepare step")
    parser.add_argument(
        "--ingest-times", type=int, metavar="ROUNDS",
        help="only run phase 6b's event-server ingest, ROUNDS times with "
             "PIO_RESILIENCE on and off in turns, and print its rates; with "
             "a copy of this script at another checkout's root, times that "
             "checkout's event server")
    parser.add_argument(
        "--networked", action="store_true",
        help="build, then only run phase 6d (the networked event store)")
    parser.add_argument(
        "--query-fleet", action="store_true",
        help="build, then only run phase 5 (store and training) and phase "
             "3d (the query fleet)")
    parser.add_argument(
        "--seqrec", action="store_true",
        help="build, then only run phase 5's store, 3e (sequentialrec), 3f "
             "(two-stage serving) and phase 7's sequence half")
    parser.add_argument(
        "--read-paths", action="store_true",
        help="build, then only write phase 5's store and time phase 3e's "
             "read and prepare two ways (indexed block by block; label "
             "columns indexed by np.unique)")
    parser.add_argument(
        "--templates", action="store_true",
        help="build, then only run phase 6e (the other templates at "
             "ML-1M)")
    parser.add_argument(
        "--crossover", action="store_true",
        help="build, then only run phase 8a (the host/device crossover)")
    parser.add_argument(
        "--sequence-parallel", action="store_true",
        help="build, then only run phase 5's store, 3e's and 3f's training "
             "and phase 8d (sequence-parallel encodes, two-stage serving "
             "over four shards)")
    parser.add_argument(
        "--ladder", action="store_true",
        help="build, then only run phase 3g (the serving ladder) on "
             "synthetic stores at ML-20M width")
    parser.add_argument(
        "--training-ladder", action="store_true",
        help="build, then only run phase 5's store and phases 5, 5b, 5c "
             "and 5d (the training ladder: warmed trainings replaying "
             "their CUDA graphs)")
    parser.add_argument(
        "--large-rank", action="store_true",
        help="build, then only run phase 2b's large-rank checks (B3's "
             "tile-group route, B2's block and device-memory routes, the "
             "rank-256 training) and phase 4b's large-rank timings")
    parser.add_argument(
        "--sharded", action="store_true",
        help="build, then only run phase 8a (the host/device crossover), "
             "phase 5 (store and training) and phase 8b (sharded serving)")
    parser.add_argument("--serve-store", metavar="SQLITE_FILE",
                        help=argparse.SUPPRESS)  # phase 6's second process
    parser.add_argument("--templates-child", action="store_true",
                        help=argparse.SUPPRESS)  # phase 6e beside 6b-6d
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    import os

    # every serving phase measures the device store and B1: under auto,
    # host factors up to HOST_SERVE_MAX_ELEMS item-factor elements (ML-1M
    # and ML-20M width among them) would serve from the host lane. The
    # children started below inherit it. Phase 8a builds both lanes
    # itself, phase 8b its stores.
    os.environ["PIO_SERVING_BACKEND"] = "device"
    if args.serve_store:
        return serve_child(args.serve_store)
    if args.templates_child:
        # the kernels are built: the parent built them before starting it
        out = other_templates(resolve_device_cuda(), args.seed,
                              nvidia_smi())
        print(json.dumps({"templates": out}, default=str))
        return 0
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
    if args.ingest_times:
        out = phase("6b event-server ingest", ingest_times, args.seed,
                    args.ingest_times)
        print(json.dumps({"ingest_times": out}))
        print(nvidia_smi())
        return 0
    phase("1 build", build_kernels)
    if args.read_paths:
        store = phase("5 event store", ml20m_store, args.seed)
        try:
            out = phase("3e read paths", sequence_read_paths, args.seed)
        finally:
            remove_store(store)
        print(json.dumps({"read_paths": out}))
        print(nvidia_smi())
        return 0
    if args.templates:
        out = phase("6e other templates", other_templates, dev, args.seed,
                    card)
        print(json.dumps({"templates": out}, default=str))
        print(nvidia_smi())
        return 0
    if args.networked:
        out = phase("6d networked event store", networked_store, args.seed,
                    card)
        print(json.dumps({"networked": out}, default=str))
        print(nvidia_smi())
        return 0
    if args.seqrec:
        store = phase("5 event store", ml20m_store, args.seed)
        try:
            seq = phase("3e seqrec: read, prepare, train",
                        sequence_read_train, dev, args.seed)
            two = phase("3f two-stage: prepare, train", twostage_train, dev,
                        args.seed, seq)
        finally:
            remove_store(store)
        seq.pop("td")
        two.pop("pd")
        ratings = store["ratings"]
        seq_served = phase("3e seqrec: serve, fold-in", seqrec_serve, dev,
                           seq, ratings, args.seed)
        two_served = phase("3f two-stage: serve, fold-in", twostage_serve,
                           dev, seq, two, ratings, args.seed)
        seq_quality = phase("7 sequence quality", sequence_quality, dev)
        print(json.dumps({"seqrec": sequence_summary(
            seq, two, seq_served, two_served, seq_quality)}, default=str))
        print(nvidia_smi())
        return 0
    if args.sequence_parallel:
        store = phase("5 event store", ml20m_store, args.seed)
        try:
            seq = phase("3e seqrec: read, prepare, train",
                        sequence_read_train, dev, args.seed)
            two = phase("3f two-stage: prepare, train", twostage_train, dev,
                        args.seed, seq)
        finally:
            remove_store(store)
        seq.pop("td")
        two.pop("pd")
        out = phase("8d sequence parallel, sharded two-stage",
                    sequence_parallel, dev, seq, two, args.seed)
        print(json.dumps({"sequence_parallel": out}, default=str))
        print(nvidia_smi())
        return 0
    if args.query_fleet:
        store = phase("5 event store", ml20m_store, args.seed)
        try:
            trained = phase("5 training", train_full_width, dev, args.seed,
                            store)
        finally:
            remove_store(store)
        out = phase("3d query fleet", query_fleet_full_width, dev, trained,
                    args.seed, card)
        print(json.dumps({"query_fleet": out}, default=str))
        print(nvidia_smi())
        return 0
    if args.crossover:
        out = phase("8a host/device crossover", host_crossover, dev,
                    args.seed, card)
        print(json.dumps({"crossover": out}))
        print(nvidia_smi())
        return 0
    if args.large_rank:
        out = phase("2b/4b large-rank routes", large_rank_only, dev,
                    args.seed, card)
        print(json.dumps({"large_rank": out}))
        print(nvidia_smi())
        return 0
    if args.ladder:
        out = phase("3g serving ladder", ladder_only, dev, args.seed, card)
        print(json.dumps({"ladder": out}, default=str))
        print(nvidia_smi())
        return 0
    if args.training_ladder:
        store = phase("5 event store", ml20m_store, args.seed)
        try:
            trained = phase("5 training", train_full_width, dev, args.seed,
                            store)
            ingest = phase("5b scale ingest", scale_ingest, dev, args.seed,
                           store, trained)
        finally:
            remove_store(store)
        options = phase("5c training options", training_options, dev,
                        trained, args.seed)
        grid = phase("5d tuning grid", tuning_grid, dev, trained,
                     store["ratings"], args.seed, card)
        print(json.dumps({"training_ladder": {
            "5b": {k: ingest[k] for k in ("warm", "train_s", "launches",
                                          "ladder")},
            "5c": options["warmed"],
            "5d": {k: grid[k] for k in ("warm", "ladder", "grid_s",
                                        "serial_s", "distances")}}},
            default=str))
        print(nvidia_smi())
        return 0
    if args.sharded:
        crossing = phase("8a host/device crossover", host_crossover, dev,
                         args.seed, card)
        store = phase("5 event store", ml20m_store, args.seed)
        try:
            trained = phase("5 training", train_full_width, dev, args.seed,
                            store)
        finally:
            remove_store(store)
        out = phase("8b sharded serving", sharded_serving, dev, trained,
                    args.seed, card)
        trained_sh = phase("8c sharded training", sharded_training, dev,
                           trained, args.seed, card)
        print(json.dumps({"crossover": crossing, "sharded": out,
                          "sharded_training": trained_sh}, default=str))
        print(nvidia_smi())
        return 0
    if args.topk_routes:
        max_err, checked = phase("2 serving kernel checks", kernel_checks,
                                 dev, args.seed)
        out = phase("4c route crossover", route_crossover, dev, args.seed)
        print(json.dumps({"topk_routes": {"max_abs_err": max_err,
                                          "checked_routes": checked, **out}},
                         default=str))
        print(nvidia_smi())
        return 0
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
        seq = phase("3e seqrec: read, prepare, train", sequence_read_train,
                    dev, args.seed)
        two = phase("3f two-stage: prepare, train", twostage_train, dev,
                    args.seed, seq)
        seq.pop("td")
        two.pop("pd")
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
    laddered = phase("3g serving ladder", ladder_phase3, served)
    batched = phase("3c batch predict", batch_predict_full_width, trained,
                    args.seed, card)
    folded = phase("3b fold-in", foldin_full_width, dev, trained,
                   store["ratings"], args.seed, served)
    fleet = phase("3d query fleet", query_fleet_full_width, dev, trained,
                  args.seed, card)
    rows = phase("4 serving kernel times", timings, dev, args.seed)
    crossover = phase("4c route crossover", route_crossover, dev, args.seed)
    train_times = phase("4b training kernel times", training_timings, dev,
                        trained, args.seed)
    large_s = {f"{name} R={r['R']}": r["s"]
               for name, rows_ in train_times["large"].items() for r in rows_}
    large_work_s = train_err["edge_s"] + train_err["grid_s"] \
        + sum(large_s.values()) + train_times["large_iteration"]["s"]
    crossing = phase("8a host/device crossover", host_crossover, dev,
                     args.seed, card)
    sharded = phase("8b sharded serving", sharded_serving, dev, trained,
                    args.seed, card)
    trained_sh = phase("8c sharded training", sharded_training, dev,
                       trained, args.seed, card)
    cycle = phase("6 lifecycle", lifecycle, args.seed)
    # phase 6e runs in a process of its own beside 6b-6d, which spend
    # their time waiting on the console's processes
    child = TemplatesChild(args.seed)
    started = {}
    try:
        started = phase("6b quick start", quick_start, args.seed, cycle,
                        card, True)
        print(f"[budget] the large-rank work {large_work_s:.2f} s: phase "
              f"2b's ranks {EDGE_RANKS} {train_err['edge_s']:.2f} s and "
              f"its tile-group grid check {train_err['grid_s']:.2f} s; "
              f"phase 4b's large-rank timings "
              f"{json.dumps({k: round(v, 2) for k, v in large_s.items()})}"
              f" s; its rank-{LARGE_ITER_RANK} iteration at ML-20M width "
              f"{train_times['large_iteration']['s']:.2f} s. Phase 6b's "
              f"overlap of pio batchpredict with the feedback and fleet "
              f"deploys hides {started['overlap']['hidden_s']:.2f} s. "
              f"Phase 4c's tiled column {crossover['tiled_s']:.2f} s; "
              f"phase 3d (f)'s two console verbs side by side "
              f"{fleet['operator_s']['both']:.2f} s against "
              f"{fleet['operator_s']['status'] + fleet['operator_s']['top']:.2f}"
              f" s one after the other")
        evaluated = phase("6c pio eval", console_eval, args.seed,
                          started["kept"], card)
        networked = phase("6d networked event store", networked_store,
                          args.seed, card)
        started["resume"] = phase(
            "6b crash trio (the rest of its wait)", started["resume"].result)
        templates = phase("6e other templates (the rest of its wait)",
                          child.result)
    finally:
        child.stop()
        if isinstance(started.get("resume"), KillResume):
            started["resume"].stop()
    scored = phase("7 quality", quality, dev)
    seq_served = phase("3e seqrec: serve, fold-in", seqrec_serve, dev, seq,
                       store["ratings"], args.seed)
    two_served = phase("3f two-stage: serve, fold-in", twostage_serve, dev,
                       seq, two, store["ratings"], args.seed)
    sp = phase("8d sequence parallel, sharded two-stage", sequence_parallel,
               dev, seq, two, args.seed)
    seq_quality = phase("7 sequence quality", sequence_quality, dev)
    seq_summary = sequence_summary(seq, two, seq_served, two_served,
                                   seq_quality)
    # the line's headline shape: a full micro-batch (B=256) at the
    # default k bucket (16) on the default GPU store (bf16)
    head = next(r for r in rows
                if (r["store"], r["B"], r["k"]) == ("bf16", 256, 16))
    sh_head = next(r for r in sharded["timings"] if r["B"] == 1)
    kernels = [{
        "name": "fused_gather_score_topk", "route": "cuda",
        "source": "predictionio_tpu_torch/ops/csrc/fused_topk.cu",
        "replaces": "predictionio_tpu/ops/als_pallas.py:453",
        "launches": served["launches"],
        # of them, launched by replays of the serving ladder's CUDA graphs
        "graph_launches": served["graph_launches"], "max_abs_err": max_err,
        "ms": head["ms"], "graph_ms": head["graph_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shape": "bf16 store, B=256, k=16",
        # launches by route on the main path (phase 3) and in phase 2
        "routes": served["routes"], "checked_routes": checked_routes,
        # per k, the batch from which the tiled route is as fast as the
        # chunked route (phase 4c)
        "crossover_batch": crossover["first_tiled"],
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
        # the offline lane: phase 3c's clean run (users_topk per chunk
        # and k, tiled at B >= CHUNKED_MAX_B) and 6b's pio batchpredict
        "batch_routes": {
            "launches": batched["launches"], "by_route": batched["by_route"],
            "queries": batched["queries"], "chunks": batched["chunks"],
            "queries_per_s": batched["queries_per_s"],
            "b1_device_ms": batched["b1_device_ms"],
            "console_launches": started["batchpredict"]["launches"][
                "fused_gather_score_topk"]},
        # phase 6d: the fleet-deployed server's launches (its folds'
        # checks and answers)
        "networked_launches": networked["b1_launches"],
        # the query fleet: phase 3d's replicas and 6b's `pio deploy
        # --fleet 2` child
        **fleet_launches("fused_gather_score_topk", fleet, started),
        # phases 3e and 3f: the sequentialrec model's users lane,
        # and two-stage serving's stage 1 (mask off, k = N = 128), timed
        # at B = 1 and 256 on the deployed store beside stage 2
        "sequence_launches": seq_summary["b1_launches"],
        "unmasked_k128": seq_summary["unmasked_k128"],
        # phase 8b: the sharded route, one launch a shard a dispatch on
        # the ML-20M-width store split four ways, its merge included
        "sharded_route": {
            "launches": sharded["launches"],
            "dispatches": sharded["dispatches"],
            **{key: sh_head[key] for key in (
                "ms", "shard_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by")},
            "shape": f"bf16 store, {SHARDS} shards of "
                     f"{sh_head['positions_per_shard']} positions, B=1, "
                     f"k=16",
            "timings": sharded["timings"]},
        # phase 8d: two-stage serving's stage 1 over 4 shards, one launch
        # a shard a two-lane dispatch, unmasked at k = N
        "twostage_sharded_route": {
            "launches": sp["twostage"]["launches"],
            "dispatches": sp["twostage"]["dispatches"],
            "launches_per_dispatch": sp["twostage"]["launches_per_dispatch"],
            **{key: sp["twostage"]["route"][key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "busy_ms", "b1_ms", "max_abs_err")},
            "b1_us": sp["twostage"]["b1_us"],
            "stage2_us": sp["twostage"]["stage2_us"],
            "shape": f"bf16 store, {SP_SHARDS} shards of "
                     f"{sp['twostage']['route']['positions_per_shard']} "
                     f"positions, B={TWO_SHARD_B}, k={TWO_CANDIDATES}, "
                     f"mask off"},
        # phase 3g: B1 inside the ladder's graphs, graph against eager
        "ladder": {"phase3": laddered, "twostage": two_served["ladder"],
                   "sharded": sharded["ladder"]},
        "timings": rows}]
    # B1's tiled route (k <= 128 in batches of CHUNKED_MAX_B or more):
    # its launches in phase 3c's `pio batchpredict` engine (its main user
    # path), phase 3 and phase 5d's grid_topk; its times at the headline
    # shape (phase 4), beside the bitonic route it replaced there and at
    # grid_topk's shape (phase 4c, both on the same inputs; phase 5d)
    tiled_launches = {"3c": batched["by_route"].get("tiled", 0),
                      "3": served["routes"].get("tiled", 0),
                      "5d": grid["launches"]["topk_routes"].get("tiled", 0)}
    head_4c = crossover["by_batch"]["k=16 B=256"]
    kernels.append({
        "name": "score_select_tile_kernel", "route": "cuda",
        "source": "predictionio_tpu_torch/ops/csrc/fused_topk.cu",
        "replaces": "predictionio_tpu/ops/als_pallas.py:453",
        "launches": tiled_launches["3c"],
        "launches_by_phase": tiled_launches, "max_abs_err": max_err,
        **{key: head[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
        "shape": "bf16 store, B=256, k=16 (the tiled route, its merge and "
                 "bitmap included)",
        "device_ms": head_4c["device_ms"], "tiled_split": head_4c[
            "tiled_split"],
        "grid_topk": {**grid["topk"], "routes_4c": crossover["grid"]},
        "first_tiled_batch": crossover["first_tiled"]})
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
        # the large-rank route: its R = 256 row, the launches of phase
        # 2b's rank-256 training, every timed rank, and phase 4b's
        # rank-256 iteration at ML-20M width
        large = train_times["large"][name]
        li = train_times["large_iteration"]
        routes = [{"route": main_route, "R": RANK,
                   "launches": trained["launches"][name],
                   **train_times["heads"][name]},
                  {**large[0],
                   "launches": train_err["large_rank_training"]["launches"][name],
                   "timings": large,
                   "ml20m_iteration": {
                       "R": li["R"], "iteration_ms": li["iteration_ms"],
                       "device_ms": li["profiled"][
                           "B3" if name.startswith("assemble") else "B2"],
                       "launches": li["launches"][name]}},
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
        # phase 6e: the similarproduct and ecommercerecommendation
        # trainings' uniform route at R=10, timed at their tables' shapes
        u = templates["uniform"]
        routes.append({
            "route": "uniform", "R": OT_ALS["rank"],
            "launches": sum(templates["trainings"][t]["launches"][name]
                            for t in OT_ALS_TEMPLATES),
            **u["heads"][name],
            "shape": "both sides of the similarproduct tables at ML-1M "
                     "(one iteration), R=10",
            "timings": u["rows"][name]})
        if name == "assemble_normal_equations":
            # B3's bf16 route: launches from phase 5c's bf16 training
            routes.append({
                "route": "tiles_bf16", "R": RANK,
                "launches": options["bf16"]["routes"]["tiles/bf16"],
                **train_times["bf16"]["head"],
                "shape": "every bucket of both sides (one iteration), R=64, "
                         "bf16 store",
                "timings": train_times["bf16"]["rows"]})
        # phase 8c: the sharded trainers, once per shard per bucket
        tm = trained_sh["timing"]
        sharded_training_entry = {
            "launches": trained_sh["launches"][name],
            "plan_per_iteration": trained_sh["plan_per_iteration"],
            "single_device_launches": trained["launches"][name],
            "ms_per_iteration": tm["ms_per_iteration"],
            "single_ms_per_iteration": tm["single_ms_per_iteration"],
            "busy_ms": tm["busy_ms"], "busy_share": tm["busy_share"],
            "single_busy_share": tm["single_busy_share"],
            "flavor_launches": trained_sh["flavor"]["launches"][name],
            # phase 4b: the plain version and the library call at the
            # shards' block shapes
            "plain_ms": train_times["sharded_library"]["plain"][name],
            "library_ms": train_times["sharded_library"][name],
            "shape": f"phase 5's bucketed sides on {TRAIN_SHARDS} logical "
                     f"shards of one card, R={RANK}"}
        # the training ladder: the launches by replays of the warmed
        # programs (5b's training, 5c's checkpointed run, 5d's grid), and
        # an iteration as a replay against eager (5b, 5d)
        by_replay = ("assemble_by_replay" if name.startswith("assemble")
                     else "spd_by_replay")

        def modes(ladder):
            return {m: {k: ladder[m][k] for k in (
                "event_ms", "wall_ms", "busy_ms", "busy_share", "B3",
                "B2")} for m in ("replay", "eager")}

        ladder_entry = {
            "launches_by_replay": {
                "5b": ingest["launches"][by_replay],
                "5c": options["warmed"]["launches"][by_replay],
                "5d": grid["replayed"][by_replay]},
            "iteration": modes(ingest["ladder"]),
            "grid_iteration": modes(grid["ladder"]),
            "pool_bytes": {"5b": ingest["warm"]["pool_bytes"],
                           "5d": grid["warm"]["pool_bytes"]}}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "predictionio_tpu_torch/ops/csrc/als_solve.cu",
            "replaces": f"predictionio_tpu/ops/als_pallas.py:{replaces}",
            "launches": trained["launches"][name], "max_abs_err": err,
            **train_times["heads"][name], "shape": shape,
            "routes": routes, "timings": train_times["rows"][name],
            # the folds of 6b's `pio deploy --fleet 2 --foldin on` child,
            # and apart, phase 3d's training of the roll's instance
            **fleet_launches(name, fleet, started),
            # phase 3f: the two-stage engine's ALS half and its fold-in
            "twostage_launches": {
                "training": two["launches"][name],
                "fold": two_served["fold_launches"][name]},
            # phase 6d: ML-1M trainings from each event source, and the
            # folds through the fleet cursor
            "networked_launches": {
                **{f"train_{label}": res["launches"][name]
                   for label, res in networked["train"].items()},
                "folds": networked["fold_launches"][name]},
            # phase 6e: each ALS template's training at ML-1M
            "templates_launches": {
                t: templates["trainings"][t]["launches"][name]
                for t in OT_ALS_TEMPLATES},
            "sharded_training": sharded_training_entry,
            "training_ladder": ladder_entry})
    print(f"[done] {time.perf_counter() - t0:.1f} s; HTTP p50 "
          f"{served['p50_ms']!r} ms p99 {served['p99_ms']!r} ms "
          f"(observability on / off p50 "
          f"{served['overhead']['on']['p50_ms']!r} / "
          f"{served['overhead']['off']['p50_ms']!r} ms); training "
          f"iteration {trained['iteration_ms']!r} ms (as a replay of its "
          f"graph {ingest['ladder']['replay']['event_ms']!r} ms event-timed "
          f"against {ingest['ladder']['eager']['event_ms']!r} eager; bf16 "
          f"lane "
          f"{options['bf16']['iteration']['bf16']['wall_ms']!r} ms; "
          f"checkpoint_every=1 wall ratio fp32 "
          f"{options['checkpoint_fp32']['overhead']!r}, bf16 "
          f"{options['checkpoint_bf16']['overhead']!r}); tuning grid "
          f"{grid['grid_s']!r} s ({grid['iteration_ms']!r} ms an iteration, "
          f"the serial trainings {grid['serial_s']!r} s); pio eval --grid "
          f"{evaluated['grid']['s']!r} s, pio eval "
          f"{evaluated['evaluation']['s']!r} s; networked store: fleet "
          f"write {networked['write']['fleet_events_per_s']!r} events/s, "
          f"fold event -> servable p99 {networked['servable_p99_s']!r} s, "
          f"killed shard's users servable "
          f"{networked['restart_delay_s']!r} s after its restart; "
          f"query fleet: sequential p50 through the balancer "
          f"{fleet['sequential']['balancer']['p50_ms']!r} ms, straight to "
          f"the replica {fleet['sequential']['direct']['p50_ms']!r} ms, "
          f"burst queries/s by replicas and clients "
          f"{json.dumps(fleet['burst_qps'])}, a new user servable through "
          f"6b's fleet in {started['fleet']['servable_s']!r} s; "
          f"batch predict "
          f"{batched['queries_per_s']!r} queries/s over "
          f"{batched['queries']} queries; fold-in event -> "
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
          f"seqrec training {seq['tokens_per_s']!r} tokens/s, query p50 "
          f"{seq_served['p50_ms']!r} ms; two-stage query p50 "
          f"{two_served['p50_ms']!r} ms (stage 2 {two_served['stage2_us']!r}"
          f" us beside B1 {two_served['b1_us']!r} us a dispatch); other "
          f"templates: query p50 ms "
          f"{json.dumps({k: v['p50_ms'] for k, v in templates['served'].items()})}"
          f", text held-out accuracy {templates['text']['accuracy']!r}; "
          f"host lane up to {crossing['supported_limit']} item-factor "
          f"elements by phase 8a (HOST_SERVE_MAX_ELEMS "
          f"{crossing['limit']}); sharded dispatch (4 shards, B=1) "
          f"{sh_head['ms']!r} ms; sharded training iteration (4 shards) "
          f"{trained_sh['timing']['ms_per_iteration']!r} ms against "
          f"{trained_sh['timing']['single_ms_per_iteration']!r}; "
          f"sequence-parallel encode s "
          f"{json.dumps({k: v['s'] for k, v in sp['encode'].items()})}; "
          f"two-stage over {SP_SHARDS} shards: B1 "
          f"{sp['twostage']['launches_per_dispatch']!r} launches a "
          f"dispatch, a lone dispatch {sp['twostage']['lone']['ms']!r} ms; "
          f"the serving ladder (graph against eager, host ms): B = 1 "
          f"{laddered['lone_b1']['graph']['host_ms']!r} / "
          f"{laddered['lone_b1']['eager']['host_ms']!r}, two-stage B = 8 "
          f"{two_served['ladder']['two_b8']['graph']['host_ms']!r} / "
          f"{two_served['ladder']['two_b8']['eager']['host_ms']!r}, 4 shards "
          f"B = 1 {sharded['ladder']['lone_b1']['graph']['host_ms']!r} / "
          f"{sharded['ladder']['lone_b1']['eager']['host_ms']!r}; ladder "
          f"bytes {laddered['warm']['bytes']} (phase 3, k to M), "
          f"{two_served['ladder']['warm']['bytes']} (two-stage); "
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
