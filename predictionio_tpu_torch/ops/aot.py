"""The program caches of the serving and training ladders, and their
CUDA-graph capture.

The port's counterpart of ``predictionio_tpu/ops/aot.py``. There,
``lower_compile`` turns a jitted program into an XLA executable ahead of
the first query. On the card the same promise (no live query pays for
building its program) is kept by a CUDA graph: :func:`capture` runs a
ladder entry's program once eagerly on a side stream, captures it, and
hands back a :class:`GraphProgram` whose call copies the query's inputs
into the graph's static buffers and replays the recorded kernels (B1,
the hand-written ``csrc/fused_topk.cu``, among them) with one launch.

:class:`AOTCache` is the JAX package's bounded, thread-safe FIFO, with
the same ``get`` / ``put`` / ``clear`` / ``keys`` / ``evictions`` /
``stats`` / ``memory_report``. Evictions are logged with the dropped key
and counted in ``pio_aot_cache_evictions_total``; ``memory_report``
sums each program's measured device bytes (:meth:`GraphProgram.
memory_bytes`).

On the CPU, used only when the caller asks for it, a program is the
entry's function bound to the same static buffers, run on each call:
every cache path works the same, and only the capture waits for a card.
A capture that fails on a CUDA device raises; it is never served
eagerly in its place.

The training programs of :mod:`~predictionio_tpu_torch.ops.als` (one
ALS iteration, the config grid's, the objective samples) share one
:class:`SharedPool` per device (:func:`train_pool`), apart from the
stores' pools: captured on the device's one capture stream, each reuses
the scratch the others freed, so their work must never overlap, which
:meth:`SharedPool.ordered` enforces.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import weakref
from typing import (Any, Callable, Dict, Hashable, Iterator, Optional,
                    Sequence, Tuple)

import torch

from predictionio_tpu_torch.ops import als_cuda

logger = logging.getLogger("pio.aot")


class AOTCache:
    """Bounded, thread-safe FIFO of ladder programs.

    Bounded because each entry pins device memory (its graph and its
    static buffers): a long-lived process warming ever-new shapes must
    not keep programs forever. Races on ``put`` are benign: the first
    program for a key wins the slot."""

    def __init__(self, max_entries: int = 8, name: str = "aot"):
        self._max = int(max_entries)
        self.name = str(name)
        self._lock = threading.Lock()
        self._entries: Dict[Hashable, Any] = {}
        self._evictions = 0

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            return self._entries.get(key)

    def put(self, key: Hashable, compiled: Any) -> None:
        dropped = []
        with self._lock:
            if key in self._entries:
                return
            while len(self._entries) >= self._max:
                old_key = next(iter(self._entries))
                self._entries.pop(old_key)
                self._evictions += 1
                dropped.append(old_key)
            self._entries[key] = compiled
        if dropped:
            from predictionio_tpu_torch.utils import metrics

            metrics.AOT_CACHE_EVICTIONS.inc(amount=len(dropped))
            for old_key in dropped:
                # name which program fell out: under fold-in growth a
                # thrashing ladder shows up as a rising eviction count
                logger.warning(
                    "%s cache full (%d entries): evicted program for %r to "
                    "admit %r", self.name, self._max, old_key, key)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def keys(self) -> Iterator[Hashable]:
        with self._lock:
            return iter(tuple(self._entries))

    @property
    def evictions(self) -> int:
        with self._lock:
            return self._evictions

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries),
                    "maxEntries": self._max,
                    "evictions": self._evictions}

    def memory_report(self) -> Dict[str, Any]:
        """Device bytes over every cached program (each program's own
        measurement, :meth:`GraphProgram.memory_bytes`): the total and
        how many entries had one."""
        with self._lock:
            entries = list(self._entries.values())
        total = analyzed = 0
        for prog in entries:
            size = getattr(prog, "memory_bytes", lambda: None)()
            if size is not None:
                total += int(size)
                analyzed += 1
        return {"entries": len(entries), "entriesAnalyzed": analyzed,
                "totalBytes": total}


def pool_bytes(pool, device: torch.device) -> int:
    """Device bytes the caching allocator holds in the graph memory pool
    ``pool`` on ``device``, read from its segment snapshot."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    want = tuple(pool)
    return sum(int(seg["total_size"])
               for seg in torch.cuda.memory.memory_snapshot()
               if seg.get("device") == index
               and tuple(seg.get("segment_pool_id", ())) == want)


class GraphProgram:
    """One ladder entry: ``fn`` bound to static input buffers.

    On a CUDA device the program holds the captured ``graph``, its static
    ``inputs`` and ``outputs``, the ``(counter, key)`` of each kernel
    launch the capture recorded (``launches``), the device bytes its
    capture added to the graph pool (``pool_bytes``) and ``events``, two
    timing events the graph itself records around ``fn``'s work at each
    replay (None where this runtime cannot time them). A call copies the host inputs
    into the static buffers (stream-ordered, before the replay), replays
    the graph on the current stream, counts the recorded launches, and
    returns the static outputs, which the next call of this program
    overwrites: the caller copies them out first. A caller that reads
    ``events`` holds ``lock`` from the call to the read, so no other
    replay records them meanwhile. On the CPU a call runs ``fn`` on the
    static buffers. ``keep`` holds what the graph reads beside its
    buffers (the store's tables), alive as long as the program."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor], *,
                 graph=None, outputs: Any = None,
                 launches: Tuple = (), pool_bytes: Optional[int] = None,
                 events: Optional[Tuple] = None, keep: Any = None):
        self.fn = fn
        self.keep = keep
        self.inputs = tuple(inputs)
        self.graph = graph
        self.outputs = outputs
        self.launches = tuple(launches)
        self.pool_bytes = pool_bytes
        self.events = events
        self.lock = threading.Lock()

    def __call__(self, *host_inputs) -> Any:
        for buf, x in zip(self.inputs, host_inputs):
            buf.copy_(_as_tensor(x), non_blocking=True)
        if self.graph is None:
            return self.fn(*self.inputs)
        self.graph.replay()
        als_cuda.note_replay(self.launches)
        return self.outputs

    def memory_bytes(self) -> int:
        """Device bytes this program holds: its share of the graph pool
        (measured at capture) on the card, its static buffers on the
        CPU."""
        if self.graph is not None:
            return int(self.pool_bytes or 0)
        return sum(int(t.nbytes) for t in self.inputs)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(x)


# captures of one process run one at a time: each measures what it adds
# to its pool, and a capture's allocations must not interleave another's
_capture_lock = threading.Lock()
# one capture stream per device: the caching allocator reuses a freed
# block only on the stream that allocated it, so graphs captured on one
# stream into a shared pool reuse each other's freed scratch
_capture_streams: Dict[int, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _capture_streams:
        _capture_streams[index] = torch.cuda.Stream(device)
    return _capture_streams[index]


def capture(fn: Callable, static_inputs: Sequence[torch.Tensor], *,
            pool=None, keep: Any = None) -> GraphProgram:
    """``fn(*static_inputs)`` as a :class:`GraphProgram`.

    On a CUDA device: one eager run on the device's capture stream (it
    sets up what a first call sets up, outside the graph), then the
    capture on that stream, from ``capture_begin(capture_error_mode=
    "thread_local")`` to ``capture_end()`` as ``torch.cuda.graph`` makes
    it (other threads keep launching on their own streams meanwhile),
    into ``pool``
    (a ``torch.cuda.graph_pool_handle()`` the graphs of one store share,
    or None for a pool of its own), ``keep`` held by the program. The
    kernels' launches inside the capture are recorded, not counted; each
    replay counts them. Two external timing events are captured around
    ``fn``'s work, so a
    replay's device time has no host time in it (a host clock, or an
    event recorded beside the replay, would take in whatever delays the
    launching thread); one trial replay checks that they time. A failed
    capture raises. On the CPU: ``fn`` bound to the buffers."""
    inputs = tuple(static_inputs)
    if not inputs or inputs[0].device.type != "cuda":
        return GraphProgram(fn, inputs, keep=keep)
    device = inputs[0].device
    with _capture_lock:
        side = _capture_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        graph = torch.cuda.CUDAGraph()
        events = tuple(torch.cuda.Event(enable_timing=True, external=True)
                       for _ in range(2))
        before = 0 if pool is None else pool_bytes(pool, device)
        with torch.cuda.stream(side):
            fn(*inputs)
            # capture_begin / capture_end as torch.cuda.graph enters and
            # leaves it, without its device-wide synchronize and cache
            # flush, which would stall every other store's queries
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                with als_cuda.recording_launches() as launches:
                    events[0].record()
                    outputs = fn(*inputs)
                    events[1].record()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture was invalidated by the failure
                raise
            graph.capture_end()
            graph.replay()
            als_cuda.note_replay(launches)
        side.synchronize()
        torch.cuda.current_stream(device).wait_stream(side)
        added = pool_bytes(graph.pool(), device) - before
        try:
            events[0].elapsed_time(events[1])
        except RuntimeError:
            logger.warning("this runtime cannot time events inside a CUDA "
                           "graph: replays record no device time")
            events = None
    return GraphProgram(fn, inputs, graph=graph, outputs=outputs,
                        launches=tuple(launches), pool_bytes=max(0, added),
                        events=events, keep=keep)


class SharedPool:
    """A graph memory pool whose programs share their scratch, and the
    order of their work. Captured into one pool on one stream, a program
    reuses the blocks the programs before it freed, so two of them must
    never run at once: every capture (:meth:`capture`) and replay of them
    runs inside :meth:`ordered`. ``handle`` is None until the first
    capture on the card, and on the CPU, where nothing is captured."""

    def __init__(self, device: torch.device):
        self.device = device
        self.handle = None
        self._lock = threading.Lock()
        self._done = None
        self._programs: "weakref.WeakSet[GraphProgram]" = weakref.WeakSet()

    @contextlib.contextmanager
    def ordered(self):
        """Hold the pool for the block: one thread at a time, and on the
        card the caller's current stream waits for the pool's last work
        before the block's and is marked after it, whichever stream that
        work ran on."""
        with self._lock:
            if self.device.type != "cuda":
                yield
                return
            stream = torch.cuda.current_stream(self.device)
            if self._done is not None:
                stream.wait_event(self._done)
            try:
                yield
            finally:
                self._done = torch.cuda.Event()
                self._done.record(stream)

    def capture(self, fn: Callable, static_inputs: Sequence[torch.Tensor]
                ) -> GraphProgram:
        """:func:`capture` into this pool, in order. Once every program
        of the pool is gone the allocators release it and take no
        capture into its id again, so the next capture opens a fresh
        pool."""
        with self.ordered():
            if self.device.type == "cuda" and not self._programs:
                self.handle = torch.cuda.graph_pool_handle()
            program = capture(fn, static_inputs, pool=self.handle)
            self._programs.add(program)
        return program

    def nbytes(self) -> int:
        """Device bytes the pool holds (0 before a capture and on the
        CPU)."""
        return 0 if self.handle is None else pool_bytes(self.handle,
                                                        self.device)


_train_pools: Dict[Tuple[str, Optional[int]], SharedPool] = {}
_train_pools_lock = threading.Lock()


def train_pool(device: torch.device) -> SharedPool:
    """``device``'s pool for the training programs, made at first use."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device.type, device.index)
    with _train_pools_lock:
        if key not in _train_pools:
            _train_pools[key] = SharedPool(device)
        return _train_pools[key]


__all__ = ["AOTCache", "GraphProgram", "SharedPool", "capture", "pool_bytes",
           "train_pool"]
