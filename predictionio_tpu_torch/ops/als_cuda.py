"""The port's hand-written CUDA kernels for ALS, and their plain versions.

Counterpart of ``predictionio_tpu/ops/als_pallas.py``; each TPU kernel
there has one here:

- ``fused_gather_score_topk`` (serving; the TPU kernel at
  ``als_pallas.py:453``, body ``_fused_topk_body``, selection
  ``_topk_select_body``) is ``csrc/fused_topk.cu``. Bound on an H100:
  the item table is read once, ``M*R*bytes(dtype)`` bytes at 3.35 TB/s,
  and the scores cost ``2*B*M*R`` fp32 FMAs at the 67 TFLOP/s non-tensor
  fp32 rate; bytes bind at small B, operations at B=256. The design
  scores with fp32 FMAs only (the reference pins ``Precision.HIGHEST``),
  masks seen items by one scatter per (slot, query) instead of comparing
  every tile with every seen slot, and orders each query's row by the
  route that :func:`topk_sort_plan` picks: for k up to 128 on rows over
  2,048 items (personal top-N queries) in batches too small to fill the
  card with one block per query, a radix select per 2,048-item chunk,
  one block each, into a candidate row per query in item order, then
  one block per query selecting and sorting the k winners of that row
  (exactly what one select over the row gives); else a radix select
  and a bitonic sort in shared memory while the sort width is at most
  2,048; above it (category queries ask for nearly every item)
  a stable LSD radix sort of the whole row, in id order, so the lowest
  id stays first among equal scores, by a cluster of 8 blocks that hold
  the row in their shared memory and scatter through distributed shared
  memory, or by one block through a device-memory scratch the wrapper
  allocates, for a row too wide for the cluster. The [B, M] scores make
  one round trip through device memory; keeping them on chip is later
  work.
- ``assemble_normal_equations`` (training; ``als_pallas.py:141``, kernel
  ``_kernel``) is ``assemble_kernel`` in ``csrc/als_solve.cu``. Bound:
  ``slots*(R(R+1) + 2R)`` fp32 operations (``A`` is symmetric: one FMA
  per entry of its upper triangle, and ``R`` for ``b``, per real slot)
  against ``Y`` read once (it fits in L2), the ``[B, L]`` tables and
  the ``A``/``b`` outputs; the operations bind except for the shortest
  rows. :func:`assembly_plan` cuts rows longer than ``ASSEMBLY_SPAN``
  slots into spans, one block each, whose partial sums a second pass
  adds to ``gram`` in span order (deterministic, no float atomics). A
  block sums only the upper 8x8 tiles of ``A`` and mirrors them as it
  writes; each thread holds one tile in registers fed by 16-byte
  shared-memory loads. A block stages its slice of the ``[B, L]``
  tables in shared memory once, and the next chunk of gathered factor
  rows arrives by ``cp.async`` while this one is summed, one barrier a
  chunk. No ``[B, L, R]`` gather reaches device memory; padding slots
  are neither gathered nor summed. Ranks up to 208 on an H100; above
  that :func:`assembly_route` picks ``assemble_large_rank_kernel`` in
  the same source, one block per (row, 32x32 tile of ``A``'s upper
  triangle) and one for ``b``, which takes any rank. Both take the
  factor store ``Y`` fp32 or bf16 (the bf16 training precision): a bf16
  row is converted to fp32 as it is gathered, so everything after the
  gather is the fp32 route's arithmetic, and the bound reads ``Y`` as
  ``M*R*bytes(Y)``. The config grid (JAX ``vmap``s the assembly over a
  leading config axis) is :func:`assemble_normal_equations_grid`: one
  launch of ``assemble_kernel`` for ``k`` configs, the config in
  ``blockIdx.y``, each summed as its own launch would sum it (bitwise);
  its bound is ``k`` times one config's.
- ``spd_solve`` (training; ``als_pallas.py:277``, kernel
  ``_spd_solve_kernel``) is ``spd_solve_warp_kernel`` in the same
  source. Bound: ``B*(R(R+1)/2+2R)*4`` bytes (the upper triangle of
  ``A``, ``b`` and ``x``) against ``B*(R^3/3+2R^2)`` operations; the
  bytes bind. One warp per system, no block barriers: non-pivoted,
  up-looking Cholesky with the pivot clamped at ``max(d, 1e-30)``, row
  by row in registers, then two substitutions, each entry taking the
  plain version's operations in its order (bitwise equal to it). The
  warp's workspace (the packed upper triangle of ``U`` and ``v``) lives
  in shared memory or, at ranks where fewer than two fit a block, in
  device memory: :func:`spd_solve_plan` picks the route, and any rank
  runs.

For a CUDA tensor each wrapper launches its kernel or raises; for a CPU
tensor it runs the plain PyTorch version beside it, which the tests
hold against the JAX package. Each wrapper counts its launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from predictionio_tpu_torch.ops._build import LaunchCounter, load_kernel_library
from predictionio_tpu_torch.ops.quantize import dequantize_rows, is_quantized

# The serving store pads its item table to this multiple once, so score
# rows start 512-byte aligned; pad rows sit past n_items and score -inf.
TOPK_TILE_M = 128

KERNEL_NAME = "fused_topk"
SOLVE_KERNEL_NAME = "als_solve"
KERNEL_NAMES = (KERNEL_NAME, SOLVE_KERNEL_NAME)
launches = LaunchCounter()
assemble_launches = LaunchCounter()
spd_launches = LaunchCounter()
# the serving kernel's route last taken on each thread ("plain" for the
# plain version): what the flight recorder names as the dispatch's kernel
_route = threading.local()


def last_route() -> Optional[str]:
    """The route of this thread's last top-k (a kernel route, or
    ``"plain"``), or None before its first."""
    return getattr(_route, "last", None)


_Y_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_bound = None
_ready_devices: dict = {}
_solve_bound = None
_solve_ready: dict = {}
_bind_lock = threading.Lock()


def _kernel(device: int):
    """(launch fn, error-string fn, the widest row the cluster sort takes
    on ``device``), bound once per process and set up once per device;
    the first call builds the library."""
    global _bound
    with _bind_lock:
        if _bound is None:
            lib = load_kernel_library(KERNEL_NAME)
            fn = lib.pio_fused_topk
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn.argtypes = [i, p, i, i, p, i, p, p, i, i, p, p, i, ll, ll, ll,
                           ll, i, i, i, p, p, ll, p, p, p, p, p]
            fn.restype = ctypes.c_int
            err = lib.pio_cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            for name in ("pio_topk_cluster_max_row", "pio_fused_topk_init"):
                getattr(lib, name).argtypes = [i]
                getattr(lib, name).restype = i
            _bound = (lib, fn, err)
        lib, fn, err_string = _bound
        if device not in _ready_devices:
            code = lib.pio_fused_topk_init(device)
            if code:
                raise RuntimeError(f"fused_topk set-up on cuda:{device} "
                                   f"failed: CUDA error {code} "
                                   f"({err_string(code).decode()})")
            _ready_devices[device] = int(lib.pio_topk_cluster_max_row(device))
    return fn, err_string, _ready_devices[device]


class TopkSortPlan(NamedTuple):
    """How the selection kernels order one query's row.

    ``route``: "chunked" (each chunk of ``TOPK_CHUNK`` items selects its
    own top k, one block each, into a candidate row of ``scratch_pairs``
    value/id pairs per query, in item order; one block per query then
    selects and sorts the k winners of that row), "bitonic" (a radix
    select of the k winners of the whole row and a bitonic sort of them
    in shared memory), "cluster_row" (no select: a stable radix sort of
    the whole row, in id order, by a cluster of blocks that hold it in
    their shared memory; the first k are kept) or "radix_row" (the same
    by one block, in device memory, for a row wider than the cluster
    holds). ``scratch_pairs``: key/id pairs of device memory per query."""

    route: str
    scratch_pairs: int


# Widest bitonic sort (a power of two >= k); wider k sort the whole row.
BITONIC_MAX = 2048
# The chunked route: items per chunk (one block selects each; the
# kernel's TOPK_CHUNK), and the widest k it takes.
TOPK_CHUNK = 2048
CHUNK_K_MAX = 128
# The chunked route takes batches below this many queries. From there
# the bitonic route's one block per query fills enough of the card that
# reading the row five times from L2 costs less than the chunk blocks'
# fixed costs: on an H100 80GB HBM3 (700 W) its device time was at most
# the chunked route's from B = 96 on, at k = 16 and at k = 128, and
# above it at B = 64 (chip_smoke.py phase 4c).
CHUNKED_MAX_B = 96
_ROUTE_CODE = {"bitonic": 0, "cluster_row": 1, "radix_row": 2, "chunked": 3}


def chunk_candidates(k: int, m: int) -> int:
    """Candidates per query of the chunked route: ``min(k, n_c)`` from
    each chunk of ``n_c`` items. Every chunk but the last holds
    ``TOPK_CHUNK >= k`` items, so the candidate row has no gaps."""
    if not 0 < k <= CHUNK_K_MAX:
        raise ValueError(f"the chunked route takes k in [1, {CHUNK_K_MAX}], "
                         f"got {k}")
    last = m - (-(-m // TOPK_CHUNK) - 1) * TOPK_CHUNK
    return (m - last) // TOPK_CHUNK * k + min(k, last)


def topk_sort_plan(k: int, m: int, batch: int,
                   cluster_max_row: int) -> TopkSortPlan:
    """The sort route and scratch of a top-``k`` over ``m`` items for
    ``batch`` queries when the cluster sort takes rows of up to
    ``cluster_max_row`` items (the library's ``pio_topk_cluster_max_row``).
    The kernel launches the route it is given; it refuses only a launch
    its buffers cannot hold."""
    if k <= CHUNK_K_MAX and m > TOPK_CHUNK and batch < CHUNKED_MAX_B:
        return TopkSortPlan("chunked", chunk_candidates(k, m))
    if 1 << (k - 1).bit_length() <= BITONIC_MAX:
        return TopkSortPlan("bitonic", 0)
    if m <= cluster_max_row:
        return TopkSortPlan("cluster_row", 0)
    return TopkSortPlan("radix_row", 2 * m)


def _check_k(k: int, m: int) -> int:
    k = int(k)
    if not 1 <= k <= m:
        raise ValueError(f"k={k} must lie in [1, {m}] (the item table's rows)")
    return k


def fused_gather_score_topk(Q: torch.Tensor, Y, seen_cols: Optional[torch.Tensor],
                            seen_mask: Optional[torch.Tensor], *, k: int,
                            n_items: int, mask_seen: bool = True,
                            row_valid: Optional[torch.Tensor] = None,
                            events: Optional[Tuple] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``top_k(mask(Y @ Q^T))`` per query row, the contract of the JAX
    package's ``als_pallas.fused_gather_score_topk``.

    ``Q [B, R]`` fp32 queries; ``Y`` the item store, a dense ``[M, R]``
    fp32/bf16 tensor or an int8 :class:`QuantFactors` whose per-row
    scales dequantize in the kernel; ``seen_cols``/``seen_mask`` ``[L,
    B]`` per-query masked item ids (any strides; ignored when
    ``mask_seen`` is False); ``row_valid`` an optional ``[M]`` vector
    (>0 = real item). Rows with id >= ``n_items`` are padding.

    Returns ``(vals [B, k] f32, idx [B, k] i32)``, rows descending, ties
    to the lowest item id, -inf past the valid candidates (the ids of
    -inf slots are unspecified).

    ``events``, a pair of ``torch.cuda.Event(enable_timing=True)``, is
    recorded on the launching stream just before the first kernel and
    just after the last (inside the one native launch call), so its
    elapsed time, read once the results are on the host, is the kernels'
    own: the flight recorder's device time."""
    data = Y.data if is_quantized(Y) else Y
    if data.device.type == "cpu":
        return fused_gather_score_topk_plain(
            Q, Y, seen_cols, seen_mask, k=k, n_items=n_items,
            mask_seen=mask_seen, row_valid=row_valid)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    return _launch(Q, Y, seen_cols, seen_mask, k=k, n_items=n_items,
                   mask_seen=mask_seen, row_valid=row_valid, events=events)


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
             device: torch.device, contiguous: bool = True) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _check_launch(err: int, what: str, err_string) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({err_string(err).decode()})")


def _launch(Q, Y, seen_cols, seen_mask, *, k, n_items, mask_seen, row_valid,
            route: Optional[str] = None, events: Optional[Tuple] = None):
    """Launch the kernel on the route :func:`topk_sort_plan` picks, or on
    ``route`` ("chunked" or "bitonic", where the shape allows it: the
    measurement of the batch at which one overtakes the other)."""
    quant = is_quantized(Y)
    data = Y.data if quant else Y
    dev = data.device
    if data.ndim != 2:
        raise ValueError(f"Y must be [M, R], got shape {tuple(data.shape)}")
    M, R = data.shape
    code = _Y_DTYPE_CODE.get(data.dtype)
    if code is None or (code == 2) != quant:
        raise TypeError(f"Y must be fp32, bf16 or an int8 QuantFactors; got "
                        f"{data.dtype}{' (quantized)' if quant else ''}")
    if not data.is_contiguous():
        raise ValueError("Y must be contiguous")
    B = Q.shape[0]
    _require(Q, "Q", torch.float32, (B, R), dev)
    k = _check_k(k, M)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return vals, idx
    scale = None
    if quant:
        _require(Y.scale, "Y.scale", torch.float32, (M,), dev)
        scale = Y.scale.data_ptr()
    rv = None
    if row_valid is not None:
        _require(row_valid, "row_valid", torch.float32, (M,), dev)
        rv = row_valid.data_ptr()
    L, sc_ptr, sm_ptr, strides = 0, None, None, (0, 0, 0, 0)
    if mask_seen:
        L = seen_cols.shape[0]
        _require(seen_cols, "seen_cols", torch.int32, (L, B), dev,
                 contiguous=False)
        _require(seen_mask, "seen_mask", torch.float32, (L, B), dev,
                 contiguous=False)
        sc_ptr, sm_ptr = seen_cols.data_ptr(), seen_mask.data_ptr()
        strides = (*seen_cols.stride(), *seen_mask.stride())
    device = _device_index(dev)
    fn, err_string, cluster_max_row = _kernel(device)
    plan = topk_sort_plan(k, M, B, cluster_max_row)
    if route == "chunked":
        plan = TopkSortPlan(route, chunk_candidates(k, M))
    elif route is not None:
        plan = TopkSortPlan(route, 0)
    # the [B, M] scores, then the route's scratch (B rows of 2 *
    # scratch_pairs words), in one allocation
    buf = torch.empty(B * (M + 2 * plan.scratch_pairs), dtype=torch.float32,
                      device=dev)
    scratch = buf.data_ptr() + B * M * 4 if plan.scratch_pairs else None
    current = torch.cuda.current_stream(dev)
    ev_start = ev_end = None
    if events is not None:
        # torch creates an event's CUDA handle at its first record; the
        # native call records both again around the kernels
        for ev in events:
            ev.record(current)
        ev_start, ev_end = events[0].cuda_event, events[1].cuda_event
    _check_launch(fn(device, Q.data_ptr(), B, R, data.data_ptr(), code, scale,
                     rv, M, int(n_items), sc_ptr, sm_ptr, L, *strides,
                     int(bool(mask_seen)), k, _ROUTE_CODE[plan.route],
                     buf.data_ptr(), scratch, plan.scratch_pairs,
                     vals.data_ptr(), idx.data_ptr(), current.cuda_stream,
                     ev_start, ev_end),
                  "fused_topk", err_string)
    launches.add((plan.route, k, B))
    _route.last = plan.route
    return vals, idx


def fused_gather_score_topk_plain(Q: torch.Tensor, Y,
                                  seen_cols: Optional[torch.Tensor],
                                  seen_mask: Optional[torch.Tensor], *, k: int,
                                  n_items: int, mask_seen: bool = True,
                                  row_valid: Optional[torch.Tensor] = None,
                                  events: Optional[Tuple] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`fused_gather_score_topk`:
    :func:`masked_scores_plain`, then a stable descending sort (so ties
    go to the lowest item id, as in ``lax.top_k``; ``torch.topk`` does
    not promise that). ``events`` (CUDA tensors only) are recorded on the
    current stream around its work."""
    data = Y.data if is_quantized(Y) else Y
    k = _check_k(k, data.shape[0])
    if events is not None:
        events[0].record(torch.cuda.current_stream(data.device))
    scores = masked_scores_plain(Q, Y, seen_cols, seen_mask, n_items=n_items,
                                 mask_seen=mask_seen, row_valid=row_valid)
    vals, order = torch.sort(scores, dim=1, descending=True, stable=True)
    out = vals[:, :k].contiguous(), order[:, :k].to(torch.int32)
    if events is not None:
        events[1].record(torch.cuda.current_stream(data.device))
    _route.last = "plain"
    return out


def masked_scores_plain(Q: torch.Tensor, Y, seen_cols: Optional[torch.Tensor],
                        seen_mask: Optional[torch.Tensor], *, n_items: int,
                        mask_seen: bool = True,
                        row_valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The ``[B, M]`` scores that :func:`fused_gather_score_topk` ranks:
    an fp32 product, -inf on padding rows, invalid rows and each query's
    seen items."""
    Yf = dequantize_rows(Y) if is_quantized(Y) else Y.float()
    M = Yf.shape[0]
    # + 0.0 turns -0.0 into +0.0, so the two tie as in the kernel
    scores = Q.float() @ Yf.T + 0.0
    invalid = torch.arange(M, device=Yf.device) >= n_items
    if row_valid is not None:
        invalid |= ~(row_valid > 0)
    scores = scores.masked_fill(invalid[None, :], float("-inf"))
    if mask_seen:
        cols = seen_cols.long()
        hit = (seen_mask > 0) & (cols >= 0) & (cols < M)       # [L, B]
        slot, query = hit.nonzero(as_tuple=True)
        scores[query, cols[slot, query]] = float("-inf")
    return scores


# -- training: normal-equation assembly and the batched SPD solve ------------

class _SolveLib(NamedTuple):
    assemble: object
    assemble_grid: object
    assemble_large: object
    solve: object
    err_string: object
    assemble_max_rank: int   # assemble_kernel's limit on this device
    smem_optin: int          # shared memory one block may opt into


def _solve_kernels(device: int) -> _SolveLib:
    """The training kernels' entry points and ``device``'s limits, bound
    once per process and set up once per device; the first call builds
    the library."""
    global _solve_bound
    with _bind_lock:
        if _solve_bound is None:
            lib = load_kernel_library(SOLVE_KERNEL_NAME)
            p, i = ctypes.c_void_p, ctypes.c_int
            asm = lib.pio_assemble_normal_equations
            asm.argtypes = [i, p, i, i, i, p, p, p, i, i, i, i, i, p, p, p,
                            p, p, p, p]
            asm.restype = i
            grid = lib.pio_assemble_normal_equations_grid
            grid.argtypes = [i, p, i, i, i, i, p, p, p, i, i, i, i, i, p, p,
                             p, p, p, p, p]
            grid.restype = i
            large = lib.pio_assemble_large_rank
            large.argtypes = [i, p, i, i, i, p, p, p, i, i, p, p, p, p, p,
                              p]
            large.restype = i
            solve = lib.pio_spd_solve
            solve.argtypes = [i, p, p, i, i, p, i, i, p, i, p, p, p]
            solve.restype = i
            err = lib.pio_als_error_string
            err.argtypes = [i]
            err.restype = ctypes.c_char_p
            for name in ("pio_assemble_max_rank", "pio_als_smem_optin",
                         "pio_als_solve_init"):
                getattr(lib, name).argtypes = [i]
                getattr(lib, name).restype = i
            _solve_bound = (lib, asm, grid, large, solve, err)
        lib, asm, grid, large, solve, err_string = _solve_bound
        if device not in _solve_ready:
            limits = (int(lib.pio_assemble_max_rank(device)),
                      int(lib.pio_als_smem_optin(device)))
            code = next((-r for r in limits if r < 0), 0) or \
                lib.pio_als_solve_init(device)
            if code:
                raise RuntimeError(f"als_solve set-up on cuda:{device} failed: "
                                   f"CUDA error {code} "
                                   f"({err_string(code).decode()})")
            _solve_ready[device] = limits
    return _SolveLib(asm, grid, large, solve, err_string,
                     *_solve_ready[device])


# Most slots one assembly block sums (a multiple of the kernel's 64-slot
# chunk, and at most the 2,048 it stages in shared memory): a longer row
# is split into spans of this many slots, one block each, whose partial
# sums a second pass adds in span order.
ASSEMBLY_SPAN = 2048
# Rows of at most this many slots are grouped: one block sums several
# rows, one per group of its threads, instead of one row with all.
ASSEMBLY_GROUPED_MAX = 512
_ASSEMBLY_CHUNK = 64


class AssemblyPlan(NamedTuple):
    """How ``assemble_kernel`` covers a bucket of rows of ``L`` slots:
    each row cut into ``n_spans`` spans of at most ``span`` slots, one
    block per (row, span), row-major. With one span a block writes ``A``
    and ``b`` itself, and ``grouped`` rows share a block, one per group
    of its threads; with more, each block writes a partial ``[R*R + R]``
    to a scratch of ``scratch_floats(rows, R)`` fp32 values, and a second
    pass adds ``gram`` and the partials in span order."""

    span: int
    n_spans: int
    grouped: bool

    def scratch_floats(self, rows: int, R: int) -> int:
        return 0 if self.n_spans == 1 else rows * self.n_spans * (R * R + R)


def assembly_plan(L: int, span: int = ASSEMBLY_SPAN) -> AssemblyPlan:
    """The plan the wrapper hands ``pio_assemble_normal_equations`` for
    rows of ``L`` slots; the kernel carries it out and refuses only a
    plan its staging area cannot hold."""
    if not 0 < span <= ASSEMBLY_SPAN or span % _ASSEMBLY_CHUNK:
        raise ValueError(f"span={span} must be a multiple of "
                         f"{_ASSEMBLY_CHUNK} in [64, {ASSEMBLY_SPAN}]")
    n_spans = -(-L // span) if L > span else 1
    return AssemblyPlan(span, n_spans,
                        n_spans == 1 and L <= ASSEMBLY_GROUPED_MAX)


# The factor stores the assembly kernels take, and their code in the
# library's y_dtype argument.
_ASM_Y_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def assembly_route(R: int, max_rank: int, dtype: torch.dtype = torch.float32
                   ) -> str:
    """The assembly kernel for rank ``R`` and a factor store of ``dtype``
    (fp32 or bf16) when ``assemble_kernel`` takes ranks up to
    ``max_rank`` (the library's ``pio_assemble_max_rank``): "tiles"
    (``assemble_kernel``, the main path) or "large_rank"
    (``assemble_large_rank_kernel``, any rank). A bf16 row is widened to
    fp32 as it is gathered into the same shared tile, so both dtypes
    share the limit; another dtype raises."""
    if dtype not in _ASM_Y_DTYPE_CODE:
        raise TypeError(f"Y must be fp32 or bf16, got {dtype}")
    return "tiles" if R <= max_rank else "large_rank"


def check_assembly_args(Y: torch.Tensor, cols: torch.Tensor, aw: torch.Tensor,
                        bw: torch.Tensor, gram: torch.Tensor, max_rank: int
                        ) -> Tuple[int, int, int, int]:
    """``(M, R, B, L)`` of an assembly launch, or the error the GPU
    wrapper raises: tensors on ``Y``'s device, ``Y`` fp32 or bf16, the
    rest fp32 (``cols`` int32), contiguous, of shapes ``Y [M, R]``,
    ``cols``/``aw``/``bw [B, L]``, ``gram [R, R]``, and ``R`` at most
    the kernel's ``max_rank`` (the main route's limit; the large-rank
    route passes ``R``)."""
    dev = Y.device
    if Y.ndim != 2 or cols.ndim != 2:
        raise ValueError(f"Y must be [M, R] and cols [B, L]; got "
                         f"{tuple(Y.shape)} and {tuple(cols.shape)}")
    M, R = Y.shape
    B, L = cols.shape
    if Y.dtype not in _ASM_Y_DTYPE_CODE:
        raise TypeError(f"Y must be fp32 or bf16, got {Y.dtype}")
    _require(Y, "Y", Y.dtype, (M, R), dev)
    _require(cols, "cols", torch.int32, (B, L), dev)
    _require(aw, "aw", torch.float32, (B, L), dev)
    _require(bw, "bw", torch.float32, (B, L), dev)
    _require(gram, "gram", torch.float32, (R, R), dev)
    if R > max_rank:
        raise ValueError(f"assemble_normal_equations takes rank <= "
                         f"{max_rank} on {dev}, got {R}")
    return M, R, B, L


def _native_events(events: Optional[Tuple], dev) -> Tuple:
    """The CUDA handles of ``events``, a pair of
    ``torch.cuda.Event(enable_timing=True)`` or None, for a native launch
    that records them on its stream just before its first kernel and
    just after its last: their elapsed time is the kernels' own."""
    if events is None:
        return None, None
    # torch creates an event's CUDA handle at its first record; the
    # native call records both again around the kernels
    for ev in events:
        ev.record(torch.cuda.current_stream(dev))
    return events[0].cuda_event, events[1].cuda_event


def assemble_normal_equations(Y: torch.Tensor, cols: torch.Tensor,
                              aw: torch.Tensor, bw: torch.Tensor,
                              gram: torch.Tensor,
                              events: Optional[Tuple] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused gather + normal-equation assembly, the contract of the JAX
    package's ``als_pallas.assemble_normal_equations``: returns
    ``(A [B, R, R], b [B, R])`` fp32 with ``A[b] = gram + sum_l
    aw[b, l] * y y^T`` and ``b[b] = sum_l bw[b, l] * y`` over
    ``y = Y[cols[b, l]]``.

    ``Y [M, R]`` fp32 or bf16 fixed-side factors (a bf16 row is widened
    to fp32 as it is gathered; the sums are fp32 either way); ``cols
    [B, L]`` int32 gather indices; ``aw``/``bw [B, L]`` fp32 weights
    (padding slots carry weight 0 in both); ``gram [R, R]`` the shared
    term. ``events`` (CUDA only), a pair of
    ``torch.cuda.Event(enable_timing=True)``, is recorded around the
    kernels inside the native launch. Launches count by ``(route,
    dtype)``: ``("tiles" | "large_rank", "fp32" | "bf16")``."""
    if Y.device.type == "cpu":
        return assemble_normal_equations_plain(Y, cols, aw, bw, gram)
    if Y.device.type != "cuda":
        raise ValueError(f"unsupported device {Y.device}")
    dev = Y.device
    device = _device_index(dev)
    lib = _solve_kernels(device)
    route = assembly_route(Y.shape[-1], lib.assemble_max_rank, Y.dtype)
    M, R, B, L = check_assembly_args(
        Y, cols, aw, bw, gram,
        lib.assemble_max_rank if route == "tiles" else Y.shape[-1])
    A = torch.empty((B, R, R), dtype=torch.float32, device=dev)
    b = torch.empty((B, R), dtype=torch.float32, device=dev)
    if B == 0:
        return A, b
    stream = torch.cuda.current_stream(dev).cuda_stream
    y_code = _ASM_Y_DTYPE_CODE[Y.dtype]
    key = (route, "bf16" if y_code else "fp32")
    if route == "large_rank":
        _check_launch(lib.assemble_large(
            device, Y.data_ptr(), y_code, M, R, cols.data_ptr(),
            aw.data_ptr(), bw.data_ptr(), B, L, gram.data_ptr(), A.data_ptr(),
            b.data_ptr(), stream, *_native_events(events, dev)),
            "assemble_normal_equations", lib.err_string)
        assemble_launches.add(key)
        return A, b
    plan = assembly_plan(L)
    partial = None
    if plan.n_spans > 1:
        partial = torch.empty(plan.scratch_floats(B, R), dtype=torch.float32,
                              device=dev)
    _check_launch(lib.assemble(device, Y.data_ptr(), y_code, M, R,
                     cols.data_ptr(), aw.data_ptr(), bw.data_ptr(), B, L,
                     plan.span,
                     plan.n_spans, int(plan.grouped), gram.data_ptr(),
                     A.data_ptr(), b.data_ptr(),
                     None if partial is None else partial.data_ptr(), stream,
                     *_native_events(events, dev)),
                  "assemble_normal_equations", lib.err_string)
    assemble_launches.add(key)
    return A, b


def assemble_normal_equations_plain(Y: torch.Tensor, cols: torch.Tensor,
                                    aw: torch.Tensor, bw: torch.Tensor,
                                    gram: torch.Tensor,
                                    events: Optional[Tuple] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`assemble_normal_equations`:
    gather ``[B, L, R]`` (a bf16 ``Y`` widened to fp32, exactly), then
    two fp32 einsums. ``events`` (CUDA
    tensors only) are recorded on the current stream around its work."""
    if events is not None:
        events[0].record(torch.cuda.current_stream(Y.device))
    Yg = Y.float()[cols.long()]                                  # [B, L, R]
    A = gram.float() + torch.einsum("bl,blr,bls->brs", aw.float(), Yg, Yg)
    out = A, torch.einsum("bl,blr->br", bw.float(), Yg)
    if events is not None:
        events[1].record(torch.cuda.current_stream(Y.device))
    return out


def assemble_normal_equations_grid(Y: torch.Tensor, cols: torch.Tensor,
                                   aw: torch.Tensor, bw: torch.Tensor,
                                   gram: torch.Tensor
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`assemble_normal_equations` for ``k`` configurations of one
    solve side at once (the config grid's half-step, JAX's ``vmap`` of
    the assembly): ``Y [k, M, R]`` (fp32 or bf16), ``aw``/``bw [k, B,
    L]`` and ``gram [k, R, R]`` carry a config axis, ``cols [B, L]`` is
    shared; returns ``A [k, B, R, R]`` and ``b [k, B, R]`` fp32.

    On the main route (``tiles``) it is one launch of ``assemble_kernel``
    for all ``k`` (the config in ``blockIdx.y``), each config summed in
    the order of its own single-config launch, so ``A[z], b[z]`` are
    bitwise :func:`assemble_normal_equations` on ``(Y[z], cols, aw[z],
    bw[z], gram[z])``; its launches count under ``("tiles_grid",
    dtype)``. Above ``assemble_kernel``'s rank limit each config is one
    launch of the large-rank route (counted as such)."""
    if Y.device.type == "cpu":
        return assemble_normal_equations_grid_plain(Y, cols, aw, bw, gram)
    if Y.device.type != "cuda":
        raise ValueError(f"unsupported device {Y.device}")
    if Y.ndim != 3 or aw.ndim != 3 or bw.ndim != 3 or gram.ndim != 3:
        raise ValueError(
            f"Y must be [k, M, R], aw / bw [k, B, L] and gram [k, R, R]; got "
            f"{tuple(Y.shape)}, {tuple(aw.shape)}, {tuple(bw.shape)}, "
            f"{tuple(gram.shape)}")
    k = Y.shape[0]
    dev = Y.device
    device = _device_index(dev)
    lib = _solve_kernels(device)
    route = assembly_route(Y.shape[-1], lib.assemble_max_rank, Y.dtype)
    if route == "large_rank":
        out = [assemble_normal_equations(Y[z], cols, aw[z], bw[z], gram[z])
               for z in range(k)]
        return (torch.stack([a for a, _ in out]),
                torch.stack([b for _, b in out]))
    M, R, B, L = check_assembly_args(Y[0], cols, aw[0], bw[0], gram[0],
                                     lib.assemble_max_rank)
    _require(Y, "Y", Y.dtype, (k, M, R), dev)
    _require(aw, "aw", torch.float32, (k, B, L), dev)
    _require(bw, "bw", torch.float32, (k, B, L), dev)
    _require(gram, "gram", torch.float32, (k, R, R), dev)
    A = torch.empty((k, B, R, R), dtype=torch.float32, device=dev)
    b = torch.empty((k, B, R), dtype=torch.float32, device=dev)
    if B == 0 or k == 0:
        return A, b
    plan = assembly_plan(L)
    partial = None
    if plan.n_spans > 1:
        partial = torch.empty(k * plan.scratch_floats(B, R),
                              dtype=torch.float32, device=dev)
    y_code = _ASM_Y_DTYPE_CODE[Y.dtype]
    _check_launch(lib.assemble_grid(
        device, Y.data_ptr(), y_code, k, M, R, cols.data_ptr(),
        aw.data_ptr(), bw.data_ptr(), B, L, plan.span, plan.n_spans,
        int(plan.grouped), gram.data_ptr(), A.data_ptr(), b.data_ptr(),
        None if partial is None else partial.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, None, None),
        "assemble_normal_equations_grid", lib.err_string)
    assemble_launches.add(("tiles_grid", "bf16" if y_code else "fp32"))
    return A, b


def assemble_normal_equations_grid_plain(Y: torch.Tensor, cols: torch.Tensor,
                                         aw: torch.Tensor, bw: torch.Tensor,
                                         gram: torch.Tensor
                                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`assemble_normal_equations_grid`:
    :func:`assemble_normal_equations_plain` once per config."""
    out = [assemble_normal_equations_plain(Y[z], cols, aw[z], bw[z], gram[z])
           for z in range(Y.shape[0])]
    return (torch.stack([a for a, _ in out]),
            torch.stack([b for _, b in out]))


# spd_solve_warp_kernel: systems (warps) a block, and the fewest
# workspaces a block must hold for the shared route (one warp an SM leaves
# the shared-memory latency of its serial chain unhidden)
SPD_MAX_WARPS = 8
SPD_MIN_SHARED_WARPS = 2
# the device-memory route's workspaces: at most this many slots and bytes
SPD_DEVICE_SLOTS = 2048
SPD_DEVICE_BYTES = 256 << 20


class SpdSolvePlan(NamedTuple):
    """Where ``spd_solve_warp_kernel`` keeps each warp's workspace of
    ``workspace_floats`` (the packed upper triangle of ``U`` and ``v``):
    route "shared", ``warps_per_block`` of them in a block's shared
    memory; or route "device", ``slots`` of them in device memory (a
    multiple of ``warps_per_block``), one per warp of the grid, each warp
    looping over systems."""

    route: str
    warps_per_block: int
    workspace_floats: int
    slots: int


def spd_solve_plan(R: int, smem_optin: int) -> SpdSolvePlan:
    """The route of a rank-``R`` solve on a device whose blocks may opt
    into ``smem_optin`` bytes of shared memory (the library's
    ``pio_als_smem_optin``): shared memory while at least
    ``SPD_MIN_SHARED_WARPS`` workspaces fit a block, else device memory,
    with a bounded number of slots (not one per system)."""
    if R < 1:
        raise ValueError(f"rank must be positive, got {R}")
    ws = R * (R + 1) // 2 + R
    fit = smem_optin // (4 * ws)
    if fit >= SPD_MIN_SHARED_WARPS:
        return SpdSolvePlan("shared", min(SPD_MAX_WARPS, fit), ws, 0)
    slots = min(SPD_DEVICE_SLOTS, SPD_DEVICE_BYTES // (4 * ws))
    slots = max(SPD_MAX_WARPS, slots // SPD_MAX_WARPS * SPD_MAX_WARPS)
    return SpdSolvePlan("device", SPD_MAX_WARPS, ws, slots)


def spd_solve(A: torch.Tensor, b: torch.Tensor,
              events: Optional[Tuple] = None) -> torch.Tensor:
    """Batched SPD solve ``x: A @ x = b`` with ``A [B, R, R]`` and
    ``b [B, R]`` fp32, the contract of the JAX package's
    ``als_pallas.spd_solve``: non-pivoted Cholesky with the pivot
    clamped at ``max(d, 1e-30)``, then forward and backward
    substitution. Reads the upper triangle of ``A``. On the GPU the
    result is bitwise equal to :func:`spd_solve_plain`, at any rank:
    :func:`spd_solve_plan` keeps the kernel's workspace in shared memory
    or, for large ranks, in device memory. ``events`` as in
    :func:`assemble_normal_equations`."""
    if A.device.type == "cpu":
        return spd_solve_plain(A, b)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    dev = A.device
    if b.ndim != 2:
        raise ValueError(f"b must be [B, R], got shape {tuple(b.shape)}")
    B, R = b.shape
    _require(A, "A", torch.float32, (B, R, R), dev)
    _require(b, "b", torch.float32, (B, R), dev)
    x = torch.empty((B, R), dtype=torch.float32, device=dev)
    if B == 0:
        return x
    device = _device_index(dev)
    lib = _solve_kernels(device)
    plan = spd_solve_plan(R, lib.smem_optin)
    slots, workspace = 0, None
    if plan.route == "device":
        w = plan.warps_per_block
        slots = min(plan.slots, -(-B // w) * w)
        workspace = torch.empty(slots * plan.workspace_floats,
                                dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check_launch(lib.solve(device, A.data_ptr(), b.data_ptr(), B, R,
                            x.data_ptr(), int(plan.route == "shared"),
                            plan.warps_per_block,
                            None if workspace is None else workspace.data_ptr(),
                            slots, stream, *_native_events(events, dev)),
                  "spd_solve", lib.err_string)
    spd_launches.add()
    return x


def spd_solve_plain(A: torch.Tensor, b: torch.Tensor,
                    events: Optional[Tuple] = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`spd_solve`, operation for
    operation the kernel's arithmetic: right-looking Cholesky ``A = U^T
    U`` on the upper triangle (pivot ``max(d, 1e-30)``), then ``U^T y =
    b`` and ``U x = y`` by column sweeps. ``events`` as in
    :func:`assemble_normal_equations_plain`."""
    if events is not None:
        events[0].record(torch.cuda.current_stream(A.device))
    U = A.float().clone()
    v = b.float().clone()
    R = v.shape[1]
    for k in range(R):
        inv = 1.0 / torch.sqrt(torch.clamp(U[:, k, k], min=1e-30))
        U[:, k, k:] *= inv[:, None]
        u = U[:, k, k + 1:]
        U[:, k + 1:, k + 1:] -= u[:, :, None] * u[:, None, :]
    for k in range(R):
        v[:, k] /= U[:, k, k]
        v[:, k + 1:] -= U[:, k, k + 1:] * v[:, k:k + 1]
    for k in reversed(range(R)):
        v[:, k] /= U[:, k, k]
        v[:, :k] -= U[:, :k, k] * v[:, k:k + 1]
    if events is not None:
        events[1].record(torch.cuda.current_stream(A.device))
    return v

