"""The fused serving kernel: ``top_k(mask(Y @ Q^T))`` on the GPU.

Counterpart of ``predictionio_tpu/ops/als_pallas.py``. This slice ports
its serving kernel, ``fused_gather_score_topk`` (the TPU kernel at
``als_pallas.py:453``, body ``_fused_topk_body``, selection
``_topk_select_body``), as the hand-written CUDA kernel in
``csrc/fused_topk.cu``. The training kernels of that module
(``spd_solve``, ``assemble_normal_equations``) come with the ALS
training slice.

Bound on an H100: the item table is read once, ``M*R*bytes(dtype)``
bytes at 3.35 TB/s, and the scores cost ``2*B*M*R`` fp32 FMAs at the
67 TFLOP/s non-tensor fp32 rate; bytes bind at small B, operations at
B=256. The design scores with fp32 FMAs only (the reference pins
``Precision.HIGHEST``), masks seen items by one scatter per (slot, query)
instead of comparing every tile with every seen slot, and selects each
query's top k by a radix select plus a bitonic sort, so k may be any
value up to the number of items. The [B, M] scores make one round trip
through device memory; keeping them on chip is later work.

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor it runs :func:`fused_gather_score_topk_plain`, the plain PyTorch
version that the tests hold against the JAX package.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from predictionio_tpu_torch.ops._build import LaunchCounter, load_kernel_library
from predictionio_tpu_torch.ops.quantize import dequantize_rows, is_quantized

# The serving store pads its item table to this multiple once, so score
# rows start 512-byte aligned; pad rows sit past n_items and score -inf.
TOPK_TILE_M = 128

KERNEL_NAME = "fused_topk"
launches = LaunchCounter()

_Y_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_bound = None
_ready_devices: set = set()
_bind_lock = threading.Lock()


def _kernel(device: int):
    """(launch fn, error-string fn, widest shared-memory sort), bound
    once per process and set up once per device; the first call builds
    the library."""
    global _bound
    with _bind_lock:
        if _bound is None:
            lib = load_kernel_library(KERNEL_NAME)
            fn = lib.pio_fused_topk
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn.argtypes = [i, p, i, i, p, i, p, p, i, i, p, p, i, ll, ll, ll,
                           ll, i, i, i, p, p, p, p, p]
            fn.restype = ctypes.c_int
            err = lib.pio_cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            lib.pio_topk_smem_sort_max.argtypes = []
            lib.pio_topk_smem_sort_max.restype = ctypes.c_int
            lib.pio_fused_topk_init.argtypes = [i]
            lib.pio_fused_topk_init.restype = ctypes.c_int
            _bound = (lib, fn, err, int(lib.pio_topk_smem_sort_max()))
        lib, fn, err_string, smem_sort_max = _bound
        if device not in _ready_devices:
            code = lib.pio_fused_topk_init(device)
            if code:
                raise RuntimeError(f"fused_topk set-up on cuda:{device} "
                                   f"failed: CUDA error {code} "
                                   f"({err_string(code).decode()})")
            _ready_devices.add(device)
    return fn, err_string, smem_sort_max


def _check_k(k: int, m: int) -> int:
    k = int(k)
    if not 1 <= k <= m:
        raise ValueError(f"k={k} must lie in [1, {m}] (the item table's rows)")
    return k


def fused_gather_score_topk(Q: torch.Tensor, Y, seen_cols: Optional[torch.Tensor],
                            seen_mask: Optional[torch.Tensor], *, k: int,
                            n_items: int, mask_seen: bool = True,
                            row_valid: Optional[torch.Tensor] = None
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
    -inf slots are unspecified)."""
    data = Y.data if is_quantized(Y) else Y
    if data.device.type == "cpu":
        return fused_gather_score_topk_plain(
            Q, Y, seen_cols, seen_mask, k=k, n_items=n_items,
            mask_seen=mask_seen, row_valid=row_valid)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    return _launch(Q, Y, seen_cols, seen_mask, k=k, n_items=n_items,
                   mask_seen=mask_seen, row_valid=row_valid)


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
             device: torch.device, contiguous: bool = True) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the item table on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(Q, Y, seen_cols, seen_mask, *, k, n_items, mask_seen, row_valid):
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
    device = dev.index if dev.index is not None else torch.cuda.current_device()
    fn, err_string, smem_sort_max = _kernel(device)
    N = 1 << (k - 1).bit_length()
    scores = torch.empty((B, M), dtype=torch.float32, device=dev)
    scratch = None
    if N > smem_sort_max:
        scratch = torch.empty((B, 2 * N), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(device, Q.data_ptr(), B, R, data.data_ptr(), code, scale, rv, M,
             int(n_items), sc_ptr, sm_ptr, L, *strides, int(bool(mask_seen)),
             k, N, scores.data_ptr(),
             None if scratch is None else scratch.data_ptr(),
             vals.data_ptr(), idx.data_ptr(), stream)
    if err:
        raise RuntimeError(f"fused_topk kernel launch failed: CUDA error "
                           f"{err} ({err_string(err).decode()})")
    launches.add()
    return vals, idx


def fused_gather_score_topk_plain(Q: torch.Tensor, Y,
                                  seen_cols: Optional[torch.Tensor],
                                  seen_mask: Optional[torch.Tensor], *, k: int,
                                  n_items: int, mask_seen: bool = True,
                                  row_valid: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`fused_gather_score_topk`:
    an fp32 product, the same masks, and a stable descending sort (so
    ties go to the lowest item id, as in ``lax.top_k``; ``torch.topk``
    does not promise that)."""
    Yf = dequantize_rows(Y) if is_quantized(Y) else Y.float()
    M = Yf.shape[0]
    k = _check_k(k, M)
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
    vals, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), order[:, :k].to(torch.int32)
