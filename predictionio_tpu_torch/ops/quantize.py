"""Int8 factor quantization for the serving store.

The port's copy of ``predictionio_tpu.ops.quantize``: each factor table
is held as ``int8`` values plus ONE fp32 scale per row (symmetric
absmax):

    scale[i] = max(|row_i|) / 127        (1.0 for all-zero rows)
    data[i]  = clip(round(row_i / scale[i]), -127, 127)

Rounding is half-to-even on both twins (``torch.round`` and
``np.round``), so the tensor and numpy versions agree bitwise.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

INT8_QMAX = 127.0


class QuantFactors(NamedTuple):
    """An int8 factor table with per-row fp32 scales (tensors or numpy
    arrays), with array-like ``shape``/``dtype`` so store bookkeeping
    reads the same for quantized and dense stores."""

    data: Any   # int8 [N, R]
    scale: Any  # float32 [N]

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype


def is_quantized(factors: Any) -> bool:
    return isinstance(factors, QuantFactors)


def quantize_rows_int8(factors: torch.Tensor) -> QuantFactors:
    """Symmetric per-row absmax quantization to int8 on tensors. A bf16
    input is widened to fp32 first, so the scale never squares bf16
    rounding."""
    if factors.ndim != 2:
        raise ValueError(
            f"quantize_rows_int8: expected [N, R] factors, got shape "
            f"{tuple(factors.shape)}")
    f = factors.float()
    absmax = f.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax / INT8_QMAX,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(f / scale[:, None]), -INT8_QMAX, INT8_QMAX)
    return QuantFactors(q.to(torch.int8), scale)


def dequantize_rows(quant: QuantFactors) -> torch.Tensor:
    """fp32 dense view of a quantized table (``data * scale`` per row)."""
    return quant.data.float() * quant.scale.float()[:, None]


def quantize_rows_int8_np(factors: np.ndarray) -> QuantFactors:
    """Numpy twin of :func:`quantize_rows_int8` (same rounding rule)."""
    f = np.asarray(factors, dtype=np.float32)
    if f.ndim != 2:
        raise ValueError(
            f"quantize_rows_int8_np: expected [N, R] factors, got shape "
            f"{f.shape}")
    absmax = np.max(np.abs(f), axis=1)
    scale = np.where(absmax > 0, absmax / INT8_QMAX, 1.0).astype(np.float32)
    q = np.clip(np.round(f / scale[:, None]), -INT8_QMAX, INT8_QMAX)
    return QuantFactors(q.astype(np.int8), scale)


def dequantize_rows_np(quant: QuantFactors) -> np.ndarray:
    """Host-side dequantization (numpy in, numpy out)."""
    data = np.asarray(quant.data)
    scale = np.asarray(quant.scale, dtype=np.float32)
    return data.astype(np.float32) * scale[:, None]


def quantization_error_bound(quant: QuantFactors) -> np.ndarray:
    """Per-row worst-case absolute reconstruction error: half an int8
    step, ``scale / 2``."""
    return np.asarray(quant.scale, dtype=np.float32) / 2.0
