"""Dense multi-head attention, the port's copy of ``mha_reference`` from
``predictionio_tpu/ops/attention.py``.

``q/k/v`` are ``[B, H, L, D]`` fp32 tensors. The scores and the weighted
sum are two fp32 einsums (the JAX package pins ``Precision.HIGHEST``;
the port resolves CUDA devices with TF32 off), never
``scaled_dot_product_attention``: that call gives NaN on a query row
whose keys are all masked, and its fused routes sum in another order.

The sequence-parallel variants (``ring_attention``, ``ulysses_attention``
and their sharded programs) need a mesh of cards and are not ported
(ROADMAP A6.4).
"""

from __future__ import annotations

from typing import Optional

import torch


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False, scale: Optional[float] = None,
                  key_padding_mask: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """``softmax(Q Kᵀ · scale [+ masks]) V`` per batch row and head.

    ``key_padding_mask``: optional ``[B, L_k]`` (nonzero / True = a real
    key, 0 / False = padding). Masked keys score ``-inf`` before the
    softmax, together with the causal mask. A query row whose visible
    keys are ALL masked outputs exact zeros (a safe softmax) instead of
    NaN; without a mask the softmax is the plain one."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    # a fill on the device, not a host copy: a captured training step
    # (CUDA graph) may hold this
    neg_inf = torch.full((), float("-inf"), dtype=s.dtype, device=s.device)
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        keep = (torch.arange(lq, device=s.device)[:, None]
                >= torch.arange(lk, device=s.device)[None, :])
        s = torch.where(keep, s, neg_inf)
    if key_padding_mask is None:
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", p, v)
    kp = key_padding_mask.to(torch.bool)[:, None, None, :]
    s = torch.where(kp, s, neg_inf)
    # safe softmax: a fully-masked query row (all -inf) outputs 0
    m = torch.amax(s, dim=-1, keepdim=True)
    dead = torch.isneginf(m)
    p = torch.where(dead, torch.zeros_like(s),
                    torch.exp(s - torch.where(dead, torch.zeros_like(m), m)))
    denom = torch.sum(p, dim=-1, keepdim=True)
    p = p / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


__all__ = ["mha_reference"]
