"""Attention: the dense multi-head oracle and the two sequence-parallel
schemes, the port's copy of ``predictionio_tpu/ops/attention.py``.

``q/k/v`` are ``[B, H, L, D]`` tensors. The scores and the weighted sum
are fp32 einsums (the JAX package pins ``Precision.HIGHEST``; the port
resolves CUDA devices with TF32 off), never
``scaled_dot_product_attention``: that call gives NaN on a query row
whose keys are all masked, and its fused routes sum in another order.

Sequence parallelism shards the sequence axis over one axis of a
:class:`~predictionio_tpu_torch.parallel.mesh.Mesh`: the ``n`` devices
along ``axis_name`` each hold one block of ``L / n`` positions (a device
may repeat: ``[cuda:0] * 4`` or ``["cpu"] * 4`` are logical shards of
one device). The JAX package runs a per-device body under
``shard_map``; here the code lays the same work over the devices
itself, and moves blocks between them by device copies (``Tensor.to``
the receiving shard's device: none between logical shards of one
device):

- :func:`ring_attention` keeps fp32 online-softmax accumulators per
  shard and folds the K / V / mask block it holds ``n`` times, each
  block passing to the next shard between folds (Liu et al., "Ring
  Attention with Blockwise Transformers"); no score block wider than
  ``L / n`` forms.
- :func:`ulysses_attention` swaps each shard's sequence block for a
  head group over the whole sequence (JAX's ``all_to_all``), runs
  :func:`mha_reference` on each group and swaps back (DeepSpeed-Ulysses).

With a ``torch.distributed`` process group, the sequence splits over
every process's shards in rank order (each process passes the same
global tensors and gets the global result, computing only its own
blocks): the ring's hop from a process's last shard to the next
process's first is ``batch_isend_irecv``, Ulysses' swaps are
``all_to_all_single`` and its mask is gathered by ``all_gather``. That
is what ``shard_map`` does over a mesh of several hosts.

Nothing here is compiled, so JAX's program caches (``_ring_fn``,
``_ulysses_fn``) have no counterpart. No TPU kernel lies under these
functions: they are jnp in the JAX package and plain PyTorch here.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """``Q Kᵀ · scale`` per batch row and head: every score block of this
    module is formed here."""
    return torch.einsum("bhqd,bhkd->bhqk", q, k) * scale


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
    s = _scores(q, k, scale)
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


# -- the plane ----------------------------------------------------------------

def _axis_devices(mesh, axis_name: str) -> List[torch.device]:
    """The devices along ``axis_name`` (the other axes at their first
    coordinate: the work is replicated over them, as ``shard_map``
    replicates an input its spec does not split)."""
    ax = mesh.axis_names.index(axis_name)
    index = tuple(slice(None) if a == ax else 0
                  for a in range(mesh.devices.ndim))
    return list(mesh.devices[index])


def _group() -> Tuple[int, int, bool]:
    """``(processes, this process's rank, whether a group exists)``."""
    from predictionio_tpu_torch.parallel import distributed

    if not distributed.group_initialized():
        return 1, 0, False
    return distributed.process_count(), distributed.process_index(), True


def sp_axis_size(mesh, axis_name: str = "data") -> int:
    """The shards the sequence splits into over ``mesh[axis_name]``: its
    devices, times the processes of a process group."""
    return int(mesh.shape[axis_name]) * _group()[0]


def _check_length(L: int, axis_name: str, n: int) -> None:
    if L % n:
        raise ValueError(
            f"sequence length {L} not divisible by mesh axis "
            f"{axis_name} of size {n}")


def _blocks(x: torch.Tensor, devs: List[torch.device], first: int,
            size: int) -> List[torch.Tensor]:
    """Sequence blocks ``first, first + 1, ...`` of ``x`` (axis 2), one
    on each of ``devs``."""
    return [x[:, :, (first + j) * size:(first + j + 1) * size].to(d)
            for j, d in enumerate(devs)]


def _gather_processes(local: torch.Tensor, dim: int) -> torch.Tensor:
    """Every process's ``local`` joined along ``dim`` in rank order
    (``all_gather``)."""
    import torch.distributed as dist

    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts, dim=dim)


# -- ring ---------------------------------------------------------------------

def _fold(q: torch.Tensor, o: torch.Tensor, l: torch.Tensor, m: torch.Tensor,
          k_blk: torch.Tensor, v_blk: torch.Tensor,
          mask_blk: Optional[torch.Tensor], qpos: Optional[torch.Tensor],
          kpos: Optional[torch.Tensor], scale: float
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold one held K / V block into a shard's online-softmax
    accumulators (``o`` numerator, ``l`` denominator, ``m`` running max,
    all fp32). ``qpos`` / ``kpos``: the global positions of the queries
    and of the block's keys (causal), else None."""
    s = _scores(q.float(), k_blk.float(), scale)
    neg_inf = torch.full((), float("-inf"), dtype=s.dtype, device=s.device)
    if qpos is not None:
        s = torch.where((qpos[:, None] >= kpos[None, :])[None, None], s,
                        neg_inf)
    if mask_blk is not None:
        s = torch.where(mask_blk[:, None, None, :].to(torch.bool), s,
                        neg_inf)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    dead = torch.isneginf(m_new)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    corr = torch.where(dead, zero, torch.exp(m - m_new))
    p = torch.where(dead[..., None], zero, torch.exp(s - m_new[..., None]))
    l_new = l * corr + torch.sum(p, dim=-1)
    o_new = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                               v_blk.float())
    return o_new, l_new, m_new


def _ring_hop(blocks: List[List[torch.Tensor]], devs: List[torch.device],
              world: int, rank: int) -> List[List[torch.Tensor]]:
    """Each shard's held blocks (``blocks[j]``: K, V and the mask if any)
    pass to the next shard: within the process by a device copy, from
    the process's last shard to the next process's first through
    ``batch_isend_irecv`` (with one process, to its own first shard)."""
    out = [[b.to(devs[j]) for b in blocks[j - 1]]
           for j in range(1, len(devs))]
    last = blocks[-1]
    if world == 1:
        first = [b.to(devs[0]) for b in last]
    else:
        import torch.distributed as dist

        first = [torch.empty(b.shape, dtype=b.dtype, device=devs[0])
                 for b in last]
        ops = [dist.P2POp(dist.isend, b.contiguous(), (rank + 1) % world)
               for b in last]
        ops += [dist.P2POp(dist.irecv, b, (rank - 1) % world)
                for b in first]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [first] + out


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis_name: str = "data", causal: bool = False,
                   scale: Optional[float] = None,
                   key_padding_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Sequence-parallel attention over ``mesh[axis_name]`` by the ring.

    ``q/k/v: [B, H, L, D]`` whose ``L`` divides by the shard count
    (:func:`sp_axis_size`); shard ``s`` holds positions ``[s·L/n,
    (s+1)·L/n)``. Each shard folds ``n`` K / V blocks into fp32
    accumulators, the block held at step ``i`` having come from shard
    ``(s - i) % n`` (causal positions come from that source shard), and
    passes it on between folds: ``n - 1`` hops, the last fold peeled off
    so no block moves only to be dropped. ``key_padding_mask``
    (optional ``[B, L]``, nonzero = a real key) travels with its K / V
    block. A query row with no visible key outputs 0, as in
    :func:`mha_reference`. Returns the ``[B, H, L, D]`` result in
    ``q``'s dtype on the mesh's first device."""
    devs = _axis_devices(mesh, axis_name)
    world, rank, _ = _group()
    n = len(devs) * world
    B, H, L, D = q.shape
    _check_length(L, axis_name, n)
    scale = float(scale if scale is not None else D ** -0.5)
    size = L // n
    first = rank * len(devs)          # this process's first global shard
    qs = _blocks(q, devs, first, size)
    held = [[kb, vb] for kb, vb in zip(_blocks(k, devs, first, size),
                                       _blocks(v, devs, first, size))]
    if key_padding_mask is not None:
        mask = key_padding_mask.to(torch.float32)
        for j, (h, d) in enumerate(zip(held, devs)):
            h.append(mask[:, (first + j) * size:(first + j + 1) * size].to(d))
    acc = [(torch.zeros((B, H, size, D), dtype=torch.float32, device=d),
            torch.zeros((B, H, size), dtype=torch.float32, device=d),
            torch.full((B, H, size), float("-inf"), dtype=torch.float32,
                       device=d)) for d in devs]
    for i in range(n):
        for j, d in enumerate(devs):
            g = first + j
            qpos = kpos = None
            if causal:
                src = (g - i) % n
                qpos = g * size + torch.arange(size, device=d)
                kpos = src * size + torch.arange(size, device=d)
            blk = held[j]
            acc[j] = _fold(qs[j], *acc[j], blk[0], blk[1],
                           blk[2] if len(blk) > 2 else None, qpos, kpos,
                           scale)
        if i < n - 1:
            held = _ring_hop(held, devs, world, rank)
    home = devs[0]
    outs = []
    for (o, l, _), qb in zip(acc, qs):
        # rows with no visible key keep denominator 0 -> output 0
        denom = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append((o / denom[..., None]).to(qb.dtype).to(home))
    out = torch.cat(outs, dim=2)
    return _gather_processes(out, 2) if world > 1 else out


# -- Ulysses --------------------------------------------------------------------

def _swap_processes(x: torch.Tensor, fwd: bool) -> torch.Tensor:
    """The process-level all-to-all: ``[B, H, L/P, D]`` (this process's
    sequence span, every head) -> ``[B, H/P, L, D]`` (its head group
    over the whole sequence) when ``fwd``, and back otherwise, through
    ``all_to_all_single``."""
    import torch.distributed as dist

    P = dist.get_world_size()
    B, H, L, D = x.shape
    if fwd:
        send = x.reshape(B, P, H // P, L, D).transpose(0, 1).contiguous()
    else:
        send = x.reshape(B, H, P, L // P, D).permute(2, 0, 1, 3, 4) \
            .contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    if fwd:       # recv[r]: process r's span of this head group
        return recv.permute(1, 2, 0, 3, 4).reshape(B, H // P, P * L, D)
    return recv.permute(1, 0, 2, 3, 4).reshape(B, P * H, L // P, D)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis_name: str = "data", causal: bool = False,
                      scale: Optional[float] = None,
                      key_padding_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """All-to-all sequence-parallel attention over ``mesh[axis_name]``
    (the DeepSpeed-Ulysses layout): inputs and output as in
    :func:`ring_attention`, but shard ``s`` trades its sequence block for
    head group ``s`` (``H / n`` heads) over the whole sequence, runs
    :func:`mha_reference` on it (causal masking is then the dense one)
    and trades back. ``key_padding_mask`` has no head axis to trade: it
    is gathered whole. Needs both ``H`` and ``L`` divisible by the shard
    count."""
    devs = _axis_devices(mesh, axis_name)
    world, rank, grouped = _group()
    n = len(devs) * world
    B, H, L, D = q.shape
    if H % n:
        raise ValueError(
            f"head count {H} not divisible by mesh axis "
            f"{axis_name} of size {n} — use ring_attention for "
            "head counts below the mesh size")
    _check_length(L, axis_name, n)
    scale = float(scale if scale is not None else D ** -0.5)
    size, hg = L // n, H // n
    home = devs[0]
    mask = None
    if key_padding_mask is not None:
        mask = key_padding_mask.to(torch.float32)
    if grouped:
        # this process's span of every head -> its head group over the
        # whole sequence, then one group of heads a local shard
        span = slice(rank * len(devs) * size, (rank + 1) * len(devs) * size)
        heads = [_swap_processes(x[:, :, span].to(home), True)
                 for x in (q, k, v)]
        full = None if mask is None else \
            _gather_processes(mask[:, span].to(home), 1)
        outs = []
        for j, d in enumerate(devs):
            qh, kh, vh = (x[:, j * hg:(j + 1) * hg].to(d) for x in heads)
            outs.append(mha_reference(
                qh, kh, vh, causal=causal, scale=scale,
                key_padding_mask=None if full is None else full.to(d))
                .to(home))
        out = _swap_processes(torch.cat(outs, dim=1), False)
        return _gather_processes(out, 2) if world > 1 else out
    blocks = [_blocks(x, devs, 0, size) for x in (q, k, v)]
    mblocks = None if mask is None else [
        mask[:, s * size:(s + 1) * size].to(d) for s, d in enumerate(devs)]
    outs = []
    for g, d in enumerate(devs):
        # the all-to-all: head group g of every sequence block
        qh, kh, vh = (torch.cat([b[:, g * hg:(g + 1) * hg].to(d)
                                 for b in bl], dim=2) for bl in blocks)
        full = None if mblocks is None else torch.cat(
            [mb.to(d) for mb in mblocks], dim=1)
        outs.append(mha_reference(qh, kh, vh, causal=causal, scale=scale,
                                  key_padding_mask=full))
    # and back: each sequence block gathers its positions of every group
    back = [torch.cat([o[:, :, s * size:(s + 1) * size].to(d) for o in outs],
                      dim=1) for s, d in enumerate(devs)]
    return torch.cat([b.to(home) for b in back], dim=2)


__all__ = ["mha_reference", "ring_attention", "sp_axis_size",
           "ulysses_attention"]
