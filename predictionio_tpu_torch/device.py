"""Device resolution for the port's entry points.

``device=None`` means CUDA. There is no silent CPU fallback: a missing
GPU raises, and the CPU is used only when the caller asks for it
(``device="cpu"``, as the tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch device an entry point runs on. ``None`` resolves to
    ``cuda`` and raises when CUDA is absent. Resolving a CUDA device
    also pins float32 matrix products to full fp32 (no TF32): the
    reference scores with ``Precision.HIGHEST``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; the port runs on the GPU unless "
                "the caller passes device='cpu'")
        # TF32 keeps about three decimal digits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!s} (expected cuda or cpu)")
    return dev


def default_serve_precision(device: torch.device) -> str:
    """The device factor store's default precision: bf16 on the GPU
    (half the bytes every scoring pass streams; scores still accumulate
    in fp32), fp32 on the CPU, which has no native bf16 datapath."""
    return "bf16" if device.type == "cuda" else "fp32"
