"""Device resolution shared by the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU; a
missing card is an error, never a silent fall-back to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; raises if the card is missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device '{dev}'")
    return dev


def to_device(a: np.ndarray, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Host array -> tensor on ``device`` without stalling the host.

    On the card the array goes through pinned memory with a
    non-blocking copy: the copy is ordered on the current stream, so the
    event loop never waits for the card to drain (a pageable copy would
    synchronise the stream on every event)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()
