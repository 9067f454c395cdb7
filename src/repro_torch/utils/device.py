"""Where the port's entry points run."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA device; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev
