"""Where the port's entry points run, and with which numerics flags."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA device; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


@contextlib.contextmanager
def deterministic_f32():
    """Run the block in full f32 with deterministic cuDNN algorithms.

    cuDNN: deterministic algorithms, no autotuning, no TF32; f32 matmuls:
    no TF32.  PyTorch's defaults run f32 convolutions in TF32 (10-bit
    mantissas) and let cuDNN pick algorithms whose sums vary from run to
    run; the reference computes in f32.  The caller's settings come back
    on the way out, on exceptions too."""
    matmul = torch.backends.cuda.matmul
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        saved = matmul.allow_tf32
        matmul.allow_tf32 = False
        try:
            yield
        finally:
            matmul.allow_tf32 = saved
