"""Plain PyTorch version of the selective-scan kernel (the port of
`src/repro/kernels/selective_scan/ref.py::selective_scan_ref`).

The CPU path of `selective_scan.selective_scan`, and the oracle the CUDA
kernel is held to on the card: the inclusive scan of
h_t = a_t h_{t-1} + b_t from h = 0, by Hillis-Steele doubling over the time
axis in f32 (log2(S) full-width steps of the combine
(A1, B1) . (A2, B2) = (A2 A1, A2 B1 + B2), as the TPU kernel does within a
chunk).
"""
import torch


def selective_scan_ref(a, b):
    """a, b: (..., S, C), any float dtype -> h (..., S, C) f32; the time axis
    is the second to last."""
    A, B = a.float(), b.to(torch.float32, copy=True)
    s = A.shape[-2]
    off = 1
    while off < s:
        B = torch.cat([B[..., :off, :],
                       A[..., off:, :] * B[..., :-off, :] + B[..., off:, :]],
                      dim=-2)
        A = torch.cat([A[..., :off, :], A[..., off:, :] * A[..., :-off, :]],
                      dim=-2)
        off *= 2
    return B
