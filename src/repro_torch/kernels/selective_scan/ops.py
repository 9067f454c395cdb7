"""Selective scan over mamba-shaped states (the port of
`src/repro/kernels/selective_scan/ops.py::scan_states`, with the batch axis
written out).

Broadcasts a to b's shape, flattens the state axes (di, N) or (H, N, P) to
one channel axis C, runs `selective_scan` once over (B, S, C), and restores
the shape.
"""
from __future__ import annotations

from repro_torch.kernels.selective_scan.selective_scan import selective_scan


def scan_states(a, b):
    """a, b: (B, S, ...) broadcast-compatible; returns h (f32) with b's
    shape."""
    b_shape = b.shape
    a = a.expand(b_shape)
    h = selective_scan(a.reshape(*b_shape[:2], -1).contiguous(),
                       b.reshape(*b_shape[:2], -1).contiguous())
    return h.reshape(b_shape)
