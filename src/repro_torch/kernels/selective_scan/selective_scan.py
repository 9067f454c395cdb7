"""Wrapper of the selective-scan CUDA kernel (`csrc/selective_scan.cu`).

`selective_scan` — h_t = a_t h_{t-1} + b_t from h = 0 over (S, C) or
(B, S, C), the recurrence of `src/repro/kernels/selective_scan/
selective_scan.py` with the batch axis written out: one launch covers
(B, S, C).  Any float dtype in, f32 out (the inputs are cast to f32 first,
as the reference casts them before its `pallas_call`).

For a CPU tensor it takes its plain version (`ref.py`).  For a CUDA tensor
it launches its kernel or raises; it never falls back.  It counts its
launches in its `launches` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

_FNS: dict = {}


def _lib():
    if not _FNS:
        lib = build.load("selective_scan")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f = lib.selective_scan_f32
        f.argtypes = [vp, vp, vp, ci, ci, ctypes.c_longlong, vp]
        f.restype = ci
        _FNS.update(scan=f)
    return _FNS


def selective_scan(a, b):
    """a, b: (S, C) or (B, S, C) -> h of the same shape, f32."""
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
    if a.shape != b.shape or a.dim() not in (2, 3):
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         f"both be (S, C) or (B, S, C)")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return selective_scan_ref(a, b)
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel path takes "
                             f"CUDA tensors (CPU tensors take the plain "
                             f"version)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    a32, b32 = a.float(), b.float()
    batch, s, c = (1, *a.shape) if a.dim() == 2 else a.shape
    if not (1 <= batch <= 65535 and s >= 1 and 1 <= c < 2**31):
        raise ValueError(f"shape {tuple(a.shape)} is out of the kernel's "
                         f"range")
    fns = _lib()
    h = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fns["scan"](a32.data_ptr(), b32.data_ptr(), h.data_ptr(), batch,
                         s, c, stream)
    if rc != 0:
        raise RuntimeError(f"selective_scan launch failed: "
                           f"cudaGetLastError() = {rc}")
    selective_scan.launches += 1
    return h


selective_scan.launches = 0
