"""Wrapper of the robust aggregators' CUDA kernel (`csrc/robust.cu`).

`rank_band_mean` — per coordinate of the (M, N) cohort stack, the mean of
the alive rows' entries whose stable rank lies in [lo, hi], plus
||band||^2: coordinate-wise trimmed mean and median in one read and one
launch (`fed/aggregators.py`).  lo and hi may be 0-d CUDA tensors computed
from the round's weights: the kernel reads them through their own pointers,
so the host never waits for them and nothing is copied.  Python numbers (and
CPU tensors) go to the kernel as values.

`plan` picks the launch: cohorts up to REG_ROWS keep every row in registers;
larger ones take the panel path, which streams the rows through shared
memory of a fixed size, so no cohort size is refused.  `csrc/robust.cu`
owns the rest of the launch (the register path's unrolled bucket of M, the
panel path's chunk and panel rows).

The wrapper takes its plain version (`ref.py`) only for CPU tensors.  For
a CUDA tensor it launches the kernel or raises; it never falls back.  It
counts its launches in its `launches` attribute.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, reduction
from repro_torch.kernels.rloo.rloo import _check, _check_cuda, _raise_on
from repro_torch.kernels.robust.ref import rank_band_mean_ref

# csrc/robust.cu's kRegRows and kPanelThreads
REG_ROWS = 32
PANEL_THREADS = 128

_FNS: dict = {}


def _lib():
    if not _FNS:
        lib = build.load("robust")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        f = lib.rank_band_mean_f32
        f.argtypes = [vp, vp, vp, vp, cf, cf, vp, vp, vp, ci, ci, ci, ci, ci,
                      vp]
        f.restype = ci
        _FNS.update(band=f)
    return _FNS


class Plan(NamedTuple):
    """One launch of `csrc/robust.cu::rank_band_mean_f32`."""
    path: str          # "registers" (M <= REG_ROWS) or "panels"
    vec: int           # floats a thread loads per row at once
    blocks: int        # the grid (and the norm's partials)


def plan(m: int, n: int, vec: int = 1) -> Plan:
    """The launch for an (M, N) stack; `vec` (from
    `reduction.vector_width`) is used on the register path only, where the
    grid strides; the panel path gives each column a thread."""
    if m <= REG_ROWS:
        return Plan("registers", vec, reduction.grid_blocks(n // vec))
    return Plan("panels", 1, -(-n // PANEL_THREADS))


def _rank_arg(name, x, device):
    """(device pointer or None, value) for lo or hi."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if x.dtype != torch.float32 or x.numel() != 1:
            raise TypeError(f"{name} must be one float32 value, got "
                            f"{x.dtype} of shape {tuple(x.shape)}")
        return x.data_ptr(), 0.0
    return None, float(x)


def rank_band_mean(g, alive, lo, hi):
    """g (M, N) f32, alive (M,) f32, lo and hi scalar ranks (floats or 0-d
    tensors) -> (band_mean (N,), ||band_mean||^2)."""
    _check("g", g, 2)
    _check("alive", alive, 1, g.device)
    m, n = g.shape
    if alive.shape[0] != m:
        raise ValueError(f"alive has {alive.shape[0]} entries for M={m}")
    if g.device.type == "cpu":
        return rank_band_mean_ref(g, alive, lo, hi)
    _check_cuda(("g", g), ("alive", alive))
    if not (1 <= m < 2**31 and 1 <= n < 2**31):
        raise ValueError(f"rank_band_mean takes 1 <= M, N < 2**31, got M={m}, "
                         f"N={n}")
    lo_ptr, lo_val = _rank_arg("lo", lo, g.device)
    hi_ptr, hi_val = _rank_arg("hi", hi, g.device)
    fns = _lib()
    p = plan(m, n, reduction.vector_width(n, g))
    agg = torch.empty((n,), dtype=torch.float32, device=g.device)
    nrm = torch.empty((), dtype=torch.float32, device=g.device)
    parts = torch.empty((p.blocks,), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device)
        rc = fns["band"](g.data_ptr(), alive.data_ptr(), lo_ptr, hi_ptr,
                         lo_val, hi_val, agg.data_ptr(), parts.data_ptr(),
                         nrm.data_ptr(), m, n, p.vec, p.blocks,
                         reduction.ticket_slot(g.device, stream),
                         stream.cuda_stream)
    _raise_on(rc, "rank_band_mean")
    rank_band_mean.launches += 1
    return agg, nrm


rank_band_mean.launches = 0
