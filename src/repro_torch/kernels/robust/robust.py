"""Wrapper of the robust aggregators' CUDA kernel (`csrc/robust.cu`).

`rank_band_mean` — per coordinate of the (M, N) cohort stack, the mean of
the alive rows' entries whose stable rank lies in [lo, hi], plus
||band||^2: coordinate-wise trimmed mean and median in one read
(`fed/aggregators.py`).  lo and hi may be 0-d device tensors computed from
the round's weights; the kernel reads them from a device buffer, so the
host never waits for them.

The wrapper takes its plain version (`ref.py`) only for CPU tensors.  For
a CUDA tensor it launches the kernel or raises; it never falls back.  It
counts its launches in its `launches` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rloo.rloo import _check, _check_cuda, _raise_on
from repro_torch.kernels.robust.ref import rank_band_mean_ref

# shared memory one block may use on an H100 (227 KB, after opting in)
SMEM_LIMIT = 232448
MAX_TILE = 256

_FNS: dict = {}


def _lib():
    if not _FNS:
        lib = build.load("robust")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f = lib.rank_band_mean_f32
        f.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
        f.restype = ci
        _FNS.update(band=f)
    return _FNS


def smem_bytes(m: int, t: int) -> int:
    """Shared memory of one block: the (M, T) tile, the mask, T/32 partials
    (the layout `csrc/robust.cu::rank_band_smem_bytes` allocates)."""
    return 4 * (m * t + m + t // 32)


def tile_width(m: int) -> int:
    """Coordinates per block for M rows: 256, shrinking in steps of 32 until
    the (M, T) tile fits in shared memory."""
    t = MAX_TILE
    while t >= 32 and smem_bytes(m, t) > SMEM_LIMIT:
        t -= 32
    return t


# the largest cohort a block's tile holds at the narrowest width, T = 32
MAX_ROWS = (SMEM_LIMIT - 4) // (4 * 32 + 4)


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
    band = torch.stack([torch.as_tensor(lo, dtype=torch.float32,
                                        device=g.device).reshape(()),
                        torch.as_tensor(hi, dtype=torch.float32,
                                        device=g.device).reshape(())])
    _check_cuda(("g", g), ("alive", alive), ("band", band))
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f"rank_band_mean takes 1 <= M <= {MAX_ROWS} rows "
                         f"(a (M, 32) tile must fit the {SMEM_LIMIT} bytes "
                         f"of shared memory a block may use), got M={m}")
    if not 1 <= n < 2**31:
        raise ValueError(f"rank_band_mean takes 1 <= N < 2**31, got N={n}")
    fns = _lib()
    t = tile_width(m)
    n_blocks = -(-n // t)
    agg = torch.empty((n,), dtype=torch.float32, device=g.device)
    parts = torch.empty((n_blocks,), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fns["band"](g.data_ptr(), alive.data_ptr(), band.data_ptr(),
                         agg.data_ptr(), parts.data_ptr(), m, n, t, stream)
    _raise_on(rc, "rank_band_mean")
    rank_band_mean.launches += 1
    return agg, parts.sum()


rank_band_mean.launches = 0
