"""Wrappers of the two FedNCV CUDA kernels (`csrc/rloo.cu`).

`rloo_combine` — the client-side RLOO pass over the (C, K, N) cohort stack
of microbatch gradients: mean, reshaped units g' = g - alpha (K gbar - g) /
(K - 1) and S2 = sum_i ||g_i||^2, in one read.  The reference vmaps its
(K, N) kernel over the cohort; here the cohort axis is the kernel's grid.

`ncv_weighted_sum` — the server-side collapsed Eq. 10-12 reduction
sum_u w_u g_u over the (M, N) stack plus ||agg||^2, both from one launch
(`kernels/reduction.py` plans it); `ncv_aggregate` derives the weights with
`ncv_coefficients`.

`ncv_weighted_sum_q` / `ncv_weighted_sum_q4` — the same weighted sum and
norm straight off the int8 / packed-int4 wire (`csrc/rloo_q.cu`), also from
one launch: the codes are read V bytes at a time and dequantized in
registers with their per-(client, chunk) scale, never written back as f32
(`wire_plan` picks V and the grid).  `ncv_aggregate_q` / `ncv_aggregate_q4`
derive the weights with `ncv_coefficients`.

A wrapper takes its plain version (`ref.py`) only for CPU tensors.  For a
CUDA tensor it launches its kernel or raises; it never falls back.  Each
wrapper counts its launches in its `launches` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, reduction
from repro_torch.kernels.rloo.ref import (ncv_weighted_sum_q4_ref,
                                          ncv_weighted_sum_q_ref,
                                          ncv_weighted_sum_ref,
                                          rloo_combine_ref)

_FNS: dict = {}
_QFNS: dict = {}


def _lib():
    if not _FNS:
        lib = build.load("rloo")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f = lib.rloo_combine_f32
        f.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
        f.restype = ci
        h = lib.ncv_weighted_sum_f32
        h.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        h.restype = ci
        lib.rloo_threads_per_block.restype = ci
        _FNS.update(rloo=f, wsum=h, threads=lib.rloo_threads_per_block())
    return _FNS


def _qlib():
    if not _QFNS:
        lib = build.load("rloo_q")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.ncv_weighted_sum_q_i8, lib.ncv_weighted_sum_q4_u8):
            fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
            fn.restype = ci
        _QFNS.update(q8=lib.ncv_weighted_sum_q_i8,
                     q4=lib.ncv_weighted_sum_q4_u8)
    return _QFNS


def _check(name, t, ndim, device=None, dtype=torch.float32):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _check_cuda(*named):
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel path "
                             f"takes CUDA tensors (CPU tensors take the "
                             f"plain version)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaGetLastError() = {rc}")


def rloo_combine(g, alpha):
    """g (C, K, N) f32, alpha (C,) f32 -> (mean (C, N), gprime (C, K, N),
    sumsq (C,))."""
    _check("g", g, 3)
    _check("alpha", alpha, 1, g.device)
    c, k, n = g.shape
    if k < 2:
        raise ValueError(f"RLOO needs K >= 2, got K={k}")
    if alpha.shape[0] != c:
        raise ValueError(f"alpha has {alpha.shape[0]} entries for C={c}")
    if g.device.type == "cpu":
        return rloo_combine_ref(g, alpha)
    _check_cuda(("g", g), ("alpha", alpha))
    if not (1 <= c <= 65535 and 1 <= n < 2**31):
        raise ValueError(f"rloo_combine takes 1 <= C <= 65535 and "
                         f"1 <= N < 2**31, got C={c}, N={n}")
    fns = _lib()
    n_blocks = -(-n // fns["threads"])
    mean = torch.empty((c, n), dtype=torch.float32, device=g.device)
    gprime = torch.empty_like(g)
    parts = torch.empty((c, n_blocks), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fns["rloo"](g.data_ptr(), alpha.data_ptr(), mean.data_ptr(),
                         gprime.data_ptr(), parts.data_ptr(), c, k, n, stream)
    _raise_on(rc, "rloo_combine")
    rloo_combine.launches += 1
    return mean, gprime, parts.sum(dim=1)


rloo_combine.launches = 0


def ncv_coefficients(n_samples, beta):
    """Per-client scalar weights w_u of the collapsed Eq. 10-12 estimator.

    A client with n_u = 0 (a padding row) gets w_u = 0 exactly.  A lone
    reporter (n_u = n, every peer at zero) has no leave-one-out network:
    its 1/(n - n_u) ratios are where-guarded to 0, so the estimator
    degrades to the plain weighted mean instead of 0 * inf = NaN.
    """
    n_samples = torch.as_tensor(n_samples, dtype=torch.float32)
    n = torch.sum(n_samples)
    p = n_samples / n
    d = n - n_samples
    zero = torch.zeros_like(d)
    a0 = 1.0 - beta * torch.sum(p * torch.where(d > 0, n / d, zero))
    return a0 * p + beta * p * torch.where(d > 0, n_samples / d, zero)


def ncv_weighted_sum(g, w):
    """g (M, N) f32, w (M,) f32 -> (agg (N,), ||agg||^2)."""
    _check("g", g, 2)
    _check("w", w, 1, g.device)
    m, n = g.shape
    if w.shape[0] != m:
        raise ValueError(f"w has {w.shape[0]} entries for M={m}")
    if g.device.type == "cpu":
        return ncv_weighted_sum_ref(g, w)
    _check_cuda(("g", g), ("w", w))
    if not (1 <= m < 2**31 and 1 <= n < 2**31):
        raise ValueError(f"ncv_weighted_sum takes 1 <= M, N < 2**31, "
                         f"got M={m}, N={n}")
    fns = _lib()
    agg = torch.empty((n,), dtype=torch.float32, device=g.device)
    nrm = torch.empty((), dtype=torch.float32, device=g.device)
    vec = reduction.vector_width(n, g)
    blocks = reduction.grid_blocks(n // vec)
    parts = torch.empty((blocks,), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device)
        rc = fns["wsum"](g.data_ptr(), w.data_ptr(), agg.data_ptr(),
                         parts.data_ptr(), nrm.data_ptr(), m, n, vec, blocks,
                         reduction.ticket_slot(g.device, stream),
                         stream.cuda_stream)
    _raise_on(rc, "ncv_weighted_sum")
    ncv_weighted_sum.launches += 1
    return agg, nrm


ncv_weighted_sum.launches = 0


def ncv_aggregate(g, n_samples, beta=1.0):
    """Fused FedNCV server reduction: (agg (N,), ||agg||^2) of Eq. 10-12."""
    return ncv_weighted_sum(g, ncv_coefficients(n_samples, beta).to(g.device))


def _check_wire(q, scales, w, chunk, codes_per_byte, dtype):
    """Shapes of a stacked quantized wire; returns (M, C)."""
    _check("q", q, 2, dtype=dtype)
    _check("scales", scales, 2, q.device)
    _check("w", w, 1, q.device)
    m, n_bytes = q.shape
    if chunk < codes_per_byte or chunk % codes_per_byte:
        raise ValueError(f"chunk={chunk} must be a positive multiple of "
                         f"{codes_per_byte}")
    c = n_bytes * codes_per_byte // chunk
    if c * chunk != n_bytes * codes_per_byte:
        raise ValueError(f"q has {n_bytes} bytes a row, not a whole number "
                         f"of chunks of {chunk} codes")
    if tuple(scales.shape) != (m, c):
        raise ValueError(f"scales has shape {tuple(scales.shape)}, expected "
                         f"{(m, c)}")
    if w.shape[0] != m:
        raise ValueError(f"w has {w.shape[0]} entries for M={m}")
    return m, c


def wire_plan(q, chunk, codes_per_byte):
    """(V, blocks) of a wire kernel's launch on the (M, bytes) code stack
    `q`: V bytes a load, V dividing the chunk's bytes (int8) or half-chunk
    (int4) and q's alignment, at most 8 once a row fills the capped grid at
    8 bytes a thread (the threads then stride) and at most 4 below that
    (more blocks for short rows); a grid of `reduction.grid_blocks` over
    the row's vectors.  On the H100 V = 8 moved the most bytes at
    16,777,216 codes and V = 4 was quickest at the FL slice's 122 chunks
    (`benchmarks/port/reduction_variants.py`); V = 16 lost at both.  The
    plan depends on the shapes and the alignment alone, so the norm's order
    of summation is the same from call to call."""
    row_bytes = q.shape[1]
    full = row_bytes // 8 >= reduction.GRID_CAP * reduction.THREADS
    vec = reduction.vector_width_bytes(row_bytes, chunk // codes_per_byte, q,
                                       widest=8 if full else 4)
    return vec, reduction.grid_blocks(row_bytes // vec)


def _launch_wire(key, what, q, scales, w, m, c, chunk, codes_per_byte):
    _check_cuda(("q", q), ("scales", scales), ("w", w))
    if not (1 <= m < 2**31 and 1 <= c * chunk < 2**31):
        raise ValueError(f"{what} takes 1 <= M, C*chunk < 2**31, got M={m}, "
                         f"C*chunk={c * chunk}")
    fns = _qlib()
    vec, blocks = wire_plan(q, chunk, codes_per_byte)
    agg = torch.empty((c * chunk,), dtype=torch.float32, device=q.device)
    nrm = torch.empty((), dtype=torch.float32, device=q.device)
    parts = torch.empty((blocks,), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device)
        rc = fns[key](q.data_ptr(), scales.data_ptr(), w.data_ptr(),
                      agg.data_ptr(), parts.data_ptr(), nrm.data_ptr(), m, c,
                      chunk, vec, blocks,
                      reduction.ticket_slot(q.device, stream),
                      stream.cuda_stream)
    _raise_on(rc, what)
    return agg, nrm


def ncv_weighted_sum_q(q, scales, w, *, chunk=512):
    """q (M, C*chunk) int8, scales (M, C) f32, w (M,) f32 ->
    (agg (C*chunk,), ||agg||^2) with agg = sum_u w_u (q_u * s_u)."""
    m, c = _check_wire(q, scales, w, chunk, 1, torch.int8)
    if q.device.type == "cpu":
        return ncv_weighted_sum_q_ref(q, scales, w, chunk=chunk)
    out = _launch_wire("q8", "ncv_weighted_sum_q", q, scales, w, m, c, chunk,
                       1)
    ncv_weighted_sum_q.launches += 1
    return out


ncv_weighted_sum_q.launches = 0


def ncv_weighted_sum_q4(qp, scales, w, *, chunk=512):
    """qp (M, C*chunk/2) uint8 split-halves int4, scales (M, C) f32, w (M,)
    f32 -> (agg (C*chunk,), ||agg||^2)."""
    m, c = _check_wire(qp, scales, w, chunk, 2, torch.uint8)
    if qp.device.type == "cpu":
        return ncv_weighted_sum_q4_ref(qp, scales, w, chunk=chunk)
    out = _launch_wire("q4", "ncv_weighted_sum_q4", qp, scales, w, m, c,
                       chunk, 2)
    ncv_weighted_sum_q4.launches += 1
    return out


ncv_weighted_sum_q4.launches = 0


def ncv_aggregate_q(q, scales, n_samples, beta=1.0, *, chunk=512):
    """`ncv_aggregate` straight off the int8 wire."""
    return ncv_weighted_sum_q(
        q, scales, ncv_coefficients(n_samples, beta).to(q.device),
        chunk=chunk)


def ncv_aggregate_q4(qp, scales, n_samples, beta=1.0, *, chunk=512):
    """`ncv_aggregate` straight off the packed int4 wire."""
    return ncv_weighted_sum_q4(
        qp, scales, ncv_coefficients(n_samples, beta).to(qp.device),
        chunk=chunk)
