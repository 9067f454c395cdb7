"""Wrappers of the two FedNCV CUDA kernels (`csrc/rloo.cu`).

`rloo_combine` — the client-side RLOO pass over the (C, K, N) cohort stack
of microbatch gradients: mean, reshaped units g' = g - alpha (K gbar - g) /
(K - 1) and S2 = sum_i ||g_i||^2, in one read.  The reference vmaps its
(K, N) kernel over the cohort; here the cohort axis is the kernel's grid.

`ncv_weighted_sum` — the server-side collapsed Eq. 10-12 reduction
sum_u w_u g_u over the (M, N) stack plus ||agg||^2; `ncv_aggregate`
derives the weights with `ncv_coefficients`.

A wrapper takes its plain version (`ref.py`) only for CPU tensors.  For a
CUDA tensor it launches its kernel or raises; it never falls back.  Each
wrapper counts its launches in its `launches` attribute.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rloo.ref import (ncv_weighted_sum_ref,
                                          rloo_combine_ref)

_FNS: dict = {}


def _lib():
    if not _FNS:
        lib = build.load("rloo")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f = lib.rloo_combine_f32
        f.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
        f.restype = ci
        h = lib.ncv_weighted_sum_f32
        h.argtypes = [vp, vp, vp, vp, ci, ci, vp]
        h.restype = ci
        lib.rloo_threads_per_block.restype = ci
        _FNS.update(rloo=f, wsum=h, threads=lib.rloo_threads_per_block())
    return _FNS


def _check(name, t, ndim, device=None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
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
    n_blocks = -(-n // fns["threads"])
    agg = torch.empty((n,), dtype=torch.float32, device=g.device)
    parts = torch.empty((n_blocks,), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fns["wsum"](g.data_ptr(), w.data_ptr(), agg.data_ptr(),
                         parts.data_ptr(), m, n, stream)
    _raise_on(rc, "ncv_weighted_sum")
    ncv_weighted_sum.launches += 1
    return agg, parts.sum()


ncv_weighted_sum.launches = 0


def ncv_aggregate(g, n_samples, beta=1.0):
    """Fused FedNCV server reduction: (agg (N,), ||agg||^2) of Eq. 10-12."""
    return ncv_weighted_sum(g, ncv_coefficients(n_samples, beta).to(g.device))
