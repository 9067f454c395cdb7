"""Wrapper of the flash attention CUDA kernels: f32 on the CUDA cores
(`csrc/flash_attention.cu`), bf16 on the tensor cores
(`csrc/flash_attention_bf16.cu`: wgmma, TMA).

`flash_attention` — the online-softmax attention forward of
`src/repro/kernels/flash_attention/flash_attention.py`: GQA (query head h
reads KV head h // (H / KV)), causal, sliding window (qi - kj < window) and
logit softcap c * tanh(s / c), f32 softmax, output in q's dtype.  Any S
and any key length S_kv of its own (cross-attention), the masks top-left
aligned as in the TPU kernel; hd a multiple of 8 up to 256; f32 or bf16.
A window with S > S_kv leaves the rows qi >= S_kv + window - 1 no key; like
the plain version (whose masked logit is -1e30, not -inf) they take the
mean of all S_kv values.  The bf16 kernel takes QK^T and P.V
from bf16 operands into f32 accumulators, with P split into two bf16
halves (hi + lo), so it stays within one bf16 step of the plain version's
f32 P.  It also stands for the reference's
`ops.attention`: that entry pads hd to a multiple of 128 for the TPU's
matrix unit, which this kernel does not need, so it takes hd as it is and
keeps the 1/sqrt(hd) temperature.

For a CPU tensor it takes its plain version (`ref.py`).  For a CUDA tensor
it launches its kernel or raises; it never falls back.  It counts its
launches in its `launches` attribute.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_FNS: dict = {}
# dtype -> (library, C entry); both entries take the same arguments
_ENTRIES = {torch.float32: ("flash_attention", "flash_attention_fwd"),
            torch.bfloat16: ("flash_attention_bf16",
                             "flash_attention_bf16_fwd")}


def _fn(dtype):
    """The C entry of the kernel for `dtype`, its library built and loaded
    at first use."""
    if dtype not in _FNS:
        lib_name, entry = _ENTRIES[dtype]
        f = getattr(build.load(lib_name), entry)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        f.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, cf, cf,
                      vp]
        f.restype = ci
        _FNS[dtype] = f
    return _FNS[dtype]


def _check_args(q, k, v, window, softcap):
    """Shapes and options both paths take; returns (B, S, S_kv, H, KV,
    hd)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, heads, hd), got "
                             f"{tuple(t.shape)}")
    b, s, h, hd = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (same B and hd)")
    s_kv, kv = k.shape[1], k.shape[2]
    if h % kv:
        raise ValueError(f"H={h} is not a multiple of KV={kv}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    return b, s, s_kv, h, kv, hd


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None):
    """q (B, S, H, hd), k/v (B, S_kv, KV, hd) -> (B, S, H, hd) in q's
    dtype."""
    b, s, s_kv, h, kv, hd = _check_args(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel path takes "
                             f"CUDA tensors (CPU tensors take the plain "
                             f"version)")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _ENTRIES:
        raise TypeError(f"the flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if not (8 <= hd <= 256 and hd % 8 == 0):
        raise ValueError(f"the flash kernel takes hd a multiple of 8 in "
                         f"[8, 256], got hd={hd}")
    if not (b <= 65535 and h <= 65535):
        raise ValueError(f"shape {tuple(q.shape)} is out of the kernel's "
                         f"range")
    if q.dtype == torch.bfloat16:
        # the tensor maps take 16-byte-aligned bases; work items of 128 rows
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary")
        if -(-s // 128) * h * b > 2 ** 30:
            raise ValueError(f"shape {tuple(q.shape)} is out of the kernel's "
                             f"range")
    fn = _fn(q.dtype)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                s, s_kv, h, kv, hd, int(bool(causal)),
                0 if window is None else int(window),
                0.0 if softcap is None else float(softcap),
                1.0 / math.sqrt(hd), stream)
    if rc != 0:
        why = {-2: "the CUDA driver has no cuTensorMapEncodeTiled",
               -3: "a tensor map could not be made"}.get(
                   rc, f"cudaGetLastError() = {rc}")
        raise RuntimeError(f"flash_attention launch failed: {why}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
