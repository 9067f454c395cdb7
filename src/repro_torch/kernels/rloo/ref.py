"""Plain PyTorch versions of the fused RLOO / aggregation kernels.

They are the CPU path of the kernel wrappers in `rloo.py` and the oracles
the CUDA kernels are held against on the card.  The cohort axis that the
reference vmaps over is written out: `rloo_combine_ref` takes (C, K, N).

The int8 and int4 wire formats (`repro_torch.comm.codecs`) carry chunked
codes with one f32 scale per (client, chunk); their oracles dequantize and
then take the dense weighted sum, as the reference's do.
"""
import torch


def rloo_combine_ref(g, alpha):
    """g (C, K, N), alpha (C,) -> mean (C, N), gprime (C, K, N), sumsq (C,)."""
    g = g.float()
    k = g.shape[1]
    mean = torch.mean(g, dim=1)
    c = (k * mean[:, None, :] - g) / (k - 1)
    gprime = g - alpha.float()[:, None, None] * c
    sumsq = torch.sum(g * g, dim=(1, 2))
    return mean, gprime, sumsq


def ncv_weighted_sum_ref(g_flat, w):
    """(sum_u w_u g_u, ||sum||^2) over the (M, N) stack."""
    agg = torch.sum(w.float()[:, None] * g_flat.float(), dim=0)
    return agg, torch.sum(agg * agg)


def ncv_aggregate_ref(g_flat, n_samples, beta=1.0):
    """Flat-substrate oracle of `networked_aggregate_stacked` (Eq. 10-12).

    g_flat: (M, N); returns (agg (N,), ||agg||^2)."""
    g = g_flat.float()
    n_samples = n_samples.float()
    n = torch.sum(n_samples)
    p = n_samples / n
    gbar_w = torch.sum(p[:, None] * g, dim=0, keepdim=True)
    d = (n - n_samples)[:, None]
    # lone-reporter guard: d = 0 has no leave-one-out network
    c = torch.where(d > 0, (n * gbar_w - n_samples[:, None] * g) / d,
                    torch.zeros_like(g))
    gprime = g - beta * c
    agg = torch.sum(p[:, None] * gprime, dim=0)
    return agg, torch.sum(agg * agg)


def dequantize_int8_ref(q, scales, chunk=512):
    """Chunked-scale int8 dequantization (the comm `int8` wire format).

    q: (..., C*chunk) int8; scales: (..., C) f32.  Returns f32 of q's shape.
    """
    lead = tuple(q.shape[:-1])
    c = scales.shape[-1]
    g = q.float().reshape(lead + (c, chunk))
    return (g * scales.float()[..., None]).reshape(lead + (c * chunk,))


def ncv_aggregate_q_ref(q, scales, n_samples, beta=1.0, chunk=512):
    """Decode-then-aggregate oracle of `ncv_aggregate_q`.

    q: (M, N_packed) int8 cohort stack; scales: (M, C) per-chunk f32.
    Returns (agg (N_packed,), ||agg||^2)."""
    return ncv_aggregate_ref(dequantize_int8_ref(q, scales, chunk=chunk),
                             n_samples, beta)


def ncv_weighted_sum_q_ref(q, scales, w, chunk=512):
    """Decode-then-weighted-sum oracle of `ncv_weighted_sum_q`."""
    return ncv_weighted_sum_ref(dequantize_int8_ref(q, scales, chunk=chunk),
                                w)


def unpack_int4_ref(qp, chunk=512):
    """Packed int4 (split-halves layout) -> int32 codes in [-8, 7].

    qp: (..., C * chunk // 2) uint8.  Within each chunk, byte j carries
    code j in its low nibble and code j + chunk/2 in its high nibble;
    codes >= 8 are two's-complement negatives (code - 16)."""
    lead = tuple(qp.shape[:-1])
    c = qp.shape[-1] * 2 // chunk
    b = qp.to(torch.int32).reshape(lead + (c, chunk // 2))
    codes = torch.cat([b & 0xF, (b >> 4) & 0xF], dim=-1)
    codes = torch.where(codes < 8, codes, codes - 16)
    return codes.reshape(lead + (c * chunk,))


def dequantize_int4_ref(qp, scales, chunk=512):
    """Packed int4 + per-chunk scales -> f32 (the comm `int4` wire format).

    qp: (..., C*chunk//2) uint8; scales: (..., C) f32.  Returns f32 of
    shape (..., C*chunk)."""
    lead = tuple(qp.shape[:-1])
    c = scales.shape[-1]
    g = unpack_int4_ref(qp, chunk=chunk).float()
    g = g.reshape(lead + (c, chunk)) * scales.float()[..., None]
    return g.reshape(lead + (c * chunk,))


def ncv_aggregate_q4_ref(qp, scales, n_samples, beta=1.0, chunk=512):
    """Decode-then-aggregate oracle of `ncv_aggregate_q4`."""
    return ncv_aggregate_ref(dequantize_int4_ref(qp, scales, chunk=chunk),
                             n_samples, beta)


def ncv_weighted_sum_q4_ref(qp, scales, w, chunk=512):
    """Decode-then-weighted-sum oracle of `ncv_weighted_sum_q4`."""
    return ncv_weighted_sum_ref(dequantize_int4_ref(qp, scales, chunk=chunk),
                                w)
