"""Plain PyTorch versions of the fused RLOO / aggregation kernels.

They are the CPU path of the kernel wrappers in `rloo.py` and the oracles
the CUDA kernels are held against on the card.  The cohort axis that the
reference vmaps over is written out: `rloo_combine_ref` takes (C, K, N).
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
