"""Plain PyTorch versions of the robust-aggregation kernel.

`rank_band_mean_ref` is the CPU path of `robust.rank_band_mean` and the
oracle the CUDA kernel is held against on the card.  The oracle sorts; the
kernel counts stable ranks pairwise (ties broken by row index).  Ranks are
then a permutation of 0..m_valid-1, so the multiset of values inside a band
of ranks is the same either way and only the order of the band's sum
differs.  `rank_band_mean_rowwise` does the kernel's own arithmetic in the
kernel's order, so the kernel's band mean equals it bitwise.
"""
import torch


def rank_band_mean_ref(g_flat, alive, lo, hi):
    """Mean of the order-statistic band [lo, hi] per coordinate, over the
    alive rows only.

    g_flat: (M, N) f32 cohort stack; alive: (M,) validity mask (> 0 keeps
    the row); lo, hi: scalar ranks into the alive rows' ascending order,
    inclusive (floats or 0-d tensors).  Returns (band_mean (N,),
    ||band_mean||^2).

    Dead rows are pushed to +inf before the sort, so positions >= m_valid
    never land in a band with hi <= m_valid - 1; hi < lo (only for
    m_valid = 0) yields zeros, not NaN."""
    g = g_flat.float()
    keep = torch.as_tensor(alive, device=g.device) > 0
    gs = torch.sort(torch.where(keep[:, None], g,
                                torch.full_like(g, float("inf"))),
                    dim=0).values
    lo = torch.as_tensor(lo, dtype=torch.float32, device=g.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=g.device)
    pos = torch.arange(g.shape[0], dtype=torch.float32,
                       device=g.device)[:, None]
    inc = (pos >= lo) & (pos <= hi)
    cnt = torch.clamp(hi - lo + 1.0, min=1.0)
    band = torch.sum(torch.where(inc, gs, torch.zeros_like(gs)), dim=0) / cnt
    return band, torch.sum(band * band)


def rank_band_mean_rowwise(g_flat, alive, lo, hi):
    """`rank_band_mean_ref` by the kernel's order of work: each rank summed
    over rows v = 0..M-1, the band over rows u = 0..M-1, one f32 rounding a
    step, then one division.  Returns (band_mean (N,), ||band_mean||^2)."""
    g = g_flat.float()
    m = g.shape[0]
    alive = torch.as_tensor(alive, dtype=torch.float32, device=g.device)
    lo = torch.as_tensor(lo, dtype=torch.float32, device=g.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=g.device)
    rows = torch.arange(m, device=g.device)[:, None]
    rank = torch.zeros_like(g)
    for v in range(m):
        # g_v < g_u, or a tie that row order breaks (v < u)
        below = (g[v] < g) | ((g[v] == g) & (v < rows))
        rank = rank + alive[v] * below.float()
    inc = (rank >= lo) & (rank <= hi) & (alive[:, None] > 0)
    acc = torch.zeros_like(g[0])
    for u in range(m):
        acc = acc + torch.where(inc[u], g[u], torch.zeros_like(g[u]))
    band = acc / torch.clamp(hi - lo + 1.0, min=1.0)
    return band, torch.sum(band * band)


def masked_median_1d(x, mask):
    """Median of x[mask] for a 1-D x; 0.0 when the mask is empty.

    The norm-clipping aggregator's threshold: the median upload norm over
    the reporting clients is a robust scale estimate (a minority of
    inflated norms cannot drag it)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    keep = torch.as_tensor(mask, device=x.device) > 0
    m_v = torch.sum(keep.float())
    xs = torch.sort(torch.where(keep, x, torch.full_like(x, float("inf"))))[0]
    safe = torch.clamp(m_v, min=1.0)
    lo = torch.floor((safe - 1.0) / 2.0).long()
    hi = torch.floor(safe / 2.0).long()
    med = 0.5 * (xs[lo] + xs[hi])
    return torch.where(m_v > 0, med, torch.zeros_like(med))
