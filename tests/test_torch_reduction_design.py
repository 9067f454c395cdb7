"""The one-launch reductions' order of work, emulated on the CPU, against the
plain versions and the reference's Pallas kernels in interpret mode.

`rloo/csrc/rloo.cu::ncv_weighted_sum_kernel` and
`robust/csrc/robust.cu`'s two rank-band kernels cannot run here, so their
arithmetic is emulated in numpy / torch from the same launch plan the
wrappers compute (`kernels/reduction.py`, `robust.plan`) and the panel
sizes `robust.cu` declares:

  norm — each thread's sum of squares over the V-float vectors it strides
         to, a shuffle tree in each warp, the warps in order, one partial a
         block, and the last block's index-order sum of the partials
         (`csrc/reduction.cuh::grid_sum`).  Held to `ncv_weighted_sum_ref`
         and the reference's `ncv_weighted_sum` at rtol 1e-4 (a sum of N
         squares in another order), the vector at rtol / atol 1e-5;
  band — the panel path: chunks of R rows u, every row v streamed in panels
         of P rows, each rank summed over v in order and the band over u in
         order.  Bitwise equal to the row-order emulation
         (`ref.rank_band_mean_rowwise`, which the kernel's agg equals on the
         card), and within rtol 1e-5, atol 1e-6 x the largest band sum of
         |g| of the sorting oracle and of the reference (the same multiset
         summed in another order).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rloo import rloo as jrloo
from repro.kernels.robust import ref as jref
from repro.kernels.robust import robust as jrobust
from repro_torch.kernels import reduction
from repro_torch.kernels.rloo.ref import ncv_weighted_sum_ref
from repro_torch.kernels.robust import robust as R
from repro_torch.kernels.robust.ref import (rank_band_mean_ref,
                                            rank_band_mean_rowwise)


def _block_sum(v):
    """reduction.cuh::block_sum over axis -1 (THREADS values a block)."""
    warps = v.reshape(v.shape[:-1] + (-1, 32)).copy()
    off = 16
    while off:
        warps[..., :off] = warps[..., :off] + warps[..., off:2 * off]
        off //= 2
    s = np.zeros(v.shape[:-1], np.float32)
    for i in range(warps.shape[-2]):
        s = s + warps[..., i, 0]
    return s


def _grid_sum(per_thread, blocks):
    """reduction.cuh::grid_sum of one f32 value per thread of the grid."""
    t = reduction.THREADS
    parts = _block_sum(per_thread.reshape(blocks, t))
    lanes = np.zeros(-(-blocks // t) * t, np.float32)
    lanes[:blocks] = parts
    acc = np.zeros(t, np.float32)
    for row in lanes.reshape(-1, t):             # thread i: i, i + T, ...
        acc = acc + row
    return _block_sum(acc)


def _wsum_emulated(g, w):
    m, n = g.shape
    vec = reduction.vector_width(n, torch.from_numpy(g))
    blocks = reduction.grid_blocks(n // vec)
    agg = np.zeros(n, np.float32)
    for u in range(m):        # rows in order, fmaf: the exact product added,
        # then rounded to f32 (through f64, which can round twice on a tie)
        agg = (agg + np.float64(w[u]) * g[u].astype(np.float64)).astype(
            np.float32)
    width = blocks * reduction.THREADS
    items = np.zeros((-(-(n // vec) // width) * width, vec), np.float32)
    items[:n // vec] = agg.reshape(-1, vec)
    sq = np.zeros(width, np.float32)
    for stride in items.reshape(-1, width, vec):  # the grid-stride loop
        for c in range(vec):
            sq = sq + stride[:, c] * stride[:, c]
    return agg, _grid_sum(sq, blocks), vec, blocks


@pytest.mark.parametrize("m,n", [(10, 62006), (2, 62006), (7, 1000), (1, 300),
                                 (3, 4097), (5, 1003), (4, 300000)])
def test_norm_from_block_partials_matches_plain_and_reference(m, n):
    rng = np.random.default_rng(m * n)
    g = rng.standard_normal((m, n)).astype(np.float32)
    w = rng.uniform(-0.2, 1.0, m).astype(np.float32)
    agg, nrm, vec, blocks = _wsum_emulated(g, w)
    assert vec == (4 if n % 4 == 0 else 2 if n % 2 == 0 else 1)
    assert blocks <= reduction.GRID_CAP
    p_agg, p_nrm = ncv_weighted_sum_ref(torch.from_numpy(g),
                                        torch.from_numpy(w))
    j_agg, j_nrm = jrloo.ncv_weighted_sum(jnp.asarray(g), jnp.asarray(w),
                                          interpret=True)
    for want_agg, want_nrm in ((p_agg.numpy(), float(p_nrm)),
                               (np.asarray(j_agg), float(j_nrm))):
        np.testing.assert_allclose(agg, want_agg, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(nrm), want_nrm, rtol=1e-4)


def test_vector_width_follows_length_and_alignment():
    base = torch.zeros(64)
    assert reduction.vector_width(62006, base) == 2       # N = 2 mod 4
    assert reduction.vector_width(16777216, base) == 4
    assert reduction.vector_width(4097, base) == 1
    assert reduction.vector_width(64, base[1:]) == 1      # 4 bytes off
    assert reduction.vector_width(64, base[2:]) == 2      # 8 bytes off
    assert reduction.grid_blocks(31003) == 122
    assert reduction.grid_blocks(4194304) == reduction.GRID_CAP
    assert reduction.grid_blocks(1) == 1


def test_ticket_slots_per_stream_and_per_captured_call(monkeypatch):
    class Stream:
        def __init__(self, handle):
            self.cuda_stream = handle

    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    monkeypatch.setattr(reduction, "TICKET_SLOTS", 5)
    t = reduction._Tickets()
    dev0, dev1 = torch.device("cuda", 0), torch.device("cuda", 1)
    a = t.slot(dev0, Stream(7))
    assert t.slot(dev0, Stream(7)) == a         # stream order: one slot
    b = t.slot(dev0, Stream(8))
    c = t.slot(dev1, Stream(7))
    assert len({a, b, c}) == 3
    capturing[0] = True
    d, e = t.slot(dev0, Stream(7)), t.slot(dev0, Stream(7))
    assert len({a, b, c, d, e}) == 5            # each captured call its own
    with pytest.raises(RuntimeError, match="ticket slots"):
        t.slot(dev0, Stream(7))


def _panel_sizes():
    """robust.cu's kChunkRows and kPanelRows: R and P."""
    src = (Path(R.__file__).parent / "csrc" / "robust.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    return int(consts["kChunkRows"]), int(consts["kPanelRows"])


def _panel_ranks(g, alive):
    """robust.cu::rank_band_panel_kernel's ranks: chunks of R rows u, every
    row v streamed in panels of P rows.  alive is 0 or 1, so the ranks are
    small integers, exact in f32 in any order: a panel's rows are added at
    once."""
    m, n = g.shape
    assert R.plan(m, n).path == "panels"
    rows, panel_rows = _panel_sizes()
    ranks = []
    for u0 in range(0, m, rows):
        x = g[u0:u0 + rows]                                  # (R, N)
        u = torch.arange(u0, u0 + x.shape[0])[:, None]
        rank = torch.zeros_like(x)
        for v0 in range(0, m, panel_rows):
            panel = g[v0:v0 + panel_rows, None]              # (P, 1, N)
            v = torch.arange(v0, v0 + panel.shape[0])[:, None, None]
            below = (panel < x) | ((panel == x) & (v < u))
            rank = rank + (alive[v0:v0 + panel_rows, None, None]
                           * below.float()).sum(dim=0)
        ranks.append(rank)
    return torch.cat(ranks)


def _band_from_ranks(g, alive, rank, lo, hi):
    """The band summed over rows u in order, carried across the chunks."""
    lo, hi = torch.tensor(lo), torch.tensor(hi)      # f32, as the kernel
    acc = torch.zeros(g.shape[1])
    for u in range(g.shape[0]):
        inc = (rank[u] >= lo) & (rank[u] <= hi) & (alive[u] > 0)
        acc = acc + torch.where(inc, g[u], torch.zeros_like(g[u]))
    return acc / torch.clamp(hi - lo + 1.0, min=1.0)


@pytest.mark.parametrize("m,n", [(1, 517), (2, 300), (10, 1001), (33, 257),
                                 (257, 65), (2000, 19)])
def test_band_by_chunks_and_panels_equals_row_order(m, n):
    rng = np.random.default_rng(m + n)
    g = np.round(rng.standard_normal((m, n)) * 4.0) / 4.0   # many ties
    g = torch.from_numpy(g.astype(np.float32))
    alive = torch.from_numpy((rng.uniform(size=m) > 0.25).astype(np.float32))
    alive[0] = 1.0
    m_v = float(alive.sum())
    k, mid = min(1.0, np.floor((m_v - 1) / 2)), np.floor((m_v - 1) / 2)
    mag = float(g.abs().sum(dim=0).max()) or 1.0
    rank = _panel_ranks(g, alive) if m > R.REG_ROWS else None
    for lo, hi in ((k, m_v - 1 - k), (mid, m_v - 1 - mid), (0.0, m_v - 1)):
        lo, hi = float(lo), float(hi)
        row, row_nrm = rank_band_mean_rowwise(g, alive, lo, hi)
        if rank is not None:
            assert torch.equal(_band_from_ranks(g, alive, rank, lo, hi), row)
        else:
            assert R.plan(m, n).path == "registers"
        plain, plain_nrm = rank_band_mean_ref(g, alive, lo, hi)
        wants = [(plain.numpy(), float(plain_nrm))]
        j, j_nrm = jref.rank_band_mean_ref(jnp.asarray(g.numpy()),
                                           jnp.asarray(alive.numpy()), lo, hi)
        wants.append((np.asarray(j), float(j_nrm)))
        if m <= 33:                  # the Pallas kernel unrolls over M
            j, j_nrm = jrobust.rank_band_mean(
                jnp.asarray(g.numpy()), jnp.asarray(alive.numpy()), lo, hi,
                interpret=True)
            wants.append((np.asarray(j), float(j_nrm)))
        for want, want_nrm in wants:
            np.testing.assert_allclose(row.numpy(), want, rtol=1e-5,
                                       atol=1e-6 * mag)
            np.testing.assert_allclose(float(row_nrm), want_nrm, rtol=1e-4,
                                       atol=1e-6)
