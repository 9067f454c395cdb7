"""The port's robust aggregators (`repro_torch.fed.aggregators`) and the
plain version of their kernel (`kernels/robust`) against the reference's
on the CPU.

Inputs are made with numpy from fixed seeds.  The reference's functions
run through its plain oracles (`use_pallas=False`); `tests/test_faults.py`
already holds its Pallas kernel to them.

Tolerances and why:
  band means and reducers — rtol 1e-5, atol 1e-6 x the largest band sum
          of |g|: the same sorted multiset summed in another order;
  masked median — bitwise: a sort and one average of the same two values;
  norms of the results — rtol 1e-4: a sum of N squares in another order.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed import aggregators as jagg
from repro.kernels.robust import ref as jref
from repro_torch import comm
from repro_torch.fed import aggregators as A
from repro_torch.kernels import reduction
from repro_torch.kernels.robust import robust as R
from repro_torch.kernels.robust.ref import (masked_median_1d,
                                            rank_band_mean_ref)
from repro_torch.utils.tree_math import flat_spec


def _stack(seed, m, n, ties=False):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((m, n)) * rng.uniform(0.1, 10.0, (m, 1))
    if ties:                                 # a coarse grid: many ties
        g = np.round(g * 2.0) / 2.0
    return g.astype(np.float32)


def _close(got, want, g):
    mag = float(np.abs(g).sum(axis=0).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6 * mag)


def _numpy_band(g, alive, lo, hi):
    """Band mean by an explicit numpy sort of each coordinate's alive rows."""
    live = g[alive > 0]
    out = np.zeros(g.shape[1], np.float64)
    if len(live):
        srt = np.sort(live, axis=0)
        lo_i, hi_i = int(lo), int(hi)
        out = srt[lo_i:hi_i + 1].astype(np.float64).sum(axis=0)
    return out / max(hi - lo + 1.0, 1.0)


ALIVE = {
    "all": lambda m: np.ones(m, np.float32),
    "dead-rows": lambda m: (np.arange(m) % 3 != 1).astype(np.float32),
    "one-alive": lambda m: (np.arange(m) == m - 1).astype(np.float32),
    "none-alive": lambda m: np.zeros(m, np.float32),
}


@pytest.mark.parametrize("alive_kind", list(ALIVE))
@pytest.mark.parametrize("m,n,ties", [(10, 3001, True), (12, 777, False),
                                      (2, 513, True)])
def test_rank_band_mean_plain_matches_reference_and_numpy(alive_kind, m, n,
                                                          ties):
    g = _stack(m * n, m, n, ties)
    alive = ALIVE[alive_kind](m)
    m_v = float(alive.sum())
    k = min(1.0, np.floor(max(m_v - 1.0, 0.0) / 2.0))
    mid = max(np.floor((m_v - 1.0) / 2.0), 0.0)
    launches = R.rank_band_mean.launches
    for lo, hi in ((k, m_v - 1.0 - k), (mid, m_v - 1.0 - mid),
                   (0.0, m_v - 1.0)):
        band, nrm = R.rank_band_mean(torch.from_numpy(g),
                                     torch.from_numpy(alive), lo, hi)
        jband, jnrm = jref.rank_band_mean_ref(jnp.asarray(g),
                                              jnp.asarray(alive), lo, hi)
        _close(band.numpy(), jband, g)
        _close(band.numpy(), _numpy_band(g, alive, lo, hi), g)
        np.testing.assert_allclose(float(nrm), float(jnrm), rtol=1e-4)
        if m_v == 0:
            assert not band.any()
    assert R.rank_band_mean.launches == launches      # CPU: plain version


def test_rank_band_mean_takes_device_scalars():
    g = _stack(0, 5, 100)
    alive = np.ones(5, np.float32)
    a = rank_band_mean_ref(torch.from_numpy(g), torch.from_numpy(alive),
                           torch.tensor(1.0), torch.tensor(3.0))
    b = rank_band_mean_ref(torch.from_numpy(g), torch.from_numpy(alive),
                           1.0, 3.0)
    assert torch.equal(a[0], b[0])


@pytest.mark.parametrize("mask", [[1, 1, 1, 1, 1], [1, 0, 1, 1, 0],
                                  [0, 0, 0, 0, 1], [0, 0, 0, 0, 0],
                                  [1, 1, 0, 1, 1]])
def test_masked_median_1d_matches_reference(mask):
    x = np.array([3.0, -1.0, 7.5, 2.0, 2.0], np.float32)
    mask = np.array(mask, np.float32)
    got = masked_median_1d(torch.from_numpy(x), torch.from_numpy(mask))
    want = jref.masked_median_1d(jnp.asarray(x), jnp.asarray(mask))
    assert float(got) == float(want)


REDUCERS = {
    "trimmed_mean": (jagg._trimmed_reduce, dict(trim_frac=0.25)),
    "trimmed_mean-default": (jagg._trimmed_reduce, dict(trim_frac=0.2)),
    "median": (jagg._median_reduce, {}),
    "norm_clip": (jagg._norm_clip_reduce, dict(clip_mult=2.0)),
    "norm_clip-tight": (jagg._norm_clip_reduce, dict(clip_mult=0.5)),
}


@pytest.mark.parametrize("case", list(REDUCERS))
@pytest.mark.parametrize("weights", [[3, 5, 0, 8, 2, 9, 4, 1, 6, 7],
                                     [0, 0, 0, 0, 0, 0, 0, 0, 0, 4],
                                     [1] * 10])
def test_reducers_match_reference(case, weights):
    jfn, opts = REDUCERS[case]
    name = case.split("-")[0]
    g = _stack(len(case), 10, 2000, ties=True)
    g[3] *= 50.0                                  # one inflated upload
    w = np.array(weights, np.float32)
    beta = 0.0 if name != "norm_clip" else 1.0
    agg = A.get_aggregator(name)
    opts = A.resolve_opts(agg, opts)
    vec, nrm = agg.reduce(opts, torch.from_numpy(g), torch.from_numpy(w),
                          beta)
    jvec, jnrm = jfn(opts, jnp.asarray(g), jnp.asarray(w), beta,
                     use_pallas=False)
    _close(vec.numpy(), jvec, g)
    np.testing.assert_allclose(float(nrm), float(jnrm), rtol=1e-4)


def test_registry_defaults_and_validation_match_reference():
    assert A.registered_aggregators() == jagg.registered_aggregators()
    for name in A.registered_aggregators():
        a, j = A.get_aggregator(name), jagg.get_aggregator(name)
        assert (a.options, a.defaults, a.honors_beta, a.fused_wire) == \
            (j.options, j.defaults, j.honors_beta, j.fused_wire)
        assert A.resolve_opts(a, None) == jagg.resolve_opts(j, None)
    for name, bad in (("trimmed_mean", dict(trim_frac=0.5)),
                      ("trimmed_mean", dict(trim_frac=-0.1)),
                      ("norm_clip", dict(clip_mult=0.0))):
        with pytest.raises(ValueError):
            jagg.resolve_opts(jagg.get_aggregator(name), bad)
        with pytest.raises(ValueError):
            A.resolve_opts(A.get_aggregator(name), bad)
    with pytest.raises(TypeError):
        A.resolve_opts(A.get_aggregator("median"), dict(trim_frac=0.1))
    with pytest.raises(KeyError, match="unknown aggregator"):
        A.get_aggregator("krum")


@pytest.mark.parametrize("name", ["trimmed_mean", "median", "norm_clip",
                                  "mean"])
def test_aggregate_stack_decodes_the_wire_once(name):
    tree = {"w": torch.from_numpy(_stack(1, 5, 600).reshape(5, 20, 30)),
            "b": torch.from_numpy(_stack(2, 5, 7))}
    spec = flat_spec(tree)
    codec = comm.get_codec("int8", n=spec.n)
    from repro_torch.utils.tree_math import ravel_stack
    flat, _ = ravel_stack(tree)
    u = torch.rand(codec.uniforms_shape(5),
                   generator=torch.Generator().manual_seed(0))
    wire, _ = codec.encode(flat, None, u)
    w = torch.tensor([4.0, 1.0, 0.0, 2.0, 3.0])
    agg = A.get_aggregator(name)
    opts = A.resolve_opts(agg, None)
    beta = 1.0 if agg.honors_beta else 0.0
    got, nrm = A.aggregate_stack(agg, opts, wire, w, beta, codec, spec)
    want, wnrm = agg.reduce(opts, codec.decode(wire), w, beta)
    assert got["w"].shape == (20, 30) and got["b"].shape == (7,)
    _close(torch.cat([got["b"], got["w"].reshape(-1)]).numpy(),
           want.numpy(), codec.decode(wire).numpy())
    np.testing.assert_allclose(float(nrm), float(wnrm), rtol=1e-4)
    dense, dnrm = A.aggregate_stack(agg, opts, tree, w, beta, None, spec)
    assert dense["w"].shape == (20, 30)


def _kernel_static_shared_bytes():
    """The most static shared memory a block of `robust.cu`'s kernels can
    declare, read from the sources: every `__shared__` array of robust.cu
    and of the reduction.cuh it includes, its extents evaluated from the
    files' integer constants (grid_sum's block at the larger of the two
    kernels' sizes).  An extent that names anything else (M, N) raises."""
    csrc = Path(R.__file__).parent / "csrc" / "robust.cu"
    texts = [csrc.read_text(),
             (csrc.parents[2] / "csrc" / "reduction.cuh").read_text()]
    consts = {k: int(v) for t in texts
              for k, v in re.findall(r"constexpr int (\w+) = (\d+);", t)}
    consts["kThreads"] = max(consts["kThreads"], consts["kPanelThreads"])
    size = {"float": 4, "bool": 1}
    total = 0
    for t in texts:
        for kind, dims in re.findall(r"__shared__ (\w+) \w+((?:\[[^\]]+\])*);",
                                     t):
            nbytes = size[kind]
            for d in re.findall(r"\[([^\]]+)\]", dims):
                nbytes *= eval(d.replace("/", "//"), {"__builtins__": {}},
                               consts)
            total += nbytes
    return total, consts


@pytest.mark.parametrize("m", [1, 8, 9, 10, 16, 17, 32, 33, 257, 1761, 2000,
                                100000])
def test_launch_plan_fits_shared_memory_for_any_cohort(m):
    smem, consts = _kernel_static_shared_bytes()
    assert smem <= 48 * 1024            # static, without opting in, any M
    assert (consts["kRegRows"], consts["kPanelThreads"]) == (R.REG_ROWS,
                                                             R.PANEL_THREADS)
    for n, vec in ((62006, 2), (4099, 1), (16777216, 4)):
        p = R.plan(m, n, vec)
        if m <= R.REG_ROWS:
            assert (p.path, p.vec) == ("registers", vec)
            # every column is some thread's: one vector each, or a stride
            assert p.blocks == min(-(-n // vec // reduction.THREADS),
                                   reduction.GRID_CAP)
        else:
            assert (p.path, p.vec) == ("panels", 1)
            assert p.blocks * R.PANEL_THREADS >= n > \
                (p.blocks - 1) * R.PANEL_THREADS


def test_rank_band_wrapper_rejects_what_the_kernel_does_not_take():
    g = torch.zeros(4, 100)
    with pytest.raises(ValueError):
        R.rank_band_mean(g, torch.ones(3), 0.0, 1.0)
    with pytest.raises(TypeError):
        R.rank_band_mean(g.double(), torch.ones(4), 0.0, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        R.rank_band_mean(torch.zeros(4, 100, device="meta"),
                         torch.ones(4, device="meta"), 0.0, 1.0)
