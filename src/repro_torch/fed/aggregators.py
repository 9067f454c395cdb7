"""Server-side aggregation strategies (`src/repro/fed/aggregators.py`).

    mean          the fused Eq. 10-12 weighted sum with the method's beta,
                  the default; it takes the codec's wire directly
                  (`methods._aggregate`: `ncv_weighted_sum`, or the
                  dequantize-aggregate kernels for int8 / int4).
    trimmed_mean  coordinate-wise trimmed mean: per coordinate, drop the
                  k = floor(trim_frac * m_valid) smallest and largest
                  reporting values and average the rest.
    median        coordinate-wise median (the maximally trimmed band).
    norm_clip     the Eq. 10-12 weighted sum with each upload clipped to
                  clip_mult x the median reporting norm.

The order-statistic pair runs on the `rank_band_mean` kernel, `norm_clip`
on `ncv_weighted_sum`; all but `mean` get the wire decoded once to the
dense (C, N) stack.  Robust aggregators are unweighted over the valid
rows (sample counts are client-reported, so weighting by them would hand a
Byzantine client a free amplification knob): the Eq. 10-12 weights enter
only as a validity mask (w_u > 0), so `trimmed_mean` and `median` do not
honor a nonzero method beta and `FLConfig` rejects that combination.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import torch

from repro_torch.fed import methods as M
from repro_torch.kernels.rloo.rloo import ncv_coefficients, ncv_weighted_sum
from repro_torch.kernels.robust.ref import masked_median_1d
from repro_torch.kernels.robust.robust import rank_band_mean
from repro_torch.utils.tree_math import ravel_stack, unravel


@dataclasses.dataclass(frozen=True)
class Aggregator:
    """A server-side cohort reduction as one strategy object.

    reduce      : (opts, g_flat (C, N) f32, weights (C,), beta) ->
                  (agg (N,) f32, ||agg||^2).  `weights` are the Eq. 10-12
                  effective counts (exactly 0 marks an invalid row).
    honors_beta : the reduction applies the method's server-side CV
                  coefficient; False makes FLConfig reject beta != 0.
    fused_wire  : the reduction takes the codec's stacked wire directly
                  (only `mean`); the others get it decoded to (C, N).
    defaults    : option values `resolve_opts` fills in.
    validate    : (resolved opts) -> None, raises ValueError.
    """
    name: str
    reduce: tp.Callable
    honors_beta: bool = False
    fused_wire: bool = False
    options: tuple = ()
    defaults: dict = dataclasses.field(default_factory=dict)
    validate: tp.Callable | None = None
    description: str = ""


_REGISTRY: dict[str, Aggregator] = {}


def register_aggregator(agg: Aggregator) -> Aggregator:
    """Register `agg` under `agg.name`; returns it for chaining."""
    if agg.name in _REGISTRY:
        raise ValueError(f"aggregator '{agg.name}' is already registered")
    if set(agg.defaults) - set(agg.options):
        raise ValueError(
            f"aggregator '{agg.name}' has defaults for undeclared options: "
            f"{sorted(set(agg.defaults) - set(agg.options))}")
    _REGISTRY[agg.name] = agg
    return agg


def get_aggregator(name: str) -> Aggregator:
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"unknown aggregator '{name}'; registered: "
                   f"{sorted(_REGISTRY)}")


def registered_aggregators() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_opts(agg: Aggregator, opts: dict | None) -> dict:
    """User options over the aggregator's defaults; unknown names raise
    TypeError and bad values ValueError (the `FLConfig.make` contract)."""
    opts = dict(opts or {})
    bad = sorted(set(opts) - set(agg.options))
    if bad:
        raise TypeError(
            f"option(s) {bad} are not used by aggregator '{agg.name}'; "
            f"valid options: {sorted(agg.options)}")
    resolved = {**agg.defaults, **opts}
    if agg.validate is not None:
        agg.validate(resolved)
    return resolved


def aggregate_stack(agg: Aggregator, opts: dict, grads, weights, beta,
                    codec, spec):
    """Stacked uploads (the dense tree with leaves (C, ...), or the codec's
    stacked wire when `codec` is given) -> (aggregate tree, ||agg||^2).

    `mean` takes the fused path (`methods._aggregate`); the others decode
    the wire once to the flat (C, N) stack."""
    if agg.fused_wire:
        return M._aggregate(grads, weights, beta, codec, spec)
    if codec is not None:
        flat = codec.decode(grads)
    else:
        flat, _ = ravel_stack(grads)
    vec, norm = agg.reduce(opts, flat.contiguous(), weights, beta)
    return unravel(vec, spec), norm


def _alive(weights):
    return (torch.as_tensor(weights) > 0).float()


# ---------------------------------------------------------------------------
# mean
# ---------------------------------------------------------------------------

def _mean_reduce(opts, g_flat, weights, beta):
    del opts
    return ncv_weighted_sum(
        g_flat, ncv_coefficients(weights, beta).to(g_flat.device))


register_aggregator(Aggregator(
    name="mean",
    reduce=_mean_reduce,
    honors_beta=True,
    fused_wire=True,
    description="the fused Eq. 10-12 weighted sum (fused wire path)",
))


# ---------------------------------------------------------------------------
# trimmed_mean / median: coordinate-wise order-statistic bands
# ---------------------------------------------------------------------------

def _trimmed_reduce(opts, g_flat, weights, beta):
    del beta                                   # honors_beta=False
    alive = _alive(weights)
    m_v = torch.sum(alive)
    k = torch.floor(opts["trim_frac"] * m_v)
    # never trim past the middle: tiny surviving cohorts degrade toward the
    # median instead of an empty band
    k = torch.minimum(torch.clamp(k, min=0.0),
                      torch.floor((m_v - 1.0) / 2.0))
    return rank_band_mean(g_flat, alive, k, m_v - 1.0 - k)


def _trimmed_validate(opts):
    if not 0.0 <= opts["trim_frac"] < 0.5:
        raise ValueError(f"trim_frac must be in [0, 0.5), got "
                         f"{opts['trim_frac']}")


register_aggregator(Aggregator(
    name="trimmed_mean",
    reduce=_trimmed_reduce,
    options=("trim_frac",),
    defaults=dict(trim_frac=0.2),
    validate=_trimmed_validate,
    description="coordinate-wise trimmed mean over the reporting clients "
                "(drops the floor(trim_frac*m) extremes per coordinate)",
))


def _median_reduce(opts, g_flat, weights, beta):
    del opts, beta
    alive = _alive(weights)
    m_v = torch.sum(alive)
    lo = torch.clamp(torch.floor((m_v - 1.0) / 2.0), min=0.0)
    return rank_band_mean(g_flat, alive, lo, m_v - 1.0 - lo)


register_aggregator(Aggregator(
    name="median",
    reduce=_median_reduce,
    description="coordinate-wise median over the reporting clients (the "
                "maximally trimmed band; breakdown point 1/2)",
))


# ---------------------------------------------------------------------------
# norm_clip: Eq. 10-12 with contributions clipped to a robust norm scale
# ---------------------------------------------------------------------------

def _norm_clip_factors(g_flat, weights, clip_mult):
    norms = torch.sqrt(torch.sum(g_flat.float() ** 2, dim=1))
    tau = clip_mult * masked_median_1d(norms, _alive(weights))
    return torch.minimum(torch.ones_like(norms),
                         tau / torch.clamp(norms, min=1e-12))


def _norm_clip_reduce(opts, g_flat, weights, beta):
    clip = _norm_clip_factors(g_flat, weights, opts["clip_mult"])
    w = ncv_coefficients(weights, beta).to(g_flat.device) * clip
    return ncv_weighted_sum(g_flat, w)


def _norm_clip_validate(opts):
    if opts["clip_mult"] <= 0:
        raise ValueError(f"clip_mult must be > 0, got {opts['clip_mult']}")


register_aggregator(Aggregator(
    name="norm_clip",
    reduce=_norm_clip_reduce,
    honors_beta=True,
    options=("clip_mult",),
    defaults=dict(clip_mult=2.0),
    validate=_norm_clip_validate,
    description="Eq. 10-12 weighted sum with each upload clipped to "
                "clip_mult x the median reporting norm (keeps the weighting "
                "and beta)",
))
