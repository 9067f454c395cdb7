"""Server-side aggregation strategies (ported so far: `mean`).

`mean` is the fused Eq. 10-12 weighted sum with the method's beta: the
(cohort, N) stack goes through `ncv_coefficients` and the
`ncv_weighted_sum` kernel in one read (`methods._aggregate`).
"""
from __future__ import annotations

import dataclasses
import typing as tp

from repro_torch.fed import methods as M


@dataclasses.dataclass(frozen=True)
class Aggregator:
    name: str
    reduce: tp.Callable          # (opts, grads, weights, beta) -> (tree, nrm)
    honors_beta: bool = False
    options: tuple = ()
    description: str = ""


_REGISTRY: dict[str, Aggregator] = {}
_NOT_PORTED = ("median", "norm_clip", "trimmed_mean")


def register_aggregator(agg: Aggregator) -> Aggregator:
    if agg.name in _REGISTRY:
        raise ValueError(f"aggregator '{agg.name}' is already registered")
    _REGISTRY[agg.name] = agg
    return agg


def get_aggregator(name: str) -> Aggregator:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _NOT_PORTED:
        raise KeyError(f"aggregator '{name}' is not ported to repro_torch "
                       f"yet; ported: {sorted(_REGISTRY)}")
    raise KeyError(f"unknown aggregator '{name}'; registered: "
                   f"{sorted(_REGISTRY)}")


def registered_aggregators() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_opts(agg: Aggregator, opts: dict | None) -> dict:
    opts = dict(opts or {})
    bad = sorted(set(opts) - set(agg.options))
    if bad:
        raise TypeError(
            f"option(s) {bad} are not used by aggregator '{agg.name}'; "
            f"valid options: {sorted(agg.options)}")
    return opts


def aggregate_stack(agg: Aggregator, opts: dict, grads, weights, beta):
    """Stacked uploads (leaves (cohort, ...)) -> (aggregate tree, ||agg||^2)."""
    return agg.reduce(opts, grads, weights, beta)


register_aggregator(Aggregator(
    name="mean",
    reduce=lambda opts, grads, weights, beta: M._aggregate(grads, weights,
                                                           beta),
    honors_beta=True,
    description="the fused Eq. 10-12 weighted sum",
))
