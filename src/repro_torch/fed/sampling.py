"""Cohort-selection strategies (ported so far: `uniform`).

A sampler draws the round's cohort: (idx (cohort,) int64, invp) where
`invp` is None for samplers that do not reweight the Eq. 10-12 counts.
Draws come from an explicit `torch.Generator`; torch cannot reproduce the
reference's threefry draws, so the simulator also accepts injected draws.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import torch


@dataclasses.dataclass(frozen=True)
class CohortSampler:
    name: str
    draw: tp.Callable            # (opts, generator, m, c) -> (idx, invp)
    options: tuple = ()
    description: str = ""


_REGISTRY: dict[str, CohortSampler] = {}
_NOT_PORTED = ("external", "importance", "similarity")


def register_sampler(s: CohortSampler) -> CohortSampler:
    if s.name in _REGISTRY:
        raise ValueError(f"sampler '{s.name}' is already registered")
    _REGISTRY[s.name] = s
    return s


def get_sampler(name: str) -> CohortSampler:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _NOT_PORTED:
        raise KeyError(f"cohort sampler '{name}' is not ported to "
                       f"repro_torch yet; ported: {sorted(_REGISTRY)}")
    raise KeyError(f"unknown cohort sampler '{name}'; registered: "
                   f"{sorted(_REGISTRY)}")


def registered_samplers() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_opts(sampler: CohortSampler, opts: dict | None) -> dict:
    """The sampler's options, rejecting names it does not read."""
    opts = dict(opts or {})
    bad = sorted(set(opts) - set(sampler.options))
    if bad:
        raise TypeError(
            f"option(s) {bad} are not used by sampler '{sampler.name}'; "
            f"valid options: {sorted(sampler.options)}")
    return opts


def _uniform_draw(opts, generator, m, c):
    del opts
    return torch.randperm(m, generator=generator)[:c], None


register_sampler(CohortSampler(
    name="uniform",
    draw=_uniform_draw,
    description="without-replacement uniform choice",
))
