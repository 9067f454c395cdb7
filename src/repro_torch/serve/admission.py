"""Admission control for the serve coordinator
(`src/repro/serve/admission.py`, DESIGN.md §12.2).

An `AdmissionPolicy` decides, once a round, how many of the queued
check-ins to admit into the cohort.  Policies register like every other
strategy (a frozen dataclass with `options` / `defaults` / `validate`
resolved by `resolve_opts`), so a mistyped option raises at construction.

The policy only picks a COUNT.  Which clients fill the slots (FIFO off the
queue), the deadline cut and the Horvitz-Thompson bookkeeping that keeps
Eq. 10-12 unbiased live in `serve.coordinator`.

`admit(opts, state, stats) -> (n_admit, state)` sees one stats dict:

    queue_depth     clients waiting after this round's check-ins
    cohort_max      FLConfig.cohort, the round's fixed cohort shape; a
                    smaller cohort is padded with dead slots
    last_round_s    wall-clock seconds of the previous round (0.0 first)
    target_round_s  the deadline the coordinator serves against

Policies:
  fixed         admit min(queue_depth, cohort_max).
  token_bucket  `tb_rate` tokens a round, burst capacity `tb_burst`; one
                admitted client spends one token.
  adaptive      AIMD against the round deadline: a round slower than
                `target_round_s` shrinks the next cohort by `ad_shrink`, a
                round inside it with queue pressure grows it by `ad_grow`.
                It reads the wall clock, so its served trajectories are not
                reproducible run to run (fixed and token_bucket are).
"""
from __future__ import annotations

import dataclasses
import typing as tp


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """One admission strategy: `init` builds the (json-serializable)
    policy state, `admit` spends it once per round."""
    name: str
    admit: tp.Callable            # (opts, state, stats) -> (n, state)
    init: tp.Callable = staticmethod(lambda opts: {})
    options: tuple = ()
    defaults: dict = dataclasses.field(default_factory=dict)
    validate: tp.Callable | None = None
    description: str = ""


_REGISTRY: dict[str, AdmissionPolicy] = {}


def register_policy(policy: AdmissionPolicy, *,
                    overwrite: bool = False) -> AdmissionPolicy:
    """Register `policy` under `policy.name`; returns it for chaining."""
    if not overwrite and policy.name in _REGISTRY:
        raise ValueError(
            f"admission policy '{policy.name}' is already registered")
    if set(policy.defaults) - set(policy.options):
        raise ValueError(
            f"admission policy '{policy.name}' has defaults for undeclared "
            f"options: {sorted(set(policy.defaults) - set(policy.options))}")
    _REGISTRY[policy.name] = policy
    return policy


def get_policy(name: str) -> AdmissionPolicy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown admission policy '{name}'; registered: "
                       f"{sorted(_REGISTRY)}") from None


def registered_policies() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_opts(policy: AdmissionPolicy, opts: dict | None) -> dict:
    """Merge user options over the policy's defaults, rejecting unknown
    names and bad values — the `FLConfig.make` option contract."""
    opts = dict(opts or {})
    bad = sorted(set(opts) - set(policy.options))
    if bad:
        raise TypeError(
            f"option(s) {bad} are not used by admission policy "
            f"'{policy.name}'; valid options: {sorted(policy.options)}")
    resolved = {**policy.defaults, **opts}
    if policy.validate is not None:
        policy.validate(resolved)
    return resolved


# ---------------------------------------------------------------------------
# fixed — admit as many as fit (no-control baseline)
# ---------------------------------------------------------------------------

def _fixed_admit(opts, state, stats):
    del opts
    return min(stats["queue_depth"], stats["cohort_max"]), state


register_policy(AdmissionPolicy(
    name="fixed",
    admit=_fixed_admit,
    description="admit min(queue_depth, cohort_max) every round "
                "(no-control baseline)",
))


# ---------------------------------------------------------------------------
# token_bucket — rate-limit admissions over check-ins
# ---------------------------------------------------------------------------

def _tb_init(opts):
    return dict(tokens=float(opts["tb_burst"]))


def _tb_admit(opts, state, stats):
    tokens = min(float(opts["tb_burst"]),
                 state["tokens"] + float(opts["tb_rate"]))
    n = min(stats["queue_depth"], stats["cohort_max"], int(tokens))
    return n, dict(state, tokens=tokens - n)


def _tb_validate(opts):
    if opts["tb_rate"] <= 0 or opts["tb_burst"] <= 0:
        raise ValueError("tb_rate and tb_burst must be > 0")


register_policy(AdmissionPolicy(
    name="token_bucket",
    admit=_tb_admit,
    init=_tb_init,
    options=("tb_rate", "tb_burst"),
    defaults=dict(tb_rate=2.0, tb_burst=8.0),
    validate=_tb_validate,
    description="token bucket over check-ins: tb_rate tokens/round, "
                "burst tb_burst, one token per admitted client",
))


# ---------------------------------------------------------------------------
# adaptive — AIMD cohort sizing against the round deadline
# ---------------------------------------------------------------------------

def _ad_init(opts):
    del opts
    return dict(cohort=0.0)       # 0 == "start at cohort_max"


def _ad_admit(opts, state, stats):
    cur = state["cohort"] if state["cohort"] > 0 \
        else float(stats["cohort_max"])
    if stats["last_round_s"] > stats["target_round_s"] > 0:
        cur *= float(opts["ad_shrink"])           # missed: back off
    elif stats["queue_depth"] > int(cur):
        cur += float(opts["ad_grow"])             # headroom + pressure
    cur = min(max(cur, float(opts["ad_min"])), float(stats["cohort_max"]))
    return min(stats["queue_depth"], int(cur)), dict(state, cohort=cur)


def _ad_validate(opts):
    if not 0.0 < opts["ad_shrink"] < 1.0:
        raise ValueError(f"ad_shrink must be in (0, 1), got "
                         f"{opts['ad_shrink']}")
    if opts["ad_grow"] <= 0:
        raise ValueError("ad_grow must be > 0")
    if opts["ad_min"] < 1:
        raise ValueError("ad_min must be >= 1")


register_policy(AdmissionPolicy(
    name="adaptive",
    admit=_ad_admit,
    init=_ad_init,
    options=("ad_shrink", "ad_grow", "ad_min"),
    defaults=dict(ad_shrink=0.7, ad_grow=1.0, ad_min=1),
    validate=_ad_validate,
    description="AIMD effective-cohort sizing against target_round_s "
                "(shrink multiplicatively on a miss, grow additively "
                "under queue pressure)",
))
