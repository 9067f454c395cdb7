"""Per-round client fault injection (`src/repro/fed/faults.py`, DESIGN.md §9).

A fault model makes a per-cohort-slot plan each round, after the cohort
draw:

    plan = fm.plan(opts, state, generator, idx, n_clients) -> dict(
        alive  = (cohort,) f32 in {0, 1}; 0: the client never reported,
        invp   = (cohort,) f32 alive_u / s_u, the Horvitz-Thompson factor of
                 a survival probability s_u (alive_u alone when the model
                 does not reweight; ones when nothing drops),
        gscale = (cohort,) f32 multiplicative upload corruption (1: honest),
        flip   = (cohort,) f32 in {0, 1}; 1: train on flipped labels)

    none        every client honest and always online; no plan, and the
                round is bitwise the round without fault machinery.
    dropout     Bernoulli mid-round failure, rates spread by client id
                (drop_skew), HT-reweighted by 1 / (1 - rate).
    markov      a per-client on/off chain across rounds, started at
                stationarity, reweighted by the stationary on-probability.
    straggler   exponential latencies against a round deadline, dropped
                when late, reweighted by the closed-form survival.
    byzantine   the first ceil(byz_frac M) client ids corrupt their
                uploads: `scale`, `signflip` or `labelflip`; never
                reweighted or excluded (the server cannot tell them).
    external    per-slot alive / invp tables a host program writes.

Three predicates of the options (`drops`, `corrupts`, `flips`) tell the
simulator once which machinery the model needs.  A model with state across
rounds (markov) declares `init_state` and `step`; the state lives under the
"faults" key of the run state.  Plans and steps run on the host, from an
explicit `torch.Generator`; each draws its noise through a `*_from` form
that takes the uniforms (or exponentials) as an argument, so a test can
hold the port to the reference on the reference's own draws.
"""
from __future__ import annotations

import dataclasses
import math
import typing as tp

import torch

from repro_torch.utils import prng
from repro_torch.utils.tree_math import tree_map

# Key under which the per-slot gscale / flip ride the cstate dict into the
# client pass; `wrap_client` pops it before the method sees the cstate.
FAULT_KEY = "fault_plan"

# Salt of the simulator's fault generator's seed, which keeps the fault
# draws off the cohort draws' stream (a zero-rate dropout run draws the
# cohorts of a run without faults).
FAULT_SALT = 0xFA17


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """A per-round client fault process as one object.

    plan        : (opts, state, generator, idx, n_clients) -> plan dict, or
                  None for the no-fault model (the simulator then skips all
                  fault machinery).
    init_state  : (opts, n_clients) -> dict of tensors, or None.
    step        : (opts, state, generator) -> state, once a round for all
                  clients, before `plan` reads it.
    drops / corrupts / flips : (opts) -> bool: the plan may zero `alive`,
                  set `gscale` other than 1, set `flip`.
    options, defaults, validate : as for samplers.
    """
    name: str
    plan: tp.Callable | None
    init_state: tp.Callable | None = None
    step: tp.Callable | None = None
    drops: tp.Callable = staticmethod(lambda opts: False)
    corrupts: tp.Callable = staticmethod(lambda opts: False)
    flips: tp.Callable = staticmethod(lambda opts: False)
    options: tuple = ()
    defaults: dict = dataclasses.field(default_factory=dict)
    validate: tp.Callable | None = None
    description: str = ""

    @property
    def stateful(self) -> bool:
        return self.init_state is not None


_REGISTRY: dict[str, FaultModel] = {}


def register_fault(fm: FaultModel, *, overwrite: bool = False) -> FaultModel:
    """Register `fm` under `fm.name`; returns it for chaining."""
    if not overwrite and fm.name in _REGISTRY:
        raise ValueError(f"fault model '{fm.name}' is already registered")
    if set(fm.defaults) - set(fm.options):
        raise ValueError(
            f"fault model '{fm.name}' has defaults for undeclared options: "
            f"{sorted(set(fm.defaults) - set(fm.options))}")
    if fm.step is not None and fm.init_state is None:
        raise ValueError(
            f"fault model '{fm.name}' declares step() but no init_state(): "
            f"a per-round state evolution needs state to evolve")
    _REGISTRY[fm.name] = fm
    return fm


def get_fault(name: str) -> FaultModel:
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"unknown fault model '{name}'; registered: "
                   f"{sorted(_REGISTRY)}")


def registered_faults() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_opts(fm: FaultModel, opts: dict | None) -> dict:
    """User options over the model's defaults; unknown names raise
    TypeError and bad values ValueError."""
    opts = dict(opts or {})
    bad = sorted(set(opts) - set(fm.options))
    if bad:
        raise TypeError(
            f"option(s) {bad} are not used by fault model '{fm.name}'; "
            f"valid options: {sorted(fm.options)}")
    resolved = {**fm.defaults, **opts}
    if fm.validate is not None:
        fm.validate(resolved)
    return resolved


# ---------------------------------------------------------------------------
# client-side injection
# ---------------------------------------------------------------------------

def _per_row(v, x):
    """(C,) -> shaped to broadcast over x (C, ...)."""
    return v.reshape((-1,) + (1,) * (x.dim() - 1))


def wrap_client(client_fn, n_classes: int | None):
    """Innermost client-pass wrapper: applies each slot's plan.

    Pops the plan (`FAULT_KEY`: gscale, flip, each (C,)) from the cstate,
    flips the slot's labels to n_classes - 1 - label where flip is set
    (`n_classes` given iff the model flips), and multiplies each upload by
    its gscale.  The sampler statistics and the codec then see the
    corrupted upload, as on a real fleet."""
    def fn(ctx, params, cstate, batches, key):
        cs = dict(cstate)
        plan = cs.pop(FAULT_KEY)
        if n_classes is not None:
            labels = batches["labels"]
            batches = dict(batches, labels=torch.where(
                _per_row(plan["flip"], labels) > 0, n_classes - 1 - labels,
                labels))
        out = client_fn(ctx, params, cs, batches, key)
        return out._replace(grad=tree_map(
            lambda g: g * _per_row(plan["gscale"], g).to(g.dtype), out.grad))
    return fn


def where_rows(alive, new, old):
    """Per-row select over trees with leaves (C, ...): `new` where
    alive > 0, else `old`."""
    return tree_map(lambda n, o: torch.where(_per_row(alive, n) > 0, n, o),
                    new, old)


def _ones_plan(c):
    return dict(alive=torch.ones(c), invp=torch.ones(c),
                gscale=torch.ones(c), flip=torch.zeros(c))


def _span(idx, m):
    """Client id spread linearly over [-1, 1]."""
    return 2.0 * idx.float() / max(m - 1, 1) - 1.0


# ---------------------------------------------------------------------------
# none
# ---------------------------------------------------------------------------

register_fault(FaultModel(
    name="none",
    plan=None,
    description="every client honest and always online (no fault machinery "
                "enters the round)",
))


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def dropout_rates(opts, idx, m):
    """drop_rate spread by client id over rate * (1 -+ drop_skew), clipped
    to [0, 0.95]: a skew makes dropout informative, where the HT factor
    matters."""
    rate = opts["drop_rate"] * (1.0 + opts["drop_skew"] * _span(idx, m))
    return torch.clamp(rate, 0.0, 0.95)


def dropout_plan_from(opts, idx, m, u):
    """The dropout plan given the slots' uniforms `u` (C,)."""
    rate = dropout_rates(opts, idx, m)
    alive = (u >= rate).float()
    invp = alive / (1.0 - rate) if opts["drop_reweight"] else alive
    return dict(_ones_plan(idx.shape[0]), alive=alive, invp=invp)


def _dropout_plan(opts, state, generator, idx, m):
    del state
    return dropout_plan_from(opts, idx, m,
                             torch.rand(idx.shape, generator=generator))


def _dropout_validate(opts):
    if not 0.0 <= opts["drop_rate"] < 1.0:
        raise ValueError(f"drop_rate must be in [0, 1), got "
                         f"{opts['drop_rate']}")
    if not 0.0 <= opts["drop_skew"] <= 1.0:
        raise ValueError(f"drop_skew must be in [0, 1], got "
                         f"{opts['drop_skew']}")


register_fault(FaultModel(
    name="dropout",
    plan=_dropout_plan,
    drops=staticmethod(lambda opts: True),
    options=("drop_rate", "drop_skew", "drop_reweight"),
    defaults=dict(drop_rate=0.3, drop_skew=0.0, drop_reweight=True),
    validate=_dropout_validate,
    description="Bernoulli mid-round failure with 1/(1-rate) HT "
                "reweighting (drop_reweight=False: biased negative "
                "control)",
))


# ---------------------------------------------------------------------------
# markov
# ---------------------------------------------------------------------------

def markov_pi(opts):
    """The chain's stationary on-probability, as an f32 tensor."""
    return torch.tensor(opts["mk_recover"] / (opts["mk_fail"]
                                              + opts["mk_recover"]))


def _markov_init(opts, m):
    # at stationarity, from the reference's fixed key 0x0A11 (bit for bit
    # its start), so P(on) = pi at every round and 1 / pi is exact
    u = torch.from_numpy(prng.uniform(prng.prng_key(0x0A11), (m,)))
    return dict(on=(u < markov_pi(opts)).float())


def markov_step_from(opts, state, u):
    """One transition of every client's chain given uniforms `u` (M,)."""
    on = state["on"]
    on = torch.where(on > 0, u >= opts["mk_fail"], u < opts["mk_recover"])
    return dict(state, on=on.float())


def _markov_step(opts, state, generator):
    return markov_step_from(opts, state, torch.rand(
        state["on"].shape, generator=generator))


def _markov_plan(opts, state, generator, idx, m):
    del generator, m
    alive = state["on"][idx]
    invp = alive / markov_pi(opts) if opts["mk_reweight"] else alive
    return dict(_ones_plan(idx.shape[0]), alive=alive, invp=invp)


def _markov_validate(opts):
    for nm in ("mk_fail", "mk_recover"):
        if not 0.0 < opts[nm] <= 1.0:
            raise ValueError(f"{nm} must be in (0, 1], got {opts[nm]}")


register_fault(FaultModel(
    name="markov",
    plan=_markov_plan,
    init_state=_markov_init,
    step=_markov_step,
    drops=staticmethod(lambda opts: True),
    options=("mk_fail", "mk_recover", "mk_reweight"),
    defaults=dict(mk_fail=0.1, mk_recover=0.3, mk_reweight=True),
    validate=_markov_validate,
    description="per-client on/off Markov availability trace (stationary "
                "start; reweighted by the stationary on-probability)",
))


# ---------------------------------------------------------------------------
# straggler
# ---------------------------------------------------------------------------

def straggler_plan_from(opts, idx, m, e):
    """The straggler plan given the slots' standard exponentials `e` (C,):
    latency mean_u e_u against the deadline; survival 1 - exp(-T / mean_u)
    in closed form, so the HT factor is exact per client."""
    mean = opts["str_mean"] * (1.0 + opts["str_skew"] * _span(idx, m))
    alive = (mean * e <= opts["str_deadline"]).float()
    s = 1.0 - torch.exp(-opts["str_deadline"] / mean)
    return dict(_ones_plan(idx.shape[0]), alive=alive, invp=alive / s)


def _straggler_plan(opts, state, generator, idx, m):
    del state
    u = torch.rand(idx.shape, generator=generator)
    return straggler_plan_from(opts, idx, m, -torch.log1p(-u))


def _straggler_validate(opts):
    if opts["str_mean"] <= 0 or opts["str_deadline"] <= 0:
        raise ValueError("str_mean and str_deadline must be > 0")
    if not 0.0 <= opts["str_skew"] < 1.0:
        raise ValueError(f"str_skew must be in [0, 1), got "
                         f"{opts['str_skew']}")


register_fault(FaultModel(
    name="straggler",
    plan=_straggler_plan,
    drops=staticmethod(lambda opts: True),
    options=("str_mean", "str_deadline", "str_skew"),
    defaults=dict(str_mean=1.0, str_deadline=2.0, str_skew=0.0),
    validate=_straggler_validate,
    description="exponential per-client latency vs. a simulated round "
                "deadline; late clients dropped with exact HT correction",
))


# ---------------------------------------------------------------------------
# byzantine
# ---------------------------------------------------------------------------

BYZ_ATTACKS = ("scale", "signflip", "labelflip")


def n_byzantine(opts, m: int) -> int:
    """The adversarial clients are the first ceil(byz_frac * m) ids, fixed
    for the whole run."""
    return min(m, math.ceil(opts["byz_frac"] * m))


def _byzantine_plan(opts, state, generator, idx, m):
    del state, generator
    byz = (idx < n_byzantine(opts, m)).float()
    attack = opts["byz_attack"]
    if attack == "scale":
        gscale = 1.0 + byz * (opts["byz_scale"] - 1.0)
    elif attack == "signflip":
        gscale = 1.0 - 2.0 * byz
    else:                                   # labelflip: honest-looking grads
        gscale = torch.ones_like(byz)
    flip = byz if attack == "labelflip" else torch.zeros_like(byz)
    return dict(_ones_plan(idx.shape[0]), gscale=gscale, flip=flip)


def _byzantine_validate(opts):
    if not 0.0 <= opts["byz_frac"] <= 1.0:
        raise ValueError(f"byz_frac must be in [0, 1], got "
                         f"{opts['byz_frac']}")
    if opts["byz_attack"] not in BYZ_ATTACKS:
        raise ValueError(f"byz_attack must be one of {BYZ_ATTACKS}, got "
                         f"{opts['byz_attack']!r}")
    if opts["byz_scale"] == 0.0:
        raise ValueError("byz_scale must be nonzero (0 is a dropout, not "
                         "an attack)")


register_fault(FaultModel(
    name="byzantine",
    plan=_byzantine_plan,
    corrupts=staticmethod(
        lambda opts: opts["byz_attack"] in ("scale", "signflip")),
    flips=staticmethod(lambda opts: opts["byz_attack"] == "labelflip"),
    options=("byz_frac", "byz_attack", "byz_scale"),
    defaults=dict(byz_frac=0.2, byz_attack="scale", byz_scale=10.0),
    validate=_byzantine_validate,
    description="fixed fraction of adversarial client ids: scaled / "
                "sign-flipped uploads or label-flipped training",
))


# ---------------------------------------------------------------------------
# external
# ---------------------------------------------------------------------------

def _external_plan(opts, state, generator, idx, m):
    """Per-slot alive / invp tables written host-side before the round."""
    del opts, generator, m
    if state["alive"].shape != idx.shape:
        raise ValueError(
            f"external fault state holds {state['alive'].shape[0]} slots "
            f"but the cohort has {idx.shape[0]}: set ext_slots=FLConfig."
            f"cohort")
    return dict(_ones_plan(idx.shape[0]), alive=state["alive"].float(),
                invp=state["invp"].float())


def _external_validate(opts):
    if int(opts["ext_slots"]) < 1:
        raise ValueError("ext_slots must be >= 1: set it to "
                         "FLConfig.cohort")


register_fault(FaultModel(
    name="external",
    plan=_external_plan,
    init_state=lambda opts, m: dict(alive=torch.ones(int(opts["ext_slots"])),
                                    invp=torch.ones(int(opts["ext_slots"]))),
    drops=staticmethod(lambda opts: True),
    options=("ext_slots",),
    defaults=dict(ext_slots=0),
    validate=_external_validate,
    description="per-slot exclusion + HT factors written host-side "
                "before the round",
))
