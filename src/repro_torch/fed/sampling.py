"""Cohort-selection strategies (`src/repro/fed/sampling.py`, DESIGN.md §8).

A sampler draws the round's cohort: (idx (cohort,) int64, invp) where
`invp` is the (cohort,) f32 inverse-probability factor 1 / (M q_u) that
the simulator multiplies into the Eq. 10-12 counts (the Horvitz-Thompson
correction), or None for samplers that do not reweight.

    uniform     without-replacement uniform choice, stateless.
    importance  P(u) proportional to an EMA of n_u ||g_u||, mixed with a
                uniform floor; Gumbel-top-k without replacement, with HT
                factors.
    similarity  greedy farthest-point cohort over EMA sketches of the
                clients' last uploads, with a staleness bonus and Gumbel
                exploration noise; no reweighting.
    external    idx and invp tables a host program writes before the
                round.

Draws run on the host, from an explicit `torch.Generator`; torch cannot
reproduce the reference's threefry draws, so the simulator also accepts
injected draws.  A stateful sampler's state (a dict of tensors) lives
under the "sampler" key of the run state; the draw gets a host copy of it,
the post-round `update` runs where the state lives.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

from repro_torch.utils import prng
from repro_torch.utils.tree_math import ravel_stack

# Reserved aux keys under which `with_stats` uploads a client's upload
# norm and its sketch; they count in `bytes_up` like any other aux leaf.
NORM_KEY = "smp_norm"
SKETCH_KEY = "smp_sketch"


@dataclasses.dataclass(frozen=True)
class CohortSampler:
    """A cohort-selection strategy as one object.

    draw        : (opts, state, generator, n_clients, cohort) -> (idx,
                  invp).  `state` is a host copy of the sampler's state
                  (None if stateless); `idx` is (cohort,) int64 without
                  replacement, `invp` (cohort,) f32 or None.
    init_state  : (opts, n_clients) -> dict of tensors, or None when the
                  sampler is stateless.
    update      : (opts, state, idx, sizes, aux) -> state, after the
                  round, from the cohort's uploaded statistics.
    needs_norms : clients also upload ||upload||_2 (aux[NORM_KEY]).
    sketch_dim  : opts -> d; d > 0: clients also upload a d-dimensional
                  sketch of the flat upload (aux[SKETCH_KEY]).
    options, defaults, validate : the option names `FLConfig.make`
                  accepts, their defaults, and a check of their values.
    """
    name: str
    draw: tp.Callable
    init_state: tp.Callable | None = None
    update: tp.Callable | None = None
    needs_norms: bool = False
    sketch_dim: tp.Callable = lambda opts: 0
    options: tuple = ()
    defaults: dict = dataclasses.field(default_factory=dict)
    validate: tp.Callable | None = None
    description: str = ""

    @property
    def stateful(self) -> bool:
        return self.init_state is not None


_REGISTRY: dict[str, CohortSampler] = {}


def register_sampler(sampler: CohortSampler, *,
                     overwrite: bool = False) -> CohortSampler:
    """Register `sampler` under `sampler.name`; returns it for chaining."""
    if not overwrite and sampler.name in _REGISTRY:
        raise ValueError(f"sampler '{sampler.name}' is already registered")
    if set(sampler.defaults) - set(sampler.options):
        raise ValueError(
            f"sampler '{sampler.name}' has defaults for undeclared options: "
            f"{sorted(set(sampler.defaults) - set(sampler.options))}")
    if sampler.update is not None and sampler.init_state is None:
        raise ValueError(
            f"sampler '{sampler.name}' declares update() but no "
            f"init_state(): a post-round update needs state to update")
    _REGISTRY[sampler.name] = sampler
    return sampler


def get_sampler(name: str) -> CohortSampler:
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"unknown cohort sampler '{name}'; registered: "
                   f"{sorted(_REGISTRY)}")


def registered_samplers() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_opts(sampler: CohortSampler, opts: dict | None) -> dict:
    """User options over the sampler's defaults; unknown names raise
    TypeError and bad values ValueError."""
    opts = dict(opts or {})
    bad = sorted(set(opts) - set(sampler.options))
    if bad:
        raise TypeError(
            f"option(s) {bad} are not used by sampler '{sampler.name}'; "
            f"valid options: {sorted(sampler.options)}")
    resolved = {**sampler.defaults, **opts}
    if sampler.validate is not None:
        sampler.validate(resolved)
    return resolved


# ---------------------------------------------------------------------------
# client-side statistics
# ---------------------------------------------------------------------------

def with_stats(client_fn, *, norm: bool = False, proj=None):
    """Wrap a ctx-signature client fn to also upload sampler statistics,
    computed on the raw f32 upload (before the codec): each client's
    ||upload||_2 (aux[NORM_KEY], (C,)) and its sketch proj @ upload
    (aux[SKETCH_KEY], (C, d)).  The upload itself is unchanged."""
    def fn(ctx, params, cstate, batches, key):
        out = client_fn(ctx, params, cstate, batches, key)
        vec, _ = ravel_stack(out.grad)
        aux = dict(out.aux)
        if norm:
            aux[NORM_KEY] = torch.sqrt(torch.sum(vec * vec, dim=1))
        if proj is not None:
            aux[SKETCH_KEY] = vec @ proj.T
        return out._replace(aux=aux)
    return fn


def sketch_projection(n: int, d: int, device=None):
    """The (d, N) Rademacher / sqrt(d) sketch matrix, from the reference's
    fixed key 0x5CE7C (never the run seed) and bit for bit its matrix, so
    sketch tables stay comparable across backends."""
    signs = prng.rademacher(prng.prng_key(0x5CE7C), (d, n))
    return torch.from_numpy(signs / np.sqrt(np.float32(d))).to(device)


def gumbel(generator, shape):
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator)
    return -torch.log(-torch.log(torch.clamp(
        u, min=torch.finfo(torch.float32).tiny)))


def gumbel_top_k(generator, log_q, k: int):
    """k items without replacement, item u with probability q_u first
    (Gumbel-top-k: the k largest of log q + Gumbel noise)."""
    return torch.topk(log_q + gumbel(generator, log_q.shape), k).indices


# ---------------------------------------------------------------------------
# uniform
# ---------------------------------------------------------------------------

def _uniform_draw(opts, state, generator, m, c):
    del opts, state
    return torch.randperm(m, generator=generator)[:c], None


register_sampler(CohortSampler(
    name="uniform",
    draw=_uniform_draw,
    description="without-replacement uniform choice",
))


# ---------------------------------------------------------------------------
# importance: P(u) ~ EMA n_u ||g_u|| with a uniform floor, HT-reweighted
# ---------------------------------------------------------------------------

def importance_q(opts, state, m):
    """The selection probabilities: the normalized score table mixed with
    a uniform floor imp_mix / M, renormalized."""
    e = state["score"]
    q = (1.0 - opts["imp_mix"]) * e / torch.clamp(torch.sum(e), min=1e-20) \
        + opts["imp_mix"] / m
    return q / torch.sum(q)


def _importance_draw(opts, state, generator, m, c):
    q = importance_q(opts, state, m)
    idx = gumbel_top_k(generator, torch.log(q), c)
    # 1 / (M q_u): exactly 1 on a fresh (uniform) table
    return idx, 1.0 / (m * q[idx])


def _importance_update(opts, state, idx, sizes, aux):
    rho = opts["imp_ema"]
    e = state["score"]
    # relative EMA: the cohort's contributions n_u ||g_u|| over their mean
    contrib = sizes * aux[NORM_KEY]
    rel = contrib / torch.clamp(torch.mean(contrib), min=1e-20)
    e = e.clone()
    e[idx] = (1.0 - rho) * e[idx] + rho * rel
    return dict(state, score=e)


def _importance_validate(opts):
    if not 0.0 < opts["imp_mix"] <= 1.0:
        raise ValueError(f"imp_mix must be in (0, 1], got {opts['imp_mix']}")
    if not 0.0 < opts["imp_ema"] <= 1.0:
        raise ValueError(f"imp_ema must be in (0, 1], got {opts['imp_ema']}")


register_sampler(CohortSampler(
    name="importance",
    draw=_importance_draw,
    # scores start at 1: round 1 selects uniformly, with invp exactly 1
    init_state=lambda opts, m: dict(score=torch.ones(m)),
    update=_importance_update,
    needs_norms=True,
    options=("imp_mix", "imp_ema"),
    defaults=dict(imp_mix=0.5, imp_ema=0.2),
    validate=_importance_validate,
    description="P(u) ~ EMA n_u||g_u|| with uniform floor; Gumbel-top-k + "
                "inverse-probability weights (unbiased)",
))


# ---------------------------------------------------------------------------
# similarity: greedy farthest-point cohort over EMA update sketches
# ---------------------------------------------------------------------------

def similarity_pick(opts, state, noise, c):
    """The farthest-point traversal given the Gumbel noise (M,): C greedy
    picks of argmax min-dist^2-to-selected (capped at 4, the unit sphere's
    largest) + sim_explore * age + sim_noise * noise."""
    sk = state["sketch"]
    nrm = torch.sqrt(torch.sum(sk * sk, dim=1, keepdim=True))
    unit = sk / torch.clamp(nrm, min=1e-12)
    base = opts["sim_explore"] * state["age"] + opts["sim_noise"] * noise
    m = sk.shape[0]
    mind2 = torch.full((m,), float("inf"))
    taken = torch.zeros(m, dtype=torch.bool)
    idx = torch.zeros(c, dtype=torch.int64)
    big = torch.tensor(4.0)
    for k in range(c):
        score = torch.where(taken, torch.tensor(-float("inf")),
                            torch.minimum(mind2, big) + base)
        u = torch.argmax(score)
        d2 = torch.sum((unit - unit[u][None, :]) ** 2, dim=1)
        idx[k] = u
        mind2 = torch.minimum(mind2, d2)
        taken[u] = True
    return idx


def _similarity_draw(opts, state, generator, m, c):
    return similarity_pick(opts, state, gumbel(generator, (m,)), c), None


def _similarity_update(opts, state, idx, sizes, aux):
    del sizes
    rho = opts["sim_ema"]
    sk, age = state["sketch"].clone(), state["age"] + 1.0
    sk[idx] = (1.0 - rho) * sk[idx] + rho * aux[SKETCH_KEY]
    age[idx] = 0.0
    return dict(state, sketch=sk, age=age)


def _similarity_validate(opts):
    if not (isinstance(opts["sim_dim"], int) and opts["sim_dim"] >= 1):
        raise ValueError(f"sim_dim must be an int >= 1, got "
                         f"{opts['sim_dim']!r}")
    if not 0.0 < opts["sim_ema"] <= 1.0:
        raise ValueError(f"sim_ema must be in (0, 1], got {opts['sim_ema']}")
    if opts["sim_noise"] < 0.0 or opts["sim_explore"] < 0.0:
        raise ValueError("sim_noise and sim_explore must be >= 0")
    if opts["sim_noise"] == 0.0 and opts["sim_explore"] == 0.0:
        # every score ties on the fresh table: clients 0..C-1 forever
        raise ValueError(
            "at least one of sim_noise / sim_explore must be > 0: a fully "
            "deterministic draw permanently starves the unselected clients")


register_sampler(CohortSampler(
    name="similarity",
    draw=_similarity_draw,
    init_state=lambda opts, m: dict(sketch=torch.zeros(m, opts["sim_dim"]),
                                    age=torch.zeros(m)),
    update=_similarity_update,
    sketch_dim=lambda opts: opts["sim_dim"],
    options=("sim_dim", "sim_ema", "sim_explore", "sim_noise"),
    defaults=dict(sim_dim=8, sim_ema=0.5, sim_explore=0.25, sim_noise=0.5),
    validate=_similarity_validate,
    description="greedy farthest-point cohort over EMA update sketches "
                "(+staleness bonus, Gumbel exploration)",
))


# ---------------------------------------------------------------------------
# external: a host program writes the cohort and its HT factors
# ---------------------------------------------------------------------------

def _external_draw(opts, state, generator, m, c):
    """The tables the host wrote: `idx` the admitted cohort (padding
    repeats a valid id), `invp` its 1 / (M q_u) (0 for padding)."""
    del opts, generator, m
    if state["idx"].shape[0] != c:
        raise ValueError(
            f"external sampler state holds {state['idx'].shape[0]} slots "
            f"but the round draws cohort={c}: set ext_cohort=FLConfig."
            f"cohort")
    return state["idx"].long(), state["invp"].float()


def _external_validate(opts):
    if int(opts["ext_cohort"]) < 1:
        raise ValueError("ext_cohort must be >= 1: set it to "
                         "FLConfig.cohort")


register_sampler(CohortSampler(
    name="external",
    draw=_external_draw,
    init_state=lambda opts, m: dict(
        idx=torch.zeros(int(opts["ext_cohort"]), dtype=torch.int32),
        invp=torch.ones(int(opts["ext_cohort"]))),
    options=("ext_cohort",),
    defaults=dict(ext_cohort=0),
    validate=_external_validate,
    description="cohort + HT inverse-probabilities written host-side "
                "before the round",
))
