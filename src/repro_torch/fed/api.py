"""The typed FedMethod strategy interface and the validated `FLConfig`.

A federated method is one object (`FedMethod`): its client update, its
server update and a declarative `state_spec()` of the per-client and
global state it carries.  Methods register under a name and
`FLConfig.make(method=..., **opts)` is the validated construction path,
with the reference's error types (`src/repro/fed/api.py`): an unknown
name raises KeyError, an option no chosen strategy reads raises
TypeError, a bad value raises ValueError.

Ported so far: the methods `fedavg` and `fedncv`, the `uniform` sampler,
the `mean` aggregator, the `identity` codec, fault model `none`, tracker
`none` and store `device`.  A name the reference has but the port does not
yet raises KeyError saying so; it is never ignored.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import torch

from repro_torch.core import control_variates as cv
from repro_torch.fed import aggregators
from repro_torch.fed import methods as M
from repro_torch.fed import sampling
from repro_torch.utils.tree_math import tree_map


class MethodCtx(tp.NamedTuple):
    """Static context a client pass runs under."""
    task: M.Task
    mc: M.MethodConfig


class RoundCtx(tp.NamedTuple):
    """Everything a server update may consume: static config, the 1-based
    round number `r`, the cohort indices `idx`, per-client sample counts
    `sizes` and the stacked scalar diagnostics `aux` every client
    uploaded."""
    task: M.Task
    mc: M.MethodConfig
    fl: "FLConfig"
    r: int
    idx: tp.Any
    sizes: tp.Any
    aux: tp.Any


@dataclasses.dataclass(frozen=True)
class StateField:
    """One declared piece of method state.

    name       : key in the state dict (and `Simulator` attribute).
    per_client : True -> stored stacked (n_clients, ...), gathered at the
                 cohort indices each round; False -> one global instance.
    init       : (params, task, mc) -> one instance.
    cstate_key : key under which clients see it; None keeps it server-only.
    scatter    : per_client only: write the client-returned rows back at
                 the cohort indices after the round.
    """
    name: str
    per_client: bool
    init: tp.Callable
    cstate_key: str | None = None
    scatter: bool = False


def sgd_server(ctx: RoundCtx, params, agg, state):
    """Default server update: theta <- theta - lr * aggregate."""
    tree, norm = agg
    lr = ctx.fl.server_lr
    params = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, tree)
    return params, state, dict(agg_norm=norm)


@dataclasses.dataclass(frozen=True)
class FedMethod:
    """A federated optimization method as one strategy object."""
    name: str
    client_update: tp.Callable      # (ctx, params, cstate, batches, key)
    server_update: tp.Callable = sgd_server   # (ctx, params, agg, state)
    state_fields: tp.Any = ()       # tuple[StateField] | (task, mc) -> tuple
    beta: tp.Callable = staticmethod(lambda mc: 0.0)
    options: tuple = ()             # MethodConfig fields this method reads
    validate: tp.Callable | None = None             # (mc) -> None, raises
    description: str = ""

    def state_spec(self, task: M.Task, mc: M.MethodConfig
                   ) -> tuple[StateField, ...]:
        fields = self.state_fields
        return tuple(fields(task, mc)) if callable(fields) else tuple(fields)


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, FedMethod] = {}

# names the reference registers that the port does not have yet
_NOT_PORTED = {
    "method": ("fedglomo", "fedncv+", "fedper", "fedprox", "fedrep",
               "pfedsim", "scaffold"),
    "codec": ("bf16", "int4", "int8", "lowrank", "topk"),
    "fault": ("byzantine", "dropout", "external", "markov", "straggler"),
    "tracker": ("composite", "csv", "jsonl", "memory", "stdout"),
    "store": ("host",),
}
# the ported option-less strategies of the other registries
_PORTED = {"codec": ("identity",), "fault": ("none",), "tracker": ("none",),
           "store": ("device",)}


def not_ported(kind: str, name: str, have) -> KeyError:
    return KeyError(f"{kind} '{name}' is not ported to repro_torch yet; "
                    f"ported: {sorted(have)}")


def register_method(method: FedMethod, *, overwrite: bool = False) -> FedMethod:
    """Register `method` under `method.name`; returns it for chaining."""
    if not overwrite and method.name in _REGISTRY:
        raise ValueError(f"method '{method.name}' is already registered")
    _REGISTRY[method.name] = method
    return method


def get_method(name: str) -> FedMethod:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _NOT_PORTED["method"]:
        raise not_ported("federated method", name, _REGISTRY)
    raise KeyError(f"unknown federated method '{name}'; registered: "
                   f"{sorted(_REGISTRY)}")


def registered_methods() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _check_name(kind: str, name: str):
    if name in _PORTED[kind]:
        return
    if name in _NOT_PORTED[kind]:
        raise not_ported(kind, name, _PORTED[kind])
    raise KeyError(f"unknown {kind} '{name}'; have {sorted(_PORTED[kind])}")


# ---------------------------------------------------------------------------
# spec-driven generic state plumbing
# ---------------------------------------------------------------------------

def init_state(fields: tuple[StateField, ...], params, task, mc,
               n_clients: int) -> dict:
    """Per-client fields stacked to (n_clients, ...), global fields as-is."""
    state = {}
    for f in fields:
        one = f.init(params, task, mc)
        if f.per_client:
            state[f.name] = tree_map(
                lambda x: x.expand((n_clients,) + tuple(x.shape)).clone(),
                one)
        else:
            state[f.name] = one
    return state


def gather_cohort_states(fields: tuple[StateField, ...], state, idx):
    """Cohort-sliced client states: per-client fields indexed at `idx`,
    global fields broadcast to every slot."""
    cs = {}
    c = idx.shape[0]
    for f in fields:
        if f.cstate_key is None:
            continue
        if f.per_client:
            cs[f.cstate_key] = tree_map(lambda x: x[idx], state[f.name])
        else:
            cs[f.cstate_key] = tree_map(
                lambda x: x.expand((c,) + tuple(x.shape)), state[f.name])
    return cs


def scatter_cohort_states(fields: tuple[StateField, ...], state, idx,
                          cstates_new) -> dict:
    """Write client-returned rows back at the cohort indices (fields with
    scatter=True)."""
    new = dict(state)
    for f in fields:
        if f.per_client and f.scatter and f.cstate_key is not None:
            def put(a, rows):
                a = a.clone()
                a[idx] = rows
                return a
            new[f.name] = tree_map(put, state[f.name],
                                   cstates_new[f.cstate_key])
    return new


# ---------------------------------------------------------------------------
# FLConfig (typed, validated construction)
# ---------------------------------------------------------------------------

# MethodConfig fields every method's local-training loop reads
COMMON_OPTIONS = frozenset({"local_lr", "local_epochs"})


@dataclasses.dataclass
class FLConfig:
    method: str = "fedncv"
    n_clients: int = 100
    cohort: int = 10                  # sampled clients per round
    k_micro: int = 8                  # K microbatches (RLOO units)
    micro_batch: int = 16
    server_lr: float = 1.0
    codec: str = "identity"
    codec_opts: dict = dataclasses.field(default_factory=dict)
    staleness: int = 0                # 0 = synchronous rounds
    sampler: str = "uniform"
    sampler_opts: dict = dataclasses.field(default_factory=dict)
    aggregator: str = "mean"
    agg_opts: dict = dataclasses.field(default_factory=dict)
    fault: str = "none"
    fault_opts: dict = dataclasses.field(default_factory=dict)
    tracker: str = "none"
    tracker_opts: dict = dataclasses.field(default_factory=dict)
    store: str = "device"
    store_opts: dict = dataclasses.field(default_factory=dict)
    track_variance: bool = False
    mc: M.MethodConfig = dataclasses.field(
        default_factory=lambda: M.MethodConfig(name="fedncv"))

    def __post_init__(self):
        method = get_method(self.method)       # raises on unknown names
        if self.mc.name != self.method:
            raise ValueError(
                f"FLConfig.method={self.method!r} does not match "
                f"mc.name={self.mc.name!r} — the method config would be "
                f"silently ignored; construct via FLConfig.make(method=...)")
        if not isinstance(self.staleness, int) or self.staleness < 0:
            raise ValueError(f"staleness must be an int >= 0 (pipeline "
                             f"depth K), got {self.staleness!r}")
        if self.staleness:
            raise NotImplementedError("pipelined rounds (staleness >= 1) "
                                      "are not ported to repro_torch yet")
        if self.track_variance:
            raise NotImplementedError("track_variance is not ported to "
                                      "repro_torch yet")
        if not 1 <= self.cohort <= self.n_clients:
            raise ValueError(f"cohort={self.cohort} must be in "
                             f"[1, n_clients={self.n_clients}]")
        if method.beta(self.mc) != 0.0 and self.cohort < 2:
            raise ValueError(f"'{self.method}' uses the server-side control "
                             f"variate (beta != 0): cohort must be >= 2")
        if method.validate is not None:
            method.validate(self.mc)
        for kind, name, opts in (("codec", self.codec, self.codec_opts),
                                 ("fault", self.fault, self.fault_opts),
                                 ("tracker", self.tracker, self.tracker_opts),
                                 ("store", self.store, self.store_opts)):
            _check_name(kind, name)
            if opts:
                raise TypeError(f"{kind} option(s) {sorted(opts)} are not "
                                f"used by {kind} '{name}'; it has none")
        sampling.resolve_opts(sampling.get_sampler(self.sampler),
                              self.sampler_opts)
        agg = aggregators.get_aggregator(self.aggregator)
        aggregators.resolve_opts(agg, self.agg_opts)
        if method.beta(self.mc) != 0.0 and not agg.honors_beta:
            raise ValueError(
                f"aggregator '{self.aggregator}' ignores the server-side "
                f"control-variate coefficient, but method '{self.method}' "
                f"has beta = {method.beta(self.mc)} — set ncv_beta=0")

    @classmethod
    def make(cls, method: str = "fedncv", *, n_clients: int = 100,
             cohort: int = 10, k_micro: int = 8, micro_batch: int = 16,
             server_lr: float = 1.0, codec: str = "identity",
             codec_opts: dict | None = None, staleness: int = 0,
             sampler: str = "uniform", sampler_opts: dict | None = None,
             aggregator: str = "mean", agg_opts: dict | None = None,
             fault: str = "none", fault_opts: dict | None = None,
             tracker: str = "none", tracker_opts: dict | None = None,
             store: str = "device", store_opts: dict | None = None,
             track_variance: bool = False,
             **opts) -> "FLConfig":
        """Validated construction: every name must be registered (or raise
        that it is not ported yet), and every extra keyword must be an
        option one of the chosen strategies reads — COMMON_OPTIONS plus the
        method's declared options, or the sampler's / aggregator's."""
        m = get_method(method)
        for kind, name in (("codec", codec), ("fault", fault),
                           ("tracker", tracker), ("store", store)):
            _check_name(kind, name)
        subsystems = (
            ("method", method, COMMON_OPTIONS | set(m.options), None),
            ("sampler", sampler,
             set(sampling.get_sampler(sampler).options), "sampler_opts"),
            ("aggregator", aggregator,
             set(aggregators.get_aggregator(aggregator).options),
             "agg_opts"),
        )
        for name in sorted(opts):
            claims = [s for s in subsystems if name in s[2]]
            if len(claims) > 1:
                (k1, n1, _, _), (k2, n2, _, d2) = claims[:2]
                raise TypeError(
                    f"option name(s) ['{name}'] are claimed by both {k1} "
                    f"'{n1}' and {k2} '{n2}' — pass them via {d2}= to "
                    f"disambiguate")
        all_allowed = set().union(*(s[2] for s in subsystems))
        bad = sorted(set(opts) - all_allowed)
        if bad:
            raise TypeError(
                f"option(s) {bad} are not used by "
                + " or ".join(f"{k} '{n}'" for k, n, _, _ in subsystems)
                + f"; valid options: {sorted(all_allowed)}")

        def routed(allowed, explicit, kind, dict_name):
            ex = dict(explicit or {})
            kw = {k: v for k, v in opts.items() if k in allowed}
            doubled = sorted(set(ex) & set(kw))
            if doubled:
                raise TypeError(
                    f"{kind} option(s) {doubled} passed both as keyword(s) "
                    f"and in {dict_name}= — remove one")
            return {**ex, **kw}

        s_opts = routed(subsystems[1][2], sampler_opts, "sampler",
                        "sampler_opts")
        a_opts = routed(subsystems[2][2], agg_opts, "aggregator", "agg_opts")
        method_opts = {k: v for k, v in opts.items() if k in subsystems[0][2]}
        return cls(method=method, n_clients=n_clients, cohort=cohort,
                   k_micro=k_micro, micro_batch=micro_batch,
                   server_lr=server_lr, codec=codec,
                   codec_opts=dict(codec_opts or {}), staleness=staleness,
                   sampler=sampler, sampler_opts=s_opts,
                   aggregator=aggregator, agg_opts=a_opts,
                   fault=fault, fault_opts=dict(fault_opts or {}),
                   tracker=tracker, tracker_opts=dict(tracker_opts or {}),
                   store=store, store_opts=dict(store_opts or {}),
                   track_variance=track_variance,
                   mc=M.MethodConfig(name=method, **method_opts))


# ---------------------------------------------------------------------------
# the ported methods
# ---------------------------------------------------------------------------

def _client(fn):
    """Adapt a raw methods.py client fn to the ctx signature."""
    def client_update(ctx, params, cstate, batches, key):
        return fn(ctx.mc, ctx.task, params, cstate, batches, key)
    return client_update


register_method(FedMethod(
    name="fedavg",
    client_update=_client(M.fedavg_client),
    description="weighted mean of local SGD deltas (paper Eq. 2 baseline)",
))


def _fedncv_server(ctx: RoundCtx, params, agg, state):
    params, state, diag = sgd_server(ctx, params, agg, state)
    mc, aux = ctx.mc, ctx.aux
    stats = cv.ClientCVStats(None, aux["k"], aux["mean_norm_sq"],
                             aux["sum_norm_sq"])
    if mc.ncv_alpha_mode == "optimal":
        alpha_new = cv.optimal_alpha_single(stats)
    else:
        alpha_new = cv.alpha_descent_update(aux["alpha"], stats,
                                            mc.ncv_alpha_lr)
    alphas = state["alphas"].clone()
    alphas[ctx.idx] = alpha_new
    return params, dict(state, alphas=alphas), diag


def _fedncv_validate(mc: M.MethodConfig):
    if mc.ncv_alpha_mode not in ("descent", "optimal"):
        raise ValueError(f"ncv_alpha_mode must be 'descent' or 'optimal', "
                         f"got {mc.ncv_alpha_mode!r}")
    if not 0.0 <= mc.ncv_alpha0 <= 1.0:
        raise ValueError(f"ncv_alpha0 must be in [0, 1], got {mc.ncv_alpha0}")


register_method(FedMethod(
    name="fedncv",
    client_update=_client(M.fedncv_client),
    server_update=_fedncv_server,
    state_fields=(
        # scatter=False: the server computes the adapted alphas itself
        # (Algorithm 1 line 12) and scatters inside server_update
        StateField("alphas", per_client=True, cstate_key="alpha",
                   init=lambda p, t, mc: torch.tensor(
                       mc.ncv_alpha0, dtype=torch.float32,
                       device=next(iter(p.values())).device)),
    ),
    beta=staticmethod(lambda mc: mc.ncv_beta),
    options=("ncv_alpha0", "ncv_alpha_lr", "ncv_beta", "ncv_alpha_mode"),
    validate=_fedncv_validate,
    description="the paper: dual RLOO control variates (Algorithm 1)",
))
