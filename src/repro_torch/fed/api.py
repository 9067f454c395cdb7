"""The typed FedMethod strategy interface and the validated `FLConfig`.

A federated method is one object (`FedMethod`): its client update, its
server update and a declarative `state_spec()` of the per-client and
global state it carries.  Methods register under a name and
`FLConfig.make(method=..., **opts)` is the validated construction path,
with the reference's error types (`src/repro/fed/api.py`): an unknown
name raises KeyError, an option no chosen strategy reads raises
TypeError, a bad value raises ValueError.

Ported so far: all nine methods the reference registers (`fedavg`,
`fedncv`, `fedncv+`, `fedprox`, `scaffold`, `fedper`, `fedrep`, `pfedsim`,
`fedglomo`), all four samplers (`uniform`, `importance`, `similarity`,
`external`), the aggregators `mean`, `trimmed_mean`, `median` and
`norm_clip`, every codec (`identity`, `bf16`, `int8`, `int4`, `topk`,
`lowrank`), all six fault models (`none`, `dropout`, `markov`,
`straggler`, `byzantine`, `external`), both stores (`device`, `host`;
`fed/store.py`) and all six trackers (`repro_torch.track`).
"""
from __future__ import annotations

import dataclasses
import typing as tp

import torch

from repro_torch import comm
from repro_torch import track
from repro_torch.core import control_variates as cv
from repro_torch.fed import aggregators
from repro_torch.fed import faults
from repro_torch.fed import methods as M
from repro_torch.fed import sampling
from repro_torch.fed import store as store_lib
from repro_torch.utils.tree_math import (ravel_stack, tree_axpy, tree_leaves,
                                         tree_map, tree_zeros_like)


class MethodCtx(tp.NamedTuple):
    """Static context a client pass runs under."""
    task: M.Task
    mc: M.MethodConfig


class RoundCtx(tp.NamedTuple):
    """Everything a server update may consume: static config, the 1-based
    round number `r`, the cohort indices `idx`, per-client sample counts
    `sizes` and the stacked diagnostics `aux` every client uploaded.

    `grads` is None unless the method sets `needs_dense_grads`; it is then
    the dense stacked upload tree (decoded from the wire once).  `weights`
    are the Eq. 10-12 effective counts the aggregation ran with: `sizes`
    times the sampler's and the fault plan's HT factors.  `invp` is the
    product of those factors (None when neither reweights), and `alive`
    the fault model's (cohort,) 0/1 survival mask (None unless the model
    drops clients)."""
    task: M.Task
    mc: M.MethodConfig
    fl: "FLConfig"
    r: int
    idx: tp.Any
    sizes: tp.Any
    aux: tp.Any
    grads: tp.Any = None
    weights: tp.Any = None
    invp: tp.Any = None
    alive: tp.Any = None


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
    federated_slice : optional (params, task, mc) -> 0/1 mask tree (the
                 params' structure) marking the leaves the federated
                 averaging covers; the simulator masks every upload before
                 the codec and the aggregate after a lossy one.  Fields
                 compose by product (`federated_mask`).
    """
    name: str
    per_client: bool
    init: tp.Callable
    cstate_key: str | None = None
    scatter: bool = False
    federated_slice: tp.Callable | None = None


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
    personal: bool = False          # evaluation overlays per-client heads
    needs_dense_grads: bool = False  # server consumes per-client uploads
    cohort_state_update: tp.Callable | None = None  # (ctx, cstates) -> cstates
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


def register_method(method: FedMethod, *, overwrite: bool = False) -> FedMethod:
    """Register `method` under `method.name`; returns it for chaining."""
    if not overwrite and method.name in _REGISTRY:
        raise ValueError(f"method '{method.name}' is already registered")
    _REGISTRY[method.name] = method
    return method


def get_method(name: str) -> FedMethod:
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"unknown federated method '{name}'; registered: "
                   f"{sorted(_REGISTRY)}")


def registered_methods() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def registered_trackers() -> tuple[str, ...]:
    return track.registered_trackers()


def registered_stores() -> tuple[str, ...]:
    return store_lib.registered_stores()


# ---------------------------------------------------------------------------
# spec-driven generic state plumbing
# ---------------------------------------------------------------------------

def codec_fields(codec) -> tuple[StateField, ...]:
    """A stateful codec's per-client state (topk's and lowrank's error
    feedback) as the per-client field "ef", which clients read and write
    under the same key; () for a stateless codec."""
    if codec is None or not codec.stateful:
        return ()

    def init(params, task, mc):
        device = tree_leaves(params)[0].device
        return tree_map(lambda x: x.to(device), codec.init_state())
    return (StateField("ef", per_client=True, init=init, cstate_key="ef",
                       scatter=True),)


def init_state(fields: tuple[StateField, ...], params, task, mc,
               n_clients: int, codec=None) -> dict:
    """Per-client fields stacked to (n_clients, ...), global fields as-is,
    plus a stateful codec's error feedback under "ef"."""
    state = {}
    for f in fields + codec_fields(codec):
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
                          cstates_new, alive=None) -> dict:
    """Write client-returned rows back at the cohort indices (fields with
    scatter=True).

    `alive` ((cohort,) 0/1, or None): a dropped client never reported, so
    its row keeps the previous state."""
    new = dict(state)
    for f in fields:
        if f.per_client and f.scatter and f.cstate_key is not None:
            rows = cstates_new[f.cstate_key]
            if alive is not None:
                rows = faults.where_rows(
                    alive, rows, tree_map(lambda a: a[idx], state[f.name]))

            def put(a, r):
                a = a.clone()
                a[idx] = r
                return a
            new[f.name] = tree_map(put, state[f.name], rows)
    return new


def federated_mask(fields: tuple[StateField, ...], params, task, mc):
    """The product of every declaring field's `federated_slice` mask (a
    0/1 f32 tree matching `params`), or None when no field declares one."""
    mask = None
    for f in fields:
        if f.federated_slice is None:
            continue
        m = tree_map(lambda x: torch.as_tensor(x, dtype=torch.float32),
                     f.federated_slice(params, task, mc))
        mask = m if mask is None else tree_map(torch.mul, mask, m)
    return mask


def with_federated_slice(client_fn, mask):
    """Mask the upload (leaves (C, ...)) before the codec sees it, so the
    masked-out leaves upload exact zeros; `apply_federated_mask` is the
    server-side half."""
    def fn(ctx, params, cstate, batches, key):
        out = client_fn(ctx, params, cstate, batches, key)
        return out._replace(grad=tree_map(lambda g, m: g * m.to(g.dtype),
                                          out.grad, mask))
    return fn


def apply_federated_mask(agg_tree, mask):
    """Hard-mask the decoded aggregate after a lossy codec and recompute its
    norm: the masked parameters get exactly zero update.  Returns (masked
    tree, ||masked||^2)."""
    tree = tree_map(lambda g, m: g * m.to(g.dtype), agg_tree, mask)
    nrm = sum(torch.sum(x.float() ** 2) for x in tree_leaves(tree))
    return tree, nrm


def with_codec(client_fn, codec):
    """Compose a ctx-signature client fn with wire encoding.

    The upload leaves the client compressed: the wrapped fn ravels
    `ClientOut.grad` (leaves (C, ...)) into the flat (C, N) stack and
    replaces it with the codec's stacked wire dict.  Its `key` argument
    carries the encoder's randomness: the stochastic-rounding uniforms
    (C, n_chunks, chunk) for int8 / int4, None for the others; the inner
    client fn gets None (the ported clients draw nothing).  A stateful
    codec (topk's and lowrank's error feedback) reads the cohort's state
    under the ``"ef"`` key of `cstate` and writes the new state back
    there, so it rides the gather and scatter of every per-client
    state."""
    def fn(ctx, params, cstate, batches, key):
        out = client_fn(ctx, params, cstate, batches, None)
        with track.scope(track.ENCODE):
            vec, _ = ravel_stack(out.grad)
            state = cstate.get("ef") if codec.stateful else None
            wire, new_state = codec.encode(vec, state, key)
        new_cstate = out.cstate
        if codec.stateful:
            new_cstate = dict(new_cstate, ef=new_state)
        return out._replace(grad=wire, cstate=new_cstate)
    return fn


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
    staleness: int = 0                # 0 = sync; K >= 1: depth-K ring
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
        if not 1 <= self.cohort <= self.n_clients:
            raise ValueError(f"cohort={self.cohort} must be in "
                             f"[1, n_clients={self.n_clients}]")
        if method.beta(self.mc) != 0.0 and self.cohort < 2:
            raise ValueError(f"'{self.method}' uses the server-side control "
                             f"variate (beta != 0): cohort must be >= 2")
        if method.validate is not None:
            method.validate(self.mc)
        comm.validate_codec_opts(self.codec, self.codec_opts)
        track.resolve_opts(track.get_tracker(self.tracker),
                           self.tracker_opts)
        store_lib.resolve_opts(store_lib.get_store(self.store),
                               self.store_opts)
        sampling.resolve_opts(sampling.get_sampler(self.sampler),
                              self.sampler_opts)
        agg = aggregators.get_aggregator(self.aggregator)
        aggregators.resolve_opts(agg, self.agg_opts)
        faults.resolve_opts(faults.get_fault(self.fault), self.fault_opts)
        if method.needs_dense_grads and self.aggregator != "mean":
            raise ValueError(
                f"method '{self.method}' consumes the dense per-client "
                f"uploads itself (needs_dense_grads) — the "
                f"'{self.aggregator}' aggregator would be silently ignored")
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
        """Validated construction: every name must be registered, and every
        extra keyword must be an option one of the chosen strategies reads
        — COMMON_OPTIONS plus the method's declared options, or the
        codec's, sampler's, aggregator's, fault model's, tracker's or
        store's."""
        m = get_method(method)
        comm.check_codec_name(codec)
        subsystems = (
            ("method", method, COMMON_OPTIONS | set(m.options), None),
            ("codec", codec, set(comm.CODECS[codec].options), "codec_opts"),
            ("sampler", sampler,
             set(sampling.get_sampler(sampler).options), "sampler_opts"),
            ("aggregator", aggregator,
             set(aggregators.get_aggregator(aggregator).options),
             "agg_opts"),
            ("fault", fault, set(faults.get_fault(fault).options),
             "fault_opts"),
            ("tracker", tracker,
             set(track.get_tracker(tracker).options), "tracker_opts"),
            ("store", store,
             set(store_lib.get_store(store).options), "store_opts"),
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

        c_opts = routed(subsystems[1][2], codec_opts, "codec", "codec_opts")
        s_opts = routed(subsystems[2][2], sampler_opts, "sampler",
                        "sampler_opts")
        a_opts = routed(subsystems[3][2], agg_opts, "aggregator", "agg_opts")
        f_opts = routed(subsystems[4][2], fault_opts, "fault", "fault_opts")
        t_opts = routed(subsystems[5][2], tracker_opts, "tracker",
                        "tracker_opts")
        st_opts = routed(subsystems[6][2], store_opts, "store", "store_opts")
        method_opts = {k: v for k, v in opts.items() if k in subsystems[0][2]}
        return cls(method=method, n_clients=n_clients, cohort=cohort,
                   k_micro=k_micro, micro_batch=micro_batch,
                   server_lr=server_lr, codec=codec,
                   codec_opts=c_opts, staleness=staleness,
                   sampler=sampler, sampler_opts=s_opts,
                   aggregator=aggregator, agg_opts=a_opts,
                   fault=fault, fault_opts=f_opts,
                   tracker=tracker, tracker_opts=t_opts,
                   store=store, store_opts=st_opts,
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


def _fedprox_validate(mc: M.MethodConfig):
    if mc.prox_mu < 0:
        raise ValueError(f"prox_mu must be >= 0, got {mc.prox_mu}")


register_method(FedMethod(
    name="fedprox",
    client_update=_client(M.fedprox_client),
    options=("prox_mu",),
    validate=_fedprox_validate,
    description="FedAvg with a proximal term mu/2 ||p - p_t||^2",
))


def _scaffold_server(ctx: RoundCtx, params, agg, state):
    params, state, diag = sgd_server(ctx, params, agg, state)
    # the c_global refresh is a sampled estimate of the population-mean
    # drift: under a reweighting sampler each term carries its 1 / (M q_u)
    dc = ctx.aux["delta_c"]
    if ctx.invp is not None:
        dc = tree_map(lambda d: d * ctx.invp.reshape(
            (-1,) + (1,) * (d.dim() - 1)), dc)
    c_delta = tree_map(lambda d: torch.mean(d, 0), dc)
    state = dict(state, c_global=tree_axpy(
        ctx.fl.cohort / ctx.fl.n_clients, c_delta, state["c_global"]))
    return params, state, diag


register_method(FedMethod(
    name="scaffold",
    client_update=_client(M.scaffold_client),
    server_update=_scaffold_server,
    state_fields=(
        StateField("c_u", per_client=True, cstate_key="c_u", scatter=True,
                   init=lambda p, t, mc: tree_zeros_like(p)),
        StateField("c_global", per_client=False, cstate_key="c_global",
                   init=lambda p, t, mc: tree_zeros_like(p)),
    ),
    description="local gradients corrected by (c - c_u); client keeps c_u",
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
    if ctx.alive is not None:
        # a dropped client's stats never arrived: it keeps the alpha the
        # round started from
        alpha_new = torch.where(ctx.alive > 0, alpha_new, aux["alpha"])
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


def _fedncv_plus_server(ctx: RoundCtx, params, agg, state):
    del agg
    params, sstate, diag = M.fedncv_plus_server(
        ctx.mc, ctx.task, params, ctx.grads, ctx.sizes, ctx.idx,
        dict(h=state["h"], h_sum=state["h_sum"]), ctx.fl.server_lr,
        ctx.fl.n_clients, invp=ctx.invp, alive=ctx.alive)
    return params, dict(state, h=sstate["h"], h_sum=sstate["h_sum"]), diag


register_method(FedMethod(
    name="fedncv+",
    # plain gradients; the server does the work
    client_update=_client(M.fedavg_client),
    server_update=_fedncv_plus_server,
    state_fields=(
        # server-only (cstate_key=None): the stale gradient table h_u and
        # its running sum never leave the server
        StateField("h", per_client=True,
                   init=lambda p, t, mc: tree_zeros_like(p)),
        StateField("h_sum", per_client=False,
                   init=lambda p, t, mc: tree_zeros_like(p)),
    ),
    needs_dense_grads=True,
    description="beyond-paper: SAGA-style stale per-client server CVs",
))


def _personal_fields(task: M.Task, mc: M.MethodConfig):
    # the head leaves are personal, so the federated averaging covers the
    # body only; the clients already upload zero head gradients, so the
    # slice changes nothing under an exact codec and keeps it so under a
    # lossy one
    return (StateField(
        "personal", per_client=True, cstate_key="personal", scatter=True,
        init=lambda p, t, mc: {k: p[k] for k in t.head_keys},
        federated_slice=lambda p, t, mc: M._body_mask(t, p)),)


register_method(FedMethod(
    name="fedrep",
    client_update=_client(M.fedrep_client),
    state_fields=_personal_fields,
    personal=True,
    options=("head_local_steps",),
    description="personal head fit first (body frozen), then shared body",
))

register_method(FedMethod(
    name="fedper",
    client_update=_client(M.fedper_client),
    state_fields=_personal_fields,
    personal=True,
    description="body+head trained locally; body aggregated, head personal",
))


def _pfedsim_cohort_update(ctx: RoundCtx, cstates_new):
    # every tenth round (r is 1-based) the cohort's heads are mixed
    if ctx.r % 10:
        return cstates_new
    return dict(cstates_new, personal=M.pfedsim_server_mix(
        ctx.aux["head"], cstates_new["personal"]))


register_method(FedMethod(
    name="pfedsim",
    client_update=_client(M.pfedsim_client),
    state_fields=_personal_fields,
    personal=True,
    cohort_state_update=_pfedsim_cohort_update,
    description="FedAvg body + similarity-mixed personal classifiers",
))


# ---------------------------------------------------------------------------
# fedglomo: global + local momentum (FedGLOMO-style, Das et al.): each client
# smooths its upload with a heavy-ball buffer carried across the rounds it
# joins, and the server applies the aggregate through a global momentum
# ---------------------------------------------------------------------------

def fedglomo_client(ctx: MethodCtx, params, cstate, batches, key):
    out = M.fedavg_client(ctx.mc, ctx.task, params, cstate, batches, key)
    m_new = tree_map(lambda m_, g: ctx.mc.glomo_beta_local * m_ + g,
                     cstate["m"], out.grad)
    return out._replace(grad=m_new, cstate=dict(out.cstate, m=m_new))


def _fedglomo_server(ctx: RoundCtx, params, agg, state):
    tree, norm = agg
    mc, lr = ctx.mc, ctx.fl.server_lr
    v = tree_map(lambda vi, g: mc.glomo_beta_global * vi
                 + (1.0 - mc.glomo_beta_global) * g.to(vi.dtype),
                 state["v"], tree)
    params = tree_map(lambda p, vi: p - lr * vi.to(p.dtype), params, v)
    return params, dict(state, v=v), dict(agg_norm=norm)


def _fedglomo_validate(mc: M.MethodConfig):
    for nm, b in (("glomo_beta_global", mc.glomo_beta_global),
                  ("glomo_beta_local", mc.glomo_beta_local)):
        if not 0.0 <= b < 1.0:
            raise ValueError(f"{nm} must be in [0, 1), got {b}")


register_method(FedMethod(
    name="fedglomo",
    client_update=fedglomo_client,
    server_update=_fedglomo_server,
    state_fields=(
        StateField("m", per_client=True, cstate_key="m", scatter=True,
                   init=lambda p, t, mc: tree_zeros_like(p)),
        StateField("v", per_client=False,
                   init=lambda p, t, mc: tree_zeros_like(p)),
    ),
    options=("glomo_beta_global", "glomo_beta_local"),
    validate=_fedglomo_validate,
    description="global + local momentum (FedGLOMO-style)",
))
