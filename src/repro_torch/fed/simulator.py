"""In-process FL simulator: the paper's protocol on one device.

M clients with Dirichlet(alpha) non-IID shards, a sampled cohort per
round, the cohort's local training, the upload's wire encoding, the
server aggregation, and pre-/post-personalization evaluation ("test
before" / "test after" in Table 1), as `src/repro/fed/simulator.py` runs
them on its synchronous, single-device, device-store path.

Each round:
  `draw_round`            the cohort (`fl.sampler`, from its state) and its
                          HT factors, microbatch rows, the codec's rounding
                          uniforms, and the fault plan (`fl.fault`)
  `_gather_batch`         the (C, K, b, ...) batch from the resident data
  `_client_section_local` the plan's HT factors folded into the Eq. 10-12
                          weights, the cohort's client pass, cohort axis
                          written out (FedNCV: two `rloo_combine` launches
                          at local_epochs=2), wrapped innermost by the
                          plan's corruption (scaled / sign-flipped uploads,
                          flipped labels), then the federated slice, the
                          sampler's statistics (upload norm, sketch) and
                          the codec's encode of the (C, N) upload stack
  `_server_section`       the fault state and the sampler state update,
                          the method's cohort-state update (pFedSim's head
                          mixing every tenth round), the write-back of the
                          per-client state and of a stateful codec's error
                          feedback (`sim.ef`; not of dropped clients), the
                          aggregator (`fl.aggregator`) over the weights:
                          Eq. 10-12 via `ncv_weighted_sum` (on the decoded
                          topk wire too), or straight off the int8 / int4
                          wire via `ncv_weighted_sum_q[4]`, or off lowrank's
                          factors (no kernel),
                          or the robust reductions (skipped for a method
                          that reduces the dense uploads itself, FedNCV+),
                          zeroed when every client dropped; then the
                          method's server update (FedNCV: alpha adaptation)

Draw-injection seam: `run_round(draws=...)` and `run_rounds(n,
draws=[...])` take a round's draws instead of drawing them, so a run can
replay another's (the reference's, or a run on another device): a `Draws`
or a tuple of its leading fields.  `idx` (cohort,) is the cohort and `sel`
(cohort, K, b) the microbatch rows; `u` (cohort, n_chunks, chunk) f32 in
[0, 1) the stochastic codecs' (int8, int4) rounding uniforms, or None to
draw them; `invp` (cohort,) the sampler's HT factors, None for no
reweighting; `plan` the fault plan dict(alive, invp, gscale, flip), None to
draw it; `fault_state` the fault model's state after the round's step
(markov), None to keep the state.  `draw_round()` returns the simulator's
own draws in that form.  The cohort and rows come from a host
`torch.Generator` seeded with `seed`, the fault plan from another seeded
with `seed ^ faults.FAULT_SALT`, and u from a generator on the simulator's
device.  A stateful sampler or fault model reads its state on the host, so
such a draw waits for the previous round.

Pipelined rounds (`fl.staleness = K >= 1`, DESIGN.md §12): round r
issues its client section against the current params, and the server
section applies the pending cohort that round r - K issued.  The in-flight
pendings are a list on the simulator (`_ring`, oldest first, at most K),
so chunked driving follows one run's trajectory.  The first K rounds are
warmup bubbles: the server section runs on all-zero pending buffers, its
params and state are dropped and every diagnostic key reads 0.

The host store (`fl.store = "host"`, `fed/store.py`, DESIGN.md §11): the
per-client `StateField` tables and the images and labels stay in host
memory, and each round works on cohort-sized windows that a prefetch
worker stages; round r's rows are written back before round r + 1's are
gathered.  Per round its params, state and diagnostics equal the device
store's bitwise, at every K.

Telemetry (`repro_torch.track`, DESIGN.md §10): with a sink other than
`none`, each round's scalar diagnostics (one row, 0 for a bubble) go to the
tracker right after its server section, in one device-to-host copy;
`corrupt_frac` (byzantine faults) and `gvar_proxy` (`track_variance`) are
sink-only rows, and under the host store each row carries the store's
`host_mem_peak` and `prefetch_overlap_frac`.  A tracked run's params and
state are bitwise an untracked one's; `tracker="none"` adds nothing.

The simulator runs on the CUDA device unless `device` says otherwise; it
raises when no card is present instead of carrying on on the CPU.  Its
rounds and `evaluate` run inside `utils.device.deterministic_f32`, whatever
the caller set globally: cuDNN deterministic with no autotuning and no
TF32, f32 matmuls without TF32 (the reference computes in f32), so the
same draws give the same bits run after run.
"""
from __future__ import annotations

import typing as tp
import weakref

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch import comm
from repro_torch import track
from repro_torch.fed import aggregators
from repro_torch.fed import api
from repro_torch.fed import faults
from repro_torch.fed import methods as M
from repro_torch.fed import sampling
from repro_torch.fed import store as store_lib
from repro_torch.fed.api import FLConfig  # noqa: F401  (re-export)
from repro_torch.utils.device import deterministic_f32, resolve_device
from repro_torch.utils.tree_math import (flat_spec, tree_bytes, tree_leaves,
                                         tree_map, tree_norm_sq, unravel)


def _tensor(x, dtype, device=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)


def _to(tree, device):
    """A tree of tensors or arrays (or None) as tensors on `device`."""
    return None if tree is None else tree_map(
        lambda x: (x if torch.is_tensor(x) else torch.tensor(np.asarray(x))
                   ).to(device), tree)


class Draws(tp.NamedTuple):
    """One round's draws, as `run_round(draws=...)` replays them (module
    docstring)."""
    idx: tp.Any
    sel: tp.Any
    u: tp.Any = None
    invp: tp.Any = None
    plan: tp.Any = None
    fault_state: tp.Any = None


class Simulator:
    def __init__(self, task: M.Task, params, data, fl: FLConfig, seed=0,
                 device=None, tracker=None):
        """data: dict(images (N, ...), labels (N,), client_idx (M, n_max)
        padded with -1, client_sizes (M,)) as numpy arrays.

        tracker: a `repro_torch.track.Tracker` instance that overrides
        `fl.tracker` / `fl.tracker_opts` (a composite a server loop built,
        a memory sink a test reads)."""
        self.device = dev = resolve_device(device)
        self.task, self.fl = task, fl
        self.method = api.get_method(fl.method)
        self._fields = self.method.state_spec(task, fl.mc)
        # where the per-client tables and the client-indexed data live
        self.store = store_lib.get_store(fl.store)
        self._store_opts = store_lib.resolve_opts(self.store, fl.store_opts)
        self._host_mode = self.store.host_resident
        self.params = tree_map(
            lambda x: torch.as_tensor(x, dtype=torch.float32).to(dev).clone(),
            params)
        sizes = _tensor(data["client_sizes"], torch.int64, dev)
        if self._host_mode:
            # images and labels in the host tables; client_sizes (M
            # scalars) stays on the device for the round's weights
            self._host = self.store.make_tables(self._store_opts,
                                                dev.type == "cuda")
            self._host.adopt("data:images", _tensor(data["images"],
                                                    torch.float32))
            self._host.adopt("data:labels", _tensor(data["labels"],
                                                    torch.int64))
            self.data = {"client_sizes": sizes}
        else:
            self._host = None
            self.data = {"images": _tensor(data["images"], torch.float32,
                                           dev),
                         "labels": _tensor(data["labels"], torch.int64, dev),
                         "client_sizes": sizes}
        # the draw runs on the host generator; its index tables stay there
        self._pool = _tensor(data["client_idx"], torch.int64)
        self._sizes_host = _tensor(data["client_sizes"], torch.int64)
        self._gen = torch.Generator().manual_seed(int(seed))
        self._grad_spec = flat_spec(self.params, lead=0)
        # client->server wire format (uploads share the params' structure;
        # lowrank factors the matrix-shaped leaves of `spec`)
        self.codec = comm.get_codec(fl.codec, n=self._grad_spec.n,
                                    spec=self._grad_spec, **fl.codec_opts)
        self._ugen = torch.Generator(device=dev).manual_seed(int(seed))
        # partial averaging: the fields' combined federated_slice mask
        # (personal heads), or None; uploads are masked before the codec
        self._fed_mask = api.federated_mask(self._fields, self.params, task,
                                            fl.mc)
        # cohort selection: stateful samplers keep their tables under the
        # run state's "sampler" key, and those that read the cohort's
        # upload norms or sketches get them through `with_stats`
        self.smp = sampling.get_sampler(fl.sampler)
        self._smp_opts = sampling.resolve_opts(self.smp, fl.sampler_opts)
        d_sketch = self.smp.sketch_dim(self._smp_opts)
        self._sketch_proj = sampling.sketch_projection(
            self._grad_spec.n, d_sketch, dev) if d_sketch else None
        # client faults: which machinery the model needs is fixed once;
        # fault="none" adds none of it
        self.fm = faults.get_fault(fl.fault)
        self._fm_opts = faults.resolve_opts(self.fm, fl.fault_opts)
        self._fault_on = self.fm.plan is not None
        self._fm_drops = self._fault_on and self.fm.drops(self._fm_opts)
        self._fm_corrupts = self._fault_on and self.fm.corrupts(
            self._fm_opts)
        self._fm_flips = self._fault_on and self.fm.flips(self._fm_opts)
        self._n_classes = int(np.max(np.asarray(data["labels"]))) + 1 \
            if self._fm_flips else None
        self._fgen = torch.Generator().manual_seed(
            int(seed) ^ faults.FAULT_SALT)
        # streaming telemetry (repro_torch.track): each round's scalar
        # diagnostics go to the sink once its server section is done; the
        # "none" sink wires no emitter, so an untracked round is unchanged
        self.tracker = tracker if tracker is not None \
            else track.make_tracker(fl.tracker, **fl.tracker_opts)
        self._track_on = not isinstance(self.tracker, track.NullTracker)
        self._emit = track.emitter(self.tracker) if self._track_on else None
        self._track_var = bool(fl.track_variance)
        self._client_update = self._client_fn()
        self.agg = aggregators.get_aggregator(fl.aggregator)
        self._agg_opts = aggregators.resolve_opts(self.agg, fl.agg_opts)
        # the per-client state the cohort gathers and writes back: the
        # method's fields and a stateful codec's error feedback ("ef")
        self._cohort_fields = self._fields + api.codec_fields(self.codec)
        self._host_state_names: list = []
        if self._host_mode:
            # per-client tables built host-side from one init row each;
            # the global fields stay in the device state dict
            self._state = {}
            for f in self._cohort_fields:
                one = f.init(self.params, task, fl.mc)
                if f.per_client:
                    self._host.add(f.name, one, fl.n_clients)
                    self._host_state_names.append(f.name)
                else:
                    self._state[f.name] = one
        else:
            self._state = api.init_state(self._fields, self.params, task,
                                         fl.mc, fl.n_clients,
                                         codec=self.codec)
        for key, owner, opts in (("sampler", self.smp, self._smp_opts),
                                 ("faults", self.fm, self._fm_opts)):
            if not owner.stateful:
                continue
            if any(f.name == key for f in self._fields):
                raise ValueError(f"method state field '{key}' collides "
                                 f"with the {key} state key; rename the "
                                 f"StateField")
            self._state[key] = _to(owner.init_state(opts, fl.n_clients), dev)
        self.round_idx = 0
        # the in-flight pendings of a pipelined run, oldest first
        self._ring: list = []
        # the host store's prefetch worker and staging copies (lazily)
        self._prefetcher = None
        self._staging = None

    def _client_fn(self):
        """The client pass with its wrappers, innermost first: the fault
        plan's corruption (the adversary controls its raw upload and its
        labels), the federated slice, the sampler's statistics (on the raw
        f32 upload), the telemetry upload ||upload||^2 (`track_variance`),
        the codec's encode (the server aggregates straight off the
        wire)."""
        fn = self.method.client_update
        if self._fm_corrupts or self._fm_flips:
            fn = faults.wrap_client(fn, self._n_classes)
        if self._fed_mask is not None:
            fn = api.with_federated_slice(fn, self._fed_mask)
        if self.smp.needs_norms or self._sketch_proj is not None:
            fn = sampling.with_stats(fn, norm=self.smp.needs_norms,
                                     proj=self._sketch_proj)
        if self._track_var:
            fn = track.with_grad_stats(fn)
        if self.codec.name != "identity":
            fn = api.with_codec(fn, self.codec)
        return fn

    def __getattr__(self, name):
        # state-field names double as read-only attributes (sim.alphas,
        # sim.c_global, sim.personal, sim.h, ...); under the host store a
        # per-client field reads as its host table
        state = self.__dict__.get("_state")
        if state is not None and name in state:
            return state[name]
        if name in self.__dict__.get("_host_state_names", ()):
            return self.__dict__["_host"].get(name)
        raise AttributeError(
            f"{type(self).__name__!s} has no attribute {name!r}")

    def __setattr__(self, name, value):
        # writes to state-key names update the state dict (a host program
        # writes the external sampler's and fault model's tables as
        # `sim.sampler = dict(...)`, `sim.faults = dict(...)`)
        state = self.__dict__.get("_state")
        if state is not None and name in state:
            self._state = dict(state, **{name: _to(value, self.device)})
            return
        if name in self.__dict__.get("_host_state_names", ()):
            self._host.set(name, value)
            return
        super().__setattr__(name, value)

    def _get_state(self):
        """The whole state dict; under the host store the per-client
        tables are merged in as their host tensors."""
        state = dict(self._state)
        for n in self._host_state_names:
            state[n] = self._host.get(n)
        return state

    def _set_state(self, state):
        """Install a whole state dict (checkpoint restore); host tables are
        written in place."""
        dev = {}
        for k, v in state.items():
            if k in self._host_state_names:
                self._host.set(k, v)
            else:
                dev[k] = _to(v, self.device)
        self._state = dev

    def _generators(self):
        """The draw generators by checkpoint name: the cohort and rows, the
        fault plan, and the codec's uniforms (on the device)."""
        return dict(gen=self._gen, fgen=self._fgen, ugen=self._ugen)

    # ------------------------------------------------------------------
    # one round
    # ------------------------------------------------------------------
    def _draw_cohort(self):
        """The sampler's cohort (cohort,) int64 and HT factors (or None),
        on the host, from the sampler's state as it stands."""
        fl = self.fl
        state = self._state.get("sampler")
        return self.smp.draw(self._smp_opts, _to(state, "cpu"), self._gen,
                             fl.n_clients, fl.cohort)

    def _draw_sel(self, idx):
        """Microbatch rows (cohort, K, b) int64, uniform with replacement
        from each cohort client's shard."""
        fl = self.fl
        sizes = self._sizes_host[idx]
        u = torch.rand((fl.cohort, fl.k_micro * fl.micro_batch),
                       generator=self._gen)
        pos = torch.minimum((u * sizes[:, None].float()).long(),
                            sizes[:, None] - 1).clamp_min(0)
        sel = torch.gather(self._pool[idx], 1, pos).clamp_min(0)
        return sel.reshape(fl.cohort, fl.k_micro, fl.micro_batch)

    def _draw_cohort_sel(self):
        """(idx, sel) host tensors; the HT factors are dropped, so this is
        the whole cohort draw only for samplers that do not reweight."""
        idx, _ = self._draw_cohort()
        return idx, self._draw_sel(idx)

    def _draw_fault(self, idx):
        """The round's fault plan for cohort `idx` and the fault state after
        the round's step (None when the model does not step), on the host;
        (None, None) under fault="none"."""
        if not self._fault_on:
            return None, None
        fstate = _to(self._state.get("faults"), "cpu")
        stepped = None
        if self.fm.step is not None:
            fstate = stepped = self.fm.step(self._fm_opts, fstate,
                                            self._fgen)
        plan = self.fm.plan(self._fm_opts, fstate, self._fgen, idx,
                            self.fl.n_clients)
        return plan, stepped

    def _draw_uniforms(self):
        """The stochastic-rounding uniforms (cohort, n_chunks, chunk) of the
        round's encode, from the device generator; None when the codec
        rounds deterministically."""
        if not self.codec.stochastic:
            return None
        return torch.rand(self.codec.uniforms_shape(self.fl.cohort),
                          generator=self._ugen, device=self.device)

    def draw_round(self):
        """One round's draws from the simulator's own generators and the
        sampler's and fault model's state as it stands, as a `Draws`."""
        idx, invp = self._draw_cohort()
        sel = self._draw_sel(idx)
        u = self._draw_uniforms()
        return Draws(idx, sel, u, invp, *self._draw_fault(idx))

    def _gather_batch(self, sel):
        """sel (cohort, K, b) dataset rows -> batch tree (cohort, K, b, ...)."""
        return {k: self.data[k][sel] for k in ("images", "labels")}

    def _cohort_cstates(self, state, idx):
        return api.gather_cohort_states(self._cohort_fields, state, idx)

    def _f32(self, x):
        if x is None:
            return None
        t = x if torch.is_tensor(x) else torch.tensor(np.asarray(x))
        return t.to(self.device, torch.float32)

    @staticmethod
    def _index(d, dev):
        return d.to(dev, torch.int64) if torch.is_tensor(d) else \
            torch.from_numpy(np.array(d, dtype=np.int64)).to(dev)

    @deterministic_f32()
    def _client_section_local(self, params, state, draws, batch=None):
        """The round's client section.  `batch` (host store): the staged
        (cohort, K, b, ...) batch; `state` then holds the cohort's windows,
        addressed by slot (pending["idx"] is arange(cohort)), and the
        global client ids ride pending["gidx"]."""
        fl, dev = self.fl, self.device
        draws = Draws(*draws)
        idx = self._index(draws.idx, dev)
        u = self._draw_uniforms() if draws.u is None else self._f32(draws.u)
        plan, fstate = draws.plan, draws.fault_state
        if self._fault_on and plan is None:
            plan, fstate = self._draw_fault(idx.cpu())
        plan = None if plan is None else {k: self._f32(v)
                                          for k, v in plan.items()}
        sizes = self.data["client_sizes"][idx].float()
        invp = self._f32(draws.invp)
        weights = sizes if invp is None else sizes * invp
        pending = {}
        if self._fm_drops:
            # honest dropout is an inclusion-probability event: the plan's
            # alive / s_u factors join the sampler's; when every client
            # dropped, ones keep the weights finite and `live` zeroes the
            # aggregate
            weights = weights * plan["invp"]
            invp = plan["invp"] if invp is None else invp * plan["invp"]
            live = (torch.sum(weights) > 0).float()
            weights = torch.where(live > 0, weights, torch.ones_like(weights))
            pending.update(alive=plan["alive"], live=live)
        if self._track_on and (self._fm_corrupts or self._fm_flips):
            # the corrupted share of the cohort, for the sink only
            bad = (plan["gscale"] != 1.0) | (plan["flip"] > 0)
            pending["corrupt_frac"] = torch.mean(bad.float())
        if fstate is not None:
            pending["fault_state"] = _to(fstate, dev)
        if batch is None:
            batches = self._gather_batch(self._index(draws.sel, dev))
            slots = idx
        else:
            batches = batch
            slots = torch.arange(fl.cohort, device=dev)
            pending["gidx"] = idx
        cstates = self._cohort_cstates(state, slots)
        if self._fm_corrupts or self._fm_flips:
            cstates[faults.FAULT_KEY] = dict(gscale=plan["gscale"],
                                             flip=plan["flip"])
        ctx = api.MethodCtx(self.task, fl.mc)
        with track.scope(track.CLIENT_PASS):
            outs = self._client_update(ctx, params, cstates, batches, u)
        pending.update(idx=slots, sizes=sizes, weights=weights,
                       grads=outs.grad, cstates=outs.cstate, aux=outs.aux)
        if invp is not None:
            pending["invp"] = invp
        return pending

    @deterministic_f32()
    def _server_section(self, params, state, pending, r):
        fl, method = self.fl, self.method
        idx, aux, grads = pending["idx"], pending["aux"], pending["grads"]
        codec = None if self.codec.name == "identity" else self.codec
        # sizes: the shard sizes; weights: the Eq. 10-12 effective counts,
        # the sizes times the sampler's and the fault plan's HT factors
        # (the sizes themselves when neither reweights)
        sizes, weights = pending["sizes"], pending["weights"]
        alive, live = pending.get("alive"), pending.get("live")
        new_state = dict(state)
        if "fault_state" in pending:
            new_state["faults"] = pending["fault_state"]
        # `idx` addresses the rows in the tables this section sees: the
        # global ids under the device store, window slots under the host
        # store, whose pending carries the global ids as "gidx"
        if self.smp.update is not None:
            new_state["sampler"] = self.smp.update(
                self._smp_opts, new_state["sampler"],
                pending.get("gidx", idx), sizes, aux)
        # the dense per-client uploads, decoded once, only if the method
        # reduces them itself
        dense = None
        if method.needs_dense_grads:
            dense = grads if codec is None else unravel(codec.decode(grads),
                                                        self._grad_spec)
        ctx = api.RoundCtx(task=self.task, mc=fl.mc, fl=fl, r=r, idx=idx,
                           sizes=sizes, aux=aux, grads=dense,
                           weights=weights, invp=pending.get("invp"),
                           alive=alive)
        cstates = pending["cstates"]
        if method.cohort_state_update is not None:
            cstates = method.cohort_state_update(ctx, cstates)
        # dropped clients keep their previous rows, error feedback
        # included: they never reported
        new_state = api.scatter_cohort_states(self._cohort_fields, new_state,
                                              idx, cstates, alive=alive)
        agg = None
        if not method.needs_dense_grads:
            with track.scope(track.AGGREGATE):
                agg = aggregators.aggregate_stack(self.agg, self._agg_opts,
                                                  grads, weights,
                                                  method.beta(fl.mc), codec,
                                                  self._grad_spec)
            if self._fed_mask is not None and codec is not None:
                # a lossy wire may leak into the masked leaves: they get
                # exactly zero update (the identity wire is masked already)
                agg = api.apply_federated_mask(agg[0], self._fed_mask)
            if live is not None:
                # nobody reported: a zero update, not NaN
                agg = (tree_map(lambda g: g * live, agg[0]), agg[1] * live)
        with track.scope(track.SERVER_UPDATE):
            params, new_state, diag = method.server_update(ctx, params, agg,
                                                           new_state)
        diag = {k: v for k, v in diag.items()
                if torch.is_tensor(v) and v.dim() == 0}
        # uploaded bytes this round: the gradient wire plus the aux uploads
        # (the sampler's statistics among them); a dropped client's wire
        # never left it
        if alive is None:
            diag["bytes_up"] = float(fl.cohort * self.codec.bytes_per_client()
                                     + tree_bytes(aux))
        else:
            diag["bytes_up"] = torch.sum(alive) * float(
                self.codec.bytes_per_client()) + float(tree_bytes(aux))
            diag["live"] = torch.sum(alive)
        # the sink's diagnostics: the fault plan's corrupted share (built in
        # the client section when a sink is on) and, under track_variance,
        # the cohort gradient-variance proxy E_w ||g_u||^2 - ||sum_u w_u
        # g_u||^2 over the normalized weights
        if "corrupt_frac" in pending:
            diag["corrupt_frac"] = pending["corrupt_frac"]
        if self._track_var and track.GNORM_KEY in aux:
            p_w = weights / torch.clamp(torch.sum(weights), min=1e-30)
            e2 = torch.sum(p_w * aux[track.GNORM_KEY])
            if agg is not None:
                # agg[1]: the aggregate's squared norm (the kernel's second
                # output on the ncv_weighted_sum path)
                diag["gvar_proxy"] = torch.clamp(e2 - agg[1], min=0.0)
            elif dense is not None:
                gbar = tree_map(lambda g: torch.tensordot(p_w, g, dims=1),
                                dense)
                diag["gvar_proxy"] = torch.clamp(e2 - tree_norm_sq(gbar),
                                                 min=0.0)
        return params, new_state, diag

    def _bubble(self, params, state, pending, r):
        """A warmup step of the pipeline: the server section runs on
        all-zero pending buffers shaped like `pending`; its params and
        state are dropped, and every diagnostic key is kept and reads 0."""
        zero = tree_map(torch.zeros_like, pending)
        _, _, diag = self._server_section(params, state, zero, r)
        return {k: torch.zeros((), dtype=torch.float32, device=self.device)
                for k in diag}

    def _round(self, draws):
        """One device-store round: sync, or one step of the depth-K ring
        (issue this round's cohort, apply the one issued K rounds ago)."""
        self.round_idx += 1
        r = self.round_idx
        pending = self._client_section_local(self.params, self._state, draws)
        if not self.fl.staleness:
            self.params, self._state, diag = self._server_section(
                self.params, self._state, pending, r)
        else:
            if len(self._ring) == self.fl.staleness:
                self.params, self._state, diag = self._server_section(
                    self.params, self._state, self._ring.pop(0), r)
            else:
                diag = self._bubble(self.params, self._state, pending, r)
            self._ring.append(pending)
        if self._emit is not None:
            self._emit(r, diag)
        return diag

    def run_round(self, draws=None):
        """One round; `draws` (a `Draws` or a tuple of its leading fields)
        replays a draw.  Returns the round's scalar diagnostics as
        floats."""
        if self._host_mode:
            rows = self._run_host(1, None if draws is None else [draws])
            return {k: float(v[0]) for k, v in rows.items()}
        if self._emit is not None:
            self._emit.reset()
        diag = self._round(self.draw_round() if draws is None else draws)
        return {k: float(v) for k, v in diag.items()}

    def run_rounds(self, n, draws=None):
        """n rounds; `draws` is a sequence of n draws or None.
        Returns the stacked per-round diagnostics as float32 numpy arrays
        (one host sync, after the last round).  A pipelined run carries its
        in-flight cohorts across calls: `run_rounds(2)` three times follows
        `run_rounds(6)`."""
        if n <= 0:
            return {}
        if draws is not None and len(draws) != n:
            raise ValueError(f"{len(draws)} draws for {n} rounds")
        if self._host_mode:
            return self._run_host(n, draws)
        if self._emit is not None:
            self._emit.reset()
        return self._stack([self._round(self.draw_round() if draws is None
                                        else draws[i]) for i in range(n)])

    def _stack(self, rows):
        out = {}
        for k in rows[0]:
            vals = [torch.as_tensor(r[k], dtype=torch.float32,
                                    device=self.device) for r in rows]
            out[k] = torch.stack(vals).cpu().numpy()
        return out

    # ------------------------------------------------------------------
    # the host store's rounds: the cohort's windows and batch are staged
    # by the prefetch worker; the rows a round wrote go back to the host
    # tables on the worker, before the next cohort's are gathered
    # ------------------------------------------------------------------
    @property
    def _draws_ahead(self):
        """Whether round r + 1's draw can be made before round r runs: not
        when it reads a sampler or fault state that round r updates."""
        return not (self.smp.stateful or self.smp.update is not None
                    or (self._fault_on and self.fm.stateful))

    def _window_like(self):
        """(shape, dtype) of each host table's cohort window."""
        c = self.fl.cohort
        return {n: tree_map(lambda t: ((c,) + tuple(t.shape[1:]), t.dtype),
                            self._host.get(n))
                for n in self._host_state_names}

    def _host_stage_batch(self, draws):
        """Stage one round's (cohort, K, b, ...) batch rows.  The data never
        changes, so this job may run before the previous round's rows are
        written back."""
        fl = self.fl
        sel = store_lib.row_ids(draws.sel)
        tables = {k: self._host.get("data:" + k) for k in ("images",
                                                          "labels")}
        slot, out = self._staging.buffers(
            {k: ((sel.numel(),) + tuple(t.shape[1:]), t.dtype)
             for k, t in tables.items()})
        for k, t in tables.items():
            torch.index_select(t, 0, sel, out=out[k])
        lead = (fl.cohort, fl.k_micro, fl.micro_batch)
        return self._staging.ship(slot, {k: v.view(lead + tuple(v.shape[1:]))
                                         for k, v in out.items()})

    def _host_stage(self, draws, swin=False):
        """Stage the cohort's state windows and, on a pipelined run, the
        windows of the cohort the server section applies (`swin`: its
        global ids; None: zeros, a bubble)."""
        idx = store_lib.row_ids(draws.idx)
        like = dict(windows=self._window_like())
        if swin is not False:
            like["swin"] = like["windows"]
        slot, out = self._staging.buffers(like)
        self._host.gather(self._host_state_names, idx, out=out["windows"])
        if swin is None:
            tree_map(torch.Tensor.zero_, out["swin"])
        elif swin is not False:
            self._host.gather(self._host_state_names, swin, out=out["swin"])
        return dict(idx=idx, staged=self._staging.ship(slot, out))

    def _host_scatter(self, gidx, wout, alive, event):
        """Write one round's windows back to the host tables once the round
        that wrote them (`event`) is done; dropped clients' rows are not
        written."""
        tree = dict(w=wout) if alive is None else dict(w=wout, alive=alive)
        rows = self._staging.fetch(tree, after=event)
        for n in self._host_state_names:
            self._host.scatter(n, gidx, rows["w"][n], rows.get("alive"))

    def _round_done(self):
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _ensure_prefetcher(self):
        if self._prefetcher is None:
            # K in-flight cohorts want K + 1 staged slices before the
            # queue pushes back
            depth = max(2, self.fl.staleness + 1)
            self._prefetcher = store_lib.CohortPrefetcher(
                enabled=bool(self._store_opts["prefetch"]), depth=depth)
            self._staging = store_lib.Staging(self.device,
                                              slots=2 * depth + 1)
            weakref.finalize(self, self._prefetcher.close)
        return self._prefetcher

    def close(self):
        """Stop the host store's prefetch worker (a later round starts a
        new one)."""
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None

    def _run_host(self, n, draws):
        """n host-store rounds through the prefetch worker.  Two jobs a
        round: the batch rows of round i, staged as soon as round i is
        drawn (while round i - 1 runs, when round i can be drawn ahead:
        its draw reads no state that round i - 1 updates), and the state
        job, which writes round i - 1's rows back and then stages round
        i's windows.  Same draws, same sections, same order as the device
        store: the same bits."""
        k, pf = self.fl.staleness, self._ensure_prefetcher()
        if self._emit is not None:
            self._emit.reset()
        ds = [None if draws is None else Draws(*d) for d in
              (draws if draws is not None else [None] * n)]
        ahead = draws is not None or self._draws_ahead
        batches, states = [None] * n, [None] * n

        def draw(i):
            if ds[i] is None:
                ds[i] = self.draw_round()
            d = ds[i]
            batches[i] = pf.submit(lambda: self._host_stage_batch(d))

        def state_job(i, scatter, swin):
            d = ds[i]

            def run():
                if scatter is not None:
                    self._host_scatter(*scatter)
                return self._host_stage(d, swin)
            return run

        def head():
            return False if not k else (
                self._ring[0]["gidx"].cpu() if len(self._ring) == k
                else None)

        draw(0)
        states[0] = pf.submit(state_job(0, None, head()))
        rows, last = [], None
        for i in range(n):
            if ahead and i + 1 < n:
                draw(i + 1)
            if self._emit is not None:
                # the host store's gauges ride every row, as published
                # before the round
                self._emit.set_host_metrics(self._host_gauges())
            batch = batches[i]().ready()
            buf = states[i]()
            staged = buf["staged"].ready()
            self.round_idx += 1
            r = self.round_idx
            pending = self._client_section_local(
                self.params, {**self._state, **staged["windows"]}, ds[i],
                batch=batch)
            scatter = None
            if not k:
                applied = pending
                state_in = {**self._state, **staged["windows"]}
            elif len(self._ring) == k:
                applied = self._ring.pop(0)
                state_in = {**self._state, **staged["swin"]}
            else:
                applied = None
                diag = self._bubble(self.params,
                                    {**self._state, **staged["swin"]},
                                    pending, r)
            if applied is not None:
                params, state, diag = self._server_section(
                    self.params, state_in, applied, r)
                wout = {nm: state.pop(nm) for nm in self._host_state_names}
                self.params, self._state = params, state
                scatter = (applied["gidx"] if k else buf["idx"], wout,
                           applied.get("alive"), self._round_done())
            if k:
                self._ring.append(pending)
            if self._emit is not None:
                self._emit(r, diag)
            rows.append(diag)
            if i + 1 < n:
                if not ahead:
                    draw(i + 1)
                states[i + 1] = pf.submit(state_job(i + 1, scatter, head()))
            elif scatter is not None:
                last = scatter
        if last is not None:
            # the chunk's end: the tables hold every applied round
            pf.submit(lambda: self._host_scatter(*last))()
        return self._stack(rows)

    def _host_gauges(self) -> dict:
        """The host store's two gauges, which a tracked row carries: peak
        host RSS and the share of staging time the rounds did not wait
        for."""
        pf = self._prefetcher
        return dict(
            host_mem_peak=float(store_lib.host_mem_peak()),
            prefetch_overlap_frac=0.0 if pf is None else pf.overlap_frac())

    def host_metrics(self) -> dict:
        """The host store's counters: its two gauges and the bytes staged
        to and from the device so far."""
        st = self._staging
        return dict(self._host_gauges(),
                    staged_bytes_in=0 if st is None else st.bytes_in,
                    staged_bytes_out=0 if st is None else st.bytes_out)

    def device_state_bytes(self):
        """Bytes of device-resident run state: params and the state dict
        (and the resident data under the device store).  Under the host
        store it holds no (M, N) table, so it does not grow with M beyond
        the sampler's and fault model's M-scalars."""
        trees = [self.params, self._state]
        if not self._host_mode:
            trees.append(self.data)
        return int(sum(x.numel() * x.element_size() for t in trees
                       for x in tree_leaves(t)))

    def host_state_bytes(self):
        """Bytes held by the host tables (0 under the device store)."""
        return 0 if self._host is None else self._host.nbytes()

    # ------------------------------------------------------------------
    # the in-flight pipeline as checkpoint state
    # ------------------------------------------------------------------
    def pipeline_state(self):
        """The in-flight pendings, dict(ring=[pending, ...]) oldest first
        (and, under the host store, pidx: the (L, cohort) global ids of
        their cohorts), or None when nothing is in flight."""
        if not self.fl.staleness or not self._ring:
            return None
        pipe = dict(ring=list(self._ring))
        if self._host_mode:
            pipe["pidx"] = torch.stack([p["gidx"] for p in self._ring])
        return pipe

    def pipeline_template(self, n_inflight=None):
        """A tree shaped like `pipeline_state()` with `n_inflight` pendings
        (default K), from one client section on a draw made with the
        generators' states put back afterwards."""
        n = self.fl.staleness if n_inflight is None else int(n_inflight)
        gens = {k: g.get_state() for k, g in self._generators().items()}
        try:
            d = self.draw_round()
            if self._host_mode:
                self._ensure_prefetcher()
                windows = self._host_stage(d)["staged"].ready()["windows"]
                pending = self._client_section_local(
                    self.params, {**self._state, **windows}, d,
                    batch=self._host_stage_batch(d).ready())
            else:
                pending = self._client_section_local(self.params,
                                                     self._state, d)
        finally:
            for k, g in self._generators().items():
                g.set_state(gens[k])
        zero = tree_map(torch.zeros_like, pending)
        pipe = dict(ring=[zero] * n)
        if self._host_mode:
            pipe["pidx"] = torch.zeros((n, self.fl.cohort), dtype=torch.int64,
                                       device=self.device)
        return pipe

    def _track_resume(self, round_idx):
        """Re-arm the tracker after a checkpoint restore: the sinks drop
        rows past `round_idx` (a crashed run may have streamed rounds the
        checkpoint never saw) and `bytes_up_cum` picks up from the last
        surviving row, so the file goes on with a monotone round index.
        Called by `checkpoint.restore_sim`."""
        if not self._track_on:
            return
        last = self.tracker.resume(int(round_idx))
        self._emit.resume(last)

    def set_pipeline_state(self, pipe):
        """Install a restored pipeline (None: a fresh one, K bubbles)."""
        self._ring = [] if pipe is None else [_to(p, self.device)
                                              for p in pipe["ring"]]

    # ------------------------------------------------------------------
    # evaluation: padded, chunked, one vmapped pass per chunk
    # ------------------------------------------------------------------
    def _eval_core(self, params, personal, feats, labels_eval, sizes,
                   personalize_steps: int):
        """`personal`: the chunk's personal heads (leaves (chunk, ...)),
        overlaid on `params` for each client, or None."""
        task, lr = self.task, self.fl.mc.local_lr
        n_max = labels_eval.shape[1]
        p = params
        per_client = personal is not None or personalize_steps > 0
        if personal is not None:
            p = M._split_update(task, params, personal)
        elif personalize_steps:
            p = M._per_client(params, sizes.shape[0])
        if personalize_steps:
            step = vmap(grad(task.loss), in_dims=(0, 0))
            # personalization runs on the cyclically padded batch: each real
            # sample appears floor/ceil(n_max/size) times
            for _ in range(personalize_steps):
                g = step(p, feats)
                p = tree_map(lambda pi, gi: pi - lr * gi, p, g)
        acc = vmap(task.accuracy, in_dims=(0 if per_client else None, 0))(
            p, dict(feats, labels=labels_eval))
        # padded positions carry label -1 (argmax never matches), so the
        # padded-mean accuracy rescales exactly to the true shard mean
        acc = acc * n_max / torch.clamp(sizes, min=1).float()
        valid = (sizes > 0).float()
        return torch.sum(acc * valid), torch.sum(valid)

    @deterministic_f32()
    def evaluate(self, eval_data, personalize_steps=0, chunk: int = 32):
        """Mean per-client accuracy; personalize_steps > 0 == "test after".
        A personalizing method (`personal`) evaluates each client with its
        own head, so the eval clients are the training clients.

        Each client's shard is cyclically padded to the global n_max, and
        padded slots are excluded from the accuracy by the -1-label mask and
        the size rescale; `chunk` clients are evaluated per vmapped pass.
        Under the host store the eval set stays on the host and only each
        chunk's (chunk, n_max, ...) window reaches the device."""
        dev = self.device
        gdev = torch.device("cpu") if self._host_mode else dev
        pool = _tensor(eval_data["client_idx"], torch.int64, gdev)
        m, n_max = pool.shape
        sizes_all = _tensor(eval_data["client_sizes"], torch.int64, gdev)
        data = {"images": _tensor(eval_data["images"], torch.float32, gdev),
                "labels": _tensor(eval_data["labels"], torch.int64, gdev)}
        ar = torch.arange(n_max, device=gdev)[None, :]
        acc_sum, n_valid = 0.0, 0.0
        for lo in range(0, m, chunk):
            hi = min(lo + chunk, m)
            sizes = sizes_all[lo:hi]
            pos = ar % torch.clamp(sizes[:, None], min=1)
            sel = torch.gather(pool[lo:hi].clamp_min(0), 1, pos)
            feats = {k: v[sel] for k, v in data.items()}
            labels_eval = torch.where(ar < sizes[:, None], feats["labels"],
                                      torch.full_like(feats["labels"], -1))
            feats = _to(feats, dev)
            labels_eval, sizes = labels_eval.to(dev), sizes.to(dev)
            personal = tree_map(lambda x: x[lo:hi].to(dev), self.personal) \
                if self.method.personal else None
            s, v = self._eval_core(self.params, personal, feats, labels_eval,
                                   sizes, personalize_steps)
            acc_sum += float(s)
            n_valid += float(v)
        return acc_sum / max(n_valid, 1.0)
