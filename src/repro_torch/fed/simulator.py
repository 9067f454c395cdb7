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
                          per-client state (not of dropped clients), the
                          aggregator (`fl.aggregator`) over the weights:
                          Eq. 10-12 via `ncv_weighted_sum`, or straight off
                          the int8 / int4 wire via `ncv_weighted_sum_q[4]`,
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

The simulator runs on the CUDA device unless `device` says otherwise; it
raises when no card is present instead of carrying on on the CPU.  Its
rounds and `evaluate` run inside `utils.device.deterministic_f32`, whatever
the caller set globally: cuDNN deterministic with no autotuning and no
TF32, f32 matmuls without TF32 (the reference computes in f32), so the
same draws give the same bits run after run.
"""
from __future__ import annotations

import typing as tp

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch import comm
from repro_torch.fed import aggregators
from repro_torch.fed import api
from repro_torch.fed import faults
from repro_torch.fed import methods as M
from repro_torch.fed import sampling
from repro_torch.fed.api import FLConfig  # noqa: F401  (re-export)
from repro_torch.utils.device import deterministic_f32, resolve_device
from repro_torch.utils.tree_math import (flat_spec, tree_bytes, tree_map,
                                         unravel)


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
                 device=None):
        """data: dict(images (N, ...), labels (N,), client_idx (M, n_max)
        padded with -1, client_sizes (M,)) as numpy arrays."""
        self.device = dev = resolve_device(device)
        self.task, self.fl = task, fl
        self.method = api.get_method(fl.method)
        self._fields = self.method.state_spec(task, fl.mc)
        self.params = tree_map(
            lambda x: torch.as_tensor(x, dtype=torch.float32).to(dev).clone(),
            params)
        self.data = {"images": _tensor(data["images"], torch.float32, dev),
                     "labels": _tensor(data["labels"], torch.int64, dev),
                     "client_sizes": _tensor(data["client_sizes"],
                                             torch.int64, dev)}
        # the draw runs on the host generator; its index tables stay there
        self._pool = _tensor(data["client_idx"], torch.int64)
        self._sizes_host = _tensor(data["client_sizes"], torch.int64)
        self._gen = torch.Generator().manual_seed(int(seed))
        self._grad_spec = flat_spec(self.params, lead=0)
        # client->server wire format (uploads share the params' structure)
        self.codec = comm.get_codec(fl.codec, n=self._grad_spec.n,
                                    **fl.codec_opts)
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
        self._client_update = self._client_fn()
        self.agg = aggregators.get_aggregator(fl.aggregator)
        self._agg_opts = aggregators.resolve_opts(self.agg, fl.agg_opts)
        self._state = api.init_state(self._fields, self.params, task, fl.mc,
                                     fl.n_clients)
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

    def _client_fn(self):
        """The client pass with its wrappers, innermost first: the fault
        plan's corruption (the adversary controls its raw upload and its
        labels), the federated slice, the sampler's statistics (on the raw
        f32 upload), the codec's encode (the server aggregates straight off
        the wire)."""
        fn = self.method.client_update
        if self._fm_corrupts or self._fm_flips:
            fn = faults.wrap_client(fn, self._n_classes)
        if self._fed_mask is not None:
            fn = api.with_federated_slice(fn, self._fed_mask)
        if self.smp.needs_norms or self._sketch_proj is not None:
            fn = sampling.with_stats(fn, norm=self.smp.needs_norms,
                                     proj=self._sketch_proj)
        if self.codec.name != "identity":
            fn = api.with_codec(fn, self.codec)
        return fn

    def __getattr__(self, name):
        # state-field names double as read-only attributes (sim.alphas,
        # sim.c_global, sim.personal, sim.h, ...)
        state = self.__dict__.get("_state")
        if state is not None and name in state:
            return state[name]
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
        super().__setattr__(name, value)

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
        return api.gather_cohort_states(self._fields, state, idx)

    def _f32(self, x):
        if x is None:
            return None
        t = x if torch.is_tensor(x) else torch.tensor(np.asarray(x))
        return t.to(self.device, torch.float32)

    @deterministic_f32()
    def _client_section_local(self, params, state, draws):
        fl, dev = self.fl, self.device
        draws = Draws(*draws)
        idx, sel = (d.to(dev, torch.int64) if torch.is_tensor(d)
                    else torch.from_numpy(np.array(d, dtype=np.int64)).to(
                        dev) for d in draws[:2])
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
        if fstate is not None:
            pending["fault_state"] = _to(fstate, dev)
        batches = self._gather_batch(sel)
        cstates = self._cohort_cstates(state, idx)
        if self._fm_corrupts or self._fm_flips:
            cstates[faults.FAULT_KEY] = dict(gscale=plan["gscale"],
                                             flip=plan["flip"])
        ctx = api.MethodCtx(self.task, fl.mc)
        outs = self._client_update(ctx, params, cstates, batches, u)
        pending.update(idx=idx, sizes=sizes, weights=weights,
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
        if self.smp.update is not None:
            new_state["sampler"] = self.smp.update(
                self._smp_opts, new_state["sampler"], idx, sizes, aux)
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
        # dropped clients keep their previous rows: they never reported
        new_state = api.scatter_cohort_states(self._fields, new_state, idx,
                                              cstates, alive=alive)
        agg = None
        if not method.needs_dense_grads:
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
        return params, new_state, diag

    def _round(self, draws):
        self.round_idx += 1
        pending = self._client_section_local(self.params, self._state, draws)
        self.params, self._state, diag = self._server_section(
            self.params, self._state, pending, self.round_idx)
        return diag

    def run_round(self, draws=None):
        """One synchronous round; `draws` (a `Draws` or a tuple of its
        leading fields) replays a draw.  Returns the round's scalar
        diagnostics as floats."""
        diag = self._round(self.draw_round() if draws is None else draws)
        return {k: float(v) for k, v in diag.items()}

    def run_rounds(self, n, draws=None):
        """n rounds; `draws` is a sequence of n draws or None.
        Returns the stacked per-round diagnostics as float32 numpy arrays
        (one host sync, after the last round)."""
        if n <= 0:
            return {}
        if draws is not None and len(draws) != n:
            raise ValueError(f"{len(draws)} draws for {n} rounds")
        rows = [self._round(self.draw_round() if draws is None
                            else draws[i]) for i in range(n)]
        out = {}
        for k in rows[0]:
            vals = [torch.as_tensor(r[k], dtype=torch.float32,
                                    device=self.device) for r in rows]
            out[k] = torch.stack(vals).cpu().numpy()
        return out

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
        the size rescale; `chunk` clients are evaluated per vmapped pass."""
        dev = self.device
        pool = _tensor(eval_data["client_idx"], torch.int64, dev)
        m, n_max = pool.shape
        sizes_all = _tensor(eval_data["client_sizes"], torch.int64, dev)
        data = {"images": _tensor(eval_data["images"], torch.float32, dev),
                "labels": _tensor(eval_data["labels"], torch.int64, dev)}
        ar = torch.arange(n_max, device=dev)[None, :]
        acc_sum, n_valid = 0.0, 0.0
        for lo in range(0, m, chunk):
            hi = min(lo + chunk, m)
            sizes = sizes_all[lo:hi]
            pos = ar % torch.clamp(sizes[:, None], min=1)
            sel = torch.gather(pool[lo:hi].clamp_min(0), 1, pos)
            feats = {k: v[sel] for k, v in data.items()}
            labels_eval = torch.where(ar < sizes[:, None], feats["labels"],
                                      torch.full_like(feats["labels"], -1))
            personal = tree_map(lambda x: x[lo:hi], self.personal) \
                if self.method.personal else None
            s, v = self._eval_core(self.params, personal, feats, labels_eval,
                                   sizes, personalize_steps)
            acc_sum += float(s)
            n_valid += float(v)
        return acc_sum / max(n_valid, 1.0)
