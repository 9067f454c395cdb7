"""In-process FL simulator: the paper's protocol on one device.

M clients with Dirichlet(alpha) non-IID shards, a sampled cohort per
round, the cohort's local training, the upload's wire encoding, the
server aggregation, and pre-/post-personalization evaluation ("test
before" / "test after" in Table 1), as `src/repro/fed/simulator.py` runs
them on its synchronous, single-device, device-store path.

Each round:
  `_draw_cohort_sel`      cohort indices + microbatch rows (host generator)
  `_gather_batch`         the (C, K, b, ...) batch from the resident data
  `_client_section_local` the cohort's client pass, cohort axis written out
                          (FedNCV: two `rloo_combine` launches at
                          local_epochs=2), then the codec's encode of the
                          (C, N) upload stack (`fl.codec`)
  `_server_section`       the aggregator (`fl.aggregator`): Eq. 10-12 via
                          `ncv_weighted_sum`, or straight off the int8 /
                          int4 wire via `ncv_weighted_sum_q[4]`, or the
                          robust reductions; then the method's server
                          update (FedNCV: alpha adaptation)

Draw-injection seam: `run_round(draws=(idx, sel, u))` and
`run_rounds(n, draws=[...])` take the cohort `idx` (cohort,), the
microbatch rows `sel` (cohort, K, b) and, for the stochastic codecs (int8,
int4), the rounding uniforms `u` (cohort, n_chunks, chunk) f32 in [0, 1)
instead of drawing them, so a run can replay another's draws (the
reference's, or a run on another device).  `u` may be left out or None.
Without them, idx and sel come from a host `torch.Generator` seeded with
`seed` and u from a generator on the simulator's device, seeded the same.

The simulator runs on the CUDA device unless `device` says otherwise; it
raises when no card is present instead of carrying on on the CPU.  Its
rounds and `evaluate` run inside `utils.device.deterministic_f32`, whatever
the caller set globally: cuDNN deterministic with no autotuning and no
TF32, f32 matmuls without TF32 (the reference computes in f32), so the
same draws give the same bits run after run.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch import comm
from repro_torch.fed import aggregators
from repro_torch.fed import api
from repro_torch.fed import methods as M
from repro_torch.fed import sampling
from repro_torch.fed.api import FLConfig  # noqa: F401  (re-export)
from repro_torch.utils.device import deterministic_f32, resolve_device
from repro_torch.utils.tree_math import flat_spec, tree_bytes, tree_map


def _tensor(x, dtype, device=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)


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
        # non-identity codecs compress the upload at the end of the client
        # fn; the server aggregates straight off the wire
        self._client_update = self.method.client_update
        if self.codec.name != "identity":
            self._client_update = api.with_codec(self._client_update,
                                                 self.codec)
        self.smp = sampling.get_sampler(fl.sampler)
        self._smp_opts = sampling.resolve_opts(self.smp, fl.sampler_opts)
        self.agg = aggregators.get_aggregator(fl.aggregator)
        self._agg_opts = aggregators.resolve_opts(self.agg, fl.agg_opts)
        self._state = api.init_state(self._fields, self.params, task, fl.mc,
                                     fl.n_clients)
        self.round_idx = 0

    def __getattr__(self, name):
        # state-field names double as read-only attributes (sim.alphas)
        state = self.__dict__.get("_state")
        if state is not None and name in state:
            return state[name]
        raise AttributeError(
            f"{type(self).__name__!s} has no attribute {name!r}")

    # ------------------------------------------------------------------
    # one round
    # ------------------------------------------------------------------
    def _draw_cohort_sel(self):
        """Cohort (without replacement, by the sampler) and microbatch rows
        (uniform with replacement from each client's shard).  Returns
        (idx (cohort,), sel (cohort, K, b)) int64 host tensors."""
        fl = self.fl
        idx, _ = self.smp.draw(self._smp_opts, self._gen, fl.n_clients,
                               fl.cohort)
        sizes = self._sizes_host[idx]
        u = torch.rand((fl.cohort, fl.k_micro * fl.micro_batch),
                       generator=self._gen)
        pos = torch.minimum((u * sizes[:, None].float()).long(),
                            sizes[:, None] - 1).clamp_min(0)
        sel = torch.gather(self._pool[idx], 1, pos).clamp_min(0)
        return idx, sel.reshape(fl.cohort, fl.k_micro, fl.micro_batch)

    def _draw_uniforms(self):
        """The stochastic-rounding uniforms (cohort, n_chunks, chunk) of the
        round's encode, from the device generator; None when the codec
        rounds deterministically."""
        if not self.codec.stochastic:
            return None
        return torch.rand(self.codec.uniforms_shape(self.fl.cohort),
                          generator=self._ugen, device=self.device)

    def draw_round(self):
        """One round's draws (idx, sel, u) from the simulator's own
        generators, in the form `run_round(draws=...)` replays."""
        return (*self._draw_cohort_sel(), self._draw_uniforms())

    def _gather_batch(self, sel):
        """sel (cohort, K, b) dataset rows -> batch tree (cohort, K, b, ...)."""
        return {k: self.data[k][sel] for k in ("images", "labels")}

    def _cohort_cstates(self, state, idx):
        return api.gather_cohort_states(self._fields, state, idx)

    @deterministic_f32()
    def _client_section_local(self, params, state, draws):
        fl = self.fl
        idx, sel = (d.to(self.device, torch.int64) if torch.is_tensor(d)
                    else torch.from_numpy(np.array(d, dtype=np.int64)).to(
                        self.device) for d in draws[:2])
        u = draws[2] if len(draws) > 2 else None
        u = self._draw_uniforms() if u is None else torch.as_tensor(
            u, dtype=torch.float32).to(self.device)
        sizes = self.data["client_sizes"][idx].float()
        batches = self._gather_batch(sel)
        cstates = self._cohort_cstates(state, idx)
        ctx = api.MethodCtx(self.task, fl.mc)
        outs = self._client_update(ctx, params, cstates, batches, u)
        return dict(idx=idx, sizes=sizes, grads=outs.grad,
                    cstates=outs.cstate, aux=outs.aux)

    @deterministic_f32()
    def _server_section(self, params, state, pending, r):
        fl, method = self.fl, self.method
        idx, aux = pending["idx"], pending["aux"]
        ctx = api.RoundCtx(task=self.task, mc=fl.mc, fl=fl, r=r, idx=idx,
                           sizes=pending["sizes"], aux=aux)
        new_state = api.scatter_cohort_states(self._fields, dict(state), idx,
                                              pending["cstates"])
        # the uniform sampler does not reweight: the Eq. 10-12 effective
        # counts are the shard sizes themselves
        codec = None if self.codec.name == "identity" else self.codec
        agg = aggregators.aggregate_stack(self.agg, self._agg_opts,
                                          pending["grads"], pending["sizes"],
                                          method.beta(fl.mc), codec,
                                          self._grad_spec)
        params, new_state, diag = method.server_update(ctx, params, agg,
                                                       new_state)
        diag = {k: v for k, v in diag.items()
                if torch.is_tensor(v) and v.dim() == 0}
        # uploaded bytes this round: the gradient wire plus the aux scalars
        diag["bytes_up"] = float(fl.cohort * self.codec.bytes_per_client()
                                 + tree_bytes(aux))
        return params, new_state, diag

    def _round(self, draws):
        self.round_idx += 1
        pending = self._client_section_local(self.params, self._state, draws)
        self.params, self._state, diag = self._server_section(
            self.params, self._state, pending, self.round_idx)
        return diag

    def run_round(self, draws=None):
        """One synchronous round; `draws` = (idx, sel[, u]) replays a draw.
        Returns the round's scalar diagnostics as floats."""
        diag = self._round(self._draw_cohort_sel() if draws is None
                           else draws)
        return {k: float(v) for k, v in diag.items()}

    def run_rounds(self, n, draws=None):
        """n rounds; `draws` is a sequence of n (idx, sel[, u]) or None.
        Returns the stacked per-round diagnostics as float32 numpy arrays
        (one host sync, after the last round)."""
        if n <= 0:
            return {}
        if draws is not None and len(draws) != n:
            raise ValueError(f"{len(draws)} draws for {n} rounds")
        rows = [self._round(self._draw_cohort_sel() if draws is None
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
    def _eval_core(self, params, feats, labels_eval, sizes,
                   personalize_steps: int):
        task, lr = self.task, self.fl.mc.local_lr
        n_max = labels_eval.shape[1]
        p = params
        if personalize_steps:
            p = M._per_client(params, sizes.shape[0])
            step = vmap(grad(task.loss), in_dims=(0, 0))
            # personalization runs on the cyclically padded batch: each real
            # sample appears floor/ceil(n_max/size) times
            for _ in range(personalize_steps):
                g = step(p, feats)
                p = tree_map(lambda pi, gi: pi - lr * gi, p, g)
        acc = vmap(task.accuracy,
                   in_dims=(0 if personalize_steps else None, 0))(
            p, dict(feats, labels=labels_eval))
        # padded positions carry label -1 (argmax never matches), so the
        # padded-mean accuracy rescales exactly to the true shard mean
        acc = acc * n_max / torch.clamp(sizes, min=1).float()
        valid = (sizes > 0).float()
        return torch.sum(acc * valid), torch.sum(valid)

    @deterministic_f32()
    def evaluate(self, eval_data, personalize_steps=0, chunk: int = 32):
        """Mean per-client accuracy; personalize_steps > 0 == "test after".

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
            s, v = self._eval_core(self.params, feats, labels_eval, sizes,
                                   personalize_steps)
            acc_sum += float(s)
            n_valid += float(v)
        return acc_sum / max(n_valid, 1.0)
