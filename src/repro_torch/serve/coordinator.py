"""The event-driven round coordinator (`src/repro/serve/coordinator.py`,
DESIGN.md §12).

The `Coordinator` is the serve loop's control plane: a `ClientQueue` of
simulated check-ins, a registered `AdmissionPolicy` deciding how many to
admit each round, and a deadline policy cutting stragglers at
`deadline_s`.  It drives the data plane, a `fed.Simulator`, one round at a
time, and writes what it decided into the simulator's "external" sampler
and fault tables before each round:

  * sampler state (idx, invp): the admitted cohort ids, padded to the
    fixed `FLConfig.cohort`, with the admission HT factor 1 / (M q_u) a
    slot (q_u from the per-client admission-frequency EMA, normalized so a
    uniform world gives invp == 1 exactly), invp = 0 on padding;
  * fault state (alive, invp): the deadline cut, alive = 0 for stragglers
    and padding, invp = alive / s_u with the exponential law's survival
    s_u = 1 - exp(-deadline / mu_u).

The simulator's HT machinery does the rest (Eq. 10-12 weights, the gated
state write-back, honest bytes_up, the all-dropped guard): the round never
learns its cohort came from a queue.

Pipelining: under `FLConfig.staleness = K` the cohort admitted at round r
is applied at round r + K; `drain()` flushes the K in-flight cohorts with
zero-admission rounds (a graceful shutdown calls it before the last
checkpoint).

Telemetry: queue_depth, checkins, admitted, rejected, cohort_size and
deadline_miss_frac are published through `emit.set_host_metrics` and ride
every row the simulator's tracker streams.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from repro_torch.serve import admission
from repro_torch.serve.queue import ClientQueue

SERVE_SIDECAR = "serve_state.json"


class Coordinator:
    """Drive `sim` (sampler="external", fault="external") from `queue`.

    policy / policy_opts: a registered `AdmissionPolicy` and its options.
    deadline_s:     T_round; admitted clients slower than this are cut and
                    HT-reweighted (<= 0 disables the cut).
    target_round_s: the wall-clock budget the adaptive policy steers to
                    (default: deadline_s).
    """

    def __init__(self, sim, queue: ClientQueue, policy: str = "fixed",
                 policy_opts: dict | None = None, deadline_s: float = 2.0,
                 target_round_s: float | None = None, ema: float = 0.1):
        fl = sim.fl
        if fl.sampler != "external" or fl.fault != "external":
            raise ValueError(
                "Coordinator needs FLConfig.make(sampler='external', "
                "sampler_opts={'ext_cohort': cohort}, fault='external', "
                "fault_opts={'ext_slots': cohort}) — the coordinator "
                f"writes those tables; got sampler={fl.sampler!r}, "
                f"fault={fl.fault!r}")
        if queue.m != fl.n_clients:
            raise ValueError(f"queue has {queue.m} clients but the "
                             f"simulator has {fl.n_clients}")
        self.sim, self.queue = sim, queue
        self.policy = admission.get_policy(policy)
        self.policy_opts = admission.resolve_opts(self.policy, policy_opts)
        self.pstate = self.policy.init(self.policy_opts)
        self.deadline_s = float(deadline_s)
        self.target_round_s = float(deadline_s if target_round_s is None
                                    else target_round_s)
        self.ema = float(ema)
        # the admission-frequency EMA (the q_u estimate), uniform at first
        self._freq = np.full((fl.n_clients,), fl.cohort / fl.n_clients,
                             np.float64)
        self._last_round_s = 0.0
        self.last_metrics: dict = {}

    # ------------------------------------------------------------------
    def _admission_invp(self, ids) -> np.ndarray:
        """HT factor 1 / (M q_u) of the admitted ids, q normalized over the
        population (a uniform world gives exactly 1.0)."""
        w = np.maximum(self._freq, 1e-6)
        q = w / w.sum()
        return 1.0 / (self.sim.fl.n_clients * q[np.asarray(ids, np.int64)])

    def _write_tables(self, ids, alive, invp_admit, invp_deadline):
        """Install this round's cohort and HT tables as the simulator's
        external sampler and fault state, on its device."""
        c = self.sim.fl.cohort
        idx = np.zeros((c,), np.int32)
        s_invp = np.zeros((c,), np.float32)
        f_alive = np.zeros((c,), np.float32)
        f_invp = np.zeros((c,), np.float32)
        n = len(ids)
        if n:
            idx[:n] = np.asarray(ids, np.int32)
            s_invp[:n] = np.asarray(invp_admit, np.float32)
            f_alive[:n] = np.asarray(alive, np.float32)
            f_invp[:n] = np.asarray(invp_deadline, np.float32)
        dev = self.sim.device
        self.sim._state = dict(
            self.sim._state,
            sampler=dict(idx=torch.from_numpy(idx).to(dev),
                         invp=torch.from_numpy(s_invp).to(dev)),
            faults=dict(alive=torch.from_numpy(f_alive).to(dev),
                        invp=torch.from_numpy(f_invp).to(dev)))

    # ------------------------------------------------------------------
    def step(self, *, admit_override: int | None = None) -> dict:
        """One served round: tick the queue, admit, cut stragglers, write
        the tables, run the round.  Returns the round's diagnostics merged
        with the queue and admission metrics."""
        fl = self.sim.fl
        checkins = self.queue.tick()
        stats = dict(queue_depth=self.queue.depth, cohort_max=fl.cohort,
                     last_round_s=self._last_round_s,
                     target_round_s=self.target_round_s)
        if admit_override is None:
            n_admit, self.pstate = self.policy.admit(
                self.policy_opts, self.pstate, stats)
        else:
            n_admit = admit_override
        ids = self.queue.admit(n_admit)
        n = len(ids)
        if n:
            if self.deadline_s > 0:
                lat = self.queue.latencies(ids)
                alive = (lat <= self.deadline_s).astype(np.float32)
                surv = self.queue.survival(ids, self.deadline_s)
                invp_deadline = alive / np.maximum(surv, 1e-9)
            else:
                alive = np.ones((n,), np.float32)
                invp_deadline = np.ones((n,), np.float32)
            invp_admit = self._admission_invp(ids)
            miss_frac = 1.0 - float(np.mean(alive))
        else:
            alive = invp_deadline = invp_admit = np.zeros((0,), np.float32)
            miss_frac = 0.0
        self._write_tables(ids, alive, invp_admit, invp_deadline)
        # the inclusion-rate estimate for the next rounds' HT factor
        ind = np.zeros_like(self._freq)
        if n:
            ind[np.asarray(ids, np.int64)] = 1.0
        self._freq = (1.0 - self.ema) * self._freq + self.ema * ind
        metrics = dict(queue_depth=float(stats["queue_depth"]),
                       checkins=float(checkins), admitted=float(n),
                       rejected=float(stats["queue_depth"] - n),
                       cohort_size=float(np.sum(alive)),
                       deadline_miss_frac=float(miss_frac))
        self.last_metrics = metrics
        if self.sim._emit is not None:
            self.sim._emit.set_host_metrics(metrics)
        t0 = time.perf_counter()
        diag = self.sim.run_round()
        self._last_round_s = time.perf_counter() - t0
        return dict(diag, **metrics)

    def drain(self) -> list[dict]:
        """Flush the pipeline: `staleness` zero-admission rounds, so every
        in-flight cohort's server section is applied (the new cohorts are
        all-dead no-ops).  A sync run (K = 0) drains at once."""
        return [self.step(admit_override=0)
                for _ in range(self.sim.fl.staleness)]

    # ------------------------------------------------------------------
    # serve checkpoints: the simulator's checkpoint and a JSON sidecar
    # ------------------------------------------------------------------
    def save(self, directory: str, keep: int = 3):
        """`checkpoint.save_sim` (params, state, the in-flight ring) and a
        JSON sidecar with the control plane (queue trace, policy state,
        admission EMA), so a restart resumes the exact served
        trajectory."""
        from repro_torch.checkpoint import ckpt
        ckpt.save_sim(directory, self.sim, keep=keep)
        sidecar = dict(
            round_idx=self.sim.round_idx,
            policy=self.policy.name,
            pstate=self.pstate,
            freq=self._freq.tolist(),
            last_round_s=self._last_round_s,
            queue=self.queue.state_dict())
        tmp = os.path.join(directory, SERVE_SIDECAR + ".tmp")
        with open(tmp, "w") as f:
            json.dump(sidecar, f)
        os.replace(tmp, os.path.join(directory, SERVE_SIDECAR))

    def restore(self, directory: str) -> dict:
        """Restore the simulator's checkpoint and, when present, the
        sidecar (a simulator-only checkpoint keeps the fresh control
        plane)."""
        from repro_torch.checkpoint import ckpt
        meta = ckpt.restore_sim(directory, self.sim)
        path = os.path.join(directory, SERVE_SIDECAR)
        if os.path.exists(path):
            with open(path) as f:
                sidecar = json.load(f)
            if sidecar.get("policy") != self.policy.name:
                raise ValueError(
                    f"serve checkpoint was written with admission policy "
                    f"{sidecar.get('policy')!r} but the coordinator runs "
                    f"{self.policy.name!r}")
            self.pstate = sidecar["pstate"]
            self._freq = np.asarray(sidecar["freq"], np.float64)
            self._last_round_s = float(sidecar["last_round_s"])
            self.queue.load_state_dict(sidecar["queue"])
        return meta


def make_serve_config(base=None, **kw):
    """An `FLConfig.make` wired for the coordinator: sampler and fault
    forced to "external" with slot counts equal to the cohort."""
    from repro_torch.fed import FLConfig
    kw = dict(base or {}, **kw)
    cohort = int(kw.get("cohort", 10))
    kw["sampler"] = "external"
    kw["sampler_opts"] = dict(ext_cohort=cohort)
    kw["fault"] = "external"
    kw["fault_opts"] = dict(ext_slots=cohort)
    return FLConfig.make(**kw)
