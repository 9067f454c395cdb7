"""The serve coordinator's client queue (`src/repro/serve/queue.py`,
DESIGN.md §12.1).

It simulates the population of M clients an FL server faces: each round
(one `tick`) the clients' availability follows a registered `FaultModel`,
the process the simulator's fault plans draw from, and available clients
check in with probability `checkin_rate`.  Checked-in clients wait FIFO
until admitted; a queued client whose availability goes off departs.

Capacity follows the straggler model's latency law: client u runs at mean
latency mu_u = lat_mean (1 + lat_skew span_u) (`faults.straggler_means`),
a round's latency is mu_u Exp(1), and the deadline policy folds the
closed-form survival s_u = 1 - exp(-T / mu_u) into the HT weights.

Draws, as the reference's: the availability plan of tick t from the key
fold_in(prng_key(seed), t), the fault state's step from fold_in(
prng_key(seed ^ 0x5E12), t), both through `utils/prng.py` and the port's
`*_from` fault forms (the uniforms, and so the trace, are the reference's
bits for `none`, `markov` and `dropout`); check-ins, arrival order and
latencies from numpy's `default_rng(seed)`.  Everything runs on the host
on small (M,) vectors.  `state_dict` / `load_state_dict` are JSON-ready,
so a serve checkpoint restores the queue mid-trace.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.fed import faults
from repro_torch.utils import prng

# salt of the fault state's step key (the reference's)
STEP_SALT = 0x5E12


def _uniforms(key, m):
    return torch.from_numpy(prng.uniform(key, (m,)))


# the fault models whose plan draws, by their `*_from` forms: (opts, idx,
# m, uniforms); the other registered plans draw nothing
_PLAN_FROM = {
    "dropout": faults.dropout_plan_from,
    "straggler": lambda opts, idx, m, u: faults.straggler_plan_from(
        opts, idx, m, -torch.log1p(-u)),
}
# the fault models that step a state across rounds: (opts, state, uniforms)
_STEP_FROM = {"markov": faults.markov_step_from}


class ClientQueue:
    """FIFO check-in queue over a FaultModel-driven availability trace.

    avail:        registered fault-model name driving availability
                  ("none": always on, "markov": the on/off chain,
                  "dropout": i.i.d. presence each round), with `avail_opts`
                  resolved by the model's own option contract.
    lat_mean /
    lat_skew:     the straggler law's per-client mean latencies (seconds
                  of simulated client compute a round).
    checkin_rate: probability an available, unqueued client checks in at
                  a tick.
    """

    def __init__(self, n_clients: int, avail: str = "markov",
                 avail_opts: dict | None = None, checkin_rate: float = 0.5,
                 lat_mean: float = 1.0, lat_skew: float = 0.5, seed: int = 0):
        if not 0.0 < checkin_rate <= 1.0:
            raise ValueError(f"checkin_rate must be in (0, 1], got "
                             f"{checkin_rate}")
        self.m = int(n_clients)
        self.fm = faults.get_fault(avail)
        self.fm_opts = faults.resolve_opts(self.fm, avail_opts)
        self.checkin_rate = float(checkin_rate)
        self._rng = np.random.default_rng(seed)
        self._seed = int(seed)
        self.tick_idx = 0
        self._ids = torch.arange(self.m)
        self._mu = faults.straggler_means(
            dict(str_mean=float(lat_mean), str_skew=float(lat_skew)),
            self._ids, self.m).numpy().astype(np.float64)
        self._fstate = None
        if self.fm.stateful:
            self._fstate = {k: np.asarray(v) for k, v in
                            self.fm.init_state(self.fm_opts, self.m).items()}
        self._queued: list[int] = []
        self._on = self._availability()

    # ------------------------------------------------------------------
    def _torch_fstate(self):
        return None if self._fstate is None else {
            k: torch.from_numpy(np.array(v, np.float32))
            for k, v in self._fstate.items()}

    def _availability(self) -> np.ndarray:
        """(M,) f32 0/1 availability at the current tick, from the fault
        model's plan over every client."""
        if self.fm.plan is None:                      # "none": always on
            return np.ones((self.m,), np.float32)
        key = prng.fold_in(prng.prng_key(self._seed), self.tick_idx)
        if self.fm.name in _PLAN_FROM:
            plan = _PLAN_FROM[self.fm.name](self.fm_opts, self._ids, self.m,
                                            _uniforms(key, self.m))
        else:
            plan = self.fm.plan(self.fm_opts, self._torch_fstate(), None,
                                self._ids, self.m)
        return plan["alive"].numpy().astype(np.float32)

    def tick(self):
        """Advance one round: step availability, drop departed queued
        clients, draw new check-ins.  Returns the number of fresh
        check-ins."""
        self.tick_idx += 1
        if self.fm.step is not None:
            key = prng.fold_in(prng.prng_key(self._seed ^ STEP_SALT),
                               self.tick_idx)
            state = _STEP_FROM[self.fm.name](
                self.fm_opts, self._torch_fstate(), _uniforms(key, self.m))
            self._fstate = {k: v.numpy() for k, v in state.items()}
        self._on = self._availability()
        # departures: queued clients whose device went offline
        self._queued = [u for u in self._queued if self._on[u] > 0]
        in_q = np.zeros((self.m,), bool)
        if self._queued:
            in_q[np.asarray(self._queued)] = True
        eligible = (self._on > 0) & ~in_q
        coins = self._rng.random(self.m) < self.checkin_rate
        fresh = np.flatnonzero(eligible & coins)
        self._rng.shuffle(fresh)          # arrival order, not id order
        self._queued.extend(int(u) for u in fresh)
        return len(fresh)

    def admit(self, n: int) -> list[int]:
        """Pop the n oldest check-ins (FIFO)."""
        n = max(0, min(int(n), len(self._queued)))
        out, self._queued = self._queued[:n], self._queued[n:]
        return out

    def latencies(self, ids) -> np.ndarray:
        """Each admitted client's latency this round: mu_u Exp(1)."""
        ids = np.asarray(ids, np.int64)
        return self._mu[ids] * self._rng.exponential(size=ids.shape)

    def survival(self, ids, deadline_s: float) -> np.ndarray:
        """P(latency <= deadline) per client (the exponential law)."""
        ids = np.asarray(ids, np.int64)
        return 1.0 - np.exp(-float(deadline_s) / self._mu[ids])

    @property
    def depth(self) -> int:
        return len(self._queued)

    @property
    def available_frac(self) -> float:
        return float(np.mean(self._on))

    # ------------------------------------------------------------------
    # checkpointing (the serve sidecar, JSON)
    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        return dict(
            tick_idx=self.tick_idx,
            queued=list(self._queued),
            fstate=None if self._fstate is None else
            {k: np.asarray(v).tolist() for k, v in self._fstate.items()},
            rng=self._rng.bit_generator.state)

    def load_state_dict(self, sd: dict):
        self.tick_idx = int(sd["tick_idx"])
        self._queued = [int(u) for u in sd["queued"]]
        if sd.get("fstate") is not None:
            self._fstate = {k: np.asarray(v, np.float32)
                            for k, v in sd["fstate"].items()}
        self._rng.bit_generator.state = sd["rng"]
        self._on = self._availability()
