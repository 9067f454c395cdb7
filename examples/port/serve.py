"""The FL round service on the port (DESIGN.md §12), on the GPU.

    PYTHONPATH=src python examples/port/serve.py [--rounds N] [--staleness K]
        [--policy NAME] [--fault NAME] [--tracker NAME] [--track-out PATH]
        [--ckpt-dir DIR --ckpt-every N] [--resume] [--smoke] [--device cpu]

The twin of `examples/serve.py` on `repro_torch`: the quickstart's
training loop turned into a server.  A `serve.Coordinator` owns a
`ClientQueue` of simulated check-ins (availability from the fault model
named by `--fault`), an `AdmissionPolicy` (`--policy`) sizes each round's
cohort, and a deadline policy cuts stragglers at `--deadline` seconds,
every decision folded into the Horvitz-Thompson weights so the Eq. 10-12
estimator stays unbiased.  `--staleness K` runs a depth-K pipeline: the
cohort admitted at round r is applied at round r + K, and the loop's last
K rounds (and a SIGINT) drain the in-flight cohorts.

Each round streams one tracker row with the queue columns alongside
(queue_depth, admitted, rejected, cohort_size, deadline_miss_frac);
`--tracker jsonl` writes stdout lines and a file (`--track-out`) that
`tools/flwatch.py` tails and checks.  Between rounds the host evaluates
every `--eval-every` rounds and checkpoints every `--ckpt-every` rounds
(`--ckpt-dir`); `--resume` restores the latest checkpoint (params, state,
the in-flight ring, the queue trace, the policy state) and continues the
served trajectory exactly (for the policies that do not read the clock).

Ctrl-C drains the in-flight cohorts, evaluates, writes the tracker's
summary and a final checkpoint.  `--crash-after N` simulates a hard kill
after round N (no drain, no flush), for `--resume` to recover from.

`--smoke` runs a 2-round depth-1 serve on a tiny split and prints
SERVE_SMOKE_OK.  It runs on the CUDA device unless `--device cpu` is
given; without a card and without that option it stops with an error.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch import track
from repro_torch.data import federated_splits
from repro_torch.fed import (Simulator, Task, registered_aggregators,
                             registered_faults)
from repro_torch.models import lenet
from repro_torch.serve import (ClientQueue, Coordinator, make_serve_config,
                               registered_policies)


def build_tracker(name: str, path: str):
    """The serve loop's sink: always a stdout line a round; a file sink
    (`jsonl` / `csv`) composes with stdout."""
    stdout = track.make_tracker("stdout")
    if name == "stdout":
        return stdout
    if name in ("jsonl", "csv"):
        return track.composite(stdout, track.make_tracker(name, path=path))
    return track.make_tracker(name)


def build_coordinator(n_clients, cohort, staleness, policy, deadline,
                      fault, checkin_rate, aggregator, scale, tracker=None,
                      seed=0, device=None):
    """The data plane (a Simulator on the external sampler and fault
    tables) and the control plane (the queue, the admission policy)."""
    spec, train, test = federated_splits("cifar10", n_clients=n_clients,
                                         alpha=0.1, seed=seed, scale=scale,
                                         noise=1.2, class_sep=0.8)
    cfg = lenet.LeNetConfig(n_classes=spec.n_classes,
                            image_size=spec.image_size,
                            channels=spec.channels)
    task = Task(loss=lambda p, b: lenet.loss_fn(cfg, p, b),
                accuracy=lambda p, b: lenet.accuracy(cfg, p, b),
                head_keys=lenet.HEAD_KEYS)
    params = lenet.init(cfg, torch.Generator().manual_seed(seed))
    fl = make_serve_config(method="fedncv", n_clients=n_clients,
                           cohort=cohort, k_micro=3, micro_batch=8,
                           server_lr=0.5, local_epochs=1, ncv_beta=0.0,
                           staleness=staleness, aggregator=aggregator)
    sim = Simulator(task, params, train, fl, seed=seed, device=device,
                    tracker=tracker)
    queue = ClientQueue(n_clients, avail=fault, checkin_rate=checkin_rate,
                        lat_mean=0.4, lat_skew=0.5, seed=seed)
    coord = Coordinator(sim, queue, policy=policy, deadline_s=deadline)
    return coord, test


def serve(coord, test, rounds, eval_every, ckpt_dir=None, ckpt_every=0,
          crash_after=0):
    """The server loop: admission rounds until `rounds - K`, then K
    zero-admission rounds that apply the in-flight cohorts, so exactly
    `rounds` rows stream.  A KeyboardInterrupt drains, evaluates, writes
    the tracker's summary and the final checkpoint."""
    sim = coord.sim
    k = sim.fl.staleness
    interrupted = False
    try:
        while sim.round_idx < rounds:
            if sim.round_idx >= rounds - k:
                coord.step(admit_override=0)      # the tail's drain
            else:
                coord.step()
            if eval_every and sim.round_idx % eval_every == 0 \
                    and sim.round_idx < rounds:
                acc = sim.evaluate(test)
                print(f"round {sim.round_idx:3d}  eval accuracy {acc:.3f}",
                      flush=True)
            if ckpt_dir and ckpt_every and sim.round_idx % ckpt_every == 0:
                coord.save(ckpt_dir)
            if crash_after and sim.round_idx >= crash_after:
                # a hard kill: no drain, no tracker flush; recovery comes
                # from the last checkpoint alone
                print(f"SERVE_CRASHED round={sim.round_idx}", flush=True)
                os._exit(3)
    except KeyboardInterrupt:
        interrupted = True
        print(f"\ninterrupt: draining {k} in-flight round(s)", flush=True)
        coord.drain()
    acc = sim.evaluate(test)
    sim.tracker.finish(dict(rounds=sim.round_idx,
                            final_accuracy=round(float(acc), 4),
                            interrupted=interrupted))
    if ckpt_dir:
        coord.save(ckpt_dir)
    return acc


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--staleness", type=int, default=1,
                    help="pipeline depth K (0 = synchronous rounds)")
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--policy", default="token_bucket",
                    choices=sorted(registered_policies()))
    ap.add_argument("--deadline", type=float, default=2.0,
                    help="round deadline T (seconds); stragglers are cut "
                         "and HT-reweighted")
    ap.add_argument("--fault", default="markov",
                    choices=sorted(set(registered_faults()) - {"external"}),
                    help="availability model driving the client queue")
    ap.add_argument("--checkin-rate", type=float, default=0.7)
    ap.add_argument("--aggregator", default="mean",
                    choices=sorted(registered_aggregators()))
    ap.add_argument("--tracker", default="stdout",
                    choices=sorted(track.registered_trackers()),
                    help="streaming sink; jsonl/csv compose with stdout")
    ap.add_argument("--track-out", default="serve.jsonl",
                    help="output path for the jsonl/csv sink")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (enables checkpointing)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every N rounds (0 = final only)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint from --ckpt-dir "
                         "before serving")
    ap.add_argument("--crash-after", type=int, default=0,
                    help="simulate a hard kill after round N")
    ap.add_argument("--smoke", action="store_true",
                    help="2 tiny rounds, print SERVE_SMOKE_OK and exit")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()

    tracker = build_tracker(args.tracker, args.track_out)
    if args.smoke:
        coord, test = build_coordinator(
            n_clients=6, cohort=3, staleness=1, policy="token_bucket",
            deadline=2.0, fault=args.fault, checkin_rate=0.9,
            aggregator="mean", scale=0.05, tracker=tracker,
            device=args.device)
        if args.resume:
            coord.restore(args.ckpt_dir)
        serve(coord, test, rounds=max(2, args.rounds if args.crash_after
                                      or args.resume else 2),
              eval_every=2, ckpt_dir=args.ckpt_dir or None,
              ckpt_every=args.ckpt_every, crash_after=args.crash_after)
        print("SERVE_SMOKE_OK", flush=True)
        return

    coord, test = build_coordinator(
        args.clients, args.cohort, args.staleness, args.policy,
        args.deadline, args.fault, args.checkin_rate, args.aggregator,
        scale=0.15, tracker=tracker, device=args.device)
    if args.resume:
        coord.restore(args.ckpt_dir)
    acc = serve(coord, test, args.rounds, args.eval_every,
                ckpt_dir=args.ckpt_dir or None, ckpt_every=args.ckpt_every,
                crash_after=args.crash_after)
    print(f"final eval accuracy {acc:.3f}")


if __name__ == "__main__":
    main()
