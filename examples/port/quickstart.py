"""Quickstart on the port: FedNCV vs FedAvg on synthetic Dirichlet(0.1)
non-IID data, on the GPU.

    PYTHONPATH=src python examples/port/quickstart.py [--device cpu]
        [--sampler NAME] [--fault NAME] [--rounds N]

The twin of `examples/quickstart.py` on `repro_torch`: it trains LeNet-5
federatedly for 15 rounds (12 clients, cohort 6, K = 4 microbatches of 16,
cifar10 stand-in at scale 0.15) and prints the pre- and
post-personalization accuracy and the uploaded KiB a round of each run:
fedavg and fedncv over the identity wire, and fedncv over the int8 wire
and over the `topk` wire (ratio 0.16, with per-client error feedback).
`--sampler`, `--fault`,
`--tracker` and `--store` take the names the port has registered, except
`external`, whose tables a host program writes each round; a fault
model runs with its default options.  It runs on the CUDA
device unless `--device cpu` is given; without a card and without that
option it stops with an error.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.data import federated_splits
from repro_torch.fed import (FLConfig, Simulator, Task, registered_faults,
                             registered_samplers, registered_stores,
                             registered_trackers)
from repro_torch.models import lenet

ROUNDS = 15
RUNS = (("fedavg", "identity"), ("fedncv", "identity"), ("fedncv", "int8"),
        ("fedncv", "topk"))


def make_world():
    """The quickstart's data and task: (train, test, task, LeNet config)."""
    spec, train, test = federated_splits("cifar10", n_clients=12, alpha=0.1,
                                         seed=0, scale=0.15, noise=1.2,
                                         class_sep=0.8)
    cfg = lenet.LeNetConfig(n_classes=spec.n_classes,
                            image_size=spec.image_size,
                            channels=spec.channels)
    task = Task(loss=lambda p, b: lenet.loss_fn(cfg, p, b),
                accuracy=lambda p, b: lenet.accuracy(cfg, p, b),
                head_keys=lenet.HEAD_KEYS)
    return train, test, task, cfg


def make_config(method, codec, sampler="uniform", tracker="none",
                store="device", fault="none"):
    ncv_kw = dict(ncv_alpha0=0.3, ncv_alpha_lr=1e-5, ncv_beta=0.0) \
        if method == "fedncv" else {}
    opts = dict(ratio=0.16) if codec == "topk" else {}
    return FLConfig.make(method=method, n_clients=12, cohort=6, k_micro=4,
                         micro_batch=16, server_lr=0.5, codec=codec,
                         codec_opts=opts, sampler=sampler, local_lr=0.05,
                         local_epochs=2, tracker=tracker, store=store,
                         fault=fault, **ncv_kw)


def run(fl, task, params, train, rounds=ROUNDS, device=None, draws=None):
    """`rounds` rounds of `fl` from `params`; `draws` (a list of `rounds`
    (idx, sel[, u])) replays another run's draws.  Returns (simulator, the
    per-round diagnostics)."""
    sim = Simulator(task, params, train, fl, seed=0, device=device)
    return sim, sim.run_rounds(rounds, draws=draws)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--sampler", default="uniform",
                    choices=sorted(set(registered_samplers()) - {"external"}))
    ap.add_argument("--fault", default="none",
                    choices=sorted(set(registered_faults()) - {"external"}))
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--tracker", default="none",
                    choices=sorted(registered_trackers()))
    ap.add_argument("--store", default="device",
                    choices=sorted(registered_stores()))
    args = ap.parse_args()

    train, test, task, cfg = make_world()
    for method, codec in RUNS:
        params = lenet.init(cfg, torch.Generator().manual_seed(0))
        fl = make_config(method, codec, args.sampler, args.tracker,
                         args.store, args.fault)
        sim, diags = run(fl, task, params, train, args.rounds, args.device)
        pre = sim.evaluate(test)
        post = sim.evaluate(test, personalize_steps=3)
        kb_up = float(diags["bytes_up"][-1]) / 1024.0
        extra = ""
        if method == "fedncv":
            extra = f"  mean alpha_u={float(sim.alphas.mean()):.3f}"
        print(f"{method:8s} codec={codec:8s} pre-test={pre:.4f}  "
              f"post-test={post:.4f}  up={kb_up:8.1f} KiB/round{extra}")


if __name__ == "__main__":
    main()
