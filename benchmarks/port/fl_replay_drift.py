"""How far the card's FedNCV run drifts from itself and from a CPU replay.

    python3 benchmarks/port/fl_replay_drift.py [--settings LIST] [--rounds R]

Runs `chip_smoke.py`'s world (cifar10 stand-in, 40 clients, LeNet-5, N =
62,006) and its `FL_KW` for R (default 5) rounds of fedncv at beta = 0 and
beta = 1, from one set of draws: once on the CPU (`device="cpu"`), then three
times on the card under each setting of the process's flags in LIST
(comma-separated, default all four):

  default        PyTorch's defaults (cuDNN in TF32, nondeterministic
                 algorithms allowed);
  tf32_off       `cuda.matmul.allow_tf32` and `cudnn.allow_tf32` False;
  deterministic  tf32_off and `cudnn.deterministic` True;
  strict         deterministic and `torch.use_deterministic_algorithms(True)`,
                 in a child process with CUBLAS_WORKSPACE_CONFIG=:4096:8
                 (which cuBLAS needs then): a nondeterministic operation on
                 the path raises, and its message is printed.

After each round it prints, for each setting and beta:
  card_vs_card  the largest difference between the three card runs' params
                and alphas (0 means bitwise equal);
  card_vs_cpu   the largest error of the card's params against the CPU's;
  margin        max over elements and card runs of err / (1e-4 + 1e-3 |x|),
                x the CPU's value: `chip_smoke.py`'s 5-round replay check
                passes at margin <= 1;
  at            the parameter and element that set the margin;
  parted        the elements with |x| >= 1e-3 where the card and the CPU
                part by more than 1e-6 |x|.
At the first round where some element parts, the CPU run's max-pool windows
of that round (every client's K microbatches at the round's starting
params, both pooling stages) are searched for near-ties: windows whose two
largest inputs lie within 1e-6 of each other, relative.  The last lines say
whether the settings' card runs are bitwise equal to each other.

The simulator now runs its rounds under its own flags
(`utils.device.deterministic_f32`) and LeNet's convolutions on the card
as stacked-patch matrix products, so the process's settings no longer
reach the round: every setting gives the same bits.  On a tree from
before that change the settings show how far TF32 and cuDNN's algorithms
move the run (`PERF.md` §6 has both tables).

Needs one card; imports no JAX.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SETTINGS = ("default", "tf32_off", "deterministic", "strict")
CARD_RUNS = 3
PARTED_REL, PARTED_FLOOR = 1e-6, 1e-3
TIE_REL = 1e-6


def apply_setting(torch, name):
    """Set the process's flags for `name`; returns a function restoring
    them."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
             matmul.allow_tf32, torch.are_deterministic_algorithms_enabled())
    if name != "default":
        matmul.allow_tf32 = False
        cudnn.allow_tf32 = False
    if name in ("deterministic", "strict"):
        cudnn.deterministic = True
    if name == "strict":
        torch.use_deterministic_algorithms(True)

    def restore():
        (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
         matmul.allow_tf32, det) = saved
        torch.use_deterministic_algorithms(det)
    return restore


def trajectory(torch, world, fl, draws, device):
    """Params (on the CPU) and alphas after each round of one run."""
    from repro_torch.fed import Simulator

    sim = Simulator(world["task"], world["params0"], world["train"], fl,
                    seed=0, device=device)
    out = []
    for d in draws:
        sim.run_round(d)
        out.append(({k: v.detach().cpu().clone() for k, v in
                     sim.params.items()}, sim.alphas.detach().cpu().clone()))
    return out


def max_diff(a, b):
    pa, aa = a
    pb, ab = b
    return max([float((pa[k] - pb[k]).abs().max()) for k in pa] +
               [float((aa - ab).abs().max())])


def compare_to_cpu(torch, card, cpu):
    """(max abs err, margin, (param, element), parted, first) of card params
    against the CPU's: parted counts the elements with |cpu| >= PARTED_FLOOR
    where the two part by more than PARTED_REL relative, and first is the
    first of them (param, flat element, card, cpu) or None."""
    worst, margin, at, parted, first = 0.0, 0.0, ("-", ()), 0, None
    for k, x in cpu.items():
        err = (card[k] - x).abs()
        ratio = err / (1e-4 + 1e-3 * x.abs())
        i = int(ratio.argmax())
        worst = max(worst, float(err.max()))
        if float(ratio.flatten()[i]) > margin:
            margin = float(ratio.flatten()[i])
            at = (k, tuple(int(j) for j in torch.unravel_index(
                torch.tensor(i), x.shape)))
        part = (err > PARTED_REL * x.abs()) & (x.abs() >= PARTED_FLOOR)
        parted += int(part.sum())
        if first is None and bool(part.any()):
            i = int(part.flatten().nonzero()[0])
            first = (k, i, float(card[k].flatten()[i]), float(x.flatten()[i]))
    return worst, margin, at, parted, first


def pool_near_ties(torch, params, images):
    """Max-pool windows of LeNet's two stages whose two largest inputs lie
    within TIE_REL of each other, relative: (near-ties, windows) a stage."""
    import torch.nn.functional as F

    x = images.reshape((-1,) + tuple(images.shape[-3:])).permute(0, 3, 1, 2)
    found = []
    for w, b in (("conv1", "b1"), ("conv2", "b2")):
        a = torch.tanh(F.conv2d(x, params[w].permute(3, 2, 0, 1))
                       + params[b][:, None, None])
        win = F.unfold(a.reshape((-1, 1) + tuple(a.shape[-2:])), 2,
                       stride=2)                       # (B C, 4, windows)
        top = torch.topk(win, 2, dim=1).values
        gap = top[:, 0] - top[:, 1]
        found.append((int((gap <= TIE_REL * top[:, 0].abs()).sum()),
                      gap.numel()))
        x = F.max_pool2d(a, 2, 2)
    return found


def run(settings, rounds):
    import torch
    import chip_smoke as C
    from repro_torch.fed import FLConfig, Simulator

    if not torch.cuda.is_available():
        print("fl_replay_drift: no CUDA device is available", file=sys.stderr)
        return 2
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {C.smi_line()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    world = C.make_world(torch)
    finals = {}
    for beta in (0.0, 1.0):
        fl = FLConfig.make(**C.FL_KW, ncv_beta=beta)
        # the host generator's draws, the same whatever the device
        sim = Simulator(world["task"], world["params0"], world["train"], fl,
                        seed=0, device="cpu")
        draws = [sim._draw_cohort_sel() for _ in range(rounds)]
        cpu = trajectory(torch, world, fl, draws, "cpu")
        cpu_starts = [world["params0"]] + [p for p, _ in cpu[:-1]]
        for name in settings:
            restore = apply_setting(torch, name)
            try:
                runs = [trajectory(torch, world, fl, draws, "cuda")
                        for _ in range(CARD_RUNS)]
            except RuntimeError as e:
                print(f"beta={beta} {name}: the round raised: {e}",
                      flush=True)
                continue
            finally:
                restore()
            finals[beta, name] = runs[0][-1]
            tied = False
            for r in range(rounds):
                vs_card = max(max_diff(runs[0][r], t[r]) for t in runs[1:])
                res = [compare_to_cpu(torch, t[r][0], cpu[r][0])
                       for t in runs]
                worst = max(x[0] for x in res)
                margin, at = max(((x[1], x[2]) for x in res),
                                 key=lambda y: y[0])
                parted, first = res[0][3:]
                line = (f"beta={beta} {name} round {r + 1}: card_vs_card "
                        f"{vs_card:.3e} card_vs_cpu {worst:.3e} margin "
                        f"{margin:.4f} at {at[0]}{list(at[1])} parted "
                        f"{parted}" + (f" first {first}" if first else ""))
                if parted and not tied:
                    tied = True
                    images = torch.as_tensor(world["train"]["images"],
                                             dtype=torch.float32)
                    ties = pool_near_ties(torch, cpu_starts[r],
                                          images[draws[r][1]])
                    line += (f"; max-pool near-ties (rel {TIE_REL}) at the "
                             f"round's start: conv1 {ties[0][0]} of "
                             f"{ties[0][1]}, conv2 {ties[1][0]} of "
                             f"{ties[1][1]} windows")
                print(line, flush=True)
            print(f"beta={beta} {name}: after {rounds} rounds margin "
                  f"{margin:.4f} ({'passes' if margin <= 1 else 'fails'} "
                  f"chip_smoke's rtol {C.PARAM_RTOL} atol {C.PARAM_ATOL})",
                  flush=True)
    for beta in (0.0, 1.0):
        names = [n for n in settings if (beta, n) in finals]
        for a, b in zip(names, names[1:]):
            d = max_diff(finals[beta, a], finals[beta, b])
            print(f"beta={beta}: {a} vs {b} after {rounds} rounds: max diff "
                  f"{d:.3e}{' (bitwise equal)' if d == 0 else ''}",
                  flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--settings", default=",".join(SETTINGS))
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    settings = [s for s in args.settings.split(",") if s]
    bad = set(settings) - set(SETTINGS)
    if bad:
        ap.error(f"unknown settings {sorted(bad)}; choose from {SETTINGS}")
    rc = 0
    here = [s for s in settings if s != "strict"]
    if here:
        rc = run(here, args.rounds)
    if "strict" in settings and rc == 0:
        if os.environ.get("CUBLAS_WORKSPACE_CONFIG"):
            return run(["strict"], args.rounds)
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        rc = subprocess.run([sys.executable, __file__, "--settings", "strict",
                             "--rounds", str(args.rounds)], env=env).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
