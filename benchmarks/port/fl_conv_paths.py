"""LeNet's convolutions on the card: cuDNN against the stacked-patch product.

    python3 benchmarks/port/fl_conv_paths.py

The port runs LeNet-5's two convolutions on the card as one f32 matrix
product over stacked patches (`models/lenet.py::_conv`); this script puts
that path beside `F.conv2d` through cuDNN (with the simulator's own flags:
deterministic algorithms, no TF32, no autotuning), on `chip_smoke.py`'s
world and `FL_KW`.  For each path and beta = 0, 1 it prints:
  - the 5-round card-vs-CPU margin (max of err / (1e-4 + 1e-3 |x|) against
    a CPU run of the same draws, which takes `F.conv2d` on the CPU either
    way), and whether two card runs are bitwise equal;
  - sec_per_round over 10 rounds, three times, the paths taken in turns
    (host clock, synchronised);
  - from torch.profiler over 2 rounds: device operations and device ms a
    round, and the three largest kernels by device time.
The cuDNN path is this script's own (it swaps `lenet._conv_pool`); the port
never takes it on the card.  Needs one card; imports no JAX.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmarks" / "port"))

ROUNDS = 5


def main() -> int:
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as C
    import fl_replay_drift as D
    from repro_torch.fed import FLConfig, Simulator
    from repro_torch.models import lenet

    if not torch.cuda.is_available():
        print("fl_conv_paths: no CUDA device is available", file=sys.stderr)
        return 2
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {C.smi_line()}; "
          f"torch {torch.__version__}", flush=True)
    stacked = lenet._conv_pool

    def cudnn(x, w, b):
        y = F.conv2d(x, w.permute(3, 2, 0, 1)) + b[:, None, None]
        return F.max_pool2d(torch.tanh(y), 2, 2)

    paths = {"cudnn": cudnn, "stacked": stacked}
    world = C.make_world(torch)
    try:
        for beta in (0.0, 1.0):
            fl = FLConfig.make(**C.FL_KW, ncv_beta=beta)
            sim = Simulator(world["task"], world["params0"], world["train"],
                            fl, seed=0, device="cpu")
            draws = [sim._draw_cohort_sel() for _ in range(ROUNDS)]
            lenet._conv_pool = stacked            # F.conv2d on the CPU
            cpu = D.trajectory(torch, world, fl, draws, "cpu")[-1]
            for name, pool in paths.items():
                lenet._conv_pool = pool
                runs = [D.trajectory(torch, world, fl, draws, "cuda")[-1]
                        for _ in range(2)]
                _, margin, at, _, _ = D.compare_to_cpu(torch, runs[0][0],
                                                       cpu[0])
                print(f"beta={beta} {name}: {ROUNDS}-round margin "
                      f"{margin:.4f} at {at[0]}{list(at[1])}; two card runs "
                      f"{'bitwise equal' if D.max_diff(*runs) == 0 else 'differ'}",
                      flush=True)
        fl = FLConfig.make(**C.FL_KW, ncv_beta=0.0)
        sims = {}
        for name, pool in paths.items():
            lenet._conv_pool = pool
            sims[name] = Simulator(world["task"], world["params0"],
                                   world["train"], fl, seed=1)
            sims[name].run_rounds(2)
        torch.cuda.synchronize()
        for rep in range(3):
            for name in (list(paths) if rep % 2 == 0 else list(paths)[::-1]):
                lenet._conv_pool = paths[name]
                t0 = time.perf_counter()
                sims[name].run_rounds(10)
                torch.cuda.synchronize()
                print(f"beta=0.0 {name}: sec_per_round "
                      f"{(time.perf_counter() - t0) / 10:.4f}", flush=True)
        for name, pool in paths.items():
            lenet._conv_pool = pool
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                sims[name].run_rounds(2)
                torch.cuda.synchronize()
            dev = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            by = {}
            for e in dev:
                by[e.name[:50]] = by.get(e.name[:50], 0.0) + e.device_time
            top = sorted(by.items(), key=lambda kv: -kv[1])[:3]
            print(f"beta=0.0 {name}: {len(dev) / 2:.0f} device operations "
                  f"and {sum(by.values()) / 2e3:.3f} device ms a round; "
                  f"largest: " + "; ".join(f"{k} {v / 2e3:.3f} ms"
                                           for k, v in top), flush=True)
    finally:
        lenet._conv_pool = stacked
    return 0


if __name__ == "__main__":
    sys.exit(main())
