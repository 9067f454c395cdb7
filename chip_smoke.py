#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero without the final `ok` line:
  1. device  — the card's name, count and power limit; TF32 off for
               matmuls and cuDNN convolutions (LeNet stays f32).
  2. build   — compiles every CUDA kernel from `src/repro_torch/kernels`.
  3. kernels — each kernel against its plain PyTorch version on the card at
               the main path's shapes, at K = 2 and at a ragged N; then
               device times (CUDA-graph replay, inputs rotated through more
               than the 50 MB L2) of the kernel, the plain version and, where
               one exists, a single PyTorch call computing the same function.
  4. slice   — the paper's experiment through the port's entry points:
               Dirichlet(0.1) cifar10 split, 40 clients, LeNet-5 (N = 62,006),
               FedNCV (beta = 0, and beta = 1 "fedncv-lit"), cohort 10, K = 4,
               micro_batch 16, local_epochs 2, 5 rounds on the card.  Checks
               the launch counts, finiteness, and the parameters against a
               CPU replay of the same draws through the plain versions.
  5. report  — one JSON line per kernel list, the card's name and power
               limit, then `{"ok": true, "device": {...}}` as the last line.

Imports nothing of JAX: the machine with the card has none.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
ROUNDS = 5
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-4   # card vs CPU replay after 5 rounds


def say(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def graph_ms(torch, fn, n_inputs, replays=20):
    """Device ms per call: one CUDA graph holding a call on each of the
    `n_inputs` rotating inputs, replayed `replays` times between events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up outside the capture
        for i in range(n_inputs):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_inputs):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * n_inputs)


def n_rotating(bytes_in: int) -> int:
    """Input copies to rotate through so each call finds its input out of
    the 50 MB L2 cache (at least 128 MB in all)."""
    return max(2, math.ceil(128e6 / bytes_in))


def require(cond, msg):
    """A check that also runs under `python -O`."""
    if not cond:
        raise AssertionError(msg)


def check_close(name, got, want, rtol, atol):
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max abs "
                             f"err {float(err.max()):.3e} (rtol {rtol}, atol "
                             f"{atol})")
    return float(err.max()) if err.numel() else 0.0


def kernel_phase(torch, K, ref):
    """Kernels against their plain versions; returns per-kernel reports."""
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen).cuda()
    reports = {}

    # -- rloo_combine: g (C, K, N), alpha (C,) ------------------------------
    errs = []
    for c, k, n in ((10, 4, 62006), (10, 2, 62006), (3, 3, 1000), (1, 5, 257)):
        g = rnd(c, k, n)
        alpha = torch.rand(c, generator=gen).cuda()
        mean, gp, s2 = K.rloo_combine(g, alpha)
        mean_r, gp_r, s2_r = ref.rloo_combine_ref(g, alpha)
        torch.cuda.synchronize()
        e = max(check_close("rloo mean", mean, mean_r, 1e-5, 1e-5),
                check_close("rloo gprime", gp, gp_r, 1e-5, 1e-5))
        check_close("rloo sumsq", s2, s2_r, 1e-4, 0.0)
        again = K.rloo_combine(g, alpha)
        require(all(torch.equal(a, b) for a, b in zip((mean, gp, s2), again)),
                "rloo_combine is not deterministic")
        errs.append(e)
        say(f"rloo_combine C={c} K={k} N={n}: max abs err {e:.3e} "
            f"(tol rtol 1e-5 atol 1e-5; sumsq rtol 1e-4) deterministic")
    c, k, n = 10, 4, 62006
    bytes_in = 4 * (c * k * n + c)
    gs = [rnd(c, k, n) for _ in range(n_rotating(bytes_in))]
    alpha = torch.rand(c, generator=gen).cuda()
    ms = graph_ms(torch, lambda i: K.rloo_combine(gs[i], alpha), len(gs))
    plain_ms = graph_ms(torch, lambda i: ref.rloo_combine_ref(gs[i], alpha),
                        len(gs))
    moved = bytes_in + 4 * (c * n + c * k * n + c)
    ops = 7 * c * k * n + c * n
    bound_ms, bound_by = max((moved / HBM_BYTES_PER_S * 1e3, "bytes"),
                             (ops / F32_OPS_PER_S * 1e3, "operations"))
    reports["rloo_combine"] = dict(
        name="rloo_combine", route="cuda",
        source="src/repro_torch/kernels/rloo/csrc/rloo.cu",
        replaces="src/repro/kernels/rloo/rloo.py:78",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)
    say(f"rloo_combine (C,K,N)=({c},{k},{n}): kernel_ms={ms:.5f} "
        f"bound_ms={bound_ms:.5f} ({bound_by}) plain_ms={plain_ms:.5f} "
        f"library_ms=none")

    # -- ncv_weighted_sum: g (M, N), w (M,) ----------------------------------
    errs = []
    for m, n in ((10, 62006), (2, 62006), (7, 1000), (1, 300)):
        g = rnd(m, n)
        w = torch.rand(m, generator=gen).cuda()
        agg, nrm = K.ncv_weighted_sum(g, w)
        agg_r, nrm_r = ref.ncv_weighted_sum_ref(g, w)
        torch.cuda.synchronize()
        e = check_close("wsum agg", agg, agg_r, 1e-5, 1e-5)
        check_close("wsum norm", nrm, nrm_r, 1e-4, 0.0)
        again = K.ncv_weighted_sum(g, w)
        require(torch.equal(agg, again[0]) and torch.equal(nrm, again[1]),
                "ncv_weighted_sum is not deterministic")
        errs.append(e)
        say(f"ncv_weighted_sum M={m} N={n}: max abs err {e:.3e} "
            f"(tol rtol 1e-5 atol 1e-5; norm rtol 1e-4) deterministic")
    m, n = 10, 62006
    bytes_in = 4 * (m * n + m)
    gs = [rnd(m, n) for _ in range(n_rotating(bytes_in))]
    w = torch.rand(m, generator=gen).cuda()
    ms = graph_ms(torch, lambda i: K.ncv_weighted_sum(gs[i], w), len(gs))
    plain_ms = graph_ms(torch, lambda i: ref.ncv_weighted_sum_ref(gs[i], w),
                        len(gs))
    library_ms = graph_ms(torch, lambda i: w @ gs[i], len(gs))
    moved = bytes_in + 4 * (n + 1)
    ops = 2 * m * n + 2 * n
    bound_ms, bound_by = max((moved / HBM_BYTES_PER_S * 1e3, "bytes"),
                             (ops / F32_OPS_PER_S * 1e3, "operations"))
    reports["ncv_weighted_sum"] = dict(
        name="ncv_weighted_sum", route="cuda",
        source="src/repro_torch/kernels/rloo/csrc/rloo.cu",
        replaces="src/repro/kernels/rloo/rloo.py:162",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms)
    say(f"ncv_weighted_sum (M,N)=({m},{n}): kernel_ms={ms:.5f} "
        f"bound_ms={bound_ms:.5f} ({bound_by}) plain_ms={plain_ms:.5f} "
        f"library_ms={library_ms:.5f} (w @ g)")
    return reports


def slice_phase(torch, np, K, card):
    """The paper's FedNCV round on the card; returns the launch counts of
    the main path's run (beta = 0)."""
    from repro_torch.data import federated_splits
    from repro_torch.fed import FLConfig, Simulator, Task
    from repro_torch.models import lenet

    t0 = time.perf_counter()
    spec, train, test = federated_splits("cifar10", n_clients=40, alpha=0.1,
                                         seed=0, scale=0.5)
    say(f"data: {len(train['labels'])} train / {len(test['labels'])} test "
        f"images, 40 clients ({time.perf_counter() - t0:.1f} s)")
    cfg = lenet.LeNetConfig(n_classes=spec.n_classes,
                            image_size=spec.image_size,
                            channels=spec.channels)
    task = Task(loss=lambda p, b: lenet.loss_fn(cfg, p, b),
                accuracy=lambda p, b: lenet.accuracy(cfg, p, b),
                head_keys=lenet.HEAD_KEYS)
    counts = None
    for label, beta in (("fedncv", 0.0), ("fedncv-lit", 1.0)):
        fl = FLConfig.make(method="fedncv", n_clients=40, cohort=10,
                           k_micro=4, micro_batch=16, server_lr=0.5,
                           local_lr=0.05, local_epochs=2, ncv_alpha0=0.3,
                           ncv_alpha_lr=1e-5, ncv_beta=beta)
        params0 = lenet.init(cfg, torch.Generator().manual_seed(0))
        # warm-up on a throwaway simulator (cuDNN plans, first launches)
        Simulator(task, params0, train, fl, seed=1).run_rounds(1)
        sim = Simulator(task, params0, train, fl, seed=0)
        draws = [sim._draw_cohort_sel() for _ in range(ROUNDS)]
        torch.cuda.synchronize()
        K.rloo_combine.launches = 0
        K.ncv_weighted_sum.launches = 0
        t0 = time.perf_counter()
        diags = sim.run_rounds(ROUNDS, draws=draws)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / ROUNDS
        launches = dict(rloo_combine=K.rloo_combine.launches,
                        ncv_weighted_sum=K.ncv_weighted_sum.launches)
        want = dict(rloo_combine=2 * ROUNDS, ncv_weighted_sum=ROUNDS)
        require(launches == want, f"{label}: launches {launches}, want {want}")
        if counts is None:
            counts = launches
        pre = sim.evaluate(test)
        post = sim.evaluate(test, personalize_steps=3)
        n_param = sum(v.numel() for v in sim.params.values())
        finite = all(bool(torch.isfinite(v).all()) for v in
                     sim.params.values()) and bool(
            torch.isfinite(sim.alphas).all()) and all(
            np.isfinite(v).all() for v in diags.values()) and \
            math.isfinite(pre) and math.isfinite(post)
        require(finite, f"{label}: non-finite params, alphas or diagnostics")
        require(n_param == 62006, f"{label}: {n_param} parameters")
        say(f"{label} (beta={beta}) on {card}: {ROUNDS} rounds, "
            f"sec_per_round={sec:.4f}, launches {launches}, "
            f"agg_norm={[float(x) for x in diags['agg_norm']]}, "
            f"bytes_up={float(diags['bytes_up'][0]):.0f}, pre={pre:.4f} "
            f"post={post:.4f}, mean alpha={float(sim.alphas.mean()):.6f}")

        # the same draws through the plain versions on the CPU
        cpu = Simulator(task, params0, train, fl, seed=0, device="cpu")
        cdiags = cpu.run_rounds(ROUNDS, draws=draws)
        worst = 0.0
        for key_, v in sim.params.items():
            worst = max(worst, check_close(f"{label} param {key_}",
                                           v.cpu(), cpu.params[key_],
                                           PARAM_RTOL, PARAM_ATOL))
        check_close(f"{label} alphas", sim.alphas.cpu(), cpu.alphas,
                    1e-5, 1e-7)
        np.testing.assert_allclose(diags["agg_norm"], cdiags["agg_norm"],
                                   rtol=1e-3)
        require(np.array_equal(diags["bytes_up"], cdiags["bytes_up"]),
                f"{label}: bytes_up differs from the CPU replay")
        cpre = cpu.evaluate(test)
        require(abs(cpre - pre) <= 1e-2,
                f"{label}: pre-test {pre} on the card, {cpre} on the CPU")
        say(f"{label}: card vs CPU replay: max param abs err {worst:.3e} "
            f"(tol rtol {PARAM_RTOL} atol {PARAM_ATOL}), pre {pre:.4f} vs "
            f"{cpre:.4f} (tol 1e-2), agg_norm rtol 1e-3, bytes_up equal")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels import build
    from repro_torch.kernels.rloo import ref
    from repro_torch.kernels.rloo import rloo as K

    say("== phase 1: device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"device {kind} x{count}; nvidia-smi: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    say("== phase 2: build")
    secs = build.build_all()
    for name, log in build.BUILD_LOG.items():
        for line in log.strip().splitlines():
            say(f"[nvcc {name}] {line}")
    say(f"build: {secs:.2f} s -> {build.BUILD_DIR}")

    say("== phase 3: kernels vs plain versions")
    reports = kernel_phase(torch, K, ref)

    say("== phase 4: slice")
    counts = slice_phase(torch, np, K, card)

    say("== phase 5: report")
    kernels = []
    for name in ("rloo_combine", "ncv_weighted_sum"):
        r = reports[name]
        kernels.append({**{k: r[k] for k in ("name", "route", "source",
                                             "replaces")},
                        "launches": counts[name],
                        **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms")}})
    say(json.dumps({"kernels": kernels}))
    say(smi_line())
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
