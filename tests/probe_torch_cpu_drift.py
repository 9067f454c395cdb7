"""CPU probes behind two parity findings of the port (not a test module).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/probe_torch_cpu_drift.py \
        first-call [--procs 48] [--par 8]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/probe_torch_cpu_drift.py \
        rounding
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/probe_torch_cpu_drift.py \
        quickstart-drift [--method fedavg] [--rounds 15]

first-call: fresh processes, each set up as the parity tests are (both
packages' `fed` imported, JAX's CPU client started by the reference's
LeNet init).  Each first runs the port's `lenet.loss_fn` and its gradient
(`torch.func.grad`, as the client pass takes it) twice on the same
batches: the per-example losses (`softmax_xent`'s `torch.logsumexp`, MKL's
`vmsExp` and `vmsLn` on the CPU), the mean loss and the gradient, at the
simulator tests' cohort batch (3 x 3 x 4 images, vmapped as the client
pass runs) and at one batch of 2,048 images (large enough for MKL to split
across threads); these are the process's first f32 exp and log calls.
Then LeNet's first stage (conv1, + b1, tanh) twice on the same tensors,
once through `torch.tanh` and once through the port's CPU tanh
(`models/lenet.py::_CPUTanh`).  Each reports the values whose first call
differs from the second, where they lie (a share of the OpenMP threads'
even split), each call's largest error against f64 tanh and, where the
first `torch.tanh` differed, whether MKL's `vmsTanh` in its LA, HA or EP
mode, called directly afterwards, gives the first or the second call's
bits.  The summary counts the processes that drifted.

rounding: the port's CPU tanh and `torch.tanh` against the correctly
rounded tanh (f64 tanh rounded to f32) over 1,200,001 values.

quickstart-drift: the quickstart twin's fedavg or fedncv run against the
reference's on its draws, round by round: the end-to-end margin and the
margin of one round started from the reference's state, max err /
(1e-5 + 1e-4 |x|), and, where a round goes past 0.1, the leaves it moves.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import ctypes, os, jax, numpy as np, torch, torch.nn.functional as F
from repro.fed import methods as _jm          # as the parity tests import
from repro_torch.fed import methods as _tm
from repro.models import lenet as jlenet
from repro_torch.models import lenet as tlenet
from repro_torch.weights import params_from_jax
p = params_from_jax(jax.tree.map(np.asarray, jlenet.init(
    jlenet.LeNetConfig(), jax.random.PRNGKey(0))))
# the loss first: its logsumexp makes the process's first f32 exp / log
from torch.func import grad, vmap
cfg = tlenet.LeNetConfig()
rng = np.random.default_rng(1)
def batch(*lead):
    return {"images": torch.from_numpy(rng.standard_normal(
                lead + (32, 32, 3)).astype(np.float32)),
            "labels": torch.from_numpy(rng.integers(0, 10, lead))}
loss = lambda q, b: tlenet.loss_fn(cfg, q, b)
per_example = lambda q, b: torch.logsumexp(
    tlenet.forward(cfg, q, b["images"].reshape(-1, 32, 32, 3)), dim=-1)
cohort, big = batch(3, 3, 4), batch(2048)
cohort_grad = vmap(vmap(grad(loss), in_dims=(None, 0)), in_dims=(None, 0))
flat = lambda t: torch.cat([v.reshape(-1) for v in
                            (t.values() if isinstance(t, dict) else [t])])
loss_rows = []
for name, fn, b in (("logsumexp cohort", per_example, cohort),
                    ("logsumexp 2048", per_example, big),
                    ("loss cohort", lambda q, b: vmap(vmap(
                        loss, in_dims=(None, 0)), in_dims=(None, 0))(q, b),
                     cohort),
                    ("loss 2048", loss, big),
                    ("grad cohort", cohort_grad, cohort),
                    ("grad 2048", grad(loss), big)):
    a, c = flat(fn(p, b)), flat(fn(p, b))
    loss_rows.append(f"{name}: {int((a != c).sum())} of {a.numel()} differ")
images = torch.from_numpy(np.random.default_rng(0).standard_normal(
    (6, 32, 32, 3)).astype(np.float32))
z = F.conv2d(images.permute(0, 3, 1, 2), p["conv1"].permute(3, 2, 0, 1)) \
    + p["b1"][:, None, None]
# the first f32 torch.tanh must be the process's first MKL tanh call (an
# f64 torch.tanh first would take it), so the f64 reference comes last
calls = {name: (fn(z), fn(z)) for name, fn in (
    ("torch.tanh", torch.tanh), ("port", tlenet._CPUTanh.apply))}
exact = torch.tanh(z.double())
mem = lambda t: t.permute(0, 2, 3, 1).reshape(-1)      # memory order
out = []
for name, (a, b) in calls.items():
    d = (mem(a) != mem(b)).nonzero().flatten()
    err = lambda t: float((t.double() - exact).abs().max())
    row = f"{name}: {len(d)} of {a.numel()} differ"
    if len(d):
        share = a.numel() // torch.get_num_threads()
        row += (f" in [{int(d.min())}, {int(d.max())}], thread shares "
                f"{sorted(set((d // share).tolist()))} of "
                f"{torch.get_num_threads()}")
        if name == "torch.tanh":
            lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__),
                                           "lib", "libtorch_cpu.so"))
            lib.vmsTanh.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_longlong]
            x = mem(z).contiguous()
            for mode, code in (("LA", 1), ("HA", 2), ("EP", 3)):
                r = torch.empty_like(x)
                lib.vmsTanh(x.numel(), x.data_ptr(), r.data_ptr(), code)
                row += (f"; vmsTanh {mode} == first "
                        f"{torch.equal(r[d], mem(a)[d])}, == second "
                        f"{torch.equal(r, mem(b))}")
    out.append(row + f"; max err vs f64: first {err(a):.3e}, second "
               f"{err(b):.3e}")
print(" | ".join(loss_rows + out))
"""


def first_call(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [v for v in [os.environ.get("PYTHONPATH")]
                               if v]))

    def one(_):
        r = subprocess.run([sys.executable, "-c", CHILD], env=env,
                           capture_output=True, text=True, timeout=600)
        return (r.stdout.strip().splitlines() or
                ["failed: " + r.stderr[-500:]])[-1]

    with ThreadPoolExecutor(args.par) as ex:
        rows = list(ex.map(one, range(args.procs)))
    drift = [r for r in rows if "torch.tanh: 0 of" not in r]
    port = [r for r in rows if "port: 0 of" not in r]
    loss = [r for r in rows if r.count(": 0 of") < 8]
    for r in drift + [r for r in port + loss if r not in drift]:
        print(r)
    print(f"{args.procs} processes ({args.par} at a time): torch.tanh's "
          f"first call differed in {len(drift)}, the port's CPU tanh in "
          f"{len(port)}, the port's loss, its per-example logsumexp or its "
          f"gradient in {len(loss)}")


def rounding(args):
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.models.lenet import _CPUTanh
    x = torch.cat([torch.linspace(-12, 12, 200001),
                   torch.randn(1000000, generator=torch.Generator()
                               .manual_seed(0)) * 2])
    exact = torch.tanh(x.double())
    cr = exact.float()
    for name, y in (("port", _CPUTanh.apply(x)), ("torch.tanh",
                                                  torch.tanh(x))):
        err = float((y.double() - exact).abs().max())
        print(f"{name}: {int((y != cr).sum())} of {x.numel()} values differ "
              f"from the correctly rounded tanh; max abs err {err:.3e}")


def quickstart_drift(args):
    import importlib.util

    import jax
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro.data import federated_splits as j_splits
    from repro.fed import FLConfig as JFLConfig, Simulator as JSimulator
    from repro.fed import Task as JTask
    from repro.models import lenet as jlenet
    from repro_torch.weights import params_from_jax

    spec_ = importlib.util.spec_from_file_location(
        "qs", ROOT / "examples" / "port" / "quickstart.py")
    qs = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(qs)
    spec, train, _ = j_splits("cifar10", n_clients=12, alpha=0.1, seed=0,
                              scale=0.15, noise=1.2, class_sep=0.8)
    jcfg = jlenet.LeNetConfig(n_classes=spec.n_classes,
                              image_size=spec.image_size,
                              channels=spec.channels)
    jtask = JTask(loss=lambda p, b: jlenet.loss_fn(jcfg, p, b),
                  accuracy=lambda p, b: jlenet.accuracy(jcfg, p, b),
                  head_keys=jlenet.HEAD_KEYS)
    jp = jlenet.init(jcfg, jax.random.PRNGKey(0))
    ncv = dict(ncv_alpha0=0.3, ncv_alpha_lr=1e-5, ncv_beta=0.0) \
        if args.method == "fedncv" else {}
    jsim = JSimulator(jtask, jp, train, JFLConfig.make(
        method=args.method, n_clients=12, cohort=6, k_micro=4,
        micro_batch=16, server_lr=0.5, local_lr=0.05, local_epochs=2,
        **ncv), seed=0)
    ttrain, _, task, _ = qs.make_world()
    fl = qs.make_config(args.method, "identity")
    port = lambda params: qs.Simulator(task, params, ttrain, fl, seed=0,
                                       device="cpu")
    tsim = port(params_from_jax(jax.tree.map(np.asarray, jp)))

    def margins(sim):
        return {k: np.abs(sim.params[k].numpy() - np.asarray(v)) / (
            1e-5 + 1e-4 * np.abs(np.asarray(v)))
            for k, v in jsim.params.items()}

    for i in range(args.rounds):
        kd = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0),
                                                 i))[0]
        idx, sel, *_ = jsim._draw_cohort_sel(jsim._get_state(), kd)
        draw = (np.asarray(idx), np.asarray(sel))
        one = port(params_from_jax(jax.tree.map(np.asarray, jsim.params)))
        if args.method == "fedncv":
            one._state["alphas"] = torch.from_numpy(np.array(jsim.alphas))
        one.run_round(draws=draw)
        jsim.run_round()
        tsim.run_round(draws=draw)
        m_one = margins(one)
        worst = max(float(m.max()) for m in m_one.values())
        print(f"round {i + 1}: end-to-end margin "
              f"{max(float(m.max()) for m in margins(tsim).values()):.4f}, "
              f"one round from the reference's state {worst:.4f}")
        if worst > 0.1:
            for k, m in m_one.items():
                err = np.abs(one.params[k].numpy() -
                             np.asarray(jsim.params[k]))
                print(f"    {k}: {int((m > 1).sum())} of {m.size} past the "
                      f"tolerance, max abs err {float(err.max()):.3e}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=("first-call", "rounding",
                                      "quickstart-drift"))
    ap.add_argument("--procs", type=int, default=48)
    ap.add_argument("--par", type=int, default=8)
    ap.add_argument("--method", default="fedavg", choices=("fedavg",
                                                           "fedncv"))
    ap.add_argument("--rounds", type=int, default=15)
    args = ap.parse_args()
    dict(first_call=first_call, rounding=rounding,
         quickstart_drift=quickstart_drift)[args.probe.replace("-", "_")](
        args)


if __name__ == "__main__":
    main()
