"""Where the time of the port's LM serving slice goes, on one CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.profile_lm [--out DIR] \
        [--only ARCH ...]

For llama3.2-3b (28 layers), falcon-mamba-7b (64 layers), gemma2-9b cut
to 2 layers, llama4-scout-17b-a16e cut to 4 (one group of 3 chunked layers
and a global one), kimi-k2-1t-a32b cut to 1 (33.8 GB of bf16 experts a
layer), zamba2-7b (81 layers: 54 Mamba-2 blocks, 27 applications of the
shared attention block) and whisper-medium (24 encoder and 24 decoder
layers; 8 clips of 1,500 frames, the decoder's 448-token context), at
full width from random bf16 params: one prefill (the shapes
`chip_smoke.py` runs) and 8 decode steps at batch 8 after a 32-token
prompt (whisper's frames encoded into the cache first), each under
`torch.profiler` after a warm-up and an unprofiled timed run.  From the
exported trace it prints, per run: the host-clock wall time with and
without the profiler, the device's busy time
(the union of kernel intervals) and idle share against each wall time, the
kernel count, and the device time by kernel class (the port's two LM
kernels, matrix products, everything else) with the top kernels by name.
Writes one JSON object per run to `DIR/profile_lm.json` (default
`build/profile_lm/` at the root of the checkout, which git ignores).
Needs a card; there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch import configs
from repro_torch.launch.serve import prepare_cache
from repro_torch.launch.train import make_prefill_step, make_serve_step
from repro_torch.models import api

ROOT = Path(__file__).resolve().parents[3]


class Run(NamedTuple):
    """One model of the LM serving slice at full width, as this profile and
    `chip_smoke.py` both run it."""
    arch: str
    depth: int | None       # layers kept (None: all)
    batch: int              # prefill batch
    seq: int                # prefill length
    launches: dict          # {kernel: its launches per prefill}


FLASH, SCAN = "flash_attention", "selective_scan"
RUNS = (Run("llama3.2-3b", None, 2, 4096, {FLASH: 28}),
        Run("falcon-mamba-7b", None, 1, 2048, {SCAN: 64}),
        # depth cut to one local/global pair
        Run("gemma2-9b", 2, 1, 8192, {FLASH: 2}),
        # one global_period group; S two 8,192-token chunks, so each
        # chunked layer is one folded flash call
        Run("llama4-scout-17b-a16e", 4, 1, 16384, {FLASH: 4}),
        # one layer: two would leave no room for the activations
        Run("kimi-k2-1t-a32b", 1, 1, 2048, {FLASH: 1}),
        # falcon-mamba's prefill shape, so the two models' scans compare
        Run("zamba2-7b", None, 1, 2048, {SCAN: 54, FLASH: 27}),
        # 8 clips of 30 s (1,500 frames) and the decoder's 448-token
        # context: 24 encoder, 24 decoder self- and 24 cross-attention calls
        Run("whisper-medium", None, 8, 448, {FLASH: 72}))
DECODE_BATCH, PROMPT, DECODE_STEPS = 8, 32, 8


def setup(run: Run, dtype: str | None = None):
    """The run's config (in `dtype` if given), its random params from seed
    0 on the card, and the card's generator (seed 1) to draw tokens from."""
    cfg = configs.get(run.arch)
    if run.depth is not None:
        cfg = cfg.replace(n_layers=run.depth)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    params = api.init_params(cfg, torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    return cfg, params, torch.Generator(device="cuda").manual_seed(1)


def kernel_class(name: str) -> str:
    if "flash_fwd_kernel" in name or "flash_bf16_kernel" in name:
        return "flash_attention"
    if "scan_kernel" in name:
        return "selective_scan"
    low = name.lower()
    if any(t in low for t in ("gemm", "cutlass", "xmma", "gemv", "cublas",
                              "nvjet")):
        return "matmul"
    return "other"


def trace_summary(path: Path, wall_s: float) -> dict:
    """Device busy time and time by kernel from a chrome trace."""
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, float("-inf")
    for s, e in spans:                      # union of the intervals, in us
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    by_class, by_name = defaultdict(float), defaultdict(float)
    for e in kernels:
        by_class[kernel_class(e["name"])] += e["dur"]
        by_name[e["name"][:90]] += e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(wall_ms=wall_s * 1e3, busy_ms=busy / 1e3,
                idle_share=1.0 - busy / 1e3 / (wall_s * 1e3),
                n_kernels=len(kernels),
                by_class_ms={k: v / 1e3 for k, v in sorted(by_class.items())},
                top_ms=[(n, v / 1e3) for n, v in top])


def profiled(fn, trace: Path):
    """Summary of one profiled call of `fn`, after a warm-up call and one
    unprofiled timed call: the profiler's own host cost inflates the wall
    time of host-bound work, so the idle share is also given against the
    unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile
    fn()                                    # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace))
    out = trace_summary(trace, wall)
    out.update(unprofiled_wall_ms=plain_wall * 1e3,
               unprofiled_idle_share=1.0 - out["busy_ms"] / (plain_wall * 1e3))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "profile_lm"))
    ap.add_argument("--only", nargs="+", choices=[r.arch for r in RUNS],
                    help="profile these models only (default: every run)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_lm: no CUDA device is available", file=sys.stderr)
        return 2

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}")
    rows = []
    for run in RUNS:
        if args.only and run.arch not in args.only:
            continue
        arch, b, s = run.arch, run.batch, run.seq
        cfg, params, gen = setup(run)
        batch = api.make_batch(cfg, gen, b, s, device="cuda")
        prefill = make_prefill_step(cfg)
        row = dict(arch=arch, layers=cfg.n_layers, card=card)
        row["prefill"] = profiled(
            lambda: prefill(params, batch),
            out / f"trace_prefill_{arch}.json")
        row["prefill"].update(batch=b, seq=s)
        del batch
        dbatch = api.make_batch(cfg, gen, DECODE_BATCH, PROMPT, device="cuda")
        toks = dbatch["tokens"]
        step = make_serve_step(cfg)
        # `decode` runs three times (warm-up, timed, profiled)
        cache = prepare_cache(cfg, params, DECODE_BATCH,
                              PROMPT + 3 * DECODE_STEPS, "cuda",
                              dbatch.get("frames"))
        del dbatch
        for i in range(PROMPT):
            _, cache = step(params, cache, toks[:, i:i + 1], i)
        tok = toks[:, -1:]
        pos = [PROMPT]

        def decode():
            nonlocal tok
            for _ in range(DECODE_STEPS):
                logits, _ = step(params, cache, tok, pos[0])
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
                pos[0] += 1

        row["decode"] = profiled(decode,
                                 out / f"trace_decode_{arch}.json")
        row["decode"].update(batch=DECODE_BATCH, steps=DECODE_STEPS)
        rows.append(row)
        for phase in ("prefill", "decode"):
            r = row[phase]
            print(f"{arch} {phase} on {card}: wall {r['wall_ms']:.3f} ms "
                  f"profiled, {r['unprofiled_wall_ms']:.3f} ms not; device "
                  f"busy {r['busy_ms']:.3f} ms; idle share "
                  f"{r['idle_share']:.4f} profiled, "
                  f"{r['unprofiled_idle_share']:.4f} not; "
                  f"{r['n_kernels']} kernels; by class "
                  f"{json.dumps(r['by_class_ms'])}")
            for name, ms in r["top_ms"]:
                print(f"    {ms:10.3f} ms  {name}")
        del params, cache
        torch.cuda.empty_cache()
    (out / "profile_lm.json").write_text(json.dumps(rows, indent=1))
    for p in out.glob("trace_*.json"):
        os.remove(p)                        # large; the summary is kept
    return 0


if __name__ == "__main__":
    sys.exit(main())
