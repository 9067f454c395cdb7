"""Where the bf16 flash kernel's time goes, on the card.

    python3 benchmarks/port/flash_variants.py

Builds the bf16 flash kernel (`src/repro_torch/kernels/flash_attention/
csrc/flash_attention_bf16.cu`) as committed and as ablations that drop
one piece of its work, each into `build/flash_variants/` with the port's
nvcc flags, and times each one (CUDA-graph replay between CUDA events,
inputs rotated past the L2, as `chip_smoke.py` times kernels) at the
llama3.2-3b and gemma2-9b local prefill shapes, causal and not, with and
without the softcap, taking the variants in alternating order.  The
ablations compute wrong numbers on purpose and are never called by the
port:
  no_lo  — P.V with P's bf16 high half only (the second P.V of the split
           is dropped): what the split's extra tensor-core work costs.
Prints one line per shape: each variant's ms and its share of the bound
(the needed flops at 989 TFLOP/s).  Needs one card and nvcc; imports no
JAX.
"""
from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc"
OUT = ROOT / "build" / "flash_variants"
ABLATIONS = {
    "no_lo": ("    wgmma::wgmma_rs<HDP>(o, p_lo + 4 * kk, dv);\n", ""),
}
# (label, b, s, h, kv, hd, causal, window, softcap)
SHAPES = (
    ("llama3.2-3b", 2, 4096, 24, 8, 128, True, None, None),
    ("llama3.2-3b not causal", 2, 4096, 24, 8, 128, False, None, None),
    ("gemma2-9b local", 1, 8192, 16, 8, 256, True, 4096, 50.0),
    ("gemma2-9b local, no softcap", 1, 8192, 16, 8, 256, True, 4096, None),
)


def build_variants(build):
    """{name: the variant's C entry}, every variant built in parallel."""
    source = (CSRC / "flash_attention_bf16.cu").read_text()
    sources = {"kernel": source}
    for name, (old, new) in ABLATIONS.items():
        if old not in source:
            raise RuntimeError(f"ablation {name}: its line is not in the "
                               f"kernel any more")
        sources[name] = source.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text.replace('#include "wgmma.cuh"',
                                   f'#include "{CSRC / "wgmma.cuh"}"'))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(OUT / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        f = ctypes.CDLL(str(OUT / f"lib{name}.so")).flash_attention_bf16_fwd
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        f.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, cf, cf,
                      vp]
        f.restype = ci
        fns[name] = f
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.kernels import build

    fns = build_variants(build)
    print(C.smi_line())
    gen = torch.Generator().manual_seed(2)
    for n, (label, b, s, h, kv, hd, causal, window, softcap) in enumerate(
            SHAPES):
        bytes_in = 2 * b * s * hd * (h + 2 * kv)
        ins = [tuple(torch.randn(b, s, m, hd, generator=gen).bfloat16()
                     .cuda() for m in (h, kv, kv))
               for _ in range(C.n_rotating(bytes_in))]
        outs = [torch.empty_like(x[0]) for x in ins]
        bound_ms = 4 * hd * b * h * C.attn_pairs(s, causal, window) / \
            C.BF16_OPS_PER_S * 1e3
        order = list(fns.items())
        if n % 2:
            order.reverse()
        res = []
        for name, f in order:
            def call(i, f=f):
                q, k, v = ins[i]
                rc = f(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       outs[i].data_ptr(), b, s, s, h, kv, hd, int(causal),
                       0 if window is None else window,
                       0.0 if softcap is None else softcap,
                       1.0 / math.sqrt(hd),
                       torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: launch failed ({rc})")
            ms = C.graph_ms(torch, call, len(ins), replays=5)
            res.append(f"{name} {ms:.5f} ms ({bound_ms / ms:.3f} of the "
                       f"bound)")
        print(f"{label} (B,S,H,KV,hd)=({b},{s},{h},{kv},{hd}) causal="
              f"{causal} window={window} softcap={softcap}, bound "
              f"{bound_ms:.5f} ms: " + " | ".join(res), flush=True)
        del ins, outs
    return 0


if __name__ == "__main__":
    sys.exit(main())
