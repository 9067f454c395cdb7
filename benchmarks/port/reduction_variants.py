"""Where the one-launch reductions' time goes, on the card.

    python3 benchmarks/port/reduction_variants.py

Builds `ncv_weighted_sum` (`src/repro_torch/kernels/rloo/csrc/rloo.cu`) and
`rank_band_mean` (`src/repro_torch/kernels/robust/csrc/robust.cu`) as
committed and as probes that take one piece of their work away, each into
`build/reduction_variants/` with the port's nvcc flags, and times each one
(CUDA-graph replay between CUDA events, inputs rotated past the L2, as
`chip_smoke.py` times kernels), taking them in alternating order.  Beside
them, the launch floor: a 1-element `add_` timed the same way.  The probes
give wrong results on purpose and are never called by the port:
  partials_only — each block writes its partial of ||agg||^2 and stops: no
                  ticket, no last-block sum (what finishing the norm in the
                  launch costs);
  no_compare    — `rank_band_mean`'s register path with the comparisons
                  replaced by the row-order tie alone (the loads, the band
                  and the store without the M^2 work).
Prints one line per shape: each build's ms and its share of the bound
(bytes over 3.35 TB/s or operations over 67 TFLOP/s, as `chip_smoke.py`
counts them).  Needs one card and nvcc; imports no JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

KERNELS = ROOT / "src/repro_torch/kernels"
OUT = ROOT / "build" / "reduction_variants"
PARTIALS_ONLY = """  {
    __shared__ float red[kThreads / 32];
    const float part = reduction::block_sum<kThreads>(sq, red);
    if (threadIdx.x == 0) parts[blockIdx.x] = part;
  }
"""
GRID_SUM = "  reduction::grid_sum<kThreads>(sq, parts, slot, nrm);\n"
# library -> (its source, {probe: ((text in the source, its stand-in), ...)})
VARIANTS = {
    "rloo": ("rloo/csrc/rloo.cu", {
        "partials_only": ((GRID_SUM, PARTIALS_ONLY),),
    }),
    "robust": ("robust/csrc/robust.cu", {
        "partials_only": ((GRID_SUM, PARTIALS_ONLY),),
        "no_compare": (
            ("const bool below = v < u ? x[v][c] <= x[u][c] : "
             "x[v][c] < x[u][c];", "const bool below = v < u;"),),
    }),
}
# (library, M, N): the FL shape, and 671 MB where bytes dominate
SHAPES = (("rloo", 10, 62006), ("rloo", 10, 16777216),
          ("robust", 10, 62006), ("robust", 10, 16777216))


def build_variants(build):
    """{library: {build: its C entry}}, every build compiled in parallel."""
    procs = {}
    OUT.mkdir(parents=True, exist_ok=True)
    include = '#include "../../csrc/reduction.cuh"'
    header = KERNELS / "csrc/reduction.cuh"
    for lib, (src, probes) in VARIANTS.items():
        source = (KERNELS / src).read_text().replace(include,
                                                     f'#include "{header}"')
        sources = {"kernel": source}
        for name, changes in probes.items():
            text = source
            for old, new in changes:
                if old not in text:
                    raise RuntimeError(f"{lib} {name}: {old!r} is not in the "
                                       f"kernel any more")
                text = text.replace(old, new)
            sources[name] = text
        for name, text in sources.items():
            cu = OUT / f"{lib}_{name}.cu"
            cu.write_text(text)
            procs[lib, name] = subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                 str(OUT / f"lib{lib}_{name}.so"), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {lib: {} for lib in VARIANTS}
    for (lib, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{lib} {name} did not build:\n{log}")
        so = ctypes.CDLL(str(OUT / f"lib{lib}_{name}.so"))
        if lib == "rloo":
            f = so.ncv_weighted_sum_f32
            f.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        else:
            f = so.rank_band_mean_f32
            f.argtypes = [vp, vp, vp, vp, cf, cf, vp, vp, vp, ci, ci, ci, ci,
                          ci, vp]
        f.restype = ci
        fns[lib][name] = f
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("reduction_variants: no CUDA device is available",
              file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.kernels import build, reduction
    from repro_torch.kernels.robust import robust as R

    fns = build_variants(build)
    print(C.smi_line())
    print(f"launch floor: {C.launch_floor_ms(torch):.5f} ms a graph node")
    gen = torch.Generator(device="cuda").manual_seed(3)
    dev = torch.device("cuda", torch.cuda.current_device())
    for k, (lib, m, n) in enumerate(SHAPES):
        bytes_in = 4 * (m * n + m)
        gs = [torch.randn(m, n, device="cuda", generator=gen)
              for _ in range(C.n_rotating(bytes_in))]
        w = torch.rand(m, device="cuda", generator=gen)
        alive = torch.ones(m, device="cuda")
        vec = reduction.vector_width(n, gs[0])
        if lib == "rloo":
            blocks = reduction.grid_blocks(n // vec)
            ops = 2 * m * n + 2 * n
        else:
            p = R.plan(m, n, vec)
            vec, blocks = p.vec, p.blocks
            ops = C.rank_band_ops(m, n)
        bound_ms, bound_by = C.bound_of(bytes_in + 4 * (n + 1), ops)
        agg = torch.empty(n, device="cuda")
        nrm = torch.empty((), device="cuda")
        parts = torch.empty(blocks, device="cuda")
        order = list(fns[lib].items())
        if k % 2:
            order.reverse()
        res = []
        for name, f in order:
            def call(i, f=f, name=name):
                stream = torch.cuda.current_stream()
                slot = reduction.ticket_slot(dev, stream)
                if lib == "rloo":
                    rc = f(gs[i].data_ptr(), w.data_ptr(), agg.data_ptr(),
                           parts.data_ptr(), nrm.data_ptr(), m, n, vec,
                           blocks, slot, stream.cuda_stream)
                else:
                    rc = f(gs[i].data_ptr(), alive.data_ptr(), None, None,
                           2.0, m - 3.0, agg.data_ptr(), parts.data_ptr(),
                           nrm.data_ptr(), m, n, vec, blocks, slot,
                           stream.cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{lib} {name}: launch failed ({rc})")
            ms = C.graph_ms(torch, call, len(gs))
            res.append(f"{name} {ms:.5f} ms ({bound_ms / ms:.3f} of the "
                       f"bound)")
        print(f"{lib} (M,N)=({m},{n}), bound {bound_ms:.5f} ms ({bound_by}):"
              f" " + " | ".join(res), flush=True)
        del gs
    return 0


if __name__ == "__main__":
    sys.exit(main())
