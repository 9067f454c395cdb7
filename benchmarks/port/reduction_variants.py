"""Where the one-launch reductions' time goes, on the card.

    python3 benchmarks/port/reduction_variants.py

Builds `ncv_weighted_sum` (`src/repro_torch/kernels/rloo/csrc/rloo.cu`) and
`rank_band_mean` (`src/repro_torch/kernels/robust/csrc/robust.cu`) as
committed and as probes that take one piece of their work away, and the
wire kernels `ncv_weighted_sum_q` / `_q4`
(`src/repro_torch/kernels/rloo/csrc/rloo_q.cu`) as committed and in their
first design (`benchmarks/port/csrc/rloo_q_two_launch.cu`: a thread a
code, per-block partials summed by a second launch), each into
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
The wire kernels run at the FL slice's shape (M 10, 122 chunks of 512) and
at 16,777,216 codes (32,768 chunks): the first design, then the committed
kernel forced to V = 4, 8 and 16 bytes a load (the wrapper's rule picks
one of them; the line names it).
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
TWO_LAUNCH = ROOT / "benchmarks/port/csrc/rloo_q_two_launch.cu"
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
    "rloo_q": ("rloo/csrc/rloo_q.cu", {}),
}
# (int4, M, chunks of 512): the FL slice's wire, and 16,777,216 codes
WIRE_SHAPES = ((False, 10, 122), (False, 10, 32768), (True, 10, 122),
               (True, 10, 32768))
WIRE_VECS = (4, 8, 16)
# (library, M, N): the FL shape, and 671 MB where bytes dominate
SHAPES = (("rloo", 10, 62006), ("rloo", 10, 16777216),
          ("robust", 10, 62006), ("robust", 10, 16777216))


def build_variants(build):
    """{library: {build: its library}}, every build compiled in parallel."""
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
        if lib == "rloo_q":
            sources["two_launch"] = TWO_LAUNCH.read_text()
        for name, text in sources.items():
            cu = OUT / f"{lib}_{name}.cu"
            cu.write_text(text)
            procs[lib, name] = subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                 str(OUT / f"lib{lib}_{name}.so"), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {lib: {} for lib in VARIANTS}
    for (lib, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{lib} {name} did not build:\n{log}")
        libs[lib][name] = ctypes.CDLL(str(OUT / f"lib{lib}_{name}.so"))
    return libs


def entry(so, lib, name=None, int4=False):
    """The C entry of a build, with its argument types."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if lib == "rloo":
        f = so.ncv_weighted_sum_f32
        f.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
    elif lib == "robust":
        f = so.rank_band_mean_f32
        f.argtypes = [vp, vp, vp, vp, cf, cf, vp, vp, vp, ci, ci, ci, ci,
                      ci, vp]
    else:
        f = so.ncv_weighted_sum_q4_u8 if int4 else so.ncv_weighted_sum_q_i8
        f.argtypes = ([vp, vp, vp, vp, vp, ci, ci, ci, vp]
                      if name == "two_launch" else
                      [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp])
    f.restype = ci
    return f


def wire_rows(torch, C, K, reduction, libs, gen, dev):
    """The wire kernels: the first design and the committed one at V = 4,
    8 and 16, alternating the order from shape to shape."""
    for k, (int4, m, c) in enumerate(WIRE_SHAPES):
        chunk = 512
        nb = c * chunk // (2 if int4 else 1)
        bytes_in = m * nb + 4 * m * c + 4 * m
        qs = [torch.randint(0, 256, (m, nb), device="cuda", generator=gen,
                            dtype=torch.int32).to(torch.uint8)
              for _ in range(C.n_rotating(bytes_in))]
        if not int4:
            qs = [q.view(torch.int8) for q in qs]
        sc = torch.rand(m, c, device="cuda", generator=gen) * 1e-2 + 1e-4
        w = torch.rand(m, device="cuda", generator=gen)
        rule, _ = K.wire_plan(qs[0], chunk, 2 if int4 else 1)
        bound_ms, bound_by = C.bound_of(bytes_in + 4 * (c * chunk + 1),
                                        4 * m * c * chunk + 2 * c * chunk)
        agg = torch.empty(c * chunk, device="cuda")
        nrm = torch.empty((), device="cuda")
        builds = [("two_launch", None)] + [(f"V={v}", v) for v in WIRE_VECS]
        if k % 2:
            builds.reverse()
        res = []
        for name, vec in builds:
            if vec is None:
                f = entry(libs["rloo_q"]["two_launch"], "rloo_q",
                          "two_launch", int4)
                parts = torch.empty(-(-nb // reduction.THREADS),
                                    device="cuda")
            else:
                f = entry(libs["rloo_q"]["kernel"], "rloo_q", None, int4)
                blocks = reduction.grid_blocks(nb // vec)
                parts = torch.empty(blocks, device="cuda")

            def call(i, f=f, vec=vec, parts=parts):
                stream = torch.cuda.current_stream()
                if vec is None:
                    rc = f(qs[i].data_ptr(), sc.data_ptr(), w.data_ptr(),
                           agg.data_ptr(), parts.data_ptr(), m, c, chunk,
                           stream.cuda_stream)
                    parts.sum()
                else:
                    rc = f(qs[i].data_ptr(), sc.data_ptr(), w.data_ptr(),
                           agg.data_ptr(), parts.data_ptr(), nrm.data_ptr(),
                           m, c, chunk, vec, reduction.grid_blocks(nb // vec),
                           reduction.ticket_slot(dev, stream),
                           stream.cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"rloo_q {name}: launch failed ({rc})")
            ms = C.graph_ms(torch, call, len(qs))
            res.append(f"{name} {ms:.5f} ms ({bound_ms / ms:.3f} of the "
                       f"bound)")
        print(f"{'ncv_weighted_sum_q4' if int4 else 'ncv_weighted_sum_q'} "
              f"(M,C,chunk)=({m},{c},{chunk}), the rule's V={rule}, bound "
              f"{bound_ms:.5f} ms ({bound_by}): " + " | ".join(res),
              flush=True)
        del qs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("reduction_variants: no CUDA device is available",
              file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.kernels import build, reduction
    from repro_torch.kernels.rloo import rloo as K
    from repro_torch.kernels.robust import robust as R

    libs = build_variants(build)
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
        order = [(name, entry(so, lib)) for name, so in libs[lib].items()]
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
    wire_rows(torch, C, K, reduction, libs, gen, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
