#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, in order (each prints its seconds); any failure exits nonzero
without the final `ok` line:
  1. device  — the card's name, count and power limit; TF32 off for the
               process's matmuls and cuDNN convolutions (the LM paths; the
               FL simulator sets its own flags, which phase 4 checks).
  2. build   — compiles all six CUDA libraries from
               `src/repro_torch/kernels` (one `nvcc` each, in parallel); the
               bf16 flash kernel's registers and spill bytes (ptxas -v: none
               may spill) and its tensor-core instructions in the SASS
               (cuobjdump: HGMMA); the same spill check for the one-launch
               reductions (`ncv_weighted_sum`, the wire kernels
               `ncv_weighted_sum_q` / `_q4`, `rank_band_mean`).
  3. kernels — each kernel against its plain PyTorch version on the card at
               the main path's shapes and at other cohort sizes and ragged
               widths (ties and dead rows for `rank_band_mean`, whose band
               must also equal the row-order emulation bitwise, up to
               M = 2,000; lo and hi as values and as device tensors alike);
               the one-launch reductions bitwise equal over CUDA-graph
               replays and on two streams at once (the wire kernels at
               every shape they are checked at, each call also one device
               kernel and no copy under torch.profiler); the flash
               kernel at the llama3.2-3b and gemma2-9b prefill shapes (bf16
               and f32), the reference's sweep (f32), ragged S, and the bf16
               tensor-core kernel's head widths, GQA ratios, masks, short
               and ragged S and batch edges; the scan at falcon-mamba-7b's
               (1, 2048, 131072), the reference's sweep, a batch axis and
               ragged S.  Then device times (CUDA-graph replay, inputs
               rotated through more than the 50 MB L2) of the kernel, the
               plain version and, where one exists, a single PyTorch call
               computing the same function; the bf16 flash kernel must reach
               a quarter of its bound at the llama3.2-3b shape.  Beside
               them, a launch floor (a 1-element `add_` timed the same
               way), and `ncv_weighted_sum` (with `w @ g`), the wire
               kernels and `rank_band_mean` at 16,777,216 columns (codes)
               of 10 rows, where bytes dominate;
               `rank_band_mean` also at M = 256 and 2,000, where its
               pairwise comparisons take the time (their rate is printed
               beside the bound, which counts a sort's comparisons).
  4. slice   — the paper's experiment through the port's entry points:
               Dirichlet(0.1) cifar10 split, 40 clients, LeNet-5 (N = 62,006),
               FedNCV (beta = 0, and beta = 1 "fedncv-lit"), cohort 10, K = 4,
               micro_batch 16, local_epochs 2, 5 rounds on the card; then
               3 rounds each of the compressed wire (int8, int4, bf16) and of
               the robust aggregators (trimmed_mean, median over the int8
               wire, norm_clip).  Checks the launch counts, `bytes_up`,
               finiteness, and the parameters against a CPU replay of the
               same draws through the plain versions (with the margin, the
               largest err / (atol + rtol |x|)); the fedncv beta = 0 draws run
               on the card a second time with the process's
               cudnn.allow_tf32 and cudnn.benchmark True and must give the
               same bits.  Then the LM serving
               slice at full width from random bf16 params: llama3.2-3b
               (28 layers) prefill B 2 x S 4096, falcon-mamba-7b (64 layers)
               B 1 x S 2048, gemma2-9b cut to 2 layers (one local/global
               pair) B 1 x S 8192; after each prefill the serve loop (batch
               8, prompt 32, decode 64); then each model in f32, prefill
               logits against 64 teacher-forced decode steps.  Last, bf16
               llama3.2-3b logits at full width (2 layers, B 1 x S 4096)
               through the flash kernel against the same model with its
               attention taken by the plain version, each layer's
               attention held to the plain version, and an f32 control.
  5. report  — one JSON line per kernel list, the card's name and power
               limit, then `{"ok": true, "device": {...}}` as the last line.

Imports nothing of JAX: the machine with the card has none.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
ROUNDS = 5
WIRE_ROUNDS = 3                # rounds of each compressed-wire / robust run
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-4   # card vs CPU replay after 5 rounds
# kernel vs plain version: f32 sums in another order, atol scaled to output
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-5


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


def launch_floor_ms(torch):
    """Device ms of the smallest graph node: a 1-element `add_`, timed as
    the kernels are."""
    x = torch.zeros(1, device="cuda")
    return graph_ms(torch, lambda i: x.add_(1.0), 64)


def replay_check(name, call, inputs, replays=20):
    """`reduction.check_replays`: bitwise over graph replays and streams."""
    from repro_torch.kernels import reduction
    reduction.check_replays(call, inputs, replays)
    say(f"{name}: bitwise equal over {replays} graph replays and "
        f"{replays} x {len(inputs)} calls on {len(inputs)} streams at once")


def one_kernel_check(torch, name, fn, tag):
    """One call of `fn` is one device kernel (its name holding `tag`) and
    no memcpy or memset (torch.profiler's CUDA-side events)."""
    from torch.profiler import ProfilerActivity, profile
    fn()                                      # build, load, first launch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if len(ops) != 1 or tag not in ops[0] or any(
            "Memcpy" in o or "Memset" in o for o in ops):
        raise AssertionError(f"{name}: one call ran {ops}, want one {tag} "
                             f"kernel and no copy")
    say(f"{name}: one call is one device kernel, no memcpy or memset")


def require(cond, msg):
    """A check that also runs under `python -O`."""
    if not cond:
        raise AssertionError(msg)


def bound_of(moved_bytes, ops):
    return max((moved_bytes / HBM_BYTES_PER_S * 1e3, "bytes"),
               (ops / F32_OPS_PER_S * 1e3, "operations"))


def rank_band_ops(m, n):
    """Operations `rank_band_mean` needs on an (M, N) stack, whatever the
    algorithm: a sort of each coordinate's M values (M ceil(log2 M)
    comparisons), the band's test and sum per row, the mean and the norm
    per coordinate.  The kernel's pairwise ranks do 4 M^2 a coordinate;
    that is its own work, not the function's, so it sets no bound."""
    return n * (m * math.ceil(math.log2(m)) + 2 * m + 3)


def check_close(name, got, want, rtol, atol):
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max abs "
                             f"err {float(err.max()):.3e} (rtol {rtol}, atol "
                             f"{atol})")
    return float(err.max()) if err.numel() else 0.0


def kernel_phase(torch, K, ref, floor_ms):
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
    # the slice's shape, N = 1, 3 and 0 (mod 4) (float, float, float4
    # loads), more rows than one batch of loads in flight, 671 MB
    for m, n in ((10, 62006), (2, 62006), (7, 1000), (1, 300), (3, 4097),
                 (5, 1003), (40, 4096), (10, 16777216)):
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
    w10 = torch.rand(10, generator=gen).cuda()
    replay_check("ncv_weighted_sum",
                 lambda g: K.ncv_weighted_sum(g, w10),
                 [rnd(10, 62006), rnd(10, 62006)])
    cuda_gen = torch.Generator(device="cuda").manual_seed(0)
    for m, n in ((10, 62006), (10, 16777216)):
        bytes_in = 4 * (m * n + m)
        gs = [torch.randn(m, n, device="cuda", generator=cuda_gen)
              for _ in range(n_rotating(bytes_in))]
        w = torch.rand(m, generator=gen).cuda()
        ms = graph_ms(torch, lambda i: K.ncv_weighted_sum(gs[i], w), len(gs))
        library_ms = graph_ms(torch, lambda i: w @ gs[i], len(gs))
        moved = bytes_in + 4 * (n + 1)
        bound_ms, bound_by = bound_of(moved, 2 * m * n + 2 * n)
        say(f"ncv_weighted_sum (M,N)=({m},{n}), {moved} bytes: "
            f"kernel_ms={ms:.5f} bound_ms={bound_ms:.5f} ({bound_by}) "
            f"share of bound {bound_ms / ms:.3f}; library_ms={library_ms:.5f} "
            f"(w @ g, share {bound_ms / library_ms:.3f}); launch floor "
            f"{floor_ms:.5f}")
        if n == 62006:
            plain_ms = graph_ms(torch, lambda i: ref.ncv_weighted_sum_ref(
                gs[i], w), len(gs))
            reports["ncv_weighted_sum"] = dict(
                name="ncv_weighted_sum", route="cuda",
                source="src/repro_torch/kernels/rloo/csrc/rloo.cu",
                replaces="src/repro/kernels/rloo/rloo.py:162",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
            say(f"ncv_weighted_sum (M,N)=({m},{n}): plain_ms={plain_ms:.5f}")
        del gs
    return reports


def check_scaled(name, got, want):
    """Kernel vs plain version: rtol 1e-5, atol 1e-5 x max|want|."""
    scale = float(want.abs().max()) or 1.0
    check_close(name, got, want, KERNEL_RTOL, KERNEL_ATOL * scale)
    return float((got - want).abs().max()) if got.numel() else 0.0


def wire_kernel_phase(torch, K, R, ref, rref, comm, floor_ms):
    """The compressed-wire and robust kernels against their plain versions;
    returns per-kernel reports."""
    gen = torch.Generator().manual_seed(1)
    cuda_gen = torch.Generator(device="cuda").manual_seed(1)
    reports = {}

    def wire(name, m, n, chunk=512):
        """A cohort's (M, n) uploads on the codec's wire, encoded on the
        card as the simulator does."""
        codec = comm.get_codec(name, n=n, chunk=chunk)
        x = torch.randn(m, n, generator=gen).cuda() * \
            torch.rand(m, 1, generator=gen).cuda()
        u = torch.rand(codec.uniforms_shape(m), generator=gen).cuda()
        w, _ = codec.encode(x, None, u)
        return codec, w["q"], w["s"]

    def raw_wire(int4, m, c, chunk, offset=0):
        """A random (M, C*chunk) int8 or packed-int4 wire made on the card,
        its codes `offset` bytes past an aligned allocation (the kernels
        then take narrower loads), and its (M, C) scales."""
        nb = c * chunk // (2 if int4 else 1)
        lo, hi, dt = (0, 256, torch.uint8) if int4 else (-127, 128, torch.int8)
        flat = torch.randint(lo, hi, (m * nb + offset,), device="cuda",
                             generator=cuda_gen, dtype=torch.int32).to(dt)
        sc = torch.rand(m, c, device="cuda", generator=cuda_gen) * 1e-2 + 1e-4
        return flat[offset:].view(m, nb), sc

    for kname, cname, kern, plain, replaces, tag in (
            ("ncv_weighted_sum_q", "int8", K.ncv_weighted_sum_q,
             ref.ncv_weighted_sum_q_ref,
             "src/repro/kernels/rloo/rloo.py:233", "wsum_q_i8"),
            ("ncv_weighted_sum_q4", "int4", K.ncv_weighted_sum_q4,
             ref.ncv_weighted_sum_q4_ref,
             "src/repro/kernels/rloo/rloo.py:308", "wsum_q4_u8")):
        int4 = cname == "int4"
        errs = []
        # the slice's shapes, bench_faults' full participation, the
        # smallest cohort, a larger one, a chunk that is no power of two
        # (narrower loads), codes 1 and 8 bytes off alignment (1- and
        # 8-byte loads), and 16,777,216 codes, where bytes dominate
        for m, n, chunk, offset in ((10, 62006, 512, None),
                                    (12, 62006, 512, None),
                                    (2, 62006, 512, None),
                                    (40, 62006, 512, None),
                                    (7, 1299, 100, None), (10, 62006, 512, 1),
                                    (10, 62006, 512, 8),
                                    (10, 16777216, 512, 0)):
            if offset is None:
                ins = [wire(cname, m, n, chunk)[1:] for _ in range(2)]
            else:
                ins = [raw_wire(int4, m, -(-n // chunk), chunk, offset)
                       for _ in range(2)]
            q, sc = ins[0]
            c = sc.shape[1]
            vec, blocks = K.wire_plan(q, chunk, 2 if int4 else 1)
            w = (torch.rand(m, generator=gen) - 0.2).cuda()
            agg, nrm = kern(q, sc, w, chunk=chunk)
            agg_r, nrm_r = plain(q, sc, w, chunk=chunk)
            torch.cuda.synchronize()
            e = check_scaled(f"{kname} agg", agg, agg_r)
            check_close(f"{kname} norm", nrm, nrm_r, 1e-4, 0.0)
            again = kern(q, sc, w, chunk=chunk)
            require(torch.equal(agg, again[0]) and torch.equal(nrm, again[1]),
                    f"{kname} is not deterministic")
            errs.append(e)
            label = f"{kname} M={m} C={c} chunk={chunk} V={vec} blocks={blocks}"
            say(f"{label}: max abs err {e:.3e} (tol rtol {KERNEL_RTOL} atol "
                f"{KERNEL_ATOL} x max|agg|; norm rtol 1e-4) deterministic")
            replay_check(label, lambda x: kern(x[0], x[1], w, chunk=chunk),
                         ins)
            one_kernel_check(torch, label, lambda: kern(q, sc, w,
                                                        chunk=chunk), tag)
            del ins, q, sc, agg, agg_r, again
        for m, c, chunk in ((10, 122, 512), (10, 32768, 512)):
            n_bytes = m * c * chunk // (2 if int4 else 1)
            bytes_in = n_bytes + 4 * m * c + 4 * m
            ins = [raw_wire(int4, m, c, chunk)
                   for _ in range(n_rotating(bytes_in))]
            w = torch.rand(m, generator=gen).cuda()
            ms = graph_ms(torch, lambda i: kern(*ins[i], w), len(ins))
            if c == 122:
                plain_ms = graph_ms(torch, lambda i: plain(*ins[i], w),
                                    len(ins))
            else:                      # gigabytes of temporaries a call
                plain_ms = event_ms(torch, lambda i: plain(*ins[i], w),
                                    len(ins))
            moved = bytes_in + 4 * (c * chunk + 1)
            # per code: convert, scale, weight, add; the norm's square-add
            bound_ms, bound_by = bound_of(moved,
                                          4 * m * c * chunk + 2 * c * chunk)
            if c == 122:
                reports[kname] = dict(
                    name=kname, route="cuda",
                    source="src/repro_torch/kernels/rloo/csrc/rloo_q.cu",
                    replaces=replaces, max_abs_err=max(errs), ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=None)
            say(f"{kname} (M,C,chunk)=({m},{c},{chunk}) V="
                f"{K.wire_plan(ins[0][0], chunk, 2 if int4 else 1)[0]}, "
                f"{moved} bytes: kernel_ms={ms:.5f} bound_ms={bound_ms:.5f} "
                f"({bound_by}) share of bound {bound_ms / ms:.3f}; "
                f"plain_ms={plain_ms:.5f}; library_ms=none (no single "
                f"call); launch floor {floor_ms:.5f}")
            del ins

    # -- rank_band_mean: g (M, N), alive (M,), {lo, hi} on the device -------
    def stack(m, n, ties):
        g = torch.randn(m, n, generator=gen)
        if ties:                          # a coarse grid: many ties
            g = torch.round(g * 4.0) / 4.0
        return g.cuda()

    errs = []
    for m, n, ties, dead in ((10, 62006, False, ()), (10, 62006, True, (3,)),
                             (12, 62006, True, (0, 5)), (2, 62006, True, ()),
                             (256, 62006, True, (1, 100, 255)),
                             (33, 4099, True, (7, 8)),
                             (2000, 777, True, (0, 999, 1999))):
        g = stack(m, n, ties)
        alive = torch.ones(m)
        alive[list(dead)] = 0.0
        alive = alive.cuda()
        m_v = m - len(dead)
        k, mid = min(1, (m_v - 1) // 2), (m_v - 1) // 2
        for lo, hi in ((k, m_v - 1 - k), (mid, m_v - 1 - mid)):
            lo_t = torch.tensor(float(lo), device="cuda")
            hi_t = torch.tensor(float(hi), device="cuda")
            agg, nrm = R.rank_band_mean(g, alive, lo_t, hi_t)
            agg_r, nrm_r = rref.rank_band_mean_ref(g, alive, lo_t, hi_t)
            row, _ = rref.rank_band_mean_rowwise(g, alive, lo_t, hi_t)
            torch.cuda.synchronize()
            e = check_scaled("rank_band_mean", agg, agg_r)
            check_close("rank_band_mean norm", nrm, nrm_r, 1e-4, 1e-6)
            require(torch.equal(agg, row), f"rank_band_mean M={m}: not "
                    f"bitwise the row-order emulation")
            again = R.rank_band_mean(g, alive, lo_t, hi_t)
            require(torch.equal(agg, again[0]) and torch.equal(nrm, again[1]),
                    "rank_band_mean is not deterministic")
            values = R.rank_band_mean(g, alive, float(lo), float(hi))
            require(torch.equal(agg, values[0]) and
                    torch.equal(nrm, values[1]),
                    "rank_band_mean: lo, hi as values differ from tensors")
            errs.append(e)
        say(f"rank_band_mean M={m} N={n} ties={ties} dead={len(dead)} "
            f"({R.plan(m, n).path}): max abs err {max(errs[-2:]):.3e} "
            f"(tol rtol {KERNEL_RTOL} atol {KERNEL_ATOL} x max|agg|; norm "
            f"rtol 1e-4); bitwise the row-order emulation; deterministic; "
            f"lo, hi as values or tensors alike")
    for m in (10, 40):
        alive = torch.ones(m, device="cuda")
        lo_t = torch.tensor(2.0, device="cuda")
        hi_t = torch.tensor(m - 3.0, device="cuda")
        replay_check(f"rank_band_mean M={m} ({R.plan(m, 62006).path})",
                     lambda g: R.rank_band_mean(g, alive, lo_t, hi_t),
                     [stack(m, 62006, True), stack(m, 62006, False)])
    # trimmed_mean's band at trim_frac 0.25 and m = 10: ranks 2..7; then
    # bytes at 671 MB, and the panel path, whose pairwise comparisons
    # outgrow the loads from M of about 200 on
    for m, n, replays in ((10, 62006, 20), (10, 16777216, 20),
                          (256, 62006, 5), (2000, 62006, 2)):
        bytes_in = 4 * (m * n + m + 2)
        gs = [torch.randn(m, n, device="cuda", generator=cuda_gen)
              for _ in range(n_rotating(bytes_in))]
        alive = torch.ones(m, device="cuda")
        lo_t = torch.tensor(float(m // 4 if m > 10 else 2), device="cuda")
        hi_t = m - 1 - lo_t
        ms = graph_ms(torch, lambda i: R.rank_band_mean(gs[i], alive, lo_t,
                                                         hi_t), len(gs),
                      replays=replays)
        moved = bytes_in + 4 * (n + 1)
        bound_ms, bound_by = bound_of(moved, rank_band_ops(m, n))
        # the pairwise ranks' own work (two compares, a multiply and an
        # add a pair of rows): a rate, not a bound
        pair_rate = 4 * m * m * n / (ms * 1e-3)
        say(f"rank_band_mean (M,N)=({m},{n}) {R.plan(m, n).path}, {moved} "
            f"bytes: kernel_ms={ms:.5f} bound_ms={bound_ms:.5f} ({bound_by}) "
            f"share of bound {bound_ms / ms:.3f}; pairwise work "
            f"{pair_rate / 1e12:.2f} Tops/s ({pair_rate / F32_OPS_PER_S:.3f} "
            f"of the f32 peak); launch floor {floor_ms:.5f}")
        if (m, n) == (10, 62006):
            plain_ms = graph_ms(torch, lambda i: rref.rank_band_mean_ref(
                gs[i], alive, lo_t, hi_t), len(gs))
            reports["rank_band_mean"] = dict(
                name="rank_band_mean", route="cuda",
                source="src/repro_torch/kernels/robust/csrc/robust.cu",
                replaces="src/repro/kernels/robust/robust.py:63",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
            say(f"rank_band_mean (M,N)=({m},{n}): plain_ms={plain_ms:.5f} "
                f"library_ms=none (no single call)")
        del gs
    return reports


def make_world(torch):
    """The slice's data, model and task: `benchmarks/bench_fl.py`'s
    protocol (cifar10 stand-in at scale 0.5, Dirichlet(0.1), 40 clients)."""
    from repro_torch.data import federated_splits
    from repro_torch.fed import Task
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
    params0 = lenet.init(cfg, torch.Generator().manual_seed(0))
    return dict(train=train, test=test, task=task, params0=params0)


# the slice's FedNCV options (bench_fl's protocol, the quickstart's alpha)
FL_KW = dict(method="fedncv", n_clients=40, cohort=10, k_micro=4,
             micro_batch=16, server_lr=0.5, local_lr=0.05, local_epochs=2,
             ncv_alpha0=0.3, ncv_alpha_lr=1e-5)


def slice_phase(torch, np, K, card, world):
    """The paper's FedNCV round on the card; returns the launch counts of
    the main path's run (beta = 0)."""
    from repro_torch.fed import FLConfig, Simulator

    train, test, task = world["train"], world["test"], world["task"]
    params0 = world["params0"]
    counts = None
    for label, beta in (("fedncv", 0.0), ("fedncv-lit", 1.0)):
        fl = FLConfig.make(**FL_KW, ncv_beta=beta)
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

        if beta == 0.0:
            # the simulator fixes its own numerics flags and LeNet's card
            # convolutions bypass cuDNN: the same draws with the process
            # asking for TF32 and autotuning give the same bits
            cudnn = torch.backends.cudnn
            saved = cudnn.allow_tf32, cudnn.benchmark
            cudnn.allow_tf32, cudnn.benchmark = True, True
            try:
                rerun = Simulator(task, params0, train, fl, seed=0)
                rerun.run_rounds(ROUNDS, draws=draws)
                torch.cuda.synchronize()
            finally:
                cudnn.allow_tf32, cudnn.benchmark = saved
            require(all(torch.equal(v, rerun.params[k])
                        for k, v in sim.params.items()) and
                    torch.equal(sim.alphas, rerun.alphas),
                    f"{label}: a second card run of the same draws (process "
                    f"cudnn.allow_tf32 and cudnn.benchmark True) differs")
            say(f"{label}: a second card run of the same draws, with the "
                f"process's cudnn.allow_tf32 and cudnn.benchmark True: params "
                f"and alphas bitwise equal")

        # the same draws through the plain versions on the CPU
        cpu = Simulator(task, params0, train, fl, seed=0, device="cpu")
        cdiags = cpu.run_rounds(ROUNDS, draws=draws)
        # max over elements of err / (atol + rtol |x|): the check passes at
        # a margin of at most 1
        margin = max(float(((v.cpu() - cpu.params[k]).abs() / (
            PARAM_ATOL + PARAM_RTOL * cpu.params[k].abs())).max())
            for k, v in sim.params.items())
        say(f"{label}: card vs CPU replay margin {margin:.4f}")
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
        say(f"{label}: card vs CPU replay: max param abs err {worst:.3e}, "
            f"margin {margin:.4f} (tol rtol {PARAM_RTOL} atol {PARAM_ATOL}: "
            f"margin <= 1), pre {pre:.4f} vs "
            f"{cpre:.4f} (tol 1e-2), agg_norm rtol 1e-3, bytes_up equal")
    return counts


# the compressed wire and the robust aggregators at full width, beta = 0 as
# benchmarks/bench_comm.py and bench_faults.py run them: (label, options,
# the kernel that carries the run's server reduction, once a round)
WIRE_RUNS = (
    ("fedncv-int8", dict(codec="int8"), "ncv_weighted_sum_q"),
    ("fedncv-int4", dict(codec="int4"), "ncv_weighted_sum_q4"),
    ("fedncv-bf16", dict(codec="bf16"), "ncv_weighted_sum"),
    ("trimmed_mean", dict(aggregator="trimmed_mean", trim_frac=0.25),
     "rank_band_mean"),
    ("median-int8", dict(aggregator="median", codec="int8"),
     "rank_band_mean"),
    ("norm_clip", dict(aggregator="norm_clip"), "ncv_weighted_sum"),
)
# bytes_up at cohort 10: cohort x (codec.bytes_per_client() + FedNCV's 16
# aux bytes), for N = 62,006 (122 chunks of 512)
BYTES_UP = {"identity": 2480400, "bf16": 1240280, "int8": 625100,
            "int4": 315070}
# the same accounting at cohort 6, as BENCH_comm.json records it
BYTES_UP_COHORT6 = {"identity": 1488240, "int8": 375060, "int4": 189042}
# card vs CPU uploads from the same state: the share of values allowed off
# the replay tolerance (stochastic rounding where x/scale + u sits within
# f32 noise of an integer, max-pool near-ties; a wrong codec or client pass
# would move most of them)
MAX_OFF_SHARE = 1e-2


def compare_uploads(codec, card, cpu, label):
    """The card's and the CPU's uploads of one round from the same state,
    as the server decodes them: within the replay tolerance except for a
    rare share that a discontinuity moves (a rounding step of the codec, a
    max-pool window whose two largest inputs swap).  Returns (values off
    the tolerance, values compared)."""
    from repro_torch.utils.tree_math import ravel_stack

    if codec.name == "identity":
        a, b = ravel_stack(card)[0].cpu(), ravel_stack(cpu)[0]
    else:
        a = codec.decode({k: v.cpu() for k, v in card.items()})
        b = codec.decode(cpu)
    err = (a - b).abs()
    off = err > PARAM_ATOL + PARAM_RTOL * b.abs()
    n_off = int(off.sum())
    require(n_off <= MAX_OFF_SHARE * off.numel(),
            f"{label}: {n_off} of {off.numel()} uploaded values off the "
            f"tolerance (max abs err {float(err.max()):.3e})")
    return n_off, off.numel()


def wire_slice_phase(torch, np, kernels, card, world):
    """The compressed wire and the robust aggregators on the card; returns
    the launch count of each run's server kernel, from the first run that
    uses it."""
    from repro_torch import comm
    from repro_torch.fed import FLConfig, Simulator
    from repro_torch.utils.tree_math import tree_map

    class Recording(Simulator):
        """Keeps, by reference, each round's starting params and state and
        the output of its client section (the uploads on the wire), so the
        CPU replay can start each round where the card did."""

        def _client_section_local(self, params, state, draws):
            pending = super()._client_section_local(params, state, draws)
            self.record.append((params, state, pending))
            return pending

    for name, want in BYTES_UP_COHORT6.items():
        got = 6 * (comm.get_codec(name, n=62006).bytes_per_client() + 16)
        require(got == want, f"{name}: bytes_up at cohort 6 is {got}, "
                             f"BENCH_comm.json has {want}")
    train, test, task = world["train"], world["test"], world["task"]
    params0 = world["params0"]
    counts = {}
    for label, kw, kname in WIRE_RUNS:
        fl = FLConfig.make(**FL_KW, ncv_beta=0.0, **kw)
        # warm-up on a throwaway simulator (cuDNN plans, first launches)
        Simulator(task, params0, train, fl, seed=1).run_rounds(1)
        sim = Recording(task, params0, train, fl, seed=0)
        sim.record = []
        draws = [sim.draw_round() for _ in range(WIRE_ROUNDS)]
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        diags = sim.run_rounds(WIRE_ROUNDS, draws=draws)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / WIRE_ROUNDS
        launches = {n: fn.launches for n, fn in kernels.items()}
        want = {n: 0 for n in kernels}
        want["rloo_combine"] = 2 * WIRE_ROUNDS
        want[kname] = WIRE_ROUNDS
        require(launches == want, f"{label}: launches {launches}, want "
                                  f"{want}")
        counts.setdefault(kname, launches[kname])
        require(all(float(b) == BYTES_UP[fl.codec]
                     for b in diags["bytes_up"]),
                f"{label}: bytes_up {diags['bytes_up']}, want "
                f"{BYTES_UP[fl.codec]}")
        pre = sim.evaluate(test)
        finite = all(bool(torch.isfinite(v).all()) for v in
                     sim.params.values()) and all(
            np.isfinite(v).all() for v in diags.values()) and \
            math.isfinite(pre)
        require(finite, f"{label}: non-finite params or diagnostics")
        say(f"{label} on {card}: {WIRE_ROUNDS} rounds, sec_per_round="
            f"{sec:.4f}, launches {launches}, bytes_up="
            f"{float(diags['bytes_up'][0]):.0f}, agg_norm="
            f"{[float(x) for x in diags['agg_norm']]}, pre={pre:.4f}")

        # the same draws through the plain versions on the CPU, each round
        # from the card's starting state; the CPU's uploads are held to the
        # card's, and its server section takes the card's uploads, so a
        # single rounding step cannot carry over into later rounds
        cpu = Simulator(task, params0, train, fl, seed=0, device="cpu")
        worst, n_off, n_vals = 0.0, 0, 0
        to_cpu = lambda tree: tree_map(lambda x: x.cpu(), tree)  # noqa: E731
        for i, (p_card, st_card, pend_card) in enumerate(sim.record):
            cpu.params, cpu._state = to_cpu(p_card), to_cpu(dict(st_card))
            idx, sel, u = draws[i]
            pend = cpu._client_section_local(
                cpu.params, cpu._state,
                (idx, sel, None if u is None else u.cpu()))
            off, nv = compare_uploads(sim.codec, pend_card["grads"],
                                     pend["grads"], f"{label} round {i}")
            n_off, n_vals = n_off + off, n_vals + nv
            for k in ("mean_norm_sq", "sum_norm_sq"):
                check_close(f"{label} {k}", pend_card["aux"][k].cpu(),
                            pend["aux"][k], PARAM_RTOL, 0.0)
            pend["grads"] = to_cpu(pend_card["grads"])
            cpu.params, cpu._state, cdiag = cpu._server_section(
                cpu.params, cpu._state, pend, i + 1)
            after = sim.record[i + 1] if i + 1 < len(sim.record) else (
                sim.params, sim._state)
            for key_, v in after[0].items():
                worst = max(worst, check_close(
                    f"{label} round {i} param {key_}", v.cpu(),
                    cpu.params[key_], PARAM_RTOL, PARAM_ATOL))
            check_close(f"{label} alphas", after[1]["alphas"].cpu(),
                        cpu.alphas, 1e-5, 1e-7)
            np.testing.assert_allclose(diags["agg_norm"][i],
                                       float(cdiag["agg_norm"]), rtol=1e-3)
            require(float(cdiag["bytes_up"]) == float(diags["bytes_up"][i]),
                    f"{label}: bytes_up differs from the CPU replay")
        cpre = cpu.evaluate(test)
        require(abs(cpre - pre) <= 1e-2,
                f"{label}: pre-test {pre} on the card, {cpre} on the CPU")
        say(f"{label}: card vs CPU replay: max param abs err {worst:.3e} "
            f"(tol rtol {PARAM_RTOL} atol {PARAM_ATOL}), uploaded values off "
            f"the tolerance {n_off} of {n_vals}, pre {pre:.4f} vs {cpre:.4f} "
            f"(tol 1e-2), agg_norm rtol 1e-3, bytes_up equal")
    return counts


BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
# flash kernel vs its plain version, (rtol, atol): f32, the reference
# kernel tests' 2e-4; bf16, both compute in f32 and round to bf16 once, so
# they differ by at most one bf16 step, at most 2^-7 of the value
FLASH_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (1e-2, 1e-3)}
SCAN_TOL = 2e-4                # sequential FMAs vs the doubling scan
# prefill logits vs teacher-forced decode at full width, f32: the
# reference's tests/test_decode_equivalence.py tolerances
DECODE_TOL = {"dense": 2e-3, "ssm": 5e-3}


def event_ms(torch, fn, n_inputs, reps=2):
    """Device ms per call between CUDA events, rotating over `n_inputs`
    inputs, after one warm-up round; for calls of milliseconds whose
    temporaries run to gigabytes (the plain versions)."""
    for i in range(n_inputs):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for i in range(n_inputs):
            fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * n_inputs)


def attn_pairs(s, causal, window):
    """(query, key) pairs the mask keeps in one (b, h) plane of length s."""
    total = 0
    for qi in range(s):
        lo = 0 if window is None else max(0, qi - window + 1)
        hi = qi if causal else s - 1
        total += hi - lo + 1
    return total


# the flash kernel's shapes: (label, b, s, h, kv, hd, dtype, causal, window,
# softcap); the first two are the prefill's (timed), then the same shapes
# in f32, tests/test_kernels.py's SWEEP in f32 and a ragged S
FLASH_CASES = (
    ("llama3.2-3b", 2, 4096, 24, 8, 128, "bfloat16", True, None, None),
    ("gemma2-9b local", 1, 8192, 16, 8, 256, "bfloat16", True, 4096, 50.0),
    ("llama3.2-3b f32", 2, 4096, 24, 8, 128, "float32", True, None, None),
    ("gemma2-9b local f32", 1, 8192, 16, 8, 256, "float32", True, 4096,
     50.0),
    ("sweep 1", 2, 256, 4, 2, 128, "float32", True, None, None),
    ("sweep 2", 1, 128, 4, 4, 64, "float32", True, None, None),
    ("sweep 3", 1, 256, 2, 1, 128, "float32", True, 128, None),
    ("sweep 4", 1, 256, 2, 2, 128, "float32", True, None, 30.0),
    ("sweep 5", 2, 128, 4, 2, 96, "float32", False, None, None),
    ("sweep 6", 1, 512, 8, 8, 32, "float32", True, 64, 50.0),
    ("ragged", 1, 1000, 8, 2, 64, "float32", True, 300, None),
    ("ragged bf16", 2, 1000, 8, 2, 128, "bfloat16", True, None, None),
    # the bf16 tensor-core kernel: every head width it pads (8 and 96 to a
    # 64-column panel; 192, 256 on 64-key tiles), GQA r = 1..4, S below
    # one tile and ragged, B > 1 across the batch edge of its tensor maps,
    # and each mask
    ("bf16 S=1 r=4", 1, 1, 4, 1, 128, "bfloat16", True, None, None),
    ("bf16 S=24 hd 8", 2, 24, 6, 2, 8, "bfloat16", True, None, None),
    ("bf16 hd 64 r=3", 3, 130, 6, 2, 64, "bfloat16", True, None, None),
    ("bf16 hd 96 r=1", 2, 300, 4, 4, 96, "bfloat16", False, None, None),
    ("bf16 hd 192", 2, 257, 4, 2, 192, "bfloat16", True, None, None),
    ("bf16 hd 256 r=4", 2, 1000, 8, 2, 256, "bfloat16", False, None, None),
    ("bf16 window", 2, 777, 4, 2, 128, "bfloat16", True, 100, None),
    ("bf16 softcap", 2, 300, 4, 1, 64, "bfloat16", False, None, 30.0),
    ("bf16 window softcap", 2, 700, 4, 2, 256, "bfloat16", True, 200,
     50.0),
)
# the scan's shapes (B, S, C): falcon-mamba-7b's prefill (C = d_inner * N =
# 8,192 * 16), the reference's sweep, a batch axis and ragged lengths
SCAN_CASES = ((1, 2048, 131072), (1, 128, 64), (1, 256, 256), (1, 512, 100),
              (1, 1024, 32), (4, 2048, 512), (1, 1000, 4099), (3, 77, 1000))


def mamba_like_ab(torch, gen, shape):
    """a = exp(-dt n) and b as a Mamba-1 layer makes them: dt a softplus
    near 0.018, n = 1..16 along the channel axis (the state index)."""
    dt = torch.nn.functional.softplus(
        torch.randn(shape, generator=gen) * 0.5 - 4.0)
    n = torch.arange(shape[-1], dtype=torch.float32) % 16 + 1
    a = torch.exp(-dt * n)
    return a.cuda(), torch.randn(shape, generator=gen).cuda()


def lm_kernel_phase(torch, card):
    """The flash and selective-scan kernels against their plain versions;
    returns per-kernel reports."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.selective_scan import selective_scan as SS
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    gen = torch.Generator().manual_seed(2)
    reports = {}
    errs = []
    for (label, b, s, h, kv, hd, dt, causal, window,
         softcap) in FLASH_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(b, s, n, hd, generator=gen).to(dtype).cuda()
                   for n in (h, kv, kv))
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = FA.flash_attention(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        rtol, atol = FLASH_TOL[dt]
        e = check_close(f"flash {label}", got.float(), want.float(), rtol,
                        atol)
        require(torch.equal(got, FA.flash_attention(q, k, v, **kw)),
                f"flash_attention is not deterministic at {label}")
        errs.append(e)
        say(f"flash_attention {label} (B,S,H,KV,hd)=({b},{s},{h},{kv},{hd}) "
            f"{dt} causal={causal} window={window} softcap={softcap}: max "
            f"abs err {e:.3e} (tol rtol {rtol} atol {atol}), max |out| "
            f"{float(want.float().abs().max()):.3f}, rms out "
            f"{float(want.float().square().mean().sqrt()):.4f}; "
            f"deterministic")
        del q, k, v, got, want

    timed = {}
    for (label, b, s, h, kv, hd, dt, causal, window,
         softcap) in FLASH_CASES[:2]:
        dtype = getattr(torch, dt)
        esize = torch.tensor([], dtype=dtype).element_size()
        bytes_in = esize * b * s * hd * (h + 2 * kv)
        ins = [tuple(torch.randn(b, s, n, hd, generator=gen).to(dtype).cuda()
                     for n in (h, kv, kv))
               for _ in range(n_rotating(bytes_in))]
        kw = dict(causal=causal, window=window, softcap=softcap)
        ms = graph_ms(torch, lambda i: FA.flash_attention(*ins[i], **kw),
                      len(ins), replays=3)
        plain_ms = event_ms(torch, lambda i: flash_attention_ref(*ins[i],
                                                                 **kw),
                            len(ins))
        library_ms = None
        if softcap is None and window is None:
            # the yardstick only: the port never calls it
            sdpa = torch.nn.functional.scaled_dot_product_attention
            library_ms = graph_ms(torch, lambda i: sdpa(
                *(t.transpose(1, 2) for t in ins[i]), is_causal=causal,
                enable_gqa=True), len(ins), replays=3)
        moved = bytes_in + esize * b * s * h * hd
        ops = 4 * hd * b * h * attn_pairs(s, causal, window)
        bound_ms, bound_by = max((moved / HBM_BYTES_PER_S * 1e3, "bytes"),
                                 (ops / BF16_OPS_PER_S * 1e3, "operations"))
        timed[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms)
        # the report line carries the main path's shape (llama3.2-3b)
        lib = "none (no single call)" if library_ms is None else \
            f"{library_ms:.5f} (scaled_dot_product_attention)"
        say(f"flash_attention {label} on {card}, {moved} bytes, {ops} flops: "
            f"kernel_ms={ms:.5f} bound_ms={bound_ms:.5f} ({bound_by}) "
            f"plain_ms={plain_ms:.5f} library_ms={lib}; "
            f"{ops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.3f} of the bound")
        if label == "llama3.2-3b":
            require(ms <= 4 * bound_ms,
                    f"flash bf16 at {label}: {ms:.5f} ms, below a quarter "
                    f"of its bound ({bound_ms:.5f} ms)")
        del ins
    reports["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention_bf16.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:70",
        max_abs_err=max(errs), **timed["llama3.2-3b"])

    errs = []
    for shape in SCAN_CASES:
        a, b = mamba_like_ab(torch, gen, shape)
        h = SS.selective_scan(a, b)
        hr = selective_scan_ref(a, b)
        torch.cuda.synchronize()
        e = check_close(f"selective_scan {shape}", h, hr, SCAN_TOL, SCAN_TOL)
        require(torch.equal(h, SS.selective_scan(a, b)),
                f"selective_scan is not deterministic at {shape}")
        errs.append(e)
        say(f"selective_scan (B,S,C)={shape}: max abs err {e:.3e} (tol rtol "
            f"{SCAN_TOL} atol {SCAN_TOL}) deterministic")
        del a, b, h, hr
    shape = SCAN_CASES[0]
    n_el = shape[0] * shape[1] * shape[2]
    ins = [mamba_like_ab(torch, gen, shape)
           for _ in range(n_rotating(8 * n_el))]
    ms = graph_ms(torch, lambda i: SS.selective_scan(*ins[i]), len(ins),
                  replays=5)
    plain_ms = event_ms(torch, lambda i: selective_scan_ref(*ins[i]),
                        len(ins))
    moved = 12 * n_el
    bound_ms, bound_by = bound_of(moved, 2 * n_el)
    reports["selective_scan"] = dict(
        name="selective_scan", route="cuda",
        source="src/repro_torch/kernels/selective_scan/csrc/"
               "selective_scan.cu",
        replaces="src/repro/kernels/selective_scan/selective_scan.py:49",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)
    say(f"selective_scan (B,S,C)={shape} on {card}, {moved} bytes: "
        f"kernel_ms={ms:.5f} bound_ms={bound_ms:.5f} ({bound_by}) "
        f"plain_ms={plain_ms:.5f} library_ms=none (no single call)")
    return reports


SERVE_DECODE = 64              # tokens the serve loop decodes
CHECK_LEN = 64                 # tokens of the f32 prefill-vs-decode check


def lm_slice_phase(torch, card, kernels):
    """Prefill and the serve loop of each model at full width on the card,
    then the f32 prefill against teacher-forced decode; returns each
    kernel's launches from the first prefill that runs it."""
    from repro_torch.launch.profile_lm import (DECODE_BATCH, PROMPT, RUNS,
                                              setup)
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import make_prefill_step, make_serve_step
    from repro_torch.models import api

    counts = {}
    for run in RUNS:
        arch, b, s, kname = run.arch, run.batch, run.seq, run.kernel
        t0 = time.perf_counter()
        cfg, params, tgen = setup(run)
        n_param = sum(v.numel() for v in params["layers"].values()) + \
            params["embed"].numel()
        prefill = make_prefill_step(cfg)
        prefill(params, api.make_batch(cfg, tgen, 1, 256, device="cuda"))
        batch = api.make_batch(cfg, tgen, b, s, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in kernels.values():
            fn.launches = 0
        t1 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t1
        launches = {n: fn.launches for n, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        want = {n: 0 for n in kernels}
        want[kname] = run.launches
        require(launches == want, f"{arch} prefill: launches {launches}, "
                                  f"want {want}")
        counts.setdefault(kname, launches[kname])
        require(tuple(logits.shape) == (b, s, cfg.vocab) and
                bool(torch.isfinite(logits).all()),
                f"{arch}: prefill logits {tuple(logits.shape)} not finite "
                f"or of the wrong shape")
        say(f"{arch} ({cfg.n_layers} layers, {n_param} params, {cfg.dtype}) "
            f"prefill on {card}: B={b} S={s} in {sec:.4f} s, "
            f"{b * s / sec:.1f} tokens/s, peak memory {peak} bytes, "
            f"launches {launches}")
        del logits, batch

        toks = api.make_batch(cfg, tgen, DECODE_BATCH, PROMPT,
                              device="cuda")["tokens"]
        for fn in kernels.values():
            fn.launches = 0
        res = serve(cfg, params, toks, SERVE_DECODE, "cuda")
        launches = {n: fn.launches for n, fn in kernels.items()}
        require(all(n == 0 for n in launches.values()),
                f"{arch} serve: decode launched {launches}")
        require(not bool(torch.isnan(res["logits"]).any()),
                f"{arch} serve: NaN logits")
        require(tuple(res["generated"].shape) ==
                (DECODE_BATCH, SERVE_DECODE),
                f"{arch} serve: generated {tuple(res['generated'].shape)}")
        say(f"{arch} serve on {card}: batch {DECODE_BATCH}, prompt "
            f"{PROMPT} in {res['prompt_s']:.4f} s, decode "
            f"{SERVE_DECODE} in {res['decode_s']:.4f} s -> "
            f"{res['tok_per_s']:.1f} tok/s, no NaN, kernel launches 0")
        del params, res
        torch.cuda.empty_cache()

        # f32 at full width: prefill (the kernels) vs teacher-forced decode
        # (plain torch, no kernel), as tests/test_decode_equivalence.py
        cfg32, params, tgen = setup(run, "float32")
        batch = api.make_batch(cfg32, tgen, 2, CHECK_LEN, device="cuda")
        full = make_prefill_step(cfg32)(params, batch)
        cache = api.init_cache(cfg32, 2, CHECK_LEN, device="cuda")
        step = make_serve_step(cfg32)
        outs = []
        for i in range(CHECK_LEN):
            lg, cache = step(params, cache, batch["tokens"][:, i:i + 1], i)
            outs.append(lg[:, 0])
        dec = torch.stack(outs, dim=1)
        tol = DECODE_TOL[cfg.family]
        e = check_close(f"{arch} f32 prefill vs decode", dec, full, tol, tol)
        say(f"{arch} f32 at full width ({cfg.n_layers} layers) on {card}: "
            f"prefill logits vs {CHECK_LEN} teacher-forced decode steps, max "
            f"abs err {e:.3e} (tol rtol {tol} atol {tol}), max |logit| "
            f"{float(full.abs().max()):.3f}; {time.perf_counter() - t0:.1f} "
            f"s for {arch}")
        del params, batch, full, cache, dec, outs
        torch.cuda.empty_cache()
    return counts


def ptxas_report(log):
    """{entry function: {"regs": registers, "spill": spill bytes}} from
    nvcc's ptxas -v output."""
    found, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            found.setdefault(entry, {})["spill"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            found.setdefault(entry, {})["regs"] = int(m[1])
    return found


def reduction_build_check(build):
    """The one-launch reductions' kernels (ncv_weighted_sum's three vector
    widths, the wire kernels' five each, rank_band_mean's nine
    register-path and one panel-path templates): registers from ptxas -v,
    and none may spill."""
    want = dict(rloo=("ncv_weighted_sum_kernel", 3), rloo_q=("wsum_q", 10),
                robust=("rank_band_", 10))
    for lib, (tag, count) in want.items():
        if lib not in build.BUILD_LOG:   # built before this run: build anew
            build.library_path(lib).unlink()
            build.build_all((lib,))
        kernels = {k: v for k, v in ptxas_report(build.BUILD_LOG[lib]).items()
                   if tag in k}
        require(len(kernels) == count, f"ptxas reported {len(kernels)} "
                                       f"{tag} kernels, want {count}")
        for entry, v in sorted(kernels.items()):
            say(f"{lib}: {entry}: {v['regs']} registers, {v['spill']} spill "
                f"bytes")
            require(v["spill"] == 0, f"{entry} spills {v['spill']} bytes")


def flash_bf16_build_check(build):
    """The bf16 flash kernel's build: each template's registers and spill
    bytes from ptxas -v (none may spill, and no setmaxnreg may be dropped),
    and its tensor-core instructions (HGMMA) in the SASS."""
    name = "flash_attention_bf16"
    if name not in build.BUILD_LOG:      # built before this run: build anew
        build.library_path(name).unlink()
        build.build_all((name,))
    log = build.BUILD_LOG[name]
    require("setmaxnreg ignored" not in log,
            "ptxas ignored setmaxnreg in the bf16 flash kernel")
    kernels = {k: v for k, v in ptxas_report(log).items()
               if "flash_bf16_kernel" in k}
    require(len(kernels) == 4, f"ptxas reported {len(kernels)} bf16 flash "
                               f"kernels, want 4")
    for entry, v in sorted(kernels.items()):
        hdp, bk = re.search(r"flash_bf16_kernelILi(\d+)ELi(\d+)E",
                            entry).groups()
        say(f"flash bf16 kernel HDP={hdp} BK={bk}: {v['regs']} registers a "
            f"thread at launch (setmaxnreg: producer 24, consumers 240), "
            f"{v['spill']} spill bytes")
        require(v["spill"] == 0, f"bf16 flash kernel HDP={hdp} BK={bk} "
                                 f"spills {v['spill']} bytes")
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    n_hgmma = sum("HGMMA" in line for line in sass.splitlines())
    require(n_hgmma > 0, "no HGMMA in the bf16 flash kernel's SASS")
    say(f"flash bf16 kernels: {n_hgmma} HGMMA (tensor-core) instructions in "
        f"the SASS (cuobjdump -sass)")


# bf16 llama3.2-3b logits at full width.  Each layer's attention through
# the kernel is held to the plain version on the same q, k, v at the
# kernel's own bf16 tolerance.  The logits cannot be held that tightly by
# any attention: the two bf16 layers cascade every flipped rounding of
# the attention output (one step, in well under 1% of its elements) into
# about 6e-3 relative rms of the logits, whether the flips come from the
# kernel or from an f32-exact attention in another summation order.  So
# the logits are held against a control, the f32 kernel on f32 copies of
# q, k, v rounded to bf16 once: the kernel may move them (relative rms
# from the plain attention's) by at most twice what the control does, or
# 2^-8 (one bf16 rounding) if that is larger.  The cascade saturates (it
# flips most logits either way), so a kernel within its contract stays
# near the control; a fault (a wrong head, mask or tile) moves the logits
# by O(1).
BF16_LOGIT_VS_CONTROL, BF16_LOGIT_REL_RMS = 2.0, 2 ** -8


def lm_bf16_check(torch, card, fa):
    """llama3.2-3b prefill logits in bf16 at full width, cut to 2 layers,
    B 1 x S 4096: attention by the kernel, by the plain version, and by
    the f32 control, over the same weights and tokens."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.launch.profile_lm import Run, setup
    from repro_torch.launch.train import make_prefill_step
    from repro_torch.models import api
    from repro_torch.models import layers

    run = Run("llama3.2-3b", 2, 1, 4096, "flash_attention", 2)
    cfg, params, tgen = setup(run)
    batch = api.make_batch(cfg, tgen, run.batch, run.seq, device="cuda")
    prefill = make_prefill_step(cfg)
    kernel = layers.flash_attention
    rtol, atol = FLASH_TOL["bfloat16"]
    layer_errs = []
    differ = {"kernel": [], "f32 control": []}   # share of outputs, by layer

    def checked(q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        ref = flash_attention_ref(q, k, v, **kw)
        layer_errs.append(check_close(
            "bf16 llama3.2-3b layer attention, kernel vs plain", out.float(),
            ref.float(), rtol, atol))
        differ["kernel"].append(float((out != ref).float().mean()))
        return out

    def f32_control(q, k, v, **kw):
        out = kernel(q.float(), k.float(), v.float(), **kw).to(q.dtype)
        ref = flash_attention_ref(q, k, v, **kw)
        differ["f32 control"].append(float((out != ref).float().mean()))
        return out

    def logits_with(attention):
        layers.flash_attention = attention
        try:
            out = prefill(params, batch)
        finally:
            layers.flash_attention = kernel
        torch.cuda.synchronize()
        return out

    fa.launches = 0
    got = logits_with(checked)
    require(fa.launches == run.launches,
            f"bf16 llama check: {fa.launches} flash launches, want "
            f"{run.launches}")
    want = logits_with(flash_attention_ref)
    control = logits_with(f32_control)
    norm = float(want.norm())
    stats = {}
    for name, x in (("kernel", got), ("f32 control", control)):
        stats[name] = (float((x - want).norm()) / norm,
                       float((x - want).abs().max()),
                       float((x != want).float().mean()))
    tol = max(BF16_LOGIT_VS_CONTROL * stats["f32 control"][0],
              BF16_LOGIT_REL_RMS)
    say(f"llama3.2-3b bf16 at full width ({cfg.n_layers} layers, B "
        f"{run.batch} x S {run.seq}) on {card}: layer attention, kernel vs "
        f"plain, max abs err {max(layer_errs):.3e} (tol rtol {rtol} atol "
        f"{atol}); share of layer outputs differing from the plain "
        f"version's " + ", ".join(f"{name} {[round(d, 5) for d in ds]}"
                                 for name, ds in differ.items()) +
        f"; logits vs the plain attention's (max |logit| "
        f"{float(want.abs().max()):.3f}): " + "; ".join(
            f"{name} relative rms {r:.3e}, max abs {m:.3e}, share differing "
            f"{d:.5f}" for name, (r, m, d) in stats.items()) +
        f" (tol for the kernel: relative rms {tol:.3e})")
    require(stats["kernel"][0] <= tol,
            f"bf16 llama3.2-3b logits: relative rms difference "
            f"{stats['kernel'][0]:.3e} from the plain attention's, above "
            f"{tol:.3e}")
    del params, batch, got, want, control
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels import build
    from repro_torch import comm
    from repro_torch.kernels.rloo import ref
    from repro_torch.kernels.rloo import rloo as K
    from repro_torch.kernels.robust import ref as rref
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.robust import robust as R
    from repro_torch.kernels.selective_scan import selective_scan as SS

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

    phase_s = {}
    t_phase = time.perf_counter()
    say("== phase 2: build")
    secs = build.build_all()
    for name, log in build.BUILD_LOG.items():
        for line in log.strip().splitlines():
            say(f"[nvcc {name}] {line}")
    say(f"build: {secs:.2f} s -> {build.BUILD_DIR}")
    flash_bf16_build_check(build)
    reduction_build_check(build)

    phase_s["build"] = time.perf_counter() - t_phase

    t_phase = time.perf_counter()
    say("== phase 3: kernels vs plain versions")
    floor_ms = launch_floor_ms(torch)
    say(f"launch floor: a 1-element add_ in a CUDA graph, {floor_ms:.5f} ms "
        f"a node")
    reports = kernel_phase(torch, K, ref, floor_ms)
    reports.update(wire_kernel_phase(torch, K, R, ref, rref, comm, floor_ms))
    reports.update(lm_kernel_phase(torch, card))
    phase_s["kernels"] = time.perf_counter() - t_phase

    t_phase = time.perf_counter()
    say("== phase 4: slice")
    world = make_world(torch)
    counts = slice_phase(torch, np, K, card, world)
    kernels = dict(rloo_combine=K.rloo_combine,
                   ncv_weighted_sum=K.ncv_weighted_sum,
                   ncv_weighted_sum_q=K.ncv_weighted_sum_q,
                   ncv_weighted_sum_q4=K.ncv_weighted_sum_q4,
                   rank_band_mean=R.rank_band_mean)
    for name, n in wire_slice_phase(torch, np, kernels, card, world).items():
        counts.setdefault(name, n)      # the main path's own count first
    phase_s["fl slice"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    del world
    torch.cuda.empty_cache()
    kernels.update(flash_attention=FA.flash_attention,
                   selective_scan=SS.selective_scan)
    counts.update(lm_slice_phase(torch, card, kernels))
    lm_bf16_check(torch, card, FA.flash_attention)
    phase_s["lm slice"] = time.perf_counter() - t_phase

    say("== phase 5: report")
    say("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in phase_s.items()))
    kernels = []
    for name in ("rloo_combine", "ncv_weighted_sum", "ncv_weighted_sum_q",
                 "ncv_weighted_sum_q4", "rank_band_mean", "flash_attention",
                 "selective_scan"):
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
