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
               and f32), the reference's sweep (f32), ragged S, the bf16
               tensor-core kernel's head widths, GQA ratios, masks, short
               and ragged S and batch edges, and the moe family's shapes
               (llama4's folded chunks (2, 8192, 40/8, hd 128), kimi-k2's
               hd 112; their plain version computed a batch item and a KV
               head at a time, and their kernel and SDPA times printed),
               zamba2-7b's shared attention (1, 2048, 32/32, hd 112,
               timed beside SDPA), whisper-medium's three shapes in bf16
               and f32 (encoder (8, 1500, 16/16, hd 64, not causal),
               decoder self (8, 448, causal), cross (8, 448 queries x
               1,500 keys); all three timed beside SDPA),
               llama-3.2-vision-11b's two in bf16 and f32 (self (2, 4096,
               32/8, hd 128, causal), cross (2, 4,096 queries x 1,601
               image tokens, GQA, not causal: the last 64-key tile holds
               one key); both timed beside SDPA) and keys
               of their own length S_kv in both kernels (below and above
               S, ragged, GQA, causal and window, rows that keep no key);
               the scan at falcon-mamba-7b's
               (1, 2048, 131072), the reference's sweep, a batch axis,
               ragged S and zamba2-7b's Mamba-2 state (1, 2048, 458752:
               C = H N P = 112 * 64 * 64, a per head; timed too); the
               server kernels (`ncv_weighted_sum`, its int8 wire twin,
               `rank_band_mean`) on the sampler and fault runs'
               inputs: HT weights that are no integers, zero-weight (dropped)
               rows, 10x (byzantine) and sign-flipped rows, byzantine and
               dead rows in one band.  Then device times (CUDA-graph
               replay, inputs rotated through more than the 50 MB L2) of
               the kernel, the plain version and, where one exists, a
               single PyTorch call computing the same function; the bf16
               flash kernel must reach a quarter of its bound at the
               llama3.2-3b shape.  Beside
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
               wire, norm_clip); then the other registered methods with
               the reference's default options, 3 rounds each (fedprox,
               scaffold, fedncv+, fedper, fedrep, fedglomo) and 10 of
               pfedsim (its round-10 head mixing); then the samplers and
               fault models (`FAULT_RUNS`: importance, similarity 5 rounds,
               dropout with drop_skew, straggler, markov 5 rounds, byzantine
               scale under mean / trimmed_mean / median, signflip under
               norm_clip, labelflip over int8, dropout + importance, and the
               external sampler and fault with host-written tables and one
               all-dead round, which must be a finite no-op), each run's
               server kernel also held to its plain version on each round's
               inputs, and a robustness check (2 of 10 clients at byzantine
               scale 10: the param step under mean against trimmed_mean),
               printing each run's device ms a round (torch.profiler);
               then `pipeline_store_ckpt_phase`: the depth-K ring (FedNCV
               beta = 1 at K = 1, 2, 3 and at K = 2 with dropout and the
               importance sampler, 6 rounds each: bitwise the
               hand-unrolled client/server loop and chunked driving, K
               all-zero bubble rows, a CPU replay of its draws), the host
               store against the device store bitwise round by round
               (fedncv, scaffold, fedncv+, fedncv at K = 2, fedncv under
               dropout, whose dropped rows must stay unwritten), fedncv+
               at 10,000 clients under both stores (bitwise params and h;
               the host store's device bytes the same at 1,000 clients),
               and a checkpoint at round 3 of a K = 2 run under both
               stores that must resume bitwise, generators included, and
               refuse another depth or store; then `codec_phase`: the
               stateful wires with per-client error feedback, 3 rounds
               each (fedncv over topk at ratio 0.1 and 0.16 and over
               lowrank at rank 8, fedavg over topk, fedncv+ over topk,
               median over topk, dropout 0.5 over topk), each printing
               bytes_up, sec_per_round, device ms and operations a round
               and launches a round, a second card run bitwise equal and
               a CPU replay round by round from the card's state; the host
               store against the device store under topk and lowrank (6
               rounds, bitwise), the ring at K = 1 and 2 under topk against
               the unrolled loop (bitwise), and a K = 1 checkpoint after
               round 2 under topk resumed bitwise; then
               `serve_track_phase`: the served FedNCV round (beta = 1,
               track_variance) under a `Coordinator` (markov queue,
               check-in 0.5, deadline 2.0 s) into a stdout + jsonl sink,
               K = 0 under the fixed policy and K = 1 under token_bucket
               (ending in `drain()`), 6 rounds each: one row a round
               (`tools/flwatch.py --check`), gvar_proxy against plain
               torch, bitwise an untracked run on the same tables, a
               save at round 3 resumed bitwise (the jsonl cut back,
               bytes_up_cum continuous), 2 `rloo_combine` + 1
               `ncv_weighted_sum` a round; then 10 interleaved tracked
               and untracked rounds timed, the row's emission split into
               its wait for the device and its host work.
               Checks the launch
               counts, `bytes_up`, finiteness, and the parameters against
               a CPU replay of the same draws through the plain versions
               (with the margin, the largest err / (atol + rtol |x|); the
               wire, robust, method, sampler and fault runs round by round
               from the card's state and draws, with every state field); the
               fedncv beta = 0 draws
               run on the card a second time with the process's
               cudnn.allow_tf32 and cudnn.benchmark True and must give the
               same bits.  Then the LM serving
               slice at full width from random bf16 params: llama3.2-3b
               (28 layers) prefill B 2 x S 4096, falcon-mamba-7b (64 layers)
               B 1 x S 2048, gemma2-9b cut to 2 layers (one local/global
               pair) B 1 x S 8192, llama4-scout-17b-a16e cut to 4 layers
               (3 chunked, 1 global) B 1 x S 16384 (4 flash launches: a
               folded call per chunked layer), kimi-k2-1t-a32b cut to 1
               layer B 1 x S 2048 (its init's peak printed), zamba2-7b (81
               layers: 54 Mamba-2 blocks, 27 applications of the shared
               attention block) B 1 x S 2048 (54 scan and 27 flash
               launches), whisper-medium (24 encoder and 24 decoder
               layers) B 8 x S 448 over 8 x 1,500 frames (72 flash
               launches: encoder, decoder self- and cross-attention),
               llama-3.2-vision-11b (40 layers: 8 groups of 4
               self-attention layers and a gated cross-attention layer)
               B 2 x S 4096 over 2 x 1,601 image tokens (40 flash
               launches: 32 causal, 8 cross);
               after each prefill the serve loop (batch 8, prompt 32,
               decode 64; whisper's frames encoded into the cross caches
               first, 24 flash launches; the vlm's image K/V filled by
               `prefill_cross`, no launch); then each model in f32, prefill
               logits against 64 teacher-forced decode steps (whisper's
               and the vlm's after `prefill_cross`, the vlm's gates drawn
               nonzero and printed, since init's zeros make every cross
               layer the identity; the moe
               models at capacity factor 8, no slot dropped in either
               pass; kimi-k2 on its reduced config, since one f32 layer
               is 78 GB), and llama4's `chunk_ring` decode on
               its reduced config (chunk 16, 40 steps).  Last, bf16
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


def fault_input_kernel_phase(torch, K, R, ref, rref, comm, reports):
    """The server kernels on the inputs the sampler and fault runs give
    them: Horvitz-Thompson weights that are no integers, rows whose weight
    is exactly 0 (dropped clients), rows 10x the others (byzantine
    `scale` 10), sign-flipped rows, and byzantine and dead rows in one
    `rank_band_mean` cohort.  Folds each kernel's largest error into its
    report."""
    from repro_torch.kernels.rloo.rloo import ncv_coefficients

    gen = torch.Generator().manual_seed(2)

    def cohort(m, n, dead, byz, flip=()):
        """(M, N) uploads with the byzantine rows 10x and the flipped rows
        negated, and the Eq. 10-12 coefficients of sizes x HT factors,
        0 at the dead rows."""
        g = torch.randn(m, n, generator=gen)
        g[list(byz)] *= 10.0
        g[list(flip)] *= -1.0
        sizes = torch.randint(20, 400, (m,), generator=gen).float()
        weights = sizes * (torch.rand(m, generator=gen) * 2.0 + 0.3)
        weights[list(dead)] = 0.0
        return g.cuda(), weights, ncv_coefficients(weights, 0.0).cuda()

    def held(name, kern, plain, args, **kw):
        got, want = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        e = check_scaled(f"{name} agg", got[0], want[0])
        check_close(f"{name} norm", got[1], want[1], 1e-4, 1e-6)
        again = kern(*args, **kw)
        require(torch.equal(got[0], again[0]) and torch.equal(got[1],
                                                              again[1]),
                f"{name} is not deterministic")
        reports[name]["max_abs_err"] = max(reports[name]["max_abs_err"], e)
        return e

    codec = comm.get_codec("int8", n=62006)
    for m, n, dead, byz, flip in ((10, 62006, (3, 7), (0, 1), ()),
                                  (10, 62006, (), (0, 1), (5,)),
                                  (10, 62006, (1, 2, 4, 6, 8), (0,), ()),
                                  (40, 62006, (5, 9, 20), (0, 1, 2, 3), (7,)),
                                  (12, 4097, (11,), (0,), (3, 4))):
        g, weights, coef = cohort(m, n, dead, byz, flip)
        e = held("ncv_weighted_sum", K.ncv_weighted_sum,
                 ref.ncv_weighted_sum_ref, (g, coef))
        line = (f"M={m} N={n} dead={len(dead)} byzantine x10={len(byz)} "
                f"sign-flipped={len(flip)} HT weights: ncv_weighted_sum max "
                f"abs err {e:.3e}")
        if n == 62006:
            wire, _ = codec.encode(g, None, torch.rand(
                codec.uniforms_shape(m), generator=gen).cuda())
            e = held("ncv_weighted_sum_q", K.ncv_weighted_sum_q,
                     ref.ncv_weighted_sum_q_ref, (wire["q"], wire["s"], coef),
                     chunk=codec.chunk)
            line += f", ncv_weighted_sum_q (int8 wire) {e:.3e}"
        alive = (weights > 0).float().cuda()
        m_v = float(alive.sum())
        k = min(math.floor(0.25 * m_v), math.floor((m_v - 1) / 2))
        mid = math.floor((m_v - 1) / 2)
        for lo in (k, mid):
            lo_t = torch.tensor(float(lo), device="cuda")
            hi_t = m_v - 1.0 - lo_t
            e = held("rank_band_mean", R.rank_band_mean,
                     rref.rank_band_mean_ref, (g, alive, lo_t, hi_t))
            row, _ = rref.rank_band_mean_rowwise(g, alive, lo_t, hi_t)
            require(torch.equal(R.rank_band_mean(g, alive, lo_t, hi_t)[0],
                                row),
                    f"rank_band_mean M={m}: not bitwise the row-order "
                    f"emulation with byzantine and dead rows")
        line += (f", rank_band_mean (trimmed band and median) {e:.3e}, "
                 f"bitwise the row-order emulation")
        say(line + " (tol rtol 1e-5 atol 1e-5 x max|agg|; norm rtol 1e-4); "
                   "deterministic")


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


# bench_fl's protocol, and the slice's FedNCV options (the quickstart's
# alpha)
FL_BASE = dict(n_clients=40, cohort=10, k_micro=4, micro_batch=16,
               server_lr=0.5, local_lr=0.05, local_epochs=2)
FL_KW = dict(FL_BASE, method="fedncv", ncv_alpha0=0.3, ncv_alpha_lr=1e-5)


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
        margin = margin_of(sim.params, cpu.params)
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
            u = draws[i].u
            pend = cpu._client_section_local(
                cpu.params, cpu._state,
                draws[i]._replace(u=None if u is None else u.cpu()))
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


# the paper's other Table-1 methods and the beyond-paper ones at the same
# protocol, each with the reference's default options: (method, rounds);
# pfedsim runs 10 so that its round-10 head mixing runs
METHOD_RUNS = (("fedprox", 3), ("scaffold", 3), ("fedncv+", 3),
               ("fedper", 3), ("fedrep", 3), ("pfedsim", 10),
               ("fedglomo", 3))
# bytes_up a round at cohort 10, the reference's accounting: the identity
# wire, 10 x 4 N = 2,480,240 B, plus SCAFFOLD's delta_c (another 4 N a
# client) or pFedSim's flattened head (850 floats a client)
METHOD_BYTES_UP = {"scaffold": 4960480, "pfedsim": 2514240}


def off_tolerance(torch, card, cpu):
    """(values off the replay tolerance, values) of two trees of stacked
    leaves (the card's on any device, the CPU's)."""
    from repro_torch.utils.tree_math import tree_leaves
    a, b = tree_leaves(card), tree_leaves(cpu)
    if not a:
        return 0, 0
    a = torch.cat([x.detach().float().cpu().reshape(-1) for x in a])
    b = torch.cat([x.float().reshape(-1) for x in b])
    off = (a - b).abs() > PARAM_ATOL + PARAM_RTOL * b.abs()
    return int(off.sum()), off.numel()


def margin_of(card, cpu):
    """max over the leaves of err / (atol + rtol |x|): at most 1 passes."""
    from repro_torch.utils.tree_math import tree_leaves
    return max((float(((x.cpu() - y).abs() / (
        PARAM_ATOL + PARAM_RTOL * y.abs())).max()) for x, y in zip(
            tree_leaves(card), tree_leaves(cpu)) if y.numel()), default=0.0)


def device_ms_per_call(torch, fn, n):
    """Device ms and device operations a call, from torch.profiler over n
    calls of fn (sum of the device kernels' times; the round's phase
    scopes, which a trace may also place on the device's timeline, are
    labels, not operations)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.track import PHASES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name not in PHASES]
    return sum(e.device_time for e in dev) / 1e3 / n, len(dev) / n


def device_ms_per_round(torch, sim, draws):
    """Device ms and device operations a round over `len(draws)` rounds of
    `sim`."""
    ms, ops = device_ms_per_call(
        torch, lambda: sim.run_rounds(len(draws), draws=draws), 1)
    return ms / len(draws), ops / len(draws)


def methods_slice_phase(torch, np, kernels, card, world):
    """fedprox, scaffold, fedncv+, fedper, fedrep, pfedsim and fedglomo on
    the card at the slice's protocol, each replayed on the CPU round by
    round from the card's state; returns the launch count of
    `ncv_weighted_sum` of the first run."""
    from repro_torch.fed import FLConfig, Simulator
    from repro_torch.utils.tree_math import tree_map

    class Recording(Simulator):
        """Keeps, by reference, each round's starting params and state and
        its client section's output."""

        def _client_section_local(self, params, state, draws):
            pending = super()._client_section_local(params, state, draws)
            self.record.append((params, state, pending))
            return pending

    train, test, task = world["train"], world["test"], world["task"]
    params0 = world["params0"]
    to_cpu = lambda tree: tree_map(lambda x: x.cpu(), tree)  # noqa: E731
    count = None
    for method, rounds in METHOD_RUNS:
        fl = FLConfig.make(method=method, **FL_BASE)
        # warm-up on a throwaway simulator (first launches), which then
        # gives one profiled round
        warm = Simulator(task, params0, train, fl, seed=1)
        warm.run_rounds(1)
        sim = Recording(task, params0, train, fl, seed=0)
        sim.record = []
        draws = [sim._draw_cohort_sel() for _ in range(rounds)]
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        diags = sim.run_rounds(rounds, draws=draws)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / rounds
        launches = {n: fn.launches for n, fn in kernels.items()}
        want = {n: 0 for n in kernels}
        want["ncv_weighted_sum"] = 0 if method == "fedncv+" else rounds
        require(launches == want, f"{method}: launches {launches}, want "
                                  f"{want}")
        if count is None:
            count = launches["ncv_weighted_sum"]
        dev_ms, dev_ops = device_ms_per_round(
            torch, warm, [warm._draw_cohort_sel()])
        up = METHOD_BYTES_UP.get(method, 2480240)
        require(all(float(b) == up for b in diags["bytes_up"]),
                f"{method}: bytes_up {diags['bytes_up']}, want {up}")
        pre = sim.evaluate(test)
        post = sim.evaluate(test, personalize_steps=3)
        finite = all(bool(torch.isfinite(v).all()) for v in
                     sim.params.values()) and all(
            np.isfinite(v).all() for v in diags.values()) and \
            math.isfinite(pre) and math.isfinite(post)
        require(finite, f"{method}: non-finite params, diagnostics or "
                        f"accuracy")
        say(f"{method} on {card}: {rounds} rounds, sec_per_round={sec:.4f}, "
            f"device ms a round {dev_ms:.3f} in {dev_ops:.0f} device "
            f"operations (torch.profiler), launches {launches}, bytes_up="
            f"{float(diags['bytes_up'][0]):.0f}, agg_norm="
            f"{[float(x) for x in diags['agg_norm']]}, pre={pre:.4f} "
            f"post={post:.4f}")

        # the same draws on the CPU, each round from the card's starting
        # state: the CPU's client section is held to the card's (uploads,
        # aux and returned client state, up to the near-tie share), then
        # its server section takes the card's and must land on the card's
        # params and every state field
        cpu = Simulator(task, params0, train, fl, seed=0, device="cpu")
        margin, n_off, n_vals = 0.0, 0, 0
        for i, (p_card, st_card, pend_card) in enumerate(sim.record):
            cpu.params, cpu._state = to_cpu(p_card), to_cpu(dict(st_card))
            pend = cpu._client_section_local(cpu.params, cpu._state,
                                             draws[i])
            for part in ("grads", "aux", "cstates"):
                off, nv = off_tolerance(torch, pend_card[part], pend[part])
                n_off, n_vals = n_off + off, n_vals + nv
                require(off <= MAX_OFF_SHARE * nv,
                        f"{method} round {i} {part}: {off} of {nv} values "
                        f"off the tolerance")
            pend = {k: to_cpu(v) for k, v in pend_card.items()}
            cpu.params, cpu._state, cdiag = cpu._server_section(
                cpu.params, cpu._state, pend, i + 1)
            after = sim.record[i + 1] if i + 1 < len(sim.record) else (
                sim.params, sim._state)
            require(set(after[1]) == set(cpu._state),
                    f"{method}: state fields {sorted(after[1])} on the "
                    f"card, {sorted(cpu._state)} on the CPU")
            margin = max(margin, margin_of(after[0], cpu.params),
                         margin_of(after[1], cpu._state))
            np.testing.assert_allclose(diags["agg_norm"][i],
                                       float(cdiag["agg_norm"]), rtol=1e-3)
            require(float(cdiag["bytes_up"]) == float(diags["bytes_up"][i]),
                    f"{method}: bytes_up differs from the CPU replay")
        require(margin <= 1.0, f"{method}: card vs CPU replay margin "
                               f"{margin:.4f} > 1")
        cpre = cpu.evaluate(test)
        require(abs(cpre - pre) <= 1e-2,
                f"{method}: pre-test {pre} on the card, {cpre} on the CPU")
        say(f"{method}: card vs CPU replay, round by round from the card's "
            f"state: params and state {sorted(cpu._state)} margin "
            f"{margin:.4f} (tol rtol {PARAM_RTOL} atol {PARAM_ATOL}: margin "
            f"<= 1), client values off the tolerance {n_off} of {n_vals}, "
            f"pre {pre:.4f} vs {cpre:.4f} (tol 1e-2), agg_norm rtol 1e-3, "
            f"bytes_up equal")
    return count


# the samplers and the fault models at the slice's protocol, fedncv with
# beta = 0: (label, options, rounds, the kernel that carries the run's
# server reduction, once a round); the byzantine ids are the first 8 of 40
FAULT_RUNS = (
    ("importance", dict(sampler="importance"), 3, "ncv_weighted_sum"),
    ("similarity", dict(sampler="similarity"), 5, "ncv_weighted_sum"),
    ("dropout", dict(fault="dropout", drop_skew=0.5), 3, "ncv_weighted_sum"),
    ("straggler", dict(fault="straggler"), 3, "ncv_weighted_sum"),
    ("markov", dict(fault="markov"), 5, "ncv_weighted_sum"),
    ("byzantine-mean", dict(fault="byzantine"), 3, "ncv_weighted_sum"),
    ("byzantine-trimmed_mean", dict(fault="byzantine",
                                    aggregator="trimmed_mean",
                                    trim_frac=0.25), 3, "rank_band_mean"),
    ("byzantine-median", dict(fault="byzantine", aggregator="median"), 3,
     "rank_band_mean"),
    ("signflip-norm_clip", dict(fault="byzantine", byz_attack="signflip",
                                aggregator="norm_clip"), 3,
     "ncv_weighted_sum"),
    ("labelflip-int8", dict(fault="byzantine", byz_attack="labelflip",
                            codec="int8"), 3, "ncv_weighted_sum_q"),
    ("dropout+importance", dict(sampler="importance", fault="dropout",
                                drop_skew=0.5), 3, "ncv_weighted_sum"),
    ("external", dict(sampler="external", ext_cohort=10, fault="external",
                      ext_slots=10), 3, "ncv_weighted_sum"),
)
# aux bytes a round at cohort 10: FedNCV's 4 scalars a client, and the
# sampler's statistics (importance: the upload norm; similarity: an
# 8-float sketch)
FAULT_AUX_BYTES = {"uniform": 160, "importance": 200, "similarity": 480,
                   "external": 160}


def external_tables(torch, r):
    """The host-written tables of the external run's round r: the cohort
    and its HT factors, and which slots report with their survival
    factors.  In round 1 every slot is dead."""
    g = torch.Generator().manual_seed(100 + r)
    idx = torch.randperm(40, generator=g)[:10]
    invp = torch.rand(10, generator=g) + 0.5
    alive = (torch.rand(10, generator=g) > 0.3).float()
    if r == 1:
        alive = torch.zeros(10)
    return (dict(idx=idx.int(), invp=invp),
            dict(alive=alive, invp=alive / 0.7))


def server_kernel_inputs_held(torch, K, R, ref, rref, kname, sim, pending):
    """The run's server kernel against its plain version on one round's
    own inputs (the card's uploads, or its int8 wire, and the weights the
    round aggregated with).  Returns the largest abs error."""
    from repro_torch.fed import aggregators
    from repro_torch.kernels.rloo.rloo import ncv_coefficients
    from repro_torch.utils.tree_math import ravel_stack

    weights = pending["weights"]
    coef = ncv_coefficients(weights, 0.0).to(weights.device)
    if kname == "ncv_weighted_sum_q":
        q, s = pending["grads"]["q"], pending["grads"]["s"]
        kw = dict(chunk=sim.codec.chunk)
        got = K.ncv_weighted_sum_q(q, s, coef, **kw)
        want = ref.ncv_weighted_sum_q_ref(q, s, coef, **kw)
    else:
        flat = ravel_stack(pending["grads"])[0].contiguous()
        if kname == "rank_band_mean":
            alive = (weights > 0).float()
            m_v = torch.sum(alive)
            lo = torch.clamp(torch.floor((m_v - 1.0) / 2.0), min=0.0)
            if sim.fl.aggregator == "trimmed_mean":
                lo = torch.minimum(torch.clamp(torch.floor(
                    sim._agg_opts["trim_frac"] * m_v), min=0.0), lo)
            got = R.rank_band_mean(flat, alive, lo, m_v - 1.0 - lo)
            want = rref.rank_band_mean_ref(flat, alive, lo, m_v - 1.0 - lo)
        else:
            if sim.fl.aggregator == "norm_clip":
                coef = coef * aggregators._norm_clip_factors(
                    flat, weights, sim._agg_opts["clip_mult"])
            got = K.ncv_weighted_sum(flat, coef)
            want = ref.ncv_weighted_sum_ref(flat, coef)
    e = check_scaled(f"{kname} on the round's inputs", got[0], want[0])
    check_close(f"{kname} norm on the round's inputs", got[1], want[1],
                1e-4, 1e-6)
    return e


def byzantine_margin_check(torch, card, world):
    """2 of 10 clients at byzantine `scale` 10 in one round, the same draws
    for all four runs: the param step ||theta_1 - theta_0||^2 under `mean`
    against its honest run must grow past 10x, under `trimmed_mean`
    (trim_frac 0.25) stay under 4x, and the first ratio exceed the second
    tenfold (`tests/test_faults.py::test_byzantine_scale_owns_mean_not_
    trimmed`'s margins)."""
    from repro_torch.fed import FLConfig, Simulator

    params0 = world["params0"]
    # clients 0 and 1 are byzantine (ceil(0.05 x 40) = 2), 10..17 honest
    idx = torch.tensor([0, 1] + list(range(10, 18)))
    steps = {}
    for agg in ("mean", "trimmed_mean"):
        aopts = dict(trim_frac=0.25) if agg == "trimmed_mean" else {}
        for byz in (True, False):
            fopts = dict(fault="byzantine", byz_frac=0.05, byz_scale=10.0) \
                if byz else {}
            fl = FLConfig.make(**FL_KW, ncv_beta=0.0, aggregator=agg,
                               **aopts, **fopts)
            sim = Simulator(world["task"], params0, world["train"], fl,
                            seed=0)
            sel = sim._draw_sel(idx)
            sim.run_round(draws=(idx, sel))
            steps[agg, byz] = float(sum(
                torch.sum((sim.params[k] - params0[k].cuda()) ** 2)
                for k in params0))
    r_mean = steps["mean", True] / steps["mean", False]
    r_trim = steps["trimmed_mean", True] / steps["trimmed_mean", False]
    require(r_mean > 10.0 and r_trim < 4.0 and r_mean > 10.0 * r_trim,
            f"byzantine scale 10, 2 of 10: param step ratio to the honest "
            f"run {r_mean:.4f} under mean, {r_trim:.4f} under trimmed_mean "
            f"(want > 10, < 4, and the first > 10x the second)")
    say(f"byzantine scale 10, 2 of 10 clients, on {card}: param step "
        f"||theta_1 - theta_0||^2 {steps['mean', True]:.6e} under mean "
        f"({r_mean:.4f}x its honest run), {steps['trimmed_mean', True]:.6e} "
        f"under trimmed_mean ({r_trim:.4f}x); margins > 10, < 4, ratio "
        f"{r_mean / r_trim:.2f} > 10")


def faults_samplers_phase(torch, np, K, R, ref, rref, kernels, card, world):
    """The importance, similarity and external samplers and the five fault
    models on the card at the slice's protocol, each replayed on the CPU
    round by round from the card's state and on the card's draws and
    plans; returns the launch count of each run's server kernel, from the
    first run that uses it."""
    from repro_torch.fed import FLConfig, Simulator
    from repro_torch.fed.sampling import SKETCH_KEY
    from repro_torch.utils.tree_math import ravel_stack, tree_map

    class Recording(Simulator):
        """Keeps each round's draws, and by reference its starting params
        and state and its client section's output."""

        def draw_round(self):
            d = super().draw_round()
            self.draws.append(d)
            return d

        def _client_section_local(self, params, state, draws):
            pending = super()._client_section_local(params, state, draws)
            self.record.append((params, state, pending))
            return pending

    train, test, task = world["train"], world["test"], world["task"]
    params0 = world["params0"]
    to_cpu = lambda tree: tree_map(lambda x: x.cpu(), tree)  # noqa: E731
    counts = {}
    for label, kw, rounds, kname in FAULT_RUNS:
        fl = FLConfig.make(**FL_KW, ncv_beta=0.0, **kw)
        external = fl.sampler == "external"

        def drive(sim, n, first=0):
            """n rounds; the external run writes its tables before each."""
            if not external:
                return sim.run_rounds(n)
            rows = []
            for r in range(first, first + n):
                sim.sampler, sim.faults = external_tables(torch, r)
                rows.append(sim.run_round())
            return {k: np.float32([row[k] for row in rows]) for k in rows[0]}

        # warm-up on a throwaway simulator (first launches), which then
        # gives one profiled round
        warm = Simulator(task, params0, train, fl, seed=1)
        drive(warm, 1)
        sim = Recording(task, params0, train, fl, seed=0)
        sim.record, sim.draws = [], []
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        diags = drive(sim, rounds)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / rounds
        launches = {n: fn.launches for n, fn in kernels.items()}
        want = {n: 0 for n in kernels}
        want["rloo_combine"] = 2 * rounds
        want[kname] = rounds
        require(launches == want, f"{label}: launches {launches}, want "
                                  f"{want}")
        counts.setdefault(kname, launches[kname])
        if external:
            warm.sampler, warm.faults = external_tables(torch, 0)
        dev_ms, dev_ops = device_ms_per_round(torch, warm,
                                              [warm.draw_round()])
        live = diags.get("live", np.full(rounds, 10.0, np.float32))
        up = live * sim.codec.bytes_per_client() + FAULT_AUX_BYTES[fl.sampler]
        require(np.array_equal(diags["bytes_up"], up.astype(np.float32)),
                f"{label}: bytes_up {diags['bytes_up']}, want {up}")
        pre = sim.evaluate(test)
        finite = all(bool(torch.isfinite(v).all()) for v in
                     sim.params.values()) and all(
            np.isfinite(v).all() for v in diags.values()) and \
            math.isfinite(pre)
        require(finite, f"{label}: non-finite params, diagnostics or "
                        f"accuracy")
        say(f"{label} on {card}: {rounds} rounds, sec_per_round={sec:.4f}, "
            f"device ms a round {dev_ms:.3f} in {dev_ops:.0f} device "
            f"operations (torch.profiler), launches {launches}, bytes_up="
            f"{[float(x) for x in diags['bytes_up']]}, live="
            f"{[float(x) for x in live]}, agg_norm="
            f"{[float(x) for x in diags['agg_norm']]}, pre={pre:.4f}")
        if external:
            # round 1: every slot dead, a finite no-op
            p1, st1, _ = sim.record[1]
            p2, st2, _ = sim.record[2]
            require(float(diags["agg_norm"][1]) == 0.0 and
                    float(diags["live"][1]) == 0.0 and
                    all(torch.equal(p1[k], p2[k]) for k in p1) and
                    torch.equal(st1["alphas"], st2["alphas"]),
                    f"{label}: the all-dead round is not a no-op")
            say(f"{label}: round 1, every slot dead: agg_norm 0, live 0, "
                f"params and alphas bitwise unchanged")

        # the server kernel against its plain version on each round's own
        # inputs (these launches are not counted)
        k_err = max(server_kernel_inputs_held(torch, K, R, ref, rref, kname,
                                              sim, pend)
                    for _, _, pend in sim.record)

        # the same draws and plans on the CPU, each round from the card's
        # state: the client section held to the card's (uploads, aux and
        # returned client state, up to the near-tie share; the weights, HT
        # factors and survival mask bitwise), then its server section takes
        # the card's and must land on the card's params and every state
        # field, sampler and fault state included
        cpu = Simulator(task, params0, train, fl, seed=0, device="cpu")
        margin, n_off, n_vals, sketch_err = 0.0, 0, 0, 0.0
        for i, (p_card, st_card, pend_card) in enumerate(sim.record):
            cpu.params, cpu._state = to_cpu(p_card), to_cpu(dict(st_card))
            d = sim.draws[i]
            pend = cpu._client_section_local(
                cpu.params, cpu._state,
                d._replace(u=None if d.u is None else d.u.cpu()))
            for part in ("weights", "invp", "alive", "live"):
                require((part in pend) == (part in pend_card) and (
                    part not in pend or torch.equal(pend_card[part].cpu(),
                                                    pend[part])),
                        f"{label} round {i}: {part} differs on the CPU")
            identity = sim.codec.name == "identity"
            if not identity:
                off, nv = compare_uploads(sim.codec, pend_card["grads"],
                                          pend["grads"], f"{label} round {i}")
                n_off, n_vals = n_off + off, n_vals + nv
            aux_card, aux_cpu = dict(pend_card["aux"]), dict(pend["aux"])
            if SKETCH_KEY in aux_cpu:
                # a sketch entry sums +-g_j / sqrt(d) over N coordinates and
                # can cancel to near 0, so each is held to its own sum's
                # scale, ||g_u||_1 / sqrt(d), the dot product's error bound
                flat = ravel_stack(pend["grads"])[0] if identity else \
                    sim.codec.decode(pend["grads"])
                scale = flat.abs().sum(1, keepdim=True) / math.sqrt(
                    aux_cpu[SKETCH_KEY].shape[1])
                err = (aux_card.pop(SKETCH_KEY).cpu()
                       - aux_cpu.pop(SKETCH_KEY)).abs()
                sketch_off = int((err > PARAM_ATOL + PARAM_RTOL * scale)
                                 .sum())
                require(sketch_off == 0,
                        f"{label} round {i}: {sketch_off} sketch values off "
                        f"rtol {PARAM_RTOL} x ||g_u||_1 / sqrt(d)")
                sketch_err = max(sketch_err, float((err / scale).max()))
            parts = [("aux", aux_card, aux_cpu),
                     ("cstates", pend_card["cstates"], pend["cstates"])]
            if identity:
                parts.append(("grads", pend_card["grads"], pend["grads"]))
            for part, card_, cpu_ in parts:
                off, nv = off_tolerance(torch, card_, cpu_)
                n_off, n_vals = n_off + off, n_vals + nv
                require(off <= MAX_OFF_SHARE * nv,
                        f"{label} round {i} {part}: {off} of {nv} values "
                        f"off the tolerance")
            pend = {k: to_cpu(v) for k, v in pend_card.items()}
            cpu.params, cpu._state, cdiag = cpu._server_section(
                cpu.params, cpu._state, pend, i + 1)
            after = sim.record[i + 1] if i + 1 < len(sim.record) else (
                sim.params, sim._state)
            require(set(after[1]) == set(cpu._state),
                    f"{label}: state fields {sorted(after[1])} on the card, "
                    f"{sorted(cpu._state)} on the CPU")
            cstate = cpu._state
            if external and i + 1 < len(sim.record):
                # the host wrote the next round's tables in between
                cstate = dict(cstate, sampler=to_cpu(after[1]["sampler"]),
                              faults=to_cpu(after[1]["faults"]))
            margin = max(margin, margin_of(after[0], cpu.params),
                         margin_of(after[1], cstate))
            np.testing.assert_allclose(diags["agg_norm"][i],
                                       float(cdiag["agg_norm"]), rtol=1e-3,
                                       atol=1e-12)
            for k in ("bytes_up", "live"):
                require(k not in cdiag or float(cdiag[k]) == float(
                    diags[k][i]), f"{label}: {k} differs from the CPU replay")
        require(margin <= 1.0, f"{label}: card vs CPU replay margin "
                               f"{margin:.4f} > 1")
        say(f"{label}: {kname} held to its plain version on each round's "
            f"inputs, max abs err {k_err:.3e} (tol rtol {KERNEL_RTOL} atol "
            f"{KERNEL_ATOL} x max|agg|); card vs CPU replay, round by round "
            f"from the card's state on its draws and plans: params and state "
            f"{sorted(cpu._state)} margin {margin:.4f} (tol rtol {PARAM_RTOL} "
            f"atol {PARAM_ATOL}: margin <= 1), client values off the "
            f"tolerance {n_off} of {n_vals} (at most {MAX_OFF_SHARE} of "
            f"each part), weights / HT factors / survival bitwise, agg_norm "
            f"rtol 1e-3, bytes_up and live equal" + (
                f"; sketch err / (||g_u||_1 / sqrt(d)) at most "
                f"{sketch_err:.3e} (tol {PARAM_RTOL}, + atol {PARAM_ATOL})"
                if fl.sampler == "similarity" else ""))
    byzantine_margin_check(torch, card, world)
    return counts


# the depth-K ring, the host store and checkpoints (phase 4, last FL part)
RING_ROUNDS = 6
SCALE_M = 10_000               # clients of the host store at scale
SMALL_M = 1_000                # ... against which its device bytes stay
HOST_REPS = 3                  # timed turns of each store, interleaved


def count_launches(torch, kernels, counts, fn):
    """fn() between two synchronizations, every kernel's count set to 0
    first; adds the launches to `counts`.  Returns (fn's result, seconds,
    launches by kernel)."""
    torch.cuda.synchronize()
    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    got = {n: f.launches for n, f in kernels.items()}
    for n, c in got.items():
        counts[n] += c
    return out, sec, got


def spread(xs):
    """'median [min, max]' of a few times."""
    xs = sorted(xs)
    return f"{xs[len(xs) // 2]:.4f} [{xs[0]:.4f}, {xs[-1]:.4f}]"
SCALE_ROUNDS = 3


def same_bits(a, b):
    """Whether two trees (on any devices) are bitwise equal."""
    import torch
    from repro_torch.utils.tree_math import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
        for x, y in zip(la, lb))


def sim_same(a, b):
    """Params and the whole state of two simulators, bitwise."""
    sa, sb = a._get_state(), b._get_state()
    return same_bits(a.params, b.params) and set(sa) == set(sb) and all(
        same_bits(sa[k], sb[k]) for k in sa)


def unrolled_on(sim, n, k, draws=None):
    """The hand-unrolled depth-k pipeline on a sync simulator's sections:
    issue at round r, apply at round r + k, oldest first; without `draws`
    each round draws from `sim` as it stands."""
    ring = []
    for i in range(n):
        d = sim.draw_round() if draws is None else draws[i]
        pending = sim._client_section_local(sim.params, sim._state, d)
        if len(ring) == k:
            sim.params, sim._state, _ = sim._server_section(
                sim.params, sim._state, ring.pop(0), i + 1)
        ring.append(pending)
    return sim


def scale_world(np, world, m):
    """`m` clients whose index rows address the slice's training images as
    one shared pool (`benchmarks/bench_scalability.py`'s layout), 64
    samples each."""
    train = world["train"]
    n_max = FL_BASE["k_micro"] * FL_BASE["micro_batch"]
    pool = len(train["labels"])
    return dict(images=train["images"], labels=train["labels"],
                client_idx=(np.arange(m * n_max, dtype=np.int64) % pool)
                .reshape(m, n_max),
                client_sizes=np.full((m,), n_max, np.int64))


def pipeline_store_ckpt_phase(torch, np, kernels, card, world):
    """The depth-K ring (K = 1, 2, 3), the host store (at 40 clients, and
    fedncv+ at 10,000) and checkpoints on the card; returns this phase's
    launch count of each kernel."""
    import shutil
    from repro_torch import checkpoint
    from repro_torch.fed import FLConfig, Simulator

    class Recording(Simulator):
        """Keeps each round's draws."""

        def draw_round(self):
            d = super().draw_round()
            self.draws.append(d)
            return d

    train, task, params0 = world["train"], world["task"], world["params0"]
    lit = dict(FL_KW, ncv_beta=1.0)
    counts = {n: 0 for n in kernels}

    def counted(fn):
        return count_launches(torch, kernels, counts, fn)

    # -- the ring: FedNCV beta = 1 at K = 1, 2, 3; K = 2 with dropout and
    # the importance sampler
    runs = [(f"ring-k{k}", k, {}) for k in (1, 2, 3)] + [
        ("ring-k2-dropout+importance", 2,
         dict(fault="dropout", sampler="importance"))]
    for label, k, extra in runs:
        fl0 = FLConfig.make(**lit, **extra)
        fl = FLConfig.make(**lit, staleness=k, **extra)
        sim = Recording(task, params0, train, fl, seed=0)
        sim.draws = []
        diags, sec, got = counted(lambda: sim.run_rounds(RING_ROUNDS))
        # the sync round on the same draws, timed right after
        sync = Simulator(task, params0, train, fl0, seed=0)
        _, sync_sec, _ = counted(lambda: sync.run_rounds(
            RING_ROUNDS, draws=sim.draws))
        want = {n: 0 for n in kernels}
        want.update(rloo_combine=2 * RING_ROUNDS,
                    ncv_weighted_sum=RING_ROUNDS)
        require(got == want, f"{label}: launches {got}, want {want}")
        zero = all(np.all(v[:k] == 0.0) for v in diags.values())
        require(zero and np.all(diags["agg_norm"][k:] > 0.0),
                f"{label}: bubble rows {diags}")
        ref = unrolled_on(Simulator(task, params0, train, fl0, seed=0),
                          RING_ROUNDS, k, None if extra else sim.draws)
        require(sim_same(sim, ref), f"{label}: the ring differs from the "
                                    f"hand-unrolled loop on the card")
        chunked = Simulator(task, params0, train, fl, seed=0)
        parts = [chunked.run_rounds(2) for _ in range(RING_ROUNDS // 2)]
        require(sim_same(sim, chunked) and all(
            np.array_equal(v, np.concatenate([p[key] for p in parts]))
            for key, v in diags.items()),
            f"{label}: run_rounds(2) x {RING_ROUNDS // 2} differs from "
            f"run_rounds({RING_ROUNDS})")
        cpu = Simulator(task, params0, train, fl, seed=0, device="cpu")
        cdiags = cpu.run_rounds(RING_ROUNDS, draws=[
            d._replace(u=None if d.u is None else d.u.cpu())
            for d in sim.draws])
        margin = max(margin_of(sim.params, cpu.params),
                     margin_of(sim._state, cpu._state))
        require(margin <= 1.0, f"{label}: card vs CPU replay margin "
                               f"{margin:.4f} > 1")
        np.testing.assert_allclose(diags["agg_norm"], cdiags["agg_norm"],
                                   rtol=1e-3)
        require(all(np.array_equal(diags[key], cdiags[key])
                    for key in ("bytes_up", "live") if key in diags),
                f"{label}: bytes_up or live differs from the CPU replay")
        finite = all(bool(torch.isfinite(v).all())
                     for v in sim.params.values())
        require(finite, f"{label}: non-finite params")
        say(f"{label} on {card}: {RING_ROUNDS} rounds, sec_per_round="
            f"{sec / RING_ROUNDS:.4f} (sync on its draws "
            f"{sync_sec / RING_ROUNDS:.4f}), launches {got} (each bubble's "
            f"server section runs on zero pending), agg_norm="
            f"{[float(x) for x in diags['agg_norm']]}, bytes_up="
            f"{[float(x) for x in diags['bytes_up']]}" + (
                f", live={[float(x) for x in diags['live']]}"
                if "live" in diags else ""))
        say(f"{label}: {k} bubble rows all 0; bitwise equal to the "
            f"hand-unrolled client/server loop on the card and to "
            f"run_rounds(2) x {RING_ROUNDS // 2}; card vs CPU replay of its "
            f"draws: params and state margin {margin:.4f} (tol rtol "
            f"{PARAM_RTOL} atol {PARAM_ATOL}: margin <= 1), agg_norm rtol "
            f"1e-3, bytes_up and live equal")

    # -- the host store against the device store, bitwise, at 40 clients
    host_runs = (("fedncv", 0, lit), ("scaffold", 0, FL_BASE),
                 ("fedncv+", 0, FL_BASE), ("fedncv", 2, lit),
                 ("fedncv-dropout", 0, dict(lit, fault="dropout")))
    for label, k, kw in host_runs:
        kw = dict(kw, method=label.split("-")[0], staleness=k)
        dev = Simulator(task, params0, train, FLConfig.make(**kw), seed=0)
        host = Simulator(task, params0, train,
                         FLConfig.make(**kw, store="host"), seed=0)
        dropped = 0
        for _ in range(3):
            # each store draws from its own generators, as a user's run
            d, dh = dev.draw_round(), host.draw_round()
            require(torch.equal(d.idx, dh.idx) and torch.equal(d.sel, dh.sel),
                    f"host-{label}: the two stores drew differently")
            h_before = {n: tree_clone(host._host.get(n))
                        for n in host._host_state_names}
            rd = dev.run_round(draws=d)
            rh = host.run_round(draws=dh)
            require(rd == rh and sim_same(dev, host),
                    f"host-{label}-k{k}: a round differs from the device "
                    f"store's")
            if d.plan is not None:
                alive = d.plan["alive"]
                for slot, u in enumerate(d.idx.tolist()):
                    if float(alive[slot]) == 0.0:
                        dropped += 1
                        require(all(same_bits(row_of(v, u),
                                              row_of(host._host.get(n), u))
                                    for n, v in h_before.items()),
                                f"host-{label}: a dropped client's row "
                                f"was written")
        # then 3 x 3 rounds by run_rounds, the stores taking turns
        secs = {"device": [], "host": []}
        for _ in range(HOST_REPS):
            dd, sd, gd = counted(lambda: dev.run_rounds(3))
            dh, sh, gh = counted(lambda: host.run_rounds(3))
            require(gd == gh and all(np.array_equal(dd[x], dh[x])
                                     for x in dd) and sim_same(dev, host),
                    f"host-{label}-k{k}: run_rounds(3) differs from the "
                    f"device store's (launches {gd} / {gh})")
            secs["device"].append(sd / 3)
            secs["host"].append(sh / 3)
        m = host.host_metrics()
        rounds = 3 + 3 * HOST_REPS
        say(f"host-{label}-k{k} on {card}: {rounds} rounds, each round's "
            f"params, state and diagnostics bitwise the device store's (3 "
            f"by run_round, then run_rounds(3) x {HOST_REPS}), launches "
            f"{gh} a run_rounds(3) as the device store's" + (
                f", {dropped} dropped slots' rows not written"
                if d.plan is not None else "") +
            f"; sec_per_round {spread(secs['host'])} (device store "
            f"{spread(secs['device'])}), staged "
            f"{m['staged_bytes_in'] / rounds:.0f} B in and "
            f"{m['staged_bytes_out'] / rounds:.0f} B out a round, "
            f"overlap_frac {m['prefetch_overlap_frac']:.3f}")
        host.close()

    # -- the host store at scale: fedncv+ (an (M, N) table h) at 10,000
    # clients, host against device
    sims, stats = {}, {}
    for store in ("device", "host"):
        fl = FLConfig.make(method="fedncv+", **dict(FL_BASE,
                                                    n_clients=SCALE_M),
                           store=store)
        t0 = time.perf_counter()
        sims[store] = Simulator(task, params0,
                                scale_world(np, world, SCALE_M), fl, seed=0)
        torch.cuda.synchronize()
        stats[store] = dict(build_s=time.perf_counter() - t0)
        sims[store].run_rounds(1)   # the worker, the staging buffers
    m0 = sims["host"].host_metrics()
    secs = {"device": [], "host": []}
    for _ in range(HOST_REPS):      # the stores take turns
        for store, sim in sims.items():
            _, sec, _ = counted(lambda: sim.run_rounds(SCALE_ROUNDS))
            secs[store].append(sec / SCALE_ROUNDS)
    for store, sim in sims.items():
        m = sim.host_metrics()
        staged = 0 if store == "device" else sum(
            m[x] - m0[x] for x in ("staged_bytes_in", "staged_bytes_out"))
        stats[store].update(
            device_state_bytes=sim.device_state_bytes(),
            host_state_bytes=sim.host_state_bytes(),
            host_mem_peak=m["host_mem_peak"],
            staged_bytes_per_round=staged / (HOST_REPS * SCALE_ROUNDS),
            overlap_frac=m["prefetch_overlap_frac"])
    dev, host = sims["device"], sims["host"]
    require(same_bits(dev.params, host.params) and
            same_bits(dev.h_sum, host.h_sum) and same_bits(dev.h, host.h),
            f"fedncv+ at M = {SCALE_M}: the host store's params or h differ "
            f"from the device store's")
    host.close()
    del dev, host, sims
    torch.cuda.empty_cache()
    small = Simulator(task, params0, scale_world(np, world, SMALL_M),
                      FLConfig.make(method="fedncv+", **dict(
                          FL_BASE, n_clients=SMALL_M), store="host"), seed=0)
    small.run_rounds(1)
    require(small.device_state_bytes() ==
            stats["host"]["device_state_bytes"],
            f"host store: device bytes {small.device_state_bytes()} at "
            f"M = {SMALL_M}, {stats['host']['device_state_bytes']} at M = "
            f"{SCALE_M}")
    small.close()
    for store, st in stats.items():
        say(f"fedncv+ at M = {SCALE_M} under store={store} on {card}: "
            f"1 + {HOST_REPS} x {SCALE_ROUNDS} rounds, sec_per_round "
            f"{spread(secs[store])}, " + ", ".join(
                f"{k}={v:.4f}" if isinstance(v, float) and v < 1e6 else
                f"{k}={v:.0f}" for k, v in st.items()))
    say(f"fedncv+ at M = {SCALE_M}: host params, h_sum and the whole h "
        f"table bitwise the device store's; host device_state_bytes equal "
        f"at M = {SMALL_M} and {SCALE_M} "
        f"({stats['host']['device_state_bytes']} B)")

    # -- checkpoints: save at round 3 with K = 2, restore into a fresh
    # simulator, 3 more rounds == 6 uninterrupted, generators included
    for store in ("device", "host"):
        fl = FLConfig.make(**lit, staleness=2, store=store)
        whole = Simulator(task, params0, train, fl, seed=0)
        rows = whole.run_rounds(RING_ROUNDS)
        first = Simulator(task, params0, train, fl, seed=0)
        rows1 = first.run_rounds(3)
        directory = str(ROOT / "build" / "chip_smoke_ckpt" / store)
        shutil.rmtree(directory, ignore_errors=True)
        t0 = time.perf_counter()
        checkpoint.save_sim(directory, first)
        save_ms = (time.perf_counter() - t0) * 1e3
        size = Path(directory, "3.ckpt").stat().st_size
        resumed = Simulator(task, params0, train, fl, seed=0)
        t0 = time.perf_counter()
        checkpoint.restore_sim(directory, resumed)
        restore_ms = (time.perf_counter() - t0) * 1e3
        rows2 = resumed.run_rounds(3)
        gens = all(torch.equal(g.get_state(), resumed._generators()[n]
                               .get_state())
                   for n, g in whole._generators().items())
        require(sim_same(whole, resumed) and gens and all(
            np.array_equal(v, np.concatenate([rows1[x], rows2[x]]))
            for x, v in rows.items()),
            f"checkpoint ({store}): the resumed run differs from the "
            f"uninterrupted one")
        refusals = []
        for bad in (dict(staleness=1, store=store),
                    dict(staleness=2, store="host" if store == "device"
                         else "device")):
            try:
                checkpoint.restore_sim(directory, Simulator(
                    task, params0, train, FLConfig.make(**lit, **bad),
                    seed=0))
            except ValueError as e:
                refusals.append(str(e)[:70])
            else:
                require(False, f"checkpoint ({store}): {bad} restored")
        shutil.rmtree(directory)
        for s in (whole, first, resumed):
            s.close()
        say(f"checkpoint (store={store}, K = 2, after round 3) on {card}: "
            f"{size} B, save {save_ms:.2f} ms, restore {restore_ms:.2f} ms "
            f"(host clock, file warm); 3 more rounds bitwise the "
            f"uninterrupted run's (params, state, rows, the 3 generators' "
            f"states); refused with ValueError: {refusals}")
    return counts


def tree_clone(tree):
    from repro_torch.utils.tree_math import tree_map
    return tree_map(lambda x: x.clone(), tree)


def row_of(tree, u):
    from repro_torch.utils.tree_math import tree_map
    return tree_map(lambda x: x[u], tree)


# the stateful wire (phase 4, after the ring): topk and lowrank with their
# per-client error feedback at the slice's protocol, 3 rounds each, beside
# the identity wire timed in the same call: (label, options over FL_KW at
# beta = 0, launches a round of each kernel)
CODEC_RUNS = (
    ("fedncv-identity", {}, dict(rloo_combine=2, ncv_weighted_sum=1)),
    ("fedncv-topk", dict(codec="topk"),
     dict(rloo_combine=2, ncv_weighted_sum=1)),
    ("fedncv-topk-0.16", dict(codec="topk", ratio=0.16),
     dict(rloo_combine=2, ncv_weighted_sum=1)),
    ("fedncv-lowrank", dict(codec="lowrank", rank=8),
     dict(rloo_combine=2)),
    ("fedavg-topk", dict(method="fedavg", codec="topk"),
     dict(ncv_weighted_sum=1)),
    ("fedncv+-topk", dict(method="fedncv+", codec="topk"), {}),
    ("median-topk", dict(aggregator="median", codec="topk"),
     dict(rloo_combine=2, rank_band_mean=1)),
    ("dropout-topk", dict(fault="dropout", drop_rate=0.5, codec="topk"),
     dict(rloo_combine=2, ncv_weighted_sum=1)),
)
# bytes a client puts on the wire at N = 62,006, the reference's accounting
# (topk: k = round(ratio N) values and uint16 indices; lowrank rank 8: U
# 6,032 + V 1,840 + dense 686 floats)
CODEC_BYTES = {("identity", None): 248024, ("topk", 0.1): 37206,
               ("topk", 0.16): 59526, ("lowrank", 8): 34232}
CODEC_ROUNDS = 3


def codec_kw(kw):
    """A codec run's FLConfig.make keywords: FL_KW at beta = 0, or a
    method's defaults over FL_BASE."""
    method = kw.get("method", "fedncv")
    base = dict(FL_KW, ncv_beta=0.0) if method == "fedncv" else FL_BASE
    return dict(base, **kw)


def codec_phase(torch, np, kernels, card, world):
    """The topk and lowrank wires on the card: each run's launches, bytes,
    time and device work a round, a second card run bitwise, a CPU replay
    round by round from the card's state; the host store against the
    device store, the ring at K = 1 and 2 against the unrolled loop, and a
    checkpoint resume, all bitwise.  Returns this phase's launch count of
    each kernel."""
    import shutil
    from repro_torch import checkpoint
    from repro_torch.fed import FLConfig, Simulator
    from repro_torch.utils.tree_math import tree_leaves, tree_map

    class Recording(Simulator):
        """Keeps each round's draws, and (by reference) its starting params
        and state and its client section's output."""

        def draw_round(self):
            d = super().draw_round()
            self.draws.append(d)
            return d

        def _client_section_local(self, params, state, draws, batch=None):
            pending = super()._client_section_local(params, state, draws,
                                                    batch)
            self.record.append((params, state, pending))
            return pending

    def recording(fl, seed=0):
        sim = Recording(task, params0, train, fl, seed=seed)
        sim.draws, sim.record = [], []
        return sim

    train, test, task = world["train"], world["test"], world["task"]
    params0 = world["params0"]
    to_cpu = lambda tree: tree_map(lambda x: x.cpu(), tree)  # noqa: E731
    counts = {n: 0 for n in kernels}

    def counted(fn):
        return count_launches(torch, kernels, counts, fn)

    for label, kw, per_round in CODEC_RUNS:
        fl = FLConfig.make(**codec_kw(kw))
        warm = Simulator(task, params0, train, fl, seed=1)
        warm.run_rounds(1)
        sim = recording(fl)
        draws = [sim.draw_round() for _ in range(CODEC_ROUNDS)]
        diags, sec, got = counted(lambda: sim.run_rounds(CODEC_ROUNDS,
                                                         draws=draws))
        want = {n: CODEC_ROUNDS * per_round.get(n, 0) for n in kernels}
        require(got == want, f"{label}: launches {got}, want {want}")
        dev_ms, dev_ops = device_ms_per_round(torch, warm,
                                              [warm.draw_round()])
        codec = sim.codec
        opt = dict(identity=None, topk=0.1, lowrank=8)[fl.codec]
        bpc = CODEC_BYTES[(fl.codec, fl.codec_opts.get(
            "ratio", fl.codec_opts.get("rank", opt)))]
        require(codec.bytes_per_client() == bpc,
                f"{label}: {codec.bytes_per_client()} bytes a client, the "
                f"reference's accounting gives {bpc}")
        aux = 16 if fl.method == "fedncv" else 0
        alive = [None if d.plan is None else float(d.plan["alive"].sum())
                 for d in draws]
        up = [(10 if a is None else a) * bpc + 10 * aux for a in alive]
        require(list(diags["bytes_up"]) == up,
                f"{label}: bytes_up {diags['bytes_up']}, want {up}")
        finite = all(bool(torch.isfinite(v).all()) for v in
                     sim.params.values()) and all(
            bool(torch.isfinite(v).all()) for v in
            tree_leaves(sim._state.get("ef", {}))) and all(
            np.isfinite(v).all() for v in diags.values())
        require(finite, f"{label}: non-finite params, ef or diagnostics")
        rerun = Simulator(task, params0, train, fl, seed=0)
        rerun.run_rounds(CODEC_ROUNDS, draws=draws)
        require(sim_same(sim, rerun), f"{label}: a second card run of the "
                                      f"same draws differs")
        pre = sim.evaluate(test)
        say(f"{label} on {card}: {CODEC_ROUNDS} rounds, bytes_up="
            f"{[float(b) for b in diags['bytes_up']]} ({bpc} B a client), "
            f"sec_per_round={sec / CODEC_ROUNDS:.4f}, device ms a round "
            f"{dev_ms:.3f} in {dev_ops:.0f} device operations "
            f"(torch.profiler), launches a round "
            f"{ {n: c / CODEC_ROUNDS for n, c in got.items() if c} }, "
            f"agg_norm={[float(x) for x in diags['agg_norm']]}, "
            f"pre={pre:.4f}; a second card run bitwise equal")

        # the CPU, round by round from the card's state: its client section
        # (decoded uploads, aux, returned state with the new error
        # feedback) held to the card's up to the near-tie share, then its
        # server section on the card's pending must land on the card's
        # params and every state field
        cpu = Simulator(task, params0, train, fl, seed=0, device="cpu")
        margin, n_off, n_vals = 0.0, 0, 0
        for i, (p_card, st_card, pend_card) in enumerate(sim.record):
            cpu.params, cpu._state = to_cpu(p_card), to_cpu(dict(st_card))
            pend = cpu._client_section_local(cpu.params, cpu._state,
                                             draws[i])
            off, nv = compare_uploads(codec, pend_card["grads"],
                                      pend["grads"], f"{label} round {i}")
            n_off, n_vals = n_off + off, n_vals + nv
            for part in ("aux", "cstates"):
                off, nv = off_tolerance(torch, pend_card[part], pend[part])
                n_off, n_vals = n_off + off, n_vals + nv
                require(off <= MAX_OFF_SHARE * nv,
                        f"{label} round {i} {part}: {off} of {nv} values off "
                        f"the tolerance")
            pend = {k: to_cpu(v) for k, v in pend_card.items()}
            cpu.params, cpu._state, cdiag = cpu._server_section(
                cpu.params, cpu._state, pend, i + 1)
            after = sim.record[i + 1] if i + 1 < len(sim.record) else (
                sim.params, sim._state)
            require(set(after[1]) == set(cpu._state) and
                    ("ef" in cpu._state) == codec.stateful,
                    f"{label}: state fields {sorted(after[1])} on the card, "
                    f"{sorted(cpu._state)} on the CPU")
            margin = max(margin, margin_of(after[0], cpu.params),
                         margin_of(after[1], cpu._state))
            np.testing.assert_allclose(diags["agg_norm"][i],
                                       float(cdiag["agg_norm"]), rtol=1e-3)
            require(float(cdiag["bytes_up"]) == float(diags["bytes_up"][i]),
                    f"{label}: bytes_up differs from the CPU replay")
        require(margin <= 1.0, f"{label}: card vs CPU replay margin "
                               f"{margin:.4f} > 1")
        say(f"{label}: card vs CPU replay, round by round from the card's "
            f"state: params and state {sorted(cpu._state)} margin "
            f"{margin:.4f} (tol rtol {PARAM_RTOL} atol {PARAM_ATOL}: margin "
            f"<= 1), client values off the tolerance {n_off} of {n_vals}, "
            f"agg_norm rtol 1e-3, bytes_up equal")

    # -- the host store against the device store, 6 rounds, round by round
    for label, kw in (("topk", dict(codec="topk")),
                      ("lowrank", dict(codec="lowrank", rank=8))):
        kw = codec_kw(kw)
        dev = Simulator(task, params0, train, FLConfig.make(**kw), seed=0)
        host = Simulator(task, params0, train,
                         FLConfig.make(**kw, store="host"), seed=0)
        secs = {"device": 0.0, "host": 0.0}
        for _ in range(RING_ROUNDS):
            d, dh = dev.draw_round(), host.draw_round()
            rd, sd, gd = counted(lambda: dev.run_round(draws=d))
            rh, sh, gh = counted(lambda: host.run_round(draws=dh))
            secs["device"] += sd
            secs["host"] += sh
            require(gd == gh and rd == rh and sim_same(dev, host),
                    f"host-{label}: a round differs from the device store's")
        m = host.host_metrics()
        say(f"host-{label} on {card}: {RING_ROUNDS} rounds, each round's "
            f"params, state (ef among {host.host_state_bytes()} B of host "
            f"tables) and diagnostics bitwise the device store's; "
            f"sec_per_round {secs['host'] / RING_ROUNDS:.4f} (device store "
            f"{secs['device'] / RING_ROUNDS:.4f}), staged "
            f"{m['staged_bytes_in'] / RING_ROUNDS:.0f} B in and "
            f"{m['staged_bytes_out'] / RING_ROUNDS:.0f} B out a round")
        host.close()

    # -- the ring at K = 1 and 2 under topk against the unrolled loop
    kw = codec_kw(dict(codec="topk"))
    for k in (1, 2):
        fl = FLConfig.make(**kw, staleness=k)
        sim = recording(fl)
        diags, sec, got = counted(lambda: sim.run_rounds(RING_ROUNDS))
        want = {n: 0 for n in kernels}
        want.update(rloo_combine=2 * RING_ROUNDS,
                    ncv_weighted_sum=RING_ROUNDS)
        require(got == want, f"ring-k{k}-topk: launches {got}, want {want}")
        ref = unrolled_on(Simulator(task, params0, train,
                                    FLConfig.make(**kw), seed=0),
                          RING_ROUNDS, k, sim.draws)
        require(sim_same(sim, ref), f"ring-k{k}-topk: the ring differs from "
                                    f"the hand-unrolled loop on the card")
        require(all(np.all(v[:k] == 0.0) for v in diags.values()),
                f"ring-k{k}-topk: bubble rows {diags}")
        say(f"ring-k{k}-topk on {card}: {RING_ROUNDS} rounds, sec_per_round="
            f"{sec / RING_ROUNDS:.4f}, launches {got}; bitwise the "
            f"hand-unrolled loop, {k} bubble rows all 0")

    # -- a K = 1 checkpoint after round 2 under topk, resumed
    fl = FLConfig.make(**kw, staleness=1)
    whole = Simulator(task, params0, train, fl, seed=0)
    rows = whole.run_rounds(5)
    first = Simulator(task, params0, train, fl, seed=0)
    rows1 = first.run_rounds(2)
    directory = str(ROOT / "build" / "chip_smoke_ckpt" / "topk")
    shutil.rmtree(directory, ignore_errors=True)
    checkpoint.save_sim(directory, first)
    size = Path(directory, "2.ckpt").stat().st_size
    resumed = Simulator(task, params0, train, fl, seed=0)
    checkpoint.restore_sim(directory, resumed)
    rows2 = resumed.run_rounds(3)
    require(sim_same(whole, resumed) and all(
        np.array_equal(v, np.concatenate([rows1[x], rows2[x]]))
        for x, v in rows.items()),
        "checkpoint (topk, K = 1): the resumed run differs from the "
        "uninterrupted one")
    shutil.rmtree(directory)
    say(f"checkpoint (topk, K = 1, after round 2) on {card}: {size} B; 3 "
        f"more rounds bitwise the uninterrupted run's (params, state with "
        f"ef, rows)")
    return counts


# the served round with streaming telemetry (phase 4, after the codecs):
# rounds of each run, the round a checkpoint is taken at, and the gvar_proxy
# check's tolerance against plain torch in f64 (each of its two terms is an
# f32 sum, so their difference also carries ~1e-6 of E_w ||g_u||^2)
SERVE_ROUNDS = 6
SERVE_SAVE_AT = 3
SERVE_TIMED = 10               # interleaved tracked / untracked rounds
GVAR_RTOL, GVAR_E2_ATOL = 1e-3, 1e-6


def gvar_plain(torch, pending, beta):
    """The cohort variance proxy max(E_w ||g_u||^2 - ||sum_u c_u g_u||^2,
    0) in plain torch (f64, on the CPU) from a round's uploads and weights
    (c: the Eq. 10-12 coefficients of the weights); and E_w ||g_u||^2."""
    from repro_torch.kernels.rloo.rloo import ncv_coefficients
    from repro_torch.utils.tree_math import ravel_stack
    g = ravel_stack(pending["grads"])[0].double().cpu()
    w = pending["weights"].cpu()
    p_w = w.double() / max(float(w.double().sum()), 1e-30)
    e2 = float((p_w * (g * g).sum(1)).sum())
    c = ncv_coefficients(w, beta).double()
    agg = (c[:, None] * g).sum(0)
    nsq = float((agg * agg).sum()) * float(pending.get("live", 1.0))
    return max(e2 - nsq, 0.0), e2


def serve_track_phase(torch, np, kernels, card, world):
    """The served FedNCV round (beta = 1, `track_variance`) under a
    `Coordinator` on the card, at the slice's FL world: a markov queue
    (check-in 0.5), deadline 2.0 s, a stdout + jsonl composite sink; K = 0
    under the fixed policy and K = 1 under token_bucket, 6 rounds each (K =
    1: 5 admission rounds and the drain).  Holds one row per round and
    `tools/flwatch.py --check`, gvar_proxy against plain torch, the tracked
    run bitwise an untracked one on the same tables, a save at round 3
    resumed bitwise (the jsonl truncated, bytes_up_cum continuous), and 2
    `rloo_combine` + 1 `ncv_weighted_sum` a round.  Returns this phase's
    launch count of each kernel."""
    import shutil
    from repro_torch import track
    from repro_torch.fed import Simulator
    from repro_torch.serve import ClientQueue, Coordinator, make_serve_config

    class Recording(Simulator):
        """Keeps the pending each round's server section applied."""

        def _server_section(self, params, state, pending, r):
            self.applied[r] = pending
            return super()._server_section(params, state, pending, r)

    train, task, params0 = world["train"], world["task"], world["params0"]
    kw = dict(FL_KW, ncv_beta=1.0)
    counts = {n: 0 for n in kernels}
    out_dir = ROOT / "build" / "chip_smoke_serve"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)

    def coordinator(k, policy, path=None):
        """A coordinator over a fresh simulator: tracked (a stdout + jsonl
        composite at `path`, track_variance) or, without a path,
        untracked."""
        fl = make_serve_config(**kw, staleness=k,
                               track_variance=path is not None)
        sink = None if path is None else track.composite(
            track.make_tracker("stdout"),
            track.make_tracker("jsonl", path=str(path)))
        sim = Recording(task, params0, train, fl, seed=0, tracker=sink)
        sim.applied = {}
        queue = ClientQueue(FL_BASE["n_clients"], avail="markov",
                            checkin_rate=0.5, seed=0)
        return Coordinator(sim, queue, policy=policy, deadline_s=2.0)

    def serve_rounds(c, k, first, last):
        """Rounds first..last of `c`, those past SERVE_ROUNDS - k through
        drain(); each counted.  Returns (step seconds, run_round seconds,
        launches) a round."""
        step_s, run_s, got = [], [], []
        for r in range(first, last + 1):
            fn = c.drain if r > SERVE_ROUNDS - k else c.step
            _, sec, g = count_launches(torch, kernels, counts, fn)
            step_s.append(sec)
            run_s.append(c._last_round_s)
            got.append(g)
        return step_s, run_s, got

    def rows_of(path):
        return [json.loads(x) for x in open(path)]

    def flwatch(path):
        gate = subprocess.run(
            [sys.executable, str(ROOT / "tools" / "flwatch.py"), str(path),
             "--check", "--expect-rounds", str(SERVE_ROUNDS)],
            capture_output=True, text=True, timeout=60)
        require(gate.returncode == 0, f"flwatch --check on {path}: "
                                      f"{gate.stdout} {gate.stderr}")
        return gate.stdout.strip()

    per_round = dict(rloo_combine=2, ncv_weighted_sum=1)
    for k, policy in ((0, "fixed"), (1, "token_bucket")):
        label = f"serve-k{k}-{policy}"
        path = out_dir / f"{label}.jsonl"
        a, b = coordinator(k, policy, path), coordinator(k, policy)
        step_s, run_s, got = serve_rounds(a, k, 1, SERVE_ROUNDS)
        serve_rounds(b, k, 1, SERVE_ROUNDS)
        want = {n: per_round.get(n, 0) for n in kernels}
        require(all(g == want for g in got),
                f"{label}: launches a round {got}, want {want}")
        require(sim_same(a.sim, b.sim), f"{label}: the tracked run's params "
                                        f"or state differ from the "
                                        f"untracked run's")
        a.sim.tracker.finish(dict(rounds=a.sim.round_idx))
        rows = [r for r in rows_of(path) if "round" in r]
        require([r["round"] for r in rows] ==
                list(range(1, SERVE_ROUNDS + 1)),
                f"{label}: rows {[r['round'] for r in rows]}")
        gate = flwatch(path)
        margin, gvars = 0.0, []
        for row in rows:
            r = row["round"]
            gvars.append(row["gvar_proxy"])
            require(row["gvar_proxy"] >= 0.0, f"{label}: round {r} "
                                              f"gvar_proxy < 0")
            if r <= k:
                require(all(v == 0.0 for x, v in row.items()
                            if x in ("agg_norm", "bytes_up", "gvar_proxy",
                                     "live")),
                        f"{label}: bubble row {row}")
                continue
            want_g, e2 = gvar_plain(torch, a.sim.applied[r], 1.0)
            tol = GVAR_E2_ATOL * e2 + GVAR_RTOL * abs(want_g)
            margin = max(margin, abs(row["gvar_proxy"] - want_g) / tol)
        require(margin <= 1.0, f"{label}: gvar_proxy {gvars} off plain "
                               f"torch, margin {margin:.4f}")
        size = path.stat().st_size
        # timing: a tracked and an untracked coordinator on the same
        # tables, their rounds interleaved (which goes first alternates),
        # after a warm round each; the tracked rows' emission split into
        # the wait for the device and the host's own work
        ptr = coordinator(k, policy, out_dir / f"{label}-timed.jsonl")
        pun = coordinator(k, policy)
        wait_s, emit_s = [], []
        emit = ptr.sim._emit

        def timed_emit(r, diag):
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = emit(r, diag)
            wait_s.append(t1 - t0)
            emit_s.append(time.perf_counter() - t1)
            return out
        for name in ("reset", "resume", "set_host_metrics"):
            setattr(timed_emit, name, getattr(emit, name))
        ptr.sim._emit = timed_emit
        for c in (ptr, pun):
            c.step()
        wait_s.clear()
        emit_s.clear()
        tr_s, un_s = [], []
        for i in range(SERVE_TIMED):
            pair = ((ptr, tr_s), (pun, un_s))
            for c, out in (pair if i % 2 else pair[::-1]):
                c.step()
                out.append(c._last_round_s)
        ms_tr, ops_tr = device_ms_per_call(torch, ptr.step, 2)
        ms_un, ops_un = device_ms_per_call(torch, pun.step, 2)
        say(f"{label} on {card}: {SERVE_ROUNDS} rounds, one row each "
            f"({gate}); Coordinator.step {spread(step_s)} s against its "
            f"run_round {spread(run_s)}; {SERVE_TIMED} interleaved rounds: "
            f"run_round tracked {spread(tr_s)}, untracked on the same "
            f"tables {spread(un_s)}, the tracked row's wait for the device "
            f"{spread(wait_s)} and host work {spread(emit_s)}; device ms a "
            f"round tracked {ms_tr:.3f} in {ops_tr:.0f} operations, "
            f"untracked {ms_un:.3f} in {ops_un:.0f} (torch.profiler); "
            f"jsonl {size / SERVE_ROUNDS:.0f} B a round; launches a round "
            f"{want}; admitted {[r['admitted'] for r in rows]}, "
            f"gvar_proxy {gvars} (plain torch margin {margin:.4f}: rtol "
            f"{GVAR_RTOL}, atol {GVAR_E2_ATOL} E_w||g||^2); params and "
            f"state bitwise the untracked run's")
        if not k:
            continue
        # a checkpoint at round 3 of the tracked K = 1 run, resumed into a
        # fresh coordinator on the same jsonl
        directory = out_dir / f"{label}-ckpt"
        a2 = coordinator(k, policy, out_dir / f"{label}-resumed.jsonl")
        serve_rounds(a2, k, 1, SERVE_SAVE_AT)
        a2.save(str(directory))
        serve_rounds(a2, k, SERVE_SAVE_AT + 1, SERVE_ROUNDS)
        a2.sim.tracker.finish(dict(rounds=a2.sim.round_idx))
        whole = [r for r in rows_of(a2.sim.tracker.children[1].path)
                 if "round" in r]
        c = coordinator(k, policy, out_dir / f"{label}-resumed.jsonl")
        c.restore(str(directory))
        kept = rows_of(out_dir / f"{label}-resumed.jsonl")
        require([r["round"] for r in kept] ==
                list(range(1, SERVE_SAVE_AT + 1)),
                f"{label}: after restore the jsonl holds {kept}")
        serve_rounds(c, k, SERVE_SAVE_AT + 1, SERVE_ROUNDS)
        c.sim.tracker.finish(dict(rounds=c.sim.round_idx))
        again = [r for r in rows_of(out_dir / f"{label}-resumed.jsonl")
                 if "round" in r]
        strip = lambda rs: [{x: v for x, v in r.items()  # noqa: E731
                             if x != "sec_per_round"} for r in rs]
        cum = list(np.cumsum([r["bytes_up"] for r in again]))
        require(sim_same(a2.sim, c.sim) and sim_same(a2.sim, a.sim)
                and strip(again) == strip(whole)
                and [r["bytes_up_cum"] for r in again] == cum,
                f"{label}: the run resumed at round {SERVE_SAVE_AT} differs "
                f"from the uninterrupted one")
        flwatch(out_dir / f"{label}-resumed.jsonl")
        say(f"{label}: saved at round {SERVE_SAVE_AT}, restored into a "
            f"fresh coordinator: the jsonl truncated to rounds 1-"
            f"{SERVE_SAVE_AT}, rounds {SERVE_SAVE_AT + 1}-{SERVE_ROUNDS} "
            f"(the last by drain) bitwise the uninterrupted run's params, "
            f"state and rows, bytes_up_cum continuous")
    shutil.rmtree(out_dir)
    return counts


BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
# flash kernel vs its plain version, (rtol, atol): f32, the reference
# kernel tests' 2e-4; bf16, both compute in f32 and round to bf16 once, so
# they differ by at most one bf16 step, at most 2^-7 of the value
FLASH_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (1e-2, 1e-3)}
SCAN_TOL = 2e-4                # sequential FMAs vs the doubling scan
# prefill logits vs teacher-forced decode at full width, f32: the
# reference's tests/test_decode_equivalence.py tolerances
DECODE_TOL = {"dense": 2e-3, "moe": 2e-3, "ssm": 5e-3, "hybrid": 5e-3,
              "encdec": 2e-3, "vlm": 2e-3}


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


def attn_pairs(s, causal, window, s_kv=None):
    """(query, key) pairs the mask keeps in one (b, h) plane of s queries
    and s_kv keys (default s), the masks top-left aligned."""
    s_kv = s if s_kv is None else s_kv
    total = 0
    for qi in range(s):
        lo = 0 if window is None else max(0, qi - window + 1)
        hi = min(qi, s_kv - 1) if causal else s_kv - 1
        total += max(0, hi - lo + 1)
    return total


# the flash kernel's shapes: (label, b, s, s_kv, h, kv, hd, dtype, causal,
# window, softcap), s the queries' length and s_kv the keys'; the first two
# are the prefill's (timed), then the same shapes in f32,
# tests/test_kernels.py's SWEEP in f32 and a ragged S
FLASH_CASES = (
    ("llama3.2-3b", 2, 4096, 4096, 24, 8, 128, "bfloat16", True, None,
     None),
    ("gemma2-9b local", 1, 8192, 8192, 16, 8, 256, "bfloat16", True, 4096,
     50.0),
    ("llama3.2-3b f32", 2, 4096, 4096, 24, 8, 128, "float32", True, None,
     None),
    ("gemma2-9b local f32", 1, 8192, 8192, 16, 8, 256, "float32", True, 4096,
     50.0),
    ("sweep 1", 2, 256, 256, 4, 2, 128, "float32", True, None, None),
    ("sweep 2", 1, 128, 128, 4, 4, 64, "float32", True, None, None),
    ("sweep 3", 1, 256, 256, 2, 1, 128, "float32", True, 128, None),
    ("sweep 4", 1, 256, 256, 2, 2, 128, "float32", True, None, 30.0),
    ("sweep 5", 2, 128, 128, 4, 2, 96, "float32", False, None, None),
    ("sweep 6", 1, 512, 512, 8, 8, 32, "float32", True, 64, 50.0),
    ("ragged", 1, 1000, 1000, 8, 2, 64, "float32", True, 300, None),
    ("ragged bf16", 2, 1000, 1000, 8, 2, 128, "bfloat16", True, None, None),
    # the bf16 tensor-core kernel: every head width it pads (8 and 96 to a
    # 64-column panel; 192, 256 on 64-key tiles), GQA r = 1..4, S below
    # one tile and ragged, B > 1 across the batch edge of its tensor maps,
    # and each mask
    ("bf16 S=1 r=4", 1, 1, 1, 4, 1, 128, "bfloat16", True, None, None),
    ("bf16 S=24 hd 8", 2, 24, 24, 6, 2, 8, "bfloat16", True, None, None),
    ("bf16 hd 64 r=3", 3, 130, 130, 6, 2, 64, "bfloat16", True, None, None),
    ("bf16 hd 96 r=1", 2, 300, 300, 4, 4, 96, "bfloat16", False, None, None),
    ("bf16 hd 192", 2, 257, 257, 4, 2, 192, "bfloat16", True, None, None),
    ("bf16 hd 256 r=4", 2, 1000, 1000, 8, 2, 256, "bfloat16", False, None,
     None),
    ("bf16 window", 2, 777, 777, 4, 2, 128, "bfloat16", True, 100, None),
    ("bf16 softcap", 2, 300, 300, 4, 1, 64, "bfloat16", False, None, 30.0),
    ("bf16 window softcap", 2, 700, 700, 4, 2, 256, "bfloat16", True, 200,
     50.0),
    # the moe family: llama4's chunked layers fold their two 8,192-token
    # chunks into the batch axis; kimi-k2's hd 112 pads to the 128 panel
    ("llama4 folded", 2, 8192, 8192, 40, 8, 128, "bfloat16", True, None,
     None),
    ("kimi-k2", 1, 2048, 2048, 64, 8, 112, "bfloat16", True, None, None),
    # zamba2-7b's shared attention block: MHA 32/32, hd 112
    ("zamba2-7b", 1, 2048, 2048, 32, 32, 112, "bfloat16", True, None, None),
    # whisper-medium's prefill, 8 clips: the encoder's bidirectional
    # self-attention over 1,500 frames, the decoder's causal self-attention
    # over its 448-token context, and its cross-attention, 448 queries onto
    # the 1,500 encoder states (ragged: 11 * 128 + 92 keys)
    ("whisper encoder", 8, 1500, 1500, 16, 16, 64, "bfloat16", False, None,
     None),
    ("whisper decoder self", 8, 448, 448, 16, 16, 64, "bfloat16", True, None,
     None),
    ("whisper cross", 8, 448, 1500, 16, 16, 64, "bfloat16", False, None,
     None),
    ("whisper encoder f32", 8, 1500, 1500, 16, 16, 64, "float32", False,
     None, None),
    ("whisper decoder self f32", 8, 448, 448, 16, 16, 64, "float32", True,
     None, None),
    ("whisper cross f32", 8, 448, 1500, 16, 16, 64, "float32", False, None,
     None),
    # llama-3.2-vision-11b's prefill: the self layers' causal GQA
    # attention, and the cross layers' 4,096 queries onto the 1,601 image
    # tokens (GQA, not causal; 1,601 = 25 * 64 + 1 = 12 * 128 + 65)
    ("llama-3.2-vision self", 2, 4096, 4096, 32, 8, 128, "bfloat16", True,
     None, None),
    ("llama-3.2-vision cross", 2, 4096, 1601, 32, 8, 128, "bfloat16", False,
     None, None),
    ("llama-3.2-vision self f32", 2, 4096, 4096, 32, 8, 128, "float32", True,
     None, None),
    ("llama-3.2-vision cross f32", 2, 4096, 1601, 32, 8, 128, "float32",
     False, None, None),
) + tuple(
    # keys of their own length, in both kernels: S_kv below and above S,
    # ragged, GQA, causal and window; where S > S_kv a window leaves the
    # rows qi >= S_kv + window - 1 no key (the mean over all S_kv values)
    (f"S_kv {label} {dt}", b, s, s_kv, h, kv, hd, dt, causal, window,
     softcap)
    for dt in ("bfloat16", "float32")
    for (label, b, s, s_kv, h, kv, hd, causal, window, softcap) in (
        ("above", 2, 96, 128, 4, 2, 64, False, None, None),
        ("below causal", 1, 1000, 300, 8, 2, 128, True, None, None),
        ("above causal GQA", 1, 300, 1000, 8, 2, 128, True, None, None),
        ("ragged", 3, 130, 777, 6, 3, 96, False, None, 30.0),
        ("window, no-key rows", 2, 257, 40, 4, 1, 64, True, 8, None),
        ("window only, no-key rows", 1, 300, 77, 4, 2, 256, False, 16,
         None),
        ("window above", 1, 130, 700, 6, 3, 128, True, 64, 50.0),
        ("one key", 1, 700, 1, 4, 2, 64, True, 50, None),
        ("one query", 3, 1, 333, 4, 2, 32, False, None, None),
    ))
# the shapes timed: the llama3.2-3b and gemma2-9b prefills, the moe,
# hybrid, encdec and vlm ones
FLASH_TIMED = ("llama3.2-3b", "gemma2-9b local", "llama4 folded", "kimi-k2",
               "zamba2-7b", "whisper encoder", "whisper decoder self",
               "whisper cross", "llama-3.2-vision self",
               "llama-3.2-vision cross")
# a plain version whose (B, H, S, S_kv) f32 logits exceed this goes a
# batch item and a KV head at a time
PLAIN_PIECE_BYTES = 4 << 30
# zamba2-7b's Mamba-2 prefill: C = H * N * P = 112 * 64 * 64 channels
ZAMBA2_HEADS = 112
ZAMBA2_SCAN = (1, 2048, ZAMBA2_HEADS * 64 * 64)
# the scan's shapes (B, S, C): falcon-mamba-7b's prefill (C = d_inner * N =
# 8,192 * 16), the reference's sweep, a batch axis, ragged lengths and
# zamba2-7b's prefill; the first and the last are timed
SCAN_CASES = ((1, 2048, 131072), (1, 128, 64), (1, 256, 256), (1, 512, 100),
              (1, 1024, 32), (4, 2048, 512), (1, 1000, 4099), (3, 77, 1000),
              ZAMBA2_SCAN)
SCAN_TIMED = (SCAN_CASES[0], ZAMBA2_SCAN)


def mamba_like_ab(torch, gen, shape):
    """a = exp(-dt n) and b as a Mamba-1 layer makes them: dt a softplus
    near 0.018, n = 1..16 along the channel axis (the state index)."""
    dt = torch.nn.functional.softplus(
        torch.randn(shape, generator=gen) * 0.5 - 4.0)
    n = torch.arange(shape[-1], dtype=torch.float32) % 16 + 1
    a = torch.exp(-dt * n)
    return a.cuda(), torch.randn(shape, generator=gen).cuda()


def mamba2_like_ab(torch, gen, shape, heads):
    """a and b as a Mamba-2 block makes them, drawn on the card: one
    a = exp(-dt exp(A_log)) per (step, head), broadcast over the head's
    N * P channels (`ops.scan_states`' materialised a), dt a softplus near
    0.018 and A_log drawn near 0 (the init's value) per head."""
    b_, s, c = shape
    a_log = torch.randn(heads, generator=gen, device="cuda") * 0.5
    dt = torch.nn.functional.softplus(torch.randn(
        b_, s, heads, generator=gen, device="cuda") * 0.5 - 4.0)
    a = torch.exp(-dt * torch.exp(a_log))
    a = a[..., None].expand(b_, s, heads, c // heads).reshape(shape)
    return a, torch.randn(shape, generator=gen, device="cuda")


def scan_ab(torch, gen, cuda_gen, shape):
    if shape == ZAMBA2_SCAN:
        return mamba2_like_ab(torch, cuda_gen, shape, ZAMBA2_HEADS)
    return mamba_like_ab(torch, gen, shape)


def plain_flash(torch, ref, q, k, v, **kw):
    """The plain version, in pieces (a batch item and a KV head's query
    heads at a time) when its f32 logits would be larger than
    PLAIN_PIECE_BYTES; each piece is the same function on its slice."""
    b, s, h, _ = q.shape
    s_kv, kv = k.shape[1], k.shape[2]
    if 4 * b * h * s * s_kv <= PLAIN_PIECE_BYTES:
        return ref(q, k, v, **kw)
    rep = h // kv
    return torch.cat([torch.cat([
        ref(q[i:i + 1, :, j * rep:(j + 1) * rep], k[i:i + 1, :, j:j + 1],
            v[i:i + 1, :, j:j + 1], **kw) for j in range(kv)], dim=2)
        for i in range(b)])


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
    for (label, b, s, s_kv, h, kv, hd, dt, causal, window,
         softcap) in FLASH_CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(b, n, m, hd, generator=gen).to(dtype).cuda()
                   for n, m in ((s, h), (s_kv, kv), (s_kv, kv)))
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = FA.flash_attention(q, k, v, **kw)
        want = plain_flash(torch, flash_attention_ref, q, k, v, **kw)
        torch.cuda.synchronize()
        rtol, atol = FLASH_TOL[dt]
        e = check_close(f"flash {label}", got.float(), want.float(), rtol,
                        atol)
        require(torch.equal(got, FA.flash_attention(q, k, v, **kw)),
                f"flash_attention is not deterministic at {label}")
        errs.append(e)
        say(f"flash_attention {label} (B,S,S_kv,H,KV,hd)=({b},{s},{s_kv},{h},"
            f"{kv},{hd}) {dt} causal={causal} window={window} "
            f"softcap={softcap}: max "
            f"abs err {e:.3e} (tol rtol {rtol} atol {atol}), max |out| "
            f"{float(want.float().abs().max()):.3f}, rms out "
            f"{float(want.float().square().mean().sqrt()):.4f}; "
            f"deterministic")
        del q, k, v, got, want

    timed = {}
    for (label, b, s, s_kv, h, kv, hd, dt, causal, window,
         softcap) in (c for c in FLASH_CASES if c[0] in FLASH_TIMED):
        dtype = getattr(torch, dt)
        esize = torch.tensor([], dtype=dtype).element_size()
        bytes_in = esize * b * hd * (s * h + 2 * s_kv * kv)
        ins = [tuple(torch.randn(b, n, m, hd, generator=gen).to(dtype).cuda()
                     for n, m in ((s, h), (s_kv, kv), (s_kv, kv)))
               for _ in range(n_rotating(bytes_in))]
        kw = dict(causal=causal, window=window, softcap=softcap)
        ms = graph_ms(torch, lambda i: FA.flash_attention(*ins[i], **kw),
                      len(ins), replays=3)
        plain_ms = None           # not timed in pieces
        if 4 * b * h * s * s_kv <= PLAIN_PIECE_BYTES:
            plain_ms = event_ms(torch, lambda i: flash_attention_ref(
                *ins[i], **kw), len(ins))
        library_ms = None
        if softcap is None and window is None:
            # the yardstick only: the port never calls it
            sdpa = torch.nn.functional.scaled_dot_product_attention
            library_ms = graph_ms(torch, lambda i: sdpa(
                *(t.transpose(1, 2) for t in ins[i]), is_causal=causal,
                enable_gqa=True), len(ins), replays=3)
        moved = bytes_in + esize * b * s * h * hd
        ops = 4 * hd * b * h * attn_pairs(s, causal, window, s_kv)
        bound_ms, bound_by = max((moved / HBM_BYTES_PER_S * 1e3, "bytes"),
                                 (ops / BF16_OPS_PER_S * 1e3, "operations"))
        timed[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms)
        # the report line carries the main path's shape (llama3.2-3b)
        lib = "none (no single call)" if library_ms is None else \
            f"{library_ms:.5f} (scaled_dot_product_attention)"
        plain = "not timed (in pieces)" if plain_ms is None else \
            f"{plain_ms:.5f}"
        say(f"flash_attention {label} on {card}, {moved} bytes, {ops} flops: "
            f"kernel_ms={ms:.5f} bound_ms={bound_ms:.5f} ({bound_by}) "
            f"plain_ms={plain} library_ms={lib}; "
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
    cuda_gen = torch.Generator(device="cuda").manual_seed(3)
    for shape in SCAN_CASES:
        a, b = scan_ab(torch, gen, cuda_gen, shape)
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
    timed = {}
    for shape in SCAN_TIMED:
        n_el = shape[0] * shape[1] * shape[2]
        ins = [scan_ab(torch, gen, cuda_gen, shape)
               for _ in range(n_rotating(8 * n_el))]
        ms = graph_ms(torch, lambda i: SS.selective_scan(*ins[i]), len(ins),
                      replays=5)
        plain_ms = event_ms(torch, lambda i: selective_scan_ref(*ins[i]),
                            len(ins))
        moved = 12 * n_el
        bound_ms, bound_by = bound_of(moved, 2 * n_el)
        timed[shape] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None)
        say(f"selective_scan (B,S,C)={shape} on {card}, {moved} bytes: "
            f"kernel_ms={ms:.5f} bound_ms={bound_ms:.5f} ({bound_by}) "
            f"plain_ms={plain_ms:.5f} library_ms=none (no single call); "
            f"{bound_ms / ms:.3f} of the bound")
        del ins
        torch.cuda.empty_cache()
    # the report line carries falcon-mamba-7b's shape, as before
    reports["selective_scan"] = dict(
        name="selective_scan", route="cuda",
        source="src/repro_torch/kernels/selective_scan/csrc/"
               "selective_scan.cu",
        replaces="src/repro/kernels/selective_scan/selective_scan.py:49",
        max_abs_err=max(errs), **timed[SCAN_TIMED[0]])
    return reports


SERVE_DECODE = 64              # tokens the serve loop decodes
CHECK_LEN = 64                 # tokens of the f32 prefill-vs-decode check
# capacity factor of the moe models' f32 check, as the reference's
# tests/test_decode_equivalence.py: per-step routing (decode) and
# whole-sequence routing (prefill) drop other tokens at capacity
MOE_CHECK_CAPACITY = 8.0
# one f32 kimi-k2 layer is 78 GB of experts: its f32 check runs reduced
F32_REDUCED = ("kimi-k2-1t-a32b",)
RING_LEN = 40                  # llama4 chunk_ring check: chunk 16, 2 crossings


def dropped_slots(moe):
    """Wrap `moe.route` to add up the slots each call drops (on the device,
    no sync); returns (the running totals, a function that unwraps)."""
    route, totals = moe.route, []

    def counted(*a):
        r = route(*a)
        totals.append((~r["keep"]).sum())
        return r
    moe.route = counted

    def unwrap():
        moe.route = route
    return totals, unwrap


def f32_decode_check(torch, cfg, params, tgen, seq, label, card):
    """The f32 prefill (the kernels) against `seq` teacher-forced decode
    steps (plain torch, no kernel; for encdec after the frames are encoded
    into the cache, for vlm after the image K/V are, as
    tests/test_decode_equivalence.py does); a moe model must drop no slot
    in either pass."""
    from repro_torch.launch.serve import prepare_cache
    from repro_torch.launch.train import make_prefill_step, make_serve_step
    from repro_torch.models import api, moe
    totals, unwrap = dropped_slots(moe)
    try:
        batch = api.make_batch(cfg, tgen, 2, seq, device="cuda")
        full = make_prefill_step(cfg)(params, batch)
        cache = prepare_cache(cfg, params, 2, seq, "cuda",
                              batch.get("frames"), batch.get("image_embeds"))
        step = make_serve_step(cfg)
        outs = []
        for i in range(seq):
            lg, cache = step(params, cache, batch["tokens"][:, i:i + 1], i)
            outs.append(lg[:, 0])
        dec = torch.stack(outs, dim=1)
    finally:
        unwrap()
    dropped = int(sum(totals).item()) if totals else 0
    require(dropped == 0, f"{label}: {dropped} slots dropped at capacity "
                          f"factor {cfg.capacity_factor}")
    tol = DECODE_TOL[cfg.family]
    e = check_close(f"{label} f32 prefill vs decode", dec, full, tol, tol)
    caches = {k: tuple(c["k"].shape) for k, c in cache.items()
              if isinstance(c, dict) and "k" in c}      # attention caches
    caches.update({k: tuple(c.shape) for k, c in cache.items()
                   if k.startswith("cross")})
    say(f"{label} f32 ({cfg.n_layers} layers, d_model {cfg.d_model}) on "
        f"{card}: prefill logits vs {seq} teacher-forced decode steps, max "
        f"abs err {e:.3e} (tol rtol {tol} atol {tol}), max |logit| "
        f"{float(full.abs().max()):.3f}, caches {caches}"
        + (f", {len(totals)} routings, 0 slots dropped" if totals else ""))


def open_gates(torch, params, label):
    """Draw the vlm's cross-layer gates uniform in (-1, 1) from seed 2 in
    place of init's zeros (tanh(0) = 0 makes every cross layer add
    nothing), and print them."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    cross = params["cross_layers"]
    for n in ("attn_gate", "ffn_gate"):
        cross[n] = torch.rand(cross[n].shape, generator=gen,
                              device="cuda") * 2 - 1
        require(bool((cross[n] != 0).all()), f"{label}: a {n} is 0")
        say(f"{label}: {n} {[round(g, 6) for g in cross[n].tolist()]}")


def lm_slice_phase(torch, card, kernels):
    """Prefill and the serve loop of each model at full width on the card,
    then the f32 prefill against teacher-forced decode; returns each
    kernel's launches from the first prefill that runs it.  kimi-k2's f32
    check runs on its reduced config (one f32 layer at full width is 78 GB
    of experts, no room beside its activations); llama4's `chunk_ring`
    decode, which 64 steps at full width (chunk 8,192) never reach, is
    checked on its reduced config (chunk 16) over 40 steps."""
    from repro_torch import configs
    from repro_torch.launch.profile_lm import (DECODE_BATCH, PROMPT, RUNS,
                                              setup)
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import make_prefill_step
    from repro_torch.models import api, dense
    from repro_torch.utils.tree_math import tree_leaves

    counts = {}
    for run in RUNS:
        arch, b, s = run.arch, run.batch, run.seq
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg, params, tgen = setup(run)
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated()
        n_param = sum(v.numel() for v in tree_leaves(params))
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
        want = {n: run.launches.get(n, 0) for n in kernels}
        require(launches == want, f"{arch} prefill: launches {launches}, "
                                  f"want {want}")
        for kname in run.launches:
            counts.setdefault(kname, launches[kname])
        require(tuple(logits.shape) == (b, s, cfg.vocab) and
                bool(torch.isfinite(logits).all()),
                f"{arch}: prefill logits {tuple(logits.shape)} not finite "
                f"or of the wrong shape")
        say(f"{arch} ({cfg.n_layers} layers, {n_param} params, {cfg.dtype}) "
            f"prefill on {card}: B={b} S={s} in {sec:.4f} s, "
            f"{b * s / sec:.1f} tokens/s, peak memory {peak} bytes "
            f"(init's peak {init_peak}), launches {launches}")
        del logits, batch

        dbatch = api.make_batch(cfg, tgen, DECODE_BATCH, PROMPT,
                                device="cuda")
        for fn in kernels.values():
            fn.launches = 0
        res = serve(cfg, params, dbatch["tokens"], SERVE_DECODE, "cuda",
                    frames=dbatch.get("frames"),
                    image_embeds=dbatch.get("image_embeds"))
        launches = {n: fn.launches for n, fn in kernels.items()}
        # decode launches nothing; whisper's frames are encoded first
        want = {n: 0 for n in kernels}
        if cfg.family == "encdec":
            want["flash_attention"] = cfg.n_enc_layers
        require(launches == want, f"{arch} serve: launched {launches}, "
                                  f"want {want}")
        require(not bool(torch.isnan(res["logits"]).any()),
                f"{arch} serve: NaN logits")
        require(tuple(res["generated"].shape) ==
                (DECODE_BATCH, SERVE_DECODE),
                f"{arch} serve: generated {tuple(res['generated'].shape)}")
        enc = ""
        if cfg.family == "encdec":
            enc = (f"frames ({DECODE_BATCH}, {cfg.enc_frames}, "
                   f"{cfg.d_model}) encoded into the cross caches in "
                   f"{res['encode_s']:.4f} s, ")
        elif cfg.family == "vlm":
            enc = (f"image K/V of ({DECODE_BATCH}, {cfg.n_image_tokens}, "
                   f"{cfg.d_model}) filled in {res['encode_s']:.4f} s, ")
        say(f"{arch} serve on {card}: batch {DECODE_BATCH}, {enc}prompt "
            f"{PROMPT} in {res['prompt_s']:.4f} s, decode "
            f"{SERVE_DECODE} in {res['decode_s']:.4f} s -> "
            f"{res['tok_per_s']:.1f} tok/s, no NaN, kernel launches "
            f"{launches}")
        del params, res, dbatch
        torch.cuda.empty_cache()

        # f32: prefill (the kernels) vs teacher-forced decode (plain torch,
        # no kernel), as tests/test_decode_equivalence.py
        if arch in F32_REDUCED:
            cfg32 = configs.get(arch).reduced().replace(dtype="float32")
            params = api.init_params(cfg32, torch.Generator(
                device="cuda").manual_seed(0), device="cuda")
            tgen = torch.Generator(device="cuda").manual_seed(1)
            label = f"{arch} reduced"
        else:
            cfg32, params, tgen = setup(run, "float32")
            label = f"{arch} at full width"
        if cfg32.family == "moe":
            cfg32 = cfg32.replace(capacity_factor=MOE_CHECK_CAPACITY)
        if cfg32.family == "vlm":
            open_gates(torch, params, label)
        f32_decode_check(torch, cfg32, params, tgen, CHECK_LEN, label, card)
        say(f"{time.perf_counter() - t0:.1f} s for {arch}")
        del params
        torch.cuda.empty_cache()

    # llama4's chunked layers decode through a ring of one chunk: reduced
    # (chunk 16), 40 steps cross two chunk boundaries
    cfg = configs.get("llama4-scout-17b-a16e").reduced().replace(
        dtype="float32", capacity_factor=MOE_CHECK_CAPACITY)
    modes = {j: dense._member_mode(cfg, j, RING_LEN)
             for j in range(cfg.global_period)}
    require(modes[0] == "chunk_ring", f"llama4 reduced modes {modes}")
    params = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), device="cuda")
    before = kernels["flash_attention"].launches
    f32_decode_check(torch, cfg, params, torch.Generator(
        device="cuda").manual_seed(1), RING_LEN,
        f"llama4-scout-17b-a16e reduced, chunk {cfg.attn_chunk}, modes "
        f"{modes}", card)
    # the chunked layer: a folded call for the 2 whole chunks and one for
    # the 8-token tail; the global layer one
    got = kernels["flash_attention"].launches - before
    require(got == 3, f"llama4 reduced S={RING_LEN} prefill: {got} flash "
                      f"launches, want 3")
    del params
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
    from repro_torch.launch.profile_lm import FLASH, Run, setup
    from repro_torch.launch.train import make_prefill_step
    from repro_torch.models import api
    from repro_torch.models import layers

    run = Run("llama3.2-3b", 2, 1, 4096, {FLASH: 2})
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
    require(fa.launches == run.launches[FLASH],
            f"bf16 llama check: {fa.launches} flash launches, want "
            f"{run.launches[FLASH]}")
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
    fault_input_kernel_phase(torch, K, R, ref, rref, comm, reports)
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
    counts.setdefault("ncv_weighted_sum", methods_slice_phase(
        torch, np, kernels, card, world))
    for name, n in faults_samplers_phase(torch, np, K, R, ref, rref, kernels,
                                         card, world).items():
        counts.setdefault(name, n)
    phase_s["fl slice"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    ring_counts = pipeline_store_ckpt_phase(torch, np, kernels, card, world)
    say(f"ring, host store and checkpoint runs: launches {ring_counts}")
    phase_s["ring + host store + checkpoints"] = \
        time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    codec_counts = codec_phase(torch, np, kernels, card, world)
    say(f"topk and lowrank runs: launches {codec_counts}")
    phase_s["topk + lowrank"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    serve_counts = serve_track_phase(torch, np, kernels, card, world)
    say(f"served and tracked runs: launches {serve_counts}")
    phase_s["serve + telemetry"] = time.perf_counter() - t_phase
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
