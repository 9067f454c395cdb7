"""The one-launch wire kernels' order of work, emulated on the CPU, against
the plain versions and the reference's Pallas kernels in interpret mode;
the simulator's own numerics flags; and LeNet's convolution as the card
runs it (stacked patches, one matrix product), against `F.conv2d`.

`rloo/csrc/rloo_q.cu`'s two kernels cannot run here, so their arithmetic is
emulated in numpy from the launch plan the wrapper computes
(`rloo.wire_plan`: V bytes a load, the grid):

  vector — each code decoded exactly (int8 as is, an int4 nibble as
           ((b & 0xF) ^ 8) - 8), code * s rounded to f32, then
           acc = fmaf(w_u, code * s, acc) for u = 0..M-1 in order;
  norm   — each thread's fmaf sum of squares over the vectors it strides to
           (int8: its V outputs in order; int4: the V low-nibble outputs,
           then the V high-nibble ones), then `reduction.cuh::grid_sum`:
           a shuffle tree in each warp, the warps in order, one partial a
           block, and the last block's index-order sum of the partials.

Held to `ncv_weighted_sum_q_ref` / `_q4_ref` and to the reference's
`ncv_weighted_sum_q` / `_q4` at rtol / atol 1e-5 (the vector: M products
summed in another order) and rtol 1e-4 (the norm: N squares in another
order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.func import grad, vmap

from repro.kernels.rloo import rloo as jrloo
from repro_torch.fed import FLConfig, Simulator, Task
from repro_torch.kernels import reduction
from repro_torch.kernels.rloo import rloo as K
from repro_torch.kernels.rloo.ref import (ncv_weighted_sum_q4_ref,
                                          ncv_weighted_sum_q_ref)
from repro_torch.models import lenet
from test_torch_reduction_design import _grid_sum


def _fma(a, b, c):
    """fmaf(a, b, c) of f32 arrays: the exact product added, then rounded
    to f32 (through f64, which can round twice on a tie)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _weighted_rows(cs, w):
    """acc = fmaf(w_u, cs_u, acc) for u in order; cs (M, ...) f32."""
    acc = np.zeros(cs.shape[1:], np.float32)
    for u in range(cs.shape[0]):
        acc = _fma(np.full_like(cs[u], w[u]), cs[u], acc)
    return acc


def _norm(items, blocks):
    """The grid-stride fmaf sums of squares of `items` (one vector's
    outputs a row, in the order a thread squares them), then grid_sum."""
    width = blocks * reduction.THREADS
    n_items, per_item = items.shape
    padded = np.zeros((-(-n_items // width) * width, per_item), np.float32)
    padded[:n_items] = items
    sq = np.zeros(width, np.float32)
    for stride in padded.reshape(-1, width, per_item):
        for k in range(per_item):
            sq = _fma(stride[:, k], stride[:, k], sq)
    return _grid_sum(sq, blocks)


def _q8_emulated(q, s, w, chunk):
    m, n = q.shape
    vec, blocks = K.wire_plan(torch.from_numpy(q), chunk, 1)
    cs = (q.astype(np.float32).reshape(m, -1, chunk)
          * s[:, :, None]).reshape(m, n)
    agg = _weighted_rows(cs, w)
    return agg, _norm(agg.reshape(-1, vec), blocks), vec, blocks


def _q4_emulated(qp, s, w, chunk):
    m, nb = qp.shape
    half = chunk // 2
    vec, blocks = K.wire_plan(torch.from_numpy(qp), chunk, 2)
    b = qp.astype(np.int32)
    codes = np.concatenate([(((b & 0xF) ^ 8) - 8).reshape(m, -1, half),
                            ((((b >> 4) & 0xF) ^ 8) - 8).reshape(m, -1, half)],
                           axis=-1)                        # (M, C, chunk)
    cs = (codes.astype(np.float32) * s[:, :, None]).reshape(m, -1)
    agg = _weighted_rows(cs, w)
    # a thread's vector: V low-nibble outputs, then the V high ones
    items = agg.reshape(-1, 2, half // vec, vec).transpose(0, 2, 1, 3)
    return agg, _norm(items.reshape(-1, 2 * vec), blocks), vec, blocks


def _wire(seed, m, n_chunks, chunk, int4):
    rng = np.random.default_rng(seed)
    if int4:
        q = rng.integers(0, 256, (m, n_chunks * chunk // 2), dtype=np.uint8)
    else:
        q = rng.integers(-127, 128, (m, n_chunks * chunk), dtype=np.int8)
    s = rng.uniform(1e-3, 1e-2, (m, n_chunks)).astype(np.float32)
    w = rng.uniform(-0.2, 1.0, m).astype(np.float32)
    return q, s, w


# the slice's cohort of 10 over 122 chunks of 512, the smallest cohort, more
# rows than one batch of loads in flight, a chunk that is no power of two
# (V = 4 / 2), and N = 8,704,000 codes: two (int4) to four (int8) times what
# the grid's cap covers (GRID_CAP blocks x THREADS vectors), so threads
# stride (chunks of 4,096 keep the reference's interpreted grid short)
SHAPES = [(10, 122, 512), (2, 122, 512), (40, 122, 512), (7, 13, 100),
          (2, 2125, 4096)]


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("m,n_chunks,chunk", SHAPES)
def test_wire_norm_from_block_partials_matches_plain_and_reference(
        int4, m, n_chunks, chunk):
    q, s, w = _wire(m * n_chunks + int4, m, n_chunks, chunk, int4)
    emulate, plain, jfn = ((_q4_emulated, ncv_weighted_sum_q4_ref,
                            jrloo.ncv_weighted_sum_q4) if int4 else
                           (_q8_emulated, ncv_weighted_sum_q_ref,
                            jrloo.ncv_weighted_sum_q))
    agg, nrm, vec, blocks = emulate(q, s, w, chunk)
    assert vec == (8 if n_chunks == 2125 else 2 if chunk == 100 and int4
                   else 4)
    assert blocks == reduction.grid_blocks(q.shape[1] // vec)
    if n_chunks == 2125:
        assert q.shape[1] // vec > 2 * reduction.GRID_CAP * reduction.THREADS
    p_agg, p_nrm = plain(torch.from_numpy(q), torch.from_numpy(s),
                         torch.from_numpy(w), chunk=chunk)
    j_agg, j_nrm = jfn(jnp.asarray(q), jnp.asarray(s), jnp.asarray(w),
                       chunk=chunk, interpret=True)
    for want_agg, want_nrm in ((p_agg.numpy(), float(p_nrm)),
                               (np.asarray(j_agg), float(j_nrm))):
        np.testing.assert_allclose(agg, want_agg, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(nrm), want_nrm, rtol=1e-4)


def test_vector_width_in_bytes_follows_chunk_length_and_alignment():
    base = torch.zeros(256, dtype=torch.uint8)
    # the slice's rows: 122 chunks of 512 codes, int8 and packed int4
    assert reduction.vector_width_bytes(62464, 512, base) == 16
    assert reduction.vector_width_bytes(31232, 256, base) == 16
    # chunk 100: int8 splits a chunk in fours, int4 its 50-byte half in twos
    assert reduction.vector_width_bytes(1300, 100, base) == 4
    assert reduction.vector_width_bytes(650, 50, base) == 2
    assert reduction.vector_width_bytes(520, 520, base) == 8   # 8 | 520
    assert reduction.vector_width_bytes(7, 7, base) == 1
    for off, want in ((1, 1), (2, 2), (4, 4), (8, 8), (16, 16), (6, 2)):
        assert reduction.vector_width_bytes(512, 512, base[off:]) == want
    assert reduction.vector_width_bytes(62464, 512, base, widest=8) == 8
    assert reduction.vector_width_bytes(62464, 512, base, widest=4) == 4
    # the wrapper's plan: 4 bytes a load on the slice's short rows (16 and
    # 8 blocks at 16 bytes: too few), 8 once a row fills the capped grid
    q8 = torch.zeros(10, 62464, dtype=torch.int8)
    q4 = torch.zeros(10, 31232, dtype=torch.uint8)
    assert K.wire_plan(q8, 512, 1) == (4, 61)
    assert K.wire_plan(q4, 512, 2) == (4, 31)
    full = reduction.GRID_CAP * reduction.THREADS * 8
    assert K.wire_plan(torch.zeros(2, full, dtype=torch.int8), 512, 1) == (
        8, reduction.GRID_CAP)
    assert K.wire_plan(torch.zeros(2, full - 512, dtype=torch.int8), 512,
                       1)[0] == 4
    assert K.wire_plan(torch.zeros(10, 8388608, dtype=torch.uint8), 512,
                       2) == (8, reduction.GRID_CAP)
    assert K.wire_plan(torch.zeros(7, 650, dtype=torch.uint8), 100, 2) == (
        2, 2)
    off = torch.zeros(10 * 62464 + 1, dtype=torch.int8)[1:].view(10, 62464)
    assert K.wire_plan(off, 512, 1)[0] == 1               # 1 byte off


def _tiny_world():
    from repro_torch.data import federated_splits
    _, train, test = federated_splits("cifar10", n_clients=4, alpha=0.1,
                                      seed=0, scale=0.01)
    cfg = lenet.LeNetConfig()
    task = Task(loss=lambda p, b: lenet.loss_fn(cfg, p, b),
                accuracy=lambda p, b: lenet.accuracy(cfg, p, b))
    fl = FLConfig.make(method="fedncv", n_clients=4, cohort=2, k_micro=2,
                       micro_batch=2, local_epochs=1)
    return task, lenet.init(cfg, torch.Generator().manual_seed(0)), train, \
        test, fl


def _flags():
    cudnn = torch.backends.cudnn
    return dict(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                deterministic=cudnn.deterministic,
                cudnn_tf32=cudnn.allow_tf32,
                matmul_tf32=torch.backends.cuda.matmul.allow_tf32)


OWN_FLAGS = dict(enabled=True, benchmark=False, deterministic=True,
                 cudnn_tf32=False, matmul_tf32=False)


def test_simulator_fixes_its_own_numerics_flags_and_restores_them():
    task, params, train, test, fl = _tiny_world()
    sim = Simulator(task, params, train, fl, seed=0, device="cpu")
    seen = []
    update = sim._client_update

    def recording(*a, **kw):
        seen.append(("round", _flags()))
        return update(*a, **kw)

    sim._client_update = recording
    eval_core = sim._eval_core

    def recording_eval(*a, **kw):
        seen.append(("evaluate", _flags()))
        return eval_core(*a, **kw)

    sim._eval_core = recording_eval
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    caller = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
              cudnn.allow_tf32, matmul.allow_tf32)
    try:
        # the caller asks for the fast, nondeterministic settings
        cudnn.benchmark, cudnn.deterministic = True, False
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        want_back = _flags()
        sim.run_round()
        sim.run_rounds(2)
        sim.evaluate(test, personalize_steps=1)
        assert [k for k, _ in seen] == ["round"] * 3 + ["evaluate"]
        assert all(f == OWN_FLAGS for _, f in seen), seen
        assert _flags() == want_back

        def failing(*a, **kw):
            seen.append(("failing", _flags()))
            raise RuntimeError("client update failed")

        sim._client_update = failing
        with pytest.raises(RuntimeError, match="client update failed"):
            sim.run_round()
        assert seen[-1] == ("failing", OWN_FLAGS)
        assert _flags() == want_back
    finally:
        (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
         cudnn.allow_tf32, matmul.allow_tf32) = caller


@pytest.mark.parametrize("cin,cout,size", [(3, 6, 32), (6, 16, 14)])
def test_card_convolution_matches_conv2d_with_its_gradients(cin, cout, size):
    """`lenet._conv`, the card's path, against `F.conv2d` (the CPU's) in
    f32 and a float64 truth, values and per-example gradients under
    vmap(grad) as the simulator takes them, at LeNet's two layers."""
    rng = np.random.default_rng(cin * cout)
    x = torch.from_numpy(rng.standard_normal((4, 8, cin, size, size))
                         .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((5, 5, cin, cout)) * 0.2)
                         .astype(np.float32))
    r = torch.from_numpy(rng.standard_normal(
        (4, 8, cout, size - 4, size - 4)).astype(np.float32))

    def conv2d(xx, ww):
        return F.conv2d(xx, ww.permute(3, 2, 0, 1))

    for conv in (lenet._conv, conv2d):
        got = conv(x.reshape(-1, cin, size, size), w)
        want = conv2d(x.reshape(-1, cin, size, size).double(), w.double())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)

    def loss(conv):
        return lambda ww, xx, rr: torch.sum(conv(xx, ww) * rr)

    outs = []
    for conv in (lenet._conv, conv2d):
        g = vmap(grad(loss(conv), argnums=(0, 1)), in_dims=(None, 0, 0))
        outs.append(g(w, x, r))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)
