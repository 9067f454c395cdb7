"""The port's stateful codecs, `topk` and `lowrank`, against the
reference's (`repro.comm`) on the CPU, codec alone.

Inputs are made with numpy from fixed seeds and handed to both packages;
the port encodes the (C, N) cohort stack at once, the reference one
client at a time.

Tolerances and why:
  topk wire (values, indices and their dtype), residual, decode — bitwise:
          a stable descending sort of |x| picks the same k entries in the
          same order as the reference's top_k (ties: the lower index
          first), and the rest is copies;
  lowrank plan, sizes, bytes_per_client — equal: accounting;
  lowrank wire, residual, decode, factored weighted sum — rtol 1e-4,
          atol 1e-5 (the reference's own lowrank tolerance,
          tests/test_mesh2d.py): 12 Newton-Schulz steps and the products
          around them in another summation order;
  lowrank's starting bases — within 3 ulps of the reference's (numpy's
          f32 log1p is not XLA's; `utils/prng.py`);
  the error-feedback invariants — the reference's own bounds
          (tests/test_comm.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.utils.tree_math import flat_spec as jflat_spec
from repro_torch import comm
from repro_torch.fed import FLConfig
from repro_torch.models import lenet as tlenet
from repro_torch.utils import prng

LENET_N = 62006


def _vec(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * rng.uniform(0.1, 10.0, shape)
            ).astype(np.float32)


def _ties(seed, m, n):
    """Rows full of ties and +-x pairs: values from a small set, signs
    random."""
    rng = np.random.default_rng(seed)
    vals = rng.choice(np.float32([0.0, 0.5, 1.0, 2.0, 3.0]), size=(m, n))
    return (vals * rng.choice(np.float32([-1.0, 1.0]), size=(m, n))
            ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _lenet_spec():
    """The reference's FlatSpec of the LeNet-5 upload (from zeros of the
    port's param shapes; the spec reads shapes only)."""
    params = tlenet.init(tlenet.LeNetConfig(), torch.Generator())
    return jflat_spec({k: np.zeros(tuple(v.shape), np.float32)
                       for k, v in params.items()}, 0)


def _pair(name, n, spec=None, **opts):
    return (jcomm.get_codec(name, n=n, spec=spec, **opts),
            comm.get_codec(name, n=n, spec=spec, **opts))


@functools.lru_cache(maxsize=None)
def _ref_encode(jc, stateful):
    if stateful:
        return jax.jit(jax.vmap(jc.encode))
    return jax.jit(jax.vmap(lambda v: jc.encode(v)))


def _ref_stack(jc, x, state=None):
    """The reference's encode of each row of x (and of its state row),
    vmapped over the rows as its simulator runs it."""
    args = (jnp.asarray(x),) if state is None else (
        jnp.asarray(x), jax.tree.map(jnp.asarray, state))
    return jax.tree.map(np.asarray, _ref_encode(jc, state is not None)(*args))


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


# ----------------------------------------------------------------------------
# topk
# ----------------------------------------------------------------------------

def test_topk_tie_order_is_the_reference():
    """|[1, -1, 2, -2, 1, .5, 2, 0]|, k = 4: the lower index first among
    equal magnitudes, [2, 3, 6, 0] (torch.topk gives [2, 3, 6, 1])."""
    x = np.float32([1, -1, 2, -2, 1, 0.5, 2, 0])
    jc, tc = _pair("topk", 8, ratio=0.5)
    jw, _ = jc.encode(jnp.asarray(x), jc.init_state())
    tw, _ = tc.encode(torch.from_numpy(x)[None], tc.init_state()[None])
    np.testing.assert_array_equal(np.asarray(jw["i"]), [2, 3, 6, 0])
    np.testing.assert_array_equal(tw["i"][0].numpy(), [2, 3, 6, 0])


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n,ratio", [(10, 0.25), (LENET_N, 0.1),
                                     (LENET_N, 0.16), (70000, 0.01)])
def test_topk_wire_is_the_reference_bitwise(n, ratio, ties):
    m = 3
    x = _ties(n, m, n) if ties else _vec(n, m, n)
    state = (_ties(n + 1, m, n) if ties else _vec(n + 1, m, n)) * 0.5
    jc, tc = _pair("topk", n, ratio=ratio)
    assert tc.k == jc.k
    jw, jstate = _ref_stack(jc, x, state)
    tw, tstate = tc.encode(torch.from_numpy(x), torch.from_numpy(state))
    assert str(tw["i"].dtype).split(".")[-1] == str(jw["i"].dtype)
    assert tw["i"].dtype == (torch.uint16 if n <= 0xFFFF else torch.uint32)
    np.testing.assert_array_equal(tw["i"].numpy(), jw["i"])
    np.testing.assert_array_equal(tw["v"].numpy(), jw["v"])
    np.testing.assert_array_equal(tstate.numpy(), jstate)
    np.testing.assert_array_equal(
        tc.decode(tw).numpy(),
        np.asarray(jax.vmap(jc.decode)(jax.tree.map(jnp.asarray, jw))))
    # without a state: the encode of x + 0, as the reference's
    # encode(x, None) is its encode(x, zeros)
    tw0, r0 = tc.encode(torch.from_numpy(x))
    twz, rz = tc.encode(torch.from_numpy(x), torch.zeros(m, n))
    assert all(torch.equal(tw0[k], twz[k]) for k in tw0)
    assert torch.equal(r0, rz)


@pytest.mark.parametrize("n", [10, 100, 513])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_error_feedback_contraction(n, seed):
    """The reference's invariants: ||x - decode(encode(x))||^2 <= (1 - k/n)
    ||x||^2, decode + residual == x, and on a constant input the residual
    stays under the EF fixed point (1-d)/(1-sqrt(1-d))^2 ||x||^2."""
    codec = comm.get_codec("topk", n=n, ratio=0.25)
    vec = torch.from_numpy(_vec(seed, 2, n))
    wire, residual = codec.encode(vec, torch.zeros(2, n))
    k = codec.k
    lhs = torch.sum(residual ** 2, -1)
    rhs = (1.0 - k / n) * torch.sum(vec ** 2, -1)
    assert bool(torch.all(lhs <= rhs + 1e-6))
    np.testing.assert_allclose((codec.decode(wire) + residual).numpy(),
                               vec.numpy(), rtol=1e-6, atol=1e-6)
    r = residual
    for _ in range(20):
        _, r = codec.encode(vec, r)
    d = k / n
    bound = (1.0 - d) / (1.0 - np.sqrt(1.0 - d)) ** 2
    assert bool(torch.all(torch.sum(r ** 2, -1)
                          <= bound * torch.sum(vec ** 2, -1) + 1e-6))


def test_topk_options_and_accounting():
    for ratio in (0.1, 0.16, 0.25, 1.0):
        for n in (1, 7, 100, 513, LENET_N, 70000):
            jc, tc = _pair("topk", n, ratio=ratio)
            assert (tc.k, tc.bytes_per_client()) == (jc.k,
                                                     jc.bytes_per_client())
            assert comm.compression_ratio(tc) == jcomm.compression_ratio(jc)
    assert comm.get_codec("topk", n=LENET_N).bytes_per_client() == 37206
    assert comm.get_codec("topk", n=LENET_N,
                          ratio=0.16).bytes_per_client() == 59526
    fl = FLConfig.make(codec="topk", ratio=0.16, n_clients=6, cohort=3)
    assert fl.codec_opts == {"ratio": 0.16}
    for bad in (0.0, -0.1, 1.5):
        with pytest.raises(ValueError, match="ratio"):
            FLConfig.make(codec="topk", ratio=bad)
    with pytest.raises(TypeError, match="rank"):
        FLConfig.make(codec="topk", rank=4)


# ----------------------------------------------------------------------------
# lowrank
# ----------------------------------------------------------------------------

def _lowrank(shapes, rank=4, iters=1):
    n = sum(int(np.prod(s)) for s in shapes)
    kw = dict(n=n, rank=rank, iters=iters,
              shapes=tuple(tuple(s) for s in shapes))
    return jcomm.LowRankCodec(**kw), comm.LowRankCodec(**kw)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_lowrank_plan_and_bytes_at_lenet():
    """The LeNet-5 upload at rank 8: conv2 (150, 16), fc1 (400, 120), fc2
    (120, 84) and the head (84, 10) factored; conv1 and the biases dense;
    34,232 bytes a client."""
    spec = _lenet_spec()
    jc, tc = _pair("lowrank", spec.n, spec=spec, rank=8)
    assert tc._plan == jc._plan and tc._sizes == jc._sizes
    assert tc._sizes == (6032, 1840, 686)
    assert tc.bytes_per_client() == jc.bytes_per_client() == 34232
    assert [(p, q) for _, p, q, _, _ in tc._plan[0]] == [
        (150, 16), (400, 120), (120, 84), (84, 10)]


def test_lowrank_starting_bases_are_the_reference_to_3_ulps():
    spec = _lenet_spec()
    jc, tc = _pair("lowrank", spec.n, spec=spec, rank=8)
    jv = np.asarray(jax.jit(jc.init_state)()["v"])
    tv = tc.init_state()["v"].numpy()
    assert tv.dtype == np.float32 and tv.shape == jv.shape == (1840,)
    ulps = np.abs(tv.view(np.int32).astype(np.int64)
                  - jv.view(np.int32).astype(np.int64))
    assert ulps.max() <= 3, ulps.max()
    # the folded keys are bitwise the reference's
    keys = jax.jit(lambda k: [jax.random.fold_in(k, i) for i in range(4)])(
        jax.random.PRNGKey(0x10A4))
    for i in range(4):
        np.testing.assert_array_equal(
            prng.fold_in(prng.prng_key(0x10A4), i), np.asarray(keys[i]))


@pytest.mark.parametrize("seed", [0, 1])
def test_lowrank_wire_matches_reference_at_lenet(seed):
    """The cohort stack against the reference client by client, from the
    same state (the reference's starting bases, then a state of its own
    encode), two rounds."""
    spec = _lenet_spec()
    jc, tc = _pair("lowrank", spec.n, spec=spec, rank=8)
    m = 3
    x = _vec(seed, m, spec.n) * 0.01
    jstate = jax.tree.map(
        lambda a: np.stack([np.asarray(a)] * m), jc.init_state())
    for _ in range(2):
        jw, jnext = _ref_stack(jc, x, jstate)
        tw, tnext = tc.encode(torch.from_numpy(x), _t(jstate))
        for k in ("u", "v", "d"):
            assert tw[k].dtype == torch.float32
            _close(tw[k].numpy(), jw[k])
        _close(tnext["r"].numpy(), jnext["r"])
        _close(tnext["v"].numpy(), jnext["v"])
        _close(tc.decode(tw).numpy(),
               jax.vmap(jc.decode)(jax.tree.map(jnp.asarray, jw)))
        jstate = jnext


@pytest.mark.parametrize("rank,iters", [(1, 1), (2, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_lowrank_roundtrip_shape_dtype(rank, iters, seed):
    """Wire leaves f32 of the planned sizes; decode (n,) f32; the dense
    (37,) segment ships bit-exact and its residual slice is exactly 0; the
    wire and state hold the reference's."""
    shapes = ((24, 16), (37,), (8, 12))
    jc, tc = _lowrank(shapes, rank=rank, iters=iters)
    x = _vec(seed, 2, tc.n)
    wire, state = tc.encode(torch.from_numpy(x))
    n_u, n_v, n_d = tc._sizes
    assert (n_u, n_v, n_d) == jc._sizes
    assert wire["u"].shape == (2, n_u) and wire["v"].shape == (2, n_v)
    assert wire["d"].shape == (2, n_d)
    assert all(w.dtype == torch.float32 for w in wire.values())
    dec = tc.decode(wire)
    assert dec.shape == (2, tc.n) and dec.dtype == torch.float32
    assert set(state) == {"r", "v"} and state["r"].shape == (2, tc.n)
    off = 24 * 16
    np.testing.assert_array_equal(dec[:, off:off + 37].numpy(),
                                  x[:, off:off + 37])
    np.testing.assert_array_equal(state["r"][:, off:off + 37].numpy(),
                                  np.zeros((2, 37), np.float32))
    jw, jstate = _ref_stack(jc, x)
    for k in ("u", "v", "d"):
        _close(wire[k].numpy(), jw[k])
    _close(state["r"].numpy(), jstate["r"])


@pytest.mark.parametrize("seed", [0, 1])
def test_lowrank_recovers_lowrank_input(seed):
    """A rank <= r matrix round-trips once the warm bases lock on (round
    4), and the residual is exactly the reconstruction gap."""
    rng = np.random.default_rng(seed)
    p, q, r = 32, 24, 4
    X = (rng.standard_normal((p, r)) @ rng.standard_normal((r, q))
         ).astype(np.float32)
    _, tc = _lowrank(((p, q),), rank=r)
    x = torch.from_numpy(X.reshape(1, -1))
    state = None
    for _ in range(4):
        wire, state = tc.encode(x, state)
    dec = tc.decode(wire)[0].reshape(p, q).numpy()
    assert np.linalg.norm(dec - X) / np.linalg.norm(X) < 1e-3
    wire1, state1 = tc.encode(x)
    np.testing.assert_allclose(state1["r"].numpy(),
                               (x - tc.decode(wire1)).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_lowrank_ef_contraction():
    """The reference's EF invariants of an orthogonal-projection codec:
    one encode is contractive; the decodes and the last residual sum to
    T times the input; the residual saturates; a rank <= r input leaves
    only orthonormalization noise."""
    rng = np.random.default_rng(0)
    _, tc = _lowrank(((48, 32), (21,)), rank=2)
    vec = torch.from_numpy(_vec(7, 1, tc.n))
    _, s1 = tc.encode(vec)
    assert float(torch.linalg.norm(s1["r"])) <= \
        float(torch.linalg.norm(vec)) * (1.0 + 1e-4)
    state, acc, norms = None, torch.zeros(1, tc.n), []
    T = 20
    for _ in range(T):
        wire, state = tc.encode(vec, state)
        acc = acc + tc.decode(wire)
        norms.append(float(torch.linalg.norm(state["r"])))
    np.testing.assert_allclose((acc + state["r"]).numpy(), (T * vec).numpy(),
                               rtol=1e-4, atol=1e-3)
    assert norms[-1] - norms[-2] < 0.2 * (norms[1] - norms[0])
    p, q, r = 48, 32, 2
    X = (rng.standard_normal((p, r)) @ rng.standard_normal((r, q))
         ).astype(np.float32)
    v2 = torch.from_numpy(np.concatenate(
        [X.reshape(-1), rng.standard_normal(21).astype(np.float32)])[None])
    state = None
    for _ in range(6):
        _, state = tc.encode(v2, state)
        assert float(torch.linalg.norm(state["r"])) < \
            1e-3 * float(torch.linalg.norm(v2))


def test_lowrank_bytes_accounting_exact():
    """4 (r (p + q) per factored matrix + the dense rest) bytes; without
    shapes an honest dense passthrough."""
    jc, tc = _lowrank(((64, 32), (100,), (8, 4)), rank=4)
    assert tc._sizes == (64 * 4, 32 * 4, 100 + 32)
    assert tc.bytes_per_client() == jc.bytes_per_client() == \
        4 * (64 * 4 + 32 * 4 + 132)
    wire, _ = tc.encode(torch.ones(1, tc.n))
    assert (wire["u"].shape[1], wire["v"].shape[1], wire["d"].shape[1]) == \
        tc._sizes
    assert comm.compression_ratio(tc) == jcomm.compression_ratio(jc)
    flat = comm.get_codec("lowrank", n=100, rank=4)
    assert flat.bytes_per_client() == 4 * 100
    assert flat._plan == jcomm.get_codec("lowrank", n=100, rank=4)._plan


def test_lowrank_registry_and_option_routing():
    """FLConfig.make routes rank / iters to codec_opts and refuses bad
    values and foreign options at construction, as the reference does."""
    fl = FLConfig.make(codec="lowrank", rank=4)
    assert fl.codec == "lowrank" and fl.codec_opts == {"rank": 4}
    with pytest.raises(ValueError, match="rank"):
        FLConfig.make(codec="lowrank", rank=0)
    with pytest.raises(ValueError, match="rank"):
        comm.get_codec("lowrank", n=64, rank=-2)
    with pytest.raises(ValueError, match="iters"):
        FLConfig.make(codec="lowrank", iters=0)
    with pytest.raises(TypeError, match="ratio"):
        FLConfig.make(codec="lowrank", ratio=0.5)
    with pytest.raises(ValueError, match="shapes"):
        comm.LowRankCodec(n=10, shapes=((3, 3),))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lowrank_weighted_sum_matches_decode_then_sum(seed):
    """The factored server sum == decode-then-weighted-sum, and the
    reference's factored sum."""
    rng = np.random.default_rng(seed)
    jc, tc = _lowrank(((16, 12), (9,), (20, 8)), rank=3)
    m = 3
    x = rng.standard_normal((m, tc.n)).astype(np.float32)
    wire, _ = tc.encode(torch.from_numpy(x))
    w = rng.uniform(0.1, 1.0, m).astype(np.float32)
    agg, nrm = tc.weighted_sum(wire, torch.from_numpy(w))
    ref = (torch.from_numpy(w)[:, None] * tc.decode(wire)).sum(0)
    np.testing.assert_allclose(agg.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(nrm), float(torch.sum(ref * ref)),
                               rtol=1e-4, atol=1e-6)
    jagg, jnrm = jc.weighted_sum(
        {k: jnp.asarray(v.numpy()) for k, v in wire.items()},
        jnp.asarray(w), use_pallas=False)
    _close(agg.numpy(), jagg)
    np.testing.assert_allclose(float(nrm), float(jnrm), rtol=1e-4)
    agg2, _ = comm.aggregate_wire(tc, wire, torch.from_numpy(w * 10), 0.0)
    jagg2, _ = jcomm.aggregate_wire(
        jc, {k: jnp.asarray(v.numpy()) for k, v in wire.items()},
        jnp.asarray(w * 10), 0.0, use_pallas=False)
    _close(agg2.numpy(), jagg2)


def test_stateful_flags_and_registry():
    assert comm.NOT_PORTED == ()
    assert set(comm.CODECS) == set(jcomm.CODECS)
    for name, cls in comm.CODECS.items():
        assert cls.stateful == jcomm.CODECS[name].stateful
        assert cls.options == jcomm.CODECS[name].options
        assert (cls(n=10).init_state() is None) == (not cls.stateful)
