"""The port's wire codecs (`repro_torch.comm`) against the reference's
(`repro.comm`) on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages;
the stochastic-rounding uniforms are the reference's own draw
(`jax.random.uniform(key, (n_chunks, chunk))`), passed to the port.

Tolerances and why:
  wire bytes, codes, scales, decode — bitwise: the same f32 operations on
          the same inputs;
  bytes_per_client — equal: accounting;
  weighted sums — rtol 1e-5, atol 1e-6 x max_j sum_u |term_uj|: a sum
          of M f32 terms in another order, whose rounding error scales
          with the terms summed, w_u g_uj here and, for the Eq. 10-12
          oracle, its leave-one-out baselines too (a fixed atol missed on
          the reference's own kernel test, and with weights of both signs
          max|agg| alone understates the terms);
  unbiasedness — the reference's bound, 6 standard errors of the mean of
          4096 draws of the port's generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as jcomm
from repro.kernels.rloo import ref as jref
from repro_torch import comm
from repro_torch.kernels.rloo import rloo as K
from repro_torch.kernels.rloo import ref as tref
from repro_torch.utils.tree_math import flat_spec

NS = [1, 511, 512, 513, 62006]


def _vec(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * rng.uniform(0.1, 10.0, shape)
            ).astype(np.float32)


def _jax_uniforms(codec, m, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), m)
    return keys, np.stack([np.asarray(jax.random.uniform(
        k, (codec.n_chunks, codec.chunk))) for k in keys])


def _both_wires(name, n, m=3, seed=0, **opts):
    """The same (m, n) uploads encoded by both packages."""
    x = _vec(seed + n, m, n)
    jc, tc = jcomm.get_codec(name, n=n, **opts), comm.get_codec(name, n=n,
                                                                **opts)
    if name in ("int8", "int4"):
        keys, u = _jax_uniforms(jc, m, seed)
        jw = [jc.encode(jnp.asarray(x[i]), None, keys[i])[0]
              for i in range(m)]
        tw, state = tc.encode(torch.from_numpy(x), None, torch.from_numpy(u))
    else:
        jw = [jc.encode(jnp.asarray(x[i]))[0] for i in range(m)]
        tw, state = tc.encode(torch.from_numpy(x))
    assert state is None
    jw = {k: np.stack([np.asarray(w[k]) for w in jw]) for k in jw[0]}
    return x, jc, tc, jw, tw


@pytest.mark.parametrize("n", NS)
def test_bf16_wire_is_the_reference_bitwise(n):
    _, jc, tc, jw, tw = _both_wires("bf16", n)
    assert tw["v"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tw["v"].view(torch.int16).numpy().view(
        np.uint16), jw["v"].view(np.uint16))
    np.testing.assert_array_equal(tc.decode(tw).numpy(),
                                  np.asarray(jax.vmap(jc.decode)(jw)))


@pytest.mark.parametrize("name", ["int8", "int4"])
@pytest.mark.parametrize("n", NS)
def test_quantized_wire_is_the_reference_bitwise(name, n):
    _, jc, tc, jw, tw = _both_wires(name, n)
    assert tw["q"].dtype == (torch.int8 if name == "int8" else torch.uint8)
    np.testing.assert_array_equal(tw["q"].numpy(), jw["q"])
    np.testing.assert_array_equal(tw["s"].numpy(), jw["s"])
    np.testing.assert_array_equal(
        tc.decode(tw).numpy(),
        np.asarray(jax.vmap(jc.decode)({k: jnp.asarray(v)
                                        for k, v in jw.items()})))


def test_quantized_wire_honours_the_chunk_option():
    for name in ("int8", "int4"):
        _, _, tc, jw, tw = _both_wires(name, 1000, chunk=64)
        assert tc.n_chunks == 16
        np.testing.assert_array_equal(tw["q"].numpy(), jw["q"])
        np.testing.assert_array_equal(tw["s"].numpy(), jw["s"])


@pytest.mark.parametrize("name", ["identity", "bf16", "int8", "int4"])
def test_bytes_per_client_is_the_reference_accounting(name):
    for n in NS:
        jc, tc = jcomm.get_codec(name, n=n), comm.get_codec(name, n=n)
        assert tc.bytes_per_client() == jc.bytes_per_client()
        assert comm.compression_ratio(tc) == jcomm.compression_ratio(jc)
    # the full-size LeNet-5 upload (62,006 parameters, 122 chunks)
    assert comm.get_codec("int8", n=62006).bytes_per_client() == \
        62006 + 4 * 122
    assert comm.get_codec("int4", n=62006).bytes_per_client() == \
        31003 + 4 * 122


def _close_scaled(got, want, terms):
    """got ~ want, a sum whose terms have magnitudes |terms| (M, N)."""
    mag = float(np.abs(terms).sum(axis=0).max())
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6 * mag)


def _weighted_terms(w, dense):
    return np.asarray(w)[:, None] * np.asarray(dense)


def _ncv_terms(dense, n_samples, beta):
    """Magnitudes of the terms the Eq. 10-12 oracle sums, leave-one-out
    baselines c_u = (n gbar_w - n_u g_u) / (n - n_u) included."""
    g, ns = np.abs(np.asarray(dense)), np.asarray(n_samples, np.float64)
    n = ns.sum()
    p = (ns / n)[:, None]
    gbar = (p * g).sum(axis=0)
    d = (n - ns)[:, None]
    c = np.where(d > 0, (n * gbar + ns[:, None] * g) / np.where(d > 0, d, 1),
                 0.0)
    return p * (g + abs(beta) * c)


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("m,n", [(1, 513), (3, 4000), (10, 62006)])
def test_plain_quantized_weighted_sums_match_reference_refs(int4, m, n):
    name = "int4" if int4 else "int8"
    _, jc, tc, jw, tw = _both_wires(name, n, m=m)
    w = np.random.default_rng(m).uniform(-0.5, 1.0, m).astype(np.float32)
    kern = K.ncv_weighted_sum_q4 if int4 else K.ncv_weighted_sum_q
    jfn = jref.ncv_weighted_sum_q4_ref if int4 else jref.ncv_weighted_sum_q_ref
    launches = kern.launches
    agg, nrm = kern(tw["q"], tw["s"], torch.from_numpy(w), chunk=tc.chunk)
    assert kern.launches == launches            # CPU: plain version
    jagg, jnrm = jfn(jnp.asarray(jw["q"]), jnp.asarray(jw["s"]),
                     jnp.asarray(w), chunk=jc.chunk)
    assert agg.shape == (tc.n_padded,)
    dense = (tref.dequantize_int4_ref if int4 else tref.dequantize_int8_ref)(
        tw["q"], tw["s"], chunk=tc.chunk).numpy()
    _close_scaled(agg.numpy(), jagg, _weighted_terms(w, dense))
    np.testing.assert_allclose(float(nrm), float(jnrm), rtol=1e-4)
    # the aggregate forms with Eq. 10-12 weights: the collapsed wrapper
    # and the port's oracle against the reference's oracle
    n_samples = np.arange(1, m + 1, dtype=np.float32)
    kagg = K.ncv_aggregate_q4 if int4 else K.ncv_aggregate_q
    tagg_fn = tref.ncv_aggregate_q4_ref if int4 else tref.ncv_aggregate_q_ref
    jagg_fn = jref.ncv_aggregate_q4_ref if int4 else jref.ncv_aggregate_q_ref
    jagg, _ = jagg_fn(jnp.asarray(jw["q"]), jnp.asarray(jw["s"]),
                      jnp.asarray(n_samples), 1.0, chunk=jc.chunk)
    terms = _ncv_terms(dense, n_samples, 1.0)
    for fn in (kagg, tagg_fn):
        agg, _ = fn(tw["q"], tw["s"], torch.from_numpy(n_samples), 1.0,
                    chunk=tc.chunk)
        _close_scaled(agg.numpy(), jagg, terms)


def test_plain_int4_unpack_is_the_reference_bitwise():
    qp = np.random.default_rng(0).integers(0, 256, (3, 2 * 256),
                                           dtype=np.uint8)
    np.testing.assert_array_equal(
        tref.unpack_int4_ref(torch.from_numpy(qp)).numpy(),
        np.asarray(jref.unpack_int4_ref(jnp.asarray(qp))))
    s = np.random.default_rng(1).uniform(0.1, 2.0, (3, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tref.dequantize_int4_ref(torch.from_numpy(qp),
                                 torch.from_numpy(s)).numpy(),
        np.asarray(jref.dequantize_int4_ref(jnp.asarray(qp), jnp.asarray(s))))


@pytest.mark.parametrize("name", ["identity", "bf16", "int8", "int4"])
@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_aggregate_wire_matches_reference(name, beta):
    n, m = 3000, 4
    _, jc, tc, jw, tw = _both_wires(name, n, m=m)
    sizes = np.array([12, 3, 0, 7], np.float32)
    agg, nrm = comm.aggregate_wire(tc, tw, torch.from_numpy(sizes), beta)
    jagg, jnrm = jcomm.aggregate_wire(
        jc, {k: jnp.asarray(v) for k, v in jw.items()}, jnp.asarray(sizes),
        beta, use_pallas=False)
    assert agg.shape == (n,)
    _close_scaled(agg.numpy(), jagg,
                  _ncv_terms(tc.decode(tw).numpy(), sizes, beta))
    np.testing.assert_allclose(float(nrm), float(jnrm), rtol=1e-4)


def test_decode_stack_unravels_to_the_upload_tree():
    tree = {"b": torch.zeros(3, 5), "a": torch.zeros(3, 2, 4)}
    spec = flat_spec(tree)
    codec = comm.get_codec("bf16", n=spec.n)
    x = torch.from_numpy(_vec(3, 3, spec.n))
    wire, _ = codec.encode(x)
    dense = comm.decode_stack(codec, wire, spec)
    assert dense["a"].shape == (3, 2, 4) and dense["b"].shape == (3, 5)
    assert torch.equal(dense["a"].reshape(3, -1), codec.decode(wire)[:, :8])


@pytest.mark.parametrize("name,opts,err,match", [
    # the first two ids are kept from before topk and lowrank were ported,
    # when they asserted KeyError "not ported"; they now assert what the
    # reference asserts for these names: the codec builds in both packages
    # and an out-of-range value raises ValueError in both
    pytest.param("topk", dict(ratio=0.0), ValueError, "ratio",
                 id="topk-opts0-KeyError-not ported"),
    pytest.param("lowrank", dict(rank=0), ValueError, "rank",
                 id="lowrank-opts1-KeyError-not ported"),
    ("nope", {}, KeyError, "unknown codec"),
    ("int8", dict(ratio=0.1), TypeError, "not used by codec"),
    ("bf16", dict(chunk=64), TypeError, "not used by codec"),
])
def test_registry_and_option_errors(name, opts, err, match):
    if err is ValueError:
        # a registered name with a bad value: both packages build it with
        # its defaults, and both refuse the value
        jcomm.get_codec(name, n=100)
        assert comm.get_codec(name, n=100).name == name
    with pytest.raises(err):
        jcomm.validate_codec_opts(name, opts)
    with pytest.raises(err, match=match):
        comm.get_codec(name, n=100, **opts)
    with pytest.raises(err):
        comm.validate_codec_opts(name, opts)
    assert set(comm.CODECS) | set(comm.NOT_PORTED) == set(jcomm.CODECS)


def test_stochastic_codecs_need_their_uniforms():
    codec = comm.get_codec("int8", n=700)
    x = torch.zeros(2, 700)
    with pytest.raises(ValueError, match="uniforms"):
        codec.encode(x)
    with pytest.raises(ValueError, match="shape"):
        codec.encode(x, None, torch.zeros(2, 1, 512))


@pytest.mark.parametrize("name,n,qmax", [("int8", 700, 127.0),
                                         ("int4", 300, 7.0)])
def test_quantized_codecs_unbiased_over_generator_draws(name, n, qmax):
    """E_u[decode(encode(x, u))] == x over draws of the port's generator,
    as tests/test_comm.py holds the reference over PRNG keys."""
    n_draws = 4096
    codec = comm.get_codec(name, n=n)
    vec = torch.from_numpy(_vec(0, n))
    gen = torch.Generator().manual_seed(1)
    u = torch.rand(codec.uniforms_shape(n_draws), generator=gen)
    wire, _ = codec.encode(vec.expand(n_draws, n), None, u)
    mean = codec.decode(wire).mean(dim=0)
    step = float(vec.abs().max()) / qmax
    np.testing.assert_allclose(mean.numpy(), vec.numpy(),
                               atol=6.0 * step / np.sqrt(n_draws))


@pytest.mark.parametrize("name,qmax", [("int8", 127), ("int4", 7)])
@pytest.mark.parametrize("n", [5, 512, 700, 1025])
def test_quantization_error_bounded(name, qmax, n):
    """|decode - x| <= the chunk scale (one step); codes in range."""
    codec = comm.get_codec(name, n=n)
    vec = torch.from_numpy(_vec(n, 2, n)) * 3.0
    u = torch.rand(codec.uniforms_shape(2),
                   generator=torch.Generator().manual_seed(n))
    wire, _ = codec.encode(vec, None, u)
    codes = (wire["q"].int() if name == "int8"
             else tref.unpack_int4_ref(wire["q"], chunk=codec.chunk))
    assert int(codes.abs().max()) <= qmax
    step = torch.repeat_interleave(wire["s"], codec.chunk, dim=1)[:, :n]
    assert bool(((codec.decode(wire) - vec).abs() <= step + 1e-7).all())


def test_quantized_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(3, 1024, dtype=torch.int8)
    s, w = torch.ones(3, 2), torch.ones(3)
    with pytest.raises(TypeError):
        K.ncv_weighted_sum_q(q.float(), s, w)
    with pytest.raises(TypeError):
        K.ncv_weighted_sum_q4(q, s, w)
    with pytest.raises(ValueError, match="scales"):
        K.ncv_weighted_sum_q(q, torch.ones(3, 3), w)
    with pytest.raises(ValueError, match="chunk"):
        K.ncv_weighted_sum_q(q, s, w, chunk=1000)
    with pytest.raises(ValueError, match="multiple of 2"):
        K.ncv_weighted_sum_q4(q.view(torch.uint8), s, w, chunk=511)
    with pytest.raises(ValueError):
        K.ncv_weighted_sum_q(q, s, torch.ones(4))
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        K.ncv_weighted_sum_q(torch.zeros(3, 1024, dtype=torch.int8, **meta),
                             torch.ones(3, 2, **meta), torch.ones(3, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        K.ncv_weighted_sum_q4(torch.zeros(3, 512, dtype=torch.uint8, **meta),
                              torch.ones(3, 2, **meta), torch.ones(3, **meta))
