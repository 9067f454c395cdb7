"""The port's attention against the JAX package's, on the CPU.

The plain flash version (`repro_torch.kernels.flash_attention.ref`, the CPU
path of the kernel wrapper) against the reference's oracle
`flash_attention_ref` over the reference's sweep, and against the Pallas
kernel in interpret mode; then the model's attention blocks, prefill and
decode, with weights carried across.  Inputs are made with numpy from a
seed and handed to both packages.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import attention as jax_attention
from repro.kernels.flash_attention.ref import flash_attention_ref as _jref
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref as torch_flash_ref
from repro_torch.models import layers as TL

# tests/test_kernels.py::SWEEP of the reference:
# b, s, h, kv, hd, causal, window, softcap
SWEEP = [
    (2, 256, 4, 2, 128, True, None, None),
    (1, 128, 4, 4, 64, True, None, None),
    (1, 256, 2, 1, 128, True, 128, None),
    (1, 256, 2, 2, 128, True, None, 30.0),
    (2, 128, 4, 2, 96, False, None, None),
    (1, 512, 8, 8, 32, True, 64, 50.0),
]
# jitted: eager JAX compiles every primitive on first use
flash_attention_ref = jax.jit(_jref,
                              static_argnames=("causal", "window", "softcap"))
# f32: the reference kernel tests' tolerance; bf16: theirs for bf16 inputs
TOL = 2e-4
TOL_BF16 = 2e-2


def _qkv(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32),
            rng.standard_normal((b, s, kv, hd)).astype(np.float32))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,softcap", SWEEP)
def test_plain_flash_matches_reference_oracle(b, s, h, kv, hd, causal, window,
                                              softcap):
    q, k, v = _qkv(s + h, b, s, h, kv, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **kw)
    got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **kw)
    _close(got, want, TOL)


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,softcap", [
    (1, 128, 2, 1, 64, True, None, None),
    (1, 256, 2, 1, 32, True, 64, 50.0),
])
def test_plain_flash_matches_pallas_interpret(b, s, h, kv, hd, causal, window,
                                              softcap):
    q, k, v = _qkv(7 * s + hd, b, s, h, kv, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         interpret=True, **kw)
    got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **kw)
    _close(got, want, TOL)


@pytest.mark.parametrize("s,window,softcap", [(256, None, None),
                                              (200, 64, 50.0)])
def test_plain_flash_bf16_matches_reference_oracle(s, window, softcap):
    q, k, v = _qkv(s, 1, s, 4, 2, 128)
    to_j = lambda x: jnp.asarray(x).astype(jnp.bfloat16)  # noqa: E731
    to_t = lambda x: torch.from_numpy(x).bfloat16()       # noqa: E731
    kw = dict(causal=True, window=window, softcap=softcap)
    want = flash_attention_ref(to_j(q), to_j(k), to_j(v), **kw)
    got = FA.flash_attention(to_t(q), to_t(k), to_t(v), **kw)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), TOL_BF16)


@pytest.mark.parametrize("s", [1, 24, 300])
def test_plain_flash_ragged_lengths(s):
    """Any S: the port has no S % 128 restriction."""
    q, k, v = _qkv(s, 1, s, 4, 2, 16)
    want = flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), window=100)
    got = torch_flash_ref(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), window=100)
    _close(got, want, TOL)


def test_flash_wrapper_checks_shapes_on_every_device():
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 8, 4, 3, 16))
    with pytest.raises(ValueError, match="multiple"):
        FA.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="window"):
        FA.flash_attention(q, q, q, window=0)
    # k and v of their own length (cross-attention): S_kv = 4 against S = 8
    # is what the reference computes, its masks top-left aligned
    got = FA.flash_attention(q, q[:, :4], q[:, :4])
    want = flash_attention_ref(jnp.asarray(q.numpy()),
                               jnp.asarray(q[:, :4].numpy()),
                               jnp.asarray(q[:, :4].numpy()))
    assert got.shape == q.shape
    _close(got, want, TOL)
    # but the same batch and head width
    for bad in (q[:1].expand(2, 8, 4, 16).contiguous(), q[..., :8]):
        with pytest.raises(ValueError, match="do not match"):
            FA.flash_attention(q, bad, bad)


def test_attend_and_mask_match_reference():
    q, k, v = _qkv(3, 2, 12, 4, 2, 32)
    for causal, window in ((True, None), (True, 5), (False, None)):
        jm = JL._make_mask(12, 12, causal=causal, window=window)
        tm = TL._make_mask(12, 12, causal=causal, window=window)
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
        want = JL.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                         softcap=30.0)
        got = TL.attend(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), tm, softcap=30.0)
        _close(got, want, TOL)


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 3, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32)
    pos = np.tile(np.arange(6, dtype=np.int32)[None] + 100, (2, 1))
    _close(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(w)), 1e-6)
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5), 1e-5)


def _attn_params(seed, spec):
    rng = np.random.default_rng(seed)
    shapes = JL.attn_param_shapes(spec)
    return {n: (rng.standard_normal(shp) / math.sqrt(shp[0])).astype(
        np.float32) for n, shp in shapes.items()}


SPEC = JL.AttnParamsSpec(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16)
T_SPEC = TL.AttnParamsSpec(64, 4, 2, 16)


@pytest.mark.parametrize("window,softcap", [(None, None), (8, None),
                                            (None, 50.0), (8, 50.0)])
def test_attention_block_matches_reference(window, softcap):
    p = _attn_params(1, SPEC)
    x = np.random.default_rng(2).standard_normal((2, 20, 64)).astype(
        np.float32)
    pos = np.tile(np.arange(20, dtype=np.int32)[None], (2, 1))
    kw = dict(causal=True, window=window, softcap=softcap, rope_theta=5e5)
    want = JL.attention_block({n: jnp.asarray(a) for n, a in p.items()},
                              jnp.asarray(x), jnp.asarray(pos), SPEC, **kw)
    got = TL.attention_block({n: torch.from_numpy(a) for n, a in p.items()},
                             torch.from_numpy(x), torch.from_numpy(pos),
                             T_SPEC, **kw)
    _close(got, want, TOL)


# The reference's attention_block takes `attend` below
# _BLOCKED_ATTN_THRESHOLD (2,048 tokens), which rounds the softmax
# probabilities to bf16 before P.V, and `blocked_attention` from 2,048 on,
# which keeps them in f32 as the port's flash path does at every length.
S_BLOCKED = JL._BLOCKED_ATTN_THRESHOLD
SPEC_SMALL = JL.AttnParamsSpec(d_model=32, n_heads=2, n_kv_heads=1,
                               head_dim=16)
T_SPEC_SMALL = TL.AttnParamsSpec(32, 2, 1, 16)


@pytest.mark.parametrize("window", [None, 256])
def test_bf16_attention_block_matches_reference_blocked_path(window):
    """bf16 at S = 2,048, where both keep P in f32: one bf16 step.

    rtol 2^-7: one bf16 rounding of y = a @ wo apart (2^-8 relative on
    each side).  atol 2^-8: a y that cancels towards 0 still carries the
    one-step (2^-8) differences of the attention output a in its 32 terms,
    2^-8 * sum_i |a_i w_ij|, which is 1.8e-3 at the median element here;
    2^-8 covers sums up to 1."""
    p = _attn_params(11, SPEC_SMALL)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, S_BLOCKED, 32)).astype(np.float32)
    pos = np.arange(S_BLOCKED, dtype=np.int32)[None]
    kw = dict(causal=True, window=window, softcap=None, rope_theta=5e5)
    block = jax.jit(lambda p_, x_, pos_: JL.attention_block(
        p_, x_, pos_, SPEC_SMALL, **kw))
    want = block({n: jnp.asarray(a, jnp.bfloat16) for n, a in p.items()},
                 jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos))
    got = TL.attention_block(
        {n: torch.from_numpy(a).bfloat16() for n, a in p.items()},
        torch.from_numpy(x).bfloat16(), torch.from_numpy(pos), T_SPEC_SMALL,
        **kw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=2 ** -8)


def test_attention_block_refuses_what_is_not_ported():
    p = {n: torch.from_numpy(a) for n, a in _attn_params(1, SPEC).items()}
    x = torch.zeros(1, 4, 64)
    pos = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="not ported"):
        TL.attention_block(p, x, pos, T_SPEC, q_scale=0.5)
    jp = {n: jnp.asarray(a) for n, a in _attn_params(1, SPEC).items()}
    # cross-attention is ported (whisper): 6 queries onto 9 memory states,
    # no RoPE, all of memory
    rng = np.random.default_rng(4)
    xq, mem = (rng.standard_normal((2, n, 64)).astype(np.float32)
               for n in (6, 9))
    pos = np.tile(np.arange(6, dtype=np.int32)[None], (2, 1))
    got = TL.attention_block(p, torch.from_numpy(xq), torch.from_numpy(pos),
                             T_SPEC, use_rope=False,
                             kv_x=torch.from_numpy(mem))
    want = JL.attention_block(jp, jnp.asarray(xq), jnp.asarray(pos), SPEC,
                              use_rope=False, kv_x=jnp.asarray(mem))
    assert got.shape == (2, 6, 64)
    _close(got, want, TOL)
    # chunked attention is ported (llama4): the chunk-masked attention
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 5, 64)).astype(np.float32))
    pos = torch.arange(5, dtype=torch.int32)[None]
    got = TL.attention_block(p, x, pos, T_SPEC, chunk=2)
    want = JL.attention_block(jp, jnp.asarray(x.numpy()),
                              jnp.asarray(pos.numpy()), SPEC, chunk=2)
    _close(got, want, TOL)


@pytest.mark.parametrize("mode,cache_len,positions", [
    ("full", 12, (0, 1, 7, 11)),
    ("ring", 5, (0, 3, 4, 5, 9, 13)),
])
def test_decode_attention_block_matches_reference(mode, cache_len, positions):
    p = _attn_params(4, SPEC)
    rng = np.random.default_rng(6)
    ck = rng.standard_normal((2, cache_len, 2, 16)).astype(np.float32)
    cv = rng.standard_normal((2, cache_len, 2, 16)).astype(np.float32)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    jk, jv = jnp.asarray(ck), jnp.asarray(cv)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    for pos in positions:
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        want, jk, jv = JL.decode_attention_block(
            jp, jnp.asarray(x), jk, jv, jnp.int32(pos), SPEC, mode=mode,
            softcap=50.0, rope_theta=1e4)
        got, tk, tv = TL.decode_attention_block(
            tp, torch.from_numpy(x), tk, tv, pos, T_SPEC, mode=mode,
            softcap=50.0, rope_theta=1e4)
        _close(got, want, TOL)
        _close(tk, jk, 1e-6)
        _close(tv, jv, 1e-6)
