"""The port's encdec family (whisper-medium) against the JAX package, on the
CPU.

The plain flash version with a key length of its own (S_kv != S) against
the Pallas kernel in interpret mode and the reference's oracle; the new
layer helpers (sinusoidal positions, layernorm, the tanh GELU FFN); then
reduced whisper (2 + 2 layers, d 128, 4/2 heads, 16 frames) in f32 with
the reference's parameters carried across by `params_from_jax`, on the
same numpy tokens and frames: encode, logits, loss, the caches,
`prefill_cross` and decode step by step; bf16 layer by layer from the
reference's state; and the serve CLI.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as pallas_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as _jref
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.models import layers as JL
from repro_torch import configs
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.launch.serve import prepare_cache
from repro_torch.launch.train import make_prefill_step, make_serve_step
from repro_torch.models import api, encdec
from repro_torch.models import layers as TL
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper-medium"
S = 16
# f32, the port against the reference: matmuls and sums in another order
RTOL, ATOL = 1e-4, 1e-5
# bf16, one bf16 step of the output
RTOL_BF16, ATOL_BF16 = 1e-2, 1e-3
# a bf16 layer's output is the rounded sum of the residual stream and the
# FFN's rounded output, both of unit scale: where one of them rounds the
# other way (an f32 sum in another order under it), the output moves by
# that term's step, 2^-7 for a term in [1, 2), even where the sum cancels
# towards 0
ATOL_STEP = 2 ** -7
# bf16 attention: the reference's `attend` (S < 2,048) rounds P to bf16
# before P.V, the flash kernel keeps it in f32; tests/test_torch_attention.py's
# bf16 llama tolerance
TOL_P = 2e-2


def _shape_dtype(x):
    return tuple(x.shape), jnp.dtype(x.dtype)


def _cfgs(**kw):
    return (configs.get(ARCH).reduced().replace(**kw),
            jconfigs.get(ARCH).reduced().replace(**kw))


def _reference_tree(cfg, jcfg, seed):
    """The port's init as the reference's tree, whose keys, shapes and
    dtypes must be those of the reference's own init (traced abstractly)."""
    tp = api.init_params(cfg, seed, device="cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(
        t.float().numpy(), dtype=jnp.bfloat16 if t.dtype == torch.bfloat16
        else jnp.float32), tp)
    spec = jax.eval_shape(lambda k: japi.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    assert jax.tree.map(_shape_dtype, jp) == \
        jax.tree.map(_shape_dtype, spec)
    return jp


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                               np.float32),
                               rtol=rtol, atol=atol)


# ---------------------- flash with a key length of its own -------------------

def _qkv(seed, s, s_kv, h=4, kv=2, hd=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, s, h, hd)).astype(np.float32),
            rng.standard_normal((1, s_kv, kv, hd)).astype(np.float32),
            rng.standard_normal((1, s_kv, kv, hd)).astype(np.float32))


# (S, S_kv, window): S_kv below and above S; at S 64 against 40 keys the
# window 8 leaves the rows 47..63 no key (their mean over all 40 values)
SKV_SHAPES = ((96, 128, 32), (128, 256, 64), (64, 40, 8))
MASKS = ("none", "causal", "window")


def _mask_kw(mask, window):
    return dict(causal=mask != "none",
                window=window if mask == "window" else None)


@pytest.mark.parametrize("s,s_kv,window", SKV_SHAPES)
def test_plain_flash_takes_its_own_key_length(s, s_kv, window):
    """Every mask at each shape, against the reference's oracle (one
    compile a shape)."""
    q, k, v = _qkv(s + s_kv, s, s_kv)
    wants = jax.jit(lambda q_, k_, v_: [_jref(q_, k_, v_, **_mask_kw(
        m, window)) for m in MASKS])(q, k, v)
    for mask, want in zip(MASKS, wants):
        got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 **_mask_kw(mask, window))
        assert got.shape == (1, s, 4, 32)
        _close(got, want, 2e-4, 2e-4)


@pytest.mark.parametrize("s,s_kv,window,mask",
                         [shape + (m,) for shape, m in zip(SKV_SHAPES,
                                                           MASKS[::-1])])
def test_plain_flash_key_length_matches_pallas_interpret(s, s_kv, window,
                                                         mask):
    q, k, v = _qkv(7 * s + s_kv, s, s_kv)
    kw = _mask_kw(mask, window)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        interpret=True, **kw)
    got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **kw)
    _close(got, want, 2e-4, 2e-4)


# ------------------------------- layer helpers -------------------------------

def test_sinusoidal_positions_match_reference():
    want = np.asarray(jax.jit(JL.sinusoidal_positions,
                              static_argnums=(0, 1))(40, 128))
    got = TL.sinusoidal_positions(40, 128)
    _close(got, want)
    # sin at even columns, cos at odd ones
    angle = TL.sinusoidal_angles(torch.arange(40, dtype=torch.float32), 128)
    assert torch.equal(got[:, 0::2], torch.sin(angle))
    assert torch.equal(got[:, 1::2], torch.cos(angle))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_and_gelu_mlp_match_reference(dtype):
    """layernorm (no model calls it; part of the module) and the GELU FFN
    in its tanh form, `jax.nn.gelu`'s default, at nonzero biases.  bf16:
    one bf16 step (the bias add before the GELU in f32, as XLA computes
    the reference)."""
    rng = np.random.default_rng(4)
    jdt = jnp.dtype(dtype)
    x = jnp.asarray(rng.standard_normal((2, 6, 32)) * 2 + 0.5, jdt)
    w, b = (jnp.asarray(rng.standard_normal((32,)), jdt) for _ in range(2))
    p = {"w_in": rng.standard_normal((32, 64)) / np.sqrt(32),
         "b_in": rng.standard_normal((64,)),
         "w_out": rng.standard_normal((64, 32)) / 8.0,
         "b_out": rng.standard_normal((32,))}
    p = {n: jnp.asarray(a, jdt) for n, a in p.items()}
    tol = (RTOL, ATOL) if dtype == "float32" else (RTOL_BF16, ATOL_BF16)
    tx, tw, tb = (params_from_jax(np.asarray(a)) for a in (x, w, b))
    want = jax.jit(JL.layernorm)(x, w, b)
    got = TL.layernorm(tx, tw, tb)
    assert got.dtype == tx.dtype
    _close(got, want, *tol)
    want = jax.jit(JL.gelu_mlp)(p, x)
    got = TL.gelu_mlp(params_from_jax(jax.tree.map(np.asarray, p)), tx)
    assert got.dtype == tx.dtype
    _close(got, want, *tol)
    spec = jax.eval_shape(lambda k: JL.init_gelu_mlp(k, 32, 64, jdt),
                          jax.random.PRNGKey(0))
    init = TL.init_gelu_mlp(torch.Generator().manual_seed(0), 32, 64,
                            getattr(torch, dtype))
    assert {n: (tuple(t.shape), str(t.dtype)) for n, t in init.items()} == \
        {n: (s.shape, "torch." + str(s.dtype)) for n, s in spec.items()}


# ------------------------------- the whole model -----------------------------

def _frames(cfg, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (2, cfg.enc_frames, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def f32():
    """Reduced whisper in f32: the reference's tree and the carried params,
    tokens and frames, and the reference's encoder states, logits, loss,
    cross caches and teacher-forced decode (logits and self caches)."""
    cfg, jcfg = _cfgs(dtype="float32")
    jp = _reference_tree(cfg, jcfg, 0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, S)).astype(
        np.int32)
    labels = np.roll(toks, -1, axis=1)
    frames = _frames(cfg)
    jbatch = dict(tokens=jnp.asarray(toks), labels=jnp.asarray(labels),
                  frames=jnp.asarray(frames))
    def prefill(p, b):
        enc = jencdec.encode(jcfg, p, b["frames"])
        return (enc, jencdec.decode_train(jcfg, p, b["tokens"], enc),
                japi.loss(jcfg, p, b),
                jencdec.prefill_cross(jcfg, p, japi.init_cache(jcfg, 2, S),
                                      enc))
    enc, logits, loss, cache = jax.jit(prefill)(jp, jbatch)
    step = jax.jit(lambda p, c, t, pos: japi.decode_step(jcfg, p, c, t, pos))
    dec = []
    for i in range(S):
        lg, cache = step(jp, cache, jbatch["tokens"][:, i:i + 1],
                         jnp.int32(i))
        dec.append((np.asarray(lg), np.asarray(cache["self"]["k"]),
                    np.asarray(cache["self"]["v"])))
    return dict(cfg=cfg, jcfg=jcfg,
                params=params_from_jax(jax.tree.map(np.asarray, jp)),
                batch=dict(api.make_batch(cfg, toks, 2, S, device="cpu"),
                           frames=torch.from_numpy(frames)),
                enc=np.asarray(enc), logits=np.asarray(logits),
                loss=float(loss), cross_k=np.asarray(cache["cross_k"]),
                cross_v=np.asarray(cache["cross_v"]), dec=dec)


def test_encode_logits_and_loss_match_reference(f32):
    cfg, params, batch = f32["cfg"], f32["params"], f32["batch"]
    assert params["decoder"]["x_wk"].shape == (2, cfg.d_model,
                                               cfg.n_kv_heads * cfg.hd)
    _close(encdec.encode(cfg, params, batch["frames"]), f32["enc"])
    got = api.logits(cfg, params, batch)
    assert got.dtype == torch.float32 and got.shape == (2, S, cfg.vocab)
    _close(got, f32["logits"])
    np.testing.assert_allclose(float(api.loss(cfg, params, batch)),
                               f32["loss"], rtol=RTOL)
    assert torch.equal(make_prefill_step(cfg)(params, batch), got)


@pytest.mark.parametrize("cache_len", [S, 448])
def test_init_cache_matches_reference_shapes(cache_len):
    """Full whisper-medium (on the meta device: nothing is allocated) and
    the reduced model: the self cache and the (L, B, T_enc, KV, hd) cross
    K/V."""
    for cfg, jcfg in ((configs.get(ARCH), jconfigs.get(ARCH)), _cfgs()):
        cache = api.init_cache(cfg, 2, cache_len, device="meta")
        want = jax.eval_shape(lambda: japi.init_cache(jcfg, 2, cache_len))
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)),
                            cache) == \
            jax.tree.map(lambda t: (tuple(t.shape), "torch." + str(t.dtype)),
                         want)
    assert cache["cross_k"].shape == (2, 2, 16, 2, 32)


def test_prefill_cross_and_decode_steps_match_reference(f32):
    """The frames encoded into the cross K/V (`prepare_cache`, the serve
    loop's), then teacher-forced decode step by step: the logits and the
    self caches, the position embedding computed at each step's pos."""
    cfg, params, batch = f32["cfg"], f32["params"], f32["batch"]
    cache = prepare_cache(cfg, params, 2, S, "cpu", batch["frames"])
    _close(cache["cross_k"], f32["cross_k"])
    _close(cache["cross_v"], f32["cross_v"])
    step = make_serve_step(cfg)
    toks = batch["tokens"]
    for i, (want, jk, jv) in enumerate(f32["dec"]):
        got, cache = step(params, cache, toks[:, i:i + 1], i)
        _close(got, want)
        _close(cache["self"]["k"], jk)
        _close(cache["self"]["v"], jv)


# ------------------------------------ bf16 -----------------------------------

@functools.partial(jax.jit, static_argnums=0)
def _jenc_layer(jcfg, p_l, x):
    """The reference's encoder scan body (`encdec.encode`)."""
    spec = jencdec._attn_spec(jcfg)
    pos = jnp.broadcast_to(jnp.arange(x.shape[1])[None], x.shape[:2])
    h = JL.rmsnorm(x, p_l["attn_norm"])
    x = x + JL.attention_block(p_l, h, pos, spec, causal=False,
                               use_rope=False)
    h = JL.rmsnorm(x, p_l["ffn_norm"])
    return x + JL.gelu_mlp(p_l, h)


@functools.partial(jax.jit, static_argnums=0)
def _jdec_layer(jcfg, p_l, x, enc_out):
    """The reference's decoder scan body (`encdec.decode_train`)."""
    spec = jencdec._attn_spec(jcfg)
    pos = jnp.broadcast_to(jnp.arange(x.shape[1])[None], x.shape[:2])
    h = JL.rmsnorm(x, p_l["attn_norm"])
    x = x + JL.attention_block(p_l, h, pos, spec, causal=True,
                               use_rope=False)
    h = JL.rmsnorm(x, p_l["cross_norm"])
    x = x + JL.attention_block(jencdec._cross_params(p_l), h, pos, spec,
                               use_rope=False, kv_x=enc_out)
    h = JL.rmsnorm(x, p_l["ffn_norm"])
    return x + JL.gelu_mlp(p_l, h)


def _bf16_tree(cfg, jcfg, zero_attention=False):
    """The reference's bf16 tree with nonzero norms and biases; with
    `zero_attention`, every attention weight 0, so that attention adds
    exactly 0 on both sides."""
    jp = jax.tree.map(np.asarray, _reference_tree(cfg, jcfg, 2))
    rng = np.random.default_rng(5)
    for part in ("encoder", "decoder"):
        for n, a in jp[part].items():
            if n.endswith("norm") or n.startswith("b_"):
                jp[part][n] = (rng.standard_normal(a.shape) * 0.3).astype(
                    a.dtype)
            elif zero_attention and n.removeprefix("x_") in ("wq", "wk", "wv",
                                                       "wo"):
                jp[part][n] = np.zeros_like(a)
    return jax.tree.map(jnp.asarray, jp)


@pytest.mark.parametrize("attention", [True, False])
def test_bf16_layers_match_reference_layer_by_layer(attention):
    """bf16 weights and activations, each encoder and decoder layer from
    the reference's state before it (the decoder's with the reference's
    encoder states).  With every attention weight 0 (attention then adds
    exactly 0 on both sides), the norms, residual adds and GELU FFNs are
    rounded where XLA rounds the reference (`layers.add_norm`, `gelu_mlp`): one
    bf16 step of a term (ATOL_STEP).  With attention, P's rounding too
    (TOL_P)."""
    tol = (TOL_P, TOL_P) if attention else (RTOL_BF16, ATOL_STEP)
    cfg, jcfg = _cfgs()
    jp = _bf16_tree(cfg, jcfg, zero_attention=not attention)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.standard_normal((2, cfg.enc_frames, cfg.d_model)),
                    jnp.bfloat16)
    pos = encdec._positions(2, cfg.enc_frames, "cpu")
    for i in range(cfg.n_enc_layers):
        p_l = jax.tree.map(lambda a: a[i], jp["encoder"])
        want = _jenc_layer(jcfg, p_l, x)
        got = encdec.encoder_layer(cfg, encdec.layer_params(
            params["encoder"], i), params_from_jax(np.asarray(x)), pos)
        assert got.dtype == torch.bfloat16
        _close(got, want, *tol)
        x = want
    enc_out = jax.jit(JL.rmsnorm)(x, jp["enc_final_norm"])
    y = jnp.asarray(rng.standard_normal((2, S, cfg.d_model)), jnp.bfloat16)
    pos = encdec._positions(2, S, "cpu")
    t_enc = params_from_jax(np.asarray(enc_out))
    for i in range(cfg.n_layers):
        p_l = jax.tree.map(lambda a: a[i], jp["decoder"])
        want = _jdec_layer(jcfg, p_l, y, enc_out)
        got = encdec.decoder_layer(cfg, encdec.layer_params(
            params["decoder"], i), params_from_jax(np.asarray(y)), pos,
            t_enc)
        _close(got, want, *tol)
        y = want


def test_serve_cli_runs_whisper_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--batch", "2", "--prompt", "8", "--decode", "8",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert "tok/s on cpu" in lines[0] and lines[-1] == "ok"
