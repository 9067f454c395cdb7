"""The port's vlm family (llama-3.2-vision-11b) against the JAX package, on
the CPU.

Reduced llama-3.2-vision at 4 layers (2 groups of one self-attention layer
and one gated cross-attention layer; d 128, 4/2 heads, 8 image tokens),
the reference's parameters carried across by `params_from_jax`, with
nonzero norms and nonzero gates in every test (init's gates are 0, and
tanh(0) = 0 would leave every cross layer the identity), on the same numpy
tokens and image embeddings: the tree, f32 logits, loss, the caches,
`prefill_cross` and decode step by step; bf16 group by group from the
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
from repro.models import api as japi
from repro.models import vlm as jvlm
from repro_torch import configs
from repro_torch.launch.serve import prepare_cache
from repro_torch.launch.train import make_prefill_step, make_serve_step
from repro_torch.models import api, vlm
from repro_torch.models import layers as L
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama-3.2-vision-11b"
S = 16
N_LAYERS = 4
# f32, the port against the reference: matmuls and sums in another order
RTOL, ATOL = 1e-4, 1e-5
# bf16 with every attention weight 0: one bf16 step of a term (2^-7 for a
# term in [1, 2)), where a product's f32 sum in another order rounds the
# other way
RTOL_BF16, ATOL_STEP = 1e-2, 2 ** -7
# bf16 attention: the reference's `attend` (S < 2,048) rounds P to bf16
# before P.V, the flash kernel keeps it in f32 (tests/test_torch_encdec.py)
TOL_P = 2e-2


def _cfgs(**kw):
    kw = dict(n_layers=N_LAYERS, **kw)
    return (configs.get(ARCH).reduced().replace(**kw),
            jconfigs.get(ARCH).reduced().replace(**kw))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                               np.float32),
                               rtol=rtol, atol=atol)


def _tree(cfg, jcfg, seed, zero_attention=False):
    """The port's init as the reference's tree, whose keys, shapes and
    dtypes must be those of the reference's own init (traced abstractly),
    with nonzero norms and gates drawn from a numpy seed; with
    `zero_attention`, every attention weight 0."""
    tp = api.init_params(cfg, seed, device="cpu")
    rng = np.random.default_rng(seed + 5)

    def draw(path, t):
        name = path[-1].key
        a = t.float().numpy()
        if name.endswith("norm"):
            a = rng.standard_normal(a.shape) * 0.3
        elif name.endswith("_gate") and a.ndim == 1:
            a = rng.uniform(-1.0, 1.0, a.shape)
        elif zero_attention and name in ("wq", "wk", "wv", "wo"):
            a = np.zeros_like(a)
        return jnp.asarray(a, jnp.bfloat16 if t.dtype == torch.bfloat16
                           else jnp.float32)

    jp = jax.tree_util.tree_map_with_path(draw, tp)
    spec = jax.eval_shape(lambda k: japi.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    assert jax.tree.map(lambda t: (t.shape, t.dtype), jp) == \
        jax.tree.map(lambda t: (t.shape, t.dtype), spec)
    assert np.all(np.asarray(jp["cross_layers"]["attn_gate"]) != 0)
    return jp


def _image(cfg, seed=1, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_matches_reference_tree(dtype):
    """The reference's keys, shapes and dtypes (the gates f32 in a bf16
    model), zero norms and gates, and the tree carried across both ways."""
    cfg, jcfg = _cfgs(dtype=dtype)
    tp = api.init_params(cfg, 0, device="cpu")
    spec = jax.eval_shape(lambda k: japi.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), tp) == \
        jax.tree.map(lambda t: (t.shape, "torch." + str(t.dtype)), spec)
    cross = tp["cross_layers"]
    assert sorted(cross) == sorted(spec["cross_layers"])
    for n in ("attn_gate", "ffn_gate", "attn_norm", "ffn_norm"):
        assert not cross[n].any()
    assert cross["attn_gate"].dtype == torch.float32
    assert vlm.plan(cfg) == (2, 2, 2)
    assert vlm.plan(configs.get(ARCH)) == (8, 32, 5)
    jp = _tree(cfg, jcfg, 0)
    back = params_from_jax(jax.tree.map(np.asarray, jp))
    assert back["cross_layers"]["ffn_gate"].dtype == torch.float32
    assert api.family_module(cfg) is vlm


@pytest.fixture(scope="module")
def f32():
    """Reduced llama-3.2-vision in f32: the carried params, tokens and
    image embeddings, and the reference's logits, loss, cross caches and
    teacher-forced decode (logits and self caches)."""
    cfg, jcfg = _cfgs(dtype="float32")
    jp = _tree(cfg, jcfg, 0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, S)).astype(
        np.int32)
    img = _image(cfg)
    jbatch = dict(tokens=jnp.asarray(toks),
                  labels=jnp.asarray(np.roll(toks, -1, axis=1)),
                  image_embeds=jnp.asarray(img))

    def prefill(p, b):
        return (japi.logits(jcfg, p, b), japi.loss(jcfg, p, b),
                jvlm.prefill_cross(jcfg, p, japi.init_cache(jcfg, 2, S),
                                   b["image_embeds"]))
    logits, loss, cache = jax.jit(prefill)(jp, jbatch)
    step = jax.jit(lambda p, c, t, pos: japi.decode_step(jcfg, p, c, t, pos))
    dec = []
    for i in range(S):
        lg, cache = step(jp, cache, jbatch["tokens"][:, i:i + 1],
                         jnp.int32(i))
        dec.append((np.asarray(lg), np.asarray(cache["self"]["k"]),
                    np.asarray(cache["self"]["v"])))
    return dict(cfg=cfg, params=params_from_jax(jax.tree.map(np.asarray, jp)),
                batch=dict(api.make_batch(cfg, toks, 2, S, device="cpu"),
                           image_embeds=torch.from_numpy(img)),
                logits=np.asarray(logits), loss=float(loss),
                cross_k=np.asarray(cache["cross_k"]),
                cross_v=np.asarray(cache["cross_v"]), dec=dec)


def test_logits_and_loss_match_reference(f32):
    cfg, params, batch = f32["cfg"], f32["params"], f32["batch"]
    got = api.logits(cfg, params, batch)
    assert got.dtype == torch.float32 and got.shape == (2, S, cfg.vocab)
    _close(got, f32["logits"])
    np.testing.assert_allclose(float(api.loss(cfg, params, batch)),
                               f32["loss"], rtol=RTOL)
    assert torch.equal(make_prefill_step(cfg)(params, batch), got)
    # the gates matter: closed, the cross layers add nothing
    shut = dict(params, cross_layers=dict(
        params["cross_layers"],
        attn_gate=torch.zeros(2), ffn_gate=torch.zeros(2)))
    assert not torch.allclose(api.logits(cfg, shut, batch), got, atol=1e-3)


@pytest.mark.parametrize("cache_len", [S, 4096])
def test_init_cache_matches_reference_shapes(cache_len):
    """Full llama-3.2-vision-11b (on the meta device: nothing is allocated)
    and the reduced model: the (n_self, B, C, KV, hd) self cache and the
    (n_groups, B, n_image_tokens, KV, hd) image K/V."""
    for cfg, jcfg in ((configs.get(ARCH), jconfigs.get(ARCH)), _cfgs()):
        cache = api.init_cache(cfg, 2, cache_len, device="meta")
        want = jax.eval_shape(lambda: japi.init_cache(jcfg, 2, cache_len))
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)),
                            cache) == \
            jax.tree.map(lambda t: (tuple(t.shape), "torch." + str(t.dtype)),
                         want)
        if cfg.n_layers == 40:
            assert cache["cross_k"].shape == (8, 2, 1601, 8, 128)
            assert cache["self"]["k"].shape == (32, 2, cache_len, 8, 128)


def test_prefill_cross_and_decode_steps_match_reference(f32):
    """The image K/V (`prepare_cache`, the serve loop's), then
    teacher-forced decode step by step: the logits and the self caches."""
    cfg, params, batch = f32["cfg"], f32["params"], f32["batch"]
    cache = prepare_cache(cfg, params, 2, S, "cpu",
                          image_embeds=batch["image_embeds"])
    _close(cache["cross_k"], f32["cross_k"])
    _close(cache["cross_v"], f32["cross_v"])
    with pytest.raises(ValueError, match="image_embeds"):
        prepare_cache(cfg, params, 2, S, "cpu")
    step = make_serve_step(cfg)
    toks = batch["tokens"]
    for i, (want, jk, jv) in enumerate(f32["dec"]):
        got, cache = step(params, cache, toks[:, i:i + 1], i)
        _close(got, want)
        _close(cache["self"]["k"], jk)
        _close(cache["self"]["v"], jv)


# ------------------------------------ bf16 -----------------------------------

@functools.partial(jax.jit, static_argnums=0)
def _jgroup(jcfg, p_selfs, p_cross, x, image_embeds):
    """`vlm.forward`'s scan body: the self layers, then the cross layer."""
    pos = jnp.broadcast_to(jnp.arange(x.shape[1])[None], x.shape[:2])
    for j in range(jcfg.cross_attn_period - 1):
        x = jvlm._self_layer(jcfg, jax.tree.map(lambda t: t[j], p_selfs), x,
                             pos)
    return jvlm._cross_layer(jcfg, p_cross, x, pos, image_embeds)


@pytest.mark.parametrize("attention", [True, False])
def test_bf16_groups_match_reference_group_by_group(attention):
    """bf16 weights and activations, each group (one compiled computation
    in the reference, so its norms read the f32 sums: `layers.add_norm`)
    from the reference's state before it.  With every attention weight 0
    (the attention adds exactly 0 on both sides), the norms, residual
    adds, gates and SwiGLU FFNs are rounded where XLA rounds the
    reference: one bf16 step of a term (ATOL_STEP).  With attention, P's
    rounding too (TOL_P)."""
    tol = (TOL_P, TOL_P) if attention else (RTOL_BF16, ATOL_STEP)
    cfg, jcfg = _cfgs()
    jp = _tree(cfg, jcfg, 2, zero_attention=not attention)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    n_groups, _, period = vlm.plan(cfg)
    n = period - 1
    spec = vlm.D._attn_spec(cfg)
    img = jnp.asarray(_image(cfg, 3), jnp.bfloat16)
    t_img = params_from_jax(np.asarray(img))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(2, S)
    x = jnp.asarray(np.random.default_rng(8).standard_normal(
        (2, S, cfg.d_model)), jnp.bfloat16)
    for g in range(n_groups):
        want = _jgroup(jcfg, jax.tree.map(lambda t: t[g * n:g * n + n],
                                          jp["self_layers"]),
                       jax.tree.map(lambda t: t[g], jp["cross_layers"]), x,
                       img)
        got = vlm._group(
            cfg, params, params_from_jax(np.asarray(x)), g,
            lambda p, h, i: L.attention_block(p, h, pos, spec, causal=True,
                                              rope_theta=cfg.rope_theta),
            lambda p, h: L.attention_block(p, h, pos, spec, kv_x=t_img,
                                           use_rope=False))
        assert got.dtype == torch.bfloat16
        _close(got, want, *tol)
        x = want


def test_serve_cli_runs_the_vlm_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--batch", "2", "--prompt", "8", "--decode", "8",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert "tok/s on cpu" in lines[0] and lines[-1] == "ok"
