"""Where the port rounds the bf16 residual stream, against the JAX package
on the CPU.

XLA computes a bf16 residual add in f32 and hands a norm in the same
compiled computation the f32 sum, while the next residual add, and the
next step of the reference's layer scan, read the sum rounded to bf16
(`repro_torch.models.layers.add_norm`).  Inside one of the reference's
scan bodies, a layer group, every norm after a residual add therefore
reads an f32 sum, the next member's first norm too.

Each case runs a reduced bf16 model group by group from the reference's
state: the reference's scan body, jitted, against the port's group on the
same input.  One token a sequence (B 64 x S 1) makes attention exact on
both sides (one key: P = 1), so the attention adds stay nonzero and
rounding is the only difference left; every norm is drawn nonzero (zero
norms give (1 + 0) = 1 on both sides).  Two checks: every output within
rtol 1e-2 and one bf16 step of its row's largest element (a term's
product summed in another order rounds the other way, and the stream
carries that step into the elements that cancel), which a rounding at the
wrong place also passes, and the share of outputs that are not bit-equal
to the reference's under SHARE_BOUND.  The same model with the
sum rounded for every norm (the rule before the repair, patched in for
`layers.add_norm`) must part from the reference in more than
ROUNDED_SHARE_MIN of its outputs, so the share check can see the fault.
`tests/probe_torch_residual_rounding.py` prints the shares of each
candidate rule.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import dense as JD
from repro.models import layers as JL
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import vlm as jvlm
from repro_torch import configs
from repro_torch.models import api, hybrid, moe, ssm, vlm
from repro_torch.models import dense as D
from repro_torch.models import layers as L
from repro_torch.weights import params_from_jax

B, S = 64, 1
RTOL = 1e-2
# the port's rule parts 0.1-1.2% of the outputs (the products' f32 sums
# in another order); the rounded rule 30-60%
SHARE_BOUND = 0.03
ROUNDED_SHARE_MIN = 0.2

# arch, layers kept (two groups), config overrides
FAMILIES = {
    "dense": ("llama3.2-3b", 2, {}),
    "dense-pairs": ("gemma2-9b", 4, {}),
    "moe": ("llama4-scout-17b-a16e", 4, dict(capacity_factor=8.0)),
    "hybrid": ("zamba2-7b", 6, {}),
    "vlm": ("llama-3.2-vision-11b", 4, dict(n_image_tokens=1)),
}


def _jdtype(t):
    return jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32


def nonzero_tree(cfg, jcfg, seed):
    """The port's init carried to the reference's tree (whose keys, shapes
    and dtypes must be the reference's own), every norm drawn nonzero and
    the vlm's gates drawn in (-1, 1)."""
    tp = api.init_params(cfg, seed, device="cpu")
    rng = np.random.default_rng(seed + 5)

    def draw(path, t):
        name = path[-1].key
        a = t.float().numpy()
        if name.endswith("norm"):
            a = rng.standard_normal(a.shape) * 0.3
        elif name.endswith("gate") and t.dtype == torch.float32:
            a = rng.uniform(-1.0, 1.0, a.shape)
        return jnp.asarray(a, _jdtype(t))

    jp = jax.tree_util.tree_map_with_path(draw, tp)
    spec = jax.eval_shape(lambda k: japi.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    assert jax.tree.map(lambda t: (t.shape, t.dtype), jp) == \
        jax.tree.map(lambda t: (t.shape, t.dtype), spec)
    return jp


def _slice(tree, lo, hi):
    return jax.tree.map(lambda t: t[lo:hi], tree)


# ----------------------- the reference's scan bodies ------------------------

@functools.partial(jax.jit, static_argnums=0)
def _jdense_group(jcfg, p_group, x, pos):
    for j in range(JD.group_size(jcfg)):
        x = JD._layer_body(jcfg, jax.tree.map(lambda t: t[j], p_group), x,
                           pos, j)
    return x


@functools.partial(jax.jit, static_argnums=0)
def _jmoe_group(jcfg, p_group, x, pos):
    for j in range(JD.group_size(jcfg)):
        x = jmoe._layer_body(jcfg, jax.tree.map(lambda t: t[j], p_group), x,
                             pos, j)[0]
    return x


@functools.partial(jax.jit, static_argnums=0)
def _jhybrid_group(jcfg, p_group, shared, x, pos):
    """`hybrid.forward`'s superblock."""
    spec = JL.AttnParamsSpec(jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads,
                             jcfg.hd)
    for j in range(jcfg.hybrid_attn_period):
        p_j = jax.tree.map(lambda t: t[j], p_group)
        x = x + jssm.mamba2_block(p_j, jcfg, JL.rmsnorm(x, p_j["norm"]))
    h = JL.rmsnorm(x, shared["attn_norm"])
    x = x + JL.attention_block(shared, h, pos, spec, causal=True,
                               rope_theta=jcfg.rope_theta)
    h = JL.rmsnorm(x, shared["ffn_norm"])
    return x + JL.swiglu(shared, h)


@functools.partial(jax.jit, static_argnums=0)
def _jvlm_group(jcfg, p_selfs, p_cross, x, pos, image_embeds):
    """`vlm.forward`'s scan body."""
    for j in range(jcfg.cross_attn_period - 1):
        x = jvlm._self_layer(jcfg, jax.tree.map(lambda t: t[j], p_selfs), x,
                             pos)
    return jvlm._cross_layer(jcfg, p_cross, x, pos, image_embeds)


# ------------------------------ both sides -----------------------------------

def _model(family, seed=0):
    """(cfg, params, n_groups, reference group fn(g, x), port group fn(g,
    x)) of a reduced bf16 model, each fn taking the group's input
    stream."""
    arch, n_layers, kw = FAMILIES[family]
    cfg = configs.get(arch).reduced().replace(n_layers=n_layers, **kw)
    jcfg = jconfigs.get(arch).reduced().replace(n_layers=n_layers, **kw)
    assert cfg.dtype == "bfloat16"
    jp = nonzero_tree(cfg, jcfg, seed)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    jpos = jnp.zeros((B, S), jnp.int32)
    pos = torch.zeros((B, S), dtype=torch.int32)
    if family in ("dense", "dense-pairs", "moe"):
        g = D.group_size(cfg)
        jbody = _jdense_group if family != "moe" else _jmoe_group
        ffn = moe._ffn if family == "moe" else D.swiglu_ffn
        one = cfg.replace(n_layers=g)

        def ref(gi, x):
            return jbody(jcfg, _slice(jp["layers"], gi * g, gi * g + g), x,
                         jpos)

        def port(gi, x):
            return D.run_layers(
                one, {k: v[gi * g:gi * g + g]
                      for k, v in params["layers"].items()}, x,
                lambda p, h, i: D._member_attn(cfg, p, h, pos, i % g),
                ffn)[0]
        return cfg, params, n_layers // g, ref, port
    if family == "hybrid":
        _, n_apps, period = hybrid.plan(cfg)
        spec = D._attn_spec(cfg)

        def ref(gi, x):
            return _jhybrid_group(jcfg, _slice(jp["mamba"], gi * period,
                                               gi * period + period),
                                  jp["shared"], x, jpos)

        def port(gi, x):
            return hybrid._superblock(
                cfg, params, x, gi,
                lambda p, h, j: ssm.mamba2_block(p, cfg, h),
                lambda h: L.attention_block(params["shared"], h, pos, spec,
                                            causal=True,
                                            rope_theta=cfg.rope_theta))
        return cfg, params, n_apps, ref, port
    n_groups, _, period = vlm.plan(cfg)
    spec = D._attn_spec(cfg)
    img = np.random.default_rng(seed + 9).standard_normal(
        (B, cfg.n_image_tokens, cfg.d_model))
    jimg = jnp.asarray(img, jnp.bfloat16)
    timg = params_from_jax(np.asarray(jimg))
    n = period - 1

    def ref(gi, x):
        return _jvlm_group(jcfg, _slice(jp["self_layers"], gi * n, gi * n + n),
                           jax.tree.map(lambda t: t[gi], jp["cross_layers"]),
                           x, jpos, jimg)

    def port(gi, x):
        return vlm._group(
            cfg, params, x, gi,
            lambda p, h, i: L.attention_block(p, h, pos, spec, causal=True,
                                              rope_theta=cfg.rope_theta),
            lambda p, h: L.attention_block(p, h, pos, spec, kv_x=timg,
                                           use_rope=False))
    return cfg, params, n_groups, ref, port


def rounded_add_norm(x, a, weight=None):
    """The rule before the repair: the norm reads the rounded sum."""
    x = x + a
    return x, None if weight is None else L.rmsnorm(x, weight)


def run_groups(family, seed=0, rules=(L.add_norm,)):
    """Group by group from the reference's state: the reference's outputs
    and the port's with each of `rules` in place of `layers.add_norm`, f32
    arrays (n_groups, B, S, D)."""
    cfg, _, n_groups, ref, port = _model(family, seed)
    x = jnp.asarray(np.random.default_rng(seed + 7).standard_normal(
        (B, S, cfg.d_model)), jnp.bfloat16)
    wants, gots = [], [[] for _ in rules]
    add_norm = L.add_norm
    try:
        for gi in range(n_groups):
            want = ref(gi, x)
            wants.append(np.asarray(want, np.float32))
            for rule, out in zip(rules, gots):
                L.add_norm = rule
                got = port(gi, params_from_jax(np.asarray(x)))
                assert got.dtype == torch.bfloat16
                assert got.shape == (B, S, cfg.d_model)
                out.append(got.float().numpy())
            x = want
    finally:
        L.add_norm = add_norm
    return np.stack(wants), [np.stack(g) for g in gots]


def assert_within_a_row_step(got, want):
    """|got - want| <= RTOL |want| + one bf16 step of the row's largest
    |want| (2^-7 for a row whose largest element lies in [1, 2))."""
    row = np.abs(want).max(-1, keepdims=True)
    step = 2.0 ** (np.floor(np.log2(row)) - 7)
    excess = np.abs(got - want) - RTOL * np.abs(want) - step
    assert excess.max() <= 0, float(excess.max())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_bf16_norms_read_the_residual_sums_as_xla_does(family):
    want, (got, got_r) = run_groups(family,
                                    rules=(L.add_norm, rounded_add_norm))
    assert_within_a_row_step(got, want)
    share = float(np.mean(got != want))
    assert share < SHARE_BOUND, share
    rounded = float(np.mean(got_r != want))
    assert rounded > ROUNDED_SHARE_MIN, (share, rounded)
