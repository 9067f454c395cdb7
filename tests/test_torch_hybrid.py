"""The port's hybrid family (zamba2-7b) against the JAX package, on the CPU.

Reduced zamba2 in f32 with the reference's parameters carried across by
`params_from_jax`, on the same numpy inputs: the Mamba-2 block and its
one-token decode alone (random selective parameters, a nonzero state), the
whole model's logits and loss at 6 layers (two applications of the shared
block, so two KV caches over one weight set), the caches' shapes, decode
step by step with every cache, the port's decode against its own forward,
the bf16 Mamba-2 block, and the serve CLI.
"""
import math
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
from repro.models import layers as JL
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.launch.train import make_prefill_step, make_serve_step
from repro_torch.models import api, hybrid, ssm
from repro_torch.models.dense import torch_dtype
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
ARCH = "zamba2-7b"
S = 16
# f32, the port against the reference: matmuls and sums in another order
RTOL, ATOL = 1e-4, 1e-5
# decode == forward inside the port: tests/test_decode_equivalence.py's
DECODE_TOL = 5e-3


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


def _tokens(cfg, seed=0, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (2, s)).astype(
        np.int32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want,
                                                               np.float32),
                               rtol=rtol, atol=atol)


# ------------------------------ the Mamba-2 block ----------------------------

def _block_params(spec, seed):
    """One block's leaves of random values, in f32, with the shapes of the
    reference's stacked `spec` less its layer axis: dt_bias, A_log, D and
    the conv bias drawn too, so every head decays at its own rate."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, sd in sorted(spec.items()):
        shape = sd.shape[1:]
        x = rng.standard_normal(shape)
        if len(shape) == 2:
            x /= math.sqrt(shape[0])
        if name == "dt_bias":
            x = x * 0.5 - 2.0
        out[name] = x.astype(np.float32)
    return out


def _mamba2_spec(jcfg):
    return jax.eval_shape(lambda k: jssm.init_mamba2(k, jcfg, 1, jnp.float32),
                          jax.random.PRNGKey(0))


def test_mamba2_block_matches_reference():
    cfg, jcfg = _cfgs(dtype="float32")
    p = _block_params(_mamba2_spec(jcfg), 0)
    x = np.random.default_rng(1).standard_normal((2, S, cfg.d_model)).astype(
        np.float32)
    want = jax.jit(lambda p_, x_: jssm.mamba2_block(p_, jcfg, x_))(p, x)
    got = ssm.mamba2_block(params_from_jax(p), cfg, torch.from_numpy(x))
    assert got.shape == (2, S, cfg.d_model)
    _close(got, want)


def test_mamba2_decode_matches_reference():
    """Six steps from a nonzero conv window and state: y, the window and
    the (B, H, N, P) f32 state after every step."""
    cfg, jcfg = _cfgs(dtype="float32")
    s = ssm.mamba2_shapes(cfg)
    conv_dim = s["d_inner"] + 2 * s["n"]
    p = _block_params(_mamba2_spec(jcfg), 2)
    rng = np.random.default_rng(3)
    conv = rng.standard_normal((2, cfg.ssm_conv - 1, conv_dim)).astype(
        np.float32)
    h = rng.standard_normal((2, s["n_heads"], s["n"], s["p"])).astype(
        np.float32)
    xs = rng.standard_normal((6, 2, 1, cfg.d_model)).astype(np.float32)
    step = jax.jit(lambda p_, x_, c_, h_: jssm.mamba2_decode(p_, jcfg, x_, c_,
                                                             h_))
    tp = params_from_jax(p)
    tconv, th = torch.from_numpy(conv), torch.from_numpy(h)
    for x in xs:
        y, conv, h = step(p, x, conv, h)
        ty, tconv, th = ssm.mamba2_decode(tp, cfg, torch.from_numpy(x),
                                          tconv, th)
        assert th.dtype == torch.float32
        _close(ty, y)
        _close(tconv, conv)
        _close(th, h)


# ------------------------------- the whole model -----------------------------

@pytest.fixture(scope="module")
def two_apps():
    """Reduced zamba2 at 6 layers in f32 (4 Mamba-2 blocks, 2 applications
    of the shared block): the reference's tree and the carried params, the
    tokens, and the reference's logits and loss on them."""
    cfg, jcfg = _cfgs(dtype="float32", n_layers=6)
    assert hybrid.plan(cfg) == (4, 2, 2)
    jp = _reference_tree(cfg, jcfg, 0)
    toks = _tokens(cfg)
    labels = np.roll(toks, -1, axis=1)
    logits = jax.jit(lambda p, t: japi.logits(jcfg, p, dict(tokens=t)))(
        jp, jnp.asarray(toks))
    # the reference's loss_fn is softmax_xent of these logits
    loss = jax.jit(JL.softmax_xent)(logits, jnp.asarray(labels))
    return dict(cfg=cfg, jcfg=jcfg, jp=jp,
                params=params_from_jax(jax.tree.map(np.asarray, jp)),
                batch=api.make_batch(cfg, toks, 2, S, device="cpu"),
                logits=np.asarray(logits), loss=float(loss))


def test_logits_and_loss_match_reference(two_apps):
    cfg, params, batch = two_apps["cfg"], two_apps["params"], two_apps["batch"]
    # the carried tree: the reference's shapes, the shared block unstacked
    assert params["shared"]["wq"].shape == (cfg.d_model, cfg.n_heads * cfg.hd)
    assert params["mamba"]["in_proj"].shape[0] == 4
    got = api.logits(cfg, params, batch)
    assert got.dtype == torch.float32 and got.shape == (2, S, cfg.vocab)
    _close(got, two_apps["logits"])
    np.testing.assert_allclose(float(api.loss(cfg, params, batch)),
                               two_apps["loss"], rtol=RTOL)
    assert torch.equal(make_prefill_step(cfg)(params, batch), got)


@pytest.mark.parametrize("cache_len", [S, 40_000])
def test_init_cache_matches_reference_shapes(cache_len):
    """Full zamba2-7b (on the meta device: nothing is allocated) and the
    reduced 6-layer model; 40,000 > 32,768 windows the attention caches."""
    for cfg, jcfg in ((configs.get(ARCH), jconfigs.get(ARCH)),
                      _cfgs(n_layers=6)):
        cache = hybrid.init_cache(cfg, 2, cache_len, device="meta")
        want = jax.eval_shape(lambda: japi.init_cache(jcfg, 2, cache_len))
        assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)),
                            cache) == \
            jax.tree.map(lambda t: (tuple(t.shape), "torch." + str(t.dtype)),
                         want)
    assert cache["attn"]["k"].shape[2] == min(cache_len, 32_768)


def test_decode_steps_match_reference(two_apps):
    """Teacher-forced decode, step by step: the logits and every cache (the
    conv windows, the f32 states, each application's own K and V)."""
    cfg, jcfg, jp = two_apps["cfg"], two_apps["jcfg"], two_apps["jp"]
    params, toks = two_apps["params"], two_apps["batch"]["tokens"]
    step = jax.jit(lambda p, c, t, pos: japi.decode_step(jcfg, p, c, t, pos))
    jcache = japi.init_cache(jcfg, 2, S)
    cache = api.init_cache(cfg, 2, S, device="cpu")
    serve = make_serve_step(cfg)
    jtoks = jnp.asarray(toks.numpy().astype(np.int32))
    for i in range(S):
        want, jcache = step(jp, jcache, jtoks[:, i:i + 1], jnp.int32(i))
        got, cache = serve(params, cache, toks[:, i:i + 1], i)
        _close(got, want)
        for key in ("conv", "h"):
            _close(cache[key], jcache[key])
        for key in ("k", "v"):
            _close(cache["attn"][key], jcache["attn"][key])
    # two applications wrote two different caches
    assert not torch.equal(cache["attn"]["k"][0], cache["attn"]["k"][1])


@pytest.mark.parametrize("n_layers", [3, 6])
def test_decode_matches_forward(n_layers):
    cfg = configs.get(ARCH).reduced().replace(dtype="float32",
                                              n_layers=n_layers)
    params = api.init_params(cfg, 0, device="cpu")
    batch = api.make_batch(cfg, torch.Generator().manual_seed(1), 2, 24,
                           device="cpu")
    full = make_prefill_step(cfg)(params, batch)
    cache = api.init_cache(cfg, 2, 24, device="cpu")
    step = make_serve_step(cfg)
    outs = []
    for i in range(24):
        lg, cache = step(params, cache, batch["tokens"][:, i:i + 1], i)
        outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), full,
                               rtol=DECODE_TOL, atol=DECODE_TOL)


_BLOCKS = {1: (jssm.init_mamba1, jssm.mamba1_block, jssm.mamba1_decode,
               ssm.mamba1_block, ssm.mamba1_decode),
           2: (jssm.init_mamba2, jssm.mamba2_block, jssm.mamba2_decode,
               ssm.mamba2_block, ssm.mamba2_decode)}


@pytest.mark.parametrize("version", [1, 2])
def test_bf16_mamba_blocks_match_reference(version):
    """bf16 weights and activations through a Mamba-1 or Mamba-2 block and
    one decode step, with a nonzero conv bias.  The port keeps the
    reference's roundings as XLA compiles it: the bf16 in_proj product and
    the conv's sum of products are rounded to bf16, but the bias add, the
    last op before the reference's `.astype(f32)`, is computed in f32
    without rounding (rounding it parts 57% of a Mamba-2 block's outputs
    from the reference, by up to 0.031); y is rounded to bf16 before
    out_proj (and, in Mamba-2, before the norm).  So the two differ by f32
    sums in another order under those roundings: at most one bf16 step of
    the output, rtol 1e-2, atol 1e-3.  The state stays f32.  (The shared
    attention block is the dense family's, held to the reference in bf16
    by tests/test_torch_lm.py and tests/test_torch_attention.py.)"""
    init, jblock, jdecode, block, decode = _BLOCKS[version]
    if version == 1:
        cfg = configs.get("falcon-mamba-7b").reduced()
        jcfg = jconfigs.get("falcon-mamba-7b").reduced()
    else:
        cfg, jcfg = _cfgs()
    assert cfg.dtype == "bfloat16"
    spec = jax.eval_shape(lambda k: init(k, jcfg, 1, jnp.bfloat16),
                          jax.random.PRNGKey(0))
    jp = {k: jnp.asarray(v, spec[k].dtype)
          for k, v in _block_params(spec, 1).items()}
    p = params_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 32, cfg.d_model)), jnp.bfloat16)
    want = jax.jit(lambda p_, x_: jblock(p_, jcfg, x_))(jp, x)
    got = block(p, cfg, params_from_jax(np.asarray(x)))
    assert got.dtype == torch.bfloat16
    _close(got, want, rtol=1e-2, atol=1e-3)
    # one layer's (B, K-1, conv_dim) window and (B, ...) f32 state
    cache = api.init_cache(cfg.replace(n_layers=3), 2, 8, device="cpu")
    conv = jnp.asarray(rng.standard_normal(cache["conv"].shape[-3:]),
                       jnp.bfloat16)
    h = rng.standard_normal(cache["h"].shape[-2 - version:]).astype(
        np.float32)
    want = jax.jit(lambda p_, x_, c_, h_: jdecode(p_, jcfg, x_, c_, h_))(
        jp, x[:, :1], conv, h)
    got = decode(p, cfg, params_from_jax(np.asarray(x[:, :1])),
                 params_from_jax(np.asarray(conv)), torch.from_numpy(h))
    for g, w in zip(got, want):
        assert g.dtype == torch_dtype(w.dtype.name)
        _close(g, w, rtol=1e-2, atol=1e-3)


def test_serve_cli_runs_zamba2_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--batch", "2", "--prompt", "8", "--decode", "8",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert "tok/s on cpu" in lines[0] and lines[-1] == "ok"


def test_hybrid_family_is_registered():
    cfg = configs.get(ARCH)
    assert api.family_module(cfg) is hybrid
    assert api.NOT_PORTED == ()
    assert hybrid.plan(cfg) == (54, 27, 2)
