"""The port's moe family (llama4-scout, kimi-k2) against the JAX package, on
the CPU.

Reduced configs: llama4 with chunk 16 and global_period 2 (one chunked and
one global layer), kimi with full attention.  Random params drawn by the
port's init are laid out as the reference's tree and go into both packages
with the same numpy tokens: logits and loss (aux included), the routed FFN
alone (drops at capacity, router ties), its chunked layout, chunked
attention with and without a tail, `chunk_ring` decode, the port's decode
against its own forward, and a bf16 llama4.
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
from repro.configs.base import ArchConfig as JArchConfig
from repro.models import api as japi
from repro.models import dense as JD
from repro.models import layers as JL
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.train import make_prefill_step, make_serve_step
from repro_torch.models import api, moe
from repro_torch.models import layers as TL
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("llama4-scout-17b-a16e", "kimi-k2-1t-a32b")
S = 32
# f32, the port against the reference: matmuls and sums in another order
RTOL, ATOL = 1e-4, 1e-5
# decode == forward inside the port: tests/test_decode_equivalence.py's
DECODE_TOL = 2e-3


def _shape_dtype(x):
    return tuple(x.shape), jnp.dtype(x.dtype)


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


def _cfgs(arch, **kw):
    return (configs.get(arch).reduced().replace(**kw),
            jconfigs.get(arch).reduced().replace(**kw))


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match_reference(arch):
    cfg, jcfg = _cfgs(arch, dtype="float32")
    jp = _reference_tree(cfg, jcfg, 0)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    spec = jax.eval_shape(lambda k: japi.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    # the carried tree: the reference's shapes, torch's dtypes
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), params) \
        == jax.tree.map(lambda s: (tuple(s.shape), "torch.float32"), spec)
    toks = _tokens(cfg)
    labels = np.roll(toks, -1, axis=1)
    want, wloss = jax.jit(lambda p, b: (japi.logits(jcfg, p, b),
                                        japi.loss(jcfg, p, b)))(
        jp, dict(tokens=jnp.asarray(toks), labels=jnp.asarray(labels)))
    batch = api.make_batch(cfg, toks, 2, S, device="cpu")
    got = api.logits(cfg, params, batch)
    assert got.dtype == torch.float32 and got.shape == (2, S, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(api.loss(cfg, params, batch)),
                               float(wloss), rtol=RTOL)
    logits, aux = moe.forward_with_aux(cfg, params, batch["tokens"])
    assert torch.equal(logits, got) and float(aux) > 0
    assert torch.equal(make_prefill_step(cfg)(params, batch), got)


# ------------------------------ the routed FFN --------------------------------

def _ffn_cfg(**kw):
    kw = dict(dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=2,
                   n_kv_heads=1, d_ff=64, vocab=64, head_dim=16, n_experts=4,
                   top_k=2, d_ff_expert=16, dtype="float32"), **kw)
    return ArchConfig(**kw), JArchConfig(**kw)


def _ffn_params(seed, d=32, e=4, f=16, tie=False):
    rng = np.random.default_rng(seed)
    p = dict(router=rng.standard_normal((d, e)) / math.sqrt(d),
             w_gate=rng.standard_normal((e, d, f)) / math.sqrt(d),
             w_up=rng.standard_normal((e, d, f)) / math.sqrt(d),
             w_down=rng.standard_normal((e, f, d)) / math.sqrt(f))
    if tie:          # equal router columns: exactly equal probabilities
        p["router"][:, 2] = p["router"][:, 1]
        p["router"][:, 3] = p["router"][:, 0]
    return {n: a.astype(np.float32) for n, a in p.items()}


_jffn = jax.jit(jmoe.moe_ffn, static_argnums=0)


@pytest.mark.parametrize("case,top_k,cf,tie,t", [
    ("top-2", 2, 1.25, False, 64),
    ("top-1", 1, 1.25, False, 96),
    ("drops", 2, 0.25, False, 64),       # cap 8 for 128 slots
    ("ties", 2, 1.25, True, 64),
    ("two groups", 2, 1.25, False, 2048),
])
def test_moe_ffn_matches_reference(case, top_k, cf, tie, t):
    cfg, jcfg = _ffn_cfg(top_k=top_k, capacity_factor=cf)
    p = _ffn_params(t + top_k, tie=tie)
    x = np.random.default_rng(t).standard_normal((t, 32)).astype(np.float32)
    want, waux = _jffn(jcfg, {n: jnp.asarray(a) for n, a in p.items()},
                       jnp.asarray(x))
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    got, aux = moe.moe_ffn(cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=RTOL)
    group = min(moe.MOE_GROUP, t)
    r = moe.route(cfg, tp["router"], torch.from_numpy(x).reshape(
        -1, group, 32), moe._capacity(cfg, group))
    dropped = int((~r["keep"]).sum())
    assert (dropped > 0) == (case == "drops"), dropped
    if tie:
        # equal probabilities: the lower expert index first, as top_k
        probs = r["probs"]
        assert torch.equal(probs[..., 1], probs[..., 2])
        first = r["idx"][..., 0]
        assert not bool(((first == 2) | (first == 3)).any())


def test_moe_ffn_chunked_matches_moe_ffn():
    """tests/test_moe_paths.py's three cases: aligned groups, several
    chunks against the re-ordered baseline, and the fallback."""
    cfg, _ = _ffn_cfg()
    p = {n: torch.from_numpy(a) for n, a in _ffn_params(0).items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4096, 32)).astype(np.float32))
    y_base, aux_base = moe.moe_ffn(cfg, p, x[:2048])
    y_chunk, aux_chunk = moe.moe_ffn_chunked(cfg, p, x[:2048], gc=2)
    torch.testing.assert_close(y_chunk, y_base, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(aux_chunk, aux_base, rtol=1e-3, atol=0.0)
    gc, group = 2, 1024
    y_chunk, _ = moe.moe_ffn_chunked(cfg, p, x, gc=gc)
    xg = x.reshape(gc, 2, group, 32).transpose(0, 1)
    y_ref = torch.stack([torch.stack([moe.moe_ffn(cfg, p, xg[c, g])[0]
                                      for g in range(gc)])
                         for c in range(2)]).transpose(0, 1).reshape(4096, 32)
    torch.testing.assert_close(y_chunk, y_ref, rtol=2e-4, atol=2e-4)
    y_fb, aux_fb = moe.moe_ffn_chunked(cfg, p, x[:96], gc=7)
    y_base, aux_base = moe.moe_ffn(cfg, p, x[:96])
    assert torch.equal(y_fb, y_base) and torch.equal(aux_fb, aux_base)
    assert moe._routed_ffn(cfg, p, x[:96])[0].equal(y_base)


# ----------------------------- chunked attention ------------------------------

SPEC = JL.AttnParamsSpec(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16)
T_SPEC = TL.AttnParamsSpec(64, 4, 2, 16)


def _attn_params(seed):
    rng = np.random.default_rng(seed)
    return {n: (rng.standard_normal(shp) / math.sqrt(shp[0])).astype(
        np.float32) for n, shp in JL.attn_param_shapes(SPEC).items()}


@pytest.mark.parametrize("s", [32, 40])
def test_chunked_attention_block_matches_reference(s):
    p = _attn_params(s)
    x = np.random.default_rng(s + 1).standard_normal((2, s, 64)).astype(
        np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32)[None], (2, 1))
    kw = dict(causal=True, chunk=16, rope_theta=5e5)
    want = jax.jit(lambda p_, x_, pos_: JL.attention_block(
        p_, x_, pos_, SPEC, **kw))({n: jnp.asarray(a) for n, a in p.items()},
                                   jnp.asarray(x), jnp.asarray(pos))
    got = TL.attention_block({n: torch.from_numpy(a) for n, a in p.items()},
                             torch.from_numpy(x), torch.from_numpy(pos),
                             T_SPEC, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("b,s,chunk,causal,window", [
    (2, 48, 16, True, None),     # whole chunks, no tail
    (2, 41, 16, True, None),     # B > 1 with a tail
    (1, 41, 16, True, None),     # B = 1: the tail is a view
    (1, 10, 16, True, None),     # S < chunk
    (2, 16, 16, True, None),     # S == chunk
    (2, 37, 8, False, None),     # not causal: block-diagonal
    (1, 45, 16, True, 5),        # a window inside each chunk
])
def test_chunk_fold_is_the_masked_attention(b, s, chunk, causal, window):
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, 16)).astype(
        np.float32)) for n in (4, 2, 2))
    got = TL.chunked_flash_attention(q, k, v, chunk, causal=causal,
                                     window=window, softcap=30.0)
    mask = TL._make_mask(s, s, causal=causal, window=window, chunk=chunk)
    want = TL.attend(q, k, v, mask, softcap=30.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_chunk_ring_decode_attention_matches_reference():
    p = _attn_params(4)
    rng = np.random.default_rng(6)
    c = 5
    ck = rng.standard_normal((2, c, 2, 16)).astype(np.float32)
    cv = rng.standard_normal((2, c, 2, 16)).astype(np.float32)
    step = jax.jit(lambda p_, x_, k_, v_, pos_: JL.decode_attention_block(
        p_, x_, k_, v_, pos_, SPEC, mode="chunk_ring", rope_theta=1e4))
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    jk, jv = jnp.asarray(ck), jnp.asarray(cv)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    for pos in (0, 3, 4, 5, 6, 9, 10, 13):    # across three chunks of 5
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        want, jk, jv = step(jp, jnp.asarray(x), jk, jv, jnp.int32(pos))
        got, tk, tv = TL.decode_attention_block(
            tp, torch.from_numpy(x), tk, tv, pos, T_SPEC, mode="chunk_ring",
            rope_theta=1e4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6,
                                   atol=1e-6)


# --------------------------------- decode -------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Token-by-token decode reproduces the prefill, capacity raised so no
    token drops (tests/test_decode_equivalence.py); S 24 > chunk 16, so
    llama4's chunked layer decodes through its `chunk_ring` cache."""
    cfg = configs.get(arch).reduced().replace(dtype="float32",
                                              capacity_factor=8.0)
    params = api.init_params(cfg, 0, device="cpu")
    batch = api.make_batch(cfg, torch.Generator().manual_seed(1), 2, 24,
                           device="cpu")
    full = make_prefill_step(cfg)(params, batch)
    cache = api.init_cache(cfg, 2, 24, device="cpu")
    modes = {moe.D._member_mode(cfg, j, 24) for j in range(
        moe.D.group_size(cfg))}
    assert modes == ({"chunk_ring", "full"} if cfg.attn_chunk else {"full"})
    step = make_serve_step(cfg)
    outs = []
    for i in range(24):
        lg, cache = step(params, cache, batch["tokens"][:, i:i + 1], i)
        outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, dim=1), full,
                               rtol=DECODE_TOL, atol=DECODE_TOL)


def test_bf16_llama4_matches_reference(monkeypatch):
    """bf16 weights at 2e-2, layer by layer from the reference's state.

    Routing is discontinuous: where two experts' probabilities lie within
    the frameworks' bf16 differences (the reference's `attend` rounds P to
    bf16 at this S, the port keeps it in f32; XLA skips some bf16
    roundings), a token takes another expert, and the run parts from
    there.  So each layer takes the reference's input (as the FL replays
    go round by round), capacity is raised so that a flip cannot move
    another token's slot, and a token whose expert set differs must be a
    near-tie in the reference's probabilities (gap < 1e-2).  Every other
    token's output is within 2e-2 of its row's largest element: the
    residual stream carries one bf16 rounding of its large elements into
    the elements that cancel.  The logits from the reference's last state
    are held at rtol = atol = 2e-2."""
    cfg, jcfg = _cfgs("llama4-scout-17b-a16e", capacity_factor=8.0)
    assert cfg.dtype == "bfloat16"
    jp = _reference_tree(cfg, jcfg, 1)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    assert params["layers"]["w_gate"].dtype == torch.bfloat16
    toks = _tokens(cfg, 2)
    pos = np.tile(np.arange(S, dtype=np.int32)[None], (2, 1))
    routes = []
    route = moe.route
    monkeypatch.setattr(moe, "route", lambda *a: routes.append(route(*a))
                        or routes[-1])
    x = jp["embed"][jnp.asarray(toks)]
    g = JD.group_size(jcfg)
    for i in range(cfg.n_layers):
        j = i % g

        def ref(p, x_):
            h = JL.rmsnorm(x_ + JD._member_attn(
                jcfg, p, JL.rmsnorm(x_, p["attn_norm"]), pos, j),
                p["ffn_norm"])
            probs = jax.nn.softmax((h.reshape(2 * S, -1) @ p["router"])
                                   .astype(jnp.float32), axis=-1)
            return jmoe._layer_body(jcfg, p, x_, pos, j)[0], probs

        p_i = jax.tree.map(lambda t: t[i], jp["layers"])
        want, probs = jax.jit(ref)(p_i, x)
        routes.clear()
        got, _ = moe._layer_body(
            cfg, moe.D.layer_params(params["layers"], i),
            torch.from_numpy(np.asarray(x, np.float32)).bfloat16(),
            torch.from_numpy(pos), j)
        probs = np.asarray(probs)
        ref_idx = np.argsort(-probs, axis=-1, kind="stable")[:, :cfg.top_k]
        got_idx = routes[0]["idx"].reshape(2 * S, -1).numpy()
        flipped = [t for t in range(2 * S)
                   if set(got_idx[t]) != set(ref_idx[t])]
        assert len(flipped) <= 2, (i, flipped)
        for t in flipped:
            other = list(set(got_idx[t]) - set(ref_idx[t]))
            assert probs[t, ref_idx[t]].min() - probs[t, other].max() < 1e-2
        w = np.asarray(want, np.float32).reshape(2 * S, -1)
        d = np.abs(got.float().numpy().reshape(2 * S, -1) - w)
        kept = [t for t in range(2 * S) if t not in flipped]
        assert (d.max(-1) <= 2e-2 * np.abs(w).max(-1))[kept].all(), i
        x = want
    want = jax.jit(lambda p, x_: (JL.rmsnorm(x_, p["final_norm"])
                                  @ p["unembed"]).astype(jnp.float32))(jp, x)
    got = moe.D._logits(cfg, params, torch.from_numpy(
        np.asarray(x, np.float32)).bfloat16())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


def test_serve_cli_runs_llama4_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "llama4-scout-17b-a16e", "--reduced", "--batch", "2", "--prompt",
         "8", "--decode", "12", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert "tok/s on cpu" in lines[0] and lines[-1] == "ok"


def test_moe_family_is_registered():
    assert "moe" not in api.NOT_PORTED
    for arch in ARCHS:
        assert api.family_module(configs.get(arch)) is moe
