"""The port's LM serving slice against the JAX package, on the CPU.

Reduced llama3.2-3b, gemma2-9b (window 16 < S, so its local layers mask)
and falcon-mamba-7b in f32: random params laid out as the reference's tree
(its init's keys, shapes and dtypes) go into the reference and, through
`params_from_jax`, into the port, with the same numpy tokens; logits, loss
and per-token decode logits against the reference's, and the port's own
decode-equals-forward property.  Then the configs, the dispatch of
unported families, the serve CLI, a bf16 model and the weight carrier.
"""
import dataclasses
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
from repro_torch import configs
from repro_torch.launch.train import make_prefill_step, make_serve_step
from repro_torch.models import api
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
S = 32
ARCHS = ("llama3.2-3b", "gemma2-9b", "falcon-mamba-7b")
# the port against the reference, f32: matmuls and sums in another order
TOL = 1e-4
# decode == forward inside the port: tests/test_decode_equivalence.py's TOL
DECODE_TOL = dict(dense=2e-3, ssm=5e-3)


def _shape_dtype(x):
    return tuple(x.shape), jnp.dtype(x.dtype)


def _reference_tree(cfg, jcfg, seed):
    """Random params as the reference's tree.  They are drawn by the port's
    init: the reference's draws compile for seconds a shape on the CPU.  The
    tree must have the keys, shapes and dtypes of the reference's own init
    (traced abstractly, without drawing)."""
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
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """Reference and port of one reduced f32 arch, with the reference's
    logits, loss and teacher-forced decode logits on the same tokens."""
    arch = request.param
    jcfg = jconfigs.get(arch).reduced().replace(dtype="float32")
    cfg = configs.get(arch).reduced().replace(dtype="float32")
    jp = _reference_tree(cfg, jcfg, 0)
    toks = _tokens(cfg)
    labels = np.roll(toks, -1, axis=1)
    jbatch = dict(tokens=jnp.asarray(toks), labels=jnp.asarray(labels))
    jlogits, jloss = jax.jit(lambda p, b: (japi.logits(jcfg, p, b),
                                           japi.loss(jcfg, p, b)))(jp, jbatch)
    jlogits, jloss = np.asarray(jlogits), float(jloss)
    step = jax.jit(lambda p, c, t, pos: japi.decode_step(jcfg, p, c, t, pos))
    cache = japi.init_cache(jcfg, 2, S)
    jdec = []
    for i in range(S):
        lg, cache = step(jp, cache, jbatch["tokens"][:, i:i + 1], jnp.int32(i))
        jdec.append(np.asarray(lg[:, 0]))
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    batch = api.make_batch(cfg, toks, 2, S, device="cpu")
    return dict(cfg=cfg, params=params, batch=batch, logits=jlogits,
                loss=jloss, decode=np.stack(jdec, axis=1))


def _decode_all(cfg, params, tokens):
    cache = api.init_cache(cfg, tokens.shape[0], tokens.shape[1],
                           device="cpu")
    step = make_serve_step(cfg)
    outs = []
    for i in range(tokens.shape[1]):
        lg, cache = step(params, cache, tokens[:, i:i + 1], i)
        outs.append(lg[:, 0])
    return torch.stack(outs, dim=1)


def test_logits_and_loss_match_reference(pair):
    cfg, params, batch = pair["cfg"], pair["params"], pair["batch"]
    logits = api.logits(cfg, params, batch)
    assert logits.dtype == torch.float32 and logits.shape == (2, S, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), pair["logits"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(api.loss(cfg, params, batch)),
                               pair["loss"], rtol=TOL)


def test_decode_logits_match_reference(pair):
    got = _decode_all(pair["cfg"], pair["params"], pair["batch"]["tokens"])
    np.testing.assert_allclose(got.numpy(), pair["decode"], rtol=TOL,
                               atol=TOL)


def test_prefill_step_is_api_logits(pair):
    cfg, params, batch = pair["cfg"], pair["params"], pair["batch"]
    assert torch.equal(make_prefill_step(cfg)(params, batch),
                       api.logits(cfg, params, batch))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "phi3-mini-3.8b",
                                  "mistral-large-123b", "gemma2-9b",
                                  "falcon-mamba-7b"])
def test_decode_matches_forward(arch):
    """Every ported arch: token-by-token decode reproduces the prefill."""
    cfg = configs.get(arch).reduced().replace(dtype="float32")
    params = api.init_params(cfg, 0, device="cpu")
    batch = api.make_batch(cfg, torch.Generator().manual_seed(1), 2, 24,
                           device="cpu")
    full = make_prefill_step(cfg)(params, batch)
    dec = _decode_all(cfg, params, batch["tokens"])
    tol = DECODE_TOL[cfg.family]
    torch.testing.assert_close(dec, full, rtol=tol, atol=tol)


def test_bf16_llama_matches_reference():
    """bf16 weights: the logits agree to bf16 precision only, at 2e-2.

    The port sends every length through the flash path, which keeps the
    softmax probabilities P in f32 (its plain version here, its kernel on
    the card to within one bf16 step).  The reference has two regimes:
    below 2,048 tokens its attention_block takes `attend`, which rounds P
    to bf16 before P.V; from 2,048 on it takes `blocked_attention`, which
    keeps P in f32.  At this short S the reference rounds P, so the two
    differ by the reference's own rounding of P (up to 2^-8 of
    sum_j p_j |v_j - o| per output), carried through the layers, plus the
    frameworks' other bf16 roundings.  Where both keep P in f32 (S =
    2,048), tests/test_torch_attention.py holds the block to one bf16
    step."""
    jcfg = jconfigs.get("llama3.2-3b").reduced()
    cfg = configs.get("llama3.2-3b").reduced()
    assert cfg.dtype == "bfloat16"
    jp = _reference_tree(cfg, jcfg, 1)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    assert params["embed"].dtype == torch.bfloat16
    toks = _tokens(cfg, 2)
    want = np.asarray(jax.jit(lambda p, t: japi.logits(jcfg, p, dict(
        tokens=t)))(jp, jnp.asarray(toks)))
    got = api.logits(cfg, params, api.make_batch(cfg, toks, 2, S,
                                                 device="cpu"))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", sorted(jconfigs.REGISTRY))
def test_configs_match_reference(arch):
    ref, port = jconfigs.get(arch), configs.get(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert port.hd == ref.hd
    for shape in jconfigs.INPUT_SHAPES:
        assert configs.shape_applicable(port, shape) == \
            jconfigs.shape_applicable(ref, shape)
    assert {k: dataclasses.asdict(v) for k, v in
            configs.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.INPUT_SHAPES.items()}


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("llama-9000")


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b",
                                  "zamba2-7b", "whisper-medium",
                                  "llama-3.2-vision-11b"])
def test_unported_families_raise(arch):
    """The five families that were not ported when this test was written
    are all ported now, and each does what the reference does: the
    reference's tree, finite (B, S, V) logits (whisper's from the frames
    and the vlm's from the image embeddings that `make_batch` draws)."""
    cfg = configs.get(arch).reduced()
    assert cfg.family not in api.NOT_PORTED
    _reference_tree(cfg, jconfigs.get(arch).reduced(), 0)
    params = api.init_params(cfg, 0, device="cpu")
    batch = api.make_batch(cfg, torch.Generator().manual_seed(0), 2, 8,
                           device="cpu")
    if cfg.family == "vlm":
        assert batch["image_embeds"].shape == (2, cfg.n_image_tokens,
                                               cfg.d_model)
        assert batch["image_embeds"].dtype == torch.bfloat16
    logits = api.logits(cfg, params, batch)
    assert logits.shape == (2, 8, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


def test_entry_points_do_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = configs.get("llama3.2-3b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_cache(cfg, 1, 8)


def test_serve_cli_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "llama3.2-3b", "--reduced", "--batch", "2", "--prompt", "8",
         "--decode", "8", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert "tok/s on cpu" in lines[0] and lines[-1] == "ok"


def test_params_from_jax_keeps_dtypes():
    from repro.models import lenet as jlenet
    tree = {"w": jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32)
                             .reshape(3, 4)).astype(jnp.bfloat16),
            "b": {"x": jnp.arange(3, dtype=jnp.float32)}}
    got = params_from_jax(jax.tree.map(np.asarray, tree))
    assert got["w"].dtype == torch.bfloat16
    assert got["b"]["x"].dtype == torch.float32
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(tree["w"], np.float32))
    # a LeNet tree of the reference's keys, shapes and dtypes (f32)
    rng = np.random.default_rng(0)
    spec = jax.eval_shape(lambda key: jlenet.init(jlenet.LeNetConfig(), key),
                          jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(s.dtype),
                      spec)
    tp = params_from_jax(jp)
    for k, v in jp.items():
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(v))
