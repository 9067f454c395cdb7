"""Where XLA rounds the reference's bf16 residual stream, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/probe_torch_residual_rounding.py

For each family of `tests/test_torch_residual_rounding.py` (reduced, bf16,
nonzero norms, B 64 x S 1 so that attention is exact on both sides), runs
the reference's jitted scan body group by group from the reference's
state against the port's group under each candidate rule for the norm
that follows a residual add, and prints the share of outputs that are
not bit-equal to the reference's:

  port     every norm inside a group reads the f32 sum (`layers.add_norm`)
  layer    as `port` inside a layer; the next layer's first norm reads
           the rounded sum
  rounded  every norm reads the rounded sum (the rule before the repair)
  cross    (vlm) as `port`, but the cross layer's attn_norm reads the
           rounded sum

At one image token the vlm's cross-attention output does not depend on
its query, so its attn_norm's rounding cannot show; `vlm, 3` has two
self layers a group (period 3), and `vlm, attend` also 8 image tokens,
with the port's attention through `layers.attend`, which rounds P to bf16
as the reference's `attend` does, in place of the flash kernel's plain
version, which keeps P in f32.  For the vlm also the gated adds with the
gated product kept in f32, with and without tanh(gate) rounded to bf16
first; and for Mamba-1 (falcon-mamba, one layer a scan step) the carry's
norm reading the rounded sum (the port) against the f32 sum.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import test_torch_residual_rounding as T  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm, vlm  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

ADD_NORM, GATED, FLASH = L.add_norm, vlm._gated, L.flash_attention
VLM = "llama-3.2-vision-11b"
T.FAMILIES.update({"vlm, 3": (VLM, 6, dict(cross_attn_period=3,
                                           n_image_tokens=1)),
                   "vlm, attend": (VLM, 6, dict(cross_attn_period=3))})


def attend(q, k, v, causal=False, window=None, softcap=None):
    """The reference's `attend` for a call that is not causal or has one
    query (every key visible)."""
    assert not causal or q.shape[1] == 1
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool)
    return L.attend(q, k, v, mask, softcap=softcap)


def handoff_norms(family, params, rule):
    """Storage of the norms that `rule` hands the rounded sum: those that
    open a layer inside a group (`layer`) or the vlm's cross layer's
    attn_norm (`cross`)."""
    if rule == "cross":
        rows = list(params["cross_layers"]["attn_norm"])
    elif family == "hybrid":
        rows = list(params["mamba"]["norm"]) + [params["shared"]["attn_norm"]]
    elif family.startswith("vlm"):
        rows = (list(params["self_layers"]["attn_norm"])
                + list(params["cross_layers"]["attn_norm"]))
    else:
        rows = list(params["layers"]["attn_norm"])
    return {t.data_ptr() for t in rows}


def share(family, rule="port", gated=GATED):
    cfg, params, n_groups, ref, port = T._model(family)
    handoffs = handoff_norms(family, params, rule)

    def add_norm(x, a, weight=None):
        if rule == "rounded" or (rule != "port" and weight is not None
                                 and weight.data_ptr() in handoffs):
            return T.rounded_add_norm(x, a, weight)
        return ADD_NORM(x, a, weight)

    L.add_norm, vlm._gated = add_norm, gated
    if family == "vlm, attend":
        L.flash_attention = attend
    try:
        x = jnp.asarray(np.random.default_rng(7).standard_normal(
            (T.B, T.S, cfg.d_model)), jnp.bfloat16)
        n = tot = 0
        for gi in range(n_groups):
            want = np.asarray(ref(gi, x), np.float32)
            got = port(gi, params_from_jax(np.asarray(x))).float().numpy()
            n, tot, x = n + int((got != want).sum()), tot + want.size, \
                jnp.asarray(want, jnp.bfloat16)
        return n / tot
    finally:
        L.add_norm, vlm._gated, L.flash_attention = ADD_NORM, GATED, FLASH


def mamba1_shares(n_layers=3):
    """Mamba-1's layer scan: (share with the carry's norm reading the
    rounded sum, share with it reading the f32 sum)."""
    arch = "falcon-mamba-7b"
    cfg = configs.get(arch).reduced().replace(n_layers=n_layers)
    jcfg = jconfigs.get(arch).reduced().replace(n_layers=n_layers)
    jp = T.nonzero_tree(cfg, jcfg, 0)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    x = jnp.asarray(np.random.default_rng(7).standard_normal(
        (T.B, T.S, cfg.d_model)), jnp.bfloat16)

    @jax.jit
    def ref(layers, x):
        def body(x, p_l):     # `ssm.forward`'s scan body
            return x + jssm.mamba1_block(p_l, jcfg, JL.rmsnorm(
                x, p_l["norm"])), None
        return jax.lax.scan(body, x, layers)[0]

    want = np.asarray(ref(jp["layers"], x), np.float32)
    out = []
    for f32_carry in (False, True):
        s = params_from_jax(np.asarray(x))
        xr = s
        for i in range(n_layers):
            p_l = {k: v[i] for k, v in params["layers"].items()}
            h = L.rmsnorm(s, p_l["norm"]).to(xr.dtype)
            s = xr.float() + ssm.mamba1_block(p_l, cfg, h).float()
            xr = s.to(torch.bfloat16)
            if not f32_carry:
                s = xr
        out.append(float(np.mean(xr.float().numpy() != want)))
    return out


def main():
    print("family        port    layer   rounded cross")
    for family in T.FAMILIES:
        rules = ("port", "layer", "rounded") + (
            ("cross",) if family.startswith("vlm") else ())
        print(f"{family:12s}" + " ".join(
            f"{share(family, rule):7.4f}" for rule in rules))
    f32_product = share("vlm", gated=lambda g, y: torch.tanh(g).to(
        y.dtype).float() * y.float())
    f32_gate = share("vlm", gated=lambda g, y: torch.tanh(g) * y.float())
    print(f"vlm gated product: bf16 (port) {share('vlm'):.4f}, f32 "
          f"{f32_product:.4f}, f32 with the f32 tanh {f32_gate:.4f}")
    rounded, f32 = mamba1_shares()
    print(f"Mamba-1 carry: rounded (port) {rounded:.4f}, f32 {f32:.4f}")


if __name__ == "__main__":
    main()
