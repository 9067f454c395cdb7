"""LeNet-5 — the model the paper's experiments use — plus a small MLP; both
classify (B, H, W, C) images.

Parameters keep the reference's layouts (`src/repro/models/lenet.py`):
conv weights HWIO over NHWC activations, dense weights (in, out), so the
flat (N,) layout and the weights carried over by `weights.params_from_jax`
match it one to one.  The convolutions run on NCHW activations, and
activations go back to NHWC before the flatten (`fc1`'s rows are in
(h, w, c) order).

On the card each convolution is one f32 matrix product over the stacked
patches (`_conv`), not cuDNN: the same draws then give the same bits run
after run, within 1% of the replay tolerance of a CPU run after 5 FedNCV
rounds.  cuDNN's default algorithms are not deterministic, and the
deterministic ones it picks (Winograd) land 2.2 times the tolerance from
the CPU at beta = 0 (`benchmarks/port/fl_replay_drift.py`, `PERF.md`).
The patches are stacked from slices, so `vmap(grad)` batches every
operation of the pass, its backward too.  On the CPU the convolutions stay
`F.conv2d` (oneDNN, f32, deterministic), which the CPU parity tests hold
to the reference.

On the CPU, tanh does not go through `torch.tanh` but through `_CPUTanh`:
ATen's own vectorized `expm1` and one division, in f64, rounded once to
f32, which gives the correctly rounded tanh.  `torch.tanh` on a float CPU
tensor calls MKL's `vmsTanh` (high-accuracy mode) on each OpenMP thread's
share of the tensor, and in some processes that have imported JAX and
started its CPU client, one thread's first call returns its whole share
up to 5.2e-5 from tanh (the high-accuracy mode is within 3.2e-8): the
process's first forward then took other bits than every later one, up to
2e-5 from the reference's logits.  `expm1` is not routed to MKL (ATen
keeps it on its own SLEEF code, the same for every element whatever the
thread split), so the first call gives the same bits as every later one.
The backward is torch.tanh's, g (1 - y^2).  On the card `torch.tanh`
stays.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import softmax_xent


@dataclasses.dataclass(frozen=True)
class LeNetConfig:
    n_classes: int = 10
    image_size: int = 32
    channels: int = 3


HEAD_KEYS = ("head", "bh")          # personalization split (FedRep/FedPer)


class _CPUTanh(torch.autograd.Function):
    """tanh(x) = sign(x) (1 - e) / (1 + e), e = exp(-2|x|), as
    -t / (t + 2) with t = expm1(-2|x|) in (-1, 0], in f64 and rounded once
    to x's dtype: the correctly rounded tanh but in rare double roundings,
    and t = -1 (no overflow) where tanh saturates."""
    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        d = x.double()
        t = torch.expm1(-2.0 * d.abs())
        return torch.copysign(-t / (t + 2.0), d).to(x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return g * (1.0 - y * y)


def _tanh(x):
    return torch.tanh(x) if x.is_cuda else _CPUTanh.apply(x)


def init(cfg: LeNetConfig, generator: torch.Generator, device="cpu"):
    """Random parameters from `generator` (scaled normal, zero biases)."""
    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(device)

    s = cfg.image_size
    s_after = ((s - 4) // 2 - 4) // 2          # two conv5+pool2 stages
    flat = s_after * s_after * 16
    z = lambda n: torch.zeros((n,), dtype=torch.float32, device=device)
    return {
        "conv1": normal((5, 5, cfg.channels, 6), 25 * cfg.channels),
        "conv2": normal((5, 5, 6, 16), 25 * 6),
        "fc1": normal((flat, 120), flat),
        "fc2": normal((120, 84), 120),
        "head": normal((84, cfg.n_classes), 84),
        "b1": z(6), "b2": z(16), "bf1": z(120), "bf2": z(84),
        "bh": z(cfg.n_classes),
    }


def _conv(x, w):
    """Valid cross-correlation of NCHW x with HWIO w, NCHW out: x's kh row
    shifts stacked, then their kw column shifts, into (B, C*kh*kw, H'*W')
    patches in (c, i, j) order, then one product with the (O, C*kh*kw)
    weights."""
    kh, kw, cin, cout = w.shape
    b, _, h, wd = x.shape
    ho, wo = h - kh + 1, wd - kw + 1
    rows = torch.stack([x[:, :, i:i + ho] for i in range(kh)], dim=2)
    cols = torch.stack([rows[..., j:j + wo] for j in range(kw)], dim=3)
    out = (w.permute(3, 2, 0, 1).reshape(cout, cin * kh * kw)
           @ cols.reshape(b, cin * kh * kw, ho * wo))
    return out.reshape(b, cout, ho, wo)


def _conv_pool(x, w, b):
    """NCHW x, HWIO w -> max_pool2x2(tanh(conv(x) + b)), NCHW."""
    y = _conv(x, w) if x.is_cuda else F.conv2d(x, w.permute(3, 2, 0, 1))
    return F.max_pool2d(_tanh(y + b[:, None, None]), 2, 2)


def forward(cfg: LeNetConfig, params, images):
    x = images.permute(0, 3, 1, 2)                       # NHWC -> NCHW
    x = _conv_pool(x, params["conv1"], params["b1"])
    x = _conv_pool(x, params["conv2"], params["b2"])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
    x = _tanh(x @ params["fc1"] + params["bf1"])
    x = _tanh(x @ params["fc2"] + params["bf2"])
    return x @ params["head"] + params["bh"]


def loss_fn(cfg: LeNetConfig, params, batch):
    return softmax_xent(forward(cfg, params, batch["images"]),
                        batch["labels"])


def accuracy(cfg: LeNetConfig, params, batch):
    logits = forward(cfg, params, batch["images"])
    return torch.mean((torch.argmax(logits, -1) == batch["labels"]).float())


# ----------------------------- tiny MLP ------------------------------------

@dataclasses.dataclass(frozen=True)
class MLPConfig:
    n_classes: int = 10
    in_dim: int = 64
    hidden: int = 128


def init_mlp(cfg: MLPConfig, generator: torch.Generator, device="cpu"):
    """Random MLP parameters from `generator` (scaled normal, zero biases),
    in the reference's (in, out) layouts."""
    def normal(shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w / math.sqrt(shape[0])).to(device)

    z = lambda n: torch.zeros((n,), dtype=torch.float32, device=device)
    return {
        "w1": normal((cfg.in_dim, cfg.hidden)),
        "w2": normal((cfg.hidden, cfg.hidden)),
        "head": normal((cfg.hidden, cfg.n_classes)),
        "b1": z(cfg.hidden), "b2": z(cfg.hidden), "bh": z(cfg.n_classes),
    }


def forward_mlp(cfg: MLPConfig, params, x):
    x = torch.relu(x @ params["w1"] + params["b1"])
    x = torch.relu(x @ params["w2"] + params["b2"])
    return x @ params["head"] + params["bh"]


def loss_mlp(cfg: MLPConfig, params, batch):
    return softmax_xent(forward_mlp(cfg, params, batch["images"]),
                        batch["labels"])
