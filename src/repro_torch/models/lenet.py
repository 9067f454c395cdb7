"""LeNet-5 — the model the paper's experiments use — on (B, H, W, C) images.

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
    return F.max_pool2d(torch.tanh(y + b[:, None, None]), 2, 2)


def forward(cfg: LeNetConfig, params, images):
    x = images.permute(0, 3, 1, 2)                       # NHWC -> NCHW
    x = _conv_pool(x, params["conv1"], params["b1"])
    x = _conv_pool(x, params["conv2"], params["b2"])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
    x = torch.tanh(x @ params["fc1"] + params["bf1"])
    x = torch.tanh(x @ params["fc2"] + params["bf2"])
    return x @ params["head"] + params["bh"]


def loss_fn(cfg: LeNetConfig, params, batch):
    return softmax_xent(forward(cfg, params, batch["images"]),
                        batch["labels"])


def accuracy(cfg: LeNetConfig, params, batch):
    logits = forward(cfg, params, batch["images"])
    return torch.mean((torch.argmax(logits, -1) == batch["labels"]).float())
