"""The bf16 flash kernel's arithmetic, emulated on the CPU, against the plain
version's f32 P.

`csrc/flash_attention_bf16.cu` cannot run here, so its numerical design is
held to the plain version (`flash_attention_ref`) through an emulation in
torch of what the kernel computes: f32 Q K^T per key tile of BK keys, the
scale (log2 e folded in) on the f32 accumulator, softcap and the -1e30 /
-inf masks, the online max and sum per row, P = 2^(x - m) split into
hi = bf16(p) and lo = bf16(p - hi), both through P V into one f32
accumulator, l from the f32 p, the output rounded to bf16 once.  It must
hold the card's check (rtol 1e-2, atol 1e-3).  The negative control shows
why P is split: bf16 P alone misses that check at short rows.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_ref

LOG2E = 1.4426950408889634
RTOL, ATOL = 1e-2, 1e-3          # the card's bf16 check of the kernel


def _emulate(q, k, v, *, causal=True, window=None, softcap=None,
             split=True):
    b, s, h, hd = q.shape
    r = h // k.shape[2]
    bk = 128 if hd <= 128 else 64          # the kernel's key tile
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    qf = q.float().transpose(1, 2)                              # b h s d
    kf = k.float().transpose(1, 2).repeat_interleave(r, 1)
    vf = v.float().transpose(1, 2).repeat_interleave(r, 1)
    m = torch.full((b, h, s), -math.inf)
    l = torch.zeros(b, h, s)
    o = torch.zeros(b, h, s, hd)
    qi = torch.arange(s)[:, None]
    for k0 in range(0, s, bk):
        kj = torch.arange(k0, min(k0 + bk, s))[None, :]
        acc = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
        if softcap is None:
            x = acc * (scale * LOG2E)
        else:
            x = softcap * torch.tanh(acc * scale / softcap) * LOG2E
        keep = torch.ones(s, kj.shape[1], dtype=torch.bool)
        if causal:
            keep &= kj <= qi
        if window is not None:
            keep &= (qi - kj) < window
        x = torch.where(keep, x, torch.tensor(-1e30 * LOG2E))
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        hi = p.bfloat16().float()
        vt = vf[:, :, k0:k0 + bk]
        if split:
            lo = (p - hi).bfloat16().float()
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + hi @ vt + lo @ vt
        else:
            l = l * corr + hi.sum(-1)
            o = o * corr[..., None] + hi @ vt
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _qkv(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    mk = lambda n: torch.from_numpy(  # noqa: E731
        rng.standard_normal((b, s, n, hd)).astype(np.float32)).bfloat16()
    return mk(h), mk(kv), mk(kv)


def _off(got, want):
    """Elements outside the card's check."""
    got, want = got.float(), want.float()
    return int(((got - want).abs() > ATOL + RTOL * want.abs()).sum())


@pytest.mark.parametrize("b,s,h,kv,hd,causal,window,softcap", [
    (1, 130, 4, 2, 16, True, None, None),
    (1, 130, 4, 2, 128, True, None, None),
    (1, 130, 4, 2, 224, True, None, None),
    (2, 256, 4, 2, 128, True, None, None),
    (1, 1000, 8, 2, 64, True, None, None),
    (2, 24, 4, 2, 32, True, 16, None),
    (1, 700, 2, 1, 256, True, 200, 50.0),
    (1, 333, 6, 3, 64, False, 50, 30.0),
])
def test_split_p_arithmetic_holds_the_card_check(b, s, h, kv, hd, causal,
                                                 window, softcap):
    q, k, v = _qkv(s + hd, b, s, h, kv, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    assert _off(_emulate(q, k, v, **kw), flash_attention_ref(q, k, v,
                                                             **kw)) == 0


def test_bf16_p_alone_misses_the_card_check():
    """Negative control: rounding P to bf16 (l from the rounded P) puts the
    output up to 2^-8 of sum_j p_j |v_j - o| off f32 P, beyond the check
    where a row has few keys."""
    q, k, v = _qkv(258, 1, 130, 4, 2, 128)
    want = flash_attention_ref(q, k, v)
    assert _off(_emulate(q, k, v, split=False), want) > 0
    assert _off(_emulate(q, k, v), want) == 0
