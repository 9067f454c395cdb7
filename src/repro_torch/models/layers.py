"""Shared model layers (only what the ported models use so far)."""
import torch


def softmax_xent(logits, labels, mask=None):
    """Mean cross entropy of (..., V) logits, accumulated in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
