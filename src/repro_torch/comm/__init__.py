"""repro_torch.comm — compressed client->server wire formats.

Codecs over the flat gradient substrate (`codecs.py`): identity, bf16,
int8, int4, and the stateful topk and lowrank with per-client error
feedback; plus the server-side entry points that take a stacked wire
(every leaf with a leading cohort axis, as the cohort's `encode` produces
it):

    aggregate_wire : wire -> (Eq. 10-12 aggregate, ||agg||^2), through the
                     codec's fused dequantize-aggregate kernel where it has
                     one (int8 and int4 never materialize f32 uploads;
                     lowrank sums its factors), else the dense
                     `ncv_weighted_sum` of the decoded stack (topk).
    decode_stack   : wire -> dense stacked gradient tree.
"""
from __future__ import annotations

from repro_torch.comm.codecs import (  # noqa: F401
    CODECS, NOT_PORTED, BF16Codec, Codec, Int4Codec, Int8Codec, LowRankCodec,
    TopKCodec, check_codec_name, compression_ratio, get_codec,
    validate_codec_opts,
)
from repro_torch.kernels.rloo.rloo import ncv_coefficients
from repro_torch.utils.tree_math import FlatSpec, unravel


def aggregate_wire(codec: Codec, wire, n_samples, beta=1.0):
    """Fused FedNCV server reduction straight off the compressed cohort
    stack: the Eq. 10-12 estimator collapsed to one weighted sum with
    `ncv_coefficients(n_samples, beta)` weights.  Returns (agg (N,) f32,
    ||agg||^2)."""
    device = next(iter(wire.values())).device
    w = ncv_coefficients(n_samples, beta).to(device)
    return codec.weighted_sum(wire, w)


def decode_stack(codec: Codec, wire, spec: FlatSpec):
    """Stacked wire -> dense stacked gradient tree (leaves (cohort, ...))."""
    return unravel(codec.decode(wire), spec)
