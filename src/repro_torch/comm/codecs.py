"""Client->server wire codecs over the flat gradient substrate.

The server estimator (Eq. 10-12) is linear in the uploaded gradients, so
any unbiased per-upload compression commutes with the aggregation, and the
collapsed weighted-sum form lets the quantized formats aggregate straight
off the wire without materializing f32 uploads (`src/repro/comm/codecs.py`).

Every upload is one (N,) f32 vector (`utils.tree_math.ravel` of the
gradient tree).  A codec is a pair of maps over it, written for any number
of leading axes so the whole cohort's (C, N) stack encodes at once:

    encode(vec (..., N), state, u) -> (wire dict, new state | None)
    decode(wire)                   -> (..., N) f32

`wire` is a dict of tensors carrying vec's leading axes.  `state` is the
reference's per-client codec state (top-k's error feedback); none of the
ported codecs has any, so it is None in and out.  Ported so far:

* ``identity`` — f32 passthrough (4 bytes/param).
* ``bf16``     — round-to-nearest-even bfloat16 cast (2 bytes/param).
* ``int8``     — chunked-scale int8 with stochastic rounding: one f32 scale
  = max|x|/127 per `chunk`-sized block and q = floor(x/scale + u),
  u ~ U[0, 1), so E[q * scale] = x (unbiased).  The (C, N_packed) int8
  stack feeds the fused `ncv_weighted_sum_q` kernel.
* ``int4``     — the same with scale = max|x|/7, codes in [-7, 7] packed
  two per byte in the split-halves layout (byte j of a chunk holds code j
  in its low nibble and code j + chunk/2 in its high nibble); the fused
  `ncv_weighted_sum_q4` kernel unpacks in registers.

`u` is the stochastic-rounding uniforms, shape (..., n_chunks, chunk) f32
in [0, 1): drawn by the caller (the simulator's generator, or another run's
draws replayed), never inside the codec.  `topk` and `lowrank` are names
the port does not have yet: `get_codec` raises KeyError saying so.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.rloo import ref as rloo_ref
from repro_torch.kernels.rloo.rloo import (ncv_weighted_sum,
                                           ncv_weighted_sum_q,
                                           ncv_weighted_sum_q4)


@dataclasses.dataclass(frozen=True)
class Codec:
    """Base codec: f32 identity passthrough."""
    n: int
    name = "identity"
    stochastic = False  # encode reads the uniforms `u`
    options = ()        # construction options FLConfig.make may route here

    def encode(self, vec, state=None, u=None):
        del state, u
        return dict(v=vec.float()), None

    def decode(self, wire):
        return wire["v"].float()

    def bytes_per_client(self) -> int:
        """Real bytes a client puts on the wire per round."""
        return 4 * self.n

    def weighted_sum(self, wire, w):
        """sum_u w_u g_u straight off the stacked wire (leaves (cohort, ...)).

        Returns (vec (N,) f32, ||vec||^2).  Codecs with a fused kernel
        (int8, int4) aggregate without decoding; this one decodes the
        stack into the dense `ncv_weighted_sum`."""
        return ncv_weighted_sum(self.decode(wire).contiguous(), w)


@dataclasses.dataclass(frozen=True)
class BF16Codec(Codec):
    name = "bf16"

    def encode(self, vec, state=None, u=None):
        del state, u
        return dict(v=vec.to(torch.bfloat16)), None

    def bytes_per_client(self) -> int:
        return 2 * self.n


@dataclasses.dataclass(frozen=True)
class Int8Codec(Codec):
    """Chunked-scale int8 with unbiased stochastic rounding."""
    chunk: int = 512
    name = "int8"
    stochastic = True
    options = ("chunk",)
    qmax = 127.0                 # symmetric code range [-qmax, qmax]

    @property
    def n_chunks(self) -> int:
        return max(1, -(-self.n // self.chunk))

    @property
    def n_padded(self) -> int:
        return self.n_chunks * self.chunk

    def uniforms_shape(self, *lead) -> tuple:
        """Shape of the `u` that `encode` reads for a (*lead, N) input."""
        return tuple(lead) + (self.n_chunks, self.chunk)

    def _chunk_quantize(self, vec, u):
        """Zero-pad to the chunk grid, one scale = max|x|/qmax per chunk,
        q = floor(x/scale + u).  Returns (q int32 (..., C, chunk),
        scales (..., C))."""
        lead = tuple(vec.shape[:-1])
        if u is None:
            raise ValueError(f"codec '{self.name}' rounds stochastically: "
                             f"pass the uniforms u of shape "
                             f"{self.uniforms_shape(*lead)}")
        if tuple(u.shape) != self.uniforms_shape(*lead):
            raise ValueError(f"u has shape {tuple(u.shape)}, expected "
                             f"{self.uniforms_shape(*lead)}")
        x = torch.nn.functional.pad(vec.float(), (0, self.n_padded - self.n))
        xc = x.reshape(lead + (self.n_chunks, self.chunk))
        scales = torch.amax(torch.abs(xc), dim=-1) / self.qmax
        scales = torch.clamp(scales, min=1e-12)
        y = xc / scales[..., None]
        q = torch.clamp(torch.floor(y + u.to(y.device, torch.float32)),
                        -self.qmax, self.qmax)
        return q.to(torch.int32), scales

    def encode(self, vec, state=None, u=None):
        del state
        q, scales = self._chunk_quantize(vec, u)
        lead = tuple(vec.shape[:-1])
        return dict(q=q.to(torch.int8).reshape(lead + (self.n_padded,)),
                    s=scales), None

    def decode(self, wire):
        return rloo_ref.dequantize_int8_ref(wire["q"], wire["s"],
                                            chunk=self.chunk)[..., :self.n]

    def bytes_per_client(self) -> int:
        return self.n + 4 * self.n_chunks

    def weighted_sum(self, wire, w):
        agg, nrm = ncv_weighted_sum_q(wire["q"].contiguous(),
                                      wire["s"].contiguous(), w,
                                      chunk=self.chunk)
        return agg[:self.n], nrm


@dataclasses.dataclass(frozen=True)
class Int4Codec(Int8Codec):
    """Chunked-scale packed int4 with unbiased stochastic rounding: the
    int8 quantizer with qmax = 7, two codes a byte in the split-halves
    layout."""
    name = "int4"
    qmax = 7.0

    def encode(self, vec, state=None, u=None):
        del state
        q, scales = self._chunk_quantize(vec, u)
        half = self.chunk // 2
        qp = (q[..., :half] & 0xF) | ((q[..., half:] & 0xF) << 4)
        lead = tuple(vec.shape[:-1])
        return dict(q=qp.to(torch.uint8).reshape(lead + (self.n_padded // 2,)),
                    s=scales), None

    def decode(self, wire):
        return rloo_ref.dequantize_int4_ref(wire["q"], wire["s"],
                                            chunk=self.chunk)[..., :self.n]

    def bytes_per_client(self) -> int:
        # the padded tail bytes are not transmitted (as int8 counts n)
        return -(-self.n // 2) + 4 * self.n_chunks

    def weighted_sum(self, wire, w):
        agg, nrm = ncv_weighted_sum_q4(wire["q"].contiguous(),
                                       wire["s"].contiguous(), w,
                                       chunk=self.chunk)
        return agg[:self.n], nrm


CODECS = {
    "identity": Codec,
    "bf16": BF16Codec,
    "int8": Int8Codec,
    "int4": Int4Codec,
}
# codecs the reference registers that the port does not have yet
NOT_PORTED = ("lowrank", "topk")


def check_codec_name(name: str):
    """KeyError for a codec the port does not have (unknown, or not ported
    yet), with the reference's wording for unknown names."""
    if name in CODECS:
        return
    if name in NOT_PORTED:
        raise KeyError(f"codec '{name}' is not ported to repro_torch yet; "
                       f"ported: {sorted(CODECS)}")
    raise KeyError(f"unknown codec '{name}'; have {sorted(CODECS)}")


def validate_codec_opts(name: str, opts: dict):
    """Name and option validation without an N (FLConfig construction
    time): unknown or unported names raise KeyError, options the codec
    would ignore raise TypeError."""
    check_codec_name(name)
    cls = CODECS[name]
    bad = sorted(set(opts) - set(cls.options))
    if bad:
        raise TypeError(
            f"codec option(s) {bad} are not used by codec '{name}'; "
            f"valid options: {sorted(cls.options)}")


def get_codec(name: str, n: int, **opts) -> Codec:
    """The codec `name` for an N-parameter upload vector."""
    validate_codec_opts(name, opts)
    return CODECS[name](n=n, **opts)


def compression_ratio(codec: Codec) -> float:
    """Uploaded-bytes ratio of the f32 path over this codec's wire."""
    return 4.0 * codec.n / codec.bytes_per_client()
