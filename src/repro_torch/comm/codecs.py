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
per-client codec state of a `stateful` codec (the error-feedback residual,
a tree of tensors with the same leading axes), None for the others.  The
codecs:

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
* ``topk``     — magnitude top-k with a per-client error-feedback residual:
  x = upload + residual, the k = round(ratio N) largest |x| ship as values
  and uint16 (N <= 65,535) or uint32 indices, and the residual keeps the
  rest.  The selection is a stable descending sort of |x|, so ties keep
  the lower index first, as `jax.lax.top_k` does; the wire is bitwise the
  reference's on the same input.  The server decodes the (C, N) stack into
  the dense `ncv_weighted_sum`.
* ``lowrank``  — PowerSGD-style rank-r factors of every matrix-shaped leaf
  (`shapes`, from the upload's FlatSpec) whose factors are smaller than
  it: one subspace iteration a round from the client's warm bases V,
  U = orthonormalize(X V) by 12 trace-normalized Newton-Schulz steps (not
  QR, as the reference), V = X^T U; the wire carries U, V and the other
  leaves dense, the state the residual X - U V^T and V.  The server sums
  sum_u w_u U_u V_u^T per matrix, never the dense (C, N) stack, so no
  kernel runs.

`u` is the stochastic-rounding uniforms, shape (..., n_chunks, chunk) f32
in [0, 1): drawn by the caller (the simulator's generator, or another run's
draws replayed), never inside the codec.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.kernels.rloo import ref as rloo_ref
from repro_torch.kernels.rloo.rloo import (ncv_weighted_sum,
                                           ncv_weighted_sum_q,
                                           ncv_weighted_sum_q4)
from repro_torch.utils import prng


@dataclasses.dataclass(frozen=True)
class Codec:
    """Base codec: f32 identity passthrough."""
    n: int
    name = "identity"
    stochastic = False  # encode reads the uniforms `u`
    stateful = False    # encode reads and returns a per-client state
    options = ()        # construction options FLConfig.make may route here

    @classmethod
    def validate_opts(cls, opts: dict):
        """Value-level option checks without an N (FLConfig construction
        time); subclasses raise ValueError on bad values."""
        del opts

    def init_state(self):
        """One client's starting state (a tree of tensors), None when the
        codec keeps none."""
        return None

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


@dataclasses.dataclass(frozen=True)
class TopKCodec(Codec):
    """Magnitude top-k with a per-client error-feedback residual."""
    ratio: float = 0.1
    name = "topk"
    options = ("ratio",)
    stateful = True

    @classmethod
    def validate_opts(cls, opts: dict):
        r = opts.get("ratio")
        if r is not None and not 0.0 < float(r) <= 1.0:
            raise ValueError(f"topk ratio must be in (0, 1], got {r!r}")

    @property
    def k(self) -> int:
        return max(1, min(self.n, int(round(self.ratio * self.n))))

    @property
    def index_dtype(self):
        return torch.uint16 if self.n <= 0xFFFF else torch.uint32

    def init_state(self):
        return torch.zeros((self.n,), dtype=torch.float32)

    def encode(self, vec, state=None, u=None):
        del u
        x = vec.float()
        if state is not None:
            x = x + state                      # re-inject the dropped mass
        # a stable descending sort: among equal |x| the lower index first,
        # the order of the reference's top_k
        idx = torch.sort(torch.abs(x), dim=-1, descending=True,
                         stable=True)[1][..., :self.k]
        vals = torch.gather(x, -1, idx)
        residual = x.scatter(-1, idx, 0.0)
        return dict(v=vals, i=idx.to(self.index_dtype)), residual

    def decode(self, wire):
        v = wire["v"].float()
        idx = wire["i"].to(torch.int64)
        out = torch.zeros(tuple(v.shape[:-1]) + (self.n,), dtype=torch.float32,
                          device=v.device)
        return out.scatter(-1, idx, v)

    def bytes_per_client(self) -> int:
        return (4 + self.index_dtype.itemsize) * self.k


@dataclasses.dataclass(frozen=True)
class LowRankCodec(Codec):
    """Rank-r factors of every matrix-shaped leaf, with error feedback.

    `shapes` is the upload's per-leaf shapes (`FlatSpec.shapes`): a leaf
    (..., q) of size p q is factored as a (p, q) matrix when r (p + q) <
    p q; the others ship dense in the wire's `d`.  Without `shapes` the
    whole vector is one dense segment.  Per-client state: ``r`` (N,), the
    residual, and ``v`` (sum_m q_m r,), the warm right bases."""
    rank: int = 8
    iters: int = 1
    shapes: tuple = ()
    name = "lowrank"
    options = ("rank", "iters")
    stateful = True

    def __post_init__(self):
        if not isinstance(self.rank, int) or self.rank < 1:
            raise ValueError(f"lowrank rank must be an int >= 1, "
                             f"got {self.rank!r}")
        if not isinstance(self.iters, int) or self.iters < 1:
            raise ValueError(f"lowrank iters must be an int >= 1, "
                             f"got {self.iters!r}")
        total = sum(math.prod(int(d) for d in s) for s in self.shapes)
        if self.shapes and total != self.n:
            raise ValueError(f"lowrank shapes sum to {total} params, "
                             f"but n={self.n}")

    @classmethod
    def validate_opts(cls, opts: dict):
        r = opts.get("rank")
        if r is not None and (not isinstance(r, int) or r < 1):
            raise ValueError(f"lowrank rank must be an int >= 1, got {r!r}")
        it = opts.get("iters")
        if it is not None and (not isinstance(it, int) or it < 1):
            raise ValueError(f"lowrank iters must be an int >= 1, "
                             f"got {it!r}")

    @functools.cached_property
    def _plan(self):
        """(mats, rest): mats = ((flat offset, p, q, u offset, v offset),
        ...) for the factored segments, rest = ((flat offset, size), ...)
        for the dense ones, in flat order."""
        mats, rest = [], []
        off = u_off = v_off = 0
        r = self.rank
        for s in self.shapes if self.shapes else ((self.n,),):
            size = math.prod(int(d) for d in s)
            if len(s) >= 2:
                q = int(s[-1])
                p = size // q
                if r * (p + q) < p * q:
                    mats.append((off, p, q, u_off, v_off))
                    u_off += p * r
                    v_off += q * r
                    off += size
                    continue
            rest.append((off, size))
            off += size
        return tuple(mats), tuple(rest)

    @property
    def _sizes(self):
        mats, rest = self._plan
        r = self.rank
        return (sum(p * r for _, p, _, _, _ in mats),
                sum(q * r for _, _, q, _, _ in mats),
                sum(sz for _, sz in rest))

    def init_state(self):
        # the reference's starting bases: normal(fold_in(key 0x10A4, m),
        # (q_m r,)) for matrix m
        key = prng.prng_key(0x10A4)
        vs = [prng.normal(prng.fold_in(key, i), (q * self.rank,))
              for i, (_, _, q, _, _) in enumerate(self._plan[0])]
        v0 = np.concatenate(vs) if vs else np.zeros((0,), np.float32)
        return dict(r=torch.zeros((self.n,), dtype=torch.float32),
                    v=torch.from_numpy(v0))

    @staticmethod
    def _orthonormalize(y, steps=12, eps=1e-6):
        """Column-orthonormalize y (..., p, r) as y (y^T y)^{-1/2}, the
        inverse square root by trace-normalized Newton-Schulz iteration
        (the reference's: plain products, a ridge eps keeps a rank-deficient
        y bounded)."""
        r = y.shape[-1]
        eye = torch.eye(r, dtype=torch.float32, device=y.device)
        s = y.transpose(-1, -2) @ y
        c = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1) + eps
        s = s / c[..., None, None] + eps * eye
        yk, zk = s, eye.expand_as(s)
        for _ in range(steps):
            t = 0.5 * (3.0 * eye - zk @ yk)
            yk = yk @ t
            zk = t @ zk
        return (y @ zk) / torch.sqrt(c)[..., None, None]

    def encode(self, vec, state=None, u=None):
        del u
        r = self.rank
        mats, rest = self._plan
        lead = tuple(vec.shape[:-1])
        b = math.prod(lead)
        x = vec.float().reshape(b, self.n)
        if state is not None:
            x = x + state["r"].reshape(b, self.n)   # re-inject the gap
            v_prev = state["v"].reshape(b, state["v"].shape[-1])
        else:
            v_prev = self.init_state()["v"].to(x.device).expand(b, -1)
        us, vs = [], []
        residual = x.clone()
        for off, p, q, _, v_off in mats:
            X = x[:, off:off + p * q].reshape(b, p, q)
            V = v_prev[:, v_off:v_off + q * r].reshape(b, q, r)
            for _ in range(self.iters):
                U = self._orthonormalize(X @ V)      # (b, p, r) orthonormal
                V = X.transpose(-1, -2) @ U          # (b, q, r)
            us.append(U.reshape(b, -1))
            vs.append(V.reshape(b, -1))
            residual[:, off:off + p * q] = (X - U @ V.transpose(-1, -2)
                                            ).reshape(b, -1)
        ds = [x[:, off:off + sz] for off, sz in rest]
        for off, sz in rest:                    # dense segments ship exact
            residual[:, off:off + sz] = 0.0

        def cat(parts):
            out = torch.cat(parts, -1) if parts else x.new_zeros((b, 0))
            return out.reshape(lead + (out.shape[-1],))
        wire = dict(u=cat(us), v=cat(vs), d=cat(ds))
        return wire, dict(r=residual.reshape(lead + (self.n,)), v=wire["v"])

    def decode(self, wire):
        r = self.rank
        mats, rest = self._plan
        lead = tuple(wire["d"].shape[:-1])
        b = math.prod(lead)
        wu, wv, wd = (wire[k].reshape(b, wire[k].shape[-1])
                      for k in ("u", "v", "d"))
        out = torch.zeros((b, self.n), dtype=torch.float32, device=wd.device)
        for off, p, q, u_off, v_off in mats:
            U = wu[:, u_off:u_off + p * r].reshape(b, p, r)
            V = wv[:, v_off:v_off + q * r].reshape(b, q, r)
            out[:, off:off + p * q] = (U @ V.transpose(-1, -2)).reshape(
                b, p * q)
        d_off = 0
        for off, sz in rest:
            out[:, off:off + sz] = wd[:, d_off:d_off + sz]
            d_off += sz
        return out.reshape(lead + (self.n,))

    def bytes_per_client(self) -> int:
        return 4 * sum(self._sizes)

    def weighted_sum(self, wire, w):
        """sum_u w_u g_u straight off the stacked factors: per matrix
        einsum('c,cpr,cqr->pq'), never the dense (C, N) stack."""
        r = self.rank
        mats, rest = self._plan
        w = w.float()
        agg = torch.zeros((self.n,), dtype=torch.float32, device=w.device)
        for off, p, q, u_off, v_off in mats:
            U = wire["u"][:, u_off:u_off + p * r].reshape(-1, p, r)
            V = wire["v"][:, v_off:v_off + q * r].reshape(-1, q, r)
            agg[off:off + p * q] = torch.einsum("c,cpr,cqr->pq", w, U,
                                                V).reshape(-1)
        d_agg = torch.einsum("c,cd->d", w, wire["d"])
        d_off = 0
        for off, sz in rest:
            agg[off:off + sz] = d_agg[d_off:d_off + sz]
            d_off += sz
        return agg, torch.sum(agg * agg)


CODECS = {
    "identity": Codec,
    "bf16": BF16Codec,
    "int8": Int8Codec,
    "int4": Int4Codec,
    "topk": TopKCodec,
    "lowrank": LowRankCodec,
}
# codecs the reference registers that the port does not have: none left
NOT_PORTED = ()


def check_codec_name(name: str):
    """KeyError, with the reference's wording, for a codec the port does
    not register."""
    if name not in CODECS:
        raise KeyError(f"unknown codec '{name}'; have {sorted(CODECS)}")


def validate_codec_opts(name: str, opts: dict):
    """Name and option validation without an N (FLConfig construction
    time): unknown names raise KeyError, options the codec
    would ignore raise TypeError, out-of-range values (ratio outside (0, 1],
    rank or iters below 1) raise ValueError."""
    check_codec_name(name)
    cls = CODECS[name]
    bad = sorted(set(opts) - set(cls.options))
    if bad:
        raise TypeError(
            f"codec option(s) {bad} are not used by codec '{name}'; "
            f"valid options: {sorted(cls.options)}")
    cls.validate_opts(opts)


def get_codec(name: str, n: int, spec=None, **opts) -> Codec:
    """The codec `name` for an N-parameter upload vector.  `spec` (a
    `utils.tree_math.FlatSpec`) gives `lowrank` the upload's leaf shapes;
    the other codecs ignore it."""
    validate_codec_opts(name, opts)
    if name == "lowrank" and spec is not None:
        opts = dict(opts, shapes=tuple(tuple(s) for s in spec.shapes))
    return CODECS[name](n=n, **opts)


def compression_ratio(codec: Codec) -> float:
    """Uploaded-bytes ratio of the f32 path over this codec's wire."""
    return 4.0 * codec.n / codec.bytes_per_client()
