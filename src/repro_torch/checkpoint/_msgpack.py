"""The msgpack subset the checkpoints use, in plain Python.

The checkpoint format is msgpack (`src/repro/checkpoint/ckpt.py` writes it
with `msgpack.packb(payload, use_bin_type=True)`), but the machines the
port runs on need not have the `msgpack` package.  `packb` writes map,
str, bin, int, float (as float64), list, tuple (as an array), bool and
None with the same bytes `msgpack.packb(obj, use_bin_type=True)` gives;
`unpackb` reads those and the wider forms another writer may choose
(float32, every int width), as `msgpack.unpackb(data, raw=False)` does.
"""
from __future__ import annotations

import struct

__all__ = ["packb", "unpackb"]


def _pack_int(x: int, out: list):
    if x < -(1 << 5):
        if x < -(1 << 15):
            if x < -(1 << 31):
                if x < -(1 << 63):
                    raise OverflowError(f"int {x} out of msgpack's range")
                out.append(b"\xd3" + struct.pack(">q", x))
            else:
                out.append(b"\xd2" + struct.pack(">i", x))
        elif x < -(1 << 7):
            out.append(b"\xd1" + struct.pack(">h", x))
        else:
            out.append(b"\xd0" + struct.pack(">b", x))
    elif x < (1 << 7):
        out.append(struct.pack(">B" if x >= 0 else ">b", x))
    elif x < (1 << 8):
        out.append(b"\xcc" + struct.pack(">B", x))
    elif x < (1 << 16):
        out.append(b"\xcd" + struct.pack(">H", x))
    elif x < (1 << 32):
        out.append(b"\xce" + struct.pack(">I", x))
    elif x < (1 << 64):
        out.append(b"\xcf" + struct.pack(">Q", x))
    else:
        raise OverflowError(f"int {x} out of msgpack's range")


def _pack_len(n: int, fix: int, fix_max: int, codes, out: list):
    """A length header: the fix form below `fix_max`, else the 8-bit (if
    `codes` has one), 16-bit or 32-bit form."""
    if n < fix_max:
        out.append(struct.pack(">B", fix | n))
        return
    for code, fmt, limit in codes:
        if n < limit:
            out.append(struct.pack(">B" + fmt, code, n))
            return
    raise ValueError(f"length {n} out of msgpack's range")


_STR = ((0xd9, "B", 1 << 8), (0xda, "H", 1 << 16), (0xdb, "I", 1 << 32))
_BIN = ((0xc4, "B", 1 << 8), (0xc5, "H", 1 << 16), (0xc6, "I", 1 << 32))
_ARR = ((0xdc, "H", 1 << 16), (0xdd, "I", 1 << 32))
_MAP = ((0xde, "H", 1 << 16), (0xdf, "I", 1 << 32))


def _pack(obj, out: list):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xa0, 32, _STR, out)
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(len(b), 0, 0, _BIN, out)     # bin has no fix form
        out.append(b)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, _ARR, out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, _MAP, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """`obj` as msgpack bytes (str as str, bytes as bin)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]


_FIXED = {
    0xc0: lambda r: None, 0xc2: lambda r: False, 0xc3: lambda r: True,
    0xca: lambda r: r.unpack(">f"), 0xcb: lambda r: r.unpack(">d"),
    0xcc: lambda r: r.unpack(">B"), 0xcd: lambda r: r.unpack(">H"),
    0xce: lambda r: r.unpack(">I"), 0xcf: lambda r: r.unpack(">Q"),
    0xd0: lambda r: r.unpack(">b"), 0xd1: lambda r: r.unpack(">h"),
    0xd2: lambda r: r.unpack(">i"), 0xd3: lambda r: r.unpack(">q"),
}
# code -> (kind, length format)
_SIZED = {0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xdc: ("arr", ">H"), 0xdd: ("arr", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}


def _unpack(r: _Reader):
    code = r.unpack(">B")
    if code <= 0x7f:
        return code
    if code >= 0xe0:
        return code - 0x100
    if 0xa0 <= code <= 0xbf:
        kind, n = "str", code & 0x1f
    elif 0x90 <= code <= 0x9f:
        kind, n = "arr", code & 0x0f
    elif 0x80 <= code <= 0x8f:
        kind, n = "map", code & 0x0f
    elif code in _FIXED:
        return _FIXED[code](r)
    elif code in _SIZED:
        kind, fmt = _SIZED[code]
        n = r.unpack(fmt)
    else:
        raise ValueError(f"msgpack type 0x{code:02x} is not supported")
    if kind == "str":
        return str(r.take(n), "utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "arr":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def unpackb(data):
    """The object msgpack bytes `data` hold (str as str, bin as bytes,
    arrays as lists)."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.buf):
        raise ValueError("extra data after the msgpack object")
    return obj
